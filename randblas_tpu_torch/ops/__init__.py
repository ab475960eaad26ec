"""Fill engine, accumulation and the hand-written CUDA kernels' wrappers."""
