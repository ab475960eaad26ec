"""The application tier of the PyTorch/CUDA port: the programs of
``examples/``, file for file, on ``randblas_tpu_torch``. Each module has a
``run(..., device=...)`` that returns what its JAX counterpart prints and
a ``main()`` that takes the same arguments plus ``--cpu``."""
