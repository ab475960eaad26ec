"""The benchmark's plain reference: frozen copies of the RandBLAS
generators (Philox4x32-10 with its counter layout, Box-Muller, repeated
Fisher-Yates) and the exact products the timed calls are judged against.

Plain PyTorch only. Nothing here imports the measured program: the
reference regenerates every operator from its key, so a fault in the
program's generators, transforms or kernels shows as a gap.
"""
