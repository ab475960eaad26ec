"""portbench: the benchmark of randblas_tpu_torch on NVIDIA H100s, driven
by the data in ``BENCHMARK.json`` and the files under this directory
(``run.py`` runs one cell once)."""
