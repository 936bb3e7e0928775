"""The benchmark of the PyTorch / CUDA port (spartacus_surface_tpu_torch):
BENCHMARK.json's cells, run by ``python3 -m benchmark.run``."""
