"""The benchmark of the PyTorch and CUDA port (``neus2_tpu_torch``) on one
H100: ``run.py`` runs a cell of ``BENCHMARK.json`` once."""
