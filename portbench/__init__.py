"""The benchmark of the PyTorch and CUDA port (``repro_torch``): cells
from ``BENCHMARK.json`` driven by ``run.py``, checked against the plain
reference in ``reference/``."""
