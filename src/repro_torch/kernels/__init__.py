"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions,
and the dispatch between them (``ops``)."""
