"""PyTorch + CUDA port of the GreediRIS influence-maximization stack.

The JAX package ``repro`` is the reference; every function here returns
the same words, seeds, gains and counts as its ``repro`` twin for the
same inputs and keys.  Packed incidence words are int32 bit patterns.
Entry points take ``device=`` (default ``"cuda"``); asking for CUDA on
a machine without a card raises instead of running on the CPU.
"""
