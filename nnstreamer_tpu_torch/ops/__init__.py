"""Compute ops: the hand-written CUDA kernels (:mod:`kernels`, built by
:mod:`build`) and weight/activation quantization (:mod:`quant`)."""
