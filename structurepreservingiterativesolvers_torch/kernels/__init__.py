"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

``dia_spmv``: the DIA sparse matrix-vector product (``csrc/dia_spmv.cu``).
Importing this package builds nothing; a kernel is compiled from ``csrc/``
the first time a CUDA tensor reaches its wrapper.
"""
