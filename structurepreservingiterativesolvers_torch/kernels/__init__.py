"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

``dia_spmv``: the DIA sparse matrix-vector product (``csrc/dia_spmv.cu``).
``stencil_spmv``: the constant-stencil product with its boundary-strip
correction (``csrc/stencil_spmv.cu``).
``poly_apply``: the fused degree-p Chebyshev and Neumann preconditioner
applies, one launch each (``csrc/poly_apply.cu``).
``ortho``: the middle pair of CGS2, ``w1 = w − hᵀQ`` and ``u2 = Q w1``, in one
read of the Krylov basis (``csrc/ortho_fused.cu``).  Importing this package builds
nothing; a kernel is compiled from ``csrc/`` the first time a CUDA tensor
reaches its wrapper.
"""
