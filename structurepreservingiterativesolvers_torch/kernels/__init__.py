"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

``dia_spmv``: the DIA sparse matrix-vector product (``csrc/dia_spmv.cu``),
and its product with a block of vectors (``csrc/dia_spmm.cu``).
``stencil_spmv``: the constant-stencil product with its boundary-strip
correction (``csrc/stencil_spmv.cu``).
``poly_apply``: the fused degree-p Chebyshev and Neumann preconditioner
applies, one launch each (``csrc/poly_apply.cu``).
``ortho``: the middle pair of CGS2, ``w1 = w − hᵀQ`` and ``u2 = Q w1``, in one
read of the Krylov basis (``csrc/ortho_fused.cu``).  Importing this package builds
nothing; a kernel is compiled from ``csrc/`` the first time a CUDA tensor
reaches its wrapper.
"""


def launch_counters() -> dict:
    """Every kernel's launch counter, by name: each wrapper that launches on
    the card adds one to its ``launches`` (a design's wrapper and its
    kernel's both); ``<name>_<design>`` for the designs of kernels #1-#4
    and of the batched #1 (``dia_spmm``: ``_live`` and ``_dense`` by its
    operator's plan, ``_tile`` and ``_spread`` by its design)."""
    from . import dia_spmv, ortho, poly_apply, stencil_spmv

    return {"dia_spmv": dia_spmv.dia_spmv_cuda,
            "dia_spmv_live": dia_spmv.dia_spmv_live_cuda,
            "dia_spmv_dense": dia_spmv.dia_spmv_dense_cuda,
            "dia_spmm": dia_spmv.dia_spmm_cuda,
            "dia_spmm_live": dia_spmv.dia_spmm_live_cuda,
            "dia_spmm_dense": dia_spmv.dia_spmm_dense_cuda,
            "dia_spmm_tile": dia_spmv.dia_spmm_tile_cuda,
            "dia_spmm_spread": dia_spmv.dia_spmm_spread_cuda,
            "stencil_spmv": stencil_spmv.stencil_spmv_cuda,
            "stencil_spmv_tiled": stencil_spmv.stencil_spmv_tiled_cuda,
            "stencil_spmv_flat": stencil_spmv.stencil_spmv_flat_cuda,
            "cheb_apply": poly_apply.cheb_apply_cuda,
            "cheb_apply_tiled": poly_apply.cheb_apply_tiled_cuda,
            "cheb_apply_flat": poly_apply.cheb_apply_flat_cuda,
            "neumann_apply": poly_apply.neumann_apply_cuda,
            "neumann_apply_tiled": poly_apply.neumann_apply_tiled_cuda,
            "neumann_apply_flat": poly_apply.neumann_apply_flat_cuda,
            "fused_update_matvec": ortho.fused_update_matvec_cuda}
