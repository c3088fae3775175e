"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

``dia_spmv``: the DIA sparse matrix-vector product (``csrc/dia_spmv.cu``),
with its mixed form (f32 in, f64 out), and its product with a block of
vectors (``csrc/dia_spmm.cu``).
``stencil_spmv``: the constant-stencil product with its boundary-strip
correction (``csrc/stencil_spmv.cu``), and its product with a block of
vectors.
``poly_apply``: the fused degree-p Chebyshev and Neumann preconditioner
applies, one launch each (``csrc/poly_tiled.cu``, ``csrc/poly_apply.cu``),
on a vector or a block of vectors.
``ortho``: the middle pair of CGS2, ``w1 = w − hᵀQ`` and ``u2 = Q w1``, in one
read of the Krylov basis (``csrc/ortho_fused.cu``).  Importing this package builds
nothing; a kernel is compiled from ``csrc/`` the first time a CUDA tensor
reaches its wrapper.
"""


import torch


class _Count:
    """A launch counter that no wrapper function stands for (``launches``)."""

    def __init__(self):
        self.launches = 0


# the launches of each kernel's f32 instantiation (the f32 storage mode's),
# counted beside the kernel's own counters, which count every dtype
F32 = {name: _Count() for name in (
    "dia_spmv", "dia_spmm", "stencil_spmv", "stencil_spmm", "cheb_apply",
    "neumann_apply", "fused_update_matvec")}


# the f64 launches of kernel #1 on the kept upcast operator of an f32 DIA
# (``ops/sparse.py::DIA.upcast``: a stage map's f64 P x over f32 storage),
# counted beside ``dia_spmv``'s own
UPCAST = _Count()
# the mixed #1's windowed launches (a row-sharded operator's f64 product
# from f32 storage), counted beside ``dia_spmv_mixed``'s own
MIXED_WINDOW = _Count()


def count_f32(name: str, dtype: torch.dtype) -> None:
    """Count a launch of ``name``'s f32 instantiation."""
    if dtype == torch.float32:
        F32[name].launches += 1


def launch_counters() -> dict:
    """Every kernel's launch counter, by name: each wrapper that launches on
    the card adds one to its ``launches`` (a design's wrapper and its
    kernel's both); ``<name>_<design>`` for the designs of kernels #1-#4
    and of the batched #1 (``dia_spmv_mixed`` the mixed f32/f64 form of #1;
    ``dia_spmm``: ``_live`` and ``_dense`` by its
    operator's plan, ``_tile`` and ``_spread`` by its design;
    ``dia_spmv_window`` and ``dia_spmm_window`` the windowed launches of a
    row-sharded operator, ``dia_spmv_mixed_window`` the mixed form's;
    ``dia_spmv_upcast`` the f64 launches on an f32 DIA's upcast operator);
    ``<name>_f32`` the launches of a kernel's f32
    instantiation (``F32``; a block form's and a design's among them).
    ``utils.counters.all_counters`` adds the collectives' counters to
    these."""
    from . import dia_spmv, ortho, poly_apply, stencil_spmv

    return {"dia_spmv": dia_spmv.dia_spmv_cuda,
            "dia_spmv_live": dia_spmv.dia_spmv_live_cuda,
            "dia_spmv_dense": dia_spmv.dia_spmv_dense_cuda,
            "dia_spmv_window": dia_spmv.dia_spmv_window_cuda,
            "dia_spmv_mixed": dia_spmv.dia_spmv_mixed_cuda,
            "dia_spmv_mixed_window": MIXED_WINDOW,
            "dia_spmv_upcast": UPCAST,
            "dia_spmm": dia_spmv.dia_spmm_cuda,
            "dia_spmm_live": dia_spmv.dia_spmm_live_cuda,
            "dia_spmm_dense": dia_spmv.dia_spmm_dense_cuda,
            "dia_spmm_window": dia_spmv.dia_spmm_window_cuda,
            "dia_spmm_tile": dia_spmv.dia_spmm_tile_cuda,
            "dia_spmm_spread": dia_spmv.dia_spmm_spread_cuda,
            "stencil_spmv": stencil_spmv.stencil_spmv_cuda,
            "stencil_spmv_tiled": stencil_spmv.stencil_spmv_tiled_cuda,
            "stencil_spmv_flat": stencil_spmv.stencil_spmv_flat_cuda,
            "stencil_spmm": stencil_spmv.stencil_spmm_cuda,
            "stencil_spmm_tiled": stencil_spmv.stencil_spmm_tiled_cuda,
            "stencil_spmm_flat": stencil_spmv.stencil_spmm_flat_cuda,
            "cheb_apply": poly_apply.cheb_apply_cuda,
            "cheb_apply_tiled": poly_apply.cheb_apply_tiled_cuda,
            "cheb_apply_flat": poly_apply.cheb_apply_flat_cuda,
            "neumann_apply": poly_apply.neumann_apply_cuda,
            "neumann_apply_tiled": poly_apply.neumann_apply_tiled_cuda,
            "neumann_apply_flat": poly_apply.neumann_apply_flat_cuda,
            "cheb_apply_many": poly_apply.cheb_apply_many_cuda,
            "cheb_apply_many_tiled": poly_apply.cheb_apply_many_tiled_cuda,
            "cheb_apply_many_flat": poly_apply.cheb_apply_many_flat_cuda,
            "neumann_apply_many": poly_apply.neumann_apply_many_cuda,
            "neumann_apply_many_tiled":
                poly_apply.neumann_apply_many_tiled_cuda,
            "neumann_apply_many_flat": poly_apply.neumann_apply_many_flat_cuda,
            "fused_update_matvec": ortho.fused_update_matvec_cuda,
            **{f"{name}_f32": count for name, count in F32.items()}}
