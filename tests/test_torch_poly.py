"""The plain twins of the fused polynomial kernels of the PyTorch port
(``kernels/poly_apply.py``, kernels #3 and #4) against the JAX package, on
the CPU.

* f64, against the JAX package's unfused ``Chebyshev.__call__`` and
  ``Neumann.__call__`` (its only f64 path: the fused kernels are f32 there),
  on heat M=16 (a ``Stencil``), heat M=17 (odd M in f64: a plain DIA, in
  both packages) and swe M=16 (a wrapped DIA), degrees 1, 2 and p: 1e-12
  relative to max|y| (the same recurrence, summed in the same order; the
  bounds come from the JAX builder);
* f32, against the JAX package's fused Pallas kernels in interpret mode
  (``tests/test_pallas_poly.py``'s calls, at heat M=16 and swe M=16):
  ``atol = 1e-5 · max|y|``, that test's own bound (the Pallas kernel reads
  the materialised DIA windows, the twin the stencil constants and strips);
* the wrappers' refusals, and the build key that covers the header the
  fused kernels share with the stencil kernel.

The CUDA kernels themselves are held against these twins on the card, in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import precond as tpre
from structurepreservingiterativesolvers_torch.kernels import poly_apply as tpa
from structurepreservingiterativesolvers_tpu import precond as jpre
from structurepreservingiterativesolvers_tpu.models import heat as jheat
from structurepreservingiterativesolvers_tpu.models import swe as jswe

RTOL64, ATOL32 = 1e-12, 1e-5
OMEGA = 0.8


@pytest.fixture(scope="module")
def operators():
    """name -> (JAX system, port system), both on the CPU in f64."""
    out = {}
    for name, js in (("heat16", jheat.linforms(M=16)),
                     ("heat17", jheat.linforms(M=17)),
                     ("swe16", jswe.linforms(M=16))):
        out[name] = (js, torch_parity.to_port(js))
    return out


def _v(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _bounds(js):
    base = jpre.chebyshev(js.A, degree=8)
    theta = 0.5 * (base.lmax + base.lmin)
    delta = 0.5 * (base.lmax - base.lmin)
    return base.lmin, base.lmax, theta, delta, theta / delta


def test_operator_forms(operators):
    """Heat at even M is a Stencil and at odd M a DIA in f64, in both
    packages; swe is a wrapped DIA."""
    forms = {name: (type(js.A).__name__, type(ts.A).__name__, ts.A.wrap)
             for name, (js, ts) in operators.items()}
    assert forms == {"heat16": ("Stencil", "Stencil", False),
                     "heat17": ("DIA", "DIA", False),
                     "swe16": ("DIA", "DIA", True)}


@pytest.mark.parametrize("name", ["heat16", "heat17", "swe16"])
@pytest.mark.parametrize("kind,degree", [("cheb", 1), ("cheb", 2), ("cheb", 8),
                                         ("neumann", 1), ("neumann", 2),
                                         ("neumann", 4)])
def test_plain_twin_matches_jax_unfused(operators, name, kind, degree):
    js, ts = operators[name]
    v = _v(js.b.shape[0], degree)
    if kind == "cheb":
        lmin, lmax, theta, delta, sigma = _bounds(js)
        ref = jpre.Chebyshev(A=js.A, lmin=lmin, lmax=lmax, degree=degree)
        y = tpa.cheb_apply(ts.A, degree, theta, delta, sigma,
                           torch.as_tensor(v))
        port = tpre.Chebyshev(A=ts.A, lmin=lmin, lmax=lmax, degree=degree)
    else:
        ref = jpre.neumann(js.A, degree=degree, omega=OMEGA, fused=False)
        port = tpre.neumann(ts.A, degree=degree, omega=OMEGA)
        y = tpa.neumann_apply(ts.A, port.dinv, degree, OMEGA,
                              torch.as_tensor(v))
    y_ref = np.asarray(ref(jnp.asarray(v)))
    torch_parity.close(y.numpy(), y_ref, RTOL64)
    # the builders' unfused recurrence on the CPU is the same function
    torch_parity.close(port(torch.as_tensor(v)).numpy(), y_ref, RTOL64)


def test_degree_zero_follows_jax(operators):
    """Below the kernels' range the unfused recurrence keeps the JAX
    package's degree-0 results: x = v/θ for Chebyshev, z = ωD⁻¹v for
    Neumann."""
    js, ts = operators["heat16"]
    lmin, lmax, *_ = _bounds(js)
    v = _v(js.b.shape[0], 3)
    for jp, tp in ((jpre.Chebyshev(A=js.A, lmin=lmin, lmax=lmax, degree=0),
                    tpre.chebyshev(ts.A, lmin, lmax, degree=0, fused=True)),
                   (jpre.neumann(js.A, degree=0, fused=False),
                    tpre.neumann(ts.A, degree=0, fused=True))):
        assert tp.fused is False  # nothing to fuse below degree 2
        torch_parity.close(tp(torch.as_tensor(v)).numpy(),
                           np.asarray(jp(jnp.asarray(v))), RTOL64)


@pytest.mark.parametrize("name,kind,block_rows", [("heat16", "cheb", 1024),
                                                  ("heat16", "neumann", 1024),
                                                  ("swe16", "neumann", 4096)])
def test_plain_twin_matches_pallas_interpret_f32(operators, name, kind,
                                                 block_rows):
    js, ts = operators[name]
    A32j, A32t = js.A.astype(jnp.float32), ts.A.astype(torch.float32)
    v = _v(js.b.shape[0], 11, np.float32)
    if kind == "cheb":
        lmin, lmax, theta, delta, sigma = _bounds(js)
        fused = jpre.chebyshev(A32j, lmin=lmin, lmax=lmax, degree=8,
                               fused=True, block_rows=block_rows,
                               interpret=True)
        y = tpa.cheb_apply_torch(A32t, 8, theta, delta, sigma,
                                 torch.as_tensor(v))
    else:
        fused = jpre.neumann(A32j, degree=4, omega=OMEGA, fused=True,
                             block_rows=block_rows, interpret=True)
        dinv = tpre.neumann(A32t, degree=4).dinv
        assert dinv.dtype == torch.float32
        y = tpa.neumann_apply_torch(A32t, dinv, 4, OMEGA, torch.as_tensor(v))
    assert fused.datawin is not None  # the Pallas kernel ran
    y_ref = np.asarray(fused(jnp.asarray(v)))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_ref,
                               atol=ATOL32 * float(np.max(np.abs(y_ref))))


def test_wrappers_refuse(operators):
    _, ts = operators["heat16"]
    A, n = ts.A, ts.b.shape[0]
    v = torch.as_tensor(_v(n, 0))
    dinv = tpre.neumann(A).dinv
    args = (1.0, 0.9, 1.0 / 0.9)
    with pytest.raises(ValueError, match="device meta"):
        tpa.cheb_apply(A, 8, *args, v.to("meta"))
    with pytest.raises(ValueError, match="device meta"):
        tpa.neumann_apply(A, dinv, 4, OMEGA, v.to("meta"))
    with pytest.raises(TypeError):  # f32 vector, f64 strips
        tpa.cheb_apply(A, 8, *args, v.float())
    with pytest.raises(TypeError):  # f32 dinv, f64 vector
        tpa.neumann_apply(A, dinv.float(), 4, OMEGA, v)
    with pytest.raises(ValueError):
        tpa.cheb_apply(A, 0, *args, v)
    with pytest.raises(ValueError):
        tpa.cheb_apply(A, tpa.MAX_DEGREE + 1, *args, v)
    with pytest.raises(ValueError):
        tpa.neumann_apply(A, dinv[:-1], 4, OMEGA, v)
    with pytest.raises(ValueError):
        tpa.cheb_apply(A, 8, *args, v[:-1])
    with pytest.raises(ValueError):  # the kernels' entry takes CUDA only
        tpa.cheb_apply_cuda(A, 8, *args, v)
    with pytest.raises(ValueError):
        tpa.neumann_apply_cuda(A, dinv, 4, OMEGA, v)
    assert tpa.cheb_apply_cuda.launches == tpa.neumann_apply_cuda.launches == 0


def test_build_key_follows_included_headers(tmp_path):
    """The kernels' build key hashes the ``csrc/`` headers a source includes,
    so an edit of ``stencil_row.cuh`` (or ``dia_row.cuh``) rebuilds both
    sources that share it."""
    from structurepreservingiterativesolvers_torch.kernels import build

    def names(src):
        return [p.name for p in build._with_headers(build.CSRC_DIR / src)]

    assert names("poly_apply.cu") == ["poly_apply.cu", "stencil_row.cuh"]
    assert names("stencil_spmv.cu") == ["stencil_spmv.cu", "stencil_row.cuh"]
    assert names("dia_spmv.cu") == ["dia_spmv.cu", "dia_row.cuh"]
    assert names("dia_spmm.cu") == ["dia_spmm.cu", "dia_row.cuh"]
    src, header = tmp_path / "k.cu", tmp_path / "h.cuh"
    src.write_text('#include <cuda_runtime.h>\n#include "h.cuh"\n')
    header.write_text("// one\n")
    key = build.source_key(src)
    header.write_text("// two\n")
    assert build.source_key(src) != key
