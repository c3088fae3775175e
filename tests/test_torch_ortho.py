"""The fused CGS2 update (kernel #5) of the PyTorch port against the JAX
package, on the CPU: the kernel's plain twin against the JAX Pallas kernel
run in interpret mode, and the inputs the wrapper and the solvers refuse.
``_cgs2`` and the solvers with ``ortho="cgs2_fused"`` are in
``tests/test_torch_ortho_solvers.py``; the kernel itself needs the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import solvers as tsol
from structurepreservingiterativesolvers_torch.kernels import ortho
from structurepreservingiterativesolvers_tpu.models import swe as jswe
from structurepreservingiterativesolvers_tpu.ops.pallas_ortho import (
    fused_update_matvec as jax_fused_update_matvec,
)

# the same sums in another order (f64), and f32 sums of up to 70,000 terms:
# max|Δw1| / max|w1|, and max|Δu2| / max|h|.  u2 = Q (w − hᵀQ) is the
# second projection, which cancels to a small fraction of the first (to 1%
# of it at n = 70,000), so its rounding is of the size of h, not of u2
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _operands(m, n, dtype, seed=0):
    """A basis of m rows of near-unit norm, w, and h = Q w as CGS2 gives it."""
    rng = np.random.default_rng(seed)
    Q = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(dtype)
    w = rng.standard_normal(n).astype(dtype)
    return Q, w, (Q.astype(np.float64) @ w.astype(np.float64)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m,n", [(21, 1000), (61, 5000), (9, 70000)])
def test_twin_matches_jax_kernel(dtype, m, n):
    """The plain twin against the JAX Pallas kernel (interpret mode, the
    ragged last block of 70,000 = 2·32,768 + 4,464 included)."""
    Q, w, h = _operands(m, n, dtype)
    w1_j, u2_j = jax_fused_update_matvec(jnp.asarray(Q), jnp.asarray(w),
                                         jnp.asarray(h), interpret=True)
    w1_t, u2_t = ortho.fused_update_matvec(*map(torch.from_numpy, (Q, w, h)))
    assert w1_t.dtype == u2_t.dtype == torch.from_numpy(Q).dtype
    torch_parity.close(w1_t.numpy(), np.asarray(w1_j), RTOL[dtype])
    assert np.max(np.abs(u2_t.numpy() - np.asarray(u2_j))) \
        <= RTOL[dtype] * np.max(np.abs(h))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    Q, w, h = map(torch.from_numpy, _operands(4, 100, np.float64))
    big = torch.zeros(ortho.MAX_ROWS + 1, 100, dtype=torch.float64)
    with pytest.raises(ValueError):  # more rows than the kernel holds
        ortho.fused_update_matvec(big, w, torch.zeros(ortho.MAX_ROWS + 1,
                                                      dtype=torch.float64))
    with pytest.raises(ValueError):  # a non-contiguous basis
        ortho.fused_update_matvec(torch.zeros(100, 4, dtype=torch.float64).T,
                                  w, h)
    with pytest.raises(ValueError):  # a non-contiguous vector
        ortho.fused_update_matvec(Q, torch.zeros(200, dtype=torch.float64)[::2],
                                  h)
    with pytest.raises(TypeError):  # mixed dtypes
        ortho.fused_update_matvec(Q, w.float(), h)
    with pytest.raises(ValueError):  # h of the wrong length
        ortho.fused_update_matvec(Q, w, h[:-1])
    with pytest.raises(ValueError):  # the kernel's entry takes CUDA tensors
        ortho.fused_update_matvec_cuda(Q, w, h)
    # what it takes, the active prefix of a workspace included
    w1, u2 = ortho.fused_update_matvec(torch.zeros(9, 100,
                                                   dtype=torch.float64)[:4], w, h)
    assert w1.shape == (100,) and u2.shape == (4,)


def test_unknown_ortho_is_refused():
    s = torch_parity.to_port(jswe.linforms(M=16))
    with pytest.raises(ValueError):
        tsol.gmres(s.A, s.b, k=3, ortho="cgs2_pallas")
