"""The PyTorch port's KKT endgame (``constrained_lsq``) against the JAX
package's on the same reduced problem: the Hessenberg matrix, β and the
reduced constraint buffers of an Arnoldi run on lkdv, handed to both as
numpy arrays.  The minimiser, the multipliers and the deviation agree to
1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.constraints import quadratic as tq
from structurepreservingiterativesolvers_torch.solvers import arnoldi as tarn
from structurepreservingiterativesolvers_torch.solvers.kkt import constrained_lsq as t_kkt
from structurepreservingiterativesolvers_tpu.constraints.quadratic import ReducedBuffers
from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv
from structurepreservingiterativesolvers_tpu.solvers.kkt import constrained_lsq as j_kkt

TOL = 1e-10
_j_kkt = jax.jit(j_kkt)
K, STEPS = 20, 12


@pytest.fixture(scope="module")
def reduced():
    """H, β, buffers and the LSQ warm start after STEPS Arnoldi steps."""
    s = torch_parity.to_port(jlkdv.linforms(**torch_parity.LKDV_EASY))
    beta = float(torch.linalg.norm(s.b))
    st = tarn.init_state(s.b, beta, K)
    for j in range(STEPS):
        tarn.arnoldi_step(s.A, lambda v: v, st, j)
    x0 = torch.zeros_like(s.b)
    bufs = [tq.catchup_buffers(c, tq.init_buffers(c, x0, K, x0_zero=True),
                               st.Z, x0, STEPS, x0_zero=True)
            for c in s.constraints()]
    y0 = tarn.lsq_coeffs(st, STEPS - 1)
    return st.H.numpy(), beta, [tuple(b_.numpy() for b_ in b) for b in bufs], y0.numpy()


def _both(reduced, con_mask, warm=None):
    H, beta, bufs, y0 = reduced
    active = np.arange(K) < STEPS
    jb = tuple(ReducedBuffers(*(jnp.asarray(a) for a in b)) for b in bufs)
    tb = tuple(tq.ReducedBuffers(*(torch.tensor(a) for a in b)) for b in bufs)
    jw, tw = {}, {}
    if warm is not None:
        lam, Kinv = warm
        jw = dict(lam_ws=jnp.asarray(lam), Kinv_ws=jnp.asarray(Kinv),
                  have_ws=jnp.bool_(True))
        tw = dict(lam_ws=torch.tensor(lam), Kinv_ws=torch.tensor(Kinv),
                  have_ws=True)
    rj = _j_kkt(jnp.asarray(H), jnp.asarray(beta), jb, jnp.asarray(y0),
               jnp.asarray(active), jnp.asarray(con_mask), **jw)
    rt = t_kkt(torch.tensor(H), beta, tb, torch.tensor(y0),
               torch.tensor(active), torch.tensor(con_mask), **tw)
    return rj, rt


def _check(rj, rt):
    y_j, lam_j = np.asarray(rj.y), np.asarray(rj.lam)
    assert np.max(np.abs(rt.y.numpy() - y_j)) <= TOL * np.max(np.abs(y_j))
    lam_scale = max(np.max(np.abs(lam_j)), 1.0)
    assert np.max(np.abs(rt.lam.numpy() - lam_j)) <= TOL * lam_scale
    assert abs(rt.deviation - float(rj.deviation)) <= TOL
    assert rt.deviation <= TOL


@pytest.mark.parametrize("con_mask", [(1.0, 1.0, 1.0), (1.0, 1.0, 0.0)],
                         ids=["all", "prototypical"])
def test_constrained_lsq_matches_jax(reduced, con_mask):
    rj, rt = _both(reduced, np.asarray(con_mask))
    _check(rj, rt)
    assert rt.iters == int(rj.iters)


def test_constrained_lsq_warm_start_matches_jax(reduced):
    """Carried multipliers and KKT inverse (the gated-iteration warm start)."""
    mask = np.ones(3)
    rj0, _ = _both(reduced, mask)
    rj, rt = _both(reduced, mask, warm=(np.asarray(rj0.lam), np.asarray(rj0.Kinv)))
    _check(rj, rt)


def test_reduced_forms_match_jax(reduced):
    """Value, gradient, Hessian and roundoff scale of each reduced
    constraint, at a single point and over a batch of points."""
    from structurepreservingiterativesolvers_tpu.constraints import quadratic as jq

    _, _, bufs, y0 = reduced
    Y = y0[None, :] * np.linspace(0.5, 1.5, 4)[:, None]
    for b in bufs:
        jb = ReducedBuffers(*(jnp.asarray(a) for a in b))
        tb = tq.ReducedBuffers(*(torch.tensor(a) for a in b))
        for y in (y0, Y):
            for fj, ft in ((jq.reduced_value, tq.reduced_value),
                           (jq.reduced_grad, tq.reduced_grad)):
                want = np.stack([np.asarray(fj(jb, jnp.asarray(r)))
                                 for r in np.atleast_2d(y)])
                got = ft(tb, torch.tensor(y)).numpy().reshape(want.shape)
                assert np.max(np.abs(got - want)) <= TOL * max(np.max(np.abs(want)), 1.0)
        np.testing.assert_array_equal(tq.reduced_hess(tb).numpy(),
                                      np.asarray(jq.reduced_hess(jb)))
        assert abs(float(tq.reduced_scale(tb, torch.tensor(y0)))
                   - float(jq.reduced_scale(jb, jnp.asarray(y0)))) <= TOL
