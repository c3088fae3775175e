"""The lkdvRK stage system of the PyTorch port against the JAX package and
the committed fixture, at M=50, degree 3, 2 stages (n = 1,200, A a wrapped
DIA of 42 diagonals), in f64 on the CPU: the Gauss–Legendre tableaux,
assembly, the stage-mapped constraints and their ``StageKron`` operators,
``step_update`` and the L2 error.

Tolerances: assembly runs the same numpy/scipy code in both packages
(1e-13 relative); the constraints and one ``step_update`` add a few
products (1e-12 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.constraints import StageKron
from structurepreservingiterativesolvers_torch.models import fixtures as tfix
from structurepreservingiterativesolvers_torch.models import lkdvrk as tlkdvrk
from structurepreservingiterativesolvers_torch.models.tableaux import (
    gauss_legendre as t_gl,
)
from structurepreservingiterativesolvers_tpu.models import fixtures as jfix
from structurepreservingiterativesolvers_tpu.models import lkdvrk as jlkdvrk
from structurepreservingiterativesolvers_tpu.models.tableaux import (
    gauss_legendre as j_gl,
)

FIXTURE = torch_parity.ROOT / "fixtures" / "lkdvrk_M50_deg3_s2.npz"
PARAMS = dict(N=10, M=50, degree=3, tstages=2)
TARGETS = {"mass": "m0", "momentum": "mo0", "energy": "e0"}
close = torch_parity.close


@pytest.fixture(scope="module")
def systems():
    js = jlkdvrk.linforms(**PARAMS)
    ts = tlkdvrk.linforms(**PARAMS, device="cpu")
    rng = np.random.default_rng(5)
    return js, ts, rng.standard_normal(ts.b.shape[0])


def test_tableaux_match_jax():
    for s in range(1, 6):
        for a, b in zip(t_gl(s), j_gl(s)):
            np.testing.assert_array_equal(a, b)


def test_linforms_matches_jax_and_fixture(systems, tmp_path):
    js, ts, x = systems
    assert type(ts.A).__name__ == type(js.A).__name__ == "DIA"
    assert ts.A.offsets == js.A.offsets and len(ts.A.offsets) == 42
    assert ts.A.wrap and js.A.wrap
    close(ts.A.data.numpy(), np.asarray(js.A.data), 1e-13)
    for key in ("b", "z0", "omega", "m0", "mo0", "e0"):
        close(getattr(ts, key).numpy(), np.asarray(getattr(js, key)), 1e-13)
    # the committed fixture (N=100, linforms' default): the operator, b and
    # z0, and its constraints (stored as plain quadratics) in both
    # packages' loaders
    tf = tlkdvrk.linforms(M=50, degree=3, tstages=2, device="cpu")
    At, bt, zt, ct, Acsr = tfix.load_fixture(str(FIXTURE), device="cpu")
    _, bj, _, cj, _ = jfix.load_fixture(str(FIXTURE))
    assert abs(Acsr - tf.A_csr).max() <= 1e-13 * abs(tf.A_csr).max()
    close(bt.numpy(), tf.b.numpy(), 1e-13)
    close(zt.numpy(), tf.z0.numpy(), 1e-13)
    assert type(At).__name__ == "DIA"
    # g(x) is the difference of an invariant and its target, which cancel
    # to a few digits at this x: relative to the invariant's size
    for c_t, c_j, c_s in zip(ct, cj, tf.constraints()):
        assert c_t.name == c_j.name == c_s.name
        scale = abs(float(getattr(tf, TARGETS[c_s.name])))
        val = float(c_t(torch.as_tensor(x)))
        assert abs(val - float(c_j(jnp.asarray(x)))) <= 1e-12 * scale
        assert abs(val - float(c_s(torch.as_tensor(x)))) <= 1e-12 * scale
    # the port writes a fixture that the JAX package reads back
    tfix.save_fixture(str(tmp_path / "rk.npz"), tf, "lkdvrk")
    _, bw, zw, cw, Aw = jfix.load_fixture(str(tmp_path / "rk.npz"))
    assert abs(Aw - Acsr).max() == 0.0
    np.testing.assert_array_equal(np.asarray(bw), np.asarray(bj))
    np.testing.assert_array_equal(np.asarray(zw), zt.numpy())
    for c_w, c_j in zip(cw, cj):
        assert abs(float(c_w(jnp.asarray(x))) - float(c_j(jnp.asarray(x)))) <= (
            1e-12 * abs(float(getattr(tf, TARGETS[c_w.name]))))


def test_stage_kron_matches_jax(systems):
    js, ts, x = systems
    X = np.random.default_rng(6).standard_normal((x.shape[0], 4))
    for c_j, c_t in zip(js.constraints()[1:], ts.constraints()[1:]):
        Kj, Kt = c_j.M, c_t.M
        assert isinstance(Kt, StageKron) and Kt.ns == 2
        close((Kt @ torch.as_tensor(x)).numpy(),
              np.asarray(Kj @ jnp.asarray(x)), 1e-13)
        close((Kt @ torch.as_tensor(X)).numpy(),
              np.asarray(Kj @ jnp.asarray(X)), 1e-13)
        close(Kt.todense().numpy(), np.asarray(Kj.todense()), 1e-13)


def test_stage_mapped_constraints_match_jax(systems):
    """Values and gradients at a seeded stage vector, and the identity
    behind ``stage_mapped``: each constraint is the deviation of its
    invariant at the reconstructed z1."""
    js, ts, x = systems
    xt = torch.as_tensor(x)
    inv = ts.compute_invariants(xt)
    for c_j, c_t in zip(js.constraints(), ts.constraints()):
        assert c_t.name == c_j.name
        val = float(c_t(xt))
        close(val, float(c_j(jnp.asarray(x))), 1e-12)
        close(c_t.grad(xt).numpy(), np.asarray(c_j.grad(jnp.asarray(x))), 1e-12)
        target = getattr(ts, TARGETS[c_t.name])
        close(val, float(inv[c_t.name] - target), 1e-10)


def test_step_update_and_error_match_jax(systems):
    js, ts, x = systems
    assert type(ts.Minv).__name__ == "BSR" and ts.Minv.block_size == 4
    np.testing.assert_array_equal(ts.Minv.blocks.numpy(),
                                  np.asarray(js.Minv.blocks))
    uj, ut = js.step_update(jnp.asarray(x)), ts.step_update(torch.as_tensor(x))
    for key in ("b", "z0", "m0", "mo0", "e0"):
        close(getattr(ut, key).numpy(), np.asarray(getattr(uj, key)), 1e-12)
    close(ts.compute_error(torch.as_tensor(x), 0.1),
          js.compute_error(jnp.asarray(x), 0.1), 1e-12)
    # the system carried across by interop is the port's own
    tw = torch_parity.to_port(js)
    assert tw.A.offsets == ts.A.offsets
    np.testing.assert_array_equal(tw.A.data.numpy(), ts.A.data.numpy())
    close(tw.step_update(torch.as_tensor(x)).b.numpy(), ut.b.numpy(), 1e-13)
