"""The port's f32 storage mode on lkdvRK and on general constraints, on the
CPU, against the JAX package's f32 runs of the same configurations
(``reference/slice17.json``, written by ``scripts/make_torch_reference.py``
with the JAX package on the CPU in f32 storage; the JAX package is not run
here):

* lkdvRK M=20, N=10, (3, 2), k=50, tol=1e-3, with the RAS + Neumann
  composite of the TimedSolve pre-builder, through ``cgmres_wrapper`` on
  both loops: the latch equal to the record's, the steps within one of the
  record's on the host loop and at most the record's on the device core
  (which pins the stage-mapped mass, as in f64: PERF.md §2), the certified
  deviation at most max(10x the record's, 1e-12 of the invariants' scale),
  the true residual below tol, x within max(1e-5·max|x|, 10x the JAX
  package's own drift under a one-ulp change of b);
* the f64 products from f32 storage of ``StageKron``, ``MatComb`` and
  lkdv's ``_BlockDiag3`` against the recorded double-f32 ``_dd_matvec``
  (1e-14 of max|y|; ``StageKron`` through the JAX package's f32 rounding
  of its weights b·dt, which the port forms in f64), and ``StageKron``'s
  inner product on the kept upcast
  operator: two products reuse one f64 operator, bit-equal to an upcast
  per call;
* the f32 RAS and composite applies against the f64 ones (1e-6 relative),
  and ``utils/cast.py::astype`` of the f64 system and preconditioner (and
  of ``interop.ras_from_arrays`` of the exported inverses) equal, bit for
  bit, to the f32 build;
* the lkdv M=50 general-energy solve in f32 on both loops (the projection
  off, as the JAX package resolves it): the record's latch and steps, x as
  above;
* the f32 error sweep (M=20, N=3, (3, 2), ``run_single(dtype=float32)``)
  against the JAX f32 sweep: every step certified, each step's steps at
  most the record's plus one (a warm-started f32 step takes eps32's floors
  and the projection's certificate, and stops earlier than the JAX
  package's), each step's L2 error within 10x the JAX package's own
  f32-f64 gap of the record's;
* ``cgmres_many`` in f32 at B = 3 on the stepped lkdvRK items: each item
  certified, its true residual below tol, its certified deviation within
  the bar; each item's steps beside its single f32 solve's (the f32
  rounding of the block products moves the small constrained problems of
  the first gated steps across their solvability, so the counts differ by
  up to three here).
"""

import dataclasses
import importlib
import tempfile

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch import interop
from structurepreservingiterativesolvers_torch.constraints import (
    GeneralConstraint,
)
from structurepreservingiterativesolvers_torch.constraints.quadratic import (
    MatComb,
)
from structurepreservingiterativesolvers_torch.experiments import wrappers
from structurepreservingiterativesolvers_torch.experiments.batched import (
    cgmres_many,
)
from structurepreservingiterativesolvers_torch.experiments.error_sweep import (
    run_single,
)
from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
    certified_deviations,
    default_pre_builder,
)
from structurepreservingiterativesolvers_torch.models import lkdv, lkdvrk
from structurepreservingiterativesolvers_torch.ops.sparse import matvec_f64
from structurepreservingiterativesolvers_torch.solvers import cgmres
from structurepreservingiterativesolvers_torch.utils.cast import astype

SCRIPT = torch_parity.reference_script()
REC = SCRIPT.load("lkdvrk_M20_f32")
F32 = torch.float32
RK = dict(M=20, N=10, degree=3, tstages=2)


def _scale(s) -> float:
    return max(abs(float(s.m0)), abs(float(s.mo0)), abs(float(s.e0)), 1.0)


def _x_close(x, rec):
    """x within max(1e-5·max|x|, 10x the record's own drift·max|x|) of the
    record's iterate."""
    ref = np.asarray(rec["x"])
    bar = max(1e-5, 10.0 * rec["own_drift"]) * np.abs(ref).max()
    err = np.abs(x.double().numpy() - ref).max()
    assert err <= bar, (err, bar)


@pytest.mark.parametrize("loop", ["host", "while"])
def test_lkdvrk_f32_solve_matches_record(loop):
    rec = REC["lkdvrk_M20_f32"]
    s = lkdvrk.linforms(device="cpu", dtype=F32, **rec["config"]["params"])
    assert type(s.A).__name__ == rec["operator"]["format"]
    pre = default_pre_builder("lkdvrk")(s)
    assert pre.inner.inv.dtype == F32
    assert list(pre.inner.idx.shape) == rec["ras_blocks"]
    tol = rec["config"]["tol"]
    assert wrappers.reduction_mode(s, tol) == rec["reduction_mode"]
    x, info = wrappers.cgmres_wrapper(s, k=rec["config"]["k"], tol=tol,
                                      pre=pre, loop=loop)
    r = rec["cgmres"]
    assert x.dtype == F32
    assert info["safety"] == r["safety"] is True
    if loop == "host":
        assert abs(info["steps"] - r["steps"]) <= 1
    else:
        assert 1 <= info["steps"] <= r["steps"]
    dev = certified_deviations(s, x)
    bar = max(10.0 * max(r["certified"].values()), 1e-12 * _scale(s))
    assert max(dev.values()) <= bar, (dev, r["certified"])
    assert float(torch.linalg.norm((s.A @ x - s.b).double())) < tol
    _x_close(x, r)


def test_f64_products_match_dd_matvec():
    """StageKron (the stage-mapped energy), its inner _BlockDiag3 and a
    MatComb of lkdvRK's M and G, at the recorded seeded f32 vectors, within
    1e-14 of max|y|.  The JAX package's ``_dd_matvec`` rounds the stage
    map's weights b·dt to f32 before splitting them, where the port forms
    their f64 product (its certificate then measures the map the solve
    enforces: with the rounded weights the quadratic term is off by 1.5e-8
    relative, above the certificate's floor at lkdvRK M=400): the port's
    StageKron is held to the record through that rounding (a StageKron of
    the rounded weights, dt 1, equal to it within 1e-14) and its own
    product within 1e-7 of it."""
    ops = REC["dd_matvec_f32"]["ops"]
    s = lkdvrk.linforms(device="cpu", dtype=F32, **RK)
    energy = s.constraints()[2].M
    rounded = dataclasses.replace(energy, b=energy.b * energy.dt, dt=1.0)
    mine = {"StageKron": rounded, "BlockDiag3": energy.inner,
            "MatComb": MatComb((1.0, -0.5), (s.Mmat, s.Gmat))}
    for key, M in mine.items():
        rec = ops[key]
        x = torch.from_numpy(np.random.default_rng(rec["seed"]).standard_normal(
            rec["n"]).astype(np.float32))
        y = matvec_f64(M, x)
        ref = np.asarray(rec["y"])
        assert y.dtype == torch.float64
        assert np.abs(y.numpy() - ref).max() <= 1e-14 * np.abs(ref).max(), key
        if key == "StageKron":
            exact = matvec_f64(energy, x).numpy()
            assert np.abs(exact - ref).max() <= 1e-7 * np.abs(ref).max()


def test_stagekron_keeps_its_upcast_operator():
    """StageKron hands its inner mass matrix the f64 vector P x: the f32
    DIA keeps one upcast operator (``DIA.upcast``), so two products reuse
    it, bit-equal to an upcast made per call."""
    s = lkdvrk.linforms(device="cpu", dtype=F32, **RK)
    K = s.constraints()[2].M
    M = K.inner.Mmat
    assert M.dtype == F32 and M._upcast is None
    X = torch.from_numpy(np.random.default_rng(5).standard_normal(
        K.shape[0]).astype(np.float32))
    y1 = matvec_f64(K, X)
    up = M._upcast
    assert up is not None and up.dtype == torch.float64
    y2 = matvec_f64(K, X)
    assert M._upcast is up and torch.equal(y1, y2)
    per_call = M.astype(torch.float64)
    assert torch.equal(up.data, per_call.data)
    # the product through an upcast made per call, field by field
    bd = K.b.double() * K.dt
    Xs = X.double().reshape(K.ns, -1)
    PX = torch.tensordot(bd, Xs, dims=1)
    parts = torch.tensor_split(PX, 3)
    v = torch.cat([c * (per_call @ p) if c else torch.zeros_like(p)
                   for c, p in zip(K.inner.coeffs, parts)])
    ref = (bd[:, None] * v[None]).reshape(-1)
    assert torch.equal(y1, ref)


def test_f32_composite_and_cast():
    """The RAS inverses and the composite in f32 against f64 (1e-6 of the
    result's max), on a vector and on the core's (n, B) block; the cast of
    the f64 build equal to the f32 build."""
    s64 = lkdvrk.linforms(device="cpu", **RK)
    s32 = lkdvrk.linforms(device="cpu", dtype=F32, **RK)
    p64 = default_pre_builder("lkdvrk")(s64)
    p32 = default_pre_builder("lkdvrk")(s32)
    c32 = astype((s64, p64), F32)
    for a, b in ((c32[0].A.data, s32.A.data), (c32[0].b, s32.b),
                 (c32[0].Mmat.data, s32.Mmat.data), (c32[0].bw, s32.bw),
                 (c32[1].inner.inv, p32.inner.inv), (c32[1].A.data, p32.A.data)):
        assert a.dtype == F32 and torch.equal(a, b)
    # the exported inverses rebuilt (``interop``), then cast
    r32 = astype(interop.ras_from_arrays(p64.inner.idx.numpy(),
                                         p64.inner.inv.numpy(),
                                         p64.inner.own.numpy(), device="cpu"),
                 F32)
    assert torch.equal(r32.inv, p32.inner.inv)
    rng = np.random.default_rng(7)
    V = rng.standard_normal((3, s64.b.shape[0]))
    for apply64, apply32 in ((p64.inner, p32.inner), (p64, p32)):
        y64 = apply64(torch.from_numpy(V[0]))
        y32 = apply32(torch.from_numpy(V[0]).to(F32))
        assert y32.dtype == F32
        assert (y32.double() - y64).abs().max() <= 1e-6 * y64.abs().max()
        Y64 = apply64(torch.from_numpy(V).T)
        Y32 = apply32(torch.from_numpy(V).to(F32).T)
        assert (Y32.double() - Y64).abs().max() <= 1e-6 * Y64.abs().max()


def test_general_f32_matches_record():
    rec = REC["lkdv_M50_general_f32"]
    cfg, r = rec["config"], rec["cgmres"]
    s = lkdv.linforms(device="cpu", dtype=F32, **cfg["params"])

    def energy(x):
        u, _, w = torch.split(x, s.n0)
        return (0.5 * torch.dot(w, s.Mmat @ w) - 0.5 * torch.dot(u, s.Mmat @ u)
                - s.e0)

    cons = list(s.constraints())
    cons[2] = GeneralConstraint(func=energy, name="energy")
    for loop in ("host", "while"):
        with pytest.warns(RuntimeWarning, match="failed to preserve"):
            x, info = cgmres(s.A, s.b, k=cfg["k"], tol=cfg["tol"],
                             constraints=cons, loop=loop)
        assert x.dtype == F32
        assert info["safety"] == r["safety"]
        assert abs(info["steps"] - r["steps"]) <= 1
        assert info["deviation"] <= max(10.0 * r["deviation"], 1e-12 * 40.0)
        _x_close(x, r)


def test_f32_sweep_matches_record():
    rec = REC["lkdvrk_M20_sweep_f32"]
    cfg = rec["config"]
    (degree, tstages, tol), = cfg["grid"]
    key = f"CGMRES_{degree}_{tstages}"
    r32, r64 = rec["f32"][key], rec["f64"][key]
    gap = np.abs(np.asarray(r32["err"]) - np.asarray(r64["err"])).max()
    with tempfile.TemporaryDirectory() as tmp:
        out = run_single("CGMRES", degree, tstages, tol, N=cfg["N"],
                         M=cfg["M"], k=cfg["k"], tmpdir=tmp, loop="while",
                         dtype=F32, device="cpu")
        assert out["dtype"] == "float32"
    assert all(v is True for v in out["safety"])
    # a warm-started f32 step takes eps32's floors and the projection's
    # certificate: at most the record's steps plus one
    assert all(1 <= a <= b + 1 for a, b in zip(out["steps"], r32["steps"]))
    err = np.asarray(out["err"])
    assert np.abs(err - np.asarray(r32["err"])).max() <= 10.0 * gap


def test_cgmres_many_f32():
    tcg = importlib.import_module(
        "structurepreservingiterativesolvers_torch.solvers.cgmres")
    params = dict(M=20, N=4, degree=3, tstages=2, T=0.4)
    s = lkdvrk.linforms(device="cpu", dtype=F32, **params)
    pre = default_pre_builder("lkdvrk")(s)
    p = SCRIPT.lkdvrk_field(s.fem, s.prob.mlength,
                            s.z0[:s.n0].double().numpy())
    states = SCRIPT.lkdvrk_stage_states(p, 3, s.prob.ns, s.n0, s.prob.dt)
    items = [s.step_update(torch.as_tensor(z, dtype=F32)) for z in states]
    cons = [t.constraints() for t in items]
    tol = 1e-3
    X, info = cgmres_many(s.A, torch.stack([t.b for t in items]), cons,
                          k=50, tol=tol, pre=pre)
    assert X.dtype == F32
    bar = 10.0 * max(REC["lkdvrk_M20_f32"]["cgmres"]["certified"].values())
    for i, t in enumerate(items):
        _, single = tcg.cgmres(s.A, t.b, k=50, tol=tol, constraints=cons[i],
                               pre=pre, loop="while", snap=False,
                               f32_reduce=False)
        assert int(info["safety"][i]) == 1 and single["safety"] is True
        assert abs(int(info["steps"][i]) - single["steps"]) <= 3
        assert float(torch.linalg.norm((t.A @ X[i] - t.b).double())) < tol
        assert max(certified_deviations(t, X[i]).values()) <= bar
