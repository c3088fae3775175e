"""The port's f32 storage mode on its device core, on the CPU: the graph
runner's steps run eagerly here, so these hold the core's arithmetic and
control flow, held to the host loop and to the JAX package's runs
(``reference/slice15.json``):

* ``cgmres(loop="while")`` takes the host loop's steps and latch, and an
  iterate within the f32 rounding of the host loop's (lkdv M=50 from its
  warm start, heat M=32 with the AMG);
* ``cgmres_many`` in f32 (mixed by default, no projection, as the JAX
  package's): each item's steps equal to its single device-core solve's in
  the same modes, and the latch and certified deviation (within max(10x,
  1e-12 of the scale)) of the record's items (swe M=16 with the
  skew-normal Chebyshev, heat M=32 with the AMG, B = 3); the steps within
  one of the record's where the record's item stopped before k, else at
  most k.  (On swe M=16 two of the JAX package's items stall at a
  constrained residual of 7e-4-1e-3, above tol, and run to k=20; the
  port's reach 1e-4, the f32 floor of the unconstrained residual, and
  stop at step 3, certified, with the assembly's deviations of the same
  size as the record's.)
* a 3-step f32 ``fused_evolve`` on swe M=16: per step the steps within one
  of the JAX ``fused_evolve``'s, and certified where the record's step
  is;
* the command line's ``--dtype float32``.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import torch_parity
from structurepreservingiterativesolvers_torch.experiments.batched import (
    cgmres_many,
)
from structurepreservingiterativesolvers_torch.experiments.cli import main
from structurepreservingiterativesolvers_torch.experiments.evolve import (
    fused_evolve,
)
from structurepreservingiterativesolvers_torch.experiments.single_solve import (
    get_model,
)
from structurepreservingiterativesolvers_torch.experiments.timed_solve import (
    certified_deviations,
    default_pre_builder,
)
from structurepreservingiterativesolvers_torch.solvers import cgmres

SCRIPT = torch_parity.reference_script()
REC = SCRIPT.load("lkdv_M50_f32")
F32 = torch.float32


@pytest.mark.parametrize("name", ["lkdv_M50_f32_warm", "heat_M32_amg_f32"])
def test_device_core_matches_host_loop(name):
    kind, problem, params, k, tol, tol_mode, start, pre_spec = \
        SCRIPT.SLICE15[name]
    s = get_model(problem).linforms(device="cpu", dtype=F32, **params)
    pre = None if pre_spec is None else default_pre_builder(problem)(s)
    x0 = None
    if start == "warm":
        rng = np.random.default_rng(3)
        x0 = torch.as_tensor(s.b.double().numpy() + 1e-3 * rng.standard_normal(
            s.b.shape[0]), dtype=F32)
    tol_abs = REC[name]["tol_abs"]
    runs = {loop: cgmres(s.A, s.b, x0=x0, k=k, tol=tol_abs,
                         constraints=s.constraints(), pre=pre, loop=loop)
            for loop in ("host", "while")}
    (xh, ih), (xw, iw) = runs["host"], runs["while"]
    assert (iw["steps"], iw["safety"]) == (ih["steps"], ih["safety"])
    assert iw["constrained_steps"] == ih["constrained_steps"]
    torch_parity.close(xw.double().numpy(), xh.double().numpy(), 1e-4)


@pytest.mark.parametrize("name", ["swe_M16_B3_f32", "heat_M32_B3_f32"])
def test_batched_f32_matches_singles_and_record(name):
    kind, problem, params, k, tol, tol_mode, B, pre_spec = SCRIPT.SLICE15[name]
    rec = REC[name]
    s = get_model(problem).linforms(device="cpu", dtype=F32, **params)
    pre = default_pre_builder(problem)(s)
    z0 = s.z0.double().numpy()
    states = z0[None] + 0.02 * np.arange(B)[:, None] * SCRIPT.smooth_field(
        params["M"], z0, problem)[None]
    items = [s.step_update(torch.as_tensor(z, dtype=F32)) for z in states]
    X, info = cgmres_many(s.A, torch.stack([t.b for t in items]),
                          [t.constraints() for t in items], k=k,
                          tol=rec["tol_abs"], pre=pre)
    assert X.dtype == F32
    scale = max([abs(v) for v in rec["targets"].values()] + [1.0])
    for i, (t, ri) in enumerate(zip(items, rec["items"])):
        _, single = cgmres(s.A, t.b, k=k, tol=rec["tol_abs"],
                           constraints=t.constraints(), pre=pre, loop="while",
                           snap=False, f32_reduce=False)
        assert int(info["steps"][i]) == single["steps"], i
        assert int(info["safety"][i]) == ri["safety"], i
        if ri["steps"] < k:
            assert abs(int(info["steps"][i]) - ri["steps"]) <= 1, i
        assert int(info["steps"][i]) <= ri["steps"], i
        # no projection in the batch: the certified deviation is the f32
        # assembly's, as the record's
        dev = certified_deviations(t, X[i])
        bar = max(10.0 * max(ri["certified"].values()), 1e-12 * scale)
        assert max(dev.values()) <= bar, (i, dev, ri["certified"])


def test_fused_evolve_f32_matches_record():
    name = "swe_M16_fused_f32"
    kind, problem, params, k, tol, tol_mode, start, pre_spec = \
        SCRIPT.SLICE15[name]
    rec = REC[name]
    s = get_model(problem).linforms(device="cpu", dtype=F32, **params)
    pre = default_pre_builder(problem)(s)
    out = fused_evolve(problem, k=k, tol=rec["tol_abs"], pre=pre,
                       device="cpu", dtype=F32, **params)
    assert out["sol"].dtype == F32
    for got, want in zip(out["steps"].tolist(), rec["steps"]):
        assert abs(got - want) <= 1, (out["steps"], rec["steps"])
    for got, want in zip(out["safety"].tolist(), rec["safety"]):
        assert got == 1 or want != 1, (out["safety"], rec["safety"])
    assert bool(torch.isfinite(out["sol"]).all())


def test_cli_dtype_float32():
    """``timed --dtype float32`` runs the row in f32 storage and prints the
    table with a certified CGMRES."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["timed", "--problem", "swe", "--sizes", "16", "--tol", "4e-7",
              "--tol-mode", "rhs", "--dtype", "float32", "--device", "cpu"])
    row = [line for line in buf.getvalue().splitlines()
           if line.startswith("| 16 |")]
    assert row and row[0].split("|")[2].strip() == "True"
