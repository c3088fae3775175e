"""The PyTorch port runs where JAX does not exist: the machine with the card
has no JAX.  A subprocess that blocks ``import jax`` and the JAX package
imports the port, runs lkdv CGMRES, the SingleSolve command line, the heat
and swe TimedSolve command lines and the swe Evolve command line (with the
fused orthogonalisation's plain twin) on the CPU, the device core
(``cgmres(loop="while")``) and ``fused_evolve`` eagerly on the CPU, and
imports the lkdvRK modules, the graph runner and the profiling module, and
runs ``cgmres_many``; and runs heat P2's TimedSolve row
with the greedy host AMG, the ILU and direct oracles and the native host
kernels, imports the reporting module, and checks that none of these pulls
in pandas or matplotlib; and imports the distribution layer (``parallel/``,
with every public name of the JAX package's ``parallel/__init__.py``) and
``experiments/scaling.py``, and runs a sharded solve's scaling row in a
world of one gloo process.  The package's surface is the JAX package's,
importable without JAX, matplotlib or pandas."""

import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "structurepreservingiterativesolvers_torch"

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["structurepreservingiterativesolvers_tpu"] = None
import torch
torch.set_num_threads(1)
from structurepreservingiterativesolvers_torch.models import lkdv
from structurepreservingiterativesolvers_torch.solvers import cgmres
s = lkdv.linforms(M=50, degree=1, device="cpu")
x, info = cgmres(s.A, s.b, k=30, tol=1e-10, constraints=s.constraints())
print("SOLVE", info["steps"], info["constrained_steps"], info["safety"],
      info["deviation"])
from structurepreservingiterativesolvers_torch.experiments.cli import main
main(["single", "--problem", "lkdv", "--M", "50", "--k", "20",
      "--device", "cpu"])
main(["timed", "--problem", "heat", "--sizes", "16", "--device", "cpu"])
main(["timed", "--problem", "swe", "--sizes", "16", "--device", "cpu",
      "--ortho", "cgs2_fused"])
main(["evolve", "--problem", "swe", "--M", "16", "--N", "2", "--k", "30",
      "--tol", "1e-8", "--device", "cpu", "--ortho", "cgs2_fused"])
x2, info2 = cgmres(s.A, s.b, k=30, tol=1e-10, constraints=s.constraints(),
                   loop="while")
print("DEVICE", info2["steps"], info2["safety"], float((x2 - x).abs().max()))
from structurepreservingiterativesolvers_torch.experiments.evolve import fused_evolve
out = fused_evolve("swe", N=2, M=8, k=20, tol=1e-8, device="cpu")
print("FUSED", out["safety"].tolist())
from structurepreservingiterativesolvers_torch.experiments.batched import cgmres_many
items = [s.step_update(s.z0 * (1.0 + 0.01 * i)) for i in range(3)]
X, binfo = cgmres_many(s.A, torch.stack([t.b for t in items]),
                       [t.constraints() for t in items], k=20, tol=1e-8)
print("BATCHED", binfo["steps"].tolist(), binfo["safety"].tolist())
from structurepreservingiterativesolvers_torch.solvers import cg, graphs
from structurepreservingiterativesolvers_torch.utils import checkpoint, profiling
from structurepreservingiterativesolvers_torch.experiments import error_sweep
from structurepreservingiterativesolvers_torch.models import fixtures, lkdvrk
from structurepreservingiterativesolvers_torch import interop
from structurepreservingiterativesolvers_torch.experiments import report
from structurepreservingiterativesolvers_torch.experiments.timed_solve import time_cgmres
row = time_cgmres("heat", M=8, degree=2, k=60, tol=1e-7, device="cpu")
print("P2", row["steps"], row["safety"])
from structurepreservingiterativesolvers_torch.models import lkdvrk as rk
from structurepreservingiterativesolvers_torch.precond.ilu_oracle import direct_oracle, ilu_oracle
r = rk.linforms(M=20, degree=3, tstages=2, device="cpu")
for oracle in (ilu_oracle, direct_oracle):
    _, ginfo = cgmres(r.A, r.b, k=30, tol=1e-8, pre=oracle(r.A_csr, device="cpu"))
    print("ORACLE", ginfo["steps"] <= 5)
from structurepreservingiterativesolvers_torch.utils import native
if native.available():
    import numpy as np
    print("NATIVE", float(np.abs(native.csr_spmv(r.A_csr, r.b.numpy()) - r.A_csr @ r.b.numpy()).max()) < 1e-10)
from structurepreservingiterativesolvers_torch import parallel
from structurepreservingiterativesolvers_torch.experiments import scaling
names = ["ROWS", "make_mesh", "replicated", "shard_constraint", "shard_matrix",
         "shard_preconditioner", "shard_system", "shard_vector", "HaloDia",
         "dia_spmv_halo", "CHIPS", "HOSTS", "global_mesh", "host_chip_mesh",
         "init_distributed", "is_coordinator", "spawn_local"]
assert all(hasattr(parallel, nm) for nm in names)
assert all(hasattr(scaling, nm) for nm in ("spmv_scaling", "solve_scaling",
           "report", "dist_bench_worker", "dist_efficiency"))
srows = scaling.solve_scaling("swe", M=8, k=15, tol=1e-8, device_counts=[1],
                              device="cpu")
print("SCALING", [r["devices"] for r in srows], srows[0]["efficiency"])
from structurepreservingiterativesolvers_torch.constraints import projection
s32 = lkdv.linforms(M=50, degree=1, device="cpu", dtype=torch.float32)
x32, info32 = cgmres(s32.A, s32.b, k=20, tol=1e-5, constraints=s32.constraints(),
                     loop="while")
print("F32", info32["safety"], x32.dtype, projection.snap_supported(s32.constraints()))
assert "pandas" not in sys.modules and "matplotlib" not in sys.modules
assert not any(m.split(".")[0] in ("jax", "structurepreservingiterativesolvers_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_port_imports_and_solves_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    solve = [ln for ln in proc.stdout.splitlines() if ln.startswith("SOLVE")]
    _, steps, ncon, safety, dev = solve[0].split()
    assert safety == "True" and float(dev) <= 1e-10
    assert int(steps) >= 1 and int(ncon) >= 1
    # the device core (eager on the CPU) and fused_evolve run without JAX
    device = [ln for ln in proc.stdout.splitlines() if ln.startswith("DEVICE")]
    _, steps2, safety2, dx = device[0].split()
    assert steps2 == steps and safety2 == "True" and float(dx) <= 1e-10
    assert "FUSED [1, 1]" in proc.stdout
    # heat P2 with the greedy AMG, the oracles and the native kernels
    assert re.search(r"^P2 \d+ True$", proc.stdout, re.M)
    assert proc.stdout.count("ORACLE True") == 2
    assert "NATIVE False" not in proc.stdout
    # the distribution layer: the sharded solve's one-device row
    assert "SCALING [1] 1.0" in proc.stdout
    # the f32 storage mode and its projection run without JAX
    assert "F32 True torch.float32 True" in proc.stdout
    # the batched solve of the JAX package's own test runs without JAX
    assert "BATCHED [18, 18, 18] [1, 1, 1]" in proc.stdout
    # SingleSolve prints every invariant deviation of the three solvers;
    # the prototypical CGMRES ones are at roundoff
    cg = re.findall(r"^cgmres \w+ deviation = (\S+)$", proc.stdout, re.M)
    assert len(cg) == 3 and max(abs(float(d)) for d in cg) <= 1e-10
    # the TimedSolve tables: one heat row and one swe row, certified
    rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("| 16 |")]
    assert len(rows) == 2 and all(r.split("|")[2].strip() == "True"
                                  for r in rows)
    # the Evolve drifts of mass and energy, at roundoff
    drifts = re.findall(r"^final d(?:m|e): (\S+)$", proc.stdout, re.M)
    assert len(drifts) == 2 and max(float(d) for d in drifts) <= 1e-9


SURFACE = r"""
import sys
for name in ("jax", "structurepreservingiterativesolvers_tpu", "matplotlib",
             "pandas"):
    sys.modules[name] = None  # any import of these now raises ImportError
import structurepreservingiterativesolvers_torch as spt
from structurepreservingiterativesolvers_torch.kernels import build
for sub in ("config", "ops", "solvers", "constraints", "precond", "models",
            "parallel", "experiments", "utils", "kernels"):
    assert sub in spt.__all__ and hasattr(spt, sub), sub
for sub in ("fem1d", "fem2d", "fixtures", "heat", "lkdv", "lkdvrk", "swe",
            "tableaux"):
    assert hasattr(spt.models, sub), sub
for name in ("error_sweep", "report", "wrappers", "deviation_plotter",
             "evolve", "single_solve", "time_cgmres", "timed_solve",
             "scaling", "batched"):
    assert hasattr(spt.experiments, name), name
for name in ("IdentityPreconditioner", "AMG", "amg", "DenseApply",
             "direct_oracle", "ilu_oracle", "as_preconditioner"):
    assert hasattr(spt.precond, name), name
for name in ("checkpoint", "native", "profiling"):
    assert hasattr(spt.utils, name), name
ident = spt.precond.IdentityPreconditioner()
import torch
v = torch.arange(3.0)
assert ident(v) is v and ident.solve(v) is v
# the quick start's spelling, on the CPU
s = spt.models.lkdv.linforms(M=20, degree=1, device="cpu")
x, info = spt.solvers.cgmres(s.A, s.b, k=20, tol=1e-8,
                             constraints=s.constraints())
assert info["safety"] is True
# importing built and loaded no kernel and started no process group
assert build.build.cache_info().currsize == 0
assert build.load.cache_info().currsize == 0
import torch.distributed as dist
assert not (dist.is_available() and dist.is_initialized())
print("SURFACE OK")
"""


def test_package_surface_without_jax():
    """``import structurepreservingiterativesolvers_torch as spt`` binds the
    JAX package's subpackages (``models``, ``parallel``, ``experiments``,
    ``utils``) and exports its names of ``experiments``, ``models`` and
    ``precond`` (``IdentityPreconditioner``, ``AMG``, ``amg``, the
    oracles), where neither JAX, the JAX package, matplotlib nor pandas
    can be imported; the quick start runs as written, and the import
    builds no kernel and starts no process group."""
    proc = subprocess.run([sys.executable, "-c", SURFACE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "SURFACE OK" in proc.stdout


def test_port_sources_never_import_jax():
    """Neither the port, ``chip_smoke.py`` nor the port's convergence-order
    study (``scripts/run_error_order_torch.py``) imports JAX or the JAX
    package, not even a module of it that does not import JAX."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|structurepreservingiterativesolvers_tpu)\b"
        r"|import_module\(\s*[\"'](jax|structurepreservingiterativesolvers_tpu)\b",
        re.M)
    sources = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
               ROOT / "scripts" / "run_error_order_torch.py"]
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("from structurepreservingiterativesolvers_tpu.models import fem2d")
    assert pattern.search("    import jax.numpy as jnp")


def test_general_constraints_not_ported():
    """The parity test of tests/test_cgmres_lkdv.py::
    test_general_constraint_matches_quadratic (the name is kept from when
    the port refused general constraints): the energy written as a
    ``GeneralConstraint`` callable certifies (``safety=True``), its
    invariant deviations and iterate match the quadratic path's, and its
    ``taylor_buffers`` match the JAX package's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from structurepreservingiterativesolvers_torch.constraints import (
        GeneralConstraint,
        taylor_buffers,
    )
    from structurepreservingiterativesolvers_torch.models import lkdv
    from structurepreservingiterativesolvers_torch.solvers import cgmres
    from structurepreservingiterativesolvers_tpu.constraints import general as jgen
    from structurepreservingiterativesolvers_tpu.models import lkdv as jlkdv

    s = lkdv.linforms(degree=3, M=100, N=100, device="cpu")  # the hard system
    mass, mom, energy_q = s.constraints()

    def energy(x):
        u, _, w = torch.split(x, s.n0)
        return (0.5 * torch.dot(w, s.Mmat @ w) - 0.5 * torch.dot(u, s.Mmat @ u)
                - s.e0)

    gen = GeneralConstraint(func=energy, name="energy")
    xq, iq = cgmres(s.A, s.b, k=50, tol=1e-6, constraints=[mass, mom, energy_q])
    xg, ig = cgmres(s.A, s.b, k=50, tol=1e-6, constraints=[mass, mom, gen])
    assert ig["safety"] is True and iq["safety"] is True

    def devs(x):
        inv = s.compute_invariants(x)
        return np.array([float(inv[k] - t) for k, t in
                         (("mass", s.m0), ("momentum", s.mo0),
                          ("energy", s.e0))])

    dq, dg = devs(xq), devs(xg)
    assert np.abs(dg).max() < 1e-9
    assert np.abs(dg - dq).max() <= 1e-10
    np.testing.assert_allclose(xg.numpy(), xq.numpy(), rtol=1e-6, atol=1e-10)

    # the Taylor model about seeded coefficients, in both packages
    js = jlkdv.linforms(degree=3, M=100, N=100)

    def jenergy(x):
        u, _, w = jnp.split(x, 3)
        return (0.5 * jnp.dot(w, js.Mmat @ w) - 0.5 * jnp.dot(u, js.Mmat @ u)
                - js.e0)

    rng = np.random.default_rng(4)
    Z = rng.standard_normal((6, s.b.shape[0]))
    x0, y0 = rng.standard_normal(s.b.shape[0]), rng.standard_normal(6)
    bt = taylor_buffers(gen, torch.as_tensor(y0), torch.as_tensor(Z),
                        torch.as_tensor(x0))
    jcon = jgen.GeneralConstraint(func=jenergy)
    bj = jax.jit(lambda y, Z, x: jgen.taylor_buffers(jcon, y, Z, x))(
        jnp.asarray(y0), jnp.asarray(Z), jnp.asarray(x0))
    for a, b in zip(bt, bj):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-10 * max(np.abs(b).max(), 1.0)
