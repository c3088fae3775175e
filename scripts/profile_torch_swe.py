"""Where a shallow-water solve of the PyTorch port spends its time on the
card: one GMRES and one CGMRES solve at swe M=512 (f64, k=60, tol=1e-9)
under ``torch.profiler``, after an untimed warm-up pass.

    python scripts/profile_torch_swe.py [--M 512] [--out build/profile]

Prints the busiest device kernels, the device-busy time against the wall
time of each solve (the device's idle share), and writes a Chrome trace per
solver into ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--M", type=int, default=512)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_swe: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from structurepreservingiterativesolvers_torch.experiments import wrappers
    from structurepreservingiterativesolvers_torch.models import swe

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    s = swe.linforms(M=args.M, device="cuda")
    solves = {
        "gmres": lambda: wrappers.gmres_wrapper(s, k=60, tol=1e-9),
        "cgmres": lambda: wrappers.cgmres_wrapper(s, k=60, tol=1e-9),
    }
    for fn in solves.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name, fn in solves.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, info = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        busy_us = sum(e.self_device_time_total for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"\n== {name} M={args.M}: steps {info['steps']}, wall "
              f"{wall * 1e3:.3f} ms (profiled), device busy {busy_us / 1e3:.3f} ms "
              f"-> idle share {1 - busy_us / 1e6 / wall:.3f}")
        print(events.table(sort_by="self_device_time_total", row_limit=15,
                           max_name_column_width=60))
        prof.export_chrome_trace(str(out / f"trace_swe{args.M}_{name}.json"))


if __name__ == "__main__":
    main()
