#!/usr/bin/env python3
"""Before/after device times of the plane-to-plane pair kernel (B3) on one
CUDA card, in one process.

    python3 pair_kernel_ab.py --parent OLD_CHECKOUT

``OLD_CHECKOUT`` is an earlier checkout of this repository whose
plane-to-plane kernel takes pre-gathered rows:
``fused_math.aniso_pair(params, ptsT, megaT, scovT)`` on
``gather_megaT(..., table="aux")``. Its package is loaded beside this
tree's (under another name; it builds its kernels into its own
``build/``), and both run on chip_smoke.py's kernel-phase inputs (the next
sweep's N = 65,536 points against a Berlin-shape map with its aux table,
at the polish's K = 1).

In turns (the order reversed every other round), median of 10 rounds of
chip_smoke.time_ms (CUDA events around 20 back-to-back calls queued behind
a device-side spin), it times:

- the old kernel on the old ``gather_megaT``'s aux rows and the new one on
  (``regmap.packed_aux``, rows); the old path (``gather_megaT(aux)`` + the
  old kernel) and the new path (``grid_rows`` + the new kernel): one
  polish evaluation each;
- the old ``gather_megaT(aux)`` and ``grid_rows`` alone;
- both kernels on the first 128, 2,048, 16,384 and 65,536 points (what a
  launch costs apart from its points);
- each kernel's own device time per launch from torch.profiler (CUDA
  kernel records, without the gaps between launches).

Both kernels are held against the plain version with chip_smoke.py's
tolerances. It prints the card line, one line per measurement and, last,
one JSON object with every time. It exits non-zero without a card.
"""
import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load_parent(checkout):
    """The earlier checkout's ``slamtpu_torch.ndt.fused_math``, imported as
    package ``parent_slamtpu_torch``."""
    pkg = os.path.join(os.path.abspath(checkout), "slamtpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_slamtpu_torch", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_slamtpu_torch"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_slamtpu_torch.ndt.fused_math")


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="an earlier checkout of this repository")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pair_kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as cs
    import simulator_np
    import slamtpu_torch  # noqa: F401  (sets the float32 matmul policy)
    from slamtpu_torch.ins import imu_config
    from slamtpu_torch.lidar import ouster
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.ndt.regmap import grid_rows
    from slamtpu_torch.runtime import config as tconfig

    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)}")
    old = load_parent(args.parent)
    old._load()
    fused_math._load()

    cfg = cs.berlin_cfg(tconfig, ouster, imu_config)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "berlin.rpl")
        gt = simulator_np.simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=4, skewed=True)
        inp = cs.kernel_inputs(torch, path, gt, cfg, dev)
    N, ptsT, scovT, params = inp["N"], inp["ptsT"], inp["scovT"], inp["p_aniso"]
    pts, mask, pose, regmap, rows = inp["pts"], inp["mask"], inp["pose"], inp["regmap"], inp["rows"]
    aux = regmap.packed_aux

    def old_gather():
        return old.gather_megaT(pts, mask, pose, regmap, cs.GRID, table="aux")

    megaT = old_gather()
    result = {"card": card, "N": N, "times": {}, "scaling": {}, "profiled_us": {}}
    label = "B3 aniso_pair K=1"
    ref = fused_math._aniso_pair_plain(params, ptsT, aux, rows, scovT)
    cs.log(f"{label}: old kernel, then the new one, against plain")
    cs.compare(old.aniso_pair(params, ptsT, megaT, scovT), ref)
    cs.compare(fused_math.aniso_pair(params, ptsT, aux, rows, scovT), ref)
    times = in_turns(torch, cs, {
        "old_kernel": lambda: old.aniso_pair(params, ptsT, megaT, scovT),
        "new_kernel": lambda: fused_math.aniso_pair(params, ptsT, aux, rows, scovT),
        "old_path": lambda: old.aniso_pair(params, ptsT, old_gather(), scovT),
        "new_path": lambda: fused_math.aniso_pair(
            params, ptsT, aux, grid_rows(pts, mask, pose, regmap, cs.GRID), scovT),
        "old gather_megaT(aux)": old_gather,
        "grid_rows": lambda: grid_rows(pts, mask, pose, regmap, cs.GRID),
    })
    result["times"][label] = times
    cs.log(f"[{card}] {label}: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (rounds {v['min']:.4f}..{v['max']:.4f})" for k, v in times.items())
        + f"; old/new kernel {times['old_kernel']['ms'] / times['new_kernel']['ms']:.2f}x, "
        f"path {times['old_path']['ms'] / times['new_path']['ms']:.2f}x")
    result["profiled_us"][label] = {
        "old_kernel": profiled_us(torch, lambda: old.aniso_pair(params, ptsT, megaT, scovT)),
        "new_kernel": profiled_us(torch, lambda: fused_math.aniso_pair(params, ptsT, aux, rows, scovT)),
        "grid_rows": profiled_us(torch, lambda: grid_rows(pts, mask, pose, regmap, cs.GRID)),
    }
    cs.log(f"[{card}] {label} profiled device us per call: {result['profiled_us'][label]}")

    for n in (128, 2048, 16384, N):
        pT, r, mT = ptsT[:, :n].contiguous(), rows[:n].contiguous(), megaT[:, :n].contiguous()
        sT = scovT[:, :n].contiguous()
        times = in_turns(torch, cs, {
            "old_kernel": lambda: old.aniso_pair(params, pT, mT, sT),
            "new_kernel": lambda: fused_math.aniso_pair(params, pT, aux, r, sT),
        })
        result["scaling"][f"K=1 N={n}"] = {k: v["ms"] for k, v in times.items()}
        cs.log(f"[{card}] B3 K=1 on {n} points: old {times['old_kernel']['ms']:.4f} ms, "
               f"new {times['new_kernel']['ms']:.4f} ms")
    cs.log(card)
    cs.log(json.dumps(result))
    return 0


def in_turns(torch, cs, fns):
    """Median device ms per call of each function over cs.TIMED_ROUNDS
    rounds, the order reversed every other round."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    acc = {k: [] for k in fns}
    names = list(fns)
    for i in range(cs.TIMED_ROUNDS):
        for k in (names if i % 2 == 0 else names[::-1]):
            acc[k].append(cs.time_ms(fns[k], torch))
    return {k: {"ms": statistics.median(v), "min": min(v), "max": max(v)} for k, v in acc.items()}


def profiled_us(torch, fn, n=20):
    """Device microseconds per call of each CUDA kernel ``fn`` launches,
    from torch.profiler's kernel records (the kernels' own run times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0.0)
        if total > 0 and e.count:
            out[e.key[:60]] = total / n
    return out


if __name__ == "__main__":
    sys.exit(main())
