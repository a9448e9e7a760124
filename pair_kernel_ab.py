#!/usr/bin/env python3
"""Before/after of the pair kernels for the KDTREE radius gate, on one CUDA
card, in one process.

    python3 pair_kernel_ab.py --parent OLD_CHECKOUT

``OLD_CHECKOUT`` is an earlier checkout of this repository whose pair
kernels gather their rows in the kernel, ``fused_math.ndt_pair(params,
ptsT, table, rows)`` and its B2 and B3 twins, without the gate. Its
package is loaded beside this tree's (under another name; it builds its
kernels into its own ``build/``), and both run on chip_smoke.py's
kernel-phase inputs (the next sweep's N = 65,536 points against
Berlin-shape maps of one sweep).

- The ungated kernels (B1 at K = 20 and K = 1, B2 and B3 at K = 1): the
  old and the new kernel give the same sums, bit for bit, and their
  device times in turns.
- The gated kernels (B1 at K = 20 and K = 1, B2 at K = 1) on the KDTREE
  maps, gate at the points' true pose with radius = resolution, against
  the same kernels without the gate on the same maps: what the gate costs.

Times: median of cs.TIMED_ROUNDS rounds of chip_smoke.time_ms (CUDA
events around 20 back-to-back calls queued behind a device-side spin), the
order reversed every other round. It prints the card line, one line per
measurement and, last, one JSON object with every time. It exits non-zero
without a card.
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
    from slamtpu_torch.ndt import fused_math as new
    from slamtpu_torch.runtime import config as tconfig

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)}")
    old = load_parent(args.parent)
    old._load()
    new._load()
    cfg = cs.berlin_cfg(tconfig, ouster, imu_config)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "berlin.rpl")
        # kernel_inputs takes LIGO_CLOUDS + 1 synced frames, each ending a sweep
        gt = simulator_np.simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=cs.LIGO_CLOUDS + 2,
                                          skewed=True)
        inp = cs.kernel_inputs(torch, path, gt, cfg, torch.device("cuda"))
    ptsT, scovT, gate = inp["ptsT"], inp["scovT"], inp["gate"]
    packed, rows = inp["regmap"].packed, inp["rows"]
    result = {"card": card, "N": inp["N"], "ungated": {}, "gated": {}}

    def aniso(mod):
        return lambda p, pT, tab, r: mod.aniso_pair(p, pT, tab, r, scovT)

    ungated = {  # label: (old, new, params, table, rows)
        "B1 K=20": (old.ndt_pair, new.ndt_pair, inp["p_ndt"], packed, rows),
        "B1 K=1": (old.ndt_pair, new.ndt_pair, inp["p_ndt1"], packed, rows),
        "B2 K=1": (old.gicp_pair, new.gicp_pair, inp["p_gicp"], inp["regmap_g"].packed, inp["rows_g"]),
        "B3 K=1": (aniso(old), aniso(new), inp["p_aniso"], inp["regmap"].packed_aux, rows),
    }
    for label, (fo, fn, p, tab, r) in ungated.items():
        a, b = fo(p, ptsT, tab, r), fn(p, ptsT, tab, r)
        assert torch.equal(a, b), f"{label}: the ungated kernel's sums changed"
        times = in_turns(torch, cs, {"old": lambda: fo(p, ptsT, tab, r), "new": lambda: fn(p, ptsT, tab, r)})
        result["ungated"][label] = times
        cs.log(f"[{card}] {label} ungated: old == new bit for bit; old {times['old']['ms']:.4f} ms "
               f"(rounds {times['old']['min']:.4f}..{times['old']['max']:.4f}), new {times['new']['ms']:.4f} "
               f"ms (rounds {times['new']['min']:.4f}..{times['new']['max']:.4f})")
    gated = {  # label: (kernel, params, KDTREE table, rows)
        "B1 K=20": (new.ndt_pair, inp["p_ndt"], inp["regmap_k"].packed, inp["rows_k"]),
        "B1 K=1": (new.ndt_pair, inp["p_ndt1"], inp["regmap_k"].packed, inp["rows_k"]),
        "B2 K=1": (new.gicp_pair, inp["p_gicp"], inp["regmap_kg"].packed, inp["rows_kg"]),
    }
    for label, (fn, p, tab, r) in gated.items():
        times = in_turns(torch, cs, {"gated": lambda: fn(p, ptsT, tab, r, gate),
                                     "ungated": lambda: fn(p, ptsT, tab, r)})
        result["gated"][label] = times
        cs.log(f"[{card}] {label} on the KDTREE map: gated {times['gated']['ms']:.4f} ms (rounds "
               f"{times['gated']['min']:.4f}..{times['gated']['max']:.4f}), ungated "
               f"{times['ungated']['ms']:.4f} ms (rounds {times['ungated']['min']:.4f}.."
               f"{times['ungated']['max']:.4f})")
    cs.log(card)
    cs.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
