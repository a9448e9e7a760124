#!/usr/bin/env python3
"""Keyframe rates and stage times of the replay paths under the map build's
two kinds of float segment sums, in one process on one CUDA card.

    python3 segment_sum_ab.py [--arms tree,index_add,index_add,tree] [--tree DIR]

It simulates chip_smoke.py's 12-sweep Berlin-shape replay and runs it
through chip_smoke.py's replay phase (``replay_phase``: launch counts, host
syncs in the sync debug mode, ATE bound) with four of its configurations:
lo_svn, odom NDT_OMP, odom isotropic GICP and ligo at parity semantics.
Each path runs once to warm up, then once per arm, in the arms' order. An
arm sets the map build's float segment sums:

- ``tree``: the package as it is (on the card, this tree's fixed-order
  float64 prefix sums, ``gaussian_map.segment_sum_scan``);
- ``index_add``: ``index_add_`` in float32 (atomics on the card, in no
  fixed order), bound in place of ``segment_sum`` in
  ``mapping.gaussian_map`` and ``ndt.gicp``.

``--tree DIR`` imports ``slamtpu_torch`` from another checkout of the
repository (its kernels build into its own ``build/``); a checkout without
``gaussian_map.segment_sum`` runs the ``tree`` arm only. Run one process
per checkout, in turns, to compare two checkouts without the history that
chip_smoke.py's earlier phases leave in its process.

It prints the card line, chip_smoke.py's lines for every run, and last one
JSON object: per arm and path, the steady-state keyframes/s (host clock,
as chip_smoke.py counts it), the median device ms of every stage, and the
largest distance of its poses from the first arm's. It exits non-zero
without a card.
"""
import argparse
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WARM = 3  # chip_smoke.py's steady state starts after the first keyframes


def load_chip_smoke():
    """This tree's chip_smoke.py, whatever checkout ``--tree`` names."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def index_add_sum(values, seg, num_segments):
    import torch

    out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values)


def main():
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", default="tree,index_add,index_add,tree")
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segment_sum_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "tests"))
    sys.path.insert(0, tree)
    cs = load_chip_smoke()
    import simulator_np
    from slamtpu_torch.apps.ligo_tc import LigoTcApp
    from slamtpu_torch.apps.lo_svn import LoSvnApp
    from slamtpu_torch.apps.odom_ndt import OdomNdtApp
    from slamtpu_torch.ins import imu_config
    from slamtpu_torch.lidar import ouster
    from slamtpu_torch.mapping import gaussian_map
    from slamtpu_torch.ndt import fused_math, gicp
    from slamtpu_torch.runtime import config as tconfig

    arms = args.arms.split(",")
    own = getattr(gaussian_map, "segment_sum", None)
    if any(a not in ("tree", "index_add") for a in arms) or (own is None and set(arms) != {"tree"}):
        raise SystemExit(f"arms {arms}: 'tree', or 'index_add' where the tree has segment_sum")
    card = cs.card_line()
    cs.log(f"card: {card} | tree {tree} | arms {arms}")
    fused_math._load()
    dev = torch.device("cuda")
    cfg = cs.berlin_cfg(tconfig, ouster, imu_config)
    paths = {
        "lo_svn": (lambda: LoSvnApp(cfg, dev), ("ndt_pair", "aniso_pair"), 0.005),
        **{f"odom {m}": (lambda m=m: OdomNdtApp(cs.odom_cfg(tconfig, cfg, m), dev, window=6),
                         (cs.ODOM_PHASES[m][2],), cs.ODOM_PHASES[m][3])
           for m in ("NDT_OMP", "GICP")},
        "ligo parity": (lambda: LigoTcApp(cs.ligo_cfg(tconfig, cfg, map_rebuild_every=1,
                                                      smoother_solver="qr"), dev, window=6),
                        ("ndt_pair",), cs.LIGO_ATE_BOUND),
    }
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        replay = os.path.join(tmp, "berlin.rpl")
        gt = simulator_np.simulate_replay(replay, cfg.meta, cfg.lidar, n_sweeps=cs.N_SWEEPS,
                                          skewed=True)
        first = {}
        for i, arm in enumerate(["tree"] + arms):
            if own is not None:
                gaussian_map.segment_sum = gicp.segment_sum = (
                    own if arm == "tree" else index_add_sum)
            for label, (make_app, kernels, bound) in paths.items():
                app = make_app()
                _, traj, _ = cs.replay_phase(torch, f"{label} [{arm}]", app, replay, gt, card,
                                             kernels, bound)
                trans = np.stack([np.asarray(e.pose.trans, np.float64) for e in traj])
                if i == 0:
                    continue  # the warm-up run
                first.setdefault(label, trans)
                ends = [1e-9 * st.queued for st in app.device_timer.keyframes().values()]
                results.append(dict(
                    arm=arm, run=i, path=label,
                    keyframes_s=(len(ends) - 1 - WARM) / (ends[-1] - ends[WARM]),
                    stage_ms={k: v["median_ms"]
                              for k, v in app.device_timer.summary(skip_first=1).items()},
                    max_pose_diff_m=float(np.abs(trans - first[label]).max()),
                ))
    cs.log(card)
    cs.log(json.dumps({"tree": tree, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
