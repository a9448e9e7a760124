"""The benchmark's command:

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the CUDA device it is started on and
prints one JSON object as the last line of its standard output (with
``--trace 1`` the per-layer metrics, else the end-to-end ones). It exits
with another code than 0, printing no result, when no CUDA device is
present, and when the process has loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program at a fixed path in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the port's host work is one Python thread
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)

    from slambench import harness

    bench, cell, cfg, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    metrics = harness.cell_metrics(bench, cell["name"], bool(args.trace))
    result = harness.run_cell(cell["name"], cfg, traffic, metrics, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the process loaded {found}", file=sys.stderr)
        return 4
    for k, v in result["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
