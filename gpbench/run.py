#!/usr/bin/env python3
"""The benchmark of xgpr_tpu_torch: one run of one cell.

    python3 gpbench/run.py --workload motif_1m.fit --seed 7 --seconds 30 \
        --trace 0

from the root of a checkout on a machine with the cell's CUDA cards.
The cell (BENCHMARK.json ``workloads``) names a configuration
(``gpbench/configs/``) and a traffic mix (``gpbench/traffic/``); the run
makes its data and the model's seed from ``--seed``, warms up one
operation, runs operations back to back for ``--seconds`` (the one
running at the deadline completes), and then compares what the window
produced with the plain reference (``gpbench/reference/``).  With
``--trace 0`` it reports the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics from the first operations of the window
traced by ``torch.profiler``.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, ``build_s``: the seconds
the port's kernel library took to load at the start of set-up, which a
checkout's first run spends building it and which ``setup_s`` includes,
and last ``checks``: each number compared beside its limit); the last
lines of standard error are the same numbers.

It exits with 2 and prints no result when the cards are not there, and
with 3 when JAX, flax or the JAX package ``xgpr_tpu`` is loaded once the
window has closed.  Every build and kernel cache the program keeps is in
``build/`` of the checkout.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "gpbench_cache"
# Before torch is imported: caches at fixed paths inside the checkout,
# and few host threads.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "4"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from gpbench.harness import cell, device, guard, spec
    chips = spec.Cell(args.workload).chips
    try:
        device.require(chips)
    except device.NoDevice as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    import xgpr_tpu_torch  # noqa: F401  (fails where the port is absent)

    seen = {}

    def window_closed():
        seen["device"] = device.info(chips)
        return guard.loaded_forbidden()

    res = cell.run(args.workload, args.seed, args.seconds, args.trace == 1,
                   on_window_closed=window_closed)
    forbidden = sorted(set(res["after_window"]) |
                       set(guard.loaded_forbidden()))
    if forbidden:
        print(f"no result: loaded {', '.join(forbidden)}", file=sys.stderr)
        return 3
    dev = seen["device"]
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": dev}
    if args.trace:
        trace = res["run"].trace
        if not trace["busy_s"] > 0:
            print("no result: the trace shows no device activity",
                  file=sys.stderr)
            return 4
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
        out["breakdown"] = res["breakdown"]
    out["build_s"] = res["build_s"]
    out["checks"] = res["checks"]
    cell.report_checks(res["checks"])
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
