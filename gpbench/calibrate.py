#!/usr/bin/env python3
"""The readings a cell's check limits are set from, in one process.

    python3 gpbench/calibrate.py --workload song.nmll \
        --seeds 11,12,13 --control-seeds 11,12,13 \
        --fault-seeds 11,12,13 --out readings.json

For each seed of ``--seeds``: the cell's set-up from that seed, the
operations of one window's worth (one fit or predict batch; one round
of the NMLL points), and the numbers the run's check compares, the
program's outputs against the float64 reference (the lower readings).
For each seed of ``--control-seeds`` (a subset of ``--seeds``): the
same numbers with the reference computed at TF32 put in the program's
place (the control, the upper readings).  For each seed of
``--fault-seeds`` in an NMLL cell: the same numbers with the reference's
SLQ estimate, broken by each of ``ESTIMATOR_FAULTS``, put in the
program's place (what the exact NMLL has to catch).  Each seed's numbers
go to stdout as one JSON line and all of them to ``--out``.  The
benchmark's own runs never run the control or the faults.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpbench.reference import solve as ref_solve  # noqa: E402


@contextlib.contextmanager
def _patched(obj, name, value):
    original = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, original)


def _quadrature_with(weights_of, mean_of):
    """The reference's Gauss quadrature with the node weights and the
    mean over probes given."""
    def quadrature(alphas, betas, num_rffs):
        logdets = []
        for a, b in zip(alphas.T, betas.T):
            bad = ~(a > 0)
            length = int(np.argmax(bad)) if bad.any() else a.shape[0]
            if length < 1:
                continue
            a = a[:length]
            b = np.clip(b[:length], 0.0, None)
            diag = 1.0 / a
            diag[1:] += b[:-1] / a[:-1]
            if length > 1:
                vals, vecs = ref_solve.eigh_tridiagonal(
                    diag, (np.sqrt(b) / a)[:-1], lapack_driver="stev")
            else:
                vals, vecs = diag[:1], np.ones((1, 1))
            logdets.append((weights_of(vecs) * np.log(
                np.clip(vals, 1e-30, None))).sum())
        return num_rffs * mean_of(logdets)
    return quadrature


# Faults of the SLQ estimator that a copy of it would share, each a
# context manager that plants it in the reference's copy.
ESTIMATOR_FAULTS = {
    # The weights from the eigenvectors' first column, not their first
    # components.
    "quadrature_weights": lambda: _patched(
        ref_solve, "_quadrature_logdet",
        _quadrature_with(lambda v: v[:, 0] ** 2, np.mean)),
    # The probes' mean taken over one probe fewer.
    "probe_mean": lambda: _patched(
        ref_solve, "_quadrature_logdet",
        _quadrature_with(lambda v: v[0] ** 2,
                         lambda x: float(np.sum(x)) / (len(x) - 1))),
    # The probes left unshaped by the preconditioner's root.
    "probe_shaping": lambda: _patched(
        ref_solve.Nystrom, "root", lambda self, v: v),
    # The preconditioner's log-determinant left out.
    "precond_logdet": lambda: _patched(
        ref_solve.Nystrom, "logdet", lambda self: 0.0),
}


def readings(cell_name, seed, control, device="cuda", root=None,
             faults=False):
    """{"seed", "program": numbers, "control": numbers or None,
    "faults": {fault: numbers} or None}."""
    import torch
    from gpbench.harness import operation, spec
    cell = spec.Cell(cell_name, root=root)
    op = operation.make(cell, seed, device)
    t0 = time.perf_counter()
    op.setup()
    for i in range(op.round_ops):
        op.step(i)
    outputs = op.outputs()
    op.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = op.reference_outputs("float64", device)
    out = {"seed": seed, "failed": sum(1 for r in op.records
                                       if r.get("failed")),
           "program": op.numbers(outputs, ref), "control": None,
           "faults": None}
    if control:
        out["control"] = op.numbers(op.reference_outputs("tf32", device),
                                    ref)
    if faults:
        out["faults"] = {}
        for name, plant in ESTIMATOR_FAULTS.items():
            with plant():
                broken = op.reference_outputs("float64", device)
            out["faults"][name] = op.numbers(broken, ref)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    faults = {int(s) for s in args.fault_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        rows.append(readings(args.workload, seed, seed in control,
                             args.device, faults=seed in faults))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
