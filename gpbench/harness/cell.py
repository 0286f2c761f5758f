"""One run of one cell: set-up, the closed-loop window, the traced
operations, the metrics, and the comparison with the plain reference
that decides ``correct``.

``run`` returns the result's fields (and the check's numbers) as a dict;
``gpbench/run.py`` adds the device and prints it.  It takes ``device``
so that a test can drive the whole run on the CPU at a tiny size.
"""
import contextlib
import gc
import sys
import time
import traceback
from types import SimpleNamespace

import torch

from . import clock, operation, spec, trace


class CheckError(RuntimeError):
    """A check's limit is missing from the configuration."""


def reader(name, root=None):
    """The reader module ``gpbench/metrics/<name>.py``."""
    return spec.load_module("metrics", name, root)


def read_metrics(readers, run, notes):
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something to read; ``readers`` maps each metric's entry to its
    module, and each reader sees its own ``notes`` as ``run.notes``."""
    out = {}
    for entry, module in readers:
        view = SimpleNamespace(**vars(run),
                               notes=notes.get(entry["name"], {}))
        value = module.read(view)
        if value is not None:
            out[entry["name"]] = {"value": float(value),
                                  "unit": entry["unit"]}
    return out


def window(op, seconds, trace_ops=0, observers=(), clock=time.perf_counter):
    """The closed-loop window: rounds of ``op.round_ops`` operations back
    to back until ``seconds`` have passed, the round running at the
    deadline completing.  With ``trace_ops``, the first that many
    operations run under the profiler, with each of ``observers`` (the
    readers' ``observe`` context managers) open around them.  Returns
    (operations, window seconds, trace summary or None)."""
    start = clock()
    done, summary = 0, None
    if trace_ops:
        op.traced = True
        with trace.profiled() as summary, contextlib.ExitStack() as stack:
            for observer in observers:
                stack.enter_context(observer())
            for done in range(1, trace_ops + 1):
                op.step(done - 1)
        op.traced = False
    round_ops = getattr(op, "round_ops", 1)
    while done == 0 or done % round_ops or clock() - start < seconds:
        op.step(done)
        done += 1
    return done, clock() - start, summary


def check(op, outputs, device):
    """(numbers, limits, correct): the program's outputs against the
    plain reference's, each number beside its limit, with the count of
    failed operations held to 0.  ``outputs`` None (the window left
    nothing to compare) fails as ``no_output``."""
    numbers = {"failed_ops": float(sum(1 for r in op.records
                                       if r.get("failed")))}
    limits = {"failed_ops": 0.0}
    if outputs is None:
        numbers["no_output"], limits["no_output"] = 1.0, 0.0
    else:
        ref = op.reference_outputs("float64", device)
        compared = op.numbers(outputs, ref)
        missing = set(compared) - set(op.limits())
        if missing:
            raise CheckError(f"no limit for {sorted(missing)}")
        numbers.update(compared)
        limits.update({k: float(op.limits()[k]) for k in compared})
    correct = all(numbers[k] <= limits[k] for k in numbers)
    return numbers, limits, correct


def program_outputs(op):
    """What the window produced, or None (with the traceback on stderr)
    where it left nothing to read: every operation failed."""
    try:
        return op.outputs()
    except Exception:      # judged as no output, below
        traceback.print_exc(file=sys.stderr)
        return None


def kernel_build_seconds(device):
    """Seconds the port's kernel library takes to load, building it
    first where the checkout has none (a checkout's first run): taken
    at the start of set-up, where the first kernel would take it."""
    if torch.device(device).type != "cuda":
        return None
    from xgpr_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.library()
    return time.perf_counter() - t0


def run(cell_name, seed, seconds, traced, device="cuda", root=None,
        on_window_closed=None):
    """One run of the cell; returns a dict with ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``build_s``, ``breakdown``
    (traced runs), ``checks`` and the ``run`` namespace the readers saw.
    ``on_window_closed()`` is called once the window has closed and
    before the program's state is freed (the device's peak is read
    there)."""
    cell = spec.Cell(cell_name, root=root)
    entries = cell.per_layer if traced else cell.end_to_end
    readers = [(e, cell.module("metrics", e["name"])) for e in entries]
    notes = {e["name"]: {} for e in entries}
    observers = [(lambda m=m, n=notes[e["name"]]: m.observe(n))
                 for e, m in readers if hasattr(m, "observe")]
    op = operation.make(cell, seed, device)
    op.progress = progress
    progress("imported")
    build_s = kernel_build_seconds(device)
    if build_s is not None:
        progress(f"kernel library loaded in {build_s:.2f} s")
    op.setup()
    progress("set up")
    op.warmup()
    progress("warmed up")
    setup_s = clock.process_age()
    trace_ops = cell.traffic["trace_ops"] if traced else 0
    n, window_s, summary = window(op, seconds, trace_ops, observers)
    progress(f"window closed: {n} operations in {window_s:.3f} s")
    if summary is not None:
        progress(f"trace: {summary['unlinked']} device operations with no "
                 "launch found, charged to no range")
    for key in ("seconds", "precond_s", "cg_iters", "cg_s"):
        values = sorted(r[key] for r in op.records
                        if r.get(key) is not None)
        if values:
            progress(f"operations' {key}: min {values[0]:.4f} median "
                     f"{values[len(values) // 2]:.4f} max {values[-1]:.4f}")
    after_window = on_window_closed() if on_window_closed else None
    failed = sum(1 for r in op.records if r.get("failed"))
    traced_records = op.records[:trace_ops]
    ns = SimpleNamespace(cell=cell, config=cell.config,
                         traffic=cell.traffic, setup_s=setup_s,
                         window_s=window_s, records=op.records,
                         traced=traced_records, trace=summary,
                         basis=op.basis(traced_records) if traced else None)
    metrics = read_metrics(readers, ns, notes)
    outputs = program_outputs(op)
    op.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    progress("program freed")
    numbers, limits, correct = check(op, outputs, device)
    progress("reference compared")
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics, "build_s": build_s,
              "after_window": after_window,
              "checks": {k: {"value": numbers[k], "limit": limits[k]}
                         for k in numbers}, "run": ns}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    return result


def progress(what, stream=sys.stderr):
    """A line on stderr with the process's age, for the run's log."""
    print(f"[{clock.process_age() or 0.0:8.2f} s] {what}", file=stream,
          flush=True)


def report_checks(checks, stream=sys.stderr):
    """Each compared number beside its limit, one line each."""
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=stream)
