"""The device trace of a traced run: ``torch.profiler`` over the traced
operations, exported as a Chrome trace into a directory under TMPDIR
and reduced there to what the per-layer readers need:

- ``window_s``: the span of the harness's ``gpbench/window`` range;
- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside it;
- what ``range_seconds`` reads: the device seconds charged to a named
  host range (a custom op such as ``xgpr_tpu_torch::conv_parts``, or a
  harness range such as ``gpbench/k1``), the device activity whose
  launch (its runtime or driver call, matched by correlation id) lies
  inside the range on the host;
- ``device_ops``: the device operations that took most time, by name;
- ``idle_gaps``: the longest gaps between device intervals, each labelled
  with the innermost harness range (``gpbench/...``) and the innermost
  host op open at its middle.

The trace file is deleted once read.
"""
import bisect
import contextlib
import json
import os
import shutil
import tempfile
from collections import defaultdict

import torch

WINDOW = "gpbench/window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10
# Device operations keep this much of their (C++ template) names.
NAME_CHARS = 160


@contextlib.contextmanager
def profiled():
    """Profile the enclosed region (host and CUDA activity) inside a
    ``gpbench/window`` range; yields a dict that holds the summary once
    the region has closed."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    tmp = tempfile.mkdtemp(prefix="gpbench-trace-")
    try:
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                yield out
            if cuda:
                torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        out.update(summarize(events))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _union(intervals):
    """Merged (start, end) of sorted intervals."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(intervals, t):
    """Name of the latest-starting interval containing t."""
    best = None
    for s, e, name in intervals:
        if s > t:
            break
        if e >= t:
            best = name
    return best


def summarize(events):
    """The summary of a list of Chrome trace events (times in us)."""
    spans = [e for e in events if e.get("ph") == "X"]
    window = [e for e in spans if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no gpbench/window range")
    w0 = window[0]["ts"]
    w1 = w0 + window[0]["dur"]
    device = sorted((e for e in spans if e.get("cat") in DEVICE_CATS),
                    key=lambda e: e["ts"])
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
               for e in device]
    busy = _union([c for c in clipped if c[1] > c[0]])
    busy_us = sum(e - s for s, e in busy)

    by_name = defaultdict(float)
    for e in device:
        by_name[e["name"][:NAME_CHARS]] += e["dur"]
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"], e.get("cat"),
                    e.get("tid")) for e in spans
                   if e.get("cat") in HOST_CATS), key=lambda h: h[0])
    harness = [(s, e, n) for s, e, n, c, _ in host
               if c == "user_annotation" and n.startswith("gpbench/")
               and n != WINDOW]
    ops = [(s, e, n) for s, e, n, c, _ in host if c == "cpu_op"]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    idle_gaps = []
    for length, start in gaps:
        mid = start + length / 2
        label = (_innermost(harness, mid) or "outside the harness's "
                 "ranges") + " | " + (_innermost(ops, mid) or "python")
        idle_gaps.append([label, length / 1e6])

    launches = {e["args"]["correlation"]: e["ts"] for e in spans
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    launched = []
    for e in device:
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is not None:
            launched.append((t, e["dur"]))
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "device_ops": [[n, us / 1e6] for n, us in device_ops],
            "idle_gaps": idle_gaps,
            "unlinked": len(device) - len(launched),
            "launched": launched,
            "host": [(s, e, n) for s, e, n, _, _ in host]}


def range_seconds(summary, name):
    """Device seconds whose launch lies inside a host range ``name``
    (nested or repeated ranges counted once)."""
    iv = _union(sorted((s, e) for s, e, n in summary["host"] if n == name))
    starts = [s for s, _ in iv]
    total = 0.0
    for t, dur in summary["launched"]:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and iv[i][1] >= t:
            total += dur
    return total / 1e6
