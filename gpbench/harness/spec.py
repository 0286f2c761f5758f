"""The benchmark's specification: BENCHMARK.json at the root of the
checkout, and the files it names by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
given in ``configs``, and a traffic mix, a data file read from
``gpbench/traffic/<traffic>.json``.  The mix names the kind of operation
its window repeats; the loop of that kind is
``gpbench/operations/<operation>.py``.  A configuration names its data
generator, ``gpbench/data/<generator>.py``.  The limits of the numbers
a cell's check compares are ``gpbench/checks/<cell>.json``.  A metric is read by
``gpbench/metrics/<metric>.py``, and a kernel's roofline reader counts
that kernel's work with ``gpbench/kernels/<kernel>.py``.  Every one of
these is found under the checkout the cell is read from, by its name.

A cell's metrics are those of BENCHMARK.json that apply to it: an
end-to-end metric with no ``workloads`` key or one that lists the cell,
and a per-layer metric that lists the cell, or that lists none and moves
one of the cell's end-to-end metrics.  So a cell, a mix, a kind of
operation, a configuration, a kernel's roofline or a metric is added by
adding files and entries, with no edit to a file that exists.
"""
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "gpbench"


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is missing or inconsistent."""


def load_benchmark(path=None):
    path = Path(path) if path else ROOT / "BENCHMARK.json"
    with open(path) as fh:
        return json.load(fh)


def _load_json(path):
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError as exc:
        raise SpecError(f"missing file {path}") from exc


def load_module(kind, name, root=None):
    """The module ``gpbench/<kind>/<name>.py`` of the checkout at
    ``root`` (this one by default), loaded afresh from its file."""
    path = (Path(root) if root else ROOT) / "gpbench" / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    mod_name = f"gpbench_{kind}_" + re.sub(r"\W", "_", name)
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic
    and metrics resolved."""

    def __init__(self, name, bench=None, root=None):
        root = Path(root) if root else ROOT
        bench = bench if bench is not None else \
            load_benchmark(root / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if len(found) != 1:
            raise SpecError(f"no workload named {name!r}")
        entry = found[0]
        self.name = name
        self.root = root
        self.chips = int(entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        if entry["config"] not in configs:
            raise SpecError(f"no configuration named {entry['config']!r}")
        self.config_entry = configs[entry["config"]]
        self.config = _load_json(root / self.config_entry["file"])
        self.traffic_name = entry["traffic"]
        self.traffic = _load_json(
            root / "gpbench" / "traffic" / f"{entry['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]

    def limits(self):
        """{number: limit} of the cell's check."""
        return _load_json(self.root / "gpbench" / "checks"
                          / f"{self.name}.json")

    def module(self, kind, name):
        """``gpbench/<kind>/<name>.py`` of this cell's checkout."""
        return load_module(kind, name, self.root)
