"""Fixtures of the benchmark's tests: a tiny copy of the benchmark's
specification (the same configurations and mixes at a few thousand rows
and 512 random features) for runs on the CPU."""
import json
import shutil

import pytest

from gpbench.harness import spec

TINY = {"rows": 3000, "test_rows": 400, "num_rffs": 512,
        "variance_rffs": 64, "chunk": 1024, "rank": 128}
# Limits that differ at the tiny size.  The exact NMLL's gap is the SLQ
# estimator's own error, which is larger at 3000 rows and a rank-128
# preconditioner: sound runs read 2.8e-4 to 8.7e-4 there, the planted
# estimator faults 7.9e-3 and more.
TINY_LIMITS = {"song.nmll": {"nmll_exact_gap": 3e-3}}


def copy_root(root):
    """A checkout-like copy of BENCHMARK.json and gpbench/ (its tests
    left out)."""
    shutil.copytree(spec.BENCH_DIR, root / "gpbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def make_tiny_root(root):
    copy_root(root)
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        cfg["data"].update(rows=TINY["rows"], test_rows=TINY["test_rows"])
        cfg["model"].update(num_rffs=TINY["num_rffs"], chunk=TINY["chunk"],
                            variance_rffs=TINY["variance_rffs"])
        if cfg["fit"]["preconditioner"]:
            cfg["fit"]["preconditioner"]["rank"] = TINY["rank"]
        if "nmll" in cfg:
            cfg["nmll"]["settings"]["max_rank"] = TINY["rank"]
        (root / c["file"]).write_text(json.dumps(cfg))
    for path in (spec.BENCH_DIR / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        if traffic["operation"] == "predict":
            traffic.update(batch_rows=512, pool_rows=2048, check_rows=300)
        if traffic["operation"] == "nmll":
            traffic.update(points=3)
        (root / "gpbench" / "traffic" / path.name).write_text(
            json.dumps(traffic))
    for name, limits in TINY_LIMITS.items():
        path = root / "gpbench" / "checks" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()),
                                    **limits}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
