"""CPU tests of the benchmark's harness: the specification and its
files found by name, the window's and the metrics' arithmetic, the
roofline counts, the trace reduction and the import guard."""
import json
from collections import Counter
from types import SimpleNamespace

import pytest

from gpbench.harness import cell, clock, guard, operation, peaks, spec
from gpbench.harness import trace
from gpbench.kernels import k1, k3

from .conftest import copy_root, make_tiny_root

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def read(name, run):
    return cell.reader(name).read(run)


# -- the specification -------------------------------------------------
def test_every_cell_resolves_with_its_metrics():
    for w in BENCH["workloads"]:
        c = spec.Cell(w["name"])
        assert c.chips == w["chips"] == 1
        assert c.config["name"] == w["config"]
        assert hasattr(c.module("operations", c.traffic["operation"]), "Op")
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer, w["name"]
        for m in c.per_layer:
            assert m["moves"] in names


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(cell.reader(m["name"]).read)


K2_KERNEL = '''"""K2, the RBF feature map (a new kernel's file)."""
from collections import Counter

from gpbench.harness import peaks

RANGE = "xgpr_tpu_torch::rbf_feature_map"


def launches():
    from xgpr_tpu_torch.ops.cuda import feature_map
    return Counter(feature_map.LAUNCHES)


def work(counts, basis, config):
    esize = peaks.ESIZE[config["model"]["feature_dtype"]]
    flops = nbytes = 0
    for key, n in counts.items():
        rows, _ = peaks.covered(key[0], n, basis)
        dim, freqs = key[1], key[2]
        flops += 2 * rows * dim * freqs
        nbytes += (rows * (dim + 2 * freqs) + n * dim * freqs) * esize
    return flops, nbytes
'''
K2_READER = '''"""K2's roofline share (a new metric's file)."""
from gpbench.harness.readers import Roofline

_K2 = Roofline("k2", __file__)
observe, read = _K2.observe, _K2.read
'''
IDLE_READER = '''from gpbench.harness.readers import idle_share


def read(run):
    return idle_share(run)
'''


def add_files_only(root):
    """What a later PR adds to a tiny checkout as files and entries: a
    mix of small predict batches, a cell of it on the tabular set with a
    new kernel's roofline and an idle share, and an NMLL cell on the
    motif set through a configuration of its own."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    traffic = {"operation": "predict", "batch_rows": 256,
               "pool_rows": 1024, "check_rows": 200, "trace_ops": 2}
    (root / "gpbench/traffic/predict_small.json").write_text(
        json.dumps(traffic))
    (root / "gpbench/kernels/k2.py").write_text(K2_KERNEL)
    (root / "gpbench/metrics/k2_roofline.predict_small.py").write_text(
        K2_READER)
    (root / "gpbench/metrics/idle_share.predict_small.py").write_text(
        IDLE_READER)
    bench["workloads"].append(
        {"name": "song.predict", "config": "rbf_song",
         "traffic": "predict_small", "chips": 1, "why": "small batches"})
    bench["end_to_end"][2]["workloads"].append("song.predict")
    bench["per_layer"] += [
        {"name": "idle_share.predict_small", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "predict_rows_per_s"},
        {"name": "k2_roofline.predict_small", "unit": "%",
         "better": "higher", "source": "device_trace", "layer": "kernels",
         "moves": "predict_rows_per_s", "workloads": ["song.predict"]}]
    motif = json.loads(
        (root / "gpbench/configs/conv1d_motif_1m.json").read_text())
    song = json.loads((root / "gpbench/configs/rbf_song.json").read_text())
    motif["name"] = "conv1d_motif_tune"
    motif["model"]["hyperparams"] = [-1.0, -2.5]
    motif["nmll"] = {"box": [[-1.5, -0.5], [-3.0, -2.0]],
                     "settings": song["nmll"]["settings"]}
    for added, like in (("motif.nmll", "song.nmll"),
                        ("song.predict", "motif_1m.predict")):
        (root / f"gpbench/checks/{added}.json").write_text(
            (root / f"gpbench/checks/{like}.json").read_text())
    (root / "gpbench/configs/conv1d_motif_tune.json").write_text(
        json.dumps(motif))
    bench["configs"].append(
        {"name": "conv1d_motif_tune", "source": "a test",
         "file": "gpbench/configs/conv1d_motif_tune.json", "reduced": [],
         "why": "an NMLL on sequences"})
    bench["workloads"].append(
        {"name": "motif.nmll", "config": "conv1d_motif_tune",
         "traffic": "nmll", "chips": 1, "why": "a tuner on sequences"})
    bench["end_to_end"][1]["workloads"].append("motif.nmll")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return traffic


def test_a_cell_added_as_files_only_is_found(tmp_path):
    root = copy_root(tmp_path)
    traffic = add_files_only(root)
    c = spec.Cell("song.predict", root=root)
    assert c.traffic == traffic
    assert c.config["model"]["kernel"] == "RBF"
    assert [m["name"] for m in c.end_to_end] == ["predict_rows_per_s",
                                                 "setup_s"]
    # A per-layer metric with no workloads key reaches every cell that
    # reports what it moves.
    assert "idle_share.predict_small" in [m["name"] for m in c.per_layer]
    assert "idle_share.predict_small" in [
        m["name"] for m in spec.Cell("motif_1m.predict", root=root).per_layer]
    assert "idle_share.predict_small" not in [
        m["name"] for m in spec.Cell("song.fit", root=root).per_layer]
    # The new kernel's roofline is read from the files added alone.
    module = c.module("metrics", "k2_roofline.predict_small")
    events = [ev(trace.WINDOW, "user_annotation", 0, 1000),
              ev("xgpr_tpu_torch::rbf_feature_map", "cpu_op", 10, 20),
              ev("cudaLaunchKernel", "cuda_runtime", 14, 2, corr=1),
              ev("k2", "kernel", 50, 100, tid=7, corr=1)]
    run = SimpleNamespace(
        trace=trace.summarize(events), config=c.config, notes={
            "launches": Counter({(256, 90, 4096, "f32"): 4})},
        basis={"rows": 1000, "windows": None, "chunks": 4,
               "chunk_rows": 256})
    flops = 2 * 1000 * 90 * 4096
    nbytes = (1000 * (90 + 2 * 4096) + 4 * 90 * 4096) * 4
    assert module.read(run) == pytest.approx(
        100 * peaks.least_seconds(flops, nbytes, "float32") / 100e-6)


@pytest.mark.parametrize("name,traced", [("song.predict", True),
                                         ("motif.nmll", False)])
def test_cells_added_as_files_only_run(name, traced, tmp_path):
    """A tiny run on the CPU of each cell added as files only: a predict
    on tabular rows, traced, and an NMLL on sequences."""
    root = make_tiny_root(tmp_path)
    add_files_only(root)
    res = cell.run(name, 2 ** 31 + 23, 0.2, traced, device="cpu",
                   root=root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    if traced:
        # No device here: the idle share reads the whole window, and the
        # kernel's roofline finds no launch to read.
        assert res["metrics"]["idle_share.predict_small"]["value"] == 100.0
        assert "k2_roofline.predict_small" not in res["metrics"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError):
        spec.Cell("no.such.cell")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200


# -- the window and the metrics' arithmetic ------------------------------
class FakeOp:
    """Operations that each take ``step_s`` on a fake clock."""

    def __init__(self, step_s, round_ops=1):
        self.t, self.step_s, self.seen = 0.0, step_s, []
        self.round_ops = round_ops

    def clock(self):
        return self.t

    def step(self, i):
        self.seen.append(i)
        self.t += self.step_s


def test_the_window_completes_the_operation_at_the_deadline():
    op = FakeOp(3.0)
    # Operations end at 3, 6, 9 and 12: the fourth runs past 10 and counts.
    assert cell.window(op, 10.0, clock=op.clock) == (4, 12.0, None)
    assert op.seen == [0, 1, 2, 3]
    op = FakeOp(3.0)
    assert cell.window(op, 0.0, clock=op.clock)[:2] == (1, 3.0)


def test_the_window_runs_whole_rounds():
    op = FakeOp(1.0, round_ops=8)
    # Rounds of 8: the deadline at 10 falls in the second round.
    assert cell.window(op, 10.0, clock=op.clock)[:2] == (16, 16.0)


def test_an_nmll_round_is_its_point_list(tiny_root):
    op = operation.make(spec.Cell("song.nmll", root=tiny_root), 5, "cpu")
    op.points = op.draw_points()
    assert op.round_ops == len(op.points) == op.traffic["points"]


def test_spread_is_the_interquartile_distance_over_the_median():
    # statistics.quantiles' default ("exclusive") method: Q1 2.75,
    # median 5.5, Q3 8.25.
    assert clock.spread(list(range(1, 11))) == pytest.approx(5.5 / 5.5)
    assert clock.spread([10.0, 10.0, 10.0, 10.0]) == 0.0


def records_run(records, window_s, setup_s=12.5, notes=None):
    return SimpleNamespace(records=records, window_s=window_s,
                           setup_s=setup_s, traced=records, trace=None,
                           basis=None, config={}, notes=notes or {})


def test_end_to_end_readers_count_completed_operations():
    recs = [{"kind": "fit"}, {"kind": "fit", "failed": True},
            {"kind": "fit"}, {"kind": "fit"}]
    run = records_run(recs, 30.0)
    assert read("fit_s", run) == pytest.approx(10.0)
    assert read("nmll_s", run) == pytest.approx(10.0)
    assert read("setup_s", run) == 12.5
    preds = [{"rows": 65536}] * 3 + [{"rows": 65536, "failed": True}]
    assert read("predict_rows_per_s", records_run(preds, 0.5)) == \
        pytest.approx(3 * 65536 / 0.5)
    assert read("fit_s", records_run([{"failed": True}], 1.0)) is None


def test_per_layer_readers_on_fixed_records():
    recs = [{"precond_s": 1.0, "cg_s": 2.0, "cg_iters": 20},
            {"precond_s": 3.0, "cg_s": 2.4, "cg_iters": 20}]
    run = records_run(recs, 9.0, notes={"ranks": [512, 1024]})
    assert read("precond_s.fit", run) == 2.0
    assert read("cg_iters.fit", run) == 20.0
    assert read("cg_iter_ms.fit", run) == pytest.approx(110.0)
    assert read("precond_rank.fit", run) == 768.0
    assert read("precond_rank.fit", records_run(recs, 9.0)) is None
    run.trace = {"window_s": 4.0, "busy_s": 3.0}
    assert read("idle_share.fit", run) == pytest.approx(25.0)


# -- the roofline counts -------------------------------------------------
def test_k1_work_by_hand():
    # One 8192-row chunk of song at SLQ's 26 right-hand sides.
    flops, nbytes = k1.shape_work(8192, 90, 4096, 26, 1)
    assert flops == 8192 * (2 * 90 * 4096 + 8 * 4096 * 26)
    assert nbytes == 4 * (8192 * 91 + 90 * 4096 + 4 * 4096 * 26)
    # Compute-bound: 13.0 GFLOP at 495 TFLOP/s, 0.0263 ms.
    assert peaks.least_seconds(flops, nbytes, "float32") == \
        pytest.approx(flops / 495e12)


def test_k3_work_by_hand():
    # 100 rows with 450 valid windows: 2 * 450 * 9 * 64 * 4096 flops.
    flops, nbytes = k3.shape_work(100, 450, 16, 64, 9, 4096, 1)
    assert flops == 2 * 450 * 576 * 4096
    assert nbytes == 100 * (16 * 64 * 4 + 4 + 2 * 4096 * 4) + 576 * 4096 * 4
    assert peaks.share(flops, nbytes, 2 * flops / 495e12, "float32") == \
        pytest.approx(50.0)
    assert peaks.share(flops, nbytes, 0.0, "float32") is None


MOTIF = {"model": {"feature_dtype": "float32"}}


def test_launches_at_the_chunk_cover_whole_passes():
    # 1M rows in 62 chunks of 16,384, the last one padded: three passes
    # count 3M real rows and their windows, not the padding.
    basis = {"rows": 1_000_000, "windows": 4_500_000, "chunks": 62,
             "chunk_rows": 16384}
    assert peaks.covered(16384, 3 * 62, basis) == (3_000_000, 13_500_000)
    # A launch at another row count is taken as real rows throughout.
    assert peaks.covered(640, 2, basis) == (1280, 1280 * 4.5)
    counts = Counter({(16384, 16, 64, 9, 4096, "f32", "hi"): 3 * 62})
    flops, _ = k3.work(counts, basis, MOTIF)
    assert flops == 3 * 2 * 4_500_000 * 576 * 4096


def test_k3_work_sums_every_width():
    # A predict record of 16 batches of 65,536 rows: K3 at the mean's
    # F 4096 and the variance's F 256, four chunks a batch each.
    basis = {"rows": 16 * 65536, "windows": 7_000_000, "chunks": 64,
             "chunk_rows": 16384}
    wide = (16384, 16, 64, 9, 4096, "f32", "hi")
    narrow = (16384, 16, 64, 9, 256, "f32", "hi")
    both = k3.work(Counter({wide: 64, narrow: 64}), basis, MOTIF)
    one = [k3.shape_work(16 * 65536, 7_000_000, 16, 64, 9, f, 64)
           for f in (4096, 256)]
    assert both == (one[0][0] + one[1][0], one[0][1] + one[1][1])
    assert both[0] == 2 * 7_000_000 * 576 * (4096 + 256)


def test_k1_work_sums_every_right_hand_side_count():
    basis = {"rows": 463715, "windows": None, "chunks": 57,
             "chunk_rows": 8192}
    counts = Counter({(8192, 90, 4096, 26, "f32"): 2 * 57,
                      (8192, 90, 4096, 1, "f32"): 57})
    flops, _ = k1.work(counts, basis, MOTIF)
    assert flops == 463715 * (3 * 2 * 90 * 4096 + 8 * 4096 * (2 * 26 + 1))


def test_a_roofline_reader_charges_its_kernels_range():
    events = [ev(trace.WINDOW, "user_annotation", 0, 1000),
              ev(k3.RANGE, "cpu_op", 10, 20),
              ev("cudaLaunchKernel", "cuda_runtime", 14, 2, corr=1),
              ev("k3", "kernel", 50, 100, tid=7, corr=1)]
    basis = {"rows": 100, "windows": 450, "chunks": 1, "chunk_rows": 100}
    run = SimpleNamespace(trace=trace.summarize(events), basis=basis,
                          config=MOTIF, notes={"launches": Counter(
                              {(100, 16, 64, 9, 4096, "f32"): 1})})
    flops, nbytes = k3.shape_work(100, 450, 16, 64, 9, 4096, 1)
    assert read("k3_roofline.fit", run) == pytest.approx(
        100 * peaks.least_seconds(flops, nbytes, "float32") / 100e-6)
    run.notes = {}
    assert read("k3_roofline.fit", run) is None


# -- the trace reduction -------------------------------------------------
def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summarize_charges_kernels_to_their_launching_range():
    events = [
        ev(trace.WINDOW, "user_annotation", 0, 1000),
        ev("gpbench/fit", "user_annotation", 0, 900),
        ev("xgpr_tpu_torch::conv_parts", "cpu_op", 10, 20),
        ev("xgpr_tpu_torch::conv_parts", "cpu_op", 12, 5),   # nested
        ev("cudaLaunchKernel", "cuda_runtime", 14, 2, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 40, 2, corr=2),
        ev("aten::item", "cpu_op", 300, 500),
        ev("k3_kernel", "kernel", 50, 100, tid=7, corr=1),
        ev("other", "kernel", 150, 50, tid=7, corr=2),
        ev("Memcpy DtoH", "gpu_memcpy", 800, 100, tid=7, corr=3),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert trace.range_seconds(s, "xgpr_tpu_torch::conv_parts") == \
        pytest.approx(100e-6)
    assert trace.range_seconds(s, "gpbench/k1") == 0.0
    assert s["device_ops"][0] == ["k3_kernel", pytest.approx(1e-4)]
    label, gap = s["idle_gaps"][0]
    assert gap == pytest.approx(600e-6)
    assert label == "gpbench/fit | aten::item"
    assert s["unlinked"] == 1


# -- the import guard ----------------------------------------------------
def test_guard_compares_whole_top_level_names():
    assert guard.loaded_forbidden(["xgpr_tpu_torch", "xgpr_tpu_torch.ops",
                                   "numpy"]) == []
    assert guard.loaded_forbidden(["xgpr_tpu.models", "jaxlib.xla",
                                   "flax"]) == ["flax", "jaxlib", "xgpr_tpu"]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    sources = sorted((ROOT / "gpbench").rglob("*.py"))
    assert sources
    for path in sources:
        names = guard.imported_names(path)
        assert not names & guard.FORBIDDEN, path
        if "reference" in path.parts:
            assert guard.PORT not in names, path
            assert "gpbench" not in names, path
