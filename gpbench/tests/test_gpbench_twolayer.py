"""The two kinds of operation added for ``gfp_2l.fit`` (a Conv1dTwoLayer
fit, ``operations/fit_twolayer.py``) and ``motif_1m.tune`` (the crude
tuner's step, ``operations/tune.py``), on the CPU at a tiny size:
sound runs are correct, the control (the reference at TF32 in the
program's place) and broken timed paths are not; and K4's counts and the
readers of its launches and of the two layers' spans."""
import json
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

from gpbench.calibrate import readings
from gpbench.harness import cell, peaks, spec, trace
from gpbench.kernels import k4
from gpbench.reference import features as ref_features
from gpbench.reference.twolayer import TwoLayerMap
from xgpr_tpu_torch.scoring import lb_optimizer

from .conftest import make_tiny_root
from .test_gpbench_faults import (half_the_data, state_unchanged,
                                  weights_altered)
from .test_gpbench_harness import ev
from .test_gpbench_spans import span, traced_run

CELLS = ("gfp_2l.fit", "motif_1m.tune")
# Below the shared tiny size: the protein's 237 positions and layer 1's
# 1024 outputs cut to what a CPU test runs in seconds; the tuner's rows
# and width to the tiny motif set's.
TINY_GFP = {"rows": 400, "test_rows": 200, "seq_len": 24,
            "init_rffs": 64, "num_rffs": 256, "variance_rffs": 32,
            "chunk": 128, "rank": 64}
TINY_TUNE = {"rows": 1500, "num_rffs": 256, "points": 3}
# At 1500 rows the step's score, rounded to 3 places, is within 3.3e-7 of
# the exact one per row, which a TF32 Gram moves by little more at the
# motif set's pinned sigma: the tiny tuner's sigma is log sigma -0.5,
# where the control reads 1.6e-6 to 6.0e-6 and sound runs 2.5e-7 at
# most.  Its least NMLL lies at lambda's upper bound there, and a lambda
# one grid point below it costs 5.3e-3 a row.
TINY_TUNE_LOG_SIGMA = -0.5
TINY_TUNE_LIMITS = {"tune_score_gap": 1e-6, "tune_lambda_regret": 1e-6}


def make_root(root):
    make_tiny_root(root)
    path = root / "gpbench" / "configs" / "conv2l_gfp.json"
    cfg = json.loads(path.read_text())
    t = TINY_GFP
    cfg["data"].update(rows=t["rows"], test_rows=t["test_rows"],
                       seq_len=t["seq_len"])
    cfg["model"].update(num_rffs=t["num_rffs"], chunk=t["chunk"],
                        variance_rffs=t["variance_rffs"])
    cfg["model"]["kernel_settings"]["init_rffs"] = t["init_rffs"]
    cfg["fit"]["preconditioner"]["rank"] = t["rank"]
    path.write_text(json.dumps(cfg))
    path = root / "gpbench" / "traffic" / "tune.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                **TINY_TUNE}))
    path = root / "gpbench" / "configs" / "conv1d_motif_1m.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["hyperparams"][1] = TINY_TUNE_LOG_SIGMA
    path.write_text(json.dumps(cfg))
    path = root / "gpbench" / "checks" / "motif_1m.tune.json"
    path.write_text(json.dumps(TINY_TUNE_LIMITS))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny_new"))


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_of_each_new_cell_is_correct(name, root):
    res = cell.run(name, 2 ** 31 + 29, 0.2, False, device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    c = spec.Cell(name, root=root)
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    for key, number in res["checks"].items():
        if key != "failed_ops":
            assert number["value"] < 1e-4, key


def test_a_traced_tiny_two_layer_fit_reads_its_layers(root):
    """Traced on the CPU: the layers' spans are read (no device, so no
    device time), K4's passes count nothing (the counter counts the
    card's launches) and its roofline finds nothing to read."""
    res = cell.run("gfp_2l.fit", 2 ** 31 + 31, 0.2, True, device="cpu",
                   root=root)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["twolayer_l1_ms.fit"]["value"] == 0.0
    assert got["twolayer_l2_ms.fit"]["value"] == 0.0
    assert got["cg_iters.fit"]["value"] > 0
    assert "k4_roofline.fit" not in got and "k4_passes.fit" not in got


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name, root):
    """The control, the reference at TF32 in the program's place, fails
    one of the cell's limits at least, where the program passes all of
    them.  The limits were set at the cells' own sizes on the card; the
    control's readings there are in PERF.md."""
    limits = spec.Cell(name, root=root).limits()
    got = readings(name, 123461, True, device="cpu", root=root)
    assert got["failed"] == 0
    assert all(got["program"][k] <= limits[k] for k in got["program"]), got
    assert any(got["control"][k] > limits[k] for k in got["control"]), got


def tuner_lambda_moved(monkeypatch):
    """The step's best lambda one point of its grid below where it is,
    its score kept."""
    search = lb_optimizer.shared_hparam_search

    def moved(sigma, kernel, engine_factory, init_bounds, **kwargs):
        score, log_lam = search(sigma, kernel, engine_factory, init_bounds,
                                **kwargs)
        lo, hi = max(init_bounds[0, 0], np.log(1e-3)), init_bounds[0, 1]
        return score, log_lam - (hi - lo) / 99
    monkeypatch.setattr(lb_optimizer, "shared_hparam_search", moved)


def exact_nmll_altered(monkeypatch):
    """The step's exact NMLL, each score of its lambda grid, one part in
    1e5 high."""
    scoregrid = lb_optimizer.generate_scoregrid

    def altered(*args, **kwargs):
        scores = scoregrid(*args, **kwargs)
        return scores + 1e-5 * np.abs(scores)
    monkeypatch.setattr(lb_optimizer, "generate_scoregrid", altered)


FAULTS = [("gfp_2l.fit", half_the_data), ("gfp_2l.fit", state_unchanged),
          ("gfp_2l.fit", weights_altered),
          ("motif_1m.tune", half_the_data),
          ("motif_1m.tune", tuner_lambda_moved),
          ("motif_1m.tune", exact_nmll_altered)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, root, monkeypatch):
    fault(monkeypatch)
    res = cell.run(name, 2 ** 31 + 37, 0.2, False, device="cpu", root=root)
    assert not res["correct"], res["checks"]


def test_the_two_layer_reference_matches_the_port():
    import torch
    from xgpr_tpu_torch.kernels import KERNEL_NAME_TO_CLASS
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((60, 20, 21), generator=gen, dtype=torch.float64)
    lengths = torch.randint(9, 21, (60,), generator=gen, dtype=torch.int32)
    lengths[0] = 9
    kern = KERNEL_NAME_TO_CLASS["Conv1dTwoLayer"](
        (60, 20, 21), 512, 5151, "cpu", False,
        kernel_spec_parms={"conv_width": 9, "init_rffs": 128})
    kern.set_hyperparams(np.log(np.asarray([0.2, 0.3])))
    fmap = TwoLayerMap(21, 9, 128, 512, 5151)
    want = fmap.features(x, 0.3, lengths)
    assert torch.allclose(kern.transform_x(x, lengths), want, rtol=0,
                          atol=1e-12)
    assert (fmap.variance_columns(64).numpy()
            == kern.variance_column_indices(64)).all()
    control = fmap.features(x, 0.3, lengths, "tf32")
    assert float((control - want).abs().max()) > 1e-5
    assert ref_features.tf32(control.float()).shape == want.shape


def test_k4_work_by_hand():
    cfg = {"model": {"feature_dtype": "float32"}}
    basis = {"rows": 21446, "windows": 21446 * 229, "chunks": 3,
             "chunk_rows": 8192}
    counts = Counter({(8192, 237, 21, 9, 1024, "high"): 6})
    flops, nbytes = k4.work(counts, basis, cfg)
    rows = 2 * 21446
    assert flops == 2 * rows * 229 * 9 * 21 * 1024
    assert nbytes == rows * (237 * 21 * 4 + 4 + 1024 * 4) \
        + 6 * 9 * 21 * 1024 * 4
    seconds = peaks.least_seconds(flops, nbytes, "float32")
    assert seconds == flops / peaks.FLOPS["tf32"]


def _passes_run(counts, ops=1):
    return SimpleNamespace(
        traced=[{"kind": "fit"}] * ops, notes={"launches": counts},
        basis={"rows": 21446, "windows": None, "chunks": 3,
               "chunk_rows": 8192})


def test_k4_passes_count_whole_passes_per_fit():
    read = cell.reader("k4_passes.fit").read
    counts = Counter({(8192, 237, 21, 9, 1024, "high"): 3 * 40,
                      (2000, 237, 21, 9, 1024, "high"): 5})
    assert read(_passes_run(counts, ops=2)) == 20.0
    assert read(_passes_run(Counter())) is None
    assert read(_passes_run(counts, ops=0)) is None


@pytest.mark.parametrize("name,span_name", [
    ("twolayer_l1_ms.fit", "xgpr/twolayer.l1"),
    ("twolayer_l2_ms.fit", "xgpr/twolayer.l2")])
def test_device_time_a_layer_call(name, span_name):
    """Device ms launched inside each of the layer's spans, over their
    count; nothing without the program's spans or without a trace."""
    read = cell.reader(name).read
    run = traced_run([span("gpbench/fit", 0, 50000),
                      span(span_name, 100, 200), span(span_name, 1000, 200),
                      ev("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=1),
                      ev("cudaLaunchKernel", "cuda_runtime", 1050, 5, corr=2),
                      ev("cudaLaunchKernel", "cuda_runtime", 5000, 5, corr=3),
                      ev("k4", "kernel", 300, 400, tid=7, corr=1),
                      ev("k2", "kernel", 1200, 200, tid=7, corr=2),
                      ev("other", "kernel", 5100, 900, tid=7, corr=3)])
    assert read(run) == pytest.approx(1e3 * 600e-6 / 2)
    assert read(traced_run([span("gpbench/fit", 0, 5000)])) is None
    run.trace = None
    assert read(run) is None
