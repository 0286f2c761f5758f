"""million_point_torch.py, the port's 1M motif run, at a tiny size.

Its corpus is scripts/million_point_tune_fit.py's _generate_motif drawn
draw for draw: x and lengths bitwise equal, y to 1e-12 (the target's
float64 window sums run in another order; measured 4e-16 relative).
Its tune -> fit -> verify on the CPU, in float64, follows the same
recipe as xgpr_tpu run through its own API: the crude-tuned point agrees
to 1e-6 (the tuners take the same evaluations, xgpr_tpu rounds lambda to
7 places) and the referee's exact NMLL at both points to 1e-8.
"""
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import xgpr_tpu

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import million_point_torch as mp  # noqa: E402

torch.set_num_threads(1)

TINY = ["--rows", "1500", "--heldout", "300", "--tune-rows", "1000",
        "--tune-rffs", "64", "--num-rffs", "128", "--max-rank", "32",
        "--verify-rffs", "64", "--verify-rank", "16", "--chunk", "500",
        "--max-bayes-iter", "12", "--device", "cpu"]


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "million_point_tune_fit",
        ROOT / "scripts" / "million_point_tune_fit.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_corpus_matches_reference_generator(tmp_path):
    rows, heldout = 2600, 400
    ref = _reference_script()
    args = SimpleNamespace(rows=rows, heldout=heldout, seq_len=16, dim=64,
                           conv_width=9, state_dir=str(tmp_path))
    paths = [str(tmp_path / n) for n in ("x.npy", "y.npy", "lengths.npy")]
    ref._generate_motif(args, np.random.default_rng(0), paths,
                        str(tmp_path / "target.json"), 0.0)
    want_x, want_y, want_l = (np.load(p) for p in paths)
    x, y, lengths = mp.motif_corpus(rows, heldout)
    assert x.dtype == want_x.dtype and np.array_equal(x, want_x)
    assert lengths.dtype == want_l.dtype and np.array_equal(lengths, want_l)
    np.testing.assert_allclose(y, want_y, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def tiny_run():
    args = mp.parse_args(TINY)
    return args, mp.Run(args).execute()


def test_tune_fit_verify_matches_jax(tiny_run):
    args, result = tiny_run
    x, y, lens = mp.motif_corpus(args.rows, args.heldout)

    def jax_model(num_rffs, n_rows):
        data = xgpr_tpu.build_regression_dataset(
            x[:n_rows], y[:n_rows], sequence_lengths=lens[:n_rows],
            chunk_size=args.chunk)
        model = xgpr_tpu.GPRegression(num_rffs=num_rffs,
                                      variance_rffs=num_rffs // 4,
                                      kernel_choice="Conv1dRBF",
                                      kernel_settings={"conv_width": 9},
                                      verbose=False)
        return model, data

    model, sub = jax_model(args.tune_rffs, args.tune_rows)
    tuned, _, score = model.tune_hyperparams_crude(
        sub, max_bayes_iter=args.max_bayes_iter)
    np.testing.assert_allclose(result["tuned_hyperparams"], tuned,
                               rtol=1e-6, atol=1e-6)
    assert abs(result["tune_crude_score"] - score) <= 1e-6 * abs(score)

    points = {"pinned": mp.PINNED, "tuned": np.asarray(tuned)}
    model, data = jax_model(args.verify_rffs, args.rows)
    for label, hp in points.items():
        rec = result["points"][label]
        model.set_hyperparams(hp, data)
        exact = model.exact_nmll(hp, data)
        assert abs(rec["exact64_nmll"] - exact) <= 1e-8 * abs(exact), label
        # The card's readings ran on the CPU here: the same float64 Gram.
        assert abs(rec["card_gram"]["exact_nmll"] - exact) <= \
            1e-8 * abs(exact)
        assert np.isfinite(rec["heldout_rmse"]) and \
            rec["cg_iterations"] > 0


def test_pinned_solve_witnesses(tiny_run):
    """At the pinned point the closed-form solve of the Gram gives the
    weights CG converged to (tol 1e-6) and the same held-out scores; CG
    in float32 converges and scores within the north star's Spearman
    gate of them; the capped fit stops at the reference's 11 iterations."""
    _, result = tiny_run
    rec = result["points"]["pinned"]
    exact, f32 = rec["exact_solve"], rec["float32_cg"]
    assert exact["weights_rel_diff_from_cg"] < 1e-4
    assert not exact["warnings"]
    for key in ("heldout_rmse", "heldout_spearman"):
        assert abs(exact[key] - rec[key]) <= 1e-4 * abs(rec[key]), key
    assert f32["converged"] and 0 < f32["cg_iterations"] <= mp.MAX_CG_ITER
    assert abs(f32["heldout_spearman"] - rec["heldout_spearman"]) <= \
        mp.SPEARMAN_ATOL
    assert rec["at_reference_cg_iterations"]["cg_iterations"] <= \
        mp.REF_CG_ITERATIONS
