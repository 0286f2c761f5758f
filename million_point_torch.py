#!/usr/bin/env python3
"""The 1M-row motif tune -> fit -> verify run of the PyTorch/CUDA port
(xgpr_tpu_torch) on one CUDA card, in one process.

    python3 million_point_torch.py                   # NORTHSTAR_torch.json
    python3 million_point_torch.py --streamed        # adds the streamed fit

The recipe is the one NORTHSTAR_r05_motif.json records for xgpr_tpu
(scripts/million_point_tune_fit.py with --profile motif --heldout 20000):
1,000,000 training rows and 20,000 held out of the motif corpus (L 16,
D 64, Conv1dRBF with conv width 9), chunks of 16,384 rows.

- data: the corpus, generated exactly as that script's _generate_motif
  does (seed 0, 50,000-row chunks), in memory.
- tune: tune_hyperparams_crude on the first 100,000 rows at 2048 RFFs,
  max_bayes_iter 15; the crude score (the NMLL with lambda optimised on
  its grid) at the tuned sigma and at the pinned one.
- fit, at the pinned point (the reference's tuned hyperparameters) and at
  the port's tuned point: a rank-512 srht_2 Nystrom preconditioner, then
  CG at 8192 RFFs to tol 1e-6 with the variance suppressed; RMSE on a
  20,000-row train sample (drawn with default_rng(1)), held-out RMSE and
  Spearman.  The dataset is held on the card: the stacked limit is raised
  above its 1.02e9 elements.  At the pinned point three more solves with
  the same preconditioner: CG capped at the reference's 11 iterations,
  the closed-form solve of the float64 Gram (fit mode "exact"), and CG
  with its state, preconditioner and matvec output rounded to float32
  (as in xgpr_tpu's float32 solve); their predictions are scored the same
  way.
- verify, at both points, at 256 RFFs and rank 64, three readings:
  (a) approximate_nmll on the card (float32 K3 features, float64 CG
      state): what the tuner optimises;
  (b) the fp64 referee: a float64 model on the CPU accumulates its Gram
      once; the exact NMLL from its Cholesky factor and the SLQ NMLL
      through GramEngine with the same probes and preconditioner seed;
  (c) the card's Gram: float32 K3 features with float64 chunk products,
      through GramEngine, exact and SLQ.
- streamed (``--streamed``): the pinned-point fit again with the dataset
  streamed through the prefetching engine; its CG iterations and
  held-out predictions against the stacked fit's, and one CG
  iteration's data pass split into host assembly, copy and compute.

The results go to ``--out`` (NORTHSTAR_torch.json, with xgpr_tpu's field
names where they exist) and to stdout.  Where the run has the reference's
settings the gates below are checked; the exit code is 1 if one fails.
"""
import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 123

# NORTHSTAR_r05_motif.json: xgpr_tpu's tuned point, the pinned point here
# (log lambda, log sigma), and what its run reached there.
PINNED = np.array([-1.4877232, -3.9336658309141335])
REF_HELDOUT_RMSE, REF_HELDOUT_SPEARMAN = 0.2800787000155547, \
    0.8131874416913231
REF_EXACT64_NMLL = 1275521.2136718812
# Its CG stopped after 11 iterations; the pinned point is also fitted
# with at most that many, to see what the extra iterations buy.
REF_CG_ITERATIONS = 11
NORTH_STAR_TOLERANCE = 1e-3
FIT_TOL = 1e-6
MAX_CG_ITER = 500
# Gates: held-out RMSE within 1% and Spearman within 0.005 of the
# reference at the pinned point; the referee's exact NMLL within 1e-6 of
# the reference's (fp64 on both sides); its SLQ within the north star's
# 1e-3 of its exact NMLL at both points; the tuned fit's Spearman at least
# 0.80; the streamed fit within one CG iteration of the stacked one, its
# predictions within 1e-4 of max |prediction|.
RMSE_RTOL, SPEARMAN_ATOL, EXACT64_RTOL = 0.01, 0.005, 1e-6
TUNED_SPEARMAN_FLOOR = 0.80
STREAMED_PREDICT_RTOL = 1e-4
REFERENCE = {"rows": 1_000_000, "heldout": 20_000, "seq_len": 16, "dim": 64,
             "conv_width": 9, "num_rffs": 8192, "tune_rffs": 2048,
             "tune_rows": 100_000, "max_rank": 512, "max_bayes_iter": 15,
             "verify_rffs": 256, "verify_rank": 64}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name, value in REFERENCE.items():
        ap.add_argument("--" + name.replace("_", "-"), type=int,
                        default=value)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--device", default="cuda",
                    help="the port's device; the referee is on the CPU")
    ap.add_argument("--streamed", action="store_true",
                    help="also fit through the streaming engine")
    ap.add_argument("--out", default=str(ROOT / "NORTHSTAR_torch.json"))
    return ap.parse_args(argv)


# ----------------------------------------------------------------------
def motif_corpus(rows, heldout, seq_len=16, dim=64, width=9):
    """The motif corpus of scripts/million_point_tune_fit.py:_generate_motif,
    copied draw for draw (default_rng(0), 50,000-row chunks), held in
    memory, with the target's window sums reordered: one-hot letters from
    a 21-symbol alphabet plus 0.1 noise, and an anchor-RBF target over
    the valid windows.  Returns x (n, L, D) float32, y (n,) float64 and
    lengths (n,) int32 for n = rows + heldout."""
    rng = np.random.default_rng(0)
    L, D = seq_len, dim
    nw = L - width + 1
    wd = width * D
    alphabet = min(D, 21)
    sig_t = 0.7
    n_anchor = 128

    n_gen = rows + heldout
    letters = rng.integers(0, alphabet, (n_gen, L))
    lengths = rng.integers(width, L + 1, size=(n_gen,)).astype(np.int32)
    a_rows = rng.integers(0, n_gen, n_anchor)
    a_starts = rng.integers(0, nw, n_anchor)
    eye = np.eye(D, dtype=np.float32)

    x = np.empty((n_gen, L, D), dtype=np.float32)
    chunk = 50_000
    for lo in range(0, n_gen, chunk):
        hi = min(lo + chunk, n_gen)
        xb = eye[letters[lo:hi]]
        xb += 0.1 * rng.standard_normal(xb.shape).astype(np.float32)
        x[lo:hi] = xb

    anchors = np.stack([x[r, s:s + width, :].reshape(wd)
                        for r, s in zip(a_rows, a_starts)]).astype(np.float64)
    coef = rng.standard_normal(n_anchor)
    an2 = (anchors ** 2).sum(-1)

    n_valid = np.clip(lengths - width + 1, 1, nw).astype(np.float64)
    wmask = np.arange(nw)[None, :]
    y = np.empty(n_gen, dtype=np.float64)
    for lo in range(0, n_gen, chunk):
        hi = min(lo + chunk, n_gen)
        xb = np.asarray(x[lo:hi], dtype=np.float64)
        # One window at a time, with its squared norm from the positions'
        # squared norms: the reference's (rows, windows, w*D) stack costs
        # most of its time; the sums run in another order (1e-16).
        pos2 = (xb * xb).sum(-1)
        wn2 = np.stack([pos2[:, t:t + width].sum(1) for t in range(nw)],
                       axis=1)
        cross = np.stack([xb[:, t:t + width, :].reshape(hi - lo, wd)
                          @ anchors.T for t in range(nw)], axis=1)
        d2 = wn2[:, :, None] - 2.0 * cross + an2[None, None, :]
        g = np.exp(-0.5 * sig_t * sig_t * d2) @ coef
        valid = wmask < n_valid[lo:hi, None]
        y[lo:hi] = (g * valid).sum(1) / n_valid[lo:hi]
    y = (y - y.mean()) / y.std() * 0.4
    y += 0.1 * rng.standard_normal(n_gen)
    return x, y, lengths


# ----------------------------------------------------------------------
class Run:
    """One invocation: its arguments, corpus and results."""

    def __init__(self, args):
        import torch
        self.torch = torch
        self.args = args
        self.result = {}
        self._corpus = None
        self._datasets = {}

    # -- helpers -------------------------------------------------------
    def sync(self):
        if self.torch.device(self.args.device).type == "cuda":
            self.torch.cuda.synchronize()

    def corpus(self):
        if self._corpus is None:
            a = self.args
            t0 = time.perf_counter()
            self._corpus = motif_corpus(a.rows, a.heldout, a.seq_len, a.dim,
                                        a.conv_width)
            secs = time.perf_counter() - t0
            self.result["data_sec"] = secs
            print(f"corpus: {a.rows} + {a.heldout} rows x {a.seq_len} x "
                  f"{a.dim} in {secs:.1f}s", flush=True)
        return self._corpus

    def dataset(self, n_rows):
        """The first n_rows of the corpus as a training dataset."""
        from xgpr_tpu_torch import build_regression_dataset
        if n_rows not in self._datasets:
            x, y, lens = self.corpus()
            self._datasets[n_rows] = build_regression_dataset(
                x[:n_rows], y[:n_rows], lens[:n_rows],
                chunk_size=self.args.chunk)
        return self._datasets[n_rows]

    def model(self, num_rffs, device=None):
        from xgpr_tpu_torch import GPRegression
        return GPRegression(num_rffs=num_rffs,
                            variance_rffs=min(512, num_rffs // 4),
                            kernel_choice="Conv1dRBF",
                            kernel_settings={"conv_width":
                                             self.args.conv_width},
                            device=device or self.args.device, verbose=False,
                            random_seed=SEED)

    def timed(self, fn, *args, **kw):
        self.sync()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.sync()
        return out, time.perf_counter() - t0

    def launches(self):
        """K3's launches so far by shape (rows, L, D, w, F), as text."""
        from xgpr_tpu_torch.ops.cuda import conv
        return {" ".join(map(str, k)): v
                for k, v in sorted(conv.PARTS_LAUNCHES.items())}

    # -- phases --------------------------------------------------------
    def tune(self):
        from xgpr_tpu_torch.scoring.lb_optimizer import shared_hparam_search
        a = self.args
        n_sub = min(a.tune_rows, a.rows)
        sub = self.dataset(n_sub)
        model = self.model(a.tune_rffs)
        (hp, n_feval, score), secs = self.timed(
            model.tune_hyperparams_crude, sub,
            max_bayes_iter=a.max_bayes_iter)
        hp = [float(h) for h in hp]
        pinned_score, pinned_lambda = shared_hparam_search(
            PINNED[1:], model.kernel, lambda: model._engine(sub),
            model.kernel.get_bounds()[:1])
        rec = {"tune_crude_sec": secs, "tune_crude_nfeval": int(n_feval),
               "tune_crude_score": float(score),
               "tuned_hyperparams": hp,
               "tuned_distance_from_pinned": float(np.linalg.norm(
                   np.asarray(hp) - PINNED)),
               "crude_score_at_pinned_sigma": float(pinned_score),
               "crude_lambda_at_pinned_sigma": float(pinned_lambda[0]),
               # The objective at both full points, lambda as given.
               "tune_exact_nmll_at_tuned": float(
                   model.exact_nmll(np.asarray(hp), sub)),
               "tune_exact_nmll_at_pinned": float(
                   model.exact_nmll(PINNED, sub))}
        self.result.update(rec)
        print(f"crude tune ({n_sub} rows, {a.tune_rffs} RFFs, "
              f"max_bayes_iter {a.max_bayes_iter}): {hp} score {score} in "
              f"{secs:.2f}s ({n_feval} evaluations); at the pinned sigma "
              f"{PINNED[1]} the crude score is {pinned_score} (lambda "
              f"{rec['crude_lambda_at_pinned_sigma']}); distance "
              f"{rec['tuned_distance_from_pinned']:.4f}; exact NMLL on these "
              f"rows at the tuned point {rec['tune_exact_nmll_at_tuned']}, "
              f"at the pinned point {rec['tune_exact_nmll_at_pinned']}",
              flush=True)
        return np.asarray(hp)

    def score(self, model):
        """Train-sample RMSE, held-out RMSE and Spearman of a fitted model,
        and its held-out predictions."""
        from scipy.stats import spearmanr
        a = self.args
        x, y, lens = self.corpus()
        idx = np.random.default_rng(1).choice(a.rows, min(20000, a.rows // 2),
                                              replace=False)
        idx.sort()
        preds = model.predict(x[idx], sequence_lengths=lens[idx])
        held = model.predict(x[a.rows:], sequence_lengths=lens[a.rows:])
        yh = y[a.rows:]
        return {"train_sample_rmse": float(np.sqrt(np.mean(
                    (preds - y[idx]) ** 2))),
                "heldout_rmse": float(np.sqrt(np.mean((held - yh) ** 2))),
                "heldout_spearman": float(spearmanr(held, yh)[0])}, held

    def cg(self, model, data, precond, max_iter):
        (n_iter, losses), secs = self.timed(
            model.fit, data, preconditioner=precond, tol=FIT_TOL,
            mode="cg", max_iter=max_iter, suppress_var=True,
            run_diagnostics=True)
        cg_s = model.fit_phase_times["cg"]
        return {"fit_tol": FIT_TOL, "fit_sec": secs,
                "cg_iterations": int(n_iter),
                "cg_final_residual": float(losses[-1]), "cg_sec": cg_s,
                "cg_ms_per_iteration": cg_s / max(n_iter, 1) * 1e3,
                "fit_phase_times": dict(model.fit_phase_times)}

    def fit(self, label, hp, mode="stacked", witnesses=False):
        """Preconditioner, CG fit and predictions at one point (with
        ``witnesses``, the other solves of the module docstring too);
        returns the record, the held-out predictions and the model."""
        a = self.args
        data = self.dataset(a.rows)
        model = self.model(a.num_rffs)
        model.set_hyperparams(hp, data)
        rec = {"mode": mode, "hyperparams": [float(h) for h in hp]}
        _, rec["engine_build_sec"] = self.timed(model._engine, data)
        (precond, _), rec["precond_sec"] = self.timed(
            model.build_preconditioner, data, max_rank=a.max_rank,
            method="srht_2")
        rec["precond_ratio"] = float(precond.achieved_ratio)
        if witnesses:
            capped = self.cg(model, data, precond, REF_CG_ITERATIONS)
            capped.update(self.score(model)[0])
            rec["at_reference_cg_iterations"] = {
                k: capped[k] for k in ("cg_iterations", "cg_final_residual",
                                       "train_sample_rmse", "heldout_rmse",
                                       "heldout_spearman")}
        rec.update(self.cg(model, data, precond, MAX_CG_ITER))
        quality, held = self.score(model)
        rec.update(quality)
        rec["y_std"] = float(np.std(self.corpus()[1][:a.rows]))
        rec["heldout_rows"] = int(a.heldout)
        print(f"{label} fit ({mode}, {a.num_rffs} RFFs, rank {a.max_rank}): "
              f"preconditioner {rec['precond_sec']:.2f}s, achieved ratio "
              f"{rec['precond_ratio']:.6g}; CG {rec['cg_iterations']} "
              f"iterations in {rec['fit_sec']:.2f}s "
              f"({rec['cg_ms_per_iteration']:.1f} ms each); train-sample RMSE"
              f" {rec['train_sample_rmse']:.4f}, held-out RMSE "
              f"{rec['heldout_rmse']:.4f}, Spearman "
              f"{rec['heldout_spearman']:.4f}", flush=True)
        if witnesses:
            rec["exact_solve"] = self.exact_solve(model, data)
            rec["float32_cg"] = self.float32_cg(model, data, precond)
        return rec, held, model

    def exact_solve(self, model, data):
        """The closed-form weights of the float64 Gram (float32 K3
        features, float64 chunk products, Cholesky in float64), against
        the CG weights the model holds."""
        w_cg = model.weights.double()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, secs = self.timed(model.fit, data, mode="exact",
                                 suppress_var=True)
        w = model.weights.double()
        rec = {"fit_sec": secs, "warnings": [str(c.message) for c in caught],
               "weights_rel_diff_from_cg": float(
                   self.torch.linalg.norm(w - w_cg) /
                   self.torch.linalg.norm(w))}
        rec.update(self.score(model)[0])
        print(f"pinned, closed-form float64 solve: {secs:.2f}s; weights "
              f"{rec['weights_rel_diff_from_cg']:.3e} from CG's; held-out "
              f"RMSE {rec['heldout_rmse']:.4f}, Spearman "
              f"{rec['heldout_spearman']:.4f}", flush=True)
        return rec

    def float32_cg(self, model, data, precond):
        """The port's CG recurrence (fitting/fused_cg.py::_cg_while) with
        its state and preconditioner in float32 and each matvec (the
        engine's ztzv: float32 features, float64 chunk sums) rounded to
        float32: the precision of xgpr_tpu's solve."""
        from xgpr_tpu_torch.fitting.fused_cg import _cg_while, _precond_mv
        engine = model._engine(data)
        n = engine.ndatapoints
        u32, inv32 = precond.u_mat.float(), precond.inv_eig.float()
        rhs = (precond.get_zty() / n)[:, None].float()
        (x, converged, n_iter, _, _, errs), secs = self.timed(
            _cg_while, lambda v: engine.ztzv(v).float(),
            lambda v: _precond_mv(u32, inv32, precond.prefactor, v),
            rhs, model.kernel.get_lambda(), MAX_CG_ITER, FIT_TOL)
        model.weights = (x[:, 0].double() * n).to(engine._dtype)
        rec = {"cg_iterations": int(n_iter), "converged": bool(converged),
               "cg_final_residual": float(errs[-1]), "cg_sec": secs}
        rec.update(self.score(model)[0])
        print(f"pinned, float32 CG: {n_iter} iterations (converged "
              f"{converged}, recursive residual {rec['cg_final_residual']:.3e})"
              f" in {secs:.2f}s; held-out RMSE {rec['heldout_rmse']:.4f}, "
              f"Spearman {rec['heldout_spearman']:.4f}", flush=True)
        return rec

    def gram(self, kind, model, data):
        """(Z^T Z, Z^T y, y^T y) of ``model`` and the seconds it took: the
        referee's through a streaming engine on its device (the CPU), the
        card's through the model's engine."""
        from xgpr_tpu_torch.fitting.engine import Engine
        engine = Engine(model.kernel, data, mode="streaming") \
            if kind == "referee" else model._engine(data)
        return self.timed(engine.design_mat)

    def gram_readings(self, kind, model, data):
        """Exact NMLL and GramEngine SLQ NMLL from one Gram."""
        from xgpr_tpu_torch import constants
        from xgpr_tpu_torch.fitting.gram_engine import GramEngine
        from xgpr_tpu_torch.models.regression import exact_nmll_from_design
        from xgpr_tpu_torch.preconditioners.nystrom import \
            NystromPreconditioner
        from xgpr_tpu_torch.scoring.slq import slq_nmll_from_engine
        a = self.args
        design, gram_s = self.gram(kind, model, data)
        ge = GramEngine(*design, model.kernel, data.get_ndatapoints())
        lam = model.kernel.get_lambda()
        exact, exact_s = self.timed(exact_nmll_from_design,
                                    ge.gram, ge._zty, ge._yty, lam,
                                    ge.ndatapoints)
        params = constants.DEFAULT_NMLL_PARAMS

        def slq():
            pre = NystromPreconditioner(ge, a.verify_rank, False, SEED,
                                        "srht_2")
            return slq_nmll_from_engine(ge, pre, SEED, params["nsamples"],
                                        params["nmll_iter"],
                                        params["nmll_tol"]), \
                pre.achieved_ratio
        (approx, ratio), slq_s = self.timed(slq)
        return {"gram_sec": gram_s, "exact_nmll": float(exact),
                "exact_sec": exact_s, "slq_nmll": float(approx),
                "slq_sec": slq_s, "slq_precond_ratio": float(ratio),
                "slq_rel_delta": float(abs(approx - exact) / abs(exact))}

    def verify(self, label, hp):
        a = self.args
        data = self.dataset(a.rows)
        rec = {"verify_rffs": a.verify_rffs, "verify_rank": a.verify_rank}
        model = self.model(a.verify_rffs)
        model.set_hyperparams(hp, data)
        approx, secs = self.timed(
            model.approximate_nmll, hp, data,
            manual_settings={"max_rank": a.verify_rank,
                             "preconditioner_mode": "srht_2"})
        rec.update({"slq_verify_nmll": float(approx),
                    "slq_verify_sec": secs})
        card_gram = self.gram_readings("card", model, data)
        del model
        referee = self.model(a.verify_rffs, device="cpu")
        referee.set_hyperparams(hp, data)
        ref = self.gram_readings("referee", referee, data)
        rec.update({"exact64_nmll": ref["exact_nmll"],
                    "exact64_sec": ref["exact_sec"],
                    "gram64_sec": ref["gram_sec"],
                    "slq64_nmll": ref["slq_nmll"], "slq64_sec": ref["slq_sec"],
                    "slq64_method": "gram_fp64",
                    "slq64_precond_ratio": ref["slq_precond_ratio"],
                    "nmll_rel_delta": ref["slq_rel_delta"],
                    "exact_method": "host_fp64",
                    "gate_estimator": "host_fp64_slq",
                    "north_star_tolerance": NORTH_STAR_TOLERANCE,
                    "nmll_within_tolerance":
                        bool(ref["slq_rel_delta"] < NORTH_STAR_TOLERANCE),
                    "card_gram": card_gram})
        exact = ref["exact_nmll"]
        rec["card_slq_rel_delta"] = abs(rec["slq_verify_nmll"] - exact) / \
            abs(exact)
        rec["card_gram_exact_rel_delta"] = abs(card_gram["exact_nmll"] -
                                               exact) / abs(exact)
        print(f"{label} verify ({a.verify_rffs} RFFs, rank "
              f"{a.verify_rank}): (a) card SLQ {rec['slq_verify_nmll']:.4f} "
              f"({rec['card_slq_rel_delta']:.3e} from the referee's exact); "
              f"(b) referee exact {exact:.4f}, SLQ {ref['slq_nmll']:.4f} "
              f"(gap {ref['slq_rel_delta']:.3e}; Gram "
              f"{ref['gram_sec']:.2f}s); "
              f"(c) card Gram exact {card_gram['exact_nmll']:.4f} "
              f"({rec['card_gram_exact_rel_delta']:.3e} from the referee), "
              f"SLQ {card_gram['slq_nmll']:.4f} (gap "
              f"{card_gram['slq_rel_delta']:.3e})", flush=True)
        return rec

    def streamed(self, stacked_rec, stacked_held):
        """The pinned-point fit through the streaming engine, against the
        stacked fit, and one data pass split into its parts."""
        from xgpr_tpu_torch import config
        from xgpr_tpu_torch.fitting.engine import Engine
        from xgpr_tpu_torch.parallel.streaming import iteration_split
        data = self.dataset(self.args.rows)
        limit = config.stacked_element_limit()
        config.set_stacked_limit(1)
        try:
            rec, held, model = self.fit("pinned", PINNED, mode="streamed")
            engine = model._engine(data)
        finally:
            config.set_stacked_limit(limit)
        rec["cg_iterations_stacked"] = stacked_rec["cg_iterations"]
        rec["max_abs_pred_diff"] = float(np.abs(held - stacked_held).max())
        rec["pred_tol"] = STREAMED_PREDICT_RTOL * float(
            np.abs(stacked_held).max())
        if engine.prefetcher is not None:
            stacked = Engine(model.kernel, data, mode="stacked")
            vec = np.random.default_rng(5).standard_normal(model.num_rffs)
            rec["iteration_split"] = iteration_split(engine, stacked, vec)
            print(f"streamed data pass: {rec['iteration_split']}", flush=True)
        print(f"streamed vs stacked: CG iterations {rec['cg_iterations']} vs "
              f"{rec['cg_iterations_stacked']}; held-out predictions differ "
              f"by {rec['max_abs_pred_diff']:.3e} (tol {rec['pred_tol']:.3e})",
              flush=True)
        return rec

    # -- the whole run -------------------------------------------------
    def execute(self):
        from xgpr_tpu_torch import config
        # 1,015,808 padded rows x 16 x 64 = 1.04e9 elements: above the
        # default limit of 1e9, and ~4.2 GB of float32 on an 80 GB card.
        limit = config.stacked_element_limit()
        config.set_stacked_limit(4 * 10 ** 9)
        try:
            return self._phases()
        finally:
            config.set_stacked_limit(limit)

    def _phases(self):
        a = self.args
        self.result.update({k: getattr(a, k) for k in REFERENCE})
        self.result.update({"chunk": a.chunk, "kernel": "Conv1dRBF",
                            "profile": "motif", "device": device_record(a)})
        self.corpus()
        if self.torch.device(a.device).type == "cuda":
            from xgpr_tpu_torch.ops.cuda import build
            _, self.result["kernel_build_sec"] = self.timed(build.library)
        points = {"pinned": PINNED, "tuned": self.tune()}
        self.result["pinned_hyperparams"] = [float(h) for h in PINNED]
        self.result["points"] = {}
        held = {}
        for label, hp in points.items():
            rec, held[label], _ = self.fit(label, hp,
                                           witnesses=label == "pinned")
            rec.update(self.verify(label, hp))
            self.result["points"][label] = rec
        if a.streamed:
            self.result["streamed"] = self.streamed(
                self.result["points"]["pinned"], held["pinned"])
        self.result["k3_launches_by_shape"] = self.launches()
        self.result["gates"] = gates(self.result, a)
        return self.result


def device_record(args):
    import torch
    if torch.device(args.device).type != "cuda":
        return {"platform": "cpu"}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": out.stdout.strip().splitlines()[0]
            if out.returncode == 0 else None}


def gates(result, args):
    """Each gate that applies to this run: its value, its limit and
    whether it passed; a comparison's value is the distance to the
    reference (relative for RMSE and NMLLs, absolute for Spearman)."""
    out = {}
    points = result["points"]
    reference_run = all(getattr(args, k) == v for k, v in REFERENCE.items())
    pinned, tuned = points["pinned"], points["tuned"]
    if reference_run:
        rel = abs(pinned["heldout_rmse"] - REF_HELDOUT_RMSE) / \
            REF_HELDOUT_RMSE
        out["pinned_heldout_rmse_vs_reference"] = (rel, RMSE_RTOL,
                                                   rel <= RMSE_RTOL)
        diff = abs(pinned["heldout_spearman"] - REF_HELDOUT_SPEARMAN)
        out["pinned_heldout_spearman_vs_reference"] = (
            diff, SPEARMAN_ATOL, diff <= SPEARMAN_ATOL)
        rel = abs(pinned["exact64_nmll"] - REF_EXACT64_NMLL) / \
            REF_EXACT64_NMLL
        out["pinned_exact64_vs_reference"] = (rel, EXACT64_RTOL,
                                              rel <= EXACT64_RTOL)
        out["tuned_heldout_spearman"] = (
            tuned["heldout_spearman"], TUNED_SPEARMAN_FLOOR,
            tuned["heldout_spearman"] >= TUNED_SPEARMAN_FLOOR)
    for label, rec in points.items():
        out[label + "_slq64_vs_exact64"] = (
            rec["nmll_rel_delta"], NORTH_STAR_TOLERANCE,
            rec["nmll_rel_delta"] < NORTH_STAR_TOLERANCE)
    streamed = result.get("streamed")
    if streamed:
        diff = abs(streamed["cg_iterations"] -
                   streamed["cg_iterations_stacked"])
        out["streamed_cg_iterations"] = (diff, 1, diff <= 1)
        out["streamed_predictions"] = (
            streamed["max_abs_pred_diff"], streamed["pred_tol"],
            streamed["max_abs_pred_diff"] <= streamed["pred_tol"])
    return {k: {"value": v, "limit": lim, "passed": bool(ok)}
            for k, (v, lim, ok) in out.items()}


def main(argv=None):
    args = parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("no CUDA device is visible; pass --device cpu to run the "
              "port on the CPU.", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    result = Run(args).execute()
    result["total_sec"] = time.perf_counter() - t0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    failed = [k for k, g in result["gates"].items() if not g["passed"]]
    if failed:
        print(f"gates failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
