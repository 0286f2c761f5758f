"""The crude tuner's step, back to back: ``tune_hyperparams_crude``
scores each sigma it visits with ``scoring.lb_optimizer``'s
``shared_hparam_search`` (the design matrix Z^T Z, its float64
eigendecomposition, then the NMLL on a 100-point lambda grid on the
host, the amplitude in closed form).  This kind makes that call, with
the model's engine and the kernel's lambda bounds as the tuner passes
them, at ``points`` fixed log sigma of the configuration's pinned point
plus or minus ``box_halfwidth``, visited in the seed's order in whole
rounds, as the NMLL kind (``operations/nmll.py``) visits its box.  The
tuner's surrogate search between the steps is host work whose number of
steps varies with the seed, and is left out.  The traffic sets the rows
(``rows``: the data made at that size) and the model's width
(``num_rffs``) wherever the NMLL kind reads the configuration's.

Compared at ``check_points`` of the visited sigma drawn from the seed,
against the reference's exact NMLL (a Cholesky factor of its float64
Gram) at every point of the same lambda grid: the step's best score
against the grid's least, and the reference's score at the step's
lambda against that least (the lambda's regret), both per row."""
import copy
from pathlib import Path

import numpy as np

from gpbench.harness import spec
from gpbench.reference import solve as ref_solve

_nmll = spec.load_module("operations", "nmll",
                         Path(__file__).resolve().parents[2])

# The tuner's lambda grid: shared_hparam_search's default points, and
# the floor it puts under the lower bound.
GRID_POINTS = 100
LAMBDA_FLOOR = 1e-3


def _exact_nmll(g, zty, yty, lambda_, n):
    """The exact NMLL, or inf where it cannot be computed: where Z^T Z +
    lambda^2 I has no Cholesky factor, or y^T y - y^T Z w comes out
    negative (the TF32 control's Gram is not positive semi-definite, and
    fails so at the grid's smallest lambda)."""
    try:
        return ref_solve.exact_nmll(g, zty, yty, lambda_, n)
    except (RuntimeError, ValueError):
        return np.inf


class Op(_nmll.Op):

    def __init__(self, cell, seed, device="cuda"):
        super().__init__(cell, seed, device)
        t = self.traffic
        self.config = copy.deepcopy(cell.config)
        self.config["data"].update(rows=t["rows"], test_rows=0)
        self.config["model"]["num_rffs"] = t["num_rffs"]
        self.model_cfg = self.config["model"]

    def setup(self, data=None):
        super().setup(data)
        # What tune_hyperparams_crude hands each step: lambda's row of
        # the kernel's bounds.
        self.lambda_bounds = self.model.kernel.get_bounds()[:1].copy()

    def draw_points(self):
        """The same ``points`` log sigma for every seed, in the seed's
        order: the centres of as many strata of the pinned log sigma
        plus or minus ``box_halfwidth``."""
        n = self.traffic["points"]
        half = self.traffic["box_halfwidth"]
        centre = float(self.model_cfg["hyperparams"][1])
        u = (np.random.default_rng(self.seed).permutation(n) + 0.5) / n
        return (centre - half + 2 * half * u)[:, None]

    def step(self, i):
        from xgpr_tpu_torch.constants import DEFAULT_SCORE_IF_PROBLEM
        from xgpr_tpu_torch.scoring import lb_optimizer
        idx = i % len(self.points)
        model = self.model

        def once(rec):
            with self.span("gpbench/nmll"):
                score, log_lam = lb_optimizer.shared_hparam_search(
                    self.points[idx], model.kernel,
                    lambda: model._engine(self.dataset), self.lambda_bounds)
            self.values[idx] = (float(score), float(log_lam[0]))
            rec["failed"] = not (np.isfinite(score)
                                 and score < DEFAULT_SCORE_IF_PROBLEM)
        self.guarded(once, {"kind": "nmll", "point": idx})

    def outputs(self):
        pts = self.checked_points()
        return {"score": {i: self.values[i][0] for i in pts},
                "log_lambda": {i: self.values[i][1] for i in pts}}

    def lambda_grid(self):
        """The log lambda the step scores (one cycle of its grid)."""
        lo, hi = self.lambda_bounds[0]
        return np.linspace(max(lo, np.log(LAMBDA_FLOOR)), hi, GRID_POINTS)

    def reference_outputs(self, precision, device, points=None):
        """At each point, the exact NMLL from the reference's Gram at
        every lambda of the grid: the least ("score"), its lambda, and
        the whole grid."""
        fmap = self.feature_map(device)
        n = self.config["data"]["rows"]
        grid = self.lambda_grid()
        out = {"score": {}, "log_lambda": {}, "grid": {}}
        for i in (points if points is not None else self.checked_points()):
            point = np.concatenate([[0.0], self.points[i]])
            _, (g, zty, yty) = self.reference_fit(fmap, self.train, precision,
                                                  point=point)
            scores = np.asarray([_exact_nmll(g, zty, yty,
                                             float(np.exp(lam)), n)
                                 for lam in grid])
            best = int(np.argmin(scores))
            out["score"][i] = float(scores[best])
            out["log_lambda"][i] = float(grid[best])
            out["grid"][i] = scores
        return out

    def numbers(self, out, ref):
        """The widest gaps over the checked points, per row: the best
        score to the grid's least, and the lambda's regret (the
        reference's score at the grid point nearest the step's lambda,
        over the least)."""
        n = self.config["data"]["rows"]
        grid = self.lambda_grid()
        score_gap, regret = 0.0, 0.0
        for i, least in ref["score"].items():
            score_gap = max(score_gap, abs(out["score"][i] - least) / n)
            j = int(np.argmin(np.abs(grid - out["log_lambda"][i])))
            regret = max(regret, float(ref["grid"][i][j] - least) / n)
        return {"tune_score_gap": score_gap, "tune_lambda_regret": regret}
