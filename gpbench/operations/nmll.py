"""A tuner's step, back to back: ``approximate_nmll`` at a fixed list of
points inside the configuration's box, visited in the seed's order and
cycled, in whole rounds of the list.  Compared at points drawn from the
seed among those the window visited: the NMLL against the reference's
copy of the port's SLQ estimate (the same sketch and probes, so that the
estimator's own error cancels and the arithmetic is held tight), and
against the exact NMLL (so that a fault of the estimator that the copy
shares still shows)."""
import numpy as np

from gpbench.harness.operation import Operation
from gpbench.reference import solve as ref_solve


class Op(Operation):

    def setup(self, data=None):
        data = data or self.make_data()
        self.progress("data made")
        self.keep_training_rows(data)
        del data
        self.progress("data on the host")
        self.build_model(self.train)
        self.points = self.draw_points()
        self.values = {}

    @property
    def round_ops(self):
        """The window runs whole rounds of the point list, so that every
        seed does the same work."""
        return len(self.points)

    def draw_points(self):
        """The same ``points`` points for every seed, in the seed's
        order: one at the centre of each of as many strata of log lambda,
        each paired with a stratum of log sigma three strata on (a fixed
        Latin pairing), inside the configuration's box.  The seed makes
        the data and the model and orders the visits."""
        n = self.traffic["points"]
        box = np.asarray(self.config["nmll"]["box"], dtype=float)
        strata = np.stack([np.arange(n), (3 * np.arange(n)) % n], axis=1)
        order = np.random.default_rng(self.seed).permutation(n)
        u = (strata[order] + 0.5) / n
        return box[:, 0] + u * (box[:, 1] - box[:, 0])

    def step(self, i):
        from xgpr_tpu_torch.constants import DEFAULT_SCORE_IF_PROBLEM
        idx = i % len(self.points)

        def once(rec):
            with self.span("gpbench/nmll"):
                value = self.model.approximate_nmll(
                    self.points[idx], self.dataset,
                    manual_settings=self.config["nmll"]["settings"])
            self.values[idx] = value
            rec["failed"] = not (np.isfinite(value)
                                 and value < DEFAULT_SCORE_IF_PROBLEM)
        self.guarded(once, {"kind": "nmll", "point": idx})

    def warmup(self):
        super().warmup()
        self.values.clear()

    def checked_points(self):
        """The points compared: ``check_points`` of those the window
        visited, drawn from the seed."""
        visited = sorted(self.values)
        rng = np.random.default_rng(self.seed + 1)
        k = min(self.traffic["check_points"], len(visited))
        return sorted(rng.choice(visited, size=k, replace=False).tolist())

    def outputs(self):
        return {"nmll": {i: self.values[i] for i in self.checked_points()}}

    def reference_outputs(self, precision, device, points=None):
        """The SLQ estimate and, beside it, the exact NMLL at each
        point."""
        fmap = self.feature_map(device)
        s = self.config["nmll"]["settings"]
        n = self.config["data"]["rows"]
        out = {"nmll": {}, "exact": {}}
        for i in (points if points is not None else self.checked_points()):
            _, (g, zty, yty) = self.reference_fit(fmap, self.train, precision,
                                                  point=self.points[i])
            _, lam = self.sigma_lambda(self.points[i])
            out["nmll"][i] = ref_solve.slq_nmll(
                g, zty, yty, lam, n, self.mseed, s["max_rank"],
                s["nsamples"], s["nmll_iter"], s["nmll_tol"])
            out["exact"][i] = ref_solve.exact_nmll(g, zty, yty, lam, n)
        return out

    def numbers(self, out, ref):
        """The widest gap over the checked points, per row: to the SLQ
        copy, and to the exact NMLL."""
        n = self.config["data"]["rows"]
        return {key: max(abs(out["nmll"][i] - ref[part][i]) / n
                         for i in ref[part])
                for key, part in (("nmll_gap", "nmll"),
                                  ("nmll_exact_gap", "exact"))}
