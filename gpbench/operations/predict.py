"""Scoring new inputs: ``predict(x, get_var=True)`` on batches of a pool
of new rows held on the card, cycled; the model is fitted once, with its
variance, in set-up.  Compared: the mean and variance of rows drawn from
the seed among the batches the window predicted."""
import numpy as np
import torch

from gpbench.harness.operation import Operation, host, rel, rel_centred


class Op(Operation):

    def setup(self, data=None):
        t = self.traffic
        data = data or self.make_data(pool_rows=t["pool_rows"])
        self.keep_training_rows(data)
        # The rows stay on the card; their lengths go to predict as numpy,
        # as a user's do (the port copies each chunk's lengths over).
        pool_lengths = data["pool"]["lengths"]
        self.pool = {"x": data["pool"]["x"], "lengths": host(pool_lengths)}
        self.batches = t["pool_rows"] // t["batch_rows"]
        b = t["batch_rows"]
        self.batch_windows = None if pool_lengths is None else [
            self.windows_of(pool_lengths[i * b:(i + 1) * b])
            for i in range(self.batches)]
        del data
        self.progress("data made, training rows on the host")
        self.build_model(self.train)
        rec = {}
        self.fit_once(rec, suppress_var=False)
        if rec["failed"]:
            raise RuntimeError("the set-up fit did not reach its tolerance")
        self.latest = {}

    def step(self, i):
        b = i % self.batches
        rows = self.traffic["batch_rows"]
        lo, hi = b * rows, (b + 1) * rows
        x = self.pool["x"][lo:hi]
        lengths = None if self.pool["lengths"] is None else \
            self.pool["lengths"][lo:hi]

        def once(rec):
            with self.span("gpbench/predict"):
                self.latest[b] = self.model.predict(
                    x, lengths, get_var=True,
                    chunk_size=self.model_cfg["chunk"])
        self.guarded(once, {"kind": "predict", "batch": b, "rows": rows})

    def warmup(self):
        super().warmup()
        self.latest.clear()

    def basis(self, traced):
        """The traced batches together: their rows, valid windows and
        chunks."""
        done = [r for r in traced if not r.get("failed")]
        rows = sum(r["rows"] for r in done)
        chunk = self.model_cfg["chunk"]
        windows = None if self.batch_windows is None else \
            sum(self.batch_windows[r["batch"]] for r in done)
        return {"rows": rows, "windows": windows,
                "chunks": sum(-(-r["rows"] // chunk) for r in done),
                "chunk_rows": chunk}

    def checked_rows(self):
        """``check_rows`` rows of the batches the window predicted, drawn
        from the seed: (batch, row in batch) pairs."""
        rows = self.traffic["batch_rows"]
        batches = sorted(self.latest)
        rng = np.random.default_rng(self.seed + 1)
        k = min(self.traffic["check_rows"], rows * len(batches))
        flat = np.sort(rng.choice(rows * len(batches), size=k,
                                  replace=False))
        return [(batches[f // rows], f % rows) for f in flat]

    def outputs(self):
        """The predictions of the checked rows; their inputs are kept on
        the host for the reference."""
        picks = self.checked_rows()
        rows = self.traffic["batch_rows"]
        flat = np.asarray([b * rows + r for b, r in picks], dtype=np.int64)
        lengths = self.pool["lengths"]
        self.picked = {
            "x": host(self.pool["x"][torch.as_tensor(
                flat, device=self.pool["x"].device)]),
            "lengths": None if lengths is None else lengths[flat]}
        mean = np.array([self.latest[b][0][r] for b, r in picks])
        var = np.array([self.latest[b][1][r] for b, r in picks])
        return {"mean": mean, "var": var}

    def release(self):
        self.pool = None
        super().release()

    def reference_outputs(self, precision, device):
        fmap = self.feature_map(device)
        fit, _ = self.reference_fit(fmap, self.train, precision,
                                    with_var=True)
        mean, var = self.reference_predict(
            fmap, fit, self.picked["x"], self.picked["lengths"],
            self.train["y"], precision)
        return {"mean": mean, "var": var}

    @staticmethod
    def numbers(out, ref):
        return {"mean_gap": rel_centred(out["mean"], ref["mean"]),
                "var_gap": rel(out["var"], ref["var"])}
