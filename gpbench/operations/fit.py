"""A user's fit, back to back: the configured preconditioner (or the
fit's own autoselect), then CG to ``tol``, with or without the variance.
Compared: the last fit's weights and its predictions on the held-out
rows."""
from gpbench.harness.operation import Operation, host, rel, rel_centred


class Op(Operation):

    def setup(self, data=None):
        data = data or self.make_data()
        self.progress("data made")
        self.keep_training_rows(data)
        self.test = {k: host(v) for k, v in data["test"].items()}
        del data
        self.progress("data on the host")
        self.build_model(self.train)

    def step(self, i):
        self.guarded(lambda rec: self.fit_once(
            rec, self.config["fit"]["suppress_var"]), {"kind": "fit"})

    def outputs(self):
        """The last fit's weights and its predictions on the held-out
        rows (mean, and variance when the fit keeps it)."""
        with_var = not self.config["fit"]["suppress_var"]
        out = {"weights": self.model.weights.double().cpu().numpy()}
        pred = self.model.predict(self.test["x"], self.test["lengths"],
                                  get_var=with_var,
                                  chunk_size=self.model_cfg["chunk"])
        out["mean"], out["var"] = pred if with_var else (pred, None)
        return out

    def reference_outputs(self, precision, device):
        fmap = self.feature_map(device)
        with_var = not self.config["fit"]["suppress_var"]
        fit, _ = self.reference_fit(fmap, self.train, precision,
                                    with_var=with_var)
        mean, var = self.reference_predict(
            fmap, fit, self.test["x"], self.test["lengths"], self.train["y"],
            precision)
        return {"weights": fit.weights.cpu().numpy(), "mean": mean,
                "var": var}

    @staticmethod
    def numbers(out, ref):
        nums = {"weight_gap": rel(out["weights"], ref["weights"]),
                "mean_gap": rel_centred(out["mean"], ref["mean"])}
        if ref["var"] is not None:
            nums["var_gap"] = rel(out["var"], ref["var"])
        return nums
