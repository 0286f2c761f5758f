"""What every kind of operation shares.  A traffic file names its kind
(``"operation"``), and ``gpbench/operations/<operation>.py`` holds that
kind's loop as a class ``Op`` built on ``Operation``.

An operation sets up the program from the seed (data made on the device,
the dataset and model built through the port's public entries), runs one
operation per ``step``, and after the window hands over what the window
produced (``outputs``), what the plain reference makes of the same
inputs (``reference_outputs``) and the numbers that compare them
(``numbers``).  The program is driven only through
``build_regression_dataset``, ``GPRegression``, ``set_hyperparams``,
``build_preconditioner``, ``fit``, ``approximate_nmll``, ``predict`` and
the public knobs of ``xgpr_tpu_torch.config``; its launch counters and
phase times are read, never changed.

An operation fails when it raises, when a fit's CG ends short of its
tolerance (at ``max_iter`` or with frozen columns), or when an NMLL
comes back as the port's penalty score.
"""
import contextlib
import sys
import time
import traceback

import numpy as np
import torch

from ..reference import features as ref_features
from ..reference import solve as ref_solve

# The port's kernels by name, and the reference's feature kind of each.
REFERENCE_KIND = {"RBF": "rbf", "Conv1dRBF": "conv"}


def model_seed(seed):
    """The model's seed (its random features, sketch and probes) for a
    run seed: numpy and scipy take it below 2**32."""
    return int(seed) % (2 ** 31 - 1)


def rel(a, b):
    a = torch.as_tensor(np.asarray(a), dtype=torch.float64).flatten()
    b = torch.as_tensor(np.asarray(b), dtype=torch.float64).flatten()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def rel_centred(a, b):
    a = torch.as_tensor(np.asarray(a), dtype=torch.float64).flatten()
    b = torch.as_tensor(np.asarray(b), dtype=torch.float64).flatten()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b - b.mean()))


def host(t):
    return None if t is None else t.cpu().numpy()


def make(cell, seed, device="cuda"):
    """The operation of the cell's traffic, set from its seed."""
    kind = cell.module("operations", cell.traffic["operation"])
    return kind.Op(cell, seed, device)


class Operation:
    """Shared set-up, spans and reference plumbing of the loops.

    ``round_ops``: the window runs whole rounds of this many operations.
    """

    round_ops = 1

    def __init__(self, cell, seed, device="cuda"):
        self.cell = cell
        self.config = cell.config
        self.model_cfg = cell.config["model"]
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.mseed = model_seed(seed)
        self.device = torch.device(device)
        self.records = []
        self.traced = False
        self.failures = 0
        self.model = self.dataset = None
        self.train_windows = None
        self.progress = lambda what: None

    # -- set-up --------------------------------------------------------
    def make_data(self, pool_rows=0):
        gen = self.cell.module("data", self.config["data"]["generator"])
        return gen.make(self.seed, self.config["data"], self.device,
                        pool_rows)

    def keep_training_rows(self, data):
        """The training rows on the host (x float32, y float64, lengths
        int32 or None) and their valid windows (sequences only)."""
        train = data["train"]
        if train["lengths"] is not None:
            self.train_windows = self.windows_of(train["lengths"])
        self.train = {k: host(v) for k, v in train.items()}

    def build_model(self, train):
        """The port's dataset of the training rows and its model at the
        configuration's point, with the configuration's knobs set."""
        from xgpr_tpu_torch import (GPRegression, build_regression_dataset,
                                    config as port_config)
        m = self.model_cfg
        port_config.set_speed_preset(m["preset"])
        if "stacked_limit" in m:
            port_config.set_stacked_limit(m["stacked_limit"])
        self.dataset = build_regression_dataset(
            train["x"], train["y"], train["lengths"], chunk_size=m["chunk"])
        self.model = GPRegression(
            num_rffs=m["num_rffs"], variance_rffs=m["variance_rffs"],
            kernel_choice=m["kernel"], device=self.device.type,
            kernel_settings=dict(m.get("kernel_settings", {})),
            verbose=False, random_seed=self.mseed)
        self.model.set_hyperparams(np.asarray(m["hyperparams"]),
                                   self.dataset)
        self.progress("dataset and model built")

    def n_chunks(self):
        return -(-self.config["data"]["rows"] // self.model_cfg["chunk"])

    def windows_of(self, lengths):
        """Valid windows of rows with these lengths (a conv kernel)."""
        width = self.model_cfg["kernel_settings"]["conv_width"]
        nw = self.config["data"]["seq_len"] - width + 1
        return int((lengths.long() - width + 1).clamp(0, nw).sum())

    def basis(self, traced):
        """What one pass of the traced operations' data covers, for the
        roofline counts: the training rows, their valid windows (None
        without sequences), and their chunks."""
        return {"rows": self.config["data"]["rows"],
                "windows": self.train_windows, "chunks": self.n_chunks(),
                "chunk_rows": self.model_cfg["chunk"]}

    def span(self, name):
        if self.traced:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def guarded(self, fn, rec):
        """Run one operation; an exception marks it failed, with its
        traceback on stderr (the first of the run in full)."""
        t0 = time.perf_counter()
        try:
            fn(rec)
        except Exception:          # the window goes on; the op failed
            self.failures += 1
            rec["failed"] = True
            if self.failures == 1:
                traceback.print_exc(file=sys.stderr)
            else:
                print(f"operation failed: {sys.exc_info()[1]!r}",
                      file=sys.stderr)
        rec["seconds"] = time.perf_counter() - t0
        self.records.append(rec)

    def fit_once(self, rec, suppress_var):
        """One fit as a user makes it: the configured preconditioner (or
        the fit's own autoselect), then CG to ``tol``."""
        fit = self.config["fit"]
        pre = fit.get("preconditioner")
        precond = None
        if pre is not None:
            self.sync()
            t0 = time.perf_counter()
            with self.span("gpbench/precond"):
                precond, _ = self.model.build_preconditioner(
                    self.dataset, max_rank=pre["rank"], method=pre["method"])
            self.sync()
            rec["precond_s"] = time.perf_counter() - t0
        with self.span("gpbench/fit"):
            n_iter, losses = self.model.fit(
                self.dataset, preconditioner=precond, tol=fit["tol"],
                max_iter=fit["max_iter"], mode="cg",
                suppress_var=suppress_var, run_diagnostics=True)
        times = self.model.fit_phase_times
        if precond is None:
            rec["precond_s"] = times.get("preconditioner")
        rec["cg_s"] = times["cg"]
        rec["cg_iters"] = n_iter
        rec["failed"] = not (len(losses) and losses[-1] < fit["tol"])

    def warmup(self):
        """One operation of the window's kind and shapes, not counted."""
        self.step(0)
        self.records.clear()
        self.failures = 0

    def release(self):
        """Free the program's state before the reference runs."""
        self.model = self.dataset = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- reference -----------------------------------------------------
    def feature_map(self, device):
        m = self.model_cfg
        kind = REFERENCE_KIND[m["kernel"]]
        d = self.config["data"]
        width = m.get("kernel_settings", {}).get("conv_width", 1)
        input_dim = d["dim"] if kind == "conv" else d["features"]
        return ref_features.FeatureMap(kind, input_dim, m["num_rffs"],
                                       self.mseed, width, True, device)

    def sigma_lambda(self, point=None):
        hp = np.exp(np.asarray(self.model_cfg["hyperparams"]
                               if point is None else point, dtype=float))
        return float(hp[1]), float(hp[0])

    @staticmethod
    def y_stats(y):
        return float(y.mean()), float(y.std())

    def reference_fit(self, fmap, train, precision, point=None,
                      with_var=False):
        """The reference's exact fit of the training rows."""
        sigma, lam = self.sigma_lambda(point)
        y_mean, y_std = self.y_stats(train["y"])
        x = torch.as_tensor(train["x"])
        lengths = None if train["lengths"] is None else \
            torch.as_tensor(train["lengths"])
        y = torch.as_tensor((train["y"] - y_mean) / y_std)
        g, zty, yty = ref_solve.gram(fmap, x, y, sigma, lengths, precision)
        var_cols = fmap.variance_columns(self.model_cfg["variance_rffs"]) \
            if with_var else None
        return ref_solve.Fit(g, zty, lam, var_cols), (g, zty, yty)

    def reference_predict(self, fmap, fit, x, lengths, train_y, precision):
        """(mean, variance) of rows x by the reference fit, in blocks."""
        sigma, _ = self.sigma_lambda()
        y_mean, y_std = self.y_stats(train_y)
        means, variances = [], []
        for lo in range(0, x.shape[0], ref_solve.BLOCK_ROWS):
            hi = lo + ref_solve.BLOCK_ROWS
            xb = torch.as_tensor(x[lo:hi]).to(fmap.device)
            lb = None if lengths is None else \
                torch.as_tensor(lengths[lo:hi]).to(fmap.device)
            mean, var = fit.predict(fmap.features(xb, sigma, lb, precision),
                                    y_mean, y_std)
            means.append(mean.cpu())
            variances.append(None if var is None else var.cpu())
        mean = torch.cat(means).numpy()
        if variances[0] is None:
            return mean, None
        return mean, torch.cat(variances).numpy()

    def limits(self):
        return self.cell.limits()
