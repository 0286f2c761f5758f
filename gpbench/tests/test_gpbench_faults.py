"""The check against a broken timed path: a tiny run of each cell on the
CPU, the device check skipped, with the port broken underneath, comes
out not correct, once for each fault the cell can have:

- half of the data left out (the engine's reductions skip every other
  chunk: the sketch, the matvec, the NMLL's terms);
- a step that returns its state unchanged (CG hands back its start);
- an answer altered where it is produced (the fit's weights, an NMLL, a
  prediction's mean or variance, off by a small relative amount);
- half of a predicted batch left out (its second half a copy of the
  first).

No cell here runs across chips, so no exchange between chips can be
left out."""
import numpy as np
import pytest
import torch

from gpbench.harness import cell
from xgpr_tpu_torch.fitting import cg as cg_module
from xgpr_tpu_torch.fitting import engine as engine_module
from xgpr_tpu_torch.fitting import fused_cg
from xgpr_tpu_torch.models import regression


def half_the_data(monkeypatch):
    batches = engine_module.Engine._batches

    def every_other(self, with_y=True):
        for i, b in enumerate(batches(self, with_y)):
            if i % 2 == 0:
                yield b
    monkeypatch.setattr(engine_module.Engine, "_batches", every_other)


def state_unchanged(monkeypatch):
    def start(matvec, precond, rhs, lam, max_iter, tol, col_sum=None):
        k = rhs.shape[1]
        zeros = torch.zeros((1, k), dtype=rhs.dtype, device=rhs.device)
        return (torch.zeros_like(rhs), True, 1, zeros, zeros,
                torch.zeros((1,), dtype=rhs.dtype, device=rhs.device))
    monkeypatch.setattr(fused_cg, "_cg_while", start)
    monkeypatch.setattr(cg_module, "_cg_while", start)


def weights_altered(monkeypatch):
    fit = regression.cg_fit

    def altered(*args, **kwargs):
        weights, n_iter, losses = fit(*args, **kwargs)
        return weights * (1 + 1e-3), n_iter, losses
    monkeypatch.setattr(regression, "cg_fit", altered)


def nmll_altered(monkeypatch):
    slq = regression.slq_nmll_from_engine

    def altered(*args, **kwargs):
        value = slq(*args, **kwargs)
        return value + 1e-5 * abs(value)
    monkeypatch.setattr(regression, "slq_nmll_from_engine", altered)


def _predict_broken(monkeypatch, change):
    predict = regression.GPRegression.predict

    def broken(self, *args, **kwargs):
        return change(*predict(self, *args, **kwargs))
    monkeypatch.setattr(regression.GPRegression, "predict", broken)


def mean_altered(monkeypatch):
    _predict_broken(monkeypatch, lambda m, v: (m * (1 + 1e-3), v))


def variance_altered(monkeypatch):
    _predict_broken(monkeypatch, lambda m, v: (m, v * (1 + 1e-3)))


def half_the_batch(monkeypatch):
    def copy_half(m, v):
        h = len(m) // 2
        return (np.concatenate([m[:h], m[:len(m) - h]]),
                np.concatenate([v[:h], v[:len(v) - h]]))
    _predict_broken(monkeypatch, copy_half)


FAULTS = [("motif_1m.fit", half_the_data), ("motif_1m.fit", state_unchanged),
          ("motif_1m.fit", weights_altered),
          ("song.fit", half_the_data), ("song.fit", state_unchanged),
          ("song.fit", weights_altered),
          ("song.nmll", half_the_data), ("song.nmll", nmll_altered),
          ("motif_1m.predict", mean_altered),
          ("motif_1m.predict", variance_altered),
          ("motif_1m.predict", half_the_batch)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, tiny_root,
                                            monkeypatch):
    # The predict cell fits in set-up; its faults act on predict alone.
    fault(monkeypatch)
    res = cell.run(name, 2 ** 31 + 99, 0.2, False, device="cpu",
                   root=tiny_root)
    assert not res["correct"], res["checks"]
