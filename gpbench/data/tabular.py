"""A regression set at a tabular benchmark's shape, made on the device
from a seed.

A torch rewrite of ``chip_smoke.py::tabular_data`` (the JAX suite's
``tests/utils/synthetic.py::tabular_data``): standard-normal features and
a smooth nonlinear target of three random directions plus Gaussian noise.
The draws come from a ``torch.Generator`` on ``device``; they differ from
the numpy original's, the distribution is the same.
"""
import math

import torch

from gpbench.data.motif import generator


def regression_set(seed, rows, features, noise=0.1, device="cuda"):
    """(x (rows, features) float32, y (rows,) float64) on ``device``:
    y = sin(2 x w1) + (x w2) cos(x w3) + tanh((x w1)(x w2)) / 2 + noise,
    the directions w drawn N(0, 1 / features) and the products float64."""
    gen = generator(seed, device)
    x = torch.randn((rows, features), generator=gen, device=device)
    w = torch.randn((features, 3), generator=gen, device=device,
                    dtype=torch.float64) / math.sqrt(features)
    p = x.double() @ w
    y = (torch.sin(2.0 * p[:, 0]) + p[:, 1] * torch.cos(p[:, 2])
         + 0.5 * torch.tanh(p[:, 0] * p[:, 1]))
    y += noise * torch.randn((rows,), generator=gen, device=device,
                             dtype=torch.float64)
    return x, y


# Added to the seed for the pool of new rows (see motif.POOL_STREAM).
POOL_STREAM = 0x5EED_9002


def make(seed, spec, device, pool_rows=0):
    """"train" and "test" (dicts of x, y, lengths None) from one draw, and
    "pool" (x, lengths None) when ``pool_rows``."""
    rows = spec["rows"]
    x, y = regression_set(seed, rows + spec["test_rows"], spec["features"],
                          spec["noise"], device)
    out = {"train": {"x": x[:rows], "y": y[:rows], "lengths": None},
           "test": {"x": x[rows:], "y": y[rows:], "lengths": None}}
    if pool_rows:
        px, _ = regression_set(int(seed) + POOL_STREAM, pool_rows,
                               spec["features"], spec["noise"], device)
        out["pool"] = {"x": px, "lengths": None}
    return out
