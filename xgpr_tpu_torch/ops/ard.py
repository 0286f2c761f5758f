"""Dense SORF weights and the MiniARD gradient op (port of
xgpr_tpu/ops/ard.py).

``precompute_sorf_weights`` builds the dense (F, D) matrix W with
x @ W.T == SORF(x) * chi.  ``mini_ard_grad`` gives MiniARD's features and
their derivatives by each group's lengthscale: per group g the partial
projection dot_g = x[:, group g] @ W[:, group g].T, the argument
sum_g sigma_g * dot_g, and

    feats      = s * [cos(arg) | sin(arg)]              (block layout)
    grad[.., g] = s * [-sin(arg) * dot_g | cos(arg) * dot_g]

xgpr_tpu computes this in XLA, outside any Pallas kernel, so it is plain
torch on every device here; the engine forms the gradient's chunk
products from it in float64 (fitting/engine.py).
"""
import math

import torch

from .hadamard import fwht, next_pow2
from .layout import assemble_cos_sin
from .sincos import sincos
from .sorf import rbf_norm_constant


def precompute_sorf_weights(radem, chi, input_dim: int):
    """Dense (num_freqs, input_dim) matrix W with x @ W.T == SORF(x) * chi,
    built by SORF-transforming the identity one block at a time."""
    p = radem.shape[-1]
    nblocks = radem.shape[1]
    num_freqs = chi.shape[0]
    eye = torch.eye(p, dtype=chi.dtype, device=chi.device)
    norm = torch.tensor(1.0 / math.sqrt(p), dtype=chi.dtype,
                        device=chi.device)
    blocks = []
    for b in range(nblocks):
        m = eye * (radem[0, b] * norm)
        m = fwht(m)
        m = m * (radem[1, b] * norm)
        m = fwht(m)
        m = m * (radem[2, b] * norm)
        m = fwht(m)
        blocks.append(m.T[:, :input_dim])
    w = torch.cat(blocks, dim=0)[:num_freqs, :]
    return w * chi[:, None]


def mini_ard_grad(x, weights, group_starts, group_ends, sigma_vals,
                  fit_intercept: bool):
    """MiniARD features (N, 2F) and their per-lengthscale gradient
    (N, 2F, G) of raw (not pre-scaled) rows x (N, D), for dense weights
    (F, D) with chi folded in, the groups [start, end) of each lengthscale
    and the lengthscales ``sigma_vals`` (G,)."""
    num_freqs = weights.shape[0]
    dots = torch.stack([x[:, s:e] @ weights[:, s:e].T
                        for s, e in zip(group_starts, group_ends)], dim=-1)
    rf_sum = torch.einsum("nfg,g->nf", dots, sigma_vals.to(x.dtype))
    scale = torch.tensor(rbf_norm_constant(num_freqs, fit_intercept),
                         dtype=x.dtype, device=x.device)
    cosv, sinv = sincos(rf_sum)
    cosv = cosv * scale
    sinv = sinv * scale
    padded = next_pow2(weights.shape[1])
    feats = assemble_cos_sin(cosv, sinv, padded)
    grad = torch.stack([assemble_cos_sin(-sinv * dots[:, :, g],
                                         cosv * dots[:, :, g], padded)
                        for g in range(dots.shape[2])], dim=-1)
    return feats, grad
