"""Structured orthogonal random feature (SORF) ops (port of xgpr_tpu/ops/sorf.py).

- SORF transform: three rounds of (Rademacher diagonal * 1/sqrt(P)) then an
  unnormalised FWHT, once per block of P frequencies.
- RBF features: cos/sin(h * chi) * s with s = sqrt(1 / (F - 0.5)) when an
  intercept is fitted, sqrt(1 / F) otherwise, in the block [cos | sin]
  layout of ops/layout.py.
- The dense projection materialises SORF * chi as one (D, F) matrix, so
  the feature map is x @ proj; on the card that product and the sincos run
  inside the feature-map kernel (ops/cuda/feature_map.py), at full
  precision in every preset, as xgpr_tpu's Pallas feature map pins
  HIGHEST.  The XLA-path twins ``rbf_feature_map_dense`` and
  ``rbf_feature_parts_dense`` project through ``feature_projection``,
  which follows the feature precision as xgpr_tpu's XLA path does.

These are the plain tensor versions.  The ``_grad`` variants (features
and d features / d sigma, for the exact NMLL gradient) stay plain torch on
every device: xgpr_tpu computes them outside its Pallas kernels too.
"""
import math

import torch

from .. import config
from .contract import bf16_mm
from .hadamard import fwht
from .layout import assemble_cos_sin
from .sincos import sincos


def sorf_blocks(x_padded, radem):
    """(N, P) padded rows, (3, B, P) diagonals -> (N, B, P) projections."""
    p = x_padded.shape[-1]
    norm = torch.tensor(1.0 / math.sqrt(p), dtype=x_padded.dtype,
                        device=x_padded.device)
    y = x_padded[:, None, :] * (radem[0] * norm)
    y = fwht(y)
    y = y * (radem[1] * norm)
    y = fwht(y)
    y = y * (radem[2] * norm)
    return fwht(y)


def pad_rows(x, padded_dim: int):
    """Zero-pad the last axis of (N, d) rows out to padded_dim."""
    d = x.shape[-1]
    if d == padded_dim:
        return x
    return torch.nn.functional.pad(x, (0, padded_dim - d))


def sorf_project(x, radem, num_freqs: int):
    """SORF-project (N, d) rows to (N, num_freqs), before chi scaling."""
    p = radem.shape[-1]
    h = sorf_blocks(pad_rows(x, p), radem)
    return h.reshape(x.shape[0], -1)[:, :num_freqs]


def cos_sin_features(arg, scale, padded: int):
    """[cos | sin] block-layout features * scale."""
    s = torch.tensor(scale, dtype=arg.dtype, device=arg.device)
    cosv, sinv = sincos(arg)
    return assemble_cos_sin(cosv * s, sinv * s, padded)


def rbf_norm_constant(num_freqs: int, fit_intercept: bool) -> float:
    """sqrt(1/(F - 0.5)) with an intercept, else sqrt(1/F)."""
    denom = num_freqs - 0.5 if fit_intercept else float(num_freqs)
    return math.sqrt(1.0 / denom)


def rbf_feature_map(x, radem, chi, fit_intercept: bool):
    """Structured RBF feature map of sigma-scaled rows -> (N, 2F).  Column
    0 becomes 1 in the kernel layer when an intercept is fitted."""
    num_freqs = chi.shape[0]
    arg = sorf_project(x, radem, num_freqs) * chi
    return cos_sin_features(arg, rbf_norm_constant(num_freqs, fit_intercept),
                            radem.shape[-1])


def _features_and_grad(g, sigma, fit_intercept, padded):
    """Features cos/sin(g * sigma) * s and their sigma-derivatives
    (-sin * g, cos * g) * s, both in the block layout; g is the projection
    of the unscaled rows."""
    num_freqs = g.shape[1]
    scale = torch.tensor(rbf_norm_constant(num_freqs, fit_intercept),
                         dtype=g.dtype, device=g.device)
    cosv, sinv = sincos(g * sigma)
    cosv = cosv * scale
    sinv = sinv * scale
    feats = assemble_cos_sin(cosv, sinv, padded)
    grad = assemble_cos_sin(-sinv * g, cosv * g, padded)
    return feats, grad[:, :, None]


def rbf_feature_map_grad(x, radem, chi, sigma, fit_intercept: bool):
    """RBF features of the unscaled rows x and d(features)/d(sigma):
    (N, 2F) and (N, 2F, 1)."""
    g = sorf_project(x, radem, chi.shape[0]) * chi
    return _features_and_grad(g, sigma, fit_intercept, radem.shape[-1])


def rbf_feature_map_dense_grad(x, proj, sigma, fit_intercept: bool,
                               padded: int):
    """Dense-projection analogue of rbf_feature_map_grad."""
    return _features_and_grad(torch.matmul(x, proj), sigma, fit_intercept,
                              padded)


def dense_sorf_projection(radem, chi, input_dim: int):
    """SORF * chi as a dense (input_dim, F) matrix: SORF(x) * chi == x @ W."""
    from .ard import precompute_sorf_weights
    return precompute_sorf_weights(radem, chi, input_dim).T


def dense_threshold_ok(input_dim: int, num_freqs: int,
                       max_elements: int = 32 * 1024 * 1024) -> bool:
    """Use the dense projection when the matrix stays modest."""
    return input_dim * num_freqs <= max_elements


def feature_projection(x, proj):
    """x @ proj at the configured feature precision (port of xgpr_tpu's
    ``_feature_projection``): under "default" both operands are rounded to
    bfloat16 and the products sum in float32."""
    if config.feature_matmul_precision(x.device, x.dtype) == "default":
        return bf16_mm(x, proj)
    return torch.matmul(x, proj)


def rbf_feature_map_dense(x, proj, fit_intercept: bool, padded: int):
    """RBF features via the dense projection of sigma-scaled rows."""
    num_freqs = proj.shape[1]
    return cos_sin_features(feature_projection(x, proj),
                            rbf_norm_constant(num_freqs, fit_intercept),
                            padded)


def rbf_feature_parts_dense(x_scaled, proj, fit_intercept: bool):
    """(cos, sin) feature parts without the block-layout assembly; column
    0 of cos is 1 when an intercept is fitted."""
    num_freqs = proj.shape[1]
    scale = torch.tensor(rbf_norm_constant(num_freqs, fit_intercept),
                         dtype=x_scaled.dtype, device=x_scaled.device)
    cosv, sinv = sincos(feature_projection(x_scaled, proj))
    cosv = cosv * scale
    sinv = sinv * scale
    if fit_intercept:
        cosv[:, 0] = 1.0
    return cosv, sinv


def srht_rows(x, radem_vec, sample_idx):
    """Subsampled randomised Hadamard transform of each row:
    FWHT(diag(radem) * x / sqrt(P)) restricted to the sampled columns."""
    p = radem_vec.shape[0]
    norm = torch.tensor(1.0 / math.sqrt(p), dtype=x.dtype,
                        device=x.device)
    y = fwht(pad_rows(x, p) * (radem_vec * norm))
    return y[:, sample_idx]
