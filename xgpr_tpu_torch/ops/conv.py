"""Convolution (k-mer) SORF feature ops for sequence and graph kernels
(port of xgpr_tpu/ops/conv.py).

For each row i with sequence length L_i, every k-mer window j in
[0, L_i - w] of the (L, D) input is flattened to a (w*D,) vector,
SORF-projected, and its cos/sin features are summed into the row's output
with a per-row scale: sqrt(1/F) times none / 1/sqrt(n_kmers) / 1/n_kmers.
The maxpool variant takes the elementwise max of the projections over the
valid windows against a zero start (an implicit ReLU) and has no cos/sin.

Two routes, as in xgpr_tpu:

- the dense projection (``proj`` given, w*D*F within the dense threshold):
  the window loop is the K3 kernel (``ops/cuda/conv.conv_parts``) and the
  maxpool the K4 kernel (``conv_maxpool``); on a CPU tensor each runs its
  plain version.  K3 applies the row scale in its epilogue;
- the structured FWHT route (``proj`` None) in plain torch, over blocks of
  windows so memory stays O(N * block * P).

``with_grad`` (features and d features / d sigma, for the exact NMLL
gradient) is plain torch on both routes, over blocks of windows, as
xgpr_tpu computes it outside its Pallas kernels; its dense projection
follows the feature precision (``feature_projection``: bfloat16 operands
under "default"), as xgpr_tpu's ``_conv_project`` does.
"""
import torch

from .cuda.conv import conv_maxpool, conv_parts, window_mask, window_slab
from .layout import assemble_cos_sin
from .sincos import sincos
from .sorf import feature_projection, rbf_norm_constant, sorf_project

SCALING_NONE = 0
SCALING_SQRT = 1
SCALING_FULL = 2


def conv_row_scale(seq_lengths, width, num_freqs, scaling_type, dtype,
                   device):
    """(N,) per-row scale: rbf_norm_constant(F) times the averaging factor
    of each row's k-mer count."""
    base = rbf_norm_constant(num_freqs, fit_intercept=False)
    nk = (seq_lengths.to(device) - width + 1).to(dtype)
    if scaling_type == SCALING_SQRT:
        return base / torch.sqrt(nk)
    if scaling_type == SCALING_FULL:
        return base / nk
    return torch.full(nk.shape, base, dtype=dtype, device=device)


def _sorf_window_blocks(x, radem, chi, width, block_size, proj=None):
    """Yield (start, g): g (N, blk, F) the projections of windows
    [start, start + blk): SORF times chi, or the dense proj (chi folded
    in) when given."""
    n = x.shape[0]
    wins = window_slab(x, width)
    for start in range(0, wins.shape[1], block_size):
        blk = wins[:, start:start + block_size]
        if proj is not None:
            yield start, feature_projection(blk, proj)
            continue
        g = sorf_project(blk.reshape(-1, blk.shape[-1]), radem,
                         chi.shape[0]) * chi
        yield start, g.reshape(n, blk.shape[1], -1)


def _check_width(x, width):
    if x.shape[1] - width + 1 < 1:
        raise ValueError("Sequence axis shorter than conv_width.")


def conv_rbf_features(x, seq_lengths, radem, chi, sigma, width,
                      scaling_type=SCALING_NONE, block_size=32, proj=None,
                      parts=False, with_grad=False):
    """Accumulated cos/sin conv-SORF features.

    Args:
        x: (N, L, D) zero-padded sequences (NOT pre-scaled by sigma).
        seq_lengths: (N,) int sequence lengths (>= width).
        radem: (3, B, P) Rademacher diagonals, P = next_pow2(width * D).
        chi: (F,) chi-distributed scaling.
        sigma: lengthscale hyperparameter.
        width: convolution width w.
        scaling_type: 0 none / 1 sqrt / 2 full averaging.
        block_size: windows per step of the structured route.
        proj: (w*D, F) dense projection, chi folded in; None takes the
            structured route.
        parts: return the scaled (cos, sin) parts, each (N, F) in
            frequency order, without the block-layout assembly.
        with_grad: also return d features / d sigma, (N, 2F, 1), in the
            block layout (incompatible with parts).

    Returns:
        (N, 2F) features in the block [cos | sin] layout, or (cos, sin),
        or (features, dz_dsigma).
    """
    _check_width(x, width)
    num_freqs = chi.shape[0]
    row_scale = conv_row_scale(seq_lengths, width, num_freqs, scaling_type,
                               x.dtype, x.device)
    if with_grad:
        if parts:
            raise ValueError("parts and with_grad are mutually exclusive")
        return _conv_rbf_grad(x, seq_lengths, radem, chi, sigma, width,
                              row_scale, block_size, proj)
    if proj is not None:
        c, s = conv_parts(x, seq_lengths, proj, sigma, width, row_scale)
    else:
        c = torch.zeros((x.shape[0], num_freqs), dtype=x.dtype,
                        device=x.device)
        s = torch.zeros_like(c)
        mask = window_mask(seq_lengths.to(x.device), width,
                           x.shape[1] - width + 1).to(x.dtype)
        for start, g in _sorf_window_blocks(x, radem, chi, width,
                                            block_size):
            m = mask[:, start:start + g.shape[1], None]
            cb, sb = sincos(g * sigma, m)
            c += cb.sum(dim=1)
            s += sb.sum(dim=1)
        c = c * row_scale[:, None]
        s = s * row_scale[:, None]
    if parts:
        return c, s
    return assemble_cos_sin(c, s, radem.shape[-1])


def _conv_rbf_grad(x, seq_lengths, radem, chi, sigma, width, row_scale,
                   block_size, proj):
    """Conv features and their sigma-derivatives: per valid window the
    projection g contributes cos/sin(g sigma) and (-sin, cos)(g sigma) * g."""
    acc = [torch.zeros((x.shape[0], chi.shape[0]), dtype=x.dtype,
                       device=x.device) for _ in range(4)]
    mask = window_mask(seq_lengths.to(x.device), width,
                       x.shape[1] - width + 1).to(x.dtype)
    for start, g in _sorf_window_blocks(x, radem, chi, width, block_size,
                                        proj):
        m = mask[:, start:start + g.shape[1], None]
        cb, sb = sincos(g * sigma)
        acc[0] += (cb * m).sum(dim=1)
        acc[1] += (sb * m).sum(dim=1)
        acc[2] += (-sb * g * m).sum(dim=1)
        acc[3] += (cb * g * m).sum(dim=1)
    c, s, dc, ds = (a * row_scale[:, None] for a in acc)
    padded = radem.shape[-1]
    return (assemble_cos_sin(c, s, padded),
            assemble_cos_sin(dc, ds, padded)[:, :, None])


def conv_maxpool_features(x, seq_lengths, radem, chi, width, block_size=32,
                          proj=None):
    """ReLU + global-maxpool conv SORF features, (N, F): the elementwise
    max of h * chi over valid windows against a zero start, no cos/sin."""
    _check_width(x, width)
    if proj is not None:
        return conv_maxpool(x, seq_lengths, proj, width)
    acc = torch.zeros((x.shape[0], chi.shape[0]), dtype=x.dtype,
                      device=x.device)
    mask = window_mask(seq_lengths.to(x.device), width,
                       x.shape[1] - width + 1)
    for start, g in _sorf_window_blocks(x, radem, chi, width, block_size):
        m = mask[:, start:start + g.shape[1], None]
        g = torch.where(m, g, float("-inf"))
        acc = torch.maximum(acc, g.amax(dim=1))
    return acc
