"""Paired sin/cos evaluators (port of xgpr_tpu/ops/sincos.py).

The same four evaluators with the same coefficients and reductions:

- "exact": torch.cos / torch.sin;
- "hi" (the "auto" default for float32): one Cody-Waite reduction by whole
  periods and deg-13/14 minimax polynomials over [-pi, pi];
- "fast": the same reduction with deg-9/8 polynomials (max err 4.1e-5);
- "poly": the legacy quadrant-folded cephes evaluator.

float64 always uses the builtin.  The reductions are exact only while
|x| < 8192 (``POLY_ARG_LIMIT``).  Where xgpr_tpu guards that with one
whole-array branch, this port guards per element: elements past the limit
take the builtin and the rest keep the polynomial.  Inside the range the
two agree exactly, and the CUDA kernels (ops/cuda/csrc/common.cuh) guard
the same way, so the plain versions here are their exact references.
"""
import math

import torch

from ..config import sincos_mode

# Cody-Waite split of pi/2 (2x the cephes pi/4 DP constants).
_DP1 = 1.5703125
_DP2 = 4.837512969970703125e-4
_DP3 = 7.54978995489188216e-8

# cephes sinf/cosf minimax coefficients, valid on |r| <= pi/4.
_S1 = -1.9515295891e-4
_S2 = 8.3321608736e-3
_S3 = -1.6666654611e-1
_C1 = 2.443315711809948e-5
_C2 = -1.388731625493765e-3
_C3 = 4.166664568298827e-2

# 2-term Cody-Waite split of 2*pi (n*_TP1 exact while |n| < 2^13).
_TP1 = 6.28125
_TP2 = 1.9353071795864769e-3

# "fast": minimax on r in [-pi, pi] (ascending odd/even powers).
_FS = (9.99979391e-01, -1.66624389e-01, 8.30898665e-03,
       -1.92650222e-04, 2.14788592e-06)
_FC = (9.99959802e-01, -4.99793151e-01, 4.14960343e-02,
       -1.33926855e-03, 1.87919992e-05)

# "hi": deg-13 sin / deg-14 cos minimax (Horner order, highest first).
_HS = (1.3451442737455466e-10, -2.4676957366409624e-08,
       2.752945192696643e-06, -0.0001984015543712303,
       0.00833331048488617, -0.166666641831398, 1.0)
_HC = (-9.758583698060708e-12, 2.061550263832146e-09,
       -2.753634191776655e-07, 2.480065268173348e-05,
       -0.0013888865942135453, 0.0416666641831398, -0.5, 1.0)

POLY_ARG_LIMIT = 8192.0


def _c(value, like):
    """A constant rounded to ``like``'s dtype, as a 0-d tensor on its
    device (so float32 arithmetic sees the float32 constant)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _poly_sincos(x):
    """(cos x, sin x) via shared quadrant reduction + short polynomials."""
    n = torch.round(x * _c(2.0 / math.pi, x))
    r = x - n * _c(_DP1, x)
    r = r - n * _c(_DP2, x)
    r = r - n * _c(_DP3, x)
    z = r * r
    sin_r = ((_c(_S1, x) * z + _c(_S2, x)) * z + _c(_S3, x)) * z * r + r
    cos_r = (((_c(_C1, x) * z + _c(_C2, x)) * z + _c(_C3, x)) * z * z
             - _c(0.5, x) * z + _c(1.0, x))
    q = n.to(torch.int32) & 3
    swap = (q & 1).bool()
    sin_v = torch.where(swap, cos_r, sin_r)
    cos_v = torch.where(swap, sin_r, cos_r)
    sin_v = torch.where((q & 2).bool(), -sin_v, sin_v)
    cos_v = torch.where(((q + 1) & 2).bool(), -cos_v, cos_v)
    return cos_v, sin_v


def _full_period(x, sin_coefs, cos_coefs, w=None):
    """Full-period reduction + Horner polynomials, no quadrant logic.
    ``w`` (a broadcastable multiplier) is folded in as xgpr_tpu does:
    cos * w and sin_poly * (r * w)."""
    n = torch.round(x * _c(1.0 / (2.0 * math.pi), x))
    r = x - n * _c(_TP1, x)
    r = r - n * _c(_TP2, x)
    z = r * r
    sp = _c(sin_coefs[0], x)
    for c in sin_coefs[1:]:
        sp = sp * z + _c(c, x)
    cp = _c(cos_coefs[0], x)
    for c in cos_coefs[1:]:
        cp = cp * z + _c(c, x)
    if w is None:
        return cp, sp * r
    return cp * w, sp * (r * w)


def _fast_sincos(x, w=None):
    # _FS/_FC are ascending; Horner wants highest power first.
    return _full_period(x, _FS[::-1], _FC[::-1], w)


def _hi_sincos(x, w=None):
    return _full_period(x, _HS, _HC, w)


def _exact_pair(x, w=None):
    c, s = torch.cos(x), torch.sin(x)
    return (c, s) if w is None else (c * w, s * w)


def _poly_pair(x, w=None):
    c, s = _poly_sincos(x)
    return (c, s) if w is None else (c * w, s * w)


_EVALUATORS = {"exact": _exact_pair, "hi": _hi_sincos, "fast": _fast_sincos,
               "poly": _poly_pair}


def kernel_sincos(dtype=torch.float32, mode=None):
    """The unguarded (cos, sin) evaluator fn(x, w=None) for a mode
    (default: the configured one); float64 always gets the builtin."""
    mode = sincos_mode() if mode is None else mode
    if dtype != torch.float32:
        return _exact_pair
    return _EVALUATORS["hi" if mode == "auto" else mode]


def sincos(x, w=None, mode=None):
    """(cos x, sin x) [* w] with the mode's evaluator (default: the
    configured one), and the builtin for every element with
    |x| > POLY_ARG_LIMIT.  This is what the CUDA kernels compute per
    element."""
    pair = kernel_sincos(x.dtype, mode)
    c, s = pair(x, w)
    if pair is _exact_pair:
        return c, s
    big = x.abs() > POLY_ARG_LIMIT
    ce, se = _exact_pair(x, w)
    return torch.where(big, ce, c), torch.where(big, se, s)
