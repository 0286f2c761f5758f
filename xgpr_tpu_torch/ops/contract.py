"""Matmul / matvec contraction helpers (port of xgpr_tpu/ops/contract.py).

The precision knobs of config.py apply as in xgpr_tpu:

- ``mm`` (the solve path) at ``config.matmul_precision()``: "highest" and
  "high" are a full-precision torch.matmul (on the card full fp32:
  config.py switches TF32 off), "default" rounds float32 operands to
  bfloat16 and sums in float32, as the TPU's DEFAULT dot does.  float64
  operands, which hold the solver state (CG, the Nystrom algebra, the
  chunk sums) and a float64 kernel's features, ignore the knobs here,
  bf16 materialisation included.
- ``fmm`` (the feature path) the same at ``config.feature_precision()``.
- With bf16 feature materialisation (``config.feature_dtype()``: on under
  ``set_fast_features(True)`` and the "max" speed preset),
  ``ztzv_contract`` and ``parts_contract`` round the features, the
  direction and Z v to bfloat16 before each product and return float32.

A product of bfloat16 operands (``bf16_mm``) never rounds its output to
bfloat16: for float32 on the card it is ``torch.mm(..., out_dtype=
torch.float32)``; otherwise the rounded operands are multiplied in their
own dtype (products of bfloat16 values are exact in float32).
"""
import torch

from .. import config


def as_bf16(a):
    """a rounded to bfloat16 (to nearest even) and back to its dtype: the
    values a bfloat16 product reads."""
    return a.to(torch.bfloat16).to(a.dtype)


def bf16_mm(a, b):
    """a @ b on operands rounded to bfloat16, summed in float32 for float32
    operands on the card and in a's dtype otherwise (a float64 witness
    sums in float64); a may carry leading batch axes."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a2.device.type == "cuda" and a2.dtype == torch.float32:
        out = torch.mm(a2.to(torch.bfloat16), b.to(torch.bfloat16),
                       out_dtype=torch.float32)
    else:
        out = torch.matmul(as_bf16(a2), as_bf16(b.to(a2.dtype)))
    return out.reshape(*lead, b.shape[-1])


def _at(precision, a, b):
    if precision == "default" and a.dtype == torch.float32:
        return bf16_mm(a, b)
    return torch.matmul(a, b)


def mm(a, b):
    """Solve-path matmul at config.matmul_precision()."""
    return _at(config.matmul_precision(), a, b)


def fmm(a, b):
    """Feature-path matmul at config.feature_precision()."""
    return _at(config.feature_precision(a.device, a.dtype), a, b)


def ztzv_contract(z, v):
    """Z^T (Z v); with bf16 feature materialisation Z, v and Z v are
    rounded to bfloat16 and the result is float32."""
    if config.feature_dtype(z.device, z.dtype) is not None:
        return bf16_mm(z.T, bf16_mm(z, v))
    return mm(z.T, mm(z, v))


def parts_contract_bf16(c, s, v_c, v_s):
    """parts_contract with every operand rounded to bfloat16: zv = c v_c +
    s v_s summed in float32, then (c^T zv, s^T zv) from zv rounded."""
    zv = bf16_mm(c, v_c) + bf16_mm(s, v_s)
    return bf16_mm(c.T, zv), bf16_mm(s.T, zv)


def parts_contract(c, s, v_c, v_s):
    """Z^T (Z v) from (cos, sin) feature parts: zv = c v_c + s v_s, then
    (c^T zv, s^T zv); in bfloat16 under bf16 feature materialisation."""
    if config.feature_dtype(c.device, c.dtype) is not None:
        return parts_contract_bf16(c, s, v_c, v_s)
    zv = fmm(c, v_c) + fmm(s, v_s)
    return fmm(c.T, zv), fmm(s.T, zv)
