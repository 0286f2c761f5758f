"""Matmul / matvec contraction helpers (port of xgpr_tpu/ops/contract.py).

Every contraction is a plain torch.matmul in the working dtype.  On the
card that is full fp32: config.py switches TF32 off, which is what the
JAX package's HIGHEST precision pin guarantees on the TPU.  xgpr_tpu's
bf16 feature-materialisation option is not ported.
"""
import torch


def mm(a, b):
    """Solve-path matmul (full precision of the working dtype)."""
    return torch.matmul(a, b)


def ztzv_contract(z, v):
    """Z^T (Z v)."""
    return mm(z.T, mm(z, v))


def parts_contract(c, s, v_c, v_s):
    """Z^T (Z v) from (cos, sin) feature parts: zv = c v_c + s v_s, then
    (c^T zv, s^T zv)."""
    zv = mm(c, v_c) + mm(s, v_s)
    return mm(c.T, zv), mm(s.T, zv)
