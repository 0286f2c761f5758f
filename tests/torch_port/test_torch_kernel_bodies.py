"""The choice of a kernel's body and the preparation of its operands
(ops/cuda/feature_map.py ``kernel_body``, ``operand_dtype``,
``launch_tags``; ops/cuda/operands.py), plain torch on the CPU.

- Every (kernel, dtype, precision): float64 operands run the float64
  body whatever the precision; float32 ones 3xTF32 ("high"), bf16
  ("default"), and at "highest" fp32 FMAs for K2, K3 and K4 but 3xTF32
  for K1; K2's float32 body is 3xTF32 under "default" too (xgpr_tpu's
  Pallas feature map pins HIGHEST), fp32 FMAs under "highest".
- Mixed or other dtypes raise; a float64 launch counts as ("exact",
  "float64").
- Each body's planes and depth padding; the transposed projection is
  cached per body.
"""
import pytest
import torch

from xgpr_tpu_torch.ops.cuda import feature_map, operands
from xgpr_tpu_torch.ops.cuda.feature_map import (BODY_FLAGS, kernel_body,
                                                 launch_tags, operand_dtype)

F32, F64 = torch.float32, torch.float64
EXPECTED = {
    # (kernel, precision): float32 body
    ("K1", "high"): "tf32x3", ("K1", "highest"): "tf32x3",
    ("K1", "default"): "bf16",
    ("K2", "high"): "tf32x3", ("K2", "highest"): "fma32",
    ("K2", "default"): "tf32x3",
    ("K3", "high"): "tf32x3", ("K3", "highest"): "fma32",
    ("K3", "default"): "bf16",
    ("K4", "high"): "tf32x3", ("K4", "highest"): "fma32",
    ("K4", "default"): "bf16",
}


@pytest.mark.parametrize("kernel,precision", sorted(EXPECTED))
@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_body(kernel, precision, dtype):
    want = "f64" if dtype == F64 else EXPECTED[(kernel, precision)]
    assert kernel_body(kernel, dtype, precision) == want
    assert want in BODY_FLAGS


def test_body_flags_are_the_formats():
    """csrc/gemm_common.cuh: Format."""
    assert BODY_FLAGS == {"tf32x3": 0, "fma32": 1, "bf16": 2, "f64": 3}


@pytest.mark.parametrize("bad", [("K5", F32, "high"), ("K1", F32, "bf16"),
                                 ("K3", F64, "auto")])
def test_unknown_kernels_and_precisions_raise(bad):
    with pytest.raises(ValueError):
        kernel_body(*bad)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError):
        kernel_body("K1", dtype, "high")
    with pytest.raises(TypeError):
        operand_dtype("K1", torch.zeros(2, dtype=dtype))


@pytest.mark.parametrize("dtypes", [(F32, F64), (F64, F32, F64),
                                    (F32, F32, torch.float16)])
def test_mixed_dtypes_raise(dtypes):
    tensors = [torch.zeros(3, dtype=d) for d in dtypes]
    with pytest.raises(TypeError, match="mix"):
        operand_dtype("K3", *tensors)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_one_dtype_is_taken(dtype):
    assert operand_dtype("K2", *(torch.zeros(4, dtype=dtype)
                                 for _ in range(3))) == dtype


@pytest.mark.parametrize("mode", ["hi", "fast", "poly", "exact"])
@pytest.mark.parametrize("precision", ["high", "highest", "default"])
def test_launch_tags(mode, precision):
    assert launch_tags(F32, mode, precision) == (mode, precision)
    assert launch_tags(F64, mode, precision) == ("exact", "float64")


@pytest.mark.parametrize("body,multiple", [("tf32x3", 4), ("fma32", 4),
                                           ("bf16", 8), ("f64", 2)])
def test_planes_and_depth(body, multiple):
    """16-byte rows of each body's values; one plane but for 3xTF32."""
    assert operands.depth_multiple(body) == multiple
    dtype = F64 if body == "f64" else F32
    a = operands.pad_depth(torch.randn(5, 7, dtype=dtype), multiple)
    assert a.shape[1] % multiple == 0 and a.shape[1] - 7 < multiple
    hi, lo = operands.kernel_planes(a, body)
    if body == "tf32x3":
        assert torch.equal(hi + lo, a)
    elif body == "bf16":
        assert lo is None and hi.dtype == torch.bfloat16
    else:
        assert lo is None and torch.equal(hi, a) and hi.is_contiguous()


def test_projT_planes_are_cached_per_body():
    proj = torch.randn(10, 6)
    proj64 = proj.double()
    tf32 = operands.projT_planes(proj, "tf32x3")
    assert operands.projT_planes(proj, "tf32x3")[0] is tf32[0]
    fma = operands.projT_planes(proj, "fma32")
    assert fma[1] is None and torch.equal(fma[0][:, :10], proj.t())
    assert operands.projT_planes(proj, "fma32")[0] is fma[0]
    f64 = operands.projT_planes(proj64, "f64")
    assert f64[0].shape == (6, 10) and f64[0].dtype == F64
    assert torch.equal(f64[0], proj64.t())


def test_the_precision_resolves_by_the_operands_dtype():
    """With no precision named, float64 operands run at "highest" on any
    device (xgpr_tpu's float64 runs ignore the knobs)."""
    from xgpr_tpu_torch import config
    with config.working_dtype(F32):
        config.set_speed_preset("max")
        try:
            assert feature_map.kernel_precision(None, "cpu") == "default"
            assert feature_map.kernel_precision(None, "cpu", F32) == \
                "default"
            assert feature_map.kernel_precision(None, "cpu", F64) == \
                "highest"
            assert feature_map.kernel_precision("default", "cpu", F64) == \
                "default"
        finally:
            config.set_speed_preset("balanced")
