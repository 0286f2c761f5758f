"""Device, dtype and numerics policy for xgpr_tpu_torch.

- Device: every model and kernel takes an explicit ``device``.  "cuda" is
  the default; "cpu" is used only when asked for by name.  Asking for
  "cuda" when no card is visible raises instead of carrying on on the CPU.
- Dtype: float64 on the CPU (the tests hold the port against xgpr_tpu run
  in float64), float32 on the card; ``working_dtype`` overrides both for
  the models and kernels made inside it (a float64 witness on the card,
  or float32 on the CPU), and a kernel built with ``double_precision``
  (a model's ``double_precision_fht``) works in float64 on any device.
- Matmuls: full fp32 on the card.  TF32 is switched off here for both
  matmuls and cuDNN, mirroring xgpr_tpu's HIGHEST pin on every solve-path
  contraction (xgpr_tpu/ops/contract.py): TF32 keeps ~3 decimal digits,
  which the Nystrom algebra and CG recurrences cannot afford.
- Precision knobs (xgpr_tpu/config.py's, same names, values and errors):
  the solve-path and feature-path matmul precisions, the feature
  materialisation dtype, fast features and the speed presets.  Each is
  read at call time; float64 ignores them, as xgpr_tpu's x64 runs do:
  a float64 working dtype on the device, or float64 operands where the
  caller passes their dtype (a float64 kernel under a float32 working
  dtype).
- sincos mode: which (cos, sin) evaluator the feature maps use (see
  ops/sincos.py).
- Stacked-element limit: datasets with fewer raw x elements than this live
  on the device for the whole fit; larger ones stream chunk by chunk.
- Scale-out (xgpr_tpu/config.py's knobs, same names, values and
  warning): the engine mode (``should_shard``: the sharded engines of
  parallel/ over an initialised torch.distributed process group), M
  sharding of the fused sharded CG, and the CG lowering.  Each of them
  and the stacked limit bumps ``config_epoch``, which keys a model's
  engine cache, so a switch rebuilds the engine instead of reusing one of
  the old kind.
"""
import contextlib
import warnings

import torch
import torch.distributed as dist

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """torch.device for a "cuda"/"cuda:N"/"cpu" request.  A CUDA request
    with no visible card raises: the port never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"Device {device!r} was requested but no CUDA device is "
                "visible; pass device='cpu' to run on the CPU.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"Device must be 'cuda' or 'cpu'; got {device!r}.")
    return dev


_DTYPE_OVERRIDE = None


def fp_dtype(device) -> torch.dtype:
    """The working dtype: float64 on the CPU, float32 on the card, unless
    ``working_dtype`` overrides it."""
    if _DTYPE_OVERRIDE is not None:
        return _DTYPE_OVERRIDE
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def _is_float64(device, dtype=None):
    """Whether work on ``device`` counts as float64 for the precision
    knobs: the working dtype of ``device`` is float64, or the operands'
    ``dtype`` is (a float64 kernel under a float32 working dtype)."""
    return fp_dtype(device) == torch.float64 or dtype == torch.float64


@contextlib.contextmanager
def working_dtype(dtype):
    """Models and kernels made inside the block work in ``dtype`` on every
    device.  The CUDA kernels run float32 and float64 operands (float64 in
    their float64 bodies, whatever the precision knobs say)."""
    global _DTYPE_OVERRIDE
    saved, _DTYPE_OVERRIDE = _DTYPE_OVERRIDE, dtype
    try:
        yield
    finally:
        _DTYPE_OVERRIDE = saved


# ----------------------------------------------------------------------
# sin/cos evaluation in the feature maps (ops/sincos.py).  "auto" (alias
# "hi") is the full-period deg-13/14 polynomial pair for float32 and the
# builtin for float64; "exact" forces the builtin; "fast" and "poly" are
# the cheaper and the legacy quadrant-folded evaluators.  The CUDA kernels
# (K1, K2 and K3) run each mode as its own instantiation.
_SINCOS_MODES = ("auto", "exact", "poly", "hi", "fast")
_SINCOS_MODE = "auto"


def set_sincos_mode(mode: str):
    global _SINCOS_MODE
    if mode not in _SINCOS_MODES:
        raise ValueError("sincos mode must be auto, exact, poly, hi or fast")
    _SINCOS_MODE = mode


def sincos_mode() -> str:
    """The configured mode with the "auto" alias resolved to "hi"."""
    return "hi" if _SINCOS_MODE == "auto" else _SINCOS_MODE


# ----------------------------------------------------------------------
# Matmul precision of the solve path (ops/contract.py ``mm``): "highest"
# and "high" are full fp32 on the card ("high" is the TPU's 3-pass bf16,
# which an fp32 product already exceeds); "default" rounds the operands to
# bfloat16 and sums in fp32, as the TPU's DEFAULT dot does.  float64
# operands ignore it.
_PRECISIONS = ("highest", "high", "default")
_MATMUL_PRECISION = "highest"


def set_matmul_precision(p: str):
    global _MATMUL_PRECISION
    if p not in _PRECISIONS:
        raise ValueError("matmul precision must be highest/high/default")
    _MATMUL_PRECISION = p


def matmul_precision() -> str:
    return _MATMUL_PRECISION


# Precision of the feature-path matmuls: the projections of K1, K3 and K4
# and the CG matvec's contractions (``fmm``).  On the card "high" is the
# kernels' 3xTF32 body, "highest" K3's and K4's fp32 CUDA-core body
# (fp32-exact, as the TPU's HIGHEST; K1 keeps 3xTF32, which measured
# fp32-grade, PERF.md) and "default" their one-pass bf16 body.  K2 stays
# at 3xTF32 in every setting, as xgpr_tpu's Pallas feature map pins
# HIGHEST.  float64 operands run the float64 bodies whatever it says.
_FEATURE_PRECISION = "high"


def set_feature_precision(p: str):
    global _FEATURE_PRECISION
    if p not in _PRECISIONS:
        raise ValueError("feature precision must be highest/high/default")
    _FEATURE_PRECISION = p


def feature_precision(device="cuda", dtype=None) -> str:
    """The configured feature precision; "highest" for float64 work (the
    working dtype on ``device``, or the operands' ``dtype``)."""
    if _is_float64(device, dtype):
        return "highest"
    return _FEATURE_PRECISION


# Feature materialisation dtype of the CG matvec: with "bfloat16" the
# chunk's (cos, sin) parts, the direction and Z v are rounded to bfloat16
# before each product, and the products sum in float32 (ops/contract.py).
_FEATURE_DTYPE = "float32"


def set_feature_dtype(d: str):
    global _FEATURE_DTYPE
    if d not in ("float32", "bfloat16"):
        raise ValueError("feature dtype must be float32 or bfloat16")
    _FEATURE_DTYPE = d


def feature_dtype(device="cuda", dtype=None):
    """torch.bfloat16 when bf16 materialisation is on and the work is not
    float64 (the working dtype on ``device``, or the operands' ``dtype``),
    else None (keep the working dtype)."""
    if _FEATURE_DTYPE == "bfloat16" and not _is_float64(device, dtype):
        return torch.bfloat16
    return None


# Fast features: the kernels' projections at "default" (one bf16 pass)
# and bf16 feature materialisation.
_FAST_FEATURES = False


def set_fast_features(enabled: bool):
    global _FAST_FEATURES
    _FAST_FEATURES = bool(enabled)
    if enabled:
        set_feature_dtype("bfloat16")


def feature_matmul_precision(device="cuda", dtype=None) -> str:
    """The precision K1, K3 and K4 (and their plain versions) run at, for
    operands of ``dtype`` on ``device``."""
    if _FAST_FEATURES and not _is_float64(device, dtype):
        return "default"
    return feature_precision(device, dtype)


# Speed presets: one call that sets the throughput knobs to an operating
# point of xgpr_tpu (docs/speed_modes.md).
_SPEED_PRESETS = {
    # The TPU's fp32-exact matmuls (on the card K3's and K4's fp32
    # CUDA-core body, K1's 3xTF32) and builtin sin/cos.
    "reference": dict(feature_precision="highest", sincos="exact",
                      fast_features=False),
    # The default: 3xTF32 projections and the "hi" polynomial sincos.
    "balanced": dict(feature_precision="high", sincos="auto",
                     fast_features=False),
    # One bf16 pass per projection, bf16 feature materialisation and the
    # "fast" polynomial sincos.
    "max": dict(feature_precision="high", sincos="fast",
                fast_features=True),
}


def set_speed_preset(name: str):
    """Set all throughput knobs to a named operating point
    ("reference" / "balanced" / "max"); see _SPEED_PRESETS."""
    preset = _SPEED_PRESETS.get(name)
    if preset is None:
        raise ValueError(
            f"speed preset must be one of {sorted(_SPEED_PRESETS)}")
    set_feature_precision(preset["feature_precision"])
    set_sincos_mode(preset["sincos"])
    set_fast_features(preset["fast_features"])
    if not preset["fast_features"]:
        set_feature_dtype("float32")


# ----------------------------------------------------------------------
# Device-resident ("stacked") vs chunk-streamed ("streaming") datasets.
# 1e9 fp32 elements = 4 GB of raw x, far inside an 80 GB card next to the
# (chunk, num_rffs) feature workspace.
_STACKED_ELEMENT_LIMIT = 10 ** 9


def set_stacked_limit(n_elements: int):
    _bump_epoch()
    global _STACKED_ELEMENT_LIMIT
    n_elements = int(n_elements)
    if n_elements <= 0:
        raise ValueError("stacked limit must be a positive element count")
    _STACKED_ELEMENT_LIMIT = n_elements


def stacked_element_limit() -> int:
    return _STACKED_ELEMENT_LIMIT


# ----------------------------------------------------------------------
# The epoch of the knobs that choose an engine: models key their engine
# cache on it (models/baseclass.py::_engine).
_CONFIG_EPOCH = 0


def _bump_epoch():
    global _CONFIG_EPOCH
    _CONFIG_EPOCH += 1


def config_epoch() -> int:
    return _CONFIG_EPOCH


# ----------------------------------------------------------------------
# CG lowering.  "fused" (the default) runs the solvers of
# fitting/fused_cg.py on a device-resident engine: K1's fused matvec, and
# on a sharded engine the solvers that all-reduce (or reduce-scatter)
# once per iteration.  "looped" sends every engine to the plain loop over
# the engine's ``ztzv`` (fitting/cg.py), one reduction per iteration.
_CG_MODE = "fused"


def set_cg_mode(mode: str):
    _bump_epoch()
    global _CG_MODE
    if mode not in ("fused", "looped"):
        raise ValueError("cg mode must be fused or looped")
    _CG_MODE = mode


def cg_mode() -> str:
    return _CG_MODE


# ----------------------------------------------------------------------
# M sharding of the fused sharded CG (fitting/fused_cg.py
# ``fused_cg_solve_msharded``): the CG iterates, residuals and the
# Nystrom factor U sharded over the feature axis across the ranks, the
# matvec's sum a reduce-scatter.  "auto" turns it on when num_rffs
# reaches the threshold and divides the group's size; "on"/"off" force.
_M_SHARDING = "auto"
_M_SHARDING_THRESHOLD = 32768


def set_m_sharding(mode: str, threshold: int = None):
    _bump_epoch()
    global _M_SHARDING, _M_SHARDING_THRESHOLD
    if mode not in ("auto", "on", "off"):
        raise ValueError("m_sharding must be auto, on or off")
    _M_SHARDING = mode
    if threshold is not None:
        _M_SHARDING_THRESHOLD = int(threshold)


def use_m_sharding(num_rffs: int, n_dev: int) -> bool:
    if _M_SHARDING == "off" or n_dev <= 1 or num_rffs % n_dev != 0:
        if _M_SHARDING == "on":
            # Forced on but impossible: say so rather than hide the
            # replicated state the user tried to avoid.
            reason = "only one device is visible" if n_dev <= 1 else \
                f"num_rffs={num_rffs} is not divisible by {n_dev} devices"
            warnings.warn(
                f"M-sharding was forced on but {reason}; running the "
                "replicated solver instead.", UserWarning)
        return False
    if _M_SHARDING == "on":
        return True
    return num_rffs >= _M_SHARDING_THRESHOLD


# ----------------------------------------------------------------------
# Engine selection (models/baseclass.py::_engine).  "auto" uses the
# sharded engines when an initialised process group has more than one
# rank; "single" never does; "sharded" does whenever a group is
# initialised, a group of one included (the sharded path on one card).
_ENGINE_MODE = "auto"


def set_engine_mode(mode: str):
    _bump_epoch()
    global _ENGINE_MODE
    if mode not in ("auto", "single", "sharded"):
        raise ValueError("engine mode must be auto, single or sharded")
    _ENGINE_MODE = mode


def engine_mode() -> str:
    return _ENGINE_MODE


def should_shard() -> bool:
    if _ENGINE_MODE == "single":
        return False
    if not (dist.is_available() and dist.is_initialized()):
        return False
    return _ENGINE_MODE == "sharded" or dist.get_world_size() > 1
