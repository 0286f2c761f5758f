"""Device, dtype and numerics policy for xgpr_tpu_torch.

- Device: every model and kernel takes an explicit ``device``.  "cuda" is
  the default; "cpu" is used only when asked for by name.  Asking for
  "cuda" when no card is visible raises instead of carrying on on the CPU.
- Dtype: float64 on the CPU (the tests hold the port against xgpr_tpu run
  in float64), float32 on the card; ``working_dtype`` overrides both for
  the models and kernels made inside it (a float64 witness on the card,
  or float32 on the CPU).
- Matmuls: full fp32 on the card.  TF32 is switched off here for both
  matmuls and cuDNN, mirroring xgpr_tpu's HIGHEST pin on every solve-path
  contraction (xgpr_tpu/ops/contract.py): TF32 keeps ~3 decimal digits,
  which the Nystrom algebra and CG recurrences cannot afford.
- sincos mode: which (cos, sin) evaluator the feature maps use (see
  ops/sincos.py).
- Stacked-element limit: datasets with fewer raw x elements than this live
  on the device for the whole fit; larger ones stream chunk by chunk.
"""
import contextlib

import torch

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


@contextlib.contextmanager
def working_dtype(dtype):
    """Models and kernels made inside the block work in ``dtype`` on every
    device.  The CUDA kernels take float32 only and raise on a float64
    CUDA tensor; the plain-torch gradient fns run in any dtype."""
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
# implement "hi" and "exact" and raise NotImplementedError for the others.
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
# Device-resident ("stacked") vs chunk-streamed ("streaming") datasets.
# 1e9 fp32 elements = 4 GB of raw x, far inside an 80 GB card next to the
# (chunk, num_rffs) feature workspace.
_STACKED_ELEMENT_LIMIT = 10 ** 9


def set_stacked_limit(n_elements: int):
    global _STACKED_ELEMENT_LIMIT
    n_elements = int(n_elements)
    if n_elements <= 0:
        raise ValueError("stacked limit must be a positive element count")
    _STACKED_ELEMENT_LIMIT = n_elements


def stacked_element_limit() -> int:
    return _STACKED_ELEMENT_LIMIT
