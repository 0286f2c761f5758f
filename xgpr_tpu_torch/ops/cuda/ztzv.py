"""Fused CG matvec for one chunk: the K1 kernel's wrapper and its plain version.

Replaces xgpr_tpu/ops/pallas/ztzv_pallas.py (``ztzv_parts_pallas``, whose
``pallas_call`` is in ``_ztzv_parts_impl``) with the CUDA C++ kernels in
csrc/ztzv.cuh (3xTF32 and bf16 on csrc/dense_wgmma.cuh; 3xTF32 from
REUSE_MIN_K right-hand sides on csrc/ztzv_reuse.cuh, which makes each
chunk's features once a call into scratch the wrapper allocates); see
those files for the design and what bounds it on the card.  Before a launch the wrapper makes the operands contiguous, pads
x's columns to 16 bytes (4 fp32, 8 bf16 or 2 float64 values) and makes x
the planes of the body (operands.py: TF32 high parts and remainders, bf16
values, or the float64 values; a few elementwise passes over the chunk,
2.75 MB at 8192 x 84); proj's transpose is prepared once per body and
cached with proj (``projT_planes``).
Same semantics: x raw (not sigma-scaled), sigma multiplies the product,
scale = rbf_norm_constant(F, intercept), mask * scale folded into both
parts, and with an intercept cos column 0 equals the mask.

The operands' dtype and the feature precision (``precision``, the
configured ``feature_matmul_precision`` by default) pick the body
(feature_map.py ``kernel_body``): float64 operands the float64 DMMA
body with the builtin sincos, whatever the precision; for float32 "high"
and "highest" 3xTF32, "default" one bf16 pass with every product's operands
rounded to bf16 as the TPU's DEFAULT dot rounds them in ``_ztzv_kernel``:
x and proj, then c and s (after scale * mask and the intercept column),
v_c / v_s and the summed zv, each product summed in fp32.

``ztzv_parts`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; anything else raises.  A CUDA call runs the kernels of the
sincos mode and precision it asks for, never another.  ``LAUNCHES``
counts kernel launches (one per call, covering its CUDA launches) by
their shape, mode and precision (R, D, F, K, mode, precision; float64
launches count as ("exact", "float64"), ``launch_tags``): K is 1 in a
fit's CG and 26 in SLQ's.  ``PROJECTIONS``, keyed the same, counts the
projections of the chunk's features the calls made (``launch_plan``:
one a pass and block of right-hand sides, or one a call on the reuse
path).  Two calls on the same inputs give the same
bits.  ``launch_plan`` is the wrapper's block arithmetic (right-hand sides
a block, the splits of the walks, the launches of each pass), plain
Python that the CPU tests hold; any K is taken (the 3xTF32 and bf16
bodies' grids are 1-D; float64's pass goes in several launches past
MAX_GRID_Z blocks of right-hand sides).  ``launcher`` returns the prepared launch apart
from the wrapper's checks and preparation (what a timing of the kernel
alone calls).
"""
from collections import Counter, namedtuple

import torch

from .. import sincos as _sincos
from ..contract import bf16_mm, parts_contract_bf16
from ..sorf import rbf_norm_constant
from ...utils.diagnostics import span
from . import build
from .feature_map import (BODY_FLAGS, TILE, cuda_operands, kernel_body,
                          kernel_mode, kernel_precision, kernel_sincos_flag,
                          launch_tags)
from .operands import (STREAM_TILE, data_ptr, depth_multiple, kernel_planes,
                       pad_depth, projT_planes, sm_count, tile_split)

LAUNCHES = Counter()
PROJECTIONS = Counter()

# The most blocks a launch may have along grid z (csrc/ztzv.cuh:
# MAX_GRID_Z): the blocks of right-hand sides past it go in further
# launches of the same passes.
MAX_GRID_Z = 65535

# The K from which a 3xTF32 call takes the reuse path
# (csrc/ztzv_reuse.cuh): up to K 16 the passes of csrc/dense_wgmma.cuh
# carry every right-hand side in one block a pass and project twice a
# call, as fast as the reuse path's one projection and two reads of the
# stored features; from K 17 they project 2 ceil(K / 16) times (PERF.md:
# both timed at K 9, 16, 17, 26 and 32).
REUSE_MIN_K = 17
# csrc/ztzv_reuse.cuh: the right-hand sides a stream block carries, and
# the stream blocks an SM holds (a stage is STREAM_TILE rows by
# STREAM_TILE columns).
STREAM_RHS, STREAM_BLOCKS_PER_SM = 32, 2


LaunchPlan = namedtuple("LaunchPlan",
                        "rhs blocks zsplit osplit launches projections "
                        "rsplit")


def reuses_features(body, k):
    """Whether a call at K right-hand sides in ``body`` takes the reuse
    path: 3xTF32 from REUSE_MIN_K."""
    return body == "tf32x3" and k >= REUSE_MIN_K


def launch_plan(rhs, n, f, k, sms, body):
    """How one call on R = n rows, F = f frequencies and K = k right-hand
    sides is launched in ``body`` on ``sms`` SMs.

    On the passes of csrc/dense_wgmma.cuh and csrc/ztzv.cuh a block
    carries ``rhs`` right-hand sides (the library's xgpr_ztzv_rhs_per_block
    for the call's body and K, the same in both passes: 1 at K 1 in
    float32, else 8 up to K 8, then 16 in 3xTF32 and 32 in bf16 and
    float64, so float64 at SLQ's K 26 projects once a pass): ``blocks``
    blocks of right-hand sides in each pass, each projecting the chunk's
    features again (``projections``, 2 ``blocks``); pass (a) splits each
    row tile's frequency tiles over ``zsplit`` blocks and pass (b) each
    frequency tile's row tiles over ``osplit``, the counts that fill the
    SMs in the fewest waves (``tile_split``); ``launches`` launches of
    each pass carry the blocks, at most MAX_GRID_Z each, but one in
    3xTF32 and bf16, whose grids are 1-D; ``rsplit`` 0.

    On the reuse path (``reuses_features``) the call projects once
    (``projections`` 1): the feature pass splits each frequency tile's
    row tiles over ``rsplit`` blocks (K2's split), and its two streams
    carry ``rhs`` = STREAM_RHS right-hand sides a block in ``blocks``
    blocks, pass (a) splitting the 64-column stages of C and S
    over ``zsplit`` blocks and pass (b) the 64-row stages over ``osplit``,
    two blocks an SM."""
    row_tiles, f_tiles = -(-n // TILE), -(-f // TILE)
    if reuses_features(body, k):
        rhs = STREAM_RHS
        blocks = -(-k // rhs)
        rows, cols = -(-n // STREAM_TILE), 2 * -(-f // STREAM_TILE)
        slots = STREAM_BLOCKS_PER_SM * sms
        return LaunchPlan(rhs, blocks,
                          tile_split(cols, rows * blocks, slots, 16),
                          tile_split(rows, cols * blocks, slots, 32),
                          1, 1, tile_split(row_tiles, f_tiles, sms, 64))
    blocks = -(-k // rhs)
    return LaunchPlan(rhs, blocks,
                      tile_split(f_tiles, row_tiles * blocks, sms, 16),
                      tile_split(row_tiles, f_tiles * blocks, sms, 32),
                      1 if body in ("tf32x3", "bf16")
                      else -(-blocks // MAX_GRID_Z), 2 * blocks, 0)


def ztzv_parts_plain(x, m, proj, sigma, v_c, v_s, fit_intercept, mode=None,
                     precision=None):
    """Plain PyTorch version: materialises the (R, F) parts and contracts
    them with torch.matmul, under "default" on operands rounded to bf16
    at the kernel's points (ops/contract.py: ``bf16_mm``)."""
    precision = kernel_precision(precision, x.device, x.dtype)
    scale = torch.tensor(rbf_norm_constant(proj.shape[1], fit_intercept),
                         dtype=x.dtype, device=x.device)
    sig = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    if precision == "default":
        arg = bf16_mm(x, proj) * sig
    else:
        arg = torch.matmul(x, proj) * sig
    c, s = _sincos.sincos(arg, (m * scale)[:, None], mode)
    if fit_intercept:
        c[:, 0] = m
    if precision == "default":
        return parts_contract_bf16(c, s, v_c, v_s)
    zv = torch.matmul(c, v_c) + torch.matmul(s, v_s)
    return torch.matmul(c.T, zv), torch.matmul(s.T, zv)


def ztzv_parts(x, m, proj, sigma, v_c, v_s, fit_intercept, mode=None,
               precision=None):
    """(oc, os), each (F, K): the chunk's Z^T (Z v) in cos/sin halves.

    x (R, D) raw rows; m (R,) row mask; proj (D, F); sigma a float;
    v_c / v_s (F, K) the cos/sin halves of the CG direction.  The call
    is the span ``xgpr/k1`` (utils/diagnostics.py) in a profiled run.
    """
    with span("xgpr/k1"):
        n, d = x.shape
        f = proj.shape[1]
        k = v_c.shape[1]
        if proj.shape[0] != d or m.shape != (n,) or v_c.shape != (f, k) \
                or v_s.shape != (f, k) or k < 1:
            raise ValueError("ztzv_parts: inconsistent operand shapes.")
        if all(t.device.type == "cpu" for t in (x, m, proj, v_c, v_s)):
            return ztzv_parts_plain(x, m, proj, sigma, v_c, v_s,
                                    fit_intercept, mode, precision)
        if x.device.type != "cuda":
            raise ValueError(f"ztzv_parts: no kernel for {x.device}.")
        return launcher(x, m, proj, sigma, v_c, v_s, fit_intercept, mode,
                        precision)()


def launcher(x, m, proj, sigma, v_c, v_s, fit_intercept, mode=None,
             precision=None):
    """The kernel launch of one ``ztzv_parts`` call on CUDA operands,
    prepared: a function of no arguments that launches its kernels on the
    current stream, counts the launch and its projections and returns
    (oc, os)."""
    n, d = x.shape
    f = proj.shape[1]
    k = v_c.shape[1]
    dtype, (x, m, proj, v_c, v_s) = cuda_operands("ztzv_parts", x, m, proj,
                                                  v_c, v_s)
    mode = kernel_mode(mode)
    precision = kernel_precision(precision, x.device, dtype)
    body = kernel_body("K1", dtype, precision)
    opts = dict(dtype=dtype, device=x.device)
    if n == 0 or f == 0:
        return lambda: (torch.zeros((f, k), **opts),
                        torch.zeros((f, k), **opts))
    lib = build.library()
    plan = launch_plan(lib.xgpr_ztzv_rhs_per_block(BODY_FLAGS[body], k, 0),
                       n, f, k, sm_count(x.device.index), body)
    xh, xl = kernel_planes(pad_depth(x, depth_multiple(body)), body)
    ph, pl = projT_planes(proj, body)
    oc_part = torch.empty((plan.osplit, f, k), **opts)
    os_part = torch.empty((plan.osplit, f, k), **opts)
    oc = torch.empty((f, k), **opts)
    os_ = torch.empty((f, k), **opts)
    key = (n, d, f, k) + launch_tags(dtype, mode, precision)
    scale = rbf_norm_constant(f, fit_intercept)
    if reuses_features(body, k):
        # One allocation: C and S (n, ldf) each, v_c^T and v_s^T (k, ldf)
        # each, zv's slices (zsplit, n, kp); ldf and kp 16-byte rows.
        ldf, kp = -(-f // 4) * 4, -(-k // 4) * 4
        scratch = torch.empty(2 * (n + k) * ldf + plan.zsplit * n * kp,
                              **opts)

        def call(stream):
            z = scratch.data_ptr()
            vt = z + 4 * 2 * n * ldf
            zv = vt + 4 * 2 * k * ldf
            return lib.xgpr_ztzv_reuse(
                xh.data_ptr(), xl.data_ptr(), m.data_ptr(), ph.data_ptr(),
                pl.data_ptr(), float(sigma), v_c.data_ptr(), v_s.data_ptr(),
                z, vt, zv, oc_part.data_ptr(), os_part.data_ptr(),
                oc.data_ptr(), os_.data_ptr(), n, xh.shape[1], f, k,
                plan.rsplit, plan.zsplit, plan.osplit, scale,
                int(bool(fit_intercept)), kernel_sincos_flag(mode), stream)
    else:
        zv_part = torch.empty((plan.zsplit, n, k), **opts)

        def call(stream):
            return lib.xgpr_ztzv(
                xh.data_ptr(), data_ptr(xl), m.data_ptr(), ph.data_ptr(),
                data_ptr(pl), float(sigma), v_c.data_ptr(), v_s.data_ptr(),
                zv_part.data_ptr(), oc_part.data_ptr(), os_part.data_ptr(),
                oc.data_ptr(), os_.data_ptr(), n, xh.shape[1], f, k,
                plan.zsplit, plan.osplit, scale, int(bool(fit_intercept)),
                kernel_sincos_flag(mode), BODY_FLAGS[body], stream)

    def launch():
        with torch.cuda.device(x.device):
            rc = call(torch.cuda.current_stream(x.device).cuda_stream)
        build.check(rc, "ztzv kernel")
        LAUNCHES[key] += 1
        PROJECTIONS[key] += plan.projections
        return oc, os_
    return launch
