"""The prefetching streamed engine on the card against the stacked one.

Needs a CUDA device and nvcc; skips without them.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_cuda_streaming.py

A streamed pass goes through parallel/streaming.py's ring of pinned
staging buffers, its copy stream and events; a stacked pass reads the
same chunks from one device tensor.  Both run the same float32 K3
features and float64 sums in the same chunk order, so they agree to
1e-4 of max |ref| (the tolerance of float32 features; in practice they
are equal), and two streamed passes are bitwise equal: a staging or
device buffer refilled before its copy or its consumer finished would
break both.  Ten chunks of 1024 rows at 4096 RFFs keep the compute
behind the copies, so the ring wraps while work is still queued.
"""
import numpy as np
import pytest
import torch

from xgpr_tpu_torch import GPRegression, build_regression_dataset
from xgpr_tpu_torch.fitting.engine import Engine
from xgpr_tpu_torch.ops.cuda import conv
from xgpr_tpu_torch.utils import rng as state_rng

pytestmark = pytest.mark.cuda

NUM_RFFS = 4096
RTOL = 1e-4


@pytest.fixture(scope="module")
def engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(21)
    n, seq_len, dim, width = 9 * 1024 + 300, 16, 64, 9
    x = rng.standard_normal((n, seq_len, dim)).astype(np.float32) * 0.3
    lengths = rng.integers(width, seq_len + 1, size=n).astype(np.int32)
    y = np.sin(x[:, :4, :8].sum(axis=(1, 2))) + 0.1 * rng.standard_normal(n)
    dset = build_regression_dataset(x, y, lengths, chunk_size=1024)
    model = GPRegression(num_rffs=NUM_RFFS, kernel_choice="Conv1dRBF",
                         kernel_settings={"conv_width": width},
                         device="cuda", verbose=False)
    model.set_hyperparams(np.array([-1.5, -2.5]), dset)
    streamed = Engine(model.kernel, dset, mode="streaming")
    stacked = Engine(model.kernel, dset, mode="stacked")
    assert streamed.prefetcher is not None and stacked.prefetcher is None
    return streamed, stacked, dset


def _close(got, want):
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g), torch.as_tensor(w)
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= RTOL * scale


def _twice(engine, fn):
    """fn over the engine twice: the second pass reuses the ring and is
    timed (the prefetcher's ``timing`` set), which changes no value."""
    first = fn(engine)
    engine.prefetcher.timing = True
    try:
        second = fn(engine)
    finally:
        engine.prefetcher.timing = False
    torch.cuda.synchronize()
    return first, second


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


REDUCTIONS = {
    "ztzv": lambda e: e.ztzv(np.random.default_rng(3).standard_normal(
        (NUM_RFFS, 3))),
    "design_mat": lambda e: e.design_mat(),
    "sketch_row_subsampled": lambda e: e.sketch(
        *state_rng.srht_state(123, NUM_RFFS, 64, np.float64),
        with_zty=True, row_keep_prob=0.3, seed=9),
}


@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_streamed_engine_matches_stacked(engines, name):
    streamed, stacked, dset = engines
    fn = REDUCTIONS[name]
    before = conv.PARTS_LAUNCHES.total()
    first, second = _twice(streamed, fn)
    assert conv.PARTS_LAUNCHES.total() > before
    assert streamed.prefetcher.last_pass()["chunks"] == dset.get_n_batches()
    want = _as_tuple(fn(stacked))
    first, second = _as_tuple(first), _as_tuple(second)
    for a, b in zip(first, second):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    _close(first, want)


def test_streamed_matvec_under_max_equals_stacked(engines):
    """Under set_speed_preset("max") both engines contract the same K3
    parts (its bf16 body) in bfloat16, chunk by chunk in the same order:
    the same bits."""
    from xgpr_tpu_torch import config
    streamed, stacked, _ = engines
    vec = np.random.default_rng(4).standard_normal((NUM_RFFS, 2))
    config.set_speed_preset("max")
    try:
        got, want = streamed.ztzv(vec), stacked.ztzv(vec)
        torch.cuda.synchronize()
    finally:
        config.set_speed_preset("balanced")
    assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))
    assert any(key[-1] == "default" for key in conv.PARTS_LAUNCHES)
