"""The conv window loop of the port against xgpr_tpu.

- The plain versions of K3 (``conv_parts``) and K4 (``conv_maxpool``) in
  float32 against the Pallas kernels they replace, run in interpret mode as
  the JAX suite runs them on the CPU, on the five shape cases of
  tests/ops_tests/test_conv_pallas.py, within 3e-5 * max(1, |ref|): the JAX
  suite's own bound for the same comparison (fp32 on both sides, the two
  differ only in summation order).
- ops/conv.py in float64 against xgpr_tpu/ops/conv.py: every averaging,
  parts on and off, and the maxpool, on the dense and the structured
  (FWHT) routes, at rtol 1e-12 (roundoff).
"""
from math import ceil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgpr_tpu.ops import conv as jconv
from xgpr_tpu.ops.hadamard import next_pow2
from xgpr_tpu.ops.pallas.conv_pallas import (conv_maxpool_pallas,
                                             conv_parts_pallas)
from xgpr_tpu.ops.sorf import dense_sorf_projection as j_dense_projection
from xgpr_tpu_torch.ops import conv as tconv
from xgpr_tpu_torch.ops.cuda import conv as kconv
from xgpr_tpu_torch.utils import rng as state_rng

torch.set_num_threads(1)

CASES = [
    (24, 30, 21, 9, 256),     # n % RD != 0, nw % BW != 0
    (16, 40, 4, 3, 128),      # small wd
    (32, 24, 16, 2, 384),     # F not a power of two (3 x 128)
    (12, 20, 21, 9, 200),     # F not a multiple of 128 (padded tail)
    (8, 16, 8, 3, 1000),      # ragged F, multiple freq tiles
]


def _inputs(n, l, d, width, num_freqs, dtype=np.float32, seed=5):
    rng = np.random.default_rng(n * 1000 + l * 10 + width)
    x = rng.standard_normal((n, l, d)).astype(dtype)
    seq_len = rng.integers(width, l + 1, size=(n,)).astype(np.int32)
    padded = next_pow2(width * d)
    nblocks = max(1, ceil(num_freqs / padded))
    radem = state_rng.radem_diagonals(seed, nblocks, padded, np.float32)
    chi = state_rng.chi_scaling(seed, padded, num_freqs, np.float32)
    proj = np.asarray(j_dense_projection(jnp.asarray(radem, dtype),
                                         jnp.asarray(chi, dtype), width * d))
    return x, seq_len, radem.astype(dtype), chi.astype(dtype), proj


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,l,d,width,num_freqs", CASES)
def test_plain_kernels_match_pallas(n, l, d, width, num_freqs):
    x, seq_len, _, _, proj = _inputs(n, l, d, width, num_freqs)
    sigma = np.float32(0.61)
    jc, js = conv_parts_pallas(jnp.asarray(x), jnp.asarray(seq_len),
                               jnp.asarray(proj), sigma, width, num_freqs,
                               interpret=True)
    before = kconv.PARTS_LAUNCHES, kconv.MAXPOOL_LAUNCHES
    tc, ts = kconv.conv_parts(_t(x), _t(seq_len), _t(proj), float(sigma),
                              width)
    assert tc.dtype == torch.float32 and tc.shape == (n, num_freqs)
    for got, want in ((tc, jc), (ts, js)):
        want = np.asarray(want, np.float64)
        tol = 3e-5 * max(1.0, np.abs(want).max())
        assert np.abs(got.numpy() - want).max() < tol

    jm = np.asarray(conv_maxpool_pallas(jnp.asarray(x), jnp.asarray(seq_len),
                                        jnp.asarray(proj), width, num_freqs,
                                        interpret=True), np.float64)
    tm = kconv.conv_maxpool(_t(x), _t(seq_len), _t(proj), width)
    assert tm.shape == (n, num_freqs)
    assert np.abs(tm.numpy() - jm).max() < 3e-5 * max(1.0, np.abs(jm).max())
    # CPU tensors take the plain versions: nothing is launched.
    assert (kconv.PARTS_LAUNCHES, kconv.MAXPOOL_LAUNCHES) == before


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("scaling", [0, 1, 2])
def test_conv_rbf_features_fp64(dense, scaling):
    n, l, d, width, num_freqs = 10, 14, 5, 4, 40
    x, seq_len, radem, chi, proj = _inputs(n, l, d, width, num_freqs,
                                           np.float64)
    for parts in (False, True):
        want = jconv.conv_rbf_features(
            jnp.asarray(x), jnp.asarray(seq_len), jnp.asarray(radem),
            jnp.asarray(chi), 0.7, width, scaling, block_size=4,
            proj=jnp.asarray(proj) if dense else None, parts=parts)
        got = tconv.conv_rbf_features(
            _t(x), _t(seq_len), _t(radem), _t(chi), 0.7, width, scaling,
            block_size=4, proj=_t(proj) if dense else None, parts=parts)
        for g, w in zip(got if parts else (got,), want if parts else (want,)):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                       atol=1e-13)


@pytest.mark.parametrize("dense", [True, False])
def test_conv_maxpool_features_fp64(dense):
    n, l, d, width, num_freqs = 9, 12, 6, 3, 50
    x, seq_len, radem, chi, proj = _inputs(n, l, d, width, num_freqs,
                                           np.float64)
    want = jconv.conv_maxpool_features(
        jnp.asarray(x), jnp.asarray(seq_len), jnp.asarray(radem),
        jnp.asarray(chi), width, block_size=4,
        proj=jnp.asarray(proj) if dense else None)
    got = tconv.conv_maxpool_features(
        _t(x), _t(seq_len), _t(radem), _t(chi), width, block_size=4,
        proj=_t(proj) if dense else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)


def test_wrappers_check_what_they_take():
    x, seq_len, _, _, proj = _inputs(4, 6, 3, 2, 16)
    with pytest.raises(ValueError):          # proj rows != w * D
        kconv.conv_parts(_t(x), _t(seq_len), _t(proj[:-1]), 0.5, 2)
    with pytest.raises(ValueError):          # sequence axis shorter than w
        kconv.conv_maxpool(_t(x[:, :1]), _t(seq_len), _t(proj), 2)
    with pytest.raises(ValueError):          # no kernel for this device
        kconv.conv_parts(_t(x).to("meta"), _t(seq_len).to("meta"),
                         _t(proj).to("meta"), 0.5, 2)
    # Row scale goes into the epilogue: the plain version scales the sums.
    scale = torch.linspace(0.5, 2.0, 4, dtype=torch.float32)
    c0, s0 = kconv.conv_parts(_t(x), _t(seq_len), _t(proj), 0.5, 2)
    c1, s1 = kconv.conv_parts(_t(x), _t(seq_len), _t(proj), 0.5, 2, scale)
    assert torch.allclose(c1, c0 * scale[:, None])
    assert torch.allclose(s1, s0 * scale[:, None])
