"""Feature ops of the PyTorch port against their xgpr_tpu namesakes.

Inputs come from numpy with a fixed seed and go through both packages on
the CPU.  float64 results must agree at roundoff (rtol 1e-12 /
atol 1e-13: the two packages differ only in summation order), the random
state bit for bit, and the float32 sincos evaluators within a few ULP of
a unit-magnitude result (atol 4e-7, XLA and PyTorch may fuse the Horner
steps differently).
"""
from math import ceil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgpr_tpu.ops import hadamard as j_hadamard
from xgpr_tpu.ops import layout as j_layout
from xgpr_tpu.ops import sincos as j_sincos
from xgpr_tpu.ops import sorf as j_sorf
from xgpr_tpu.utils import rng as j_rng
from xgpr_tpu_torch.ops import hadamard as t_hadamard
from xgpr_tpu_torch.ops import layout as t_layout
from xgpr_tpu_torch.ops import sincos as t_sincos
from xgpr_tpu_torch.ops import sorf as t_sorf
from xgpr_tpu_torch.utils import rng as t_rng

torch.set_num_threads(1)

RTOL, ATOL = 1e-12, 1e-13


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _state(seed, d, num_freqs):
    padded = j_rng.next_pow2(d)
    nblocks = max(1, ceil(num_freqs / padded))
    radem = j_rng.radem_diagonals(seed, nblocks, padded, np.float64)
    chi = j_rng.chi_scaling(seed, padded, num_freqs, np.float64)
    return radem, chi


@pytest.mark.parametrize("name,args", [
    ("radem_diagonals", (123, 3, 128)),
    ("chi_scaling", (123, 128, 300)),
    ("matern_chi_modifier", (123, 300, 1.5)),
    ("cauchy_chi_modifier", (123, 300)),
    ("srht_state", (7, 1000, 64)),
    ("normal_probes", (5, 64, 4)),
    ("rademacher_probes", (5, 64, 4)),
])
def test_rng_copy_is_bit_identical(name, args):
    want = getattr(j_rng, name)(*args)
    got = getattr(t_rng, name)(*args)
    as_tuple = lambda v: v if isinstance(v, tuple) else (v,)
    for g, w in zip(as_tuple(got), as_tuple(want)):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)


def test_exact_count_keep_mask_is_bit_identical():
    mask = (np.arange(50) < 41).astype(np.float64)
    want = j_rng.exact_count_keep_mask(mask, 0.2, np.random.default_rng(3))
    got = t_rng.exact_count_keep_mask(mask, 0.2, np.random.default_rng(3))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 8, 128, 256, 4096])
def test_fwht(n):
    x = np.random.default_rng(n).standard_normal((3, n))
    _close(t_hadamard.fwht(torch.from_numpy(x)),
           j_hadamard.fwht(jnp.asarray(x)))


@pytest.mark.parametrize("num_freqs,padded", [(64, 128), (256, 128),
                                              (200, 16), (1000, 64)])
def test_layout(num_freqs, padded):
    assert t_layout.block_widths(num_freqs, padded) == \
        j_layout.block_widths(num_freqs, padded)
    for g, w in zip(t_layout.freq_positions(num_freqs, padded),
                    j_layout.freq_positions(num_freqs, padded)):
        assert np.array_equal(g, w)
    assert np.array_equal(
        t_layout.variance_column_indices(num_freqs, padded, 32),
        j_layout.variance_column_indices(num_freqs, padded, 32))
    rng = np.random.default_rng(num_freqs)
    c, s = rng.standard_normal((2, 5, num_freqs))
    got = t_layout.assemble_cos_sin(torch.from_numpy(c), torch.from_numpy(s),
                                    padded)
    want = j_layout.assemble_cos_sin(jnp.asarray(c), jnp.asarray(s), padded)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d,num_freqs", [(10, 32), (84, 256), (50, 1000)])
def test_dense_sorf_projection(d, num_freqs):
    radem, chi = _state(11, d, num_freqs)
    got = t_sorf.dense_sorf_projection(torch.from_numpy(radem),
                                       torch.from_numpy(chi), d)
    want = j_sorf.dense_sorf_projection(jnp.asarray(radem),
                                        jnp.asarray(chi), d)
    _close(got, want)


@pytest.mark.parametrize("intercept", [False, True])
@pytest.mark.parametrize("n,d,num_freqs", [(10, 50, 32), (23, 84, 300),
                                           (7, 10, 200)])
def test_rbf_feature_maps(intercept, n, d, num_freqs):
    rng = np.random.default_rng(d + num_freqs)
    x = rng.standard_normal((n, d)) * 0.3
    radem, chi = _state(5, d, num_freqs)
    padded = radem.shape[-1]
    _close(t_sorf.rbf_feature_map(torch.from_numpy(x),
                                  torch.from_numpy(radem),
                                  torch.from_numpy(chi), intercept),
           j_sorf.rbf_feature_map(jnp.asarray(x), jnp.asarray(radem),
                                  jnp.asarray(chi), intercept))
    proj = np.array(j_sorf.dense_sorf_projection(
        jnp.asarray(radem), jnp.asarray(chi), d))
    tx, tp = torch.from_numpy(x), torch.from_numpy(proj)
    jx, jp = jnp.asarray(x), jnp.asarray(proj)
    _close(t_sorf.rbf_feature_map_dense(tx, tp, intercept, padded),
           j_sorf.rbf_feature_map_dense(jx, jp, intercept, padded))
    for g, w in zip(t_sorf.rbf_feature_parts_dense(tx, tp, intercept),
                    j_sorf.rbf_feature_parts_dense(jx, jp, intercept)):
        _close(g, w)


@pytest.mark.parametrize("n,d,rank", [(10, 50, 16), (6, 1000, 100)])
def test_srht_rows(n, d, rank):
    x = np.random.default_rng(d).standard_normal((n, d))
    radem, idx = j_rng.srht_state(3, d, rank, np.float64)
    _close(t_sorf.srht_rows(torch.from_numpy(x), torch.from_numpy(radem),
                            torch.from_numpy(idx).long()),
           j_sorf.srht_rows(jnp.asarray(x), jnp.asarray(radem),
                            jnp.asarray(idx)))


def _sincos_args(dtype):
    rng = np.random.default_rng(0)
    return np.concatenate([rng.uniform(-3, 3, 4000),
                           rng.uniform(-120, 120, 4000),
                           rng.uniform(-8000, 8000, 2000)]).astype(dtype)


@pytest.mark.parametrize("name", ["_hi_sincos", "_fast_sincos",
                                  "_poly_sincos"])
def test_sincos_evaluators_fp64(name):
    x = _sincos_args(np.float64)
    got = getattr(t_sincos, name)(torch.from_numpy(x))
    want = getattr(j_sincos, name)(jnp.asarray(x))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("name", ["_hi_sincos", "_fast_sincos",
                                  "_poly_sincos"])
def test_sincos_evaluators_fp32(name):
    x = _sincos_args(np.float32)
    got = getattr(t_sincos, name)(torch.from_numpy(x))
    want = getattr(j_sincos, name)(jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=4e-7)


def test_sincos_exact_and_guard():
    """fp64 takes the builtin bit for bit; in fp32 elements past the
    Cody-Waite range take the builtin and the rest keep the polynomial."""
    x64 = torch.from_numpy(_sincos_args(np.float64))
    c, s = t_sincos.sincos(x64)
    assert torch.equal(c, torch.cos(x64)) and torch.equal(s, torch.sin(x64))
    x = _sincos_args(np.float32)
    x[7] = 1.5e6
    tx = torch.from_numpy(x)
    c, s = t_sincos.sincos(tx)
    assert c[7] == torch.cos(tx[7]) and s[7] == torch.sin(tx[7])
    cp, sp = t_sincos._hi_sincos(tx)
    keep = np.abs(x) <= t_sincos.POLY_ARG_LIMIT
    assert torch.equal(c[keep], cp[keep]) and torch.equal(s[keep], sp[keep])
