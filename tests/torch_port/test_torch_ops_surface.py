"""The ``xgpr_tpu_torch.ops`` package surface against ``xgpr_tpu.ops``.

- It exports the 23 names of xgpr_tpu/ops/__init__.py, each from its
  port namesake.
- Where they compute, the two agree at float64 roundoff (1e-12 of
  max|ref|: the same arithmetic, summed in another order), on the same
  numpy inputs, in float64 on the CPU; the constants and the layout's
  index arithmetic are equal.
- ``fwht_normalized`` is the orthonormal transform, as xgpr_tpu's.
- A fresh ``import xgpr_tpu_torch.ops`` builds no kernel: it starts no
  nvcc and loads no library.
"""
import ast
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xgpr_tpu.ops as jops
import xgpr_tpu_torch.ops as tops

torch.set_num_threads(1)

RTOL = 1e-12
ROOT = Path(__file__).resolve().parents[2]


def _jax_names():
    """The names xgpr_tpu/ops/__init__.py imports."""
    tree = ast.parse((ROOT / "xgpr_tpu" / "ops" / "__init__.py").read_text())
    return [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


def test_the_23_names_are_exported():
    names = _jax_names()
    assert len(names) == 23 and "fwht_normalized" in names
    for name in names:
        assert hasattr(tops, name), name
        obj = getattr(tops, name)
        if callable(obj):
            assert obj.__module__.startswith("xgpr_tpu_torch.ops"), name


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((30, 12))
    radem = rng.choice([-1.0, 1.0], size=(3, 2, 16))
    chi = np.abs(rng.standard_normal(24)) + 0.5
    seqs = rng.standard_normal((20, 10, 4))
    lengths = rng.integers(3, 11, size=20).astype(np.int32)
    cradem = rng.choice([-1.0, 1.0], size=(3, 1, 16))
    return x, radem, chi, seqs, lengths, cradem


@pytest.mark.parametrize("n", [1, 2, 8, 64, 256])
def test_fwht_and_fwht_normalized(n):
    x = np.random.default_rng(n).standard_normal((5, n))
    _close(tops.fwht(_t(x)), jops.fwht(x))
    _close(tops.fwht_normalized(_t(x)), jops.fwht_normalized(x))
    # Orthonormal: twice is the identity, norms are kept.
    y = tops.fwht_normalized(tops.fwht_normalized(_t(x)))
    _close(y, x)


def test_hadamard_matrix_and_next_pow2():
    for n in (1, 2, 16, 128):
        _close(tops.hadamard_matrix(n, torch.float64, "cpu"),
               jops.hadamard_matrix(n, np.float64))
    assert inspect.signature(tops.hadamard_matrix).parameters[
        "device"].default == "cuda"
    for n in (0, 1, 2, 3, 5, 64, 65, 1000):
        assert tops.next_pow2(n) == jops.next_pow2(n)


def test_sorf_ops(state):
    x, radem, chi, _, _, _ = state
    xp = jops.pad_rows(x, 16)
    _close(tops.pad_rows(_t(x), 16), xp)
    _close(tops.sorf_blocks(_t(xp), _t(radem)), jops.sorf_blocks(xp, radem))
    _close(tops.sorf_project(_t(x), _t(radem), 24),
           jops.sorf_project(x, radem, 24))
    for intercept in (True, False):
        assert tops.rbf_norm_constant(24, intercept) == \
            jops.rbf_norm_constant(24, intercept)
        _close(tops.rbf_feature_map(_t(x), _t(radem), _t(chi), intercept),
               jops.rbf_feature_map(x, radem, chi, intercept))
        got = tops.rbf_feature_map_grad(_t(x), _t(radem), _t(chi), 0.7,
                                        intercept)
        want = jops.rbf_feature_map_grad(x, radem, chi, 0.7, intercept)
        for g, w in zip(got, want):
            _close(g, w)
    arg = x[:, :8] * 3.0
    _close(tops.cos_sin_features(_t(arg), 0.5, 4),
           jops.cos_sin_features(arg, 0.5, 4))
    sample = np.array([3, 0, 7, 12], dtype=np.int32)
    _close(tops.srht_rows(_t(x), _t(radem[0, 0]), _t(sample).long()),
           jops.srht_rows(x, radem[0, 0], sample))


def test_layout_ops(state):
    x, _, _, _, _, _ = state
    for num_freqs, padded in ((24, 16), (16, 16), (7, 4)):
        assert list(tops.block_widths(num_freqs, padded)) == \
            list(jops.block_widths(num_freqs, padded))
        for got, want in zip(tops.freq_positions(num_freqs, padded),
                             jops.freq_positions(num_freqs, padded)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(
            np.asarray(tops.variance_column_indices(num_freqs, padded, 6)),
            np.asarray(jops.variance_column_indices(num_freqs, padded, 6)))
        c, s = x[:, :num_freqs], x[:, -num_freqs:]
        _close(tops.assemble_cos_sin(_t(c), _t(s), padded),
               jops.assemble_cos_sin(c, s, padded))


def test_conv_ops(state):
    _, _, chi, seqs, lengths, cradem = state
    assert (tops.SCALING_NONE, tops.SCALING_SQRT, tops.SCALING_FULL) == \
        (jops.SCALING_NONE, jops.SCALING_SQRT, jops.SCALING_FULL)
    chi = chi[:16]
    for scaling in (tops.SCALING_NONE, tops.SCALING_SQRT, tops.SCALING_FULL):
        _close(tops.conv_rbf_features(_t(seqs), _t(lengths), _t(cradem),
                                      _t(chi), 0.6, 3, scaling),
               jops.conv_rbf_features(seqs, lengths, cradem, chi, 0.6, 3,
                                      scaling))
    _close(tops.conv_maxpool_features(_t(seqs), _t(lengths), _t(cradem),
                                      _t(chi), 3),
           jops.conv_maxpool_features(seqs, lengths, cradem, chi, 3))


def test_ard_ops(state):
    x, radem, chi, _, _, _ = state
    w = jops.precompute_sorf_weights(radem, chi, 12)
    _close(tops.precompute_sorf_weights(_t(radem), _t(chi), 12), w)
    sig = np.array([0.3, 0.8])
    got = tops.mini_ard_grad(_t(x), _t(w), (0, 5), (5, 12), _t(sig), True)
    want = jops.mini_ard_grad(x, np.asarray(w), [0, 5], [5, 12], sig, True)
    for g, wv in zip(got, want):
        _close(g, wv)


def test_importing_the_ops_builds_nothing():
    code = (
        "import subprocess\n"
        "class Guard(subprocess.Popen):\n"
        "    def __init__(self, args, *a, **k):\n"
        "        if 'nvcc' in str(args):\n"
        "            raise AssertionError('nvcc was started')\n"
        "        super().__init__(args, *a, **k)\n"
        "subprocess.Popen = Guard\n"
        "import xgpr_tpu_torch.ops as ops\n"
        "from xgpr_tpu_torch.ops.cuda import build\n"
        "assert build._LIB is None and build.BUILD_SECONDS is None\n"
        "assert callable(ops.fwht_normalized)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
