"""The auxiliary tools and SRHTCompressor against xgpr_tpu, both in
float64 on the CPU, same data, seeds and hyperparameters; and the port's
``diagnostics.trace``, with one of the port's spans in its file.

- SRHTCompressor: the same state bit for bit, the compressed rows to
  1e-12 relative.
- KernelFGen on RBF and Conv1dRBF: features to 1e-10 of the largest value
  (the feature maps sum in another order), the intercept column off.
- KernelPCA: components equal up to sign and explained variances to 1e-8
  relative, the transformed rows to 1e-8.
- KernelKMeans: on xgpr_tpu's own blob data the labels are identical,
  the centres within 1e-8.
"""
import os

import numpy as np
import pytest
import torch

from xgpr_tpu.kernels import SRHTCompressor as JaxSRHT
from xgpr_tpu.models.clustering import KernelKMeans as JaxKMeans
from xgpr_tpu.models.clustering import KernelPCA as JaxPCA
from xgpr_tpu.models.kernel_fgen import KernelFGen as JaxFGen
import xgpr_tpu_torch
from xgpr_tpu_torch.kernels import SRHTCompressor
from xgpr_tpu_torch.ops.cuda.ztzv import ztzv_parts
from xgpr_tpu_torch.utils import diagnostics
from tests.utils.synthetic import sequence_data, tabular_data

torch.set_num_threads(1)

SRHT_RTOL = 1e-12
FEATURE_RTOL = 1e-10
PCA_RTOL = 1e-8


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _blobs(seed=0, n_per=120, d=8):
    """xgpr_tpu's blob data (tests/auxiliary_tests/test_clustering.py)."""
    rng = np.random.default_rng(seed)
    centers = np.array([[3.0] * d, [-3.0] * d, [3.0] * (d // 2) +
                        [-3.0] * (d - d // 2)])
    xs, ys = [], []
    for k, c in enumerate(centers):
        xs.append(c + rng.standard_normal((n_per, d)))
        ys.append(np.full(n_per, k))
    idx = rng.permutation(3 * n_per)
    return np.vstack(xs)[idx], np.concatenate(ys)[idx]


@pytest.mark.parametrize("size,width", [(32, 100), (100, 256)])
def test_srht_compressor_matches_jax(size, width):
    x = np.random.default_rng(0).standard_normal((9, width))
    jc = JaxSRHT(size, width, random_seed=7)
    tc = SRHTCompressor(size, width, random_seed=7, device="cpu")
    assert np.array_equal(tc._radem_np, jc._radem_np)
    assert np.array_equal(tc._idx_np, jc._idx_np)
    got = tc.transform_x(x)
    assert got.shape == (9, size) and got.dtype == torch.float64
    _close(got.numpy(), np.asarray(jc.transform_x(x)), SRHT_RTOL)
    _close(tc.transform_x(torch.as_tensor(x)).numpy(), got.numpy(), 0.0)


def test_srht_compressor_validates_input():
    comp = SRHTCompressor(16, 64, device="cpu")
    with pytest.raises(RuntimeError):
        comp.transform_x(np.zeros((4, 32)))
    for size in (64, 1):
        with pytest.raises(RuntimeError):
            SRHTCompressor(size, 64, device="cpu")


@pytest.mark.parametrize("kernel_choice", ["RBF", "Conv1dRBF"])
def test_kernel_fgen_matches_jax(kernel_choice):
    if kernel_choice == "RBF":
        (x, _), _ = tabular_data(n_train=150, n_test=1, n_features=12)
        lens, settings, nfeat = None, None, 12
    else:
        (x, _, lens), _ = sequence_data(n_train=120, n_test=1)
        settings, nfeat = {"conv_width": 9}, 21
    h = np.array([np.log(0.3)])
    jf = JaxFGen(num_rffs=128, hyperparams=h, num_features=nfeat,
                 kernel_choice=kernel_choice, kernel_settings=settings,
                 verbose=False)
    tf = xgpr_tpu_torch.KernelFGen(num_rffs=128, hyperparams=h,
                                   num_features=nfeat,
                                   kernel_choice=kernel_choice,
                                   kernel_settings=settings, device="cpu",
                                   verbose=False)
    assert not tf.kernel.fit_intercept
    got = tf.predict(x, lens, chunk_size=50)
    assert isinstance(got, np.ndarray) and got.shape == (x.shape[0], 128)
    _close(got, jf.predict(x, lens, chunk_size=50), FEATURE_RTOL)
    np.testing.assert_array_equal(got, tf.kernel.transform_x(x, lens))


def test_auxiliary_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        xgpr_tpu_torch.KernelFGen(num_rffs=64, hyperparams=np.zeros(1),
                                  num_features=4)


def test_kernel_pca_matches_jax():
    x, _ = _blobs(seed=1)
    h = np.array([np.log(0.1)])
    jp = JaxPCA(n_components=3, num_rffs=128, hyperparams=h,
                num_features=8, verbose=False)
    tp = xgpr_tpu_torch.KernelPCA(n_components=3, num_rffs=128,
                                  hyperparams=h, num_features=8,
                                  device="cpu", verbose=False)
    jproj = jp.fit_transform(x, chunk_size=100)
    tproj = tp.fit_transform(x, chunk_size=100)
    _close(tp.explained_variance_.numpy(), np.asarray(jp.explained_variance_),
           PCA_RTOL)
    _close(tp.mean_.numpy(), np.asarray(jp.mean_), PCA_RTOL)
    tc, jc = tp.components_.numpy(), np.asarray(jp.components_)
    signs = np.sign(np.sum(tc * jc, axis=1))
    _close(tc * signs[:, None], jc, PCA_RTOL)
    _close(tproj * signs[None, :], jproj, PCA_RTOL)
    eye = tp.components_ @ tp.components_.T
    assert torch.allclose(eye, torch.eye(3, dtype=eye.dtype), atol=1e-12)


def test_kernel_kmeans_labels_match_jax():
    x, y = _blobs()
    h = np.array([np.log(0.1)])
    jk = JaxKMeans(n_clusters=3, num_rffs=256, hyperparams=h,
                   num_features=8, verbose=False).fit(x)
    tk = xgpr_tpu_torch.KernelKMeans(n_clusters=3, num_rffs=256,
                                     hyperparams=h, num_features=8,
                                     device="cpu", verbose=False).fit(x)
    np.testing.assert_array_equal(tk.labels_, np.asarray(jk.labels_))
    _close(tk.cluster_centers_.numpy(), np.asarray(jk.cluster_centers_),
           PCA_RTOL)
    labels = tk.predict(x, chunk_size=100)
    np.testing.assert_array_equal(labels, jk.predict(x))
    purity = sum(np.unique(labels[y == k], return_counts=True)[1].max()
                 for k in range(3)) / x.shape[0]
    assert purity > 0.9


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones((64, 64), dtype=torch.float64)
    v = torch.ones((32, 1), dtype=torch.float64)
    with diagnostics.trace(str(tmp_path / "t")) as prof:
        y = x @ x
        oc, _ = ztzv_parts(x, torch.ones(64, dtype=torch.float64),
                           x[:, :32], 0.1, v, v, True)
    assert prof is not None and float(y[0, 0]) == 64.0
    assert oc.shape == (32, 1)
    path = tmp_path / "t" / "trace.json"
    text = path.read_text() if path.exists() else ""
    assert "aten::mm" in text and '"xgpr/k1"' in text
