"""Slice D2 on the card: MiniARD, KernelFGen, KernelPCA, KernelKMeans and
the exported predict functions against their plain versions.

Needs a CUDA device and nvcc; skips without them.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_cuda_auxiliary.py

- A MiniARD whose lengthscales all equal an RBF's sigma gives the RBF's
  K2 features bit for bit (same draws, same projection, same call).
- MiniARD's and KernelFGen's features (K2, or K3 for Conv1dRBF) agree
  with the plain feature maps on the same float32 inputs to 1e-5
  absolute (chip_smoke.py's FEATURE_ATOL).
- An exported fn agrees with its model's predict to 1e-6 x max|pred|.
- A CUDA tensor never takes a plain path: with the plain versions made
  to raise, every new path still runs (and launches its kernel), and a
  float64 CUDA tensor raises instead of falling back.
"""
import numpy as np
import pytest
import torch

from xgpr_tpu_torch import (GPClassification, GPRegression, KernelFGen,
                            KernelKMeans, KernelPCA,
                            build_classification_dataset,
                            build_regression_dataset)
from xgpr_tpu_torch.kernels import RBF, MiniARD
from xgpr_tpu_torch.ops.conv import conv_row_scale
from xgpr_tpu_torch.ops.cuda import conv, feature_map
from xgpr_tpu_torch.ops.layout import assemble_cos_sin
from tests.utils.synthetic import (classification_data, sequence_data,
                                   tabular_data)

pytestmark = pytest.mark.cuda

FEATURE_ATOL = 1e-5
EXPORT_RTOL = 1e-6
HPARAMS = np.array([-1.7908995, -3.9549678])
SPLIT = {"split_points": [40]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tab(n=2048, d=84):
    (x, _), _ = tabular_data(n_train=n, n_test=1, n_features=d)
    return x


@pytest.mark.parametrize("num_rffs", [1024, 8192])
def test_mini_ard_equals_rbf_bitwise(cuda, num_rffs):
    x = torch.as_tensor(_tab(), dtype=torch.float32, device=cuda)
    rbf = RBF(tuple(x.shape), num_rffs, device=cuda)
    rbf.set_hyperparams(HPARAMS)
    ard = MiniARD(tuple(x.shape), num_rffs, device=cuda,
                  kernel_spec_parms=SPLIT)
    ard.set_hyperparams(np.array([HPARAMS[0], HPARAMS[1], HPARAMS[1]]))
    before = feature_map.LAUNCHES.total()
    assert torch.equal(ard.transform_x(x), rbf.transform_x(x))
    assert feature_map.LAUNCHES.total() == before + 2


@pytest.mark.parametrize("intercept", [True, False])
def test_mini_ard_features_match_plain(cuda, intercept):
    x = torch.as_tensor(_tab(), dtype=torch.float32, device=cuda)
    ard = MiniARD(tuple(x.shape), 2048, device=cuda,
                  kernel_spec_parms=dict(SPLIT, intercept=intercept))
    ard.set_hyperparams(np.array([-1.0, -4.2, -3.5]))
    got = ard.transform_x(x)
    params = ard.feature_params()
    want = feature_map.rbf_feature_map_plain(
        x * params["ard_weights"], params["proj"], intercept,
        ard.padded_dims)
    if intercept:
        want[:, 0] = 1.0
    assert float((got - want).abs().max()) < FEATURE_ATOL


@pytest.mark.parametrize("kernel_choice", ["RBF", "Conv1dRBF"])
def test_kernel_fgen_matches_plain(cuda, kernel_choice):
    if kernel_choice == "RBF":
        x, lens, settings, nfeat = _tab(), None, None, 84
    else:
        (x, _, lens), _ = sequence_data(n_train=1024, n_test=1)
        settings, nfeat = {"conv_width": 9}, 21
    fgen = KernelFGen(num_rffs=2048, hyperparams=HPARAMS[1:],
                      num_features=nfeat, kernel_choice=kernel_choice,
                      kernel_settings=settings, device=cuda, verbose=False)
    got = fgen.predict(x, lens, chunk_size=512)
    kern, params = fgen.kernel, fgen.kernel.feature_params()
    xs = kern._cast_input(x)
    if lens is None:
        want = feature_map.rbf_feature_map_plain(
            xs * params["sigma"], params["proj"], False, kern.padded_dims)
    else:
        ls = kern._cast_lengths(lens)
        scale = conv_row_scale(ls, kern.conv_width, kern.num_freqs,
                               kern.scaling_type, kern.dtype, kern.device)
        c, s = conv.conv_parts_plain(xs, ls, params["proj"],
                                     params["sigma"], kern.conv_width, scale)
        want = assemble_cos_sin(c, s, kern.padded_dims)
    assert np.abs(got - want.cpu().numpy()).max() < FEATURE_ATOL


def _close(got, want):
    assert np.abs(np.asarray(got) - want).max() < \
        EXPORT_RTOL * np.abs(want).max()


def test_exported_fns_match_predict(cuda):
    (trx, tr_y), (tex, _) = tabular_data(n_train=8192, n_test=2048)
    dset = build_regression_dataset(trx, tr_y, chunk_size=4096)
    model = GPRegression(num_rffs=2048, variance_rffs=64, device=cuda,
                         verbose=False)
    model.set_hyperparams(HPARAMS, dset)
    model.fit(dset, mode="cg")
    fn, state = model.export_predict_fn(get_var=True)
    mean, var = fn(state, torch.as_tensor(tex, dtype=torch.float32,
                                          device=cuda))
    p_ref, v_ref = model.predict(tex, get_var=True)
    _close(mean.cpu(), p_ref)
    _close(var.cpu(), v_ref)

    (cx, cy), (ctex, _) = classification_data(n_train=4096, n_test=1024,
                                              n_features=84, n_classes=5)
    cset = build_classification_dataset(cx, cy, chunk_size=4096)
    clf = GPClassification(num_rffs=1024, device=cuda, verbose=False)
    clf.set_hyperparams(np.log(np.array([0.3, 0.03])), cset)
    clf.fit(cset, max_iter=20)
    fn, state = clf.export_predict_fn()
    _close(fn(state, torch.as_tensor(ctex, dtype=torch.float32,
                                     device=cuda)).cpu(), clf.predict(ctex))


def test_cuda_tensors_take_no_plain_path(cuda, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(feature_map, "rbf_feature_map_plain", refuse)
    monkeypatch.setattr(conv, "conv_parts_plain", refuse)
    x = _tab(1024)
    before = feature_map.LAUNCHES.total()
    ard = MiniARD(x.shape, 512, device=cuda, kernel_spec_parms=SPLIT)
    ard.set_hyperparams(np.array([0.0, -2.0, -3.0]))
    ard.transform_x(x)
    KernelFGen(num_rffs=512, hyperparams=HPARAMS[1:], num_features=84,
               device=cuda, verbose=False).predict(x)
    KernelPCA(n_components=2, num_rffs=256, hyperparams=HPARAMS[1:],
              num_features=84, device=cuda, verbose=False).fit(x)
    KernelKMeans(n_clusters=3, num_rffs=256, hyperparams=HPARAMS[1:],
                 num_features=84, device=cuda, verbose=False).fit(x)
    assert feature_map.LAUNCHES.total() >= before + 4
    (sx, _, sl), _ = sequence_data(n_train=256, n_test=1)
    before = conv.PARTS_LAUNCHES.total()
    KernelFGen(num_rffs=256, hyperparams=HPARAMS[1:], num_features=21,
               kernel_choice="Conv1dRBF", kernel_settings={"conv_width": 9},
               device=cuda, verbose=False).predict(sx, sl)
    assert conv.PARTS_LAUNCHES.total() > before
    fn = ard.pure_feature_fn()
    params = {k: v.double() for k, v in ard.feature_params().items()}
    with pytest.raises(TypeError):
        fn(params, torch.as_tensor(x, device=cuda))
