"""The precision knobs and speed presets, and the bf16 ("default") plain
paths, against xgpr_tpu.

- The knobs of ``xgpr_tpu_torch.config`` against ``xgpr_tpu.config``: the
  same names, values, defaults, errors and preset landings; a float64
  working dtype (the CPU's default, xgpr_tpu's x64) ignores them.
- K1, K3 and K4's plain versions at "default" against xgpr_tpu's
  explicit-bf16 XLA functions under fast features, in float32 (xgpr_tpu
  inside ``jax.enable_x64(False)``, the port inside
  ``config.working_dtype(torch.float32)``).  xgpr_tpu's Pallas bodies in
  interpret mode cannot be the reference: the CPU computes their DEFAULT
  dots at full precision.  Both sides round the same operands to bf16 and
  multiply them exactly in fp32; the sums run in other orders, so the
  agreement is to a few fp32 ulps of the largest term, held at
  1e-5 * max|ref| for features and window sums and 1e-4 * max|ref| for
  the matvec, whose zv can round to the neighbouring bf16 value on one
  side (a ~2^-8 step of one row's term).
  K1 rounds raw x and multiplies the product by sigma (the Pallas body),
  where xgpr_tpu's XLA twin rounds x * sigma.  With sigma a power of two
  the two are the same bits, and so they are when the port is handed
  x * sigma and sigma 1; with raw x and a general sigma each phase moves
  by up to 2^-8 of sum_d |x_d proj_d| sigma, and the matvec is held to
  PHASE_RTOL * max|ref| (below).  K3 and K4 round raw x in both packages.
- ``ops/contract.py``'s bf16 contractions against xgpr_tpu.ops.contract's:
  float32 out, 1e-5 * max|ref|.
- The slice under "max": an RBF CG fit in float32 against the same fit in
  "balanced" within xgpr_tpu's own gates (tests/numerics_tests/
  test_fast_features.py: |d Spearman| < 0.02, exact NMLL within 1e-3
  relative), and against xgpr_tpu's "max" fit (PREDICT_RTOL below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgpr_tpu import GPRegression as JaxGPRegression
from xgpr_tpu import build_regression_dataset as jax_dataset
from xgpr_tpu import config as jax_config
from xgpr_tpu.ops import contract as jax_contract
from xgpr_tpu.ops.conv import conv_maxpool_features as jax_maxpool
from xgpr_tpu.ops.conv import conv_rbf_features as jax_conv_features
from xgpr_tpu.ops.sorf import rbf_feature_parts_dense as jax_parts_dense
from xgpr_tpu_torch import GPRegression, build_regression_dataset, config
from xgpr_tpu_torch.ops import contract
from xgpr_tpu_torch.ops import conv as tconv
from xgpr_tpu_torch.ops import sorf as tsorf
from xgpr_tpu_torch.ops.cuda import conv, feature_map, ztzv
from tests.utils.synthetic import spearman, tabular_data

torch.set_num_threads(1)

# The matvec under a general sigma: each phase moves by up to 2^-8 of
# sum_d |x_d proj_d| sigma (below 1 rad at these inputs), so each c, s by
# up to 2^-8 * scale, and oc, os by up to 2^-8 of the sums of |c zv|;
# 4 * 2^-8 of max|ref| leaves room for those sums' excess over max|ref|.
# It does not tell rounded operands from unrounded ones (those differ by
# ~2^-8 as well), so the rounding is held at ROUND_RTOL where both sides
# round the same operands.
PHASE_RTOL = 4 * 2.0 ** -8
ROUND_RTOL = 1e-4


def _state():
    return (jax_config.matmul_precision(), jax_config._FEATURE_PRECISION,
            jax_config._FEATURE_DTYPE, jax_config._FAST_FEATURES,
            jax_config.sincos_mode(), config.matmul_precision(),
            config._FEATURE_PRECISION, config._FEATURE_DTYPE,
            config._FAST_FEATURES, config._SINCOS_MODE)


def _restore(s):
    jax_config.set_matmul_precision(s[0])
    jax_config.set_feature_precision(s[1])
    jax_config.set_fast_features(s[3])
    jax_config.set_feature_dtype(s[2])
    jax_config.set_sincos_mode(s[4])
    config.set_matmul_precision(s[5])
    config.set_feature_precision(s[6])
    config.set_fast_features(s[8])
    config.set_feature_dtype(s[7])
    config.set_sincos_mode(s[9])


@pytest.fixture
def knobs():
    """Every knob of both packages, restored after the test."""
    saved = _state()
    try:
        yield
    finally:
        _restore(saved)


@pytest.fixture
def fp32(knobs):
    """Both packages in float32, every knob restored after."""
    with jax.enable_x64(False), config.working_dtype(torch.float32):
        yield


def _both(name, *args):
    getattr(jax_config, name)(*args)
    getattr(config, name)(*args)


def _read_jax():
    return {"matmul_precision": jax_config.matmul_precision(),
            "feature_precision": jax_config.feature_precision(),
            "feature_matmul_precision": jax_config.feature_matmul_precision(),
            "feature_dtype": None if jax_config.feature_dtype() is None
            else "bfloat16",
            "sincos_mode": jax_config.sincos_mode().replace("auto", "hi")}


def _read_port(device="cpu"):
    return {"matmul_precision": config.matmul_precision(),
            "feature_precision": config.feature_precision(device),
            "feature_matmul_precision":
                config.feature_matmul_precision(device),
            "feature_dtype": None if config.feature_dtype(device) is None
            else "bfloat16",
            "sincos_mode": config.sincos_mode()}


def test_defaults_match_xgpr_tpu(fp32):
    assert _read_port() == _read_jax() == {
        "matmul_precision": "highest", "feature_precision": "high",
        "feature_matmul_precision": "high", "feature_dtype": None,
        "sincos_mode": "hi"}


@pytest.mark.parametrize("setter,values,bad", [
    ("set_matmul_precision", ("highest", "high", "default"), "fast"),
    ("set_feature_precision", ("highest", "high", "default"), "bf16"),
    ("set_feature_dtype", ("float32", "bfloat16"), "float16"),
])
def test_setters_take_the_same_values_and_errors(fp32, setter, values, bad):
    for value in values:
        _both(setter, value)
        assert _read_port() == _read_jax()
    errors = []
    for pkg in (jax_config, config):
        with pytest.raises(ValueError) as err:
            getattr(pkg, setter)(bad)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("enabled", [True, False])
def test_fast_features_match_xgpr_tpu(fp32, enabled):
    _both("set_fast_features", enabled)
    assert _read_port() == _read_jax()
    assert (config.feature_matmul_precision("cpu") == "default") == enabled


@pytest.mark.parametrize("preset", ["reference", "balanced", "max"])
def test_presets_land_on_the_same_knobs(fp32, preset):
    _both("set_speed_preset", "max")       # start away from the preset
    _both("set_speed_preset", preset)
    assert _read_port() == _read_jax()
    assert sorted(config._SPEED_PRESETS) == sorted(jax_config._SPEED_PRESETS)
    assert config._SPEED_PRESETS[preset] == jax_config._SPEED_PRESETS[preset]


def test_unknown_preset_raises_the_same_error(knobs):
    errors = []
    for pkg in (jax_config, config):
        with pytest.raises(ValueError) as err:
            pkg.set_speed_preset("warp9")
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("preset", ["reference", "max"])
def test_float64_ignores_the_knobs(knobs, preset):
    """In float64 (the port's CPU default, xgpr_tpu's x64 runs) the
    feature precision reads "highest" and features keep their dtype."""
    _both("set_speed_preset", preset)
    assert jax_config.x64_enabled()
    for read in (_read_jax(), _read_port()):
        assert read["feature_precision"] == "highest"
        assert read["feature_matmul_precision"] == "highest"
        assert read["feature_dtype"] is None
    assert config.feature_matmul_precision("cuda") == (
        "default" if preset == "max" else "highest")


def test_kernel_precision_flags(knobs):
    """The flag K3's C entry point takes for each float32 precision: the
    body the precision runs (3xTF32, fp32 FMAs, bf16)."""
    flags = {p: feature_map.BODY_FLAGS[feature_map.kernel_body(
                 "K3", torch.float32, p)]
             for p in ("high", "highest", "default")}
    assert flags == {"high": 0, "highest": 1, "default": 2}
    for bad in ("bf16", "tf32", "auto"):
        with pytest.raises(ValueError):
            feature_map.kernel_body("K3", torch.float32, bad)
    assert feature_map.kernel_precision(None, "cpu") == "highest"
    config.set_speed_preset("max")
    assert feature_map.kernel_precision(None, "cuda") == "default"
    assert feature_map.kernel_precision(None, "cpu") == "highest"


# ----------------------------------------------------------------------
# The plain "default" versions against xgpr_tpu's explicit-bf16 paths.
def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _dense(seed, n=512, d=8, f=256, k=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    proj = (rng.standard_normal((d, f)) * 0.6).astype(np.float32)
    m = (rng.random(n) > 0.2).astype(np.float32)
    vc = rng.standard_normal((f, k)).astype(np.float32)
    vs = rng.standard_normal((f, k)).astype(np.float32)
    return x, proj, m, vc, vs


def _jax_ztzv(x, proj, m, vc, vs, sigma, intercept):
    """xgpr_tpu's XLA matvec (fitting/fused_cg.py: parts_fn and
    _parts_contract) on one masked chunk."""
    c, s = jax_parts_dense(jnp.asarray(x * np.float32(sigma)),
                           jnp.asarray(proj), intercept)
    m = jnp.asarray(m)[:, None]
    return jax_contract.parts_contract(c * m, s * m, jnp.asarray(vc),
                                       jnp.asarray(vs))


@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("sigma", [0.25, 0.5, 0.3, 0.7])
def test_ztzv_plain_default_matches_xgpr_tpu(fp32, intercept, sigma):
    """Handed x * sigma and sigma 1, or raw x with sigma a power of two,
    the port rounds the operands xgpr_tpu's twin rounds (ROUND_RTOL); raw
    x with a general sigma rounds at K1's point (PHASE_RTOL)."""
    _both("set_speed_preset", "max")
    x, proj, m, vc, vs = _dense(int(sigma * 10))
    want = _jax_ztzv(x, proj, m, vc, vs, sigma, intercept)
    raw_rtol = ROUND_RTOL if np.log2(sigma).is_integer() else PHASE_RTOL
    for xs, sig, rtol in ((x, sigma, raw_rtol),
                          (x * np.float32(sigma), 1.0, ROUND_RTOL)):
        got = ztzv.ztzv_parts(_t(xs), _t(m), _t(proj), sig, _t(vc), _t(vs),
                              intercept)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            _close(g, w, rtol)


def test_ztzv_plain_default_rounds_what_the_tpu_rounds(knobs):
    """"default" moves the matvec by bf16 rounding (~2^-8), far more than
    the 3xTF32 / fp32 bodies differ; "highest" and "high" are the same
    plain product."""
    x, proj, m, vc, vs = (_t(a) for a in _dense(1))
    with config.working_dtype(torch.float32):
        out = {p: ztzv.ztzv_parts_plain(x, m, proj, 0.5, vc, vs, True,
                                        "hi", p)[0]
               for p in ("highest", "high", "default")}
    assert torch.equal(out["highest"], out["high"])
    rel = float((out["default"] - out["high"]).abs().max()
                / out["high"].abs().max())
    assert ROUND_RTOL < rel < PHASE_RTOL


def _seqs(seed, n=64, l=16, d=8, width=3, f=256):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, l, d)) * 0.5).astype(np.float32)
    lengths = rng.integers(width, l + 1, size=n).astype(np.int32)
    proj = (rng.standard_normal((width * d, f)) * 0.5).astype(np.float32)
    return x, lengths, proj


@pytest.mark.parametrize("scaling", [0, 2])
@pytest.mark.parametrize("sigma", [0.5, 0.7])
def test_conv_parts_plain_default_matches_xgpr_tpu(fp32, scaling, sigma):
    _both("set_speed_preset", "max")
    x, lengths, proj = _seqs(scaling + 3)
    f = proj.shape[1]
    radem = jnp.zeros((3, 1, 32), jnp.float32)
    chi = jnp.zeros((f,), jnp.float32)
    want = jax_conv_features(jnp.asarray(x), jnp.asarray(lengths), radem,
                             chi, sigma, 3, scaling, proj=jnp.asarray(proj),
                             parts=True)
    got = tconv.conv_rbf_features(_t(x), _t(lengths), None,
                                  torch.zeros(f), sigma, 3, scaling,
                                  proj=_t(proj), parts=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5)


def test_conv_maxpool_plain_default_matches_xgpr_tpu(fp32):
    _both("set_speed_preset", "max")
    x, lengths, proj = _seqs(7, f=200)
    want = jax_maxpool(jnp.asarray(x), jnp.asarray(lengths),
                       jnp.zeros((3, 1, 32), jnp.float32),
                       jnp.zeros((200,), jnp.float32), 3,
                       proj=jnp.asarray(proj))
    got = conv.conv_maxpool(_t(x), _t(lengths), _t(proj), 3)
    _close(got, want, 1e-5)
    full = conv.conv_maxpool_plain(_t(x), _t(lengths), _t(proj), 3, "high")
    assert float((got - full).abs().max()) > 1e-4


def test_conv_gradient_projection_follows_the_precision(fp32):
    """The exact-gradient feature map's dense projection rounds to bf16
    under "default", as xgpr_tpu's _conv_project does."""
    _both("set_speed_preset", "max")
    x, lengths, proj = _seqs(11, f=128)
    radem = np.zeros((3, 1, 32), np.float32)
    want = jax_conv_features(jnp.asarray(x), jnp.asarray(lengths),
                             jnp.asarray(radem), jnp.zeros((128,)), 0.6, 3,
                             1, with_grad=True, proj=jnp.asarray(proj))
    got = tconv.conv_rbf_features(_t(x), _t(lengths), _t(radem),
                                  torch.zeros(128), 0.6, 3, 1,
                                  proj=_t(proj), with_grad=True)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("intercept", [True, False])
def test_rbf_xla_twins_follow_the_precision(fp32, intercept):
    _both("set_speed_preset", "max")
    x, proj, *_ = _dense(5, n=200, f=96)
    want = jax_parts_dense(jnp.asarray(x * 0.3), jnp.asarray(proj),
                           intercept)
    got = tsorf.rbf_feature_parts_dense(_t(x * 0.3), _t(proj), intercept)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


# ----------------------------------------------------------------------
# ops/contract.py's bf16 branches.
def test_bf16_contractions_match_xgpr_tpu(fp32):
    _both("set_fast_features", True)
    rng = np.random.default_rng(2)
    z = (rng.standard_normal((300, 96)) * 0.2).astype(np.float32)
    c, s = z[:, :48], z[:, 48:]
    v = rng.standard_normal((96, 4)).astype(np.float32)
    got = contract.ztzv_contract(_t(z), _t(v))
    assert got.dtype == torch.float32
    _close(got, jax_contract.ztzv_contract(jnp.asarray(z), jnp.asarray(v)),
           1e-5)
    got = contract.parts_contract(_t(c), _t(s), _t(v[:48]), _t(v[48:]))
    want = jax_contract.parts_contract(jnp.asarray(c), jnp.asarray(s),
                                       jnp.asarray(v[:48]),
                                       jnp.asarray(v[48:]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5)
    # Without bf16 materialisation the contraction is the fp32 product.
    config.set_feature_dtype("float32")
    full = contract.parts_contract(_t(c), _t(s), _t(v[:48]), _t(v[48:]))
    assert float((full[0] - got[0]).abs().max()) > 1e-5


def test_bf16_mm_never_rounds_its_output(knobs):
    rng = np.random.default_rng(4)
    a = _t(rng.standard_normal((64, 33)).astype(np.float32))
    b = _t(rng.standard_normal((33, 7)).astype(np.float32))
    out = contract.bf16_mm(a, b)
    exact = contract.as_bf16(a).double() @ contract.as_bf16(b).double()
    assert out.dtype == torch.float32
    assert float((out.double() - exact).abs().max()) < 1e-5
    assert not torch.equal(out, contract.as_bf16(out))


# ----------------------------------------------------------------------
# The slice under "max".
HP = np.array([-1.7908995, -3.9549678])
# Port "max" against xgpr_tpu "max": the port projects K1's raw x and
# K2's sigma-scaled x as the TPU kernels do (K2 at full precision), where
# xgpr_tpu's CPU path rounds x * sigma to bf16 everywhere, so the two fits
# solve slightly different random-feature models; predictions are held to
# 2% of max|pred|.
PREDICT_RTOL = 0.02


def _fit(pkg_model, pkg_dataset, data, with_nmll=True, **kw):
    (trx, tr_y), (tex, _) = data
    ds = pkg_dataset(trx, tr_y, chunk_size=300)
    model = pkg_model(num_rffs=1024, kernel_choice="RBF", verbose=False,
                      **kw)
    nmll = float(model.exact_nmll(HP, ds)) if with_nmll else None
    model.set_hyperparams(HP, ds)
    pre, _ = model.build_preconditioner(ds, max_rank=128, method="srht")
    model.fit(ds, preconditioner=pre, mode="cg", tol=1e-5,
              suppress_var=True)
    return np.asarray(model.predict(tex), np.float64), nmll


@pytest.fixture(scope="module")
def slice_data():
    return tabular_data(n_train=1200)


def test_max_preset_fit_is_within_xgpr_tpus_gates(fp32, slice_data):
    te_y = slice_data[1][1]
    runs = {}
    for preset in ("balanced", "max"):
        config.set_speed_preset(preset)
        runs[preset] = _fit(GPRegression, build_regression_dataset,
                            slice_data, device="cpu")
    (p_bal, n_bal), (p_max, n_max) = runs["balanced"], runs["max"]
    assert abs(spearman(p_max, te_y) - spearman(p_bal, te_y)) < 0.02
    assert abs(n_max - n_bal) / abs(n_bal) < 1e-3
    assert not np.array_equal(p_max, p_bal)

    jax_config.set_speed_preset("max")
    p_jax, _ = _fit(JaxGPRegression, jax_dataset, slice_data,
                    with_nmll=False)
    assert np.abs(p_max - p_jax).max() < PREDICT_RTOL * np.abs(p_jax).max()
    assert abs(spearman(p_max, te_y) - spearman(p_jax, te_y)) < 0.02


def test_streamed_fit_under_max_equals_stacked(fp32):
    """A Conv1dRBF CG fit under "max" contracts the same K3 parts in
    bfloat16 chunk by chunk whether the dataset is stacked or streamed:
    the weights are the same bits."""
    from tests.utils.synthetic import sequence_data
    config.set_speed_preset("max")
    (x, y, lengths), _ = sequence_data(n_train=300, n_test=10)
    weights = []
    limit = config.stacked_element_limit()
    for stacked_limit in (limit, 1):
        config.set_stacked_limit(stacked_limit)
        try:
            ds = build_regression_dataset(x, y, lengths, chunk_size=128)
            model = GPRegression(num_rffs=128, kernel_choice="Conv1dRBF",
                                 kernel_settings={"conv_width": 9},
                                 device="cpu", verbose=False)
            model.set_hyperparams(np.log(np.array([0.3, 0.05])), ds)
            pre, _ = model.build_preconditioner(ds, max_rank=32)
            model.fit(ds, preconditioner=pre, mode="cg", tol=1e-6,
                      suppress_var=True)
            assert model._engine(ds).mode == (
                "streaming" if stacked_limit == 1 else "stacked")
        finally:
            config.set_stacked_limit(limit)
        weights.append(model.weights)
    assert weights[0].dtype == torch.float32
    assert torch.equal(weights[0], weights[1])
