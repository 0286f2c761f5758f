"""The plain reference against the port at tiny sizes on the CPU, and
the check that decides ``correct``: sound runs pass, the control (the
reference at TF32 in the program's place) and a broken timed path fail.
The limits are the configurations' own, set from readings on the card
(PERF.md)."""
import numpy as np
import pytest
import torch

from gpbench.calibrate import ESTIMATOR_FAULTS, readings
from gpbench.harness import cell, spec
from gpbench.reference import features as ref_features
from gpbench.reference import solve as ref_solve
from xgpr_tpu_torch.kernels import KERNEL_NAME_TO_CLASS

CELLS = ("motif_1m.fit", "song.nmll", "motif_1m.predict", "song.fit")


def port_kernel(name, xdim, rffs, seed, settings, hp):
    kern = KERNEL_NAME_TO_CLASS[name](xdim, rffs, seed, "cpu", False,
                                      kernel_spec_parms=settings)
    kern.set_hyperparams(np.log(np.asarray(hp)))
    return kern


@pytest.mark.parametrize("rffs", [256, 2048])
def test_rbf_features_match_the_port(rffs):
    x = torch.randn((300, 90), dtype=torch.float64)
    kern = port_kernel("RBF", (300, 90), rffs, 987654, {}, [0.3, 0.05])
    fmap = ref_features.FeatureMap("rbf", 90, rffs, 987654)
    ref = fmap.features(x, 0.05)
    assert torch.allclose(kern.transform_x(x), ref, rtol=0, atol=1e-13)
    cols = fmap.variance_columns(64).numpy()
    assert (cols == kern.variance_column_indices(64)).all()


@pytest.mark.parametrize("rffs", [512, 4096])
def test_conv_features_match_the_port(rffs):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((200, 16, 64), generator=gen, dtype=torch.float64)
    lengths = torch.randint(9, 17, (200,), generator=gen, dtype=torch.int32)
    kern = port_kernel("Conv1dRBF", (200, 16, 64), rffs, 4242,
                       {"conv_width": 9}, [0.2, 0.02])
    fmap = ref_features.FeatureMap("conv", 64, rffs, 4242, width=9)
    ref = fmap.features(x, 0.02, lengths)
    assert torch.allclose(kern.transform_x(x, lengths), ref, rtol=0,
                          atol=1e-12)
    cols = fmap.variance_columns(512).numpy()
    assert (cols == kern.variance_column_indices(512)).all()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -9])
    out = ref_features.tf32(t)
    assert out.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                            -3.0 - 2 ** -9]


def test_exact_nmll_matches_the_ports():
    from xgpr_tpu_torch import GPRegression, build_regression_dataset
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1500, 12), generator=gen, dtype=torch.float64)
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn((1500,), generator=gen,
                                               dtype=torch.float64)
    ds = build_regression_dataset(x.numpy(), y.numpy(), chunk_size=500)
    model = GPRegression(num_rffs=256, kernel_choice="RBF", device="cpu",
                         verbose=False, random_seed=31)
    point = np.log(np.array([0.3, 0.4]))
    yn = (y - y.mean()) / y.std(unbiased=False)
    fmap = ref_features.FeatureMap("rbf", 12, 256, 31)
    g, zty, yty = ref_solve.gram(fmap, x, yn, 0.4)
    ours = ref_solve.exact_nmll(g, zty, yty, 0.3, 1500)
    assert ours == pytest.approx(model.exact_nmll(point, ds), rel=1e-10)


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_of_each_cell_is_correct(name, tiny_root):
    """The whole run but the device check and the device's report, on
    the CPU in float64: the program and the reference agree to the
    solver's tolerance."""
    res = cell.run(name, 2 ** 31 + 17, 0.2, False, device="cpu",
                   root=tiny_root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    c = spec.Cell(name, root=tiny_root)
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    for key, number in res["checks"].items():
        assert number["value"] <= number["limit"]
        # The exact NMLL's gap is the estimator's own error, not the
        # solver's: its limit is its own.
        if key not in ("failed_ops", "nmll_exact_gap"):
            assert number["value"] < 1e-4, key


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name, tiny_root):
    """The control, the reference computed at TF32 in the program's
    place (TF32 features and TF32 products in the Gram), fails one of the
    cell's limits at least, where the program passes all of them.  The
    limits were set at the cells' own sizes on the card; the control's
    readings there are in PERF.md."""
    c = spec.Cell(name, root=tiny_root)
    limits = c.limits()
    got = readings(name, 123457, True, device="cpu", root=tiny_root)
    assert got["failed"] == 0
    assert all(got["program"][k] <= limits[k] for k in got["program"]), got
    assert any(got["control"][k] > limits[k] for k in got["control"]), got


def test_the_estimator_faults_fail_the_exact_nmll(tiny_root):
    """The reference's SLQ estimate, with each fault that a copy of the
    port's estimator would share planted in it, put in the program's
    place: the gap to the exact NMLL fails its limit, where the gap to
    the SLQ copy could not see a fault the copy shares."""
    limit = spec.Cell("song.nmll", root=tiny_root).limits()["nmll_exact_gap"]
    got = readings("song.nmll", 2 ** 31 + 77, False, device="cpu",
                   root=tiny_root, faults=True)
    assert got["program"]["nmll_exact_gap"] <= limit, got
    assert set(got["faults"]) == set(ESTIMATOR_FAULTS)
    for name, numbers in got["faults"].items():
        assert numbers["nmll_exact_gap"] > limit, (name, got)
