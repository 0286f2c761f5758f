"""The scale-out knobs of xgpr_tpu_torch.config against xgpr_tpu.config's,
and the sharded path in one process: a gloo group of one (the counterpart
of chip_smoke.py's NCCL run at world size 1) must give the single
engine's bits, and a model must release its stale engine before it
builds the next.
"""
import warnings

import pytest
import torch
import torch.distributed as dist

from xgpr_tpu import config as jcfg
import xgpr_tpu_torch
from xgpr_tpu_torch import config
from xgpr_tpu_torch.fitting.engine import Engine
from xgpr_tpu_torch.parallel import ShardedEngine
from xgpr_tpu_torch.parallel.distributed import (global_host_reduce,
                                                 initialize_distributed)
from tests.torch_port import scale_out_jobs as jobs

torch.set_num_threads(1)


@pytest.fixture
def restore():
    yield
    for cfg in (config, jcfg):
        cfg.set_engine_mode("auto")
        cfg.set_m_sharding("auto", 32768)
        cfg.set_cg_mode("fused")
        cfg.set_stacked_limit(10 ** 9)


@pytest.mark.parametrize("setter,good,bad", [
    ("set_engine_mode", "sharded", "mesh"),
    ("set_m_sharding", "on", "yes"),
    ("set_cg_mode", "looped", "loop")])
def test_knobs_match_xgpr_tpu(restore, setter, good, bad):
    getter = {"set_engine_mode": "engine_mode", "set_cg_mode": "cg_mode"}
    for cfg in (config, jcfg):
        before = cfg.config_epoch()
        getattr(cfg, setter)(good)
        assert cfg.config_epoch() > before
        if setter in getter:
            assert getattr(cfg, getter[setter])() == good
        with pytest.raises(ValueError) as err:
            getattr(cfg, setter)(bad)
        assert str(err.value) == str(
            pytest.raises(ValueError, getattr(jcfg, setter), bad).value)
    before = config.config_epoch()
    config.set_stacked_limit(123)
    assert config.config_epoch() > before


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_use_m_sharding_matches_xgpr_tpu(restore, mode):
    for cfg in (config, jcfg):
        cfg.set_m_sharding(mode)
    for num_rffs in (512, 32768, 32770, 65536):
        for n_dev in (1, 2, 8):
            with warnings.catch_warnings(record=True) as ours:
                warnings.simplefilter("always")
                got = config.use_m_sharding(num_rffs, n_dev)
            with warnings.catch_warnings(record=True) as theirs:
                warnings.simplefilter("always")
                want = jcfg.use_m_sharding(num_rffs, n_dev)
            assert got == want, (num_rffs, n_dev)
            assert [str(w.message) for w in ours] == \
                [str(w.message) for w in theirs]
            assert bool(ours) == (mode == "on" and not got)
    config.set_m_sharding("auto", threshold=1024)
    assert config.use_m_sharding(1024, 2)


def test_should_shard_without_a_group(restore):
    for mode in ("auto", "single", "sharded"):
        config.set_engine_mode(mode)
        assert not config.should_shard()
    assert global_host_reduce([1.5, 2.0], ["sum", "max"]) == [1.5, 2.0]
    with pytest.raises(ValueError):
        global_host_reduce([1.0], ["min"])


@pytest.fixture
def group_of_one(restore):
    initialize_distributed(f"127.0.0.1:{jobs.free_port()}", 1, 0,
                           backend="gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_group_of_one_gives_the_single_engine_bits(group_of_one):
    """"sharded" shards over a group of one ("auto" does not), and the
    sharded CG fit, its preconditioner and SLQ then equal the single
    engine's bitwise: an all-reduce over one rank is the identity."""
    model, d = jobs.rbf_model(xgpr_tpu_torch, (0, 800), rffs=256,
                              chunk=200, device="cpu", n=800)
    assert not config.should_shard()
    single = model.fit(d, tol=1e-8, run_diagnostics=True)[0], \
        model.weights.clone(), model.approximate_nmll(jobs.HPARAMS, d)
    assert type(model._engine(d)) is Engine
    config.set_engine_mode("sharded")
    assert config.should_shard()
    sharded = model.fit(d, tol=1e-8, run_diagnostics=True)[0], \
        model.weights.clone(), model.approximate_nmll(jobs.HPARAMS, d)
    assert type(model._engine(d)) is ShardedEngine
    assert single[0] == sharded[0]
    assert torch.equal(single[1], sharded[1])
    assert single[2] == sharded[2]
    assert global_host_reduce([3.0], ["sum"]) == [3.0]


def test_stale_engine_released_first(restore, monkeypatch):
    """A knob's switch builds a new engine, and the model holds no engine
    while it does (a stacked engine pins its dataset on the device)."""
    model, d = jobs.rbf_model(xgpr_tpu_torch, (0, 400), rffs=64, chunk=100,
                              device="cpu", n=400)
    first = model._engine(d)
    assert model._engine(d) is first
    held = []
    init = Engine.__init__

    def spy(self, *args, **kwargs):
        held.append(dict(model._engines))
        init(self, *args, **kwargs)
    monkeypatch.setattr(Engine, "__init__", spy)
    config.set_cg_mode("looped")
    second = model._engine(d)
    assert second is not first and held == [{}]
    assert list(model._engines.values()) == [second]
