"""Rank-side jobs of the port's scale-out tests, and the launcher that runs
one over a gloo group of processes.

    python -m tests.torch_port.scale_out_jobs JOB RANK WORLD PORT OUT [DEVICE]

runs the job ``JOB`` (a function in ``JOBS``) as rank RANK of a
WORLD-process gloo group at tcp://127.0.0.1:PORT, on DEVICE ("cpu", or
"cuda": every rank on card 0, as two ranks share one card), and pickles
its result (a dict of numpy arrays and numbers) to OUT.  ``run_job``
starts the ranks, waits for them within a timeout and returns each
rank's dict; it fails if the timeout is hit.  ``shared_job`` runs a job
once per test session: pytest-xdist's workers share its result.  Each rank builds only its
own rows, with y already standardised over the whole set and
``normalize_y=False`` (the port's multi-process contract); the test that
calls a job builds the whole set with the same functions below for the
one-process reference.  Imports no jax.
"""
import fcntl
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tests.utils.synthetic import (classification_data, sequence_data,
                                   tabular_data)

ROOT = Path(__file__).resolve().parents[2]
HPARAMS = np.array([-1.7908995, -3.9549678])
CONV_HPARAMS = np.array([-1.0, -1.5])
ARD_HPARAMS = np.array([-1.0, -3.0, -2.5])
CLASS_HPARAMS = np.log(np.array([0.3, 0.2]))
JOIN_TIMEOUT = 120


# ----------------------------------------------------------------------
# the data, whole and split
def standardised(y):
    return (y - y.mean()) / y.std()


def rbf_data(n=1600):
    (x, y), _ = tabular_data(n_train=n)
    return x, standardised(y)


def conv_data(n=320):
    (x, y, lengths), _ = sequence_data(n_train=n)
    return x, standardised(y), lengths


def ard_data(n=800):
    (x, y), _ = tabular_data(n_train=n)
    return x, standardised(y)


def class_data(n=900):
    (x, y), _ = classification_data(n_train=n)
    return x, y


def split(n, rank, world, cuts=None):
    """Rows [lo, hi) of rank: equal contiguous blocks, or the blocks
    between ``cuts`` (world + 1 row indices)."""
    if cuts is None:
        cuts = [n * r // world for r in range(world + 1)]
    return cuts[rank], cuts[rank + 1]


def trim(x, lengths):
    """x cut to its own longest sequence: a rank's ragged local corpus."""
    return x[:, :int(lengths.max())]


def to_numpy(value):
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    if isinstance(value, (tuple, list)):
        return [to_numpy(v) for v in value]
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    return value


def _regression_model(pkg, x, y, lengths, kernel, rffs, hparams, chunk,
                      settings=None, **kw):
    d = pkg.build_regression_dataset(x, y, lengths, chunk_size=chunk,
                                     normalize_y=False)
    model = pkg.GPRegression(num_rffs=rffs, kernel_choice=kernel,
                             kernel_settings=settings, verbose=False,
                             **kw)
    model.set_hyperparams(hparams, d)
    return model, d


def rbf_model(pkg, rows, rffs=512, chunk=200, device=None, n=1600):
    x, y = rbf_data(n)
    kw = {} if device is None else {"device": device}
    return _regression_model(pkg, x[rows[0]:rows[1]], y[rows[0]:rows[1]],
                             None, "RBF", rffs, HPARAMS, chunk, **kw)


def conv_model(pkg, rows, rffs=128, chunk=40, device=None, ragged=False):
    x, y, lengths = conv_data()
    x, y, lengths = (a[rows[0]:rows[1]] for a in (x, y, lengths))
    if ragged:
        x = trim(x, lengths)
    kw = {} if device is None else {"device": device}
    return _regression_model(pkg, x, y, lengths, "Conv1dRBF", rffs,
                             CONV_HPARAMS, chunk, settings={"conv_width": 9},
                             **kw)


def ard_model(pkg, rows, device=None):
    x, y = ard_data()
    kw = {} if device is None else {"device": device}
    return _regression_model(pkg, x[rows[0]:rows[1]], y[rows[0]:rows[1]],
                             None, "MiniARD", 256, ARD_HPARAMS, 100,
                             settings={"split_points": [40]}, **kw)


def class_model(pkg, rows, device=None):
    x, y = class_data()
    d = pkg.build_classification_dataset(x[rows[0]:rows[1]],
                                         y[rows[0]:rows[1]], chunk_size=150)
    kw = {} if device is None else {"device": device}
    model = pkg.GPClassification(num_rffs=256, kernel_choice="RBF",
                                 verbose=False, **kw)
    model.set_hyperparams(CLASS_HPARAMS, d)
    return model, d


def probe_vectors(m, k, seed):
    return np.random.default_rng(seed).standard_normal((m, k))


def class_directions(m, c):
    rng = np.random.default_rng(11)
    return rng.standard_normal((m, c)) * 0.1, rng.standard_normal((m, c))


LINESEARCH_STEPS = np.array([0.0, 0.25, 0.5, 1.0, 2.0])


# ----------------------------------------------------------------------
# jobs: each returns a dict for its rank
def job_reductions(rank, world, device):
    """Every ShardedEngine reduction (RBF; ztzv and design_mat for a
    Conv1dRBF and a MiniARD kernel; the classifier's two), a preconditioned
    CG fit, global_host_reduce and the engine selection."""
    import xgpr_tpu_torch as xt
    from xgpr_tpu_torch import config
    from xgpr_tpu_torch.fitting.cg import cg_fit
    from xgpr_tpu_torch.parallel import ShardedEngine
    from xgpr_tpu_torch.parallel.distributed import global_host_reduce
    from xgpr_tpu_torch.preconditioners.nystrom import NystromPreconditioner
    from xgpr_tpu_torch.utils.rng import srht_state
    out = {}
    model, d = rbf_model(xt, split(1600, rank, world), device=device)
    eng = ShardedEngine(model.kernel, d)
    radem, idx = srht_state(42, 512, 128, np.float64)
    q = torch.linalg.qr(torch.as_tensor(probe_vectors(512, 16, 4)))[0]
    out.update(
        ndatapoints=eng.ndatapoints,
        ztzv=eng.ztzv(probe_vectors(512, 3, 0)),
        gauss_pass=eng.gauss_pass(q),
        design_mat=eng.design_mat(), zty=eng.zty(),
        var_design_mat=eng.var_design_mat(64),
        sketch=eng.sketch(radem, idx, with_zty=True),
        sketch_sub=eng.sketch(radem, idx, with_zty=False,
                              row_keep_prob=0.5, seed=7),
        gradient_terms=eng.gradient_terms(),
        gradient_terms_sub=eng.gradient_terms(subsample=0.5, seed=5))
    precond = NystromPreconditioner(eng, 128, random_state=123,
                                    method="srht")
    w, n_iter, _ = cg_fit(eng, precond, tol=1e-7, verbose=False)
    out.update(cg_weights=w, cg_iter=n_iter)

    cm, cd = conv_model(xt, split(320, rank, world), device=device)
    ce = ShardedEngine(cm.kernel, cd)
    out.update(conv_ztzv=ce.ztzv(probe_vectors(128, 2, 5)),
               conv_design_mat=ce.design_mat())
    am, ad = ard_model(xt, split(800, rank, world), device=device)
    out["ard_ztzv"] = ShardedEngine(am.kernel, ad).ztzv(
        probe_vectors(256, 2, 9))
    km, kd = class_model(xt, split(900, rank, world), device=device)
    ke = ShardedEngine(km.kernel, kd)
    w0, dirn = class_directions(256, 3)
    out.update(
        class_n=ke.n_classes,
        class_loss_grad=ke.classification_loss_grad(w0, 0.3),
        class_linesearch=ke.softmax_linesearch(w0, dirn, LINESEARCH_STEPS,
                                               0.3))
    out["host_reduce"] = global_host_reduce(
        (rank + 1.5, 10.0 * rank, -float(rank)), ("sum", "max", "max"))

    # Engine selection: rank 0 holds 3x rank 1's rows; a limit between
    # their sizes must stream on both ranks.
    small, sd = rbf_model(xt, split(800, rank, world, [0, 600, 800]),
                          rffs=64, chunk=100, device=device, n=800)
    kinds = {}
    try:
        for mode, limit in (("sharded", 600 * 84 - 1),
                            ("sharded", 10 ** 9), ("single", 10 ** 9),
                            ("auto", 10 ** 9)):
            config.set_engine_mode(mode)
            config.set_stacked_limit(limit)
            kinds[f"{mode} {limit}"] = type(small._engine(sd)).__name__
    finally:
        config.set_engine_mode("auto")
        config.set_stacked_limit(10 ** 9)
    out["engine_kinds"] = kinds
    return out


def job_solvers(rank, world, device):
    """The M-sharded CG against the replicated one (fit, SLQ coefficients,
    no preconditioner), the looped CG, streamed sharded fits on an unequal
    and a ragged split, and the models' entry points on a sharded
    engine."""
    import xgpr_tpu_torch as xt
    from xgpr_tpu_torch import config
    from xgpr_tpu_torch.fitting.cg import ConjugateGrad, cg_fit
    from xgpr_tpu_torch.parallel import ShardedEngine
    from xgpr_tpu_torch.preconditioners.nystrom import NystromPreconditioner
    out = {}
    model, d = rbf_model(xt, split(1600, rank, world), device=device)
    eng = ShardedEngine(model.kernel, d)
    precond = NystromPreconditioner(eng, 128, random_state=123,
                                    method="srht")
    lam = model.kernel.get_lambda()
    rhs = np.concatenate([precond.get_zty().cpu().numpy()[:, None] / 1600,
                          probe_vectors(512, 4, 1)], axis=1)
    cg = ConjugateGrad(eng)
    try:
        for mode in ("off", "on"):
            config.set_m_sharding(mode)
            out[f"fit {mode}"] = cg_fit(eng, precond, tol=1e-7,
                                        verbose=False)[:2]
            out[f"slq {mode}"] = cg.fit(rhs, lam, precond, 50, 1e-6,
                                        nmll_settings=True)
            out[f"plain {mode}"] = cg.fit(probe_vectors(512, 2, 2), lam,
                                          None, 30, 1e-6)[:3]
        config.set_m_sharding("auto")
        out["auto_m_sharding"] = config.use_m_sharding(512, world)
        config.set_cg_mode("looped")
        out["fit looped"] = cg_fit(eng, precond, tol=1e-7,
                                   verbose=False)[:2]
    finally:
        config.set_m_sharding("auto")
        config.set_cg_mode("fused")

    # Streamed sharded fits: rank 0 holds 5 chunks, rank 1 3 (unequal);
    # the sequences cut to each rank's own longest (ragged).
    try:
        config.set_engine_mode("sharded")
        config.set_stacked_limit(1)
        um, ud = rbf_model(xt, split(800, rank, world, [0, 500, 800]),
                           rffs=256, chunk=100, device=device, n=800)
        out["unequal"] = um.fit(ud, tol=1e-8, run_diagnostics=True)[0], \
            um.weights, type(um._engine(ud)).__name__
        rm, rd = conv_model(xt, split(320, rank, world, [0, 200, 320]),
                            device=device, ragged=True)
        out["ragged"] = rm.fit(rd, tol=1e-8, run_diagnostics=True)[0], \
            rm.weights, type(rm._engine(rd)).__name__, \
            rm._engine(rd).global_batches
        config.set_stacked_limit(10 ** 9)

        # The models' entry points on the stacked sharded engine.
        mm, md = rbf_model(xt, split(1600, rank, world), rffs=256,
                           device=device)
        mm.fit(md, mode="exact")
        out["exact_fit"] = mm.weights, mm.var
        n_iter = mm.fit(md, tol=1e-8, run_diagnostics=True)[0]
        out["cg_fit"] = n_iter, mm.weights
        out["engine_kind"] = type(mm._engine(md)).__name__
        out["exact_nmll"] = mm.exact_nmll(HPARAMS, md)
        out["approximate_nmll"] = mm.approximate_nmll(HPARAMS, md)
        out["nmll_gradient"] = mm.exact_nmll_gradient(HPARAMS, md)
        out["crude_tune"] = mm.tune_hyperparams_crude(md,
                                                      max_bayes_iter=3)
        cm, cd = class_model(xt, split(900, rank, world), device=device)
        cm.fit(cd, tol=1e-6)
        out["classifier"] = cm.weights, cm.predict(class_data()[0][:64])
    finally:
        config.set_engine_mode("auto")
        config.set_stacked_limit(10 ** 9)
    return out


JOBS = {"reductions": job_reductions, "solvers": job_solvers}


# ----------------------------------------------------------------------
def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(name, world=2, device="cpu", timeout=JOIN_TIMEOUT):
    """Run job ``name`` on ``world`` gloo ranks; each rank's result dict,
    in rank order.  Fails when a rank fails or the job outlasts
    ``timeout`` seconds (every rank is then killed)."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for rank in range(world):
            log = open(Path(tmp) / f"rank{rank}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_port.scale_out_jobs",
                 name, str(rank), str(world), str(port),
                 str(Path(tmp) / f"rank{rank}.pkl"), device],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"scale-out job {name!r} did not end "
                                 f"within {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = []
        for rank, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            if p.returncode != 0:
                failed.append(f"rank {rank} exited {p.returncode}:\n"
                              + log.read()[-4000:])
            log.close()
        if failed:
            raise AssertionError("\n".join(failed))
        results = []
        for rank in range(world):
            with open(Path(tmp) / f"rank{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


def shared_job(name, tmp_path_factory):
    """``run_job(name)``'s results, run once per test session: under
    pytest-xdist the first worker to ask runs it and leaves the results in
    the session's shared temporary root (behind a file lock) for the
    others."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return run_job(name)
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"scale_out_{name}.pkl"
    with open(root / f"scale_out_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                results = run_job(name)
                part = path.with_suffix(".part")
                with open(part, "wb") as f:
                    pickle.dump(results, f)
                os.replace(part, path)
            with open(path, "rb") as f:
                return pickle.load(f)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def main(argv):
    name, rank, world, port, out = argv[:5]
    device = argv[5] if len(argv) > 5 else "cpu"
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from xgpr_tpu_torch.parallel.distributed import initialize_distributed
    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           local_device_ids=[0], backend="gloo")
    try:
        result = to_numpy(JOBS[name](rank, world, device))
    finally:
        torch.distributed.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
