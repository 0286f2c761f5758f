"""Telescoping-grid search over the shared lambda hyperparameter (port of
xgpr_tpu/scoring/lb_optimizer.py).

One eigendecomposition of Z^T Z (+1e-5 jitter, eigenvalue floor 1e-7),
then the NMLL scored in closed form on a 100-point lambda grid per cycle,
the grid contracted around the best point.  The engine's Gram matrix is
float64 on its device, so the eigendecomposition runs there in float64
(xgpr_tpu moves it to the host only because the TPU has no fp64), and
only the eigenvalues and U^T Z^T y come to the host for the grid.
"""
import numpy as np
import torch

from ..constants import DEFAULT_SCORE_IF_PROBLEM
from ..ops.contract import mm


def get_eigvals(engine, subsample=1.0):
    """Eigen-decompose Z^T Z; returns (eigvals, U^T Z^T y, y^T y, N) on
    the host."""
    if subsample >= 1.0:
        z_trans_z, z_trans_y, y_trans_y = engine.design_mat()
        ndatapoints = engine.ndatapoints
    else:
        z_trans_z, z_trans_y, y_trans_y, ndatapoints = \
            _subsampled_design_mat(engine, subsample)

    m = z_trans_z.shape[0]
    eye = torch.eye(m, dtype=torch.float64, device=z_trans_z.device)
    eigvals, eigvecs = torch.linalg.eigh(z_trans_z + 1e-5 * eye)
    eigvals = torch.flip(eigvals, dims=[0]) - 1e-5
    eigvecs = torch.flip(eigvecs, dims=[1])

    eigvals_np = eigvals.cpu().numpy()
    cut_point = max(int((eigvals_np >= 1e-7).sum()), 1)
    eigvals_np[cut_point:] = 1e-7
    eigvecs[:, cut_point:] = 0
    proj = mm(eigvecs.T, z_trans_y).cpu().numpy()
    return eigvals_np, proj, float(y_trans_y), ndatapoints


def _subsampled_design_mat(engine, subsample):
    """(Z^T Z, Z^T y, y^T y, rows) over a per-chunk row subsample drawn
    from a fixed seed, as xgpr_tpu draws it; products in the working
    dtype, sums in float64 on the device."""
    rng = np.random.default_rng(123)
    kernel = engine.kernel
    m = engine.num_rffs
    ztz = torch.zeros((m, m), dtype=torch.float64, device=engine.device)
    zty = torch.zeros((m,), dtype=torch.float64, device=engine.device)
    yty = 0.0
    n = 0
    for xb, yb, lb in engine.dataset.get_chunked_data():
        idx_size = max(1, int(subsample * xb.shape[0]))
        idx = rng.choice(xb.shape[0], idx_size, replace=False)
        xb, yb = xb[idx, ...], yb[idx]
        lb = None if lb is None else lb[idx]
        z = kernel.transform_x(xb, lb)
        y = torch.as_tensor(yb, dtype=z.dtype, device=z.device)
        ztz += mm(z.T, z)
        zty += mm(z.T, y)
        yty += float(y @ y)
        n += xb.shape[0]
    return ztz, zty, yty, n


def generate_scoregrid(num_rffs, eigvals, proj, lambda_grid, y_trans_y,
                       ndatapoints):
    """Closed-form NMLL for each lambda grid point (numpy, on the host).

    A materially negative residual means the eigenpairs were too
    inaccurate to score; such grid points, and non-finite ones, get the
    penalty score."""
    eigval_batch = eigvals[:, None] + lambda_grid[None, :] ** 2
    resid = y_trans_y - proj @ (proj[:, None] / eigval_batch)
    bad = resid < -1e-3 * max(abs(y_trans_y), 1e-30)
    scoregrid = np.clip(resid, 0, None)
    scoregrid = 0.5 * scoregrid

    beta = np.sqrt(2 * scoregrid / (ndatapoints * lambda_grid ** 2))
    beta = np.clip(beta, 0.1, 10)

    scoregrid = scoregrid / (beta * lambda_grid) ** 2
    scoregrid += 0.5 * np.log(eigval_batch).sum(axis=0)
    scoregrid += (ndatapoints - num_rffs) * np.log(lambda_grid)
    scoregrid += ndatapoints * 0.5 * np.log(2 * np.pi) \
        + ndatapoints * np.log(beta)
    scoregrid = np.where(bad | ~np.isfinite(scoregrid),
                         DEFAULT_SCORE_IF_PROBLEM, scoregrid)
    return scoregrid


def shared_hparam_search(sigma_vals, kernel, engine_factory, init_bounds,
                         n_pts_per_dim=100, n_cycles=1, subsample=1.0):
    """Score a sigma point by optimising lambda on a telescoping grid.

    Args:
        sigma_vals: (n_hyperparams - 1,) log-space kernel-specific values.
        kernel: the kernel object (hyperparams will be overwritten).
        engine_factory: zero-arg callable returning the Engine of
            (kernel, dataset); the kernel's hyperparams are read through
            feature_params at reduction time.
        init_bounds: log-space bounds, row 0 is lambda's.

    Returns:
        (score, best_lambda_logspace), the score rounded to 3 places and
        log-lambda to 7.
    """
    bounds = np.asarray(init_bounds, dtype=np.float64).copy()
    if np.exp(bounds[0, 0]) < 1e-3:
        bounds[0, 0] = np.log(1e-3)

    hparams = np.zeros((np.asarray(sigma_vals).shape[0] + 1))
    if hparams.shape[0] > 1:
        hparams[1:] = sigma_vals
    kernel.set_hyperparams(hparams, logspace=True)

    engine = engine_factory()
    eigvals, proj, y_trans_y, ndatapoints = get_eigvals(engine, subsample)
    num_rffs = kernel.get_num_rffs()

    best_score, best_lb = np.inf, None
    for _ in range(n_cycles):
        lambda_grid = np.exp(np.linspace(bounds[0, 0], bounds[0, 1],
                                         n_pts_per_dim))
        spacing = 1.05 * abs(bounds[0, 0] - bounds[0, 1]) / n_pts_per_dim
        scoregrid = generate_scoregrid(num_rffs, eigvals, proj, lambda_grid,
                                       y_trans_y, ndatapoints)
        min_pt = int(np.argmin(scoregrid))
        best_score = scoregrid[min_pt]
        best_lb = np.log(float(lambda_grid[min_pt]))
        bounds[0, 0] = max(best_lb - spacing, init_bounds[0, 0])
        bounds[0, 1] = min(best_lb + spacing, init_bounds[0, 1])

    return np.round(float(best_score), 3), np.round(np.asarray([best_lb]), 7)
