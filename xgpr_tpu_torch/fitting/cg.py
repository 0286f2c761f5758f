"""Batched-RHS preconditioned conjugate gradients (port of xgpr_tpu/fitting/cg.py).

The matvec is the chunked (Z^T Z + lambda^2) v reduction; per-RHS alpha
and beta, convergence when the relative residual norm of every column is
below tol.  Stacked engines use the fused-matvec solvers
(fitting/fused_cg.py): a sharded engine the sharded one (M-sharded when
``config.use_m_sharding`` says so), a single engine the stacked one.
Streaming engines, sharded or not, and every engine under
``config.set_cg_mode("looped")`` use the loop over the engine's ztzv
(all-reduced on a sharded engine).  All carry the same per-column
breakdown freeze and record each iteration's alphas and betas for SLQ.
"""
import warnings

import torch

from .. import config
from ..parallel.sharded import ShardedEngine
from .fused_cg import (_cg_while, fused_cg_solve_sharded,
                       fused_cg_solve_stacked)


class ConjugateGrad:
    """PCG over the implicit normal equations (Z^T Z + lambda^2) x = b."""

    def __init__(self, engine):
        self.engine = engine

    def _fused_solver(self):
        """The solver for a device-resident engine, or None for the loop
        (xgpr_tpu's ``ConjugateGrad._fused_solver``)."""
        if config.cg_mode() == "looped" or self.engine._stacked is None:
            return None
        if isinstance(self.engine, ShardedEngine):
            return fused_cg_solve_sharded
        return fused_cg_solve_stacked

    def fit(self, rhs, lambda_, preconditioner=None, maxiter=200, tol=1e-4,
            nmll_settings=False):
        """Solve (Z^T Z + lambda^2) x = rhs for each (M, K) RHS column,
        with the solver state in float64 (see fitting/fused_cg.py).

        Returns (x, converged, niter, losses), or with ``nmll_settings``
        (x, alphas, betas): the per-iteration CG coefficients of the probe
        columns, (niter, K - 1) float64 tensors on the device, with the
        fit column 0 dropped, for stochastic Lanczos quadrature.
        """
        rhs = torch.as_tensor(rhs, dtype=torch.float64,
                              device=self.engine.device)
        fused = self._fused_solver()
        if fused is not None:
            x_k, done, niter, alphas, betas, errs = fused(
                self.engine, rhs, lambda_, preconditioner, maxiter, tol)
        else:
            precond = (lambda v: v) if preconditioner is None \
                else preconditioner.batch_matvec
            x_k, done, niter, alphas, betas, errs = _cg_while(
                self.engine.ztzv, precond, rhs, lambda_, maxiter, tol)
        if nmll_settings:
            return x_k, alphas[:, 1:], betas[:, 1:]
        return x_k, done, niter, list(errs.cpu().numpy())


def cg_fit(engine, preconditioner=None, tol=1e-6, max_iter=500,
           verbose=True):
    """Fit driver: rhs = Z^T y / N, run PCG, rescale the weights by N and
    warn on non-convergence."""
    lambda_ = engine.kernel.get_lambda()
    ndatapoints = engine.ndatapoints
    if preconditioner is None:
        z_trans_y, _ = engine.zty()
    else:
        z_trans_y = preconditioner.get_zty()
    rhs = (z_trans_y / ndatapoints)[:, None]
    x_k, converged, n_iter, losses = ConjugateGrad(engine).fit(
        rhs, lambda_, preconditioner, max_iter, tol)
    weights = (x_k[:, 0] * ndatapoints).to(engine._dtype)
    if not converged:
        if n_iter >= max_iter:
            warnings.warn("CG hit max_iter before reaching tol; the "
                          "returned weights are usable but a larger "
                          "preconditioner rank or looser tol may fit "
                          "better.")
        else:
            warnings.warn("CG froze numerically broken-down columns "
                          "before reaching tol; the returned weights are "
                          "usable but the system is near-singular at "
                          "these hyperparameters.")
    if verbose:
        print(f"CG iterations: {n_iter}")
    return weights, n_iter, losses

