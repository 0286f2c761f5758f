"""Stochastic Lanczos quadrature logdet estimation from CG coefficients
(port of xgpr_tpu/scoring/slq.py).

The probes are drawn on the host with numpy (utils/rng.py), as in
xgpr_tpu, and shaped to N(0, P) by the preconditioner on the device; the
fit column and the probes share one batched PCG (K1 at K = 26 on the card
with the default 25 probes).  The Lanczos tridiagonal for each probe is
rebuilt from the CG (alpha, beta) sequences: diag_i = 1/alpha_i +
beta_{i-1}/alpha_{i-1}, offdiag_i = sqrt(beta_i)/alpha_i; then logdet ~=
num_rffs * mean_probes sum_j w_j ln(theta_j) with w_j the squared first
eigenvector components, plus the preconditioner's own logdet.  The
coefficients come to the host once, after the solve: the tridiagonals are
at most nmll_iter square, so scipy's eigh_tridiagonal solves them there.
The three steps are the spans ``xgpr/slq.probes``, ``xgpr/slq.pcg`` and
``xgpr/slq.lanczos`` in a profiled run.
"""
import numpy as np
import torch
from scipy.linalg import eigh_tridiagonal

from .alpha_beta import optimize_alpha_beta
from ..fitting.cg import ConjugateGrad
from ..utils import rng as state_rng
from ..utils.diagnostics import span


def slq_nmll_from_engine(engine, preconditioner, random_seed, nsamples,
                         nmll_iter, nmll_tol):
    """Approximate NMLL via preconditioned CG + SLQ over an engine; the
    data is touched only through the engine's matvec and the
    preconditioner's stored Z^T y / y^T y."""
    num_rffs = engine.num_rffs
    with span("xgpr/slq.probes"):
        probes = torch.as_tensor(
            state_rng.normal_probes(random_seed, num_rffs, nsamples),
            dtype=torch.float64, device=engine.device)
        probes = preconditioner.matvec_for_sampling(probes)

    z_trans_y = preconditioner.get_zty()
    y_trans_y = preconditioner.get_yty()
    ndatapoints = engine.ndatapoints
    rhs = torch.cat([z_trans_y[:, None] / ndatapoints, probes], dim=1)

    with span("xgpr/slq.pcg"):
        x_k, alphas, betas = ConjugateGrad(engine).fit(
            rhs, engine.kernel.get_lambda(), preconditioner, nmll_iter,
            nmll_tol, nmll_settings=True)
    x0 = x_k[:, 0] * ndatapoints
    with span("xgpr/slq.lanczos"):
        logdet = estimate_logdet(alphas, betas, num_rffs, preconditioner)
    nll1 = float(0.5 * (y_trans_y - z_trans_y @ x0))
    negloglik, _ = optimize_alpha_beta(
        engine.kernel.get_lambda(), np.array([nll1, 0.5 * logdet]),
        ndatapoints, num_rffs)
    return negloglik


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.float64)
    return np.asarray(a, dtype=np.float64)


def estimate_logdet(alphas, betas, num_rffs, preconditioner=None):
    """alphas/betas: (niter, nprobes) tensors or arrays from the CG run.

    Each probe's Lanczos sequence is truncated at its first non-positive
    alpha: the breakdown-safe CG records alpha = 0 once a column has
    converged or broken down, and only the preceding coefficients define
    a valid tridiagonal.  Raises FloatingPointError when no probe yields
    a usable sequence, or a kept one is not finite.
    """
    alphas, betas = _host(alphas), _host(betas)
    nprobes = alphas.shape[1]
    logdets = np.zeros((nprobes,))
    n_used = 0
    for i in range(nprobes):
        a = alphas[:, i]
        b = betas[:, i]
        bad = ~(a > 0)
        length = int(np.argmax(bad)) if bad.any() else a.shape[0]
        if length < 1:
            continue
        a = a[:length]
        b = np.clip(b[:length], 0.0, None)
        mat_diag = 1.0 / a
        mat_diag[1:] += b[:-1] / a[:-1]
        if not (np.all(np.isfinite(mat_diag)) and np.all(np.isfinite(b))):
            raise FloatingPointError("SLQ: non-finite Lanczos coefficients.")
        if length > 1:
            upper_diag = (np.sqrt(b) / a)[:-1]
            eigvals, eigvecs = eigh_tridiagonal(
                mat_diag, upper_diag, lapack_driver="stev")
        else:
            eigvals = mat_diag[:1]
            eigvecs = np.ones((1, 1))
        weights = eigvecs[0, :] ** 2
        eigvals = np.clip(eigvals, 1e-30, None)
        logdets[i] = (weights * np.log(eigvals)).sum()
        n_used += 1

    if n_used == 0:
        raise FloatingPointError("SLQ: no usable probe sequences.")
    logdet = num_rffs * logdets.sum() / n_used
    if preconditioner is not None:
        logdet += preconditioner.get_logdet()
    return float(logdet)
