"""Surrogate-assisted tuning for kernels with 2-3 hyperparameters (port
of xgpr_tpu/scoring/surrogate_tuner.py).

The shared noise hyperparameter has a closed-form score at any fixed
kernel-specific point (lb_optimizer.shared_hparam_search), so crude
tuning reduces to low-dimensional black-box minimisation over the one or
two kernel lengthscales:

* the surrogate is an exact GP over the scored points, with a
  marginal-likelihood sweep over a lengthscale grid, a posterior draw at
  a quasirandom candidate lattice and the argmin (Thompson sampling).
  xgpr_tpu writes it as one jitted device program; here it is plain torch
  in float64 on the CPU: it is at most a few dozen points against 1024
  candidates, far too small to be worth a trip to the card;
* seed and candidate designs come from a Roberts R_d low-discrepancy
  lattice, and the candidates and normal draws from numpy with the same
  seeds as xgpr_tpu, so both propose the same points;
* a golden-section descent per coordinate spends the remaining budget on
  the incumbent's basin.

The search stops when a proposal lands within ``tol`` of an
already-scored point or when the evaluation budget is spent.
"""
import numpy as np
import torch

from ..constants import DEFAULT_SCORE_IF_PROBLEM
from .lb_optimizer import shared_hparam_search

# Unit-box lengthscale grid for the surrogate's marginal-likelihood sweep.
_LS_GRID = np.array([0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 1.5])
_JITTER = 1e-4
_N_CANDIDATES = 1024


def _lattice(n, dim, seed, offset=0):
    """Roberts R_d quasirandom sequence with a seeded Cranley-Patterson
    shift; points offset..offset+n of the stream, in the unit box."""
    root = 1.5
    for _ in range(40):
        root = (1.0 + root) ** (1.0 / (dim + 1))
    alphas = (1.0 / root) ** np.arange(1, dim + 1)
    shift = np.random.default_rng(seed).random(dim)
    idx = np.arange(offset + 1, offset + n + 1)
    return (shift[None, :] + idx[:, None] * alphas[None, :]) % 1.0


def _thompson_round(xpts, yvals, mask, cands, draws):
    """One acquisition round, in float64 torch on the CPU.

    xpts (NMAX, d) unit-box points, yvals (NMAX,) scores, mask (NMAX,)
    1.0 for live rows; cands (C, d) candidate lattice; draws (C,) standard
    normals (numpy arrays).  Returns (chosen candidate, its sampled
    value) as numpy.
    """
    xpts, yvals, mask, cands, draws = (
        torch.as_tensor(np.asarray(a), dtype=torch.float64)
        for a in (xpts, yvals, mask, cands, draws))
    nmax = xpts.shape[0]
    eye = torch.eye(nmax, dtype=torch.float64)
    pair_d2 = torch.sum((xpts[:, None, :] - xpts[None, :, :]) ** 2, dim=-1)
    cand_d2 = torch.sum((xpts[:, None, :] - cands[None, :, :]) ** 2, dim=-1)
    live_outer = mask[:, None] * mask[None, :]

    n_live = torch.sum(mask)
    center = torch.sum(yvals * mask) / n_live
    spread = torch.sqrt(torch.sum(((yvals - center) ** 2) * mask) / n_live) \
        + 1e-12
    y_unit = (yvals - center) / spread * mask

    # One batch over the lengthscale grid.  Masked-out rows get a unit
    # diagonal and zero cross terms: they drop out of the solve, the
    # logdet and the posterior exactly.
    ls = torch.as_tensor(_LS_GRID, dtype=torch.float64)[:, None, None]
    cov = torch.exp(-0.5 * pair_d2 / ls ** 2) * live_outer
    cov = cov + eye * (1.0 - mask) + eye * (_JITTER * mask)
    chol, info = torch.linalg.cholesky_ex(cov)
    dual = torch.cholesky_solve(y_unit.expand(len(_LS_GRID), nmax)[..., None],
                                chol)[..., 0]
    nll = 0.5 * torch.sum(y_unit * dual, dim=-1) + \
        torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    # A grid point whose covariance would not factor is never chosen.
    nll = torch.where(info == 0, nll, torch.inf)
    cross = torch.exp(-0.5 * cand_d2 / ls ** 2) * mask[:, None]
    post_mean = torch.einsum("lnc,ln->lc", cross, dual)
    solved = torch.cholesky_solve(cross, chol)
    post_var = torch.clamp(1.0 + _JITTER - torch.sum(cross * solved, dim=1),
                           min=1e-12)

    best_ls = int(torch.argmin(nll))
    sample = post_mean[best_ls] + torch.sqrt(post_var[best_ls]) * draws
    winner = int(torch.argmin(sample))
    return cands[winner].numpy(), float(sample[winner])


_GOLDEN = 0.5 * (3.0 - np.sqrt(5.0))


def _coordinate_refine(unit_history, score_history, span, score_fn,
                       n_done_fn, budget, tol):
    """Golden-section descent along each sigma coordinate, bracketed by
    the incumbent's nearest already-scored neighbours (other coordinates
    held at the incumbent).  Runs until the bracket is tighter than
    ``tol`` in log-hyperparameter units or the budget is spent; every
    evaluation lands in the shared history, so later argmins see it."""
    n_dims = unit_history.shape[1]

    def evaluate(u_vec):
        score_fn(u_vec)
        return float(score_history[n_done_fn() - 1])

    for dim in range(n_dims):
        if n_done_fn() + 2 > budget:
            return
        best = int(np.argmin(score_history[:n_done_fn()]))
        u_best = unit_history[best].copy()
        coords = np.unique(unit_history[:n_done_fn(), dim])
        center = u_best[dim]
        left = coords[coords < center - 1e-9]
        right = coords[coords > center + 1e-9]
        a = float(left.max()) if left.size else max(0.0, center - 0.25)
        b = float(right.min()) if right.size else min(1.0, center + 0.25)
        unit_tol = tol / max(float(span[dim]), 1e-12)
        if b - a <= unit_tol:
            continue

        def at(x):
            u = u_best.copy()
            u[dim] = x
            return evaluate(u)

        x1 = a + _GOLDEN * (b - a)
        x2 = b - _GOLDEN * (b - a)
        f1, f2 = at(x1), at(x2)
        while n_done_fn() < budget and (b - a) > unit_tol:
            if f1 < f2:
                b, x2, f2 = x2, x1, f1
                x1 = a + _GOLDEN * (b - a)
                f1 = at(x1)
            else:
                a, x1, f1 = x1, x2, f2
                x2 = b - _GOLDEN * (b - a)
                f2 = at(x2)


def surrogate_grid_tuning(kernel, engine_factory, bounds, random_seed,
                          max_iter, verbose, tol=1e-1, n_pts_per_dim=100,
                          n_cycles=1, n_init_pts=10, subsample=1.0):
    """Tune (lambda, sigma...) for a 2-3 hyperparameter kernel.

    Returns (best_hparams, (scored_points, scores), best_score, n_feval).
    """
    bounds = np.asarray(bounds, dtype=np.float64)
    n_dims = bounds.shape[0] - 1
    if n_dims not in (1, 2):
        raise RuntimeError(
            "Surrogate tuning requires a kernel with 2 or 3 total "
            "hyperparameters; use the single-lambda closed form or a "
            "scipy optimizer otherwise.")
    low, span = bounds[1:, 0], bounds[1:, 1] - bounds[1:, 0]
    n_init_pts = min(n_init_pts, max_iter)
    budget = max_iter
    nmax = budget

    unit_history = np.zeros((nmax, n_dims))
    score_history = np.full((nmax,), np.inf)
    lambda_history = np.zeros((nmax, 1))
    n_done = 0

    def score_unit_point(u):
        nonlocal n_done
        sigma = low + u * span
        score, best_lambda = shared_hparam_search(
            sigma, kernel, engine_factory, bounds[:1, :],
            n_pts_per_dim=n_pts_per_dim, n_cycles=n_cycles,
            subsample=subsample)
        unit_history[n_done] = u
        score_history[n_done] = score
        lambda_history[n_done] = best_lambda
        n_done += 1
        if verbose:
            print(f"Scored point {n_done}/{budget}: sigma={sigma}, "
                  f"score={score}", flush=True)

    for u in _lattice(n_init_pts, n_dims, random_seed):
        score_unit_point(u)

    while n_done < budget:
        # Degenerate evaluations return DEFAULT_SCORE_IF_PROBLEM; feed the
        # surrogate the worst real score instead, so one sentinel cannot
        # flatten the GP's normalisation of everything else.
        hist = score_history[:n_done]
        real_sel = np.isfinite(hist) & (hist < 0.1 * DEFAULT_SCORE_IF_PROBLEM)
        real = hist[real_sel]
        worst = float(real.max()) if real.size else 0.0
        capped = np.where(
            np.isfinite(score_history) &
            (score_history < 0.1 * DEFAULT_SCORE_IF_PROBLEM),
            score_history, worst)

        cands = _lattice(_N_CANDIDATES, n_dims, random_seed + 7919,
                         offset=n_done * _N_CANDIDATES)
        draws = np.random.default_rng(random_seed + n_done).standard_normal(
            _N_CANDIDATES)
        mask = (np.arange(nmax) < n_done).astype(np.float64)
        proposal, _ = _thompson_round(unit_history, capped, mask, cands,
                                      draws)

        gap = np.min(np.linalg.norm(
            (unit_history[:n_done] - proposal[None, :]) * span[None, :],
            axis=1))
        # Score the converging proposal too before stopping: the final
        # proposal is usually an exploit step into the incumbent basin.
        score_unit_point(proposal)
        if gap < tol:
            if verbose:
                print(f"Surrogate collapsed: proposal within {tol} of a "
                      "scored point.", flush=True)
            break

    _coordinate_refine(unit_history, score_history, span, score_unit_point,
                       lambda: n_done, budget, tol)

    best = int(np.argmin(score_history[:n_done]))
    best_hparams = np.concatenate(
        [lambda_history[best], low + unit_history[best] * span])
    best_score = float(score_history[best])
    scored_sigmas = [low + u * span for u in unit_history[:n_done]]
    if verbose:
        print(f"Surrogate search done: score={best_score}, "
              f"hyperparams={best_hparams}", flush=True)
    return (best_hparams, (scored_sigmas, score_history[:n_done].tolist()),
            best_score, n_done)
