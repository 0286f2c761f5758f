"""Preconditioned CG over a device-resident dataset (port of the stacked
solver in xgpr_tpu/fitting/fused_cg.py: ``_cg_while`` and
``fused_cg_solve_stacked``).

The JAX solver is one ``lax.while_loop`` program.  Here it is a Python
loop over device tensors that reads one flag per iteration on the host to
decide whether to go on.  Where the kernel has a fused chunk matvec (the
K1 kernel on the card) it runs on the cos/sin halves of the direction, so
no (chunk, num_rffs) feature matrix is ever written; otherwise (the
convolution kernels) the matvec is the engine's ``ztzv``, which contracts
each chunk's (cos, sin) parts with torch.matmul.

The solver state (iterates, residuals, the preconditioner) is float64 on
the device whatever the working dtype: it is O(M * K) per iteration,
negligible next to the matvec, and in float32 the recurrences lose
positive definiteness at the condition numbers real fits reach (the
Gram matrix's top eigenvalue grows with n while lambda^2 does not).  The
kernel takes the direction rounded to the working dtype and its per-chunk
outputs are summed in float64.
"""
import torch

from ..ops.contract import mm


def _precond_mv(u_mat, inv_eig, prefactor, v):
    xp = mm(u_mat.T, v)
    return (v - mm(u_mat, xp)) + mm(u_mat, inv_eig[:, None] * prefactor * xp)


def _cg_while(matvec, precond, rhs, lam, max_iter, tol):
    """Batched-RHS PCG with a per-column breakdown freeze.

    Each RHS column carries an 'active' flag.  A column is frozen when
    every column has converged or broken down, or when CG breaks down for
    it (non-positive or non-finite curvature p^T A p or residual energy
    r^T P^-1 r -- impossible in exact arithmetic, routine in fp32 at
    extreme hyperparameters).  Frozen columns stop updating (alpha = beta
    = 0) so they can never poison the others with NaNs; converged columns
    keep iterating until the global exit, as in the reference.  Each
    iteration's alphas and betas go into (max_iter, K) float64 buffers on
    the device (zero once a column is frozen), where SLQ reads where each
    column's Lanczos sequence ends.

    Returns (x, all converged, iterations, alphas, betas, relative
    residual norms of column 0 per iteration), the last three trimmed to
    the iterations run.
    """
    _, k = rhs.shape
    init_norms = torch.sqrt(torch.sum(rhs * rhs, dim=0))
    p = precond(rhs)
    rz = torch.sum(rhs * p, dim=0)
    x = torch.zeros_like(rhs)
    r = rhs
    active = torch.ones((k,), dtype=torch.bool, device=rhs.device)
    converged = torch.zeros((k,), dtype=torch.bool, device=rhs.device)
    errs = torch.zeros((max_iter,), dtype=rhs.dtype, device=rhs.device)
    alphas = torch.zeros((max_iter, k), dtype=rhs.dtype, device=rhs.device)
    betas = torch.zeros_like(alphas)
    lam2 = lam ** 2
    niter = 0
    while niter < max_iter and bool(active.any()):
        w = matvec(p) + lam2 * p
        pw = torch.sum(p * w, dim=0)
        alpha_raw = rz / pw
        active = active & torch.isfinite(alpha_raw) & (pw > 0)
        alpha = torch.where(active, alpha_raw, 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * w
        err = torch.sqrt(torch.sum(r * r, dim=0)) / init_norms
        converged = converged | (err < tol)
        z = precond(r)
        rz_next = torch.sum(r * z, dim=0)
        active = active & (rz_next > 0)
        beta = torch.where(active, rz_next / rz, 0.0)
        p = torch.where(active[None, :], z + beta[None, :] * p, p)
        active = active & ~torch.all(converged | ~active)
        alphas[niter] = alpha
        betas[niter] = beta
        errs[niter] = err[0]
        rz = rz_next
        niter += 1
    return (x, bool(torch.all(converged)), niter, alphas[:niter],
            betas[:niter], errs[:niter])


def fused_cg_solve_stacked(engine, rhs, lam, precond=None, max_iter=200,
                           tol=1e-4):
    """PCG on (Z^T Z + lam^2) x = rhs for a stacked engine; rhs and the
    returned iterates are float64."""
    s = engine._stacked
    ztzv_fn = engine.kernel.pure_ztzv_parts_fn()
    params = engine._params()
    if ztzv_fn is None:
        matvec = engine.ztzv
    else:
        cos_pos, sin_pos = (torch.as_tensor(p, device=engine.device)
                            for p in engine.kernel.feature_positions())

        def matvec(v):
            v_c = v[cos_pos].to(engine._dtype).contiguous()
            v_s = v[sin_pos].to(engine._dtype).contiguous()
            oc = torch.zeros(v_c.shape, dtype=v.dtype, device=v.device)
            os_ = torch.zeros_like(oc)
            for i in range(s["x"].shape[0]):
                lb = None if s["l"] is None else s["l"][i]
                a, b = ztzv_fn(params, s["x"][i], lb, s["m"][i], v_c, v_s)
                oc += a
                os_ += b
            out = torch.empty_like(v)
            out[cos_pos] = oc
            out[sin_pos] = os_
            return out

    if precond is None:
        precond_fn = lambda v: v
    else:
        def precond_fn(v):
            return _precond_mv(precond.u_mat, precond.inv_eig,
                               precond.prefactor, v)
    return _cg_while(matvec, precond_fn, rhs, lam, max_iter, tol)
