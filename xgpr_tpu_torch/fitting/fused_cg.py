"""Preconditioned CG over a device-resident dataset (port of the stacked
solver in xgpr_tpu/fitting/fused_cg.py: ``_cg_while`` and
``fused_cg_solve_stacked``).

The JAX solver is one ``lax.while_loop`` program.  Here it is a Python
loop over device tensors that reads one flag per iteration on the host to
decide whether to go on.  Where the kernel has a fused chunk matvec (the
K1 kernel on the card) it runs on the cos/sin halves of the direction, so
no (chunk, num_rffs) feature matrix is ever written; otherwise (the
convolution kernels) the matvec is the engine's ``ztzv``, which contracts
each chunk's (cos, sin) parts with torch.matmul (ops/contract.py:
``parts_contract``, in bfloat16 under bf16 feature materialisation, as
xgpr_tpu's matvec contracts them).  Under the "default" feature
precision K1 rounds every product's operands to bfloat16 itself.

The solver state (iterates, residuals, the preconditioner) is float64 on
the device whatever the working dtype: it is O(M * K) per iteration,
negligible next to the matvec, and in float32 the recurrences lose
positive definiteness at the condition numbers real fits reach (the
Gram matrix's top eigenvalue grows with n while lambda^2 does not).  The
kernel takes the direction rounded to the working dtype and its per-chunk
outputs are summed in float64.

On a sharded engine (parallel/sharded.py) the same loop runs on every
rank (``fused_cg_solve_sharded``): the matvec sums K1's local (cos, sin)
outputs over this rank's rows on the device and all-reduces them once per
iteration, and the iterates stay replicated.  ``fused_cg_solve_msharded``
shards the rhs, iterates, residuals and the Nystrom factor U over M
instead.  Every rank must take the loop's exit on the same iteration or
the job deadlocks in the next collective: the flag read on the host comes
from all-reduced values, the same on every rank.
"""
import torch

from .. import config
from ..ops.contract import mm
from ..parallel.distributed import all_gather, all_reduce_sum, reduce_scatter
from ..utils.diagnostics import span


def _precond_mv(u_mat, inv_eig, prefactor, v):
    xp = mm(u_mat.T, v)
    return (v - mm(u_mat, xp)) + mm(u_mat, inv_eig[:, None] * prefactor * xp)


def _col_sum(a):
    return torch.sum(a, dim=0)


def _any_active(active):
    """The loop's one host read an iteration: whether any column is still
    active (it waits for the iteration's work on the device)."""
    with span("xgpr/wait.cg_flag"):
        return bool(active.any())


def _cg_while(matvec, precond, rhs, lam, max_iter, tol, col_sum=_col_sum):
    """Batched-RHS PCG with a per-column breakdown freeze.

    ``col_sum`` reduces (M, K) to (K,) over M: a local sum by default; the
    M-sharded solver passes one that all-reduces, so inner products are
    global while the iterates stay sharded.

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

    Each iteration is the span ``xgpr/cg.iter`` in a profiled run, its
    closing flag read ``xgpr/wait.cg_flag`` inside it (the first read
    comes before the loop).

    Returns (x, all converged, iterations, alphas, betas, relative
    residual norms of column 0 per iteration), the last three trimmed to
    the iterations run.
    """
    _, k = rhs.shape
    init_norms = torch.sqrt(col_sum(rhs * rhs))
    p = precond(rhs)
    rz = col_sum(rhs * p)
    x = torch.zeros_like(rhs)
    r = rhs
    active = torch.ones((k,), dtype=torch.bool, device=rhs.device)
    converged = torch.zeros((k,), dtype=torch.bool, device=rhs.device)
    errs = torch.zeros((max_iter,), dtype=rhs.dtype, device=rhs.device)
    alphas = torch.zeros((max_iter, k), dtype=rhs.dtype, device=rhs.device)
    betas = torch.zeros_like(alphas)
    lam2 = lam ** 2
    niter = 0
    go = niter < max_iter and _any_active(active)
    while go:
        with span("xgpr/cg.iter"):
            w = matvec(p) + lam2 * p
            pw = col_sum(p * w)
            alpha_raw = rz / pw
            active = active & torch.isfinite(alpha_raw) & (pw > 0)
            alpha = torch.where(active, alpha_raw, 0.0)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * w
            err = torch.sqrt(col_sum(r * r)) / init_norms
            converged = converged | (err < tol)
            z = precond(r)
            rz_next = col_sum(r * z)
            active = active & (rz_next > 0)
            beta = torch.where(active, rz_next / rz, 0.0)
            p = torch.where(active[None, :], z + beta[None, :] * p, p)
            active = active & ~torch.all(converged | ~active)
            alphas[niter] = alpha
            betas[niter] = beta
            errs[niter] = err[0]
            rz = rz_next
            niter += 1
            go = niter < max_iter and _any_active(active)
    return (x, bool(torch.all(converged)), niter, alphas[:niter],
            betas[:niter], errs[:niter])


def _local_matvec(engine):
    """Z^T Z v over this process's rows of a stacked engine: K1's fused
    chunk matvec on the cos/sin halves of v where the kernel has it, else
    the engine's local ``ztzv``."""
    ztzv_fn = engine.kernel.pure_ztzv_parts_fn()
    if ztzv_fn is None:
        return engine.local_ztzv
    s = engine._stacked
    params = engine._params()
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
    return matvec


def _precond_fn(precond):
    if precond is None:
        return lambda v: v
    return lambda v: _precond_mv(precond.u_mat, precond.inv_eig,
                                 precond.prefactor, v)


def fused_cg_solve_stacked(engine, rhs, lam, precond=None, max_iter=200,
                           tol=1e-4):
    """PCG on (Z^T Z + lam^2) x = rhs for a stacked engine; rhs and the
    returned iterates are float64."""
    return _cg_while(_local_matvec(engine), _precond_fn(precond), rhs, lam,
                     max_iter, tol)


def fused_cg_solve_sharded(engine, rhs, lam, precond=None, max_iter=200,
                           tol=1e-4):
    """``fused_cg_solve_stacked`` on a stacked sharded engine: each matvec
    is the local one all-reduced once; the M-sharded solver instead when
    ``config.use_m_sharding`` says so."""
    if config.use_m_sharding(engine.num_rffs, engine.n_dev):
        return fused_cg_solve_msharded(engine, rhs, lam, precond, max_iter,
                                       tol)
    local = _local_matvec(engine)
    return _cg_while(lambda v: all_reduce_sum(engine.mesh, local(v))[0],
                     _precond_fn(precond), rhs, lam, max_iter, tol)


def fused_cg_solve_msharded(engine, rhs, lam, precond=None, max_iter=200,
                            tol=1e-4):
    """PCG with the rhs, iterates, residuals and U sharded over M: this
    rank holds rows [lo, hi) of each (``DataMesh.shard_rows``).  Per
    iteration the direction is all-gathered, the local matvec runs over
    this rank's data rows, and its (M, K) result is reduce-scattered back
    to the shard; the column sums and P^-1's U^T v are all-reduced.  U is
    replicated after the preconditioner's all-reduced sketch, so each
    rank slices its own rows.  Returns the whole x (all-gathered) with
    the loop's coefficients, as the other solvers do."""
    mesh = engine.mesh
    lo, hi = mesh.shard_rows(engine.num_rffs)
    local = _local_matvec(engine)

    def matvec(v_shard):
        return reduce_scatter(mesh, local(all_gather(mesh, v_shard)))

    def col_sum(a):
        return all_reduce_sum(mesh, torch.sum(a, dim=0))[0]

    if precond is None:
        precond_fn = lambda v: v
    else:
        u_mat = precond.u_mat[lo:hi]
        scale = precond.inv_eig[:, None] * precond.prefactor

        def precond_fn(v):
            xp = all_reduce_sum(mesh, mm(u_mat.T, v))[0]
            return (v - mm(u_mat, xp)) + mm(u_mat, scale * xp)
    x_s, done, niter, alphas, betas, errs = _cg_while(
        matvec, precond_fn, rhs[lo:hi], lam, max_iter, tol, col_sum)
    return all_gather(mesh, x_s), done, niter, alphas, betas, errs
