"""Closed-form fitting: Cholesky weights and exact variance (port of
xgpr_tpu/fitting/exact.py)."""
import warnings

import torch


def direct_weight_calc(z_trans_z, z_trans_y, lambda_):
    """Cholesky solve of (Z^T Z + lambda^2 I) w = Z^T y -> (chol, weights).

    Raises FloatingPointError if the matrix is not positive definite.  The
    engine returns the Gram matrix in float64 (its entries are O(n)-scale
    sums, and at large n a well-tuned lambda^2 sits below the float32
    roundoff of the diagonal), so the factorisation runs in float64 on the
    device; xgpr_tpu, with no fp64 on the TPU, does this step on the host.
    """
    m = z_trans_z.shape[0]
    a = z_trans_z + (lambda_ ** 2) * torch.eye(m, dtype=z_trans_z.dtype,
                                               device=z_trans_z.device)
    chol, info = torch.linalg.cholesky_ex(a)
    if int(info) != 0 or bool(torch.any(torch.isnan(chol))):
        raise FloatingPointError("Design matrix is not positive definite.")
    weights = torch.cholesky_solve(z_trans_y[:, None], chol)[:, 0]
    return chol, weights


def rescue_weight_calc(z_trans_z, z_trans_y, lambda_):
    """Cholesky weights, retried with a growing diagonal shift (a slightly
    stronger ridge) when the factorisation breaks down."""
    try:
        return direct_weight_calc(z_trans_z, z_trans_y, lambda_)[1]
    except FloatingPointError:
        pass
    m = z_trans_z.shape[0]
    mean_eig = float(torch.trace(z_trans_z)) / m
    for k in range(7):
        eps = mean_eig * (10.0 ** (k - 7))
        try:
            _, weights = direct_weight_calc(z_trans_z, z_trans_y,
                                            (lambda_ ** 2 + eps) ** 0.5)
        except FloatingPointError:
            continue
        warnings.warn(
            "Design matrix was not positive definite at the requested "
            f"lambda; solved with an extra ridge of {eps:.3e} (shifted "
            "factorization).")
        return weights
    raise FloatingPointError("Design matrix is not positive definite.")


def calc_weights_exact(engine):
    """Exact weights via one design-matrix pass + Cholesky."""
    z_trans_z, z_trans_y, _ = engine.design_mat()
    weights = rescue_weight_calc(z_trans_z, z_trans_y,
                                 engine.kernel.get_lambda())
    return weights.to(engine._dtype), 1, []


def calc_variance_exact(engine, variance_rffs):
    """var = pinv(Z_v^T Z_v + lambda^2 I) over the first variance_rffs
    columns (float64, with jax's default cutoff 10 * max(M, N) * eps),
    returned in the working dtype."""
    z_trans_z = engine.var_design_mat(variance_rffs)
    lambda_ = engine.kernel.get_lambda()
    a = z_trans_z + (lambda_ ** 2) * torch.eye(
        variance_rffs, dtype=z_trans_z.dtype, device=z_trans_z.device)
    rtol = 10 * variance_rffs * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rtol).to(engine._dtype)
