"""Exact NMLL gradient (port of xgpr_tpu/scoring/gradient.py).

Closed-form dNMLL/dlambda and per-sigma gradients via Cholesky traces,
returned times the linear hyperparameters for the log-space chain rule.
The Cholesky factor, its triangular inverse and the trace solves are
float64 on the engine's device (xgpr_tpu, with no fp64 on the TPU, runs
them at its working precision); only scalars come to the host.
"""
import numpy as np
import torch

from .alpha_beta import optimize_alpha_beta
from ..fitting.exact import cho_solve_lower, direct_weight_calc


def exact_nmll_reg_grad(z_trans_z, z_trans_y, y_trans_y, hparams,
                        ndatapoints, dz_dsigma_ty, inner_deriv):
    """Returns (negloglik, grad, beta).

    Args:
        z_trans_z: (M, M) float64 design matrix WITHOUT the lambda^2 shift.
        dz_dsigma_ty: (M, n_sigma), inner_deriv: (M, M, n_sigma), float64.
        hparams: linear-space hyperparameters.

    Raises FloatingPointError if the shifted matrix is not positive
    definite.
    """
    m = z_trans_z.shape[0]
    lambda_ = float(hparams[0])
    chol, weights = direct_weight_calc(z_trans_z, z_trans_y, lambda_)
    eye = torch.eye(m, dtype=chol.dtype, device=chol.device)
    chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)

    nll1 = float(0.5 * (y_trans_y - z_trans_y @ weights))
    nll2 = float(torch.sum(torch.log(torch.diagonal(chol))))
    negloglik, beta = optimize_alpha_beta(lambda_, np.array([nll1, nll2]),
                                          float(ndatapoints), float(m))

    grad = np.zeros((hparams.shape[0],))
    alpha = lambda_ * beta

    dnll_dlambda = (1 / (beta ** 2 * lambda_ ** 3)) * float(
        z_trans_y @ weights - y_trans_y)
    dnll_dlambda += (1 / (beta ** 2 * lambda_)) * float(weights @ weights)
    dnll_dlambda += (ndatapoints - m) / lambda_
    dnll_dlambda += lambda_ * float(torch.sum(chol_inv ** 2))
    grad[0] = dnll_dlambda

    for i in range(grad.shape[0] - 1):
        trace_term = cho_solve_lower(chol, inner_deriv[:, :, i])
        dnll_dsigma = -2 * float(weights @ dz_dsigma_ty[:, i])
        dnll_dsigma += float(weights @ (inner_deriv[:, :, i] @ weights))
        dnll_dsigma *= 0.5 / alpha ** 2
        dnll_dsigma += 0.5 * float(torch.trace(trace_term))
        grad[i + 1] = dnll_dsigma

    grad *= np.asarray(hparams)
    return negloglik, grad, beta
