"""Alpha/beta nuisance-parameter optimisation for NMLL (port of
xgpr_tpu/scoring/alpha_beta.py, a copy: the module is numpy only).

lambda is the ratio alpha/beta; for a fixed ratio the fit is unchanged
but the marginal likelihood depends on beta, so report the best
achievable NMLL with beta clipped to [0.1, 10].
"""
import numpy as np


def optimize_alpha_beta(lambda_, nll_terms, ndatapoints, nrffs,
                        beta_max=10., beta_min=0.1):
    """Returns (score, beta) for nll_terms = [0.5(y^Ty - y^T Z w),
    0.5 ln|Z^T Z + lambda^2 I|]."""
    beta = np.sqrt(2 * nll_terms[0] / (ndatapoints * lambda_ ** 2))
    beta = max(min(beta, beta_max), beta_min)
    score = nll_terms[0] / (beta * lambda_) ** 2 \
        + (ndatapoints - nrffs) * np.log(lambda_)
    score += nll_terms[1] + ndatapoints * np.log(beta)
    return score + 0.5 * ndatapoints * np.log(2 * np.pi), beta
