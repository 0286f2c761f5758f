"""Plain reference of the fit, the predictions and the NMLL, from the
features of reference/features.py, in float64.

- ``gram``: Z^T Z, Z^T y and y^T y over the rows in blocks.
- ``Fit``: the exact weights, solve(Z^T Z + lambda^2 I, Z^T y), by a
  Cholesky factor; the variance matrix pinv(Z_v^T Z_v + lambda^2 I) over
  the variance columns (with numpy's default cutoff of the port,
  10 * rank * eps); mean and variance of new rows, y de-normalised.
- ``exact_nmll``: the NMLL from the Cholesky factor, lambda as given and
  the amplitude optimised in closed form.
- ``slq_nmll``: the SLQ estimate the port computes, worked out again
  from the Gram matrix: a frozen copy of the two-pass SRHT Nystrom
  preconditioner (the sketch S Z^T Z, a QR, a Z^T Z Q pass, eigh
  whitening), the probes of the model seed shaped by P^(1/2), one batched
  preconditioned CG over the fit column and the probes, the Lanczos
  tridiagonals from the CG coefficients and their Gauss quadrature.  The
  same probes and sketch make the estimator's own error cancel, so what
  is left is the port's arithmetic.

Nothing here imports the port.
"""
import math

import numpy as np
import torch
from scipy.linalg import eigh_tridiagonal

from .features import tf32

# Rows of a block of features: (block, num_rffs) float64 and the window
# projections of a convolution block stay within a few GB.
BLOCK_ROWS = 4096


def gram(fmap, x, y, sigma, lengths=None, precision="float64",
         block=BLOCK_ROWS):
    """(Z^T Z, Z^T y, y^T y) over rows x (and float64 y, already
    normalised), features at ``precision``.  In float64 every product
    and sum is float64.  At "tf32" (the control) a block's products
    take TF32-rounded operands and sum in float32, as the port's float32
    chunk products would on TF32 tensor cores, and the blocks sum in
    float64, as the port's chunks do."""
    m = fmap.num_rffs
    dev = fmap.device
    g = torch.zeros((m, m), dtype=torch.float64, device=dev)
    zty = torch.zeros((m,), dtype=torch.float64, device=dev)
    for lo in range(0, x.shape[0], block):
        hi = min(lo + block, x.shape[0])
        z = fmap.features(x[lo:hi].to(dev), sigma,
                          None if lengths is None else lengths[lo:hi].to(dev),
                          precision)
        yb = y[lo:hi].to(dev)
        if precision == "tf32":
            z = tf32(z.float())
            g += (z.T @ z).double()
            zty += (z.T @ tf32(yb.float())).double()
        else:
            g.addmm_(z.T, z)
            zty += z.T @ yb
    yty = float(y.double() @ y.double())
    return g, zty, yty


def optimize_alpha_beta(lambda_, nll_terms, ndatapoints, nrffs,
                        beta_max=10., beta_min=0.1):
    """The NMLL of [0.5 (y^T y - y^T Z w), 0.5 ln|Z^T Z + lambda^2 I|]
    with the amplitude beta chosen in closed form, clipped to
    [beta_min, beta_max]."""
    beta = math.sqrt(2 * nll_terms[0] / (ndatapoints * lambda_ ** 2))
    beta = max(min(beta, beta_max), beta_min)
    score = nll_terms[0] / (beta * lambda_) ** 2 \
        + (ndatapoints - nrffs) * math.log(lambda_)
    score += nll_terms[1] + ndatapoints * math.log(beta)
    return score + 0.5 * ndatapoints * math.log(2 * math.pi)


def _regularised(g, lambda_):
    return g + lambda_ ** 2 * torch.eye(g.shape[0], dtype=g.dtype,
                                        device=g.device)


def exact_nmll(g, zty, yty, lambda_, ndatapoints):
    chol = torch.linalg.cholesky(_regularised(g, lambda_))
    w = torch.cholesky_solve(zty[:, None], chol)[:, 0]
    nll1 = 0.5 * (yty - float(zty @ w))
    nll2 = float(torch.log(torch.diagonal(chol)).sum())
    return optimize_alpha_beta(lambda_, [nll1, nll2], ndatapoints,
                               g.shape[0])


class Fit:
    """The exact fit of one Gram matrix: weights and variance matrix."""

    def __init__(self, g, zty, lambda_, var_cols=None):
        self.lambda_ = lambda_
        chol = torch.linalg.cholesky(_regularised(g, lambda_))
        self.weights = torch.cholesky_solve(zty[:, None], chol)[:, 0]
        self.var_cols = var_cols
        self.var_mat = None
        if var_cols is not None:
            gv = g[var_cols][:, var_cols]
            a = _regularised(gv, lambda_)
            self.var_mat = torch.linalg.pinv(
                a, rtol=10 * a.shape[0] * torch.finfo(a.dtype).eps)

    def predict(self, z, y_mean, y_std):
        """(mean, variance) of feature rows z (N, M) float64; variance
        None without a variance matrix."""
        mean = (z @ self.weights) * y_std + y_mean
        if self.var_mat is None:
            return mean, None
        zv = z[:, self.var_cols]
        lam2 = self.lambda_ ** 2
        var = lam2 + lam2 * ((zv @ self.var_mat) * zv).sum(1)
        return mean, torch.clamp(var, min=0.0) * y_std ** 2


# ----------------------------------------------------------------------
# The SLQ estimate, from the Gram matrix.
def srht_state(seed, input_size, rank):
    """Rademacher diagonal and sampled columns of the SRHT, drawn as the
    port draws them."""
    padded = 1 << (max(int(input_size), 2) - 1).bit_length()
    rng = np.random.default_rng(seed)
    radem = rng.choice(np.asarray([-1, 1], dtype=np.int8), size=(padded,),
                       replace=True).astype(np.float64)
    perm = rng.permutation(padded)
    return radem, perm[:rank]


def normal_probes(seed, num_rffs, nsamples):
    return np.random.default_rng(seed).standard_normal(
        size=(num_rffs, nsamples))


def _fwht(x):
    """Unnormalised Walsh-Hadamard transform along the last axis, in the
    Sylvester (natural) order."""
    shape, n = x.shape, x.shape[-1]
    x = x.reshape(-1, n)
    h = 1
    while h < n:
        x = x.reshape(-1, n // (2 * h), 2, h)
        x = torch.stack((x[:, :, 0] + x[:, :, 1], x[:, :, 0] - x[:, :, 1]),
                        dim=2).reshape(-1, n)
        h *= 2
    return x.reshape(shape)


def _tall_svd(b):
    ev, v = torch.linalg.eigh(b.T @ b)
    ev = torch.clamp(torch.flip(ev, dims=[0]), min=0.0)
    v = torch.flip(v, dims=[1])
    s = torch.sqrt(ev)
    inv_s = torch.where(s > 1e-14, 1.0 / torch.where(s > 1e-14, s, 1.0), 0.0)
    return b @ (v * inv_s[None, :]), s


class Nystrom:
    """Two-pass SRHT Nystrom preconditioner of Z^T Z + lambda^2 I from
    the Gram matrix g: the sketch S Z^T Z, Q = qr(sketch), g Q, and the
    whitening of Q^T g Q."""

    def __init__(self, g, lambda_, rank, seed):
        m = g.shape[0]
        radem, idx = srht_state(seed, m, rank)
        p = radem.shape[0]
        radem = torch.as_tensor(radem, device=g.device)
        gp = torch.nn.functional.pad(g, (0, p - m))
        acc = _fwht(gp * radem / math.sqrt(p))[:, torch.as_tensor(
            idx, device=g.device)]                       # (M, rank)
        q = torch.linalg.qr(acc)[0]
        acc = g @ q
        small = q.T @ acc
        e_val, e_vec = torch.linalg.eigh(small)
        floor = torch.clamp(e_val[-1], min=0.0) * (
            torch.finfo(acc.dtype).eps * small.shape[0])
        inv_sqrt = torch.where(
            e_val > floor,
            1.0 / torch.sqrt(torch.where(e_val > floor, e_val, 1.0)), 0.0)
        u, s = _tall_svd(acc @ (e_vec * inv_sqrt[None, :]))
        eig = torch.clamp(s ** 2, min=0)
        self.u = u
        self.eig = eig + lambda_ ** 2
        self.inv_eig = torch.where(self.eig > 1e-14, 1.0 / self.eig, 0.0)
        self.prefactor = float(eig.min() + lambda_ ** 2)

    def _reweight(self, v, spectrum):
        coords = self.u.T @ v
        return v - self.u @ coords + self.u @ (spectrum[:, None] * coords)

    def inverse(self, v):
        return self._reweight(v, self.prefactor * self.inv_eig)

    def root(self, v):
        return self._reweight(v, torch.sqrt(torch.clamp(self.eig, min=0)
                                            / self.prefactor))

    def logdet(self):
        ratio = 1 + (self.eig - self.prefactor) / self.prefactor
        return float(torch.log(torch.clamp(ratio, min=1e-12)).sum())


def _pcg(g, precond, rhs, lambda_, max_iter, tol):
    """Batched PCG on (g + lambda^2) x = rhs with the port's per-column
    breakdown freeze; returns (x, alphas, betas) of the iterations run."""
    k = rhs.shape[1]
    init = torch.sqrt((rhs * rhs).sum(0))
    p = precond(rhs)
    rz = (rhs * p).sum(0)
    x = torch.zeros_like(rhs)
    r = rhs
    active = torch.ones((k,), dtype=torch.bool, device=rhs.device)
    converged = torch.zeros_like(active)
    alphas, betas = [], []
    lam2 = lambda_ ** 2
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        w = g @ p + lam2 * p
        pw = (p * w).sum(0)
        alpha_raw = rz / pw
        active = active & torch.isfinite(alpha_raw) & (pw > 0)
        alpha = torch.where(active, alpha_raw, 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * w
        converged = converged | (torch.sqrt((r * r).sum(0)) / init < tol)
        z = precond(r)
        rz_next = (r * z).sum(0)
        active = active & (rz_next > 0)
        beta = torch.where(active, rz_next / rz, 0.0)
        p = torch.where(active[None, :], z + beta[None, :] * p, p)
        active = active & ~torch.all(converged | ~active)
        alphas.append(alpha)
        betas.append(beta)
        rz = rz_next
    return x, torch.stack(alphas).cpu().numpy(), \
        torch.stack(betas).cpu().numpy()


def _quadrature_logdet(alphas, betas, num_rffs):
    """num_rffs times the mean over probes of the Gauss quadrature of
    log on each probe's Lanczos tridiagonal, cut at its first alpha <= 0."""
    logdets = []
    for a, b in zip(alphas.T, betas.T):
        bad = ~(a > 0)
        length = int(np.argmax(bad)) if bad.any() else a.shape[0]
        if length < 1:
            continue
        a = a[:length]
        b = np.clip(b[:length], 0.0, None)
        diag = 1.0 / a
        diag[1:] += b[:-1] / a[:-1]
        if length > 1:
            vals, vecs = eigh_tridiagonal(diag, (np.sqrt(b) / a)[:-1],
                                          lapack_driver="stev")
        else:
            vals, vecs = diag[:1], np.ones((1, 1))
        logdets.append((vecs[0] ** 2 * np.log(np.clip(vals, 1e-30, None)))
                       .sum())
    return num_rffs * float(np.mean(logdets))


def slq_nmll(g, zty, yty, lambda_, ndatapoints, seed, rank, nsamples=25,
             max_iter=500, tol=1e-6):
    """The SLQ NMLL of the port's ``approximate_nmll`` with a rank-``rank``
    two-pass preconditioner, from the Gram matrix."""
    m = g.shape[0]
    pre = Nystrom(g, lambda_, rank, seed)
    probes = pre.root(torch.as_tensor(normal_probes(seed, m, nsamples),
                                      device=g.device))
    rhs = torch.cat([zty[:, None] / ndatapoints, probes], dim=1)
    x, alphas, betas = _pcg(g, pre.inverse, rhs, lambda_, max_iter, tol)
    x0 = x[:, 0] * ndatapoints
    logdet = _quadrature_logdet(alphas[:, 1:], betas[:, 1:], m) + pre.logdet()
    nll1 = 0.5 * (yty - float(zty @ x0))
    return optimize_alpha_beta(lambda_, [nll1, 0.5 * logdet], ndatapoints, m)
