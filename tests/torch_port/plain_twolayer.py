"""A plain float64 reference of Conv1dTwoLayer, written from the kernel's
equations: no JAX, no ``xgpr_tpu_torch``, no kernel.

Layer 1 (hyperparameter-free): every window of ``width`` positions of a
row x (L, C), flattened position-major (t * C + c), is projected by the
dense SORF matrix of the model seed, and the row's profile is the
elementwise max over its valid windows (j < length - width + 1) against
0 (a ReLU on a global max-pool), ``init_rffs`` values.

Layer 2: the RBF random features of sigma times the profile, under the
state of a second seed, seed2 = default_rng(seed).integers(0, 2**31 - 1):
cos and sin of the projection in blocks of P frequencies, [cos b0 | sin b0
| cos b1 | ...], times sqrt(1 / (F - 1/2)), and column 0 set to 1 (the
intercept).

The state is drawn as the port draws it: numpy Rademacher diagonals
(3, blocks, P) and scipy chi(df=P) scalings from the seed, in float32
(float64 with ``double_precision``); a block of the projection is
H D2 H D1 H D0 / P^1.5 (H the Sylvester Hadamard matrix) with the chi
draws on its rows.  The fit is the exact ridge solution by a Cholesky
factor, weights = solve(Z^T Z + lambda^2 I, Z^T y_n) on y normalised by
its mean and (population) std; the variance is lambda^2 (1 + z_v^T
pinv(Z_v^T Z_v + lambda^2 I) z_v) y_std^2 over the variance columns, the
pseudo-inverse at the cutoff 10 * rank * eps.

``precision="tf32"`` is a control: both layers' projections take
operands rounded to TF32 and sum in float32, a precision below the
float32 features the port states.
"""
import math

import numpy as np
import scipy.linalg
import torch
from scipy.stats import chi as chi_dist

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def next_pow2(n):
    n = max(int(n), 2)
    return 1 << (n - 1).bit_length()


def tf32(t):
    """float32 ``t`` rounded to TF32: 10 mantissa bits, to nearest, ties
    away from zero."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def sorf_matrix(seed, input_dim, num_freqs, state_dtype=np.float32):
    """(input_dim, num_freqs) float64: x @ it projects a row."""
    padded = next_pow2(input_dim)
    nblocks = max(1, math.ceil(num_freqs / padded))
    rng = np.random.default_rng(seed)
    radem = rng.choice(np.asarray([-1, 1], dtype=np.int8),
                       size=(3, 1, nblocks * padded), replace=True)
    radem = radem.reshape(3, nblocks, padded).astype(state_dtype)
    chi = chi_dist.rvs(df=padded, size=num_freqs,
                       random_state=seed).astype(state_dtype)
    h = scipy.linalg.hadamard(padded).astype(np.float64)
    d = radem.astype(np.float64)
    blocks = [(h @ (d[2, b][:, None] * h) @ (d[1, b][:, None] * h)
               * d[0, b][None, :])[:, :input_dim] for b in range(nblocks)]
    proj = np.concatenate(blocks)[:num_freqs] * padded ** -1.5
    proj = proj * chi.astype(np.float64)[:, None]
    return torch.as_tensor(proj.T.copy())


def second_seed(seed):
    return int(np.random.default_rng(seed).integers(0, 2 ** 31 - 1))


def _matmul(a, b, precision):
    if precision == "float64":
        return a.double() @ b.double()
    if precision == "tf32":
        return (tf32(a) @ tf32(b)).double()
    raise ValueError(f"unknown precision {precision!r}")


class TwoLayer:
    """The two layers' state of one model seed, and their outputs."""

    def __init__(self, channels, width, init_rffs, num_rffs, seed,
                 state_dtype=np.float32):
        self.width, self.num_freqs = width, num_rffs // 2
        self.proj1 = sorf_matrix(seed, width * channels, init_rffs,
                                 state_dtype)
        self.proj2 = sorf_matrix(second_seed(seed), init_rffs,
                                 self.num_freqs, state_dtype)
        self.padded2 = next_pow2(init_rffs)

    def profile(self, x, lengths, precision="float64"):
        """(N, init_rffs): max(0, max over valid windows of the
        window's projection)."""
        x = torch.as_tensor(x)
        n, seq_len, chans = x.shape
        nw = seq_len - self.width + 1
        win = x.unfold(1, self.width, 1).transpose(2, 3).reshape(
            n, nw, self.width * chans)
        g = _matmul(win, self.proj1, precision)
        valid = torch.arange(nw)[None, :] < \
            (torch.as_tensor(lengths).long() - self.width + 1)[:, None]
        g = torch.where(valid[:, :, None], g, -math.inf)
        return torch.clamp_min(g.amax(dim=1), 0.0)

    def features(self, x, lengths, sigma, precision="float64"):
        """(N, num_rffs) float64 features in the block layout, column 0
        the intercept's 1."""
        arg = _matmul(self.profile(x, lengths, precision) * sigma,
                      self.proj2, precision)
        c, s = torch.cos(arg), torch.sin(arg)
        n = arg.shape[0]
        width = min(self.padded2, self.num_freqs)
        nb = self.num_freqs // width
        z = torch.cat([c.reshape(n, nb, width), s.reshape(n, nb, width)],
                      dim=2).reshape(n, 2 * self.num_freqs)
        z = z * math.sqrt(1.0 / (self.num_freqs - 0.5))
        z[:, 0] = 1.0
        return z

    def variance_columns(self, variance_rffs):
        """The cos and sin columns of the first variance_rffs / 2
        frequencies, interleaved."""
        k = np.arange(variance_rffs // 2)
        width = min(self.padded2, self.num_freqs)
        base = (k // width) * 2 * width + k % width
        return torch.as_tensor(np.stack([base, base + width], 1).reshape(-1))


class ExactFit:
    """The exact ridge fit of feature rows z (N, M) float64 to y."""

    def __init__(self, z, y, lambda_, var_cols):
        y = torch.as_tensor(np.asarray(y), dtype=torch.float64)
        self.y_mean, self.y_std = float(y.mean()), float(y.std(
            unbiased=False))
        yn = (y - self.y_mean) / self.y_std
        lam2 = lambda_ ** 2
        self.lam2 = lam2
        g = z.T @ z
        chol = torch.linalg.cholesky(g + lam2 * torch.eye(g.shape[0],
                                                          dtype=g.dtype))
        self.weights = torch.cholesky_solve((z.T @ yn)[:, None], chol)[:, 0]
        self.var_cols = var_cols
        a = g[var_cols][:, var_cols] + lam2 * torch.eye(len(var_cols),
                                                        dtype=g.dtype)
        self.var_mat = torch.linalg.pinv(
            a, rtol=10 * a.shape[0] * torch.finfo(a.dtype).eps)

    def predict(self, z):
        """(mean, variance) of feature rows z."""
        mean = (z @ self.weights) * self.y_std + self.y_mean
        zv = z[:, self.var_cols]
        var = self.lam2 + self.lam2 * ((zv @ self.var_mat) * zv).sum(1)
        return mean, torch.clamp(var, min=0.0) * self.y_std ** 2
