"""Plain random-feature reference: the state draw, the dense projection
and the RBF and convolution features, worked out from a model seed.

Frozen copies of the draw the port makes (numpy ``default_rng(seed)``
Rademacher diagonals, scipy ``chi.rvs(random_state=seed)``, both drawn in
float32 as the port draws them) and of the SORF algebra: each block of
the projection is H D2 H D1 H D0 / P^1.5 with H the Sylvester Hadamard
matrix, here a dense matrix product in float64.  Features are laid out as
the port lays them out, [cos b0 | sin b0 | cos b1 | ...] over blocks of
P frequencies, so that weights and variance columns compare position by
position.  Nothing here imports the port.

``precision`` is "float64" (the reference: float64 projection and
sincos) or "tf32" (the control: both operands of the projection rounded
to TF32, products summed in float32, float32 sincos), the precision
below the float32 features the configurations state.
"""
import math

import numpy as np
import scipy.linalg
import torch
from scipy.stats import chi as chi_dist

PRECISIONS = ("float64", "tf32")


def next_pow2(n):
    """Smallest power of two >= max(n, 2)."""
    n = max(int(n), 2)
    return 1 << (n - 1).bit_length()


def radem_diagonals(seed, nblocks, padded):
    """(3, nblocks, padded) +-1 diagonals, drawn as the port draws them."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(np.asarray([-1, 1], dtype=np.int8),
                      size=(3, 1, nblocks * padded), replace=True)
    return flat.reshape(3, nblocks, padded).astype(np.float32)


def chi_scaling(seed, padded, num_freqs):
    """(num_freqs,) chi(df=padded) draws, in float32 as the port draws."""
    return chi_dist.rvs(df=padded, size=num_freqs,
                        random_state=seed).astype(np.float32)


class FeatureMap:
    """The random-feature state of one model seed and its features.

    ``kind`` is "rbf" (fixed vectors, D = input width) or "conv"
    (windows of ``width`` positions, D = width * channels).
    """

    def __init__(self, kind, input_dim, num_rffs, seed, width=1,
                 intercept=True, device="cpu"):
        if kind not in ("rbf", "conv"):
            raise ValueError(f"unknown feature kind {kind!r}")
        self.kind, self.width, self.intercept = kind, width, intercept
        self.device = torch.device(device)
        self.num_rffs = num_rffs
        self.num_freqs = num_rffs // 2
        self.input_dim = input_dim * (width if kind == "conv" else 1)
        self.padded = next_pow2(self.input_dim)
        if self.num_freqs > self.padded and self.num_freqs % self.padded:
            raise ValueError("ragged frequency blocks are not covered")
        nblocks = max(1, math.ceil(self.num_freqs / self.padded))
        radem = radem_diagonals(seed, nblocks, self.padded).astype(np.float64)
        chi = chi_scaling(seed, self.padded, self.num_freqs).astype(np.float64)
        h = scipy.linalg.hadamard(self.padded).astype(np.float64)
        norm = self.padded ** -1.5
        blocks = [(h @ (radem[2, b][:, None] * h) @ (radem[1, b][:, None] * h)
                   * radem[0, b][None, :])[:, :self.input_dim] * norm
                  for b in range(nblocks)]
        proj = np.concatenate(blocks, axis=0)[:self.num_freqs] * chi[:, None]
        # (input_dim, F): x @ proj is the projection of a row.
        self.proj = torch.as_tensor(proj.T.copy(), device=self.device)
        self._proj_tf32 = tf32(self.proj.float())
        if kind == "conv":
            self.scale = math.sqrt(1.0 / self.num_freqs)
        else:
            denom = self.num_freqs - 0.5 if intercept else self.num_freqs
            self.scale = math.sqrt(1.0 / denom)

    def _project(self, x, precision):
        if precision == "float64":
            return x.double() @ self.proj
        if precision == "tf32":
            return tf32(x.float()) @ self._proj_tf32
        raise ValueError(f"unknown precision {precision!r}")

    def parts(self, x, sigma, lengths=None, precision="float64"):
        """(cos, sin), each (N, F), before the layout: for "rbf" of rows x
        (N, D); for "conv" summed over each row's valid windows of x
        (N, L, C) with ``lengths`` (N,)."""
        if self.kind == "rbf":
            arg = self._project(x, precision) * sigma
            return torch.cos(arg) * self.scale, torch.sin(arg) * self.scale
        n, seq_len, chans = x.shape
        nw = seq_len - self.width + 1
        win = x.unfold(1, self.width, 1).transpose(2, 3).reshape(
            n, nw, self.width * chans)
        arg = self._project(win, precision) * sigma
        valid = (torch.arange(nw, device=x.device)[None, :] <
                 (lengths.long() - self.width + 1)[:, None]).to(arg.dtype)
        c = (torch.cos(arg) * valid[:, :, None]).sum(1) * self.scale
        s = (torch.sin(arg) * valid[:, :, None]).sum(1) * self.scale
        return c, s

    def features(self, x, sigma, lengths=None, precision="float64"):
        """(N, num_rffs) features in the block layout, float64, with the
        intercept's column 0 set to 1."""
        c, s = self.parts(x, sigma, lengths, precision)
        n = c.shape[0]
        nb = max(1, self.num_freqs // self.padded)
        width = self.num_freqs // nb
        z = torch.cat([c.reshape(n, nb, width), s.reshape(n, nb, width)],
                      dim=2).reshape(n, 2 * self.num_freqs).double()
        if self.intercept:
            z[:, 0] = 1.0
        return z

    def variance_columns(self, variance_rffs):
        """Columns of the cos/sin pairs of the first variance_rffs / 2
        frequencies, in the block layout."""
        k = variance_rffs // 2
        freq = np.arange(k)
        width = min(self.padded, self.num_freqs)
        block, within = freq // width, freq % width
        cols = np.empty(2 * k, dtype=np.int64)
        cols[0::2] = block * 2 * width + within
        cols[1::2] = block * 2 * width + width + within
        return torch.as_tensor(cols, device=self.device)


def tf32(t):
    """float32 ``t`` rounded to TF32 (10 explicit mantissa bits), to
    nearest, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
