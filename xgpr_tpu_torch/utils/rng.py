"""Deterministic host-side projection state.

All random projection state (Rademacher diagonals, chi scaling arrays,
column permutations) is generated on the host from a single integer seed with
numpy's default_rng, exactly as the reference does
(sorf_kernel_baseclass.py:74-84).  This guarantees every host in a multi-host
mesh materialises identical state with no communication -- requirement (d) of
SURVEY.md section 2.9.
"""
import numpy as np
from scipy.stats import chi as chi_dist

from ..ops.hadamard import next_pow2


def radem_diagonals(seed: int, nblocks: int, padded_dim: int,
                    dtype=np.float32) -> np.ndarray:
    """(3, nblocks, padded_dim) Rademacher +-1 diagonals.

    Drawn exactly like the reference (rng.choice([-1, 1], size=(3, 1,
    nblocks*padded)), sorf_kernel_baseclass.py:76-81) then reshaped so each
    block's diagonal slice is explicit.
    """
    rng = np.random.default_rng(seed)
    flat = rng.choice(np.asarray([-1, 1], dtype=np.int8),
                      size=(3, 1, nblocks * padded_dim), replace=True)
    return flat.reshape(3, nblocks, padded_dim).astype(dtype)


def chi_scaling(seed: int, padded_dim: int, num_freqs: int,
                dtype=np.float32) -> np.ndarray:
    """(num_freqs,) chi(df=padded_dim) draws (sorf_kernel_baseclass.py:82)."""
    arr = chi_dist.rvs(df=padded_dim, size=num_freqs, random_state=seed)
    return arr.astype(dtype)


def matern_chi_modifier(seed: int, num_freqs: int, nu: float,
                        dtype=np.float32) -> np.ndarray:
    """Divisor turning RBF frequencies into Matern ones: sqrt(chi2(2nu)/2nu)
    (matern.py:50-54)."""
    rng = np.random.default_rng(seed)
    return np.sqrt(rng.chisquare(2 * nu, size=num_freqs) / (2 * nu)
                   ).astype(dtype)


def cauchy_chi_modifier(seed: int, num_freqs: int,
                        dtype=np.float32) -> np.ndarray:
    """Multiplier for Cauchy kernel: sqrt(Exp(1)) draws (cauchy.py:39-41)."""
    rng = np.random.default_rng(seed)
    return np.sqrt(rng.exponential(size=num_freqs)).astype(dtype)


def srht_state(seed: int, input_size: int, compression_size: int,
               dtype=np.float32):
    """Rademacher diagonal + truncated column permutation for SRHT
    (srht_compressor.py:60-66)."""
    padded = next_pow2(input_size)
    rng = np.random.default_rng(seed)
    radem = rng.choice(np.asarray([-1, 1], dtype=np.int8), size=(padded,),
                       replace=True).astype(dtype)
    perm = rng.permutation(padded)
    return radem, perm[:compression_size].astype(np.int32)


def normal_probes(seed: int, num_rffs: int, nsamples: int,
                  dtype=np.float64) -> np.ndarray:
    """(num_rffs, nsamples) standard-normal probe vectors
    (probe_generators.py:9-31)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(size=(num_rffs, nsamples)).astype(dtype)


def rademacher_probes(seed: int, num_rffs: int, nsamples: int,
                      dtype=np.float64) -> np.ndarray:
    """Unit-normalised Rademacher probes (probe_generators.py:34-51)."""
    rng = np.random.default_rng(seed)
    probes = rng.choice(np.asarray([-1.0, 1.0]),
                        size=(num_rffs, nsamples), replace=True)
    probes /= np.linalg.norm(probes, axis=0)[None, :]
    return probes.astype(dtype)


def exact_count_keep_mask(mask, keep_frac: float, rng) -> np.ndarray:
    """0/1 keep mask selecting an exact per-chunk count of real rows.

    The reference's sampled ratio check draws ``max(int(frac * rows), 1)``
    rows per chunk without replacement (rand_nys_constructors.py:82-84),
    so the realised sample fraction equals the nominal one and the
    ``/ sample_frac`` rescale of the estimated eigenvalues is unbiased.
    A Bernoulli(p) mask makes the realised fraction itself random, which
    directly perturbs the estimate.  ``mask`` marks real (non-padding)
    rows of a fixed-shape chunk; only those are sampled from.
    """
    mask = np.asarray(mask)   # callers pass host arrays; one conversion
    real = np.flatnonzero(mask > 0)
    keep = np.zeros(mask.shape[0], dtype=np.float64)
    if real.size == 0:
        return keep
    cutoff = max(int(keep_frac * real.size), 1)
    sel = rng.permutation(real.size)[:cutoff]
    keep[real[sel]] = 1.0
    return keep
