"""Fast Walsh-Hadamard transform (port of xgpr_tpu/ops/hadamard.py).

Same Kronecker factorisation H_n = H_a (x) H_b (x) ... (each factor <= 128)
as the JAX package, so a length-n transform is a few small dense +-1
matmuls over a reshaped batch.  On the card these are plain torch.matmul
in full fp32 (TF32 off, see config.py); nothing on the slice's hot path
runs an FWHT (the dense projection replaces it), so no kernel is needed.
"""
from functools import lru_cache

import numpy as np
import torch

_MAX_FACTOR_LOG2 = 7


@lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    """Unnormalised +-1 Hadamard matrix of size n (n a power of two)."""
    if n < 1 or (n & (n - 1)) != 0:
        raise ValueError(f"Hadamard size must be a power of two, got {n}.")
    h = np.ones((1, 1), dtype=np.float64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_matrix(n: int, dtype=torch.float32, device="cuda"):
    """The unnormalised +-1 Hadamard matrix of size n (a power of two) on
    ``device`` ("cuda" by default, as every entry point of the port)."""
    return torch.as_tensor(_hadamard_np(n), dtype=dtype, device=device)


@lru_cache(maxsize=None)
def _factorize(n: int):
    """Split n = 2^k into balanced power-of-two factors, each <= 128."""
    if n < 1 or (n & (n - 1)) != 0:
        raise ValueError(f"FWHT length must be a power of two, got {n}.")
    k = n.bit_length() - 1
    if k == 0:
        return (1,)
    nparts = -(-k // _MAX_FACTOR_LOG2)
    base, rem = divmod(k, nparts)
    logs = [base + (1 if i < rem else 0) for i in range(nparts)]
    return tuple(1 << l for l in logs)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised fast Walsh-Hadamard transform along the last axis
    (natural ordering, no 1/sqrt(n)); the last axis must be a power of 2."""
    n = x.shape[-1]
    if n == 1:
        return x
    factors = _factorize(n)
    batch_shape = tuple(x.shape[:-1])
    nb = len(batch_shape)
    x = x.reshape(batch_shape + factors)
    for i, f in enumerate(factors):
        h = hadamard_matrix(f, x.dtype, x.device)
        x = torch.tensordot(x, h, dims=([nb + i], [0]))
        x = torch.movedim(x, -1, nb + i)
    return x.reshape(batch_shape + (n,))


def fwht_normalized(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal Walsh-Hadamard transform (H / sqrt(n)) along the last
    axis."""
    n = x.shape[-1]
    return fwht(x) * (1.0 / np.sqrt(n))


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 2) (the reference's input padding)."""
    n = max(int(n), 2)
    return 1 << (n - 1).bit_length()
