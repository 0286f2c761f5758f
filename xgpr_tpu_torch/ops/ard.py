"""Dense SORF weights (port of xgpr_tpu/ops/ard.py::precompute_sorf_weights;
the MiniARD gradient op waits for the MiniARD kernel)."""
import math

import torch

from .hadamard import fwht


def precompute_sorf_weights(radem, chi, input_dim: int):
    """Dense (num_freqs, input_dim) matrix W with x @ W.T == SORF(x) * chi,
    built by SORF-transforming the identity one block at a time."""
    p = radem.shape[-1]
    nblocks = radem.shape[1]
    num_freqs = chi.shape[0]
    eye = torch.eye(p, dtype=chi.dtype, device=chi.device)
    norm = torch.tensor(1.0 / math.sqrt(p), dtype=chi.dtype,
                        device=chi.device)
    blocks = []
    for b in range(nblocks):
        m = eye * (radem[0, b] * norm)
        m = fwht(m)
        m = m * (radem[1, b] * norm)
        m = fwht(m)
        m = m * (radem[2, b] * norm)
        m = fwht(m)
        blocks.append(m.T[:, :input_dim])
    w = torch.cat(blocks, dim=0)[:num_freqs, :]
    return w * chi[:, None]
