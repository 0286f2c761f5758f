"""Block [cos | sin] feature layout (port of xgpr_tpu/ops/layout.py).

    [cos b0 | sin b0 | cos b1 | sin b1 | ...]

where block b covers frequencies [b*P, min(F, (b+1)*P)) for padded dim P.
The layout is a bijection on feature positions, so every reduction is
unchanged; ``freq_positions`` maps frequency i to its (cos, sin) columns
and ``variance_column_indices`` keeps the reference's cos/sin-paired
"first variance_rffs features" truncation.
"""
from math import ceil

import numpy as np
import torch


def block_widths(num_freqs, padded):
    """Widths of each frequency block (the last may be ragged)."""
    if num_freqs <= padded:
        return [num_freqs]
    nblocks = ceil(num_freqs / padded)
    widths = [padded] * (nblocks - 1)
    widths.append(num_freqs - padded * (nblocks - 1))
    return widths


def assemble_cos_sin(cosv, sinv, padded):
    """Assemble (N, F) cos and sin parts into the (N, 2F) block layout."""
    n, f = cosv.shape
    widths = block_widths(f, padded)
    if len(widths) == 1:
        return torch.cat([cosv, sinv], dim=1)
    if all(w == widths[0] for w in widths):
        w, nb = widths[0], len(widths)
        return torch.cat([cosv.reshape(n, nb, w), sinv.reshape(n, nb, w)],
                         dim=2).reshape(n, 2 * f)
    parts, start = [], 0
    for w in widths:
        parts.append(cosv[:, start:start + w])
        parts.append(sinv[:, start:start + w])
        start += w
    return torch.cat(parts, dim=1)


def freq_positions(num_freqs, padded):
    """(cos_pos, sin_pos) int arrays: column of cos/sin of frequency i."""
    widths = block_widths(num_freqs, padded)
    cos_pos = np.zeros(num_freqs, dtype=np.int64)
    sin_pos = np.zeros(num_freqs, dtype=np.int64)
    start_freq, start_col = 0, 0
    for w in widths:
        idx = np.arange(w)
        cos_pos[start_freq:start_freq + w] = start_col + idx
        sin_pos[start_freq:start_freq + w] = start_col + w + idx
        start_freq += w
        start_col += 2 * w
    return cos_pos, sin_pos


def variance_column_indices(num_freqs, padded, variance_rffs):
    """Columns of the cos/sin pairs of the first variance_rffs/2
    frequencies."""
    cos_pos, sin_pos = freq_positions(num_freqs, padded)
    k = variance_rffs // 2
    cols = np.empty(2 * k, dtype=np.int64)
    cols[0::2] = cos_pos[:k]
    cols[1::2] = sin_pos[:k]
    return cols
