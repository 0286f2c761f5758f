"""The motif corpus of the 1M north star, made on the device from a seed.

A torch rewrite of ``chip_smoke.py::motif_corpus`` (itself a copy of
``scripts/million_point_tune_fit.py::_generate_motif``): one-hot letters
from a ``alphabet``-symbol alphabet plus Gaussian noise, lengths uniform
on [width, L], and an anchor-RBF target averaged over each row's valid
windows, standardised to 0.4 and given Gaussian noise.  The draws come
from a ``torch.Generator`` on ``device`` in a few large calls, so a
million rows take seconds on the card; the numpy original builds the
target on the host, which at 1M rows takes minutes.  The draws differ
from the numpy original's; the distribution is the same.
"""
import torch

# Rows a generation step holds: the one-hot block and its noise, and the
# target's float64 window stack (rows x windows x w*D).
_BLOCK = 65_536


def generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def sequences(gen, rows, seq_len, dim, width, alphabet, noise, device):
    """(x (rows, L, D) float32, lengths (rows,) int32) on ``device``."""
    letters = torch.randint(0, alphabet, (rows, seq_len), generator=gen,
                            device=device)
    lengths = torch.randint(width, seq_len + 1, (rows,), generator=gen,
                            device=device, dtype=torch.int32)
    x = torch.empty((rows, seq_len, dim), dtype=torch.float32, device=device)
    for lo in range(0, rows, _BLOCK):
        hi = min(lo + _BLOCK, rows)
        block = torch.randn((hi - lo, seq_len, dim), generator=gen,
                            device=device) * noise
        block.scatter_add_(2, letters[lo:hi, :, None],
                           torch.ones((hi - lo, seq_len, 1), device=device))
        x[lo:hi] = block
    return x, lengths


def windows(x, width):
    """(N, nw, w*D) windows of (N, L, D) rows, window j x[:, j:j+w, :]
    flattened position-major."""
    n, seq_len, dim = x.shape
    return x.unfold(1, width, 1).transpose(2, 3).reshape(
        n, seq_len - width + 1, width * dim)


def corpus(seed, rows, seq_len=16, dim=64, width=9, alphabet=21, noise=0.1,
           target_sigma=0.7, anchors=128, target_scale=0.4,
           target_noise=0.1, device="cuda"):
    """(x, y, lengths): x (rows, L, D) float32, y (rows,) float64 and
    lengths (rows,) int32, all on ``device``, made from ``seed``."""
    gen = generator(seed, device)
    alphabet = min(dim, alphabet)
    x, lengths = sequences(gen, rows, seq_len, dim, width, alphabet, noise,
                           device)
    nw = seq_len - width + 1
    a_rows = torch.randint(0, rows, (anchors,), generator=gen, device=device)
    a_starts = torch.randint(0, nw, (anchors,), generator=gen, device=device)
    anchor = torch.stack([x[r, s:s + width, :].reshape(-1) for r, s in
                          zip(a_rows.tolist(), a_starts.tolist())]).double()
    coef = torch.randn((anchors,), generator=gen, device=device,
                       dtype=torch.float64)
    an2 = (anchor * anchor).sum(-1)
    n_valid = (lengths.long() - width + 1).clamp(1, nw)
    y = torch.empty((rows,), dtype=torch.float64, device=device)
    for lo in range(0, rows, _BLOCK // 8):
        hi = min(lo + _BLOCK // 8, rows)
        win = windows(x[lo:hi].double(), width)
        d2 = (win * win).sum(-1)[:, :, None] - 2.0 * win @ anchor.T \
            + an2[None, None, :]
        g = torch.exp(-0.5 * target_sigma ** 2 * d2) @ coef
        valid = torch.arange(nw, device=device)[None, :] < \
            n_valid[lo:hi, None]
        y[lo:hi] = (g * valid).sum(1) / n_valid[lo:hi]
    y = (y - y.mean()) / y.std(unbiased=False) * target_scale
    y += target_noise * torch.randn((rows,), generator=gen, device=device,
                                    dtype=torch.float64)
    return x, y, lengths


# Added to the seed for the pool of new sequences, so that the pool is a
# stream of its own and the corpus of a seed stays the same with or
# without it.
POOL_STREAM = 0x5EED_9001


def pool(seed, rows, seq_len=16, dim=64, width=9, alphabet=21, noise=0.1,
         device="cuda", **_target):
    """(x, lengths) of ``rows`` new sequences of the corpus's kind, with
    no target, made from ``seed`` on ``device``."""
    gen = generator(int(seed) + POOL_STREAM, device)
    return sequences(gen, rows, seq_len, dim, width, min(dim, alphabet),
                     noise, device)


def make(seed, spec, device, pool_rows=0):
    """The parts of a configuration's data: "train" and "test" (dicts of
    x, y, lengths) from one corpus, and "pool" (x, lengths) when
    ``pool_rows``.  ``spec`` is the configuration's "data" entry."""
    shape = {k: spec[k] for k in ("seq_len", "dim", "width", "alphabet",
                                  "noise")}
    rows = spec["rows"]
    x, y, lengths = corpus(seed, rows + spec["test_rows"], device=device,
                           **shape)
    out = {"train": {"x": x[:rows], "y": y[:rows], "lengths": lengths[:rows]},
           "test": {"x": x[rows:], "y": y[rows:], "lengths": lengths[rows:]}}
    if pool_rows:
        px, pl = pool(seed, pool_rows, device=device, **shape)
        out["pool"] = {"x": px, "lengths": pl}
    return out
