"""Variants of one protein in the shape of the TAPE fluorescence task
(avGFP, Sarkisyan et al. 2016, as split by Rao et al. 2019), made on the
device from a seed.

The measured values are not in the repository, so the data are drawn:
a wild type of ``seq_len`` letters over ``alphabet`` (20) amino acids;
each training row carries ``train_substitutions`` [lo, hi] substitutions
at distinct positions (a count uniform on that range, positions
uniform, each new letter uniform over the 19 others), each test row
``test_substitutions`` of them, as TAPE trains on low-order mutants and
tests on higher-order ones.  Rows are one-hot in ``dim`` (21) channels,
the last left empty as in xGPR's 21-letter encoding, and every row has
the full length.  The target is additive site effects (a standard
normal effect for each position and non-wild-type letter) plus sparse
pairwise epistasis (``epistasis_pairs`` pairs of positions, each adding
a normal coefficient of scale ``epistasis_scale`` when both are
substituted), standardised over all rows, plus Gaussian noise of scale
``noise``.  Every draw comes from a ``torch.Generator`` on ``device``.
"""
import torch

# Added to the seed for the pool of new variants, a stream of its own.
POOL_STREAM = 0x5EED_6F9


def generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def landscape(gen, spec, device):
    """(wild type (L,), site effects (L, A), pairs (P, 2), pair
    coefficients (P,)) of the seed."""
    seq_len, alphabet = spec["seq_len"], spec["alphabet"]
    wild = torch.randint(0, alphabet, (seq_len,), generator=gen,
                         device=device)
    effects = torch.randn((seq_len, alphabet), generator=gen, device=device,
                          dtype=torch.float64)
    effects[torch.arange(seq_len, device=device), wild] = 0.0
    n_pairs = spec["epistasis_pairs"]
    first = torch.randint(0, seq_len, (n_pairs,), generator=gen,
                          device=device)
    second = (first + torch.randint(1, seq_len, (n_pairs,), generator=gen,
                                    device=device)) % seq_len
    coef = spec["epistasis_scale"] * torch.randn(
        (n_pairs,), generator=gen, device=device, dtype=torch.float64)
    return wild, effects, torch.stack([first, second], dim=1), coef


def variants(gen, wild, rows, substitutions, alphabet, device):
    """(rows, L) letters: the wild type with a count uniform on
    ``substitutions`` [lo, hi] of distinct positions substituted."""
    lo, hi = substitutions
    seq_len = wild.shape[0]
    counts = torch.randint(lo, hi + 1, (rows,), generator=gen,
                           device=device)
    pos = torch.rand((rows, seq_len), generator=gen,
                     device=device).argsort(dim=1)[:, :hi]
    shift = torch.randint(1, alphabet, (rows, hi), generator=gen,
                          device=device)
    old = wild[pos]
    keep = torch.arange(hi, device=device)[None, :] < counts[:, None]
    letters = wild.expand(rows, seq_len).clone()
    letters.scatter_(1, pos, torch.where(keep, (old + shift) % alphabet,
                                         old))
    return letters


def one_hot(letters, dim):
    """(rows, L, dim) float32 one-hot rows."""
    x = torch.zeros(letters.shape + (dim,), dtype=torch.float32,
                    device=letters.device)
    x.scatter_(2, letters[..., None], 1.0)
    return x


def signal(letters, wild, effects, pairs, coef):
    """(rows,) float64: the site effects of each row's letters plus the
    coefficients of its pairs with both positions substituted."""
    seq_len = wild.shape[0]
    site = effects[torch.arange(seq_len, device=letters.device)[None, :],
                   letters].sum(1)
    mutated = letters != wild[None, :]
    both = (mutated[:, pairs[:, 0]] & mutated[:, pairs[:, 1]]).double()
    return site + both @ coef


def make(seed, spec, device, pool_rows=0):
    """The parts of a configuration's data: "train" and "test" (dicts of
    x, y, lengths) and "pool" (x, lengths) when ``pool_rows``.  ``spec``
    is the configuration's "data" entry."""
    gen = generator(seed, device)
    wild, effects, pairs, coef = landscape(gen, spec, device)
    alphabet = spec["alphabet"]
    parts = {"train": (spec["rows"], spec["train_substitutions"]),
             "test": (spec["test_rows"], spec["test_substitutions"])}
    letters = {k: variants(gen, wild, n, subs, alphabet, device)
               for k, (n, subs) in parts.items()}
    raw = {k: signal(v, wild, effects, pairs, coef)
           for k, v in letters.items()}
    every = torch.cat(list(raw.values()))
    mean, std = every.mean(), every.std(unbiased=False)
    out = {}
    for k, v in letters.items():
        y = (raw[k] - mean) / std + spec["noise"] * torch.randn(
            raw[k].shape, generator=gen, device=device, dtype=torch.float64)
        out[k] = {"x": one_hot(v, spec["dim"]), "y": y,
                  "lengths": torch.full((v.shape[0],), spec["seq_len"],
                                        dtype=torch.int32, device=device)}
    if pool_rows:
        pool_gen = generator(int(seed) + POOL_STREAM, device)
        v = variants(pool_gen, wild, pool_rows, spec["test_substitutions"],
                     alphabet, device)
        out["pool"] = {"x": one_hot(v, spec["dim"]),
                       "lengths": torch.full((pool_rows,), spec["seq_len"],
                                             dtype=torch.int32,
                                             device=device)}
    return out
