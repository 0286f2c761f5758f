"""Randomized Nystrom preconditioner (port of xgpr_tpu/preconditioners/nystrom.py).

- ``initialize_srht``: one SRHT sketch pass -> acc = (S Z)^T Z, then
  C = S acc^T, SVD(C), B = acc^T V^T S^{-1/2} V, eigenvalues from SVD(B)^2.
- ``initialize_srht_multipass`` ("srht_2"): the sketch, then per extra pass
  QR(acc) and a Z^T Z Q pass, whitened by eigh.
- ``srht_ratio_check``: a row-subsampled sketch whose min eigenvalue
  predicts the rank needed.
- ``NystromPreconditioner``: P^{-1} v = U ((prefactor / (S + lambda^2))
  U^T v) + (v - U U^T v).

The algebra after each sketch pass runs in float64 on the engine's device
with torch.linalg (svd, eigh, qr), whatever the working dtype; eigh returns
eigenvalues in ascending order, reversed where the JAX package reverses
them.  In float32 the sketch's small eigenvalues are noise, and an fp32
``_tall_svd`` turns them into columns of U that are far from orthonormal,
so P^{-1} is indefinite and CG breaks down in its first iteration (seen
on the card at 262,144 rows, lambda^2 = 0.028).  In float64 U stays
orthonormal and P^{-1} positive definite, and the preconditioner is kept
in float64 for the CG iterations, whose state is float64 too
(fitting/fused_cg.py).  On the CPU, where the working dtype is float64,
this changes nothing.
"""
import numpy as np
import torch

from ..ops.contract import mm
from ..ops.sorf import srht_rows
from ..utils import rng as state_rng


def _sketch_state(engine, rank, random_state):
    return state_rng.srht_state(random_state, engine.num_rffs, rank,
                                np.float64)


def _tall_svd(b):
    """(U, singular values) of a tall (M, r) matrix via eigh of the (r, r)
    Gram matrix, largest first."""
    ev, v = torch.linalg.eigh(mm(b.T, b))
    ev = torch.clamp(torch.flip(ev, dims=[0]), min=0.0)
    v = torch.flip(v, dims=[1])
    s = torch.sqrt(ev)
    inv_s = torch.where(s > 1e-14, 1.0 / torch.where(s > 1e-14, s, 1.0), 0.0)
    return mm(b, v * inv_s[None, :]), s


def _nystrom_from_sketch(acc, radem, idx):
    """Shared tail of the single-pass construction: sketch-SVD + whitening."""
    acc = acc.double()
    c_mat = srht_rows(acc, torch.as_tensor(radem, dtype=acc.dtype,
                                           device=acc.device),
                      torch.as_tensor(idx, dtype=torch.int64,
                                      device=acc.device))
    _, c_s1, c_v1 = torch.linalg.svd(c_mat, full_matrices=False)
    mask = c_s1 < 1e-14
    c_s1 = 1.0 / torch.sqrt(torch.clamp(c_s1, min=1e-14))
    c_s1 = torch.where(mask, 0.0, c_s1)
    b = mm(mm(acc.T, c_v1.T), c_s1[:, None] * c_v1)
    u_mat, s_mat = _tall_svd(b)
    return u_mat, s_mat ** 2


def initialize_srht(engine, rank, random_state, is_regression=True):
    """One-pass randomized Nystrom approximation."""
    radem, idx = _sketch_state(engine, rank, random_state)
    if is_regression:
        acc, z_trans_y, y_trans_y = engine.sketch(radem, idx, with_zty=True)
    else:
        acc = engine.sketch(radem, idx, with_zty=False)
        z_trans_y, y_trans_y = None, 0.0
    u_mat, eig = _nystrom_from_sketch(acc, radem, idx)
    return u_mat, eig, z_trans_y, y_trans_y


def initialize_srht_multipass(engine, rank, random_state, n_passes=2,
                              is_regression=True):
    """Multi-pass construction: SRHT sketch then Z^T Z Q power passes."""
    radem, idx = _sketch_state(engine, rank, random_state)
    if is_regression:
        acc, z_trans_y, y_trans_y = engine.sketch(radem, idx, with_zty=True)
    else:
        acc = engine.sketch(radem, idx, with_zty=False)
        z_trans_y, y_trans_y = None, 0.0
    acc = acc.T.double()  # (M, rank)
    q_mat = None
    for _ in range(n_passes - 1):
        q_mat = torch.linalg.qr(acc)[0].to(engine._dtype)
        acc = engine.gauss_pass(q_mat).double()
        q_mat = q_mat.double()
    # Whiten acc by small^{-1/2}, small = Q^T Z^T Z Q, with pinv-style
    # eigh whitening: directions below fp noise are dropped rather than
    # amplified, so fp32 never NaNs on a numerically rank-deficient sketch.
    small = mm(q_mat.T, acc)
    e_val, e_vec = torch.linalg.eigh(small)
    floor = torch.clamp(e_val[-1], min=0.0) * (
        torch.finfo(acc.dtype).eps * small.shape[0])
    inv_sqrt = torch.where(
        e_val > floor, 1.0 / torch.sqrt(torch.where(e_val > floor, e_val,
                                                    1.0)), 0.0)
    u_mat, s_mat = _tall_svd(mm(acc, e_vec * inv_sqrt[None, :]))
    return u_mat, torch.clamp(s_mat ** 2, min=0), z_trans_y, y_trans_y


def srht_ratio_check(engine, rank, random_state, sample_frac=0.1):
    """Estimate preconditioner eigenvalues from a row subsample."""
    radem, idx = _sketch_state(engine, rank, random_state)
    acc = engine.sketch(radem, idx, with_zty=False,
                        row_keep_prob=sample_frac, seed=random_state)
    return _nystrom_from_sketch(acc, radem, idx)[1]


class NystromPreconditioner:
    """Randomized Nystrom approximation to (Z^T Z + lambda^2 I)^{-1}."""

    def __init__(self, engine, max_rank, verbose=False, random_state=123,
                 method="srht", is_regression=True):
        if method not in ("srht", "srht_2", "srht_3"):
            raise RuntimeError("Unknown preconditioner construction method.")
        if method.startswith("srht_"):
            u_mat, eig, zty, yty = initialize_srht_multipass(
                engine, max_rank, random_state, int(method.split("_")[1]),
                is_regression)
        else:
            u_mat, eig, zty, yty = initialize_srht(
                engine, max_rank, random_state, is_regression)
        lambda_ = engine.kernel.get_lambda()
        min_eig = float(eig.min())
        self.u_mat = u_mat
        self.eig = eig + lambda_ ** 2
        self.inv_eig = torch.where(self.eig > 1e-14, 1.0 / self.eig, 0.0)
        self.achieved_ratio = min_eig / lambda_ ** 2
        self.prefactor = float(min_eig + lambda_ ** 2)
        self.z_trans_y = zty
        self.y_trans_y = yty

    def _reweight_range(self, vec, spectrum):
        """U diag(spectrum) U^T vec + (I - U U^T) vec for (M, K) columns."""
        coords = mm(self.u_mat.T, vec)
        remainder = vec - mm(self.u_mat, coords)
        return remainder + mm(self.u_mat, spectrum[:, None] * coords)

    def batch_matvec(self, xvec):
        """P^{-1} @ xvec for (M, K) columns."""
        return self._reweight_range(xvec, self.prefactor * self.inv_eig)

    def get_zty(self):
        return self.z_trans_y
