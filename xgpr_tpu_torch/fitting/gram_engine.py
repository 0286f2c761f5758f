"""Exact-Gram engine: the CG/SLQ data surface backed by a cached Z^T Z
(port of xgpr_tpu/fitting/gram_engine.py).

Every solver and preconditioner in this package touches the dataset only
through four reductions -- ``ztzv`` (Z^T Z v), ``gauss_pass`` (the same
with a matrix RHS), ``zty`` (Z^T y, y^T y) and ``sketch`` ((S Z)^T Z for
a feature-side SRHT S).  All four are linear images of the Gram matrix
G = Z^T Z:

    ztzv(v)             = G v
    gauss_pass(Q)       = G Q
    sketch(radem, idx)  = (G W)^T  with W the SRHT map (G symmetric)

so once G, Z^T y and y^T y have been accumulated in one dataset pass
(``Engine.design_mat``), an estimator run against this engine is the same
algorithm as a run that re-streams features every iteration, agreeing to
fp64 roundoff (the sums run in another order), at O(M^2) per matvec
instead of O(N M).

It is the referee at 1e6 rows: there the top Gram eigenvalue is O(1e7)
while an interior lambda^2 is ~0.05, so float32 arithmetic anywhere in
the operator swamps the NMLL.  The Gram is kept in float64 on the device
of the Gram it is given: the CPU for a float64 referee, or the card for a
Gram built there from float32 features with float64 chunk products.
"""
import torch

from ..ops.sorf import srht_rows


class GramEngine:
    """Engine facade over a precomputed (Z^T Z, Z^T y, y^T y) triple.

    Takes the output of ``Engine.design_mat()`` plus the kernel and row
    count; usable anywhere a fitting engine is (ConjugateGrad,
    NystromPreconditioner, scoring.slq.slq_nmll_from_engine).
    """

    def __init__(self, gram, z_trans_y, y_trans_y, kernel, ndatapoints):
        self.gram = torch.as_tensor(gram).to(torch.float64)
        self.device = self.gram.device
        self._zty = torch.as_tensor(z_trans_y, device=self.device).to(
            torch.float64)
        self._yty = float(y_trans_y)
        self.kernel = kernel
        self.ndatapoints = int(ndatapoints)
        self.num_rffs = int(self.gram.shape[0])
        # The solvers read these from an engine: the working dtype of the
        # vectors they hand over, and no device-resident stack (so CG runs
        # its loop over ``ztzv``).
        self._dtype = torch.float64
        self._stacked = None

    def _as_tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float64, device=self.device)

    def ztzv(self, vec):
        return torch.matmul(self.gram, self._as_tensor(vec))

    def gauss_pass(self, q_mat):
        return self.ztzv(q_mat)

    def zty(self):
        return self._zty, self._yty

    def design_mat(self):
        return self.gram, self._zty, self._yty

    def sketch(self, srht_radem, sample_idx, with_zty=True,
               row_keep_prob=None, seed=123):
        if row_keep_prob is not None and row_keep_prob < 1.0:
            raise RuntimeError(
                "A cached Gram matrix determines every feature-side "
                "reduction exactly, but row subsampling acts on the "
                "dataset axis, which the Gram has already summed out. "
                "Run ratio checks against a streaming engine instead.")
        idx = torch.as_tensor(sample_idx, dtype=torch.int64,
                              device=self.device)
        acc = srht_rows(self.gram, self._as_tensor(srht_radem), idx).T
        if with_zty:
            return acc, self._zty, self._yty
        return acc
