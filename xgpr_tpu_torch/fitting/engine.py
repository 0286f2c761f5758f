"""Chunked dataset reductions (port of xgpr_tpu/fitting/engine.py).

Every heavy operation is a reduction over dataset chunks: Z^T Z v (CG
matvec), Z^T Z / Z^T y (exact fitting and NMLL), SRHT sketches (Nystrom
preconditioner) and the exact NMLL gradient's terms.  Each is a Python
loop over fixed-shape padded chunks with tensors resident on the
kernel's device:

- "stacked": the whole padded dataset is copied to the device once, chunk
  by chunk into one preallocated tensor (the fast path, used when it has
  fewer raw elements than config.stacked_element_limit());
- "streaming": each chunk is copied to the device as it is reached.  On
  the card the copies go through parallel/streaming.py's prefetcher
  (pinned staging buffers, a copy stream, events), so the copy of the
  next chunk overlaps the compute on this one; on the CPU each chunk is
  converted in place.

Padded rows are zeroed with the row mask after featurisation, so padding
never perturbs a reduction.  The CG matvec's and the sketch's chunk
products run in the working dtype (float32 on the card); the sums over
chunks, and every result, are float64.  That costs O(M * K) per chunk and
keeps the rounding of a float32 sum over hundreds of thousands of rows
out of the solver.  The design matrix's and the exact NMLL gradient's
chunk products are float64 too (features stay in the working dtype):
with float32 products the exact NMLL is rough in sigma at 262,144 rows
(its central differences 31% off), the gradient's sigma component 0.1-0.7%
off, and at 1e6 rows the float32 noise in Z^T Z is of the order of
lambda^2.  Features come from the kernel's feature fn (the K2 kernel, or
for the convolution kernels the K3/K4 kernels, on the card).  Sequence
lengths travel with their chunk as int32 tensors on the device (None for
fixed-vector data); padded rows carry the full padded length
(data/dataset.py), so row averaging stays finite before the mask zeroes
them.
"""
import numpy as np
import torch

from .. import config
from ..data.dataset import OnlineDataset
from ..ops.contract import mm, parts_contract, ztzv_contract
from ..ops.sorf import srht_rows
from ..parallel.streaming import ChunkPrefetcher
from ..utils import rng as state_rng


class Engine:
    """Bundles (kernel, dataset) and exposes the reductions."""

    def __init__(self, kernel, dataset, mode=None):
        self.kernel = kernel
        self.dataset = dataset
        self.fn = kernel.pure_feature_fn()
        self.num_rffs = kernel.get_num_rffs()
        self.ndatapoints = dataset.get_ndatapoints()
        self.device = kernel.device
        self._dtype = kernel.dtype
        if mode is None:
            n_elements = int(np.prod(dataset.get_xdim()))
            mode = "stacked" if (isinstance(dataset, OnlineDataset) and
                                 n_elements < config.stacked_element_limit()) \
                else "streaming"
        if mode not in ("stacked", "streaming"):
            raise ValueError("engine mode must be stacked or streaming")
        self.mode = mode
        self._stacked = None
        self.prefetcher = None
        if mode == "stacked":
            self._build_stack()
        elif self.device.type == "cuda":
            self.prefetcher = ChunkPrefetcher(dataset, self._dtype,
                                              self.device)

    # ------------------------------------------------------------------
    def _to_device(self, arr):
        return torch.as_tensor(np.asarray(arr), dtype=self._dtype,
                               device=self.device)

    def _lengths_to_device(self, lb):
        if lb is None:
            return None
        return torch.as_tensor(np.asarray(lb), dtype=torch.int32,
                               device=self.device)

    def _build_stack(self):
        """Copy the padded chunks into one device tensor per field, chunk
        by chunk: the host never holds a second copy of the dataset."""
        n = self.dataset.get_n_batches()
        stack, masks = None, []
        for i, (xb, yb, lb, mb) in enumerate(
                self.dataset.padded_batches(with_y=True)):
            fields = {"x": self._to_device(xb), "y": self._to_device(yb),
                      "m": self._to_device(mb),
                      "l": self._lengths_to_device(lb)}
            if stack is None:
                stack = {k: None if t is None else
                         t.new_empty((n,) + tuple(t.shape))
                         for k, t in fields.items()}
            for k, t in fields.items():
                if t is not None:
                    stack[k][i] = t
            masks.append(mb)
        # Host copy of the masks: row subsampling reads mask values on the
        # host without a device round trip.
        self._m_host = np.stack(masks)
        self._stacked = stack

    def _params(self):
        return self.kernel.feature_params()

    def _batches(self, with_y=True):
        """Yield (x, y-or-None, lengths-or-None, mask, host mask) per
        chunk, on the device."""
        if self.mode == "stacked":
            s = self._stacked
            for i in range(s["x"].shape[0]):
                yield (s["x"][i], s["y"][i],
                       None if s["l"] is None else s["l"][i], s["m"][i],
                       self._m_host[i])
            return
        if self.prefetcher is not None:
            yield from self.prefetcher.chunks(with_y)
            return
        for xb, yb, lb, mb in self.dataset.padded_batches(with_y=with_y):
            yield (self._to_device(xb),
                   None if yb is None else self._to_device(yb),
                   self._lengths_to_device(lb), self._to_device(mb), mb)

    def _features(self, params, xb, lb, mb):
        return self.fn(params, xb, lb) * mb[:, None]

    def _as_matrix(self, vec):
        return torch.as_tensor(vec, dtype=self._dtype,
                               device=self.device).reshape(self.num_rffs, -1)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.float64, device=self.device)

    # ------------------------------------------------------------------
    def ztzv(self, vec):
        """Sum over chunks of Z^T (Z v); vec is (M,) or (M, K).  With the
        kernel's (cos, sin) parts the contraction skips the block layout
        and only the small (M, K) vectors are gathered and scattered."""
        params = self._params()
        v2 = self._as_matrix(vec)
        parts_fn = self.kernel.pure_feature_parts_fn()
        if parts_fn is None:
            acc = self._zeros(*v2.shape)
            for xb, _, lb, mb, _ in self._batches(with_y=False):
                acc += ztzv_contract(self._features(params, xb, lb, mb), v2)
            return acc.reshape(np.shape(vec))
        cos_pos, sin_pos = (torch.as_tensor(p, device=self.device)
                            for p in self.kernel.feature_positions())
        v_c, v_s = v2[cos_pos], v2[sin_pos]
        oc = self._zeros(*v_c.shape)
        os_ = self._zeros(*v_s.shape)
        for xb, _, lb, mb, _ in self._batches(with_y=False):
            c, s = parts_fn(params, xb, lb)
            a, b = parts_contract(c * mb[:, None], s * mb[:, None], v_c, v_s)
            oc += a
            os_ += b
        out = oc.new_empty(v2.shape)
        out[cos_pos] = oc
        out[sin_pos] = os_
        return out.reshape(np.shape(vec))

    def gauss_pass(self, q_mat):
        """Z^T Z Q for a dense (M, rank) Q: ztzv with a matrix RHS."""
        return self.ztzv(q_mat)

    def design_mat(self):
        """(Z^T Z, Z^T y, y^T y) in one pass, each chunk's products in
        float64 from working-dtype features."""
        m = self.num_rffs
        ztz, zty, yty = self._zeros(m, m), self._zeros(m), self._zeros()
        params = self._params()
        for xb, yb, lb, mb, _ in self._batches():
            z = self._features(params, xb, lb, mb).double()
            ym = (yb * mb).double()
            ztz += mm(z.T, z)
            zty += mm(z.T, ym)
            yty += ym @ ym
        return ztz, zty, float(yty)

    def zty(self):
        """(Z^T y, y^T y)."""
        zty, yty = self._zeros(self.num_rffs), self._zeros()
        params = self._params()
        for xb, yb, lb, mb, _ in self._batches():
            ym = yb * mb
            zty += mm(self._features(params, xb, lb, mb).T, ym)
            yty += ym @ ym
        return zty, float(yty)

    def var_design_mat(self, variance_rffs):
        """Z_v^T Z_v over the variance feature columns (the cos/sin pairs
        of the first variance_rffs/2 frequencies)."""
        idx = torch.as_tensor(
            self.kernel.variance_column_indices(variance_rffs),
            device=self.device)
        acc = self._zeros(variance_rffs, variance_rffs)
        params = self._params()
        for xb, _, lb, mb, _ in self._batches(with_y=False):
            z = self._features(params, xb, lb, mb)[:, idx]
            acc += mm(z.T, z)
        return acc

    def sketch(self, srht_radem, sample_idx, with_zty=True,
               row_keep_prob=None, seed=123):
        """SRHT sketch pass: acc = sum SRHT(Z)^T Z, optionally with Z^T y
        and y^T y, or over an exact-count row subsample."""
        rank = sample_idx.shape[0]
        m = self.num_rffs
        opts = dict(dtype=self._dtype, device=self.device)
        acc, zty, yty = self._zeros(rank, m), self._zeros(m), self._zeros()
        params = self._params()
        radem = torch.as_tensor(srht_radem, **opts)
        idx = torch.as_tensor(sample_idx, dtype=torch.int64,
                              device=self.device)
        if row_keep_prob is not None and row_keep_prob >= 1.0:
            row_keep_prob = None
        rng = np.random.default_rng(seed)
        for xb, yb, lb, mb, mh in self._batches(with_y=with_zty):
            if row_keep_prob is not None:
                keep = state_rng.exact_count_keep_mask(mh, row_keep_prob, rng)
                mb = mb * torch.as_tensor(keep, **opts)
            z = self._features(params, xb, lb, mb)
            acc += mm(srht_rows(z, radem, idx).T, z)
            if with_zty:
                ym = yb * mb
                zty += mm(z.T, ym)
                yty += ym @ ym
        if with_zty:
            return acc, zty, float(yty)
        return acc

    # ------------------------------------------------------------------
    def _gradient_batch_terms(self, grad_fn, gparams, xb, lb, mb, yb):
        """One masked chunk's (Z^T Z, Z^T y, y^T y, dZ^T y, dZ^T Z, rows),
        the products in float64 from working-dtype features; dZ is
        (R, M, n_sigma)."""
        z, dz = grad_fn(gparams, xb, lb)
        mb = mb.double()
        z = z.double() * mb[:, None]
        dz = dz.double() * mb[:, None, None]
        ym = yb.double() * mb
        inner = torch.stack([mm(dz[:, :, i].T, z)
                             for i in range(dz.shape[2])], dim=2)
        return (mm(z.T, z), mm(z.T, ym), ym @ ym,
                torch.einsum("nmi,n->mi", dz, ym), inner, torch.sum(mb))

    @staticmethod
    def _subsample_mask(mb, rng, subsample):
        """Bernoulli row-keep mask on a chunk's row mask, drawn per chunk
        from one generator; shapes stay fixed and the kept count comes
        back through the mask sum."""
        if subsample >= 1.0:
            return mb
        keep = rng.random(mb.shape[0]) < subsample
        return mb * torch.as_tensor(keep, dtype=mb.dtype, device=mb.device)

    def gradient_terms(self, subsample=1.0, seed=123):
        """Terms for the exact NMLL gradient: (Z^T Z, Z^T y, y^T y,
        dZ^T y (M, n_sigma), dZ^T Z + Z^T dZ (M, M, n_sigma), rows),
        float64 on the device: each chunk's products and the sums over
        chunks."""
        grad_fn = self.kernel.pure_gradient_fn()
        if grad_fn is None:
            raise NotImplementedError(
                "This kernel has no gradient fn; exact NMLL gradients are "
                "not available for it.")
        m = self.num_rffs
        nsig = self.kernel.get_hyperparams().shape[0] - 1
        gparams = self.kernel.gradient_params()
        rng = np.random.default_rng(seed)
        acc = [self._zeros(m, m), self._zeros(m), self._zeros(),
               self._zeros(m, nsig), self._zeros(m, m, nsig), self._zeros()]
        for xb, yb, lb, mb, _ in self._batches():
            mb = self._subsample_mask(mb, rng, subsample)
            for a, t in zip(acc, self._gradient_batch_terms(
                    grad_fn, gparams, xb, lb, mb, yb)):
                a += t
        ztz, zty, yty, dz_ty, inner, n = acc
        inner = inner + inner.transpose(0, 1)
        return ztz, zty, float(yty), dz_ty, inner, int(n)
