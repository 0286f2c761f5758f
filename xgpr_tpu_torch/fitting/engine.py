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
never perturbs a reduction.  A classifier's labels travel as torch.long
(float targets in the working dtype otherwise), and its two reductions,
``classification_loss_grad`` and ``softmax_linesearch``, serve
fitting/softmax_solver.py.  The CG matvec's and the sketch's chunk
products run in the working dtype (float32 on the card), or under bf16
feature materialisation (config.feature_dtype(): fast features, the "max"
preset) on the chunk's features, the direction and Z v rounded to
bfloat16 with float32 sums (ops/contract.py, as xgpr_tpu contracts them
in its CG); the sums over chunks, and every result, are float64.  That
costs O(M * K) per chunk and keeps the rounding of a float32 sum over
hundreds of thousands of rows out of the solver.  The design matrix's
and the exact NMLL gradient's chunk products are float64 too (features
stay in the working dtype):
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
        # A classifier's labels reach the reductions as torch.long.
        self.is_classification = dataset.get_n_classes() is not None
        self._ydtype = torch.long if self.is_classification else self._dtype
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
                                              self.device, self._ydtype)

    # ------------------------------------------------------------------
    def _to_device(self, arr):
        return torch.as_tensor(np.asarray(arr), dtype=self._dtype,
                               device=self.device)

    def _y_to_device(self, yb):
        return torch.as_tensor(np.asarray(yb), dtype=self._ydtype,
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
            fields = {"x": self._to_device(xb), "y": self._y_to_device(yb),
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
                   None if yb is None else self._y_to_device(yb),
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

    # ------------------------------------------------------------------
    # The classifier's reductions (fitting/softmax_solver.py).  The chunk
    # products with the weights run in the working dtype (z @ W outside any
    # kernel, as xgpr_tpu's ops/contract.py::mm); the softmax, the loss and
    # every sum over chunks are float64: the solver accepts a step by
    # comparing totals of ~1e5 against a margin of 1e-4 * step * slope.
    @staticmethod
    def _softmax_loss_grad(z, w, yb, mb):
        """One masked chunk's cross-entropy loss and its (M, C) gradient
        Z^T (P - onehot(y)), both float64."""
        pred = mm(z, w).double()
        pred = pred - torch.max(pred, dim=1, keepdim=True).values
        p = torch.exp(pred)
        p = p / torch.sum(p, dim=1, keepdim=True)
        logp = torch.log(torch.clamp(p, min=1e-16))
        picked = torch.gather(logp, 1, yb[:, None])[:, 0]
        mb = mb.double()
        loss = -torch.sum(picked * mb)
        resid = p - torch.nn.functional.one_hot(yb, w.shape[1]).double()
        grad = mm(z.T, (resid * mb[:, None]).to(z.dtype))
        return loss, grad.double()

    def classification_loss_grad(self, wvec, lambda_):
        """(gradient (M, C), objective): softmax cross-entropy over the
        dataset plus the L2(lambda^2) ridge, which exempts the intercept
        row; float64 on the device."""
        w = torch.as_tensor(wvec, dtype=torch.float64, device=self.device)
        wz = w.to(self._dtype)
        loss, grad = self._zeros(), self._zeros(*w.shape)
        params = self._params()
        for xb, yb, lb, mb, _ in self._batches():
            bl, bg = self._softmax_loss_grad(
                self._features(params, xb, lb, mb), wz, yb, mb)
            loss += bl
            grad += bg
        grad[1:, :] += (lambda_ ** 2) * w[1:, :]
        total = float(loss) + 0.5 * (lambda_ ** 2) * \
            float(torch.sum(w[1:, :] ** 2))
        return grad, total

    def softmax_linesearch(self, wvec, direction, steps, lambda_):
        """The data-side cross-entropy of W + t D for every step t of
        ``steps``, in one dataset pass (float64, on the device): the
        logits are affine in t, so each chunk's z [W | D] is formed once.
        The solver adds the ridge term in closed form."""
        w = torch.as_tensor(wvec, dtype=torch.float64, device=self.device)
        d = torch.as_tensor(direction, dtype=torch.float64,
                            device=self.device)
        t = torch.as_tensor(np.asarray(steps), dtype=torch.float64,
                            device=self.device)
        wd = torch.cat([w, d], dim=1).to(self._dtype)
        n_cls = w.shape[1]
        acc = self._zeros(t.shape[0])
        params = self._params()
        for xb, yb, lb, mb, _ in self._batches():
            zwd = mm(self._features(params, xb, lb, mb), wd).double()
            logits = zwd[None, :, :n_cls] + t[:, None, None] * \
                zwd[None, :, n_cls:]
            lse = torch.logsumexp(logits, dim=2)
            hit = torch.gather(
                logits, 2, yb[None, :, None].expand(t.shape[0], -1, 1))[..., 0]
            acc += torch.sum((lse - hit) * mb.double()[None, :], dim=1)
        return acc

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
