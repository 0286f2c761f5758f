"""Sharded dataset reductions: the multi-card engine (port of
xgpr_tpu/parallel/sharded.py).

xgpr_tpu shards a stacked batch tensor over a 1-D device mesh and psums
each device's partial Z^T (Z v), Z^T Z, Z^T y, ... over it.  Here each
rank of a torch.distributed group (parallel/mesh.py: one process per
card) holds its own rows as a stacked ``Engine`` on its card, and each
reduction is that Engine's reduction over the local rows followed by
ONE float64 all-reduce of everything it returns (packed into one buffer,
parallel/distributed.py).  CG's iterates and the preconditioner stay
replicated: they are O(M) and tiny next to the data.  The solvers that
run on top (NystromPreconditioner, ConjugateGrad, cg_fit, the softmax
NCG) work unchanged on this engine.

Each rank draws the row subsamples of ``sketch`` and ``gradient_terms``
from its own identically seeded stream over its own chunks, as
xgpr_tpu's hosts do (sharded.py ``_subsampled_mask_stack``): the
subsample is an estimator, so it need not match a one-process run's.
The classifier's ridge term is added after the sum over ranks.

xgpr_tpu's jitted shard_map program cache (``_get_jit``,
``_shard_reduce``) is XLA machinery with no counterpart: the local
reductions are the Engine's own loops.
"""
from ..fitting.engine import Engine
from .distributed import all_reduce_sum, global_host_reduce
from .mesh import data_mesh


class ShardedEngine(Engine):
    """Engine over this rank's rows whose reductions sum over the ranks of
    ``group`` (default WORLD).  ``ndatapoints`` is the row count over all
    ranks."""

    def __init__(self, kernel, dataset, group=None, mode="stacked"):
        self.mesh = data_mesh(group)
        self.n_dev = self.mesh.n_dev
        rows, n_classes = self._global_geometry(dataset)
        super().__init__(kernel, dataset, mode=mode)
        self.ndatapoints = rows
        if self.is_classification:
            self.n_classes = n_classes

    def _global_geometry(self, dataset):
        """One exchange of (the row total, the largest chunk count, the
        largest sequence axis, the largest class count) over the ranks
        (xgpr_tpu's ``_global_stream_geometry``).  A sequence dataset is
        padded to the largest axis, so every rank's chunks have one shape;
        each rank keeps its own chunk count (``local_batches``) against
        the largest (``global_batches``): no collective runs per chunk, so
        a rank with fewer chunks waits at the reduction's all-reduce
        instead of padding its stream.  Returns the row total and the
        class count (a rank may lack the top label)."""
        xdim = dataset.get_xdim()
        self.local_batches = dataset.get_n_batches()
        rows, batches, dim1, n_classes = global_host_reduce(
            (dataset.get_ndatapoints(), self.local_batches,
             xdim[1] if len(xdim) == 3 else 0,
             dataset.get_n_classes() or 0),
            ("sum", "max", "max", "max"), self.mesh)
        self.global_batches = int(batches)
        if len(xdim) == 3:
            dataset.set_sequence_pad(int(dim1))
        return int(rows), int(n_classes)

    def _sum(self, *values):
        return all_reduce_sum(self.mesh, *values)

    # Each reduction: the local Engine reduction, then one all-reduce.
    def ztzv(self, vec):
        return self._sum(self.local_ztzv(vec))[0]

    def zty(self):
        return self._sum(*super().zty())

    def design_mat(self):
        return self._sum(*super().design_mat())

    def var_design_mat(self, variance_rffs):
        return self._sum(super().var_design_mat(variance_rffs))[0]

    def sketch(self, srht_radem, sample_idx, with_zty=True,
               row_keep_prob=None, seed=123):
        out = super().sketch(srht_radem, sample_idx, with_zty,
                             row_keep_prob, seed)
        return self._sum(*out) if with_zty else self._sum(out)[0]

    def gradient_terms(self, subsample=1.0, seed=123):
        return self._sum(*super().gradient_terms(subsample, seed))

    def softmax_data_terms(self, w):
        return self._sum(*super().softmax_data_terms(w))

    def softmax_linesearch(self, wvec, direction, steps, lambda_):
        return self._sum(super().softmax_linesearch(
            wvec, direction, steps, lambda_))[0]
