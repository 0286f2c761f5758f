"""The data group the sharded engines reduce over (port of
xgpr_tpu/parallel/mesh.py).

xgpr_tpu shards its dataset stack over a 1-D device mesh on the "data"
axis and psums every chunk reduction over it.  Here the mesh is a
torch.distributed process group, one process per card: each rank holds
its own rows on its own card, and the reductions are summed over the
group (parallel/distributed.py holds the collectives).  ``DATA_AXIS``
keeps the JAX name for readers.  ``batch_sharding`` and ``replicated``
have no counterpart: no array spans ranks, each keeps its own tensors.

``backend`` is read once, when the ``DataMesh`` is made: it decides how
the collectives move tensors ("nccl" takes them on the card, "gloo"
through the host).
"""
import torch.distributed as dist

DATA_AXIS = "data"


class DataMesh:
    """A process group (None: WORLD) with its size ``n_dev``, this
    process's ``rank`` in it and its ``backend``.  Without an initialised
    process group it is a group of one with no backend, whose collectives
    are the identity."""

    def __init__(self, group=None):
        self.group = group
        if dist.is_available() and dist.is_initialized():
            self.n_dev = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group)).lower()
        else:
            if group is not None:
                raise RuntimeError("a process group was passed but "
                                   "torch.distributed is not initialised")
            self.n_dev, self.rank, self.backend = 1, 0, None

    def shard_rows(self, m):
        """(lo, hi): the rows of an axis of length m that this rank holds
        when the axis is split into n_dev equal blocks in rank order."""
        if m % self.n_dev:
            raise ValueError(f"an axis of {m} does not split over "
                             f"{self.n_dev} ranks")
        block = m // self.n_dev
        return self.rank * block, (self.rank + 1) * block


def data_mesh(group=None):
    """The data group over ``group`` (default WORLD)."""
    return DataMesh(group)
