"""Multi-process execution over torch.distributed (port of
xgpr_tpu/parallel/distributed.py) and the collectives every sharded
engine and solver calls.

One process per card.  Each process:

1. calls ``initialize_distributed(coordinator, n_procs, proc_id)``;
2. builds its LOCAL rows as a dataset (e.g. its slice of the .npy file
   list) with ``normalize_y=False`` and y already on a common scale: each
   rank would otherwise normalise by its own mean and spread;
3. fits as usual; the model picks the sharded engine (models/baseclass.py)
   and each reduction sums over the ranks.

All projection state derives from the shared integer seed, so nothing is
broadcast (utils/rng.py).  xgpr_tpu's ``host_local_stack_to_global`` has
no counterpart: no array spans ranks, each rank's engine keeps its local
stack.

The collectives (``all_reduce_sum``, ``all_gather``, ``reduce_scatter``)
take a ``DataMesh`` (parallel/mesh.py).  On an "nccl" group they run on
the card's tensors; on a "gloo" group a CUDA tensor is staged through the
host (a copy out, the collective, a copy back), decided by the backend
when the mesh is made, never by trying.  A tensor the backend cannot
take (a CPU tensor on "nccl") raises.  ``COLLECTIVES`` counts the calls
by name and ``COLLECTIVE_SECONDS`` their host seconds; with
``SYNC_TIMING`` set the device is synchronised before and after each
call, so the seconds include an NCCL call's device time.
"""
import time
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from .mesh import data_mesh

COLLECTIVES = Counter()
COLLECTIVE_SECONDS = Counter()
SYNC_TIMING = False


def initialize_distributed(coordinator_address, num_processes, process_id,
                           local_device_ids=None, backend=None):
    """``torch.distributed.init_process_group`` over
    tcp://``coordinator_address`` (host:port).  The backend is "nccl"
    when a card is visible and "gloo" otherwise, unless ``backend`` says;
    with a card, this process's device is ``local_device_ids[0]``, or the
    card of its index among the host's cards by default."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        device = local_device_ids[0] if local_device_ids else \
            process_id % torch.cuda.device_count()
        torch.cuda.set_device(device)
    address = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id)


def global_data_mesh():
    """The data group over every process of the job."""
    return data_mesh()


def global_host_reduce(values, ops, mesh=None):
    """Reduce a few per-rank scalars over every rank ("sum" or "max" for
    each), in float64; returns python floats, the same on every rank.
    Engines agree on stream geometry and their engine kind with it.  A
    group of one (or none) returns ``values`` unchanged."""
    if len(values) != len(ops):
        raise ValueError("values and ops must pair up")
    if any(op not in ("sum", "max") for op in ops):
        raise ValueError("ops must be sum or max")
    mesh = mesh if mesh is not None else global_data_mesh()
    if mesh.n_dev == 1:
        return [float(v) for v in values]
    device = _collective_device(mesh)
    out = torch.tensor([float(v) for v in values], dtype=torch.float64,
                       device=device)
    for op, red in (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX)):
        cols = [i for i, o in enumerate(ops) if o == op]
        if cols:
            part = out[cols]
            _run("all_reduce", dist.all_reduce, part, op=red,
                 group=mesh.group)
            out[cols] = part
    return [float(v) for v in out.cpu()]


def _collective_device(mesh):
    """Where a group's collectives take tensors: the current card for
    "nccl", the host for "gloo"."""
    if mesh.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if mesh.backend == "gloo":
        return torch.device("cpu")
    raise RuntimeError(f"no collectives for backend {mesh.backend!r}; "
                       "the port runs nccl and gloo groups")


def _transport(mesh, t):
    """t on the device the group's backend takes (module docstring)."""
    want = _collective_device(mesh)
    if t.device.type == want.type:
        return t.contiguous()
    if want.type == "cpu":
        return t.cpu()
    raise RuntimeError(f"an {mesh.backend} group cannot reduce a tensor on "
                       f"{t.device}")


def _run(name, fn, *args, **kwargs):
    sync = SYNC_TIMING and torch.cuda.is_available()
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    if sync:
        torch.cuda.synchronize()
    COLLECTIVE_SECONDS[name] += time.perf_counter() - t0
    COLLECTIVES[name] += 1


def all_reduce_sum(mesh, *values):
    """The sums over the group's ranks of each of ``values`` (tensors,
    python floats or ints), in one float64 all-reduce: the values are
    packed into one buffer.  Returns them in order, tensors as float64
    tensors of their shape on their device, numbers as floats or ints.
    A mesh with no group returns them unchanged (tensors as float64)."""
    tensors = [torch.as_tensor(v, dtype=torch.float64) for v in values]
    if mesh.backend is None:
        packed = tensors
    else:
        device = next((t.device for t in tensors if t.device.type != "cpu"),
                      tensors[0].device)
        buf = torch.cat([t.to(device).reshape(-1) for t in tensors])
        wire = _transport(mesh, buf)
        _run("all_reduce", dist.all_reduce, wire, group=mesh.group)
        buf = wire.to(device)
        packed, at = [], 0
        for t in tensors:
            packed.append(buf[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
    out = []
    for v, t in zip(values, packed):
        if torch.is_tensor(v):
            out.append(t)
        elif isinstance(v, (int, np.integer)):
            out.append(int(round(float(t))))
        else:
            out.append(float(t))
    return tuple(out)


def all_gather(mesh, t):
    """Every rank's t (equal shapes) stacked along axis 0 in rank order."""
    if mesh.backend is None:
        return t
    wire = _transport(mesh, t)
    parts = [torch.empty_like(wire) for _ in range(mesh.n_dev)]
    _run("all_gather", dist.all_gather, parts, wire, group=mesh.group)
    return torch.cat(parts).to(t.device)


def reduce_scatter(mesh, t):
    """The sum over the ranks of t (M, ...), this rank's block of M / n_dev
    rows (``DataMesh.shard_rows``)."""
    if mesh.backend is None:
        return t
    mesh.shard_rows(t.shape[0])
    wire = _transport(mesh, t)
    parts = list(wire.chunk(mesh.n_dev))
    out = torch.empty_like(parts[0])
    _run("reduce_scatter", dist.reduce_scatter, out, parts,
         group=mesh.group)
    return out.to(t.device)

