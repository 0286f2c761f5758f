"""Chunk streaming to a card with bounded-depth prefetch, and the
streaming sharded engine (port of xgpr_tpu/parallel/streaming.py: the
host assembly of chunks, ``_stream_steps``, ``PREFETCH_DEPTH`` and
``StreamingShardedEngine``).

``StreamingShardedEngine`` is the sharded engine (parallel/sharded.py)
over a streaming ``Engine``: each rank streams its own rows through the
prefetcher below on every pass and all-reduces the pass's result once.
xgpr_tpu issues a collective per superbatch, so its ranks pad their
streams with empty superbatches up to the largest count; here no
collective runs per chunk, so an unequal or ragged split costs the
shorter rank a wait at the all-reduce and nothing else.  Its geometry
(the row total, the largest chunk count, the largest sequence axis) is
agreed in one exchange when it is made, as for the stacked sharded
engine.

A streaming engine re-reads the dataset in deterministic chunk order on
every reduction pass, so streamed and device-resident ("stacked") passes
agree to fp64 roundoff.  ``ChunkPrefetcher`` moves those chunks to the
card so that the host->device copy of chunk k+1 overlaps the compute on
chunk k:

- a ring of ``PREFETCH_DEPTH`` slots, each a set of pinned host staging
  buffers and device buffers of one padded chunk (x, y, lengths, mask; y
  in ``label_dtype``, torch.long for a classifier's labels);
- a dedicated copy stream issuing ``non_blocking`` copies from the pinned
  buffers (a copy from pageable memory would synchronise first);
- CUDA events: the compute stream waits for a slot's copy before its
  chunk is used; the copy into a slot waits for the compute that last
  read it; and the host refills a staging buffer only after the copy out
  of it has completed (a buffer refilled early gives silently wrong
  chunks).

The loop reads nothing back from the card, so copy and compute stay
queued.  A pass made with ``timing`` set (``iteration_split`` sets it for
one pass) also records its host assembly time (the dataset's
``padded_batches`` plus the fill of the staging buffers) and a timing
event pair around each copy; ``last_pass`` reads them after the pass.
"""
import time

import numpy as np
import torch

from .sharded import ShardedEngine

# Slots in the ring: the chunk being consumed and up to two copies ahead
# of it.  Two slots would overlap one copy with one chunk's compute; the
# third absorbs the jitter of the host assembly.  Host memory is bounded
# at depth x one padded chunk of pinned staging (67 MB a slot for a
# 16,384-row chunk of 16 x 64 float32).
PREFETCH_DEPTH = 3


class ChunkPrefetcher:
    """Streams a dataset's padded chunks to a CUDA device; see the module
    docstring.  Slots are allocated at the first chunk and reused by every
    later pass."""

    def __init__(self, dataset, dtype, device, label_dtype=None):
        self.dataset = dataset
        self.dtype = dtype
        self.label_dtype = dtype if label_dtype is None else label_dtype
        self.device = torch.device(device)
        self.depth = PREFETCH_DEPTH
        self._copy_stream = torch.cuda.Stream(self.device)
        self._slots = None
        self._copied = [None] * self.depth     # copy-done event per slot
        self._consumed = [None] * self.depth   # last compute on the slot
        self.timing = False
        self._pass = None

    def _make_slots(self, xb, lb):
        def pair(shape, dtype):
            return (torch.empty(shape, dtype=dtype, pin_memory=True),
                    torch.empty(shape, dtype=dtype, device=self.device))
        rows = xb.shape[0]
        slots = []
        for _ in range(self.depth):
            slot = {"x": pair(xb.shape, self.dtype),
                    "y": pair((rows,), self.label_dtype),
                    "m": pair((rows,), self.dtype)}
            if lb is not None:
                slot["l"] = pair((rows,), torch.int32)
            slots.append(slot)
        return slots

    def _fill(self, slot, arrays):
        """Copy one host chunk into a slot's pinned buffers (the host's
        part of the assembly; torch's copy runs on several threads)."""
        for key, arr in arrays.items():
            slot[key][0].copy_(torch.from_numpy(np.asarray(arr)))

    def _issue_copy(self, j, keys):
        slot = self._slots[j]
        timed = self._pass is not None
        start = torch.cuda.Event(enable_timing=True) if timed else None
        done = torch.cuda.Event(enable_timing=timed)
        with torch.cuda.stream(self._copy_stream):
            if self._consumed[j] is not None:
                self._copy_stream.wait_event(self._consumed[j])
            if timed:
                start.record(self._copy_stream)
            for key in keys:
                host, dev = slot[key]
                dev.copy_(host, non_blocking=True)
            done.record(self._copy_stream)
        self._copied[j] = done
        if timed:
            self._pass["copies"].append((start, done))
            self._pass["bytes"] += sum(slot[key][0].numel() *
                                       slot[key][0].element_size()
                                       for key in keys)

    def _clock(self, t0):
        if self._pass is not None:
            self._pass["host_s"] += time.perf_counter() - t0

    def chunks(self, with_y=True):
        """Yield (x, y-or-None, lengths-or-None, mask, host mask) per
        chunk, on the device; the tensors are the slot's buffers and are
        valid until the consumer asks for the next chunk.  A chunk is
        handed over once the copies of the next depth - 2 chunks have been
        issued behind it."""
        self._pass = {"host_s": 0.0, "copies": [], "bytes": 0} \
            if self.timing else None
        pending = []
        batches = self.dataset.padded_batches(with_y=with_y)
        k = 0
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            self._clock(t0)
            if batch is None:
                break
            xb, yb, lb, mb = batch
            if self._slots is None:
                self._slots = self._make_slots(xb, lb)
            # Slot j last held chunk k - depth, already handed over.
            j = k % self.depth
            if self._copied[j] is not None:
                # The copy out of this staging buffer must be done before
                # the host overwrites it.
                self._copied[j].synchronize()
            arrays = {"x": xb, "m": mb}
            if yb is not None:
                arrays["y"] = yb
            if lb is not None:
                arrays["l"] = lb
            t0 = time.perf_counter()
            self._fill(self._slots[j], arrays)
            self._clock(t0)
            self._issue_copy(j, arrays)
            pending.append((j, mb, yb is not None, lb is not None))
            k += 1
            if len(pending) == self.depth - 1:
                yield from self._hand_over(pending.pop(0))
        while pending:
            yield from self._hand_over(pending.pop(0))

    def _hand_over(self, entry):
        j, mb, has_y, has_l = entry
        slot = self._slots[j]
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(self._copied[j])
        try:
            yield (slot["x"][1], slot["y"][1] if has_y else None,
                   slot["l"][1] if has_l else None, slot["m"][1], mb)
        finally:
            # Everything the consumer queued on this chunk is behind this
            # event; the next copy into the slot waits for it.
            event = torch.cuda.Event()
            event.record(compute)
            self._consumed[j] = event

    def last_pass(self):
        """(host assembly seconds, summed copy seconds, bytes copied) of
        the last pass, which must have been made with ``timing`` set;
        waits for its copies."""
        if self._pass is None:
            raise RuntimeError("the last pass was not timed; set "
                               "ChunkPrefetcher.timing before it")
        copies = self._pass["copies"]
        if copies:
            copies[-1][1].synchronize()
        copy_s = sum(a.elapsed_time(b) for a, b in copies) / 1e3
        return {"host_s": self._pass["host_s"], "copy_s": copy_s,
                "bytes": self._pass["bytes"], "chunks": len(copies)}


class StreamingShardedEngine(ShardedEngine):
    """ShardedEngine whose rows stream from the dataset on every pass."""

    def __init__(self, kernel, dataset, group=None):
        super().__init__(kernel, dataset, group, mode="streaming")


def iteration_split(streamed, stacked, vec, reps=3):
    """One CG iteration's data pass (``ztzv``) split into its parts, from
    two engines of one kernel and dataset: the streamed pass's wall time,
    its host assembly and summed copy seconds (``last_pass``), and the
    stacked engine's pass, the compute alone.  Wall seconds per pass,
    averaged over ``reps`` untimed passes after a warm one; the split from
    one more pass made with the prefetcher's ``timing`` set."""
    out = {}
    for name, engine in (("streamed_s", streamed), ("compute_s", stacked)):
        engine.ztzv(vec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.ztzv(vec)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps
    streamed.prefetcher.timing = True
    try:
        streamed.ztzv(vec)
    finally:
        streamed.prefetcher.timing = False
    split = streamed.prefetcher.last_pass()
    out.update(host_s=split["host_s"], copy_s=split["copy_s"],
               chunks=split["chunks"],
               copy_gb_per_s=split["bytes"] / split["copy_s"] / 1e9)
    return out
