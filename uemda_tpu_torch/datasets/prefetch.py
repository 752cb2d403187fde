"""Background-thread batch prefetching, and the host <-> card copies behind
it.

The port's copy of ``uemda_tpu/datasets/prefetch.py``: one daemon thread
assembles the next batches (RAM-cached decode + stack) while the device runs
the current step, behind a queue of ``depth`` batches (:func:`prefetch`).
The trainer and the serving path chain two of them: the decode stage and
the upload stage (:func:`upload_batches`: a worker thread with its own CUDA
stream and a :class:`PinnedRing` of reused pinned buffers), whose worker is
the decode stage's only consumer. :class:`HostReadback` is the other
direction: device results copied into reused pinned buffers and handed to
the host one call later, so the host never waits for the batch the device
is still computing.

Unlike the JAX package's copy, closing the returned generator stops the
worker at its next batch, so its owner can read the wrapped iterator again
afterwards (the trainer closes its upload stage when the loop ends).
"""

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from uemda_tpu_torch.utils import trace

_POLL_S = 0.1  # how often a worker blocked on a full queue looks for a stop


def prefetch(iterator: Iterator, depth: int = 2, name: str = "decode"
             ) -> Iterator:
    """Wrap any batch iterator with a depth-bounded background thread.

    Worker exceptions (decode/IO failures) re-raise in the consumer: a
    corrupt tile must fail the run, not silently truncate the dataset.
    While tracing is on (``utils/trace.py``) each get is the span
    ``<name>.wait`` on the consumer's thread, the queue's depth seen at
    each get adds to the counter ``<name>.depth``, and the worker's spans
    hang under the span open where the first batch was asked for."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    origin = trace.here()

    def worker():
        trace.adopt(origin)
        try:
            for item in iterator:
                if not put(item):
                    break
            else:
                put(stop)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            put((stop, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    wait_span, depth_count = name + ".wait", name + ".depth"
    try:
        while True:
            with trace.span(wait_span) as sp:
                trace.count(depth_count, q.qsize())
                item = q.get()
                if item is stop:
                    sp.discard()
            if item is stop:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                raise item[1]
            yield item
    finally:
        closed.set()
        t.join()


class PinnedRing:
    """Pinned host buffers, ``slots`` per (key, shape, dtype), handed out in
    turn and reused: no page-locking per batch. A slot is handed out again
    only once the copy that last used it has completed (its event), so no
    pinned buffer is overwritten, nor read, while a copy of it is in
    flight. While tracing is on, each hand-out that had to wait for a copy
    in flight counts to ``<name>.ring_waits``."""

    def __init__(self, slots: int = 3, name: str = "upload"):
        self.slots = slots
        self._rings: Dict[tuple, list] = {}
        self._waits = name + ".ring_waits"

    def acquire(self, key, shape, dtype: np.dtype):
        """(pinned host tensor, its event) of the next slot for ``key``."""
        ring = self._rings.setdefault((key, tuple(shape), np.dtype(dtype)),
                                      [0, []])
        turn, slots = ring
        if len(slots) < self.slots:
            host = torch.from_numpy(np.empty(shape, dtype)).pin_memory()
            slots.append((host, torch.cuda.Event()))
            ring[0] = len(slots) % self.slots
            return slots[-1]
        host, ev = slots[turn]
        ring[0] = (turn + 1) % self.slots
        if not ev.query():
            trace.count(self._waits)
            ev.synchronize()
        return host, ev


def upload_batches(iterator: Iterator[Dict[str, Any]], device,
                   depth: int = 2, keys: Optional[Sequence[str]] = None
                   ) -> Iterator[Dict[str, Any]]:
    """The upload stage (the counterpart of ``_device_iter``, ``uemda_tpu/
    train/loop.py:187-208``): host batches (dicts) -> the same dicts with
    each numpy array (those under ``keys``, if given) a tensor on
    ``device``; other values pass through. To the card, a worker thread
    copies each array into a slot of a :class:`PinnedRing` and from there
    to the device on its own CUDA stream, without blocking; the consumer's
    stream waits for the batch's copies (an event) and records its use of
    the tensors, so the allocator never hands their memory to the next
    upload while a step still reads them. On the CPU the arrays are wrapped
    as they are. While tracing is on the consumer's wait for a batch is the
    span ``upload.wait`` (with the counter ``upload.depth``, as
    :func:`prefetch`'s) and the worker's copy of one ``upload.copy``."""
    device = torch.device(device)

    def moves(k, v) -> bool:
        return isinstance(v, np.ndarray) and (keys is None or k in keys)

    if device.type != "cuda":
        while True:
            with trace.span("upload.wait") as sp:
                batch = next(iterator, None)
                if batch is None:
                    sp.discard()
                    return
            yield {k: torch.from_numpy(np.ascontiguousarray(v))
                   if moves(k, v) else v for k, v in batch.items()}
    stream = torch.cuda.Stream(device)
    ring = PinnedRing(depth + 1)

    def upload(batch):
        with trace.span("upload.copy"), torch.cuda.device(device), \
                torch.cuda.stream(stream):
            out = {}
            for k, v in batch.items():
                if not moves(k, v):
                    out[k] = v
                    continue
                host, ev = ring.acquire(k, v.shape, v.dtype)
                np.copyto(host.numpy(), v)
                out[k] = torch.empty(v.shape, dtype=host.dtype,
                                     device=device).copy_(host,
                                                          non_blocking=True)
                ev.record(stream)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    staged = prefetch((upload(b) for b in iterator), depth, name="upload")
    try:
        for out, done in staged:
            cur = torch.cuda.current_stream(device)
            cur.wait_event(done)
            for t in out.values():
                if isinstance(t, torch.Tensor):
                    t.record_stream(cur)
            yield out
    finally:
        staged.close()  # stops the worker: the caller may read on


class HostReadback:
    """Device results back to the host, one call late. :meth:`push` enqueues
    the copies of a batch's tensors into reused pinned buffers (a
    :class:`PinnedRing` of two slots a key) on the current stream and
    returns the batch pushed before it, as numpy arrays, once its copies
    are done; :meth:`flush` returns the last one. So the host reads batch i
    while the device computes batch i + 1. The arrays handed back are views
    of the pinned buffers, valid until the next :meth:`push`; a caller that
    keeps one copies it. On the CPU the tensors' own arrays are handed
    back, in the same order. While tracing is on, the host's wait for a
    batch's copies is the span ``readback.wait``."""

    def __init__(self):
        self._ring = PinnedRing(2, name="readback")
        self._pending: Optional[Tuple[Any, Dict[str, Any], Any]] = None

    def push(self, tag, tensors: Dict[str, torch.Tensor]
             ) -> Optional[Tuple[Any, Dict[str, np.ndarray]]]:
        """Start the copies of ``tensors``; returns (tag, arrays) of the
        previous push, or None."""
        hosts, done = {}, None
        for k, t in tensors.items():
            if t.device.type != "cuda":
                hosts[k] = t.numpy()
                continue
            host, ev = self._ring.acquire(
                k, t.shape, torch.empty((), dtype=t.dtype).numpy().dtype)
            host.copy_(t, non_blocking=True)
            ev.record()
            hosts[k], done = host, ev
        prev, self._pending = self._pending, (tag, hosts, done)
        return self._hand_over(prev)

    def flush(self) -> Optional[Tuple[Any, Dict[str, np.ndarray]]]:
        """(tag, arrays) of the last push, or None."""
        prev, self._pending = self._pending, None
        return self._hand_over(prev)

    @staticmethod
    def _hand_over(item):
        if item is None:
            return None
        tag, hosts, done = item
        if done is not None:
            with trace.span("readback.wait"):
                done.synchronize()
        return tag, {k: v.numpy() if isinstance(v, torch.Tensor) else v
                     for k, v in hosts.items()}
