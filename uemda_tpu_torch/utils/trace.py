"""The port's tracer: spans, counters and phase timers, off by default.

One switch for the whole process (:func:`enable`, :func:`disable`): the
trainers' ``--profile-dir`` turns it on for their run (``train/loop.py``),
and so may any caller that wants to see inside the program. Off, each call
costs one test of a module-level bool: :func:`span` hands back one shared
no-op context, :func:`count` and :func:`phase` return, and a graph
captured then holds no node of the tracer.

* **Spans** (:func:`span`): a name, timed from enter to exit
  (``time.perf_counter_ns``) on its thread. A span is totalled under its
  path, the names of the spans open on that thread from the outermost
  down to it joined by ``/`` (``step/step.prepare``): the same name under
  another parent is another entry, so an evaluation's ``upload.wait``
  inside ``loop.eval/serve.batch`` never adds to the training loop's. A
  worker thread hangs its spans under the span its starter had open
  (:func:`here`, :func:`adopt`): the evaluation's upload worker's
  ``upload.copy`` is ``loop.eval/serve.batch/upload.copy``. Each thread
  keeps, per path, the count, the total and the self time (the total less
  the part its children cover), and no record of single spans; an ended
  thread's totals are folded into one. A span that starts while a
  ``torch.profiler`` session records is also a ``record_function`` range,
  so it lands in the chrome trace on the trace's own clock, beside the
  kernels launched inside it (outside a session the range would cost some
  10 us a span and record nothing).
* **Counters** (:func:`count`): integers by name, kept a thread and summed
  by :func:`snapshot`. A queue's depth is the depth seen at each get added
  up; the gets are its wait span's count.
* **Phases** (:func:`phases`, :func:`phase`): the boundaries of the named
  phases of one step's device work. Eager, or on the CPU, each phase is a
  host span ``phase.<name>``. Inside a CUDA graph capture each boundary is
  one launch of a one-thread kernel (``kernels/csrc/trace.cu``) that writes
  the device's ``%globaltimer`` and the phase's id into a ring of
  :data:`RING_ROWS` replays x :data:`RING_SLOTS` boundaries; the step's
  last boundary advances a replay counter on the device, so every replay
  writes its own row and no replay waits for the host. :func:`snapshot`
  copies the ring once, after a synchronisation, and adds the rows written
  since its last look to each phase's device time; a phase's time in a
  replay runs from its boundary to the next, and the replay's from the
  first boundary to the last.

:func:`snapshot` gives the totals so far, :func:`reset` clears them and
:func:`write` puts them, with the last replays' rows, in a JSON file.
"""

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

RING_ROWS = 4096        # replays the device ring holds between two looks
RING_SLOTS = 32         # phase boundaries a replay may mark, its end included
_END = 0                # the id of a replay's last boundary

_on = False
_lock = threading.Lock()        # guards _buffers, _ended, _phase_ids, _rings
_buffers: List["_Buffer"] = []  # the live threads' (and any not yet folded)
_local = threading.local()
_phase_ids: Dict[str, int] = {}
_rings: Dict[int, "_Ring"] = {}


class _Noop:
    """What :func:`span` and :func:`phases` give while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def discard(self) -> None:
        pass


_NOOP = _Noop()


def enable() -> None:
    """Turn tracing on for the whole process."""
    global _on
    _on = True


def disable() -> None:
    """Turn tracing off; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Buffer:
    """One thread's record: the spans open on it (innermost last), the
    path its outermost spans hang under (:func:`adopt`), per span path
    [count, total ns, self ns], and its counters."""

    def __init__(self, thread: threading.Thread):
        self.thread = thread
        self.stack: List[Span] = []
        self.root: Optional[str] = None
        self.totals: Dict[str, List[int]] = {}
        self.counters: Dict[str, int] = collections.defaultdict(int)

    def add(self, other: "_Buffer") -> None:
        for path, tot in other.totals.items():
            mine = self.totals.setdefault(path, [0, 0, 0])
            for j in range(3):
                mine[j] += tot[j]
        for name, n in other.counters.items():
            self.counters[name] += n


_ended = _Buffer(threading.main_thread())   # the ended threads', folded


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer(threading.current_thread())
        with _lock:
            _buffers.append(buf)
    return buf


def _live_buffers() -> List[_Buffer]:
    """Every buffer, after folding those of ended threads into
    :data:`_ended` (an ended thread writes no more)."""
    with _lock:
        for buf in [b for b in _buffers if not b.thread.is_alive()]:
            _buffers.remove(buf)
            _ended.add(buf)
        return list(_buffers) + [_ended]


class Span:
    """One span (:func:`span`): its ``name`` and ``path``, and ``parent``
    (the :class:`Span` open around it on its thread, or None) while it is
    open."""

    __slots__ = ("name", "path", "parent", "start", "_buf", "_child_ns",
                 "_range", "_kept")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        buf = self._buf = _buffer()
        self.parent = buf.stack[-1] if buf.stack else None
        if self.parent is not None:
            self.path = self.parent.path + "/" + self.name
        else:
            self.path = self.name if buf.root is None \
                else buf.root + "/" + self.name
        self._child_ns, self._kept = 0, True
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        buf.stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.start
        buf = self._buf
        if buf.stack[-1] is self:
            buf.stack.pop()
        else:   # a phase's span, ended by the next phase inside a span
            buf.stack.remove(self)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        parent, self.parent = self.parent, None
        if not self._kept:
            return False
        if parent is not None:
            parent._child_ns += dur
        tot = buf.totals.get(self.path)
        if tot is None:
            tot = buf.totals[self.path] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self._child_ns
        return False

    def discard(self) -> None:
        """Leave this span out of the record (a wait that found no item)."""
        self._kept = False


def span(name: str):
    """A context that records a span named ``name`` while tracing is on."""
    if not _on:
        return _NOOP
    return Span(name)


def here() -> Optional[str]:
    """The path the spans opened now on this thread would hang under (None
    for none, or while tracing is off): what a thread started here gives
    to :func:`adopt`."""
    if not _on:
        return None
    buf = _buffer()
    return buf.stack[-1].path if buf.stack else buf.root


def adopt(path: Optional[str]) -> None:
    """Hang this thread's outermost spans under ``path`` (:func:`here` of
    the thread that started it; None: at the root)."""
    if path is not None:
        _buffer().root = path


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _on:
        return
    _buffer().counters[name] += n


# --------------------------------------------------------------- phases


class _Ring:
    """A card's phase ring: (RING_ROWS, RING_SLOTS, 2) int64 of (device ns,
    phase id) and the replay counter, made outside any capture (a captured
    graph writes them at fixed addresses), with the host's sums of the rows
    read so far."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rows = torch.zeros((RING_ROWS, RING_SLOTS, 2), dtype=torch.int64,
                                device=device)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        self.seen = 0
        self.lost = 0
        self.replays = [0, 0]   # [replays read, their ns first to last]
        self.phase_ns: Dict[str, List[int]] = {}   # name: [replays, ns]
        self.recent = collections.deque(maxlen=RING_ROWS)
        # one launch now, outside any capture, builds and loads the kernel
        # (into a slot no step's row reads before its end marker)
        self.mark(RING_SLOTS - 1, -1)

    def mark(self, slot: int, phase_id: int) -> None:
        from uemda_tpu_torch import kernels

        fn = kernels.function("trace", "uemda_phase_mark_launch", [
            kernels.P, kernels.P, kernels.I, kernels.I, kernels.I,
            kernels.I, kernels.P])
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = fn(self.rows.data_ptr(), self.counter.data_ptr(), slot,
                 phase_id, RING_ROWS, RING_SLOTS, stream)
        kernels.check_launch("trace", "uemda_phase_mark_launch", err)

    def read(self, names: Dict[int, str]) -> None:
        """Add the rows written since the last read to the sums."""
        torch.cuda.synchronize(self.device)
        n = int(self.counter.item())
        if n <= self.seen:
            return
        rows = self.rows.cpu().numpy()
        first = max(self.seen, n - RING_ROWS)
        self.lost += first - self.seen
        for r in range(first, n):
            row = rows[r % RING_ROWS]
            # a row is read once its end marker has advanced the counter
            end = next(j for j in range(RING_SLOTS) if row[j, 1] == _END)
            per: Dict[str, int] = collections.defaultdict(int)
            for j in range(end):
                per[names[int(row[j, 1])]] += int(row[j + 1, 0] - row[j, 0])
            total = int(row[end, 0] - row[0, 0])
            self.replays[0] += 1
            self.replays[1] += total
            for name, ns in per.items():
                acc = self.phase_ns.setdefault(name, [0, 0])
                acc[0] += 1
                acc[1] += ns
            self.recent.append(dict(per, total=total))
        self.seen = n

    def clear(self) -> None:
        torch.cuda.synchronize(self.device)
        self.counter.zero_()
        self.seen = self.lost = 0
        self.replays = [0, 0]
        self.phase_ns.clear()
        self.recent.clear()


def _ring(device: torch.device) -> "_Ring":
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    ring = _rings.get(idx)
    if ring is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "trace: the phase ring is made by an eager step, before a "
                "capture; turn tracing on before the step's first call")
        with _lock:
            ring = _rings.setdefault(idx, _Ring(torch.device("cuda", idx)))
    return ring


def _phase_id(name: str) -> int:
    pid = _phase_ids.get(name)
    if pid is None:
        with _lock:
            pid = _phase_ids.setdefault(name, len(_phase_ids) + 1)
    return pid


class _Phases:
    """One step's phases on ``device`` (:func:`phases`)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.outer = getattr(_local, "phases", None)
        _local.phases = self
        self.slot, self.host = 0, None
        self.ring = None
        if self.device.type == "cuda":
            ring = _ring(self.device)
            if torch.cuda.is_current_stream_capturing():
                self.ring = ring
        return self

    def mark(self, name: str) -> None:
        if self.ring is not None:
            if self.slot >= RING_SLOTS - 1:
                raise RuntimeError(f"trace: more than {RING_SLOTS - 1} "
                                   f"phase boundaries in one step")
            self.ring.mark(self.slot, _phase_id(name))
            self.slot += 1
            return
        if self.host is not None:
            self.host.__exit__(None, None, None)
        self.host = Span("phase." + name).__enter__()

    def __exit__(self, *exc):
        _local.phases = self.outer
        if self.host is not None:
            self.host.__exit__(*exc)
        if self.ring is not None and self.slot and exc[0] is None:
            self.ring.mark(self.slot, _END)
        return False


def phases(device):
    """A context around one step's device work on ``device``, inside which
    :func:`phase` marks where each named phase starts."""
    if not _on:
        return _NOOP
    return _Phases(device)


def phase(name: str) -> None:
    """Mark the start of phase ``name`` of the step whose :func:`phases`
    is open on this thread (none open: nothing)."""
    if not _on:
        return
    group = getattr(_local, "phases", None)
    if group is not None:
        group.mark(name)


# ------------------------------------------------------------ read out


def snapshot() -> dict:
    """The totals so far: ``spans`` {path: {n, total_ns, self_ns}},
    ``counters`` {name: n}, ``phases`` {name: {n (replays that ran it),
    ns}} and ``replays`` {n, ns (first boundary to last), lost (rows
    written over before a look)} of the captured steps' phases. Reading
    the phases synchronises with the card once."""
    spans: Dict[str, Dict[str, int]] = {}
    counters: Dict[str, int] = collections.defaultdict(int)
    buffers = _live_buffers()
    with _lock:
        rings = list(_rings.values())
        names = {v: k for k, v in _phase_ids.items()}
    for buf in buffers:
        for path, (n, total, own) in list(buf.totals.items()):
            s = spans.setdefault(path, {"n": 0, "total_ns": 0, "self_ns": 0})
            s["n"] += n
            s["total_ns"] += total
            s["self_ns"] += own
        for name, n in list(buf.counters.items()):
            counters[name] += n
    phase_ns: Dict[str, Dict[str, int]] = {}
    replays = {"n": 0, "ns": 0, "lost": 0}
    for ring in rings:
        ring.read(names)
        for name, (n, ns) in ring.phase_ns.items():
            p = phase_ns.setdefault(name, {"n": 0, "ns": 0})
            p["n"] += n
            p["ns"] += ns
        replays["n"] += ring.replays[0]
        replays["ns"] += ring.replays[1]
        replays["lost"] += ring.lost
    return {"spans": spans, "counters": dict(counters), "phases": phase_ns,
            "replays": replays}


def reset() -> None:
    """Forget every span, counter and phase time recorded so far."""
    buffers = _live_buffers()
    with _lock:
        rings = list(_rings.values())
    for buf in buffers:
        buf.totals.clear()
        buf.counters.clear()
    for ring in rings:
        ring.clear()


def write(path: str) -> dict:
    """Write :func:`snapshot`, with each span's and phase's mean ms and the
    device ms of each phase in the last replays read (``replay_rows``), as
    JSON to ``path``; returns what was written."""
    snap = snapshot()
    for s in snap["spans"].values():
        s["mean_ms"] = s["total_ns"] / s["n"] / 1e6
    for p in snap["phases"].values():
        p["mean_ms"] = p["ns"] / p["n"] / 1e6
    with _lock:
        rings = list(_rings.values())
    snap["replay_rows"] = [{k: ns / 1e6 for k, ns in row.items()}
                           for ring in rings for row in ring.recent]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(snap, f, indent=1)
    return snap
