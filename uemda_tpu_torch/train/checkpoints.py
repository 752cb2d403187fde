"""The trainers' state on disk: atomic checkpoint writes, a background
snapshot writer and the run-dir lock.

The port's copy of ``uemda_tpu/train/checkpoints.py:28-171``:

* :func:`save_checkpoint` writes with ``torch.save`` through a tmp file
  named by pid and a per-process counter, then ``os.replace``: two writers
  of one path never truncate each other's tmp, and a failed write leaves
  no orphan;
* :class:`AsyncSaver` takes a snapshot's device-to-host copy on the
  caller's thread -- into reused pinned buffers, enqueued on the stream
  that runs the steps, so it is ordered before the next step's in-place
  writes -- and serializes and writes it on a worker thread;
* :class:`RunDirLock` keeps a second trainer off a run dir (an ``O_EXCL``
  pid file; a dead or garbled holder's lock is stolen).

Not ported: ``save_checkpoint_orbax`` and ``load_checkpoint_orbax``, a
JAX-ecosystem directory layout (ROADMAP.md).
"""

import itertools
import os
import queue
import threading
import time
from typing import Any, Dict, Optional

import torch

from uemda_tpu_torch.utils import trace

_tmp_seq = itertools.count()  # unique tmp suffix per in-process writer


def save_checkpoint(path: str, obj: Any) -> str:
    """``torch.save`` of ``obj`` to ``path``, atomically: the tmp name is
    unique per writer (pid + counter), so concurrent writers of one path
    each rename a complete file and the last one wins."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_seq)}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # failed mid-write: leave no orphan
            os.remove(tmp)
    return path


def load_checkpoint(path: str) -> Any:
    """What :func:`save_checkpoint` wrote (tensors, numbers, lists and
    dicts), on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _host_copy(tree, bufs: Dict[str, torch.Tensor], pinned: bool,
               prefix: str = ""):
    """``tree`` with each tensor copied into its host buffer in ``bufs``
    (made on first use, pinned for device tensors, reused after), the
    copies enqueued on the current stream without waiting."""
    if isinstance(tree, torch.Tensor):
        buf = bufs.get(prefix)
        if buf is None or buf.shape != tree.shape or buf.dtype != tree.dtype:
            buf = torch.empty(tree.shape, dtype=tree.dtype,
                              pin_memory=pinned and tree.is_cuda)
            bufs[prefix] = buf
        buf.copy_(tree.detach(), non_blocking=tree.is_cuda)
        return buf
    if isinstance(tree, dict):
        return {k: _host_copy(v, bufs, pinned, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v, bufs, pinned, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return tree


class AsyncSaver:
    """Background checkpoint writer. :meth:`save` copies the tree's
    tensors into reused host buffers on the current CUDA stream (or
    ``stream``) and records an event there: the steps update the state in
    place, so the copy has to sit on the stream that runs them, before the
    next step's kernels. The worker thread waits on that event, then
    serializes and writes. A write's error is raised at the next
    :meth:`save` or at :meth:`wait`. The buffers are reused, so a save
    first waits for the write before it.

    ``fetch_s``: the caller's seconds of the last :meth:`save` (the wait
    for the write before it included); ``write_s``: the worker's seconds
    of the last write, the wait on the copies included; ``nbytes``: the
    tensors' bytes of the last snapshot. While tracing is on
    (``utils/trace.py``) the caller's part is the span ``snapshot.fetch``
    and the worker's ``snapshot.write``."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._bufs: Dict[str, torch.Tensor] = {}
        self.fetch_s = self.write_s = 0.0
        self.nbytes = 0
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, tree, event = item
                t0 = time.perf_counter()
                with trace.span("snapshot.write"):
                    if event is not None:
                        event.synchronize()
                    save_checkpoint(path, tree)
                self.write_s = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 - raised on save or wait
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, path: str, tree, stream=None) -> None:
        with trace.span("snapshot.fetch"):
            self._save(path, tree, stream)

    def _save(self, path: str, tree, stream) -> None:
        t0 = time.perf_counter()
        self._q.join()  # the buffers are the last write's until it ends
        self._raise_pending()
        cuda = any(t.is_cuda for t in _tensors(tree))
        event = None
        if cuda:
            stream = stream or torch.cuda.current_stream()
            with torch.cuda.stream(stream):
                host = _host_copy(tree, self._bufs, True)
                event = torch.cuda.Event()
                event.record(stream)
        else:
            host = _host_copy(tree, self._bufs, False)
        self.nbytes = sum(t.numel() * t.element_size() for t in _tensors(host))
        self._q.put((path, host, event))
        self.fetch_s = time.perf_counter() - t0

    def wait(self) -> None:
        """Drain the pending writes; raise a write's error."""
        self._q.join()
        self._raise_pending()

    def close(self, wait: bool = True) -> None:
        """Stop the worker thread after the pending writes; ``wait=False``
        does not wait for them (a loop whose deadline expired on a hung
        device: the daemon worker is abandoned)."""
        if self._t.is_alive():
            self._q.put(None)
            if wait:
                self._t.join()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class RunDirLock:
    """Guard a run directory against two concurrent trainers, which would
    interleave ``metrics.jsonl`` and race the checkpoints: the second one
    fails fast with both pids named.

    An ``O_EXCL`` pid file, ``.run_lock``; a lock whose pid is no longer
    alive, or whose content is garbled, is stolen, so a crashed or killed
    run resumes with ``--resume auto`` without a manual cleanup."""

    def __init__(self, run_dir: str):
        self.path = os.path.join(run_dir, ".run_lock")
        self._held = False

    @staticmethod
    def _alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True  # exists, owned by someone else
        return True

    def acquire(self) -> "RunDirLock":
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        for _ in range(8):  # bounded: a steal can race another stealer
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                self._held = True
                return self
            except FileExistsError:
                try:
                    with open(self.path) as f:
                        holder = int(f.read().strip() or "0")
                except (OSError, ValueError):
                    holder = 0  # unreadable or garbled: stale
                if holder and self._alive(holder):
                    raise RuntimeError(
                        f"run dir {os.path.dirname(self.path)} is locked by "
                        f"live pid {holder} (this pid: {os.getpid()}): a "
                        "second trainer on one run dir races checkpoints and "
                        "metrics; stop the other process or use another "
                        "snapshot dir") from None
                try:  # stale: the holder is dead, steal
                    os.remove(self.path)
                except FileNotFoundError:
                    pass
        raise RuntimeError(f"could not acquire {self.path} after 8 attempts")

    def release(self) -> None:
        if self._held:
            self._held = False
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
