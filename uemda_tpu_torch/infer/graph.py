"""The serving forward as one captured CUDA graph.

The port's counterpart of the ``jax.jit`` around the slide(+TTA) predictor
(``uemda_tpu/infer/slide.py:82-83,133``): there one XLA program holds all
windows, all 8 TTA views, the forward and the stitching, dispatched once a
batch. Here the predictor's device work for one input shape is captured
once with ``torch.cuda.CUDAGraph`` and replayed: one launch a batch in
place of several hundred.

:func:`capture` is the recipe shared with the trainer's step graph
(``train/graph.py``): the caches the captured code reads (cuDNN and cuBLAS
handles and workspaces, the kernels' launch plans, the resize matrices) are
set up by a warm-up call on the capture stream first, the capture is
thread-local because the upload stage's worker keeps copying on its own
stream meanwhile, and the graph's private pool is what the capture
reserves. Capturing launches nothing, so the capture leaves the kernel
wrappers' launch counts as they were and every replay adds the launches it
holds (:func:`count_replay`): the counts stay the kernels' launches on the
device. :class:`Predictor` captures on its first call on the card, with a
static input buffer, read by every replay, and the static outputs a replay
writes. A graph reads the weights at the addresses they had when it was
captured, so it is tied to one model object (K4's TMA maps and every conv
hold those addresses): refolding or recalibrating a fast path needs a new
predictor. On the card a capture that fails raises; nothing falls back to
eager calls.
"""

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from uemda_tpu_torch.utils import trace


def kernel_wrappers():
    """The port's kernel wrappers (each counts its launches): what a
    capture reports as the launches a replay holds."""
    from uemda_tpu_torch.ops.bnact import bnact
    from uemda_tpu_torch.ops.crop import crop_normalize
    from uemda_tpu_torch.ops.insnorm import (
        instance_norm,
        instance_norm_backward,
    )
    from uemda_tpu_torch.ops.mine import uvem_mine
    from uemda_tpu_torch.ops.resblock import bottleneck_identity
    from uemda_tpu_torch.ops.segment import (
        segment_gather,
        segment_max,
        segment_sum,
    )
    from uemda_tpu_torch.ops.stem import stem_pool
    from uemda_tpu_torch.ops.tail import tail_upsample_softmax_mean

    return (crop_normalize, instance_norm, instance_norm_backward, segment_max,
            segment_sum, segment_gather, tail_upsample_softmax_mean, uvem_mine,
            stem_pool, bottleneck_identity, bnact)


def capture(fn: Callable, stream: torch.cuda.Stream,
            wrappers: Sequence = ()) -> Tuple[torch.cuda.CUDAGraph, object,
                                              Dict[str, object]]:
    """Capture ``fn()`` on ``stream``. Returns (graph, what ``fn`` returned:
    the tensors every replay writes, statistics): ``capture_s`` (wall
    seconds, synchronisations included), ``pool_bytes`` (device memory the
    capture reserved: the graph's private pool) and ``launches`` ({kernel
    wrapper: launches a replay}, from the wrappers' counts during the
    capture, which are then put back: the capture launched nothing)."""
    graph = torch.cuda.CUDAGraph()
    before = [w.launches for w in wrappers]
    t0 = time.perf_counter()
    # what torch.cuda.graph does first, done here so that the memory
    # reserved during the capture is the graph's pool alone
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    # thread_local: an upload stage's worker thread keeps copying on its
    # own stream while this thread captures
    try:
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches - b
                    for w, b in zip(wrappers, before)}
    finally:
        for w, b in zip(wrappers, before):
            w.launches = b
    stats = {"capture_s": time.perf_counter() - t0,
             "pool_bytes": torch.cuda.memory_reserved() - reserved,
             "launches": launches}
    return graph, out, stats


def count_replay(wrappers: Sequence, launches: Dict[str, int]) -> None:
    """Add one replay's launches (``capture``'s ``launches``) to the
    wrappers' counts: a replay launches every kernel the capture recorded."""
    for w in wrappers:
        w.launches += launches.get(w.__name__, 0)


def _tensors(tree):
    """The tensors of an output: a tensor, or a tuple of tensors and None."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for t in tree if isinstance(t, torch.Tensor)]


class Predictor:
    """The slide(+TTA) predictor ``infer/slide.py``'s ``make_predictor``
    returns: ``fn`` (a function of one normalized (B, 3, H, W) input) as a
    callable. On the card (unless made with ``capture=False``) its first
    call runs ``fn`` once on the capture stream (the warm-up, a real call
    whose result it returns) and captures it for that input's shape, dtype
    and layout; every later call copies its input into the static input
    buffer, replays the graph on the current stream and returns the
    graph's static outputs: they are overwritten by the next call, so a
    caller reads them, or enqueues its reads, before calling again. An
    input of another shape is refused (make a predictor for it). On the
    CPU, and with ``capture=False``, each call runs ``fn`` eagerly.
    :meth:`close` releases the graph and its pool; the predictor is also a
    context manager that closes it. While tracing is on
    (``utils/trace.py``) a call is the span ``predict.call``, and a replay's
    input copy and launch its children ``predict.load`` and
    ``predict.launch``."""

    def __init__(self, fn: Callable, capture: bool = True):
        self.fn = fn  # keeps the model, whose weights the graph reads, alive
        self.capture = capture
        self.graph = None

    def __call__(self, x: torch.Tensor):
        with trace.span("predict.call"):
            return self._call(x)

    def _call(self, x: torch.Tensor):
        if not self.capture or x.device.type != "cuda":
            return self.fn(x)
        if self.graph is None:
            return self._capture(x)
        s = self.static_in
        if x.shape != s.shape or x.dtype != s.dtype or x.device != s.device:
            raise ValueError(
                f"captured predictor: input {tuple(x.shape)} {x.dtype} on "
                f"{x.device} does not match the captured {tuple(s.shape)} "
                f"{s.dtype} on {s.device}; make a predictor for it")
        with trace.span("predict.load"):
            s.copy_(x)
        with trace.span("predict.launch"):
            self.graph.replay()
            count_replay(self.wrappers, self.launches)
            self.replays += 1
        return self.out

    def _capture(self, example: torch.Tensor):
        """The warm-up on ``example`` and the capture; returns the
        warm-up's result."""
        self.wrappers = kernel_wrappers()
        self.static_in = example.clone()
        stream = torch.cuda.Stream(example.device)
        cur = torch.cuda.current_stream(example.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            first = self.fn(self.static_in)
        cur.wait_stream(stream)
        for t in _tensors(first):
            t.record_stream(cur)
        self.graph, self.out, st = capture(lambda: self.fn(self.static_in),
                                           stream, self.wrappers)
        self.capture_s = st["capture_s"]
        self.pool_bytes = st["pool_bytes"]
        self.launches = st["launches"]
        self.replays = 0
        return first

    def stats(self) -> Optional[Dict[str, object]]:
        """The capture's ``capture_s``, ``pool_bytes``, ``launches`` (as
        :func:`capture`) and ``replays``, or None if nothing was
        captured."""
        if self.graph is None:
            return None
        return {"capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "replays": self.replays, "launches": self.launches}

    def close(self) -> Optional[Dict[str, object]]:
        """Release the graph, its pool and the static buffers; returns the
        statistics, or None if nothing was captured."""
        stats = self.stats()
        if stats is not None:
            torch.cuda.synchronize()
            self.graph = self.out = self.static_in = None
            torch.cuda.empty_cache()
        return stats

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
