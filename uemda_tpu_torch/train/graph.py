"""Several train steps per call: one step of a stage captured as a CUDA
graph and replayed.

The port's counterpart of ``_make_multi_step`` (``uemda_tpu/train/loop.py:
236-275``), which runs K steps in one jitted ``lax.scan`` so that the host
dispatches once per K steps. Here the device part of a step
(``train/steps.py``'s ``_Step.run``: forwards, losses, backward and the
update, no host synchronisation, the state written in place) is captured
once with ``torch.cuda.CUDAGraph`` and replayed: one launch a step in place
of some four thousand. Around each replay the host does what a replay
cannot: the step's draws (``_Step.prepare``, from the same (seed, step)
generators as an eager step, so graph and eager steps draw the same bits),
their copy and the batches' copy into the graph's static input buffers, the
learning rate into the optimizer's device scalar, and the step count.

The capture follows PyTorch's recipe: the chunk's first step runs eagerly
on the capture stream (a real step of the run, whose math counts: cuBLAS,
cuDNN and the kernels' caches are set up by it), then one step is captured
(capturing computes nothing, so the state does not move), then the graph is
replayed. Each replay's metrics are cloned before the next replay writes
over them. On the CPU a chunk is K eager steps, so the chunk schedule runs
there too; on the card a step that cannot be captured raises: nothing falls
back to eager steps. Under data parallelism on NCCL the step's
collectives (the BatchNorm statistics, the loss sums, the gradient
all-reduce) are captured with it (``chip_smoke.py``'s ``[dp]`` replays
them from a graph on a group of one); a gloo group's cannot be, and a
chunk on the card over gloo raises.
"""

import collections
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import torch

from uemda_tpu_torch.infer.graph import (
    capture,
    count_replay,
    kernel_wrappers,
)
from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.train.state import TrainState

# replays the host may run ahead of the device: each holds a batch upload's
# device memory until the device has passed it
MAX_AHEAD = 2


def _clone(tree):
    """A copy of a batch or draws tree's tensors (the static buffers)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _clone(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _load(dst, src, what: str) -> None:
    """Copy ``src``'s tensors into the static buffers ``dst`` (same tree
    shape, same tensor shapes), on the current stream."""
    if isinstance(dst, torch.Tensor):
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"{what}: {tuple(src.shape)} {src.dtype} does "
                             f"not match the captured {tuple(dst.shape)} "
                             f"{dst.dtype}")
        dst.copy_(src, non_blocking=True)
    elif isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"{what}: keys {sorted(src)} do not match the "
                             f"captured {sorted(dst)}")
        for k in dst:
            _load(dst[k], src[k], f"{what}[{k!r}]")
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _load(getattr(dst, f.name), getattr(src, f.name),
                  f"{what}.{f.name}")


class StepGraph:
    """One train step of ``step`` (a ``_Step`` with ``prepare`` and ``run``)
    captured on ``stream`` from the shapes of ``batch_s``, ``batch_t`` and
    ``draws``, with its own static input buffers.

    Attributes after capture: ``capture_s`` (wall seconds of the capture,
    its synchronisations included), ``pool_bytes`` (device memory the
    capture reserved: the graph's private pool), ``launches`` ({kernel
    wrapper: launches a replay}, from the wrappers' counts during capture)
    and ``replays``. Each replay adds its launches to the wrappers'
    counts."""

    def __init__(self, step, state: TrainState, batch_s, batch_t, draws,
                 stream: torch.cuda.Stream, wrappers=()):
        self.step = step
        self.wrappers = wrappers
        self.static_s = _clone(batch_s)
        self.static_t = _clone(batch_t)
        self.static_draws = _clone(draws)
        self.graph, self.metrics, stats = capture(
            lambda: step.run(state, self.static_s, self.static_t,
                             self.static_draws), stream, wrappers)
        self.capture_s = stats["capture_s"]
        self.pool_bytes = stats["pool_bytes"]
        self.launches = stats["launches"]
        # the gradients the graph writes (the segmenter's and, for the
        # adversarial step, the discriminator's): an eager step in between
        # points .grad elsewhere, a replay points it back
        self.params = state.grad_params()
        self.grads = [p.grad for p in self.params]
        self.replays = 0

    def __call__(self, state: TrainState, batch_s, batch_t, seed: int
                 ) -> Dict[str, torch.Tensor]:
        """One step by replay: the host's part, the copies into the static
        buffers, the replay and the step count; returns a copy of the
        step's metrics."""
        draws = self.step.prepare(state, batch_s, batch_t, seed)
        _load(self.static_s, batch_s, "batch_s")
        _load(self.static_t, batch_t, "batch_t")
        _load(self.static_draws, draws, "draws")
        state.opt.set_lr()
        self.graph.replay()
        count_replay(self.wrappers, self.launches)
        for p, g in zip(self.params, self.grads):
            p.grad = g
        state.advance()
        self.replays += 1
        return {k: v.clone() for k, v in self.metrics.items()}


class ChunkRunner:
    """Runs a chunk of K steps of ``step_fn`` (``run_training_loop``'s
    ``steps_per_call``). On the CPU: K eager steps. On the card: the first
    chunk's first step eagerly on the capture stream, the capture, then a
    replay a step (:class:`StepGraph`); a step that has no ``prepare`` and
    ``run`` cannot be captured and raises. :meth:`close` reports the
    capture: its time, its pool, the replays and the kernels' launches a
    replay holds."""

    def __init__(self, step_fn: Callable, seed: int, device):
        self.step_fn = step_fn
        self.seed = seed
        self.device = torch.device(device)
        self.wrappers = kernel_wrappers()
        self.graph: Optional[StepGraph] = None
        self._ahead = collections.deque()
        if self.device.type == "cuda":
            if not (hasattr(step_fn, "prepare") and hasattr(step_fn, "run")):
                raise TypeError(
                    f"steps_per_call > 1 on the card captures the step: "
                    f"{type(step_fn).__name__} has no prepare/run")
            if mesh.world_size() > 1 and mesh.backend() != "nccl":
                # the step's collectives go into the graph: NCCL's can be
                # captured, gloo's cannot
                raise RuntimeError(
                    f"steps_per_call > 1 on the card captures the step with "
                    f"its collectives; the process group's backend is "
                    f"{mesh.backend()!r}, and only 'nccl' collectives can be "
                    f"captured in a CUDA graph")
            self.stream = torch.cuda.Stream(self.device)

    def __call__(self, state: TrainState, pairs: Iterable
                 ) -> List[Dict[str, torch.Tensor]]:
        """The chunk's steps, one a (source, target) batch pair of
        ``pairs``, read one at a time just before its step: the upload
        stage keeps filling while the device runs the steps before."""
        if self.device.type != "cuda":
            return [self.step_fn(state, bs, bt, self.seed) for bs, bt in pairs]
        out = []
        pairs = iter(pairs)
        if self.graph is None:
            # warm-up: the chunk's first step, eager on the capture stream;
            # its inputs are the capture's template
            step, (bs, bt) = self.step_fn, next(pairs)
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                draws = step.prepare(state, bs, bt, self.seed)
                state.opt.set_lr()
                out.append(step.run(state, bs, bt, draws))
                state.advance()
            cur.wait_stream(self.stream)
            self.graph = StepGraph(step, state, bs, bt, draws, self.stream,
                                   self.wrappers)
        for bs, bt in pairs:
            out.append(self.graph(state, bs, bt, self.seed))
            ev = torch.cuda.Event()
            ev.record()
            self._ahead.append(ev)
            if len(self._ahead) > MAX_AHEAD:
                self._ahead.popleft().synchronize()
        return out

    def close(self) -> Optional[dict]:
        """Release the graph and its pool (a stage's end); returns its
        statistics, or None if nothing was captured."""
        g, self.graph = self.graph, None
        self._ahead.clear()
        if g is None:
            return None
        stats = {"capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                 "replays": g.replays, "launches": g.launches}
        torch.cuda.synchronize()
        for p in g.params:
            p.grad = None
        del g
        torch.cuda.empty_cache()
        return stats
