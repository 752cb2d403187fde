#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``uemda_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``uemda_tpu_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes of the main
paths, and drives them (flagship ResNet-50 OS16 dual-PPM model, random
weights from a seed):

* serving: the standard eval forward, the fused-stem fast path and slide +
  8-view TTA evaluation of a split with a padded last batch, through
  ``device_batches`` and the captured predictor, held to eager calls;
* ``[fused]`` the fast path with the identity bottlenecks of stages (1, 2)
  and of all four stages in the K4 kernel, and a slide + 8-view TTA
  evaluation through it; ``[int8]`` int8 serving: the dynamic int8 fast
  path, the int8 fast path calibrated on every stage, and ``Int8Model`` on
  the standard forward;
* stage-1 training (``[train]``): one f32 step on the card against the same
  step on the CPU, then 30 bf16 steps with CORAL at the 2urban geometry
  (synthetic 1024^2 LoveDA tiles cropped to 512^2 by the K9 kernel, batch 8)
  through ``run_training_loop``, ending in an evaluation;
* ``init_prototypes`` and stage 2 (``[align]``) on the model stage 1 left:
  an f32 step against the CPU, then 30 flagship steps with refine 'all';
* ``[prep]`` the real-data path on the model and prototypes stage 2 left:
  LSC superpixel maps and their shrink for four synthetic 1024^2 target
  tiles through the port's binding of ``native/superpixels.cpp`` (host
  seconds, ids, the boundary id, pixels at or above ``max_segments``), the
  ``with_aux`` eval forward against the default one, ``refine_quality``'s
  refinement in every mode on those maps (K5 and K7 held exactly to their
  plain versions there and timed on LSC and grid maps), and 21 stage-2
  steps on the LSC maps through the CUDA graph;
* ``init_prototypes`` again and stage 3 (``[ssl]``) on the model stage 2
  left: an f32 step against the CPU, then the pseudo-label sweep of the
  target tiles (slide + 8-view TTA, bf16) and 30 flagship UVEM steps, each
  mining its soft label once with the K8 kernel;
* ``[resume]`` on stage 2's flagship setup: 20 steps uninterrupted against
  10, a snapshot of the whole train state, ``maybe_resume`` into a fresh
  state and 10 more (steps 11-20 through the graph in both runs), held at
  1e-4 relative; the snapshot's cost and size; the run-dir lock;
* ``[mix]`` the mix and combo self-training (``train_ssl_mix``): an f32
  combo step (ClassMix, UVEM, refine 'all') against the CPU, then 30
  flagship combo steps on the soft labels the ``[ssl]`` sweep left in RAM
  and 30 legacy CutMix steps, each eagerly and through the graph;
* ``[zoo]`` what the stages used to refuse: stage 3 with each target loss
  of the zoo (UPS, OHEM, focal, GHM, GDP; an f32 GHM step against the
  CPU), stage 1 with OHEM and gradient accumulation, each eagerly and
  through the graph; ``with_cp`` on all four stages against none (losses,
  BatchNorm buffers, peak memory, ms/step); PROCA's stage 2
  (``AlignSimpleStep``) for 21 steps, eager and through the graph; and
  ResNeXt-50 32x4d and ResNet-50 v1c: eval forward and fast path through
  the serving graph against eager calls (K2 and K4 skipped where JAX
  skips them) and an f32 training step against the CPU;
* ``[adv]``, ``[dca]``, ``[abl]`` the other DA trainers on the chain's
  model: an f32 G + D step and an f32 DCA step (``--bcs 1``) against the
  CPU, 21 flagship adversarial steps (and 21 with ``accum_steps`` 2) and
  21 DCA steps, each eagerly and through the graph; and the UVEM
  ablation's loop (``run_regen_chunks``) at ``GENE_EVERY`` 10: a sweep,
  10 steps, a sweep, 10 steps, through the graph;
* ``[dp]`` data parallelism (``uemda_tpu_torch/parallel/``): the flagship
  stage 1, 2 and 3 steps in an NCCL group of ``torch.cuda.device_count()``
  (1 here), eager and through the graph, against the plain steps; the
  row-sharded raster predictor on a 1024 x 1536 raster with TTA, standard
  and fast path, bit-equal to the slide predictor over the padded raster;
  the collectives a step takes at world size > 1 (global BatchNorm, the
  all-reduces, the all-gather) captured in a CUDA graph on the NCCL group
  and replayed against their eager run; and two ranks sharing the card
  over gloo for the step's collectives;
* ``[tools]`` the analysis and gate tools on the chain's model:
  ``class_rates`` of the in-memory splits against a numpy recount,
  ``sample_features`` (the train-mode forward, K1) of four 1024^2 tiles a
  domain, the host-crop A/B (``hostcrop_ab``) at the loveda_synth
  geometry, ``profile_summary`` on a chrome trace of three stage-1 steps
  (each stream's busy time against its union counted apart, the events
  that overlap on a stream), ``real_data_gate`` on the model's ``.pth``
  (pins, the strict load, ``--kind imagenet --out``, the eval stage) and
  ``slide_predict`` against an eager predictor;
* ``[bnact]`` the eval BatchNorm epilogue at the sweep's shapes against its
  plain version and the library chain it replaces (alone:
  ``python3 -c "import chip_smoke; chip_smoke.bnact_phase()"``).

``[serve-graph]`` takes every bf16 serving mode through the captured
slide predictor (``infer/graph.py``) at batch 1, 8 and 32 on 512^2 tiles,
against eager calls: the difference, ms/forward and tiles/s of both, the
device's idle share under the graph, the capture's time, pool and kernel
launches a replay. The sweep (``[ssl]``) is held to its eager calls too and
timed on both routes.

It prints the launch plan ("design") of each redesigned kernel, times
kernels, forwards and steps with CUDA events, profiles the paths, and
prints one line per phase. Any failed check prints FAIL and exits
nonzero. The second-to-last line is the kernels' JSON record; the last line
is ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

import copy
import dataclasses
import json
import logging
import os
import platform
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8          # kernel checks and the flagship forward
TILE = 512
NUM_CLASSES = 6    # IsprsDA
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# dense bf16 tensor-core and non-tensor f32 peaks (H100 SXM data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def check_close(name, got, ref, atol, rtol):
    """Elementwise |got - ref| <= atol + rtol*|ref|; returns max abs err."""
    import torch

    d = (got.float() - ref.float()).abs()
    bad = d > atol + rtol * ref.float().abs()
    err = float(d.max())
    if got.shape != ref.shape or not torch.isfinite(got.float()).all() \
            or bool(bad.any()):
        fail(f"{name}: max abs err {err:.3g} over atol {atol} rtol {rtol} "
             f"({int(bad.sum())} elements), shapes {tuple(got.shape)} "
             f"{tuple(ref.shape)}")
    return err


def cuda_ms(fn, iters=20, warmup=3):
    """Time per call of fn() in ms between CUDA events around ``iters``
    back-to-back calls: the device's time, including any wait for the host
    when the caller's host work is the slower side."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters=20, warmup=3, spin_cycles=200_000_000):
    """Device time per call of fn() in ms: a spinner kernel (about 0.1 s)
    keeps the device busy while the host enqueues ``iters`` calls, so the
    events around them time back-to-back device work, not the wrapper's host
    work."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_rows(prof, n):
    """(by kernel, by operator) device time per iteration in us, largest
    first, and the total kernel time per iteration."""
    import torch

    events = prof.key_averages()
    rows = [(e.key, e.self_device_time_total / n) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    ops = [(e.key, e.self_device_time_total / n) for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    return rows, ops, sum(t for _, t in rows)


WRAPPERS = []  # every kernel wrapper with a launch count, filled by main()
CARD = [""]    # nvidia-smi's name and power limit, filled by main()


def profile_steps(what, step_fn, state, src_it, tgt_it, dev, ms_step, n=3,
                  run=None, trace=None):
    """``n`` more steps under the profiler (eager steps of ``step_fn``, or
    ``run()``, which takes ``n`` steps): device time per step, the device's
    idle share, device time by kernel and by operator, and the host's
    operator time. ``trace``: the profile also written there as a chrome
    trace. Returns the device ms a step and the idle share of the
    event-timed step ``ms_step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uemda_tpu_torch.train.loop import batch_to_device

    if run is None:
        def run():
            for _ in range(n):
                step_fn(state, batch_to_device(next(src_it), dev),
                        batch_to_device(next(tgt_it), dev), 2333)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    if trace is not None:
        prof.export_chrome_trace(trace)
    rows, ops, total_us = profile_rows(prof, n)
    if total_us <= 0:
        phase("profile", f"{what}: device time not measured (profiler saw "
              "none)")
        return None, None
    idle = max(0.0, 1 - total_us / 1e3 / ms_step)
    phase("profile", f"{what}, {n} steps: device time {total_us / 1e3:.3f} "
          f"ms/step; idle share {idle:.3f} of the event-timed step "
          f"{ms_step:.3f} ms, "
          f"{max(0.0, 1 - total_us / 1e3 / wall_ms):.3f} of the profiled wall "
          f"{wall_ms:.3f} ms/step; by kernel:")
    for key, t in rows[:15]:
        phase("profile", f"  {t / total_us * 100:5.1f}%  {t / 1e3:.4f} ms"
              f"  {key[:150]}")
    phase("profile", "by operator (device time of the kernels each "
          "launched itself), per step:")
    for key, t in ops[:15]:
        phase("profile", f"  {t / total_us * 100:5.1f}%  {t / 1e3:.4f} ms"
              f"  {key}")
    host = sorted(((e.key, e.self_cpu_time_total / n, e.count / n)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r[1])
    phase("profile", f"host: {sum(t for _, t, _ in host) / 1e3:.3f} ms of "
          f"self CPU time per step under the profiler, in "
          f"{sum(c for _, _, c in host):.0f} operator calls; largest:")
    for key, t, c in host[:10]:
        phase("profile", f"  {t / 1e3:.4f} ms  {c:.0f} calls  {key}")
    return total_us / 1e3, idle


K_GRAPH = 10  # steps_per_call of the graph reruns
DA_STEPS = 21  # step 1 alone, 2-11 and 12-21 in two calls at K_GRAPH 10


def stream(dataset, seed, host_crop=None, skip=0):
    """A training batch stream behind its decode thread, as the trainers'
    ``make_source_iter`` and ``make_target_iter`` build it (``skip``: a
    resumed run's, from batch ``skip`` on)."""
    from uemda_tpu_torch.datasets.base import infinite_batches
    from uemda_tpu_torch.datasets.prefetch import prefetch

    return prefetch(infinite_batches(dataset, BATCH, seed=seed,
                                     skip_batches=skip, host_crop=host_crop))


def copy_start(state):
    """An independent copy of a train state: the model (masters,
    BatchNorm buffers), an optimizer like the original's (its counts,
    momentum and accumulated gradients copied), the aligner, the balances
    and the GHM/GDP histogram."""
    import dataclasses

    import torch

    from uemda_tpu_torch.train.optim import SGD

    model = copy.deepcopy(state.model)
    named = list(model.named_parameters())
    o = state.opt
    opt = SGD(named, o.schedule, o.momentum, o.weight_decay, o.clip_norm,
              dict(zip(o.names, o.trainable)), accum_steps=o.accum_steps)
    opt.count, opt.mini_step = o.count, o.mini_step
    with torch.no_grad():
        for dst, src in zip(opt.trace + opt.acc, o.trace + o.acc):
            dst.copy_(src)

    def clone(x):
        return None if x is None else dataclasses.replace(x, **{
            f.name: getattr(x, f.name).clone()
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})

    return dataclasses.replace(state, model=model, opt=opt,
                               aligner=clone(state.aligner),
                               balance_s=clone(state.balance_s),
                               balance_t=clone(state.balance_t),
                               ghm=clone(state.ghm))


def graph_rerun(name, what, make_step, state, src_it, tgt_it, steps, dev,
                eager, eval_fn=None, gate=True, per_call=K_GRAPH):
    """The flagship's ``steps`` again from ``state`` (a copy of its start
    state), through ``run_training_loop`` with ``steps_per_call``
    ``per_call``
    (``K_GRAPH``: 10) and logs and evaluation at the end only: step 1
    alone, steps 2-11 and 12-21 in two calls (step 2 eager on the capture
    stream, the capture, then replays), steps 22-30 alone (at ``per_call`` 5:
    steps 2-6 and 7-11). With ``gate``, steps 1-3's losses are held to the
    eager run's (``eager``: its metrics by step) at 1e-4 relative. Prints
    the largest relative loss difference over all steps, whether the runs
    are bit-equal, ms/step of the second call (replays only) by CUDA
    events, the capture time, the graph's pool and the launches a replay
    holds; returns (ms/step, the metrics by step)."""
    import numpy as np
    import torch

    from uemda_tpu_torch.train.loop import run_training_loop

    step_fn = make_step(state.model)
    losses, events = [], []

    def on_step(i, metrics):
        losses.append(metrics)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = run_training_loop(state, step_fn, src_it, tgt_it, steps,
                            logging.getLogger(f"chip_smoke.{name}.graph"),
                            eval_every=steps, log_every=steps,
                            eval_fn=eval_fn, seed=2333, on_step=on_step,
                            steps_per_call=per_call)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = [{k: float(v) for k, v in m.items()} for m in losses]
    stats = out["graph"]
    if len(loss) != steps or not all(np.isfinite(list(m.values())).all()
                                     for m in loss):
        fail(f"{what}: {len(loss)} steps, losses {loss}")
    if stats is None or stats["replays"] != 2 * per_call - 1:
        fail(f"{what}: the graph was not replayed as scheduled ({stats})")
    rel = [abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-30)
           for a, b in zip(loss, eager)]
    if gate:
        for i in range(3):
            for k in eager[i]:
                r = abs(loss[i][k] - eager[i][k]) / max(abs(eager[i][k]),
                                                        1e-30)
                if not r <= 1e-4:  # the same kernels on the same inputs
                    fail(f"{what}: step {i + 1} {k}: graph {loss[i][k]} vs "
                         f"eager {eager[i][k]} (rel {r:.3g})")
    ms_step = events[per_call].elapsed_time(events[2 * per_call]) / per_call
    bit = all(a == b for a, b in zip(loss, eager))
    phase(name, f"{what}: {steps} steps in {wall:.2f} s (steps_per_call "
          f"{per_call}: steps 2-{2 * per_call + 1} in two calls, "
          f"{stats['replays']} replays); capture {stats['capture_s']:.3f} s, "
          f"graph pool {stats['pool_bytes'] / 2**30:.3f} GiB, peak memory "
          f"{peak:.2f} GiB; launches a replay {json.dumps(stats['launches'])}")
    if gate:
        phase(name, f"{what} vs eager: steps 1-3 losses "
              f"{json.dumps([[loss[i]['loss'], eager[i]['loss']] for i in range(3)])}"
              f"; largest relative loss difference over {steps} steps "
              f"{max(rel):.3g} (step {int(np.argmax(rel)) + 1}); bit-equal "
              f"{bit}")
    phase(name, f"{what}: losses by step: " + json.dumps(
        [round(m["loss"], 5) for m in loss]))
    phase(name, f"{what}: steps {per_call + 2}-{2 * per_call + 1} "
          f"(replays): "
          f"{ms_step:.3f} ms/step by CUDA events")
    return ms_step, loss


def graph_profile(name, what, make_step, state, src_it, tgt_it, dev, ms_step,
                  n=3):
    """``profile_steps`` over ``n`` replays of a captured step of
    ``state``'s stage (its own capture, released after)."""
    import torch

    from uemda_tpu_torch.train.graph import ChunkRunner
    from uemda_tpu_torch.train.loop import batch_to_device

    step_fn = make_step(state.model)
    runner = ChunkRunner(step_fn, 2333, dev)

    def batches(k):
        return ([batch_to_device(next(src_it), dev) for _ in range(k)],
                [batch_to_device(next(tgt_it), dev) for _ in range(k)])

    runner(state, zip(*batches(2)))  # warm-up, capture, one replay
    pairs = list(zip(*batches(n)))
    out = profile_steps(f"{what}, replays", None, None, None, None, dev,
                        ms_step, n=n, run=lambda: runner(state, pairs))
    runner.close()
    torch.cuda.synchronize()
    return out


def eval_against_eager(name, what, model, data, st, summary, miou):
    """``evaluate_dataset`` of ``data`` again with eager predictor calls
    (``capture=False``), held to the captured run's ``summary``: the same
    confusion matrix and the mIoU within 1e-12 (the same kernels on the
    same inputs). Returns the eager run's wall seconds."""
    import torch

    from uemda_tpu_torch.infer.evaluate import evaluate_dataset

    t0 = time.time()
    summary_e, miou_e = evaluate_dataset(
        model, data, st["mean"], st["std"], tile=(TILE, TILE), tta=True,
        batch_size=2, compute_dtype=torch.bfloat16, device="cuda",
        capture=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if summary_e["confusion_matrix"] != summary["confusion_matrix"] \
            or not abs(miou_e - miou) <= 1e-12:
        fail(f"{what}: evaluation through the graph (mIoU {miou}, confusion "
             f"matrix {summary['confusion_matrix']}) differs from eager calls "
             f"({miou_e}, {summary_e['confusion_matrix']})")
    phase(name, f"{what}: evaluation through the captured predictor equals "
          f"eager calls: confusion matrix equal "
          f"({sum(map(sum, summary['confusion_matrix']))} pixels), mIoU "
          f"{miou:.12f} vs {miou_e:.12f}")
    return wall


SERVE_BATCHES = (1, 8, 32)   # [serve-graph]: infer_single's case, 8, 32
# the modes whose batch-8 forward [serve-graph] breaks down by kernel
PROFILED = ("fast path", "fused (1, 2, 3, 4)", "fastpath_int8cal_all")


def serve_graph_phase(modes):
    """``[serve-graph]``: each serving mode (name: callable on bf16 (B, 3,
    512, 512) tiles) through ``make_predictor`` on one 512^2 window, the
    captured predictor against eager calls (``capture=False``) at batch 1,
    8 and 32: after the first call (the warm-up and the capture), the max
    abs diff of the f32 probabilities of two replays on two inputs (each
    re-reads the static input; gate 2e-4), ms/forward and
    tiles/s by CUDA events in turns (eager, graph, graph, eager), device
    time and idle share under the graph from the profiler (and under eager
    calls at batch 8; for the ``PROFILED`` modes at batch 8, the top
    kernels under the graph and the top operators of eager calls), the
    capture's time, pool and kernel launches a replay, and the peak
    memory. Returns {mode: launches a replay} at
    batch 8."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uemda_tpu_torch.infer.slide import make_predictor

    g = torch.Generator(device="cpu").manual_seed(11)
    iters = {1: 20, 8: 5, 32: 3}
    per_replay, table = {}, {}

    def device_rows(fn, n=3):
        """(by kernel, by operator, total) device us a forward."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return profile_rows(prof, n)

    def breakdown(mode, b, rows_g, ops_e):
        """Where a forward's device time goes: the top kernels under the
        graph and the top operators of eager calls (a replay launches
        its kernels with no operator around them)."""
        total = sum(t for _, t in rows_g)
        phase("profile", f"{mode} bf16 batch {b} through the graph, 3 "
              f"forwards: device time {total / 1e3:.3f} ms/forward; by "
              "kernel:")
        for key, t in rows_g[:12]:
            phase("profile", f"  {t / total * 100:5.1f}%  {t / 1e3:.4f} ms"
                  f"  {key[:150]}")
        total = sum(t for _, t in ops_e)
        phase("profile", f"{mode} bf16 batch {b}, eager calls: by operator "
              "(device time of the kernels each launched itself):")
        for key, t in ops_e[:10]:
            phase("profile", f"  {t / total * 100:5.1f}%  {t / 1e3:.4f} ms"
                  f"  {key}")

    for b in SERVE_BATCHES:
        xs = [torch.randn(b, 3, TILE, TILE, generator=g).to("cuda")
              .contiguous(memory_format=torch.channels_last) for _ in range(2)]
        for mode, fm in modes.items():
            kw = dict(tile=(TILE, TILE), image_hw=(TILE, TILE),
                      compute_dtype=torch.bfloat16)
            eager = make_predictor(fm, capture=False, **kw)
            graph = make_predictor(fm, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            graph(xs[0])  # the warm-up and the capture
            diffs = []
            for x in (xs[1], xs[0]):  # two replays, the input changed
                ref = eager(x)
                got = graph(x)
                if tuple(got.shape) != (b, NUM_CLASSES, TILE, TILE) \
                        or not torch.isfinite(got).all():
                    fail(f"[serve-graph] {mode} batch {b}: output "
                         f"{tuple(got.shape)} not finite or misshaped")
                diffs.append(max_err(got, ref))
                del ref, got
            if max(diffs) > 2e-4:
                fail(f"[serve-graph] {mode} batch {b}: graph vs eager max abs "
                     f"diff {diffs} over 2e-4")
            x = xs[0]
            n = iters[b]
            turns = [cuda_ms(lambda: eager(x), n, 1),
                     cuda_ms(lambda: graph(x), n, 1),
                     cuda_ms(lambda: graph(x), n, 1),
                     cuda_ms(lambda: eager(x), n, 1)]
            ms_e, ms_g = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            rows_g, _, dev_g = device_rows(lambda: graph(x))
            dev_g /= 1e3
            dev_e = None
            if b == BATCH:
                _, ops_e, dev_e = device_rows(lambda: eager(x))
                dev_e /= 1e3
                if mode in PROFILED and dev_g > 0 and dev_e > 0:
                    breakdown(mode, b, rows_g, ops_e)
            peak = torch.cuda.max_memory_allocated() / 2**30
            st = graph.close()
            launches = {k: v for k, v in st["launches"].items() if v}
            if b == BATCH:
                per_replay[mode] = st["launches"]
            idle_g = max(0.0, 1 - dev_g / ms_g) if dev_g > 0 else None
            idle_e = (max(0.0, 1 - dev_e / ms_e) if dev_e else None)
            table[f"{mode} b{b}"] = {
                "max_abs_diff": max(diffs), "eager_ms": ms_e,
                "graph_ms": ms_g, "eager_tiles_s": b / ms_e * 1e3,
                "graph_tiles_s": b / ms_g * 1e3, "graph_device_ms": dev_g,
                "graph_idle": idle_g, "eager_device_ms": dev_e,
                "eager_idle": idle_e, "capture_s": st["capture_s"],
                "pool_bytes": st["pool_bytes"], "peak_gib": peak,
                "launches_per_replay": launches}
            phase("serve-graph", f"{mode} batch {b}: graph vs eager max abs "
                  f"diff {diffs[0]:.3g}, {diffs[1]:.3g} on the two replays "
                  f"(gate 2e-4); eager {ms_e:.3f} ms/forward ({b / ms_e * 1e3:.2f} "
                  f"tiles/s), graph {ms_g:.3f} ({b / ms_g * 1e3:.2f} "
                  f"tiles/s), turns {[round(t, 3) for t in turns]}; graph "
                  f"device time {dev_g:.3f} ms, idle share "
                  f"{'not measured' if idle_g is None else f'{idle_g:.3f}'}"
                  + ("" if dev_e is None else
                     f"; eager device time {dev_e:.3f} ms, idle share "
                     f"{idle_e:.3f}")
                  + f"; capture {st['capture_s']:.3f} s, pool "
                  f"{st['pool_bytes'] / 2**30:.3f} GiB, peak memory "
                  f"{peak:.2f} GiB; launches a replay {json.dumps(launches)}")
        del xs
        torch.cuda.empty_cache()
    for name in ("stem_pool", "tail_upsample_softmax_mean", "instance_norm"):
        if per_replay["fast path"].get(name, 0) <= 0:
            fail(f"[serve-graph] the fast path's replay holds no {name}")
    if per_replay["fused (1, 2, 3, 4)"].get("bottleneck_identity", 0) != 12:
        fail(f"[serve-graph] fused (1, 2, 3, 4): "
             f"{per_replay['fused (1, 2, 3, 4)']} launches a replay, not 12 "
             "K4")
    phase("serve-graph", "summary " + json.dumps(table))
    return per_replay


# kernels (a pattern of the name) of each source whose instantiations the
# [build] lines list one by one: the kernels redesigned for Hopper (K8: its
# LoveDA instantiations and the strided route)
REDESIGNED = {"stem": "", "resblock": "", "insnorm": "",
              "segment": "segment_", "tail": "tail_kernel",
              "mine": r"uvem_mine_\w*(ILi7E|strided)"}


def in_design(p, hw) -> str:
    last = hw - (p.cluster - 1) * p.ppc
    return (f"{p.route} route, {p.cb} channels a CTA, a cluster of "
            f"{p.cluster} CTAs splitting H x W ({p.ppc} pixels each, the last "
            f"{max(0, last)}), {p.smem} B of dynamic shared memory, grid "
            f"{p.grid}")


def reduce_design(p) -> str:
    return (f"{p.route} route, {p.tile} pixels a tile (ids and values "
            f"staged), a table of {p.rows} rows, {p.smem} B of shared "
            f"memory, grid {p.grid}")


def gather_design(p) -> str:
    return (f"{p.route} route, {p.lanes} lane(s) a pixel, {p.ppc} pixels a "
            f"CTA, {p.smem} B of shared memory, grid {p.grid}")


def tail_design(p) -> str:
    return (f"{p.rows} rows x {p.cols} columns a CTA, {p.ppt} pixel(s) a "
            f"thread, an input window of at most {p.in_rows} x {p.in_cols}, "
            f"{p.smem} B of shared memory, grid {p.grid}")


def mine_design(p) -> str:
    return (f"{p.route} route, {p.ppt} pixels a thread, {p.blocks} CTAs a "
            f"sample, {p.smem} B of dynamic shared memory, grid {p.grid}")


def k4_design(plan) -> str:
    """K4's launch plan in words: tile, configuration, ring, layout."""
    from uemda_tpu_torch.ops.resblock import WGMMA_CONFIGS

    if plan.design != "wgmma":
        return (f"f32 on the CUDA cores, tile {plan.tile}, {plan.smem} B "
                f"of shared memory, grid {plan.grid}")
    kc, mt1, nw1, mt2, nw2, nw3 = WGMMA_CONFIGS[plan.config]
    return (f"wgmma config {plan.config} (k-chunk {kc}, conv1 {mt1} m-tiles "
            f"x {nw1} columns a warpgroup, conv2 {mt2} x {nw2}, conv3 {mt2} "
            f"x {nw3}), tile {plan.tile}, ring of {plan.stages} stages of "
            f"{plan.stage} B at {plan.region}, y2 at {plan.y2_off}, "
            f"{plan.smem} B of shared memory, grid {plan.grid}")


def train_phase(dev):
    """The stage-1 training path. (a) One f32 step on the card against the
    same step on the CPU's plain path. (b) The flagship run through
    ``run_training_loop``, every launch count set to 0 just before it and
    read just after; returns those counts and what stage 2 starts from
    (the config, the trained model, the source split and the target split
    with its superpixel maps)."""
    import dataclasses

    import numpy as np
    import torch

    from uemda_tpu_torch.config import PRESETS
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.train.loop import (
        build_model,
        build_state,
        default_hparams,
        make_eval_hook,
        run_training_loop,
    )
    from uemda_tpu_torch.train.steps import make_src_step

    cfg = PRESETS["2urban"]  # LoveDA: 7 classes, 1024^2 tiles, crop 512^2
    nc = cfg.class_num

    # (a) one f32 step with CORAL on the card against the CPU
    f32_step_check("train", "f32 step (ResNet-50 OS16, CORAL)", cfg, dev,
                   make_src_step, dict(align_domain=True))

    # (b) the flagship: 2urban geometry, bf16, CORAL, batch 8, 30 steps with
    # the schedule's horizon at 30 (warm-up 1 step), synthetic 1024^2 tiles
    steps, batch = 30, BATCH
    src = synthetic_split(LoveDA, n=2 * batch, hw=2 * TILE, seed=3)
    tgt_sup = synthetic_split(LoveDA, n=2 * batch, hw=2 * TILE, seed=4,
                              domain_shift=20.0, with_sup=True)
    tgt = dataclasses.replace(tgt_sup, sup=None)  # stage 1 reads no maps
    val = synthetic_split(LoveDA, n=2, hw=2 * TILE, seed=5, domain_shift=20.0)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    state = build_state(model, cfg, steps)
    start = copy_start(state)  # for the rerun through the graph
    hp = default_hparams(cfg, align_domain=True)
    step_fn = make_src_step(model, hp)
    eval_fn, _ = make_eval_hook(cfg, None, dataset=val)
    src_it = stream(src, 0)
    tgt_it = stream(tgt, 1)
    losses, events = [], []

    def on_step(i, metrics):
        losses.append(metrics)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    logger = logging.getLogger("chip_smoke.train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in WRAPPERS:
        fn.launches = 0
    t0 = time.time()
    best = run_training_loop(state, step_fn, src_it, tgt_it, steps, logger,
                             eval_every=steps, log_every=10, eval_fn=eval_fn,
                             seed=2333, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = [{k: float(v) for k, v in m.items()} for m in losses]
    if len(loss) != steps or not all(np.isfinite(list(m.values())).all()
                                     for m in loss):
        fail(f"flagship training: {len(loss)} steps, losses {loss}")
    if not loss[-1]["loss"] < loss[0]["loss"]:
        fail(f"flagship training: loss did not fall ({loss[0]['loss']} -> "
             f"{loss[-1]['loss']})")
    for name in ("instance_norm", "instance_norm_backward", "crop_normalize"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the training path")
    w0 = 5  # steps 1-5 warm cuDNN's algorithm choice and the allocator
    ms_step = events[w0 - 1].elapsed_time(events[-1]) / (steps - w0)
    phase("train", f"flagship stage 1 (ResNet-50 OS16 dual PPM, 2urban: 7 "
          f"classes, 1024^2 synthetic tiles -> 512^2 crops, batch {batch}, "
          f"bf16, CORAL) {steps} steps + evaluation in {wall:.2f} s; loss "
          f"{loss[0]['loss']:.5g} -> {loss[-1]['loss']:.5g} (seg "
          f"{loss[0]['loss_seg']:.5g} -> {loss[-1]['loss_seg']:.5g}, CORAL "
          f"{loss[0]['loss_domain']:.4g} -> {loss[-1]['loss_domain']:.4g}); "
          f"mIoU {best['miou']:.5f} (random init)")
    phase("train", "losses by step: " + json.dumps(
        [round(m["loss"], 5) for m in loss]))
    phase("train", f"steps {w0 + 1}-{steps}: {ms_step:.3f} ms/step by CUDA "
          f"events, {batch / ms_step * 1e3:.2f} source images/s "
          f"({2 * batch / ms_step * 1e3:.2f} with the target batch); peak "
          f"memory {peak:.2f} GiB")
    phase("launches", f"training path (30 steps + evaluation): "
          f"{json.dumps(counts)}")

    dev_ms, idle = profile_steps(f"stage-1 step (bf16, batch {batch}, "
                                 "CORAL)", step_fn, state, src_it, tgt_it,
                                 dev, ms_step)

    # (c) the same 30 steps from a copy of the start state through the
    # captured step, against (b)
    make = lambda m: make_src_step(m, hp)  # noqa: E731
    ms_g, _ = graph_rerun("train", "flagship stage 1 through the CUDA graph",
                          make, start, stream(src, 0), stream(tgt, 1), steps, dev,
                          loss, eval_fn=eval_fn)
    dev_g, idle_g = graph_profile("train", "stage-1 step", make, start,
                                  src_it, tgt_it, dev, ms_g)
    phase("train", f"stage 1, ms/step by CUDA events (device ms/step, idle "
          f"share): steps_per_call 1 {ms_step:.3f} ({dev_ms}, {idle}); "
          f"steps_per_call {K_GRAPH} through the graph {ms_g:.3f} "
          f"({dev_g}, {idle_g})")
    del start
    torch.cuda.empty_cache()
    return counts, dict(cfg=cfg, model=model, src=src, tgt=tgt_sup, val=val)


def align_phase(dev, ctx):
    """``init_prototypes`` and the stage-2 path. (a) One f32 stage-2 step on
    the card against the same step on the CPU's plain path. (b) On the model
    stage 1 left: the prototype pass over the source split, 30 bf16
    stage-2 steps through ``run_training_loop`` and an evaluation, every
    launch count set to 0 just before the pass and read just after the
    evaluation; returns those counts and the inputs ``label_refine`` saw
    last, for its timing."""
    import numpy as np
    import torch

    from uemda_tpu_torch.tools.init_prototypes import init_prototypes
    from uemda_tpu_torch.train.loop import (
        build_state,
        default_hparams,
        make_eval_hook,
        run_training_loop,
    )
    from uemda_tpu_torch.train.steps import (
        make_align_step,
        make_init_proto_step,
    )

    cfg = ctx["cfg"]
    nc = cfg.class_num

    # (a) one f32 stage-2 step (CORAL, refine 'all' with 16-pixel grid
    # superpixels) on the card against the CPU, the prototypes' EMA within
    # 1e-5 of their largest entry
    def proto_gate(sc, sg, _):
        p_c, p_g = sc.aligner.prototypes.cpu(), sg.aligner.prototypes.cpu()
        e_p = float((p_g - p_c).abs().max()) / float(p_c.abs().max())
        if not e_p <= 1e-5:
            fail(f"f32 stage-2 step: prototypes {e_p:.3g} of max |p| "
                 "(limit 1e-5)")
        return f"; prototypes {e_p:.3g} of max |p|"

    f32_step_check("align", "f32 stage-2 step (ResNet-50 OS16, CORAL, "
                   "refine 'all')", cfg, dev, make_align_step,
                   dict(align_domain=True), sup=True, extra=proto_gate)

    # (b) the chain at the flagship: the stage-1 model -> init_prototypes
    # over the 16 source tiles (2 batches of 8) -> 30 stage-2 steps with
    # the schedule's horizon at 30 -> evaluation
    steps, batch = 30, BATCH
    model = ctx["model"]
    hp = default_hparams(cfg, align_domain=True, refine=True,
                         refine_mode="all")
    eval_fn, _ = make_eval_hook(cfg, None, dataset=ctx["val"])
    src_it = stream(ctx["src"], 10)
    tgt_it = stream(ctx["tgt"], 11)
    losses, events = [], []

    def on_step(i, metrics):
        losses.append(metrics)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    logger = logging.getLogger("chip_smoke.align")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in WRAPPERS:
        fn.launches = 0
    t0 = time.time()
    state = build_state(model, cfg, steps)
    n_proto = init_prototypes(state, make_init_proto_step(model, hp),
                              ctx["src"], batch, 2333, dev)
    torch.cuda.synchronize()
    t_proto = time.time() - t0
    proto0 = state.aligner.prototypes.clone()
    cnt = state.aligner.data_cnt.cpu().numpy().ravel()
    if not (torch.isfinite(proto0).all() and cnt.sum() > 0):
        fail(f"init_prototypes: counts {cnt}, finite "
             f"{bool(torch.isfinite(proto0).all())}")
    phase("align", f"init_prototypes: {n_proto} batches of {batch} in "
          f"{t_proto:.2f} s; class counts {cnt.tolist()}")
    start = copy_start(state)  # for the rerun through the graph
    resume_starts = (copy_start(state), copy_start(state))  # for [resume]
    step_fn = make_align_step(model, hp)
    t0 = time.time()
    best = run_training_loop(state, step_fn, src_it, tgt_it, steps, logger,
                             eval_every=steps, log_every=10, eval_fn=eval_fn,
                             seed=2333, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = [{k: float(v) for k, v in m.items()} for m in losses]
    if len(loss) != steps or not all(np.isfinite(list(m.values())).all()
                                     for m in loss):
        fail(f"flagship stage 2: {len(loss)} steps, losses {loss}")
    moved = float((state.aligner.prototypes - proto0).abs().max())
    if not (torch.isfinite(state.aligner.prototypes).all() and moved > 0):
        fail(f"flagship stage 2: prototypes moved {moved}")
    for name in ("segment_max", "segment_gather", "instance_norm",
                 "instance_norm_backward", "crop_normalize",
                 "tail_upsample_softmax_mean"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the stage-2 path")
    w0 = 5
    ms_step = events[w0 - 1].elapsed_time(events[-1]) / (steps - w0)
    phase("align", f"flagship stage 2 (ResNet-50 OS16 dual PPM, 2urban, batch "
          f"{batch} per domain, bf16, CORAL, refine 'all', max_segments "
          f"{hp.max_segments}) {steps} steps + evaluation in {wall:.2f} s; loss "
          f"{loss[0]['loss']:.5g} -> {loss[-1]['loss']:.5g} (seg "
          f"{loss[0]['loss_seg']:.5g} -> {loss[-1]['loss_seg']:.5g}, PCL "
          f"{loss[0]['loss_align']:.5g} -> {loss[-1]['loss_align']:.5g}, "
          f"CORAL {loss[0]['loss_domain']:.4g} -> "
          f"{loss[-1]['loss_domain']:.4g}); prototypes moved {moved:.4g}; "
          f"mIoU {best['miou']:.5f}")
    phase("align", "losses by step: " + json.dumps(
        [round(m["loss"], 5) for m in loss]))
    phase("align", f"steps {w0 + 1}-{steps}: {ms_step:.3f} ms/step by CUDA "
          f"events, {batch / ms_step * 1e3:.2f} source images/s; peak memory "
          f"{peak:.2f} GiB")
    phase("launches", f"stage-2 path (init_prototypes + {steps} steps + "
          f"evaluation): {json.dumps(counts)}")
    dev_ms, idle = profile_steps(f"stage-2 step (bf16, batch {batch}, "
                                 "CORAL, refine 'all')", step_fn, state,
                                 src_it, tgt_it, dev, ms_step)
    make = lambda m: make_align_step(m, hp)  # noqa: E731
    ms_g, _ = graph_rerun("align", "flagship stage 2 through the CUDA graph",
                          make, start,
                          stream(ctx["src"], 10), stream(ctx["tgt"], 11), steps,
                          dev, loss, eval_fn=eval_fn)
    dev_g, idle_g = graph_profile("align", "stage-2 step", make, start,
                                  src_it, tgt_it, dev, ms_g)
    ctx["align_graph_ms"] = ms_g
    phase("align", f"stage 2, ms/step by CUDA events (device ms/step, idle "
          f"share): steps_per_call 1 {ms_step:.3f} ({dev_ms}, {idle}); "
          f"steps_per_call {K_GRAPH} through the graph {ms_g:.3f} "
          f"({dev_g}, {idle_g})")
    del start
    torch.cuda.empty_cache()
    saved = [fn.launches for fn in WRAPPERS]  # [resume] is not the path
    resume_phase(dev, ctx, hp, *resume_starts)
    for fn, n in zip(WRAPPERS, saved):
        fn.launches = n
    del resume_starts
    torch.cuda.empty_cache()
    return counts, state


def resume_phase(dev, ctx, hp, first, second):
    """``[resume]`` on stage 2's flagship setup, from two copies of its
    start state: 20 steps uninterrupted at ``steps_per_call`` 10 (step 1,
    steps 2-10 alone, 11-20 in one call through the graph); 10 steps with
    ``state_path`` set, which snapshot the state at step 10; then a fresh
    state (other random weights), ``maybe_resume`` into it and steps 11-20
    on streams skipped by 10, again in one call through the graph. Steps
    11-20's losses are held to the uninterrupted run's at 1e-4 relative;
    prints the largest difference, the masters' after step 20, the
    snapshot's caller-thread ms, the worker's write seconds and the
    file's MiB, and the caller's ms of a snapshot through a saver whose
    buffers are pinned already; and shows that the loop refuses a run dir
    another live trainer holds."""
    import shutil

    import torch

    from uemda_tpu_torch.train.checkpoints import AsyncSaver, RunDirLock
    from uemda_tpu_torch.train.loop import (
        build_model,
        build_state,
        maybe_resume,
        run_training_loop,
    )
    from uemda_tpu_torch.train.steps import make_align_step

    cfg = ctx["cfg"]
    run_dir = os.path.join(ROOT, "build", "smoke_resume")
    shutil.rmtree(run_dir, ignore_errors=True)
    logger = logging.getLogger("chip_smoke.resume")
    steps, cut = 20, 10

    def run(state, stop, skip=0, state_path=None):
        losses = {}
        out = run_training_loop(
            state, make_align_step(state.model, hp),
            stream(ctx["src"], 10, skip=skip),
            stream(ctx["tgt"], 11, skip=skip), stop, logger, log_every=10,
            eval_every=steps, seed=2333,
            on_step=lambda i, m: losses.__setitem__(i, m),
            steps_per_call=K_GRAPH, state_path=state_path)
        torch.cuda.synchronize()
        return {i: float(m["loss"]) for i, m in losses.items()}, out

    try:
        l1, _ = run(first, steps)
        path = os.path.join(run_dir, "state_curr.pth")
        _, out = run(second, cut, state_path=path)
        saver, mib = out["saver"], os.path.getsize(path) / 2**20
        # the same snapshot three times through one new saver: the first
        # allocates its pinned buffers (from PyTorch's cache of freed
        # pinned blocks where it holds them), the others reuse them (a
        # run's later evaluations); each write drained before the next
        again = AsyncSaver()
        fetch = []
        for _ in range(3):
            again.save(os.path.join(run_dir, "again.pth"), second.state_dict())
            again.wait()
            fetch.append(again.fetch_s * 1e3)
        again.close()
        del second
        torch.cuda.empty_cache()
        model = build_model(cfg, device=dev,
                            generator=torch.Generator().manual_seed(1))
        fresh = build_state(model, cfg, 30)
        t0 = time.time()
        fresh, start, path = maybe_resume(fresh, run_dir, "auto", logger)
        t_load = time.time() - t0
        if start != cut or fresh.opt.count != cut:
            fail(f"[resume]: maybe_resume gave step {start}, count "
                 f"{fresh.opt.count} (expected {cut})")
        held = RunDirLock(run_dir).acquire()
        try:
            run_training_loop(fresh, None, None, None, steps, logger,
                              state_path=path)
            fail("[resume]: the loop ran on a run dir another trainer holds")
        except RuntimeError as e:
            if "locked by live pid" not in str(e):
                raise
            refused = str(e).split(":")[0]
        finally:
            held.release()
        l3, out3 = run(fresh, steps, skip=start, state_path=path)
        if sorted(l3) != list(range(cut + 1, steps + 1)):
            fail(f"[resume]: the resumed run took steps {sorted(l3)}")
        rel = {i: abs(l3[i] - l1[i]) / max(abs(l1[i]), 1e-30) for i in l3}
        worst = max(rel, key=rel.get)
        if not rel[worst] <= 1e-4:
            fail(f"[resume]: step {worst} loss {l3[worst]} resumed vs "
                 f"{l1[worst]} uninterrupted (rel {rel[worst]:.3g})")
        masters = max(float((p - q).abs().max()) for p, q in
                      zip(fresh.opt.params, first.opt.params))
        bit = all(l3[i] == l1[i] for i in l3) and masters == 0.0
        phase("resume", f"stage 2 flagship, {steps} steps uninterrupted vs "
              f"{cut} + snapshot + maybe_resume into a fresh state + "
              f"{steps - cut} (steps {cut + 1}-{steps} in one call through "
              f"the graph, both runs): largest relative loss difference "
              f"{rel[worst]:.3g} (step {worst}); masters' max abs difference "
              f"after step {steps} {masters:.3g}; bit-equal {bit}")
        phase("resume", f"snapshot of the state at step {cut}: "
              f"{saver['nbytes'] / 2**20:.1f} MiB of tensors, file "
              f"{mib:.1f} MiB; {saver['fetch_s'] * 1e3:.3f} ms on the "
              f"caller's thread (the device-to-host copies enqueued), "
              f"{saver['write_s']:.3f} s on the writer's thread (copies, "
              f"serialization, write); the resumed run's final snapshot "
              f"{out3['saver']['fetch_s'] * 1e3:.3f} ms / "
              f"{out3['saver']['write_s']:.3f} s; one saver three times: "
              f"{', '.join(f'{x:.3f}' for x in fetch)} ms on the caller's "
              f"thread (the first allocates its pinned buffers), the last "
              f"write "
              f"{again.write_s:.3f} s; load into the fresh state "
              f"{t_load:.3f} s; {CARD[0]}")
        phase("resume", f"a second trainer on the run dir is refused: "
              f"{refused}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def soft_labels(labels, nc, seed):
    """(N, H, W) labels -> (N, H, W, nc) fp16 soft labels, as the sweep
    stores them, peaked on the label by a confidence drawn per 16-pixel
    block, so that they hold selected and ambiguous pixels, and entropies in
    all three UVEM branches: a random-init model's own labels select nothing
    at the default cutoffs, and a step whose target loss is 0 shows nothing
    of K8."""
    import numpy as np

    r = np.random.default_rng(seed)
    n, h, w = labels.shape
    conf = np.kron(r.choice([0.5, 2.0, 4.0, 8.0], (n, h // 16, w // 16)),
                   np.ones((16, 16)))[..., None]
    logit = r.normal(size=(n, h, w, nc)) + conf * np.eye(nc)[labels.clip(0)]
    p = np.exp(logit - logit.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float16)


def ssl_phase(dev, ctx):
    """Pipeline steps 4 and 5: ``init_prototypes`` on the model stage 2
    left, the pseudo-label sweep and the stage-3 path. (a) One f32 stage-3
    step on the card against the same step on the CPU's plain path. (b) At
    the flagship: the prototype pass, the sweep of the 16 target tiles
    (slide at 512^2, 8-view TTA, bf16, in RAM), 30 bf16 stage-3 steps
    (UVEM, refine 'all') through ``run_training_loop`` and an evaluation,
    every launch count set to 0 just before the prototype pass and read
    just after the evaluation; returns those counts."""
    import numpy as np
    import torch

    from uemda_tpu_torch.datasets.base import ArrayDataset, infinite_batches
    from uemda_tpu_torch.datasets.meta import LoveDA, NORM_STATS
    from uemda_tpu_torch.infer.fastpath import build_fastpath
    from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
    from uemda_tpu_torch.infer.slide import make_predictor
    from uemda_tpu_torch.ops.mine import uvem_mine
    from uemda_tpu_torch.ops.pseudo import pseudo_selection
    from uemda_tpu_torch.tools.init_prototypes import init_prototypes
    from uemda_tpu_torch.train.loop import (
        batch_to_device,
        build_state,
        default_hparams,
        make_eval_hook,
        run_training_loop,
    )
    from uemda_tpu_torch.train.steps import (
        make_init_proto_step,
        make_ssl_step,
    )

    cfg = ctx["cfg"]
    nc = cfg.class_num

    # (a) one f32 stage-3 step (UVEM, refine 'all', the target class
    # balance) on the card against the CPU: the prototypes within 1e-5 of
    # their largest entry, the class-balance frequencies 1e-6 relative, and
    # pixels selected and trained, so the check shows K8
    def ssl_gate(sc, sg, m_c):
        if not (m_c["loss_target"] > 0 and m_c["selected"] > 0
                and m_c["trained"] > 0):
            fail(f"f32 stage-3 step: the target loss selected or trained no "
                 f"pixel ({m_c}); the check would show nothing of K8")
        p_c, p_g = sc.aligner.prototypes.cpu(), sg.aligner.prototypes.cpu()
        f_c, f_g = sc.balance_t.freq.cpu(), sg.balance_t.freq.cpu()
        e_p = float((p_g - p_c).abs().max()) / float(p_c.abs().max())
        e_f = float(((f_g - f_c).abs() / f_c.abs()).max())
        if not (e_p <= 1e-5 and e_f <= 1e-6):
            fail(f"f32 stage-3 step: prototypes {e_p:.3g} of max |p| (limit "
                 f"1e-5); class-balance frequencies {e_f:.3g} relative "
                 "(limit 1e-6)")
        return f"; prototypes {e_p:.3g} of max |p|; frequencies {e_f:.3g}"

    f32_step_check("ssl", "f32 stage-3 step (ResNet-50 OS16, UVEM, refine "
                   "'all', target class balance)", cfg, dev, make_ssl_step,
                   dict(refine=True, refine_mode="all", balance_target=True),
                   sup=True, prob=True, extra=ssl_gate)

    # (b) the chain's steps 4 and 5 at the flagship: init_prototypes over
    # the 16 source tiles on the stage-2 model, the sweep of the 16 target
    # tiles, 30 stage-3 steps with the schedule's horizon at 30, evaluation
    steps, batch = 30, BATCH
    model = ctx["model"]
    hp = default_hparams(cfg, refine=True, refine_mode="all")
    eval_fn, _ = make_eval_hook(cfg, None, dataset=ctx["val"])
    tgt = ctx["tgt"]
    st = NORM_STATS["LoveDA"]
    src_it = stream(ctx["src"], 20)
    losses, events = [], []

    def on_step(i, metrics):
        losses.append(metrics)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    logger = logging.getLogger("chip_smoke.ssl")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in WRAPPERS:
        fn.launches = 0
    t0 = time.time()
    state = build_state(model, cfg, steps)
    n_proto = init_prototypes(state, make_init_proto_step(model, hp),
                              ctx["src"], batch, 2333, dev)
    torch.cuda.synchronize()
    t_proto = time.time() - t0
    proto0 = state.aligner.prototypes.clone()
    cnt = state.aligner.data_cnt.cpu().numpy().ravel()
    if not (torch.isfinite(proto0).all() and cnt.sum() > 0):
        fail(f"init_prototypes (stage 2's model): counts {cnt}")
    peak_proto = torch.cuda.max_memory_allocated() / 2**30
    sweep_kw = dict(tile=(TILE, TILE), tta=True, batch_size=min(4, batch),
                    cutoff_top=cfg.cutoff_top, cutoff_low=cfg.cutoff_low,
                    compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.time()
    sweep = generate_pseudo_labels(model, tgt, st["mean"], st["std"],
                                   **sweep_kw)
    torch.cuda.synchronize()
    t_sweep = time.time() - t0
    peak_sweep = torch.cuda.max_memory_allocated() / 2**30
    peak_over = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    # comparisons, their launches not counted: the sweep with eager
    # predictor calls (held equal), and the --gen-fastpath sweep (timed)
    saved = [fn.launches for fn in WRAPPERS]
    t0 = time.time()
    sweep_e = generate_pseudo_labels(model, tgt, st["mean"], st["std"],
                                     capture=False, **sweep_kw)
    torch.cuda.synchronize()
    t_sweep_e = time.time() - t0
    t0 = time.time()
    generate_pseudo_labels(model, tgt, st["mean"], st["std"], fastpath=True,
                           **sweep_kw)
    torch.cuda.synchronize()
    t_sweep_f = time.time() - t0
    # the sweep's predictor alone at its shape (a batch of 4 tiles of
    # 1024^2: 9 windows x 8 views x 4 = 288 tiles a forward), with the
    # sweep's epilogue and its colour labels (K8) inside the capture:
    # replays against eager calls, equal outputs, ms in turns, standard
    # forward and fast path
    def epilogue(probs):
        return (probs.to(torch.float16).permute(0, 2, 3, 1).contiguous(),
                uvem_mine(probs, cfg.cutoff_top, cfg.cutoff_low)[0])

    steady = {}
    x4s = [torch.randn(min(4, batch), 3, 2 * TILE, 2 * TILE, device=dev)
           .contiguous(memory_format=torch.channels_last) for _ in range(2)]
    x4 = x4s[0]
    for route, net in (("standard",
                        copy.deepcopy(model).eval().to(torch.bfloat16)),
                       ("fast path", build_fastpath(model,
                                                    dtype=torch.bfloat16))):
        kw = dict(tile=(TILE, TILE), image_hw=(2 * TILE, 2 * TILE), tta=True,
                  compute_dtype=torch.bfloat16, epilogue=epilogue)
        eager = make_predictor(net, capture=False, **kw)
        graph = make_predictor(net, **kw)
        graph(x4s[1])  # the warm-up and the capture
        for a, b_ in zip(graph(x4), eager(x4)):  # a replay, another input
            if not torch.equal(a, b_):
                fail(f"sweep predictor ({route}) through the graph differs "
                     f"from eager calls: {max_err(a, b_)}")
        turns = [cuda_ms(lambda: eager(x4), 3, 1),
                 cuda_ms(lambda: graph(x4), 3, 1),
                 cuda_ms(lambda: graph(x4), 3, 1),
                 cuda_ms(lambda: eager(x4), 3, 1)]
        st_g = graph.close()
        steady[route] = ((turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2,
                         st_g["pool_bytes"],
                         {k: v for k, v in st_g["launches"].items() if v})
        del net, eager, graph
    del x4, x4s
    torch.cuda.empty_cache()
    for fn, n in zip(WRAPPERS, saved):
        fn.launches = n
    if list(sweep_e) != list(sweep) or not all(
            np.array_equal(sweep[k], sweep_e[k]) for k in sweep):
        worst = max(float(np.abs(sweep[k].astype(np.float32)
                                 - sweep_e[k].astype(np.float32)).max())
                    for k in sweep)
        fail(f"pseudo-label sweep through the graph differs from eager "
             f"calls: max abs fp16 diff {worst}")
    bf16_bytes = sum(t.numel() * 2 for t in list(model.parameters())
                     + list(model.buffers()) if t.is_floating_point())
    phase("ssl", f"sweep through the captured predictor: fp16 probabilities "
          f"equal to eager calls' ({len(sweep)} tiles); peak memory "
          f"{peak_sweep:.2f} GiB, {peak_over:.2f} GiB above what was "
          f"allocated before it (the eager bf16 copy of the model "
          f"{bf16_bytes / 2**30:.3f} GiB, the graph's pool (below), the "
          f"warm-up's activations, the batches); 1024^2 tiles/s: standard forward "
          f"{len(tgt) / t_sweep:.3f} through the graph, "
          f"{len(tgt) / t_sweep_e:.3f} eager, --gen-fastpath "
          f"{len(tgt) / t_sweep_f:.3f} through the graph (whole calls: the "
          f"copy or fold, the warm-up and the capture included)")
    nb = min(4, batch)
    for route, (ms_e, ms_g, pool, launches) in steady.items():
        phase("ssl", f"sweep predictor alone, {route}, a batch of {nb} tiles "
              f"of {2 * TILE}^2 (288 window views a forward; the fp16 cast "
              f"and the colour labels inside the capture, equal to eager "
              f"calls'): eager {ms_e:.3f} ms ({nb / ms_e * 1e3:.3f} tiles/s), "
              f"graph {ms_g:.3f} ms ({nb / ms_g * 1e3:.3f} tiles/s); pool "
              f"{pool / 2**30:.3f} GiB; launches a replay "
              f"{json.dumps(launches)}")
        if launches.get("uvem_mine") != 1:
            fail(f"sweep predictor ({route}): K8 not in the replay "
                 f"({launches})")
    names = [tgt.filename(i) for i in range(len(tgt))]
    prob = np.stack([sweep[n] for n in names])
    if prob.shape != (len(tgt), 2 * TILE, 2 * TILE, nc) \
            or prob.dtype != np.float16 or not np.isfinite(prob).all():
        fail(f"pseudo-label sweep: {prob.shape} {prob.dtype}, finite "
             f"{bool(np.isfinite(prob).all())}")
    s_err = float(np.abs(prob.astype(np.float32).sum(-1) - 1).max())
    if s_err > 2e-2:  # bf16 views averaged, one fp16 rounding per class
        fail(f"pseudo-label sweep: probabilities sum to 1 +- {s_err}")
    with torch.no_grad():  # a reading of the sweep, on the card
        sel = float(np.mean([
            float((pseudo_selection(torch.from_numpy(prob[i:i + 1]).to(dev)
                                    .permute(0, 3, 1, 2).float(),
                                    cfg.cutoff_top, cfg.cutoff_low) >= 0)
                  .float().mean()) for i in range(len(prob))]))
    n_views = len(tgt) * 9 * 8  # 3 x 3 windows of 512^2 per 1024^2 tile
    phase("ssl", f"init_prototypes on the stage-2 model: {n_proto} batches "
          f"in {t_proto:.2f} s; pseudo-label sweep of {len(tgt)} target "
          f"tiles of {2 * TILE}^2 (slide at {TILE}^2, 8-view TTA, bf16, in "
          f"RAM as fp16: {prob.nbytes / 2**20:.1f} MiB) in {t_sweep:.3f} s: "
          f"{len(tgt) / t_sweep:.3f} tiles/s, {n_views / t_sweep:.2f} window "
          f"views of {TILE}^2 /s; share of pixels selected at the default "
          f"cutoffs {sel:.5f}; max |sum - 1| {s_err:.3g}; peak memory "
          f"{peak_proto:.2f} GiB (init_prototypes), {peak_sweep:.2f} GiB "
          f"(sweep, {min(4, batch) * 72} window views a forward)")

    target = ArrayDataset(LoveDA, tgt.images, sup=tgt.sup, prob=prob)
    tgt_it = stream(target, 21)
    start = copy_start(state)     # the reruns through the graph: as (b),
    start_hc = copy_start(state)  # and with the host crop
    step_fn = make_ssl_step(model, hp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    best = run_training_loop(state, step_fn, src_it, tgt_it, steps, logger,
                             eval_every=steps, log_every=10, eval_fn=eval_fn,
                             seed=2333, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = [{k: float(v) for k, v in m.items()} for m in losses]
    if len(loss) != steps or not all(np.isfinite(list(m.values())).all()
                                     for m in loss):
        fail(f"flagship stage 3: {len(loss)} steps, losses {loss}")
    moved = float((state.aligner.prototypes - proto0).abs().max())
    if not (torch.isfinite(state.aligner.prototypes).all() and moved > 0):
        fail(f"flagship stage 3: prototypes moved {moved}")
    if counts["uvem_mine"] != steps:
        fail(f"uvem_mine launched {counts['uvem_mine']} times in {steps} "
             "stage-3 steps (once per step)")
    for name in ("segment_max", "segment_gather", "instance_norm",
                 "instance_norm_backward", "crop_normalize",
                 "tail_upsample_softmax_mean"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the stage-3 path")
    w0 = 5
    ms_step = events[w0 - 1].elapsed_time(events[-1]) / (steps - w0)
    phase("ssl", f"flagship stage 3 (ResNet-50 OS16 dual PPM, 2urban, batch "
          f"{batch} per domain, bf16, UVEM m {hp.uvem_m} t {hp.uvem_t} gamma "
          f"{hp.uvem_g}, refine 'all', max_segments {hp.max_segments}) "
          f"{steps} steps + evaluation in {wall:.2f} s; loss "
          f"{loss[0]['loss']:.5g} -> {loss[-1]['loss']:.5g} (source "
          f"{loss[0]['loss_source']:.5g} -> {loss[-1]['loss_source']:.5g}, "
          f"target {loss[0]['loss_target']:.5g} -> "
          f"{loss[-1]['loss_target']:.5g}); prototypes moved {moved:.4g}; "
          f"mIoU {best['miou']:.5f}")
    for key in ("loss", "loss_source", "loss_target", "selected", "trained",
                "w_mean"):
        phase("ssl", f"{key} by step: " + json.dumps(
            [round(m[key], 6) for m in loss]))
    phase("ssl", f"steps {w0 + 1}-{steps}: {ms_step:.3f} ms/step by CUDA "
          f"events, {batch / ms_step * 1e3:.2f} source images/s; peak memory "
          f"{peak:.2f} GiB")
    phase("launches", f"stage-3 path (init_prototypes + sweep + {steps} "
          f"steps + evaluation): {json.dumps(counts)}")
    # the host's share of a step: assembling each domain's batch from the
    # in-memory split (numpy), whole tiles and cropped on the host, and its
    # upload, from freshly pinned memory (batch_to_device) and through the
    # upload stage's ring of reused pinned buffers, timed on their own
    from uemda_tpu_torch.datasets.prefetch import PinnedRing

    ring = PinnedRing(3)

    def ring_upload(host):
        for k, a in host.items():
            buf, ev = ring.acquire(k, a.shape, a.dtype)
            np.copyto(buf.numpy(), a)
            buf.to(dev, non_blocking=True)
            ev.record()
        torch.cuda.synchronize()

    hc = (TILE, TILE)
    for what, it in (
            ("source", infinite_batches(ctx["src"], batch, seed=20)),
            ("target", infinite_batches(target, batch, seed=21)),
            ("source, host crop",
             infinite_batches(ctx["src"], batch, seed=20, host_crop=hc)),
            ("target, host crop",
             infinite_batches(target, batch, seed=21, host_crop=hc))):
        for _ in range(3):  # the ring's slots are pinned at first use
            ring_upload(next(it))
        t_np = t_up = t_ring = 0.0
        for _ in range(5):
            t0 = time.perf_counter()
            host = next(it)
            t1 = time.perf_counter()
            batch_to_device(host, dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ring_upload(host)
            t_np += t1 - t0
            t_up += t2 - t1
            t_ring += time.perf_counter() - t2
        nbytes = sum(a.nbytes for a in host.values())
        phase("ssl", f"host data, {what} batch ({nbytes / 2**20:.1f} MiB: "
              f"{', '.join(f'{k} {a.dtype} {a.shape[1:]}' for k, a in host.items())}"
              f"): {t_np / 5 * 1e3:.3f} ms to assemble, {t_up / 5 * 1e3:.3f} "
              f"ms to pin and upload, {t_ring / 5 * 1e3:.3f} ms to upload "
              "through the pinned ring")
    # the data path alone, as the loop runs it: decode thread, upload
    # thread (pinned ring, own stream), batches taken as fast as they come
    from uemda_tpu_torch.datasets.prefetch import upload_batches

    for what, ds, seed in (("source", ctx["src"], 20),
                           ("target", target, 21)):
        cells = []
        for crop in (None, hc):
            it = upload_batches(stream(ds, seed, crop), dev)
            for _ in range(3):
                next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                next(it)
            torch.cuda.synchronize()
            cells.append((time.perf_counter() - t0) * 1e2)
            it.close()
        phase("ssl", f"upload stage alone, {what} stream: {cells[0]:.3f} ms "
              f"a batch of whole tiles, {cells[1]:.3f} ms cropped on the host")
    src_hc, tgt_hc = stream(ctx["src"], 20, hc), stream(target, 21, hc)
    dev_ms, idle = profile_steps(f"stage-3 step (bf16, batch {batch}, UVEM, "
                                 "refine 'all')", step_fn, state, src_it,
                                 tgt_it, dev, ms_step)

    # (c) the 30 steps again from copies of the start state through the
    # captured step: on the same batches, against (b); then with the host
    # crop (other crops, so other losses: not held to (b))
    make = lambda m: make_ssl_step(m, hp)  # noqa: E731
    ms_g, _ = graph_rerun("ssl", "flagship stage 3 through the CUDA graph",
                          make, start,
                          stream(ctx["src"], 20), stream(target, 21), steps,
                          dev, loss, eval_fn=eval_fn)
    del start
    torch.cuda.empty_cache()
    ms_hc, _ = graph_rerun(
        "ssl", "flagship stage 3 through the CUDA graph with --host-crop",
        make, start_hc,
        stream(ctx["src"], 20, hc), stream(target, 21, hc), steps, dev,
        loss, gate=False)
    dev_g, idle_g = graph_profile("ssl", "stage-3 step with --host-crop",
                                  make, start_hc, src_hc, tgt_hc, dev, ms_hc)
    phase("ssl", f"stage 3, ms/step by CUDA events (device ms/step, idle "
          f"share): steps_per_call 1 {ms_step:.3f} ({dev_ms}, {idle}); "
          f"steps_per_call {K_GRAPH} through the graph {ms_g:.3f}; with "
          f"--host-crop {ms_hc:.3f} ({dev_g}, {idle_g})")
    del start_hc
    torch.cuda.empty_cache()
    return counts, dict(target=target, prototypes=proto0)


def mix_phase(dev, ctx, sctx):
    """``[mix]``: the mix and combo self-training step. (a) One f32 combo
    step (ClassMix, UVEM, refine 'all', the target class balance) on the
    card against the same step on the CPU's plain path. (b) At the
    flagship, on the model the chain left, the prototypes stage 3 started
    from and the soft labels its sweep left in RAM: 30 bf16 combo steps
    through ``run_training_loop`` and an evaluation, every launch count
    set to 0 just before and read just after (returned); then again from
    a copy of the start state through the graph. (c) 30 legacy CutMix
    steps eagerly and through the graph. Graph runs are held to eager
    ones on steps 1-3 at 1e-4 relative."""
    import dataclasses

    import numpy as np
    import torch

    from uemda_tpu_torch.datasets.augment import draw_augment
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.ops.mixing import draw_mix
    from uemda_tpu_torch.train.loop import (
        batch_to_device,
        build_model,
        build_state,
        default_hparams,
        make_eval_hook,
        run_training_loop,
    )
    from uemda_tpu_torch.train.steps import MixStepDraws, make_mix_step

    cfg = ctx["cfg"]
    nc = cfg.class_num

    # (a) f32, TF32 off: ResNet-50 OS16 dual PPM at 128^2, batch 2, the
    # stage-3 check's model, batches, soft labels and prototypes; the
    # augmentation, class subset and three sets of dropout masks drawn
    # once on the host, the same on both devices, at step 1
    small = dataclasses.replace(cfg, crop=(128, 128))
    g = torch.Generator().manual_seed(1)
    cpu_model = build_model(small, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    gpu_model = build_model(small, device=dev,
                            generator=torch.Generator().manual_seed(0))
    gpu_model.load_state_dict(cpu_model.state_dict())
    hp32 = default_hparams(small, refine=True, refine_mode="all",
                           target_loss="uvem", balance_target=True,
                           compute_dtype="float32")
    data = synthetic_split(LoveDA, n=4, hw=160, seed=2, with_sup=True)
    bs = {"image": data.images[:2], "label": data.labels[:2]}
    bt = {"image": data.images[2:], "sup": data.sup[2:],
          "prob": soft_labels(data.labels[2:], nc, seed=1)}
    drop = [{h: torch.rand(2, 512, 8, 8, generator=g) < 0.9
             for h in ("layer5", "layer6")} for _ in range(3)]
    draws = MixStepDraws(
        draw_augment(g, 2, (160, 160), small.crop),
        draw_augment(g, 2, (160, 160), small.crop, "compose"),
        drop[0], drop[1], mix=draw_mix(g, "classmix", small.crop, nc),
        drop_m=drop[2])
    proto = torch.randn(nc, cpu_model.config.inchannels, generator=g)
    out = {}
    for name, model, d in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
        state = build_state(model, small, 100, prototypes=proto)
        state.step = state.opt.count = 1
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics = make_mix_step(model, hp32, "classmix", combo=True)(
            state, batch_to_device(bs, d), batch_to_device(bt, d), 0,
            draws=draws)
        out[name] = (
            {k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: (p.detach() - before[n]).cpu()
             for n, p in model.named_parameters()},
            state.aligner.prototypes.cpu(), state.balance_t.freq.cpu())
    (m_c, g_c, u_c, p_c, f_c), (m_g, g_g, u_g, p_g, f_g) = \
        out["cpu"], out["gpu"]
    for k in m_c:
        rel = abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-30)
        if not rel <= 1e-4:  # f32 sums in other orders, as stages 1-3
            fail(f"f32 combo mix step {k}: card {m_g[k]} vs CPU {m_c[k]} "
                 f"(rel {rel:.3g})")
    if not m_c["loss_target"] > 0:
        fail(f"f32 combo mix step: the target loss is 0 ({m_c})")

    def rel_max(a, b):
        num = max(float((a[n] - b[n]).abs().max()) for n in a)
        return num / max(float(b[n].abs().max()) for n in b)

    e_g, e_u = rel_max(g_g, g_c), rel_max(u_g, u_c)
    e_p = float((p_g - p_c).abs().max()) / float(p_c.abs().max())
    e_f = float(((f_g - f_c).abs() / f_c.abs()).max())
    if not (e_g <= 2e-2 and e_u <= 2e-2 and e_p <= 1e-5 and e_f <= 1e-6):
        fail(f"f32 combo mix step: gradients {e_g:.3g}, updates {e_u:.3g} of "
             f"max |g| (limit 2e-2); prototypes {e_p:.3g} of max |p| (limit "
             f"1e-5); class-balance frequencies {e_f:.3g} relative (limit "
             "1e-6)")
    phase("mix", f"f32 combo mix step on the card vs the CPU plain path "
          f"(ResNet-50 OS16, 128^2, batch 2, ClassMix, UVEM, refine 'all', "
          f"target class balance, step 1): "
          f"{json.dumps({k: [m_g[k], m_c[k]] for k in m_c})}; gradients max "
          f"abs err / max |g| {e_g:.3g}, updates {e_u:.3g}; prototypes "
          f"{e_p:.3g} of max |p|; frequencies {e_f:.3g}")
    del cpu_model, gpu_model, out, g_c, g_g, u_c, u_g

    # (b) the flagship combo: 30 steps with the schedule's horizon at 30,
    # ClassMix, UVEM, refine 'all' with the 2urban grid superpixels, the
    # sweep's soft labels
    steps, batch = 30, BATCH
    model = ctx["model"]
    target = sctx["target"]
    hp = default_hparams(cfg, refine=True, refine_mode="all",
                         target_loss="uvem")
    eval_fn, _ = make_eval_hook(cfg, None, dataset=ctx["val"])
    logger = logging.getLogger("chip_smoke.mix")

    def eager(what, make, state, log_every, eval_fn=None):
        losses, events = [], []

        def on_step(i, metrics):
            losses.append(metrics)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        best = run_training_loop(state, make(state.model), stream(ctx["src"], 30),
                                 stream(target, 31), steps, logger,
                                 eval_every=steps, log_every=log_every,
                                 eval_fn=eval_fn, seed=2333, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.time() - t0
        loss = [{k: float(v) for k, v in m.items()} for m in losses]
        if len(loss) != steps or not all(np.isfinite(list(m.values())).all()
                                         for m in loss):
            fail(f"{what}: {len(loss)} steps, losses {loss}")
        w0 = 5
        ms = events[w0 - 1].elapsed_time(events[-1]) / (steps - w0)
        phase("mix", f"{what} (ResNet-50 OS16 dual PPM, 2urban, batch "
              f"{batch} per domain, bf16) {steps} steps in {wall:.2f} s; loss "
              f"{loss[0]['loss']:.5g} -> {loss[-1]['loss']:.5g} (source "
              f"{loss[0]['loss_source']:.5g} -> {loss[-1]['loss_source']:.5g}"
              f", target {loss[0]['loss_target']:.5g} -> "
              f"{loss[-1]['loss_target']:.5g}); steps {w0 + 1}-{steps}: "
              f"{ms:.3f} ms/step by CUDA events; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {CARD[0]}")
        return loss, ms, best

    state = build_state(model, cfg, steps, prototypes=sctx["prototypes"])
    start = copy_start(state)
    legacy = (copy_start(state), copy_start(state))
    combo = lambda m: make_mix_step(m, hp, "classmix", combo=True)  # noqa: E731
    for fn in WRAPPERS:
        fn.launches = 0
    loss, ms_step, best = eager("flagship combo (ClassMix, UVEM, refine "
                                "'all')", combo, state, 10, eval_fn)
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    if counts["uvem_mine"] != steps:
        fail(f"uvem_mine launched {counts['uvem_mine']} times in {steps} "
             "combo steps (once per step)")
    for name in ("segment_max", "segment_gather", "instance_norm",
                 "instance_norm_backward", "crop_normalize"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the mix path")
    phase("mix", f"flagship combo: mIoU {best['miou']:.5f} (random init)")
    phase("launches", f"mix path ({steps} combo steps + evaluation): "
          f"{json.dumps(counts)}")
    src_it, tgt_it = stream(ctx["src"], 30), stream(target, 31)
    dev_ms, idle = profile_steps(f"combo mix step (bf16, batch {batch}, "
                                 "ClassMix, UVEM, refine 'all')", combo(model),
                                 state, src_it, tgt_it, dev, ms_step)
    saved = [fn.launches for fn in WRAPPERS]
    ms_g, _ = graph_rerun("mix", "flagship combo through the CUDA graph",
                          combo, start, stream(ctx["src"], 30),
                          stream(target, 31), steps, dev, loss,
                          eval_fn=eval_fn)
    dev_g, idle_g = graph_profile("mix", "combo mix step", combo, start,
                                  src_it, tgt_it, dev, ms_g)
    del start
    torch.cuda.empty_cache()

    # (c) the reference's mix trainer: CutMix, CE on both mixed batches
    hp_l = default_hparams(cfg, refine=False, target_loss="ce")
    make_l = lambda m: make_mix_step(m, hp_l, "cutmix")  # noqa: E731
    loss_l, ms_l, _ = eager("flagship legacy CutMix", make_l, legacy[0], 10)
    ms_lg, _ = graph_rerun("mix", "flagship legacy CutMix through the CUDA "
                           "graph", make_l, legacy[1], stream(ctx["src"], 30),
                           stream(target, 31), steps, dev, loss_l)
    for fn, n in zip(WRAPPERS, saved):
        fn.launches = n
    phase("mix", f"ms/step by CUDA events (device ms/step, idle share): "
          f"combo steps_per_call 1 {ms_step:.3f} ({dev_ms}, {idle}), "
          f"steps_per_call {K_GRAPH} through the graph {ms_g:.3f} ({dev_g}, "
          f"{idle_g}); legacy CutMix steps_per_call 1 {ms_l:.3f}, through "
          f"the graph {ms_lg:.3f}; {CARD[0]}")
    del legacy
    torch.cuda.empty_cache()
    return counts


ZOO_LOSSES = ("ups", "ohem", "focal", "ghm", "gdp")
ZOO_STEPS, ZOO_K = 11, 5  # step 1 alone, 2-6 and 7-11 in two calls


def f32_step_check(tag, what, cfg, dev, make_step, hp_kw, backbone=None,
                   sup=False, prob=False, extra=None, wrap=None, tol=None):
    """One f32 train step (TF32 off) on the card against the same step on
    the CPU's plain path: ResNet-50 OS16 dual PPM (or ``backbone``) at
    128^2, batch 2, the same weights (seed 0), LoveDA batches (seed 2),
    augmentation draws, dropout masks and random prototypes (seed 1) on
    both devices, at step 1 (lr(1) != 0) of a 100-step schedule; with
    ``sup`` the target carries its superpixel maps, with ``prob`` stored
    soft labels peaked on its labels and stage 3's "compose" pipeline.
    Gates: losses 1e-4 relative (f32 sums in other orders; the shares of
    selected and trained pixels 1e-3: a pixel at a threshold may flip),
    gradients and updates 2e-2 of max |g| (the tiny geometry's gradients
    are ill-conditioned in f32, PERF.md, PRs 2-3); ``extra(state_cpu,
    state_gpu, metrics_cpu)`` adds its own gates and returns a note.
    ``wrap(state)`` gives the state the step takes (the adversarial
    step's ``AdvState``); ``tol`` {metric: relative limit} replaces 1e-4
    for a metric that reads the updated model."""
    import dataclasses

    import torch

    from uemda_tpu_torch.datasets.augment import draw_augment
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.train.loop import (
        batch_to_device,
        build_model,
        build_state,
        default_hparams,
    )
    from uemda_tpu_torch.train.steps import StepDraws

    small = dataclasses.replace(cfg, crop=(128, 128),
                                model=backbone or cfg.model)
    nc = small.class_num
    g = torch.Generator().manual_seed(1)
    cpu_model = build_model(small, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    gpu_model = build_model(small, device=dev,
                            generator=torch.Generator().manual_seed(0))
    gpu_model.load_state_dict(cpu_model.state_dict())
    hp32 = default_hparams(small, compute_dtype="float32", **hp_kw)
    data = synthetic_split(LoveDA, n=4, hw=160, seed=2, with_sup=sup)
    bs = {"image": data.images[:2], "label": data.labels[:2]}
    bt = {"image": data.images[2:]}
    if sup:
        bt["sup"] = data.sup[2:]
    if prob:
        bt["prob"] = soft_labels(data.labels[2:], nc, seed=1)
    drop = [{h: torch.rand(2, 512, 8, 8, generator=g) < 0.9
             for h in ("layer5", "layer6")} for _ in range(2)]
    draws = StepDraws(draw_augment(g, 2, (160, 160), small.crop),
                      draw_augment(g, 2, (160, 160), small.crop,
                                   "compose" if prob else "oneof"), *drop)
    proto = torch.randn(nc, cpu_model.config.inchannels, generator=g)
    out, states = {}, {}
    for name, model, d in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
        state = build_state(model, small, 100, prototypes=proto)
        state.step = state.opt.count = 1
        if wrap is not None:
            state = wrap(state)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics = make_step(model, hp32)(
            state, batch_to_device(bs, d), batch_to_device(bt, d), 0,
            draws=draws)
        out[name] = (
            {k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: (p.detach() - before[n]).cpu()
             for n, p in model.named_parameters()})
        states[name] = state
    (m_c, g_c, u_c), (m_g, g_g, u_g) = out["cpu"], out["gpu"]
    for k in m_c:
        if k in ("selected", "trained"):  # a pixel at a threshold may flip
            ok = abs(m_g[k] - m_c[k]) <= 1e-3
        else:
            ok = abs(m_g[k] - m_c[k]) <= (tol or {}).get(k, 1e-4) * max(
                abs(m_c[k]), 1e-30)
        if not ok:
            fail(f"{what}: {k} card {m_g[k]} vs CPU {m_c[k]}")

    def rel_max(a, b):
        num = max(float((a[n] - b[n]).abs().max()) for n in a)
        return num / max(float(b[n].abs().max()) for n in b)

    e_g, e_u = rel_max(g_g, g_c), rel_max(u_g, u_c)
    if not (e_g <= 2e-2 and e_u <= 2e-2):
        worst = max(g_c, key=lambda n: float((g_g[n] - g_c[n]).abs().max()))
        fail(f"{what}: gradients {e_g:.3g}, updates {e_u:.3g} of max |g| "
             f"(limit 2e-2), worst {worst}")
    note = extra(states["cpu"], states["gpu"], m_c) if extra else ""
    phase(tag, f"{what} on the card vs the CPU plain path (128^2, batch 2, "
          f"step 1): {json.dumps({k: [m_g[k], m_c[k]] for k in m_c})}; "
          f"gradients max abs err / max |g| {e_g:.3g}, updates {e_u:.3g}"
          f"{note}")
    return states


def eager_run(tag, what, make, state, src_it, tgt_it, steps, logger,
              eval_fn=None):
    """``steps`` eager steps of ``make(state.model)`` through
    ``run_training_loop`` (logs and an optional evaluation at the end);
    returns (metrics by step, ms/step by CUDA events over steps 4 on,
    the loop's result)."""
    import numpy as np
    import torch

    from uemda_tpu_torch.train.loop import run_training_loop

    losses, events = [], []

    def on_step(i, metrics):
        losses.append(metrics)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    best = run_training_loop(state, make(state.model), src_it, tgt_it, steps,
                             logger, eval_every=steps, log_every=steps,
                             eval_fn=eval_fn, seed=2333, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    loss = [{k: float(v) for k, v in m.items()} for m in losses]
    if len(loss) != steps or not all(np.isfinite(list(m.values())).all()
                                     for m in loss):
        fail(f"{what}: {len(loss)} steps, losses {loss}")
    w0 = 3
    ms = events[w0 - 1].elapsed_time(events[-1]) / (steps - w0)
    phase(tag, f"{what}: {steps} eager steps in {wall:.2f} s; loss "
          f"{loss[0]['loss']:.5g} -> {loss[-1]['loss']:.5g}; steps "
          f"{w0 + 1}-{steps}: {ms:.3f} ms/step by CUDA events; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {CARD[0]}")
    return loss, ms, best


def zoo_phase(dev, ctx, sctx):
    """``[zoo]``: what the three stages used to refuse, at the flagship
    (ResNet-50 OS16 dual PPM, 2urban, bf16, batch 8 per domain, 512^2
    crops) unless named otherwise. (a) Stage 3 with each target loss of
    ``ZOO_LOSSES`` (refine 'all', on the chain's model, the prototypes
    stage 3 started from and the ``[ssl]`` sweep's soft labels):
    ``ZOO_STEPS`` eager steps, then again from a copy of the start state
    through the graph at ``ZOO_K``, steps 1-3 held at 1e-4 relative;
    for GHM also the histogram of both runs, and one f32 step on the card
    against the CPU. (b) Stage 1 with OHEM and ``accum_steps`` 2, eager
    and through the graph: the masters, momentum and running mean of the
    two runs equal. (c) ``with_cp`` on all four stages against the same
    stage-1 steps without it: losses, BatchNorm buffers, peak memory,
    ms/step. (d) PROCA's stage 2 (``AlignSimpleStep``) for 21 steps,
    eager and through the graph. (e) ResNeXt-50 32x4d and ResNet-50 v1c
    with random weights: the eval forward and the fast path at batch 8
    through the serving graph against eager calls, ms/forward, K2 and K4
    launches where JAX skips them, and an f32 training step on the card
    against the CPU. Every launch count is set to 0 before (a) and read
    after (e); returns those counts."""
    import torch

    from uemda_tpu_torch.infer.fastpath import build_fastpath
    from uemda_tpu_torch.infer.slide import make_predictor
    from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
    from uemda_tpu_torch.ops.resblock import bottleneck_identity
    from uemda_tpu_torch.ops.segment import segment_gather, segment_max
    from uemda_tpu_torch.ops.stem import stem_pool
    from uemda_tpu_torch.train.loop import (
        batch_to_device,
        build_state,
        default_hparams,
        make_eval_hook,
    )
    from uemda_tpu_torch.train.steps import (
        make_align_simple_step,
        make_src_step,
        make_ssl_step,
    )

    cfg = ctx["cfg"]
    base = ctx["model"]
    target = sctx["target"]
    logger = logging.getLogger("chip_smoke.zoo")
    eval_fn, _ = make_eval_hook(cfg, None, dataset=ctx["val"])

    # (a0) the f32 GHM step on the card against the CPU, with the target
    # class balance on (which GHM does not move, as JAX); the histogram of
    # each head's gradient norms: the same pixel count, at most 0.1% of the
    # pixels' weight in another bin (a norm on an edge may round across)
    def ghm_gate(sc, sg, _):
        a, b = sg.ghm.acc_sum.cpu(), sc.ghm.acc_sum.cpu()
        l1 = float((a - b).abs().sum())
        if not (abs(float(a.sum() - b.sum())) <= 1e-5 * float(b.sum())
                and l1 <= 1e-3 * float(b.sum()) and float(b.sum()) > 0):
            fail(f"f32 GHM step: acc_sum card {a.tolist()} vs CPU "
                 f"{b.tolist()}")
        if not torch.equal(sg.balance_t.freq.cpu(), sc.balance_t.freq.cpu()):
            fail("f32 GHM step: the target class balance moved")
        return f"; acc_sum L1 diff {l1:.3g} of {float(b.sum()):.6g}"

    f32_step_check("zoo", "f32 stage-3 GHM step (refine 'all', target "
                   "class balance)", cfg, dev, make_ssl_step,
                   dict(refine=True, refine_mode="all", target_loss="ghm",
                        balance_target=True), sup=True, prob=True,
                   extra=ghm_gate)

    torch.cuda.synchronize()
    for fn in WRAPPERS:
        fn.launches = 0
    t_zoo = time.time()
    # (a) stage 3 with each loss of the zoo, eager and through the graph,
    # on host-cropped batches (the same crops in both runs): the whole
    # tiles' upload would bind the graph runs on some hosts (PR 12, §5),
    # and the losses are compared by their device time
    steps = ZOO_STEPS
    hc = (TILE, TILE)
    table = {}
    for lt in ZOO_LOSSES:
        hp = default_hparams(cfg, refine=True, refine_mode="all",
                             target_loss=lt)
        make = lambda m, hp=hp: make_ssl_step(m, hp)  # noqa: E731
        state = build_state(copy.deepcopy(base), cfg, steps,
                            prototypes=sctx["prototypes"])
        start = copy_start(state)
        loss, ms_e, _ = eager_run("zoo", f"stage 3 --lt {lt}", make, state,
                                  stream(ctx["src"], 40, hc),
                                  stream(target, 41, hc), steps, logger)
        if not max(m["loss_target"] for m in loss) > 0:
            fail(f"stage 3 --lt {lt}: the target loss stayed 0 ({loss})")
        ms_g, _ = graph_rerun("zoo", f"stage 3 --lt {lt} through the CUDA "
                              "graph", make, start, stream(ctx["src"], 40, hc),
                              stream(target, 41, hc), steps, dev, loss,
                              per_call=ZOO_K)
        if lt == "ghm":
            a, b = state.ghm.acc_sum, start.ghm.acc_sum
            err = float((a - b).abs().max())
            if not err <= 1e-5 * float(a.abs().max()):
                fail(f"stage 3 --lt ghm: the graph's histogram differs from "
                     f"the eager run's by {err}")
            phase("zoo", f"stage 3 --lt ghm: histogram after {steps} steps "
                  f"eager vs graph max abs diff {err:.3g} (sum "
                  f"{float(a.sum()):.6g}); target class balance untouched "
                  f"{bool(torch.allclose(state.balance_t.freq, torch.full_like(state.balance_t.freq, 1.0 / cfg.class_num)))}")
        # the profiled steps are extra: their launches are not counted
        saved = [fn.launches for fn in WRAPPERS]
        src_it, tgt_it = stream(ctx["src"], 42, hc), stream(target, 43, hc)
        row = [ms_e, ms_g]
        if lt == "ghm":
            row += list(profile_steps(
                f"stage-3 step --lt {lt} (bf16, batch {BATCH}, refine "
                "'all', host crop)", make(state.model), state, src_it,
                tgt_it, dev, ms_e))
        row += list(graph_profile("zoo", f"stage-3 step --lt {lt}", make,
                                  start, src_it, tgt_it, dev, ms_g))
        for fn, n in zip(WRAPPERS, saved):
            fn.launches = n
        table[lt] = row
        del state, start
        torch.cuda.empty_cache()
    phase("zoo", "stage 3 by --lt (host crop), ms/step by CUDA events "
          f"[eager, through the graph at K={ZOO_K}, (GHM: eager device "
          f"ms/step, idle share,) graph device ms/step, idle share]: "
          f"{json.dumps(table)}; {CARD[0]}")

    # (b) stage 1 with OHEM and gradient accumulation 2
    hp1 = default_hparams(cfg, align_domain=True, source_loss="ohem")
    make1 = lambda m: make_src_step(m, hp1)  # noqa: E731
    state = build_state(copy.deepcopy(base), cfg, steps, accum_steps=2)
    start = copy_start(state)
    loss, ms_e, _ = eager_run("zoo", "stage 1 --ls OhemCrossEntropy "
                              "--accum-steps 2", make1, state,
                              stream(ctx["src"], 44), stream(ctx["tgt"], 45),
                              steps, logger)
    ms_g, _ = graph_rerun("zoo", "stage 1 --ls OhemCrossEntropy --accum-steps "
                          "2 through the CUDA graph", make1, start,
                          stream(ctx["src"], 44), stream(ctx["tgt"], 45),
                          steps, dev, loss, per_call=ZOO_K)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        list(state.model.parameters()) + state.opt.trace + state.opt.acc,
        list(start.model.parameters()) + start.opt.trace + start.opt.acc))
    counts_ok = (state.opt.count, state.opt.mini_step) == \
        (start.opt.count, start.opt.mini_step) == (steps // 2, steps % 2)
    if diff != 0 or not counts_ok:
        fail(f"accumulation: masters, momentum and running mean after "
             f"{steps} micro-steps differ between eager and graph by {diff}; "
             f"counts {state.opt.count, state.opt.mini_step} / "
             f"{start.opt.count, start.opt.mini_step}")
    phase("zoo", f"stage 1 OHEM, accumulation 2: after {steps} micro-steps "
          f"({state.opt.count} updates, mini_step {state.opt.mini_step}) the "
          f"masters, momentum and running mean of eager and graph runs are "
          f"equal; ms/micro-step eager {ms_e:.3f}, through the graph "
          f"{ms_g:.3f}; {CARD[0]}")
    del state, start
    torch.cuda.empty_cache()

    # (c) with_cp on all four stages against the same stage-1 steps
    hp_c = default_hparams(cfg, align_domain=True)
    it_s, it_t = stream(ctx["src"], 46), stream(ctx["tgt"], 47)
    batches = [(batch_to_device(next(it_s), dev),
                batch_to_device(next(it_t), dev)) for _ in range(6)]
    it_s.close()
    it_t.close()
    runs = {}
    for cp in (False, True):
        model = copy.deepcopy(base)
        model.encoder.resnet.with_cp = (cp,) * 4
        state = build_state(model, cfg, 30)
        step = make_src_step(model, hp_c)
        out, bufs = [], None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        evs = []
        for i, (bs, bt) in enumerate(batches):
            out.append({k: float(v) for k, v in step(state, bs, bt,
                                                     2333).items()})
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append(ev)
            if i == 0:
                bufs = {n: b.clone() for n, b in model.named_buffers()}
        torch.cuda.synchronize()
        runs[cp] = dict(
            loss=out, bufs1=bufs, bufs={n: b.clone() for n, b in
                                        model.named_buffers()},
            ms=evs[1].elapsed_time(evs[-1]) / (len(evs) - 2),
            peak=(torch.cuda.max_memory_allocated() - base_mem) / 2**30)
        # the device's time a step (three more steps, not held to anything)
        runs[cp]["device"] = profile_steps(
            f"stage-1 step, with_cp {cp} (bf16, batch {BATCH}, CORAL)", None,
            None, None, None, dev, runs[cp]["ms"], n=3,
            run=lambda: [step(state, bs, bt, 2333) for bs, bt in batches[:3]])
        del state, step
        if not cp:
            del model
    a, b = runs[False], runs[True]
    for i, (x, y) in enumerate(zip(a["loss"], b["loss"])):
        for k in x:
            if not abs(x[k] - y[k]) <= 1e-4 * max(abs(x[k]), 1e-30):
                fail(f"with_cp: step {i + 1} {k} {y[k]} vs {x[k]} without")
    for n, t in a["bufs1"].items():
        if not torch.equal(t, b["bufs1"][n]):
            fail(f"with_cp: BatchNorm buffer {n} after step 1 differs")
    bit = all(torch.equal(t, b["bufs"][n]) for n, t in a["bufs"].items())
    phase("zoo", f"with_cp on all four stages vs none (stage 1, CORAL, bf16, "
          f"batch {BATCH}, 6 steps): losses within 1e-4 "
          f"({json.dumps([[x['loss'], y['loss']] for x, y in zip(a['loss'], b['loss'])])}), "
          f"BatchNorm buffers equal after step 1, after step 6 bit-equal "
          f"{bit}; peak memory above the model's {a['peak']:.3f} GiB without, "
          f"{b['peak']:.3f} GiB with; ms/step {a['ms']:.3f} without, "
          f"{b['ms']:.3f} with (device ms/step, idle share: {a['device']} "
          f"without, {b['device']} with); {CARD[0]}")
    table["with_cp"] = [a["ms"], b["ms"], a["peak"], b["peak"],
                        a["device"], b["device"]]
    del runs, a, b, model, batches
    torch.cuda.empty_cache()

    # (d) PROCA's stage 2: 21 steps, eager and through the graph
    steps_p = DA_STEPS
    hp_p = default_hparams(cfg, refine=False)
    make_p = lambda m: make_align_simple_step(m, hp_p, conf_thresh=0.9)  # noqa: E731,E501
    state = build_state(copy.deepcopy(base), cfg, steps_p,
                        prototypes=sctx["prototypes"])
    start = copy_start(state)
    proto0 = state.aligner.prototypes.clone()
    seg0 = [segment_max.launches, segment_gather.launches]
    loss_p, ms_pe, best = eager_run("zoo", "PROCA stage 2 (AlignSimpleStep, "
                                    "conf 0.9)", make_p, state,
                                    stream(ctx["src"], 48),
                                    stream(ctx["tgt"], 49), steps_p, logger,
                                    eval_fn=eval_fn)
    moved = float((state.aligner.prototypes - proto0).abs().max())
    if not (torch.isfinite(state.aligner.prototypes).all() and moved > 0):
        fail(f"PROCA stage 2: prototypes moved {moved}")
    if [segment_max.launches, segment_gather.launches] != seg0:
        fail("PROCA stage 2 launched K5/K7: it has no refinement")
    ms_pg, _ = graph_rerun("zoo", "PROCA stage 2 through the CUDA graph",
                           make_p, start, stream(ctx["src"], 48),
                           stream(ctx["tgt"], 49), steps_p, dev, loss_p,
                           eval_fn=eval_fn)
    table["proca"] = [ms_pe, ms_pg]
    phase("zoo", f"PROCA stage 2: prototypes moved {moved:.4g}; mIoU "
          f"{best['miou']:.5f}; loss_align {loss_p[0]['loss_align']:.5g} -> "
          f"{loss_p[-1]['loss_align']:.5g}; ms/step eager {ms_pe:.3f}, "
          f"through the graph {ms_pg:.3f}; {CARD[0]}")
    del state, start
    torch.cuda.empty_cache()

    # (e) ResNeXt-50 32x4d and ResNet-50 v1c, random weights
    g = torch.Generator(device="cpu").manual_seed(12)
    xs = [torch.randn(BATCH, 3, TILE, TILE, generator=g).to(dev)
          .contiguous(memory_format=torch.channels_last) for _ in range(2)]
    for rt in ("resnext50_32x4d", "resnet50_v1c"):
        model = DeeplabV2(DeeplabV2Config.uemda_default(NUM_CLASSES,
                                                        resnet_type=rt),
                          device=dev, generator=torch.Generator()
                          .manual_seed(0))
        nets = {"standard": copy.deepcopy(model).eval().to(torch.bfloat16),
                "fast path, fused (1, 2, 3, 4)": build_fastpath(
                    model, dtype=torch.bfloat16, fused_stages=(1, 2, 3, 4))}
        cells = {}
        for mode, net in nets.items():
            kw = dict(tile=(TILE, TILE), image_hw=(TILE, TILE),
                      compute_dtype=torch.bfloat16)
            eager = make_predictor(net, capture=False, **kw)
            graph = make_predictor(net, **kw)
            k2, k4 = stem_pool.launches, bottleneck_identity.launches
            ref = eager(xs[1])
            per = {"stem_pool": stem_pool.launches - k2,
                   "bottleneck_identity": bottleneck_identity.launches - k4}
            graph(xs[0])  # the warm-up and the capture
            got = graph(xs[1])
            if tuple(got.shape) != (BATCH, NUM_CLASSES, TILE, TILE) \
                    or not torch.isfinite(got).all():
                fail(f"{rt} {mode}: output {tuple(got.shape)}, finite "
                     f"{bool(torch.isfinite(got).all())}")
            err = max_err(got, ref)
            if err > 2e-4:
                fail(f"{rt} {mode}: graph vs eager max abs diff {err}")
            ms_e = cuda_ms(lambda: eager(xs[0]), 5, 1)
            ms_g = cuda_ms(lambda: graph(xs[0]), 5, 1)
            graph.close()
            cells[mode] = dict(ms_eager=ms_e, ms_graph=ms_g, graph_err=err,
                               **per)
            del eager, graph, ref, got
        fp = cells["fast path, fused (1, 2, 3, 4)"]
        want = ({"stem_pool": 0, "bottleneck_identity": 12}
                if rt.endswith("v1c") else
                {"stem_pool": 1, "bottleneck_identity": 0})
        if {k: fp[k] for k in want} != want:
            fail(f"{rt} fast path: launches a forward {fp} (want {want}: JAX "
                 "runs the v1c stem as library convs and keeps grouped "
                 "blocks off the fused kernel)")
        phase("zoo", f"{rt} (random weights, bf16, batch {BATCH}, {TILE}^2, "
              f"through make_predictor): {json.dumps(cells)}; {CARD[0]}")
        table[rt] = cells
        del model, nets
        torch.cuda.empty_cache()
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    phase("launches", f"zoo path (stage 3 by loss, eager and graph; stage 1 "
          f"with accumulation; with_cp; PROCA; ResNeXt and v1c serving) in "
          f"{time.time() - t_zoo:.1f} s: {json.dumps(counts)}")
    need = len(ZOO_LOSSES) * 2 * steps
    if counts["uvem_mine"] != need:
        fail(f"uvem_mine launched {counts['uvem_mine']} times on the zoo "
             f"path (once per stage-3 step: {need})")
    for name in ("segment_max", "segment_gather", "instance_norm",
                 "instance_norm_backward", "crop_normalize", "stem_pool",
                 "tail_upsample_softmax_mean", "bottleneck_identity"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the zoo path")
    for rt in ("resnext50_32x4d", "resnet50_v1c"):
        f32_step_check("zoo", f"f32 stage-1 step, {rt} (CORAL)", cfg, dev,
                       make_src_step, dict(align_domain=True), backbone=rt)
    phase("zoo", "summary " + json.dumps(table))
    return counts


def copy_adv_start(adv):
    """An independent copy of an ``AdvState``: the segmenter's state
    (``copy_start``), D and its Adam (moments and count copied)."""
    import torch

    from uemda_tpu_torch.train.adversarial import Adam, AdvState

    disc = copy.deepcopy(adv.disc)
    d = adv.d_opt
    opt = Adam(list(disc.named_parameters()), d.lr, d.b1, d.b2, d.eps)
    with torch.no_grad():
        for dst, src in zip(opt.mu + opt.nu + [opt.count],
                            d.mu + d.nu + [d.count]):
            dst.copy_(src)
    return AdvState(copy_start(adv.seg), disc, opt)


def da_run(tag, what, make, state, src_it, tgt_it, dev, logger,
           start=None, eval_fn=None, profile=True):
    """``DA_STEPS`` eager steps (``eager_run``) and, from ``start`` (a copy
    of the start state), the same steps through the graph
    (``graph_rerun``: steps 1-3 held to the eager run's at 1e-4
    relative), each on its own copy of the batch streams ``src_it()`` and
    ``tgt_it()``; then profiles of three eager steps and three replays.
    Returns (eager metrics, eager ms/step, graph ms/step, (device ms,
    idle share) eager, the same through the graph; not measured without
    ``profile``)."""
    loss, ms_e, _ = eager_run(tag, what, make, state, src_it(), tgt_it(),
                              DA_STEPS, logger, eval_fn=eval_fn)
    ms_g = None
    if start is not None:
        ms_g, _ = graph_rerun(tag, f"{what} through the CUDA graph", make,
                              start, src_it(), tgt_it(), DA_STEPS, dev, loss)
    if not profile:
        return loss, ms_e, ms_g, (None, None), (None, None)
    saved = [fn.launches for fn in WRAPPERS]   # the profiled steps are extra
    s_p, t_p = src_it(), tgt_it()
    prof_e = profile_steps(f"{what} (bf16, batch {BATCH})", make(state.model),
                           state, s_p, t_p, dev, ms_e)
    prof_g = (None, None)
    if start is not None:
        prof_g = graph_profile(tag, what, make, start, s_p, t_p, dev, ms_g)
    for fn, n in zip(WRAPPERS, saved):
        fn.launches = n
    return loss, ms_e, ms_g, prof_e, prof_g


def adv_phase(dev, ctx, sctx):
    """``[adv]``: the adversarial trainer (``train_adv``). (a) One f32 G + D
    step on the card against the CPU's plain path: G's losses 1e-4
    relative and D's 1e-3 (it reads the source re-forwarded at the updated
    G, and G's update is held at 2e-2 of its largest entry), G's
    gradients and updates as every f32 check; the target map D reads
    within 1e-4 of its max of the CPU's; the source re-forward held on
    equal inputs (the CPU's updated G, image and dropout masks through
    ``forward_scratch`` on the card) within 1e-4 of its max (at the card's
    own G it is printed: it reads G's update, held at 2e-2); and D's
    update held on equal inputs: the CPU's D, forward, backward and Adam,
    replayed on the card's maps, its first moment and the root of its
    second within 1e-4 of their max, Adam's arithmetic on the card's own
    moments within 1e-5 of the largest parameter, and the parameters
    within 1e-5 of it (one learning-rate step where the second moment's
    root is under 1e-6, a gradient under 1e-5, as the CPU test holds them
    under 100 eps; two where the two gradients differ in sign, Adam's
    first step being the sign). (b) At the flagship, on the
    chain's model:
    ``DA_STEPS`` bf16 G + D steps (lambda_adv 0.001, D's lr 1e-4) through
    ``run_training_loop`` with an evaluation, every launch count set to 0
    just before and read just after (returned), then again from a copy of
    the start state through the graph; (c) the same with ``accum_steps``
    2, eager and through the graph (no evaluation or profile). Host-cropped
    batches, as ``[zoo]``."""
    import torch

    from uemda_tpu_torch.datasets.base import ArrayDataset
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.train.adversarial import create_adv_state, make_adv_step
    from uemda_tpu_torch.train.loop import (
        build_state,
        default_hparams,
        make_eval_hook,
    )

    cfg = ctx["cfg"]
    d_lr = 1e-4

    maps = {}   # each device's D inputs: G's target map, then D's two
    calls = {}  # each device's segmenter calls: (image, masks, map)
    hooks = []

    def wrap(st):
        adv = create_adv_state(st, cfg.class_num, d_lr)
        dev_type = next(adv.disc.parameters()).device.type
        seen = maps.setdefault(dev_type, [])
        adv.disc.register_forward_pre_hook(
            lambda m, args: seen.append(args[0].detach().float().cpu()))
        fwd = calls.setdefault(dev_type, [])

        def record(m, args, kwargs, out):
            masks = kwargs.get("dropout_masks", args[2] if len(args) > 2
                               else None)
            fwd.append((args[0].detach().cpu(),
                        {k: v.cpu() for k, v in masks.items()},
                        out[1].detach().float().cpu()))

        hooks.append(st.model.register_forward_hook(record, with_kwargs=True))
        return adv

    def soft_map(logits, like):
        from uemda_tpu_torch.ops.resize import upsample_logits

        return torch.softmax(upsample_logits(logits, tuple(like.shape[-2:])),
                             dim=1)

    def d_gate(sc, sg, m_c):
        from uemda_tpu_torch.alignment.extra_losses import bce_logits_loss
        from uemda_tpu_torch.train.adversarial import Adam
        from uemda_tpu_torch.train.steps import forward_scratch

        for h in hooks:
            h.remove()
        (t_c, s_c, _), (t_g, s_g, _) = maps["cpu"], maps["cuda"]
        e_t, e_s = (float((g - c).abs().max()) / float(c.abs().max())
                    for g, c in ((t_g, t_c), (s_g, s_c)))
        mean_s = float((s_g - s_c).abs().mean())
        # the source re-forward on equal inputs: the CPU's updated G, its
        # source image and dropout masks, through forward_scratch on the
        # card; and how far the CPU's own map moved in the step
        image, masks, _ = calls["cpu"][2]
        moved = float((s_c - soft_map(calls["cpu"][0][2], s_c)).abs().max())
        twin = copy.deepcopy(sg.model).train()
        twin.load_state_dict(sc.model.state_dict())
        with torch.no_grad():
            _, s2, _ = forward_scratch(
                twin, None, image.to(dev),
                {k: v.to(dev) for k, v in masks.items()})
            e_r = float((soft_map(s2, s_c).cpu() - s_c).abs().max()) / float(
                s_c.abs().max())
        del twin
        # the card's D update replayed on the CPU from the card's inputs:
        # D's gradient is ill-conditioned in its inputs (a fresh D barely
        # tells the maps apart: its two terms nearly cancel)
        ref = create_adv_state(sc.seg, cfg.class_num, d_lr).disc
        p0 = [p.detach().clone() for p in ref.parameters()]
        opt = Adam(list(ref.named_parameters()), d_lr, 0.9, 0.99)
        o_s, o_t = ref(s_g), ref(t_g)
        (0.5 * (bce_logits_loss(o_s, torch.ones_like(o_s))
                + bce_logits_loss(o_t, torch.zeros_like(o_t)))).backward()
        opt.update()
        mu_g = [m.cpu() for m in sg.d_opt.mu]
        nu_g = [n.cpu() for n in sg.d_opt.nu]
        top_mu = max(float(m.abs().max()) for m in opt.mu)
        e_mu = max(float((a - b).abs().max())
                   for a, b in zip(mu_g, opt.mu)) / top_mu
        root = max(float(nu.max()) for nu in opt.nu) ** 0.5
        e_nu = max(float((a.sqrt() - b.sqrt()).abs().max())
                   for a, b in zip(nu_g, opt.nu)) / root
        top = max(float(p.detach().abs().max()) for p in ref.parameters())
        e_d = e_a = e_tiny = 0.0
        flips = tiny = 0
        for a, b, a0, mu_a, nu_a, mu_b, nu_b in zip(
                sg.disc.parameters(), ref.parameters(), p0, mu_g, nu_g,
                opt.mu, opt.nu):
            a = a.detach().cpu()
            # Adam's first step on the card's own moments, in f64
            step = (mu_a.double() / 0.1) / (
                (nu_a.double() / 0.01).sqrt() + 1e-8)
            e_a = max(e_a, float((a.double() - (a0.double() - d_lr * step))
                                 .abs().max()) / top)
            # against the replay: one step where the second moment's root
            # is under 1e-6 (Adam's ratio g / (|g| + eps) turns on the
            # devices' gradient difference there, as in the CPU test), two
            # where the two gradients differ in sign (only where both are
            # within the gradient's gated 1e-4)
            flip = torch.sign(mu_a) != torch.sign(mu_b)
            small = (nu_b.sqrt() < 1e-6) & ~flip
            flips += int(flip.sum())
            tiny += int(small.sum())
            diff = (a - b.detach()).abs()
            limit = torch.where(small, torch.full_like(diff, d_lr),
                                torch.full_like(diff, 1e-5 * top))
            limit = torch.where(flip, torch.full_like(diff, 2 * d_lr), limit)
            if bool((diff > limit).any()):
                fail(f"f32 adversarial step: D's parameters on the card "
                     f"{float(diff.max()):.3g} from the CPU's update on the "
                     f"card's inputs")
            e_d = max(e_d, float(torch.where(flip | small, 0.0, diff).max())
                      / top)
            e_tiny = max(e_tiny, float(torch.where(small, diff, 0.0).max())
                         / d_lr)
        if not (e_t <= 1e-4 and e_r <= 1e-4 and e_mu <= 1e-4 and e_nu <= 1e-4
                and e_a <= 1e-5 and m_c["loss_d"] > 0):
            fail(f"f32 adversarial step: the target map D reads "
                 f"{e_t:.3g} of its max from the CPU's, the source map "
                 f"re-forwarded on the CPU's updated G {e_r:.3g}, D's "
                 f"gradient on the card's maps {e_mu:.3g} of its max from "
                 f"the CPU's, the root of its second moment {e_nu:.3g} "
                 f"(limits 1e-4), Adam on the card's moments {e_a:.3g} of "
                 f"the largest parameter (limit 1e-5), loss_d {m_c['loss_d']}")
        return (f"; the target map {e_t:.3g} of its max from the CPU's; the "
                f"source map at the updated G {e_r:.3g} on the CPU's G and "
                f"inputs, {e_s:.3g} (mean {mean_s:.3g}) at the card's own G "
                f"(the CPU's map moved {moved:.3g} in the step); on the "
                f"card's maps D's first moment {e_mu:.3g} and its second's "
                f"root {e_nu:.3g} of their max from the CPU's, Adam on the "
                f"card's moments {e_a:.3g} and D's parameters {e_d:.3g} of "
                f"the largest from the CPU's, but for {tiny} entries whose "
                f"second moment's root is under 1e-6 ({e_tiny:.3g} of a step "
                f"apart) and {flips} whose two gradients differ in sign "
                f"(within two steps)")

    f32_step_check("adv", "f32 G + D step (ResNet-50 OS16, lambda_adv 0.1)",
                   cfg, dev, lambda m, hp: make_adv_step(m, hp, 0.1), {},
                   extra=d_gate, tol={"loss_d": 1e-3}, wrap=wrap)

    hc = (TILE, TILE)
    hp = default_hparams(cfg)
    make = lambda m: make_adv_step(m, hp, 0.001)  # noqa: E731
    images = ArrayDataset(LoveDA, ctx["tgt"].images)   # label-free target
    logger = logging.getLogger("chip_smoke.adv")
    eval_fn, _ = make_eval_hook(cfg, None, dataset=ctx["val"])
    out = {}
    for accum in (1, 2):
        state = create_adv_state(build_state(
            copy.deepcopy(ctx["model"]), cfg, DA_STEPS, accum_steps=accum),
            cfg.class_num, d_lr)
        start = copy_adv_start(state)
        torch.cuda.synchronize()
        if accum == 1:
            for fn in WRAPPERS:
                fn.launches = 0
        what = "flagship G + D" + (", accum_steps 2" if accum > 1 else "")
        loss, ms_e, ms_g, prof_e, prof_g = da_run(
            "adv", what, make, state, lambda: stream(ctx["src"], 50, hc),
            lambda: stream(images, 51, hc), dev, logger, start,
            eval_fn=eval_fn if accum == 1 else None, profile=accum == 1)
        if accum == 1:
            counts = {fn.__name__: fn.launches for fn in WRAPPERS}
        for st in (state, start):   # D steps every micro-step
            if not (float(st.d_opt.count) == st.step
                    and st.opt.count == st.step // accum):
                fail(f"{what}: {st.step} steps, D's count "
                     f"{float(st.d_opt.count)}, G's {st.opt.count}")
        phase("adv", f"{what}: loss_d {loss[0]['loss_d']:.5g} -> "
              f"{loss[-1]['loss_d']:.5g}, loss_adv {loss[0]['loss_adv']:.5g}"
              f" -> {loss[-1]['loss_adv']:.5g}; ms/step by CUDA events "
              f"(device ms/step, idle share): steps_per_call 1 {ms_e:.3f} "
              f"{prof_e}, steps_per_call {K_GRAPH} through the graph "
              f"{ms_g:.3f} {prof_g}; {CARD[0]}")
        out[accum] = (ms_e, ms_g, prof_e, prof_g)
        del state, start
        torch.cuda.empty_cache()
    for name in ("instance_norm", "instance_norm_backward", "crop_normalize",
                 "tail_upsample_softmax_mean"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the adversarial path")
    phase("launches", f"adversarial path ({DA_STEPS} G + D steps + "
          f"evaluation, then through the graph): {json.dumps(counts)}")
    return counts


def dca_phase(dev, ctx, sctx):
    """``[dca]``: DCA self-training (``train_ssl_dca``). (a) One f32 DCA
    step with ``--bcs 1`` on the card against the CPU's plain path (the
    source class balance 1e-6 relative). (b) At the flagship, on the
    chain's model and the ``[ssl]`` sweep's soft labels: ``DA_STEPS``
    bf16 steps with ``--bcs 1`` and an evaluation, every launch count set
    to 0 just before and read just after (returned), then again from a
    copy of the start state through the graph. Host-cropped batches."""
    import torch

    from uemda_tpu_torch.datasets.base import ArrayDataset
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.train.loop import (
        build_state,
        default_hparams,
        make_eval_hook,
    )
    from uemda_tpu_torch.train.steps import make_dca_step

    cfg = ctx["cfg"]

    def bcs_gate(sc, sg, m_c):
        f_c, f_g = sc.balance_s.freq.cpu(), sg.balance_s.freq.cpu()
        e_f = float(((f_g - f_c).abs() / f_c.abs()).max())
        if not (e_f <= 1e-6 and m_c["loss_icr"] > 0 and m_c["loss_ccr"] > 0):
            fail(f"f32 DCA step: source class balance {e_f:.3g} relative "
                 f"(limit 1e-6); {m_c}")
        return f"; source class-balance frequencies {e_f:.3g}"

    f32_step_check("dca", "f32 DCA step (ResNet-50 OS16, --bcs 1)", cfg, dev,
                   make_dca_step, dict(balance_source=True), prob=True,
                   extra=bcs_gate)
    hc = (TILE, TILE)
    hp = default_hparams(cfg, balance_source=True)
    make = lambda m: make_dca_step(m, hp)  # noqa: E731
    target = ArrayDataset(LoveDA, sctx["target"].images,
                          prob=sctx["target"].prob)   # no superpixel maps
    state = build_state(copy.deepcopy(ctx["model"]), cfg, DA_STEPS)
    start = copy_start(state)
    eval_fn, _ = make_eval_hook(cfg, None, dataset=ctx["val"])
    torch.cuda.synchronize()
    for fn in WRAPPERS:
        fn.launches = 0
    loss, ms_e, ms_g, prof_e, prof_g = da_run(
        "dca", "flagship DCA (--bcs 1)", make, state,
        lambda: stream(ctx["src"], 52, hc),
        lambda: stream(target, 53, hc), dev,
        logging.getLogger("chip_smoke.dca"), start, eval_fn=eval_fn)
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    for name in ("instance_norm", "instance_norm_backward", "crop_normalize"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the DCA path")
    phase("dca", f"flagship DCA: loss_icr {loss[0]['loss_icr']:.5g} -> "
          f"{loss[-1]['loss_icr']:.5g}, loss_ccr {loss[0]['loss_ccr']:.5g} "
          f"-> {loss[-1]['loss_ccr']:.5g}; ms/step by CUDA events (device "
          f"ms/step, idle share): steps_per_call 1 {ms_e:.3f} {prof_e}, "
          f"steps_per_call {K_GRAPH} through the graph {ms_g:.3f} {prof_g}; "
          f"{CARD[0]}")
    phase("launches", f"DCA path ({DA_STEPS} steps + evaluation, then through "
          f"the graph): {json.dumps(counts)}")
    del state, start
    torch.cuda.empty_cache()
    return counts


def abl_phase(dev, ctx, sctx):
    """``[abl]``: the UVEM ablation trainer's loop (``train_ssl_uvem_abl``:
    ``run_regen_chunks`` with ``make_ssl_step``, UVEM, refine 'all') at
    the flagship with ``GENE_EVERY`` cut to 10: a sweep of the 16 target
    tiles, 10 steps, a sweep by the updated model, 10 steps, at
    steps_per_call 3 (each chunk: step 1, then three calls of three
    steps through the graph) on host-cropped batches, every launch count
    set to 0 just before and read just after (returned)."""
    import numpy as np
    import torch

    from uemda_tpu_torch.datasets.base import ArrayDataset
    from uemda_tpu_torch.datasets.meta import LoveDA, NORM_STATS
    from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
    from uemda_tpu_torch.train.loop import (
        build_state,
        default_hparams,
        run_regen_chunks,
    )
    from uemda_tpu_torch.train.steps import make_ssl_step

    cfg = ctx["cfg"]
    tgt = ctx["tgt"]
    st = NORM_STATS["LoveDA"]
    steps, gene_every, k = 20, 10, 3
    hc = (TILE, TILE)
    hp = default_hparams(cfg, refine=True, refine_mode="all")
    model = copy.deepcopy(ctx["model"])
    state = build_state(model, cfg, steps, prototypes=sctx["prototypes"])
    labels, sweeps, events = {}, [], []

    def regen():
        torch.cuda.synchronize()
        t0 = time.time()
        out = generate_pseudo_labels(
            model, tgt, st["mean"], st["std"], tile=(TILE, TILE), tta=True,
            batch_size=min(4, BATCH), cutoff_top=cfg.cutoff_top,
            cutoff_low=cfg.cutoff_low, compute_dtype=torch.bfloat16,
            device=dev)
        torch.cuda.synchronize()
        sweeps.append(time.time() - t0)
        labels["prob"] = np.stack([out[tgt.filename(i)]
                                   for i in range(len(tgt))])

    def target_stream(skip):
        return stream(ArrayDataset(LoveDA, tgt.images, sup=tgt.sup,
                                   prob=labels["prob"]), 61, hc, skip=skip)

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((metrics, ev))

    torch.cuda.synchronize()
    for fn in WRAPPERS:
        fn.launches = 0
    t0 = time.time()
    run_regen_chunks(state, make_ssl_step(model, hp), steps, gene_every, 0,
                     logging.getLogger("chip_smoke.abl"), regen,
                     lambda skip: stream(ctx["src"], 60, hc, skip=skip),
                     target_stream, seed=2333, eval_every=steps,
                     log_every=gene_every, steps_per_call=k, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    loss = [{n: float(v) for n, v in m.items()} for m, _ in events]
    if state.step != steps or len(sweeps) != 2 or not all(
            np.isfinite(list(m.values())).all() for m in loss):
        fail(f"ablation loop: step {state.step}, {len(sweeps)} sweeps, "
             f"losses {loss}")
    if counts["uvem_mine"] < steps:
        fail(f"uvem_mine launched {counts['uvem_mine']} times in {steps} "
             "ablation steps and two sweeps")
    for name in ("tail_upsample_softmax_mean", "segment_max",
                 "segment_gather", "instance_norm", "instance_norm_backward",
                 "crop_normalize"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the ablation path")
    # the second chunk's replays: steps 15-20 (two calls of three)
    ms = events[13][1].elapsed_time(events[19][1]) / 6
    phase("abl", f"UVEM ablation loop (ResNet-50 OS16, 2urban, batch {BATCH} "
          f"per domain, bf16, UVEM, refine 'all', GENE_EVERY {gene_every}, "
          f"steps_per_call {k}): {steps} steps and 2 sweeps in {wall:.2f} s; "
          f"loss {loss[0]['loss']:.5g} -> {loss[-1]['loss']:.5g}; steps 15-20 "
          f"(replays): {ms:.3f} ms/step by CUDA events; sweeps of "
          f"{len(tgt)} tiles of {2 * TILE}^2: "
          f"{', '.join(f'{len(tgt) / t:.3f}' for t in sweeps)} tiles/s "
          f"(whole calls: the copy, warm-up and capture included); "
          f"{CARD[0]}")
    phase("launches", f"ablation path (2 sweeps + {steps} steps): "
          f"{json.dumps(counts)}")
    del state, model
    torch.cuda.empty_cache()
    return counts


DP_STEPS = 5      # [dp]: eager steps of each stage, plain and data-parallel
DP_GRAPH = 21     # [dp]: steps through the K_GRAPH graph (step 1 alone, 2 calls)
RASTER_HW = (1024, 1536)


def _dp_gloo_rank(rank, port, path):
    """One of two ranks sharing card 0 over gloo (``[dp]`` (d)): the
    collectives a data-parallel step takes, on CUDA tensors -- the global
    BatchNorm forward and backward, ``gsum``, ``gmax``, ``gather_rows``,
    the flat gradient all-reduce -- each against the single-process value
    of the global batch. Saves the largest differences to
    ``<path>_<rank>.pt``; an error in any of them ends the process with a
    non-zero code, which fails the phase. The raster's point-to-point
    exchange is not tried: gloo writes a CUDA tensor's device pointer to
    its socket (``writev``: bad address) and can abort the process; on
    the card it runs on NCCL."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from uemda_tpu_torch.parallel import mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 64, 32, 32, generator=g, device=dev) * 2 + 1
    dy = torch.randn(x.shape, generator=g, device=dev)
    w = torch.rand(64, generator=g, device=dev) + 0.5
    b = torch.randn(64, generator=g, device=dev)
    rows = mesh.rows(4)

    def bn():
        xl = x[rows].clone().requires_grad_()
        wl, bl = w.clone().requires_grad_(), b.clone().requires_grad_()
        y, mean, var = mesh.batch_norm(xl, wl, bl, 1e-5)
        (y * dy[rows]).sum().backward()
        mesh.all_reduce_grads([wl.grad, bl.grad])
        xr = x.clone().requires_grad_()
        wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
        yr = F.batch_norm(xr, None, None, wr, br, True, 0.0, 1e-5)
        (yr * dy).sum().backward()
        return {"y": (y - yr[rows]).abs().max(),
                "dx": (xl.grad - xr.grad[rows]).abs().max(),
                "dw": (wl.grad - wr.grad).abs().max(),
                "db": (bl.grad - br.grad).abs().max(),
                "mean": (mean - x.mean((0, 2, 3))).abs().max(),
                "var": (var - x.var((0, 2, 3), unbiased=False)).abs().max()}

    v = torch.arange(6.0, device=dev).reshape(2, 3) + 10 * rank
    base = v - 10 * rank
    res = {k: float(e) for k, e in bn().items()}
    res["gsum"] = float((mesh.gsum(v) - (2 * base + 10)).abs().max())
    res["gmax"] = float((mesh.gmax(v) - (base + 10)).abs().max())
    res["gather"] = float((mesh.gather_rows(v) - torch.cat(
        [base, base + 10])).abs().max())

    dist.destroy_process_group()
    torch.save(res, f"{path}_{rank}.pt")


def _dp_collective_bodies(x, dy, w, b, v):
    """The bodies ``parallel/mesh.py``'s helpers run at world size > 1 (at
    1 they return early): the global BatchNorm forward and backward, the
    autograd all-reduce sum, the flat gradient all-reduce and the
    all-gather, on the current group."""
    from uemda_tpu_torch.parallel import mesh

    xi = x.detach().clone().requires_grad_()
    wi = w.detach().clone().requires_grad_()
    bi = b.detach().clone().requires_grad_()
    y, mean, var = mesh._GlobalBatchNorm.apply(xi, wi, bi, 1e-5)
    (mesh._AllReduceSum.apply(y) * dy).sum().backward()
    mesh._all_reduce_flat([wi.grad, bi.grad])
    return {"y": y.detach(), "mean": mean, "var": var, "dx": xi.grad,
            "dw": wi.grad, "db": bi.grad, "gather": mesh._all_gather(v)}


def _dp_collectives_captured(dev):
    """``[dp]`` (c), in the NCCL group of one: the world-size > 1 bodies
    (``_dp_collective_bodies``) eagerly against one library BatchNorm,
    then captured in one CUDA graph and replayed on new inputs against
    the eager bodies on those inputs. What ``--steps-per-call`` under
    several processes captures with each step. Returns (largest error
    against the library, largest replay-eager difference, whether every
    replayed tensor was bit-equal)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(1)

    def inputs():
        return (torch.randn(8, 64, 32, 32, generator=g, device=dev) * 2 + 1,
                torch.randn(8, 64, 32, 32, generator=g, device=dev),
                torch.rand(64, generator=g, device=dev) + 0.5,
                torch.randn(64, generator=g, device=dev),
                torch.randn(4, 6, generator=g, device=dev))

    static = inputs()
    eager = _dp_collective_bodies(*static)
    x, dy, w, b, v = (t.clone().requires_grad_(i in (0, 2, 3))
                      for i, t in enumerate(static))
    y = F.batch_norm(x, None, None, w, b, True, 0.0, 1e-5)
    (y * dy).sum().backward()
    lib = {"y": y.detach(), "mean": x.detach().mean((0, 2, 3)),
           "var": x.detach().var((0, 2, 3), unbiased=False),
           "dx": x.grad, "dw": w.grad, "db": b.grad, "gather": v}
    vs_lib = {k: float((eager[k] - lib[k]).abs().max()) for k in eager}
    limits = {"y": 1e-4, "dx": 1e-4, "dw": 1e-3, "db": 1e-3, "mean": 1e-5,
              "var": 1e-4, "gather": 0.0}
    for k, e in vs_lib.items():
        if not e <= limits[k]:
            fail(f"[dp] collective bodies on NCCL: {k} max abs err {e} "
                 f"from the library BatchNorm (limit {limits[k]})")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            _dp_collective_bodies(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = _dp_collective_bodies(*static)
    fresh = inputs()
    for t, f in zip(static, fresh):
        t.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    want = _dp_collective_bodies(*fresh)
    diff = {k: float((out[k] - want[k]).abs().max()) for k in want}
    if not max(diff.values()) <= 1e-5:
        fail(f"[dp] collective bodies captured on NCCL: the replay parts "
             f"from the eager run on the same inputs: {json.dumps(diff)}")
    return (max(vs_lib.values()), max(diff.values()),
            all(torch.equal(out[k], want[k]) for k in want))


def dp_phase(dev, ctx, sctx):
    """``[dp]``: data parallelism (``uemda_tpu_torch/parallel/``) on the
    card. (a) At world size ``torch.cuda.device_count()`` on NCCL (this
    process: one card, a group of one), the flagship stage 1, 2 and 3
    steps on the chain's model: ``DP_STEPS`` plain eager steps without a
    group, the same steps from the same start in the group (held to the
    plain ones at 1e-4 relative, bit-equality reported) and ``DP_GRAPH``
    steps through the ``K_GRAPH`` graph (steps 1-3 held at 1e-4); ms/step
    of each. (b) The raster predictor (``infer/raster.py``) on a synthetic
    1024 x 1536 raster with 8-view TTA, standard and fast path (K2, K3 and
    K4 on stages (1, 2)), against ``make_predictor`` over the padded
    raster. Every launch count is set to 0 after the plain steps, just
    before the group's, and read after (b) (returned). (c) In the group,
    the collectives a step takes at world size > 1, captured in a CUDA
    graph (``_dp_collectives_captured``). (d) Two ranks sharing the card
    over gloo (``_dp_gloo_rank``): the step's collectives on CUDA tensors
    against one process."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from uemda_tpu_torch.datasets.augment import normalize
    from uemda_tpu_torch.infer.fastpath import build_fastpath
    from uemda_tpu_torch.infer.raster import RasterPlan, make_raster_predictor
    from uemda_tpu_torch.infer.slide import make_predictor
    from uemda_tpu_torch.parallel import mesh
    from uemda_tpu_torch.parallel.multihost import init_multihost
    from uemda_tpu_torch.train.loop import build_state, default_hparams
    from uemda_tpu_torch.train.steps import (
        make_align_step,
        make_src_step,
        make_ssl_step,
    )

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    cfg = ctx["cfg"]
    world = torch.cuda.device_count()
    if world != 1:
        phase("dp", f"{world} cards: the group of this script's one process "
              "is world size 1 on card 0 (the script needs one card)")
    logger = logging.getLogger("chip_smoke.dp")
    tgt1 = dataclasses.replace(ctx["tgt"], sup=None)
    stages = (
        ("stage 1", lambda m, hp: make_src_step(m, hp),
         default_hparams(cfg, align_domain=True), None, tgt1, 60),
        ("stage 2", lambda m, hp: make_align_step(m, hp),
         default_hparams(cfg, align_domain=True, refine=True,
                         refine_mode="all"), sctx["prototypes"], ctx["tgt"],
         62),
        ("stage 3", lambda m, hp: make_ssl_step(m, hp),
         default_hparams(cfg, refine=True, refine_mode="all"),
         sctx["prototypes"], sctx["target"], 64))
    plain = {}
    for name, mk, hp, proto, target, seed in stages:
        state = build_state(copy.deepcopy(ctx["model"]), cfg, 30,
                            prototypes=proto)
        start = copy_start(state)
        plain[name] = (start, copy_start(state)) + eager_run(
            "dp", f"{name} plain (no process group)",
            lambda m, mk=mk, hp=hp: mk(m, hp), state,
            stream(ctx["src"], seed), stream(target, seed + 1), DP_STEPS,
            logger)[:2]
        del state
    torch.cuda.synchronize()
    for fn in WRAPPERS:   # the grouped steps, the graph and the raster only
        fn.launches = 0
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        if not (mesh.world_size() == 1 and mesh.backend() == "nccl"):
            fail(f"[dp] group: world size {mesh.world_size()}, backend "
                 f"{mesh.backend()}")
        for name, mk, hp, proto, target, seed in stages:
            start, start_g, loss_p, ms_p = plain.pop(name)
            make = lambda m, mk=mk, hp=hp: mk(m, hp)  # noqa: E731
            loss_d, ms_d, _ = eager_run(
                "dp", f"{name} in an NCCL group of {mesh.world_size()}",
                make, start, stream(ctx["src"], seed),
                stream(target, seed + 1), DP_STEPS, logger)
            rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                      for a, b in zip(loss_d, loss_p) for k in b)
            if not rel <= 1e-4:
                fail(f"[dp] {name}: data-parallel losses part from the plain "
                     f"steps' by {rel:.3g} relative (limit 1e-4)")
            ms_g, _ = graph_rerun(
                "dp", f"{name} in the NCCL group through the CUDA graph",
                make, start_g, stream(ctx["src"], seed),
                stream(target, seed + 1), DP_GRAPH, dev, loss_p)
            phase("dp", f"{name}: NCCL group of {mesh.world_size()} vs plain "
                  f"steps, {DP_STEPS} eager steps: largest relative loss "
                  f"difference {rel:.3g}, bit-equal "
                  f"{all(a == b for a, b in zip(loss_d, loss_p))}; ms/step "
                  f"by CUDA events: plain {ms_p:.3f}, data-parallel "
                  f"{ms_d:.3f}, data-parallel through the graph (K "
                  f"{K_GRAPH}) {ms_g:.3f}; {CARD[0]}")
            del start, start_g
            torch.cuda.empty_cache()

        # (b) the raster predictor against the padded slide predictor
        h, w = RASTER_HW
        rng = np.random.default_rng(70)
        raw = torch.from_numpy(rng.integers(0, 256, (1, h, w, 3),
                                            dtype=np.uint8)).to(dev)
        st = cfg.val
        x = normalize(raw.permute(0, 3, 1, 2), st.mean, st.std)[0]
        plan = RasterPlan(RASTER_HW, (TILE, TILE), 0.5, mesh.world_size())
        n_win = len(plan.origins(True))
        padded = torch.zeros((1, 3, plan.hp, plan.wp), device=dev)
        padded[0, :, :h, :w] = x
        model = copy.deepcopy(ctx["model"]).eval()
        nets = (("standard", copy.deepcopy(model).to(torch.bfloat16)),
                ("fast path, fused_stages (1, 2)",
                 build_fastpath(model, fused_stages=(1, 2))))
        for what, net in nets:
            # one forward of every window, as the single predictor's
            pred = make_raster_predictor(net, RASTER_HW, (TILE, TILE),
                                         tta=True, window_chunk=n_win,
                                         compute_dtype=torch.bfloat16,
                                         return_probs=True)
            with make_predictor(net, (TILE, TILE), (plan.hp, plan.wp),
                                tta=True,
                                compute_dtype=torch.bfloat16) as single:
                ref = single(padded)[0, :, :h, :w].clone()
                ms_s = cuda_ms(lambda: single(padded), iters=3, warmup=1)
            got = pred(x)
            ms_r = cuda_ms(lambda: pred(x), iters=3, warmup=1)
            err = float((got - ref).abs().max())
            agree = float((got.argmax(0) == ref.argmax(0)).float().mean())
            if not torch.equal(got, ref):
                fail(f"[dp] raster {what}: max abs diff {err:.3g} from the "
                     f"padded slide predictor, argmax agreement {agree}")
            phase("dp", f"raster {h}x{w}, 8-view TTA, {what}: {n_win} "
                  f"windows of {TILE}^2 on a {plan.hp}x{plan.wp} padded "
                  f"grid at world size {mesh.world_size()}; vs make_predictor "
                  f"on the padded raster: bit-equal {torch.equal(got, ref)}, "
                  f"max abs diff {err:.3g}, argmax agreement {agree:.6f}; "
                  f"raster {ms_r:.3f} ms, slide predictor (graph) "
                  f"{ms_s:.3f} ms by CUDA events; {CARD[0]}")
            del pred, net
        del nets, model
        torch.cuda.empty_cache()
        counts = {fn.__name__: fn.launches for fn in WRAPPERS}

        # (c) the world-size > 1 collectives captured on NCCL
        vs_lib, vs_eager, bit = _dp_collectives_captured(dev)
        phase("dp", f"the collectives of a step at world size > 1 (global "
              f"BatchNorm forward and backward, all-reduce sum, flat "
              f"gradient all-reduce, all-gather) in the NCCL group of "
              f"{mesh.world_size()}: eager against one library BatchNorm "
              f"max abs err {vs_lib:.3g}; captured in a CUDA graph and "
              f"replayed on new inputs against the eager bodies: max abs "
              f"diff {vs_eager:.3g}, bit-equal {bit}")
    finally:
        dist.destroy_process_group()
    for name in ("instance_norm", "instance_norm_backward", "crop_normalize",
                 "segment_max", "segment_gather", "uvem_mine", "stem_pool",
                 "tail_upsample_softmax_mean", "bottleneck_identity"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the [dp] paths")
    phase("launches", f"[dp] paths (3 x {DP_STEPS} eager steps in the group "
          f"and {DP_GRAPH} through the graph each, two raster "
          f"predictions; not the plain steps): {json.dumps(counts)}")

    # (d) two ranks sharing the card over gloo
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gloo")
        mp.spawn(_dp_gloo_rank, args=(free_port(), path), nprocs=2,
                 join=True)
        res = [torch.load(f"{path}_{r}.pt") for r in range(2)]
    worst = {k: max(r[k] for r in res) for k in res[0]}
    limits = {"y": 1e-4, "dx": 1e-4, "dw": 1e-3, "db": 1e-3, "mean": 1e-5,
              "var": 1e-4}
    for k, e in worst.items():
        if not e <= limits.get(k, 0.0):
            fail(f"[dp] 2 gloo ranks on the card: {k} max abs err {e}")
    phase("dp", f"2 gloo ranks sharing the card ({time.time() - t0:.1f} s "
          f"with the processes' start), CUDA tensors against one process: "
          f"max abs err {json.dumps(worst)}")
    return counts


PREP_TILES = 4  # [prep]: LSC tiles of 1024^2


def prep_phase(dev, ctx, astate):
    """``[prep]``: the real-data path on the model and prototypes stage 2
    left (copies, in a fresh state with a 21-step schedule). (a) LSC maps and their shrink for
    ``PREP_TILES`` synthetic 1024^2 target tiles through the port's binding
    of ``native/superpixels.cpp``, on a thread pool. Then, every launch
    count set to 0 just before and read just after (returned): (b) the
    ``with_aux`` eval forward (f32) at batch 2 against the default
    forward; (c) ``refine_quality``'s ``refine_all`` for modes none, p, l,
    s, all on those maps, and the 's' view as ``vis_corrected_pseudo_labels``
    calls it (``max_segments`` 2048); (d) 21 stage-2 steps (refine 'all')
    on the LSC maps through the CUDA graph (K=10). Outside that window:
    K5 and K7 on the 's' view's inputs held exactly to their plain
    versions, and their ms on the LSC maps and on the grid maps of the
    same shape."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from uemda_tpu_torch.alignment.prototypes import label_refine
    from uemda_tpu_torch.datasets.augment import normalize
    from uemda_tpu_torch.ops.segment import (
        segment_gather,
        segment_gather_plain,
        segment_max,
        segment_max_plain,
    )
    from uemda_tpu_torch.ops.pseudo import pseudo_selection
    from uemda_tpu_torch.superpixels import native
    from uemda_tpu_torch.tools.refine_quality import make_refine_all
    from uemda_tpu_torch.train.loop import (
        build_state,
        default_hparams,
        max_segments_for,
    )
    from uemda_tpu_torch.train.steps import make_align_step

    cfg = ctx["cfg"]
    nc = cfg.class_num
    tgt = ctx["tgt"]
    hw = tgt.images.shape[1]
    s_max = max_segments_for(cfg)
    boundary = (hw // 16) * (hw // 16)

    # (a) the superpixel maps, one host thread a tile (the C code runs
    # without the GIL)
    t0 = time.time()
    native.build()
    t_build = time.time() - t0

    def one(img):
        t = time.time()
        n, labels, shrunk = native.superpixels_with_shrink(img)
        return n, labels, shrunk, time.time() - t

    t0 = time.time()
    with ThreadPoolExecutor(PREP_TILES) as ex:
        maps = list(ex.map(one, tgt.images[:PREP_TILES]))
    t_lsc = time.time() - t0
    cpu = platform.machine()
    try:
        lscpu = subprocess.run(["lscpu"], capture_output=True, text=True,
                               timeout=30).stdout
        names = re.findall(r"^(?:Vendor ID|Model name):\s*(.+)$", lscpu, re.M)
        cpu = ", ".join([cpu] + names)
    except OSError:
        pass
    phase("prep", f"LSC (region 16, ratio 0.075, 100 iterations) + shrink "
          f"(window 3) of {PREP_TILES} synthetic {hw}^2 target tiles on "
          f"{PREP_TILES} host threads in {t_lsc:.2f} s (build {t_build:.2f} "
          f"s); host {cpu}, {os.cpu_count()} cores")
    for i, (n, labels, shrunk, sec) in enumerate(maps):
        if not (labels.min() == 0 and labels.max() == n - 1
                and shrunk.max() == max(boundary, n - 1)):
            fail(f"LSC tile {i}: {n} ids, labels {labels.min()}-"
                 f"{labels.max()}, shrunk max {shrunk.max()}")
        phase("prep", f"tile {i}: {sec:.3f} s host; {n} ids, largest id "
              f"{labels.max()}, boundary id {boundary}; pixels at or above "
              f"max_segments_for(cfg) {s_max}: {int((shrunk >= s_max).sum())}"
              f"; at or above 2048: {int((shrunk >= 2048).sum())} of "
              f"{shrunk.size} ({int(((shrunk >= 2048) & (shrunk != boundary)).sum())} "
              "not the boundary id)")
    sup_np = np.stack([m[2] for m in maps]).astype(np.int32)
    lsc = dataclasses.replace(tgt, images=tgt.images[:PREP_TILES],
                              labels=tgt.labels[:PREP_TILES], sup=sup_np)

    model = copy.deepcopy(astate.model)
    start = build_state(model, cfg, DA_STEPS,
                        prototypes=astate.aligner.prototypes)
    aligner = start.aligner
    st = cfg.target
    torch.cuda.synchronize()
    for fn in WRAPPERS:
        fn.launches = 0
    t0 = time.time()
    # (b) the with_aux forward at the flagship width, f32, batch 2
    images = torch.from_numpy(lsc.images[:2]).to(dev).permute(0, 3, 1, 2)
    sup = torch.from_numpy(sup_np[:2]).to(dev)
    model.eval()
    with torch.no_grad():
        x = normalize(images, st.mean, st.std)
        probs, x1, x2, feat = model(x, with_aux=True)
        plain = model(x)
    torch.cuda.synchronize()
    d_aux = max_err(probs, plain)
    shapes = [tuple(t.shape) for t in (probs, x1, x2, feat)]
    if not (torch.equal(probs, plain) and shapes == [
            (2, nc, hw, hw), (2, nc, hw // 16, hw // 16),
            (2, nc, hw // 16, hw // 16), (2, 2048, hw // 16, hw // 16)]):
        fail(f"with_aux forward: probs differ from the default forward by "
             f"{d_aux}, shapes {shapes}")
    phase("prep", f"with_aux forward (ResNet-50 OS16, twin PPM heads, "
          f"instance norm, {nc} classes, f32, batch 2, {hw}^2): probs against "
          f"the default forward max abs diff {d_aux:.3g}; x1, x2, feat "
          f"{shapes[1:]}")
    # (c) refine_quality's refine_all on the LSC maps, the soft labels as
    # stored (fp16) from the model's own posterior
    modes = ["none", "p", "l", "s", "all"]
    refine_all = make_refine_all(model, aligner, cfg, modes, 2.0, s_max)
    soft = probs.half().float()
    out = refine_all(images, soft, sup)
    torch.cuda.synchronize()
    cells = []
    for m in modes:
        hard, conf = out[m]
        if not (hard.shape == (2, hw, hw) and torch.isfinite(conf).all()):
            fail(f"refine_all mode {m}: labels {tuple(hard.shape)}, "
                 f"confidence finite {bool(torch.isfinite(conf).all())}")
        cells.append(f"{m} mined {float((hard != cfg.ignore_label).float().mean()):.4f}"
                     f" conf {float(conf.mean()):.4f}")
    phase("prep", f"refine_all (max_segments {s_max}) on the LSC maps: "
          + "; ".join(cells))
    # the 's' view as vis_corrected_pseudo_labels calls label_refine (its
    # default max_segments 2048, under the boundary id and LSC's ids)
    with torch.no_grad():
        ref_s = label_refine(aligner, soft, feat, [x1, x2], sup=sup, mode="s")
        nan_px = int(torch.isnan(ref_s).any(1).sum())
        mined_s = float((pseudo_selection(ref_s, cfg.cutoff_top,
                                          cfg.cutoff_low, cfg.ignore_label)
                         != cfg.ignore_label).float().mean())
    phase("prep", f"label_refine mode 's' at its default max_segments 2048 "
          f"(vis_corrected_pseudo_labels' call): {nan_px} of "
          f"{2 * hw * hw} pixels NaN, mined share {mined_s:.4f} (at "
          f"{s_max}: {float((out['s'][0] != cfg.ignore_label).float().mean()):.4f})")
    t_fwd = time.time() - t0
    # (d) 21 stage-2 steps on the LSC maps through the captured step
    hp = default_hparams(cfg, align_domain=True, refine=True,
                         refine_mode="all")
    ms_g, _ = graph_rerun("prep", "stage 2 on LSC maps through the CUDA "
                          "graph", lambda m: make_align_step(m, hp), start,
                          stream(ctx["src"], 10), stream(lsc, 11), DA_STEPS,
                          dev, [], gate=False)
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    for name in ("instance_norm", "tail_upsample_softmax_mean",
                 "segment_max", "segment_gather"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the [prep] path")
    phase("prep", f"stage 2 (refine 'all', max_segments {s_max}), steps "
          f"{K_GRAPH + 2}-{2 * K_GRAPH + 1} through the graph: "
          f"{ms_g:.3f} ms/step on LSC maps, {ctx['align_graph_ms']:.3f} on "
          f"grid maps ([align], this run); forward and refinement "
          f"{t_fwd:.2f} s; {CARD[0]}")
    phase("launches", f"[prep] path (with_aux + default forward, refine_all, "
          f"the 's' view at 2048, {DA_STEPS} graph steps): "
          f"{json.dumps(counts)}")

    # K5 and K7 on the 's' view's inputs at these shapes, exactly against
    # their plain versions, and their time on the LSC maps and on the
    # [align] grid maps of the same shape
    saved = [fn.launches for fn in WRAPPERS]
    flat = soft.permute(0, 2, 3, 1).reshape(2, hw * hw, nc).contiguous()
    timing = {}
    for kind, ids_np in (("LSC", sup_np[:2]), ("grid", tgt.sup[:2])):
        ids = torch.from_numpy(np.ascontiguousarray(ids_np)).to(dev) \
            .reshape(2, -1)
        got = segment_max(flat, ids, s_max)
        route, plan = segment_max.route, segment_max.plan
        ref = segment_max_plain(flat, ids, s_max)
        g7 = segment_gather(got, ids)
        r7 = segment_gather_plain(ref, ids)
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(g7, r7)):
            fail(f"K5/K7 on {kind} maps: segment_max differs by "
                 f"{max_err(got, ref)}, segment_gather by {max_err(g7, r7)}")
        t5 = kernel_ms(lambda: segment_max(flat, ids, s_max))
        t7 = kernel_ms(lambda: segment_gather(got, ids))
        timing[kind] = (t5, t7)
        phase("prep", f"K5 segment_max and K7 segment_gather on {kind} maps "
              f"(2, {hw * hw}, {nc}) f32, S {s_max}: exact against their "
              f"plain versions; K5 route {route} (tile {plan.tile}, rows "
              f"{plan.rows}); K5 {t5:.4f} ms, K7 {t7:.4f} ms by CUDA events")
    for fn, n in zip(WRAPPERS, saved):
        fn.launches = n
    del start, model, probs, plain, soft, flat
    torch.cuda.empty_cache()
    return counts, timing


TOOLS_TILES = 4   # [tools]: 1024^2 tiles a domain for sample_features
AB_STEPS, AB_WARMUP, AB_PAIRS = 10, 3, 2   # [tools]: the host-crop A/B


def _numpy_majority(label, s, nc, min_ratio=0.75):
    """``downscale_label`` recounted in numpy: each s x s cell's most
    frequent class (ignore -1 voting as class ``nc``, ties to the lower
    class), ignore where the winner is ``nc`` or holds less than
    ``min_ratio`` of the cell."""
    import numpy as np

    h, w = label.shape
    lab = np.where(label == -1, nc, label).reshape(h // s, s, w // s, s)
    counts = np.stack([(lab == c).sum(axis=(1, 3)) for c in range(nc + 1)],
                      -1)
    win = counts.argmax(-1)
    ok = (win != nc) & (counts.max(-1) >= min_ratio * s * s)
    return np.where(ok, win, -1).astype(np.int32)


def _stream_overlaps(evs):
    """(union ns, summed ns, [(overlap ns, earlier name, later name)]) of
    one stream's (start, end, name) events sorted by start: the union
    counted with numpy, apart from ``profile_summary``'s, and each event
    that starts before the stream's earlier events have ended (on Hopper
    a kernel may start before its predecessor ends: programmatic
    dependent launch)."""
    import numpy as np

    a = np.array([(s, e) for s, e, _ in evs], np.int64)
    prev = np.maximum.accumulate(a[:, 1])
    before = np.concatenate([a[:1, 0], prev[:-1]])
    union = int(np.clip(a[:, 1] - np.maximum(a[:, 0], before), 0, None).sum())
    lap = [(int(min(a[i, 1], before[i]) - a[i, 0]), evs[i - 1][2], evs[i][2])
           for i in range(1, len(evs)) if a[i, 0] < before[i]]
    return union, int((a[:, 1] - a[:, 0]).sum()), lap


def bnact_phase():
    """``[bnact]`` the eval BatchNorm epilogue (``ops/bnact.py``) at the
    sweep's shapes (batch 4 x 9 windows x 8 views = 288 tiles of 512^2, bf16
    as the serving copy of the model holds it): layer1's block end with the
    identity and with the downsample branch's BatchNorm, layer4's block end,
    and the PPM's pooled maps at scales 1 and 6. Each is held to its plain
    version (one bf16 unit in the last place) and timed behind a spinner:
    the kernel, its plain version, the library chain the standard forward
    ran before it (``BatchNorm.forward``'s f32 cast, cuDNN's f32 BatchNorm
    and cast back, the add, the ReLU) and the library's one-call design
    (``F.batch_norm`` on the bf16 tensor with f32 statistics, then
    ``add_`` and ``relu_`` in place), against its bytes at the memory
    bandwidth. Returns the records; ``main`` adds each path's launches."""
    import torch
    import torch.nn.functional as F

    from uemda_tpu_torch.models.resnet import BatchNorm
    from uemda_tpu_torch.models.resnet import bn_norm
    from uemda_tpu_torch.ops.bnact import bnact, bnact_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    cases = [((288, 256, 128, 128), "identity"),
             ((288, 256, 128, 128), "downsample"),
             ((288, 2048, 32, 32), "identity"),
             ((288, 512, 1, 1), "none"),
             ((288, 512, 6, 6), "none")]
    out = []
    for shape, res in cases:
        c = shape[1]

        def draw(scale=1.0):
            return (torch.randn(shape, device=dev, generator=g) * scale).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)

        bns = []
        for _ in range(2):
            bn = BatchNorm(c).to(dev)
            with torch.no_grad():
                bn.running_mean.normal_(generator=g)
                bn.running_var.uniform_(0.1, 2.0, generator=g)
                bn.weight.normal_(generator=g)
                bn.bias.normal_(generator=g)
            bns.append(bn.eval().to(torch.bfloat16).requires_grad_(False))
        x = draw(3.0)
        r = None if res == "none" else draw()
        rbn = bns[1] if res == "downsample" else None
        args = (x, bn_norm(bns[0]), True, r,
                None if rbn is None else bn_norm(rbn))
        got = bnact(*args).float()
        want = bnact_plain(*args).float()
        # in bf16 units in the last place of the larger result; 1e-4 of
        # slack where a sum near 0 cancels (f32 terms of up to ~100)
        ulps = float(((got - want).abs() - 1e-4).clamp_min(0).div(
            2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 1e-30).max())
        del got, want
        if ulps > 1.0:
            fail(f"bnact {shape} {res}: {ulps:.3f} bf16 ulps from the plain "
                 "version")

        def library():
            y = bns[0](x)
            if r is not None:
                y = y + (r if rbn is None else rbn(r))
            return F.relu(y)

        def one_call(t, m):
            return F.batch_norm(t, m.running_mean.float(),
                                m.running_var.float(), m.weight.float(),
                                m.bias.float(), False, 0.0, m.eps)

        def library_mixed():
            y = one_call(x, bns[0])
            if r is not None:
                y.add_(r if rbn is None else one_call(r, rbn))
            return y.relu_()

        with torch.no_grad():
            ms = kernel_ms(lambda: bnact(*args))
            plain_ms = kernel_ms(lambda: bnact_plain(*args))
            lib_ms = kernel_ms(library)
            mixed_ms = kernel_ms(library_mixed)
        n = x.numel()
        nbytes = n * 2 * (2 if r is None else 3) + 4 * c * 2 * (
            2 if rbn is not None else 1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out.append({"name": "bnact", "shape": list(shape), "residual": res,
                    "ms": ms, "bound_ms": bound, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "library_one_call_ms": mixed_ms,
                    "max_ulps": ulps, "bytes": nbytes})
        phase("bnact", f"{tuple(shape)} bf16, residual {res}: kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({nbytes} B; "
              f"{100 * bound / ms:.1f}% of the bandwidth), plain "
              f"{plain_ms:.4f} ms, library chain {lib_ms:.4f} ms, library "
              f"one call (bf16 F.batch_norm + add_ + relu_) {mixed_ms:.4f} "
              f"ms, {ulps:.3f} ulps from the plain version")
        del x, r, args
        torch.cuda.empty_cache()
    return out


def tools_phase(dev, ctx):
    """``[tools]``: the analysis and gate tools on the chain's model
    (ResNet-50 OS16, twin PPM heads, instance norm, 2urban), every launch
    count set to 0 just before and read just after (returned). (a)
    ``class_rates`` of the in-memory source and target splits against a
    numpy recount; (b) ``sample_features`` of ``TOOLS_TILES`` 1024^2 tiles
    a domain (labels against a numpy recount of the same draws, finite
    features, the BatchNorm buffers unchanged, ms an image); (c)
    ``hostcrop_ab`` at the loveda_synth geometry in memory (1024^2 tiles,
    512^2 crops, batch 8); (d) ``profile_summary`` on a chrome trace of
    three stage-1 steps (each stream's busy time against the union of its
    events counted apart, the events that overlap on a stream, the
    device's busy share beside ``profile_steps``' idle share); (e)
    ``real_data_gate`` on the model's ``.pth`` (pins, the strict load,
    ``--kind imagenet --out``, the eval stage against
    ``evaluate_dataset``); (f) ``slide_predict`` against an eager
    predictor."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from uemda_tpu_torch.datasets.augment import normalize
    from uemda_tpu_torch.infer.evaluate import evaluate_dataset
    from uemda_tpu_torch.infer.slide import make_predictor, slide_predict
    from uemda_tpu_torch.tools import hostcrop_ab, profile_summary
    from uemda_tpu_torch.tools import real_data_gate as gate
    from uemda_tpu_torch.tools.class_distribution import class_rates
    from uemda_tpu_torch.tools.tsne_dataset import (
        sample_features,
        train_features,
    )
    from uemda_tpu_torch.train.loop import build_state, default_hparams
    from uemda_tpu_torch.train.steps import make_src_step

    cfg, model = ctx["cfg"], ctx["model"]
    nc = cfg.class_num
    src = ctx["src"]
    tgt = dataclasses.replace(ctx["tgt"], sup=None)
    torch.cuda.synchronize()
    for fn in WRAPPERS:
        fn.launches = 0
    t_phase = time.time()

    # (a) class rates of the in-memory splits
    for name, ds in (("source", src), ("target", tgt)):
        got = class_rates(ds)
        lbl = ds.labels[(ds.labels >= 0) & (ds.labels < nc)]
        want = np.bincount(lbl, minlength=nc).astype(np.float64)
        want /= want.sum()
        if not np.array_equal(got, want):
            fail(f"class_rates of the {name} split {got} against the numpy "
                 f"recount {want}")
        phase("tools", f"class_rates {name} ({len(ds)} x "
              f"{ds.images.shape[1]}^2, {nc} classes) = numpy recount: "
              f"{np.round(got, 5).tolist()}")

    # (b) sample_features: train-mode features of TOOLS_TILES tiles a domain
    model.eval()
    before = {k: v.clone() for k, v in model.named_buffers()}
    for name, ds, st, seed in (("source", src, cfg.source, 0),
                               ("target", tgt, cfg.target, 1)):
        sub = dataclasses.replace(ds, images=ds.images[:TOOLS_TILES],
                                  labels=ds.labels[:TOOLS_TILES])
        feats, labels = sample_features(model, sub, st.mean, st.std,
                                        max_images=TOOLS_TILES, seed=seed)
        rng = np.random.default_rng(seed)
        want = []
        for lab in sub.labels:
            l_ = _numpy_majority(lab, 16, nc).reshape(-1)
            keep = np.flatnonzero(l_ >= 0)
            want.append(l_[rng.choice(keep, size=min(64, len(keep)),
                                      replace=False)])
        want = np.concatenate(want)
        if not (np.array_equal(labels, want) and np.isfinite(feats).all()
                and feats.shape == (len(want), 2048)):
            fail(f"sample_features {name}: labels equal to the numpy recount "
                 f"{np.array_equal(labels, want)}, finite "
                 f"{bool(np.isfinite(feats).all())}, shape {feats.shape}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TOOLS_TILES):
            train_features(model, sub.images[i:i + 1], st.mean, st.std)
        torch.cuda.synchronize()
        ms_img = (time.perf_counter() - t0) * 1e3 / TOOLS_TILES
        phase("tools", f"sample_features {name}: {TOOLS_TILES} tiles of "
              f"{sub.images.shape[1]}^2, {len(labels)} samples x 2048 f32, "
              f"finite; labels = numpy recount of the same draws; "
              f"{ms_img:.3f} ms an image (train-mode forward, host to host)")
    changed = [k for k, v in model.named_buffers()
               if not torch.equal(v, before[k])]
    if changed or model.training:
        fail(f"sample_features moved the model's buffers {changed[:3]} or "
             f"left it in train mode ({model.training})")
    phase("tools", "sample_features left the model's BatchNorm buffers "
          "unchanged and the model in eval mode")
    del before

    # (c) the host-crop A/B at the loveda_synth geometry, in memory
    ab_cfg = dataclasses.replace(cfg, name="loveda_synth (in memory)")

    def make_iters(host_crop):
        return (stream(src, 50, host_crop), stream(tgt, 51, host_crop))

    t0 = time.time()
    record, losses = hostcrop_ab.run_ab(model, ab_cfg, make_iters, AB_STEPS,
                                        AB_WARMUP, AB_PAIRS)
    if not all(np.isfinite(ls).all() for v in losses.values() for ls in v):
        fail(f"hostcrop_ab: losses {losses}")
    phase("tools", f"hostcrop_ab ({AB_PAIRS} pairs, {AB_WARMUP} warm-up + "
          f"{AB_STEPS} timed stage-1 steps an arm, bf16, batch {BATCH}, "
          f"{src.images.shape[1]}^2 tiles -> {cfg.crop[0]}^2, the loss read "
          f"back every step) in {time.time() - t0:.1f} s; {CARD[0]}:")
    print(json.dumps(record), flush=True)

    # (d) profile_summary on a trace of three stage-1 steps
    hp = default_hparams(cfg, align_domain=True, compute_dtype="bfloat16")
    m_ = copy.deepcopy(model)
    state = build_state(m_, cfg, 1000)
    src_it, tgt_it = stream(src, 52), stream(tgt, 53)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        dev_ms, idle = profile_steps(
            "stage-1 step for profile_summary", make_src_step(m_, hp), state,
            src_it, tgt_it, dev, record["mean_off_ms"], trace=path)
        events = profile_summary.load_events(path)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = profile_summary.main([path, "--top", "5"])[path]
    src_it.close()
    tgt_it.close()
    del m_, state
    devices = summary["devices"]
    if not devices:
        fail("profile_summary found no device events in a CUDA trace")
    for pid, s_ in devices.items():
        for tid, busy in sorted(s_["line_busy_us"].items(),
                                key=lambda kv: -kv[1]):
            evs = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                         for e in events
                         if e.get("cat") in profile_summary.DEVICE_CATS
                         and e["pid"] == pid and e["tid"] == tid)
            union, summed, lap = _stream_overlaps(evs)
            if abs(busy - union / 1e3) > 1e-6 * union / 1e3:
                fail(f"profile_summary device {pid} stream {tid}: busy "
                     f"{busy} us against {union / 1e3} us, the union of "
                     "its events counted apart")
            largest = "".join(
                f"; {o / 1e3:.3f} us {a[:40]} -> {b[:40]}"
                for o, a, b in sorted(lap, reverse=True)[:3])
            phase("tools", f"profile_summary device {pid} stream {tid}: "
                  f"{len(evs)} events, busy {busy / 1e3:.3f} ms = their "
                  f"union counted apart (1e-6); summed durations "
                  f"{summed / 1e6:.3f} ms: {len(lap)} events start before "
                  f"the stream's earlier ones end, overlapping "
                  f"{sum(o for o, _, _ in lap) / 1e3:.3f} us in all"
                  f"{largest}")
        share = s_["busy_us"] / s_["span_us"]
        phase("tools", f"profile_summary on a chrome trace of 3 stage-1 steps "
              f"(device {pid}): span {s_['span_us'] / 1e3:.3f} ms, "
              f"{len(s_['line_busy_us'])} streams; device busy share "
              f"{share:.4f} (idle {1 - share:.4f}); profile_steps' idle "
              f"share {idle:.4f} of the A/B's 'off' step "
              f"{record['mean_off_ms']} ms (device {dev_ms:.3f} ms a step)")
    for line in buf.getvalue().splitlines()[1:]:
        phase("tools", "  " + line.strip())

    # (e) the gate on the model's .pth
    model.eval()
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "flagship.pth")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
        digest = gate.sha256_file(ckpt)
        base = ["--torch-ckpt", ckpt, "--kind", "deeplabv2",
                "--resnet-type", "resnet50", "--num-classes", str(nc),
                "--skip-parity"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ok = gate.main(base + ["--expect-sha256", digest[:16]])
            try:
                gate.main(base + ["--expect-sha256", "0" * 16])
                wrong = None
            except SystemExit as e:
                wrong = e.code
        lines = [json.loads(x) for x in out.getvalue().splitlines()]
        if not (ok["ok"] and ok["sha_ok"] and wrong == 1
                and lines[-1]["failed"] == "checksum"):
            fail(f"real_data_gate pins: {lines}, exit {wrong}")
        args = gate.build_parser().parse_args(base)
        loaded = gate.port_and_load(args, gate.load_ref_sd(ckpt), dev)
        x = normalize(torch.from_numpy(np.ascontiguousarray(
            tgt.images[:2, :TILE, :TILE])).to(dev).permute(0, 3, 1, 2),
            cfg.target.mean, cfg.target.std)
        with torch.no_grad():
            same = torch.equal(loaded(x), model(x))
        if not same:
            fail("real_data_gate: the strictly loaded model's eval forward "
                 "differs from the source model's")
        trunk = os.path.join(d, "resnet50-trunk.pth")
        torch.save({k: v.cpu() for k, v in
                    model.encoder.resnet.state_dict().items()}, trunk)
        ported = os.path.join(d, "ported.pth")
        with contextlib.redirect_stdout(io.StringIO()):
            rec = gate.main(["--torch-ckpt", trunk, "--num-classes", str(nc),
                             "--allow-unverified", "--skip-parity", "--out",
                             ported])
        saved = torch.load(ported, map_location="cpu", weights_only=True)
        own = model.encoder.resnet.state_dict()
        bad = [k for k, v in own.items()
               if not torch.equal(saved["encoder.resnet." + k], v.cpu())]
        if not rec["ok"] or bad:
            fail(f"real_data_gate --kind imagenet --out: {rec}, trunk keys "
                 f"that differ {bad[:3]}")
    split = cfg.val
    miou_gate = gate.eval_miou(loaded, ctx["val"], split, cfg.crop, dev)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    direct = copy.deepcopy(model).to(dtype)
    _, miou_direct = evaluate_dataset(
        direct, ctx["val"], split.mean, split.std, tile=tuple(cfg.crop),
        batch_size=split.batch_size, compute_dtype=dtype, device=dev)
    if miou_gate != miou_direct:
        fail(f"real_data_gate eval stage mIoU {miou_gate} against "
             f"evaluate_dataset's {miou_direct}")
    phase("tools", f"real_data_gate on the model's .pth: a correct "
          f"--expect-sha256 pin passes, a wrong one exits 1 'checksum'; the "
          f"strict load's eval forward on 2 x {TILE}^2 tiles bit-equal to the "
          f"source model's; --kind imagenet --out holds the file's trunk; the "
          f"eval stage's mIoU {miou_gate:.6f} = evaluate_dataset's "
          f"({str(dtype).split('.')[1]}, {len(ctx['val'])} x "
          f"{ctx['val'].images.shape[1]}^2)")
    del loaded

    # (f) slide_predict against an eager predictor
    xs = normalize(torch.from_numpy(tgt.images[:1]).to(dev)
                   .permute(0, 3, 1, 2), cfg.target.mean, cfg.target.std)
    got = slide_predict(direct, xs, tuple(cfg.crop), tta=True,
                        compute_dtype=dtype)
    with make_predictor(direct, tuple(cfg.crop), tuple(xs.shape[2:]),
                        tta=True, compute_dtype=dtype, capture=False) as eager:
        want = eager(xs)
    if not torch.equal(got, want):
        fail(f"slide_predict differs from the eager predictor by "
             f"{max_err(got, want)}")
    phase("tools", f"slide_predict ({str(dtype).split('.')[1]}, 8-view TTA, "
          f"{tuple(xs.shape)} with "
          f"{cfg.crop[0]}^2 tiles) bit-equal to make_predictor(capture="
          f"False)")
    del direct, got, want
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    for name in ("instance_norm", "instance_norm_backward",
                 "tail_upsample_softmax_mean", "crop_normalize"):
        if counts[name] <= 0:
            fail(f"{name} was not launched on the [tools] path")
    phase("tools", f"phase {time.time() - t_phase:.1f} s; {CARD[0]}")
    phase("launches", f"[tools] path (class rates, sample_features, the "
          f"host-crop A/B, the profiled steps, the gate, slide_predict): "
          f"{json.dumps(counts)}")
    torch.cuda.empty_cache()
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on the GPU")
    if not os.path.isdir(os.path.join(ROOT, "uemda_tpu_torch")):
        fail("uemda_tpu_torch/ not found beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from uemda_tpu_torch import kernels
    from uemda_tpu_torch.datasets.meta import NORM_STATS, IsprsDA
    from uemda_tpu_torch.kernels import sass
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.infer.evaluate import evaluate_dataset
    from uemda_tpu_torch.infer.fastpath import build_fastpath, make_serving_fn
    from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
    from uemda_tpu_torch.ops.crop import crop_normalize, crop_normalize_plain
    from uemda_tpu_torch.ops.insnorm import (
        instance_norm,
        instance_norm_backward,
        instance_norm_backward_plain,
        instance_norm_backward_plan,
        instance_norm_forward,
        instance_norm_forward_plain,
        instance_norm_forward_plan,
        instance_norm_plain,
    )
    from uemda_tpu_torch.ops.mine import (
        uvem_mine,
        uvem_mine_plain,
        uvem_mine_plan,
    )
    from uemda_tpu_torch.ops.pseudo import class_thresholds
    from uemda_tpu_torch.ops.segment import (
        segment_gather,
        segment_gather_plain,
        segment_max,
        segment_max_plain,
        segment_reduce_plan,
        segment_sum,
        segment_sum_bound,
        segment_sum_plain,
        superpixel_expand,
    )
    from uemda_tpu_torch.ops.resblock import (
        bottleneck_identity,
        bottleneck_identity_plain,
    )
    from uemda_tpu_torch.ops.stem import stem_pool, stem_pool_plain
    from uemda_tpu_torch.ops.tail import (
        tail_plan,
        tail_upsample_softmax_mean,
        tail_upsample_softmax_mean_plain,
    )

    from uemda_tpu_torch.ops.bnact import bnact

    WRAPPERS[:] = [instance_norm, instance_norm_backward, crop_normalize,
                   stem_pool, tail_upsample_softmax_mean, segment_max,
                   segment_sum, segment_gather, uvem_mine, bottleneck_identity,
                   bnact]
    t_start = time.time()
    sections = []  # (name, start) of each part of the run, for the summary

    def mark(name):
        sections.append((name, time.time()))
    dev = torch.device("cuda")
    CL = torch.channels_last

    # 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    CARD[0] = card
    print(card, flush=True)
    phase("card", f"{card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, devices {torch.cuda.device_count()}")

    mark("build")
    # 2. build ----------------------------------------------------------
    t0 = time.time()
    logs = kernels.build()
    phase("build", f"{len(kernels.SOURCES)} kernel sources built in "
          f"{time.time() - t0:.1f} s into {kernels.BUILD_DIR}")
    for name, log in logs.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log))
        phase("build", f"{name}: {len(regs)} instantiations, at most "
              f"{max(regs, default=0)} registers a thread, {spill} bytes of "
              "spill stores")
        if name in REDESIGNED:  # the redesigned kernels, each
            for fn, body in re.findall(  # instantiation: ptxas -v
                    r"Compiling entry function '([^']+)'(.*?)(?=Compiling "
                    r"entry|$)", log, re.S):
                if not re.search(REDESIGNED[name], fn):
                    continue
                r_ = re.search(r"Used (\d+) registers", body)
                sp = re.search(r"(\d+) bytes spill stores", body)
                sm = re.search(r"(\d+) bytes smem", body)
                phase("build", f"{name} {fn}: {r_.group(1) if r_ else '?'} "
                      f"registers, {sm.group(1) if sm else 0} bytes static "
                      f"shared memory (the rest dynamic, from the launch "
                      f"plan), {sp.group(1) if sp else '?'} bytes spill "
                      "stores")
            for msg in sorted(set(re.findall(r"Potential Performance Loss: "
                                             r"([^\n]*?) in the function",
                                             log))):
                phase("build", f"{name}: ptxas: {msg}")
    # SASS of the kernels redesigned for the memory system (K1 forward and
    # backward, K5/K6, K7, K3, K8): instructions, loop bodies, subroutine
    # calls and 64-bit integer divisions (the I2F.U64.RP that opens one)
    for name in ("insnorm", "segment", "tail", "mine"):
        try:
            found = sass.stats(str(kernels._lib_path(name)), "")
        except (OSError, subprocess.CalledProcessError) as e:
            phase("build", f"{name}: cuobjdump not available ({e})")
            continue
        for fn, st in found.items():
            if not re.search(REDESIGNED[name], fn):
                continue
            phase("build", f"{name} {fn} SASS: {st['insns']} instructions; "
                  f"loops {[(n, f'{a:#x}-{b:#x}') for a, b, n in st['loops']]}"
                  f"; calls {st['calls']}; 64-bit divisions {st['div64']}")
            if name in ("tail", "mine") and st["div64"]:
                fail(f"{name} {fn}: {st['div64']} 64-bit integer divisions")

    mark("kernel checks")
    # 3. kernels against their plain versions, at the slice's shapes -----
    torch.backends.cudnn.allow_tf32 = False   # plain f32 side: full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    x_in = randn(BATCH, 2048, TILE // 16, TILE // 16)
    x_st = randn(BATCH, 12, TILE // 2, TILE // 2)
    w_st = randn(4, 4, 12, 64, scale=0.2)
    b_st = randn(64)
    x_tl = randn(BATCH, 12, TILE // 16, TILE // 16, scale=3.0)
    tol = {  # (atol, rtol) per dtype; reasons in PERF.md
        "instance_norm": {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)},
        "stem_pool": {"float32": (1e-5, 1e-5), "bfloat16": (1.6e-2, 1.6e-2)},
        "tail": {"float32": (1e-5, 0.0), "bfloat16": (8e-3, 0.0)},
    }
    inputs = {}
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        xi = x_in.to(dev, dt).contiguous(memory_format=CL)
        xs = x_st.to(dev, dt).contiguous(memory_format=CL)
        ws = w_st.to(dev, dt).contiguous()
        bs = b_st.to(dev)
        xt = x_tl.to(dev, dt).contiguous(memory_format=CL)
        inputs[dn] = (xi, xs, ws, bs, xt)
        cases = {
            "instance_norm": (instance_norm(xi), instance_norm_plain(xi)),
            "stem_pool": (stem_pool(xs, ws, bs), stem_pool_plain(xs, ws, bs)),
            "tail": (tail_upsample_softmax_mean(xt, (TILE, TILE), 2, 6),
                     tail_upsample_softmax_mean_plain(xt, (TILE, TILE), 2, 6)),
        }
        torch.cuda.synchronize()
        for name, (got, ref) in cases.items():
            atol, rtol = tol[name][dn]
            errs[(name, dn)] = check_close(f"{name} {dn}", got, ref, atol, rtol)
            phase("kernel", f"{name} {dn} {tuple(got.shape)}: max abs err "
                  f"{errs[(name, dn)]:.3g} (atol {atol}, rtol {rtol})")
            if name == "stem_pool":
                sp = stem_pool.plan
                phase("kernel", f"stem_pool {dn} design: {sp.design} "
                      f"({'tensor cores, mma.sync' if sp.design == 'mma' else 'CUDA cores'}), "
                      f"pooled tile {sp.tile}, grid {sp.grid}, {sp.smem} B of "
                      "shared memory")
            if name == "tail":
                phase("kernel", f"tail {dn} design: "
                      + tail_design(tail_upsample_softmax_mean.plan))

    # K3 at the serving batch of 32 and on output rows that start off 16
    # bytes (45 x 37 pixels of 7 classes from 7 x 7, one head pair), both
    # dtypes, at the gates above, each with its plan. Inputs from a
    # generator of their own, so the later checks draw what they drew before
    g3 = torch.Generator(device="cpu").manual_seed(3)
    tail_cases = {"serving batch 32": (32, 2, 6, TILE // 16, TILE, TILE),
                  "misaligned rows": (2, 2, 7, 7, 45, 37)}
    for case, (b3, h3, nc3, hi3, ho3, wo3) in tail_cases.items():
        x3 = torch.randn(b3, h3 * nc3, hi3, hi3, generator=g3) * 3.0
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[-1]
            xt3 = x3.to(dev, dt).contiguous(memory_format=CL)
            got = tail_upsample_softmax_mean(xt3, (ho3, wo3), h3, nc3)
            ref = tail_upsample_softmax_mean_plain(xt3, (ho3, wo3), h3, nc3)
            torch.cuda.synchronize()
            atol, rtol = tol["tail"][dn]
            e = check_close(f"tail {dn} {case}", got, ref, atol, rtol)
            if case == "serving batch 32":
                errs[("tail_b32", dn)] = e
                inputs[f"tail32 {dn}"] = xt3
            phase("kernel", f"tail {dn} {case} {tuple(xt3.shape)} -> "
                  f"{tuple(got.shape)}: max abs err {e:.3g} (atol {atol})")
            phase("kernel", f"tail {dn} {case} design: "
                  + tail_design(tail_upsample_softmax_mean.plan))

    # K1 forward against its plain version on each of its plan's routes, y
    # at the tolerances above and the f32 mean and rstd (which the backward
    # reads) at 1e-5: the flagship's (8, 2048, 32, 32) and the serving
    # batch of 32 in both dtypes, an odd (3, 96, 20, 28), a cluster of 8 over
    # 45 x 47 pixels (the last CTA 5 short), 64 x 64, and 128 x 128 (f32 on
    # the global route: 8 CTAs' parts overflow shared memory). Inputs from a
    # generator of their own, so the later checks draw what they drew before
    g8 = torch.Generator(device="cpu").manual_seed(8)
    fwd_cases = {"flagship": (BATCH, 2048, TILE // 16, TILE // 16),
                 "serving batch 32": (32, 2048, TILE // 16, TILE // 16),
                 "odd": (3, 96, 20, 28), "ragged": (2, 96, 45, 47),
                 "64x64": (2, 64, 64, 64), "global": (1, 32, 128, 128)}
    fwd_routes = set()
    for case, shape in fwd_cases.items():
        xf0 = torch.randn(*shape, generator=g8) + 3.0
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[-1]
            xf = xf0.to(dev, dt).contiguous(memory_format=CL)
            yk, mk, rk = instance_norm_forward(xf)
            yp, mp, rp = instance_norm_forward_plain(xf)
            torch.cuda.synchronize()
            atol, rtol = tol["instance_norm"][dn]
            e = check_close(f"instance_norm {dn} {case}", yk, yp, atol, rtol)
            em = check_close(f"instance_norm mean {dn} {case}", mk, mp,
                             1e-5, 1e-5)
            er = check_close(f"instance_norm rstd {dn} {case}", rk, rp,
                             1e-5, 1e-5)
            fp = instance_norm_forward.plan
            fwd_routes.add(fp.route)
            phase("kernel", f"instance_norm {dn} {shape}: max abs err y "
                  f"{e:.3g} (atol {atol}, rtol {rtol}), mean {em:.3g}, rstd "
                  f"{er:.3g} (1e-5)")
            phase("kernel", f"instance_norm {dn} {shape} design: "
                  + in_design(fp, shape[2] * shape[3]))
            if case == "flagship":
                # the kernel's statistics feed the backward to the dx of
                # the plain statistics
                dyf = torch.randn(*shape, generator=g8).to(dev, dt) \
                    .contiguous(memory_format=CL)
                t = 1e-5 if dt == torch.float32 else 1e-2
                e = check_close(
                    f"instance_norm_backward {dn} on the forward's statistics",
                    instance_norm_backward(xf, dyf, mk, rk),
                    instance_norm_backward_plain(xf, dyf, mp, rp), t, t)
                phase("kernel", f"instance_norm_backward {dn} {shape} on the "
                      f"forward kernel's mean and rstd: max abs err {e:.3g} "
                      f"against the plain statistics' dx (atol {t}, rtol {t})")
    if fwd_routes != {"smem", "global"}:
        fail(f"instance_norm: routes {fwd_routes} checked, not both")

    # K1 backward against its plain version on the same (x, dy) and the
    # plain f32 statistics, each on its plan's route: the flagship's (8,
    # 2048, 32, 32) in both dtypes (f32 too in shared memory), an odd (3,
    # 96, 20, 28), bf16 at 64x64, a cluster of 8 over 45 x 47 pixels (the
    # last CTA 5 short) and the global route at 128 x 128
    bwd_cases = {"flagship": (BATCH, 2048, TILE // 16, TILE // 16),
                 "odd": (3, 96, 20, 28), "64x64": (2, 64, 64, 64),
                 "ragged": (2, 96, 45, 47), "global": (1, 32, 128, 128)}
    bwd_tol = {"float32": 1e-5, "bfloat16": 1e-2}  # test_pallas_insnorm.py
    bwd_routes = set()
    for case, shape in bwd_cases.items():
        xb0 = randn(*shape) + 3.0
        dyb0 = randn(*shape)
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[-1]
            if case == "64x64" and dt == torch.float32:
                continue
            xb = xb0.to(dev, dt).contiguous(memory_format=CL)
            dyb = dyb0.to(dev, dt).contiguous(memory_format=CL)
            _, mb, rb = instance_norm_forward_plain(xb)
            got = instance_norm_backward(xb, dyb, mb, rb)
            ref = instance_norm_backward_plain(xb, dyb, mb, rb)
            torch.cuda.synchronize()
            t = bwd_tol[dn]
            e = check_close(f"instance_norm_backward {dn} {case}", got, ref, t, t)
            if case == "flagship":
                errs[("instance_norm_backward", dn)] = e
                inputs[f"bwd {dn}"] = (xb, dyb, mb, rb)
            bp = instance_norm_backward.plan
            bwd_routes.add(bp.route)
            phase("kernel", f"instance_norm_backward {dn} {shape}: max abs err "
                  f"{e:.3g} (atol {t}, rtol {t})")
            phase("kernel", f"instance_norm_backward {dn} {shape} design: "
                  + in_design(bp, shape[2] * shape[3]))
    if bwd_routes != {"smem", "global"}:
        fail(f"instance_norm_backward: routes {bwd_routes} checked, not both")

    # K9 against its plain version: uint8 and f32 images, origins 0, odd and
    # maximal, at the training shape (8 crops of 512^2 from 1024^2 tiles)
    # and an odd one. Exact (tolerance 0): one subtract and one multiply by
    # the same f32 reciprocal of std on both sides.
    st_l = NORM_STATS["LoveDA"]
    crop_cases = {
        "train": ((BATCH, 2 * TILE, 2 * TILE), (TILE, TILE),
                  [(0, 0), (1, 3), (TILE, TILE), (17, 511), (256, 0),
                   (TILE - 1, TILE - 7), (3, 16), (TILE, 1)]),
        "odd": ((3, 301, 257), (97, 131), [(0, 0), (101, 63), (204, 126)]),
    }
    raw = {}
    for case, ((b, h, w), chw, offs) in crop_cases.items():
        img = torch.randint(0, 256, (b, h, w, 3), generator=g,
                            dtype=torch.uint8)
        off = torch.tensor(offs, dtype=torch.int32)
        for dt in (torch.uint8, torch.float32):
            dn = str(dt).split(".")[-1]
            xc = img.to(dev, dt)
            # the origins as the train step hands them over: int32 on the
            # card (checked on the host before their upload)
            off_d = off.to(dev)
            got = crop_normalize(xc, off_d, chw, st_l["mean"], st_l["std"])
            ref = crop_normalize_plain(xc, off, chw, st_l["mean"], st_l["std"])
            torch.cuda.synchronize()
            e = check_close(f"crop_normalize {dn} {case}", got, ref, 0.0, 0.0)
            if case == "train":
                errs[("crop_normalize", dn)] = e
                raw[dn] = (xc, off_d)
            phase("kernel", f"crop_normalize {dn} {tuple(xc.shape)} -> "
                  f"{tuple(got.shape)}, origins on the card: max abs err "
                  f"{e:.3g} (exact)")
    inputs["crop"] = raw["uint8"]
    # K9 with the stage-3 clamp (the ISPRS target Normalize), exactly, at the
    # training shape, on statistics that push part of every tile past 1.0
    st_v = NORM_STATS["Vaihingen"]
    xc, off = raw["uint8"]
    got = crop_normalize(xc, off, (TILE, TILE), st_v["mean"], st_v["std"],
                         clamp=True)
    ref = crop_normalize_plain(xc, off.cpu(), (TILE, TILE), st_v["mean"],
                               st_v["std"], clamp=True)
    torch.cuda.synchronize()
    e = check_close("crop_normalize clamp", got, ref, 0.0, 0.0)
    clamped = float((got == 1.0).float().mean())
    if not (float(got.max()) == 1.0 and clamped > 0):
        fail(f"crop_normalize clamp: max {float(got.max())}, share at 1.0 "
             f"{clamped}")
    phase("kernel", f"crop_normalize uint8 clamp {tuple(xc.shape)} -> "
          f"{tuple(got.shape)}: max abs err {e:.3g} (exact), share capped at "
          f"1.0 {clamped:.4f}")

    # K8 against its plain version: the flagship stage-3 shape (8, 7,
    # 512^2) in the channels_last memory the refined soft label arrives in
    # and as NCHW planes, an odd (2, 6, 37, 53), the degenerate (m, t)
    # pairs and a NaN planted in one class. Softmax inputs at logit scales
    # drawn per pixel put the entropies in all three branches and the
    # selection at one class and none; several classes pass only below the
    # default cutoffs (two probabilities cannot both exceed 0.6), so one
    # flagship case lowers them to (0.4, 0.3). Labels exact; u rtol 1e-6,
    # w rtol 1e-5, atol 1e-7 (tests/test_pallas_mine_crop.py:26-28)
    def mine_input(shape):
        b, c, h, w = shape
        scale = torch.tensor([0.3, 2.0, 8.0])[
            torch.randint(0, 3, (b, 1, h, w), generator=g)]
        return torch.softmax(randn(b, c, h, w) * scale, 1).to(dev)

    p_flag = mine_input((BATCH, 7, TILE, TILE))
    p_odd = mine_input((2, 6, 37, 53))
    p_nan = p_odd.clone()
    p_nan[1, 3, 5, 6] = float("nan")
    p_cl = p_flag.contiguous(memory_format=CL)
    mine_cases = [  # (case, probabilities, (m, t), (cutoff_top, cutoff_low))
        ("flagship channels_last", p_cl, (0.2, 0.7), (0.8, 0.6)),
        ("flagship NCHW", p_flag, (0.2, 0.7), (0.8, 0.6)),
        ("flagship low cutoffs", p_cl, (0.2, 0.7), (0.4, 0.3)),
        ("odd", p_odd, (0.2, 0.7), (0.8, 0.6)),
        ("odd m=0", p_odd, (0.0, 0.5), (0.8, 0.6)),
        ("odd m>=t", p_odd, (0.6, 0.5), (0.8, 0.6)),
        ("odd NaN", p_nan, (0.2, 0.7), (0.8, 0.6)),
    ]
    seen = dict.fromkeys(("u<=m", "m<u<t", "u>=t", "one class", "none",
                          "several"), 0.0)
    for case, pm, (m_, t_), (top, low) in mine_cases:
        got = uvem_mine(pm, top, low, m_, t_, 4.0)
        ref = uvem_mine_plain(pm, top, low, m_, t_, 4.0)
        torch.cuda.synchronize()
        if not torch.equal(got[0], ref[0]):
            fail(f"uvem_mine {case}: labels differ at "
                 f"{int((got[0] != ref[0]).sum())} pixels")
        if not torch.equal(torch.isnan(got[2]), torch.isnan(ref[2])):
            fail(f"uvem_mine {case}: NaN entropies differ")
        e_u = check_close(f"uvem_mine {case} u", torch.nan_to_num(got[2]),
                          torch.nan_to_num(ref[2]), 1e-7, 1e-6)
        e_w = check_close(f"uvem_mine {case} w", got[1], ref[1], 1e-7, 1e-5)
        u, lab = ref[2], ref[0]
        p32 = pm.float()
        n_over = (p32 > class_thresholds(p32, top, low)).sum(1)
        shares = {
            "u<=m": float((u <= m_).float().mean()),
            "m<u<t": float(((u > m_) & (u < t_)).float().mean()),
            "u>=t": float((u >= t_).float().mean()),
            "one class": float((n_over == 1).float().mean()),
            "none": float((n_over == 0).float().mean()),
            "several": float((n_over > 1).float().mean()),
            "bit-equal u": float((got[2] == ref[2]).float().mean()),
            "bit-equal w": float((got[1] == ref[1]).float().mean()),
        }
        for k in seen:
            seen[k] = max(seen[k], shares[k])
        if case == "flagship channels_last":
            errs[("uvem_mine", "float32")] = max(e_u, e_w)
            inputs["mine"] = pm
        if case == "odd NaN" and not (bool(torch.isnan(got[2][1, 5, 6]))
                                      and not bool((lab[1] == 3).any())):
            fail("uvem_mine NaN: the pixel's u is not NaN, or its class "
                 "was selected")
        phase("kernel", f"uvem_mine {case} {tuple(pm.shape)} m {m_} t {t_} "
              f"cutoffs ({top}, {low}): labels equal, max abs err u "
              f"{e_u:.3g} (rtol 1e-6), w {e_w:.3g} (rtol 1e-5); shares "
              + json.dumps({k: round(v, 5) for k, v in shares.items()}))
        phase("kernel", f"uvem_mine {case} design: "
              + mine_design(uvem_mine.plan))
    if not all(v > 0 for v in seen.values()):
        fail(f"uvem_mine checks miss a branch or a selection case: {seen}")

    # K5, K6, K7 against their plain versions at the 2urban stage-2 shape:
    # 8 crops of 512^2 from 1024^2 grid-superpixel maps (16-pixel cells,
    # ids 0-4095, the boundary ring 4096), S = 4128, 7 classes; then the
    # same with one id out of range (>= S). Max, gather and one-hot counts
    # are exact; a sum of random f32 values is held to the error bound of
    # f32 summation in any order (count * 2^-24 * sum |x| per segment) of
    # the exact f64 sums: the atomics' order varies, and the boundary
    # segment sums ~60K values
    from uemda_tpu_torch.datasets.synthetic import grid_superpixels

    n_seg, nc7 = 4128, 7
    grid = torch.from_numpy(grid_superpixels(2 * TILE))
    seg_ids = torch.stack([grid[y:y + TILE, x:x + TILE] for y, x in
                           ((0, 0), (3, 17), (TILE, TILE), (100, 511),
                            (256, 0), (511, 9), (40, 300), (TILE, 1))])
    seg_ids = seg_ids.reshape(BATCH, -1).to(dev, torch.int32).contiguous()
    seg_val = torch.softmax(randn(BATCH, TILE * TILE, nc7, scale=3.0), -1) \
        .to(dev).contiguous()
    seg_oh = F.one_hot(torch.randint(0, nc7, (BATCH, TILE * TILE),
                                     generator=g), nc7).float().to(dev)
    bad_ids = seg_ids.clone()
    bad_ids[0, 5] = n_seg + 3
    for case, ids in (("2urban", seg_ids), ("id out of range", bad_ids)):
        table = segment_max(seg_val, ids, n_seg)
        ref5 = segment_max_plain(seg_val, ids, n_seg)
        torch.cuda.synchronize()
        if not torch.equal(table, ref5):  # -inf in empty segments on both
            fail(f"segment_max {case}: differs from its plain version")
        e5 = max_err(table[torch.isfinite(ref5)], ref5[torch.isfinite(ref5)])
        cnt = segment_sum(seg_oh, ids, n_seg)
        e6 = check_close(f"segment_sum one-hot {case}", cnt,
                         segment_sum_plain(seg_oh, ids, n_seg), 0.0, 0.0)
        exact, bound = segment_sum_bound(seg_val, ids, n_seg)
        d6 = (segment_sum(seg_val, ids, n_seg).double() - exact).abs()
        e6r = float((d6 / bound.clamp(min=1e-300)).max())
        if not bool((d6 <= bound).all()):
            fail(f"segment_sum {case}: max abs err {float(d6.max()):.3g}, "
                 f"{e6r:.3g} of the f32 summation bound")
        occ = torch.where(torch.isinf(table), torch.zeros_like(table), table)
        got = segment_gather(occ, ids)
        ref = segment_gather_plain(occ, ids)
        torch.cuda.synchronize()
        nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
        if not (torch.equal(nan_g, nan_r) and torch.equal(got[~nan_g],
                                                          ref[~nan_r])):
            fail(f"segment_gather {case}: differs from its plain version")
        if case != "2urban" and not bool(nan_g[0, 5].all()):
            fail("segment_gather: an id >= S did not gather NaN")
        if case == "2urban":
            errs[("segment_max", "float32")] = e5
            errs[("segment_sum", "float32")] = e6
            errs[("segment_gather", "float32")] = max_err(got, ref)
            inputs["segment"] = (seg_val, seg_ids, seg_oh, occ)
        phase("kernel", f"segment_max / segment_sum / segment_gather {case} "
              f"({BATCH}, {TILE * TILE}, {nc7}), S {n_seg}, route "
              f"{segment_max.route}: max err {e5:.3g} (exact), one-hot counts "
              f"{e6:.3g} (exact), random sums at {e6r:.3g} of the f32 bound, "
              f"gather exact, "
              f"{int(nan_g.any(-1).sum())} NaN pixels")
        phase("kernel", f"segment_max / segment_sum {case} design: "
              + reduce_design(segment_max.plan))
        phase("kernel", f"segment_gather {case} design: "
              + gather_design(segment_gather.plan))
    # K5 and K6 on each route of their plan, equal to their plain versions
    # (K6: one-hot counts exact, random sums within the f32 summation
    # bound): ISPRS's 6 classes, int64 ids, random ids that no window holds
    # (the "window" plan sends every tile to the output's atomics) and the
    # same on a pinned "full" table, S x C over shared memory (10000 x 7;
    # coherent ids still fit a window), and the pinned "global" route
    def reduce_case(case, val, ids, s_, plan=None):
        got = segment_max(val, ids, s_, plan=plan)
        ref = segment_max_plain(val, ids, s_)
        oh = F.one_hot(torch.randint(0, val.shape[2], val.shape[:2],
                                     generator=g8), val.shape[2]).float().to(dev)
        cnt = segment_sum(oh, ids, s_, plan=plan)
        ex, bd = segment_sum_bound(val, ids, s_)
        d = (segment_sum(val, ids, s_, plan=plan).double() - ex).abs()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"segment_max {case}: differs from its plain version")
        if not torch.equal(cnt, segment_sum_plain(oh, ids, s_)):
            fail(f"segment_sum {case}: one-hot counts differ")
        if not bool((d <= bd).all()):
            fail(f"segment_sum {case}: over the f32 summation bound")
        p_ = segment_max.plan
        if segment_sum.plan != p_:
            fail(f"segment_sum {case}: plan {segment_sum.plan} is not K5's")
        phase("kernel", f"segment_max / segment_sum {case} "
              f"{tuple(val.shape)}, {ids.dtype}, S {s_}: max exact, counts "
              f"exact, sums at {float((d / bd.clamp(min=1e-300)).max()):.3g} "
              f"of the f32 bound; design: {reduce_design(p_)}")
        return p_.route

    n_tile_px = TILE * TILE
    val6 = torch.softmax(torch.randn(BATCH, n_tile_px, 6, generator=g8) * 3, -1) \
        .to(dev).contiguous()
    rnd_ids = torch.randint(0, n_seg, (BATCH, n_tile_px), generator=g8,
                            dtype=torch.int32).to(dev)
    reduce_routes = {
        reduce_case("ISPRS C 6", val6, seg_ids, n_seg),
        reduce_case("int64 ids", seg_val, seg_ids.long(), n_seg),
        reduce_case("random ids", seg_val, rnd_ids, n_seg),
        reduce_case("random ids, full table", seg_val, rnd_ids, n_seg,
                    segment_reduce_plan(BATCH, n_tile_px, nc7, n_seg,
                                        route="full")),
        reduce_case("S x C over shared memory", seg_val, seg_ids * 2, 10000),
        reduce_case("global", seg_val, bad_ids, n_seg,
                    segment_reduce_plan(BATCH, n_tile_px, nc7, n_seg,
                                        route="global")),
    }
    if reduce_routes != {"window", "full", "global"}:
        fail(f"segment_max: routes {reduce_routes} checked, not all three")
    # K7 on its direct route (rows wider than 2048 floats) and on the widest
    # staged row, int64 ids, ids outside [0, S): exact, NaN there
    for c_w in (2500, 2048):
        tab_w = randn(2, 9, c_w).to(dev)
        ids_w = torch.randint(0, 9, (2, 37), generator=g)
        ids_w[1, [0, 5, 36]] = torch.tensor([-1, 9, 1 << 20])
        ids_w = ids_w.to(dev)
        got = segment_gather(tab_w, ids_w)
        ref = segment_gather_plain(tab_w, ids_w)
        torch.cuda.synchronize()
        if not (torch.equal(torch.nan_to_num(got, nan=7.0),
                            torch.nan_to_num(ref, nan=7.0))
                and bool(torch.isnan(got[1, [0, 5, 36]]).all())):
            fail(f"segment_gather C {c_w}: differs from its plain version")
        if segment_gather.plan.route != ("direct" if c_w > 2048 else "staged"):
            fail(f"segment_gather C {c_w}: route {segment_gather.plan.route}")
        phase("kernel", f"segment_gather (2, 37) ids, C {c_w}, S 9: exact, 3 "
              "NaN pixels; design: " + gather_design(segment_gather.plan))
    # K6 on its own function, superpixel_expand (no path calls it), against
    # the CPU plain path on the same labels and maps
    lab_t = torch.randint(-1, nc7, (BATCH, TILE, TILE), generator=g)
    sup_t = seg_ids.reshape(BATCH, TILE, TILE).cpu()
    exp_g = superpixel_expand(lab_t.to(dev), sup_t.to(dev), nc7, n_seg)
    exp_c = superpixel_expand(lab_t, sup_t, nc7, n_seg)
    if not torch.equal(exp_g.cpu(), exp_c):
        fail("superpixel_expand on the card differs from the CPU")
    phase("kernel", f"superpixel_expand ({BATCH}, {TILE}, {TILE}), S {n_seg}: "
          f"equal to the CPU plain path")

    # K4 against its plain version: the flagship's four stage shapes (batch
    # 8, 512^2 tiles, bf16; 1.6e-2 covers the 3x3's tap order, one bf16
    # rounding, tests/test_pallas_resblock.py:71-80), f32 on the CUDA cores
    # at two widths (1e-5), an odd shape, and dilation 2 on a 6x6 map (every
    # tile on the edge). Weights at He scale, the residual branch at half the
    # identity's, as in a trained ResNet
    def block_args(shape, cmid, dt):
        c = shape[1]

        def t(*s_, scale=1.0, d=dt):
            v = randn(*s_, scale=scale).to(dev, d)
            return v.contiguous(memory_format=CL) if v.dim() == 4 else v

        f32 = torch.float32
        return (t(*shape), t(cmid, c, 1, 1, scale=c ** -0.5),
                t(cmid, scale=0.1, d=f32),
                t(cmid, cmid, 3, 3, scale=(9 * cmid) ** -0.5),
                t(cmid, scale=0.1, d=f32),
                t(c, cmid, 1, 1, scale=0.5 * cmid ** -0.5),
                t(c, scale=0.1, d=f32))

    k4_stages = {  # stage: ((B, C, H, W), Cmid, dilation, K4 blocks a forward)
        "layer1": ((BATCH, 256, TILE // 4, TILE // 4), 64, 1, 2),
        "layer2": ((BATCH, 512, TILE // 8, TILE // 8), 128, 1, 3),
        "layer3": ((BATCH, 1024, TILE // 16, TILE // 16), 256, 1, 5),
        "layer4": ((BATCH, 2048, TILE // 16, TILE // 16), 512, 2, 2),
    }
    k4_cases = {stage: (sh, cm, d, torch.bfloat16)
                for stage, (sh, cm, d, _) in k4_stages.items()}
    k4_cases.update({
        "f32 layer1 width": ((2, 256, 32, 32), 64, 1, torch.float32),
        "f32 layer4 width": ((2, 2048, 8, 8), 512, 2, torch.float32),
        "odd f32": ((2, 64, 37, 53), 16, 1, torch.float32),
        "odd bf16": ((2, 64, 37, 53), 16, 1, torch.bfloat16),
        "dilation 2 on 6x6": ((BATCH, 2048, 6, 6), 512, 2, torch.bfloat16),
    })
    k4_plans = {}
    for case, (shape, cmid, dil, dt) in k4_cases.items():
        dn = str(dt).split(".")[-1]
        args = block_args(shape, cmid, dt)
        got = bottleneck_identity(*args, dilation=dil)
        k4_plans[case] = bottleneck_identity.plan
        ref = bottleneck_identity_plain(*args, dilation=dil)
        torch.cuda.synchronize()
        t_ = 1e-5 if dt == torch.float32 else 1.6e-2
        e = check_close(f"bottleneck_identity {case}", got, ref, t_, t_)
        if case in k4_stages:
            errs[(f"bottleneck_identity_{case}", dn)] = e
            inputs[case] = args
        phase("kernel", f"bottleneck_identity {case} {shape} Cmid {cmid} "
              f"dilation {dil} {dn}: tile {k4_plans[case].tile}, max abs err "
              f"{e:.3g} (atol = rtol = {t_}), "
              f"{float((got == ref).float().mean()):.5f} of values bit-equal")
        phase("kernel", f"bottleneck_identity {case} design: "
              + k4_design(k4_plans[case]))
        del got, ref

    mark("f32 model checks")
    # 4. the flagship model, f32 on a small input, against the plain path
    #    on the CPU (a comparison: its launches are not the main path's)
    cfg = DeeplabV2Config.uemda_default(num_classes=NUM_CLASSES)
    cpu_model = DeeplabV2(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    model = copy.deepcopy(cpu_model).to(dev)
    xs_small = randn(2, 3, 128, 128).contiguous(memory_format=CL)
    with torch.no_grad():
        ref_cpu = cpu_model(xs_small)
        fn32, p32 = make_serving_fn(model, dtype=torch.float32,
                                    s2b_layer4=True)
        got32 = fn32(p32, xs_small.to(dev))
        std32 = model(xs_small.to(dev))
    e_fp = check_close("fast path f32 vs CPU", got32.cpu(), ref_cpu, 1e-4, 1e-4)
    e_std = check_close("standard f32 vs CPU", std32.cpu(), ref_cpu, 1e-4, 1e-4)
    agree32 = float((got32.cpu().argmax(1) == ref_cpu.argmax(1)).float().mean())
    if agree32 <= 0.999:
        fail(f"fast path f32 argmax agreement {agree32}")
    phase("model", f"f32 128x128 b2 vs CPU plain path: fast path max abs err "
          f"{e_fp:.3g}, standard {e_std:.3g}, argmax agreement {agree32:.5f}")
    # the fused fast paths in f32 (TF32 off) against the unfused one on the
    # card: atol 5e-5, rtol 1e-4 (tests/test_infer_fastpath.py:47)
    from uemda_tpu_torch.infer.fastpath import FastpathModel

    fp32 = build_fastpath(model, dtype=torch.float32)  # one fold, three metas
    with torch.no_grad():
        unf32 = fp32(xs_small.to(dev))
        for stages in ((1, 2), (1, 2, 3, 4)):
            fu32 = FastpathModel({**fp32.meta, "fused_stages": stages},
                                 fp32.params)(xs_small.to(dev))
            e = check_close(f"fused {stages} f32 fast path vs unfused", fu32,
                            unf32, 5e-5, 1e-4)
            phase("model", f"f32 128x128 b2: fast path with fused_stages "
                  f"{stages} vs unfused: max abs err {e:.3g} (atol 5e-5, "
                  "rtol 1e-4)")
    del unf32, fu32

    mark("serving")
    # 5. the main path: the serving entry points at the flagship's full
    #    width, bf16 -- one fused-stem fast-path forward, one standard eval
    #    forward, and slide + 8-view TTA evaluation of a synthetic IsprsDA
    #    split. Every launch count is 0 just before and read just after.
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    fast_bf16 = build_fastpath(model, dtype=torch.bfloat16)
    x_flag = randn(BATCH, 3, TILE, TILE).to(dev, torch.bfloat16) \
        .contiguous(memory_format=CL)
    # three images at batch 2: the last batch is padded, so one captured
    # predictor serves the split
    data = synthetic_split(IsprsDA, n=3, hw=2 * TILE, seed=0)
    st = NORM_STATS["Vaihingen"]
    wrappers = (instance_norm, stem_pool, tail_upsample_softmax_mean)
    for fn in wrappers + (bnact,):
        fn.launches = 0
    with torch.no_grad():
        p_fast = fast_bf16(x_flag)
        per_forward = {fn.__name__: fn.launches for fn in wrappers}
        bnact_fast = bnact.launches
        p_std = model_bf16(x_flag)
        bnact_std = bnact.launches - bnact_fast
    t0 = time.time()
    summary, miou = evaluate_dataset(
        fast_bf16, data, st["mean"], st["std"], tile=(TILE, TILE), tta=True,
        batch_size=2, compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_eval = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers + (bnact,)}
    # comparisons, made after the main path's counts were read: the same
    # evaluation with eager predictor calls, and the f32 fast path on the
    # flagship batch (TF32 off)
    t_eval_e = eval_against_eager("eval", "the fast path", fast_bf16, data,
                                  st, summary, miou)
    with torch.no_grad():
        p_f32 = fp32(x_flag.float())

    for name, p in (("standard", p_std), ("fast path", p_fast)):
        if tuple(p.shape) != (BATCH, NUM_CLASSES, TILE, TILE) \
                or not torch.isfinite(p.float()).all():
            fail(f"{name} bf16 output {tuple(p.shape)} not finite or "
                 "misshaped")
        s_err = float((p.float().sum(1) - 1).abs().max())
        if s_err > 2e-2:  # six bf16 roundings of values <= 1
            fail(f"{name} bf16 probabilities sum to 1 +- {s_err}")
    # bf16 against f32 and against the bf16 standard forward: the bound of
    # tests/test_infer_fastpath.py:205 on the mean abs prob diff; argmax
    # agreement >= 0.9, as bf16 rounding flips near-ties of random weights
    for name, ref in (("f32 fast path", p_f32), ("bf16 standard", p_std)):
        d_max = max_err(p_fast, ref)
        d_mean = float((p_fast.float() - ref.float()).abs().mean())
        agree = float((p_fast.argmax(1) == ref.argmax(1)).float().mean())
        if d_mean >= 0.03 or agree < 0.9:
            fail(f"bf16 fast path vs {name}: mean abs prob diff {d_mean} "
                 f"(limit 0.03), argmax agreement {agree} (limit 0.9)")
        phase("model", f"ResNet-50 OS16 ({BATCH}, 3, {TILE}, {TILE}): bf16 "
              f"fast path vs {name}: max prob diff {d_max:.4g}, mean "
              f"{d_mean:.3g} (limit 0.03), argmax agreement {agree:.5f}")
    if not (0.0 <= miou <= 1.0):
        fail(f"evaluate_dataset mIoU {miou}")
    phase("eval", f"3 synthetic IsprsDA images {2 * TILE}^2 at batch 2, "
          f"tile {TILE}, 8-view TTA through the fast path (device_batches, "
          f"the captured predictor): mIoU {miou:.5f} (random weights) in "
          f"{t_eval:.2f} s (eager calls {t_eval_e:.2f} s)")
    phase("launches", f"one fast-path forward {json.dumps(per_forward)}; "
          f"main path {json.dumps(launches)}")
    for name, n in per_forward.items():
        if n != 1:
            fail(f"{name} launched {n} times in one fast-path forward")
    # the eval BatchNorm epilogue: none in the fast path (folded), one a
    # BatchNorm of the standard forward (stem 1, 16 blocks x 3, two heads
    # x 5)
    if bnact_fast != 0 or bnact_std != 59:
        fail(f"bnact launched {bnact_fast} times in one fast-path forward "
             f"(want 0) and {bnact_std} in one standard forward (want 59)")
    phase("launches", f"bnact: {bnact_fast} in one fast-path forward, "
          f"{bnact_std} in one standard forward")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")

    def gate(name, p, ref=None):
        """Finite probabilities of the flagship shape summing to 1 (+-2e-2,
        six bf16 roundings of values <= 1); against ``ref``, the mean abs
        prob diff and the argmax agreement."""
        if tuple(p.shape) != (BATCH, NUM_CLASSES, TILE, TILE) \
                or not torch.isfinite(p.float()).all():
            fail(f"{name}: output {tuple(p.shape)} not finite or misshaped")
        s_err = float((p.float().sum(1) - 1).abs().max())
        if s_err > 2e-2:
            fail(f"{name}: probabilities sum to 1 +- {s_err}")
        if ref is None:
            return s_err, None, None
        d_mean = float((p.float() - ref.float()).abs().mean())
        agree = float((p.argmax(1) == ref.argmax(1)).float().mean())
        return s_err, d_mean, agree

    mark("fused serving")
    # 5b. this slice's path: the fast path with the identity bottlenecks in
    #     K4 -- fused_stages (1, 2), the set the JAX package's bench A/B
    #     measures, and all four stages -- one forward each, then slide +
    #     8-view TTA evaluation through the all-stage one. Counts are 0 just
    #     before and read just after. Gate: the unfused bf16 fast path's
    #     (mean abs prob diff < 0.03, argmax agreement >= 0.9)
    fused = {stages: build_fastpath(model, dtype=torch.bfloat16,
                                    fused_stages=stages)
             for stages in ((1, 2), (1, 2, 3, 4))}
    fwrappers = (instance_norm, stem_pool, tail_upsample_softmax_mean,
                 bottleneck_identity)
    for fn in fwrappers + (bnact,):
        fn.launches = 0
    k4_per_forward, p_fused = {}, {}
    with torch.no_grad():
        for stages, fm in fused.items():
            n0 = bottleneck_identity.launches
            p_fused[stages] = fm(x_flag)
            k4_per_forward[stages] = bottleneck_identity.launches - n0
    t0 = time.time()
    summary_f, miou_f = evaluate_dataset(
        fused[(1, 2, 3, 4)], data, st["mean"], st["std"], tile=(TILE, TILE),
        tta=True, batch_size=2, compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_eval_f = time.time() - t0
    fused_launches = {fn.__name__: fn.launches
                      for fn in fwrappers + (bnact,)}
    t_eval_fe = eval_against_eager("fused", "fused_stages (1, 2, 3, 4)",
                                   fused[(1, 2, 3, 4)], data, st, summary_f,
                                   miou_f)
    for stages, n_want in (((1, 2), 5), ((1, 2, 3, 4), 12)):
        if k4_per_forward[stages] != n_want:
            fail(f"fused_stages {stages}: K4 launched "
                 f"{k4_per_forward[stages]} times a forward, not {n_want}")
        s_err, d_mean, agree = gate(f"fused {stages}", p_fused[stages], p_fast)
        if d_mean >= 0.03 or agree < 0.9:
            fail(f"fused {stages} vs unfused bf16 fast path: mean abs prob "
                 f"diff {d_mean} (limit 0.03), argmax agreement {agree}")
        phase("fused", f"fused_stages {stages} ({BATCH}, 3, {TILE}, {TILE}) "
              f"bf16: {n_want} K4 launches a forward; vs the unfused fast "
              f"path: max prob diff {max_err(p_fused[stages], p_fast):.4g}, "
              f"mean {d_mean:.3g}, argmax agreement {agree:.5f}; max |sum - "
              f"1| {s_err:.3g}")
    if not (0.0 <= miou_f <= 1.0):
        fail(f"evaluate_dataset through the fused fast path: mIoU {miou_f}")
    phase("fused", f"3 synthetic IsprsDA images {2 * TILE}^2 at batch 2, "
          f"8-view TTA through fused_stages (1, 2, 3, 4) (the captured "
          f"predictor): mIoU {miou_f:.5f} (unfused {miou:.5f}) in "
          f"{t_eval_f:.2f} s (eager calls {t_eval_fe:.2f} s)")
    phase("launches", f"fused path (two forwards + evaluation): "
          f"{json.dumps(fused_launches)}")
    for fn in fwrappers:
        if fused_launches[fn.__name__] <= 0:
            fail(f"{fn.__name__} was not launched on the fused path")
    del p_fused

    mark("int8 serving")
    # 5c. int8 serving at the flagship's full width: the dynamic int8 fast
    #     path (heads + stages 3, 4), the fast path calibrated on two random
    #     batches with every stage in int8 (the JAX package's
    #     fastpath_int8cal_all), and Int8Model on the bf16 standard forward.
    #     Random weights: only finiteness and the sum to 1 gate; the diff to
    #     the bf16 fast path is printed. Counts are 0 just before the builds.
    from uemda_tpu_torch.infer.fastpath import _conv_int8, _quantize_w
    from uemda_tpu_torch.infer.quant import Int8Model

    for fn in WRAPPERS:
        fn.launches = 0
    calib = [randn(BATCH, 3, TILE, TILE).to(dev).contiguous(memory_format=CL)
             for _ in range(2)]
    int8_modes = {
        "fastpath_int8": build_fastpath(model, dtype=torch.bfloat16, int8=True),
        "fastpath_int8cal_all": build_fastpath(
            model, dtype=torch.bfloat16, int8=True, int8_stages=(1, 2, 3, 4),
            calibration_batches=calib),
        "int8model": Int8Model(model_bf16),
    }
    del calib
    with torch.no_grad():
        for name, fm in int8_modes.items():
            s_err, d_mean, agree = gate(name, fm(x_flag), p_fast)
            phase("int8", f"{name} ({BATCH}, 3, {TILE}, {TILE}): max |sum - "
                  f"1| {s_err:.3g}; vs the bf16 fast path: mean abs prob "
                  f"diff {d_mean:.4g}, argmax agreement {agree:.5f} (random "
                  "weights)")
    int8_launches = {fn.__name__: fn.launches for fn in WRAPPERS}
    phase("launches", f"int8 path (builds, calibration, three forwards): "
          f"{json.dumps(int8_launches)}")
    for name in ("instance_norm", "stem_pool", "tail_upsample_softmax_mean"):
        if int8_launches[name] <= 0:
            fail(f"{name} was not launched on the int8 path")
    # one int8 conv on the card against the same call on the CPU: exact
    # int32 sums, the same f32 epilogue, so equal
    xq8 = randn(2, 256, 32, 32).contiguous(memory_format=CL)
    wq8, sq8 = (torch.from_numpy(a) for a in
                _quantize_w(randn(256, 256, 3, 3, scale=0.05).numpy()))
    bq8 = randn(256)
    with torch.no_grad():
        c_cpu = _conv_int8(xq8, wq8, sq8, bq8, dilation=2)
        c_gpu = _conv_int8(xq8.to(dev), wq8.to(dev), sq8.to(dev),
                           bq8.to(dev), dilation=2).cpu()
    if not torch.equal(c_cpu, c_gpu):
        fail(f"_conv_int8 on the card differs from the CPU: max abs diff "
             f"{max_err(c_gpu, c_cpu)}")
    phase("int8", "_conv_int8 (2, 256, 32, 32) 3x3 dilation 2 on the card: "
          "equal to the CPU")

    mark("stage 1")
    # 6. the stage-1 training path: the f32 step against the CPU, then the
    #    flagship bf16 run with its own launch counts
    train_launches, ctx = train_phase(dev)

    mark("stage 2")
    # 7. init_prototypes and stage 2 on the model stage 1 left: the f32
    #    step against the CPU, then the flagship chain with its own counts
    align_launches, astate = align_phase(dev, ctx)

    mark("prep")
    # 7b. the real-data path on stage 2's model and prototypes: LSC maps,
    #    the with_aux forward, refine_quality's refinement, stage 2 on LSC
    #    maps through the graph, with its own counts
    prep_launches, _ = prep_phase(dev, ctx, astate)

    mark("stage 3")
    # 8. init_prototypes and stage 3 on the model stage 2 left: the f32 step
    #    against the CPU, then the sweep and the flagship steps with their
    #    own counts
    ssl_launches, sctx = ssl_phase(dev, ctx)

    mark("mix")
    # 9. the mix and combo self-training on the chain's model and the
    #    sweep's soft labels: the f32 step against the CPU, the flagship
    #    combo and legacy CutMix, eager and through the graph
    mix_launches = mix_phase(dev, ctx, sctx)

    mark("zoo")
    # 10. what the stages used to refuse: stage 3 with every loss of the
    #    zoo, accumulation, with_cp, PROCA's stage 2, ResNeXt and v1c
    zoo_launches = zoo_phase(dev, ctx, sctx)

    mark("adv")
    # 11. the other DA trainers on the chain's model: the adversarial G + D
    #    step, DCA and the UVEM ablation's loop
    adv_launches = adv_phase(dev, ctx, sctx)
    mark("dca")
    dca_launches = dca_phase(dev, ctx, sctx)
    mark("abl")
    abl_launches = abl_phase(dev, ctx, sctx)
    mark("dp")
    # 11b. data parallelism: the three stages' steps in an NCCL group,
    #    eager and through the graph, against the plain steps; the raster
    #    predictor; two gloo ranks sharing the card
    dp_launches = dp_phase(dev, ctx, sctx)
    del sctx
    mark("tools")
    # 11c. the analysis and gate tools on the chain's model: class rates,
    #    sample_features, the host-crop A/B, the profile reader, the gate,
    #    slide_predict, with their own counts
    tools_launches = tools_phase(dev, ctx)
    mark("bnact")
    # 11d. the eval BatchNorm epilogue at the sweep's shapes, timed
    bnact_record = bnact_phase()

    mark("timing")
    # 12. timing (bf16, the serving and training dtype; K9 on uint8 tiles,
    #    K5-K7 on f32 probabilities), CUDA events after warm-up
    xi, xs, ws, bs, xt = inputs["bfloat16"]
    xb, dyb, mb, rb = inputs["bwd bfloat16"]
    xc, offc = inputs["crop"]
    wt_oihw = ws.permute(3, 2, 0, 1).contiguous(memory_format=CL)
    bs16 = bs.to(torch.bfloat16)
    xr = xb.detach().requires_grad_()
    yr = F.instance_norm(xr, eps=1e-5)   # the library yardstick's graph
    crop_args = (xc, offc, (TILE, TILE), st_l["mean"], st_l["std"])
    crop_host = (xc, offc.cpu(), (TILE, TILE), st_l["mean"], st_l["std"])
    p_mine = inputs["mine"]
    xt32 = inputs["tail32 bfloat16"]
    # K5-K7 at the 2urban stage-2 shape; the library yardsticks take the
    # int64 indices they need, made here once
    sv, sid, _, stab = inputs["segment"]
    sidx = sid.long()[..., None].expand(BATCH, TILE * TILE, nc7)
    srow = (sid.long() + n_seg * torch.arange(BATCH, device=dev)[:, None]
            ).reshape(-1)
    neg_table = torch.full((BATCH, n_seg, nc7), float("-inf"), device=dev)
    zero_rows = torch.zeros(BATCH * n_seg, nc7, device=dev)
    timed = {
        "instance_norm": (
            lambda: instance_norm(xi), lambda: instance_norm_plain(xi),
            lambda: F.instance_norm(xi, eps=1e-5)),
        "stem_pool": (
            lambda: stem_pool(xs, ws, bs), lambda: stem_pool_plain(xs, ws, bs),
            lambda: F.max_pool2d(F.relu(F.conv2d(F.pad(xs, (2, 1, 2, 1)),
                                                 wt_oihw, bs16)), 3, 2, 1)),
        "tail": (
            lambda: tail_upsample_softmax_mean(xt, (TILE, TILE), 2, 6),
            lambda: tail_upsample_softmax_mean_plain(xt, (TILE, TILE), 2, 6),
            lambda: torch.softmax(F.interpolate(
                xt, size=(TILE, TILE), mode="bilinear", align_corners=True
            ).view(BATCH, 2, 6, TILE, TILE), dim=2).mean(1)),
        "tail_b32": (
            lambda: tail_upsample_softmax_mean(xt32, (TILE, TILE), 2, 6),
            lambda: tail_upsample_softmax_mean_plain(xt32, (TILE, TILE), 2, 6),
            lambda: torch.softmax(F.interpolate(
                xt32, size=(TILE, TILE), mode="bilinear", align_corners=True
            ).view(32, 2, 6, TILE, TILE), dim=2).mean(1)),
        "instance_norm_backward": (
            lambda: instance_norm_backward(xb, dyb, mb, rb),
            lambda: instance_norm_backward_plain(xb, dyb, mb, rb),
            lambda: torch.autograd.grad(yr, xr, dyb, retain_graph=True)),
        "crop_normalize": (
            lambda: crop_normalize(*crop_args),
            lambda: crop_normalize_plain(*crop_host), None),
        "segment_max": (
            lambda: segment_max(sv, sid, n_seg),
            lambda: segment_max_plain(sv, sid, n_seg),
            lambda: neg_table.scatter_reduce(1, sidx, sv, "amax")),
        "segment_sum": (
            lambda: segment_sum(sv, sid, n_seg),
            lambda: segment_sum_plain(sv, sid, n_seg),
            lambda: zero_rows.index_add_(0, srow, sv.view(-1, nc7))),
        "segment_gather": (
            lambda: segment_gather(stab, sid),
            lambda: segment_gather_plain(stab, sid),
            lambda: torch.gather(stab, 1, sidx)),
        # the whole wrapper: K8's two passes, the class max inside them; no
        # one library call mines
        "uvem_mine": (
            lambda: uvem_mine(p_mine), lambda: uvem_mine_plain(p_mine), None),
    }
    # K4 at the four flagship stage shapes; no one library call computes the
    # block, so its yardstick is the unfused fast path's block on the same
    # folded weights: three cuDNN convs (bias inside) and two adds
    from uemda_tpu_torch.infer.fastpath import _block_forward

    for stage, (_, _, dil, _) in k4_stages.items():
        a4 = inputs[stage]
        blk = {c: {"w": a4[1 + 2 * i], "b": a4[2 + 2 * i]}
               for i, c in enumerate(("conv1", "conv2", "conv3"))}
        timed[f"bottleneck_identity_{stage}"] = (
            lambda a4=a4, dil=dil: bottleneck_identity(*a4, dilation=dil),
            lambda a4=a4, dil=dil: bottleneck_identity_plain(*a4, dilation=dil),
            lambda a4=a4, blk=blk, dil=dil: _block_forward(
                a4[0], blk, {"block": "bottleneck", "groups": 1}, 1, dil))
    # bytes each function must move (inputs read once, outputs written once)
    # and the operations it does, from this run's shapes, each with the peak
    # rate of its type: the stem conv's multiply-adds could run on the bf16
    # tensor cores; instance norm's and the tail's elementwise f32 work
    # (per element 6 ops; per pixel and logit 3 lerps = 9, softmax 4, mean
    # 1) runs outside them
    # K1's backward reads x and dy and the f32 statistics and writes dx,
    # ~10 f32 ops per element (x-hat 2, the two sums 3, dx 4); K9 reads the
    # uint8 windows and writes f32, 2 ops per element
    el = 2  # bf16
    n_in, n_st_in = xi.numel(), xs.numel() + ws.numel()
    n_st_out = BATCH * 64 * (TILE // 4) ** 2
    n_px = BATCH * TILE * TILE
    n_crop = BATCH * TILE * TILE * 3
    work = {
        "instance_norm_backward": (3 * xb.numel() * el + 2 * mb.numel() * 4,
                                   10 * xb.numel(), PEAK_FLOPS["float32"]),
        "crop_normalize": (n_crop * 1 + n_crop * 4, 2 * n_crop,
                           PEAK_FLOPS["float32"]),
        "instance_norm": (2 * n_in * el, 6 * n_in, PEAK_FLOPS["float32"]),
        "stem_pool": (n_st_in * el + bs.numel() * 4 + n_st_out * el,
                      2 * BATCH * (TILE // 2) ** 2 * 64 * 192,
                      PEAK_FLOPS["bfloat16"]),
        "tail": (xt.numel() * el + n_px * 6 * el, n_px * 12 * 14,
                 PEAK_FLOPS["float32"]),
        "tail_b32": (xt32.numel() * el + 4 * n_px * 6 * el,
                     4 * n_px * 12 * 14, PEAK_FLOPS["float32"]),
        # K5/K6 read the f32 values and int32 ids and write the (B, S, C)
        # table, one compare or add per value; K7 reads the ids and the
        # table and writes the values, no arithmetic
        "segment_max": (4 * sv.numel() + 4 * sid.numel() + 4 * stab.numel(),
                        sv.numel(), PEAK_FLOPS["float32"]),
        "segment_sum": (4 * sv.numel() + 4 * sid.numel() + 4 * stab.numel(),
                        sv.numel(), PEAK_FLOPS["float32"]),
        "segment_gather": (4 * sid.numel() + 4 * stab.numel() + 4 * sv.numel(),
                           0, PEAK_FLOPS["float32"]),
        # K8 reads the f32 probabilities and writes the int32 label and the
        # f32 w and u; per value a log, a multiply, an add and a compare,
        # per pixel ~16 ops of the parabola and one pow (counted as 1 op
        # each: the bytes bound it by far)
        "uvem_mine": (4 * p_mine.numel() + 3 * 4 * p_mine[:, 0].numel(),
                      4 * p_mine.numel() + 17 * p_mine[:, 0].numel(),
                      PEAK_FLOPS["float32"]),
    }
    # K4 reads x, the three bf16 weights and the f32 biases and writes the
    # output; 2 x (C*Cm + 9*Cm^2 + Cm*C) operations a pixel, bf16 tensor
    # cores
    for stage, ((b4, c4, h4, w4), cm4, _, _) in k4_stages.items():
        n_w = 2 * c4 * cm4 + 9 * cm4 * cm4
        work[f"bottleneck_identity_{stage}"] = (
            2 * b4 * c4 * h4 * w4 * el + n_w * el + (2 * cm4 + c4) * 4,
            2 * b4 * h4 * w4 * n_w, PEAK_FLOPS["bfloat16"])
    meta = {
        "instance_norm": ("uemda_tpu_torch/kernels/csrc/insnorm.cu",
                          "uemda_tpu/ops/pallas_insnorm.py:32", "instance_norm"),
        "stem_pool": ("uemda_tpu_torch/kernels/csrc/stem.cu",
                      "uemda_tpu/ops/pallas_stem.py:184", "stem_pool"),
        "tail": ("uemda_tpu_torch/kernels/csrc/tail.cu",
                 "uemda_tpu/ops/pallas_tail.py:57",
                 "tail_upsample_softmax_mean"),
        "tail_b32": ("uemda_tpu_torch/kernels/csrc/tail.cu",
                     "uemda_tpu/ops/pallas_tail.py:57",
                     "tail_upsample_softmax_mean"),
        "instance_norm_backward": (
            "uemda_tpu_torch/kernels/csrc/insnorm.cu",
            "uemda_tpu/ops/pallas_insnorm.py:32 (backward of)",
            "instance_norm_backward"),
        "crop_normalize": ("uemda_tpu_torch/kernels/csrc/crop.cu",
                           "uemda_tpu/ops/pallas_kernels.py:335",
                           "crop_normalize"),
        "segment_max": ("uemda_tpu_torch/kernels/csrc/segment.cu",
                        "uemda_tpu/ops/pallas_kernels.py:108", "segment_max"),
        "segment_sum": ("uemda_tpu_torch/kernels/csrc/segment.cu",
                        "uemda_tpu/ops/pallas_kernels.py:118", "segment_sum"),
        "segment_gather": ("uemda_tpu_torch/kernels/csrc/segment.cu",
                           "uemda_tpu/ops/pallas_kernels.py:143",
                           "segment_gather"),
        "uvem_mine": ("uemda_tpu_torch/kernels/csrc/mine.cu",
                      "uemda_tpu/ops/pallas_kernels.py:235", "uvem_mine"),
    }
    for stage in k4_stages:
        meta[f"bottleneck_identity_{stage}"] = (
            "uemda_tpu_torch/kernels/csrc/resblock.cu",
            "uemda_tpu/ops/pallas_resblock.py:165", "bottleneck_identity")
    record = []
    rec_fn = {name: m[2] for name, m in meta.items()}
    rec_fn["bnact"] = "bnact"
    paths = {"serve": launches, "fused": fused_launches,
             "int8": int8_launches, "train": train_launches,
             "align": align_launches, "prep": prep_launches,
             "ssl": ssl_launches, "mix": mix_launches, "zoo": zoo_launches,
             "adv": adv_launches, "dca": dca_launches, "abl": abl_launches,
             "dp": dp_launches, "tools": tools_launches}

    def path_launches(fn_name):
        """A kernel's launches on each path, each counted from 0 by that
        path's own run, and their sum."""
        per = {f"launches_{p}": n.get(fn_name, 0) for p, n in paths.items()}
        return {"launches": sum(per.values()), **per}

    for name, (k_fn, plain_fn, lib_fn) in timed.items():
        with torch.no_grad():
            ms = kernel_ms(k_fn)
            host_ms = cuda_ms(k_fn)
            plain_ms = kernel_ms(plain_fn)
        lib_ms = kernel_ms(lib_fn) if lib_fn is not None else None
        nbytes, nops, peak = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / peak * 1e3
        bound = max(t_bytes, t_ops)
        src, rep, fn_name = meta[name]
        dn = ("uint8" if name == "crop_normalize" else "float32"
              if name.startswith("segment") or name == "uvem_mine"
              else "bfloat16")
        record.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            **path_launches(fn_name),
            "max_abs_err": errs[(name, dn)], "ms": ms,
            "ms_with_host": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        if fn_name == "bottleneck_identity":
            stage = name.rsplit("_", 1)[1]
            record[-1].update(shape=list(k4_stages[stage][0]),
                              cmid=k4_stages[stage][1],
                              dilation=k4_stages[stage][2],
                              launches_per_forward=k4_stages[stage][3],
                              tile=list(k4_plans[stage].tile),
                              config=k4_plans[stage].config,
                              stages=k4_plans[stage].stages,
                              smem=k4_plans[stage].smem)
        if fn_name == "instance_norm":
            record[-1].update(plan=dataclasses.asdict(
                instance_norm_forward.plan))
        if fn_name == "instance_norm_backward":
            record[-1].update(plan=dataclasses.asdict(
                instance_norm_backward.plan))
        if fn_name in ("segment_max", "segment_sum"):
            record[-1].update(plan=dataclasses.asdict(
                getattr(segment_max if fn_name == "segment_max"
                        else segment_sum, "plan")))
        if fn_name == "segment_gather":
            record[-1].update(plan=dataclasses.asdict(segment_gather.plan))
        if fn_name == "tail_upsample_softmax_mean":
            record[-1].update(plan=dataclasses.asdict(
                tail_upsample_softmax_mean.plan))
        if fn_name == "uvem_mine":
            record[-1].update(plan=dataclasses.asdict(uvem_mine.plan))
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        phase("time", f"{name} {dn}: kernel {ms:.4f} ms ({host_ms:.4f} ms "
              f"back to back with its wrapper's host work), plain "
              f"{plain_ms:.4f} ms, library {lib_txt}, bound "
              f"{bound:.4f} ms ({record[-1]['bound_by']}; {nbytes} B, "
              f"{nops} op)")
    # the K1 forward's design space at the flagship shape in both dtypes and
    # at the serving batch of 32 in bf16, each plan held to its plain
    # version and timed like the kernels above: 32 or 64 channels a CTA,
    # clusters of 1-8; the plan's own choice first
    for shape, dn in (((BATCH, 2048, TILE // 16, TILE // 16), "bfloat16"),
                      ((BATCH, 2048, TILE // 16, TILE // 16), "float32"),
                      ((32, 2048, TILE // 16, TILE // 16), "bfloat16")):
        dt = getattr(torch, dn)
        xs_ = torch.randn(*shape, generator=g8).to(dev, dt) \
            .contiguous(memory_format=CL)
        ref_ = instance_norm_plain(xs_)
        sweep = [None] + [instance_norm_forward_plan(*shape, dt, cb=cb,
                                                     cluster=k)
                          for cb in (64, 32) for k in (1, 2, 4, 8)]
        cells = []
        for plan in sweep:
            with torch.no_grad():
                got = instance_norm_forward(xs_, plan=plan)[0]
                atol, rtol = tol["instance_norm"][dn]
                check_close(f"instance_norm {dn} sweep", got, ref_, atol, rtol)
                p_ = instance_norm_forward.plan
                t_ = kernel_ms(lambda: instance_norm_forward(xs_, plan=plan))
            cells.append(f"{'plan: ' if plan is None else ''}{p_.route} cb "
                         f"{p_.cb} cluster {p_.cluster} {p_.smem // 1024} KB "
                         f"{t_:.4f} ms")
        phase("time", f"instance_norm {dn} {shape} design sweep: "
              + "; ".join(cells))
    # K5's design space at 2urban: tiles of 512-2048 pixels on the window
    # route, the full table and the global route, each held to the plain
    # version; the plan's own choice first
    ref_ = segment_max_plain(sv, sid, n_seg)
    sweep = [None] + [segment_reduce_plan(BATCH, TILE * TILE, nc7, n_seg,
                                          tile=t) for t in (512, 2048)] + [
        segment_reduce_plan(BATCH, TILE * TILE, nc7, n_seg, route=r)
        for r in ("full", "global")]
    cells = []
    for plan in sweep:
        got = segment_max(sv, sid, n_seg, plan=plan)
        torch.cuda.synchronize()
        if not torch.equal(got, ref_):
            fail(f"segment_max sweep {plan}: differs from its plain version")
        p_ = segment_max.plan
        t_ = kernel_ms(lambda: segment_max(sv, sid, n_seg, plan=plan))
        cells.append(f"{'plan: ' if plan is None else ''}{p_.route} tile "
                     f"{p_.tile} rows {p_.rows} {p_.smem // 1024} KB "
                     f"{t_:.4f} ms")
    phase("time", f"segment_max float32 ({BATCH}, {TILE * TILE}, {nc7}) S "
          f"{n_seg} design sweep: " + "; ".join(cells))
    # K3's design space at (8, 12, 32, 32) bf16 -> 512^2: 2-16 rows a CTA,
    # each held to the plain version at the bf16 gate and timed like the
    # kernels above; the plan's own choice first
    ref_ = tail_upsample_softmax_mean_plain(xt, (TILE, TILE), 2, 6)
    sweep = [None] + [tail_plan(BATCH, TILE // 16, TILE // 16, TILE, TILE, 2,
                                6, torch.bfloat16, rows=r)
                      for r in (2, 4, 8, 16)]
    cells = []
    for plan in sweep:
        with torch.no_grad():
            got = tail_upsample_softmax_mean(xt, (TILE, TILE), 2, 6, plan=plan)
            check_close("tail bfloat16 sweep", got, ref_,
                        *tol["tail"]["bfloat16"])
            p_ = tail_upsample_softmax_mean.plan
            t_ = kernel_ms(lambda: tail_upsample_softmax_mean(
                xt, (TILE, TILE), 2, 6, plan=plan))
        cells.append(f"{'plan: ' if plan is None else ''}rows {p_.rows} ppt "
                     f"{p_.ppt} {p_.smem // 1024} KB {t_:.4f} ms")
    phase("time", f"tail bfloat16 {tuple(xt.shape)} -> {TILE}^2 design "
          "sweep: " + "; ".join(cells))
    # K8's at the flagship (8, 7, 512^2) channels_last, the whole wrapper:
    # 4, 8 or 16 pixels a thread, each held to the plain version at the
    # gates above; the plan's own first
    ref_ = uvem_mine_plain(p_mine)
    sweep = [None] + [uvem_mine_plan(*p_mine.shape, p_mine.stride(),
                                     p_mine.data_ptr(), ppt=pp)
                      for pp in (4, 8, 16)]
    cells = []
    for plan in sweep:
        got = uvem_mine(p_mine, plan=plan)
        torch.cuda.synchronize()
        if not torch.equal(got[0], ref_[0]):
            fail(f"uvem_mine sweep {plan}: labels differ")
        check_close("uvem_mine sweep u", got[2], ref_[2], 1e-7, 1e-6)
        check_close("uvem_mine sweep w", got[1], ref_[1], 1e-7, 1e-5)
        p_ = uvem_mine.plan
        t_ = kernel_ms(lambda: uvem_mine(p_mine, plan=plan))
        cells.append(f"{'plan: ' if plan is None else ''}{p_.route} ppt "
                     f"{p_.ppt} {t_:.4f} ms")
    phase("time", f"uvem_mine float32 {tuple(p_mine.shape)} channels_last "
          "design sweep: " + "; ".join(cells))
    # the K1 backward's design space at the flagship shape, each plan held
    # to its plain version and timed like the kernels above, in both dtypes:
    # 32 or 64 channels a CTA, clusters of 1-8; the plan's own choice first
    for dn in ("bfloat16", "float32"):
        xs_, dys_, ms_, rs_ = inputs[f"bwd {dn}"]
        b_, c_, h_, w_ = xs_.shape
        ref_ = instance_norm_backward_plain(xs_, dys_, ms_, rs_)
        sweep = [None] + [instance_norm_backward_plan(
            b_, c_, h_, w_, xs_.dtype, cb=cb, cluster=k)
            for cb in (64, 32) for k in (1, 2, 4, 8)]
        cells = []
        for plan in sweep:
            got = instance_norm_backward(xs_, dys_, ms_, rs_, plan=plan)
            check_close(f"instance_norm_backward {dn} sweep", got, ref_,
                        bwd_tol[dn], bwd_tol[dn])
            p_ = instance_norm_backward.plan
            t_ = kernel_ms(lambda: instance_norm_backward(
                xs_, dys_, ms_, rs_, plan=plan))
            cells.append(f"{'plan: ' if plan is None else ''}{p_.route} cb "
                         f"{p_.cb} cluster {p_.cluster} {p_.smem // 1024} KB "
                         f"{t_:.4f} ms")
        phase("time", f"instance_norm_backward {dn} {tuple(xs_.shape)} "
              "design sweep: " + "; ".join(cells))
    # what label_refine costs at the flagship stage-2 shape, per view: the
    # trained prototypes, (8, 2048, 32, 32) features, two heads' (8, 7, 32,
    # 32) logits, the (8, 7, 512, 512) soft label and the 2urban maps
    from uemda_tpu_torch.alignment.prototypes import label_refine

    lr_feat = torch.randn(BATCH, 2048, TILE // 16, TILE // 16, device=dev) \
        .contiguous(memory_format=CL)
    lr_preds = [torch.randn(BATCH, nc7, TILE // 16, TILE // 16, device=dev)
                .contiguous(memory_format=CL) for _ in range(2)]
    lr_soft = torch.softmax(torch.randn(BATCH, nc7, TILE, TILE, device=dev), 1) \
        .contiguous(memory_format=CL)
    lr_sup = sid.reshape(BATCH, TILE, TILE)
    for mode in ("all", "p", "l", "s"):
        t_lr = kernel_ms(lambda: label_refine(
            astate.aligner, lr_soft, lr_feat, lr_preds, sup=lr_sup, mode=mode,
            max_segments=n_seg), iters=10)
        t_lr_host = cuda_ms(lambda: label_refine(
            astate.aligner, lr_soft, lr_feat, lr_preds, sup=lr_sup, mode=mode,
            max_segments=n_seg), iters=10)
        phase("time", f"label_refine mode {mode!r} at batch {BATCH}, "
              f"{TILE}^2, S {n_seg}: {t_lr:.4f} ms device, {t_lr_host:.4f} ms "
              "back to back with its host work")

    # the serving modes through the captured predictor against eager calls,
    # at batch 1, 8 and 32, each mode built once
    mark("serve graph")
    serve_modes = {"fast path": fast_bf16,
                   "fused (1, 2)": fused[(1, 2)],
                   "fused (1, 2, 3, 4)": fused[(1, 2, 3, 4)],
                   **int8_modes, "standard": model_bf16}
    replay_launches = serve_graph_phase(serve_modes)
    for rec in bnact_record:
        rec.update(path_launches("bnact"),
                   launches_per_standard_forward=bnact_std)
    phase("launches", f"bnact on each path: "
          f"{json.dumps(path_launches('bnact'))}; "
          f"{bnact_std} a standard forward")
    for rec in record + bnact_record:
        per_mode = {m: n[rec_fn[rec["name"]]]
                    for m, n in replay_launches.items()
                    if n.get(rec_fn[rec["name"]], 0) > 0}
        rec["launches_per_replay_serve_b8"] = per_mode

    t_end = time.time()
    spans = [(n, (sections[i + 1][1] if i + 1 < len(sections) else t_end) - t)
             for i, (n, t) in enumerate(sections)]
    phase("done", f"{t_end - t_start:.1f} s: " + ", ".join(
        f"{n} {d:.1f} s" for n, d in spans))
    print(json.dumps({"kernels": record + bnact_record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
