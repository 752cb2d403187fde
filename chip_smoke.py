#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``uemda_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``uemda_tpu_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes of the main
paths, and drives them (flagship ResNet-50 OS16 dual-PPM model, random
weights from a seed):

* serving: the standard eval forward, the fused-stem fast path and slide +
  8-view TTA evaluation;
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
* ``init_prototypes`` again and stage 3 (``[ssl]``) on the model stage 2
  left: an f32 step against the CPU, then the pseudo-label sweep of the
  target tiles (slide + 8-view TTA, bf16) and 30 flagship UVEM steps, each
  mining its soft label once with the K8 kernel.

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


def profile_steps(what, step_fn, state, src_it, tgt_it, dev, ms_step, n=3):
    """``n`` more steps under the profiler: device time per step, the
    device's idle share, device time by kernel and by operator, and the
    host's operator time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uemda_tpu_torch.train.loop import batch_to_device

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step_fn(state, batch_to_device(next(src_it), dev),
                    batch_to_device(next(tgt_it), dev), 2333)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows, ops, total_us = profile_rows(prof, n)
    if total_us <= 0:
        phase("profile", f"{what}: device time not measured (profiler saw "
              "none)")
        return None
    phase("profile", f"{what}, {n} steps: device time {total_us / 1e3:.3f} "
          f"ms/step; idle share {max(0.0, 1 - total_us / 1e3 / ms_step):.3f} "
          f"of the event-timed step, "
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
    return total_us / 1e3


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
    from uemda_tpu_torch.datasets.base import infinite_batches
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.train.loop import (
        batch_to_device,
        build_model,
        build_state,
        default_hparams,
        make_eval_hook,
        run_training_loop,
    )
    from uemda_tpu_torch.datasets.augment import draw_augment
    from uemda_tpu_torch.train.steps import StepDraws, make_src_step

    cfg = PRESETS["2urban"]  # LoveDA: 7 classes, 1024^2 tiles, crop 512^2
    nc = cfg.class_num

    # (a) f32, TF32 off: ResNet-50 OS16 dual PPM at 128^2, batch 2, CORAL
    # on; the same weights, batches, augmentation draws and dropout masks on
    # both devices, at step 1 (lr(1) != 0) of a 100-step schedule
    small = dataclasses.replace(cfg, crop=(128, 128))
    g = torch.Generator().manual_seed(1)
    cpu_model = build_model(small, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    gpu_model = build_model(small, device=dev,
                            generator=torch.Generator().manual_seed(0))
    gpu_model.load_state_dict(cpu_model.state_dict())
    hp32 = default_hparams(small, align_domain=True, compute_dtype="float32")
    data = synthetic_split(LoveDA, n=4, hw=160, seed=2)
    bs = {"image": data.images[:2], "label": data.labels[:2]}
    bt = {"image": data.images[2:]}
    drop = [{h: torch.rand(2, 512, 8, 8, generator=g) < 0.9
             for h in ("layer5", "layer6")} for _ in range(2)]
    draws = StepDraws(draw_augment(g, 2, (160, 160), small.crop),
                      draw_augment(g, 2, (160, 160), small.crop), *drop)
    out = {}
    for name, model, d in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
        state = build_state(model, small, 100)
        state.step = state.opt.count = 1
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics = make_src_step(model, hp32)(
            state, batch_to_device(bs, d), batch_to_device(bt, d), 0,
            draws=draws)
        out[name] = (
            {k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: (p.detach() - before[n]).cpu()
             for n, p in model.named_parameters()})
    (m_c, g_c, u_c), (m_g, g_g, u_g) = out["cpu"], out["gpu"]
    for k in m_c:
        rel = abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-30)
        if not rel <= 1e-4:  # f32 sums in other orders; measured in PERF.md
            fail(f"f32 step {k}: card {m_g[k]} vs CPU {m_c[k]} (rel {rel:.3g})")

    def rel_max(a, b):
        num = max(float((a[n] - b[n]).abs().max()) for n in a)
        return num / max(float(b[n].abs().max()) for n in b)

    e_g, e_u = rel_max(g_g, g_c), rel_max(u_g, u_c)
    worst = max(g_c, key=lambda n: float((g_g[n] - g_c[n]).abs().max()))
    # the gradients of a random-weight net at 8x8 features are
    # ill-conditioned in f32 (PERF.md, stage-1 section): 2e-2 of max |g|
    if not (e_g <= 2e-2 and e_u <= 2e-2):
        fail(f"f32 step gradients: max abs err / max |g| {e_g:.3g}, update "
             f"{e_u:.3g} (limit 2e-2), worst {worst}")
    phase("train", f"f32 step on the card vs the CPU plain path (ResNet-50 "
          f"OS16, 128^2, batch 2, CORAL, step 1): losses "
          f"{json.dumps({k: [m_g[k], m_c[k]] for k in m_c})}; gradients max "
          f"abs err / max |g| {e_g:.3g} (worst {worst}), updates {e_u:.3g}")
    del cpu_model, gpu_model, out, g_c, g_g, u_c, u_g

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
    step_fn = make_src_step(model, default_hparams(cfg, align_domain=True))
    eval_fn, _ = make_eval_hook(cfg, None, dataset=val)
    src_it = infinite_batches(src, batch, seed=0)
    tgt_it = infinite_batches(tgt, batch, seed=1)
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

    profile_steps(f"stage-1 step (bf16, batch {batch}, CORAL)", step_fn,
                  state, src_it, tgt_it, dev, ms_step)
    return counts, dict(cfg=cfg, model=model, src=src, tgt=tgt_sup, val=val)


def align_phase(dev, ctx):
    """``init_prototypes`` and the stage-2 path. (a) One f32 stage-2 step on
    the card against the same step on the CPU's plain path. (b) On the model
    stage 1 left: the prototype pass over the source split, 30 bf16
    stage-2 steps through ``run_training_loop`` and an evaluation, every
    launch count set to 0 just before the pass and read just after the
    evaluation; returns those counts and the inputs ``label_refine`` saw
    last, for its timing."""
    import dataclasses

    import numpy as np
    import torch

    from uemda_tpu_torch.datasets.augment import draw_augment
    from uemda_tpu_torch.datasets.base import infinite_batches
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.tools.init_prototypes import init_prototypes
    from uemda_tpu_torch.train.loop import (
        batch_to_device,
        build_model,
        build_state,
        default_hparams,
        make_eval_hook,
        run_training_loop,
    )
    from uemda_tpu_torch.train.steps import (
        StepDraws,
        make_align_step,
        make_init_proto_step,
    )

    cfg = ctx["cfg"]
    nc = cfg.class_num

    # (a) f32, TF32 off: ResNet-50 OS16 dual PPM at 128^2, batch 2, CORAL,
    # refine 'all' with 16-pixel grid superpixels: the stage-1 check's
    # weights, batches, draws and dropout masks (seeds 0, 1, 2), the target's
    # superpixel maps and random prototypes, the same on both devices, at
    # step 1 of a 100-step schedule. The gradient limit measures the
    # conditioning of this tiny geometry (the stem conv's gradient, as in
    # stage 1) as much as the port; another draw exceeds it for the
    # stage-1 step as well (PERF.md, PR 3)
    small = dataclasses.replace(cfg, crop=(128, 128))
    g = torch.Generator().manual_seed(1)
    cpu_model = build_model(small, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    gpu_model = build_model(small, device=dev,
                            generator=torch.Generator().manual_seed(0))
    gpu_model.load_state_dict(cpu_model.state_dict())
    hp32 = default_hparams(small, align_domain=True, compute_dtype="float32")
    data = synthetic_split(LoveDA, n=4, hw=160, seed=2, with_sup=True)
    bs = {"image": data.images[:2], "label": data.labels[:2]}
    bt = {"image": data.images[2:], "sup": data.sup[2:]}
    drop = [{h: torch.rand(2, 512, 8, 8, generator=g) < 0.9
             for h in ("layer5", "layer6")} for _ in range(2)]
    draws = StepDraws(draw_augment(g, 2, (160, 160), small.crop),
                      draw_augment(g, 2, (160, 160), small.crop), *drop)
    proto = torch.randn(nc, 2048, generator=g)
    out = {}
    for name, model, d in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
        state = build_state(model, small, 100, prototypes=proto)
        state.step = state.opt.count = 1
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics = make_align_step(model, hp32)(
            state, batch_to_device(bs, d), batch_to_device(bt, d), 0,
            draws=draws)
        out[name] = (
            {k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: (p.detach() - before[n]).cpu()
             for n, p in model.named_parameters()},
            state.aligner.prototypes.cpu())
    (m_c, g_c, u_c, p_c), (m_g, g_g, u_g, p_g) = out["cpu"], out["gpu"]
    for k in m_c:
        rel = abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-30)
        if not rel <= 1e-4:  # f32 sums in other orders, as stage 1
            fail(f"f32 stage-2 step {k}: card {m_g[k]} vs CPU {m_c[k]} "
                 f"(rel {rel:.3g})")

    def rel_max(a, b):
        num = max(float((a[n] - b[n]).abs().max()) for n in a)
        return num / max(float(b[n].abs().max()) for n in b)

    e_g, e_u = rel_max(g_g, g_c), rel_max(u_g, u_c)
    e_p = float((p_g - p_c).abs().max()) / float(p_c.abs().max())
    if not (e_g <= 2e-2 and e_u <= 2e-2 and e_p <= 1e-5):
        fail(f"f32 stage-2 step: gradients {e_g:.3g}, updates {e_u:.3g} of "
             f"max |g| (limit 2e-2); prototypes {e_p:.3g} of max |p| (limit "
             "1e-5)")
    phase("align", f"f32 stage-2 step on the card vs the CPU plain path "
          f"(ResNet-50 OS16, 128^2, batch 2, CORAL, refine 'all', step 1): "
          f"losses {json.dumps({k: [m_g[k], m_c[k]] for k in m_c})}; "
          f"gradients max abs err / max |g| {e_g:.3g}, updates {e_u:.3g}; "
          f"prototypes {e_p:.3g} of max |p|")
    del cpu_model, gpu_model, out, g_c, g_g, u_c, u_g

    # (b) the chain at the flagship: the stage-1 model -> init_prototypes
    # over the 16 source tiles (2 batches of 8) -> 30 stage-2 steps with
    # the schedule's horizon at 30 -> evaluation
    steps, batch = 30, BATCH
    model = ctx["model"]
    hp = default_hparams(cfg, align_domain=True, refine=True,
                         refine_mode="all")
    eval_fn, _ = make_eval_hook(cfg, None, dataset=ctx["val"])
    src_it = infinite_batches(ctx["src"], batch, seed=10)
    tgt_it = infinite_batches(ctx["tgt"], batch, seed=11)
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
    profile_steps(f"stage-2 step (bf16, batch {batch}, CORAL, refine 'all')",
                  step_fn, state, src_it, tgt_it, dev, ms_step)
    return counts, state


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
    import dataclasses

    import numpy as np
    import torch

    from uemda_tpu_torch.datasets.augment import draw_augment
    from uemda_tpu_torch.datasets.base import ArrayDataset, infinite_batches
    from uemda_tpu_torch.datasets.meta import LoveDA, NORM_STATS
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
    from uemda_tpu_torch.ops.pseudo import pseudo_selection
    from uemda_tpu_torch.tools.init_prototypes import init_prototypes
    from uemda_tpu_torch.train.loop import (
        batch_to_device,
        build_model,
        build_state,
        default_hparams,
        make_eval_hook,
        run_training_loop,
    )
    from uemda_tpu_torch.train.steps import (
        StepDraws,
        make_init_proto_step,
        make_ssl_step,
    )

    cfg = ctx["cfg"]
    nc = cfg.class_num

    # (a) f32, TF32 off: ResNet-50 OS16 dual PPM at 128^2, batch 2, UVEM
    # with refine 'all' and the target class balance; stage 1's draw (model
    # seed 0, data seeds 1, 2), the target's superpixel maps, stored soft
    # labels peaked on its labels, random prototypes, the same on both
    # devices, at step 1 of a 100-step schedule
    small = dataclasses.replace(cfg, crop=(128, 128))
    g = torch.Generator().manual_seed(1)
    cpu_model = build_model(small, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    gpu_model = build_model(small, device=dev,
                            generator=torch.Generator().manual_seed(0))
    gpu_model.load_state_dict(cpu_model.state_dict())
    hp32 = default_hparams(small, refine=True, refine_mode="all",
                           balance_target=True, compute_dtype="float32")
    data = synthetic_split(LoveDA, n=4, hw=160, seed=2, with_sup=True)
    bs = {"image": data.images[:2], "label": data.labels[:2]}
    bt = {"image": data.images[2:], "sup": data.sup[2:],
          "prob": soft_labels(data.labels[2:], nc, seed=1)}
    drop = [{h: torch.rand(2, 512, 8, 8, generator=g) < 0.9
             for h in ("layer5", "layer6")} for _ in range(2)]
    draws = StepDraws(draw_augment(g, 2, (160, 160), small.crop),
                      draw_augment(g, 2, (160, 160), small.crop, "compose"),
                      *drop)
    proto = torch.randn(nc, cpu_model.config.inchannels, generator=g)
    out = {}
    for name, model, d in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
        state = build_state(model, small, 100, prototypes=proto)
        state.step = state.opt.count = 1
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics = make_ssl_step(model, hp32)(
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
    for k in ("loss", "loss_source", "loss_target"):
        rel = abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-30)
        if not rel <= 1e-4:  # f32 sums in other orders, as stages 1 and 2
            fail(f"f32 stage-3 step {k}: card {m_g[k]} vs CPU {m_c[k]} "
                 f"(rel {rel:.3g})")
    if not (m_c["loss_target"] > 0 and m_c["selected"] > 0
            and m_c["trained"] > 0):
        fail(f"f32 stage-3 step: the target loss selected or trained no "
             f"pixel ({m_c}); the check would show nothing of K8")
    for k in ("selected", "trained"):  # a pixel at a threshold may flip
        if not abs(m_g[k] - m_c[k]) <= 1e-3:
            fail(f"f32 stage-3 step {k}: card {m_g[k]} vs CPU {m_c[k]}")

    def rel_max(a, b):
        num = max(float((a[n] - b[n]).abs().max()) for n in a)
        return num / max(float(b[n].abs().max()) for n in b)

    e_g, e_u = rel_max(g_g, g_c), rel_max(u_g, u_c)
    e_p = float((p_g - p_c).abs().max()) / float(p_c.abs().max())
    e_f = float(((f_g - f_c).abs() / f_c.abs()).max())
    if not (e_g <= 2e-2 and e_u <= 2e-2 and e_p <= 1e-5 and e_f <= 1e-6):
        fail(f"f32 stage-3 step: gradients {e_g:.3g}, updates {e_u:.3g} of "
             f"max |g| (limit 2e-2); prototypes {e_p:.3g} of max |p| (limit "
             f"1e-5); class-balance frequencies {e_f:.3g} relative (limit "
             "1e-6)")
    phase("ssl", f"f32 stage-3 step on the card vs the CPU plain path "
          f"(ResNet-50 OS16, 128^2, batch 2, UVEM, refine 'all', target "
          f"class balance, step 1): {json.dumps({k: [m_g[k], m_c[k]] for k in m_c})}; "
          f"gradients max abs err / max |g| {e_g:.3g}, updates {e_u:.3g}; "
          f"prototypes {e_p:.3g} of max |p|; frequencies {e_f:.3g}")
    del cpu_model, gpu_model, out, g_c, g_g, u_c, u_g

    # (b) the chain's steps 4 and 5 at the flagship: init_prototypes over
    # the 16 source tiles on the stage-2 model, the sweep of the 16 target
    # tiles, 30 stage-3 steps with the schedule's horizon at 30, evaluation
    steps, batch = 30, BATCH
    model = ctx["model"]
    hp = default_hparams(cfg, refine=True, refine_mode="all")
    eval_fn, _ = make_eval_hook(cfg, None, dataset=ctx["val"])
    tgt = ctx["tgt"]
    st = NORM_STATS["LoveDA"]
    src_it = infinite_batches(ctx["src"], batch, seed=20)
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sweep = generate_pseudo_labels(
        model, tgt, st["mean"], st["std"], tile=(TILE, TILE), tta=True,
        batch_size=min(4, batch), cutoff_top=cfg.cutoff_top,
        cutoff_low=cfg.cutoff_low, compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_sweep = time.time() - t0
    peak_sweep = torch.cuda.max_memory_allocated() / 2**30
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
    tgt_it = infinite_batches(target, batch, seed=21)
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
    # in-memory split (numpy) and its pinned upload, timed on their own
    for what, it in (("source", src_it), ("target", tgt_it)):
        t_np = t_up = 0.0
        for _ in range(5):
            t0 = time.perf_counter()
            host = next(it)
            t1 = time.perf_counter()
            batch_to_device(host, dev)
            torch.cuda.synchronize()
            t_np += t1 - t0
            t_up += time.perf_counter() - t1
        nbytes = sum(a.nbytes for a in host.values())
        phase("ssl", f"host data, {what} batch ({nbytes / 2**20:.1f} MiB: "
              f"{', '.join(f'{k} {a.dtype}' for k, a in host.items())}): "
              f"{t_np / 5 * 1e3:.3f} ms to assemble, {t_up / 5 * 1e3:.3f} ms "
              "to pin and upload")
    profile_steps(f"stage-3 step (bf16, batch {batch}, UVEM, refine 'all')",
                  step_fn, state, src_it, tgt_it, dev, ms_step)
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

    WRAPPERS[:] = [instance_norm, instance_norm_backward, crop_normalize,
                   stem_pool, tail_upsample_softmax_mean, segment_max,
                   segment_sum, segment_gather, uvem_mine, bottleneck_identity]
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
            got = crop_normalize(xc, off, chw, st_l["mean"], st_l["std"])
            ref = crop_normalize_plain(xc, off, chw, st_l["mean"], st_l["std"])
            torch.cuda.synchronize()
            e = check_close(f"crop_normalize {dn} {case}", got, ref, 0.0, 0.0)
            if case == "train":
                errs[("crop_normalize", dn)] = e
                raw[dn] = (xc, off)
            phase("kernel", f"crop_normalize {dn} {tuple(xc.shape)} -> "
                  f"{tuple(got.shape)}: max abs err {e:.3g} (exact)")
    inputs["crop"] = raw["uint8"]
    # K9 with the stage-3 clamp (the ISPRS target Normalize), exactly, at the
    # training shape, on statistics that push part of every tile past 1.0
    st_v = NORM_STATS["Vaihingen"]
    xc, off = raw["uint8"]
    got = crop_normalize(xc, off, (TILE, TILE), st_v["mean"], st_v["std"],
                         clamp=True)
    ref = crop_normalize_plain(xc, off, (TILE, TILE), st_v["mean"],
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
    data = synthetic_split(IsprsDA, n=2, hw=2 * TILE, seed=0)
    st = NORM_STATS["Vaihingen"]
    wrappers = (instance_norm, stem_pool, tail_upsample_softmax_mean)
    for fn in wrappers:
        fn.launches = 0
    with torch.no_grad():
        p_fast = fast_bf16(x_flag)
        per_forward = {fn.__name__: fn.launches for fn in wrappers}
        p_std = model_bf16(x_flag)
    t0 = time.time()
    summary, miou = evaluate_dataset(
        fast_bf16, data, st["mean"], st["std"], tile=(TILE, TILE), tta=True,
        batch_size=1, compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_eval = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    # the f32 fast path on the same batch (TF32 off), a comparison made after
    # the main path's counts were read
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
    phase("eval", f"2 synthetic IsprsDA images {2 * TILE}^2, tile {TILE}, "
          f"8-view TTA through the fast path: mIoU {miou:.5f} (random "
          f"weights) in {t_eval:.2f} s")
    phase("launches", f"one fast-path forward {json.dumps(per_forward)}; "
          f"main path {json.dumps(launches)}")
    for name, n in per_forward.items():
        if n != 1:
            fail(f"{name} launched {n} times in one fast-path forward")
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
    for fn in fwrappers:
        fn.launches = 0
    k4_per_forward, p_fused = {}, {}
    with torch.no_grad():
        for stages, fm in fused.items():
            n0 = bottleneck_identity.launches
            p_fused[stages] = fm(x_flag)
            k4_per_forward[stages] = bottleneck_identity.launches - n0
    t0 = time.time()
    _, miou_f = evaluate_dataset(
        fused[(1, 2, 3, 4)], data, st["mean"], st["std"], tile=(TILE, TILE),
        tta=True, batch_size=1, compute_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_eval_f = time.time() - t0
    fused_launches = {fn.__name__: fn.launches for fn in fwrappers}
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
    phase("fused", f"2 synthetic IsprsDA images {2 * TILE}^2, 8-view TTA "
          f"through fused_stages (1, 2, 3, 4): mIoU {miou_f:.5f} (unfused "
          f"{miou:.5f}) in {t_eval_f:.2f} s")
    phase("launches", f"fused path (two forwards + evaluation): "
          f"{json.dumps(fused_launches)}")
    for name, n in fused_launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the fused path")
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

    mark("stage 3")
    # 8. init_prototypes and stage 3 on the model stage 2 left: the f32 step
    #    against the CPU, then the sweep and the flagship steps with their
    #    own counts
    ssl_launches = ssl_phase(dev, ctx)

    mark("timing")
    # 9. timing (bf16, the serving and training dtype; K9 on uint8 tiles,
    #    K5-K7 on f32 probabilities), CUDA events after warm-up
    xi, xs, ws, bs, xt = inputs["bfloat16"]
    xb, dyb, mb, rb = inputs["bwd bfloat16"]
    xc, offc = inputs["crop"]
    wt_oihw = ws.permute(3, 2, 0, 1).contiguous(memory_format=CL)
    bs16 = bs.to(torch.bfloat16)
    xr = xb.detach().requires_grad_()
    yr = F.instance_norm(xr, eps=1e-5)   # the library yardstick's graph
    crop_args = (xc, offc, (TILE, TILE), st_l["mean"], st_l["std"])
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
            lambda: crop_normalize_plain(*crop_args), None),
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
        n_serve = launches.get(fn_name, 0)
        n_fused = fused_launches.get(fn_name, 0)
        n_int8 = int8_launches[fn_name]
        n_train = train_launches[fn_name]
        n_align = align_launches[fn_name]
        n_ssl = ssl_launches[fn_name]
        record.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n_serve + n_fused + n_int8 + n_train + n_align + n_ssl,
            "launches_serve": n_serve, "launches_fused": n_fused,
            "launches_int8": n_int8, "launches_train": n_train,
            "launches_align": n_align, "launches_ssl": n_ssl,
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

    with torch.no_grad():

        # serving modes in turns within this run: unfused, fused (1, 2),
        # fused (1, 2, 3, 4), unfused again, at batch 8 and 32; then the
        # int8 modes and the standard forward at batch 8
        fast_ms = {}
        serving = [("fast path", fast_bf16),
                   ("fused (1, 2)", fused[(1, 2)]),
                   ("fused (1, 2, 3, 4)", fused[(1, 2, 3, 4)]),
                   ("fast path again", fast_bf16)]
        for b in (BATCH, 32):
            xq = torch.randn(b, 3, TILE, TILE, device=dev,
                             dtype=torch.bfloat16).contiguous(memory_format=CL)
            for mode, fm in serving:
                torch.cuda.reset_peak_memory_stats()
                fast_ms[(mode, b)] = ms = cuda_ms(lambda: fm(xq), iters=5,
                                                  warmup=2)
                peak = torch.cuda.max_memory_allocated() / 2**30
                phase("time", f"{mode} bf16 batch {b}: {ms:.3f} ms/forward, "
                      f"{b / ms * 1e3:.2f} tiles/s, peak memory {peak:.2f} GiB")
        del xq
        for mode, fm in list(int8_modes.items()) + [("standard", model_bf16)]:
            fast_ms[(mode, BATCH)] = ms = cuda_ms(lambda: fm(x_flag), iters=5,
                                                  warmup=2)
            phase("time", f"{mode} bf16 batch {BATCH}: {ms:.3f} ms/forward, "
                  f"{BATCH / ms * 1e3:.2f} tiles/s")

        # where a forward's device time goes (batch 8): the unfused fast
        # path, all stages fused, and int8 calibrated on every stage
        from torch.profiler import ProfilerActivity, profile

        for mode, fm in (("fast path", fast_bf16),
                         ("fused (1, 2, 3, 4)", fused[(1, 2, 3, 4)]),
                         ("fastpath_int8cal_all",
                          int8_modes["fastpath_int8cal_all"])):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    fm(x_flag)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            rows, ops, total = profile_rows(prof, 3)
            if total <= 0:
                phase("profile", f"{mode}: device time not measured "
                      "(profiler saw none)")
                continue
            dev_ms = total / 1e3
            phase("profile", f"{mode} bf16 batch {BATCH}, 3 forwards: device "
                  f"time {dev_ms:.3f} ms/forward; idle share "
                  f"{max(0.0, 1 - dev_ms / fast_ms[(mode, BATCH)]):.3f} of "
                  f"the event-timed back-to-back forward, "
                  f"{max(0.0, 1 - total * 3 / wall_us):.3f} of the profiled "
                  f"wall {wall_us / 3e3:.3f} ms/forward; by kernel:")
            for key, t in rows[:12]:
                phase("profile", f"  {t / total * 100:5.1f}%  "
                      f"{t / 1e3:.4f} ms  {key[:150]}")
            phase("profile", "by operator (device time of the kernels each "
                  "launched itself):")
            for key, t in ops[:10]:
                phase("profile", f"  {t / total * 100:5.1f}%  "
                      f"{t / 1e3:.4f} ms  {key}")

    t_end = time.time()
    spans = [(n, (sections[i + 1][1] if i + 1 < len(sections) else t_end) - t)
             for i, (n, t) in enumerate(sections)]
    phase("done", f"{t_end - t_start:.1f} s: " + ", ".join(
        f"{n} {d:.1f} s" for n, d in spans))
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
