#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``uemda_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``uemda_tpu_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes of the two main
paths, and drives both (flagship ResNet-50 OS16 dual-PPM model, random
weights from a seed):

* serving: the standard eval forward, the fused-stem fast path and slide +
  8-view TTA evaluation;
* stage-1 training (``[train]``): one f32 step on the card against the same
  step on the CPU, then 30 bf16 steps with CORAL at the 2urban geometry
  (synthetic 1024^2 LoveDA tiles cropped to 512^2 by the K9 kernel, batch 8)
  through ``run_training_loop``, ending in an evaluation.

It times kernels, forwards and steps with CUDA events, profiles both paths,
and prints one line per phase. Any failed check prints FAIL and exits
nonzero. The second-to-last line is the kernels' JSON record; the last line
is ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

import copy
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


def train_phase(dev):
    """The stage-1 training path. (a) One f32 step on the card against the
    same step on the CPU's plain path. (b) The flagship run through
    ``run_training_loop``, every launch count set to 0 just before it and
    read just after; returns those counts."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uemda_tpu_torch.config import PRESETS
    from uemda_tpu_torch.datasets.base import infinite_batches
    from uemda_tpu_torch.datasets.meta import LoveDA
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.ops.crop import crop_normalize
    from uemda_tpu_torch.ops.insnorm import instance_norm, instance_norm_backward
    from uemda_tpu_torch.ops.stem import stem_pool
    from uemda_tpu_torch.ops.tail import tail_upsample_softmax_mean
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
    tgt = synthetic_split(LoveDA, n=2 * batch, hw=2 * TILE, seed=4,
                          domain_shift=20.0)
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
    wrappers = (instance_norm, instance_norm_backward, crop_normalize,
                stem_pool, tail_upsample_softmax_mean)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.time()
    best = run_training_loop(state, step_fn, src_it, tgt_it, steps, logger,
                             eval_every=steps, log_every=10, eval_fn=eval_fn,
                             seed=2333, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {fn.__name__: fn.launches for fn in wrappers}
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

    # where a step's device time goes: 3 more steps under the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step_fn(state, batch_to_device(next(src_it), dev),
                    batch_to_device(next(tgt_it), dev), 2333)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    rows, ops, total_us = profile_rows(prof, 3)
    if total_us > 0:
        phase("profile", f"stage-1 step (bf16, batch {batch}, CORAL), 3 "
              f"steps: device time {total_us / 1e3:.3f} ms/step; idle share "
              f"{max(0.0, 1 - total_us / 1e3 / ms_step):.3f} of the "
              f"event-timed step, {max(0.0, 1 - total_us / 1e3 / wall_ms):.3f}"
              f" of the profiled wall {wall_ms:.3f} ms/step; by kernel:")
        for key, t in rows[:15]:
            phase("profile", f"  {t / total_us * 100:5.1f}%  {t / 1e3:.4f} ms"
                  f"  {key[:150]}")
        phase("profile", "by operator (device time of the kernels each "
              "launched itself), per step:")
        for key, t in ops[:15]:
            phase("profile", f"  {t / total_us * 100:5.1f}%  {t / 1e3:.4f} ms"
                  f"  {key}")
        host = sorted(((e.key, e.self_cpu_time_total / 3, e.count / 3)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda r: -r[1])
        phase("profile", f"host: {sum(t for _, t, _ in host) / 1e3:.3f} ms of "
              f"self CPU time per step under the profiler, in "
              f"{sum(c for _, _, c in host):.0f} operator calls; largest:")
        for key, t, c in host[:10]:
            phase("profile", f"  {t / 1e3:.4f} ms  {c:.0f} calls  {key}")
    else:
        phase("profile", "stage-1 device time not measured (profiler saw none)")
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
    from uemda_tpu_torch.datasets.synthetic import synthetic_split
    from uemda_tpu_torch.infer.evaluate import evaluate_dataset
    from uemda_tpu_torch.infer.fastpath import build_fastpath, make_serving_fn
    from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
    from uemda_tpu_torch.ops.crop import crop_normalize, crop_normalize_plain
    from uemda_tpu_torch.ops.insnorm import (
        instance_norm,
        instance_norm_backward,
        instance_norm_backward_plain,
        instance_norm_forward_plain,
        instance_norm_plain,
    )
    from uemda_tpu_torch.ops.stem import stem_pool, stem_pool_plain
    from uemda_tpu_torch.ops.tail import (
        tail_upsample_softmax_mean,
        tail_upsample_softmax_mean_plain,
    )

    t_start = time.time()
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

    # K1 backward against its plain version on the same (x, dy) and the
    # plain f32 statistics: the flagship's (8, 2048, 32, 32) -- bf16 through
    # the shared-memory slabs, f32 through the global-memory route -- and an
    # odd (3, 96, 20, 28), and bf16 at 64x64 (global route too)
    bwd_cases = {"flagship": (BATCH, 2048, TILE // 16, TILE // 16),
                 "odd": (3, 96, 20, 28), "64x64": (2, 64, 64, 64)}
    bwd_tol = {"float32": 1e-5, "bfloat16": 1e-2}  # test_pallas_insnorm.py
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
                if dn == "bfloat16":
                    inputs["bwd"] = (xb, dyb, mb, rb)
            phase("kernel", f"instance_norm_backward {dn} {shape}: max abs err "
                  f"{e:.3g} (atol {t}, rtol {t})")

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
        p_f32 = build_fastpath(model, dtype=torch.float32)(x_flag.float())

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

    # 6. the stage-1 training path: the f32 step against the CPU, then the
    #    flagship bf16 run with its own launch counts
    train_launches = train_phase(dev)

    # 7. timing (bf16, the serving and training dtype; K9 on uint8 tiles),
    #    CUDA events after warm-up
    xi, xs, ws, bs, xt = inputs["bfloat16"]
    xb, dyb, mb, rb = inputs["bwd"]
    xc, offc = inputs["crop"]
    wt_oihw = ws.permute(3, 2, 0, 1).contiguous(memory_format=CL)
    bs16 = bs.to(torch.bfloat16)
    xr = xb.detach().requires_grad_()
    yr = F.instance_norm(xr, eps=1e-5)   # the library yardstick's graph
    crop_args = (xc, offc, (TILE, TILE), st_l["mean"], st_l["std"])
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
        "instance_norm_backward": (
            lambda: instance_norm_backward(xb, dyb, mb, rb),
            lambda: instance_norm_backward_plain(xb, dyb, mb, rb),
            lambda: torch.autograd.grad(yr, xr, dyb, retain_graph=True)),
        "crop_normalize": (
            lambda: crop_normalize(*crop_args),
            lambda: crop_normalize_plain(*crop_args), None),
    }
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
    }
    meta = {
        "instance_norm": ("uemda_tpu_torch/kernels/csrc/insnorm.cu",
                          "uemda_tpu/ops/pallas_insnorm.py:32", "instance_norm"),
        "stem_pool": ("uemda_tpu_torch/kernels/csrc/stem.cu",
                      "uemda_tpu/ops/pallas_stem.py:184", "stem_pool"),
        "tail": ("uemda_tpu_torch/kernels/csrc/tail.cu",
                 "uemda_tpu/ops/pallas_tail.py:57",
                 "tail_upsample_softmax_mean"),
        "instance_norm_backward": (
            "uemda_tpu_torch/kernels/csrc/insnorm.cu",
            "uemda_tpu/ops/pallas_insnorm.py:32 (backward of)",
            "instance_norm_backward"),
        "crop_normalize": ("uemda_tpu_torch/kernels/csrc/crop.cu",
                           "uemda_tpu/ops/pallas_kernels.py:335",
                           "crop_normalize"),
    }
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
        dn = "uint8" if name == "crop_normalize" else "bfloat16"
        n_serve = launches.get(fn_name, 0)
        n_train = train_launches[fn_name]
        record.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n_serve + n_train, "launches_serve": n_serve,
            "launches_train": n_train,
            "max_abs_err": errs[(name, dn)], "ms": ms,
            "ms_with_host": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        phase("time", f"{name} {dn}: kernel {ms:.4f} ms ({host_ms:.4f} ms "
              f"back to back with its wrapper's host work), plain "
              f"{plain_ms:.4f} ms, library {lib_txt}, bound "
              f"{bound:.4f} ms ({record[-1]['bound_by']}; {nbytes} B, "
              f"{nops} op)")
    with torch.no_grad():

        fast_ms = {}
        for b in (8, 16, 32):
            xq = torch.randn(b, 3, TILE, TILE, device=dev,
                             dtype=torch.bfloat16).contiguous(memory_format=CL)
            torch.cuda.reset_peak_memory_stats()
            fast_ms[b] = ms = cuda_ms(lambda: fast_bf16(xq), iters=5, warmup=2)
            peak = torch.cuda.max_memory_allocated() / 2**30
            phase("time", f"fast path bf16 batch {b}: {ms:.3f} ms/forward, "
                  f"{b / ms * 1e3:.2f} tiles/s, peak memory {peak:.2f} GiB")
        ms = cuda_ms(lambda: model_bf16(x_flag), iters=5, warmup=2)
        phase("time", f"standard bf16 batch {BATCH}: {ms:.3f} ms/forward, "
              f"{BATCH / ms * 1e3:.2f} tiles/s")

        # where the fast-path forward's device time goes (batch 8)
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                fast_bf16(x_flag)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        rows = [(e.key, e.self_device_time_total) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        ops = [(e.key, e.self_device_time_total) for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.self_device_time_total > 0]
        total = sum(t for _, t in rows)
        if total > 0:
            rows.sort(key=lambda r: -r[1])
            ops.sort(key=lambda r: -r[1])
            dev_ms = total / 3e3
            phase("profile", f"fast path bf16 batch {BATCH}, 3 forwards: "
                  f"device time {dev_ms:.3f} ms/forward; idle share "
                  f"{max(0.0, 1 - dev_ms / fast_ms[BATCH]):.3f} of the "
                  f"event-timed back-to-back forward, "
                  f"{max(0.0, 1 - total / wall_us):.3f} of the profiled wall "
                  f"{wall_us / 3e3:.3f} ms/forward; by kernel:")
            for key, t in rows[:12]:
                phase("profile", f"  {t / total * 100:5.1f}%  "
                      f"{t / 3e3:.4f} ms  {key[:150]}")
            phase("profile", "by operator (device time of the kernels each "
                  "launched itself):")
            for key, t in ops[:10]:
                phase("profile", f"  {t / total * 100:5.1f}%  "
                      f"{t / 3e3:.4f} ms  {key}")
        else:
            phase("profile", "device time not measured (profiler saw none)")

    phase("done", f"{time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
