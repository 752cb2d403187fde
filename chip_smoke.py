#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``uemda_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``uemda_tpu_torch/kernels/csrc``,
holds each against its plain PyTorch version at the serving shapes, drives
the serving path (flagship ResNet-50 OS16 dual-PPM model, random weights
from a seed) through the standard eval forward, the fused-stem fast path and
slide + 8-view TTA evaluation, times kernels and forwards with CUDA events,
and prints one line per phase. Any failed phase exits nonzero. The
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

import copy
import json
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
    """Mean device time of fn() in ms over ``iters`` back-to-back calls."""
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
    from uemda_tpu_torch.ops.insnorm import instance_norm, instance_norm_plain
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

    # 6. timing (bf16, the serving dtype), CUDA events after warm-up -----
    xi, xs, ws, bs, xt = inputs["bfloat16"]
    wt_oihw = ws.permute(3, 2, 0, 1).contiguous(memory_format=CL)
    bs16 = bs.to(torch.bfloat16)
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
    }
    # bytes each function must move (inputs read once, outputs written once)
    # and the operations it does, from this run's shapes, each with the peak
    # rate of its type: the stem conv's multiply-adds could run on the bf16
    # tensor cores; instance norm's and the tail's elementwise f32 work
    # (per element 6 ops; per pixel and logit 3 lerps = 9, softmax 4, mean
    # 1) runs outside them
    el = 2  # bf16
    n_in, n_st_in = xi.numel(), xs.numel() + ws.numel()
    n_st_out = BATCH * 64 * (TILE // 4) ** 2
    n_px = BATCH * TILE * TILE
    work = {
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
    }
    record = []
    with torch.no_grad():
        for name, (k_fn, plain_fn, lib_fn) in timed.items():
            ms = cuda_ms(k_fn)
            plain_ms = cuda_ms(plain_fn)
            lib_ms = cuda_ms(lib_fn)
            nbytes, nops, peak = work[name]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / peak * 1e3
            bound = max(t_bytes, t_ops)
            src, rep, fn_name = meta[name]
            record.append({
                "name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[fn_name],
                "max_abs_err": errs[(name, "bfloat16")], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms,
            })
            phase("time", f"{name} bf16: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({record[-1]['bound_by']}; {nbytes} B, "
                  f"{nops} op)")

        fast_ms = {}
        for b in (8, 16, 32):
            xb = torch.randn(b, 3, TILE, TILE, device=dev,
                             dtype=torch.bfloat16).contiguous(memory_format=CL)
            torch.cuda.reset_peak_memory_stats()
            fast_ms[b] = ms = cuda_ms(lambda: fast_bf16(xb), iters=5, warmup=2)
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
