"""``--host-crop`` off against on, for the same stage-1 step in one process.

Twin of ``tools/hostcrop_ab.py``::

    python -m uemda_tpu_torch.tools.hostcrop_ab \\
        [--config-path uemda_tpu_torch/runs/loveda_synth_config.py] \\
        [--steps 30 --warmup 5 --pairs 2] [--device cpu]

The same ``make_src_step`` (CORAL on) runs arm after arm, off then on, for
``--pairs`` pairs: off ships whole tiles and the device crop (K9) cuts the
windows; on crops on the host first (``datasets/base.py:
_host_crop_batch``) and K9 only normalizes. Each arm starts from a copy of
the same random init (seed 0) and a fresh train state, with its own source
and target streams (``train/loop.py: make_source_iter``,
``make_target_iter``) behind the upload stage the training loop uses, and
closes their threads when done. A step's time is wall time with the loss
read back every step (``.item()``): the loop's K=1 regime the JAX tool
measures, not a CUDA graph. Prints one JSON line with the JAX tool's keys.
"""

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.prefetch import upload_batches
from uemda_tpu_torch.train.loop import (
    build_model,
    build_state,
    default_hparams,
    make_source_iter,
    make_target_iter,
)
from uemda_tpu_torch.train.steps import make_src_step
from uemda_tpu_torch.utils.runtime import resolve_device

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "runs", "loveda_synth_config.py")


def measure_arm(model0, cfg, hp, src_iter, tgt_iter, steps: int,
                warmup: int):
    """ms a step over ``steps`` steps after ``warmup``, on a copy of
    ``model0`` and a fresh state, reading the loss back each step; returns
    (ms, the losses of every step). Closes both streams. Every step takes
    seed 0, as every JAX step takes ``jax.random.key(0)``."""
    dev = next(model0.parameters()).device
    model = copy.deepcopy(model0)
    state = build_state(model, cfg, 1000)
    step = make_src_step(model, hp)
    src, tgt = upload_batches(src_iter, dev), upload_batches(tgt_iter, dev)
    losses = []
    try:
        for _ in range(warmup):
            losses.append(step(state, next(src), next(tgt), 0)["loss"]
                          .item())
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(step(state, next(src), next(tgt), 0)["loss"]
                          .item())
        ms = (time.perf_counter() - t0) / steps * 1e3
    finally:
        for it in (src, tgt, src_iter, tgt_iter):
            it.close()
    return ms, losses


def run_ab(model0, cfg, make_iters, steps: int = 30, warmup: int = 5,
           pairs: int = 2):
    """The A/B: ``make_iters(host_crop)`` gives an arm's (source, target)
    streams (``host_crop`` None, then ``cfg.crop``). Returns the JAX tool's
    record and {'off': [losses of each arm], 'on': [...]}."""
    dev = next(model0.parameters()).device
    hp = default_hparams(cfg, align_domain=True, compute_dtype=(
        "bfloat16" if dev.type == "cuda" else "float32"))
    rows, losses = [], {"off": [], "on": []}
    for _ in range(pairs):
        row = {}
        for arm, crop in (("off", None), ("on", tuple(cfg.crop))):
            ms, ls = measure_arm(model0, cfg, hp, *make_iters(crop), steps,
                                 warmup)
            row[f"{arm}_ms"] = round(ms, 2)
            losses[arm].append(ls)
        rows.append(row)
    mean_off = float(np.mean([r["off_ms"] for r in rows]))
    mean_on = float(np.mean([r["on_ms"] for r in rows]))
    return {
        "config": cfg.name,
        "crop": list(cfg.crop),
        "batch": cfg.source.batch_size,
        "steps_per_arm": steps,
        "pairs": rows,
        "mean_off_ms": round(mean_off, 2),
        "mean_on_ms": round(mean_on, 2),
        "speedup": round(mean_off / mean_on, 3),
    }, losses


def main(argv=None):
    parser = argparse.ArgumentParser(description="host-crop on/off A/B")
    parser.add_argument("--config-path", type=str, default=DEFAULT_CONFIG)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config_path)
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(0))

    def make_iters(host_crop):
        return (make_source_iter(cfg, host_crop=host_crop)[0],
                make_target_iter(cfg, host_crop=host_crop)[0])

    record, _ = run_ab(model, cfg, make_iters, args.steps, args.warmup,
                       args.pairs)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
