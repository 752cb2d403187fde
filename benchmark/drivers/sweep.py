"""Pseudo-label sweep traffic: stage 3's sweep of target tiles, as
``infer/pseudo_gen._generate_pseudo_labels_local`` runs it.

Set-up makes the model with the benchmark's seeded weights and its
eval-mode bf16 copy, as the sweep does. The tiles of a seeded pool, cycled,
stream through the program's ``predict_batches`` (decode and upload
threads, the padded batch, slide windows at half overlap with 8-view TTA,
one captured predictor whose epilogue casts the probabilities to fp16 HWC)
and come back through ``HostReadback``, one batch late. The window opens at
the hand-over of the ``warm``-th batch and counts the tiles handed over
from then until the first hand-over past ``--seconds``; ``--trace 1`` then
profiles ``trace_batches`` more.

The traffic file's keys: ``pool``, ``batch``, ``tta``, ``warm``,
``trace_batches``, ``sample`` (tiles the reference checks) and
``sample_span`` (the window's first tiles they are drawn from).
"""

import copy
import time

import numpy as np
import torch

from benchmark.counts import deeplab
from benchmark.drivers.common import (
    free_device,
    launch_counts,
    pair_config,
    serve_check,
    sync,
)
from benchmark.harness import make
from benchmark.harness.trace import Stretch
from benchmark.reference import model as ref_model


class Cycled:
    """The pool as an endless split: sample i is tile i mod n."""

    def __init__(self, meta, images: np.ndarray, length: int):
        self.meta, self.images, self.length = meta, images, length

    def __len__(self):
        return self.length

    def filename(self, idx: int) -> str:
        return f"tile_{idx:07d}.png"

    def item(self, idx: int):
        return {"image": self.images[idx % len(self.images)]}

    def batch(self, indices):
        idx = np.asarray(indices, np.int64) % len(self.images)
        return {"image": self.images[idx]}


def run(ctx) -> dict:
    from uemda_tpu_torch.datasets.prefetch import HostReadback
    from uemda_tpu_torch.infer.evaluate import predict_batches
    from uemda_tpu_torch.infer.slide import window_grid
    from uemda_tpu_torch.train.loop import build_model

    conf, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    cfg = pair_config(conf)
    tile = (conf["crop"], conf["crop"])
    hw = (conf["tile"], conf["tile"])
    dtype = ctx.compute_dtype
    bsz = int(traffic["batch"])
    tta = bool(traffic["tta"])
    spec = ref_model.param_spec(conf["arch"], conf["num_classes"])
    weights = make.weights(spec, ctx.seed, dev)
    pool = make.pool(traffic["pool"], conf["tile"], conf["num_classes"],
                     ctx.seed, 30, dev)["image"]
    ctx.mark("made")
    model = build_model(cfg, dev)
    model.load_state_dict(weights)
    net = copy.deepcopy(model).eval().to(dtype)
    del model
    ctx.mark("model")
    ds = Cycled(cfg.meta, pool, 1 << 30)
    mean, std = cfg.target.mean, cfg.target.std

    def epilogue(probs):
        return probs.to(torch.float16).permute(0, 2, 3, 1).contiguous(), None

    rng = np.random.default_rng(ctx.seed + 7)
    wanted = set(int(j) for j in rng.choice(
        int(traffic["sample_span"]), int(traffic["sample"]), replace=False))
    warm = int(traffic["warm"])
    stretch = Stretch() if ctx.trace and cuda else None
    rec = {"handed": 0, "kept": [], "waits": []}
    readback = HostReadback()

    def take(item, now):
        if item is None:
            return
        indices, arrays = item
        rec["handed"] += 1
        if rec["handed"] == 1:
            ctx.mark("first batch")
        if "t0" in rec and "t1" not in rec:
            for j, idx in enumerate(indices):
                ordinal = rec["tiles"]
                rec["tiles"] += 1
                if ordinal in wanted:
                    rec["kept"].append((idx % len(pool),
                                        arrays["prob"][j].copy()))
            rec["t_last"] = now
        if rec["handed"] == warm and "t0" not in rec:
            ctx.mark("warm")
            rec["t0"], rec["t_last"], rec["tiles"] = now, now, 0
            rec["w0"] = len(rec["waits"])

    gen = predict_batches(net, ds, mean, std, tile, tta, bsz, dtype, dev,
                          epilogue=epilogue)
    try:
        while True:
            t = time.perf_counter()
            indices, n, _, (p16, _) = next(gen)
            rec["waits"].append(time.perf_counter() - t)
            item = readback.push(indices, {"prob": p16[:n]})
            take(item, time.perf_counter())
            if "t0" in rec and "t1" not in rec \
                    and rec["t_last"] - rec["t0"] >= ctx.seconds:
                rec["t1"], rec["w1"] = rec["t_last"], len(rec["waits"])
                ctx.after_window()
                if stretch is None:
                    break
                stretch.start()
                rec["l0"], rec["s0"] = launch_counts(), rec["handed"]
            elif "t1" in rec and rec["handed"] - rec["s0"] \
                    >= int(traffic["trace_batches"]):
                stretch.stop()
                rec["l1"] = launch_counts()
                break
    finally:
        readback.flush()
        gen.close()
    sync(dev)
    window_s = rec["t1"] - rec["t0"]
    tiles = rec["tiles"]
    n_win = len(window_grid(hw, tile))
    views = tiles * n_win * (8 if tta else 1)
    out = {"setup_s": rec["t0"] - ctx.t_start, "window_s": window_s,
           "attempted": tiles, "failed": 0,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    out["e2e"] = {"serve_mpix_per_s": tiles * hw[0] * hw[1] / 1e6 / window_s}
    batches = rec["w1"] - rec["w0"]
    out["layer"] = {
        "batch_wait_ms": sum(rec["waits"][rec["w0"]:rec["w1"]]) * 1e3
        / max(batches, 1),
        "views": views, "window_s": window_s,
        "view_flops": deeplab.forward_flops(conf["arch"], conf["num_classes"],
                                            tile)}
    if stretch is not None:
        out["stretch"] = stretch.summary()
        out["stretch_launches"] = {k: rec["l1"][k] - rec["l0"][k]
                                   for k in rec["l0"]}
        out["stretch_work"] = int(traffic["trace_batches"])
        f = -(-tile[0] // 16)
        nv = bsz * n_win * (8 if tta else 1)
        out["kernel_calls"] = {
            "k1": (nv, ref_model.feature_channels(conf["arch"]), f, f),
            "k3": (nv, 2, conf["num_classes"], f, f, tile[0], tile[1])}
    del net, gen
    free_device()
    out["readings"], out["extra"] = _judge(ctx, weights, pool, rec["kept"],
                                           mean, std, tile, tta)
    return out


def _judge(ctx, weights, pool, kept, mean, std, tile, tta):
    """The widest difference of the served probabilities from the
    reference's, over the sampled tiles; when calibrating, the control's."""
    if not kept:
        raise RuntimeError("no sampled tile came back inside the window")
    return serve_check(ctx, weights, pool, kept, mean, std, tile, tta,
                       labels=False)
