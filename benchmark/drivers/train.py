"""Training traffic: the program's trainer loop on seeded tile pools.

Set-up builds one train state: the model (``train/loop.build_model``) with
the benchmark's seeded weights, SGD with the stage's schedule, the
benchmark's seeded prototypes, and the stage's step (``SslStep`` or
``SrcStep`` with ``default_hparams`` of the configuration). The tile pools
stream through the program's shuffled ``infinite_batches`` (with the host
crop where the mix asks for it), its decode thread and its upload stage,
into ``run_training_loop`` at ``steps_per_call`` K: step 1 alone, then
chunks of K steps, on the card replays of the captured step. One loop
call drives everything: the first steps (which the reference follows),
the capture, ``warm_chunks`` chunks of warm-up, the measured window of
``--seconds`` (chunks until the host's clock passes it, bounded by CUDA
events on the steps' stream), and with ``--trace 1`` ``trace_chunks`` more
chunks under the profiler. The loop is ended by an exception from its
per-step hook, and its own ``finally`` releases the graph and the streams.

The traffic file's keys: ``stage`` ("ssl" or "src"), ``pool`` (tiles a
domain), ``host_crop``, ``steps_per_call``, ``warm_chunks``,
``trace_chunks``, ``follow_steps`` (the steps the reference follows).
"""

import logging
import time

import torch

from benchmark.counts import deeplab
from benchmark.drivers.common import (
    free_device,
    launch_counts,
    pair_config,
    sync,
)
from benchmark.harness import judge, make
from benchmark.harness.trace import Stretch
from benchmark.reference import model as ref_model, steps as ref_steps


class _Closed(Exception):
    """Raised from the loop's per-step hook when the run has its steps."""


class _Watched:
    """The program's step, with a look at the state before steps 2 and
    ``follow + 1``: the momentum after step 1 and the leaves after the
    followed steps. Everything else is the step's own."""

    def __init__(self, step, follow: int, prototypes: bool):
        self._step, self._follow, self._protos = step, follow, prototypes
        self.after_first = None
        self.after_follow = None

    def __getattr__(self, name):
        return getattr(self._step, name)

    def _look(self, state) -> None:
        if state.step == 1 and self.after_first is None:
            self.after_first = [t.detach().clone() for t in state.opt.trace]
        if state.step == self._follow and self.after_follow is None:
            leaves = {n: p.detach().clone()
                      for n, p in zip(state.opt.names, state.opt.params)}
            if self._protos:
                leaves["aligner.prototypes"] = \
                    state.aligner.prototypes.detach().clone()
            self.after_follow = leaves

    def prepare(self, state, batch_s, batch_t, seed, draws=None):
        self._look(state)
        return self._step.prepare(state, batch_s, batch_t, seed, draws)

    def run(self, state, batch_s, batch_t, draws):
        return self._step.run(state, batch_s, batch_t, draws)

    def __call__(self, state, batch_s, batch_t, seed, draws=None):
        self._look(state)
        return self._step(state, batch_s, batch_t, seed, draws)


def _timed(it, waits):
    """``it``'s items, each ``next`` timed into ``waits``; closes ``it``."""
    try:
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t)
            yield item
    finally:
        it.close()


def hyper(conf: dict, traffic: dict) -> ref_steps.Hyper:
    stage = traffic["stage"]
    return ref_steps.Hyper(
        stage=stage, arch=conf["arch"], num_classes=conf["num_classes"],
        crop=(conf["crop"], conf["crop"]),
        src_mean=tuple(conf["source_mean"]), src_std=tuple(conf["source_std"]),
        tgt_mean=tuple(conf["target_mean"]), tgt_std=tuple(conf["target_std"]),
        clamp_target=conf["clamp_target"], base_lr=conf["learning_rate"],
        horizon=conf["stage3_steps" if stage == "ssl" else "stage1_steps"],
        power=conf["power"], momentum=conf["momentum"],
        weight_decay=conf["weight_decay"], cutoff_top=conf["cutoff_top"],
        cutoff_low=conf["cutoff_low"])


def pools(conf: dict, traffic: dict, seed: int, device):
    """(source pool, target pool) of host arrays, made on ``device``."""
    n, hw, nc = traffic["pool"], conf["tile"], conf["num_classes"]
    ssl = traffic["stage"] == "ssl"
    src = make.pool(n, hw, nc, seed, 10, device)
    tgt = make.pool(n, hw, nc, seed, 11, device, shift=20.0, soft=ssl,
                    sup=ssl)
    del tgt["label"]
    return src, tgt


def run(ctx) -> dict:
    from uemda_tpu_torch.datasets.base import ArrayDataset, infinite_batches
    from uemda_tpu_torch.datasets.prefetch import prefetch
    from uemda_tpu_torch.train.loop import (
        build_model,
        build_state,
        default_hparams,
        run_training_loop,
    )
    from uemda_tpu_torch.train.steps import SrcStep, SslStep

    conf, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    cfg = pair_config(conf)
    hp_ref = hyper(conf, traffic)
    stage, batch = traffic["stage"], conf["batch"]
    k = int(traffic["steps_per_call"])
    follow = int(traffic["follow_steps"])
    crop = (conf["crop"], conf["crop"])
    host_crop = crop if traffic["host_crop"] else None

    spec = ref_model.param_spec(conf["arch"], conf["num_classes"])
    weights = make.weights(spec, ctx.seed, dev)
    protos = (make.prototypes(conf["num_classes"],
                              ref_model.feature_channels(conf["arch"]),
                              ctx.seed, dev) if stage == "ssl" else None)
    src_pool, tgt_pool = pools(conf, traffic, ctx.seed, dev)
    ctx.mark("made")

    model = build_model(cfg, dev)
    model.load_state_dict(weights)
    horizon = hp_ref.horizon
    state = build_state(model, cfg, horizon, prototypes=protos)
    dtype = conf["compute_dtype"]
    if stage == "ssl":
        step = SslStep(model, default_hparams(cfg, compute_dtype=dtype))
    else:
        step = SrcStep(model, default_hparams(cfg, align_domain=True,
                                              compute_dtype=dtype))
    watched = _Watched(step, follow, stage == "ssl")
    ctx.mark("model")
    meta = cfg.meta
    src_ds = ArrayDataset(meta, src_pool["image"], src_pool["label"])
    tgt_ds = ArrayDataset(meta, tgt_pool["image"], sup=tgt_pool.get("sup"),
                          prob=tgt_pool.get("prob"))
    waits_s, waits_t = [], []
    src_it = _timed(prefetch(infinite_batches(
        src_ds, batch, seed=ctx.seed, host_crop=host_crop)), waits_s)
    tgt_it = _timed(prefetch(infinite_batches(
        tgt_ds, batch, seed=ctx.seed + 1, host_crop=host_crop)), waits_t)

    warm_steps = 1 + k * int(traffic["warm_chunks"])
    losses, rec = [], {}
    stretch = Stretch() if ctx.trace and cuda else None
    trace_steps = k * int(traffic["trace_chunks"])

    def on_step(i, metrics):
        if i <= follow:
            losses.append((metrics["loss"], metrics.get("loss_domain")))
        if i != state.step:          # act at the end of a chunk
            return
        now = time.perf_counter()
        if "t0" not in rec:
            if i == 1:
                ctx.mark("first step")
            elif i == 1 + k:
                ctx.mark("capture")
            if i >= warm_steps:
                ctx.mark("warm")
                rec["t0"], rec["i0"] = now, i
                rec["ev0"] = _event(cuda)
                rec["waits0"] = (len(waits_s), len(waits_t))
            return
        if "i1" not in rec:
            if now - rec["t0"] >= ctx.seconds:
                rec["ev1"] = _event(cuda)
                rec["i1"], rec["t1"] = i, now
                rec["waits1"] = (len(waits_s), len(waits_t))
                rec["last_loss"] = metrics["loss"]
                if stretch is None:
                    raise _Closed
                stretch.start()
                rec["launch0"], rec["s0"] = launch_counts(), i
            return
        if i - rec["s0"] >= trace_steps:
            stretch.stop()
            rec["launch1"], rec["s1"] = launch_counts(), i
            raise _Closed

    logger = logging.getLogger("benchmark.train")
    logger.setLevel(logging.WARNING)
    huge = 10 ** 9
    try:
        run_training_loop(state, watched, src_it, tgt_it, huge, logger,
                          eval_every=huge, log_every=huge, seed=ctx.seed,
                          on_step=on_step, steps_per_call=k)
    except _Closed:
        pass
    finally:
        src_it.close()
        tgt_it.close()
    sync(dev)
    ctx.after_window()
    if "i1" not in rec:
        raise RuntimeError("the loop ended before the window closed")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    steps = rec["i1"] - rec["i0"]
    window_s = (rec["ev0"].elapsed_time(rec["ev1"]) / 1e3 if cuda
                else rec["t1"] - rec["t0"])
    imgs = 2 * batch * steps
    step_flops = 2 * batch * deeplab.train_flops(conf["arch"],
                                                 conf["num_classes"], crop)
    w0, w1 = rec["waits0"], rec["waits1"]
    wait_ms = (sum(waits_s[w0[0]:w1[0]]) + sum(waits_t[w0[1]:w1[1]])) \
        * 1e3 / max(steps, 1)
    last_loss = float(rec["last_loss"])
    prog = {"losses": [float(v) for v, _ in losses[:follow]],
            "coral": [float(d) for _, d in losses[:follow] if d is not None],
            "grad": {n: t - hp_ref.weight_decay * weights[n]
                     for n, t in zip(state.opt.names, watched.after_first)},
            "change": {n: v - (protos if n == "aligner.prototypes"
                               else weights[n])
                       for n, v in watched.after_follow.items()}}
    out = {
        "setup_s": rec["t0"] - ctx.t_start,
        "window_s": window_s, "attempted": steps, "failed": 0,
        "memory_peak_bytes": peak,
        "e2e": {"train_img_per_s": imgs / window_s},
        "layer": {"data_wait_ms": wait_ms, "steps": steps,
                  "step_flops": step_flops, "window_s": window_s},
        "last_loss": last_loss,
    }
    if stretch is not None:
        out["stretch"] = stretch.summary()
        out["stretch_launches"] = {
            n: rec["launch1"][n] - rec["launch0"][n] for n in rec["launch0"]}
        out["stretch_work"] = rec["s1"] - rec["s0"]
        out["kernel_calls"] = _kernel_calls(conf, traffic)
    del watched, step, state, model, src_it, tgt_it
    free_device()
    out["readings"], out["extra"] = _judge(
        ctx, hp_ref, weights, protos, (src_pool, tgt_pool), prog, host_crop)
    return out


def _event(cuda):
    if not cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _kernel_calls(conf, traffic):
    """{kernel: (shapes of one launch)} of a step of this mix: the
    operations and bytes ``counts/kernels.py`` gives each launch."""
    b, c, nc = conf["batch"], conf["crop"], conf["num_classes"]
    f = -(-c // 16)
    k = ref_model.feature_channels(conf["arch"])
    calls = {"k1": (b, k, f, f), "k1_bwd": (b, k, f, f), "k9": (b, c, c)}
    if traffic["stage"] == "ssl":
        n, s = c * c, (max(conf["tile"], c) // 16) ** 2 + 32
        calls.update({"k5": (b, n, nc, s), "k7": (b, n, nc, s),
                      "k8": (b, nc, c, c)})
    return calls


def _judge(ctx, hp, weights, protos, pools_, prog, host_crop):
    """The reference's readings of the program's first steps and, when
    calibrating, of the control (the reference in fp8) and of the
    half-batch fault."""
    dev = torch.device(ctx.device)
    follow = len(prog["losses"])
    kw = dict(seed=ctx.seed, steps=follow, batch=ctx.config["batch"],
              host_crop=host_crop, device=dev)
    with ref_model.full_f32():
        ref = ref_steps.follow(hp, weights, protos, pools_, **kw)
        readings = judge.training_readings(prog, ref)
        extra = {}
        if ctx.calibrate:
            extra["leaves"] = judge.worst_leaves(prog, ref)
            for name, opts in (("control", {"quant": "fp8"}),
                               ("half_batch", {"half": True}),
                               ("bf16_reference", {"quant": "bf16"})):
                got = ref_steps.follow(hp, weights, protos, pools_, **kw,
                                       **opts)
                other = {"losses": [r["loss"] for r in got],
                         "coral": [r["loss_domain"] for r in got
                                   if "loss_domain" in r],
                         "grad": got[0]["grad"], "change": got[-1]["change"]}
                extra[name] = judge.training_readings(other, ref)
                del got, other
    return readings, extra
