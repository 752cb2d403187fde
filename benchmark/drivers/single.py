"""Single-tile serving traffic: ``infer_single``'s path, one client
offering requests at a fixed rate (an open loop).

Set-up makes the model with the benchmark's seeded weights, the serving
callable the CLI's flags pick (``infer/quant.serving_model``: the folded
fast path with ``fastpath``), and ``make_predictor`` for one tile with
8-view TTA in bf16, captured on its first call. A request is one uint8 tile
of the seeded pool, in a seeded order: uploaded, normalized with the eval
split's statistics, predicted, its argmax taken as uint8 labels and read
back to the host, as ``tools/infer_single.py`` does. After ``warm``
requests back to back, the window offers ``rate`` requests a second, one
client issuing each at its due time (an open loop; a request that starts
late has waited, and its latency counts from its due time) until the
host's clock passes ``--seconds``; each is timed to its labels on the
host, and CUDA events around the predictor's call time its replay on the
device. The first request captures the predictor's graph. ``--trace 1``
then profiles ``trace_requests`` more, back to back.

The traffic file's keys: ``pool``, ``tta``, ``fastpath``, ``warm``,
``rate``, ``trace_requests``, ``sample`` (requests the reference checks)
and ``sample_span`` (the window's first requests they are drawn from).
"""

import time

import numpy as np
import torch

from benchmark.counts import deeplab
from benchmark.drivers.common import (
    free_device,
    pair_config,
    serve_check,
    sync,
)
from benchmark.harness import make
from benchmark.harness.trace import Stretch
from benchmark.reference import model as ref_model


def _p95(values):
    v = sorted(values)
    return v[min(len(v) - 1, int(np.ceil(0.95 * len(v))) - 1)]


def run(ctx) -> dict:
    from uemda_tpu_torch.datasets.augment import normalize
    from uemda_tpu_torch.infer.quant import serving_model
    from uemda_tpu_torch.infer.slide import make_predictor, window_grid
    from uemda_tpu_torch.train.loop import build_model

    conf, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    cfg = pair_config(conf)
    tile = (conf["crop"], conf["crop"])
    hw = (conf["tile"], conf["tile"])
    dtype = ctx.compute_dtype
    spec = ref_model.param_spec(conf["arch"], conf["num_classes"])
    weights = make.weights(spec, ctx.seed, dev)
    pool = make.pool(traffic["pool"], conf["tile"], conf["num_classes"],
                     ctx.seed, 20, dev)["image"]
    order = np.random.default_rng(ctx.seed).integers(0, len(pool), 1 << 20)
    ctx.mark("made")
    model = build_model(cfg, dev)
    model.load_state_dict(weights)
    net = serving_model(model, bool(traffic["fastpath"]), False, dtype)
    mean, std = cfg.val.mean, cfg.val.std
    predictor = make_predictor(net, tile, hw, tta=bool(traffic["tta"]),
                               compute_dtype=dtype)
    ev_a = torch.cuda.Event(enable_timing=True) if cuda else None
    ev_b = torch.cuda.Event(enable_timing=True) if cuda else None

    def request(i, t=None):
        """Request ``i``, issued now; returns its labels, its latency from
        ``t`` (its due time; now if None) and its replay's device time."""
        t = time.perf_counter() if t is None else t
        img = pool[order[i]]
        x = normalize(torch.from_numpy(np.array(img[None])).to(dev)
                      .permute(0, 3, 1, 2), mean, std)
        if cuda:
            ev_a.record()
        probs = predictor(x)
        if cuda:
            ev_b.record()
        pred = probs.argmax(dim=1)[0].to(torch.uint8).cpu().numpy()
        lat = time.perf_counter() - t
        dev_s = ev_a.elapsed_time(ev_b) / 1e3 if cuda else 0.0
        return pred, lat, dev_s

    ctx.mark("model")
    request(0)
    ctx.mark("capture")
    i = 1
    for _ in range(int(traffic["warm"]) - 1):
        request(i)
        i += 1
    sync(dev)
    ctx.mark("warm")
    # the answers the reference checks: a seeded sample of the window's
    # first sample_span requests, the only ones kept
    picks = set(np.random.default_rng(ctx.seed + 7).choice(
        int(traffic["sample_span"]), int(traffic["sample"]), replace=False)
        .tolist())
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    kept, lats, devs, served = [], [], [], []
    rate = float(traffic["rate"])
    while True:
        # open loop: request k is due at t0 + k / rate; one that starts
        # late waits in the latency it reports. The client spins to its
        # due time: a sleeping thread wakes up late by more than the host
        # work of a request varies
        due = t0 + len(lats) / rate
        while time.perf_counter() < due:
            pass
        start = time.perf_counter()
        pred, lat, dev_s = request(i, due)
        if len(lats) in picks:
            kept.append((int(order[i]), pred))
        i += 1
        lats.append(lat)
        devs.append(dev_s)
        served.append(time.perf_counter() - start)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    ctx.after_window()
    n = len(lats)
    out = {"setup_s": setup_s, "window_s": window_s, "attempted": n,
           "failed": 0,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    mpix = hw[0] * hw[1] / 1e6
    views = len(window_grid(hw, tile)) * (8 if traffic["tta"] else 1)
    out["e2e"] = {"serve_mpix_per_s": n * mpix / window_s,
                  "serve_p95_ms": _p95(lats) * 1e3}
    out["layer"] = {
        "host_ms": (sum(served) - sum(devs)) / n * 1e3,
        "late_ms": (sum(lats) - sum(served)) / n * 1e3,
        "device_ms": sum(devs) / n * 1e3,
        "request_flops": views * deeplab.forward_flops(
            conf["arch"], conf["num_classes"], tile)}
    if ctx.trace and cuda:
        from benchmark.drivers.common import launch_counts

        st = Stretch()
        st.start()
        l0 = launch_counts()
        m = int(traffic["trace_requests"])
        for _ in range(m):
            request(i)
            i += 1
        st.stop()
        l1 = launch_counts()
        out["stretch"] = st.summary()
        out["stretch_launches"] = {k: l1[k] - l0[k] for k in l0}
        out["stretch_work"] = m
        f = -(-tile[0] // 16)
        k_ch = ref_model.feature_channels(conf["arch"])
        out["kernel_calls"] = {
            "k1": (views, k_ch, f, f),
            "k3": (views, 2, conf["num_classes"], f, f, tile[0], tile[1])}
        if traffic["fastpath"]:
            out["kernel_calls"]["k2"] = (views, tile[0], tile[1])
    predictor.close()
    del predictor, net, model
    free_device()
    if not kept:
        raise RuntimeError("no sampled request was served in the window")
    out["readings"], out["extra"] = _judge(ctx, weights, pool, kept, cfg,
                                           tile, bool(traffic["tta"]))
    return out


def _judge(ctx, weights, pool, served, cfg, tile, tta):
    """The widest gap of a served label below the reference's best, over
    the sampled requests; when calibrating, the control's."""
    return serve_check(ctx, weights, pool, served, cfg.val.mean, cfg.val.std,
                       tile, tta, labels=True)
