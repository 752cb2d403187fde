"""The data-parallel cases of ``tests/test_torch_parallel.py``, shared by the
2-rank gloo workers (``tests/torch_parallel_worker.py``) and the 1-rank
reference the test runs in its own process. Each case computes on this
rank's rows of one global batch (``parallel/mesh.py``) and returns what
the test compares: the metrics of every step, the state after the steps,
values, and the gradients of this rank's rows. Imports no JAX."""

import dataclasses
import hashlib
import os

import numpy as np
import torch

from uemda_tpu_torch.config import PRESETS
from uemda_tpu_torch.datasets.synthetic import grid_superpixels
from uemda_tpu_torch.parallel import mesh

GB, HW, CROP, C, K = 4, 72, 64, 6, 512
NORM = dict(src_mean=(128.0,) * 3, src_std=(64.0,) * 3,
            tgt_mean=(120.0,) * 3, tgt_std=(60.0,) * 3)
BASE = dict(class_num=C, crop=(CROP, CROP), compute_dtype="float32",
            max_segments=64, **NORM)
SSL = dict(BASE, refine=True, refine_mode="all", target_loss="uvem",
           balance_target=True, clamp_target=True)

# name -> (step kind, hparams, extra)
STEP_CASES = {
    "src": ("src", dict(BASE, align_domain=True, balance_source=True), {}),
    "align": ("align", dict(BASE, align_domain=True, refine=True,
                            refine_mode="all"), {}),
    "ssl": ("ssl", SSL, {}),
    "ssl_ohem_ghm": ("ssl", dict(SSL, source_loss="ohem", target_loss="ghm"),
                     {}),
    "mix": ("mix", dict(SSL, balance_source=True), {"mix": "classmix",
                                                    "combo": True}),
    "adv": ("adv", dict(BASE, balance_source=True), {}),
    "dca": ("dca", dict(BASE, balance_source=True, clamp_target=True), {}),
    "init_proto": ("init_proto", BASE, {}),
}


def global_batches(seed: int):
    """One global batch of each domain (numpy): source tiles with blocky
    labels, target tiles with grid superpixels and stored soft labels
    whose confidence varies by block (as ``test_torch_ssl_step.py``'s)."""
    r = np.random.default_rng(seed)
    label = np.kron(r.integers(0, C, (GB, 3, 3)),
                    np.ones((32, 32), np.int64))[:, :HW, :HW].astype(np.int32)
    label[:, :4] = -1
    palette = np.linspace(40, 215, C)[:, None] * np.array([[1.0, 0.8, 0.6]])
    img = np.clip(palette[label.clip(0)] + r.normal(0, 8, label.shape + (3,)),
                  0, 255).astype(np.uint8)
    tgt = np.clip(img[::-1].astype(np.float32) + 20, 0, 255).astype(np.uint8)
    sup = np.stack([np.roll(grid_superpixels(80), (i * 5, i * 3), (0, 1))
                    [:HW, :HW] for i in range(GB)]).astype(np.int32)
    scale = np.kron(r.choice([1.0, 3.0, 6.0, 12.0], (GB, 9, 9)),
                    np.ones((8, 8)))[..., None]
    logit = r.normal(size=(GB, HW, HW, C)) * scale
    prob = np.exp(logit - logit.max(-1, keepdims=True))
    prob = (prob / prob.sum(-1, keepdims=True)).astype(np.float16)
    return ({"image": img, "label": label},
            {"image": tgt, "sup": sup, "prob": prob})


def local(batch):
    """This rank's rows of a global numpy batch, as tensors."""
    n = GB // mesh.world_size()
    rows = mesh.rows(n)
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
            for k, v in batch.items()}


def _cfg():
    return dataclasses.replace(PRESETS["2vaihingen"], model="resnet18",
                               learning_rate=1e-3)


def _model(seed=0, ins_norm=False):
    """The trainers' resnet18 model (``train.loop.build_model``'s config);
    without the instance norm unless asked: the PPM's 1x1 pool of an
    instance-normed feature is zero up to rounding, and its BatchNorm
    normalizes that rounding, so the steps' gradients would differ with
    any change of summation order (the JAX parity tests hold updates to
    0.15 of their norm for it)."""
    from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
    from uemda_tpu_torch.models.config import PPMConfig

    cfg = dataclasses.replace(
        DeeplabV2Config.uemda_default(C, resnet_type="resnet18"),
        ppm=PPMConfig(num_classes=C, fc_dim=K), inchannels=K,
        is_ins_norm=ins_norm)
    return DeeplabV2(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


SAMPLE = 2048   # elements kept of each parameter tensor


def sketch(named) -> dict:
    """A compact record of parameter tensors: their fingerprint (the sum of
    every |p|, f64), and per tensor a SHA-1 of its bytes and the values at
    ``SAMPLE`` fixed positions (drawn from the tensor's name), from which
    the test estimates update norms. A full copy of this resnet18 with its
    two PPM heads is 141 MB a state."""
    out = {"fp": 0.0, "sha": {}, "sample": {}}
    for name, t in named:
        t = t.detach().contiguous()
        out["fp"] += float(t.abs().sum(dtype=torch.float64))
        out["sha"][name] = hashlib.sha1(t.numpy().tobytes()).hexdigest()
        flat = t.reshape(-1)
        if flat.numel() > SAMPLE:
            g = torch.Generator().manual_seed(
                int(hashlib.sha1(name.encode()).hexdigest()[:8], 16))
            flat = flat[torch.randint(0, flat.numel(), (SAMPLE,),
                                      generator=g)]
        out["sample"][name] = (flat.clone(), t.numel())
    return out


def _snapshot(state, disc=None) -> dict:
    """The parameters' sketch and every other tensor of the state."""
    sd = state.model.state_dict()
    params = {n for n, _ in state.model.named_parameters()}
    named = [(f"model.{n}", sd[n]) for n in sorted(params)]
    if disc is not None:
        named += [(f"disc.{n}", p) for n, p in disc.named_parameters()]
    out = {f"model.{k}": v.detach().clone() for k, v in sd.items()
           if k not in params}
    for name in ("balance_s", "balance_t"):
        out[f"{name}.freq"] = getattr(state, name).freq.clone()
    out["ghm.acc_sum"] = state.ghm.acc_sum.clone()
    for f in ("prototypes", "data_sum", "data_cnt"):
        out[f"aligner.{f}"] = getattr(state.aligner, f).clone()
    return {"buffers": out, "params": sketch(named)}


def run_step_case(name: str, steps: int = 2) -> dict:
    """``steps`` steps of the case's step on this rank's rows, the draws
    made by the step itself from (seed, step) for the global batch."""
    from uemda_tpu_torch.train.adversarial import create_adv_state, make_adv_step
    from uemda_tpu_torch.train.loop import build_state
    from uemda_tpu_torch.train import steps as S

    kind, hp, extra = STEP_CASES[name]
    hp = S.StageHParams(**hp)
    model = _model(1)
    proto = np.random.default_rng(3).normal(size=(C, K)).astype(np.float32)
    state = build_state(model, _cfg(), 40, prototypes=proto, feat_channels=K)
    run_state = create_adv_state(state, C, seed=5) if kind == "adv" else state
    disc = run_state.disc if kind == "adv" else None
    start = _snapshot(state, disc)["params"]
    if kind == "init_proto":
        step = S.make_init_proto_step(model, hp)
        for i in range(steps):
            bs, _ = global_batches(10 + i)
            step(state, local(bs), 7, index=i)
        return {"metrics": [], "state": _snapshot(state), "start": start}
    make = {"src": S.make_src_step, "align": S.make_align_step,
            "ssl": S.make_ssl_step, "dca": S.make_dca_step,
            "mix": lambda m, h: S.make_mix_step(m, h, **extra),
            "adv": make_adv_step}[kind]
    step = make(model, hp)
    metrics = []
    for i in range(steps):
        bs, bt = global_batches(10 + i)
        if kind in ("src", "align", "adv"):
            bt = {k: v for k, v in bt.items()
                  if k == "image" or (k == "sup" and kind == "align")}
        m = step(run_state, local(bs), local(bt), 2333)
        metrics.append({k: float(v) for k, v in m.items()})
    out = _snapshot(state, disc)
    return {"metrics": metrics, "state": out, "start": start}


# ------------------------------------------------------------ dormant audit


def _inputs(seed: int):
    """Global inputs of the audit (numpy), each rank's rows taken below."""
    r = np.random.default_rng(seed)
    return {
        "feat": r.normal(size=(GB, 16, 4, 4)).astype(np.float32),
        "feat2": r.normal(size=(GB, 16, 4, 4)).astype(np.float32),
        "logits": r.normal(size=(GB, C, 8, 8)).astype(np.float32) * 2,
        "logits2": r.normal(size=(GB, C, 8, 8)).astype(np.float32) * 2,
        "label": r.integers(-1, C, (GB, 8, 8)).astype(np.int32),
        "label_feat": r.integers(-1, C, (GB, 4, 4)).astype(np.int32),
        "rows": r.normal(size=(GB * 4, 8)).astype(np.float32),
        "rows_label": r.integers(0, 3, (GB * 4,)).astype(np.int64),
        "anchors": r.normal(size=(GB * 2, 2, 8)).astype(np.float32),
        "anchor_label": r.integers(0, 3, (GB * 2,)).astype(np.int64),
        "pix_feat": r.normal(size=(GB, 24, 8)).astype(np.float32),
        "pix_label": r.integers(0, 3, (GB, 24)).astype(np.int64),
        "pix_pred": r.integers(0, 3, (GB, 24)).astype(np.int64),
        "pix_noise": r.random((GB, 24, 3)).astype(np.float32),
        "weight": (r.random((GB, 1, 8, 8)) > 0.3).astype(np.float32),
        "image": r.normal(size=(GB, 3, 8, 8)).astype(np.float32),
        "soft": r.dirichlet(np.ones(C), (GB, 8, 8)).transpose(
            0, 3, 1, 2).astype(np.float32),
        "protos": r.normal(size=(C, 16)).astype(np.float32),
        "tn": r.normal(size=(GB, 16, 4, 4)).astype(np.float32) + 0.5,
    }


def _audit_fns():
    """name -> (f(x: dict of this rank's tensors), flag): f gives a
    replicated scalar, or, flagged True, a tuple of tensors of this rank's
    rows."""
    from uemda_tpu_torch.alignment import (coral, contrastive, dca,
                                           extra_losses as xl, losses as L,
                                           mmd, msc, pcl, prototypes as P,
                                           saw, whiten)
    from uemda_tpu_torch.alignment.balance import (class_balance_weight,
                                                   init_class_balance)
    from uemda_tpu_torch.models import discriminator
    from uemda_tpu_torch.models.trans_norm import TransNorm2d
    from uemda_tpu_torch.ops.mixing import MixDraws, cutmix_inbatch

    def aligner(x):
        return P.init_aligner(C, 16, prototypes=x["protos"], device="cpu")

    def transnorm(x):
        tn = TransNorm2d(16, generator=torch.Generator().manual_seed(0))
        src, tgt = x["tn"], x["tn"] * 1.5 - 0.2
        b = src.shape[0]
        out = tn(torch.cat([src, tgt]))
        return (mesh.gmean(out[:b] ** 2) + mesh.gmean(out[b:] * out[b:].tanh())
                + tn.var_target.sum() + tn.mean_source.sum())

    perm = torch.tensor([2, 0, 3, 1])
    return {
        "ce": (lambda x: L.cross_entropy_loss(x["logits"], x["label"]), False),
        "ohem": (lambda x: L.ohem_cross_entropy(x["logits"], x["label"]),
                 False),
        "focal": (lambda x: L.focal_loss(x["logits"], x["label"]), False),
        "ghm": (lambda x: L.ghm_loss(x["logits"], x["label"],
                                     L.init_ghm())[0], False),
        "gdp": (lambda x: L.gdp_loss(x["logits"], x["label"],
                                     L.init_ghm())[0], False),
        "ups": (lambda x: L.ups_loss(x["logits"], x["label"], x["soft"]),
                False),
        "uvem": (lambda x: L.uvem_loss(x["logits"], x["label"], x["soft"]),
                 False),
        "balance": (lambda x: class_balance_weight(
            init_class_balance(C), x["label"])[1].freq.sum()
            + mesh.gmean(class_balance_weight(init_class_balance(C),
                                              x["label"])[0]), False),
        "coral": (lambda x: coral.align_domain(x["feat"], x["feat2"]), False),
        "pcl": (lambda x: pcl.prototype_contrastive_loss(
            x["protos"], x["feat"], x["label_feat"]), False),
        "update_prototype": (lambda x: P.update_prototype(
            aligner(x), x["feat"], x["label"], C, 2)[0].prototypes.sum(),
            False),
        "update_avg": (lambda x: P.init_avg(P.update_avg(
            aligner(x), x["feat"], x["label"], C, 2)).prototypes.sum(), False),
        "align_class": (lambda x: P.align_class(
            aligner(x), x["feat"], x["label"], C, x["feat2"], x["label"], 2),
            False),
        "align_instance": (lambda x: P.align_instance(
            aligner(x), x["feat"], x["label"], C, x["feat2"], x["label"], 2),
            False),
        "proto_by_target": (lambda x: P.update_prototype_by_target(
            aligner(x), x["feat"], x["soft"]).prototypes.sum(), False),
        "refine_n": (lambda x: (P.label_refine(
            aligner(x), x["soft"], x["feat"], x["logits2"], mode="n",
            topk=4),), True),
        "icr": (lambda x: dca.icr(x["logits"][:, :, :4, :4],
                                  x["logits2"][:, :, :4, :4], x["feat"]),
                False),
        "ccr": (lambda x: dca.ccr(
            x["logits"][:, :, :4, :4], x["logits2"][:, :, :4, :4], x["feat"],
            x["logits2"][:, :, :4, :4], x["logits"][:, :, :4, :4],
            x["feat2"]), False),
        "mse_intra": (lambda x: dca.mse_intra(
            x["logits"][:, :, :4, :4], x["logits2"][:, :, :4, :4],
            x["feat"]), False),
        "mse_cross": (lambda x: dca.mse_cross(
            x["logits"][:, :, :4, :4], x["logits2"][:, :, :4, :4], x["feat"],
            x["logits2"][:, :, :4, :4], x["logits"][:, :, :4, :4],
            x["feat2"]), False),
        "triplet": (lambda x: contrastive.triplet_loss(
            x["rows"], x["rows_label"]), False),
        "contrastive_anchors": (lambda x: contrastive.contrastive_anchors(
            x["anchors"], x["anchor_label"]), False),
        "pixel_contrast": (lambda x: contrastive.pixel_contrast_loss(
            x["pix_feat"], x["pix_label"], x["pix_pred"], x["pix_noise"], 3,
            n_view=4), False),
        "msc": (lambda x: msc.msc_loss(x["rows"], x["rows_label"],
                                       x["rows"] * 0.5 + 0.1, 3, k=3, m=2,
                                       mu=4), False),
        "mmd_linear": (lambda x: mmd.mmd_linear(x["rows"], x["rows"] ** 2),
                       False),
        "mmd_rbf": (lambda x: mmd.mmd_rbf(x["rows"], x["rows"] * 0.7), False),
        "mmd_disc": (lambda x: discriminator.mmd_linear(
            x["rows"], x["rows"] ** 2), False),
        "saw": (lambda x: saw.saw_loss(x["feat"], x["protos"], [0, 1, 2, 3]),
                False),
        "whiten": (lambda x: whiten.class_ware_whitening_loss(
            x["feat"], x["label_feat"], [0, 1], groups=4), False),
        "som": (lambda x: xl.som(x["logits"].abs()), False),
        "entropy": (lambda x: xl.entropy_loss(x["logits"], x["weight"]),
                    False),
        "kld": (lambda x: xl.kld_loss(x["logits"], x["weight"]), False),
        "bce": (lambda x: xl.bce_logits_loss(x["logits"], x["soft"]), False),
        "mixup": (lambda x: xl.mixup(perm, 3, x["image"], x["label"],
                                     x["image"] * 2, x["label"] + 1), True),
        "cutmix_inbatch": (lambda x: cutmix_inbatch(
            MixDraws(lam=torch.tensor(0.6), cx=torch.tensor(3.0),
                     cy=torch.tensor(4.0), perm=perm),
            x["image"], x["label"]), True),
        "transnorm": (transnorm, False),
    }


def run_audit() -> dict:
    """Every audited function on this rank's rows: its value and the
    gradient of each float input's rows."""
    raw = _inputs(11)
    out = {}
    for name, (fn, local_out) in _audit_fns().items():
        x = {k: torch.from_numpy(np.ascontiguousarray(
            v[mesh.rows(v.shape[0] // mesh.world_size())]))
            if k != "protos" else torch.from_numpy(v) for k, v in raw.items()}
        for k, v in x.items():
            if v.is_floating_point() and k not in ("protos", "weight",
                                                   "pix_noise", "soft"):
                v.requires_grad_(True)
        val = fn(x)
        if local_out:
            res = {"value": [t.detach().clone() for t in val], "local": True}
            val = sum(t.float().sum() for t in val if t.requires_grad)
        else:
            res = {"value": val.detach().clone(), "local": False}
        if isinstance(val, torch.Tensor) and val.requires_grad:
            if local_out:
                val.backward()   # a sum of this rank's own rows
            else:
                mesh.backward(val)
            res["grads"] = {k: v.grad.clone() for k, v in x.items()
                            if v.grad is not None}
        out[name] = res
    return out


def audit_names():
    return sorted(_audit_fns())


def run_rundir_case(root: str) -> dict:
    """Two loop steps at steps_per_call 2 with an evaluation and snapshots,
    each rank with its own run dir: process 0 alone writes there."""
    from uemda_tpu_torch.datasets.base import ArrayDataset, infinite_batches
    from uemda_tpu_torch.datasets.meta import IsprsDA
    from uemda_tpu_torch.train import steps as S
    from uemda_tpu_torch.train.loop import (build_state, maybe_resume,
                                            process_shard, run_training_loop)
    import logging

    bs, bt = global_batches(20)
    src = ArrayDataset(IsprsDA, bs["image"], bs["label"])
    model = _model(2)
    state = build_state(model, _cfg(), 4, feat_channels=K)
    run_dir = os.path.join(root, f"rundir_r{mesh.rank()}")
    os.makedirs(run_dir, exist_ok=True)   # as the CLIs make it
    state, start, state_path = maybe_resume(state, run_dir, "",
                                            logging.getLogger("t"))
    evals = []
    it = infinite_batches(src, GB, seed=3, process_shard=process_shard(GB))
    run_training_loop(state, S.make_src_step(model, S.StageHParams(**BASE)),
                      it, None, 4, logging.getLogger("t"), eval_every=2,
                      log_every=2, eval_fn=lambda s: evals.append(1) or 0.5,
                      steps_per_call=2, state_path=state_path)
    files = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
    return {"files": files, "evals": len(evals),
            "params": sketch(sorted(model.named_parameters()))}


def run_jax_bundle(path: str) -> dict:
    """Two stage-3 steps (``test_torch_ssl_step.py``'s hparams) from the
    weights, prototypes, global batches and augmentation draws in the
    bundle the test wrote, dropout off, as the JAX step on a 2-device mesh
    runs them."""
    from uemda_tpu_torch.datasets.augment import AugDraws
    from uemda_tpu_torch.models import heads
    from uemda_tpu_torch.train import steps as S
    from uemda_tpu_torch.train.loop import build_state

    b = torch.load(path, weights_only=False)
    model = _model(0, ins_norm=True)
    model.load_state_dict(b["state_dict"])
    state = build_state(model, _cfg(), 40, prototypes=b["proto"],
                        feat_channels=K)
    step = S.make_ssl_step(model, S.StageHParams(**b["hp"]))
    forward = heads.Dropout.forward
    heads.Dropout.forward = lambda self, x, generator=None, mask=None: x
    metrics = []
    try:
        for (bs, bt), draws in zip(b["batches"], b["draws"]):
            d = S.StepDraws(*[S.global_draws(AugDraws(
                torch.as_tensor(o), torch.as_tensor(d4), mode))
                for o, d4, mode in draws])
            m = step(state, local(bs), local(bt), 0, draws=d)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        heads.Dropout.forward = forward
    return {"metrics": metrics, "state": _snapshot(state)}


# ------------------------------------------------------------ serving cases


class Stub:
    """A model whose windows' outputs do not depend on the batch they run
    in (elementwise arithmetic and a softmax over classes): the raster's
    own sums can be held bit for bit."""

    def __call__(self, x):
        x = x.float()
        logits = torch.stack([x[:, 0] * 0.3 + x[:, 1] * (c - 2.0) * 0.2
                              - x[:, 2] * 0.1 * c for c in range(5)], 1)
        return torch.softmax(logits, 1)


STUB_RASTERS = [((90, 52), 0.5, False), ((90, 52), 0.5, True),
                ((40, 23), 0.5, True), ((110, 40), 0.25, False)]
MEAN, STD = (120.0, 82.0, 81.0), (55.0, 39.0, 38.0)
RASTER_HW = (100, 70)


def stub_raster(hw):
    return torch.from_numpy(np.random.default_rng(hw[0]).random(
        (3,) + tuple(hw)).astype(np.float32))


def real_raster():
    """A raw (H, W, 3) raster for the resnet18 cases."""
    return (np.random.default_rng(5).random(RASTER_HW + (3,)) * 255).astype(
        np.float32)


def serving_model(path, fastpath=False):
    """The bundle's resnet18 in eval mode (f32), or its fast path."""
    from uemda_tpu_torch.infer.fastpath import build_fastpath

    model = _model(0, ins_norm=True)
    model.load_state_dict(torch.load(path, weights_only=False)["state_dict"])
    model = model.eval()
    return build_fastpath(model, dtype=torch.float32) if fastpath else model


def run_serving_cases(path: str, out: str) -> dict:
    """The raster predictor on the stub rasters and, with the bundle's
    resnet18 (standard and fast path, TTA on and off), on one raw raster;
    an evaluation (``data_parallel``) and a sweep into ``<out>/sweep_<N>``
    on the bundle's split."""
    from uemda_tpu_torch.datasets.base import ArrayDataset
    from uemda_tpu_torch.datasets.meta import IsprsDA
    from uemda_tpu_torch.infer.evaluate import evaluate_dataset
    from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
    from uemda_tpu_torch.infer.raster import (make_raster_predictor,
                                              raster_predict)

    res = {}
    for i, (hw, overlap, tta) in enumerate(STUB_RASTERS):
        res[f"stub{i}"] = make_raster_predictor(
            Stub(), hw, (16, 16), overlap=overlap, tta=tta, window_chunk=3,
            compute_dtype=torch.float32, return_probs=True)(stub_raster(hw))
    for fast in (False, True):
        net = serving_model(path, fast)
        for tta in (False, True):
            res[f"real_fast{int(fast)}_tta{int(tta)}"] = raster_predict(
                net, real_raster(), MEAN, STD, tile=(32, 32), tta=tta,
                compute_dtype=torch.float32, return_probs=True, device="cpu")
    b = torch.load(path, weights_only=False)
    ds = ArrayDataset(IsprsDA, b["images"], b["labels"])
    model = serving_model(path)
    summary, _ = evaluate_dataset(model, ds, MEAN, STD, tile=(32, 32),
                                  batch_size=1, compute_dtype=torch.float32,
                                  device="cpu", data_parallel=True)
    res["cm"] = summary["confusion_matrix"]
    sweep = os.path.join(out, f"sweep_{mesh.world_size()}")
    got = generate_pseudo_labels(model, ds, MEAN, STD, out_dir=sweep,
                                 tile=(32, 32), batch_size=2,
                                 keep_in_memory=False,
                                 compute_dtype=torch.float32, device="cpu")
    res["sweep_returned"] = sorted(got)
    return res
