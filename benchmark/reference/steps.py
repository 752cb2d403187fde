"""The plain reference of the benchmarked train steps, in float32.

Stage 1 (source CE on both heads + CORAL, reference ``tools/train_src.py:
108-149``) and stage 3 (source CE; the target's stored soft label refined
by the prototype, prediction and superpixel views; strict-threshold pseudo
labels and the UVEM weight; the prototypes' EMA; reference ``tools/
train_ssl_uem.py:171-235``, ``uemda/gast/alignment.py``, ``balance.py``),
then one SGD update (poly warm-up rate, momentum, weight decay, the
gradient clipped to norm 32). Every function is plain PyTorch written from
those descriptions; nothing of the measured program is imported.

The inputs are worked out again from what the benchmark made (the tile
pools, the weights, the prototypes) and the run's seed, by the rules the
measured loop documents: the shuffled stream of ``infinite_batches`` with
its host crops, and a step's draws from ``(seed, step)`` (the crop origins
and D4 turns on a CPU generator, the dropout masks on a generator of the
batches' device).
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import HEADS, PPM_WIDTH, DROPOUT, Net

EPS = 1e-7


# ------------------------------------------------------------- the stream


def batch_schedule(n: int, batch: int, seed: int, count: int,
                   host_crop: Optional[tuple], tile_hw: tuple):
    """The first ``count`` batches of the shuffled epoch stream: for each,
    the tile indices and, with ``host_crop``, each sample's crop origin
    (DALoader's RandomSampler with drop_last, and the host crop's
    uniform origins from ``default_rng((seed, 9157, batch index))``)."""
    rng = np.random.default_rng(seed)
    out, b_index = [], 0
    while len(out) < count:
        perm = rng.permutation(n)
        stop = (n // batch) * batch
        for i in range(0, max(stop, batch), batch):
            idx = perm[i:i + batch]
            if len(idx) < batch:
                idx = np.concatenate([idx, perm[:batch - len(idx)]])
            origins = None
            if host_crop is not None:
                u = np.random.default_rng((seed, 9157, b_index)).random(
                    (len(idx), 2))
                (h, w), (ch, cw) = tile_hw, host_crop
                origins = [(min(int(u[j, 0] * (h - ch + 1)), h - ch),
                            min(int(u[j, 1] * (w - cw + 1)), w - cw))
                           for j in range(len(idx))]
            out.append((idx, origins))
            b_index += 1
            if len(out) == count:
                break
    return out


def take_batch(pool: Dict[str, np.ndarray], idx, origins, crop):
    """The arrays of one batch: whole tiles, or each cropped at its
    origin."""
    out = {}
    for k, arr in pool.items():
        rows = arr[idx]
        if origins is not None:
            rows = np.stack([r[y:y + crop[0], x:x + crop[1]]
                             for r, (y, x) in zip(rows, origins)])
        out[k] = rows
    return out


# -------------------------------------------------------------- the draws


def step_generators(seed: int, step: int, device):
    a, b = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    return (torch.Generator().manual_seed(int(a) >> 1),
            torch.Generator(device=device).manual_seed(int(b) >> 1))


def draw_augment(gen, batch: int, image_hw, crop_hw, mode: str):
    (h, w), (ch, cw) = image_hw, crop_hw

    def randint(high):
        return torch.randint(0, high, (batch,), generator=gen)

    offsets = torch.stack([randint(max(h - ch, 0) + 1),
                           randint(max(w - cw, 0) + 1)], 1)
    if mode == "oneof":
        apply = torch.rand(batch, generator=gen) < 0.75
        d4 = torch.stack([apply.long(), randint(3), randint(4)], 1)
    else:
        d4 = (torch.rand(batch, 3, generator=gen) < 0.5).long()
    return offsets, d4


def dropout_masks(batch: int, hw, gen) -> Dict[str, torch.Tensor]:
    keep = 1.0 - DROPOUT
    return {h: torch.rand((batch, PPM_WIDTH) + tuple(hw), generator=gen,
                          device=gen.device) < keep for h in HEADS}


def d4(a: torch.Tensor, op, mode: str, hd: int, wd: int) -> torch.Tensor:
    """One sample's flip or turn; ``rot90`` turns from H toward W."""
    if mode == "oneof":
        apply, choice, k90 = op
        if not apply:
            return a
        if choice == 0:
            return torch.flip(a, (wd,))
        if choice == 1:
            return torch.flip(a, (hd,))
        return torch.rot90(a, k90, (hd, wd))
    h, v, r = op
    if h:
        a = torch.flip(a, (wd,))
    if v:
        a = torch.flip(a, (hd,))
    if r:
        a = torch.rot90(a, 1, (hd, wd))
    return a


def augment(batch, offsets, ops, crop, mean, std, mode, clamp, device):
    """Crop, normalize ((x - mean) times the f32 reciprocal of std; with
    ``clamp`` capped at 1) and turn every sample and its maps alike."""
    th, tw = crop
    m = torch.tensor(mean, dtype=torch.float32, device=device)
    inv = 1.0 / torch.tensor(std, dtype=torch.float32, device=device)
    out = {k: [] for k in batch}
    for i in range(batch["image"].shape[0]):
        y, x = (int(v) for v in offsets[i])
        op = [int(v) for v in ops[i]]
        img = torch.from_numpy(np.ascontiguousarray(
            batch["image"][i, y:y + th, x:x + tw])).to(device).float()
        img = (img - m) * inv
        if clamp:
            img = torch.clamp(img, max=1.0)
        out["image"].append(d4(img.permute(2, 0, 1), op, mode, 1, 2))
        for k in batch:
            if k == "image":
                continue
            t = torch.from_numpy(np.ascontiguousarray(
                batch[k][i, y:y + th, x:x + tw])).to(device)
            out[k].append(d4(t, op, mode, 0, 1))
    return {k: torch.stack(v) for k, v in out.items()}


# ------------------------------------------------------------- the losses


def upsample(logits, hw):
    return F.interpolate(logits, hw, mode="bilinear", align_corners=True)


def ce_mean(logits, label, ignore=-1):
    """Per-pixel CE, 0 where ignored, averaged over every pixel."""
    logp = torch.log_softmax(logits, 1)
    valid = label != ignore
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    ce = -torch.gather(logp, 1, safe[:, None])[:, 0]
    return torch.where(valid, ce, torch.zeros_like(ce)).mean()


def uvem_ce(logits, label, w, u, t, ignore=-1):
    logp = torch.log_softmax(logits, 1)
    valid = label != ignore
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    ce = -torch.gather(logp, 1, safe[:, None])[:, 0]
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    trained = u <= t
    ce = torch.where(trained, ce, torch.zeros_like(ce))
    return (w * ce).sum() / ((trained & valid).sum() + EPS)


def two_heads(preds, label, fn):
    hw = tuple(label.shape[-2:])
    return sum(fn(upsample(p, hw), label) for p in preds) / len(preds)


def coral(fs, ft):
    def cov(x):
        xm = x - x.mean(0, keepdim=True)
        return xm.t() @ xm / (x.shape[0] - 1)

    k = fs.shape[1]
    rows = lambda f: f.permute(0, 2, 3, 1).reshape(-1, k)  # noqa: E731
    d = cov(rows(fs)) - cov(rows(ft))
    return (d * d).sum() / (4.0 * k * k)


def downscale(label, s, nc, ignore=-1, min_ratio=0.75):
    b, h, w = label.shape
    lbl = torch.where(label == ignore, torch.full_like(label, nc),
                      label).long()
    oh = F.one_hot(lbl, nc + 1)
    counts = oh.reshape(b, h // s, s, w // s, s, nc + 1).sum((2, 4))
    mx, out = counts.max(-1)
    bad = (out == nc) | (mx.float() / (s * s) < min_ratio)
    return torch.where(bad, torch.full_like(out, ignore), out)


def pearson(f1, f2):
    k = f1.shape[-1]
    c1 = f1 - f1.mean(-1, keepdim=True)
    c2 = f2 - f2.mean(-1, keepdim=True)
    cov = c1 @ c2.t() / (k - 1 + EPS)
    s1 = torch.sqrt((c1 * c1).sum(-1) / (k - 1))
    s2 = torch.sqrt((c2 * c2).sum(-1) / (k - 1))
    return (-cov / (s1[:, None] * s2[None, :] + EPS) + 1.0) * 0.5


def maxnorm(w):
    return w / (w.amax(1, keepdim=True) + EPS)


def refine(protos, soft, feat, preds, sup, temp=2.0):
    """The 'all' refinement: prototype view times prediction view, times
    the superpixel view off the boundary."""
    b, k, h, w = feat.shape
    c, ho, wo = soft.shape[1:]
    rows = feat.permute(0, 2, 3, 1).reshape(-1, k)
    simi = (1.0 / pearson(rows, protos)).reshape(b, h, w, c).permute(0, 3, 1,
                                                                     2)
    weight = maxnorm(torch.softmax(upsample(simi, (ho, wo)), 1))
    lw = sum(torch.softmax(upsample(p, (ho, wo)) / temp, 1)
             for p in preds) / len(preds)
    weight = weight + maxnorm(lw)
    # each superpixel's class-wise max, spread over its pixels
    ids = sup.reshape(b, -1).long()
    flat = soft.permute(0, 2, 3, 1).reshape(b, -1, c)
    n_ids = int(ids.max()) + 1
    pooled = torch.full((b, n_ids, c), float("-inf"), device=soft.device)
    pooled.scatter_reduce_(1, ids[..., None].expand(-1, -1, c), flat, "amax")
    back = torch.gather(pooled, 1, ids[..., None].expand(-1, -1, c))
    back = back.reshape(b, ho, wo, c).permute(0, 3, 1, 2)
    sw = maxnorm(torch.softmax(back / temp, 1))
    boundary = (sup == sup.max())[:, None]
    weight = torch.where(boundary, weight, weight * sw)
    refined = weight * soft
    return refined / (refined.sum(1, keepdim=True) + EPS)


def mine(probs, top, low, m, t, g, ignore=-1):
    """The one class strictly above max(top * its max, low), the entropy
    and the UVEM weight."""
    thr = torch.clamp(probs.amax((2, 3), keepdim=True) * top, min=low)
    over = probs > thr
    one = over.sum(1) == 1
    label = torch.where(one, over.to(torch.uint8).argmax(1),
                        torch.full_like(one, ignore, dtype=torch.long))
    u = -(probs * torch.log(torch.clamp_min(probs, 1e-30))).sum(1)
    left = torch.clamp(-1.0 / (m * m) * (u - m) ** 2 + 1.0, 0, 1) ** (1 / g)
    x = torch.where((u > m) & (u <= t), u, torch.zeros_like(u))
    right = torch.clamp(-1.0 / ((t - m) ** 2) * (x - m) ** 2 + 1.0, 0,
                        1) ** (1 / g)
    w = torch.where(u <= m, left, right)
    return label, torch.where(u >= t, torch.zeros_like(w), w), u


def ema_prototypes(protos, feat, label, nc, s, decay=0.996, ignore=-1):
    down = downscale(label, s, nc, ignore)
    k = feat.shape[1]
    rows = feat.permute(0, 2, 3, 1).reshape(-1, k)
    valid = (down.reshape(-1) != ignore)
    oh = F.one_hot(torch.where(valid, down.reshape(-1), 0), nc).float()
    oh = oh * valid[:, None].float()
    n = oh.sum(0)[:, None]
    local = torch.where(n < 1, protos, (oh.t() @ rows) / (n + EPS))
    return (1.0 - decay) * local + decay * protos


# ---------------------------------------------------------------- the step


@dataclasses.dataclass
class Hyper:
    """A step's settings, as the configuration states them."""
    stage: str            # "ssl" or "src"
    arch: str
    num_classes: int
    crop: tuple
    src_mean: tuple
    src_std: tuple
    tgt_mean: tuple
    tgt_std: tuple
    clamp_target: bool
    base_lr: float
    horizon: int
    power: float = 0.9
    momentum: float = 0.9
    weight_decay: float = 5e-4
    clip: float = 32.0
    cutoff_top: float = 0.8
    cutoff_low: float = 0.6
    uvem_m: float = 0.2
    uvem_t: float = 0.7
    uvem_g: float = 4.0
    refine_temp: float = 2.0
    stride: int = 16


def lr_at(hp: Hyper, count: int) -> float:
    preheat = int(hp.horizon / 20)
    if count < preheat:
        return hp.base_lr * count / max(preheat, 1)
    return hp.base_lr * (1.0 - count / (hp.horizon * 1.5)) ** hp.power


class Trainer:
    """The reference's model, momentum and prototypes, stepped one batch
    pair at a time. ``quant`` and ``half`` make the control and the
    half-batch fault (the mean over the first half of each batch)."""

    def __init__(self, hp: Hyper, params: Dict[str, torch.Tensor],
                 protos: Optional[torch.Tensor], quant=None, half=False):
        self.hp, self.half = hp, half
        self.names = [n for n, v in params.items() if v.is_floating_point()
                      and not n.endswith(("running_mean", "running_var"))]
        self.p = {n: v.detach().clone().float() for n, v in params.items()}
        for n in self.names:
            self.p[n].requires_grad_(True)
        self.trace = {n: torch.zeros_like(self.p[n]) for n in self.names}
        self.protos = None if protos is None else protos.clone().float()
        self.net = Net(self.p, hp.arch, quant=quant)
        self.count = 0

    def step(self, bs, bt, draws):
        """One step on the augmented batches' raw arrays and the step's
        draws; returns the loss and, for stage 1, its CORAL term."""
        hp, dev = self.hp, self.p[self.names[0]].device
        (off_s, ops_s), (off_t, ops_t), drop_s, drop_t = draws
        if self.half:
            cut = bs["image"].shape[0] // 2
            bs = {k: v[:cut] for k, v in bs.items()}
            bt = {k: v[:cut] for k, v in bt.items()}
            off_s, ops_s, off_t, ops_t = (off_s[:cut], ops_s[:cut],
                                          off_t[:cut], ops_t[:cut])
            drop_s = {k: v[:cut] for k, v in drop_s.items()}
            drop_t = {k: v[:cut] for k, v in drop_t.items()}
        t_mode = "compose" if hp.stage == "ssl" else "oneof"
        s = augment(bs, off_s, ops_s, hp.crop, hp.src_mean, hp.src_std,
                    "oneof", False, dev)
        t = augment(bt, off_t, ops_t, hp.crop, hp.tgt_mean, hp.tgt_std,
                    t_mode, t_mode == "compose" and hp.clamp_target, dev)
        p1, p2, fs = self.net.train_forward(s["image"], drop_s)
        t1, t2, ft = self.net.train_forward(t["image"], drop_t)
        label_s = s["label"].long()
        loss = two_heads([p1, p2], label_s, ce_mean)
        parts = {}
        if hp.stage == "src":
            dom = coral(fs, ft)
            parts["loss_domain"] = float(dom.detach())
            loss = loss + dom
        else:
            with torch.no_grad():
                soft = t["prob"].permute(0, 3, 1, 2).float()
                soft = refine(self.protos, soft, ft.detach(),
                              [t1.detach(), t2.detach()], t["sup"],
                              hp.refine_temp)
                lt, w, u = mine(soft, hp.cutoff_top, hp.cutoff_low,
                                hp.uvem_m, hp.uvem_t, hp.uvem_g)
                self.protos = ema_prototypes(self.protos, fs.detach(),
                                             label_s, hp.num_classes,
                                             hp.stride)
            loss = loss + two_heads(
                [t1, t2], lt,
                lambda lg, lb: uvem_ce(lg, lb, w, u, hp.uvem_t))
        grads = torch.autograd.grad(loss, [self.p[n] for n in self.names])
        with torch.no_grad():
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = 1.0 if norm < hp.clip else hp.clip / norm
            lr = lr_at(hp, self.count)
            for n, g in zip(self.names, grads):
                u_ = g * scale + hp.weight_decay * self.p[n]
                self.trace[n] = u_ + hp.momentum * self.trace[n]
                self.p[n] -= lr * self.trace[n]
        self.count += 1
        return {"loss": float(loss.detach()), **parts}

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The trained tensors (and the prototypes), detached."""
        out = {n: self.p[n].detach() for n in self.names}
        if self.protos is not None:
            out["aligner.prototypes"] = self.protos
        return out


def draws_for(seed: int, step: int, batch: int, tile_hw, crop, stage: str,
              device, feat_hw):
    """A step's draws, as the measured step makes them: the source's, then
    the target's augmentation on the CPU generator, then the source's and
    the target's dropout masks on the device generator."""
    host, dev = step_generators(seed, step, device)
    aug_s = draw_augment(host, batch, tile_hw, crop, "oneof")
    aug_t = draw_augment(host, batch, tile_hw, crop,
                         "compose" if stage == "ssl" else "oneof")
    return aug_s, aug_t, dropout_masks(batch, feat_hw, dev), \
        dropout_masks(batch, feat_hw, dev)


def follow(hp: Hyper, params, protos, pools, seed: int, steps: int,
           batch: int, host_crop, device, quant=None, half=False
           ) -> List[dict]:
    """Run the reference's first ``steps`` steps. Returns, for each step,
    its loss and, after step 1, the gradient as the optimizer took it
    (momentum minus the weight decay term), and after the last step the
    leaves."""
    tr = Trainer(hp, params, protos, quant=quant, half=half)
    src_pool, tgt_pool = pools
    tile_hw = tuple(src_pool["image"].shape[1:3])
    sched_s = batch_schedule(len(src_pool["image"]), batch, seed, steps,
                             host_crop, tile_hw)
    sched_t = batch_schedule(len(tgt_pool["image"]), batch, seed + 1, steps,
                             host_crop, tuple(tgt_pool["image"].shape[1:3]))
    in_hw = tuple(host_crop) if host_crop else tile_hw
    feat_hw = tuple(-(-c // hp.stride) for c in hp.crop)
    out = []
    start = {n: v.detach().clone() for n, v in tr.leaves().items()}
    for k in range(steps):
        bs = take_batch(src_pool, *sched_s[k], host_crop)
        bt = take_batch(tgt_pool, *sched_t[k], host_crop)
        draws = draws_for(seed, k, batch, in_hw, hp.crop, hp.stage, device,
                          feat_hw)
        rec = tr.step(bs, bt, draws)
        if k == 0:
            rec["grad"] = {n: (tr.trace[n] - hp.weight_decay * start[n])
                           for n in tr.names}
        out.append(rec)
    out[-1]["change"] = {n: v - start[n] for n, v in tr.leaves().items()}
    return out
