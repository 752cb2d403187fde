"""Serving fast path: the exact-math restructured eval forward.

Port of the exact-math part of ``uemda_tpu/infer/fastpath.py``. It computes
the same function as ``DeeplabV2`` in eval mode (averaged head softmax at
input resolution, reference ``Encoder.py:152-155``) from folded weights:

* **BN folding** (:func:`_fold`): each eval-mode BatchNorm folds into the
  preceding conv's weight and a bias.
* **Space-to-depth stem** (:func:`_s2d_stem_kernel`, :func:`_space_to_depth`):
  the 7x7/s2 conv on 3 channels becomes a 4x4/s1 conv on 12 channels with
  padding (2, 1) per axis; the conv, bias, ReLU and the 3x3/s2 max-pool run
  in the K2 kernel and only the pooled map is written (the JAX package's
  ``fused_stem=True``; there is no unfused stem on the card).
* **Space-to-batch layer4** (``s2b_layer4``): blocks 1+ of the dilate-2
  stage run as dense 3x3s on a 4x batch of half-resolution phases.
* **Fused dual head**: the heads sharing a feature stack their feature-side
  3x3 convs into one conv, and the pooled pyramid branch runs as tap GEMMs on
  the tiny pooled maps followed by one separable-upsample GEMM
  (:func:`_ppm_pooled_heads`) -- no full-resolution pooled map exists.
* Instance norm is the K1 kernel and the eval tail the K3 kernel.

int8 serving, activation calibration and the fused residual blocks
(``fused_stages``) come in later slices and raise ``NotImplementedError``.
"""

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from uemda_tpu_torch.models.deeplabv2 import DeeplabV2, eval_tail
from uemda_tpu_torch.models.resnet import (
    RESNET_SPECS,
    BasicBlock,
    stage_plan,
)
from uemda_tpu_torch.ops.insnorm import instance_norm
from uemda_tpu_torch.ops.resize import (
    _interp_matrix,
    adaptive_avg_pool_multi,
    matrix_on,
)
from uemda_tpu_torch.ops.stem import stem_pool

CL = torch.channels_last


@functools.lru_cache(maxsize=128)
def _shifted_interp_cat(in_size: int, out_size: int) -> np.ndarray:
    """(out, 3*in) matrix stacking the three conv-tap-shifted row blocks of
    the align_corners=False upsample matrix M: ``U[o, t*in + i] =
    M[o + t - 1, i]``, zero where ``o + t - 1`` falls outside (the 3x3
    conv's zero padding)."""
    m = _interp_matrix(in_size, out_size, False)
    u = np.zeros((out_size, 3 * in_size), np.float32)
    for t in range(3):
        src = np.arange(out_size) + t - 1
        ok = (src >= 0) & (src < out_size)
        u[ok, t * in_size:(t + 1) * in_size] = m[src[ok]]
    return u


@functools.lru_cache(maxsize=32)
def _pooled_upsample_matrix(scales: tuple, out_h: int, out_w: int) -> np.ndarray:
    """(out_h*out_w, sum_sc 9*sc*sc) combined conv-tap x upsample operator;
    column ``((i*sc + j)*3 + ty)*3 + tx`` of scale sc's block holds
    ``Uh[h, ty*sc+i] * Uw[w, tx*sc+j]``."""
    cols = []
    for sc in scales:
        uh = _shifted_interp_cat(sc, out_h).reshape(out_h, 3, sc)
        uw = _shifted_interp_cat(sc, out_w).reshape(out_w, 3, sc)
        blk = np.einsum("hyi,wxj->hwijyx", uh, uw)
        cols.append(blk.reshape(out_h * out_w, sc * sc * 9))
    return np.ascontiguousarray(np.concatenate(cols, 1))


def _ppm_pooled_heads(both, g_params, g_size, pool_scales, h, w, dtype):
    """Pooled branch of the PPM head group, restructured (exact math):
    ``Conv3x3(concat_sc Up_sc(z_sc)) = sum_sc sum_taps U_ty (z_sc @ W[ty,tx])
    U_tx^T``. Nine tap GEMMs per (head, scale) on the tiny (B, sc, sc, 512)
    pooled maps, then one (h*w, sum 9*sc^2) GEMM to the full-resolution
    pooled-branch output of all heads. That GEMM runs in f32 in both
    dtypes: the JAX package's bf16 hi/lo split of the matrix (two MXU passes,
    ``fastpath.py:140-155``) approximates exactly this product. Returns (B, g_size*C_out, h, w), heads stacked on channels."""
    ts = []
    for hi in range(g_size):
        per_scale = []
        for si, sc in enumerate(pool_scales):
            z = both[sc][:, hi * 512:(hi + 1) * 512].permute(0, 2, 3, 1)
            wt = g_params["pool_taps"][hi][si]             # (512, 9*C_out)
            co = wt.shape[1] // 9
            t = torch.matmul(z.float(), wt.float())        # (b, sc, sc, 9co)
            per_scale.append(t.reshape(z.shape[0], sc * sc * 9, co))
        ts.append(torch.cat(per_scale, dim=1))             # (b, K, C_out)
    t_all = torch.cat(ts, dim=-1).to(dtype)                # (b, K, g*C_out)
    bm = matrix_on(t_all.device, _pooled_upsample_matrix, tuple(pool_scales),
                   h, w)
    out = torch.matmul(bm, t_all.float())
    out = out.reshape(t_all.shape[0], h, w, t_all.shape[-1]).permute(0, 3, 1, 2)
    return out.to(dtype).contiguous(memory_format=CL)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _fold(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d):
    """Conv weight (+ optional bias) followed by eval-mode BN -> folded
    (w OIHW, b) f32 numpy."""
    w = _np(conv.weight)
    b0 = _np(conv.bias) if conv.bias is not None else np.float32(0.0)
    s = _np(bn.weight) / np.sqrt(_np(bn.running_var) + np.float32(1e-5))
    return w * s[:, None, None, None], (b0 - _np(bn.running_mean)) * s + _np(bn.bias)


def _s2d_stem_kernel(w: np.ndarray) -> np.ndarray:
    """(K, K, C, O) HWIO s2-conv kernel -> s1 kernel on the 2x2
    space-to-depth input (K=7 -> 4x4 on 4C). Tap d in [-K//2, K//2]
    decomposes uniquely as 2q + r, r in {0, 1}; s2d channel layout is
    (ry*2 + rx)*C + c (matching :func:`_space_to_depth`); the matching
    conv padding is (size//2, (size-1)//2) per axis."""
    k, _, c, o = w.shape
    r_ = k // 2
    qmin, _ = divmod(-r_, 2)
    qmax, _ = divmod(r_, 2)
    size = qmax - qmin + 1
    w2 = np.zeros((size, size, 4 * c, o), w.dtype)
    for dy in range(-r_, r_ + 1):
        qy, ry = divmod(dy, 2)
        for dx in range(-r_, r_ + 1):
            qx, rx = divmod(dx, 2)
            w2[qy - qmin, qx - qmin,
               (ry * 2 + rx) * c:(ry * 2 + rx + 1) * c] = w[dy + r_, dx + r_]
    return w2


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel (ry*2 + rx)*C + c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2).contiguous(memory_format=CL)


def _conv(x, p, stride=1, dilation=1):
    """SAME conv on folded params {'w' OIHW, 'b' f32}; the bias is added in
    the activation dtype."""
    w = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype)
    return F.conv2d(x, w, b, stride, dilation * (w.shape[-1] - 1) // 2,
                    dilation)


def build_serving_params(
    model: DeeplabV2,
    dtype: torch.dtype = torch.bfloat16,
    s2b_layer4: bool = True,
    heads_int8: bool = False,
    int8_stages: Tuple[int, ...] = (),
    fused_stages: Tuple[int, ...] = (),
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Fold the eval-mode ``model`` into the serving layout on the model's
    device. Returns ``(meta, params)``: static metadata and the folded
    weights in ``dtype`` (channels_last) with f32 biases."""
    if heads_int8 or int8_stages:
        raise NotImplementedError("int8 serving is not ported yet "
                                  "(ROADMAP.md queue A)")
    if fused_stages:
        raise NotImplementedError("fused_stages needs the K4 "
                                  "bottleneck_identity kernel, not ported "
                                  "yet (ROADMAP.md queue A)")
    cfg = model.config
    block_cls, layers, _, _, _ = RESNET_SPECS[cfg.backbone.resnet_type]
    dev = next(model.parameters()).device
    enc = model.encoder.resnet
    meta = {
        "block": "basic" if block_cls is BasicBlock else "bottleneck",
        "output_stride": cfg.backbone.output_stride,
        "is_ins_norm": cfg.is_ins_norm,
        "pool_scales": tuple(cfg.ppm.pool_scales),
        "s2b_layer4": bool(s2b_layer4),
        "include_conv5": cfg.backbone.include_conv5,
        "head": "ppm" if cfg.use_ppm else "aspp",
        "aspp_dilations": tuple(cfg.aspp_dilations),
    }

    def put(w, b):
        return {"w": torch.from_numpy(np.ascontiguousarray(w)).to(
                    device=dev, dtype=dtype).contiguous(memory_format=CL),
                "b": torch.from_numpy(np.asarray(b, np.float32)).to(dev)}

    out: Dict[str, Any] = {}
    w, b = _fold(enc.conv1, enc.bn1)
    w2 = _s2d_stem_kernel(w.transpose(2, 3, 1, 0))        # HWIO (4,4,12,64)
    out["stem"] = {"w": torch.from_numpy(np.ascontiguousarray(w2)).to(dev, dtype),
                   "b": torch.from_numpy(np.asarray(b, np.float32)).to(dev)}

    n_stages = 4 if cfg.backbone.include_conv5 else 3
    for li in range(n_stages):
        blocks = []
        for blk_m in getattr(enc, f"layer{li + 1}"):
            names = ("1", "2") + (("3",) if block_cls is not BasicBlock else ())
            blk = {f"conv{n}": put(*_fold(getattr(blk_m, f"conv{n}"),
                                          getattr(blk_m, f"bn{n}")))
                   for n in names}
            if blk_m.downsample is not None:
                blk["ds"] = put(*_fold(blk_m.downsample[0], blk_m.downsample[1]))
            blocks.append(blk)
        out[f"layer{li + 1}"] = blocks

    # heads as groups sharing one input feature (fastpath.py:393-405):
    # dual head = one group of two, single head = one group of one, cascade
    # (head1 on c4, head2 on c5) = two groups of one
    if not cfg.multi_layer:
        groups_names = [("cls_pred",)]
    elif cfg.cascade:
        groups_names = [("layer5",), ("layer6",)]
    else:
        groups_names = [("layer5", "layer6")]
    meta["head_group_sizes"] = tuple(len(g) for g in groups_names)
    meta["cascade"] = bool(cfg.multi_layer and cfg.cascade)

    def build_group(names):
        heads = [getattr(model, n) for n in names]
        g: Dict[str, Any] = {}
        if not cfg.use_ppm:
            g["aspp"] = [
                put(np.concatenate([_np(h.conv2d_list[i].weight) for h in heads]),
                    np.concatenate([_np(h.conv2d_list[i].bias) for h in heads]))
                for i in range(len(cfg.aspp_dilations))
            ]
            return g
        scales = {}
        for si, sc in enumerate(cfg.ppm.pool_scales):
            folded = [_fold(h.ppm[si][1], h.ppm[si][2]) for h in heads]
            scales[sc] = put(np.concatenate([w for w, _ in folded]),
                             np.concatenate([b for _, b in folded]))
        g["ppm_scales"] = scales
        lasts = [_fold(h.conv_last[0], h.conv_last[1]) for h in heads]
        fc = lasts[0][0].shape[1] - 512 * len(cfg.ppm.pool_scales)  # feat ch
        g["last_feat"] = put(np.concatenate([w[:, :fc] for w, _ in lasts]),
                             np.concatenate([b for _, b in lasts]))
        # pooled part of each head's concat conv, tap-packed: (O, I, ty, tx)
        # -> (I, ty, tx, O) -> (512, 9*O), column (ty*3+tx)*O + o
        g["pool_taps"] = [
            [torch.from_numpy(np.ascontiguousarray(
                w[:, fc + si * 512:fc + (si + 1) * 512].transpose(1, 2, 3, 0)
            ).reshape(512, 9 * w.shape[0])).to(dev, dtype)
             for si in range(len(cfg.ppm.pool_scales))]
            for w, _ in lasts
        ]
        g["classifier"] = [put(_np(h.conv_last[4].weight), _np(h.conv_last[4].bias))
                           for h in heads]
        return g

    out["head_groups"] = [build_group(g) for g in groups_names]
    return meta, out


def _block_forward(x, blk, meta, stride, dilation, dilation2=None):
    """One residual block; the stride sits on conv1 (BasicBlock) / conv2
    (Bottleneck), as in ``models/resnet.py``; ``dilation2`` is BasicBlock
    conv2's full stage dilate."""
    identity = x
    if meta["block"] == "basic":
        y = F.relu(_conv(x, blk["conv1"], stride=stride, dilation=dilation))
        y = _conv(y, blk["conv2"],
                  dilation=dilation if dilation2 is None else dilation2)
    else:
        y = F.relu(_conv(x, blk["conv1"]))
        y = F.relu(_conv(y, blk["conv2"], stride=stride, dilation=dilation))
        y = _conv(y, blk["conv3"])
    if "ds" in blk:
        identity = _conv(x, blk["ds"], stride=stride)
    return F.relu(y + identity)


def _stage_forward(x, blocks, meta, stride, dilate, s2b: bool):
    """First block dilation dilate//2, later blocks dilate (``stage_plan``);
    with ``s2b`` and dilate 2, blocks 1+ run on the 2x2 space-to-batch
    phases as dense 3x3s (exact)."""
    x = _block_forward(x, blocks[0], meta, stride, max(dilate // 2, 1),
                       dilation2=dilate)
    rest = blocks[1:]
    if rest and s2b and dilate == 2:
        b, c, h, w = x.shape
        # (B,C,H,W) -> (4B, C, H/2, W/2), phases (0,0),(0,1),(1,0),(1,1)
        x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(3, 5, 0, 1, 2, 4)
        x = x.reshape(4 * b, c, h // 2, w // 2).contiguous(memory_format=CL)
        for blk in rest:
            x = _block_forward(x, blk, meta, 1, 1)
        x = x.reshape(2, 2, b, c, h // 2, w // 2).permute(2, 3, 4, 0, 5, 1)
        return x.reshape(b, c, h, w).contiguous(memory_format=CL)
    for blk in rest:
        x = _block_forward(x, blk, meta, 1, dilate)
    return x


def serving_forward(meta: Dict[str, Any], params: Dict[str, Any],
                    x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, nc, H, W) averaged head softmax, the same output
    as ``DeeplabV2`` in eval mode."""
    in_hw = (x.shape[2], x.shape[3])
    mult = 2
    if meta["s2b_layer4"]:
        mult = {8: 16, 16: 32, 32: 2}[meta["output_stride"]]
    if in_hw[0] % mult or in_hw[1] % mult:
        raise ValueError(
            f"fastpath needs input H, W divisible by {mult} (space-to-depth "
            f"stem{' + space-to-batch layer4' if mult == 32 else ''}); got "
            f"{in_hw}. Use the standard model for other sizes.")

    y = _space_to_depth(x.contiguous(memory_format=CL))
    y = stem_pool(y, params["stem"]["w"].to(y.dtype), params["stem"]["b"])

    plan = stage_plan(meta["output_stride"])
    n_stages = 4 if meta["include_conv5"] else 3
    outs = []
    for li in range(n_stages):
        stride, dilate = plan[li]
        y = _stage_forward(y, params[f"layer{li + 1}"], meta, stride, dilate,
                           s2b=meta["s2b_layer4"])
        outs.append(y)

    feats = [outs[-2], outs[-1]] if meta["cascade"] else [outs[-1]]
    head_logits = []
    for g_params, g_size, feat in zip(params["head_groups"],
                                      meta["head_group_sizes"], feats):
        if meta["is_ins_norm"]:
            feat = instance_norm(feat)
        if meta["head"] == "aspp":
            acc = None
            for i, d in enumerate(meta["aspp_dilations"]):
                z = _conv(feat, g_params["aspp"][i], dilation=d)
                acc = z if acc is None else acc + z
            c = acc.shape[1] // g_size
            head_logits += [acc[:, hi * c:(hi + 1) * c] for hi in range(g_size)]
        else:
            h, w = feat.shape[2], feat.shape[3]
            acc = _conv(feat, g_params["last_feat"])   # all heads' 512s
            pooled = adaptive_avg_pool_multi(feat, meta["pool_scales"])
            both = {sc: F.relu(_conv(pooled[sc], g_params["ppm_scales"][sc]))
                    for sc in meta["pool_scales"]}
            us = _ppm_pooled_heads(both, g_params, g_size, meta["pool_scales"],
                                   h, w, feat.dtype)
            acc = F.relu(acc + us)
            head_logits += [
                _conv(acc[:, hi * 512:(hi + 1) * 512], g_params["classifier"][hi])
                for hi in range(g_size)
            ]
    return eval_tail(head_logits, in_hw)


class FastpathModel:
    """Callable like the eval-mode ``DeeplabV2``: ``model(x)`` runs the
    folded forward on serving params from :func:`build_serving_params`."""

    def __init__(self, meta: Dict[str, Any], params: Dict[str, Any]):
        self.meta = meta
        self.params = params

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return serving_forward(self.meta, self.params, x)


def check_fastpath_tile(tile) -> None:
    """CLI guard: the space-to-depth stem needs even tile sides."""
    if tile[0] % 2 or tile[1] % 2:
        raise SystemExit(
            f"--fastpath requires even tile sides (space-to-depth stem), "
            f"got {tuple(tile)}; rerun without --fastpath")


def build_fastpath(
    model: DeeplabV2,
    dtype: torch.dtype = torch.bfloat16,
    int8: bool = False,
    calibration_batches=None,
    fused_stages: Tuple[int, ...] = (),
    int8_stages: Optional[Tuple[int, ...]] = None,
) -> FastpathModel:
    """CLI-facing entry: fold ``model`` and return a callable ready for
    ``make_predictor`` / ``evaluate_dataset``. s2b layer4 stays off as in
    the JAX package's ``build_fastpath``."""
    if int8 or calibration_batches is not None or int8_stages:
        raise NotImplementedError("int8 serving and calibration are not "
                                  "ported yet (ROADMAP.md queue A)")
    meta, params = build_serving_params(
        model, dtype=dtype, s2b_layer4=False, fused_stages=fused_stages)
    return FastpathModel(meta, params)


def make_serving_fn(
    model: DeeplabV2,
    dtype: torch.dtype = torch.bfloat16,
    s2b_layer4: bool = False,
    heads_int8: bool = False,
    int8_stages: Tuple[int, ...] = (),
    fused_stages: Tuple[int, ...] = (),
):
    """Returns ``(apply_fn, params)`` with ``apply_fn(params, images)`` the
    folded eval forward."""
    meta, params = build_serving_params(
        model, dtype=dtype, s2b_layer4=s2b_layer4, heads_int8=heads_int8,
        int8_stages=int8_stages, fused_stages=fused_stages)
    return functools.partial(serving_forward, meta), params
