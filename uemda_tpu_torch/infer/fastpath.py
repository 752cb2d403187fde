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
  ``fused_stem=True``; there is no unfused stem on the card). The v1c deep
  stem folds its three 3x3 convs, the first re-indexed for the
  space-to-depth input (2x2 on 12 channels, padding (1, 0)), and runs them
  and the max-pool as library ops, with no K2, as the JAX package does
  (``uemda_tpu/infer/fastpath.py:337-358,599-600``).
* **Space-to-batch layer4** (``s2b_layer4``): blocks 1+ of the dilate-2
  stage run as dense 3x3s on a 4x batch of half-resolution phases.
* **Fused dual head**: the heads sharing a feature stack their feature-side
  3x3 convs into one conv, and the pooled pyramid branch runs as tap GEMMs on
  the tiny pooled maps followed by one separable-upsample GEMM
  (:func:`_ppm_pooled_heads`) -- no full-resolution pooled map exists.
* Instance norm is the K1 kernel and the eval tail the K3 kernel.
* **Fused identity blocks** (``fused_stages``, opt-in): the blocks of the
  listed stages that keep their width run in the K4 kernel
  (:func:`_fusable`, ``ops/resblock.py``), which keeps the block's
  intermediates on chip. ResNeXt's grouped blocks stay off K4.
* **int8 serving** (opt-in): the heads' feature-side GEMM and the 3x3s of
  ``int8_stages`` hold per-out-channel int8 weights (:func:`_quantize_w`)
  and run as int8 x int8 -> int32 products (:func:`_conv_int8`, through
  ``torch._int_mm``) with a dynamic per-tensor activation scale, or the
  static one :func:`calibrate_act_scales` embeds.
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
from uemda_tpu_torch.ops.resblock import bottleneck_identity
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


def _conv(x, p, stride=1, dilation=1, groups=1):
    """SAME conv on folded params {'w' OIHW, 'b' f32}; the bias is added in
    the activation dtype."""
    w = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype)
    return F.conv2d(x, w, b, stride, dilation * (w.shape[-1] - 1) // 2,
                    dilation, groups)


def _quantize_sym(x: torch.Tensor, dims, floor: float = 1e-12):
    """Symmetric abs-max int8 quantization over ``dims``, as
    ``uemda_tpu/infer/quant.py:_quantize_sym``: scale = max(amax, floor) /
    127, q = clip(round-half-even(x / scale), -127, 127). Returns (q int8,
    scale f32 with ``dims`` kept)."""
    amax = x.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(amax, min=floor) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_w(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-out-channel symmetric int8 quantization of a folded OIHW weight
    (f32): (q int8 OIHW, scale f32 (O,))."""
    q, s = _quantize_sym(torch.from_numpy(np.asarray(w, np.float32)), (1, 2, 3))
    return q.numpy(), s.reshape(-1).numpy()


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N) through ``torch._int_mm``
    (cuBLASLt on the card). K and N are padded to multiples of 8 and M to
    more than 16 with zeros, which the card's int8 GEMM needs; zeros add
    nothing to an integer sum, so this is exact."""
    m, k = a.shape
    n = b.shape[1]
    pk, pn, pm = -k % 8, -n % 8, max(0, 17 - m)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    bt = b.t()
    if pk or pn:
        bt = F.pad(bt, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return out[:m, :n]


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride=(1, 1),
                padding=(0, 0), dilation=(1, 1), groups: int = 1
                ) -> torch.Tensor:
    """Exact int8 conv: xq (B, C, H, W) int8, wq (O, C/groups, kh, kw) int8
    -> int32 (B, O, Ho, Wo) in channels_last memory, as an int8 im2col of
    the zero-padded input times the weight matrix, one product a group."""
    bsz, c, h, w = xq.shape
    o, cg, kh, kw = wq.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = F.pad(xq, (pw, pw, ph, ph)) if ph or pw else xq
    xn = xp.permute(0, 2, 3, 1)                       # (B, Hp, Wp, C)
    taps = [xn[:, ky * dh:ky * dh + sh * (ho - 1) + 1:sh,
               kx * dw:kx * dw + sw * (wo - 1) + 1:sw]
            for ky in range(kh) for kx in range(kw)]  # each (B, Ho, Wo, C)
    cols = taps[0].unsqueeze(3) if len(taps) == 1 else torch.stack(taps, 3)
    og = o // groups
    outs = []
    for gi in range(groups):
        a = cols[..., gi * cg:(gi + 1) * cg].reshape(bsz * ho * wo, kh * kw * cg)
        wg = wq[gi * og:(gi + 1) * og].permute(0, 2, 3, 1).reshape(og, -1)
        outs.append(_int_mm(a, wg.t()))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(bsz, ho, wo, o).permute(0, 3, 1, 2)


# Collector for activation-scale calibration: lists appended in forward-visit
# order with each dynamic int8 site's amax and its weight shape, set only
# during a calibration forward (:func:`_amax_visit`). The shapes let
# calibration check the visit order against the params walk.
_AMAX_COLLECTOR: Optional[list] = None
_SIG_COLLECTOR: Optional[list] = None
_LAST_VISIT_SIGS: Optional[list] = None


def _conv_int8(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
               b: torch.Tensor, stride=1, dilation=1, groups=1,
               a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 x int8 -> int32 SAME conv; the dequantized epilogue returns
    x's dtype. The activation scale is the dynamic per-tensor
    ``max(amax, 1e-8) / 127``, or the static calibrated ``a``. In JAX's
    order: ``round(x / a)`` (a division, round-half-even), clamp to +-127,
    then ``(acc * (a * w_scale)) + b`` in f32, cast to x's dtype."""
    k = wq.shape[-1]
    p = dilation * (k - 1) // 2
    x32 = x.float()
    if a is None:
        amax = x32.abs().amax()
        if _AMAX_COLLECTOR is not None:
            _AMAX_COLLECTOR.append(amax)
            _SIG_COLLECTOR.append(tuple(wq.shape))
        a = torch.clamp(amax, min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x32 / a), -127, 127).to(torch.int8)
    acc = int8_conv2d(xq, wq, (stride, stride), (p, p), (dilation, dilation),
                      groups)
    y = acc.float() * (a * w_scale).view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    return y.to(x.dtype)


def _conv_any(x, p: Dict[str, Any], **kw):
    """Dispatch on the params entry: {'w', 'b'} -> a conv in the serving
    dtype; {'wq', 's', 'b'} -> the int8 conv (with the static activation
    scale 'a' once calibrated)."""
    if "wq" in p:
        return _conv_int8(x, p["wq"], p["s"], p["b"], a=p.get("a"), **kw)
    return _conv(x, p, **kw)


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
    weights in ``dtype`` (channels_last) with f32 biases. ``heads_int8``
    quantizes the heads' feature-side conv (the stacked PPM ``last_feat``
    3x3, or the ASPP convs); ``int8_stages`` the 3x3s of those backbone
    stages (their 1x1s and downsamples stay in ``dtype``);
    ``fused_stages`` sends those stages' identity blocks to K4."""
    cfg = model.config
    block_cls, layers, groups, _, deep_stem = RESNET_SPECS[
        cfg.backbone.resnet_type]
    dev = next(model.parameters()).device
    enc = model.encoder.resnet
    meta = {
        "block": "basic" if block_cls is BasicBlock else "bottleneck",
        "groups": groups,
        "deep_stem": deep_stem,
        # stages whose identity bottleneck blocks run in the K4 kernel
        "fused_stages": tuple(fused_stages),
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

    def put_q(w, b):
        q, sc = _quantize_w(w)
        return {"wq": torch.from_numpy(q).to(dev),
                "s": torch.from_numpy(sc).to(dev),
                "b": torch.from_numpy(np.asarray(b, np.float32)).to(dev)}

    out: Dict[str, Any] = {}
    if deep_stem:
        stems = []
        for i in (0, 3, 6):
            w, b = _fold(enc.stem[i], enc.stem[i + 1])
            if i == 0:   # HWIO (2, 2, 12, 32) -> OIHW
                w = _s2d_stem_kernel(w.transpose(2, 3, 1, 0)).transpose(
                    3, 2, 0, 1)
            stems.append(put(w, b))
        out["deep_stem"] = stems
    else:
        w, b = _fold(enc.conv1, enc.bn1)
        w2 = _s2d_stem_kernel(w.transpose(2, 3, 1, 0))    # HWIO (4,4,12,64)
        out["stem"] = {
            "w": torch.from_numpy(np.ascontiguousarray(w2)).to(dev, dtype),
            "b": torch.from_numpy(np.asarray(b, np.float32)).to(dev)}

    n_stages = 4 if cfg.backbone.include_conv5 else 3
    for li in range(n_stages):
        # int8 only on the compute-bound 3x3s of the listed stages
        q33 = (li + 1) in int8_stages
        blocks = []
        for blk_m in getattr(enc, f"layer{li + 1}"):
            names = ("1", "2") + (("3",) if block_cls is not BasicBlock else ())
            blk = {}
            for n in names:
                w, b = _fold(getattr(blk_m, f"conv{n}"), getattr(blk_m, f"bn{n}"))
                blk[f"conv{n}"] = (put_q if q33 and w.shape[-1] == 3
                                   else put)(w, b)
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
        mk_head = put_q if heads_int8 else put
        if not cfg.use_ppm:
            g["aspp"] = [
                mk_head(
                    np.concatenate([_np(h.conv2d_list[i].weight) for h in heads]),
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
        g["last_feat"] = mk_head(np.concatenate([w[:, :fc] for w, _ in lasts]),
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
        y = F.relu(_conv_any(x, blk["conv1"], stride=stride, dilation=dilation))
        y = _conv_any(y, blk["conv2"],
                      dilation=dilation if dilation2 is None else dilation2)
    else:
        y = F.relu(_conv_any(x, blk["conv1"]))
        y = F.relu(_conv_any(y, blk["conv2"], stride=stride, dilation=dilation,
                             groups=meta["groups"]))
        y = _conv_any(y, blk["conv3"])
    if "ds" in blk:
        identity = _conv_any(x, blk["ds"], stride=stride)
    return F.relu(y + identity)


def _fusable(blk, meta, dilate) -> bool:
    """An identity bottleneck the K4 kernel takes: stride 1 (blocks 1+ of a
    stage always are), no grouped conv, no downsample branch, entries in
    the serving dtype (not int8), a 3x3 middle conv; dilated stages fuse
    too."""
    return (
        meta["block"] == "bottleneck"
        and dilate >= 1
        and meta["groups"] == 1
        and "ds" not in blk
        and all("w" in blk[c] for c in ("conv1", "conv2", "conv3"))
        and tuple(blk["conv2"]["w"].shape[-2:]) == (3, 3)
    )


def _stage_forward(x, blocks, meta, stride, dilate, s2b: bool, li: int = -1):
    """First block dilation dilate//2, later blocks dilate (``stage_plan``);
    ``li`` (the 1-based stage number) in ``meta['fused_stages']`` sends
    blocks 1+ that :func:`_fusable` admits to K4, the others to
    :func:`_block_forward`; otherwise, with ``s2b`` and dilate 2, blocks 1+
    run on the 2x2 space-to-batch phases as dense 3x3s (exact)."""
    x = _block_forward(x, blocks[0], meta, stride, max(dilate // 2, 1),
                       dilation2=dilate)
    rest = blocks[1:]
    if rest and li in meta["fused_stages"]:
        for blk in rest:
            if _fusable(blk, meta, dilate):
                # weights in x's dtype, as _conv casts them (an f32
                # calibration batch through a bf16 model)
                w1, w2, w3 = (blk[c]["w"].to(x.dtype)
                              for c in ("conv1", "conv2", "conv3"))
                x = bottleneck_identity(
                    x, w1, blk["conv1"]["b"], w2, blk["conv2"]["b"],
                    w3, blk["conv3"]["b"], dilation=dilate)
            else:
                x = _block_forward(x, blk, meta, 1, dilate)
        return x
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
    if meta["deep_stem"]:
        s1, s2, s3 = params["deep_stem"]
        # the s2d 2x2 kernel's padding (1, 0) per axis, then library convs
        y = F.relu(_conv(F.pad(y, (1, 0, 1, 0)), s1))
        y = F.relu(_conv(y, s2))
        y = F.max_pool2d(F.relu(_conv(y, s3)), 3, 2, 1)
    else:
        y = stem_pool(y, params["stem"]["w"].to(y.dtype), params["stem"]["b"])

    plan = stage_plan(meta["output_stride"])
    n_stages = 4 if meta["include_conv5"] else 3
    outs = []
    for li in range(n_stages):
        stride, dilate = plan[li]
        y = _stage_forward(y, params[f"layer{li + 1}"], meta, stride, dilate,
                           s2b=meta["s2b_layer4"], li=li + 1)
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
                z = _conv_any(feat, g_params["aspp"][i], dilation=d)
                acc = z if acc is None else acc + z
            c = acc.shape[1] // g_size
            head_logits += [acc[:, hi * c:(hi + 1) * c] for hi in range(g_size)]
        else:
            h, w = feat.shape[2], feat.shape[3]
            acc = _conv_any(feat, g_params["last_feat"])  # all heads' 512s
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


def _map_int8_entries(tree, fn):
    """Rebuild the serving-params structure, applying ``fn`` to every int8
    conv entry (a dict holding 'wq')."""
    if isinstance(tree, dict):
        if "wq" in tree:
            return fn(tree)
        return {k: _map_int8_entries(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_int8_entries(v, fn) for v in tree]
    return tree


@torch.no_grad()
def _amax_visit(meta, params, x) -> np.ndarray:
    """One calibration forward: every dynamic int8 site's amax, in
    forward-visit order (their weight shapes go to ``_LAST_VISIT_SIGS``).
    It reads the amaxes back to the host, so it runs eagerly: never under
    a CUDA graph capture."""
    global _AMAX_COLLECTOR, _SIG_COLLECTOR, _LAST_VISIT_SIGS
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("int8 calibration reads activation maxima back "
                           "to the host and cannot run under a CUDA graph "
                           "capture; calibrate before making a predictor")
    _AMAX_COLLECTOR, _SIG_COLLECTOR = [], []
    try:
        serving_forward(meta, params, x)
        _LAST_VISIT_SIGS = list(_SIG_COLLECTOR)
        if not _AMAX_COLLECTOR:
            return np.zeros((0,), np.float32)
        return torch.stack(_AMAX_COLLECTOR).cpu().numpy()
    finally:
        _AMAX_COLLECTOR = _SIG_COLLECTOR = None


def calibrate_act_scales(meta: Dict[str, Any], params: Dict[str, Any],
                         batches) -> Dict[str, Any]:
    """Post-training calibration of static int8 activation scales
    (``uemda_tpu/infer/fastpath.py:716-775``): one forward per batch of
    ``batches`` (normalized (B, 3, H, W) tensors on the params' device)
    records every int8 site's dynamic amax; the entries then carry
    ``a = max over batches(amax) / 127``. Sites match entries by
    forward-visit order, checked against the params walk: a different count
    or order of weight shapes raises AssertionError. Old scales are dropped
    first (re-calibration); when no batch is consumed the original params
    come back unchanged."""
    original_params = params
    params = _map_int8_entries(
        params, lambda e: {k: v for k, v in e.items() if k != "a"})
    walk_sigs: list = []

    def _collect_sig(e):
        walk_sigs.append(tuple(e["wq"].shape))
        return e

    _map_int8_entries(params, _collect_sig)
    agg = None
    for x in batches:
        cur = _amax_visit(meta, params, x)
        agg = cur if agg is None else np.maximum(agg, cur)
    if agg is None or agg.size == 0:
        return original_params
    if agg.size != len(walk_sigs):
        raise AssertionError(
            f"calibration visited {agg.size} int8 convs but the params hold "
            f"{len(walk_sigs)} int8 entries -- forward/walk order contract "
            "broken")
    if _LAST_VISIT_SIGS is not None and list(_LAST_VISIT_SIGS) != walk_sigs:
        raise AssertionError(
            "int8 calibration order mismatch: forward-visit shapes "
            f"{_LAST_VISIT_SIGS} != params-walk shapes {walk_sigs}")
    it = iter(agg.tolist())

    def embed(entry):
        a = torch.tensor(max(next(it), 1e-8) / 127.0, dtype=torch.float32,
                         device=entry["wq"].device)
        return {**entry, "a": a}

    return _map_int8_entries(params, embed)


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


def parse_int8_stages_flag(int8_stages: str, int8: bool, fastpath: bool):
    """CLI guard for ``--int8-stages``, called right after argparse so that
    a bad value fails before any calibration work, and the flag is never
    silently ignored without ``--fastpath 1 --int8 1``. Returns a stage
    tuple or None."""
    if not int8_stages:
        return None
    if not fastpath or not int8:
        raise SystemExit(
            "--int8-stages requires --fastpath 1 --int8 1 "
            "(it selects which fastpath backbone stages to quantize)")
    try:
        stages = tuple(int(t) for t in int8_stages.split(",") if t.strip())
    except ValueError:
        stages = ()
    if not stages or any(t not in (1, 2, 3, 4) for t in stages):
        raise SystemExit(
            f"--int8-stages must be a comma list from 1-4, got {int8_stages!r}")
    return stages


def build_fastpath(
    model: DeeplabV2,
    dtype: torch.dtype = torch.bfloat16,
    int8: bool = False,
    calibration_batches=None,
    fused_stages: Tuple[int, ...] = (),
    int8_stages: Optional[Tuple[int, ...]] = None,
) -> FastpathModel:
    """CLI-facing entry: fold ``model`` and return a callable ready for
    ``make_predictor`` / ``evaluate_dataset``; s2b layer4 stays off, as in
    the JAX package's ``build_fastpath``. ``int8`` quantizes the heads'
    feature-side conv and the 3x3s of ``int8_stages`` (default (3, 4));
    ``calibration_batches`` (normalized (B, 3, H, W) tensors) then embeds
    static activation scales (:func:`calibrate_act_scales`).
    ``fused_stages`` runs those stages' identity blocks in K4."""
    if int8_stages is None:
        int8_stages = (3, 4)
    meta, params = build_serving_params(
        model, dtype=dtype, s2b_layer4=False, heads_int8=int8,
        int8_stages=int8_stages if int8 else (), fused_stages=fused_stages)
    if int8 and calibration_batches is not None:
        params = calibrate_act_scales(meta, params, calibration_batches)
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
