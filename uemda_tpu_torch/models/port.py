"""Weights carried across: flax variables and checkpoints -> the port's
state dict.

The port's own copy of the mapping in ``uemda_tpu/models/port_torch.py:
182-276`` (``export_deeplabv2``). Keys are the reference's module names
(``encoder.resnet.*``, ``layer5.*``/``layer6.*`` or ``cls_pred.*``), which
are also the port's, so a reference ``.pth`` loads directly. Conventions:
flax conv kernel (kh, kw, I, O) -> torch weight (O, I, kh, kw); flax BN
``scale``/``bias`` params and ``mean``/``var`` batch_stats -> ``weight``/
``bias``/``running_mean``/``running_var``. The same conventions carry the
adversarial discriminators, the MMD baseline's reduction and head (a flax
Dense kernel (in, out) -> a Linear weight (out, in)), ``TransNorm2d``
(its four statistics keep their names) and ``SpixelNet``.
"""

import re
from typing import Dict

import numpy as np
import torch


def _conv_back(w) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def _bn_back(out: Dict[str, torch.Tensor], prefix: str, p: Dict, s: Dict):
    out[prefix + ".weight"] = _vec(p["bn"]["scale"])
    out[prefix + ".bias"] = _vec(p["bn"]["bias"])
    out[prefix + ".running_mean"] = _vec(s["bn"]["mean"])
    out[prefix + ".running_var"] = _vec(s["bn"]["var"])
    out[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _backbone(enc_p: Dict, enc_s: Dict, deep_stem: bool) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if deep_stem:
        for i, (ci, bi) in enumerate([(0, 1), (3, 4), (6, 7)]):
            out[f"stem.{ci}.weight"] = _conv_back(enc_p[f"stem_conv{i + 1}"]["kernel"])
            _bn_back(out, f"stem.{bi}", enc_p[f"stem_bn{i + 1}"],
                     enc_s[f"stem_bn{i + 1}"])
    else:
        out["conv1.weight"] = _conv_back(enc_p["conv1"]["kernel"])
        _bn_back(out, "bn1", enc_p["bn1"], enc_s["bn1"])
    for lname, ltree in enc_p.items():
        if not lname.startswith("layer"):
            continue
        for bname, btree in ltree.items():
            tp = f"{lname}.{bname[len('block'):]}"
            for sub, stree in btree.items():
                if sub.startswith("conv"):
                    out[f"{tp}.{sub}.weight"] = _conv_back(stree["kernel"])
                elif sub.startswith("bn"):
                    _bn_back(out, f"{tp}.{sub}", stree, enc_s[lname][bname][sub])
                elif sub == "ds_conv":
                    out[f"{tp}.downsample.0.weight"] = _conv_back(stree["kernel"])
                elif sub == "ds_bn":
                    _bn_back(out, f"{tp}.downsample.1", stree,
                             enc_s[lname][bname][sub])
    return out


def state_dict_from_jax(variables: Dict, use_ppm: bool = True,
                        deep_stem: bool = False, pool_scales=(1, 2, 3, 6),
                        dilations=(6, 12, 18, 24)) -> Dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` (nested dicts of numpy arrays) ->
    the port's state dict (f32 CPU tensors) under the reference's keys."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = {"encoder.resnet." + k: v for k, v in _backbone(
        params["encoder"], stats.get("encoder", {}), deep_stem).items()}
    for hn in ("layer5", "layer6", "cls_pred"):
        if hn not in params:
            continue
        hp, hs = params[hn], stats.get(hn, {})
        if use_ppm:
            for i, scale in enumerate(pool_scales):
                out[f"{hn}.ppm.{i}.1.weight"] = _conv_back(hp[f"ppm{scale}_conv"]["kernel"])
                _bn_back(out, f"{hn}.ppm.{i}.2", hp[f"ppm{scale}_bn"],
                         hs[f"ppm{scale}_bn"])
            out[f"{hn}.conv_last.0.weight"] = _conv_back(hp["last_conv"]["kernel"])
            _bn_back(out, f"{hn}.conv_last.1", hp["last_bn"], hs["last_bn"])
            out[f"{hn}.conv_last.4.weight"] = _conv_back(hp["classifier"]["kernel"])
            out[f"{hn}.conv_last.4.bias"] = _vec(hp["classifier"]["bias"])
        else:
            for i, d in enumerate(dilations):
                out[f"{hn}.conv2d_list.{i}.weight"] = _conv_back(hp[f"aspp_d{d}"]["kernel"])
                out[f"{hn}.conv2d_list.{i}.bias"] = _vec(hp[f"aspp_d{d}"]["bias"])
    return out


def _dense_back(w) -> torch.Tensor:
    """flax Dense kernel (in, out) -> torch Linear weight (out, in)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).T))


# the flax auto-names of each discriminator's convs, in order, and the
# port's module names (``models/discriminator.py``)
_DISC_CONVS = {
    "fc": ["convs.0", "convs.1", "convs.2", "convs.3", "classifier"],
    "local": ["convs.0", "convs.1", "convs.2", "classifier"],
    "pixel": ["conv1", "conv2", "src", "tgt"],
}


def discriminator_state_dict_from_jax(params: Dict, kind: str = "fc"
                                      ) -> Dict[str, torch.Tensor]:
    """A flax discriminator's ``params`` (``Conv_0``, ``Conv_1``, ...) ->
    the state dict of the port's ``FCDiscriminator`` (``kind`` "fc"),
    ``FCDiscriminatorLocal`` ("local") or ``PixelDiscriminator``
    ("pixel"): kernels HWIO -> OIHW, biases as they are."""
    names = _DISC_CONVS[kind]
    if sorted(params) != sorted(f"Conv_{i}" for i in range(len(names))):
        raise KeyError(f"{kind} discriminator: params {sorted(params)}")
    out = {}
    for i, name in enumerate(names):
        out[f"{name}.weight"] = _conv_back(params[f"Conv_{i}"]["kernel"])
        out[f"{name}.bias"] = _vec(params[f"Conv_{i}"]["bias"])
    return out


def reduction_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``ReductionLayer``'s ``Dense_0``/``Dense_1`` -> ``fc1``/
    ``fc2`` (kernels (in, out) -> weights (out, in))."""
    return {f"fc{i + 1}.{k}": (_dense_back(params[f"Dense_{i}"]["kernel"])
                               if k == "weight"
                               else _vec(params[f"Dense_{i}"]["bias"]))
            for i in range(2) for k in ("weight", "bias")}


def mmd_state_dict_from_jax(variables: Dict, deep_stem: bool = False,
                            dilations=(6, 12, 18, 24)
                            ) -> Dict[str, torch.Tensor]:
    """A flax ``DeeplabV2MMD``'s variables -> the port's state dict:
    the encoder as :func:`state_dict_from_jax`'s, the ASPP head under
    ``cls_pred`` and the reduction under ``reduction``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out = {"encoder.resnet." + k: v for k, v in _backbone(
        params["encoder"], stats.get("encoder", {}), deep_stem).items()}
    for i, d in enumerate(dilations):
        conv = params["cls_pred"][f"aspp_d{d}"]
        out[f"cls_pred.conv2d_list.{i}.weight"] = _conv_back(conv["kernel"])
        out[f"cls_pred.conv2d_list.{i}.bias"] = _vec(conv["bias"])
    out.update({"reduction." + k: v for k, v in
                reduction_state_dict_from_jax(params["reduction"]).items()})
    return out


def trans_norm_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``TransNorm2d``'s ``scale``/``bias`` and its four
    ``batch_stats`` -> ``weight``/``bias`` and the buffers under their
    names."""
    p, s = variables["params"], variables["batch_stats"]
    out = {"weight": _vec(p["scale"]), "bias": _vec(p["bias"])}
    for k in ("mean_source", "mean_target", "var_source", "var_target"):
        out[k] = _vec(s[k])
    return out


def spixelnet_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A flax ``SpixelNet``'s variables -> the port's state dict: each
    ``conv{i}a``/``conv{i}b``/``up{i}`` block's ``Conv_0`` and
    ``BatchNorm_0`` to ``.conv`` and ``.bn``; the decoder's resize convs,
    auto-named ``Conv_0``-``Conv_3`` from the deepest level up, to
    ``deconv3``-``deconv0``, and ``Conv_4`` to ``pred`` (kernels HWIO ->
    OIHW)."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    def conv(name, tree):
        out[f"{name}.weight"] = _conv_back(tree["kernel"])
        out[f"{name}.bias"] = _vec(tree["bias"])

    for name, tree in p.items():
        if name.startswith("Conv_"):
            i = int(name[len("Conv_"):])
            conv("pred" if i == 4 else f"deconv{3 - i}", tree)
        else:
            conv(f"{name}.conv", tree["Conv_0"])
            _bn_back(out, f"{name}.bn", {"bn": tree["BatchNorm_0"]},
                     {"bn": s[name]["BatchNorm_0"]})
    return out


def save_npz(path: str, state_dict: Dict[str, torch.Tensor]) -> str:
    """Write a state dict as ``.npz`` (one array per key)."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state_dict.items()})
    return path


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth``/``.pt`` (optionally under ``state_dict``) or an
    ``.npz`` written by :func:`save_npz` -> state dict on the CPU."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


# a block's key in a torchvision-style checkpoint
_BLOCK_KEY = re.compile(r"^layer\d\.\d+\.")


def load_pretrained_backbone(model, path: str) -> None:
    """Load a torchvision-style ImageNet ResNet checkpoint (``.pth`` or
    ``.pt``, keys ``conv1.weight``, ``layer1.0.conv1.weight``, ... or the
    v1c ``stem.*``) into ``model.encoder.resnet`` in place, as
    ``init_variables(pretrained=...)`` does through
    ``port_imagenet_backbone`` (``uemda_tpu/train/loop.py:75-81``): every
    trunk weight and BatchNorm statistic comes from the file, the heads
    keep their init, ``fc.*`` and ``num_batches_tracked`` are ignored. A
    trunk key the model has and the file lacks, a trunk key of the file the
    model lacks (another depth), or a shape mismatch raises before anything
    is written. A full model's state dict (reference keys, ``encoder.*``:
    what ``tools/real_data_gate.py --kind imagenet --out`` writes) loads
    whole and strictly, as the JAX package loads a full-variables
    ``--pretrained`` file. Any other suffix (a JAX ``.msgpack``) is
    refused: convert it with ``tools/port_weights.py --kind export`` and
    load the ``.pth``."""
    if not path.endswith((".pth", ".pt")):
        raise ValueError(
            f"--pretrained {path!r}: the port reads torchvision-style .pth/.pt "
            "ImageNet weights; convert a JAX checkpoint with "
            "'python tools/port_weights.py --kind export' first")
    sd = load_checkpoint(path)
    if any(k.startswith("encoder.") for k in sd):
        model.load_state_dict(sd)
        return
    trunk = model.encoder.resnet
    own = {k: v for k, v in trunk.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"{path}: no {missing[:3]} ... for the "
                       f"{model.config.backbone.resnet_type} trunk")
    extra = sorted(k for k in sd if _BLOCK_KEY.match(k) and k not in own
                   and not k.endswith("num_batches_tracked"))
    if extra:
        raise KeyError(f"{path}: trunk keys {extra[:3]} ... that the "
                       f"{model.config.backbone.resnet_type} trunk lacks")
    for k, v in own.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{path}: {k} is {tuple(sd[k].shape)}, the "
                             f"model's {tuple(v.shape)}")
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(sd[k].to(v.dtype))


def aligner_from_jax(aligner, device=None):
    """The JAX package's ``AlignerState`` (or any object with its fields:
    ``prototypes``, ``data_sum``, ``data_cnt`` as arrays, ``decay``,
    ``ignore_label``) -> the port's, f32 on ``device`` (None: the card)."""
    from uemda_tpu_torch.alignment.prototypes import AlignerState
    from uemda_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    return AlignerState(prototypes=t(aligner.prototypes),
                        data_sum=t(aligner.data_sum),
                        data_cnt=t(aligner.data_cnt),
                        decay=float(aligner.decay),
                        ignore_label=int(aligner.ignore_label))


def load_prototypes(path: str) -> torch.Tensor:
    """(C, K) f32 prototypes on the CPU from a ``.pth``/``.pt`` holding the
    tensor (as the reference and ``on_best`` save them) or a ``.npy``."""
    if path.endswith(".npy"):
        return torch.from_numpy(np.load(path).astype(np.float32))
    return torch.load(path, map_location="cpu", weights_only=True).float()
