"""Readiness gate for real weights: checksum -> port and load -> parity ->
optional evaluation, in one command.

Twin of ``tools/real_data_gate.py``::

    python -m uemda_tpu_torch.tools.real_data_gate --torch-ckpt \\
        resnet50-19c8e357.pth [--out model.pth] \\
        [--reference-root REF | --skip-parity]
    python -m uemda_tpu_torch.tools.real_data_gate --torch-ckpt \\
        Vaihingen_best.pth --kind deeplabv2 --run-eval --config-path \\
        2vaihingen [--reference-root REF | --skip-parity]

* **checksum**: torchvision file names carry the first 8 hex digits of
  the file's SHA-256 (``torch.hub``'s check); :data:`KNOWN_SHA8` is the
  reference's URL list (``uemda/_resnets.py:7-17``). ``--expect-sha256``
  pins a full digest or a prefix instead. A trained reference checkpoint
  has no canonical digest: it is recorded and passes unless pinned.
* **port and load**: ``--kind deeplabv2`` loads the reference ``.pth``
  strictly into the flagship ``DeeplabV2`` (the port's modules carry the
  reference's key names); ``--kind imagenet`` loads a torchvision trunk
  into it (``models/port.load_pretrained_backbone``), the heads keeping
  the port's seeded init (seed 0). ``--out`` writes the loaded model's
  full state dict as a ``.pth``, which the trainers' ``--ckpt-model`` and
  ``--pretrained`` read (the JAX tool writes flax variables as
  ``.msgpack``).
* **parity**: the reference's own torch module, imported from
  ``--reference-root`` (``tools/reference.py``), against the port's, on
  the same state dict, both in f32 with TF32 off on one device: the eval
  forward for deeplabv2, the encoder's pyramid for imagenet; max abs
  difference within ``--parity-tol``. Without a checkout (none given, or
  none at the path) the stage fails unless ``--skip-parity`` is given.
* **eval** (``--run-eval``, deeplabv2 only): ``infer/evaluate.
  evaluate_dataset`` on the val split of ``--config-path`` (bf16 on the
  card, f32 on the CPU, as the eval CLI).

Prints one JSON line with the JAX tool's keys; exits 0 only if every
requested stage passes. Runs on the card unless ``--device cpu``.
"""

import argparse
import contextlib
import hashlib
import json
import os

import numpy as np
import torch

from uemda_tpu_torch.models import DeeplabV2, DeeplabV2Config
from uemda_tpu_torch.models.config import BackboneConfig
from uemda_tpu_torch.models.resnet import ResNetEncoder
from uemda_tpu_torch.models.port import load_pretrained_backbone
from uemda_tpu_torch.utils.runtime import resolve_device

# reference torchvision/openmmlab weight files and their SHA-256 prefixes
# (the file names of uemda/_resnets.py:7-17, torch.hub's check)
KNOWN_SHA8 = {
    "resnet18": "5c106cde",
    "resnet34": "333f7ec4",
    "resnet50": "19c8e357",
    "resnet101": "5d3b4d8f",
    "resnet152": "b121ed2d",
    "resnext50_32x4d": "7cdf4587",
    "resnext101_32x8d": "8ba56ff5",
    "resnext101_32x4d": "a5af3160",
    "resnet50_v1c": "2cccc1ad",
    "resnet101_v1c": "e67eebb6",
}


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def check_sum(args, out) -> bool:
    """The checksum stage (``tools/real_data_gate.py:68-87``): records
    ``sha256`` and ``sha_ok`` (and ``sha_expected_prefix`` for an
    ImageNet trunk) in ``out``; True if the run may go on."""
    digest = sha256_file(args.torch_ckpt)
    out["sha256"] = digest
    if args.expect_sha256:
        ok = digest.startswith(args.expect_sha256.lower())
        out["sha_ok"] = ok
        return ok
    if args.kind == "imagenet":
        want = KNOWN_SHA8.get(args.resnet_type)
        out["sha_expected_prefix"] = want
        ok = want is not None and digest.startswith(want)
        out["sha_ok"] = ok
        return ok or args.allow_unverified
    # a trained reference checkpoint has no canonical digest: recorded,
    # and it passes unless pinned
    out["sha_ok"] = None
    return True


def load_ref_sd(path: str):
    """A reference ``.pth`` (optionally under ``state_dict``, DataParallel
    ``module.`` prefixes dropped) on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()}


# the first PPM head's classifier in a reference Deeplabv2 state dict
_CLASSIFIER = "layer5.conv_last.4.weight"


def flagship(num_classes: int, resnet_type: str, device) -> DeeplabV2:
    """The flagship config every reference tool instantiates, from the
    port's seeded init (seed 0)."""
    return DeeplabV2(DeeplabV2Config.uemda_default(num_classes,
                                                   resnet_type=resnet_type),
                     device=device, generator=torch.Generator().manual_seed(0))


def port_and_load(args, sd, device) -> DeeplabV2:
    """The port-and-load stage: the reference state dict ``sd`` (the file
    at ``args.torch_ckpt``) in the flagship model on ``device``, f32, eval
    mode. A deeplabv2 checkpoint brings its own class count (its first
    head's classifier), as the JAX tool's ported variables do;
    ``--num-classes`` sizes the ImageNet model's heads and the reference
    module of the parity stage."""
    if args.kind == "deeplabv2":
        if _CLASSIFIER not in sd:
            raise KeyError(f"{args.torch_ckpt}: no {_CLASSIFIER}, not a "
                           "dual-PPM-head Deeplabv2 checkpoint")
        model = flagship(sd[_CLASSIFIER].shape[0], args.resnet_type, device)
        model.load_state_dict(sd)
    else:
        model = flagship(args.num_classes, args.resnet_type, device)
        load_pretrained_backbone(model, args.torch_ckpt)
    return model.eval()


@contextlib.contextmanager
def full_f32(device):
    """f32 without TF32 (the JAX tool's exact-math parity on the CPU), and,
    on the CPU, the reference's hard-coded ``.cuda()`` as a no-op, as the
    test oracle makes it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(), torch.Tensor.cuda,
             torch.nn.Module.cuda)
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if device.type == "cpu":
        torch.Tensor.cuda = lambda self, *a, **k: self
        torch.nn.Module.cuda = lambda self, *a, **k: self
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, precision, torch.Tensor.cuda,
         torch.nn.Module.cuda) = saved
        torch.set_float32_matmul_precision(precision)


def reference_module(args, sd):
    """The reference's module for ``args.kind`` with ``sd`` loaded: its
    ``Deeplabv2`` (the flagship config, strict) or its ``ResNetEncoder``
    (the trunk, ``fc`` unused)."""
    from uemda_tpu_torch.tools.reference import ref_import

    root = args.reference_root
    if args.kind == "deeplabv2":
        encoder = ref_import("uemda.models.Encoder", root)
        ref = encoder.Deeplabv2(dict(
            backbone=dict(resnet_type=args.resnet_type,
                          output_stride=args.output_stride, pretrained=False),
            multi_layer=True, cascade=False, use_ppm=True,
            ppm=dict(num_classes=args.num_classes, use_aux=False,
                     fc_dim=2048),
            inchannels=2048, num_classes=args.num_classes, is_ins_norm=True))
        ref.load_state_dict(sd)
        return ref
    ref_resnet = ref_import("uemda.resnet", root)
    ref_resnets = ref_import("uemda._resnets", root)
    registry = ref_import("ever.core.registry", root)
    if args.resnet_type not in registry.MODEL:
        registry.MODEL.register(args.resnet_type,
                                getattr(ref_resnets, args.resnet_type))
    ref = ref_resnet.ResNetEncoder(dict(
        resnet_type=args.resnet_type, output_stride=args.output_stride,
        pretrained=False))
    ref.resnet.load_state_dict(sd, strict=False)
    return ref


def parity(args, sd, model, out, device) -> bool:
    """The parity stage: the reference module against ``model`` (for
    imagenet its trunk in an encoder at ``--output-stride``, as the
    reference's) on one (2, 3, 128, 128) normal input from
    ``default_rng(0)``; records ``parity_max_abs`` (or ``parity_error``
    when the reference cannot be imported) in ``out``."""
    try:
        ref = reference_module(args, sd)
    except (ImportError, OSError, AttributeError, RuntimeError) as e:
        out["parity_error"] = f"{type(e).__name__}: {e}"
        return False
    ref = ref.to(device).eval()
    ours = model
    if args.kind == "imagenet":
        ours = ResNetEncoder(BackboneConfig(
            resnet_type=args.resnet_type, output_stride=args.output_stride))
        ours.resnet.load_state_dict(model.encoder.resnet.state_dict())
        ours = ours.to(device, memory_format=torch.channels_last).eval()
    x = np.random.default_rng(0).normal(size=(2, 128, 128, 3)) \
        .astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))) \
        .to(device)
    with torch.no_grad(), full_f32(device):
        r, o = ref(x), ours(x)
    pairs = zip(r, o) if isinstance(r, (list, tuple)) else [(r, o)]
    out["parity_max_abs"] = max(float((a.float() - b.float()).abs().max())
                                for a, b in pairs)
    return out["parity_max_abs"] < args.parity_tol


def eval_miou(model, dataset, split, tile, device) -> float:
    """The eval stage: ``evaluate_dataset`` of ``dataset`` (a split with
    ``split``'s normalization and batch size) at ``tile``, bf16 on the
    card, f32 on the CPU; the model is cast in place."""
    from uemda_tpu_torch.infer.evaluate import evaluate_dataset

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    _, miou = evaluate_dataset(model.to(dtype), dataset, split.mean,
                               split.std, tile=tuple(tile),
                               batch_size=split.batch_size,
                               compute_dtype=dtype, device=device)
    return miou


def build_parser():
    parser = argparse.ArgumentParser(
        description="checksum -> port and load -> parity -> eval, in one "
        "command")
    parser.add_argument("--torch-ckpt", type=str, required=True)
    parser.add_argument("--kind", choices=["imagenet", "deeplabv2"],
                        default="imagenet")
    parser.add_argument("--resnet-type", type=str, default="resnet50")
    parser.add_argument("--output-stride", type=int, default=16)
    parser.add_argument("--num-classes", type=int, default=6)
    parser.add_argument("--expect-sha256", type=str, default="",
                        help="pin the full or prefix SHA256 (overrides the "
                        "built-in torchvision table)")
    parser.add_argument("--allow-unverified", action="store_true",
                        help="continue past an unknown/failed checksum")
    parser.add_argument("--parity-tol", type=float, default=1e-3,
                        help="max-abs tolerance of the parity stage")
    parser.add_argument("--skip-parity", action="store_true",
                        help="checksum and port only (no reference "
                        "checkout)")
    parser.add_argument("--reference-root", type=str, default="",
                        help="the reference checkout the parity stage "
                        "imports (needed unless --skip-parity)")
    parser.add_argument("--out", type=str, default="",
                        help="write the loaded model's state dict here "
                        "(.pth)")
    parser.add_argument("--run-eval", action="store_true",
                        help="deeplabv2 kind: score the val split of "
                        "--config-path with the loaded weights")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    return parser


def run_gate(args):
    """Every requested stage in order; returns the JSON record (``ok``,
    and ``failed`` naming the stage that failed)."""
    out = {"ckpt": os.path.basename(args.torch_ckpt), "kind": args.kind}
    if not check_sum(args, out):
        return {**out, "ok": False, "failed": "checksum"}
    device = resolve_device(args.device)
    sd = load_ref_sd(args.torch_ckpt)
    model = port_and_load(args, sd, device)
    if args.skip_parity:
        out["parity"] = "skipped"
    elif not parity(args, sd, model, out, device):
        return {**out, "ok": False, "failed": "parity"}
    if args.out:
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   args.out)
        out["ported"] = args.out
    if args.run_eval:
        if args.kind != "deeplabv2":
            return {**out, "ok": False,
                    "failed": "eval needs --kind deeplabv2"}
        from uemda_tpu_torch.config import load_config
        from uemda_tpu_torch.datasets.base import SegDataset

        cfg = load_config(args.config_path)
        if cfg.class_num != model.config.num_classes:
            raise ValueError(
                f"--run-eval: {args.config_path} has {cfg.class_num} "
                f"classes, {args.torch_ckpt} {model.config.num_classes}")
        split = cfg.val
        ds = SegDataset(cfg.meta, list(split.image_dir),
                        list(split.mask_dir)[0])
        out["eval_miou"] = eval_miou(model, ds, split, cfg.crop, device)
    return {**out, "ok": True}


def main(argv=None):
    record = run_gate(build_parser().parse_args(argv))
    print(json.dumps(record))
    if not record["ok"]:
        raise SystemExit(1)
    return record


if __name__ == "__main__":
    main()
