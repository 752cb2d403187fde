"""Checkpoint evaluation CLI: sliding-window mIoU on the val or test split
with optional x8 TTA, on the GPU.

Twin of ``tools/eval.py`` (reference ``tools/eval.py:15-56``)::

    python -m uemda_tpu_torch.tools.eval --config-path 2vaihingen \\
        --ckpt-path model.pth --test 1 --tta 1 --fastpath 1

``--ckpt-path`` takes a reference ``.pth`` (the port's module names are the
reference's) or the ``.npz`` that ``models.port.save_npz`` writes. Prints one
JSON line with the mean metrics.
"""

import argparse
import json
import logging

import torch

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.base import SegDataset
from uemda_tpu_torch.infer.evaluate import evaluate_dataset
from uemda_tpu_torch.models.config import DeeplabV2Config, PPMConfig
from uemda_tpu_torch.models.deeplabv2 import DeeplabV2
from uemda_tpu_torch.models.port import load_checkpoint
from uemda_tpu_torch.models.resnet import ResNetEncoder


def str2bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def build_model(cfg, device) -> DeeplabV2:
    """The one model config every reference tool uses (train_src.py:63-80);
    head widths follow the backbone (uemda_tpu/train/loop.py:44-63)."""
    name = str(cfg.model).lower()
    name = "resnet50" if name == "resnet" else name
    fc_dim = ResNetEncoder.out_channels(name)
    mcfg = DeeplabV2Config.uemda_default(num_classes=cfg.class_num,
                                         resnet_type=name)
    if fc_dim != 2048:
        import dataclasses

        mcfg = dataclasses.replace(
            mcfg, ppm=PPMConfig(num_classes=cfg.class_num, fc_dim=fc_dim),
            inchannels=fc_dim)
    return DeeplabV2(mcfg, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a checkpoint.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-path", type=str, required=True,
                        help="reference .pth or the port's .npz")
    parser.add_argument("--test", type=str2bool, default=0,
                        help="use TEST split instead of EVAL")
    parser.add_argument("--tta", type=str2bool, default=0)
    parser.add_argument("--fastpath", type=str2bool, default=0,
                        help="folded serving fast path (BN fold, fused dual "
                        "head, fused stem kernel), exact math")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.eval")
    cfg = load_config(args.config_path)
    model = build_model(cfg, args.device)
    model.load_state_dict(load_checkpoint(args.ckpt_path))
    dtype = (torch.bfloat16 if torch.device(args.device).type == "cuda"
             else torch.float32)

    split = cfg.test if args.test else cfg.val
    dataset = SegDataset(cfg.meta, list(split.image_dir), list(split.mask_dir)[0])
    if args.fastpath:
        from uemda_tpu_torch.infer.fastpath import build_fastpath, check_fastpath_tile

        check_fastpath_tile(cfg.crop)
        model = build_fastpath(model, dtype=dtype)
    else:
        model = model.to(dtype)
    summary, miou = evaluate_dataset(
        model, dataset, split.mean, split.std, tile=cfg.crop,
        tta=bool(args.tta), batch_size=args.batch_size or split.batch_size,
        compute_dtype=dtype, device=args.device, logger=logger)
    print(json.dumps({"miou": miou, **{k: summary[k] for k in
                                       ("mf1", "mprecision", "mrecall")}}))
    return summary


if __name__ == "__main__":
    main()
