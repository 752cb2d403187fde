"""Checkpoint evaluation CLI: sliding-window mIoU on the val or test split
with optional x8 TTA, on the GPU.

Twin of ``tools/eval.py`` (reference ``tools/eval.py:15-56``)::

    python -m uemda_tpu_torch.tools.eval --config-path 2vaihingen \\
        --ckpt-path model.pth --test 1 --tta 1 --fastpath 1

``--ckpt-path`` takes a reference ``.pth`` (the port's module names are the
reference's) or the ``.npz`` that ``models.port.save_npz`` writes. int8
serving: ``--fastpath 1 --int8 1`` quantizes the fast path's heads and the
3x3s of ``--int8-stages`` (default 3,4), with static activation scales
calibrated on ``--calib-batches`` eval batches when that is above 0;
``--int8 1`` alone runs the standard forward with every conv in int8
(``infer/quant.py``). Prints one JSON line with the mean metrics.
"""

import argparse
import json
import logging

import torch

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.base import SegDataset
from uemda_tpu_torch.infer.evaluate import evaluate_dataset
from uemda_tpu_torch.models.port import load_checkpoint
from uemda_tpu_torch.train.loop import build_model


def str2bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


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
    parser.add_argument("--int8", type=str2bool, default=0,
                        help="serve the convs as int8 x int8 -> int32 "
                        "products (infer/quant.py); with --fastpath, only "
                        "the compute-bound ones")
    parser.add_argument("--calib-batches", type=int, default=0,
                        help="with --fastpath --int8: calibrate static int8 "
                        "activation scales on this many eval batches")
    parser.add_argument("--int8-stages", type=str, default="",
                        help="with --fastpath --int8: comma list of backbone "
                        "stages whose 3x3s are quantized (default 3,4)")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from uemda_tpu_torch.infer.fastpath import parse_int8_stages_flag

    int8_stages = parse_int8_stages_flag(args.int8_stages, bool(args.int8),
                                         bool(args.fastpath))

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.eval")
    cfg = load_config(args.config_path)
    model = build_model(cfg, args.device)
    model.load_state_dict(load_checkpoint(args.ckpt_path))
    dtype = (torch.bfloat16 if torch.device(args.device).type == "cuda"
             else torch.float32)

    split = cfg.test if args.test else cfg.val
    dataset = SegDataset(cfg.meta, list(split.image_dir), list(split.mask_dir)[0])
    batch_size = args.batch_size or split.batch_size
    if args.fastpath:
        from uemda_tpu_torch.infer.fastpath import build_fastpath, check_fastpath_tile

        check_fastpath_tile(cfg.crop)
        calib = None
        if args.int8 and args.calib_batches > 0:
            from uemda_tpu_torch.infer.evaluate import collect_calib_batches

            calib = collect_calib_batches(
                dataset, batch_size, split.mean, split.std, args.calib_batches,
                tile=cfg.crop, device=args.device)
        model = build_fastpath(model, dtype=dtype, int8=bool(args.int8),
                               calibration_batches=calib,
                               int8_stages=int8_stages)
    else:
        model = model.to(dtype)
        if args.int8:
            from uemda_tpu_torch.infer.quant import Int8Model

            model = Int8Model(model)
    summary, miou = evaluate_dataset(
        model, dataset, split.mean, split.std, tile=cfg.crop,
        tta=bool(args.tta), batch_size=batch_size,
        compute_dtype=dtype, device=args.device, logger=logger)
    print(json.dumps({"miou": miou, **{k: summary[k] for k in
                                       ("mf1", "mprecision", "mrecall")}}))
    return summary


if __name__ == "__main__":
    main()
