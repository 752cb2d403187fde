"""Single-image inference CLI, on the GPU.

Twin of ``tools/infer_single.py`` (reference ``tools/infer_single.py:
14-70``)::

    python -m uemda_tpu_torch.tools.infer_single --config-path 2vaihingen \\
        --ckpt-path model.pth --image-path top_mosaic_09cm_area1.tif --tta 1

Loads a checkpoint (reference ``.pth`` or the port's ``.npz``), slide-infers
one image (``--slide 0``: one forward of the whole image) with optional
8-view TTA, and writes ``<stem>_ids.png`` (raw class ids), ``<stem>_color.png``
(palette) and, when the mask is found by the img_dir -> ann_dir
substitution, ``<stem>_gt.png``. ``--fastpath 1`` serves the folded fast
path, ``--int8 1`` int8 (``infer/quant.py``; with ``--fastpath``, only the
compute-bound GEMMs). On the card the predictor is one captured CUDA graph.
``--raster 1`` runs the whole image through the row-sharded raster
predictor (``infer/raster.py``) over every card of the host, as the JAX
tool over every chip: one process a card, the halo rows exchanged between
them; on the CPU one process. Needs PIL.
"""

import argparse
import os

import numpy as np
import torch

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.augment import normalize
from uemda_tpu_torch.datasets.io import read_image
from uemda_tpu_torch.infer.quant import serving_model
from uemda_tpu_torch.infer.raster import make_raster_predictor
from uemda_tpu_torch.infer.slide import make_predictor
from uemda_tpu_torch.models.port import load_checkpoint
from uemda_tpu_torch.parallel.multihost import is_main_process, launch
from uemda_tpu_torch.train.loop import build_model
from uemda_tpu_torch.utils.log import str2bool
from uemda_tpu_torch.utils.runtime import resolve_device
from uemda_tpu_torch.utils.viz import VisualizeSegmm


def main(argv=None):
    parser = argparse.ArgumentParser(description="Infer one image.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-path", type=str, required=True,
                        help="reference .pth or the port's .npz")
    parser.add_argument("--image-path", type=str, required=True)
    parser.add_argument("--out-dir", type=str, default="./infer_out")
    parser.add_argument("--tta", type=str2bool, default=0)
    parser.add_argument("--slide", type=str2bool, default=1)
    parser.add_argument("--int8", type=str2bool, default=0,
                        help="serve the convs as int8 x int8 -> int32 "
                        "products (infer/quant.py)")
    parser.add_argument("--fastpath", type=str2bool, default=0,
                        help="folded serving fast path (infer/fastpath.py); "
                        "with --int8, quantizes only the compute-bound GEMMs")
    parser.add_argument("--raster", type=str2bool, default=0,
                        help="whole-image inference with the rows sharded "
                        "over every card of the host (halo exchange)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    # the raster spans the host's cards, one process a card
    args.num_devices = (torch.cuda.device_count() if args.raster
                        and torch.device(args.device).type == "cuda"
                        else None)
    return launch(_run, args)


def _run(args):
    """The image in this process: the slide predictor, or this rank's band
    of the raster predictor (``parallel/multihost.py: launch``)."""
    from PIL import Image

    cfg = load_config(args.config_path)
    dev = resolve_device(args.device)
    model = build_model(cfg, dev)
    model.load_state_dict(load_checkpoint(args.ckpt_path))
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    img = read_image(args.image_path)
    hw = tuple(img.shape[:2])
    split = cfg.val
    x = normalize(torch.from_numpy(np.array(img[None])).to(dev)
                  .permute(0, 3, 1, 2), split.mean, split.std)
    # the forward tile is cfg.crop when sliding or rastering, else the
    # image's own dims
    tile = tuple(cfg.crop) if (args.slide or args.raster) else hw
    if args.fastpath:
        from uemda_tpu_torch.infer.fastpath import check_fastpath_tile

        check_fastpath_tile(tile)
    net = serving_model(model, args.fastpath, args.int8, dtype)
    if args.raster:
        predictor = make_raster_predictor(net, hw, tile=tile,
                                          tta=bool(args.tta),
                                          compute_dtype=dtype)
        pred = predictor(x[0]).to(torch.uint8).cpu().numpy()
        if not is_main_process():
            return None
    else:
        with make_predictor(net, tile, hw, tta=bool(args.tta),
                            compute_dtype=dtype) as predictor:
            pred = predictor(x).argmax(dim=1)[0].to(torch.uint8).cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.image_path))[0]
    Image.fromarray(pred).save(os.path.join(args.out_dir, stem + "_ids.png"))
    viz = VisualizeSegmm(args.out_dir, cfg.meta.palette)
    viz(pred, stem + "_color.png")
    # the GT view, if found by directory substitution (infer_single.py:64-68)
    gt_path = args.image_path.replace("img_dir", "ann_dir").replace(
        "images_png", "masks_png")
    if gt_path != args.image_path and os.path.exists(gt_path):
        gt = np.asarray(Image.open(gt_path)).astype(np.int32) + cfg.meta.offset
        viz(gt, stem + "_gt.png")
    print(os.path.join(args.out_dir, stem + "_color.png"))


if __name__ == "__main__":
    main()
