"""Batch directory inference CLI (the serving path), on the GPU.

Twin of ``tools/infer_dir.py``::

    python -m uemda_tpu_torch.tools.infer_dir --config-path 2vaihingen \\
        --ckpt-path model.pth --img-dir tiles/ --out-dir pred/ --fastpath 1

Runs the batched slide(+TTA) predictor over every image of a directory and
writes ``<stem>_ids.png`` (``--ids``) and/or ``<stem>_color.png``
(``--color``): the pseudo-label sweep without its probability files. Images
stream through ``predict_batches`` (decode on ``--decode-workers`` threads
and upload on worker threads, the last batch padded) into the predictor,
on the card one captured CUDA graph, and the ids come back through reused
pinned buffers one batch late. ``--fastpath``, ``--int8``,
``--calib-batches`` and ``--int8-stages`` as the eval CLI (the calibration
on the directory's first batches). ``--num-devices N`` (N > 1) runs N
processes, one a card (gloo on the CPU with ``--device cpu``), each
writing its share of the images. Process 0 prints ``<n> images -> <dir>
in <s>s (<r> img/s)`` for all of them. Needs PIL.
"""

import argparse
import os
import time

import torch

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.base import SegDataset
from uemda_tpu_torch.datasets.prefetch import HostReadback
from uemda_tpu_torch.infer.evaluate import RankShare, predict_batches
from uemda_tpu_torch.infer.quant import serving_model
from uemda_tpu_torch.models.port import load_checkpoint
from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.parallel.multihost import is_main_process, launch
from uemda_tpu_torch.train.loop import build_model
from uemda_tpu_torch.utils.log import str2bool
from uemda_tpu_torch.utils.runtime import resolve_device
from uemda_tpu_torch.utils.viz import VisualizeSegmm


def main(argv=None):
    parser = argparse.ArgumentParser(description="Infer a whole directory.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-path", type=str, required=True,
                        help="reference .pth or the port's .npz")
    parser.add_argument("--img-dir", type=str, required=True)
    parser.add_argument("--out-dir", type=str, required=True)
    parser.add_argument("--tta", type=str2bool, default=0)
    parser.add_argument("--int8", type=str2bool, default=0)
    parser.add_argument("--fastpath", type=str2bool, default=0,
                        help="folded serving fast path (infer/fastpath.py); "
                        "with --int8, quantizes only the compute-bound GEMMs")
    parser.add_argument("--calib-batches", type=int, default=0,
                        help="with --fastpath --int8: calibrate static int8 "
                        "activation scales on this many input batches")
    parser.add_argument("--int8-stages", type=str, default="",
                        help="with --fastpath --int8: comma list of backbone "
                        "stages to quantize (default 3,4)")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--ids", type=str2bool, default=1,
                        help="write raw class-id PNGs")
    parser.add_argument("--color", type=str2bool, default=1,
                        help="write palette PNGs")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="N > 1: N processes, one a card (gloo on the "
                        "CPU with --device cpu), each writing its share")
    parser.add_argument("--decode-workers", type=int, default=1,
                        help="host-side image-decode thread pool (PNG/TIFF "
                        "decompression releases the GIL; >1 pays off on "
                        "multi-core hosts)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from uemda_tpu_torch.infer.fastpath import parse_int8_stages_flag

    # checked before any process starts
    args.int8_stage_list = parse_int8_stages_flag(
        args.int8_stages, bool(args.int8), bool(args.fastpath))
    return launch(_run, args)


def _run(args):
    """The directory's images, or this rank's share of them
    (``parallel/multihost.py: launch``)."""
    from PIL import Image

    int8_stages = args.int8_stage_list
    cfg = load_config(args.config_path)
    dev = resolve_device(args.device)
    model = build_model(cfg, dev)
    model.load_state_dict(load_checkpoint(args.ckpt_path))
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    dataset = SegDataset(cfg.meta, args.img_dir, None, label_type="none")
    split = cfg.val
    kw = {}
    if args.fastpath:
        from uemda_tpu_torch.infer.fastpath import check_fastpath_tile

        check_fastpath_tile(cfg.crop)
        kw["int8_stages"] = int8_stages
        if args.int8 and args.calib_batches > 0:
            from uemda_tpu_torch.infer.evaluate import collect_calib_batches

            kw["calibration_batches"] = collect_calib_batches(
                dataset, args.batch_size, split.mean, split.std,
                args.calib_batches, tile=cfg.crop, device=dev)
    net = serving_model(model, bool(args.fastpath), bool(args.int8), dtype,
                        **kw)
    if mesh.world_size() > 1:   # this rank's share of the images
        dataset = RankShare(dataset, mesh.rank(), mesh.world_size())

    os.makedirs(args.out_dir, exist_ok=True)
    viz = VisualizeSegmm(args.out_dir, cfg.meta.palette) if args.color else None

    def write(item):
        if item is None:
            return
        indices, arrays = item
        for j, idx in enumerate(indices):
            stem = os.path.splitext(dataset.filename(idx))[0]
            if args.ids:
                Image.fromarray(arrays["pred"][j]).save(
                    os.path.join(args.out_dir, stem + "_ids.png"))
            if viz is not None:
                viz(arrays["pred"][j], stem + "_color.png")

    readback = HostReadback()
    t0, done = time.time(), 0
    for indices, n, _, probs in predict_batches(
            net, dataset, split.mean, split.std, tuple(cfg.crop),
            bool(args.tta), args.batch_size, dtype, dev,
            decode_workers=args.decode_workers):
        pred = probs[:n].argmax(dim=1).to(torch.uint8)
        write(readback.push(indices, {"pred": pred}))
        done += n
    write(readback.flush())
    done = int(mesh.gsum(torch.tensor(done, device=dev)))
    dt = time.time() - t0
    if is_main_process():
        print(f"{done} images -> {args.out_dir} in {dt:.1f}s "
              f"({done / dt:.2f} img/s)")


if __name__ == "__main__":
    main()
