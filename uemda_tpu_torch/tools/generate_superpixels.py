"""Offline superpixel generation for the target training splits.

Twin of ``tools/generate_superpixels.py`` (reference ``tools/
generate_superpixels.py`` + ``uemda/gast/superpixels.py:86-127``)::

    python -m uemda_tpu_torch.tools.generate_superpixels \\
        --img-dir data/LoveDA/Train/Urban/images_png \\
        --out-dir data/LoveDA/Train/Urban/masks_png_sup [--algo lsc|slic]

For each image it writes the uint16 ``.tif`` label map under
``<out-dir>``, the boundary-shrunk map under ``<out-dir>_shrink`` (the file
``datasets/io.py: sup_path_for`` reads for the 's' refinement view: name
the out dir ``<ann dir>_sup``) and a boundary visualization under
``<out-dir>_vis``, through the repo's C++ runtime
(``superpixels/native.py``). Host only; needs PIL.
"""

import argparse
import os

import numpy as np

from uemda_tpu_torch.datasets.io import list_images, read_image
from uemda_tpu_torch.superpixels import superpixels_with_shrink


def process_image(p: str, out_dir: str, region_size=16, ratio=0.075,
                  iterations=100, win_size=3, vis=True, algo="lsc") -> int:
    """One image's three files; returns its number of superpixels."""
    from PIL import Image

    img = read_image(p)
    n, labels, shrunk = superpixels_with_shrink(
        img.astype(np.uint8), region_size, ratio, iterations, win_size, algo)
    stem = os.path.splitext(os.path.basename(p))[0]
    Image.fromarray(labels.astype(np.uint16)).save(
        os.path.join(out_dir, stem + ".tif"))
    Image.fromarray(shrunk.astype(np.uint16)).save(
        os.path.join(out_dir + "_shrink", stem + ".tif"))
    if vis:
        edge = shrunk == shrunk.max()
        v = img.copy()
        v[edge] = (0, 255, 0)
        Image.fromarray(v).save(os.path.join(out_dir + "_vis", stem + ".png"))
    return n


def process_dir(dir_path: str, out_dir: str, region_size=16, ratio=0.075,
                iterations=100, win_size=3, vis=True, algo="lsc"):
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(out_dir + "_shrink", exist_ok=True)
    if vis:
        os.makedirs(out_dir + "_vis", exist_ok=True)
    paths = list_images(dir_path)
    print(f"{dir_path}: {len(paths)} images")
    for i, p in enumerate(paths):
        n = process_image(p, out_dir, region_size, ratio, iterations,
                          win_size, vis, algo)
        if (i + 1) % 50 == 0:
            print(f"  {i + 1}/{len(paths)} (last n={n})")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate superpixel maps.")
    parser.add_argument("--img-dir", type=str, required=True)
    parser.add_argument("--out-dir", type=str, required=True,
                        help="e.g. data/IsprsDA/Vaihingen/ann_dir/train_sup")
    parser.add_argument("--region-size", type=int, default=16)
    parser.add_argument("--ratio", type=float, default=0.075)
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument("--win-size", type=int, default=3)
    parser.add_argument("--algo", choices=["lsc", "slic"], default="lsc")
    args = parser.parse_args(argv)
    process_dir(args.img_dir, args.out_dir, args.region_size, args.ratio,
                args.iterations, args.win_size, algo=args.algo)


if __name__ == "__main__":
    main()
