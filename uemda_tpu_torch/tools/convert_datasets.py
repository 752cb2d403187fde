"""Raw ISPRS raster -> tiled dataset converter CLI.

Twin of ``tools/convert_datasets.py`` (reference ``convert_datasets/
convert_potsdam.py``, ``convert_vaihingen.py``, ``convert_potsdam_rgb.py``)::

    python -m uemda_tpu_torch.tools.convert_datasets potsdam \\
        --dataset-path raw/ --out-dir data/IsprsDA/Potsdam [--stats]

Clips the official rasters into 512^2 tiles under ``img_dir/{train,val,
test}`` and ``ann_dir/...`` with the reference's tile names and splits;
``--stats`` prints the channel statistics of the train split. Host only;
needs PIL.
"""

import argparse
import glob
import os.path as osp

from uemda_tpu_torch.datasets.convert import (
    POTSDAM_SPLITS,
    VAIHINGEN_SPLITS,
    compute_channel_stats,
    convert_raster,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Convert ISPRS rasters.")
    parser.add_argument("dataset", choices=["potsdam", "potsdam_rgb", "vaihingen"])
    parser.add_argument("--dataset-path", required=True,
                        help="dir holding the official image/label rasters")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--clip-size", type=int, default=512)
    parser.add_argument("--stats", action="store_true",
                        help="print channel stats of the produced train split")
    args = parser.parse_args(argv)

    if args.dataset.startswith("potsdam"):
        splits = POTSDAM_SPLITS
        channels = "rgb" if args.dataset == "potsdam_rgb" else "irrg"

        def tile_id(path):
            return "_".join(osp.basename(path).split("_")[2:4])
    else:
        splits, channels = VAIHINGEN_SPLITS, "rgb"  # Vaihingen is IRRG 3ch

        def tile_id(path):
            return osp.splitext(osp.basename(path))[0].split("_")[-1]

    rasters = sorted(
        glob.glob(osp.join(args.dataset_path, "*.tif"))
        + glob.glob(osp.join(args.dataset_path, "*.png"))
    )
    label_rasters = [p for p in rasters if "label" in osp.basename(p).lower()]
    image_rasters = [p for p in rasters if p not in label_rasters]

    for split, ids in splits.items():
        for paths, sub, to_label in (
            (image_rasters, "img_dir", False),
            (label_rasters, "ann_dir", True),
        ):
            out = osp.join(args.out_dir, sub, split)
            for p in paths:
                if tile_id(p) in ids:
                    convert_raster(
                        p, out, args.clip_size, to_label=to_label,
                        channels=channels, name_prefix=tile_id(p),
                    )
            print(f"{split}/{sub}: done -> {out}")

    if args.stats:
        mean, std = compute_channel_stats(
            osp.join(args.out_dir, "img_dir", "train"))
        print("mean:", mean.round(4).tolist(), "std:", std.round(4).tolist())


if __name__ == "__main__":
    main()
