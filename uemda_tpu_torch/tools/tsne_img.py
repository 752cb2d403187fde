"""t-SNE of one image's stride-16 features.

Twin of ``tools/tsne_img.py`` (reference ``tools/tsne_img.py``)::

    python -m uemda_tpu_torch.tools.tsne_img --config-path 2urban \\
        --ckpt-path model.pth --image-path .../img_dir/val/tile_000.png \\
        [--mask-path ...] [--out tsne_img.png] [--device cpu]

Every feature cell of the image (the checkpoint's train-mode forward,
``tsne_dataset.train_features``) embedded with scikit-learn's t-SNE and
drawn coloured by its ground-truth class when the mask is found (by
default the image path with ``img_dir`` -> ``ann_dir`` and ``images_png``
-> ``masks_png``), else in one colour. Needs scikit-learn and matplotlib.
"""

import argparse
import os

import torch

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.io import read_image, read_mask
from uemda_tpu_torch.ops.labels import downscale_label
from uemda_tpu_torch.tools.tsne_dataset import (
    load_model,
    palette_colors,
    train_features,
)
from uemda_tpu_torch.utils.runtime import require_package, resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="t-SNE of one image.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-path", type=str, required=True)
    parser.add_argument("--image-path", type=str, required=True)
    parser.add_argument("--mask-path", type=str, default=None)
    parser.add_argument("--out", type=str, default="tsne_img.png")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)
    manifold = require_package("sklearn.manifold", "scikit-learn",
                               "tsne_img's embedding")
    matplotlib = require_package("matplotlib", "matplotlib",
                                 "tsne_img's figure")

    cfg = load_config(args.config_path)
    model = load_model(cfg, args.ckpt_path, resolve_device(args.device))
    img = read_image(args.image_path)[None]
    feat = train_features(model, img, cfg.val.mean, cfg.val.std)
    f = feat[0].permute(1, 2, 0).reshape(-1, feat.shape[1]).cpu().numpy()

    mask_path = args.mask_path or args.image_path.replace(
        "img_dir", "ann_dir").replace("images_png", "masks_png")
    labels = None
    if os.path.exists(mask_path):
        gt = read_mask(mask_path, cfg.meta.offset, cfg.meta.num_classes)
        labels = downscale_label(torch.from_numpy(gt[None]), 16,
                                 cfg.meta.num_classes)[0].numpy().reshape(-1)

    emb = manifold.TSNE(n_components=2, init="pca",
                        random_state=0).fit_transform(f)

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = palette_colors(cfg.meta)
    fig, ax = plt.subplots(figsize=(7, 7))
    if labels is None:
        ax.scatter(emb[:, 0], emb[:, 1], s=4)
    else:
        for c in range(cfg.meta.num_classes):
            sel = labels == c
            if sel.any():
                ax.scatter(emb[sel, 0], emb[sel, 1], s=4, color=colors[c],
                           label=cfg.meta.class_names[c])
        ax.legend(fontsize=8)
    ax.set_title(os.path.basename(args.image_path))
    fig.savefig(args.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(args.out)
    return args.out


if __name__ == "__main__":
    main()
