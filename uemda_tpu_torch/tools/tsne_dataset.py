"""t-SNE of a model's features over a pair's source and target splits.

Twin of ``tools/tsne_dataset.py`` (reference ``tools/tsne_dataset.py:
73-304``)::

    python -m uemda_tpu_torch.tools.tsne_dataset --config-path 2urban \\
        --ckpt-path model.pth [--max-images 32] [--perplexity 30] \\
        [--out tsne.png] [--device cpu]

Samples stride-16 features and their majority labels from the first
``--max-images`` images of each split through the checkpoint's train-mode
forward (:func:`sample_features`), embeds them with scikit-learn's t-SNE
and draws a scatter coloured by class, one marker a domain (needs
scikit-learn and matplotlib). The checkpoint is a reference-keyed
``.pth``/``.npz`` (``models/port.load_checkpoint``).
"""

import argparse
import os

import numpy as np
import torch

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.augment import normalize
from uemda_tpu_torch.datasets.base import SegDataset, sequential_batches
from uemda_tpu_torch.models.port import load_checkpoint
from uemda_tpu_torch.ops.labels import downscale_label
from uemda_tpu_torch.train.loop import build_model
from uemda_tpu_torch.train.steps import forward_features
from uemda_tpu_torch.utils.runtime import require_package, resolve_device


def train_features(model, image: np.ndarray, mean, std) -> torch.Tensor:
    """The stride-16 feature map (1, K, h, w) f32 of one uint8 (1, H, W, 3)
    image through the train-mode forward, as the JAX tools take it
    (``train=True``: BatchNorm on the image's own batch statistics, then
    the instance norm, K1). JAX throws the forward's new BatchNorm
    statistics away; here the encoder runs on scratch copies of its
    buffers (``train/steps.forward_features``), so the model's running
    statistics stay as they were, and its mode is restored."""
    dev = next(model.parameters()).device
    # a copy: a decoded tile may be a read-only view of the dataset's cache
    x = normalize(torch.from_numpy(np.array(image)).to(dev)
                  .permute(0, 3, 1, 2), mean, std)
    training = model.training
    model.train()
    try:
        with torch.no_grad():
            return forward_features(model, x, torch.float32)
    finally:
        model.train(training)


def sample_features(model, dataset, mean, std, max_images: int = 32,
                    samples_per_image: int = 64, seed: int = 0):
    """(features (N, K) f32, labels (N,) int32) sampled at stride 16 from
    the first ``max_images`` images of ``dataset`` (``uemda_tpu/tools/
    tsne_dataset.py:33-60``): each image's train-mode features
    (:func:`train_features`) and its labels' 16 x 16 majority vote
    (``ops/labels.downscale_label``); up to ``samples_per_image`` labelled
    cells drawn by ``default_rng(seed).choice(..., replace=False)``, the
    JAX tool's draws, so equal features give equal picks."""
    rng = np.random.default_rng(seed)
    nc = dataset.meta.num_classes
    feats, labels = [], []
    for indices, batch in sequential_batches(dataset, 1):
        if indices[0] >= max_images:
            break
        feat = train_features(model, batch["image"], mean, std)
        lab = downscale_label(torch.from_numpy(batch["label"]), 16, nc)
        f = feat[0].permute(1, 2, 0).reshape(-1, feat.shape[1]).cpu().numpy()
        l = lab[0].numpy().reshape(-1)
        keep = np.flatnonzero(l >= 0)
        if len(keep) == 0:
            continue
        sel = rng.choice(keep, size=min(samples_per_image, len(keep)),
                         replace=False)
        feats.append(f[sel])
        labels.append(l[sel])
    return np.concatenate(feats), np.concatenate(labels)


def load_model(cfg, ckpt_path: str, device):
    """The config's model with the checkpoint's weights, on ``device``."""
    model = build_model(cfg, device)
    model.load_state_dict(load_checkpoint(ckpt_path))
    return model


def palette_colors(meta) -> np.ndarray:
    return np.asarray(meta.palette, np.float32).reshape(-1, 3) / 255.0


def main(argv=None):
    parser = argparse.ArgumentParser(description="t-SNE of deep features.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-path", type=str, required=True)
    parser.add_argument("--out", type=str, default="tsne.png")
    parser.add_argument("--max-images", type=int, default=32)
    parser.add_argument("--perplexity", type=float, default=30.0)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)
    manifold = require_package("sklearn.manifold", "scikit-learn",
                               "tsne_dataset's embedding")
    matplotlib = require_package("matplotlib", "matplotlib",
                                 "tsne_dataset's figure")

    cfg = load_config(args.config_path)
    model = load_model(cfg, args.ckpt_path, resolve_device(args.device))
    src_ds = SegDataset(cfg.meta, list(cfg.source.image_dir),
                        list(cfg.source.mask_dir)[0])
    tgt_ds = SegDataset(cfg.meta, list(cfg.target.image_dir),
                        list(cfg.target.mask_dir)[0])
    fs, ls = sample_features(model, src_ds, cfg.source.mean, cfg.source.std,
                             args.max_images)
    ft, lt = sample_features(model, tgt_ds, cfg.target.mean, cfg.target.std,
                             args.max_images)

    emb = manifold.TSNE(n_components=2, perplexity=args.perplexity,
                        init="pca", random_state=0).fit_transform(
        np.concatenate([fs, ft]))

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_src = len(fs)
    colors = palette_colors(cfg.meta)
    fig, ax = plt.subplots(figsize=(8, 8))
    for dom, (e, l, marker) in enumerate(
            [(emb[:n_src], ls, "o"), (emb[n_src:], lt, "^")]):
        for c in range(cfg.meta.num_classes):
            sel = l == c
            if sel.any():
                ax.scatter(e[sel, 0], e[sel, 1], s=6, marker=marker,
                           color=colors[c],
                           label=f"{'S' if dom == 0 else 'T'}:"
                                 f"{cfg.meta.class_names[c]}")
    ax.legend(fontsize=7, ncol=2)
    ax.set_title(f"t-SNE features {cfg.name} "
                 f"({os.path.basename(args.ckpt_path)})")
    fig.savefig(args.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(args.out)
    return args.out


if __name__ == "__main__":
    main()
