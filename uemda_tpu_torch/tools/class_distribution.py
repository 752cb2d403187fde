"""Class distribution of a pair's splits.

Twin of ``tools/class_distribution.py`` (reference
``uemda/utils/classvis.py``)::

    python -m uemda_tpu_torch.tools.class_distribution --config-path 2urban \\
        [--out class_dist.png]

Prints each class's pixel rate in the source and target train splits
(rounded to 5 places) as indented JSON and draws them as grouped bars
(needs matplotlib).
"""

import argparse
import json

import numpy as np

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.base import SegDataset
from uemda_tpu_torch.utils.runtime import require_package


def class_rates(dataset) -> np.ndarray:
    """(C,) float64 share of each class among the labelled pixels of
    ``dataset`` (anything with ``meta``, ``__len__`` and ``item(i)["label"]``:
    a :class:`SegDataset` or an in-memory ``ArrayDataset``); ignore and
    out-of-range labels are not counted. Counts in float64 as the JAX tool
    does (exact below 2^53 pixels)."""
    c = dataset.meta.num_classes
    counts = np.zeros(c, np.float64)
    for i in range(len(dataset)):
        lbl = np.asarray(dataset.item(i)["label"]).ravel()
        counts += np.bincount(lbl[(lbl >= 0) & (lbl < c)], minlength=c)
    return counts / max(counts.sum(), 1.0)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Class distribution bars.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--out", type=str, default="class_dist.png")
    args = parser.parse_args(argv)
    matplotlib = require_package("matplotlib", "matplotlib",
                                 "class_distribution's bar chart")

    cfg = load_config(args.config_path)
    rates = {}
    for name, split in (("source", cfg.source), ("target", cfg.target)):
        ds = SegDataset(cfg.meta, list(split.image_dir),
                        list(split.mask_dir)[0])
        rates[name] = class_rates(ds).round(5).tolist()
    print(json.dumps({"classes": cfg.meta.class_names, **rates}, indent=2))

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.arange(cfg.meta.num_classes)
    fig, ax = plt.subplots(figsize=(8, 4))
    width = 0.8 / len(rates)
    for i, (name, r) in enumerate(rates.items()):
        ax.bar(x + i * width, r, width, label=name)
    ax.set_xticks(x + width / 2)
    ax.set_xticklabels(cfg.meta.class_names, rotation=30, ha="right")
    ax.set_ylabel("pixel rate")
    ax.legend()
    fig.savefig(args.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(args.out)
    return rates


if __name__ == "__main__":
    main()
