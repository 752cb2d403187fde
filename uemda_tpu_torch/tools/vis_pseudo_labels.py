"""Pseudo-label quality analysis CLI.

Twin of ``tools/vis_pseudo_labels.py`` (reference ``tools/
vis_pseudo_labels.py`` + ``analysis_pseudo_labels``,
``uemda/gast/pseudo_generation.py:158-335``)::

    python -m uemda_tpu_torch.tools.vis_pseudo_labels --config-path 2urban \\
        --label-dir data/.../ann_dir/train --pseudo-dir log/pseudo_label \\
        [--cutoff-top 0.8 --cutoff-low 0.6] [--plot fig.png] [--device cpu]

Prints the mined labels' coverage and accuracy against ground truth,
overall and per entropy bin, as indented JSON; ``--plot`` also draws the
count and accuracy against entropy (needs matplotlib). Mining runs on the
card unless ``--device cpu``.
"""

import argparse
import json

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.infer.analysis import analyze_pseudo_labels


def main(argv=None):
    parser = argparse.ArgumentParser(description="Analyze pseudo labels.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--label-dir", type=str, required=True,
                        help="ground-truth ann dir of the target train split")
    parser.add_argument("--pseudo-dir", type=str, required=True,
                        help="dir of saved per-image probability files")
    parser.add_argument("--cutoff-top", type=float, default=None)
    parser.add_argument("--cutoff-low", type=float, default=None)
    parser.add_argument("--plot", type=str, default=None,
                        help="write the accuracy/count-vs-entropy figure "
                             "(the reference's analysis plots, "
                             "pseudo_generation.py:238-335) to this PNG")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config_path)
    report = analyze_pseudo_labels(
        args.label_dir,
        args.pseudo_dir,
        cfg.meta,
        cutoff_top=args.cutoff_top or cfg.cutoff_top,
        cutoff_low=args.cutoff_low or cfg.cutoff_low,
        device=args.device,
    )
    print(json.dumps(report, indent=2))

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        edges = np.asarray(report["bin_edges"])
        mid = (edges[:-1] + edges[1:]) / 2
        fig, ax1 = plt.subplots(figsize=(6, 4))
        ax1.bar(mid, report["bin_count"], width=np.diff(edges) * 0.9,
                alpha=0.4, label="pixel count")
        ax1.set_xlabel("pseudo-label entropy u")
        ax1.set_ylabel("pixels")
        ax2 = ax1.twinx()
        ax2.plot(mid, report["bin_accuracy"], "o-", color="C1",
                 label="accuracy")
        ax2.set_ylabel("accuracy")
        ax2.set_ylim(0, 1.02)
        fig.suptitle(
            f"coverage {report['coverage']:.3f}, "
            f"mined accuracy {report['accuracy']:.3f}"
        )
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(args.plot)
    return report


if __name__ == "__main__":
    main()
