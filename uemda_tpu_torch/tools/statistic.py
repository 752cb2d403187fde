"""Per-channel mean/std statistics over image directories.

Twin of ``tools/statistic.py`` (reference root-level ``statistic.py:1-96``,
the tool that produced the configs' normalization constants)::

    python -m uemda_tpu_torch.tools.statistic --img-dir DIR [DIR ...]

Host only; needs PIL.
"""

import argparse

from uemda_tpu_torch.datasets.convert import compute_channel_stats


def main(argv=None):
    parser = argparse.ArgumentParser(description="Channel statistics.")
    parser.add_argument("--img-dir", type=str, required=True, nargs="+")
    args = parser.parse_args(argv)
    mean, std = compute_channel_stats(list(args.img_dir))
    print("mean:", [round(float(v), 4) for v in mean])
    print("std: ", [round(float(v), 4) for v in std])
    return mean, std


if __name__ == "__main__":
    main()
