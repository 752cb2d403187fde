"""Plain self-training, the PROCA baseline's stage 3, on the GPU.

Twin of ``tools/train_ssl.py`` (reference ``tools/train_ssl.py``): the
stage-3 trainer ``train_ssl_uem`` with the reference's defaults, CE as the
target loss (``--lt ce``) and no online refinement (``--refine-label 0``),
unless the caller passes either flag::

    python -m uemda_tpu_torch.tools.train_ssl --config-path 2urban \\
        --ckpt-model log/align/Urban_best.pth \\
        --ckpt-proto log/align/prototypes_init.pth
"""

import sys

from uemda_tpu_torch.tools import train_ssl_uem


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--lt" not in argv:
        argv += ["--lt", "ce"]
    if "--refine-label" not in argv:
        argv += ["--refine-label", "0"]
    return train_ssl_uem.main(argv)


if __name__ == "__main__":
    main()
