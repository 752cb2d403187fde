"""LoveDA-geometry synthetic pair: the port's twin of
``runs/loveda_synth_config.py``, built with the port's own
``make_synthetic_dataset`` and ``PairConfig`` (no JAX, no ``uemda_tpu``).

The 2urban semantics at the geometry the reference trains on: 1024^2
tiles, 7 classes, label offset -1 with raw-0 padding borders
(``uemda/datasets/loveda.py:17-46``), 512^2 random crops
(``configs/ToURBAN.py``), 3x3-window slide (+8-view TTA) evaluation and
pseudo labels at 1024^2, LoveDA's shared normalization for both domains.
A compressed schedule (600/800/800 steps; the reference's is
4000/6000/6000, ``2urban.py:18-25``)::

    python -m uemda_tpu_torch.tools.run_pipeline \\
        --config-path uemda_tpu_torch/runs/loveda_synth_config.py

Loading it writes the data under ``ROOT`` once (PIL needed).
"""

import os

from uemda_tpu_torch.config import PairConfig, SplitConfig
from uemda_tpu_torch.datasets.meta import NORM_STATS, LoveDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset

ROOT = "/tmp/uemda_loveda"
HW = 1024

if not os.path.isdir(f"{ROOT}/src/img_dir/train"):
    make_synthetic_dataset(
        f"{ROOT}/src", LoveDA, n_train=16, n_val=4, hw=HW, seed=0,
        pad_border=32,
    )
if not os.path.isdir(f"{ROOT}/tgt/img_dir/train"):
    make_synthetic_dataset(
        f"{ROOT}/tgt", LoveDA, n_train=16, n_val=4, hw=HW, seed=1,
        domain_shift=12.0, pad_border=32,
    )

_m, _s = NORM_STATS["LoveDA"]["mean"], NORM_STATS["LoveDA"]["std"]

CONFIG = PairConfig(
    name="loveda_synth",
    datasets="LoveDA",
    target_set="SynthUrban",
    source=SplitConfig((f"{ROOT}/src/img_dir/train",),
                       (f"{ROOT}/src/ann_dir/train",), _m, _s, 8),
    target=SplitConfig((f"{ROOT}/tgt/img_dir/train",),
                       (f"{ROOT}/tgt/ann_dir/train",), _m, _s, 8),
    val=SplitConfig((f"{ROOT}/tgt/img_dir/val",),
                    (f"{ROOT}/tgt/ann_dir/val",), _m, _s, 2),
    test=SplitConfig((f"{ROOT}/tgt/img_dir/val",),
                     (f"{ROOT}/tgt/ann_dir/val",), _m, _s, 2),
    snapshot_dir=f"{ROOT}/log",
    model="resnet50",
    stage1_steps=600,
    stage2_steps=800,
    stage3_steps=800,
    eval_every=200,
    gene_every=400,
    crop=(512, 512),  # RandomCrop(512) from the 1024^2 tiles (ToURBAN.py)
)
