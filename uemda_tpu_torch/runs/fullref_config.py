"""The reference's full schedule at the flagship LoveDA geometry: the
port's twin of ``runs/fullref_config.py``. 4000/6000/6000 steps with
``EVAL_EVERY`` 500 and ``GENE_EVERY`` 1000 (``configs/st/uemda/
2urban.py:18-25``) over a synthetic target split of 64 x 1024^2 tiles, so
the long schedule's effects show: BatchNorm running statistics over 6000
stage-3 steps, six pseudo-label regenerations a stage over the whole
split, the host pipeline over hours. The geometry and semantics of
``loveda_synth_config.py`` (1024^2 tiles, 7 classes, raw-0 padding
borders -> ignore, 512^2 crops, LoveDA's shared normalization, no clamp).
``UEMDA_FULLREF_LOG`` overrides the snapshot directory. Loading it writes
the data under ``ROOT`` once (PIL needed).
"""

import os

from uemda_tpu_torch.config import PairConfig, SplitConfig
from uemda_tpu_torch.datasets.meta import NORM_STATS, LoveDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset

ROOT = "/tmp/uemda_fullref"
HW = 1024

if not os.path.isdir(f"{ROOT}/src/img_dir/train"):
    make_synthetic_dataset(
        f"{ROOT}/src", LoveDA, n_train=64, n_val=8, hw=HW, seed=0,
        pad_border=32,
    )
if not os.path.isdir(f"{ROOT}/tgt/img_dir/train"):
    make_synthetic_dataset(
        f"{ROOT}/tgt", LoveDA, n_train=64, n_val=8, hw=HW, seed=1,
        domain_shift=12.0, pad_border=32,
    )

_m, _s = NORM_STATS["LoveDA"]["mean"], NORM_STATS["LoveDA"]["std"]

CONFIG = PairConfig(
    name="fullref",
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
    snapshot_dir=os.environ.get("UEMDA_FULLREF_LOG", f"{ROOT}/log"),
    model="resnet50",
    stage1_steps=4000,          # 2urban.py:18 STAGE1_STEPS
    stage2_steps=6000,          # 2urban.py:19 STAGE2_STEPS
    stage3_steps=6000,          # 2urban.py:20 STAGE3_STEPS
    eval_every=500,             # 2urban.py:24 EVAL_EVERY
    gene_every=1000,            # 2urban.py:25 GENE_EVERY
    crop=(512, 512),            # ToURBAN.py RandomCrop(512)
)
