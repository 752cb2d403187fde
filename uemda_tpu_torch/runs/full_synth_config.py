"""Schedule-scale synthetic pair: the port's twin of
``runs/full_synth_config.py``. The reference's step counts (4000/6000/6000,
batch 8, ``configs/st/uemda/2vaihingen.py:14-25``) on a generated
IsprsDA source/target pair of 256^2 tiles: the LR decay's tail, the
prototype EMA's saturation and the ``GENE_EVERY`` regeneration cadence
end to end::

    python -m uemda_tpu_torch.tools.run_pipeline \\
        --config-path uemda_tpu_torch/runs/full_synth_config.py

Loading it writes the data under ``ROOT`` once (PIL needed).
"""

import os

from uemda_tpu_torch.config import PairConfig, SplitConfig
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset

ROOT = "/tmp/uemda_full"
HW = 256

if not os.path.isdir(f"{ROOT}/src/img_dir/train"):
    make_synthetic_dataset(f"{ROOT}/src", IsprsDA, n_train=48, n_val=8, hw=HW, seed=0)
if not os.path.isdir(f"{ROOT}/tgt/img_dir/train"):
    make_synthetic_dataset(
        f"{ROOT}/tgt", IsprsDA, n_train=48, n_val=8, hw=HW, seed=1,
        domain_shift=10.0,
    )

_m, _s = (128.0,) * 3, (64.0,) * 3

CONFIG = PairConfig(
    name="full_synth",
    datasets="IsprsDA",
    target_set="SynthTarget",
    source=SplitConfig((f"{ROOT}/src/img_dir/train",), (f"{ROOT}/src/ann_dir/train",), _m, _s, 8),
    target=SplitConfig((f"{ROOT}/tgt/img_dir/train",), (f"{ROOT}/tgt/ann_dir/train",), _m, _s, 8),
    val=SplitConfig((f"{ROOT}/tgt/img_dir/val",), (f"{ROOT}/tgt/ann_dir/val",), _m, _s, 4),
    test=SplitConfig((f"{ROOT}/tgt/img_dir/val",), (f"{ROOT}/tgt/ann_dir/val",), _m, _s, 4),
    snapshot_dir=f"{ROOT}/log",
    model="resnet50",
    # reference schedule (2vaihingen.py:14-25)
    stage1_steps=4000,
    stage2_steps=6000,
    stage3_steps=6000,
    eval_every=500,
    gene_every=2000,  # 3 pseudo-label regenerations inside stage 3
    crop=(HW, HW),
)
