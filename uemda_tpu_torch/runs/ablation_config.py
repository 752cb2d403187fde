"""Hard-shift synthetic pair for the ablation of the flagship method: the
port's twin of ``runs/ablation_config.py``. The source is clean
(noise sigma 12); the target has sigma-45 pixel noise (past the ~29-level
palette step: per-pixel class evidence is ambiguous, the 16-pixel blocks
stay poolable), ``palette_mix`` 0.25 (each class's colour a quarter of
the way toward the next class's: a systematic confusion of adjacent
classes) and a global shift, so stage-1 transfer is weak and the pseudo
labels carry dense salt-and-pepper errors: the regime of UemDA's
refinement views and UVEM weighting (``uemda/gast/alignment.py:194-293``,
``balance.py:345-434``). ``UEMDA_ABL_LOG`` overrides the snapshot
directory, so stage-3 variants keep their own. Loading it writes the data
under ``ROOT`` once (PIL needed).
"""

import os

from uemda_tpu_torch.config import PairConfig, SplitConfig
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset

ROOT = "/tmp/uemda_abl"
HW = 256

if not os.path.isdir(f"{ROOT}/src/img_dir/train"):
    make_synthetic_dataset(f"{ROOT}/src", IsprsDA, n_train=48, n_val=8,
                           hw=HW, seed=0)
if not os.path.isdir(f"{ROOT}/tgt/img_dir/train"):
    make_synthetic_dataset(
        f"{ROOT}/tgt", IsprsDA, n_train=48, n_val=8, hw=HW, seed=1,
        domain_shift=8.0, noise=45.0, palette_mix=0.25,
    )

_m, _s = (128.0,) * 3, (64.0,) * 3

CONFIG = PairConfig(
    name="abl_synth",
    datasets="IsprsDA",
    target_set="SynthTarget",
    source=SplitConfig((f"{ROOT}/src/img_dir/train",),
                       (f"{ROOT}/src/ann_dir/train",), _m, _s, 8),
    target=SplitConfig((f"{ROOT}/tgt/img_dir/train",),
                       (f"{ROOT}/tgt/ann_dir/train",), _m, _s, 8),
    val=SplitConfig((f"{ROOT}/tgt/img_dir/val",),
                    (f"{ROOT}/tgt/ann_dir/val",), _m, _s, 4),
    test=SplitConfig((f"{ROOT}/tgt/img_dir/val",),
                     (f"{ROOT}/tgt/ann_dir/val",), _m, _s, 4),
    snapshot_dir=os.environ.get("UEMDA_ABL_LOG", f"{ROOT}/log"),
    model="resnet50",
    stage1_steps=1500,
    stage2_steps=1200,
    stage3_steps=1200,
    eval_every=300,
    gene_every=600,
    crop=(HW, HW),
)
