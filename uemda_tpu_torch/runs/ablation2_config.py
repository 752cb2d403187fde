"""Variance-dominated synthetic shift for the ablation of the flagship
method: the port's twin of ``runs/ablation2_config.py``. Pixel noise above
the ~35-level palette step (per-pixel evidence genuinely ambiguous: the
salt-and-pepper pseudo-label errors that superpixel and prototype
refinement repair, ``uemda/gast/alignment.py:194-293``), only a mild
``palette_mix`` (a bias no label-averaging view can undo) and a global
shift.

``UEMDA_ABL2_NOISE`` (default 40) and ``UEMDA_ABL2_PMIX`` (default 0.10)
set the shift; each pair gets its own data and run root, which embeds the
two strings verbatim (``UEMDA_ABL2_ROOT`` overrides it), so shell scripts
that interpolate the same strings find the same directory.
``UEMDA_ABL_LOG`` overrides the snapshot directory. Loading it writes the
data under ``ROOT`` once (PIL needed).
"""

import os

from uemda_tpu_torch.config import PairConfig, SplitConfig
from uemda_tpu_torch.datasets.meta import IsprsDA
from uemda_tpu_torch.datasets.synthetic import make_synthetic_dataset

_NOISE_S = os.environ.get("UEMDA_ABL2_NOISE", "40")
_PMIX_S = os.environ.get("UEMDA_ABL2_PMIX", "0.10")
NOISE = float(_NOISE_S)
PMIX = float(_PMIX_S)
ROOT = os.environ.get(
    "UEMDA_ABL2_ROOT",
    f"/tmp/uemda_abl2/n{_NOISE_S}_p{_PMIX_S}",
)
HW = 256

if not os.path.isdir(f"{ROOT}/src/img_dir/train"):
    make_synthetic_dataset(f"{ROOT}/src", IsprsDA, n_train=48, n_val=8,
                           hw=HW, seed=0)
if not os.path.isdir(f"{ROOT}/tgt/img_dir/train"):
    make_synthetic_dataset(
        f"{ROOT}/tgt", IsprsDA, n_train=48, n_val=8, hw=HW, seed=1,
        domain_shift=8.0, noise=NOISE, palette_mix=PMIX,
    )

_m, _s = (128.0,) * 3, (64.0,) * 3

CONFIG = PairConfig(
    name="abl2_synth",
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
