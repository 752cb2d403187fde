"""Dataset-pair presets: the port's copy of ``uemda_tpu/config.py``.

A ``PairConfig`` per dataset pair (2vaihingen, 2potsdam, 2urban, 2rural,
the RGB-Potsdam pairs and their ``proca.`` twins; reference
``configs/To*.py``, ``configs/st/*/*.py``) holds the split directories, the
per-domain normalization statistics, the backbone name, the tile size, the
snapshot directory and the training hyperparameters
(``configs/st/uemda/2vaihingen.py:13-48``). ``load_config(name)`` resolves
a preset by name or imports a user Python file exposing ``CONFIG``.
"""

import dataclasses
import os
from typing import Optional, Tuple

from uemda_tpu_torch.datasets.meta import DATASET_META, NORM_STATS, DatasetMeta


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    image_dir: Tuple[str, ...]
    mask_dir: Tuple[Optional[str], ...] = (None,)
    mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    batch_size: int = 8


@dataclasses.dataclass(frozen=True)
class PairConfig:
    name: str  # e.g. '2vaihingen'
    datasets: str  # 'IsprsDA' | 'LoveDA'
    target_set: str  # e.g. 'Vaihingen'
    source: SplitConfig
    target: SplitConfig
    val: SplitConfig
    test: SplitConfig
    snapshot_dir: str = "./log/uemda"

    # hyperparameters (configs/st/uemda/2vaihingen.py:13-25)
    model: str = "resnet50"
    learning_rate: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 5e-4
    power: float = 0.9
    stage1_steps: int = 4000
    stage2_steps: int = 6000
    stage3_steps: int = 6000
    eval_every: int = 500
    gene_every: int = 1000
    cutoff_top: float = 0.8
    cutoff_low: float = 0.6
    crop: Tuple[int, int] = (512, 512)
    # stage-3-style target Normalize clamp(max=1.0): the ISPRS configs only
    # (configs/st/uemda/2vaihingen.py:38); every LoveDA config normalizes
    # without it (uemda_tpu/config.py:59-67)
    clamp_target: bool = False

    @property
    def meta(self) -> DatasetMeta:
        return DATASET_META[self.datasets]

    @property
    def ignore_label(self) -> int:
        return self.meta.ignore_label

    @property
    def class_num(self) -> int:
        return self.meta.num_classes


def _isprs_pair(name, target_set, src_stats, tgt_stats, src_city, tgt_city,
                data_root="data/IsprsDA"):
    sm, ss = NORM_STATS[src_stats]["mean"], NORM_STATS[src_stats]["std"]
    tm, ts = NORM_STATS[tgt_stats]["mean"], NORM_STATS[tgt_stats]["std"]
    return PairConfig(
        name=name,
        datasets="IsprsDA",
        target_set=target_set,
        source=SplitConfig(
            (f"{data_root}/{src_city}/img_dir/train",),
            (f"{data_root}/{src_city}/ann_dir/train",),
            sm, ss,
        ),
        target=SplitConfig(
            (f"{data_root}/{tgt_city}/img_dir/train",),
            (f"{data_root}/{tgt_city}/ann_dir/train",),
            tm, ts,
        ),
        val=SplitConfig(
            (f"{data_root}/{tgt_city}/img_dir/val",),
            (f"{data_root}/{tgt_city}/ann_dir/val",),
            tm, ts, batch_size=8,
        ),
        test=SplitConfig(
            (f"{data_root}/{tgt_city}/img_dir/test",),
            (f"{data_root}/{tgt_city}/ann_dir/test",),
            tm, ts, batch_size=8,
        ),
        snapshot_dir=f"./log/uemda/{name}",
        clamp_target=True,  # configs/st/uemda/2vaihingen.py:38
    )


def _loveda_pair(name, target_set, src_domain, tgt_domain, data_root="data/LoveDA"):
    m, s = NORM_STATS["LoveDA"]["mean"], NORM_STATS["LoveDA"]["std"]
    return PairConfig(
        name=name,
        datasets="LoveDA",
        target_set=target_set,
        source=SplitConfig(
            (f"{data_root}/Train/{src_domain}/images_png",),
            (f"{data_root}/Train/{src_domain}/masks_png",),
            m, s,
        ),
        target=SplitConfig(
            (f"{data_root}/Train/{tgt_domain}/images_png",),
            (f"{data_root}/Train/{tgt_domain}/masks_png",),
            m, s,
        ),
        val=SplitConfig(
            (f"{data_root}/Val/{tgt_domain}/images_png",),
            (f"{data_root}/Val/{tgt_domain}/masks_png",),
            m, s, batch_size=2,
        ),
        test=SplitConfig(
            (f"{data_root}/Val/{tgt_domain}/images_png",),
            (f"{data_root}/Val/{tgt_domain}/masks_png",),
            m, s, batch_size=2,
        ),
        snapshot_dir=f"./log/uemda/{name}",
    )


PRESETS = {
    "2vaihingen": _isprs_pair(
        "2vaihingen", "Vaihingen", "PotsdamIRRG", "Vaihingen",
        "Potsdam", "Vaihingen",
    ),
    # ToPotsdam normalizes every split with ImageNet stats (ToPotsdam.py:51-52)
    "2potsdam": _isprs_pair(
        "2potsdam", "Potsdam", "ImageNet", "ImageNet", "Vaihingen", "Potsdam"
    ),
    "2urban": _loveda_pair("2urban", "Urban", "Rural", "Urban"),
    "2rural": _loveda_pair("2rural", "Rural", "Urban", "Rural"),
}

# RGB-Potsdam pairs (configs/st/{uemda,proca}/pRgb2*.py): source =
# RGB-channel Potsdam tiles, ResNet-101 backbone; pRgb2vaihingen normalizes
# both domains with Vaihingen stats (:27-28), while pRgb2potsdam uses
# ImageNet stats everywhere (via ToPotsdam).
PRESETS["pRgb2vaihingen"] = dataclasses.replace(
    _isprs_pair(
        "pRgb2vaihingen", "Vaihingen", "Vaihingen", "Vaihingen",
        "Potsdam_rgb", "Vaihingen",
    ),
    model="resnet101",
    snapshot_dir="./log/uemda/pRgb2vaihingen",
)
PRESETS["pRgb2potsdam"] = dataclasses.replace(
    _isprs_pair(
        "pRgb2potsdam", "Potsdam", "ImageNet", "ImageNet",
        "Potsdam_rgb", "Potsdam",
    ),
    model="resnet101",
    snapshot_dir="./log/uemda/pRgb2potsdam",
)

# ProCA-method variants: the reference's configs/st/proca/*.py differ from
# the uemda configs only in the snapshot directory ('st.proca.X' resolves to
# 'proca.X').
for _name in list(PRESETS):
    PRESETS[f"proca.{_name}"] = dataclasses.replace(
        PRESETS[_name], snapshot_dir=f"./log/proca/{_name}")


def load_config(name_or_path: str, snapshot_postfix: str = "") -> PairConfig:
    """Resolve a preset name ('2vaihingen', also the reference's dotted
    'st.uemda.2vaihingen' / 'st.proca.pRgb2vaihingen' forms) or a Python
    file with CONFIG; ``snapshot_postfix`` is appended to its snapshot
    directory (a stage's subdirectory, e.g. ``/src``)."""
    parts = name_or_path.split(".")
    key = next(
        (k for k in (".".join(parts[-2:]), parts[-1]) if k in PRESETS), None
    )
    if key is not None:
        cfg = PRESETS[key]
    elif os.path.exists(name_or_path):
        import importlib.util

        spec = importlib.util.spec_from_file_location("user_config", name_or_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cfg = mod.CONFIG
    else:
        raise KeyError(
            f"unknown config '{name_or_path}' (presets: {sorted(PRESETS)})"
        )
    if snapshot_postfix:
        cfg = dataclasses.replace(
            cfg, snapshot_dir=cfg.snapshot_dir + snapshot_postfix)
    return cfg
