"""Dataset metadata for the ISPRS Potsdam/Vaihingen and LoveDA benchmarks
(a copy of ``uemda_tpu/datasets/meta.py``).

Class tables, palettes, tile sizes, label offsets and per-domain
normalization statistics, mirroring the reference dataset classes
(``uemda/datasets/isprsda.py:17-43``, ``uemda/datasets/loveda.py:17-46``) and
config constants (``configs/ToVaihingen.py:51-53,73-75``,
``configs/ToURBAN.py:51-52``; stats originally derived by ``statistic.py``).
"""

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    name: str
    label_map: "OrderedDict[str, int]"
    color_map: "OrderedDict[str, Tuple[int, int, int]]"
    size: Tuple[int, int]
    ignore_label: int
    offset: int  # added to raw mask ids on load (basedata.py:84)
    eval_ignore_labels: Tuple[int, ...]  # class rows dropped from mean metrics

    @property
    def num_classes(self) -> int:
        return len(self.label_map)

    @property
    def class_names(self) -> List[str]:
        return list(self.label_map.keys())

    @property
    def palette(self) -> List[int]:
        flat: List[int] = []
        for rgb in self.color_map.values():
            flat.extend(int(v) for v in rgb)
        return flat


IsprsDA = DatasetMeta(
    name="IsprsDA",
    label_map=OrderedDict(
        BgClutter=0, imp_surf=1, building=2, low_vege=3, tree=4, car=5
    ),
    color_map=OrderedDict(
        BgClutter=(255, 0, 0),
        imp_surf=(255, 255, 255),
        building=(0, 0, 255),
        low_vege=(0, 255, 255),
        tree=(0, 255, 0),
        car=(255, 255, 0),
    ),
    size=(512, 512),
    ignore_label=-1,
    offset=0,
    eval_ignore_labels=(0,),  # BgClutter excluded from mIoU (utils/eval.py:16-17)
)

LoveDA = DatasetMeta(
    name="LoveDA",
    label_map=OrderedDict(
        Backgd=0, Building=1, Road=2, Water=3, Barren=4, Forest=5, Agricult=6
    ),
    color_map=OrderedDict(
        Backgd=(255, 255, 255),
        Building=(255, 0, 0),
        Road=(255, 255, 0),
        Water=(0, 0, 255),
        Barren=(159, 129, 183),
        Forest=(0, 255, 0),
        Agricult=(255, 195, 128),
    ),
    size=(1024, 1024),
    ignore_label=-1,
    offset=-1,  # raw masks are 0..7 with 0 = padding (loveda.py:43-46)
    eval_ignore_labels=(),
)

DATASET_META: Dict[str, DatasetMeta] = {"IsprsDA": IsprsDA, "LoveDA": LoveDA}

# Per-domain channel statistics (statistic.py output recorded in configs).
NORM_STATS: Dict[str, Dict[str, Tuple[float, float, float]]] = {
    "PotsdamIRRG": {
        "mean": (97.4603, 86.3828, 92.4078),
        "std": (36.2062, 35.7308, 35.3348),
    },
    "Vaihingen": {
        "mean": (120.8217, 81.8250, 81.2344),
        "std": (54.7461, 39.3116, 37.9288),
    },
    # ToPotsdam uses ImageNet stats for all splits (configs/ToPotsdam.py:51-52)
    "ImageNet": {
        "mean": (123.675, 116.28, 103.53),
        "std": (58.395, 57.12, 57.375),
    },
    # LoveDA uses one shared stat set for both domains (configs/ToURBAN.py:51-52)
    "LoveDA": {
        "mean": (73.53223948, 80.01710095, 74.59297778),
        "std": (41.5113661, 35.66528876, 33.75830885),
    },
}
