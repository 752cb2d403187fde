"""Domain balance: valid-pixel counts and the target-loss weight.

The port's copy of ``uemda_tpu/alignment/domain_balance.py`` (reference
``uemda/gast/domain_balance.py``, dormant there), host numpy over the
port's datasets (``SegDataset.item`` / ``ArrayDataset.item``).
"""

from typing import Tuple

import numpy as np


def examples_cnt(dataset, ignore_label: int = -1, prob_labels: bool = False
                 ) -> Tuple[float, float]:
    """(``domain_balance.py:15-36``) the split's valid pixels and their
    share of all pixels; ``prob_labels``: the arg-max of the stored soft
    labels counts as the label."""
    cnt = cnt_all = 0.0
    for i in range(len(dataset)):
        item = dataset.item(i)
        lbl = np.argmax(item["prob"], axis=-1) if prob_labels \
            else item["label"]
        cnt += float((lbl != ignore_label).sum())
        cnt_all += float(lbl.size)
    return cnt, cnt / max(cnt_all, 1.0)


def get_target_weight(cnt_s, ratio_s, cnt_t, ratio_t) -> float:
    """(``domain_balance.py:38-40``) ``cnt_t ratio_s / (cnt_s ratio_t)``,
    at most 1."""
    weight = cnt_t * ratio_s / (cnt_s * ratio_t + 1e-7)
    return 1.0 if weight >= 1.0 else float(weight)
