"""Offline raw-dataset converters: ISPRS Potsdam / Vaihingen tiling and the
channel statistics the configs bake in.

The port's copy of ``uemda_tpu/datasets/convert.py`` (reference
``convert_datasets/convert_potsdam.py:35-178``, ``convert_vaihingen.py``,
``convert_potsdam_rgb.py`` and ``statistic.py``, without mmcv or skimage):
big rasters are clipped into (clip_size)^2 tiles on a clip-size grid with
the border tiles shifted inward; RGBIR Potsdam images are reordered
Green-Red-IR ('irrg') or R-G-B ('rgb'); colour masks map to class ids
through the dot-product table with clutter merged into background
(``convert_potsdam.py:78-91``). PIL is imported inside the functions that
read or write files: hosts without it import this module.
"""

import os
import os.path as osp
from typing import List, Tuple

import numpy as np

POTSDAM_SPLITS = {
    "train": ["2_10", "3_10", "3_11", "3_12", "4_11", "4_12", "5_10", "5_12",
              "6_10", "6_11", "6_12", "6_8", "6_9", "7_11", "7_12", "7_7", "7_9"],
    "val": ["2_11", "2_12", "4_10", "5_11", "6_7", "7_10", "7_8"],
    "test": ["5_15", "6_15", "6_13", "3_13", "4_14", "6_14", "5_14", "2_13",
             "4_15", "2_14", "5_13", "4_13", "3_14", "7_13"],
}

VAIHINGEN_SPLITS = {
    "train": ["area1", "area11", "area13", "area15", "area17", "area21",
              "area23", "area26", "area28", "area3", "area30", "area32",
              "area34", "area37", "area5", "area7"],
    "val": ["area6", "area24", "area35", "area16", "area14", "area22"],
    "test": ["area10", "area12", "area20", "area2", "area4", "area8",
             "area31", "area33", "area27", "area38", "area29"],
}


def clip_boxes(h: int, w: int, clip_size: int) -> List[Tuple[int, int, int, int]]:
    """(x0, y0, x1, y1) tiles on a clip_size grid over an (h, w) raster,
    the border tiles shifted inward (``convert_potsdam.py:52-76``)."""
    xs = list(range(0, w, clip_size))
    ys = list(range(0, h, clip_size))
    boxes = []
    for y in ys:
        for x in xs:
            x0 = min(x, max(w - clip_size, 0))
            y0 = min(y, max(h - clip_size, 0))
            boxes.append((x0, y0, min(x0 + clip_size, w), min(y0 + clip_size, h)))
    return boxes


def color_mask_to_ids(mask_rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) ISPRS colour mask -> (H, W) uint8 ids through the
    dot-product table (``convert_potsdam.py:78-91``); clutter (id 6 in
    that table's order) merges into background, as does an unknown
    colour."""
    color_map = np.array(
        [[0, 0, 0], [255, 255, 255], [255, 0, 0], [255, 255, 0],
         [0, 255, 0], [0, 255, 255], [0, 0, 255]]
    )
    key = np.array([2, 3, 4])
    flat = mask_rgb.reshape(-1, 3).astype(np.int64) @ key
    out = np.zeros_like(flat)
    for idx, cc in enumerate(color_map):
        out[flat == int(cc @ key)] = idx
    out = out.reshape(mask_rgb.shape[:2])
    out[out == 6] = 0  # clutter -> background
    return out.astype(np.uint8)


def convert_raster(
    image_path: str,
    out_dir: str,
    clip_size: int = 512,
    to_label: bool = False,
    channels: str = "irrg",
    name_prefix: str = None,
):
    """Clip one raster into ``<out_dir>/<prefix>_<x0>_<y0>_<x1>_<y1>.png``
    tiles: a colour label mask as ids (``to_label``), else the image's
    channels ('irrg' reorders four-channel RGBIR to G-R-IR; otherwise the
    first three). ``name_prefix`` defaults to the Potsdam tile id, the
    file name's third and fourth ``_`` fields."""
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # ISPRS rasters are 6000^2
    with Image.open(image_path) as im:
        arr = np.asarray(im)
    if to_label:
        arr = color_mask_to_ids(arr[..., :3])
    else:
        if channels == "irrg" and arr.shape[-1] >= 4:
            arr = arr[:, :, [1, 0, 3]]  # Green-Red-IR (convert_potsdam.py:46)
        else:
            arr = arr[..., :3]
    h, w = arr.shape[:2]
    os.makedirs(out_dir, exist_ok=True)
    prefix = name_prefix or "_".join(osp.basename(image_path).split("_")[2:4])
    for (x0, y0, x1, y1) in clip_boxes(h, w, clip_size):
        tile = arr[y0:y1, x0:x1]
        Image.fromarray(tile.astype(np.uint8)).save(
            osp.join(out_dir, f"{prefix}_{x0}_{y0}_{x1}_{y1}.png")
        )


def compute_channel_stats(image_dir) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean and standard deviation (two passes, f64) over every
    image of ``image_dir`` (a directory or a list of them): the reference's
    ``statistic.py:1-96``, the source of the configs' normalization."""
    from uemda_tpu_torch.datasets.io import list_images, read_image

    paths = list_images(image_dir)
    total, count = np.zeros(3, np.float64), 0
    for p in paths:
        img = read_image(p).reshape(-1, 3).astype(np.float64)
        total += img.sum(axis=0)
        count += img.shape[0]
    mean = total / count
    sq = np.zeros(3, np.float64)
    for p in paths:
        img = read_image(p).reshape(-1, 3).astype(np.float64)
        sq += ((img - mean) ** 2).sum(axis=0)
    return mean, np.sqrt(sq / count)
