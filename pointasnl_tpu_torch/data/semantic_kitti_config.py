"""SemanticKITTI label taxonomy, mappings, and split (official dataset facts),
the port's copy of ``pointasnl_tpu/data/semantic_kitti_config.py``.

Python rendering of the official semantic-kitti-api configuration (the
reference ships it as SemanticKITTI/semantic-kitti.yaml). These are dataset
constants — raw label ids, the 20-class learning map and its inverse, BGR
color map, per-class content ratios, ignore flags, and the sequence split.
`load_config(path=None)` returns the same dict structure the reference gets
from yaml.safe_load, and accepts an external yaml path for users who want to
point at the official file; ``yaml`` is imported only then.

``KITTI_LABEL_TO_CAT`` (the 20 training classes' names, which the trainers
log per class) lives here, beside the maps, for every KITTI driver of the
port; the JAX package keeps it in ``cli/train_semantic_kitti.py``.
"""

from __future__ import annotations

from typing import Optional

LABELS = {
    0: "unlabeled",
    1: "outlier",
    10: "car",
    11: "bicycle",
    13: "bus",
    15: "motorcycle",
    16: "on-rails",
    18: "truck",
    20: "other-vehicle",
    30: "person",
    31: "bicyclist",
    32: "motorcyclist",
    40: "road",
    44: "parking",
    48: "sidewalk",
    49: "other-ground",
    50: "building",
    51: "fence",
    52: "other-structure",
    60: "lane-marking",
    70: "vegetation",
    71: "trunk",
    72: "terrain",
    80: "pole",
    81: "traffic-sign",
    99: "other-object",
    252: "moving-car",
    253: "moving-bicyclist",
    254: "moving-person",
    255: "moving-motorcyclist",
    256: "moving-on-rails",
    257: "moving-bus",
    258: "moving-truck",
    259: "moving-other-vehicle",
}

COLOR_MAP_BGR = {
    0: [0, 0, 0],
    1: [0, 0, 255],
    10: [245, 150, 100],
    11: [245, 230, 100],
    13: [250, 80, 100],
    15: [150, 60, 30],
    16: [255, 0, 0],
    18: [180, 30, 80],
    20: [255, 0, 0],
    30: [30, 30, 255],
    31: [200, 40, 255],
    32: [90, 30, 150],
    40: [255, 0, 255],
    44: [255, 150, 255],
    48: [75, 0, 75],
    49: [75, 0, 175],
    50: [0, 200, 255],
    51: [50, 120, 255],
    52: [0, 150, 255],
    60: [170, 255, 150],
    70: [0, 175, 0],
    71: [0, 60, 135],
    72: [80, 240, 150],
    80: [150, 240, 255],
    81: [0, 0, 255],
    99: [255, 255, 50],
    252: [245, 150, 100],
    253: [200, 40, 255],
    254: [30, 30, 255],
    255: [90, 30, 150],
    256: [255, 0, 0],
    257: [250, 80, 100],
    258: [180, 30, 80],
    259: [255, 0, 0],
}

CONTENT = {
    0: 0.018889854628292943,
    1: 0.0002937197336781505,
    10: 0.040818519255974316,
    11: 0.00016609538710764618,
    13: 2.7879693665067774e-05,
    15: 0.00039838616015114444,
    16: 0.0,
    18: 0.0020633612104619787,
    20: 0.0016218197275284021,
    30: 0.00017698551338515307,
    31: 1.1065903904919655e-08,
    32: 5.532951952459828e-09,
    40: 0.1987493871255525,
    44: 0.014717169549888214,
    48: 0.14392298360372,
    49: 0.0039048553037472045,
    50: 0.1326861944777486,
    51: 0.0723592229456223,
    52: 0.002395131480328884,
    60: 4.7084144280367186e-05,
    70: 0.26681502148037506,
    71: 0.006035012012626033,
    72: 0.07814222006271769,
    80: 0.002855498193863172,
    81: 0.0006155958086189918,
    99: 0.009923127583046915,
    252: 0.001789309418528068,
    253: 0.00012709999297008662,
    254: 0.00016059776092534436,
    255: 3.745553104802113e-05,
    256: 0.0,
    257: 0.00011351574470342043,
    258: 0.00010157861367183268,
    259: 4.3840131989471124e-05,
}

# Raw label id -> 20-class training id (moving classes folded into static).
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,
    30: 6, 31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13,
    51: 14, 52: 0, 60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19,
    99: 0, 252: 1, 253: 7, 254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

# Training id -> raw label id (for submission .label files).
LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32,
    9: 40, 10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71,
    17: 72, 18: 80, 19: 81,
}

KITTI_LABEL_TO_CAT = {
    0: "unlabeled", 1: "car", 2: "bicycle", 3: "motorcycle", 4: "truck",
    5: "other-vehicle", 6: "person", 7: "bicyclist", 8: "motorcyclist",
    9: "road", 10: "parking", 11: "sidewalk", 12: "other-ground",
    13: "building", 14: "fence", 15: "vegetation", 16: "trunk",
    17: "terrain", 18: "pole", 19: "traffic-sign",
}

LEARNING_IGNORE = {i: (i == 0) for i in range(20)}

SPLIT = {
    "train": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10],
    "valid": [8],
    "test": [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
}

# Per-TRAINING-class content (mapped through LEARNING_MAP) — the hardcoded
# `mapped_content` table the reference uses for class weights
# (SemanticKITTI/semantic_kitti_dataset.py:8-13).
MAPPED_CONTENT = {
    0: 0.03150183342534689,
    1: 0.042607828674502385,
    2: 0.00016609538710764618,
    3: 0.00039838616015114444,
    4: 0.0021649398241338114,
    5: 0.0018070552978863615,
    6: 0.0003375832743104974,
    7: 0.00012711105887399155,
    8: 3.746106399997359e-05,
    9: 0.19879647126983288,
    10: 0.014717169549888214,
    11: 0.14392298360372,
    12: 0.0039048553037472045,
    13: 0.1326861944777486,
    14: 0.0723592229456223,
    15: 0.26681502148037506,
    16: 0.006035012012626033,
    17: 0.07814222006271769,
    18: 0.002855498193863172,
    19: 0.0006155958086189918,
}


def default_config() -> dict:
    """The dict structure yaml.safe_load would produce for the official file."""
    return {
        "labels": dict(LABELS),
        "color_map": {k: list(v) for k, v in COLOR_MAP_BGR.items()},
        "content": dict(CONTENT),
        "learning_map": dict(LEARNING_MAP),
        "learning_map_inv": dict(LEARNING_MAP_INV),
        "learning_ignore": dict(LEARNING_IGNORE),
        "split": {k: list(v) for k, v in SPLIT.items()},
    }


def load_config(path: Optional[str] = None) -> dict:
    """Load an external semantic-kitti.yaml, or fall back to the bundled facts."""
    if path is None:
        return default_config()
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)
