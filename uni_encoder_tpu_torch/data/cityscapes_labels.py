"""Cityscapes category constants (public dataset metadata; the port's own
copy of `uni_encoder_tpu/data/cityscapes_labels.py`).

The 19 evaluation classes with their official dataset ids, trainIds,
isthing flags and palette colors — the table the reference consumes from
detectron2's builtin_meta (CITYSCAPES_CATEGORIES) to build the
thing/stuff -> contiguous-id maps (register_cityscapes_panoptic.py:143-186).
"""

# (dataset id, trainId, isthing, name, color)
_ROWS = [
    (7, 0, 0, "road", (128, 64, 128)),
    (8, 1, 0, "sidewalk", (244, 35, 232)),
    (11, 2, 0, "building", (70, 70, 70)),
    (12, 3, 0, "wall", (102, 102, 156)),
    (13, 4, 0, "fence", (190, 153, 153)),
    (17, 5, 0, "pole", (153, 153, 153)),
    (19, 6, 0, "traffic light", (250, 170, 30)),
    (20, 7, 0, "traffic sign", (220, 220, 0)),
    (21, 8, 0, "vegetation", (107, 142, 35)),
    (22, 9, 0, "terrain", (152, 251, 152)),
    (23, 10, 0, "sky", (70, 130, 180)),
    (24, 11, 1, "person", (220, 20, 60)),
    (25, 12, 1, "rider", (255, 0, 0)),
    (26, 13, 1, "car", (0, 0, 142)),
    (27, 14, 1, "truck", (0, 0, 70)),
    (28, 15, 1, "bus", (0, 60, 100)),
    (31, 16, 1, "train", (0, 80, 100)),
    (32, 17, 1, "motorcycle", (0, 0, 230)),
    (33, 18, 1, "bicycle", (119, 11, 32)),
]

CITYSCAPES_CATEGORIES = [
    {"id": i, "trainId": t, "isthing": th, "name": n, "color": c} for i, t, th, n, c in _ROWS
]

THING_TRAIN_IDS = [r[1] for r in _ROWS if r[2] == 1]
STUFF_TRAIN_IDS = [r[1] for r in _ROWS if r[2] == 0]
CLASS_NAMES = [r[3] for r in _ROWS]
PALETTE = [r[4] for r in _ROWS]
NUM_CLASSES = len(_ROWS)
LABEL_DIVISOR = 1000
IGNORE_LABEL = 255

# trainId -> official dataset id (needed by evaluators writing cityscapes-
# format outputs) and the reverse
TRAINID_TO_ID = {r[1]: r[0] for r in _ROWS}
ID_TO_TRAINID = {r[0]: r[1] for r in _ROWS}
