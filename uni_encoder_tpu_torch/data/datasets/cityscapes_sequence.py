"""The port's own copy of `uni_encoder_tpu/data/datasets/cityscapes_sequence.py`.

Cityscapes sequence (depth/motion) dataset registration.

Capability spec: reference model/data/datasets/
register_cityscapes_depth_panoptic_multi_pass.py — splits from "city id"
file lists; frame t±2 neighbors resolved in leftImg8bit_sequence; items
carry type="sequence", camera json, optional GT disparity;
evaluator_type="cityscapes_depth". Also covers the stereo-aware depth
panoptic splits (register_cityscapes_depth_panoptic.py) via the
disparity/camera fields.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog

SPLITS = {
    "cityscapes_sequence_crop_full_sequence_train": (
        "cityscapes_full_crop/train_files.txt",
        "cityscapes_full_crop/leftImg8bit_sequence/train",
        "cityscapes_full_crop/leftImg8bit_sequence/train",
        "cityscapes_full_crop/camera/train",
        None,
    ),
    "cityscapes_crop_test": (
        "cityscapes_crop/test_files.txt",
        "cityscapes_crop/leftImg8bit/test",
        "cityscapes_crop/leftImg8bit_sequence/test",
        "cityscapes_crop/camera/test",
        "cityscapes_crop/gt_depths",
    ),
}


def _neighbor(basename: str, offset: int) -> str:
    parts = basename.split("_")
    parts[2] = str(int(parts[2]) + offset).zfill(6)
    return "_".join(parts)


def load_split(
    files_list: str,
    left_dir: str,
    seq_dir: str,
    cam_dir: Optional[str],
    depth_dir: Optional[str],
) -> List[dict]:
    items = []
    with open(files_list) as f:
        lines = [l.strip() for l in f if l.strip()]
    for line in lines:
        city, file_id = line.split(" ")
        basename = file_id + "_leftImg8bit.png"
        image_file = os.path.join(left_dir, city, basename)
        prev_file = os.path.join(seq_dir, city, _neighbor(basename, -2))
        nxt_file = os.path.join(seq_dir, city, _neighbor(basename, +2))
        if not (os.path.isfile(prev_file) and os.path.isfile(nxt_file)):
            continue
        cam_file = (
            os.path.join(cam_dir, city, basename.replace("_leftImg8bit.png", "_camera.json"))
            if cam_dir
            else None
        )
        disp_file = os.path.join(depth_dir, city, basename) if depth_dir else None
        items.append(
            {
                "type": "sequence",
                "file_name": image_file,
                "image_id": "_".join(os.path.splitext(basename)[0].split("_")[:3]),
                "left_prev_image_file": prev_file,
                "left_nxt_image_file": nxt_file,
                "cam_info_file": cam_file,
                "left_disp_file": disp_file,
            }
        )
    if not items:
        raise FileNotFoundError(f"no sequence items found via {files_list}")
    return items


def register_all(root: str) -> None:
    for key, (files_list, left_dir, seq_dir, cam_dir, depth_dir) in SPLITS.items():
        args = (
            os.path.join(root, files_list),
            os.path.join(root, left_dir),
            os.path.join(root, seq_dir),
            os.path.join(root, cam_dir) if cam_dir else None,
            os.path.join(root, depth_dir) if depth_dir else None,
        )
        DatasetCatalog.remove(key)
        DatasetCatalog.register(key, lambda a=args: load_split(*a))
        MetadataCatalog.get(key).set(
            left_image_root=args[1], evaluator_type="cityscapes_depth"
        )
