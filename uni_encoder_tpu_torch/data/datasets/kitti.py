"""The port's own copy of `uni_encoder_tpu/data/datasets/kitti.py`.

KITTI Eigen split registration.

Capability spec: reference model/data/datasets/register_kitti.py — Eigen-Zhou
train / standard Eigen test splits from "folder frame side" file lists;
items carry prev/next frame paths, calib directory and velodyne bin path;
evaluator_type="kitti_depth".
"""

from __future__ import annotations

import os
from typing import List

from ..catalog import DatasetCatalog, MetadataCatalog

SPLITS = {
    "KITTI_eigen_zhou_train_split": (
        "kitti_data",
        "kitti_data/eigen_zhou_train_files_kitti.txt",
        ".jpg",
    ),
    "KITTI_standard_eigen_test_split": (
        "kitti_data",
        "kitti_data/standard_eigen_test_files.txt",
        ".jpg",
    ),
}

SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}


def load_split(data_root: str, files_list: str, img_ext: str = ".jpg") -> List[dict]:
    with open(files_list) as f:
        lines = [l for l in f.read().splitlines() if l]
    items = []
    for line in lines:
        info = line.split()
        folder = info[0]
        frame = int(info[1]) if len(info) == 3 else 0
        side = info[2] if len(info) == 3 else None

        img_dir = os.path.join(data_root, folder, f"image_0{SIDE_MAP[side]}/data")
        image_file = os.path.join(img_dir, f"{frame:010d}{img_ext}")
        prev_file = os.path.join(img_dir, f"{frame - 1:010d}{img_ext}")
        nxt_file = os.path.join(img_dir, f"{frame + 1:010d}{img_ext}")
        calib_path = os.path.join(data_root, folder.split("/")[0])
        velo_file = os.path.join(data_root, folder, f"velodyne_points/data/{frame:010d}.bin")

        if not os.path.isfile(image_file):
            continue
        has_neighbors = os.path.isfile(prev_file) and os.path.isfile(nxt_file)
        items.append(
            {
                "type": "sequence",
                "file_name": image_file,
                "image_id": os.path.splitext(os.path.basename(image_file))[0],
                "left_prev_image_file": prev_file if has_neighbors else None,
                "left_nxt_image_file": nxt_file if has_neighbors else None,
                "calib_path": calib_path,
                "velo_file": velo_file,
                "side": side,
            }
        )
    if not items:
        raise FileNotFoundError(f"no KITTI items found via {files_list}")
    return items


def register_all(root: str) -> None:
    for key, (data_root, files_list, ext) in SPLITS.items():
        args = (os.path.join(root, data_root), os.path.join(root, files_list), ext)
        DatasetCatalog.remove(key)
        DatasetCatalog.register(key, lambda a=args: load_split(*a))
        MetadataCatalog.get(key).set(left_image_root=args[0], evaluator_type="kitti_depth")
