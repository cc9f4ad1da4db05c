"""The port's own copy of `uni_encoder_tpu/data/datasets/cityscapes_panoptic.py`.

Cityscapes panoptic dataset registration.

Capability spec: reference model/data/datasets/register_cityscapes_panoptic.py
— registers cityscapes_fine_panoptic_{train,val} and the crop variants
(cityscapes_crop/ roots), building thing/stuff dataset-id -> contiguous
trainId maps from the category table; items carry type="segmentation",
panoptic PNG + segments_info + labelTrainIds semantic PNG;
evaluator_type="cityscapes_panoptic_seg", label_divisor 1000.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from ..catalog import DatasetCatalog, MetadataCatalog
from ..cityscapes_labels import (
    CITYSCAPES_CATEGORIES,
    IGNORE_LABEL,
    LABEL_DIVISOR,
    PALETTE,
    CLASS_NAMES,
)

SPLITS = {
    "cityscapes_fine_panoptic_train": (
        "cityscapes/leftImg8bit/train",
        "cityscapes/gtFine/cityscapes_panoptic_train",
        "cityscapes/gtFine/cityscapes_panoptic_train.json",
    ),
    "cityscapes_fine_panoptic_val": (
        "cityscapes/leftImg8bit/val",
        "cityscapes/gtFine/cityscapes_panoptic_val",
        "cityscapes/gtFine/cityscapes_panoptic_val.json",
    ),
    "cityscapes_segmentation_crop_fine_panoptic_train": (
        "cityscapes_crop/leftImg8bit/train",
        "cityscapes_crop/gtFine/cityscapes_panoptic_train",
        "cityscapes_crop/gtFine/cityscapes_panoptic_train.json",
    ),
    "cityscapes_segmentation_crop_fine_panoptic_val": (
        "cityscapes_crop/leftImg8bit/val",
        "cityscapes_crop/gtFine/cityscapes_panoptic_val",
        "cityscapes_crop/gtFine/cityscapes_panoptic_val.json",
    ),
}


def category_maps() -> Dict[str, Dict[int, int]]:
    thing, stuff = {}, {}
    for k in CITYSCAPES_CATEGORIES:
        (thing if k["isthing"] else stuff)[k["id"]] = k["trainId"]
    return {"thing_dataset_id_to_contiguous_id": thing, "stuff_dataset_id_to_contiguous_id": stuff}


def load_split(image_dir: str, gt_dir: str, gt_json: str) -> List[dict]:
    maps = category_maps()
    with open(gt_json) as f:
        info = json.load(f)

    image_files = {}
    for city in sorted(os.listdir(image_dir)):
        city_dir = os.path.join(image_dir, city)
        for fname in sorted(os.listdir(city_dir)):
            stem = fname[: -len("_leftImg8bit.png")]
            image_files[stem] = os.path.join(city_dir, fname)

    items = []
    for ann in info["annotations"]:
        image_file = image_files[ann["image_id"]]
        segments = []
        for seg in ann["segments_info"]:
            seg = dict(seg)
            cid = seg["category_id"]
            if cid in maps["thing_dataset_id_to_contiguous_id"]:
                seg["category_id"] = maps["thing_dataset_id_to_contiguous_id"][cid]
            else:
                seg["category_id"] = maps["stuff_dataset_id_to_contiguous_id"][cid]
            segments.append(seg)
        sem_file = image_file.replace("leftImg8bit", "gtFine").split(".")[0] + "_labelTrainIds.png"
        items.append(
            {
                "file_name": image_file,
                "type": "segmentation",
                "image_id": "_".join(
                    os.path.splitext(os.path.basename(image_file))[0].split("_")[:3]
                ),
                "sem_seg_file_name": sem_file,
                "pan_seg_file_name": os.path.join(gt_dir, ann["file_name"]),
                "segments_info": segments,
            }
        )
    return items


def register_all(root: str) -> None:
    maps = category_maps()
    for key, (image_dir, gt_dir, gt_json) in SPLITS.items():
        image_dir = os.path.join(root, image_dir)
        gt_dir = os.path.join(root, gt_dir)
        gt_json = os.path.join(root, gt_json)
        DatasetCatalog.remove(key)
        DatasetCatalog.register(
            key, lambda x=image_dir, y=gt_dir, z=gt_json: load_split(x, y, z)
        )
        MetadataCatalog.get(key).set(
            panoptic_root=gt_dir,
            image_root=image_dir,
            panoptic_json=gt_json,
            gt_dir=gt_dir.replace("cityscapes_panoptic_", ""),
            evaluator_type="cityscapes_panoptic_seg",
            ignore_label=IGNORE_LABEL,
            label_divisor=LABEL_DIVISOR,
            thing_classes=CLASS_NAMES,
            stuff_classes=CLASS_NAMES,
            thing_colors=PALETTE,
            stuff_colors=PALETTE,
            **maps,
        )
