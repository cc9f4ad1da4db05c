"""The port's own copy of `uni_encoder_tpu/data/datasets/coco.py`.

COCO-format instance dataset registration.

Capability spec: the reference carries a COCO-style evaluator fork
(model/evaluation/coco_evaluator.py / instance_evaluation.py) and ADE/COCO
dataset-prep tooling. This front-end registers any COCO-format instance
json (images + annotations with RLE/polygon segmentations) into the
catalog; evaluation/coco.py consumes the same json for AP.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from ..catalog import DatasetCatalog, MetadataCatalog


def load_coco_json(json_file: str, image_root: str) -> List[dict]:
    with open(json_file) as f:
        data = json.load(f)
    images = {im["id"]: im for im in data["images"]}
    cats = sorted(data["categories"], key=lambda c: c["id"])
    cat_to_contiguous = {c["id"]: i for i, c in enumerate(cats)}

    anns_by_image: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    items = []
    for img_id, im in images.items():
        items.append(
            {
                "type": "segmentation",
                "file_name": os.path.join(image_root, im["file_name"]),
                "image_id": img_id,
                "height": im["height"],
                "width": im["width"],
                "annotations": [
                    {
                        "category_id": cat_to_contiguous[a["category_id"]],
                        "segmentation": a.get("segmentation"),
                        "bbox": a.get("bbox"),
                        "iscrowd": a.get("iscrowd", 0),
                        "area": a.get("area", 0),
                    }
                    for a in anns_by_image.get(img_id, [])
                ],
            }
        )
    return items


def register_coco_instances(name: str, json_file: str, image_root: str) -> None:
    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root))
    with open(json_file) as f:
        cats = sorted(json.load(f)["categories"], key=lambda c: c["id"])
    MetadataCatalog.get(name).set(
        json_file=json_file,
        image_root=image_root,
        evaluator_type="coco_instance",
        thing_classes=[c["name"] for c in cats],
        thing_dataset_id_to_contiguous_id={c["id"]: i for i, c in enumerate(cats)},
    )
