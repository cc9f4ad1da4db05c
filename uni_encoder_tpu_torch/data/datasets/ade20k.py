"""The port's own copy of `uni_encoder_tpu/data/datasets/ade20k.py`.

ADE20K dataset registration (panoptic / instance / semantic).

Capability spec: the reference evaluates ADE20K through detectron2's
builtin registrations (train_net.py:92-149 routes evaluator_type
"ade20k_panoptic_seg"/"sem_seg"; oneformer_model.py:470-473 remaps instance
labels through the thing-id list for 'ade20k' datasets). The PNG/json
layout consumed here is produced by datasets/prepare_ade20k_*.py.

Category convention: dataset ids are the 0-based contiguous 150-class ids,
so both thing and stuff dataset->contiguous maps are identities over their
subsets; the instance json (100 thing classes) uses the same ids, remapped
to 0..99 by sorted order at load time (data/datasets/coco.py).
"""

from __future__ import annotations

import json
import os
from typing import List

from ..catalog import DatasetCatalog, MetadataCatalog
from ..prep import ade20k_150_categories
from .coco import register_coco_instances

LABEL_DIVISOR = 1000
IGNORE_LABEL = 255

SPLITS = {"train": "training", "val": "validation"}


def load_panoptic_split(base: str, split: str) -> List[dict]:
    dirname = SPLITS[split]
    with open(os.path.join(base, f"ade20k_panoptic_{split}.json")) as f:
        info = json.load(f)

    # optional instance annotations on the same items (reference evaluates
    # ADE20K instance AP on the panoptic val set via a COCO-format json)
    inst_by_image = {}
    inst_json = os.path.join(base, f"ade20k_instance_{split}.json")
    if os.path.exists(inst_json):
        with open(inst_json) as f:
            inst = json.load(f)
        cats = sorted(inst["categories"], key=lambda c: c["id"])
        to_contig = {c["id"]: i for i, c in enumerate(cats)}
        for a in inst.get("annotations", []):
            inst_by_image.setdefault(a["image_id"], []).append(
                {
                    "category_id": to_contig[a["category_id"]],
                    "segmentation": a.get("segmentation"),
                    "bbox": a.get("bbox"),
                    "iscrowd": a.get("iscrowd", 0),
                    "area": a.get("area", 0),
                }
            )

    images = {im["id"]: im for im in info["images"]}
    items = []
    for ann in info["annotations"]:
        im = images[ann["image_id"]]
        item = {
            "type": "segmentation",
            "file_name": os.path.join(base, "images", dirname, im["file_name"]),
            "image_id": ann["image_id"],
            "height": im["height"],
            "width": im["width"],
            "pan_seg_file_name": os.path.join(base, f"ade20k_panoptic_{split}", ann["file_name"]),
            "sem_seg_file_name": os.path.join(
                base, "annotations_detectron2", dirname, ann["image_id"] + ".png"
            ),
            "segments_info": [dict(s) for s in ann["segments_info"]],
        }
        if ann["image_id"] in inst_by_image:
            item["annotations"] = inst_by_image[ann["image_id"]]
        items.append(item)
    return items


def load_sem_seg_split(base: str, split: str) -> List[dict]:
    dirname = SPLITS[split]
    image_dir = os.path.join(base, "images", dirname)
    ann_dir = os.path.join(base, "annotations_detectron2", dirname)
    items = []
    for fname in sorted(os.listdir(image_dir)):
        stem = fname.rsplit(".", 1)[0]
        items.append(
            {
                "type": "segmentation",
                "file_name": os.path.join(image_dir, fname),
                "image_id": stem,
                "sem_seg_file_name": os.path.join(ann_dir, stem + ".png"),
            }
        )
    return items


def register_all(root: str) -> None:
    base = os.path.join(root, "ADEChallengeData2016")
    cats = ade20k_150_categories()
    names = [c["name"] for c in cats]
    colors = [c["color"] for c in cats]
    thing_map = {c["id"]: c["id"] for c in cats if c["isthing"]}
    stuff_map = {c["id"]: c["id"] for c in cats if not c["isthing"]}
    thing_names = [c["name"] for c in cats if c["isthing"]]

    for split in SPLITS:
        key = f"ade20k_panoptic_{split}"
        DatasetCatalog.remove(key)
        DatasetCatalog.register(key, lambda b=base, s=split: load_panoptic_split(b, s))
        MetadataCatalog.get(key).set(
            panoptic_root=os.path.join(base, f"ade20k_panoptic_{split}"),
            image_root=os.path.join(base, "images", SPLITS[split]),
            panoptic_json=os.path.join(base, f"ade20k_panoptic_{split}.json"),
            evaluator_type="ade20k_panoptic_seg",
            ignore_label=IGNORE_LABEL,
            label_divisor=LABEL_DIVISOR,
            thing_classes=names,
            stuff_classes=names,
            thing_colors=colors,
            stuff_colors=colors,
            num_sem_classes=len(names),
            instance_classes=thing_names,
            thing_dataset_id_to_contiguous_id=thing_map,
            stuff_dataset_id_to_contiguous_id=stuff_map,
        )

        sem_key = f"ade20k_sem_seg_{split}"
        DatasetCatalog.remove(sem_key)
        DatasetCatalog.register(sem_key, lambda b=base, s=split: load_sem_seg_split(b, s))
        MetadataCatalog.get(sem_key).set(
            image_root=os.path.join(base, "images", SPLITS[split]),
            evaluator_type="sem_seg",
            ignore_label=IGNORE_LABEL,
            stuff_classes=names,
            num_sem_classes=len(names),
        )

        # instance registration needs the prepped json for its category list;
        # registration must not touch disk when the dataset isn't present
        inst_json = os.path.join(base, f"ade20k_instance_{split}.json")
        if os.path.exists(inst_json):
            register_coco_instances(
                f"ade20k_instance_{split}", inst_json, os.path.join(base, "images", SPLITS[split])
            )
