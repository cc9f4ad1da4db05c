"""Dataset registration (the port's counterpart of
`uni_encoder_tpu/data/datasets/__init__.py`): the Cityscapes panoptic and
sequence splits, KITTI and ADE20K (panoptic, semantic and, where its json
exists, instance)."""

import os

from . import ade20k, cityscapes_panoptic, cityscapes_sequence, kitti


def register_all(root: str = None) -> None:
    """Register every builtin dataset under `root` (default: $UNI_DATASETS
    or $DETECTRON2_DATASETS or ./datasets, the reference's convention)."""
    root = root or os.getenv("UNI_DATASETS") or os.getenv("DETECTRON2_DATASETS", "datasets")
    cityscapes_panoptic.register_all(root)
    cityscapes_sequence.register_all(root)
    kitti.register_all(root)
    ade20k.register_all(root)
