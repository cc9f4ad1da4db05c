"""Dataset registration (the port's counterpart of
`uni_encoder_tpu/data/datasets/__init__.py`): the Cityscapes panoptic and
sequence splits and KITTI. ADE20K and COCO are not ported yet (ROADMAP
Queue 1 item 3)."""

import os

from . import cityscapes_panoptic, cityscapes_sequence, kitti


def register_all(root: str = None) -> None:
    """Register every ported builtin dataset under `root` (default:
    $UNI_DATASETS or $DETECTRON2_DATASETS or ./datasets, the reference's
    convention)."""
    root = root or os.getenv("UNI_DATASETS") or os.getenv("DETECTRON2_DATASETS", "datasets")
    cityscapes_panoptic.register_all(root)
    cityscapes_sequence.register_all(root)
    kitti.register_all(root)
