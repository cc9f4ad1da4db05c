"""Evaluators and metrics of the port (`uni_encoder_tpu/evaluation/`'s
counterpart): Cityscapes semantic, panoptic, instance and depth, KITTI
depth, and COCO-format instance AP (ADE20K's instance split)."""
