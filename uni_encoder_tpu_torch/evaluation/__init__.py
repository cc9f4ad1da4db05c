"""Evaluators and metrics of the port (`uni_encoder_tpu/evaluation/`'s
counterpart): Cityscapes semantic, panoptic, instance and depth, KITTI depth."""
