"""Training: the set criterion and its matcher, the self-supervised
monodepth loss, the fused AdamW and the `Trainer` (port of
`uni_encoder_tpu/training/`)."""
