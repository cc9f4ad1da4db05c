"""The demo of the port (`uni_encoder_tpu/demo/`'s counterpart): the
two-pass predictor and the renderings of `demo_torch.py`."""
