"""Two iterations of `train_torch.main` with (a) BasePixelDecoder + DCMNet
selected by overrides of the decoder names, and the checkpoint loaded by
`evaluate_torch.build_model`."""

import json
import os

import numpy as np
import torch

from _torch_port_train_decoders import MODELS, one_thread  # noqa: F401 (one thread, autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# configs/cityscapes_swin_unified.yaml at the scaled profile's widths, crops of 64x128
SCALED = ["input.seg_crop_train=[64,128]", "input.seg_min_size_train=[64]", "input.seg_max_size_train=256",
          "input.depth_hw_train=[64,128]", "model.one_former.num_object_queries=8", "model.one_former.dec_layers=2",
          "model.one_former.class_dec_layers=1", "model.one_former.dim_feedforward=64",
          "model.one_former.hidden_dim=32", "model.one_former.nheads=4", "model.one_former.train_num_points=64",
          "model.sem_seg_head.transformer_enc_layers=1", "model.sem_seg_head.convs_dim=32",
          "model.sem_seg_head.mask_dim=32", "model.text_encoder.width=32", "model.text_encoder.num_layers=1",
          "model.text_encoder.proj_num_layers=1", "model.text_encoder.n_ctx=2", "model.num_depth_scales=2",
          "model.backbone.swin.embed_dim=32", "model.backbone.swin.depths=[1,1,1,1]",
          "model.backbone.swin.num_heads=[1,2,4,8]"]
TRAINING_ONLY = ("text_encoder.", "text_projector.", "prompt_ctx.", "logit_scale")


def test_train_entry_point_two_iterations(tmp_path):
    """`train_torch.main` on configs/cityscapes_swin_unified.yaml with the
    decoder names overridden to (a), scaled by overrides: two iterations
    with finite losses in train.py's records, the decoders the overrides
    name, DCMNet's statistics as initialised, and a checkpoint that
    `evaluate_torch.build_model` loads byte for byte, with exactly the
    training-only keys unused."""
    import evaluate_torch
    import train_torch
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.data import synthetic
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    root = str(tmp_path / "data")
    synthetic.write_cityscapes_train(root, 2, (128, 256))
    pixel, depth = MODELS["a"]
    cfg_path = os.path.join(REPO, "configs", "cityscapes_swin_unified.yaml")
    opts = SCALED + [f"model.sem_seg_head.pixel_decoder_name={pixel}", f"model.sem_seg_head.depth_decoder_name={depth}"]
    out = str(tmp_path / "run")
    state = train_torch.main(["--config", cfg_path, "--datasets-root", root, "--output-dir", out, "--max-iter", "2",
                              "--batch", "2", "--log-period", "1", "--checkpoint-period", "2", "--device", "cpu",
                              *opts])
    with open(os.path.join(out, "metrics.json")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert [r["iteration"] for r in records] == [0, 1]
    assert all(np.isfinite(r[k]) for r in records for k in ("loss", "loss_seg", "loss_monodepth"))
    assert state.step == 2 and os.path.isfile(os.path.join(out, "step_2.pt"))
    model = state.model
    assert (type(model.pixel_decoder).__name__, type(model.depth_decoder).__name__) == (pixel, depth)
    cfg = load_config(cfg_path, opts)
    fresh = UniEncoder(cfg.model, device="cpu", seed=0, task_seq_len=cfg.input.task_seq_len)
    init = dict(fresh.named_buffers())
    stats = {k: v for k, v in model.named_buffers() if k.startswith("sem_seg_head.depth_decoder.")}
    assert stats and all(torch.equal(v, init[k]) for k, v in stats.items())

    loaded, report = evaluate_torch.build_model(load_config(cfg_path, opts + ["model.is_train=false"]), out,
                                                device="cpu")
    trained = model.state_dict()
    own = loaded.state_dict()
    assert all(own[k].numpy().tobytes() == trained[k].numpy().tobytes() for k in own)
    assert report.unused == sorted(set(trained) - set(own))
    assert report.unused and all(k.startswith(TRAINING_ONLY) for k in report.unused)
