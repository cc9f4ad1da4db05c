"""Checkpoint conversion command line of the PyTorch port (the counterpart
of `tools/convert_checkpoint.py`).

Capability spec: reference tools/convert-pretrained-model-to-d2.py,
convert-torchvision-to-d2.py, single2double_inputs.py,
merge_two_pretrained_models.py, folded into one tool: merges d2 `.pkl` /
torch `.pth` state dicts and `.npz` files of the JAX trainer's checkpoints
(later files win), optionally duplicates a conv's
input channels (3 -> 6), and writes a port checkpoint directory
(`engine/checkpoint.py::save_checkpoint`: `step_0.pt` and its
`last_checkpoint` pointer) that `evaluate_torch.py`, `demo_torch.py` and
`evaluate_torch.build_model` read.

A `.npz` is what `tools/orbax_to_numpy.py` writes from an orbax checkpoint
of `train.py` (run that where JAX is installed); it goes through
`engine/convert.py::state_dict_from_jax`. When one holds the training
state's text encoder (`text_params`), the model is built as for training
(`is_train`), so that the port checkpoint keeps it; the entry points that
evaluate leave those keys unused.

The model the state is loaded into is the one `--config` describes, or
else `--backbone`'s shipped config (swin: configs/cityscapes_swin_unified.yaml,
resnet: cityscapes_r18.yaml, convnext: cityscapes_convnext.yaml, dinat:
cityscapes_dinat.yaml), in fp32. Its structure is
built without drawing weights (`evaluate_torch.build_structure`);
`load_into` then fills every tensor it owns
and raises on a missing key or a shape mismatch. The source keys the model
does not own are printed (the first 20), as the JAX tool prints its
unconverted keys, with the parameter count. (A reference checkpoint's
`motion_decoder.layer1..4` / `motion_mask.layer1..4` are among them: the
JAX converter writes those into leaves its model never reads, and does not
list them.) The tensors live on the GPU
unless `--device cpu` is given; without a GPU and without that flag it
raises.

Usage:
  python tools/convert_checkpoint_torch.py model.pkl|model.npz [pose.pkl ...] -o out_ckpt/ \
      [--duplicate-conv backbone.patch_embed.proj.weight] [--backbone swin] \
      [--config cfg.yaml] [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BACKBONE_CONFIGS = {
    "swin": "configs/cityscapes_swin_unified.yaml",
    "resnet": "configs/cityscapes_r18.yaml",
    "convnext": "configs/cityscapes_convnext.yaml",
    "dinat": "configs/cityscapes_dinat.yaml",
}


def main(argv: Optional[List[str]] = None) -> str:
    """Convert as the command line `argv` asks; returns the written
    checkpoint file's path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+", help=".pkl/.pth state dicts or tools/orbax_to_numpy.py .npz files "
                                              "(later ones win on conflicts)")
    ap.add_argument("-o", "--output", required=True, help="port checkpoint directory")
    ap.add_argument("--backbone", default="swin", choices=sorted(BACKBONE_CONFIGS))
    ap.add_argument("--duplicate-conv", default=None,
                    help="duplicate a conv's input channels 3->6 (single2double_inputs equivalent)")
    ap.add_argument("--config", default=None, help="the model's config (default: --backbone's shipped config)")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    args = ap.parse_args(argv)

    import evaluate_torch
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.device import resolve_device
    from uni_encoder_tpu_torch.engine import checkpoint as ckpt

    device = resolve_device(args.device)
    states = [ckpt.load_jax_numpy_state(p) if p.endswith(".npz") else ckpt.load_reference_state(p)
              for p in args.inputs]
    state = ckpt.merge_states(*states)
    if args.duplicate_conv:
        state = ckpt.duplicate_input_conv(state, args.duplicate_conv)

    cfg = load_config(args.config or os.path.join(REPO, BACKBONE_CONFIGS[args.backbone]))
    if any(p.endswith(".npz") and any(k.startswith("text_encoder.") for k in st) for p, st in zip(args.inputs, states)):  # the JAX trainer's text encoder: keep it, as a training model holds it
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, is_train=True))
    model = evaluate_torch.build_structure(cfg, device)
    report = ckpt.load_into(model, state)
    if report.unused:
        print(f"WARNING: {len(report.unused)} source keys not converted:")
        for k in report.unused[:20]:
            print(f"  {k}")

    n = sum(p.numel() for p in model.parameters())
    print(f"converted {n / 1e6:.2f} M params -> {args.output}")
    return ckpt.save_checkpoint(args.output, model)


if __name__ == "__main__":
    main()
