"""Demo entry point of the PyTorch port (the counterpart of `demo.py`).

Capability spec: reference demo/demo.py (:88-154): seeded deterministic run,
globs input images, derives the previous frame path by filename arithmetic
(frame - 2, or the same name in leftImg8bit_sequence), runs the two-pass
predictor (`uni_encoder_tpu_torch/demo/predictor.py`), saves one output
directory per requested rendering and logs per-image latency.

Weights: a reference d2 `.pkl` or torch `.pth`, or a port checkpoint
directory, loaded by `evaluate_torch.build_model`. The model runs on the GPU
unless `--device cpu` is given; without a GPU and without that flag it
raises. Nothing here needs matplotlib; PIL is imported to draw the text
labels and to read or write JPEG files.

Usage:
  python demo_torch.py --input 'path/to/*.png' --output out/ [--config cfg.yaml]
      [--weights model.pth] [--task panoptic] [--device cpu] [opts a.b.c=v ...]
"""

import argparse
import dataclasses
import glob
import logging
import os
import sys
import time
from typing import Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

logger = logging.getLogger("demo_torch")


def prev_frame_path(path: str, offset: int = -2) -> Optional[str]:
    """cityscapes naming: city_seq_frame_leftImg8bit.png; the previous frame
    lives beside it or in leftImg8bit_sequence (reference demo.py:114-121)."""
    base = os.path.basename(path)
    parts = base.split("_")
    if len(parts) < 4:
        return None
    try:
        parts[2] = str(int(parts[2]) + offset).zfill(6)
    except ValueError:
        return None
    prev = os.path.join(os.path.dirname(path), "_".join(parts))
    if os.path.isfile(prev):
        return prev
    seq = prev.replace("leftImg8bit/", "leftImg8bit_sequence/")
    return seq if os.path.isfile(seq) else None


def main(argv: Optional[List[str]] = None, timings: Optional[List[Dict]] = None) -> Dict[str, Dict[str, str]]:
    """Render every image the command line `argv` globs; returns {input
    path: {rendering name: written file}}. With `timings`, appends one
    record per image: its path, and the seconds spent reading it, in the
    model passes (`predict_s`), rendering (`render_s`) and writing."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--input", required=True, help="glob of input images")
    ap.add_argument("--output", required=True)
    ap.add_argument("--task", default="panoptic", choices=["panoptic", "semantic", "instance"])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_intermixed_args(argv)

    np.random.seed(42)

    import evaluate_torch
    from uni_encoder_tpu_torch.config import Config, load_config
    from uni_encoder_tpu_torch.data.image_io import read_image, write_image
    from uni_encoder_tpu_torch.demo.predictor import VisualizationDemo
    from uni_encoder_tpu_torch.device import resolve_device

    cfg = load_config(args.config, args.opts) if (args.config or args.opts) else Config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, is_demo=True))
    device = resolve_device(args.device)
    model, _ = evaluate_torch.build_model(cfg, args.weights, device)
    demo = VisualizationDemo(cfg, model)
    paths = sorted(glob.glob(args.input))
    if not paths:
        raise FileNotFoundError(f"no inputs match {args.input}")

    written: Dict[str, Dict[str, str]] = {}
    for path in paths:
        t0 = time.perf_counter()
        image = read_image(path)
        prev_path = prev_frame_path(path)
        prev = read_image(prev_path) if prev_path else None
        read_s = time.perf_counter() - t0
        timing: Dict = {}
        outputs = demo.run_on_image(image, prev, args.task, timing)
        t1 = time.perf_counter()
        written[path] = {}
        for name, img in outputs.items():
            out_dir = os.path.join(args.output, name)
            os.makedirs(out_dir, exist_ok=True)
            written[path][name] = os.path.join(out_dir, os.path.basename(path))
            write_image(written[path][name], img)
        write_s = time.perf_counter() - t1
        seconds = time.perf_counter() - t0
        if timings is not None:
            timings.append(dict(timing, image=path, read_s=read_s, write_s=write_s, seconds=seconds))
        logger.info(f"{path}: {len(outputs)} outputs in {seconds:.2f}s (predict {timing['predict_s']:.2f}s, "
                    f"render {timing['render_s']:.2f}s)")
    return written


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    main()
