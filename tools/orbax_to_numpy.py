"""Write a checkpoint of the JAX trainer (`train.py`) as one numpy file that
the PyTorch port reads.

`train.py` saves orbax directories (`uni_encoder_tpu/engine/checkpoint.py::
save_checkpoint`: `OUT/step_<n>/` and the `OUT/last_checkpoint` pointer)
holding the collections `params`, `batch_stats` and `text_params`. This
tool restores one with the JAX package's `load_checkpoint` (a directory
with a `last_checkpoint` pointer is read at the step it names) and writes
every leaf to one `.npz`, keyed `<collection>/<flax>/<path>`. Run it where
JAX and orbax are installed, as `train.py` was; the port reads the file
without them (`tools/convert_checkpoint_torch.py MODEL.npz -o PORT_CKPT`,
through `uni_encoder_tpu_torch/engine/convert.py::state_dict_from_jax`).

Usage:
  python tools/orbax_to_numpy.py TRAIN_OUTPUT_DIR[/step_N] -o model.npz
"""

import argparse
import os
import sys
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

COLLECTIONS = ("params", "batch_stats", "text_params")


def flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def main(argv: Optional[List[str]] = None) -> str:
    """Convert as the command line `argv` asks; returns the written file's path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", help="a train.py output directory (its last_checkpoint) or one step_N directory")
    ap.add_argument("-o", "--output", required=True, help="the .npz to write")
    args = ap.parse_args(argv)

    from uni_encoder_tpu.engine.checkpoint import load_checkpoint

    variables = load_checkpoint(args.checkpoint)
    unknown = sorted(set(variables) - set(COLLECTIONS))
    if unknown:
        raise KeyError(f"{args.checkpoint} holds collections other than {COLLECTIONS}: {unknown}")
    arrays = {"/".join((col,) + path): leaf for col in COLLECTIONS
              for path, leaf in flatten(variables.get(col) or {}).items()}
    with open(args.output, "wb") as f:
        np.savez(f, **arrays)
    n = sum(a.size for k, a in arrays.items() if not k.startswith("batch_stats/"))
    print(f"wrote {len(arrays)} arrays ({n / 1e6:.2f} M params) -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
