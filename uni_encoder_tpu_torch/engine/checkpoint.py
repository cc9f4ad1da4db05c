"""Checkpoint I/O of the port: reference d2 `.pkl` / `.pth` files, and the
port's own checkpoints (the counterpart of `uni_encoder_tpu/engine/checkpoint.py`).

Reference files: `load_reference_state` reads a detectron2 `.pkl` (a
pickled numpy dict, under "model" when present) or a torch `.pth` (under
"model" or "state_dict" when present), drops the `num_batches_tracked`
counters and applies the reference's legacy-key migrations
(oneformer_head.py:26-48 "sem_seg_head.* -> sem_seg_head.pixel_decoder.*";
oneformer_transformer_decoder.py:231-252 "static_query -> query_feat").
`merge_states` and `duplicate_input_conv` are the converter tools
(tools/merge_two_pretrained_models.py, tools/single2double_inputs.py).

The port's modules keep the reference's d2 names, so loading is a key
match: `load_into` loads every key the model owns, raises on a missing key
or a shape mismatch, and returns the file's keys the model does not own in
`LoadReport.unused` (the JAX converter's `Converter.unused`): in a
reference checkpoint those are `motion_decoder.layer1..4` /
`motion_mask.layer1..4` (MotionDecoderV2 builds only `layer0`) and, in an
eval-mode model, the text encoder's keys.

The port's own checkpoints: `save_checkpoint(dir, model, optimizer_state,
step)` writes `dir/step_<step>.pt` with `torch.save` to a temporary file,
fsyncs and renames it, and only then publishes it in `dir/last_checkpoint`
(written the same way), so a crash never leaves the pointer at a partial
file. `load_checkpoint(dir)` reads the file the pointer names. The JAX
package's orbax directories are not read.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

POINTER = "last_checkpoint"


# ------------------------------------------------------------ reference files
def load_reference_state(path: str) -> Dict[str, np.ndarray]:
    """Load a d2 .pkl or a torch .pth into a flat {name: np.ndarray} dict,
    applying the reference's legacy-key migrations."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        state = data.get("model", data)
        state = {k: np.asarray(v) for k, v in state.items() if not k.endswith("num_batches_tracked")}
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
        state = data.get("model", data.get("state_dict", data))
        state = {
            k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in state.items()
            if not k.endswith("num_batches_tracked")
        }
    return migrate_legacy_keys(state)


def migrate_legacy_keys(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state.items():
        nk = k
        if "static_query" in nk:  # oneformer_transformer_decoder.py:241-244
            nk = nk.replace("static_query", "query_feat")
        # oneformer_head.py:34-42: pre-v2 checkpoints lack the pixel_decoder scope
        if (
            nk.startswith("sem_seg_head.")
            and not nk.startswith("sem_seg_head.predictor")
            and not nk.startswith("sem_seg_head.pixel_decoder.")
            and not nk.startswith("sem_seg_head.depth_decoder.")
        ):
            nk = nk.replace("sem_seg_head.", "sem_seg_head.pixel_decoder.", 1)
        out[nk] = v
    return out


def merge_states(*states: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """tools/merge_two_pretrained_models.py equivalent: dict union, later
    states win."""
    out: Dict[str, np.ndarray] = {}
    for s in states:
        out.update(s)
    return out


def duplicate_input_conv(state: Dict[str, np.ndarray], key: str) -> Dict[str, np.ndarray]:
    """tools/single2double_inputs.py:27-40: duplicate a conv's input channels
    (3 -> 6) for two-frame inputs, halving the weights."""
    out = dict(state)
    w = out[key]
    out[key] = np.concatenate([w, w], axis=1) / 2.0  # OIHW, axis 1 = in
    return out


# --------------------------------------------------------------- loading
@dataclasses.dataclass
class LoadReport:
    loaded: List[str]  # the model's keys, every one loaded
    unused: List[str]  # the file's keys the model does not own


def load_into(model: nn.Module, state: Mapping[str, Any]) -> LoadReport:
    """Load `state` ({d2 name: array or tensor}) into `model`: every key of
    `model.state_dict()` must be in `state` with the same shape (values are
    cast to the model's dtype); keys the model does not own are returned,
    never dropped silently."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"{len(missing)} of the model's keys are not in the checkpoint: {missing[:10]}")
    mismatched = [f"{k}: checkpoint {tuple(np.shape(state[k]))}, model {tuple(own[k].shape)}"
                  for k in own if tuple(np.shape(state[k])) != tuple(own[k].shape)]
    if mismatched:
        raise ValueError(f"{len(mismatched)} shape mismatches: {mismatched[:10]}")
    model.load_state_dict({k: torch.as_tensor(state[k]) for k in own}, strict=True)
    return LoadReport(loaded=sorted(own), unused=sorted(set(state) - set(own)))


# --------------------------------------------------------- port checkpoints
def _write_durable(dst: str, write: Callable[[Any], None]) -> None:
    """Write `dst` through a temporary file that is fsynced and renamed, and
    fsync the directory, so `dst` is either absent, the old file or the
    whole new one."""
    tmp = f"{dst}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, dst)
    fd = os.open(os.path.dirname(os.path.abspath(dst)), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(path: str, model: nn.Module, optimizer_state: Optional[Mapping] = None, step: int = 0) -> str:
    """Save the model's state dict (on the CPU), `optimizer_state` (tensors,
    numbers, strings, lists and dicts, e.g. `dataclasses.asdict` of the
    trainer's optimizer state) and `step` as `path/step_<step>.pt`, then
    point `path/last_checkpoint` at it. Returns the file's path."""
    os.makedirs(path, exist_ok=True)
    name = f"step_{step}.pt"
    payload = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
               "optimizer": optimizer_state, "step": step}
    _write_durable(os.path.join(path, name), lambda f: torch.save(payload, f))
    _write_durable(os.path.join(path, POINTER), lambda f: f.write(name.encode()))
    return os.path.join(path, name)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{"model": state dict, "optimizer": ..., "step": int} of the checkpoint
    `path/last_checkpoint` names, on the CPU."""
    pointer = os.path.join(path, POINTER)
    if not os.path.isfile(pointer):
        raise FileNotFoundError(f"{pointer} not found: {path} is not a port checkpoint directory "
                                "(orbax checkpoints of the JAX package are not read)")
    with open(pointer) as f:
        name = f.read().strip()
    return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)
