"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py).

The scaled profile of tests/test_whole_model_parity.py (every production
component at narrow widths, 224x448 input), and one random d2-named state
dict, made with numpy from a seed, that drives both packages: the JAX side
through its checkpoint converter, the port through
`load_state_dict(strict=True)`.
"""

import dataclasses
import math

import numpy as np
import torch
from torch import nn

EMBED = 32
DEPTHS = (2, 2, 2, 2)
HEADS = (1, 2, 4, 8)
CONV_DIM = 32
NQ = 8
K = 7
ENC_LAYERS = 2
DEC_LAYERS = 4  # the predictor runs DEC_LAYERS - 1 = 3 rounds
DFF = 64
NHEADS = 4
H_IN, W_IN = 224, 448
SEG_ATOL = 5e-3  # tests/test_whole_model_parity.py:52, rtol 1e-3


def make_cfg(C):
    """The scaled ModelConfig, from either package's config module `C`."""
    swin = C.SwinConfig(embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS)
    of = C.OneFormerConfig(
        num_object_queries=NQ, dec_layers=DEC_LAYERS, class_dec_layers=2,
        dim_feedforward=DFF, hidden_dim=CONV_DIM, nheads=NHEADS,
    )
    head = C.SemSegHeadConfig(
        num_classes=K, convs_dim=CONV_DIM, mask_dim=CONV_DIM, transformer_enc_layers=ENC_LAYERS,
    )
    return dataclasses.replace(
        C.Config().model, backbone=C.BackboneConfig(name="swin", swin=swin), sem_seg_head=head, one_former=of,
    )


def random_d2_state(model: nn.Module, seed: int = 7):
    """numpy fp32 values for every parameter of the port `model`, keyed by
    its d2 names: fan-in-scaled matrices and kernels, norm scales near 1,
    small everything else (keeps activations O(1) through the stack)."""
    rng = np.random.RandomState(seed)
    state = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) and pname == "weight":
                arr = 1 + 0.1 * rng.randn(*shape)
            elif len(shape) >= 2 and pname.endswith("weight") and not isinstance(mod, nn.Embedding):
                arr = rng.randn(*shape) / math.sqrt(math.prod(shape[1:]))
            else:
                arr = 0.1 * rng.randn(*shape)
            state[key] = arr.astype(np.float32)
    return state


def jax_params(state):
    """The JAX package's flax params for the same d2 state dict; every key
    must be consumed (this also checks the port's module names)."""
    from uni_encoder_tpu.engine import checkpoint as ckpt

    c = ckpt.Converter(state)
    ckpt.convert_swin(c, DEPTHS)
    ckpt.convert_msdeform_pixel_decoder(c, layers=ENC_LAYERS)
    ckpt.convert_query_decoder(c, dec_layers=DEC_LAYERS - 1)
    ckpt.convert_task_mlp(c)
    assert not c.unused, sorted(c.unused)[:8]
    return c.params


def port_model(state=None):
    """The port's scaled UniEncoder on the CPU, with `state` loaded strictly."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    model = UniEncoder(make_cfg(TC), device="cpu")
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))
