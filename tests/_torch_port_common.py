"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py).

The scaled profile of tests/test_whole_model_parity.py (every production
component at narrow widths, 224x448 input), and one random d2-named state
dict, made with numpy from a seed, that drives both packages: the JAX side
through its checkpoint converter, the port through
`load_state_dict(strict=True)`. The motion decoders keep their fixed
production widths (up to 1536 channels) at this profile, so a state dict
holds about 93 M floats: build one per test module.
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
SEQ_ATOL = 1e-5  # tests/test_whole_model_parity.py:52, rtol 1e-4
# state-dict prefixes of the sequence path
SEQUENCE_PREFIXES = ("sem_seg_head.depth_decoder.", "pose_decoder.", "motion_decoder.", "motion_mask.")


# the scaled backbones besides Swin: narrow widths, few blocks. DiNAT's
# dilations give sub-grids shorter than its kernel (the duplicate-index edge)
# at 224x448 in levels 1 and 2, and at 128x256 in levels 0 and 3
DINAT_DEPTHS = (2, 2, 2, 1)
DINAT_DILATIONS = ((1, 8), (1, 5), (1, 3), (1,))
CONVNEXT_DEPTHS = (1, 1, 2, 1)
RESNET_BLOCKS = (2, 2, 2, 2)  # depth 18


def backbone_cfg(C, backbone: str = "swin"):
    """The scaled BackboneConfig of `backbone`, from either package's config module `C`."""
    if backbone == "swin":
        return C.BackboneConfig(name="swin", swin=C.SwinConfig(embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS))
    if backbone == "resnet":
        return C.BackboneConfig(name="resnet", resnet=C.ResNetConfig(depth=18, stem_out_channels=16,
                                                                     res2_out_channels=16))
    if backbone == "convnext":
        return C.BackboneConfig(name="convnext", convnext=C.ConvNeXtConfig(depths=CONVNEXT_DEPTHS,
                                                                           dims=(EMBED, 2 * EMBED, 4 * EMBED, 8 * EMBED)))
    if backbone == "dinat":
        return C.BackboneConfig(name="dinat", dinat=C.DiNATConfig(embed_dim=EMBED, depths=DINAT_DEPTHS, num_heads=HEADS,
                                                                  kernel_size=7, dilations=DINAT_DILATIONS,
                                                                  mlp_ratio=2.0))
    raise ValueError(backbone)


def make_cfg(C, backbone: str = "swin"):
    """The scaled ModelConfig, from either package's config module `C`."""
    of = C.OneFormerConfig(
        num_object_queries=NQ, dec_layers=DEC_LAYERS, class_dec_layers=2,
        dim_feedforward=DFF, hidden_dim=CONV_DIM, nheads=NHEADS,
    )
    head = C.SemSegHeadConfig(
        num_classes=K, convs_dim=CONV_DIM, mask_dim=CONV_DIM, transformer_enc_layers=ENC_LAYERS,
    )
    return dataclasses.replace(
        C.Config().model, backbone=backbone_cfg(C, backbone), sem_seg_head=head, one_former=of,
    )


def random_d2_state(model: nn.Module, seed: int = 7):
    """numpy fp32 values for every parameter and BatchNorm statistic of the
    port `model`, keyed by its d2 names: fan-in-scaled matrices and kernels,
    norm scales near 1, running variances in [1, 1.3] or so, small
    everything else (keeps activations O(1) through the stack). The
    segmentation modules are drawn first, so their values do not depend on
    the sequence modules."""
    from uni_encoder_tpu_torch.models.layers import FrozenBatchNorm

    rng = np.random.RandomState(seed)
    state = {}
    modules = sorted(model.named_modules(), key=lambda nm: (nm[0] + ".").startswith(SEQUENCE_PREFIXES))
    for mname, mod in modules:
        for pname, p in mod.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm)) and pname == "weight":
                arr = 1 + 0.1 * rng.randn(*shape)
            elif len(shape) >= 2 and pname.endswith("weight") and not isinstance(mod, nn.Embedding):
                arr = rng.randn(*shape) / math.sqrt(math.prod(shape[1:]))
            else:
                arr = 0.1 * rng.randn(*shape)
            state[key] = np.asarray(arr, np.float32)  # a 0-d parameter draws a float
        if isinstance(mod, FrozenBatchNorm):
            n = mod.running_mean.shape[0]
            state[f"{mname}.running_mean"] = (0.1 * rng.randn(n)).astype(np.float32)
            state[f"{mname}.running_var"] = (1 + 0.1 * np.abs(rng.randn(n))).astype(np.float32)
    return state


def convert_backbone(c, backbone: str = "swin"):
    """The JAX converter's rules for the scaled `backbone`, into Converter `c`."""
    from uni_encoder_tpu.engine import checkpoint as ckpt

    if backbone == "swin":
        ckpt.convert_swin(c, DEPTHS)
    elif backbone == "resnet":
        ckpt.convert_resnet(c, RESNET_BLOCKS)
    elif backbone == "convnext":
        ckpt.convert_convnext(c, CONVNEXT_DEPTHS)
    else:
        ckpt.convert_dinat(c, DINAT_DEPTHS)


def jax_variables(state, backbone: str = "swin"):
    """The JAX package's flax {"params", "batch_stats"} for the same d2 state
    dict; every key must be consumed (this also checks the port's module
    names)."""
    from uni_encoder_tpu.engine import checkpoint as ckpt

    c = ckpt.Converter(state)
    convert_backbone(c, backbone)
    ckpt.convert_msdeform_pixel_decoder(c, layers=ENC_LAYERS)
    ckpt.convert_query_decoder(c, dec_layers=DEC_LAYERS - 1)
    ckpt.convert_task_mlp(c)
    ckpt.convert_transdssl(c)
    ckpt.convert_pose_decoder(c)
    ckpt.convert_motion_decoder(c, "motion_decoder")
    ckpt.convert_motion_decoder(c, "motion_mask")
    assert not c.unused, sorted(c.unused)[:8]
    return {"params": c.params, "batch_stats": c.batch_stats}


def port_model(state=None, backbone: str = "swin"):
    """The port's scaled UniEncoder on the CPU, with `state` loaded strictly."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    model = UniEncoder(make_cfg(TC, backbone), device="cpu")
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


def model_pair(seed: int, backbone: str = "swin"):
    """The port model with a random d2 state dict loaded strictly, the JAX
    model, the JAX variables of the same state, and the state. The class
    head is scaled up so that queries clear the 0.8 keep threshold."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as JUniEncoder

    model = port_model(backbone=backbone)
    state = random_d2_state(model, seed=seed)
    state["sem_seg_head.predictor.class_embed.weight"] *= 8.0
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model, JUniEncoder(make_cfg(JC, backbone)), jax_variables(state, backbone), state


def scaled_yaml(path):
    """The scaled profile (make_cfg, Swin) as a config file for the port's
    command lines; returns its path as a string."""
    path.write_text(f"""
model:
  backbone:
    name: swin
    swin:
      embed_dim: {EMBED}
      depths: {list(DEPTHS)}
      num_heads: {list(HEADS)}
  sem_seg_head:
    num_classes: {K}
    convs_dim: {CONV_DIM}
    mask_dim: {CONV_DIM}
    transformer_enc_layers: {ENC_LAYERS}
  one_former:
    num_object_queries: {NQ}
    dec_layers: {DEC_LAYERS}
    class_dec_layers: 2
    dim_feedforward: {DFF}
    hidden_dim: {CONV_DIM}
    nheads: {NHEADS}
""")
    return str(path)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ------------------------------------------------------------- micro trainer
def micro_config(C):
    """tests/test_train_step.py's micro config (stochastic depth off), from
    either package's config module `C`."""
    swin = C.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), drop_path_rate=0.0)
    of = C.OneFormerConfig(num_object_queries=8, dec_layers=2, class_dec_layers=1, dim_feedforward=64, hidden_dim=32,
                           nheads=4, train_num_points=32, oversample_ratio=2.0)
    head = C.SemSegHeadConfig(num_classes=19, convs_dim=32, mask_dim=32, transformer_enc_layers=1)
    te = C.TextEncoderConfig(width=32, num_layers=1, vocab_size=512, context_length=16, n_ctx=2)
    model = C.ModelConfig(backbone=C.BackboneConfig(name="swin", swin=swin), sem_seg_head=head, one_former=of,
                          text_encoder=te, is_train=True)
    return C.Config(model=model, input=C.InputConfig(task_seq_len=16, max_seq_len=16))


def micro_batches():
    """tests/test_train_step.py's batches, as numpy arrays."""
    rng = np.random.RandomState(0)
    B, H, W, N = 2, 32, 32, 2
    seg = {"images": rng.randn(B, H, W, 3).astype(np.float32), "task_tokens": np.ones((B, 16), np.int64),
           "text_tokens": np.ones((B, 6, 16), np.int64), "labels": rng.randint(0, 19, (B, N)),
           "masks": rng.rand(B, N, H // 4, W // 4) > 0.5, "valid": np.ones((B, N), bool)}
    K = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    K[:, 0, 0] = K[:, 1, 1] = 25.0
    K[:, 0, 2], K[:, 1, 2] = W / 2, H / 2
    seq = {"images": (rng.randn(B, H, W, 3) * 0.1).astype(np.float32),
           "prev_images": (rng.randn(B, H, W, 3) * 0.1).astype(np.float32),
           "next_images": (rng.randn(B, H, W, 3) * 0.1).astype(np.float32),
           "K": K, "inv_K": np.linalg.inv(K).astype(np.float32)}
    return seg, seq
