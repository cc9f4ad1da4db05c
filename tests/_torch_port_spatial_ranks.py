"""Rank functions of the spatial-partitioning CPU tests
(tests/test_torch_port_spatial*.py), run through
`_torch_port_dist_common.run_ranks`. Nothing here imports jax: each rank
imports torch, numpy and the port, computes its rows with
`uni_encoder_tpu_torch/parallel/spatial.py` and, from the whole inputs it
was also given, the one-process module's result, so that the test compares
the two."""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from _torch_port_common import SEQUENCE_PREFIXES, t
from uni_encoder_tpu_torch.parallel import mesh


def forward_cfg(C):
    """tests/test_model_forward.py's scaled Swin-T profile (embed 32,
    depths (1, 1, 2, 1), 20 queries, 64 wide), from either package's config
    module `C`."""
    swin = C.SwinConfig(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8))
    of = C.OneFormerConfig(num_object_queries=20, dec_layers=4, class_dec_layers=1, dim_feedforward=128,
                           hidden_dim=64, nheads=4)
    head = C.SemSegHeadConfig(num_classes=19, convs_dim=64, mask_dim=64, transformer_enc_layers=2)
    return dataclasses.replace(C.Config().model, backbone=C.BackboneConfig(name="swin", swin=swin),
                               sem_seg_head=head, one_former=of)


def segmentation_model(state, cfg=None):
    """The port's UniEncoder at `cfg` (by default `forward_cfg`) with only
    its segmentation modules on the CPU (the sequence modules stay on the
    meta device: neither forward here reaches them), `state` (numpy, d2
    names) loaded."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    model = UniEncoder(forward_cfg(TC) if cfg is None else cfg, device="meta")
    for m in (model.backbone, model.pixel_decoder, model.predictor, model.task_mlp):
        m.to_empty(device="cpu")
    missing, unexpected = model.load_state_dict({k: t(v) for k, v in state.items()}, strict=False)
    assert not unexpected and all(k.startswith(SEQUENCE_PREFIXES) for k in missing), (unexpected, missing[:4])
    return model.eval()


def forward_rank(out_dir, state, images, tokens, cfg=None, float64=False):
    """`spatial_inference` of each image of `images` on this rank: its
    pred_logits, its rows of pred_masks with their range, and the whole
    masks through `gather_rows`; rank 0 adds the one-process
    `forward_segmentation` of each, and with `float64` the same in float64
    (`one_process_float64`: what the fp32 forwards round). `cfg`: the
    model's config (the port's), by default `forward_cfg`."""
    from uni_encoder_tpu_torch.parallel.spatial import gather_rows, spatial_inference

    model = segmentation_model(state, cfg)
    got = []
    with torch.inference_mode():
        for img in images:
            out = spatial_inference(model, t(img), t(tokens))
            out["gathered_masks"] = gather_rows(out["pred_masks"], out["rows"], out["height"])
            if mesh.rank() == 0:
                ref = model.forward_segmentation(t(img), t(tokens))
                out["one_process"] = {k: ref[k] for k in ("pred_logits", "pred_masks")}
            got.append(out)
        if float64 and mesh.rank() == 0:
            model.double()
            for img, out in zip(images, got):
                ref = model.forward_segmentation(t(img).double(), t(tokens))
                out["one_process_float64"] = {k: ref[k] for k in ("pred_logits", "pred_masks")}
    return got


def models_rank(out_dir, cases, tokens):
    """`forward_rank` of each (cfg, state, images) of `cases`, in order,
    with the float64 one-process forwards."""
    return [forward_rank(out_dir, state, images, tokens, cfg, float64=True) for cfg, state, images in cases]


# ------------------------------------------------------------------- parts
PARTS_HEIGHT = 128  # image rows: blocks of 32 over 3 ranks, (2, 1, 1)


def parts_inputs(seed=0):
    """The whole inputs of `parts_rank`, made with numpy from `seed`."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "fetch": f(2, 32, 5),
        "gn": f(2, 8, 32, 6) * 2 + 5,
        "conv": f(2, 8, 32, 6),
        "up": f(1, 8, 16, 6),
        "down": f(1, 8, 32, 12),
        "swin4": f(1, 32, 20, 16),
        "swin32": f(1, 4, 10, 16),
        "attn_q": f(2, 5, 16),
        "attn_kv": f(2, 32 * 3, 16),
        "mask_logits": f(2, 4, 32 * 3),
        "enc_src": f(1, 4 * 2 + 8 * 4 + 16 * 8, 32),
        "enc_pos": f(1, 4 * 2 + 8 * 4 + 16 * 8, 32),
        "image": f(1, PARTS_HEIGHT, 14, 3),
        "stride2": f(1, 64, 10, 5),
        "stride8": f(1, 16, 9, 8),
        "qkv": f(1, 32, 10, 3, 2, 4),
        "rpb": f(2, 13, 13),
        "seed": seed,
    }


def _module(cls, *args, seed, **kwargs):
    """`cls(*args)` with random weights from `seed` (every rank the same)."""
    from uni_encoder_tpu_torch.models.layers import random_init_

    m = cls(*args, **kwargs)
    random_init_(m, torch.Generator().manual_seed(seed))
    return m.eval()


def parts_rank(out_dir, x):
    """Each helper of parallel/spatial.py on this rank's rows of the whole
    inputs `x` (`parts_inputs`), with PARTS_HEIGHT's plan, beside the
    one-process module's result on the whole input cut to the same rows:
    {name: (partitioned, one process)}."""
    from uni_encoder_tpu_torch.models.backbones.swin import SwinBlock
    from uni_encoder_tpu_torch.models.layers import Conv2dNHWC, MultiheadAttention
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import (
        MSDeformAttnEncoderLayer,
        absolute_reference_points,
    )
    from uni_encoder_tpu_torch.ops import resize_hw
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_plain, reach_rows
    from uni_encoder_tpu_torch.ops.resize import resize_hw_rows
    from uni_encoder_tpu_torch.parallel import spatial

    plan = spatial.RowPlan(PARTS_HEIGHT)
    me = mesh.rank()
    out = {"rows4": plan.rows(4), "rows32": plan.rows(32)}

    def cut(a, stride, dim):
        lo, hi = plan.rows(stride)
        return a.narrow(dim, lo, hi - lo)

    with torch.inference_mode():
        # fetch_rows: windows over several ranks, rows past both edges, a wrap
        whole = t(x["fetch"])
        b4 = plan.bounds(4)
        wants = [(-3, 20), [31, 0, 1, 2, 33, 17], (14, 35)]
        got = mesh.fetch_rows(cut(whole, 4, 1), wants, b4, dim=1)
        idx = np.asarray(range(*wants[me]) if isinstance(wants[me], tuple) else wants[me])
        ref = torch.zeros((whole.shape[0], len(idx), whole.shape[2]))
        inside = (idx >= 0) & (idx < whole.shape[1])
        ref[:, torch.from_numpy(np.flatnonzero(inside))] = whole[:, torch.from_numpy(idx[inside])]
        out["fetch_rows"] = (got, ref)

        gn = _module(nn.GroupNorm, 4, 8, seed=1)
        out["group_norm"] = (spatial.group_norm(gn, cut(t(x["gn"]), 4, 2)), cut(gn(t(x["gn"])), 4, 2))

        conv = _module(nn.Conv2d, 8, 8, 3, padding=1, seed=2)
        out["conv3x3"] = (spatial.conv_rows(conv, cut(t(x["conv"]), 4, 2), b4), cut(conv(t(x["conv"])), 4, 2))

        up = t(x["up"])
        out["upsample_x2"] = (spatial.resize_rows(cut(up, 8, 2), (32, 12), plan.bounds(8), b4),
                              cut(resize_hw(up, (32, 12), dims=(2, 3)), 4, 2))

        down = t(x["down"])
        for stride in (8, 16, 32):  # factors 2, 4, 8 from stride 4: the rank's own rows only
            size = (PARTS_HEIGHT // stride, 12 * 4 // stride)
            out[f"downsample_stride{stride}"] = (
                resize_hw_rows(cut(down, 4, 2), size, (2, 3), plan.rows(stride), plan.rows(4), 32),
                cut(resize_hw(down, size, dims=(2, 3)), stride, 2))

        for name, stride in (("swin4", 4), ("swin32", 32)):
            for shift in (0, 3):
                blk = _module(SwinBlock, 16, 2, 7, shift, seed=3 + shift)
                xs = t(x[name])
                out[f"{name}_shift{shift}"] = (spatial.swin_block(blk, cut(xs, stride, 1), plan.bounds(stride),
                                                                  xs.shape[1]), cut(blk(xs), stride, 1))

        # row-split keys (32 rows of 3 tokens at stride 4); query 1 allowed
        # only on rank 1's rows, query 2 on rank 0's only, query 4 nowhere
        # (un-masked, as the decoder's rule does)
        mha = _module(MultiheadAttention, 16, 4, seed=7)
        q, kv = t(x["attn_q"]), t(x["attn_kv"])
        rng = np.random.RandomState(x["seed"])
        masked = rng.rand(2, 1, 5, 32, 3) < 0.5
        masked[:, :, 1] = True
        masked[:, :, 1, b4[1][0]:b4[1][1]] = False
        masked[:, :, 2] = True
        masked[:, :, 2, :b4[0][1]] = False
        masked[:, :, 4] = True
        masked = masked.reshape(2, 1, 5, 96)
        masked = masked & ~masked.all(axis=-1, keepdims=True)
        mask = torch.from_numpy(masked)
        lo, hi = plan.rows(4)
        out["masked_attention"] = (spatial.attention(mha, q, kv[:, 3 * lo:3 * hi], kv[:, 3 * lo:3 * hi],
                                                     mask[..., 3 * lo:3 * hi]), mha(q, kv, kv, attn_mask=mask))
        out["masked_attention_rank_allows"] = mask[..., 3 * lo:3 * hi].logical_not().sum(-1)

        # the query decoder's mask: query 1 masked on every key (un-masked),
        # query 2 on every key of rank 0 only
        logits = t(x["mask_logits"])
        logits[:, 1] = -logits[:, 1].abs() - 0.1
        logits[:, 2, :3 * b4[0][1]] = -logits[:, 2, :3 * b4[0][1]].abs() - 0.1
        whole = torch.sigmoid(logits) < 0.5
        out["attention_mask"] = (spatial.attention_mask(logits[..., 3 * lo:3 * hi]),
                                 (whole & ~whole.all(dim=-1, keepdim=True))[..., 3 * lo:3 * hi])

        # one deformable encoder layer: levels at strides 32, 16, 8 of a
        # 128x64 image; the rank's queries are its rows of each level
        layer = _module(MSDeformAttnEncoderLayer, 32, 64, 3, 4, 4, seed=8)
        shapes = ((4, 2), (8, 4), (16, 8))
        src, pos = t(x["enc_src"]), t(x["enc_pos"])
        index, start = [], 0
        for (h, w), stride in zip(shapes, (32, 16, 8)):
            a, b = plan.rows(stride)
            index.append(np.arange(start + a * w, start + b * w))
            start += h * w
        index = torch.from_numpy(np.concatenate(index))
        ref_abs = absolute_reference_points(shapes, torch.device("cpu"))
        out["encoder_layer"] = (
            spatial._encoder_layer(layer, src[:, index], pos[:, index], ref_abs[:, index].contiguous(), shapes,
                                   index),
            layer(src, pos, ref_abs, shapes)[:, index])
        out["encoder_queries"] = index

        gathered = spatial.gather_rows(cut(t(x["conv"]), 4, 2), plan.rows(4), 32)
        out["gather_rows"] = (gathered, t(x["conv"]))

        # the general halo convolution: ResNet's 7x7 stride-2 stem on image
        # rows (NCHW), a 3x3 stride-2 pad-1 (NHWC, stride 2 -> 4), and
        # ConvNeXt's depthwise 7x7 (3 halo rows a side, at stride 8: 8, 4, 4
        # rows a rank); the stem's 3x3 stride-2 max-pool, -inf padded
        img = t(x["image"]).permute(0, 3, 1, 2)
        stem = _module(nn.Conv2d, 3, 4, 7, stride=2, padding=3, seed=9)
        out["conv7x7_stride2"] = (spatial.conv_rows(stem, cut(img, 1, 2), plan.bounds(1), plan.bounds(2)),
                                  cut(stem(img), 2, 2))
        s2 = t(x["stride2"])
        down = _module(Conv2dNHWC, 5, 6, 3, stride=2, padding=1, seed=10)
        out["conv3x3_stride2"] = (spatial.conv_rows(down, cut(s2, 2, 1), plan.bounds(2), b4), cut(down(s2), 4, 1))
        s8 = t(x["stride8"])
        dw = _module(Conv2dNHWC, 8, 8, 7, padding=3, groups=8, seed=11)
        out["depthwise7x7"] = (spatial.conv_rows(dw, cut(s8, 8, 1), plan.bounds(8)), cut(dw(s8), 8, 1))
        pooled = F.max_pool2d(s2.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        out["max_pool3x3_stride2"] = (spatial.max_pool_rows(cut(s2, 2, 1), plan.bounds(2), b4), cut(pooled, 4, 1))

        # neighbourhood attention's plain version with a row window on the
        # rank's rows of a 32-row map (16, 8, 8 rows a rank), against the
        # whole map's rows: dilation 1, 3 (clamped windows that reach other
        # ranks' rows) and 8 (sub-grids of 4 rows, shorter than the kernel:
        # repeated keys)
        qkv, rpb = t(x["qkv"]), t(x["rpb"])
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
        lo, hi = plan.rows(4)
        for d in (1, 3, 8):
            k0, k1 = reach_rows(32, 7, d, (lo, hi))
            out[f"na_row_window_dilation{d}"] = (
                neighborhood_attention_2d_plain(q[:, lo:hi], k[:, k0:k1], v[:, k0:k1], rpb, 7, d, 0.5, (32, lo, k0)),
                neighborhood_attention_2d_plain(q, k, v, rpb, 7, d, 0.5)[:, lo:hi])
            out[f"na_reach_dilation{d}"] = (k0, k1)
    return out
