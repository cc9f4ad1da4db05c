"""One image split by rows over the ranks (the port's counterpart of
`uni_encoder_tpu/parallel/spatial.py`).

The JAX function puts the image's H axis on the mesh's data axis and lets
GSPMD partition the whole segmentation forward. PyTorch has no GSPMD, so
this module holds the partitioned forward of every layer of the default
model (Swin-T -> MSDeformAttnPixelDecoder -> OneFormerQueryDecoder), each
calling the one-process modules' own sub-layers and weights:

  * rows go to the ranks in blocks of ROW_BLOCK image rows (one row at
    stride 32), as evenly as the blocks allow (`RowPlan`); at stride s rank
    r holds rows [32 b_r / s, 32 b_{r+1} / s), so the patch embedding, the
    patch merging, every per-token layer, every 1x1 convolution and the
    mask features' downsample to each level are local;
  * a Swin block computes every window (shifted or not) that holds one of
    its rows, with the rows of those windows fetched from whichever ranks
    hold them (`mesh.fetch_rows`): the bottom padding comes back as zero
    rows and the shifted blocks' top rows, which the cyclic shift wraps
    into the bottom window, come from the first rank, so every window,
    its bias and its region mask are the one-process model's;
  * GroupNorm takes its statistics over the whole image (two sum
    all-reduces of (B, groups) in fp32: the mean, then the centred squares);
  * the FPN tail's x2 bilinear upsample and its 3x3 convolution fetch one
    row from each neighbour, and clamp or zero-pad at the image's edges only;
  * the deformable encoder: each rank's queries are its rows of each level
    (not contiguous in the level-major token order); their values are
    all-gathered, since the sampling reaches anywhere in the image, and K2
    samples for the rank's queries only;
  * attention whose keys are row-split (the class transformer over the
    stride-4 map, the masked cross-attention rounds) takes the global max of
    the logits, local exp sums and weighted values, and one sum all-reduce:
    the max-subtracted softmax of the one-process module, in another order.
    A query with no allowed key on one rank's rows adds nothing there; the
    un-masking of a fully masked query row counts allowed keys over all
    ranks;
  * the queries, their self-attention, FFNs and heads run on every rank on
    replicated values.

The result is the one-process forward's up to the order of sums. The value
all-gather of each encoder layer is the one activation held whole
(S x conv_dim: 43 008 x 256 at 1024x2048). The partitioned path is for
serving: it runs without autograd.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import mesh
from ..models.backbones.swin import SwinTransformer, _shift_attn_mask, window_partition, window_reverse
from ..models.layers import relu
from ..models.oneformer import FEATURE_STRIDES
from ..models.pixel_decoders.msdeformattn import MSDeformAttnPixelDecoder, absolute_reference_points
from ..models.transformer_decoder import OneFormerQueryDecoder
from ..ops import ms_deform_attn_fused, position_embedding_sine
from ..ops.resize import resize_hw_rows, source_rows

# image rows a rank holds at a time: one row at the backbone's last stride
ROW_BLOCK = 32
# keys a rank exponentiates at a time in the row-split attention
KEY_CHUNK = 16384


class RowPlan:
    """The rows of an image of `height` rows that each rank of the process
    group holds: blocks of ROW_BLOCK image rows, the first
    `n_blocks % world` ranks one block more. Raises unless `height` is a
    multiple of ROW_BLOCK (as the model's size_divisibility asks) and every
    rank holds a block."""

    def __init__(self, height: int):
        world = mesh.world()
        self.rank = mesh.rank()
        if height % ROW_BLOCK:
            raise ValueError(f"spatial partitioning needs the image height to be a multiple of {ROW_BLOCK}, "
                             f"got {height}")
        n_blocks = height // ROW_BLOCK
        if n_blocks < world:
            raise ValueError(f"an image of {height} rows holds {n_blocks} blocks of {ROW_BLOCK} rows, fewer than "
                             f"the {world} ranks: a rank would hold no row (give at least {ROW_BLOCK * world} rows, "
                             f"or fewer ranks)")
        q, rem = divmod(n_blocks, world)
        self.height = height
        self.world = world
        self.blocks = [r * q + min(r, rem) for r in range(world + 1)]

    def bounds(self, stride: int) -> List[Tuple[int, int]]:
        """Every rank's rows (start, end) of the map at `stride` (a divisor of ROW_BLOCK)."""
        if ROW_BLOCK % stride:
            raise ValueError(f"stride {stride} does not divide the row block of {ROW_BLOCK}")
        k = ROW_BLOCK // stride
        return [(k * self.blocks[r], k * self.blocks[r + 1]) for r in range(self.world)]

    def rows(self, stride: int) -> Tuple[int, int]:
        """This rank's rows of the map at `stride`."""
        return self.bounds(stride)[self.rank]


def gather_rows(x: torch.Tensor, rows: Tuple[int, int], height: int) -> torch.Tensor:
    """The whole (B, C, height, W) map on every rank from each rank's rows
    `rows` of it (a collective): a zero map, this rank's rows in place,
    summed over the ranks."""
    if rows == (0, height):
        return x
    whole = x.new_zeros((x.shape[0], x.shape[1], height, x.shape[3]))
    whole[:, :, rows[0]:rows[1]] = x
    return mesh.all_reduce_sum(whole)


# ----------------------------------------------------------------- layers
def group_norm(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """`gn` on (B, C, h, W), the rank's rows of the map, with the whole
    map's statistics: per (batch, group) the fp32 sums over the ranks, the
    mean first, then the centred squares (as the one-process kernel, not
    E[x^2] - mean^2)."""
    B, C = x.shape[:2]
    G = gn.num_groups
    xf = x.float().reshape(B, G, -1)
    sums = mesh.all_reduce_sum(torch.cat([xf.sum(dim=-1).reshape(-1), xf.new_full((1,), xf.shape[-1])]))
    n = sums[-1]
    d = xf - (sums[:-1] / n).view(B, G, 1)
    var = mesh.all_reduce_sum(d.square().sum(dim=-1)) / n
    y = (d * torch.rsqrt(var + gn.eps)[..., None]).view(x.shape)
    return (y * gn.weight.float().view(1, C, 1, 1) + gn.bias.float().view(1, C, 1, 1)).to(x.dtype)


def conv_rows(conv: nn.Conv2d, x: torch.Tensor, bounds: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """A stride-1 convolution with `padding` = kernel // 2 on (B, C, h, W),
    the rank's rows `bounds[rank]` of the map: `padding` halo rows from each
    neighbour, zero rows past the map's edges (its zero padding there)."""
    ph, pw = conv.padding
    if conv.stride != (1, 1) or conv.kernel_size[0] != 2 * ph + 1 or conv.dilation != (1, 1):
        raise ValueError(f"conv_rows takes stride-1 'same' convolutions, got {conv}")
    x = mesh.fetch_rows(x, [(s - ph, e + ph) for s, e in bounds], bounds, dim=2)
    return F.conv2d(x, conv.weight, conv.bias, 1, (0, pw), 1, conv.groups)


def upsample_rows(x: torch.Tensor, size: Tuple[int, int], in_bounds: Sequence[Tuple[int, int]],
                  out_bounds: Sequence[Tuple[int, int]], in_height: int) -> torch.Tensor:
    """The rank's rows `out_bounds[rank]` of the bilinear resize
    (align_corners=False) of the whole (B, C, in_height, w) map to `size`,
    from its rows `in_bounds[rank]` and the rows around them that the resize
    reads (one from each neighbour at x2), fetched."""
    wants = [source_rows(r, in_height, size[0]) for r in out_bounds]
    x = mesh.fetch_rows(x, wants, in_bounds, dim=2)
    me = mesh.rank()
    return resize_hw_rows(x, size, (2, 3), out_bounds[me], wants[me], in_height)


def attention(mha: nn.Module, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
              attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`models.layers.MultiheadAttention` `mha` with its queries on every
    rank and its keys and values (and the mask's key axis) this rank's:
    the logits' max over every rank's keys, then per rank the exp sums and
    the exp-weighted values (fp32; the keys KEY_CHUNK at a time), summed over
    the ranks in one all-reduce and divided. A query whose keys are all
    masked on this rank adds zeros here; one with no allowed key anywhere
    gives NaN, as the one-process module does."""
    E, H = mha.embed_dim, mha.num_heads
    Dh = E // H
    B, Lq, _ = query.shape
    Lk = key.shape[1]
    w, b = mha.in_proj_weight, mha.in_proj_bias
    q = F.linear(query, w[:E], b[:E]).view(B, Lq, H, Dh).transpose(1, 2)
    k = F.linear(key, w[E:2 * E], b[E:2 * E]).view(B, Lk, H, Dh).transpose(1, 2)
    v = F.linear(value, w[2 * E:], b[2 * E:]).view(B, Lk, H, Dh).transpose(1, 2)

    logits = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(Dh)
    if attn_mask is not None:  # bool, True = not allowed
        logits = logits.masked_fill(attn_mask, float("-inf"))
    top = mesh.all_reduce_max(logits.amax(dim=-1, keepdim=True).float())
    num = torch.zeros((B, H, Lq, Dh), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    for c in range(0, Lk, KEY_CHUNK):
        p = torch.exp(logits[..., c:c + KEY_CHUNK].float() - top)
        den += p.sum(dim=-1, keepdim=True)
        num += torch.matmul(p, v[:, :, c:c + KEY_CHUNK].float())
    sums = mesh.all_reduce_sum(torch.cat([num, den], dim=-1))
    out = (sums[..., :Dh] / sums[..., Dh:]).to(v.dtype).transpose(1, 2).reshape(B, Lq, E)
    return mha.out_proj(out)


def attention_mask(mask_logits: torch.Tensor) -> torch.Tensor:
    """The query decoder's attention mask (True = not allowed) from mask
    logits whose last axis is this rank's keys: sigmoid < 0.5, a query row
    that no rank allows un-masked (its allowed keys counted over the ranks)."""
    masked = torch.sigmoid(mask_logits) < 0.5
    allowed = mesh.all_reduce_sum((~masked).sum(dim=-1, keepdim=True))
    return masked & (allowed > 0)


def _window_rows(lo: int, hi: int, padded: int, window: int, shift: int) -> Tuple[np.ndarray, np.ndarray]:
    """The windows of a block shifted by `shift` (rows cyclic over `padded`)
    that hold one of rows [lo, hi): their indices in the shifted frame, and
    the global row at each of their rows, window after window."""
    ks = np.unique(((np.arange(lo, hi) - shift) % padded) // window)
    return ks, ((ks[:, None] * window + np.arange(window)[None, :] + shift) % padded).reshape(-1)


@functools.lru_cache(maxsize=64)
def _window_masks(padded_h: int, padded_w: int, window: int, shift: int, ks: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    """The shifted block's region masks of the window rows `ks`, every
    window of each (the one-process mask's windows), kept on the device."""
    full = _shift_attn_mask(padded_h, padded_w, window, shift)
    n = window * window
    sel = full.reshape(padded_h // window, padded_w // window, n, n)[list(ks)].reshape(-1, n, n)
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(sel)).to(device)


def swin_block(blk: nn.Module, x: torch.Tensor, bounds: Sequence[Tuple[int, int]], height: int) -> torch.Tensor:
    """`SwinBlock.forward` on (B, h, W, C), the rank's rows `bounds[rank]` of
    a map of `height` rows: every window that holds one of its rows, on
    rows fetched from the ranks that hold them; its own rows kept."""
    B, h, W, C = x.shape
    ws, shift = blk.window, blk.shift
    padded_h = -(-height // ws) * ws
    pad_r = (ws - W % ws) % ws
    padded_w = W + pad_r
    me = mesh.rank()
    lo, hi = bounds[me]
    plans = [_window_rows(s, e, padded_h, ws, shift) for s, e in bounds]
    ks, rows = plans[me]

    shortcut = x
    # rows past the map's last come back as zeros: the bottom padding
    x = mesh.fetch_rows(blk.norm1(x), [r for _, r in plans], bounds, dim=1)
    if pad_r:
        x = F.pad(x, (0, 0, 0, pad_r))
    mask = None
    if shift > 0:
        x = torch.roll(x, shifts=-shift, dims=2)
        mask = _window_masks(padded_h, padded_w, ws, shift, tuple(int(k) for k in ks), x.device)
    x = window_reverse(blk.attn(window_partition(x, ws), mask), ws, len(rows), padded_w)
    if shift > 0:
        x = torch.roll(x, shifts=shift, dims=2)
    own = np.flatnonzero((rows >= lo) & (rows < hi))
    own = own[np.argsort(rows[own])]
    x = shortcut + x[:, :, :W].index_select(1, torch.as_tensor(own, device=x.device))
    return x + blk.mlp(blk.norm2(x))


# ------------------------------------------------------------------ model
def backbone_features(backbone: SwinTransformer, images: torch.Tensor, plan: RowPlan) -> Dict[str, torch.Tensor]:
    """`SwinTransformer.forward` (no stochastic depth) on the rank's image
    rows: its rows of {res2 .. res5}, channels-last."""
    x = backbone.patch_embed(images)
    outs = {}
    for i, stage in enumerate(backbone.layers):
        stride = FEATURE_STRIDES[f"res{i + 2}"]
        for blk in stage.blocks:
            x = swin_block(blk, x, plan.bounds(stride), plan.height // stride)
        outs[f"res{i + 2}"] = getattr(backbone, f"norm{i}")(x)
        if stage.downsample is not None:
            x = stage.downsample(x)
    return outs


@functools.lru_cache(maxsize=32)
def _local_reference_points(shapes: Tuple[Tuple[int, int], ...], index: Tuple[Tuple[int, int], ...],
                            device: torch.device) -> torch.Tensor:
    """`absolute_reference_points` of the tokens in the level-major ranges
    `index`, (L, n, 2), kept on the device."""
    with torch.inference_mode(False):
        idx = torch.from_numpy(np.concatenate([np.arange(a, b) for a, b in index])).to(device)
        return absolute_reference_points(shapes, device).index_select(1, idx)


def _encoder_layer(layer: nn.Module, src: torch.Tensor, pos: torch.Tensor, ref_abs: torch.Tensor,
                   shapes: Tuple[Tuple[int, int], ...], index: torch.Tensor) -> torch.Tensor:
    """`MSDeformAttnEncoderLayer.forward` on the rank's tokens `src` at the
    level-major positions `index`: their values all-gathered into the whole
    (B, S, C) value, K2 on the rank's queries."""
    attn = layer.self_attn
    B, n, C = src.shape
    S = sum(h * w for h, w in shapes)
    value = src.new_zeros((B, S, C))
    value.index_copy_(1, index, attn.value_proj(src))
    value = mesh.all_reduce_sum(value).view(B, S, attn.n_heads, C // attn.n_heads)
    query = src + pos
    out = ms_deform_attn_fused(value, shapes, attn.sampling_offsets(query), attn.attention_weights(query), ref_abs)
    src = layer.norm1(src + attn.output_proj(out))
    return layer.norm2(src + layer.linear2(relu(layer.linear1(src))))


def pixel_decoder(pd: MSDeformAttnPixelDecoder, features: Dict[str, torch.Tensor], plan: RowPlan):
    """`MSDeformAttnPixelDecoder.forward` on the rank's rows of the
    features: its rows of (mask_features, the lowest-res map, the
    `num_multi_scale` lowest-res maps), channels-first, and the maps'
    strides, low-res first."""
    C = pd.conv_dim
    me = mesh.rank()
    srcs, poss, shapes, strides, index = [], [], [], [], []
    start = 0
    for i, f in enumerate(reversed(pd.transformer_in_features)):
        stride = FEATURE_STRIDES[f]
        proj = pd.input_proj[i]
        x = group_norm(proj[1], proj[0](features[f].permute(0, 3, 1, 2)))
        h, w = plan.height // stride, x.shape[3]
        a, b = plan.rows(stride)
        shapes.append((h, w))
        strides.append(stride)
        index.append((start + a * w, start + b * w))
        start += h * w
        srcs.append(x.flatten(2).transpose(1, 2))
        poss.append(position_embedding_sine(h, w, C // 2, device=x.device, rows=(a, b)))
    src = torch.cat(srcs, dim=1)
    level_embed = pd.transformer.level_embed
    pos = torch.cat(
        [(p.reshape(1, -1, C) + level_embed[i][None, None]).to(src.dtype) for i, p in enumerate(poss)], dim=1,
    ).expand(src.shape[0], -1, -1)
    shapes, index = tuple(shapes), tuple(index)
    ref_abs = _local_reference_points(shapes, index, src.device)
    token_index = torch.from_numpy(np.concatenate([np.arange(a, b) for a, b in index])).to(src.device)
    y = src
    for layer in pd.transformer.encoder.layers:
        y = _encoder_layer(layer, y, pos, ref_abs, shapes, token_index)

    B = y.shape[0]
    out = []
    offset = 0
    for stride, (_, w) in zip(strides, shapes):
        a, b = plan.rows(stride)
        out.append(y[:, offset:offset + (b - a) * w].transpose(1, 2).reshape(B, C, b - a, w))
        offset += (b - a) * w

    for idx, f in enumerate(reversed(pd.fpn_in_features)):
        stride = FEATURE_STRIDES[f]
        adapter, conv = getattr(pd, f"adapter_{idx + 1}"), getattr(pd, f"layer_{idx + 1}")
        lat = group_norm(adapter.norm, nn.Conv2d.forward(adapter, features[f].permute(0, 3, 1, 2)))
        up = upsample_rows(out[-1], (plan.height // stride, lat.shape[3]), plan.bounds(strides[-1]),
                           plan.bounds(stride), plan.height // strides[-1])
        out.append(relu(group_norm(conv.norm, conv_rows(conv, lat + up, plan.bounds(stride)))))
        strides.append(stride)
    return pd.mask_features(out[-1]), out[0], out[: pd.num_multi_scale], strides[: pd.num_multi_scale]


def predictor(pr: OneFormerQueryDecoder, multi_scale: Sequence[torch.Tensor], mask_features: torch.Tensor,
              task_embedding: torch.Tensor, strides: Sequence[int], plan: RowPlan) -> Dict[str, torch.Tensor]:
    """`OneFormerQueryDecoder.forward` (serving) on the rank's rows of the
    multi-scale maps (at `strides`) and of the stride-4 mask features: the
    queries on every rank, pred_logits (B, Q, K+1) the same on every rank,
    pred_masks (B, Q, h_r, W/4) the rank's rows."""
    if pr.is_train:
        raise ValueError("the partitioned query decoder serves: build the model without is_train")
    C, Q, L = pr.hidden_dim, pr.num_queries, pr.num_feature_levels
    B, _, _, mw = mask_features.shape
    if len(multi_scale) != L:
        raise ValueError(f"expected {L} feature levels, got {len(multi_scale)}")
    dev = mask_features.device
    rows4 = plan.rows(4)

    srcs, poss, level_rows = [], [], []
    for i in range(L):
        x = multi_scale[i]
        h, w = plan.height // strides[i], x.shape[3]
        a, b = plan.rows(strides[i])
        level_rows.append(((a, b), (h, w)))
        poss.append(position_embedding_sine(h, w, C // 2, device=dev, rows=(a, b)).reshape(1, (b - a) * w, C)
                    .to(x.dtype))
        srcs.append(x.flatten(2).transpose(1, 2) + pr.level_embed.weight[i][None, None])

    tasks = task_embedding[:, None, :]
    if pr.use_task_norm:
        tasks = pr.decoder_norm(tasks)
    pe_mask = position_embedding_sine(plan.height // 4, mw, C // 2, device=dev, rows=rows4).reshape(1, -1, C)
    pe_mask = pe_mask.expand(B, -1, -1).to(mask_features.dtype)
    proj_mask = pr.class_input_proj(mask_features).flatten(2).transpose(1, 2)

    query_embed = pr.query_embed.weight
    tgt = tasks.expand(B, Q - 1, C)
    cls_query_pos = query_embed[None, : Q - 1].expand(B, -1, -1)
    for layer in pr.class_transformer.decoder.layers:
        # DETRDecoderLayer.forward(tgt, memory=pe_mask, pos=proj_mask, query_pos)
        q = tgt + cls_query_pos
        tgt = layer.norm1(tgt + layer.self_attn(q, q, tgt))
        tgt = layer.norm2(tgt + attention(layer.multihead_attn, tgt + cls_query_pos, pe_mask + proj_mask, pe_mask))
        tgt = layer.norm3(tgt + layer.linear2(relu(layer.linear1(tgt))))
    out_t = pr.class_transformer.decoder.norm(tgt)

    output = torch.cat([out_t, tasks], dim=1)
    query_pos = query_embed[None].expand(B, -1, -1)

    # each level's rows read only the rank's own stride-4 rows
    mask_feats_at_level = [
        resize_hw_rows(mask_features, size, (2, 3), rows, rows4, plan.height // 4).flatten(2)
        for rows, size in level_rows
    ]
    mask_feats_full = mask_features.flatten(2)

    def attn_mask_for(output, level):
        emb = pr.mask_embed(pr.decoder_norm(output))
        return attention_mask(torch.matmul(emb, mask_feats_at_level[level]))[:, None], emb

    attn_mask, emb = attn_mask_for(output, 0)
    for i in range(len(pr.transformer_cross_attention_layers)):
        lvl = i % L
        cross = pr.transformer_cross_attention_layers[i]
        output = cross.norm(output + attention(cross.multihead_attn, output + query_pos, srcs[lvl] + poss[lvl],
                                               srcs[lvl], attn_mask))
        output = pr.transformer_self_attention_layers[i](output, query_pos)
        output = pr.transformer_ffn_layers[i](output)
        attn_mask, emb = attn_mask_for(output, (i + 1) % L)

    logits = pr.class_embed(pr.decoder_norm(output))
    masks = torch.matmul(emb, mask_feats_full).view(B, Q, rows4[1] - rows4[0], mw)
    return {"pred_logits": logits, "pred_masks": masks}


def spatial_inference(model: nn.Module, images: torch.Tensor, task_tokens: torch.Tensor) -> Dict:
    """`model.forward_segmentation(images, task_tokens)` with the image's
    rows split over the ranks of the process group (one rank without one).
    Every rank passes the same model, the whole (B, H, W, 3) image and the
    (B, 77) task tokens; each computes on its own rows (`RowPlan(H)`) and
    exchanges only what crosses rows.

    Returns pred_logits (B, Q, K+1), the same on every rank; pred_masks
    (B, Q, h_r, W/4), this rank's rows of the stride-4 masks; `rows`, their
    global range (a, b), and `height`, the masks' H/4 (`gather_rows(
    out["pred_masks"], out["rows"], out["height"])` assembles the whole map).
    Supports the Swin backbone with the MSDeformAttn pixel decoder (the
    default config); raises for others and for a training model."""
    plan = RowPlan(images.shape[1])
    if not isinstance(model.backbone, SwinTransformer) or not isinstance(model.pixel_decoder,
                                                                          MSDeformAttnPixelDecoder):
        raise NotImplementedError(
            f"spatial partitioning is ported for the Swin backbone with MSDeformAttnPixelDecoder, not "
            f"{type(model.backbone).__name__} with {type(model.pixel_decoder).__name__}")
    a, b = plan.rows(1)
    with torch.no_grad():
        task = model.task_mlp(task_tokens.to(torch.float32)).to(images.dtype)
        features = backbone_features(model.backbone, images[:, a:b], plan)
        mask_features, _, multi_scale, strides = pixel_decoder(model.pixel_decoder, features, plan)
        out = predictor(model.predictor, multi_scale, mask_features, task, strides, plan)
    out["rows"] = plan.rows(4)
    out["height"] = plan.height // 4
    return out
