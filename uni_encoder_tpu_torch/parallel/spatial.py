"""One image split by rows over the ranks (the port's counterpart of
`uni_encoder_tpu/parallel/spatial.py`).

The JAX function puts the image's H axis on the mesh's data axis and lets
GSPMD partition the whole segmentation forward of whatever model it is
given. PyTorch has no GSPMD, so this module holds the partitioned forward of
every layer of every segmentation model `models/oneformer.py` builds (the
Swin-T, ResNet, ConvNeXt and DiNAT backbones; the MSDeformAttn, Base and
TransformerEncoder pixel decoders; the OneFormer query decoder), each
calling the one-process modules' own sub-layers and weights:

  * rows go to the ranks in blocks of ROW_BLOCK image rows (one row at
    stride 32), as evenly as the blocks allow (`RowPlan`): ranks past the
    blocks hold none, and the last block may be short. At stride s rank r
    holds rows [32 b_r / s, 32 b_{r+1} / s) of the map, cut at its height,
    so every per-token layer, every 1x1 convolution, the patch embeddings,
    Swin's patch merging and ConvNeXt's downsamples are local;
  * every other convolution (any kernel height, stride and zero padding:
    the stems, the stride-2 3x3s, ConvNeXt's depthwise 7x7, the FPNs' 3x3s)
    fetches the halo rows its kernel reads from the ranks that hold them
    (`conv_rows`, over `mesh.fetch_rows`), zero rows past the map's edges;
    ResNet's stem max-pool pads with -inf there (`max_pool_rows`); resizes
    fetch the rows they read (`resize_rows`);
  * a Swin block computes every window (shifted or not) that holds one of
    its rows, with the rows of those windows fetched: the bottom padding
    comes back as zero rows and the shifted blocks' top rows, which the
    cyclic shift wraps into the bottom window, come from the first rank, so
    every window, its bias and its region mask are the one-process model's;
  * a DiNAT layer fetches the rows its queries' neighbourhoods reach (their
    windows' union, up to (kernel - 1) * dilation rows past the block) and
    runs K4 with a row window: the windows clamp at the whole map's edges;
  * GroupNorm takes its statistics over the whole image (two sum
    all-reduces of (B, groups) in fp32: the mean, then the centred squares);
  * the deformable encoder: each rank's queries are its rows of each level
    (not contiguous in the level-major token order); their values are
    all-gathered, since the sampling reaches anywhere in the image, and K2
    samples for the rank's queries only;
  * TransformerEncoderPixelDecoder's encoder attends globally over res5
    (32 x 64 tokens at 1024x2048): res5 is gathered whole and the encoder
    runs on every rank, which keeps its rows;
  * attention whose keys are row-split (the class transformer over the
    stride-4 map, the masked cross-attention rounds) takes the global max of
    the logits, local exp sums and weighted values, and one sum all-reduce:
    the max-subtracted softmax of the one-process module, in another order.
    A query with no allowed key on one rank's rows adds nothing there; the
    un-masking of a fully masked query row counts allowed keys over all
    ranks;
  * the queries, their self-attention, FFNs and heads run on every rank on
    replicated values.

A rank that holds no row takes part in every collective and launches no
kernel. The result is the one-process forward's up to the order of sums.
The value all-gather of each encoder layer is the one activation held whole
(S x conv_dim: 43 008 x 256 at 1024x2048). The partitioned path is for
serving: it runs without autograd.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import mesh
from ..models.backbones.convnext import ConvNeXt
from ..models.backbones.dinat import DiNAT
from ..models.backbones.resnet import ResNet
from ..models.backbones.swin import SwinTransformer, _shift_attn_mask, window_partition, window_reverse
from ..models.layers import Conv2dNHWC, gelu, relu
from ..models.oneformer import FEATURE_STRIDES
from ..models.pixel_decoders.fpn import BasePixelDecoder, TransformerEncoderPixelDecoder
from ..models.pixel_decoders.msdeformattn import MSDeformAttnPixelDecoder, absolute_reference_points
from ..models.transformer_decoder import OneFormerQueryDecoder
from ..ops import ms_deform_attn_fused, position_embedding_sine
from ..ops.neighborhood_attention import neighborhood_attention_2d, reach_rows
from ..ops.resize import resize_hw_rows, source_rows

# image rows a rank holds at a time: one row at the backbone's last stride
ROW_BLOCK = 32
# keys a rank exponentiates at a time in the row-split attention
KEY_CHUNK = 16384
# the stride of each backbone feature a pixel decoder reads
STRIDES = {"stem": 4, **FEATURE_STRIDES}

Bounds = Sequence[Tuple[int, int]]


def conv_out(size: int, kernel: int, stride: int, padding: int) -> int:
    """The output length of a convolution or pooling along one axis."""
    return (size + 2 * padding - kernel) // stride + 1


class RowPlan:
    """The rows of an image of `height` rows that each rank of the process
    group holds: blocks of ROW_BLOCK image rows (the last one short where
    `height` is not a multiple of ROW_BLOCK), the first `n_blocks % world`
    ranks one block more; with fewer blocks than ranks the last ranks hold
    none. At stride s rank r holds rows [k b_r, k b_{r+1}) of the map, k =
    ROW_BLOCK / s, cut at the map's height: ceil(height / s) unless a layer
    set it (`set_size`: a valid convolution rounds down)."""

    def __init__(self, height: int):
        if height < 1:
            raise ValueError(f"an image needs rows, got height {height}")
        world = mesh.world()
        self.rank = mesh.rank()
        q, rem = divmod(-(-height // ROW_BLOCK), world)
        self.height = height
        self.world = world
        self.blocks = [r * q + min(r, rem) for r in range(world + 1)]
        self.sizes = {1: height}

    def size(self, stride: int) -> int:
        """The whole map's rows at `stride`."""
        return self.sizes.get(stride, -(-self.height // stride))

    def set_size(self, stride: int, rows: int) -> int:
        """Record the whole map's rows at `stride` (what a layer's arithmetic
        gives); returns them."""
        self.sizes[stride] = rows
        return rows

    def bounds(self, stride: int) -> List[Tuple[int, int]]:
        """Every rank's rows (start, end) of the map at `stride` (a divisor of
        ROW_BLOCK); (n, n) for a rank without rows."""
        if ROW_BLOCK % stride:
            raise ValueError(f"stride {stride} does not divide the row block of {ROW_BLOCK}")
        k, n = ROW_BLOCK // stride, self.size(stride)
        return [(min(k * self.blocks[r], n), min(k * self.blocks[r + 1], n)) for r in range(self.world)]

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


def _reads(out_bounds: Bounds, kernel: int, stride: int, padding: int) -> List[Tuple[int, int]]:
    """The input rows [lo, hi) that each rank's output rows of a convolution
    or pooling read ((0, 0) for none; past the map's edges: its padding)."""
    return [(a * stride - padding, (b - 1) * stride - padding + kernel) if b > a else (0, 0) for a, b in out_bounds]


def conv_rows(conv: nn.Conv2d, x: torch.Tensor, in_bounds: Bounds,
              out_bounds: Optional[Bounds] = None) -> torch.Tensor:
    """`conv` (any kernel, stride and zero padding, no dilation; an
    `nn.Conv2d` on (B, C, h, W) or a `Conv2dNHWC` on (B, h, W, C)) on the
    rank's rows `in_bounds[rank]` of its input map: the rank's rows
    `out_bounds[rank]` of the output map (by default `in_bounds`: a stride-1
    'same' convolution). The input rows those output rows read come from the
    ranks that hold them (`mesh.fetch_rows`: the halo that the kernel height,
    stride and padding give; none for a 1x1 or a valid convolution on
    aligned rows), zero rows past the map's edges (its padding there)."""
    (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    if conv.dilation != (1, 1) or conv.padding_mode != "zeros":
        raise ValueError(f"conv_rows takes undilated zero-padded convolutions, got {conv}")
    out_bounds = in_bounds if out_bounds is None else out_bounds
    if conv_out(in_bounds[-1][1], kh, sh, ph) != out_bounds[-1][1]:
        raise ValueError(f"{conv} makes {conv_out(in_bounds[-1][1], kh, sh, ph)} rows of {in_bounds[-1][1]}, "
                         f"the plan says {out_bounds[-1][1]}")
    nhwc = isinstance(conv, Conv2dNHWC)
    dim, me = (1 if nhwc else 2), mesh.rank()
    reads = _reads(out_bounds, kh, sh, ph)
    if all(s <= lo and hi <= e for (lo, hi), (s, e) in zip(reads, in_bounds) if hi > lo):
        # no rank reads a row it does not hold: no exchange
        lo, hi = reads[me]
        x = x.narrow(dim, lo - in_bounds[me][0], hi - lo) if hi > lo else x.narrow(dim, 0, 0)
    else:
        x = mesh.fetch_rows(x, reads, in_bounds, dim=dim)
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    a, b = out_bounds[me]
    if a == b:
        y = x.new_zeros((x.shape[0], conv.out_channels, 0, conv_out(x.shape[3], kw, sw, pw)))
    else:
        y = F.conv2d(x, conv.weight, conv.bias, (sh, sw), (0, pw), 1, conv.groups)
    return y.permute(0, 2, 3, 1) if nhwc else y


def max_pool_rows(x: torch.Tensor, in_bounds: Bounds, out_bounds: Bounds, kernel: int = 3, stride: int = 2,
                  padding: int = 1) -> torch.Tensor:
    """`F.max_pool2d(kernel, stride, padding)` (ResNet's stem pool) on
    (B, h, W, C), the rank's rows `in_bounds[rank]` of the map: its rows
    `out_bounds[rank]` of the pooled map, from the rows they read, fetched;
    -inf padding at the map's edges only, as the one-process pool's."""
    n = in_bounds[-1][1]
    if conv_out(n, kernel, stride, padding) != out_bounds[-1][1]:
        raise ValueError(f"the pool makes {conv_out(n, kernel, stride, padding)} rows of {n}, the plan says "
                         f"{out_bounds[-1][1]}")
    wants = _reads(out_bounds, kernel, stride, padding)
    x = mesh.fetch_rows(x, wants, in_bounds, dim=1)
    lo, hi = wants[mesh.rank()]
    if lo == hi:
        return x.new_zeros((x.shape[0], 0, conv_out(x.shape[2], kernel, stride, padding), x.shape[3]))
    rows = np.arange(lo, hi)
    edge = np.flatnonzero((rows < 0) | (rows >= n))
    if len(edge):  # fetch_rows gives zeros there
        x.index_fill_(1, torch.from_numpy(edge).to(x.device), float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, (0, padding)).permute(0, 2, 3, 1)


def resize_rows(x: torch.Tensor, size: Tuple[int, int], in_bounds: Bounds, out_bounds: Bounds,
                mode: str = "bilinear") -> torch.Tensor:
    """The rank's rows `out_bounds[rank]` of the resize (bilinear with
    align_corners=False, or nearest) of the whole (B, C, h, w) map to
    `size`, from its rows `in_bounds[rank]` and the rows the resize reads
    besides (one from each neighbour at a bilinear x2; none for a downsample
    by a power of 2 on aligned rows), fetched."""
    n = in_bounds[-1][1]
    wants = [source_rows(r, n, size[0], mode) for r in out_bounds]
    x = mesh.fetch_rows(x, wants, in_bounds, dim=2)
    me = mesh.rank()
    return resize_hw_rows(x, size, (2, 3), out_bounds[me], wants[me], n, mode)


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
    Lk = key.shape[1]  # 0 on a rank without rows
    w, b = mha.in_proj_weight, mha.in_proj_bias
    q = F.linear(query, w[:E], b[:E]).view(B, Lq, H, Dh).transpose(1, 2)
    k = F.linear(key, w[E:2 * E], b[E:2 * E]).view(B, Lk, H, Dh).transpose(1, 2)
    v = F.linear(value, w[2 * E:], b[2 * E:]).view(B, Lk, H, Dh).transpose(1, 2)

    logits = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(Dh)
    if attn_mask is not None:  # bool, True = not allowed
        logits = logits.masked_fill(attn_mask, float("-inf"))
    top = logits.amax(dim=-1, keepdim=True).float() if Lk else logits.new_full((B, H, Lq, 1), float("-inf"),
                                                                                dtype=torch.float32)
    top = mesh.all_reduce_max(top)
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
    if lo == hi:
        return shortcut
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


# -------------------------------------------------------------- backbones
def nat_layer(blk: nn.Module, x: torch.Tensor, bounds: Bounds, height: int) -> torch.Tensor:
    """`NATLayer.forward` (no stochastic depth) on (B, h, W, C), the rank's
    rows `bounds[rank]` of a map of `height` rows: the normed rows its
    queries' windows reach (`reach_rows`: the union, clamped at the whole
    map's edges) fetched from the ranks that hold them, q, k and v projected
    there, and the neighbourhood attention (K4 on the card) with the row
    window (height, first query row, first fetched row)."""
    attn = blk.attn
    lo, hi = bounds[mesh.rank()]
    reach = [reach_rows(height, attn.kernel_size, attn.dilation, (a, b)) if b > a else (0, 0) for a, b in bounds]
    y = mesh.fetch_rows(blk.norm1(x), reach, bounds, dim=1)
    if lo == hi:
        return x
    B, _, W, C = x.shape
    k0 = reach[mesh.rank()][0]
    dh = C // attn.num_heads
    qkv = attn.qkv(y).view(B, y.shape[1], W, 3, attn.num_heads, dh)
    out = neighborhood_attention_2d(qkv[:, lo - k0:hi - k0, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], attn.rpb,
                                    attn.kernel_size, attn.dilation, dh ** -0.5, rows=(height, lo, k0))
    x = x + attn.proj(out.reshape(B, hi - lo, W, C))
    return x + blk.mlp(blk.norm2(x))


def swin_features(backbone: SwinTransformer, images: torch.Tensor, plan: RowPlan) -> Dict[str, torch.Tensor]:
    """`SwinTransformer.forward` (no stochastic depth) on the rank's image
    rows: its rows of {res2 .. res5}, channels-last."""
    embed = backbone.patch_embed
    n = plan.set_size(4, conv_out(plan.height, 4, 4, 0))
    x = conv_rows(embed.proj, images.permute(0, 3, 1, 2), plan.bounds(1), plan.bounds(4)).permute(0, 2, 3, 1)
    if embed.norm is not None:
        x = embed.norm(x)
    outs = {}
    for i, stage in enumerate(backbone.layers):
        stride = 4 << i
        for blk in stage.blocks:
            x = swin_block(blk, x, plan.bounds(stride), n)
        outs[f"res{i + 2}"] = getattr(backbone, f"norm{i}")(x)
        if stage.downsample is not None:
            x = stage.downsample(x)  # pads an odd map's last row: the last rank's
            n = plan.set_size(2 * stride, -(-n // 2))
    return outs


def _conv_bn(conv: nn.Module, x: torch.Tensor, plan: RowPlan, stride: int) -> Tuple[torch.Tensor, int]:
    """ResNet's `ConvBN` on the rank's rows of a map at `stride`: (its rows
    of the output, the output's stride)."""
    out_stride = stride * conv.stride[0]
    plan.set_size(out_stride, conv_out(plan.size(stride), conv.kernel_size[0], conv.stride[0], conv.padding[0]))
    return conv.norm(conv_rows(conv, x, plan.bounds(stride), plan.bounds(out_stride))), out_stride


def resnet_features(backbone: ResNet, images: torch.Tensor, plan: RowPlan) -> Dict[str, torch.Tensor]:
    """`ResNet.forward` on the rank's image rows: its rows of the features in
    `out_features` ({stem, res2 .. res5}), channels-last."""
    x, _ = _conv_bn(backbone.stem.conv1, images, plan, 1)
    plan.set_size(4, conv_out(plan.size(2), 3, 2, 1))
    x = max_pool_rows(relu(x), plan.bounds(2), plan.bounds(4))
    stride, outs = 4, {"stem": x}
    for i in range(4):
        for blk in getattr(backbone, f"res{i + 2}"):
            convs = [blk.conv1, blk.conv2] + ([blk.conv3] if hasattr(blk, "conv3") else [])
            out, s = x, stride
            for j, conv in enumerate(convs):
                out, s = _conv_bn(conv, out, plan, s)
                if j < len(convs) - 1:
                    out = relu(out)
            shortcut = x if blk.shortcut is None else _conv_bn(blk.shortcut, x, plan, stride)[0]
            x, stride = relu(out + shortcut), s
        outs[f"res{i + 2}"] = x
    return {k: v for k, v in outs.items() if k in backbone.out_features}


def convnext_features(backbone: ConvNeXt, images: torch.Tensor, plan: RowPlan) -> Dict[str, torch.Tensor]:
    """`ConvNeXt.forward` (no stochastic depth) on the rank's image rows: its
    rows of {res2 .. res5}, channels-last. The stem and the downsamples are
    valid convolutions on aligned rows (local); the depthwise 7x7 fetches 3
    halo rows a side."""
    x, n, outs = images, plan.height, {}
    for i, (down, stage) in enumerate(zip(backbone.downsample_layers, backbone.stages)):
        stride = 4 << i
        conv = down[0] if i == 0 else down[1]  # the stem: conv, norm; a downsample: norm, conv
        n = plan.set_size(stride, conv_out(n, conv.kernel_size[0], conv.stride[0], 0))
        bounds = plan.bounds(stride // conv.stride[0]), plan.bounds(stride)
        x = down[1](conv_rows(conv, x, *bounds)) if i == 0 else conv_rows(conv, down[0](x), *bounds)
        for blk in stage:
            y = blk.pwconv2(gelu(blk.pwconv1(blk.norm(conv_rows(blk.dwconv, x, plan.bounds(stride))))))
            x = x + (y if blk.gamma is None else blk.gamma * y)
        outs[f"res{i + 2}"] = getattr(backbone, f"norm{i}")(x)
    return outs


def dinat_features(backbone: DiNAT, images: torch.Tensor, plan: RowPlan) -> Dict[str, torch.Tensor]:
    """`DiNAT.forward` (no stochastic depth) on the rank's image rows: its
    rows of {res2 .. res5}, channels-last. The tokenizer's and downsamplers'
    3x3 stride-2 convolutions fetch one halo row above."""
    x, stride = images, 1
    for conv in backbone.patch_embed.proj:
        plan.set_size(2 * stride, conv_out(plan.size(stride), 3, 2, 1))
        x = conv_rows(conv, x, plan.bounds(stride), plan.bounds(2 * stride))
        stride *= 2
    x = backbone.patch_embed.norm(x)
    outs = {}
    for i, level in enumerate(backbone.levels):
        for blk in level.blocks:
            x = nat_layer(blk, x, plan.bounds(stride), plan.size(stride))
        outs[f"res{i + 2}"] = getattr(backbone, f"norm{i}")(x)
        if level.downsample is not None:
            plan.set_size(2 * stride, conv_out(plan.size(stride), 3, 2, 1))
            x = level.downsample.norm(conv_rows(level.downsample.reduction, x, plan.bounds(stride),
                                                plan.bounds(2 * stride)))
            stride *= 2
    return outs


# --------------------------------------------------------- pixel decoders
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
    (B, S, C) value, K2 on the rank's queries (none without queries)."""
    attn = layer.self_attn
    B, n, C = src.shape
    S = sum(h * w for h, w in shapes)
    value = src.new_zeros((B, S, C))
    value.index_copy_(1, index, attn.value_proj(src))
    value = mesh.all_reduce_sum(value).view(B, S, attn.n_heads, C // attn.n_heads)
    if n == 0:
        return src
    query = src + pos
    out = ms_deform_attn_fused(value, shapes, attn.sampling_offsets(query), attn.attention_weights(query), ref_abs)
    src = layer.norm1(src + attn.output_proj(out))
    return layer.norm2(src + layer.linear2(relu(layer.linear1(src))))


def msdeform_pixel_decoder(pd: MSDeformAttnPixelDecoder, features: Dict[str, torch.Tensor], plan: RowPlan):
    """`MSDeformAttnPixelDecoder.forward` on the rank's rows of the
    features: its rows of mask_features and of the `num_multi_scale`
    lowest-res maps, channels-first, and the maps' strides, low-res first."""
    C = pd.conv_dim
    srcs, poss, shapes, strides, index = [], [], [], [], []
    start = 0
    for i, f in enumerate(reversed(pd.transformer_in_features)):
        stride = STRIDES[f]
        proj = pd.input_proj[i]
        x = group_norm(proj[1], conv_rows(proj[0], features[f].permute(0, 3, 1, 2), plan.bounds(stride)))
        h, w = plan.size(stride), x.shape[3]
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
        stride = STRIDES[f]
        adapter, conv = getattr(pd, f"adapter_{idx + 1}"), getattr(pd, f"layer_{idx + 1}")
        lat = group_norm(adapter.norm, conv_rows(adapter, features[f].permute(0, 3, 1, 2), plan.bounds(stride)))
        up = resize_rows(out[-1], (plan.size(stride), lat.shape[3]), plan.bounds(strides[-1]), plan.bounds(stride))
        out.append(relu(group_norm(conv.norm, conv_rows(conv, lat + up, plan.bounds(stride)))))
        strides.append(stride)
    mask_features = conv_rows(pd.mask_features, out[-1], plan.bounds(strides[-1]))
    return mask_features, out[: pd.num_multi_scale], strides[: pd.num_multi_scale]


def fpn_pixel_decoder(pd, features: Dict[str, torch.Tensor], plan: RowPlan):
    """`BasePixelDecoder.forward` / `TransformerEncoderPixelDecoder.forward`
    (`_FPN.trunk`, then the mask features) on the rank's rows of the
    features: its rows of mask_features and of the `num_multi_scale`
    lowest-res maps, channels-first, and their strides, low-res first. The
    lateral 1x1 convolutions and the nearest upsample are local on aligned
    rows, the 3x3 convolutions fetch a halo row a side; the transformer's
    encoder runs on every rank on res5 gathered whole (its attention is
    global), and each rank keeps its rows."""
    outs, strides, y = [], [], None
    for idx, f in enumerate(reversed(pd.in_features)):
        num, stride = len(pd.in_features) - idx, STRIDES[f]
        bounds = plan.bounds(stride)
        x = features[f].permute(0, 3, 1, 2)
        if idx == 0:
            if pd.use_transformer:
                a, b = bounds[mesh.rank()]
                x = gather_rows(conv_rows(pd.input_proj, x, bounds), (a, b), plan.size(stride))
                x = pd._encode(x)[:, :, a:b]
        else:
            adapter = getattr(pd, f"adapter_{num}")
            lat = group_norm(adapter.norm, conv_rows(adapter, x, bounds))
            x = lat + resize_rows(y, (plan.size(stride), lat.shape[3]), plan.bounds(strides[-1]), bounds, "nearest")
        layer = getattr(pd, f"layer_{num}")
        y = relu(group_norm(layer.norm, conv_rows(layer, x, bounds)))
        outs.append(y)
        strides.append(stride)
    mask_features = conv_rows(pd.mask_features, outs[-1], plan.bounds(strides[-1]))
    return mask_features, outs[: pd.num_multi_scale], strides[: pd.num_multi_scale]


# ---------------------------------------------------------- query decoder
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
    rows4, h4 = plan.rows(4), plan.size(4)

    srcs, poss, level_rows = [], [], []
    for i in range(L):
        x = multi_scale[i]
        h, w = plan.size(strides[i]), x.shape[3]
        a, b = plan.rows(strides[i])
        level_rows.append((plan.bounds(strides[i]), (h, w)))
        poss.append(position_embedding_sine(h, w, C // 2, device=dev, rows=(a, b)).reshape(1, (b - a) * w, C)
                    .to(x.dtype))
        srcs.append(x.flatten(2).transpose(1, 2) + pr.level_embed.weight[i][None, None])

    tasks = task_embedding[:, None, :]
    if pr.use_task_norm:
        tasks = pr.decoder_norm(tasks)
    pe_mask = position_embedding_sine(h4, mw, C // 2, device=dev, rows=rows4).reshape(1, -1, C)
    pe_mask = pe_mask.expand(B, -1, -1).to(mask_features.dtype)
    proj_mask = conv_rows(pr.class_input_proj, mask_features, plan.bounds(4)).flatten(2).transpose(1, 2)

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

    # each level's rows of the mask features (a power-of-2 downsample reads
    # only the rank's own stride-4 rows: nothing is fetched then)
    mask_feats_at_level = [resize_rows(mask_features, size, plan.bounds(4), bounds).flatten(2)
                           for bounds, size in level_rows]
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


# ---------------------------------------------------------------- entry
# the partitioned forward of each backbone and segmentation pixel decoder
# that models/oneformer.py builds, by the module's type
BACKBONES: Dict[type, Callable] = {SwinTransformer: swin_features, ResNet: resnet_features,
                                   ConvNeXt: convnext_features, DiNAT: dinat_features}
PIXEL_DECODERS: Dict[type, Callable] = {MSDeformAttnPixelDecoder: msdeform_pixel_decoder,
                                        BasePixelDecoder: fpn_pixel_decoder,
                                        TransformerEncoderPixelDecoder: fpn_pixel_decoder}


def spatial_inference(model: nn.Module, images: torch.Tensor, task_tokens: torch.Tensor) -> Dict:
    """`model.forward_segmentation(images, task_tokens)` with the image's
    rows split over the ranks of the process group (one rank without one).
    Every rank passes the same model, the whole (B, H, W, 3) image and the
    (B, 77) task tokens; each computes on its own rows (`RowPlan(H)`) and
    exchanges only what crosses rows. A rank without rows (fewer blocks of
    ROW_BLOCK rows than ranks) takes part in every exchange.

    Returns pred_logits (B, Q, K+1), the same on every rank; pred_masks
    (B, Q, h_r, W/4), this rank's rows of the stride-4 masks (none on a rank
    without rows); `rows`, their global range (a, b), and `height`, the
    masks' rows (`gather_rows(out["pred_masks"], out["rows"],
    out["height"])` assembles the whole map). Every backbone (Swin, ResNet,
    ConvNeXt, DiNAT) and segmentation pixel decoder (MSDeformAttn, Base,
    TransformerEncoder) that `build_backbone` and `build_pixel_decoder`
    select; a training model (its query decoder built with is_train) raises
    NotImplementedError."""
    if model.predictor.is_train:
        raise NotImplementedError("spatial partitioning serves: build the model without is_train")
    backbone = BACKBONES.get(type(model.backbone))
    decoder = PIXEL_DECODERS.get(type(model.pixel_decoder))
    if backbone is None or decoder is None:
        raise TypeError(f"{type(model.backbone).__name__} with {type(model.pixel_decoder).__name__} is not a "
                        f"segmentation model models/oneformer.py builds")
    plan = RowPlan(images.shape[1])
    a, b = plan.rows(1)
    with torch.no_grad():
        task = model.task_mlp(task_tokens.to(torch.float32)).to(images.dtype)
        features = backbone(model.backbone, images[:, a:b], plan)
        mask_features, multi_scale, strides = decoder(model.pixel_decoder, features, plan)
        out = predictor(model.predictor, multi_scale, mask_features, task, strides, plan)
    out["rows"] = plan.rows(4)
    out["height"] = plan.size(4)
    return out
