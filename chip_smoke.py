"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
CUDA kernels from this checkout, holds each against its plain PyTorch version
at the main path's shapes, serves full-width 1024x2048 segmentation requests
and 192x512 two-frame depth/motion requests through the port's entry points,
takes full-width training steps, and reports per-kernel times.

    python3 chip_smoke.py

Phases, one JSON line each: device, build, k1_vs_plain, k1_class_chunks,
k2_vs_plain, k3_vs_plain, serve, stages, profile, kernels_on_served_tensors,
reference_small, sequence, sequence_stages, frame, predictor,
sequence_reference_small, train, train_reference_small, train_deterministic,
train_entry, eval.
Then the card's name and power limit as nvidia-smi reports them, the
{"kernels": [...]} line, and last {"ok": true, "device": {...}}. Any failure
raises and the script exits non-zero without the last line. It needs a CUDA
card and the repository's `uni_encoder_tpu_torch` package beside it; it
imports nothing of JAX. Served requests run under torch.inference_mode
(`serve_segmentation`, `serve_sequence`), as a server holds it.

K3, the backward of K2, is bitwise deterministic: `k3_vs_plain` fails unless
three reruns give the same bytes in all three gradients, and checks its two
edge cases (grad_out all zero, and one NaN in grad_out). The phase
`train_deterministic` runs this script twice more as child processes
(`--train-deterministic-child PATH`, with CUBLAS_WORKSPACE_CONFIG=:4096:8),
each one `Trainer(deterministic=True)` step at train_reference_small's sizes,
and fails unless their losses, watched gradients and updated parameters are
the same bytes.

The phase `train_entry` drives the training entry point, `train_torch.main`,
on the production Swin-T config (configs/cityscapes_swin_unified.yaml, read
without PyYAML) at full width and depth: 4 iterations of 2 items per
modality from a synthetic tree of 4 full-size segmentation items and 4
frame triples, through the train mappers on the host. It fails unless the
4 metrics.json records carry train.py's keys with finite losses, K2 and K3
ran 6 times per step and K1 never, the checkpoints of steps 2 and 4 were
written, and `evaluate_torch.build_model` loads the last one byte for byte,
with exactly the training-only keys (text encoder, text projector, prompt
context, logit scale) left unused.

The phase `eval` drives the evaluation entry point, `evaluate_torch.main`,
at full width on a synthetic Cityscapes / KITTI tree (4 images per
dataset) with a reference-style .pth of random weights: the loaded state
dict and a forward must be byte-equal to the writer's, the keys the model
does not own exactly the planted ones, every scalar metric finite (a
per-class IoU is NaN where the class is in neither GT nor prediction), K2
launched 6 times per segmentation forward, and the same evaluators fed the
GT must score PQ = mIoU = AP = 100.

Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of HBM, 67 TFLOP/s
of fp32 outside the tensor cores and 495 TFLOP/s of TF32 on them (at the
700 W power limit). K1 runs its semantic product on TF32 tensor cores, so
its bound counts that product at the TF32 rate; the all-CUDA-core bound is
reported beside it. The build phase reports ptxas's stack-frame bytes for
each kernel (K2 and each of K3's three kernels must have none) and the HMMA
count of K1's SASS.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

SEG_H, SEG_W = 1024, 2048
SEQ_H, SEQ_W = 192, 512  # the sequence request: a two-frame pair
N_REQUESTS = 3  # served with the kernels' launch counts read
N_TIMED = 10  # timed stage by stage
N_PROFILED = 3  # under torch.profiler
N_FRAMES = 10  # segmentation + sequence frames, timed
N_SERVED = 2  # items of each kind through the Predictor and the serving pool
STAGES = ("task_mlp", "backbone", "pixel_decoder", "predictor", "postprocess")
SEQ_STAGES = ("backbone", "pose_decoder", "motion_decoder", "motion_mask", "depth_decoder")
TASK = "The task is panoptic"
THING_IDS = range(11, 19)  # Cityscapes things: person .. bicycle
CLASS_NAMES = ("road", "sidewalk", "building", "wall", "fence", "pole", "traffic light", "traffic sign",
               "vegetation", "terrain", "sky", "person", "rider", "car", "truck", "bus", "train", "motorcycle",
               "bicycle")
TRAIN_BATCH = 2  # per modality: the floor of train.py's batch (the default is 8)
TRAIN_SLOTS, TRAIN_VALID = 100, 40  # padded target slots (train_mappers max_instances), instances per crop
N_TRAIN_TIMED = 3  # training steps timed, after one warm-up; one more is profiled
# parameters whose gradients train_reference_small compares, and whose
# values the train phase checks for movement
WATCHED = ("sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
           "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.value_proj.weight",
           "backbone.layers.0.blocks.0.attn.qkv.weight", "motion_decoder.conv5.0.weight",
           "sem_seg_head.predictor.class_embed.weight", "text_encoder.transformer.resblocks.0.attn.in_proj_weight")
# the CUDA kernels of K3's source; ptxas must give each a 0-byte stack frame
K3_KERNELS = ("msda_grad_out_absmax_kernel", "msda_fused_backward_kernel", "msda_grad_value_epilogue_kernel")
DETERMINISTIC_CHILD = "--train-deterministic-child"
TRAIN_ENTRY_CONFIG = "configs/cityscapes_swin_unified.yaml"  # the production Swin-T config, read without PyYAML
TRAIN_ENTRY_ITERS, TRAIN_ENTRY_ITEMS = 4, 4  # iterations (of 90 000); synthetic items per training split
# the state-dict keys only a model built with is_train owns: the text encoder
# and its projector, the prompt context and the contrastive logit scale
TRAINING_ONLY_KEYS = ("text_encoder.", "text_projector.", "prompt_ctx.", "logit_scale")
METRICS_JSON_KEYS = {"iteration", "loss", "loss_seg", "loss_monodepth", "loss_ce", "loss_mask", "loss_dice",
                     "data_time", "img_per_s"}  # train.py's records
EVAL_SEG_IMAGES = 4  # per synthetic dataset (reduced: the real val split holds 500 images)
EVAL_KITTI = "kitti_synthetic_png"  # the synthetic KITTI drive, PNG frames
EVAL_SEG_SET = "cityscapes_fine_panoptic_val"
# checkpoint keys no port module owns, planted in the reference-style .pth
EVAL_PLANTED = {"motion_decoder.layer1.0.weight": (256, 1536, 1, 1),
                "motion_decoder.layer1.1.left.0.weight": (256, 256, 3, 3),
                "text_encoder.transformer.resblocks.0.attn.in_proj_weight": (768, 256)}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of `fn()` over `reps` launches, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def blobby(seed, Q, K, h, w):
    """tests/test_fused_postprocess.py's fixture: blobby mask logits with
    generic thresholds, well-separated class logits."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    masks = np.empty((Q, h, w), np.float32)
    for q in range(Q):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.uniform(2, 8)
        masks[q] = (r - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)) * rng.uniform(0.5, 2.0)
    cls = rng.randn(Q, K + 1).astype(np.float32) * 3
    return torch.from_numpy(cls), torch.from_numpy(masks)


def compare_post(got, ref, map_mismatch):
    """K1 tolerances (tests/test_fused_postprocess.py:59-86): segment arrays,
    labels and query indices exact; per-pixel maps within `map_mismatch`;
    scores atol/rtol 1e-3; boxes within 1 pixel. Returns the measurements."""
    for k in ("seg_id", "label", "isthing", "is_new_segment", "labels", "query_indices"):
        if not torch.equal(got[k].cpu(), ref[k].cpu()):
            raise AssertionError(f"K1 {k} differs from the plain version")
    out = {}
    for k in ("sem_seg_argmax", "panoptic_seg"):
        if got[k].dtype != torch.uint8 or got[k].shape != ref[k].shape:
            raise AssertionError(f"K1 {k}: {got[k].dtype} {tuple(got[k].shape)}")
        frac = (got[k] != ref[k]).float().mean().item()
        if not frac < map_mismatch:
            raise AssertionError(f"K1 {k} mismatch {frac} >= {map_mismatch}")
        out[f"{k}_mismatch"] = frac
    torch.testing.assert_close(got["scores"], ref["scores"], atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(got["boxes"], ref["boxes"], atol=1.0, rtol=0.0)
    out["scores_max_abs_err"] = (got["scores"] - ref["scores"]).abs().max().item()
    out["boxes_max_abs_err"] = (got["boxes"] - ref["boxes"]).abs().max().item()
    return out


def compare_msda(got, ref, fp32):
    """fp32: atol/rtol 1e-5 (tests/test_ms_deform_attn.py:51). bf16: within
    one bf16 ulp of the plain output plus the fp32 atol 1e-5 (both sum the
    same fp32 products in another order and round once; the atol covers
    sums that cancel to near zero, whose ulp is below fp32's error)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if fp32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        ulp = torch.where(ref == 0, torch.zeros_like(ref), 2.0 ** (torch.floor(torch.log2(ref.abs())) - 7))
        bad = err > ulp + 1e-5
        if bool(bad.any()):
            i = int(torch.argmax((err - ulp) * bad))
            raise AssertionError(f"K2 bf16: {int(bad.sum())} values beyond 1 ulp + 1e-5, worst "
                                 f"kernel {got.flatten()[i].item()} plain {ref.flatten()[i].item()}")
    return err.max().item()


def k1_bound(Q, K, h, w):
    """Bytes and fp32 operations; of those, 2 * K * Q * H * W are the
    semantic product clsprob @ sig, the rest the upsample, sigmoid, argmaxes
    and per-query sums."""
    H, W = 4 * h, 4 * w
    nbytes = Q * h * w * 2 + Q * (K + 2) * 4 + 2 * H * W + Q * 9 * 4  # logits, class probs, maps, per-query
    flops = (2 * K + 20) * Q * H * W
    return nbytes, flops


def k1_bound_semantic_on_tensor_cores(Q, K, h, w):
    """K1's least time if its semantic product ran on TF32 tensor cores
    beside the rest on CUDA cores (ms): the largest of the byte time and the
    two units' operation times."""
    nbytes, flops = k1_bound(Q, K, h, w)
    semantic = 2 * K * Q * 16 * h * w
    return max(nbytes / HBM_BYTES_PER_S, semantic / TF32_FLOP_PER_S, (flops - semantic) / FP32_FLOP_PER_S) * 1e3


def k2_bound(B, Lq, S, M, D, L, P, nbytes_el):
    """The fused contract: value, offsets and logits in the model dtype and
    fp32 ref_abs read once, the output written once."""
    nbytes = (B * S * M * D + B * Lq * M * L * P * 3 + B * Lq * M * D) * nbytes_el + L * Lq * 2 * 4
    # 4 corners x D fused multiply-adds, corner weights, softmax and location
    flops = B * Lq * M * L * P * (8 * D + 30)
    return nbytes, flops


def ptxas_stack_frames(log_path, kernel):
    """Stack-frame bytes ptxas reports for each build of `kernel` (its
    template instantiations), from an `nvcc -Xptxas -v` log."""
    frames, current = [], None
    with open(log_path, errors="replace") as f:
        for line in f:
            if "Function properties for" in line:
                current = line.rsplit("for", 1)[1].strip()
            elif "bytes stack frame" in line and current is not None:
                if kernel in current:
                    frames.append(int(line.split("bytes stack frame")[0].split()[-1]))
                current = None
    return frames


def sass_count(lib_path, opcode):
    """How many `opcode` instructions the built library's SASS holds
    (cuobjdump ships with the nvcc that built it)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        raise FileNotFoundError("cuobjdump not found beside nvcc: cannot read the kernels' SASS")
    sass = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return sum(1 for line in sass.splitlines() if f" {opcode}" in line)


def msda_inputs(g, B, Lq, M, L, P, dtype, dev):
    """Raw Linear outputs as the served model gives them: offsets around the
    module's directional initialisation (head angle, scaled by point index
    + 1) plus noise, with 1 in 50 pushed far out of range; logits of spread
    comparable to trained heads."""
    ang = torch.arange(M, dtype=torch.float32) * (2 * np.pi / M)
    grid = torch.stack([ang.cos(), ang.sin()], -1)
    grid = grid / grid.abs().amax(-1, keepdim=True)
    grid = grid[:, None, None, :] * torch.arange(1, P + 1, dtype=torch.float32)[None, None, :, None]
    off = grid.expand(M, L, P, 2) + torch.randn(B, Lq, M, L, P, 2, generator=g) * 1.5
    far = torch.rand(B, Lq, M, L, P, 1, generator=g) < 0.02
    off = torch.where(far, off * 40.0, off)
    logits = torch.randn(B, Lq, M * L * P, generator=g) * 2.0
    return off.reshape(B, Lq, -1).to(dev, dtype).contiguous(), logits.to(dev, dtype).contiguous()


def bound_fields(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def reset_launches(*wrappers):
    for w in wrappers:
        w.launches = 0


def profile_device(fn, n, untraced_ms):
    """Device kernel time of one `fn()` from torch.profiler over `n` calls,
    the busy share (traced, and against the untraced wall time
    `untraced_ms`), launches per call and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / n
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / n
    top = sorted(on_device, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    return {"kernel_ms": kernel_ms, "traced_wall_ms": traced_ms, "busy_share_traced": kernel_ms / traced_ms,
            "busy_share_untraced": kernel_ms / untraced_ms,
            "kernel_launches": sum(e.count for e in on_device) / n,
            "top_kernels_ms": {e.key[:90]: e.self_device_time_total / 1e3 / n for e in top}}


def check_sequence_outputs(out, B, H, W):
    """The sequence request's checks: shapes, finite values, disparity in
    the TransDSSL bin range [0.01, 1], a motion probability, an SE(3) last
    row."""
    disp, mask = out["disp"].float(), out["motion_mask"].float()
    flow, cam = out["complete_flow"].float(), out["cam_T_cam"].float()
    last_row = torch.tensor([0.0, 0.0, 0.0, 1.0], device=cam.device).expand(B, 4)
    return {
        "disp_shape": tuple(disp.shape) == (B, H, W, 1),
        "motion_mask_shape": tuple(mask.shape) == (B, H, W, 1),
        "complete_flow_shape": tuple(flow.shape) == (B, H, W, 3),
        "cam_T_cam_shape": tuple(cam.shape) == (B, 4, 4),
        "finite": all(bool(torch.isfinite(x).all()) for x in (disp, mask, flow, cam)),
        "disp_in_bins": bool((disp >= 0.01).all() and (disp <= 1.0).all()),
        "motion_mask_in_0_1": bool((mask >= 0).all() and (mask <= 1).all()),
        "cam_T_cam_last_row": bool(torch.equal(cam[:, 3], last_row)),
    }


@torch.inference_mode()
def serve_segmentation(model, images, tokens, thing):
    """One segmentation request as a server makes it: forward_segmentation
    and the fused post-process of each image, under inference_mode."""
    from uni_encoder_tpu_torch.inference.fused_postprocess import fused_multitask_inference

    out = model.forward_segmentation(images, tokens)
    Q = out["pred_logits"].shape[1]
    post = [fused_multitask_inference(out["pred_logits"][b], out["pred_masks"][b], thing,
                                      object_mask_threshold=0.8, overlap_threshold=0.8, topk=Q)
            for b in range(images.shape[0])]
    return out, post


@torch.inference_mode()
def serve_sequence(model, cur, prev):
    """One sequence request as a server makes it, under inference_mode."""
    return model.forward_sequence(cur, prev)


def train_batches(seed, B, seg_hw, seq_hw, slots, valid, n_texts, device):
    """A synthetic balanced batch from `seed`: B segmentation crops with
    `valid` of `slots` target slots filled by random discs at stride 4,
    labels, and per-query texts ("a photo with a {class}" per target,
    padded with the task prompt, as the segmentation train mapper builds
    them); and B frame triples with pinhole intrinsics."""
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    rng = np.random.RandomState(seed)
    H, W = seg_hw
    h, w = H // 4, W // 4
    labels = rng.randint(0, len(CLASS_NAMES), size=(B, slots))
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.zeros((B, slots, h, w), bool)
    texts = np.zeros((B, n_texts, 77), np.int64)
    for b in range(B):
        prompts = [f"a {TASK.split()[-1]} photo"] * n_texts
        for n in range(valid):
            cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.uniform(3, h / 4)
            masks[b, n] = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            if n < n_texts:
                prompts[n] = f"a photo with a {CLASS_NAMES[labels[b, n]]}"
        texts[b] = [tokenize_task(p) for p in prompts]
    ok = np.zeros((B, slots), bool)
    ok[:, :valid] = True
    Hs, Ws = seq_hw
    K = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * Ws, 1.92 * Hs, 0.5 * Ws, 0.5 * Hs
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    seg = {"images": f32(rng.randn(B, H, W, 3)),
           "task_tokens": torch.tensor([tokenize_task(TASK)] * B, dtype=torch.int64, device=device),
           "text_tokens": torch.from_numpy(texts).to(device), "labels": torch.from_numpy(labels).to(device),
           "masks": torch.from_numpy(masks).to(device), "valid": torch.from_numpy(ok).to(device)}
    seq = {k: f32(rng.randn(B, Hs, Ws, 3) * 0.5) for k in ("images", "prev_images", "next_images")}
    seq["K"], seq["inv_K"] = f32(K), f32(np.linalg.inv(K))
    return seg, seq


def k3_bound(B, Lq, S, M, D, L, P):
    """fp32: value, grad_out, offsets, logits and ref_abs read once; the
    three gradients written once. Per sample: 4 corner dot products and 4
    scaled adds over D channels, the corner weights and the softmax
    backward."""
    nbytes = (2 * B * S * M * D + B * Lq * M * D + 2 * B * Lq * M * L * P * 3) * 4 + L * Lq * 2 * 4
    flops = B * Lq * M * L * P * (16 * D + 60)
    return nbytes, flops


def small_train_step(Trainer, cfg, device, deterministic=False):
    """One fp32 training step at the full width on a small batch (2 crops
    of 128x256 with 20 target slots, 8 valid; 2 frame triples of 64x128),
    weights from seed 0 and draws from seed 1: (losses, the WATCHED
    gradients, every updated parameter), on `device`."""
    n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
    tr = Trainer(cfg, device=device, deterministic=deterministic)
    st = tr.init(seed=0)
    seg_s, seq_s = train_batches(1, TRAIN_BATCH, (128, 256), (64, 128), 20, 8, n_texts, device)
    draws = tr.make_draws(torch.Generator().manual_seed(1), seg_s, seq_s, device)
    _, m = tr.train_step(st, seg_s, seq_s, draws=draws)
    params = dict(st.model.named_parameters())
    return m, {n: params[n].grad for n in WATCHED}, {n: p.detach() for n, p in params.items()}


def train_deterministic_child(out_path):
    """The child of phase train_deterministic: one deterministic step,
    its losses, watched gradients and updated parameters saved to
    `out_path` as CPU tensors, with the step's seconds."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from uni_encoder_tpu_torch.config import Config
    from uni_encoder_tpu_torch.training.train_step import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    losses, grads, params = small_train_step(Trainer, Config(), torch.device("cuda"), deterministic=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    torch.save({"losses": cpu(losses), "grads": cpu(grads), "params": cpu(params), "seconds": seconds}, out_path)


def k3_scatter_rows(shapes, off, logits, ref_abs, M):
    """K3's scatter on these inputs: its valid corner writes (each one row of
    D channels of grad_value, the kernel's 64-bit atomics / D), and the
    distinct value rows those hit within one (b, q, head) and within a block
    of 16 consecutive (b, head, q) work items, the kernel's thread block."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import sampling_inputs

    loc = sampling_inputs(off, logits, ref_abs, M)[0]  # (B, Lq, M, L, P, 2)
    B, Lq = off.shape[:2]
    S = sum(h * w for h, w in shapes)
    toks, start = [], 0
    for lvl, (H, W) in enumerate(shapes):
        x0, y0 = loc[:, :, :, lvl, :, 0].floor(), loc[:, :, :, lvl, :, 1].floor()
        xs = torch.stack([x0, x0 + 1, x0, x0 + 1], -1)
        ys = torch.stack([y0, y0, y0 + 1, y0 + 1], -1)
        valid = (xs >= 0) & (xs <= W - 1) & (ys >= 0) & (ys <= H - 1)
        toks.append(torch.where(valid, start + ys * W + xs, -1.0).long())  # (B, Lq, M, P, 4)
        start += H * W
    tok = torch.stack(toks, 3)  # (B, Lq, M, L, P, 4)
    b = torch.arange(B, device=tok.device).view(B, 1, 1, 1, 1, 1)
    m = torch.arange(M, device=tok.device).view(1, 1, M, 1, 1, 1)
    rows = torch.where(tok >= 0, (b * S + tok) * M + m, -1).permute(0, 2, 1, 3, 4, 5).reshape(B * M * Lq, -1)

    def distinct(x):
        x = x.sort(-1).values
        return int(((x[:, 1:] != x[:, :-1]) & (x[:, 1:] >= 0)).sum() + (x[:, 0] >= 0).sum())

    pad = rows.new_full(((-rows.shape[0]) % 16, rows.shape[1]), -1)
    return {"corner_rows": int((rows >= 0).sum()), "distinct_rows_per_query_head": distinct(rows),
            "distinct_rows_per_block_of_16": distinct(torch.cat([rows, pad]).reshape(-1, 16 * rows.shape[1]))}


def fail_unless(phase, checks):
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} checks failed: {failed}")


def finite_metrics(results):
    """(scalar metrics all finite, per-class IoU entries that are NaN: a
    class absent from both GT and prediction)."""
    scalars, nan_classes = [], 0
    for group in results["seg_and_depth"].values():
        for k, v in group.items():
            if isinstance(v, list):
                nan_classes += int(np.isnan(v).sum())
            else:
                scalars.append(float(v))
    return bool(scalars) and bool(np.isfinite(scalars).all()), nan_classes


def eval_summary(timings):
    """Seconds per image by dataset, split into loader wait, predict and
    the evaluators' process: each dataset's first item (which holds the
    run's warm-up) apart from the mean of the rest (the steady state), the
    instances and panoptic segments each image handed the evaluators, and
    the loader-wait share of the whole run and of its steady state."""
    keys = ("loader_wait_s", "predict_s", "process_s")
    by_set = {}
    for t in timings:
        by_set.setdefault(t["dataset"], []).append(t)
    per_set = {name: {"first": {k: ts[0][k] for k in keys},
                      "steady_mean": {k: float(np.mean([t[k] for t in ts[1:]])) for k in keys} if ts[1:] else None,
                      "per_image": {k: [t[k] for t in ts] for k in (*keys, "instances", "segments") if k in ts[0]}}
               for name, ts in by_set.items()}

    def seconds_and_wait_share(ts):
        total = sum(t[k] for t in ts for k in keys)
        return total, sum(t["loader_wait_s"] for t in ts) / max(total, 1e-12)

    steady = [t for ts in by_set.values() for t in ts[1:]]
    total, share = seconds_and_wait_share(timings)
    steady_total, steady_share = seconds_and_wait_share(steady)
    return {"per_dataset": per_set, "images": len(timings), "seconds": total,
            "seconds_per_image": total / max(len(timings), 1), "loader_wait_share": share,
            "steady_images": len(steady), "steady_seconds_per_image": steady_total / max(len(steady), 1),
            "steady_loader_wait_share": steady_share}


def eval_phase(dev, smi):
    """The evaluation entry point at full width on the card: a synthetic
    Cityscapes / KITTI tree in the datasets' layouts (EVAL_SEG_IMAGES per dataset:
    val at 1024x2048 with panoptic, trainId and 16-bit instance PNGs;
    cityscapes_crop_test frames at 1024x2048 with GT depth; KITTI frames at
    375x1242 with calibration and velodyne scans), a reference-style .pth
    of a random Config().model (class head x8) with planted keys the model
    does not own, `evaluate_torch.main` with --task panoptic, then with
    --task semantic and TEST.AUG (6 scales x flip) on 1 image, and the
    same evaluators fed the GT; the panoptic run once more under
    torch.profiler. Returns the K1 and K2 launches of the two runs."""
    import tempfile

    import evaluate_torch
    from uni_encoder_tpu_torch.config import Config
    from uni_encoder_tpu_torch.data import image_io, synthetic
    from uni_encoder_tpu_torch.data.build import build_test_loader
    from uni_encoder_tpu_torch.data.mappers import TestMapper
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.engine import checkpoint as ckpt
    from uni_encoder_tpu_torch.inference.fused_postprocess import fused_postprocess_cuda
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_cuda

    t_phase = time.perf_counter()
    importable = {m: subprocess.run([sys.executable, "-c", f"import {m}"], capture_output=True,
                                    timeout=120).returncode == 0 for m in ("PIL", "cv2")}
    cfg = Config()
    enc_layers = cfg.model.sem_seg_head.transformer_enc_layers
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        synthetic.write_cityscapes_val(root, EVAL_SEG_IMAGES, (SEG_H, SEG_W))
        synthetic.write_cityscapes_sequence(root, EVAL_SEG_IMAGES, (SEG_H, SEG_W))
        synthetic.register_kitti(root, EVAL_KITTI, synthetic.write_kitti(root, EVAL_SEG_IMAGES))
        fixture_s = time.perf_counter() - t0
        frame = os.path.join(root, "cityscapes/leftImg8bit/val", synthetic.CITY,
                             f"{synthetic.CITY}_000000_000019_leftImg8bit.png")
        read_ms, lanczos_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            rgb = image_io.read_png(frame)
            read_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            image_io.resize_lanczos(rgb, (SEQ_H, SEQ_W))
            lanczos_ms.append((time.perf_counter() - t0) * 1e3)

        # ---- a reference-style .pth of random full-width weights
        writer = UniEncoder(cfg.model, device=dev, seed=0)
        with torch.no_grad():
            writer.predictor.class_embed.weight.mul_(8.0)
        saved = {k: v.detach().cpu().clone() for k, v in writer.state_dict().items()}
        g = torch.Generator().manual_seed(5)
        planted = {k: torch.randn(*shape, generator=g) for k, shape in EVAL_PLANTED.items()}
        pth = os.path.join(root, "model_final.pth")
        t0 = time.perf_counter()
        torch.save({"model": {**saved, **planted}}, pth)
        save_s = time.perf_counter() - t0
        pth_mb = os.path.getsize(pth) / 1e6
        t0 = time.perf_counter()
        ckpt.load_reference_state(pth)
        read_pth_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded, report = evaluate_torch.build_model(cfg, pth, dev)
        torch.cuda.synchronize()
        build_model_s = time.perf_counter() - t0
        own = loaded.state_dict()
        rng = np.random.RandomState(4)
        img = torch.from_numpy(rng.randn(1, 256, 512, 3).astype(np.float32)).to(dev)
        tokens = torch.tensor([tokenize_task(TASK)], dtype=torch.int64, device=dev)
        cur, prev = (torch.from_numpy(rng.randn(1, SEQ_H, SEQ_W, 3).astype(np.float32)).to(dev) for _ in range(2))
        outs = []
        with torch.inference_mode():
            for m in (writer, loaded):
                outs.append({**m.forward_segmentation(img, tokens), **m.forward_sequence(cur, prev)})
        keys = ("pred_logits", "pred_masks", "disp", "motion_mask", "complete_flow", "cam_T_cam")
        load_checks = {
            "state_dict_byte_equal": sorted(own) == sorted(saved) and all(
                own[k].cpu().numpy().tobytes() == saved[k].numpy().tobytes() for k in saved),
            "forward_byte_equal": all(torch.equal(outs[0][k], outs[1][k]) for k in keys),
            "unused_exactly_the_planted_keys": report.unused == sorted(EVAL_PLANTED),
        }
        del writer, loaded, own, outs
        torch.cuda.empty_cache()

        # ---- the entry point: panoptic, then semantic with TEST.AUG on 1 image
        common = ["--weights", pth, "--datasets-root", root]
        argvs = {"panoptic": common + ["--task", "panoptic", f"datasets.depth_test=[cityscapes_crop_test,{EVAL_KITTI}]",
                                       f"datasets.seg_test_panoptic=[{EVAL_SEG_SET}]"],
                 "semantic": common + ["--task", "semantic", "--max-images", "1", "model.test.aug_enabled=true",
                                       "datasets.depth_test=[]", f"datasets.seg_test_semantic=[{EVAL_SEG_SET}]"]}
        runs = {}
        for task, argv in argvs.items():
            reset_launches(fused_postprocess_cuda, ms_deform_attn_fused_cuda)
            timings = []
            t0 = time.perf_counter()
            results = evaluate_torch.main(argv, timings=timings)
            torch.cuda.synchronize()
            runs[task] = {"results": results, "wall_s": time.perf_counter() - t0, "timings": timings,
                          "launches": {"k1": fused_postprocess_cuda.launches, "k2": ms_deform_attn_fused_cuda.launches}}
            torch.cuda.empty_cache()
        # the panoptic run once more under torch.profiler: how much of it the card works
        prof = profile_device(lambda: evaluate_torch.main(argvs["panoptic"]), 1, runs["panoptic"]["wall_s"] * 1e3)
        tta = cfg.model.test
        seg_forwards = {"panoptic": EVAL_SEG_IMAGES, "semantic": len(tta.aug_min_sizes) * (2 if tta.aug_flip else 1)}
        checks = dict(load_checks)
        nan_classes = {}
        for task, r in runs.items():
            checks[f"{task}_metrics_finite"], nan_classes[task] = finite_metrics(r["results"])
            checks[f"{task}_k2_launches"] = r["launches"]["k2"] == enc_layers * seg_forwards[task]
            checks[f"{task}_k1_launches"] = r["launches"]["k1"] == 0  # the Predictor's post-process is unfused
        checks["panoptic_groups"] = sorted(runs["panoptic"]["results"]["seg_and_depth"]) == sorted(
            ["cityscapes_crop_test/depth_error", f"{EVAL_KITTI}/depth_error", f"{EVAL_SEG_SET}/panoptic_seg",
             f"{EVAL_SEG_SET}/sem_seg", f"{EVAL_SEG_SET}/segm"])

        # ---- the same evaluators fed the GT, on the same full-size files
        gt_eval = evaluate_torch.build_evaluator(EVAL_SEG_SET, "panoptic")
        gt_eval.reset()
        for item in build_test_loader(EVAL_SEG_SET, TestMapper(task="panoptic")):
            gt_eval.process([item], [synthetic.gt_as_prediction(item)])
        gt = gt_eval.evaluate()
        perfect = {"PQ": gt["panoptic_seg"]["PQ"], "mIoU": gt["sem_seg"]["mIoU"], "AP": gt["segm"]["AP"]}
        checks["gt_fed_back_perfect"] = all(abs(v - 100.0) < 1e-9 for v in perfect.values())
        checks["no_pil_or_cv2_imported"] = not any(m in sys.modules for m in ("PIL", "cv2"))

    summaries = {task: eval_summary(r["timings"]) for task, r in runs.items()}
    emit("eval", datasets={"cityscapes_val": [EVAL_SEG_IMAGES, SEG_H, SEG_W],
                           "cityscapes_crop_test": [EVAL_SEG_IMAGES, SEG_H, SEG_W],
                           "kitti": [EVAL_SEG_IMAGES, *synthetic.KITTI_HW]},
         dtype=cfg.model.dtype, tf32=False, pil_importable=importable["PIL"], cv2_importable=importable["cv2"],
         fixture_s=fixture_s, read_png_ms=read_ms, resize_lanczos_ms=lanczos_ms,
         pth_mb=pth_mb, pth_save_s=save_s, pth_read_s=read_pth_s,
         build_model_with_weights_s=build_model_s, unused=report.unused,
         runs={task: {"wall_s": r["wall_s"], "launches": r["launches"], "timing": summaries[task],
                      "metrics": r["results"]["seg_and_depth"]} for task, r in runs.items()},
         panoptic_run_profiled={"kernel_ms": prof["kernel_ms"], "traced_wall_ms": prof["traced_wall_ms"],
                                "busy_share_traced": prof["busy_share_traced"],
                                "busy_share_untraced": prof["busy_share_untraced"],
                                "kernel_launches": prof["kernel_launches"], "top_kernels_ms": prof["top_kernels_ms"]},
         nan_iou_classes=nan_classes, gt_fed_back=perfect, checks=checks,
         seconds=time.perf_counter() - t_phase, card=smi)
    fail_unless("eval", checks)
    return {task: r["launches"] for task, r in runs.items()}


def train_entry_phase(dev, smi):
    """The training entry point at full width and depth: a synthetic tree of
    TRAIN_ENTRY_ITEMS 1024x2048 segmentation items and as many 3-frame
    sequence items under build/, then `train_torch.main` on the production
    Swin-T config (read by the port's YAML reader) for TRAIN_ENTRY_ITERS
    iterations of TRAIN_BATCH per modality, logging every iteration and saving
    every 2; the checkpoint loaded by `evaluate_torch.build_model`. The
    peak device memory is reported per iteration (the first holds the
    model's initialisation, and in a process that has not run these shapes
    yet, cuDNN's benchmarking) and over the run. Returns the kernels'
    launches over the run."""
    import evaluate_torch
    import train_torch
    from uni_encoder_tpu_torch import kernels
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.data import datasets, synthetic
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.data.train_mappers import build_train_mappers
    from uni_encoder_tpu_torch.inference.fused_postprocess import fused_postprocess_cuda
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_backward_cuda, ms_deform_attn_fused_cuda

    t_phase = time.perf_counter()
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAIN_ENTRY_CONFIG)
    work = os.path.join(os.path.dirname(kernels.BUILD_DIR), "train_entry")
    root, out = os.path.join(work, "data"), os.path.join(work, "run")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        synthetic.write_cityscapes_train(root, TRAIN_ENTRY_ITEMS, (SEG_H, SEG_W))
        tree_s = time.perf_counter() - t0
        cfg = load_config(cfg_path)

        # host ms by stage: the first two items of each kind (a process's
        # first item also builds build/native/ with g++ when it is missing,
        # and loads the tokenizer if no earlier phase did)
        datasets.register_all(root)
        seg_mapper, seq_mapper = build_train_mappers(cfg)
        stage_ms = {}
        for kind, mapper, name in (("segmentation", seg_mapper, "cityscapes_fine_panoptic_train"),
                                   ("sequence", seq_mapper, "cityscapes_sequence_crop_full_sequence_train")):
            stage_ms[kind] = []
            for item in DatasetCatalog.get(name)[:2]:
                mapper.stage_s.clear()
                mapped = mapper(item)
                stage_ms[kind].append({k: v * 1e3 for k, v in mapper.stage_s.items()})
                if kind == "segmentation":
                    stage_ms[kind][-1].update(task=mapped["task"], target_count=int(mapped["valid"].sum()))

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(fused_postprocess_cuda, ms_deform_attn_fused_cuda, ms_deform_attn_fused_backward_cuda)
        timings = []
        t0 = time.perf_counter()
        state = train_torch.main(["--config", cfg_path, "--datasets-root", root, "--output-dir", out,
                                  "--max-iter", str(TRAIN_ENTRY_ITERS), "--batch", str(TRAIN_BATCH),
                                  "--log-period", "1", "--checkpoint-period", "2"], timings=timings)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {"k1": fused_postprocess_cuda.launches, "k2": ms_deform_attn_fused_cuda.launches,
                    "k3": ms_deform_attn_fused_backward_cuda.launches}
        peak_gb = max(t["peak_gb"] for t in timings)
        with open(os.path.join(out, "metrics.json")) as f:
            records = [json.loads(line) for line in f if line.strip()]
        with open(os.path.join(out, "last_checkpoint")) as f:
            pointer = f.read().strip()

        # the checkpoint through the evaluation entry point's loader
        trained = state.model.state_dict()
        t0 = time.perf_counter()
        model, report = evaluate_torch.build_model(cfg, out, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        own = model.state_dict()
        training_only = sorted(set(trained) - set(own))
        rng = np.random.RandomState(6)
        img = torch.from_numpy(rng.randint(0, 256, (1, *cfg.input.seg_crop_train, 3)).astype(np.float32)).to(dev)
        tokens = torch.tensor([tokenize_task(TASK)], dtype=torch.int64, device=dev)
        with torch.inference_mode():
            fwd = model.forward_segmentation(img, tokens)
        enc_layers = cfg.model.sem_seg_head.transformer_enc_layers
        checks = {
            "losses_finite": len(records) > 0 and all(
                np.isfinite(r[k]) for r in records for k in ("loss", "loss_seg", "loss_monodepth")),
            "metrics_records": len(records) == TRAIN_ENTRY_ITERS and all(set(r) == METRICS_JSON_KEYS for r in records),
            "step_count": state.step == TRAIN_ENTRY_ITERS and state.opt.count == TRAIN_ENTRY_ITERS,
            "k1_launches": launches["k1"] == 0,
            "k2_launches": launches["k2"] == TRAIN_ENTRY_ITERS * enc_layers,
            "k3_launches": launches["k3"] == TRAIN_ENTRY_ITERS * enc_layers,
            "checkpoints": all(os.path.isfile(os.path.join(out, f"step_{n}.pt")) for n in (2, 4))
            and pointer == "step_4.pt",
            "config_read_without_pyyaml": "yaml" not in sys.modules,
            "loaded_byte_equal": all(own[k].cpu().numpy().tobytes() == trained[k].cpu().numpy().tobytes()
                                     for k in own),
            "unused_exactly_the_training_only_keys": report.unused == training_only and bool(training_only)
            and all(k.startswith(TRAINING_ONLY_KEYS) for k in training_only),
            "loaded_forward_finite": all(bool(torch.isfinite(fwd[k]).all()) for k in ("pred_logits", "pred_masks")),
        }
        ckpt_mb = os.path.getsize(os.path.join(out, pointer)) / 1e6
    finally:
        shutil.rmtree(work, ignore_errors=True)
    iterations = [{"data_ms": t["data_s"] * 1e3, "step_ms": t["step_s"] * 1e3,
                   "data_share": t["data_s"] / (t["data_s"] + t["step_s"]), "img_per_s": r["img_per_s"],
                   "checkpoint_s": t["checkpoint_s"], "peak_gb": t["peak_gb"], "loss": r["loss"]}
                  for t, r in zip(timings, records)]
    emit("train_entry", config=TRAIN_ENTRY_CONFIG, batch_per_modality=TRAIN_BATCH, iterations=TRAIN_ENTRY_ITERS,
         items_per_split=TRAIN_ENTRY_ITEMS, image=[SEG_H, SEG_W], crop=list(cfg.input.seg_crop_train),
         frames=list(cfg.input.depth_hw_train), per_iteration=iterations,
         stage_ms=stage_ms, peak_memory_gb=peak_gb, tree_write_s=tree_s, run_s=run_s, checkpoint_mb=ckpt_mb,
         build_model_with_checkpoint_s=load_s, launches=launches,
         training_only_keys={p: sum(k.startswith(p) for k in training_only) for p in TRAINING_ONLY_KEYS},
         metrics=records, checks=checks, seconds=time.perf_counter() - t_phase, card=smi)
    fail_unless("train_entry", checks)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.utils.flop_counter import FlopCounterMode

    from uni_encoder_tpu_torch import kernels
    from uni_encoder_tpu_torch.config import Config
    from uni_encoder_tpu_torch.engine.predictor import Predictor
    from uni_encoder_tpu_torch.engine.serving import AsyncBatchedPredictor, per_item
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.inference.fused_postprocess import (
        fused_multitask_inference,
        fused_multitask_inference_plain,
        fused_postprocess_cuda,
        fused_postprocess_inputs,
    )
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import absolute_reference_points
    from uni_encoder_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_fused_backward_cuda,
        ms_deform_attn_fused_cuda,
        ms_deform_attn_fused_plain,
    )
    from uni_encoder_tpu_torch.training.matcher import assign_on_host
    from uni_encoder_tpu_torch.training.train_step import Trainer

    # ---------------------------------------------------------------- device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    secs = kernels.build(force=True)
    ptxas = {}
    for name in kernels.SOURCES:
        with open(kernels.build_log_path(name), errors="replace") as f:
            ptxas[name] = [l.strip() for l in f if "Used" in l or "spill" in l]
    k2_frames = ptxas_stack_frames(kernels.build_log_path("ms_deform_attn"), "msda_fused_kernel")
    k3_frames = {k: ptxas_stack_frames(kernels.build_log_path("ms_deform_attn_backward"), k) for k in K3_KERNELS}
    k1_frames = ptxas_stack_frames(kernels.build_log_path("fused_postprocess"), "fused_kernel")
    k1_hmma = sass_count(kernels.library_path("fused_postprocess"), "HMMA")
    emit("build", seconds=time.perf_counter() - t0, per_source=secs, ptxas=ptxas,
         k2_stack_frame_bytes=k2_frames, k3_stack_frame_bytes=k3_frames, k1_stack_frame_bytes=k1_frames,
         k1_sass_hmma=k1_hmma)
    for name, frames in (("K2", k2_frames), *((f"K3 {k}", v) for k, v in k3_frames.items())):
        if not frames or any(frames):
            raise AssertionError(f"{name} stack frames {frames}: expected 0 bytes for every instantiation")
    if k1_hmma == 0:
        raise AssertionError("K1's SASS holds no HMMA: the semantic product is not on tensor cores")

    results = {}

    # ------------------------------------------------- K1 against its plain
    Q, K, h, w = 150, 19, SEG_H // 4, SEG_W // 4
    cls, masks = blobby(0, Q, K, h, w)
    cls, masks = cls.to(dev), masks.to(dev, torch.bfloat16)
    thing = torch.isin(torch.arange(K), torch.arange(11, 19)).to(dev)
    kw = dict(object_mask_threshold=0.3, overlap_threshold=0.5, topk=Q)
    got = fused_multitask_inference(cls, masks, thing, **kw)
    ref = fused_multitask_inference_plain(cls, masks, thing, **kw)
    k1 = compare_post(got, ref, 3e-3)
    again = [fused_multitask_inference(cls, masks, thing, **kw) for _ in range(2)]
    for k in got:
        if not (torch.equal(got[k], again[0][k]) and torch.equal(got[k], again[1][k])):
            raise AssertionError(f"K1 rerun is not byte-identical in {k}")
    # `ms` is the kernel's wrapper alone, on the arguments the served
    # function's prologue gives it: the work `bound_ms` describes;
    # `function_ms` is the whole function, prologue and epilogue included
    k_args = fused_postprocess_inputs(cls, masks, kw["object_mask_threshold"])[3]
    k1_ms = cuda_ms(lambda: fused_postprocess_cuda(*k_args), 20)
    k1_function_ms = cuda_ms(lambda: fused_multitask_inference(cls, masks, thing, **kw), 20)
    k1_plain_ms = cuda_ms(lambda: fused_multitask_inference_plain(cls, masks, thing, **kw), 3)
    del ref, again, k_args
    torch.cuda.empty_cache()
    k1["deterministic_reruns"] = 2
    k1["kept_queries"] = int(got["is_new_segment"].sum().item())
    k1_fields = bound_fields(*k1_bound(Q, K, h, w))
    emit("k1_vs_plain", shape={"Q": Q, "K": K, "h": h, "w": w}, ms=k1_ms, function_ms=k1_function_ms,
         plain_ms=k1_plain_ms, bound_ms_all_on_cuda_cores=k1_fields["bound_ms"],
         bound_ms_semantic_on_tf32_tensor_cores=k1_bound_semantic_on_tensor_cores(Q, K, h, w), **k1)
    # the kernel runs its semantic product on TF32 tensor cores, so its bound
    # counts that product at the TF32 rate
    k1_fields["bound_ms"] = k1_bound_semantic_on_tensor_cores(Q, K, h, w)
    results["k1"] = dict(max_abs_err=k1["scores_max_abs_err"], ms=k1_ms, function_ms=k1_function_ms,
                         plain_ms=k1_plain_ms, **k1_fields)

    # K1 at other class counts: each class-group width the kernel is built
    # with (8, 16, 24 at K = 19 above, 32) and the loop over class groups
    # (K > 32, up to 5 groups at Q = 150, K = 133)
    chunks = {}
    for Qc, Kc in ((20, 7), (20, 13), (20, 29), (20, 40), (150, 133)):
        cls, masks = blobby(Kc, Qc, Kc, 16, 32)
        cls, masks = cls.to(dev), masks.to(dev, torch.bfloat16)
        thing = (torch.arange(Kc) >= Kc // 2).to(dev)
        kw = dict(object_mask_threshold=0.3, overlap_threshold=0.5, topk=Qc)
        got = fused_multitask_inference(cls, masks, thing, **kw)
        chunks[f"Q{Qc}_K{Kc}"] = compare_post(got, fused_multitask_inference_plain(cls, masks, thing, **kw), 3e-3)
        if not all(torch.equal(v, fused_multitask_inference(cls, masks, thing, **kw)[k]) for k, v in got.items()):
            raise AssertionError(f"K1 rerun at Q={Qc}, K={Kc} is not byte-identical")
    emit("k1_class_chunks", hw=[16, 32], results=chunks)

    # ------------------------------------------------- K2 against its plain
    # the fused contract: raw offsets and logits, cached ref_abs
    shapes = ((SEG_H // 32, SEG_W // 32), (SEG_H // 16, SEG_W // 16), (SEG_H // 8, SEG_W // 8))
    B, M, D, L, P = 1, 8, 32, 3, 4
    S = sum(a * b for a, b in shapes)
    Lq = S
    g = torch.Generator(device="cpu").manual_seed(1)
    ref_abs = absolute_reference_points(shapes, dev)
    value = torch.randn(B, S, M, D, generator=g).to(dev)
    off, logits = msda_inputs(g, B, Lq, M, L, P, torch.float32, dev)
    err32 = compare_msda(ms_deform_attn_fused_cuda(value, shapes, off, logits, ref_abs),
                         ms_deform_attn_fused_plain(value, shapes, off, logits, ref_abs), fp32=True)
    k2_ms_fp32 = cuda_ms(lambda: ms_deform_attn_fused_cuda(value, shapes, off, logits, ref_abs), 50)
    vb, ob, lb = value.to(torch.bfloat16), off.to(torch.bfloat16), logits.to(torch.bfloat16)
    err16 = compare_msda(ms_deform_attn_fused_cuda(vb, shapes, ob, lb, ref_abs),
                         ms_deform_attn_fused_plain(vb, shapes, ob, lb, ref_abs), fp32=False)
    k2_ms = cuda_ms(lambda: ms_deform_attn_fused_cuda(vb, shapes, ob, lb, ref_abs), 50)
    k2_plain_ms = cuda_ms(lambda: ms_deform_attn_fused_plain(vb, shapes, ob, lb, ref_abs), 5)
    emit("k2_vs_plain", shape={"B": B, "Lq": Lq, "S": S, "M": M, "D": D, "L": L, "P": P},
         fp32_max_abs_err=err32, bf16_max_abs_err=err16, ms=k2_ms, plain_ms=k2_plain_ms, fp32_ms=k2_ms_fp32,
         stack_frame_bytes=k2_frames, tolerance="fp32 atol/rtol 1e-5; bf16 within 1 ulp + 1e-5")
    results["k2"] = dict(max_abs_err=err16, ms=k2_ms, plain_ms=k2_plain_ms, stack_frame_bytes=max(k2_frames),
                         **bound_fields(*k2_bound(B, Lq, S, M, D, L, P, 2)))
    del value, vb, off, ob, logits, lb
    torch.cuda.empty_cache()

    # ------------------------------------------------- K3 against its plain
    # the training shapes: a 512x1024 crop's res5..res3, batch 2, fp32
    TH, TW = Config().input.seg_crop_train
    shapes = ((TH // 32, TW // 32), (TH // 16, TW // 16), (TH // 8, TW // 8))
    B = TRAIN_BATCH
    S = sum(a * b for a, b in shapes)
    Lq = S
    ref_abs = absolute_reference_points(shapes, dev)
    value = torch.randn(B, S, M, D, generator=g).to(dev)
    off, logits = msda_inputs(g, B, Lq, M, L, P, torch.float32, dev)
    grad_out = torch.randn(B, Lq, M * D, generator=g).to(dev)

    def k3(go):
        return ms_deform_attn_fused_backward_cuda(value, shapes, off, logits, ref_abs, go)

    got = k3(grad_out)
    # bitwise deterministic: three reruns give the same bytes in all three
    reruns = [k3(grad_out) for _ in range(3)]
    for i, again in enumerate(reruns):
        for name, a, b in zip(("value", "offsets", "logits"), got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"K3 rerun {i + 1} differs from the first run in grad {name}")
    leaves = [x.clone().requires_grad_(True) for x in (value, off, logits)]
    plain_out = ms_deform_attn_fused_plain(leaves[0], shapes, leaves[1], leaves[2], ref_abs)
    ref = torch.autograd.grad(plain_out, leaves, grad_out, retain_graph=True)
    k3_err = {}
    for name, a, b in zip(("value", "offsets", "logits"), got, ref):
        # fp32 sums of up to a few hundred products in another order than
        # autograd's (d value summed exactly in fixed point, then rounded to
        # fp32 once; d offsets and d logits by shuffles): atol/rtol 1e-4
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=f"K3 grad {name}")
        k3_err[name] = (a - b).abs().max().item()
    # the edge cases: grad_out all zero gives exactly zero gradients; one NaN
    # in grad_out makes all of grad_value NaN, never silent zeros
    zero = k3(torch.zeros_like(grad_out))
    nan_out = grad_out.clone()
    nan_out.view(-1)[nan_out.numel() // 3] = float("nan")
    nan_value = k3(nan_out)[0]
    edge = {"zero_grad_out_gives_zero_gradients": all(bool((x == 0).all()) for x in zero),
            "nan_in_grad_out_gives_nan_grad_value": bool(torch.isnan(nan_value).all())}
    fail_unless("k3_vs_plain", edge)
    k3_ms = cuda_ms(lambda: k3(grad_out), 20)
    k3_plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, leaves, grad_out, retain_graph=True), 5)
    emit("k3_vs_plain", shape={"B": B, "Lq": Lq, "S": S, "M": M, "D": D, "L": L, "P": P}, dtype="float32",
         max_abs_err=k3_err, deterministic_reruns=len(reruns), edge_cases=edge,
         scatter=k3_scatter_rows(shapes, off, logits, ref_abs, M),
         ms=k3_ms, plain_ms=k3_plain_ms, plain="autograd backward of ms_deform_attn_fused_plain",
         stack_frame_bytes=k3_frames,
         tolerance="atol/rtol 1e-4 (fp32 sums in another order); reruns byte-identical",
         **bound_fields(*k3_bound(B, Lq, S, M, D, L, P)))
    results["k3"] = dict(max_abs_err=max(k3_err.values()), ms=k3_ms, plain_ms=k3_plain_ms,
                         stack_frame_bytes=max(max(v) for v in k3_frames.values()), deterministic=True,
                         **bound_fields(*k3_bound(B, Lq, S, M, D, L, P)))
    del value, off, logits, grad_out, got, reruns, leaves, plain_out, ref, zero, nan_out, nan_value
    torch.cuda.empty_cache()

    # ------------------------------------------- serve three full-width requests
    cfg = Config().model
    t0 = time.perf_counter()
    model = UniEncoder(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    with torch.no_grad():
        # random class logits are flat over 20 classes and no query would clear
        # the 0.8 keep threshold; a sharper head keeps some, so the panoptic
        # path has segments to build (as in tests/test_torch_port_slice.py)
        model.predictor.class_embed.weight.mul_(8.0)
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(1, SEG_H, SEG_W, 3).astype(np.float32)).to(dev, torch.bfloat16)
    tokens = torch.tensor([tokenize_task(TASK)], dtype=torch.int64, device=dev)
    thing = torch.isin(torch.arange(cfg.sem_seg_head.num_classes), torch.arange(11, 19)).to(dev)

    def request():
        return serve_segmentation(model, images, tokens, thing)

    t0 = time.perf_counter()
    request()  # warm-up: cuBLAS/cuDNN handles, kernel libraries, allocator
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3

    reset_launches(fused_postprocess_cuda, ms_deform_attn_fused_cuda)
    request_ms = []
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        out, posts = request()
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"k1": fused_postprocess_cuda.launches, "k2": ms_deform_attn_fused_cuda.launches}

    post = posts[0]
    Qm = cfg.one_former.num_object_queries
    checks = {
        "pred_logits": tuple(out["pred_logits"].shape) == (1, Qm, cfg.sem_seg_head.num_classes + 1),
        "pred_masks": tuple(out["pred_masks"].shape) == (1, Qm, SEG_H // 4, SEG_W // 4),
        "maps_u8": all(post[k].dtype == torch.uint8 and tuple(post[k].shape) == (SEG_H, SEG_W)
                       for k in ("sem_seg_argmax", "panoptic_seg")),
        "finite_logits": bool(torch.isfinite(out["pred_logits"]).all() and torch.isfinite(out["pred_masks"]).all()),
        "finite_scores": bool(torch.isfinite(post["scores"]).all()),
        "k1_launches": launches["k1"] == N_REQUESTS,
        "k2_launches": launches["k2"] == N_REQUESTS * cfg.sem_seg_head.transformer_enc_layers,
    }
    emit("serve", requests=N_REQUESTS, image=[1, SEG_H, SEG_W, 3], dtype="bfloat16", task=TASK,
         request_ms=request_ms, warmup_ms=warmup_ms, model_build_s=build_s, launches=launches, checks=checks,
         kept_queries=int(post["is_new_segment"].sum().item()),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")

    # --------------- where a request's time goes: stage by stage, then traced
    # CUDA events recorded as each stage's module is entered (and as the
    # query decoder returns), and after the post-process
    marks = []

    def mark(*_):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    handles = [m.register_forward_pre_hook(mark)
               for m in (model.task_mlp, model.backbone, model.pixel_decoder, model.predictor)]
    handles.append(model.predictor.register_forward_hook(mark))
    stage_ms = {s: [] for s in STAGES}
    wall_ms = []
    for _ in range(N_TIMED):
        marks.clear()
        t0 = time.perf_counter()
        request()
        mark()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        if len(marks) != len(STAGES) + 1:
            raise AssertionError(f"{len(marks)} stage marks in one request, expected {len(STAGES) + 1}")
        for i, s in enumerate(STAGES):
            stage_ms[s].append(marks[i].elapsed_time(marks[i + 1]))
    for hd in handles:
        hd.remove()
    wall_median = float(np.median(wall_ms))
    emit("stages", requests=N_TIMED, request_wall_ms=wall_ms, request_wall_ms_median=wall_median,
         stage_ms_median={s: float(np.median(v)) for s, v in stage_ms.items()}, card=smi)

    # the profiler slows the host, not the card: the traced wall time is
    # longer than an untraced request, so the busy share is given both ways
    prof = profile_device(request, N_PROFILED, wall_median)
    emit("profile", requests=N_PROFILED, kernel_ms_per_request=prof["kernel_ms"],
         traced_wall_ms_per_request=prof["traced_wall_ms"], busy_share_traced=prof["busy_share_traced"],
         busy_share_untraced=prof["busy_share_untraced"], kernel_launches_per_request=prof["kernel_launches"],
         top_kernels_ms_per_request=prof["top_kernels_ms"], card=smi)

    # ------------------------- the kernels on the served request's own tensors
    pd = model.pixel_decoder
    with torch.inference_mode():
        src, pos, ref_abs, shapes = pd.encode(model.backbone(images))
        attn0 = pd.transformer.encoder.layers[0].self_attn
        value = attn0.value_proj(src).view(src.shape[0], src.shape[1], attn0.n_heads, -1)
        off = attn0.sampling_offsets(src + pos)
        logits = attn0.attention_weights(src + pos)
    k2_err = compare_msda(ms_deform_attn_fused_cuda(value, shapes, off, logits, ref_abs),
                          ms_deform_attn_fused_plain(value, shapes, off, logits, ref_abs), fp32=False)
    logits, masks = out["pred_logits"][0], out["pred_masks"][0]
    kw = dict(object_mask_threshold=0.8, overlap_threshold=0.8, topk=150)
    k1_real = compare_post(fused_multitask_inference(logits, masks, thing, **kw),
                           fused_multitask_inference_plain(logits, masks, thing, **kw), 3e-3)
    emit("kernels_on_served_tensors", k2_layer0_bf16_max_abs_err=k2_err,
         k2_shape=list(value.shape), k1=k1_real, k1_kept_queries=int(post["is_new_segment"].sum().item()),
         k1_panoptic_pixels=int((post["panoptic_seg"] > 0).sum().item()))

    # --------- small input: the GPU path against the port's CPU path, fp32
    # (the CPU path is the one tests/test_torch_port_*.py hold against JAX)
    small = torch.from_numpy(rng.randn(1, 128, 256, 3).astype(np.float32))
    outs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        m = UniEncoder(cfg, device=d, dtype=torch.float32, seed=0)
        with torch.no_grad():
            m.predictor.class_embed.weight.mul_(8.0)
        with torch.inference_mode():
            outs[name] = m.forward_segmentation(small.to(d), tokens.to(d))
        del m
    errs = {}
    for k in ("pred_logits", "pred_masks"):
        a, b = outs["cuda"][k].cpu(), outs["cpu"][k]
        # fp32 with TF32 off; cuBLAS/cuDNN sum in other orders than the CPU
        torch.testing.assert_close(a, b, atol=5e-3, rtol=1e-3)
        errs[k] = (a - b).abs().max().item()
    emit("reference_small", image=[1, 128, 256, 3], dtype="float32", max_abs_err=errs,
         tolerance="atol 5e-3, rtol 1e-3")
    del outs

    # ------------------- the sequence request: a 192x512 two-frame pair, bf16
    seq_rng = np.random.RandomState(0)
    cur, prev = (torch.from_numpy(seq_rng.randn(1, SEQ_H, SEQ_W, 3).astype(np.float32)).to(dev, torch.bfloat16)
                 for _ in range(2))

    def seq_request():
        return serve_sequence(model, cur, prev)

    t0 = time.perf_counter()
    seq_request()
    torch.cuda.synchronize()
    seq_warmup_ms = (time.perf_counter() - t0) * 1e3
    reset_launches(fused_postprocess_cuda, ms_deform_attn_fused_cuda)
    seq_ms = []
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        seq_out = seq_request()
        torch.cuda.synchronize()
        seq_ms.append((time.perf_counter() - t0) * 1e3)
    seq_launches = {"k1": fused_postprocess_cuda.launches, "k2": ms_deform_attn_fused_cuda.launches}
    checks = check_sequence_outputs(seq_out, 1, SEQ_H, SEQ_W)
    checks["no_k1_k2_launches"] = seq_launches == {"k1": 0, "k2": 0}
    emit("sequence", requests=N_REQUESTS, image=[1, SEQ_H, SEQ_W, 3], dtype="bfloat16", request_ms=seq_ms,
         warmup_ms=seq_warmup_ms, launches=seq_launches, checks=checks,
         disp_range=[seq_out["disp"].min().item(), seq_out["disp"].max().item()],
         cam_T_cam=seq_out["cam_T_cam"][0].float().tolist(), card=smi)
    fail_unless("sequence", checks)

    # operations of one request by stage (convolutions and matrix products;
    # the two motion decoders share a class, so they count together), then
    # the stages timed by CUDA events as each is entered, and at the end
    with FlopCounterMode(display=False) as flops:
        seq_request()
    by_module = flops.get_flop_counts()
    seq_gflop = {name: sum(by_module.get(cls, {}).values()) / 1e9 for name, cls in (
        ("backbone_2b", "SwinTransformer"), ("pose_decoder", "ResNetLikePoseDecoder"),
        ("motion_decoder_and_motion_mask", "MotionDecoderV2"), ("depth_decoder", "TransDSSL"),
        ("depth_refinenet0", "TransDSSL.layers.refinenet0"), ("depth_output_conv", "TransDSSL.layers.output_conv"))}
    seq_gflop["total"] = flops.get_total_flops() / 1e9
    handles = [getattr(model, name).register_forward_pre_hook(mark) for name in SEQ_STAGES]
    seq_stage_ms = {s: [] for s in SEQ_STAGES}
    seq_wall_ms = []
    for _ in range(N_TIMED):
        marks.clear()
        t0 = time.perf_counter()
        seq_request()
        mark()
        torch.cuda.synchronize()
        seq_wall_ms.append((time.perf_counter() - t0) * 1e3)
        if len(marks) != len(SEQ_STAGES) + 1:
            raise AssertionError(f"{len(marks)} stage marks in one sequence request, expected {len(SEQ_STAGES) + 1}")
        for i, s in enumerate(SEQ_STAGES):
            seq_stage_ms[s].append(marks[i].elapsed_time(marks[i + 1]))
    for hd in handles:
        hd.remove()
    seq_wall_median = float(np.median(seq_wall_ms))
    prof = profile_device(seq_request, N_PROFILED, seq_wall_median)
    emit("sequence_stages", requests=N_TIMED, request_wall_ms=seq_wall_ms, request_wall_ms_median=seq_wall_median,
         stage_ms_median={s: float(np.median(v)) for s, v in seq_stage_ms.items()},
         gflop=seq_gflop, gflop_counts="torch.utils.flop_counter: convolutions and matrix products",
         profiled_requests=N_PROFILED, kernel_ms_per_request=prof["kernel_ms"],
         busy_share_traced=prof["busy_share_traced"], busy_share_untraced=prof["busy_share_untraced"],
         kernel_launches_per_request=prof["kernel_launches"], top_kernels_ms_per_request=prof["top_kernels_ms"],
         card=smi)

    # --------------- bench.py's frame: one segmentation + one sequence request
    def frame():
        return request(), seq_request()

    frame()
    reset_launches(fused_postprocess_cuda, ms_deform_attn_fused_cuda)
    frame_ms = []
    for _ in range(N_FRAMES):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    frame_launches = {"k1": fused_postprocess_cuda.launches, "k2": ms_deform_attn_fused_cuda.launches}
    frame_median = float(np.median(frame_ms))
    prof = profile_device(frame, N_PROFILED, frame_median)
    checks = {"k1_launches": frame_launches["k1"] == N_FRAMES,
              "k2_launches": frame_launches["k2"] == N_FRAMES * cfg.sem_seg_head.transformer_enc_layers}
    emit("frame", frames=N_FRAMES, frame_wall_ms=frame_ms, frame_wall_ms_median=frame_median,
         frames_per_s=1e3 / frame_median, launches=frame_launches, checks=checks, profiled_frames=N_PROFILED,
         kernel_ms_per_frame=prof["kernel_ms"], traced_wall_ms_per_frame=prof["traced_wall_ms"],
         busy_share_traced=prof["busy_share_traced"], busy_share_untraced=prof["busy_share_untraced"],
         kernel_launches_per_frame=prof["kernel_launches"], top_kernels_ms_per_frame=prof["top_kernels_ms"],
         card=smi)
    fail_unless("frame", checks)

    # ---------------- the Predictor from uint8 images, through the serving pool
    predictor = Predictor(Config(), model)
    predictor.set_thing_ids(THING_IDS)
    u8 = np.random.RandomState(2)
    seg_items = [{"image": u8.randint(0, 256, (SEG_H, SEG_W, 3), np.uint8), "height": SEG_H, "width": SEG_W,
                  "task_tokens": np.asarray(tokenize_task(TASK), np.int64), "index": i} for i in range(N_SERVED)]
    seq_items = [{"image": u8.randint(0, 256, (SEQ_H, SEQ_W, 3), np.uint8),
                  "prev_image": u8.randint(0, 256, (SEQ_H, SEQ_W, 3), np.uint8), "index": i}
                 for i in range(N_SERVED)]

    def serve_all(infer, items):
        """Submit every item to a pool of batch size 1 and read the results
        in submission order; each result carries its item's index. The pool
        first serves the first item once untimed: its thread's first call
        creates that thread's cuBLAS and cuDNN handles. Returns the results
        and the time between consecutive results (ms)."""
        pool = AsyncBatchedPredictor(per_item(lambda item: dict(infer(item), index=int(item["index"]))),
                                     batch_size=1, device=dev)
        try:
            pool(items[0])
            t0 = time.perf_counter()
            futs = [pool.submit(it) for it in items]
            results, done_ms = [], []
            for f in futs:
                results.append(f.result(timeout=300))
                done_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            pool.shutdown()
        return results, [b - a for a, b in zip([0.0] + done_ms, done_ms)]

    seg_res, seg_item_ms = serve_all(predictor.infer_segmentation, seg_items)
    seq_res, seq_item_ms = serve_all(predictor.infer_sequence, seq_items)
    # one segmentation item traced: how much of it the device works
    seg_prof = profile_device(lambda: predictor.infer_segmentation(seg_items[0]), 1, float(np.median(seg_item_ms)))
    K = cfg.sem_seg_head.num_classes
    checks = {"segmentation_order": [r["index"] for r in seg_res] == list(range(N_SERVED)),
              "sequence_order": [r["index"] for r in seq_res] == list(range(N_SERVED))}
    for i, r in enumerate(seg_res):
        pan, infos = r["panoptic_seg"]
        inst = r["instances"]
        n = len(inst["scores"])
        checks[f"segmentation_{i}"] = (
            sorted(r) == ["index", "instances", "panoptic_seg", "sem_seg"]
            and r["sem_seg"].dtype == np.float32 and r["sem_seg"].shape == (K, SEG_H, SEG_W)
            and bool(np.isfinite(r["sem_seg"]).all())
            and pan.dtype == np.int32 and pan.shape == (SEG_H, SEG_W)
            and {s["id"] for s in infos} == set(np.unique(pan[pan > 0]).tolist())
            and sorted(inst) == ["boxes", "labels", "masks", "query_indices", "scores"]
            and inst["masks"].dtype == np.bool_ and inst["masks"].shape == (n, SEG_H, SEG_W)
            and inst["boxes"].shape == (n, 4) and bool(np.isfinite(inst["scores"]).all())
            and set(inst["labels"].tolist()) <= set(THING_IDS))
    for i, r in enumerate(seq_res):
        checks[f"sequence_{i}"] = (
            sorted(r) == ["cam_T_cam", "complete_flow", "disp_results", "index", "motion_mask"]
            and r["disp_results"].shape == (SEQ_H, SEQ_W) and r["motion_mask"].shape == (SEQ_H, SEQ_W)
            and r["complete_flow"].shape == (SEQ_H, SEQ_W, 3) and r["cam_T_cam"].shape == (4, 4)
            and all(r[k].dtype == np.float32 and bool(np.isfinite(r[k]).all())
                    for k in ("disp_results", "motion_mask", "complete_flow", "cam_T_cam")))
    emit("predictor", batch_size=1, segmentation_items=N_SERVED, sequence_items=N_SERVED,
         segmentation_item_ms=seg_item_ms, sequence_item_ms=seq_item_ms,
         segmentation_item_kernel_ms=seg_prof["kernel_ms"],
         segmentation_item_busy_share_untraced=seg_prof["busy_share_untraced"],
         segmentation_item_top_kernels_ms=seg_prof["top_kernels_ms"],
         segments=[len(r["panoptic_seg"][1]) for r in seg_res],
         instances=[len(r["instances"]["scores"]) for r in seg_res], checks=checks, card=smi)
    fail_unless("predictor", checks)
    del predictor, seg_res, seq_res
    torch.cuda.empty_cache()

    # ------ small sequence input: the GPU path against the port's CPU path, fp32
    small_rng = np.random.RandomState(3)
    small_pair = [torch.from_numpy(small_rng.randn(1, 96, 320, 3).astype(np.float32)) for _ in range(2)]
    outs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        m = UniEncoder(cfg, device=d, dtype=torch.float32, seed=0)
        outs[name] = serve_sequence(m, *(x.to(d) for x in small_pair))
        del m
    errs = {}
    for k in ("disp", "motion_mask", "complete_flow", "axisangle", "translation", "cam_T_cam"):
        a, b = outs["cuda"][k].cpu(), outs["cpu"][k]
        # fp32 with TF32 off; cuDNN sums in other orders than the CPU
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)
        errs[k] = (a - b).abs().max().item()
    emit("sequence_reference_small", image=[1, 96, 320, 3], dtype="float32", max_abs_err=errs,
         tolerance="atol 1e-4, rtol 1e-3")
    del model, outs
    torch.cuda.empty_cache()

    # --------------- training: Trainer at full width on a synthetic batch, fp32
    train_cfg = Config()
    n_texts = train_cfg.model.one_former.num_object_queries - train_cfg.model.text_encoder.n_ctx
    trainer = Trainer(train_cfg, device=dev)
    t0 = time.perf_counter()
    state = trainer.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    seg_b, seq_b = train_batches(0, TRAIN_BATCH, train_cfg.input.seg_crop_train, train_cfg.input.depth_hw_train,
                                 TRAIN_SLOTS, TRAIN_VALID, n_texts, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    named = dict(state.model.named_parameters())
    watched0 = {n: named[n].detach().clone() for n in WATCHED}
    stats0 = {n: b.clone() for n, b in state.model.named_buffers() if n.endswith(("running_mean", "running_var"))}

    def train_step():
        return trainer.train_step(state, seg_b, seq_b, gen)[1]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_step()  # warm-up: cuBLAS/cuDNN plans, the allocator
    torch.cuda.synchronize()
    train_warmup_ms = (time.perf_counter() - t0) * 1e3
    reset_launches(fused_postprocess_cuda, ms_deform_attn_fused_cuda, ms_deform_attn_fused_backward_cuda)
    copies0, assignments0 = assign_on_host.copies, assign_on_host.assignments
    step_wall_ms, step_event_ms, step_metrics = [], [], []
    for _ in range(N_TRAIN_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step_metrics.append(train_step())
        end.record()
        torch.cuda.synchronize()
        step_wall_ms.append((time.perf_counter() - t0) * 1e3)
        step_event_ms.append(start.elapsed_time(end))
    train_launches = {"k1": fused_postprocess_cuda.launches, "k2": ms_deform_attn_fused_cuda.launches,
                      "k3": ms_deform_attn_fused_backward_cuda.launches}
    host_copies = assign_on_host.copies - copies0
    assignments = assign_on_host.assignments - assignments0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_median = float(np.median(step_wall_ms))
    prof = profile_device(train_step, 1, step_median)
    enc_layers = train_cfg.model.sem_seg_head.transformer_enc_layers
    losses = {k: [float(m[k]) for m in step_metrics] for k in step_metrics[0]}
    checks = {
        "losses_finite": all(np.isfinite(v).all() for v in losses.values()),
        "params_moved": all(not torch.equal(named[n], watched0[n]) for n in WATCHED),
        "bn_stats_changed": all(not torch.equal(b, stats0[n]) for n, b in state.model.named_buffers()
                                if n in stats0),
        "step_count": state.step == 1 + N_TRAIN_TIMED + 1 and state.opt.count == state.step,
        "k1_launches": train_launches["k1"] == 0,
        "k2_launches": train_launches["k2"] == N_TRAIN_TIMED * enc_layers,
        "k3_launches": train_launches["k3"] == N_TRAIN_TIMED * enc_layers,
        "one_host_copy_per_step": host_copies == N_TRAIN_TIMED,
        "assignments": assignments == N_TRAIN_TIMED * TRAIN_BATCH * trainer.n_prediction_sets(),
    }
    emit("train", batch={"segmentation": [TRAIN_BATCH, *train_cfg.input.seg_crop_train, 3],
                         "sequence": [TRAIN_BATCH, 3, *train_cfg.input.depth_hw_train, 3],
                         "target_slots": TRAIN_SLOTS, "valid": TRAIN_VALID, "texts": n_texts},
         dtype="float32", tf32=False, parameters=sum(p.numel() for p in named.values()), init_s=init_s,
         warmup_ms=train_warmup_ms, steps_timed=N_TRAIN_TIMED, step_wall_ms=step_wall_ms,
         step_event_ms=step_event_ms, step_wall_ms_median=step_median,
         kernel_ms_per_step=prof["kernel_ms"], traced_wall_ms_per_step=prof["traced_wall_ms"],
         busy_share_traced=prof["busy_share_traced"], busy_share_untraced=prof["busy_share_untraced"],
         kernel_launches_per_step=prof["kernel_launches"], top_kernels_ms_per_step=prof["top_kernels_ms"],
         launches=train_launches, matcher_host_copies=host_copies, matcher_assignments=assignments,
         peak_memory_gb=peak_gb, steps_taken=state.step, losses=losses, checks=checks, card=smi)
    fail_unless("train", checks)
    del trainer, state, named, watched0, stats0, seg_b, seq_b, step_metrics
    torch.cuda.empty_cache()

    # ---- small input: one training step on the GPU against the CPU path, fp32
    # with TF32 off, the same weights (seed 0) and the same draws
    def small_step_errors(phase, got, ref):
        """Losses within atol 1e-4 + rtol 1e-3 and the WATCHED gradients
        within 1e-3 relative norm (cuBLAS/cuDNN sum in other orders than
        the CPU, or than their deterministic algorithms); returns both."""
        loss_err, grad_err = {}, {}
        for k, r in ref[0].items():
            if not abs(got[0][k] - r) <= 1e-4 + 1e-3 * abs(r):
                raise AssertionError(f"{phase} {k}: {got[0][k]} against {r}")
            loss_err[k] = abs(got[0][k] - r)
        for n in WATCHED:
            a, b = got[1][n], ref[1][n]
            grad_err[n] = ((a - b).norm() / b.norm()).item()
            if not grad_err[n] < 1e-3:
                raise AssertionError(f"{phase} grad {n}: relative error {grad_err[n]}")
        return loss_err, grad_err

    small = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        m, grads, _ = small_train_step(Trainer, train_cfg, d)
        small[name] = ({k: float(v) for k, v in m.items()}, {n: v.cpu() for n, v in grads.items()})
        del m, grads
    loss_err, grad_err = small_step_errors("train_reference_small", small["cuda"], small["cpu"])
    emit("train_reference_small", segmentation=[TRAIN_BATCH, 128, 256, 3], sequence=[TRAIN_BATCH, 3, 64, 128, 3],
         dtype="float32", loss_abs_err=loss_err, grad_relative_norm_err=grad_err,
         tolerance="losses atol 1e-4 + rtol 1e-3; gradients |cuda - cpu| / |cpu| < 1e-3")

    # ---- the same step in two processes, deterministic: the same bytes
    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    paths = [os.path.join(os.path.dirname(kernels.BUILD_DIR), f"train_deterministic_{i}.pt") for i in range(2)]
    for path in paths:
        child = subprocess.run([sys.executable, os.path.abspath(__file__), DETERMINISTIC_CHILD, path], env=env,
                               capture_output=True, text=True, timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"train_deterministic child exited {child.returncode}:\n{child.stderr[-4000:]}")
    runs = [torch.load(path) for path in paths]
    equal = {group: all(runs[0][group][k].numpy().tobytes() == runs[1][group][k].numpy().tobytes()
                        for k in runs[0][group]) and sorted(runs[0][group]) == sorted(runs[1][group])
             for group in ("losses", "grads", "params")}
    # and a child's deterministic step against this process's default one
    det = ({k: float(v) for k, v in runs[0]["losses"].items()}, runs[0]["grads"])
    det_loss_err, det_grad_err = small_step_errors("train_deterministic", det, small["cuda"])
    emit("train_deterministic", children=len(paths), cublas_workspace_config=env["CUBLAS_WORKSPACE_CONFIG"],
         child_step_s=[r["seconds"] for r in runs], byte_equal=equal,
         compared={"losses": len(runs[0]["losses"]), "grads": len(runs[0]["grads"]),
                   "params": len(runs[0]["params"]),
                   "param_elements": sum(v.numel() for v in runs[0]["params"].values())},
         vs_default_step={"loss_abs_err": det_loss_err, "grad_relative_norm_err": det_grad_err},
         seconds=time.perf_counter() - t0, card=smi)
    fail_unless("train_deterministic", equal)
    del small, runs
    for path in paths:
        os.remove(path)

    # ---------------- the training entry point: the production config, full
    # width and depth, on a synthetic full-size tree (the train phase's state
    # is gone: two of its 52 GB training states do not fit the card)
    train_entry_launches = train_entry_phase(dev, smi)
    torch.cuda.empty_cache()

    # ---------------- the evaluation entry point on synthetic full-size data
    # (last: the shape-keyed device constants of its TTA scales stay cached)
    eval_launches = eval_phase(dev, smi)

    print(smi, flush=True)
    rows = []
    # K1 and K2 launches are the served requests' (phase serve), K3's the
    # timed training steps' (phase train); train_entry_launches those of the
    # train_torch run (phase train_entry), eval_launches those of the two
    # evaluate_torch runs (phase eval)
    launches["k3"] = train_launches["k3"]
    for key, name, source, replaces in (
        ("k1", "fused_multitask_inference", "uni_encoder_tpu_torch/kernels/csrc/fused_postprocess.cu",
         "uni_encoder_tpu/inference/fused_postprocess.py:61"),
        ("k2", "ms_deform_attn_fused", "uni_encoder_tpu_torch/kernels/csrc/ms_deform_attn.cu",
         "uni_encoder_tpu/ops/ms_deform_attn.py:73"),
        ("k3", "ms_deform_attn_fused_backward", "uni_encoder_tpu_torch/kernels/csrc/ms_deform_attn_backward.cu",
         "uni_encoder_tpu/training/train_step.py:340"),
    ):
        r = results[key]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[key],
                     "train_entry_launches": train_entry_launches[key],
                     "eval_launches": {task: n.get(key, 0) for task, n in eval_launches.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": None,
                     **{k: r[k] for k in ("function_ms", "stack_frame_bytes", "deterministic") if k in r}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == DETERMINISTIC_CHILD:
        train_deterministic_child(sys.argv[2])
    else:
        main()
