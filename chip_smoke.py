"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
CUDA kernels from this checkout, holds each against its plain PyTorch version
at the main path's shapes, serves three full-width 1024x2048 segmentation
requests through the port's entry points, and reports per-kernel times.

    python3 chip_smoke.py

Phases, one JSON line each: device, build, k1_vs_plain, k1_class_chunks,
k2_vs_plain, serve, stages, profile, kernels_on_served_tensors,
reference_small. Then the card's name and power limit as
nvidia-smi reports them, the {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Any failure raises and the script exits
non-zero without the last line. It needs a CUDA card and the repository's
`uni_encoder_tpu_torch` package beside it; it imports nothing of JAX.

Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of HBM and 67 TFLOP/s
of fp32 outside the tensor cores (at the 700 W power limit); K1's bound is
also given with its semantic product on TF32 tensor cores (495 TFLOP/s).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

SEG_H, SEG_W = 1024, 2048
N_REQUESTS = 3  # served with the kernels' launch counts read
N_TIMED = 10  # timed stage by stage
N_PROFILED = 3  # under torch.profiler
STAGES = ("task_mlp", "backbone", "pixel_decoder", "predictor", "postprocess")
TASK = "The task is panoptic"


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


def k2_bound(B, Lq, S, M, D, L, P, value_bytes):
    nbytes = B * S * M * D * value_bytes + B * Lq * M * L * P * 3 * 4 + B * Lq * M * D * value_bytes
    flops = B * Lq * M * L * P * (8 * D + 20)  # 4 corners x D fused multiply-adds + weights
    return nbytes, flops


def bound_fields(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from uni_encoder_tpu_torch import kernels
    from uni_encoder_tpu_torch.config import Config
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.inference.fused_postprocess import (
        fused_multitask_inference,
        fused_multitask_inference_plain,
        fused_postprocess_cuda,
    )
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_cuda, ms_deform_attn_plain

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
    emit("build", seconds=time.perf_counter() - t0, per_source=secs, ptxas=ptxas)

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
    k1_ms = cuda_ms(lambda: fused_multitask_inference(cls, masks, thing, **kw), 20)
    k1_plain_ms = cuda_ms(lambda: fused_multitask_inference_plain(cls, masks, thing, **kw), 3)
    del ref, again
    torch.cuda.empty_cache()
    k1["deterministic_reruns"] = 2
    k1["kept_queries"] = int(got["is_new_segment"].sum().item())
    emit("k1_vs_plain", shape={"Q": Q, "K": K, "h": h, "w": w}, ms=k1_ms, plain_ms=k1_plain_ms,
         bound_ms_semantic_on_tf32_tensor_cores=k1_bound_semantic_on_tensor_cores(Q, K, h, w), **k1)
    results["k1"] = dict(max_abs_err=k1["scores_max_abs_err"], ms=k1_ms, plain_ms=k1_plain_ms,
                         **bound_fields(*k1_bound(Q, K, h, w)))

    # K1 at other class counts: each register chunk the kernel is built with
    # (8, 16, 24 at K = 19 above, 32), the loop over class chunks (K > 32),
    # and more than 48 KB of shared memory (Q = 150, K = 133)
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
    shapes = ((SEG_H // 32, SEG_W // 32), (SEG_H // 16, SEG_W // 16), (SEG_H // 8, SEG_W // 8))
    B, M, D, L, P = 1, 8, 32, 3, 4
    S = sum(a * b for a, b in shapes)
    Lq = S
    g = torch.Generator(device="cpu").manual_seed(1)
    value = torch.randn(B, S, M, D, generator=g).to(dev)
    wh = torch.tensor([[b, a] for a, b in shapes], dtype=torch.float32)
    loc = (torch.rand(B, Lq, M, L, P, 2, generator=g) * 1.4 - 0.2)  # some out of range
    loc = (loc * wh[None, None, None, :, None, :] - 0.5).to(dev).contiguous()
    attw = torch.rand(B, Lq, M, L, P, generator=g)
    attw = (attw / attw.sum(dim=(3, 4), keepdim=True)).to(dev).contiguous()
    err32 = compare_msda(ms_deform_attn_cuda(value, shapes, loc, attw),
                         ms_deform_attn_plain(value, shapes, loc, attw), fp32=True)
    vb = value.to(torch.bfloat16)
    err16 = compare_msda(ms_deform_attn_cuda(vb, shapes, loc, attw),
                         ms_deform_attn_plain(vb, shapes, loc, attw), fp32=False)
    k2_ms = cuda_ms(lambda: ms_deform_attn_cuda(vb, shapes, loc, attw), 50)
    k2_plain_ms = cuda_ms(lambda: ms_deform_attn_plain(vb, shapes, loc, attw), 5)
    k2_ms_fp32 = cuda_ms(lambda: ms_deform_attn_cuda(value, shapes, loc, attw), 50)
    emit("k2_vs_plain", shape={"B": B, "Lq": Lq, "S": S, "M": M, "D": D, "L": L, "P": P},
         fp32_max_abs_err=err32, bf16_max_abs_err=err16, ms=k2_ms, plain_ms=k2_plain_ms, fp32_ms=k2_ms_fp32,
         tolerance="fp32 atol/rtol 1e-5; bf16 within 1 ulp + 1e-5")
    results["k2"] = dict(max_abs_err=err16, ms=k2_ms, plain_ms=k2_plain_ms,
                         **bound_fields(*k2_bound(B, Lq, S, M, D, L, P, 2)))
    del value, vb, loc, attw
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
        out = model.forward_segmentation(images, tokens)
        post = [fused_multitask_inference(out["pred_logits"][b], out["pred_masks"][b], thing,
                                          object_mask_threshold=0.8, overlap_threshold=0.8, topk=150)
                for b in range(images.shape[0])]
        return out, post

    t0 = time.perf_counter()
    request()  # warm-up: cuBLAS/cuDNN handles, kernel libraries, allocator
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3

    fused_postprocess_cuda.launches = 0
    ms_deform_attn_cuda.launches = 0
    request_ms = []
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        out, posts = request()
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"k1": fused_postprocess_cuda.launches, "k2": ms_deform_attn_cuda.launches}

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

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(N_PROFILED):
            request()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / N_PROFILED
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / N_PROFILED
    top = sorted(on_device, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    # the profiler slows the host, not the card: the traced wall time is
    # longer than an untraced request, so the busy share is given both ways
    emit("profile", requests=N_PROFILED, kernel_ms_per_request=kernel_ms,
         traced_wall_ms_per_request=traced_ms, busy_share_traced=kernel_ms / traced_ms,
         busy_share_untraced=kernel_ms / wall_median,
         kernel_launches_per_request=sum(e.count for e in on_device) / N_PROFILED,
         top_kernels_ms_per_request={e.key[:90]: e.self_device_time_total / 1e3 / N_PROFILED for e in top},
         card=smi)

    # ------------------------- the kernels on the served request's own tensors
    pd = model.pixel_decoder
    with torch.no_grad():
        src, pos, ref_abs, shapes = pd.encode(model.backbone(images))
        attn0 = pd.transformer.encoder.layers[0].self_attn
        value = attn0.value_proj(src).view(src.shape[0], src.shape[1], attn0.n_heads, -1)
        loc, attw = attn0.sampling_inputs(src + pos, ref_abs)
    k2_err = compare_msda(ms_deform_attn_cuda(value, shapes, loc, attw),
                          ms_deform_attn_plain(value, shapes, loc, attw), fp32=False)
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

    print(smi, flush=True)
    rows = []
    for key, name, source, replaces in (
        ("k1", "fused_multitask_inference", "uni_encoder_tpu_torch/kernels/csrc/fused_postprocess.cu",
         "uni_encoder_tpu/inference/fused_postprocess.py:61"),
        ("k2", "ms_deform_attn", "uni_encoder_tpu_torch/kernels/csrc/ms_deform_attn.cu",
         "uni_encoder_tpu/ops/ms_deform_attn.py:73"),
    ):
        r = results[key]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
