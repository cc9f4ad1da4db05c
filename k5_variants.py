"""Variants of K5 (the neighborhood-attention backward kernel) built from the
checked-in source and held against it on one CUDA card.

    python3 k5_variants.py [--out build/k5_variants]

Each variant is the source of
`uni_encoder_tpu_torch/kernels/csrc/neighborhood_attention_backward.cu` with
a few lines replaced:

  1xTF32      each product is big*big only (the small terms dropped): what
              one TF32 product per term gives
  3 blocks,   __launch_bounds__ asking for 3 or 4 blocks of 4 warps an SM
  4 blocks    (168 and 128 registers a thread)
  unroll 1    the column loops of both passes not unrolled (the build
              unrolls them by two)

Every variant is compiled with the build's nvcc flags, all at once. For
each the script prints ptxas's registers and spills, its error against
autograd of the plain version as a multiple of the tolerance `k5_vs_plain`
holds (dqkv atol 2e-5 + rtol 1e-4) at unit-scale shapes and at q and k 4x
larger (the plain fp32 version's own error against float64 beside it), and
its time (CUDA events, 20 calls back to back) at the crop's stage 0 and
summed over the 60 launches of a DiNAT-L training step, the checked-in
build beside it in the same process. Imports neither jax nor the JAX
package.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from uni_encoder_tpu_torch import kernels  # noqa: E402
from uni_encoder_tpu_torch.config import load_config  # noqa: E402
from uni_encoder_tpu_torch.ops import neighborhood_attention as na  # noqa: E402

QUERY_LOOP = "#pragma unroll 2  // two columns in flight"
KEY_LOOP = "#pragma unroll 2\n    for (int c = 0; c < tw.n; ++c) {"
VARIANTS = {
    "1xTF32": [("  mma_tf32(c, a_small, bb0, bb1);\n  mma_tf32(c, a_big, bs0, bs1);\n", ""),
               ("    mma_tf32(part, small, bb0, bb1);\n    mma_tf32(part, big, bs0, bs1);\n", "")],
    "3 blocks": [("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 3;")],
    "4 blocks": [("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 4;")],
    "unroll 1": [(QUERY_LOOP, QUERY_LOOP.replace("2", "1", 1)), (KEY_LOOP, KEY_LOOP.replace("2", "1", 1))],
}
# (B, H, W, heads, kernel, dilation, gain): unit-scale training shapes and
# q, k times 4 (K5_STRESS_SHAPE of chip_smoke.py first)
SHAPES = [(2, 13, 21, 3, 7, 1, 4.0), (2, 20, 96, 3, 7, 4, 4.0), (6, 48, 128, 6, 7, 20, 4.0),
          (2, 128, 256, 6, 7, 1, 4.0), (2, 128, 256, 6, 7, 1, 1.0), (2, 128, 256, 6, 7, 20, 1.0),
          (6, 6, 16, 48, 7, 2, 1.0), (2, 40, 45, 3, 13, 3, 1.0)]


def build(out_dir):
    """Compile every variant at once; returns {name: (library path or None,
    ptxas lines)}."""
    src = open(os.path.join(kernels.CSRC, "neighborhood_attention_backward.cu")).read()
    nvcc = "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                text = None
                break
            text = text.replace(old, new)
        if text is None:
            procs[name] = None
            continue
        stem = os.path.join(out_dir, "k5_" + name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"]
        procs[name] = (stem + ".so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    kernels.build(["neighborhood_attention", "neighborhood_attention_backward"], force=True)
    with open(kernels.build_log_path("neighborhood_attention_backward"), errors="replace") as f:
        built = {"as built": (None, [line.strip() for line in f if "Used" in line or "spill" in line])}
    for name, entry in procs.items():
        if entry is None:
            built[name] = (None, ["not made: the source no longer has the lines this variant replaces"])
            continue
        path, proc = entry
        log = proc.communicate()[0].decode(errors="replace")
        lines = [line.strip() for line in log.splitlines() if "Used" in line or "spill" in line or "error" in line]
        built[name] = (path if proc.returncode == 0 else None, lines)
    return built


def launcher(path):
    """K5's C entry of a variant library (the checked-in wrapper for None)."""
    if path is None:
        return na.neighborhood_attention_2d_backward_cuda
    lib = ctypes.CDLL(path)
    lib.na2d_backward.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    lib.na2d_backward.restype = ctypes.c_int

    def call(qkv, rpb, out, lse, grad_out, kernel, dilation, scale):
        B, H, W, _, nh, dh = qkv.shape
        blocks = na._k5_launch_shape(lib, B, H, W, nh, kernel, dilation)[0]
        dqkv, drpb = torch.empty_like(qkv), torch.empty_like(rpb)
        stats = torch.empty(lse.shape + (4,), device=qkv.device)
        partial = torch.empty((max(blocks, 1), (2 * kernel - 1) ** 2), device=qkv.device)
        rc = lib.na2d_backward(qkv.data_ptr(), rpb.data_ptr(), out.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
                               dqkv.data_ptr(), drpb.data_ptr(), stats.data_ptr(), partial.data_ptr(), B, H, W, nh,
                               dh, kernel, dilation, float(scale), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{path}: cudaError {rc}")
        return dqkv, drpb

    return call


def case(B, H, W, nh, kernel, dilation, gain, dev):
    """tests/test_torch_port_cuda.py's draw (numpy seed H * W + dilation),
    q and k times gain; K4's output and log-sum-exp."""
    rng = np.random.RandomState(H * W + dilation)
    qkv = rng.randn(B, H, W, 3, nh, 32).astype(np.float32)
    qkv[:, :, :, :2] *= gain
    qkv = torch.from_numpy(qkv).to(dev)
    rpb = torch.from_numpy((0.5 * rng.randn(nh, 2 * kernel - 1, 2 * kernel - 1)).astype(np.float32)).to(dev)
    grad_out = torch.from_numpy(rng.randn(B, H, W, nh, 32).astype(np.float32)).to(dev)
    lse = torch.empty((B, H, W, nh), device=dev)
    with torch.no_grad():
        out = na.neighborhood_attention_2d_cuda(qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb, kernel,
                                                dilation, 32 ** -0.5, lse)
    return qkv, rpb, out, lse, grad_out


def excess(got, ref):
    """The largest dqkv error as a multiple of atol 2e-5 + rtol 1e-4."""
    return ((got - ref).abs() / (2e-5 + 1e-4 * ref.abs())).max().item()


def cuda_ms(fn, reps=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "k5_variants"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k5_variants: no CUDA device visible")
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    built = build(args.out)
    print(json.dumps({"card": card, "ptxas": {name: lines for name, (_, lines) in built.items()}}), flush=True)
    calls = {name: launcher(path) for name, (path, _) in built.items() if name == "as built" or path}
    scale = 32 ** -0.5
    for shape in SHAPES:
        B, H, W, nh, kernel, dilation, gain = shape
        qkv, rpb, out, lse, grad_out = case(*shape, dev)
        ref = na.neighborhood_attention_2d_backward_plain(qkv, rpb, grad_out, kernel, dilation, scale)[0]
        ref64 = na.neighborhood_attention_2d_backward_plain(qkv.double(), rpb.double(), grad_out.double(), kernel,
                                                            dilation, scale)[0]
        row = {"shape": shape, "plain_vs_float64": excess(ref.double(), ref64), "excess": {}, "ms": {}}
        for name, call in calls.items():
            row["excess"][name] = excess(call(qkv, rpb, out, lse, grad_out, kernel, dilation, scale)[0], ref)
            if H == 128 and gain == 1.0:
                row["ms"][name] = cuda_ms(lambda: call(qkv, rpb, out, lse, grad_out, kernel, dilation, scale))
        print(json.dumps(row), flush=True)
        del qkv, out, ref, ref64
    cfg = load_config(os.path.join(ROOT, "configs", "cityscapes_dinat.yaml"))
    c = cfg.model.backbone.dinat
    # a step at batch 2 per modality: the crops' pass (B = 2) and the triples' (B = 6)
    passes = ((2, tuple(cfg.input.seg_crop_train)), (6, tuple(cfg.input.depth_hw_train)))
    layers = [(B, h // 4 >> i, w // 4 >> i, c.num_heads[i], d) for B, (h, w) in passes
              for i in range(len(c.depths)) for d in c.dilations[i]]
    step = {name: 0.0 for name in calls}
    for B, H, W, nh, dilation in layers:
        qkv, rpb, out, lse, grad_out = case(B, H, W, nh, c.kernel_size, dilation, 1.0, dev)
        for name, call in calls.items():
            step[name] += cuda_ms(lambda: call(qkv, rpb, out, lse, grad_out, c.kernel_size, dilation, scale), 10)
    print(json.dumps({"step_launches": len(layers), "step_ms": step}), flush=True)


if __name__ == "__main__":
    main()
