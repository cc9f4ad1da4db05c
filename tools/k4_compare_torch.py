"""K4 (`uni_encoder_tpu_torch/kernels/csrc/neighborhood_attention.cu`) of
this tree against K4 of another tree, on one card in one call: the way to
see whether a change of K4 moves its time, which moves with the card and
the host from one machine to the next.

Unpack the other tree first, into a directory that .gitignore lists:

    git archive <commit> | tar -x -C build/trees/<name>

then run, on the machine with the card, from the repo's root:

    python3 tools/k4_compare_torch.py build/trees/<name>

Both sources are built with the package's nvcc flags (the other tree's
library under build/k4_compare/). At DiNAT-L's stage 0 over a 1024x2048
frame (1, 256, 512, 6 heads, head dim 32, kernel 7, dilation 1), bf16 and
fp32, it checks that the two trees' whole-map outputs are the same bytes,
then times them in turns (this, other, other, this; `--rounds` times): the
mean of 50 launches after a warm-up, host included (`ms`), and of 20
launches replayed from a CUDA graph (`device_ms`). The other tree's kernel
is called through its C entry point, either signature (before and after
the row window). Prints the card's name and power limit, ptxas's registers
and spills for both, and one JSON line.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    import chip_smoke as cs
    from uni_encoder_tpu_torch import kernels
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="a directory holding another tree of the repo")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    kernels.build(["neighborhood_attention"], force=True)
    out_dir = os.path.join(ROOT, "build", "k4_compare")
    os.makedirs(out_dir, exist_ok=True)
    lib_path, log_path = os.path.join(out_dir, "libother.so"), os.path.join(out_dir, "other.log")
    src = os.path.join(args.other, "uni_encoder_tpu_torch", "kernels", "csrc", "neighborhood_attention.cu")
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib_path, src], capture_output=True, text=True)
    with open(log_path, "w") as f:
        f.write(r.stdout + r.stderr)
    if r.returncode:
        raise SystemExit(f"the other tree's K4 does not build:\n{r.stdout}{r.stderr}")
    usage = {"this": cs.ptxas_usage(kernels.build_log_path("neighborhood_attention"), "na2d_kernel"),
             "other": cs.ptxas_usage(log_path, "na2d_kernel")}
    other = ctypes.CDLL(lib_path).na2d_forward
    windowed = "int row_lo" in open(src).read()
    other.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
                      + [ctypes.c_int] * (2 if windowed else 0) + [ctypes.c_void_p])
    other.restype = ctypes.c_int

    dev = torch.device("cuda")
    B, H, W, nh, dh, kernel, dilation = 1, 256, 512, 6, 32, 7, 1
    g = torch.Generator().manual_seed(4)
    result = {"card": smi, "shape": [B, H, W, nh, dh], "kernel": kernel, "dilation": dilation, "ptxas": usage}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            key = "bf16" if dtype == torch.bfloat16 else "fp32"
            q, k, v, rpb = cs.na_qkv(g, B, H, W, nh, dh, kernel, dtype, dev)
            scale = dh ** -0.5
            out = torch.empty((B, H, W, nh, dh), dtype=dtype, device=dev)

            def this_call():
                return neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, dilation, scale)

            def other_call():
                rc = other(q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), out.data_ptr(), None, B, H, W,
                           nh, dh, *q.stride()[:4], kernel, dilation, float(scale), int(dtype == torch.bfloat16),
                           *((0, H) if windowed else ()), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"the other tree's K4 failed: cudaError {rc}")

            other_call()
            times = {"this_ms": [], "other_ms": [], "this_device_ms": [], "other_device_ms": []}
            for _ in range(args.rounds):
                for name, fn in (("this", this_call), ("other", other_call), ("other", other_call),
                                 ("this", this_call)):
                    times[f"{name}_ms"].append(cs.cuda_ms(fn, 50))
                    times[f"{name}_device_ms"].append(cs.cuda_graph_ms(fn, 20))
            result[key] = {"same_bytes": torch.equal(out, this_call()), **times}
    print(json.dumps(result), flush=True)
    if not all(result[k]["same_bytes"] for k in ("bf16", "fp32")):
        raise SystemExit("the two trees' K4 give other bytes on the whole map")


if __name__ == "__main__":
    main()
