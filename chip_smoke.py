"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
CUDA kernels from this checkout, holds each against its plain PyTorch version
at the main path's shapes, serves full-width 1024x2048 segmentation requests
and 192x512 two-frame depth/motion requests through the port's entry points
(on the Swin-T model, then on the ResNet-18, ConvNeXt-L and DiNAT-L
configs, and with the other pixel and depth decoders), takes full-width
training steps, and reports per-kernel times.

    python3 chip_smoke.py

Phases, one JSON line each: device, build, k1_vs_plain, k1_class_chunks,
k2_vs_plain, k3_vs_plain, k4_vs_plain, k5_vs_plain, serve, stages, profile,
kernels_on_served_tensors, reference_small, sequence, sequence_stages, frame,
predictor, sequence_reference_small, train, train_deterministic,
train_reference_small, train_backbones (one line per config),
train_decoders (one line per model), tools, train_entry, eval, backbones
(one line per config), decoders (one line per model, one for the modules
no config selects), convert, demo, eval_ade20k, spatial, multi_device and
tensor_parallel.
Each line carries `elapsed_s`, the seconds since the script started.
Then the card's name and power limit as nvidia-smi reports them, the
{"kernels": [...]} line, and last {"ok": true, "device": {...}}. Any failure
raises and the script exits non-zero without the last line. It needs a CUDA
card and the repository's `uni_encoder_tpu_torch` package beside it; it
imports nothing of JAX. Served requests run under torch.inference_mode
(`serve_segmentation`, `serve_sequence`), as a server holds it.

K3, the backward of K2, is bitwise deterministic: `k3_vs_plain` fails unless
three reruns give the same bytes in all three gradients, and checks its two
edge cases (grad_out all zero, and one NaN in grad_out). The phase
`train_deterministic` runs this script twice more as child processes, both
at once (`--train-deterministic-child PATH CONFIG...`, with
CUBLAS_WORKSPACE_CONFIG=:4096:8), each one `Trainer(deterministic=True)` step
at train_reference_small's sizes on the default Swin-T model and one on
configs/cityscapes_dinat.yaml, and fails unless their losses, watched
gradients and updated parameters are the same bytes. It also holds a
child's Swin-T step against this process's default step: the same function,
not the same sums, so a loss within atol 1e-4 + rtol 1e-3 and a watched
gradient within 1e-3 relative norm, or within twice what the CPU's own
small step moves between one thread (a child, `--cpu-step-child`, run on
one core beside the deterministic children) and this process's thread
count: the motion decoder's gradient passes through the RANSAC
ground-plane fit, which the order of fp32 sums alone moves.

`train_reference_small` holds the card's small Swin-T step against the
CPU's at this process's thread count by the same rule, read once the
one-thread child of train_deterministic has finished (its line follows
train_deterministic's).

The phase `train_decoders` takes a full-width training step on Swin-T with
each of the other decoder pairs the JAX builder selects (DECODER_MODELS,
by overrides of model.sem_seg_head.{pixel,depth}_decoder_name; fp32, TF32
off, train's batch, random weights from seed 0): one warm-up step, one
timed, one profiled. It fails unless the losses are finite, every
parameter with a gradient moved, DCMNet's BatchNorm statistics stay as
stored, and the launches per step are exact: K2 and K3 6 on (c)'s
segmentation side and 6 more on its sequence side
(DepthMSDeformAttnPixelDecoder), none on (a) and (b), K1, K4 and K5 none.
On (c) K3 is held against its plain version on the warm-up step's first
sequence-side call. Each model's small step on the card is held against
the CPU's by small_step_errors' rule; the CPU steps (at 2 threads, then at
1, then at 1 from images moved by one ulp) run in one child process a model (`--cpu-step-child` with
DECODER_CHILD_CONFIG), started after the build. Their first
steps try one cuDNN algorithm a convolution (DECODER_CUDNN_BENCHMARK_LIMIT). The phase `tools`
runs tools/calc_throughput_torch.py (img/s of the real training step on
the JAX tool's fixed batch at 192x512, 2 items a modality, 10 iterations)
and tools/analyze_model_torch.py (parameters, operator FLOPs, peak
activation memory and ms an image of the segmentation forward at
512x1024): K2 and K3 6 a step, K2 6 a forward, K1 never.

The phase `train_entry` drives the training entry point, `train_torch.main`,
on the production Swin-T config (configs/cityscapes_swin_unified.yaml, read
without PyYAML) at full width and depth: 4 iterations of 2 items per
modality from a synthetic tree of 4 full-size segmentation items and 4
frame triples, through the train mappers on the host. It fails unless the
4 metrics.json records carry train.py's keys with finite losses, K2 and K3
ran 6 times per step and K1 never, the checkpoints of steps 2 and 4 were
written, and `evaluate_torch.build_model` loads the last one byte for byte,
with exactly the training-only keys (text encoder, text projector, prompt
context, logit scale) left unused. Then it trains configs/cityscapes_dinat.yaml
for 2 iterations on the same tree: finite losses, K4 and K5 60 launches a
step.

The phase `train_backbones` takes full-width training steps on
configs/cityscapes_r18.yaml, cityscapes_convnext.yaml and
cityscapes_dinat.yaml (fp32, TF32 off, 2 crops of 512x1024 and 2 triples of
192x512, random weights from seed 0): one warm-up step, 2 timed, 1
profiled, with the cold and the steady peak memory. It fails unless the
losses are finite, the parameters move, the launches per step are exact (K2
and K3 6, K1 0; K4 and K5 60 on DiNAT-L, 0 on the others) and, on
ResNet-18, the backbone's BatchNorm statistics stay as stored (the JAX
ResNet never updates them). On DiNAT-L it also holds one small step on the
card against the CPU (as train_reference_small; a quantity may also differ
by twice what the CPU's own step moves at one thread, taken by a child
process, `--cpu-step-child`, that runs on one core beside the phase's card
steps: on this random model the RANSAC ground-plane fit is near-singular
and the pose and motion decoders' gradients cancel, so the order of fp32
sums alone moves them by percents) and holds train_deterministic's two
deterministic steps on that config, whose bytes must be equal.

K5, the backward of K4 (three CUDA kernels: query tiles for dq, key tiles
gathering dk and dv over each key's range of queries, both with their
products on the tensor cores in 3xTF32 and the log-sum-exp K4's fp32 kernel
wrote, and a fixed-order sum of per-block drpb tables), is held in
`k5_vs_plain` against autograd of the plain version at every NAT-layer shape
of a DiNAT-L training step (the crop pass at B=2 over 512x1024, the triples'
pass at B=6 over 192x512), at K4_EDGE_SHAPES and at K5_STRESS_SHAPE (q and k
4x larger: logits up to ~80, where one TF32 product per term would miss the
tolerance a thousandfold), fp32: dqkv within atol 2e-5 + rtol 1e-4, drpb
within atol 1e-6 * sqrt(B*H*W*dh) + rtol 1e-4, a rerun byte-identical; it
reports the kernel, device-only, plain and bound times per shape, each
pass's 30 launches summed, and the backward of torch.compile(flex_attention)
at the crop's stage 0, dilation 1 as the library yardstick.

K4, dilated neighborhood attention, is held against its plain version in
`k4_vs_plain` at every NAT-layer shape of a DiNAT-L backbone pass
(configs/cityscapes_dinat.yaml; head dim 32, kernel 7) over a 1024x2048
frame (256x512 with 6 heads at dilations 1 and 20, 128x256 with 12 at 1, 5
and 10, 64x128 with 24 at 1 to 4, 32x64 with 48 at 1 and 2) and over a
192x512 pair, both frames in one pass (B=2: 48x128 at 1 and 20, 24x64 at 1,
5 and 10, 12x32 at 1 to 4, 6x16 at 1 and 2; most of these sub-grids are
shorter than the kernel, so the clamped windows repeat keys), and at
K4_EDGE_SHAPES (ragged tiles, sub-grids of one key, kernels 3 and 5), in
bf16 and fp32, reruns byte-identical; at every fp32 shape the log-sum-exp
K4 writes for K5 (its optional `lse` output) against torch.logsumexp of the
plain version's logits, repeated keys counted, and the output with it
byte-equal to the output without; it reports each shape's kernel time
twice (20 calls back to back, host included as a caller sees it, and the
device alone, the calls replayed from a CUDA graph), the plain and bound
times, the launch's blocks, shared memory and registers per block, the sums
over each pass's 30 launches, and the time of torch.compile(flex_attention)
with the window as its mask_mod and the bias as its score_mod at stage 0,
dilation 1 (the library yardstick: null, with the reason, if it does not
compile).

The phase `backbones` serves configs/cityscapes_r18.yaml,
cityscapes_convnext.yaml and cityscapes_dinat.yaml (read by the port's YAML
reader) at full width and depth in bf16, random weights from seed 0: 2
1024x2048 panoptic requests through serve_segmentation and 2 192x512 pairs
through serve_sequence, each kind once more profiled (device time per
request). It fails unless the outputs are finite and of the right shapes
and the launches are exact: K1 1 and K2 6 per segmentation request, K4 30
per DiNAT backbone pass (0 for the others), K3 never. Then per config the
card (its kernels, fp32, TF32 off) against the CPU (the plain versions) on a
128x256 image and a 64x128 pair, stage by stage: the backbone's features,
the pixel decoder's outputs, the query decoder fed the CPU's pixel-decoder
outputs and the sequence outputs at atol 1e-4, rtol 1e-3; end to end,
pred_logits and pred_masks at atol 5e-3, rtol 1e-3 for all but 0.1% of their
elements, each of those within 5e-2 (the query decoder's masked attention
thresholds its own mask logits, so the pixel decoder's fp32 noise can flip
a mask bit; SMALL_PRED_OUTLIERS, SMALL_PRED_MAX_ERR). An element of the
query decoder's outputs, alone and end to end, past its bound also passes
where it lies within that bound of the CPU's own query decoder run on the
same inputs at one thread instead of this process's thread count (the
order of fp32 sums alone can flip such a bit), for up to 1% of the elements
(SMALL_CPU_CROSSED); the line counts those elements.

The phase `decoders` serves Swin-T (configs/cityscapes_swin_unified.yaml)
with the other pixel and depth decoders the JAX build_pixel_decoder selects, by
overrides of model.sem_seg_head.{pixel,depth}_decoder_name: (a)
BasePixelDecoder + DCMNet, (b) TransformerEncoderPixelDecoder +
DepthTransformerEncoderPixelDecoder, (c) MSDeformAttnPixelDecoder +
DepthMSDeformAttnPixelDecoder, at full width in bf16: 2 1024x2048 panoptic
requests through serve_segmentation and 2 192x512 pairs through
serve_sequence each, one more of each profiled. It fails unless the outputs
are finite, the disparity comes at its decoder's stride (2 for DCMNet, 4
for the other two) and the launches are exact: K1 1 per segmentation
request, K2 6 per request of either kind on (c) and 0 on (a) and (b). On
(c) one more sequence request's first K2 call (layer 0 of
DepthMSDeformAttn's encoder, bf16, grids 6x16, 12x32 and 24x64) is held
against its plain version at compare_msda's tolerance. One request of (a)
also goes through the fused post-process with
phase_layout=True, whose maps deinterleave_phases_np must turn into the
default call's byte for byte. Each model is then held fp32 on the card
against the CPU as in `backbones` (every disparity scale too), and so are
the modules no config selects at their full widths on a 192x512 input
(MonodepthDecoder and MotionDecoderV1 on a monodepth2 pyramid,
Monodepth2PoseModel on a 6-channel pair, ContextDecoder at its defaults).

The phase `eval` drives the evaluation entry point, `evaluate_torch.main`,
at full width on a synthetic Cityscapes / KITTI tree (4 images per
dataset) with a reference-style .pth of random weights: the loaded state
dict and a forward must be byte-equal to the writer's, the keys the model
does not own exactly the planted ones, every scalar metric finite (a
per-class IoU is NaN where the class is in neither GT nor prediction), K2
launched 6 times per segmentation forward, and the same evaluators fed the
GT must score PQ = mIoU = AP = 100.

The phase `convert` runs the checkpoint-conversion command line,
`tools/convert_checkpoint_torch.py --backbone swin`, on eval's recipe of a
reference-style .pth split into two files; `evaluate_torch.build_model`
from its output must equal the .pth load byte for byte. The phase `demo`
runs `demo_torch.main --task panoptic` on Swin-T (the converted
checkpoint; the configs of DEMO_CONFIGS, on which a DiNAT config also
runs, K4 60 a frame), a synthetic 1024x2048 frame with its t-2 frame: 8
renderings a frame at their sizes, K2 6 and K1 0 launches a frame, K4 0
on Swin-T, and matplotlib never imported; it reports predict and render
seconds per frame. The phase `eval_ade20k`
runs `evaluate_torch.main` on Swin-T with the 150-class head at ADE20K's
test resize over 4 synthetic 512x683 val images, --task panoptic and
--task instance: finite metrics, K2 6 launches per image, an instance kept
on every image (THING_LOGIT_BIAS), and the GT fed back through the same
evaluators scoring PQ = mIoU = AP = 100. Both `demo` (on Swin-T's first
frame, resized to its config's 384x768) and `eval_ade20k` (on the first
image, resized to 512x683, ragged level grids) hold K2 against its plain
version on the tensors that the entry point's own first deformable
attention call, layer 0 of the pixel decoder, was given. These three
come after `eval` and `backbones`: they import PIL (labels, JPEG) and cv2
(COCO polygons), which the Cityscapes evaluation must not.

The phase `multi_device` drives data-parallel training and sharded
evaluation (`uni_encoder_tpu_torch/parallel/`) in child processes
(`--multi-device-child`), three at once, each training and then
evaluating. Two
gloo ranks share the card (NCCL refuses two ranks on one card; gloo
all-reduces the CUDA tensors through the host) and take 2 full-width
Swin-T steps (deterministic, fp32) at local batch 1 a modality; before
each, rank 0 takes one process's step at the global batch 2 from the same
state with the same draws, and the same step with its images
moved by one ulp, and holds its own step, at one process's matching and
uncertain points (pinned: on random weights their inputs nearly tie),
against the first within the bounds of tests/test_torch_port_parallel.py
(MD_*) or twice the second's difference (what rounding alone moves); the
ranks' states must have the same fingerprints after each step, and K2 and
K3 6 launches a rank a step (K1, K4 and K5 none). One nccl rank takes a rank's step (batch 1) in a
group of one against the step without a group (NCCL's all-reduce on the
card), within the same bounds.
`evaluate_torch`'s library path on 2 gloo ranks over a synthetic
Cityscapes tree (2 val images, 2 depth frames, random weights from seed
0) must give both ranks the one process's metrics within
1e-9, each rank evaluating its shard (K2 6 an image, no other kernel); the line counts the
predictions whose digests equal the one process's. Two processes
time-sharing one card measure no scaling.

The phase `spatial` splits one image by rows over ranks
(`uni_encoder_tpu_torch/parallel/spatial.py`) in child processes
(`--spatial-child`), started before `convert`, each setting up a 1024x2048
image: first one process (`forward_segmentation`), then SPATIAL_WORLD gloo
ranks sharing the card (`spatial_inference`), each serving every model of
SPATIAL_MODELS in turn at full width (the default Swin-T; the ResNet-18,
ConvNeXt-L and DiNAT-L configs; Swin-T with BasePixelDecoder and with
TransformerEncoderPixelDecoder), random weights drawn on the card from
seed 0 (Swin-T's on the host, as `UniEncoder(seed=0)` draws them). Each takes
one fp32 forward (TF32 off), then a bf16 warm-up request
and the timed ones (SPATIAL_REQUESTS on the backbones, 1 on the FPN
decoders). It fails unless, on every model, the ranks' fp32 outputs equal
the one process's within the `backbones` end-to-end rule (SPATIAL_ATOL,
SPATIAL_RTOL), every process ran K2 6 times a request on the MSDeformAttn
models, K4 30 times on DiNAT-L and no other kernel, K2 on rank 0's
scattered queries (its rows of each level: Lq = 21504 of S = 43008) and on
DiNAT-L K4 on rank 0's first row window agree with their plain versions,
and each rank's peak memory is at most the one process's at the same
request (on Swin-T at most SPATIAL_PEAK_SHARE of it); on Swin-T also K1's
maps of rank 0's gathered bf16 outputs are within 3e-3 of the one
process's (the semantic map at bf16, the panoptic map at bf16 or fp32). It
reports each process's request ms, peak, and the all-reduces' seconds,
calls and bytes, one line a model; two ranks time-sharing one card measure
no latency gain.

The phase `tensor_parallel` (`uni_encoder_tpu_torch/parallel/tensor.py`)
takes one training step of the default Swin-T model at full width on
TP_WORLD gloo ranks sharing the card as a (1 x 2) data x model grid
(`--tensor-parallel-child`, started before `convert`, stepping once
multi_device's children have freed their training's memory), the JAX
rule's parameters at TP_MIN_DIM split over the model group. It fails
unless the split set is the JAX rule's TP_RULE_PARAMS parameters and
TP_RULE_ELEMENTS elements, rank 0's step gathered whole is within
multi_device's bounds (or twice the ulp spread) of multi_device's first
one-process step (the same state, draws and pinned discrete choices), the
ranks' replicated tensors carry equal fingerprints, K2 and K3 launch 6
times a rank and no other kernel, a rank holds half of the split elements,
and `tools/dryrun_multichip_torch.py TP_DRYRUN_RANKS` (the JAX dry run's
micro config on a (2 x 2) grid of gloo ranks on the card, run beside
`convert` .. `spatial`) exits 0 with a finite `dryrun_multichip(...)`
line. It reports a rank's parameter and optimizer bytes against one
process's, its peak, and the collectives' count, bytes and seconds.

Bounds use the H100 SXM data-sheet peaks: 3.35 TB/s of HBM, 67 TFLOP/s
of fp32 outside the tensor cores, 495 TFLOP/s of TF32 and 989 TFLOP/s of
bf16 on them (at the 700 W power limit). K1 runs its semantic product on
TF32 tensor cores, so its bound counts that product at the TF32 rate; the
all-CUDA-core bound is reported beside it. K4's bf16 bound counts the
logits q . k (bf16 products summed in fp32) at the bf16 tensor-core rate
and the weighted sum of values and the softmax at the fp32 rate; K5's
(fp32) counts all of its work at the fp32 rate (its bytes bind either way). The build phase reports
ptxas's stack-frame bytes for each kernel (K2, each of K3's three kernels,
both of K4's, bf16 and fp32, and each of K5's three must have none, and
K4's and K5's no spill) and the HMMA counts of K1's, K4's and K5's SASS
(each must have some: K1's semantic product, K4's bf16 logits and P . V and
K5's products run on tensor cores).
"""

import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12

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
# K4 beyond the DiNAT-L shapes, (B, H, W, heads, dh, dilation, kernel): tiles
# (8 x 8 sub-grid queries) with ragged edges on both axes, maps shorter than
# the dilation (sub-grids of one key), sub_len 1 and sub_len < kernel on one
# axis only, and kernels 3 and 5
K4_EDGE_SHAPES = ((2, 13, 21, 6, 32, 1, 7), (2, 13, 21, 6, 32, 2, 7), (2, 5, 11, 48, 32, 12, 7),
                  (2, 3, 64, 24, 32, 4, 7), (2, 20, 96, 12, 32, 4, 7), (2, 19, 27, 12, 32, 1, 5),
                  (2, 64, 128, 24, 32, 2, 5), (2, 17, 9, 12, 32, 1, 3), (2, 64, 128, 24, 32, 3, 3))
# the CUDA kernels of K3's source; ptxas must give each a 0-byte stack frame
K3_KERNELS = ("msda_grad_out_absmax_kernel", "msda_fused_backward_kernel", "msda_grad_value_epilogue_kernel")
# WATCHED on a DiNAT model: the heads' parameters, the backbone's first
# block's qkv projection and the bias table of its second (dilation 20 at
# stage 0: at 128x256 its sub-grids are 1 and 2 rows long, repeated keys)
WATCHED_DINAT = tuple(n for n in WATCHED if not n.startswith("backbone.")) + (
    "backbone.levels.0.blocks.0.attn.qkv.weight", "backbone.levels.0.blocks.1.attn.rpb")
N_TRAIN_BACKBONE_TIMED = 2  # training steps timed per backbone config, after one warm-up; one more profiled
TRAIN_ENTRY_DINAT_ITERS = 2  # train_torch.main on configs/cityscapes_dinat.yaml (of 90 000)
# train_backbones' DiNAT-L small step on the CPU: the reference's threads, in
# a child beside the one-thread step (taken in this process at its thread
# count, it held the main process for most of DiNAT-L's part of the phase)
DINAT_CPU_THREADS = 2
# the CUDA kernels of K5's source; ptxas must give each a 0-byte stack frame and no spill
K5_KERNELS = ("na2d_bwd_query_kernel", "na2d_bwd_key_kernel", "na2d_bwd_rpb_kernel")
# K5's precision stress, (B, H, W, heads, dh, dilation, kernel, gain): q and k
# drawn as tests/test_torch_port_cuda.py draws them (numpy seed H * W +
# dilation) and multiplied by gain, so that the logits reach ~80 (window
# maxima ~35): the same bytes as that test's case
K5_STRESS_SHAPE = (2, 13, 21, 3, 32, 1, 7, 4.0)
DETERMINISTIC_CHILD = "--train-deterministic-child"
CPU_STEP_CHILD = "--cpu-step-child"
MULTI_DEVICE_CHILD = "--multi-device-child"
MD_WORLD = 2  # gloo ranks sharing the one card (NCCL refuses two ranks on one card)
MD_STEPS = 2  # training steps on the ranks, each against one process's at the global batch
MD_EVAL_IMAGES = 2  # synthetic val images and depth frames (1 a rank)
# the bounds of tests/test_torch_port_parallel.py: losses relative (d_ground:
# its RANSAC plane fit's conditioning); gradients and AdamW's moments (mu and
# sqrt(nu)) in relative norm against the larger of their own norm and their
# share of their whole set's; the BatchNorm statistics against their largest
# element; each parameter element within its learning rate times
# MD_UPDATE_GAIN times its gradient's relative difference (AdamW's step
# g / sqrt(v) moves by at most about twice the relative change of g), at most
# MD_PARAM_LRS learning rates (a gradient within rounding of 0 has a noise
# sign), plus two ulps of the parameter
MD_LOSS_RTOL, MD_D_GROUND_RTOL = 1e-5, 2e-3
MD_GRAD_RTOL, MD_BN_RTOL = 1e-4, 1e-4
MD_UPDATE_GAIN, MD_PARAM_LRS = 4.0, 2.0
TP_CHILD = "--tensor-parallel-child"
TP_WORLD = 2  # gloo ranks sharing the one card as a (1 x 2) grid: each holds the whole batch
TP_MIN_DIM = 1024  # the JAX rule's production min_dim
# what the JAX rule shards at TP_MIN_DIM on the default training model
# (tests/test_torch_port_tensor_parallel.py holds the port's selection to it
# leaf by leaf on jax.eval_shape of the JAX trainer's state)
TP_RULE_PARAMS, TP_RULE_ELEMENTS = 72, 54_362_112
TP_BYTES_PER_ELEMENT = 16  # fp32 parameter, gradient and AdamW's two moments
# A rank's measured training state (the allocator's requested bytes after the step) lies
# TP_BYTES_PER_ELEMENT bytes an element it does not hold below one process's, within this share of that saving
TP_SAVED_RTOL = 0.02
# Each rank's allocator capped (`torch.cuda.set_per_process_memory_fraction`): without it the two ranks
# sharing the card race for its free memory and cuDNN, which takes the first deterministic backward
# algorithm whose workspace it can allocate, chose a ≈19 GB workspace on one rank (peak 37.12 GB) and
# other algorithms on the other (18.17 GB); under the cap both take the same and round alike
TP_MEMORY_CAP_GB = 24
TP_DRYRUN_RANKS = 4  # tools/dryrun_multichip_torch.py's (2 x 2) micro grid
SPATIAL_CHILD = "--spatial-child"
SPATIAL_WORLD = 2  # gloo ranks sharing the one card, each holding half of the image's rows
SPATIAL_REQUESTS = 2  # bf16 requests timed per process and backbone, after one warm-up
# the partitioned fp32 forward against the one-process fp32 forward, both on
# the card, TF32 off: end to end at the `backbones` rule (atol 5e-3, rtol
# 1e-3 for all but SMALL_PRED_OUTLIERS of the elements, each of those within
# SMALL_PRED_MAX_ERR: the query decoder's masked attention thresholds its
# own mask logits, and another order of fp32 sums can flip a mask bit)
SPATIAL_ATOL, SPATIAL_RTOL = 5e-3, 1e-3
SPATIAL_PEAK_SHARE = 0.75  # a rank's peak against the one-process peak at the same bf16 request
DEFAULT_CONFIG = "default"  # a child's config argument for the default Swin-T model
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
BACKBONE_CONFIGS = {"resnet": "configs/cityscapes_r18.yaml", "convnext": "configs/cityscapes_convnext.yaml",
                    "dinat": "configs/cityscapes_dinat.yaml"}
# (Swin-T only: DiNAT-L's frame, its full weights drawn on the host and its
# rendering, is cut for the smoke's 800 s beside spatial's models)
DEMO_CONFIGS = {"swin": TRAIN_ENTRY_CONFIG}
# phase spatial: the models each of its processes serves, one after another:
# key -> (config file, None for the default Swin-T; pixel decoder selected by
# override, or None; bf16 requests timed after one warm-up)
SPATIAL_MODELS = {"swin": (None, None, SPATIAL_REQUESTS),
                  **{k: (BACKBONE_CONFIGS[k], None, SPATIAL_REQUESTS) for k in ("resnet", "convnext", "dinat")},
                  "base": (None, "BasePixelDecoder", 1), "transformer": (None, "TransformerEncoderPixelDecoder", 1)}
# synthetic 1024x2048 frames per config, each with its t-2 frame (one frame
# keeps the whole smoke within its 800 s beside multi_device)
DEMO_FRAMES = 1
# a panoptic demo frame's renderings and their shapes
DEMO_RENDERINGS = {**{k: (SEQ_H, SEQ_W, 3) for k in ("depth", "ego_flow", "independent_flow", "total_flow")},
                   "motion_mask": (SEQ_H, SEQ_W), **{k: (SEG_H, SEG_W, 3) for k in ("semantic", "panoptic", "instance")}}
ADE_SET = "ade20k_panoptic_val"
ADE_IMAGES = 4  # synthetic val images (reduced: the real val split holds 2000)
# added to the thing classes' logits of the ADE20K model's random class head
# (after its x8): without it the top class of every query is a stuff class,
# and the instance run keeps nothing
THING_LOGIT_BIAS = 20.0
ADE_HW = (512, 683)  # ADE20K's common val size
# Swin-T with the 150-class head at OneFormer's ADE20K test resize
ADE_OVERRIDES = ["model.sem_seg_head.num_classes=150", "input.seg_min_size_test=512", "input.seg_max_size_test=2048",
                 "datasets.depth_test=[]", f"datasets.seg_test_panoptic=[{ADE_SET}]",
                 f"datasets.seg_test_instance=[{ADE_SET}]"]
N_BACKBONE_REQUESTS = 2  # served per config and request kind with the launch counts read; one more profiled
# The share of pred_logits / pred_masks elements the backbones phase's
# card-against-CPU check lets past its tolerance: on the CPU alone, N(0, 1e-5)
# noise on the pixel decoder's outputs (fp32 summation-order noise) moves 1 of
# ConvNeXt-L's 3000 class logits by 9.4e-3 and 27 of its 307200 mask logits
# past atol 5e-3 + rtol 1e-3, through the query decoder's masked attention,
# each by at most 9.5e-3; SMALL_PRED_MAX_ERR caps the outliers at 5x that
SMALL_PRED_OUTLIERS = 1e-3
SMALL_PRED_MAX_ERR = 5e-2
# The share of a query-decoder output's elements (query_decoder_*, pred_*)
# that may pass the card-against-CPU check past its fixed tolerance against
# the CPU at this process's thread count by lying within that tolerance of
# the CPU at one thread: the decoder's masked attention thresholds its own
# mask logits, so the order of fp32 sums alone can flip a mask bit and move
# that query's outputs, and through self-attention the other queries' (Swin-T
# with the TransformerEncoder pixel decoder: the CPU at 1 thread crosses the
# tolerance against itself at 8 in 9 of 3000 class logits and 1156 of 307200
# mask logits, over 18 queries)
SMALL_CPU_CROSSED = 1e-2
SMALL_TOLERANCE = ("backbone, pixel decoder, query decoder fed the CPU's pixel-decoder outputs and sequence atol "
                   "1e-4 rtol 1e-3; end to end pred_logits and pred_masks atol 5e-3 rtol 1e-3 for all but "
                   f"{SMALL_PRED_OUTLIERS:.1%} of their elements, each within {SMALL_PRED_MAX_ERR}; an element of "
                   "the query decoder's outputs past its bound against the CPU at its thread count also passes "
                   "within the same bound of the CPU at 1 thread, for up to "
                   f"{SMALL_CPU_CROSSED:.0%} of the elements")
# phase decoders: Swin-T (configs/cityscapes_swin_unified.yaml) with the other
# pixel and depth decoders the JAX build_pixel_decoder selects, by (pixel, depth) name;
# the stride of each depth decoder's disp, and the launches of K2 per request
# of each kind (the MSDeformAttn decoders' 6 encoder layers)
DECODER_MODELS = {"a": ("BasePixelDecoder", "DCMNet"),
                  "b": ("TransformerEncoderPixelDecoder", "DepthTransformerEncoderPixelDecoder"),
                  "c": ("MSDeformAttnPixelDecoder", "DepthMSDeformAttnPixelDecoder")}
DECODER_DISP_STRIDE = {"a": 2, "b": 4, "c": 4}
N_DECODER_REQUESTS = 2  # served per model and request kind with the launch counts read; one more profiled
# phase train_decoders: a full-width training step on each DECODER_MODELS
# pair after one warm-up (reduced: 1 timed step); the parameters whose
# gradients its small step holds against the CPU, and whose values must move
N_TRAIN_DECODER_TIMED = 1
WATCHED_DECODERS = {
    "a": ("sem_seg_head.pixel_decoder.layer_4.weight", "sem_seg_head.pixel_decoder.mask_features.weight",
          "sem_seg_head.depth_decoder.fpn_bottleneck_0.conv.weight", "sem_seg_head.depth_decoder.last_layer_0.weight"),
    "b": ("sem_seg_head.pixel_decoder.transformer.encoder.layers.0.linear1.weight",
          "sem_seg_head.pixel_decoder.mask_features.weight",
          "sem_seg_head.depth_decoder.transformer.encoder.layers.0.self_attn.in_proj_weight",
          "sem_seg_head.depth_decoder.low_disp_3.conv0.weight"),
    "c": ("sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
          "sem_seg_head.pixel_decoder.adapter_1.weight",
          "sem_seg_head.depth_decoder.transformer.encoder.layers.0.self_attn.sampling_offsets.weight",
          "sem_seg_head.depth_decoder.low_disp_3.conv0.weight"),
}
# the parameters every model shares that its small step holds: the
# backbone's first qkv and the class head. The motion decoder's and the
# text encoder's gradients are reported and not held (UNHELD_DECODERS): on
# these random models the motion decoder's passes through the monodepth
# loss's photometric warp near the camera plane, and the card moved it by
# 1.05e-2 to 1.12e-2 from the CPU's at 2 threads, while the CPU's own steps
# at 1 thread and from ulp-moved images moved it by 2.9e-3 to 1.2e-2 (it
# failed twice the larger of two such samples on (b)); the text encoder's
# passes through the contrastive loss of the query decoder's features,
# whose masked attention thresholds its own mask logits: 1.21e-3 on (a)
# against the CPU's 2.5e-4 (ROADMAP Queue 3). Both are held on the
# shipped pair (train_reference_small)
WATCHED_SHARED = tuple(n for n in WATCHED if n.startswith(("backbone.", "sem_seg_head.predictor.")))
UNHELD_DECODERS = tuple(n for n in WATCHED if n.startswith(("motion_decoder.", "text_encoder.")))
DECODER_CHILD_CONFIG = "decoders:"  # a child's config argument for Swin-T with DECODER_MODELS[letter]
# a decoder model's child takes the small step on the CPU at 2 threads (the
# reference), then at 1, then at 1 from images moved by one ulp
# (`ulp_moved`): the spread of rounding alone is the larger of the last two
# differences from the first. The depth and motion decoders' gradients pass
# through the monodepth loss, whose photometric warp on random weights puts
# points near the camera plane: on (a) the card moved DCMNet's
# fpn_bottleneck_0 gradient by 1.5e-3 and the motion decoder's by 1.1e-2,
# the CPU at 1 thread by 1.6e-4 and 1.2e-2, at 1 thread from moved images by
# 3.4e-3 and 4.2e-3 (tests/test_torch_port_train_{dcmnet,fpn,msdeform}.py
# find the same loss's disparity gradients 3e-4 to 2e-2 apart between two
# implementations)
DECODER_CPU_STEPS = ("2", "1", "1u")
# cuDNN algorithms tried a convolution on the decoder models' first step
# (torch's default is 10): at 10, (a)'s first step took 62 s of
# benchmarking (DCMNet's 512-wide fp32 convolutions) and its step 367.5 ms
# of device time, at 1 (cuDNN's first choice) 2.1 s and 477.1 ms (H100
# 80GB HBM3, 700 W). The decoder models' step times, and their small steps on
# the card, are at this limit
DECODER_CUDNN_BENCHMARK_LIMIT = 1
# phase tools: tools/calc_throughput_torch.py on the default config at its
# size (reduced: TOOLS_THROUGHPUT_ITERS of the JAX tool's 30 iterations, and
# batch TRAIN_BATCH of its 4: the phase train benchmarked that batch's
# convolutions, and at 4 the first step benchmarks every one of them anew
# with cuDNN, 97 s for the tool in all), and tools/analyze_model_torch.py at
# its defaults
TOOLS_THROUGHPUT_ITERS = 10
TOOLS_ANALYZE_ITERS = 20
# the modules no config selects, at their full widths on a 192x512 input:
# monodepth2's encoder pyramid (stem at stride 2 .. res5 at 32) and the
# motion decoder's 8-channel full-resolution input (two RGB frames and
# their disparities)
MONODEPTH2_PYRAMID = {"stem": (2, 64), "res2": (4, 64), "res3": (8, 128), "res4": (16, 256), "res5": (32, 512)}
CONTEXT_TEXT, CONTEXT_VISUAL = (1, 19, 1024), (1, 384, 1024)  # a text per Cityscapes class; 12x32 visual tokens


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.perf_counter() - T_START}), flush=True)


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


def cuda_graph_ms(fn, reps, replays=5):
    """Device time of one `fn()`: `reps` calls captured in one CUDA graph,
    replayed `replays` times after one warm-up, so that the host's time per
    call, which bounds `cuda_ms` for a short kernel, is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


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


def compare_msda(got, ref, fp32, name="K2"):
    """fp32: atol/rtol 1e-5 (tests/test_ms_deform_attn.py:51). bf16: within
    one bf16 ulp of the plain output plus the fp32 atol 1e-5 (both sum the
    same fp32 products in another order and round once; the atol covers
    sums that cancel to near zero, whose ulp is below fp32's error). Also
    K4's tolerance, on the same grounds."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if fp32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        ulp = torch.where(ref == 0, torch.zeros_like(ref), 2.0 ** (torch.floor(torch.log2(ref.abs())) - 7))
        bad = err > ulp + 1e-5
        if bool(bad.any()):
            i = int(torch.argmax((err - ulp) * bad))
            raise AssertionError(f"{name} bf16: {int(bad.sum())} values beyond 1 ulp + 1e-5, worst "
                                 f"kernel {got.flatten()[i].item()} plain {ref.flatten()[i].item()}")
    return err.max().item()


@contextlib.contextmanager
def first_msda_call():
    """Within the block, records the module and inputs of the first
    deformable-attention call (MSDeformAttnModule: layer 0 of the pixel
    decoder's encoder on the first image, or of DepthMSDeformAttn's on a
    sequence request) into the yielded list; a global forward hook, removed
    at that call."""
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import MSDeformAttnModule

    seen = []

    def hook(module, args, out):
        if isinstance(module, MSDeformAttnModule) and not seen:
            seen.append((module, args))
            handle.remove()

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def k2_on_recorded_call(seen):
    """K2 against its plain version on the value, offsets and logits that
    `first_msda_call`'s recorded module computes from its recorded inputs,
    at compare_msda's tolerance for their dtype (it raises past it)."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_cuda, ms_deform_attn_fused_plain

    (attn, (query, ref_abs, value_src, shapes)), = seen
    with torch.inference_mode():
        value = attn.value_proj(value_src).view(*value_src.shape[:2], attn.n_heads, -1)
        off, logits = attn.sampling_offsets(query), attn.attention_weights(query)
        err = compare_msda(ms_deform_attn_fused_cuda(value, shapes, off, logits, ref_abs),
                           ms_deform_attn_fused_plain(value, shapes, off, logits, ref_abs),
                           fp32=value.dtype == torch.float32)
    return {"max_abs_err": err, "value_shape": list(value.shape), "dtype": str(value.dtype).replace("torch.", ""),
            "level_grids": torch.as_tensor(shapes).tolist()}


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
    beside the rest on CUDA cores (ms)."""
    return bound_fields(*k1_bound(Q, K, h, w), tensor_flops=2 * K * Q * 16 * h * w,
                        tensor_rate=TF32_FLOP_PER_S)["bound_ms"]


def k2_bound(B, Lq, S, M, D, L, P, nbytes_el):
    """The fused contract: value, offsets and logits in the model dtype and
    fp32 ref_abs read once, the output written once."""
    nbytes = (B * S * M * D + B * Lq * M * L * P * 3 + B * Lq * M * D) * nbytes_el + L * Lq * 2 * 4
    # 4 corners x D fused multiply-adds, corner weights, softmax and location
    flops = B * Lq * M * L * P * (8 * D + 30)
    return nbytes, flops


def ptxas_usage(log_path, kernel):
    """Registers, stack-frame and spill bytes ptxas reports for each entry
    function whose name holds `kernel`, from an `nvcc -Xptxas -v` log:
    {function: {"registers", "stack_frame", "spill_bytes"}}."""
    usage, compiling, props = {}, None, None
    with open(log_path, errors="replace") as f:
        for line in f:
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            used = re.search(r"Used (\d+) registers", line)
            if "Compiling entry function" in line:
                compiling = line.split("'")[1]
            elif "Function properties for" in line:
                props = line.rsplit("for", 1)[1].strip()
            elif frame and props is not None and kernel in props:
                usage.setdefault(props, {}).update(stack_frame=int(frame[1]),
                                                   spill_bytes=int(frame[2]) + int(frame[3]))
            elif used and compiling is not None and kernel in compiling:
                usage.setdefault(compiling, {})["registers"] = int(used[1])
    return usage


def ptxas_stack_frames(log_path, kernel):
    """Stack-frame bytes of each build of `kernel` (its template instantiations)."""
    return [u["stack_frame"] for u in ptxas_usage(log_path, kernel).values() if "stack_frame" in u]


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


def bound_fields(nbytes, flops, tensor_flops=0, tensor_rate=BF16_FLOP_PER_S):
    """The least time (ms): the larger of the byte time and the operation
    time, where `tensor_flops` of the `flops` run at `tensor_rate` on the
    tensor cores and the rest at the fp32 rate on the CUDA cores, the two
    units side by side."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(tensor_flops / tensor_rate, (flops - tensor_flops) / FP32_FLOP_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def reset_launches(*wrappers):
    for w in wrappers:
        w.launches = 0


def profile_device(fn, n, untraced_ms):
    """Device kernel time of one `fn()` from torch.profiler over `n` calls,
    the busy share (traced, and against the untraced wall time
    `untraced_ms`), launches per call and the largest kernels. Only the
    device's activity is traced: reading a profile of training steps back
    took 26 s so, and 48 s with the host's operators traced too (H100
    80GB HBM3, 700 W)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def check_sequence_outputs(out, B, H, W, disp_stride=1, disp_low=0.01):
    """The sequence request's checks: shapes (disp at 1 / `disp_stride` of
    the input), finite values, disparity in [disp_low, 1] (the TransDSSL bin
    range by default; a sigmoid's [0, 1] for the other depth decoders), a
    motion probability, an SE(3) last row."""
    disp, mask = out["disp"].float(), out["motion_mask"].float()
    flow, cam = out["complete_flow"].float(), out["cam_T_cam"].float()
    last_row = torch.tensor([0.0, 0.0, 0.0, 1.0], device=cam.device).expand(B, 4)
    return {
        "disp_shape": tuple(disp.shape) == (B, H // disp_stride, W // disp_stride, 1),
        "motion_mask_shape": tuple(mask.shape) == (B, H, W, 1),
        "complete_flow_shape": tuple(flow.shape) == (B, H, W, 3),
        "cam_T_cam_shape": tuple(cam.shape) == (B, 4, 4),
        "finite": all(bool(torch.isfinite(x).all()) for x in (disp, mask, flow, cam)),
        "disp_in_bins": bool((disp >= disp_low).all() and (disp <= 1.0).all()),
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


def small_seq_hw(model_cfg):
    """The small step's frame size: 64x128, or taller where the depth
    decoder's coarsest disparity would keep no ground row there (3 rows at
    least: decoders at strides 4 to 32 take 96x128)."""
    from uni_encoder_tpu_torch.models.oneformer import disparity_strides

    return max(64, 3 * max(disparity_strides(model_cfg))), 128


def small_train_step(Trainer, cfg, device, deterministic=False, watched=WATCHED, moved=False):
    """One fp32 training step at the full width on a small batch (2 crops
    of 128x256 with 20 target slots, 8 valid; 2 frame triples of
    `small_seq_hw`, 64x128 but for the stride-4 depth decoders; with
    `moved`, every image float moved by one ulp, `ulp_moved`), weights from
    seed 0 and draws from seed 1: (losses, the `watched` gradients, every
    updated parameter), on `device`."""
    n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
    tr = Trainer(cfg, device=device, deterministic=deterministic)
    st = tr.init(seed=0)
    seg_s, seq_s = train_batches(1, TRAIN_BATCH, (128, 256), small_seq_hw(cfg.model), 20, 8, n_texts, device)
    if moved:
        seg_s, seq_s = ulp_moved(seg_s, seq_s)
    draws = tr.make_draws(torch.Generator().manual_seed(1), seg_s, seq_s, device)
    _, m = tr.train_step(st, seg_s, seq_s, draws=draws)
    params = dict(st.model.named_parameters())
    return m, {n: params[n].grad for n in watched}, {n: p.detach() for n, p in params.items()}


def step_differences(got, ref, watched):
    """(|loss difference| per term, relative norm of the gradient difference
    per watched parameter) of two small steps' (losses, gradients)."""
    return ({k: abs(got[0][k] - r) for k, r in ref[0].items()},
            {n: ((got[1][n] - ref[1][n]).norm() / ref[1][n].norm()).item() for n in watched})


def small_step_errors(phase, got, ref, watched=WATCHED, cpu_steps=None):
    """Losses within atol 1e-4 + rtol 1e-3 and the `watched` gradients
    within 1e-3 relative norm (cuBLAS/cuDNN sum in other orders than the
    CPU, or than their deterministic algorithms); returns both. With
    `cpu_steps`, the same step on the CPU at one thread and at this
    process's thread count (two orders of its fp32 sums), a quantity may
    also differ by up to twice as much as those two differ: where the step
    is ill-conditioned (a near-singular RANSAC plane fit, a decoder's
    cancelling gradients), that is the part of a difference the port
    cannot remove. `cpu_steps` may also be a list of such pairs (other
    roundings of the same step): then twice the largest of their
    differences."""
    loss_err, grad_err = step_differences(got, ref, watched)
    loss_noise, grad_noise = {}, {}
    for pair in (cpu_steps if isinstance(cpu_steps, list) else [cpu_steps] if cpu_steps else []):
        for noise, err in zip((loss_noise, grad_noise), step_differences(*pair, watched)):
            for k, v in err.items():
                noise[k] = max(noise.get(k, 0.0), v)
    for k, r in ref[0].items():
        if not loss_err[k] <= max(1e-4 + 1e-3 * abs(r), 2 * loss_noise.get(k, 0.0)):
            raise AssertionError(f"{phase} {k}: {got[0][k]} against {r} (the CPU against itself: "
                                 f"{loss_noise.get(k)})")
    for n in watched:
        if not grad_err[n] < max(1e-3, 2 * grad_noise.get(n, 0.0)):
            raise AssertionError(f"{phase} grad {n}: relative error {grad_err[n]} (the CPU against itself: "
                                 f"{grad_noise.get(n)})")
    return loss_err, grad_err


def kill_at_exit(child):
    """Kill `child` at this process's exit if it still runs then (a phase
    that fails before the child is waited for raises past it)."""
    import atexit

    def stop():
        if child.poll() is None:
            child.kill()
            child.wait()

    atexit.register(stop)


def start_child(mode, out_path, *args, env=None):
    """Start this script as a child in `mode` (DETERMINISTIC_CHILD or
    CPU_STEP_CHILD) writing to `out_path`, its output in `out_path`.log."""
    with open(out_path + ".log", "w") as log:
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, out_path, *args], env=env,
                                stdout=log, stderr=subprocess.STDOUT)


def finish_children(children, paths, timeout):
    """Wait for `children` (killing every one still running as soon as one
    fails, or when `timeout` seconds have passed) and load what each saved
    to its path."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [child.poll() for child in children]
            for path, code in zip(paths, codes):
                if code not in (None, 0):
                    with open(path + ".log") as log:
                        raise AssertionError(f"child {path} exited {code}:\n{log.read()[-4000:]}")
            if all(code == 0 for code in codes):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"children {paths} still running after {timeout} s")
            time.sleep(0.5)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    runs = [torch.load(path) for path in paths]
    for path in paths:
        os.remove(path)
        os.remove(path + ".log")
    return runs


def deterministic_children(paths, configs, meanwhile=lambda: None):
    """Run this script once per path as a child, all at once
    (`DETERMINISTIC_CHILD PATH CONFIG...`, CUBLAS_WORKSPACE_CONFIG=:4096:8):
    each takes one deterministic step per config in turn, saved there;
    this process runs `meanwhile()` while they do. Returns per config the
    children's runs and whether their losses, gradients and parameters are
    the same bytes; and the environment's workspace setting."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    children = [start_child(DETERMINISTIC_CHILD, path, *configs, env=env) for path in paths]
    for child in children:
        kill_at_exit(child)
    meanwhile()
    loaded = finish_children(children, paths, timeout=600)
    out = {}
    for config in configs:
        runs = [r[config] for r in loaded]
        equal = {group: all(runs[0][group][k].numpy().tobytes() == runs[1][group][k].numpy().tobytes()
                            for k in runs[0][group]) and sorted(runs[0][group]) == sorted(runs[1][group])
                 for group in ("losses", "grads", "params")}
        out[config] = (runs, equal)
    return out, env["CUBLAS_WORKSPACE_CONFIG"]


def decoder_overrides(key):
    """The overrides that select DECODER_MODELS[key] on the Swin-T config."""
    pixel, depth = DECODER_MODELS[key]
    return [f"model.sem_seg_head.pixel_decoder_name={pixel}", f"model.sem_seg_head.depth_decoder_name={depth}"]


def decoder_config(key):
    """configs/cityscapes_swin_unified.yaml with DECODER_MODELS[key]."""
    from uni_encoder_tpu_torch.config import load_config

    return load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAIN_ENTRY_CONFIG),
                       decoder_overrides(key))


def load_child_config(config):
    """A child's config argument: a config file, DEFAULT_CONFIG for the
    default Swin-T model, or DECODER_CHILD_CONFIG + a DECODER_MODELS key;
    and the watched parameters on it."""
    from uni_encoder_tpu_torch.config import Config, load_config

    if config.startswith(DECODER_CHILD_CONFIG):
        key = config[len(DECODER_CHILD_CONFIG):]
        return decoder_config(key), WATCHED_SHARED + WATCHED_DECODERS[key] + UNHELD_DECODERS
    cfg = Config() if config == DEFAULT_CONFIG else load_config(config)
    return cfg, WATCHED_DINAT if cfg.model.backbone.name == "dinat" else WATCHED


def train_deterministic_child(out_path, *configs):
    """The child of phase train_deterministic: per config, one
    deterministic step, its losses, watched gradients and updated
    parameters as CPU tensors with the step's seconds, all saved to
    `out_path`."""
    from uni_encoder_tpu_torch.training.train_step import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    saved = {}
    for config in configs:
        cfg, watched = load_child_config(config)
        t0 = time.perf_counter()
        losses, grads, params = small_train_step(Trainer, cfg, torch.device("cuda"), deterministic=True,
                                                 watched=watched)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        saved[config] = {"losses": cpu(losses), "grads": cpu(grads), "params": cpu(params), "seconds": seconds}
        del losses, grads, params
    torch.save(saved, out_path)


def cpu_step_key(spec):
    """The key of a `cpu_step_child` step: its thread count, or "1u"."""
    return spec if spec.endswith("u") else int(spec)


def cpu_step_child(out_path, config, threads):
    """The child of phases train_deterministic (Swin-T), train_backbones
    (DiNAT-L) and train_decoders (each DECODER_MODELS pair): the small step
    on the CPU at each of the comma-separated thread counts `threads` in
    turn (a count followed by "u": from images moved by one ulp), its
    losses and watched gradients saved to `out_path`, keyed by the count
    (an int) or, moved, by its spec ("1u")."""
    from uni_encoder_tpu_torch.training.train_step import Trainer

    cfg, watched = load_child_config(config)
    saved = {}
    for spec in threads.split(","):
        torch.set_num_threads(int(spec.rstrip("u")))
        m, grads, _ = small_train_step(Trainer, cfg, torch.device("cpu"), watched=watched, moved=spec.endswith("u"))
        saved[cpu_step_key(spec)] = {"losses": {k: float(v) for k, v in m.items()}, "grads": grads}
        del m, grads
    torch.save(saved, out_path)


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


def reference_weights(model_cfg, dev, planted_shapes=EVAL_PLANTED, thing_classes=()):
    """Random full-width weights from seed 0 on `dev`, the class head x8 (so
    that queries clear the 0.8 threshold) and THING_LOGIT_BIAS on the
    columns of `thing_classes`: the model that holds them, its state dict on
    the host, and random host tensors under `planted_shapes`' keys, which the
    model does not own (a reference checkpoint's extras)."""
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    writer = UniEncoder(model_cfg, device=dev, seed=0)
    with torch.no_grad():
        writer.predictor.class_embed.weight.mul_(8.0)
        writer.predictor.class_embed.bias[list(thing_classes)] += THING_LOGIT_BIAS
    saved = {k: v.detach().cpu().clone() for k, v in writer.state_dict().items()}
    g = torch.Generator().manual_seed(5)
    planted = {k: torch.randn(*shape, generator=g) for k, shape in planted_shapes.items()}
    return writer, saved, planted


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
        writer, saved, planted = reference_weights(cfg.model, dev)
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
    yet, cuDNN's benchmarking) and over the run. Then `train_torch.main` on
    configs/cityscapes_dinat.yaml for TRAIN_ENTRY_DINAT_ITERS iterations on
    the same tree (K4 and K5 60 launches a step). Returns each config's
    kernel launches over its run."""
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
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d_backward_cuda,
        neighborhood_attention_2d_cuda,
    )

    kernel_fns = {"k1": fused_postprocess_cuda, "k2": ms_deform_attn_fused_cuda,
                  "k3": ms_deform_attn_fused_backward_cuda, "k4": neighborhood_attention_2d_cuda,
                  "k5": neighborhood_attention_2d_backward_cuda}
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
        reset_launches(*kernel_fns.values())
        timings = []
        t0 = time.perf_counter()
        state = train_torch.main(["--config", cfg_path, "--datasets-root", root, "--output-dir", out,
                                  "--max-iter", str(TRAIN_ENTRY_ITERS), "--batch", str(TRAIN_BATCH),
                                  "--log-period", "1", "--checkpoint-period", "2"], timings=timings)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in kernel_fns.items()}
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
            "launches": launches == {"k1": 0, "k2": TRAIN_ENTRY_ITERS * enc_layers,
                                     "k3": TRAIN_ENTRY_ITERS * enc_layers, "k4": 0, "k5": 0},
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
        del state, model, fwd, trained, own
        torch.cuda.empty_cache()

        # the DiNAT-L config through the same entry point and tree: K4 and
        # K5 on the path, 30 launches each a backbone pass, two a step
        dinat_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), BACKBONE_CONFIGS["dinat"])
        dinat_cfg = load_config(dinat_path)
        dinat_out = os.path.join(work, "run_dinat")
        torch.cuda.reset_peak_memory_stats()
        reset_launches(*kernel_fns.values())
        dinat_timings = []
        t0 = time.perf_counter()
        dinat_state = train_torch.main(["--config", dinat_path, "--datasets-root", root, "--output-dir", dinat_out,
                                        "--max-iter", str(TRAIN_ENTRY_DINAT_ITERS), "--batch", str(TRAIN_BATCH),
                                        "--log-period", "1", "--checkpoint-period", str(TRAIN_ENTRY_DINAT_ITERS)],
                                       timings=dinat_timings)
        torch.cuda.synchronize()
        dinat_run_s = time.perf_counter() - t0
        dinat_launches = {k: f.launches for k, f in kernel_fns.items()}
        with open(os.path.join(dinat_out, "metrics.json")) as f:
            dinat_records = [json.loads(line) for line in f if line.strip()]
        nat = 2 * sum(dinat_cfg.model.backbone.dinat.depths)
        dinat_enc = dinat_cfg.model.sem_seg_head.transformer_enc_layers
        checks.update({
            "dinat_losses_finite": len(dinat_records) == TRAIN_ENTRY_DINAT_ITERS and all(
                np.isfinite(r[k]) for r in dinat_records for k in ("loss", "loss_seg", "loss_monodepth")),
            "dinat_step_count": dinat_state.step == TRAIN_ENTRY_DINAT_ITERS,
            "dinat_launches": dinat_launches == {"k1": 0, "k2": TRAIN_ENTRY_DINAT_ITERS * dinat_enc,
                                                 "k3": TRAIN_ENTRY_DINAT_ITERS * dinat_enc,
                                                 "k4": TRAIN_ENTRY_DINAT_ITERS * nat,
                                                 "k5": TRAIN_ENTRY_DINAT_ITERS * nat},
            "dinat_checkpoint": os.path.isfile(os.path.join(dinat_out, f"step_{TRAIN_ENTRY_DINAT_ITERS}.pt")),
        })
        dinat = {"config": BACKBONE_CONFIGS["dinat"], "iterations": TRAIN_ENTRY_DINAT_ITERS,
                 "per_iteration": [{"data_ms": t["data_s"] * 1e3, "step_ms": t["step_s"] * 1e3,
                                    "checkpoint_s": t["checkpoint_s"], "peak_gb": t["peak_gb"], "loss": r["loss"]}
                                   for t, r in zip(dinat_timings, dinat_records)],
                 "run_s": dinat_run_s, "launches": dinat_launches}
        del dinat_state
        torch.cuda.empty_cache()
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
         metrics=records, dinat=dinat, checks=checks, seconds=time.perf_counter() - t_phase, card=smi)
    fail_unless("train_entry", checks)
    return {TRAIN_ENTRY_CONFIG: launches, BACKBONE_CONFIGS["dinat"]: dinat_launches}


def na_bound(B, H, W, nh, dh, kernel):
    """Bytes, operations and the operations bf16 tensor cores could do, for
    bf16 inputs: q, k, v read once, the output written once (and the bias
    table); per query and head k * k * dh multiply-adds of the logits q . k
    (bf16 products summed in fp32, as the tensor cores do), k * k * dh of
    the weighted sum of values (fp32 probabilities) and 4 * k * k softmax
    operations (bias add, max, exp, sum) on the CUDA cores."""
    nbytes = 4 * B * H * W * nh * dh * 2 + nh * (2 * kernel - 1) ** 2 * 2
    logits = B * H * W * nh * 2 * kernel * kernel * dh
    flops = logits + B * H * W * nh * (2 * kernel * kernel * dh + 4 * kernel * kernel)
    return nbytes, flops, logits


def na_qkv(g, B, H, W, nh, dh, kernel, dtype, dev):
    """q, k, v as DiNAT's attention hands them to K4 (views of one
    (B, H, W, 3, heads, dh) projection output, spread like a LayerNormed
    input through a fan-in-scaled Linear) and an rpb table."""
    qkv = torch.randn(B, H, W, 3, nh, dh, generator=g).to(dev, dtype)
    rpb = (torch.randn(nh, 2 * kernel - 1, 2 * kernel - 1, generator=g) * 0.5).to(dev, dtype)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb


def dinat_frame_layers(cfg, H, W, B=1):
    """(B, h, w, heads, dh, dilation) of each NAT layer of one DiNAT
    backbone pass over B (H, W) images."""
    c = cfg.backbone.dinat
    return [(B, H // 4 >> i, W // 4 >> i, c.num_heads[i], c.embed_dim * 2 ** i // c.num_heads[i], d)
            for i in range(len(c.depths)) for d in c.dilations[i]]


def flex_neighborhood(q, k, v, rpb, kernel, dilation):
    """The same function through one PyTorch call: flex_attention over the
    flattened map with the clamped window as its mask_mod and the rpb as its
    score_mod (exact where no window repeats a key). Returns (output in
    (B, H, W, heads, dh), the compiled call)."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    B, H, W, nh, dh = q.shape
    L, r = H * W, kernel // 2
    bias = rpb.float()

    def window(i, size):
        m, qd = i % dilation, i // dilation
        sub_len = (size - m + dilation - 1) // dilation
        start = torch.minimum(torch.clamp(qd - r, min=0), torch.clamp(sub_len - kernel, min=0))
        return m, qd, start

    def mask_mod(b, h, q_idx, kv_idx):
        (mh, _, sh), (mw, _, sw) = window(q_idx // W, H), window(q_idx % W, W)
        ki, kj = kv_idx // W, kv_idx % W
        return ((ki % dilation == mh) & (ki // dilation >= sh) & (ki // dilation < sh + kernel)
                & (kj % dilation == mw) & (kj // dilation >= sw) & (kj // dilation < sw + kernel))

    def score_mod(score, b, h, q_idx, kv_idx):
        # evaluated on masked-out pairs of a block too: clamp into the table
        rel_h = (kv_idx // W) // dilation - (q_idx // W) // dilation + kernel - 1
        rel_w = (kv_idx % W) // dilation - (q_idx % W) // dilation + kernel - 1
        return score + bias[h, rel_h.clamp(0, 2 * kernel - 2), rel_w.clamp(0, 2 * kernel - 2)]

    mask = create_block_mask(mask_mod, B=None, H=None, Q_LEN=L, KV_LEN=L, device=q.device, _compile=True)
    fn = torch.compile(flex_attention)
    heads = [x.reshape(B, L, nh, dh).transpose(1, 2) for x in (q, k, v)]

    def call():
        return fn(*heads, score_mod=score_mod, block_mask=mask, scale=1.0)

    return call().transpose(1, 2).reshape(B, H, W, nh, dh), call


def k4_launch_shape(lib, B, H, W, nh, kernel, dilation, bf16, rows=None):
    """(blocks, threads a block, dynamic shared memory bytes a block) of K4's
    launch at these shapes (for the query rows `rows` = (lo, hi) of the map
    under a row window), from the kernel's own plan."""
    fn = lib.na2d_launch_shape
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    blocks, threads, smem = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    lo, hi = (0, H) if rows is None else rows
    rc = fn(B, H, W, nh, kernel, dilation, int(bf16), lo, hi, ctypes.byref(blocks), ctypes.byref(threads),
            ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"K4 refuses {(B, H, W, nh, kernel, dilation)}: cudaError {rc}")
    return blocks.value, threads.value, smem.value


def k4_phase(dev, smi, usage):
    """K4 against its plain version at every NAT layer shape of a DiNAT-L
    backbone pass (configs/cityscapes_dinat.yaml) over a 1024x2048 frame and
    over a 192x512 pair (B=2; its small maps and large dilations give
    sub-grids shorter than the kernel), and at K4_EDGE_SHAPES, in bf16 and
    fp32; each shape's kernel, plain and bound times, blocks per launch,
    shared memory and registers per block (`usage`: ptxas's, per kernel);
    each pass's 30 launches summed; and at each layer of the frame the row
    window of each of phase spatial's SPATIAL_WORLD ranks (`measure_windows`:
    bf16 and fp32 against the plain version with the same window, bf16
    times and bound; each rank's 30 launches summed). Returns the kernels
    line's fields, at the frame's stage 0, dilation 1, bf16, and the
    compilation of its library yardstick there (`k4_library`), to be run
    later (`compile_yardstick`)."""
    from uni_encoder_tpu_torch import kernels
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d_cuda,
        neighborhood_attention_2d_lse_plain,
        neighborhood_attention_2d_plain,
        reach_rows,
    )

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), BACKBONE_CONFIGS["dinat"])).model
    kernel = cfg.backbone.dinat.kernel_size
    layers = dinat_frame_layers(cfg, SEG_H, SEG_W)
    pair_layers = dinat_frame_layers(cfg, SEQ_H, SEQ_W, B=2)  # forward_sequence: both frames in one pass
    lib = kernels.load("neighborhood_attention")
    regs = {("bf16" if "bf16" in name else "fp32"): u["registers"] for name, u in usage.items()}
    g = torch.Generator(device="cpu").manual_seed(4)

    def measure(shape, kernel):
        B, H, W, nh, dh, d = shape
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            key = "fp32" if dtype == torch.float32 else "bf16"
            q, k, v, rpb = na_qkv(g, B, H, W, nh, dh, kernel, dtype, dev)
            scale = dh ** -0.5
            with torch.inference_mode():
                got = neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, d, scale)
                ref = neighborhood_attention_2d_plain(q, k, v, rpb, kernel, d, scale)
                # the plain version computes in fp32 and rounds once, as the
                # kernel does, in another order
                err = compare_msda(got, ref, fp32=dtype == torch.float32, name=f"K4 {shape} kernel {kernel}")
                if not torch.equal(got, neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, d, scale)):
                    raise AssertionError(f"K4 rerun at {shape} {dtype} is not byte-identical")
                row[f"{key}_max_abs_err"] = err
                if dtype == torch.float32:  # the log-sum-exp K5 takes, with the window's repeats
                    lse = torch.empty((B, H, W, nh), dtype=torch.float32, device=dev)
                    if not torch.equal(got, neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, d, scale, lse)):
                        raise AssertionError(f"K4's output at {shape} changes with its lse output")
                    lse_ref = neighborhood_attention_2d_lse_plain(q, k, rpb, kernel, d, scale)
                    row["fp32_lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
                    if not torch.allclose(lse, lse_ref, atol=1e-5, rtol=1e-5):
                        raise AssertionError(f"K4's lse at {shape}: max abs err {row['fp32_lse_max_abs_err']}")
                    del lse, lse_ref
                call = lambda: neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, d, scale)  # noqa: E731
                row[f"{key}_ms"] = cuda_ms(call, 20)
                row[f"{key}_device_ms"] = cuda_graph_ms(call, 20)
                blocks, threads, smem = k4_launch_shape(lib, B, H, W, nh, kernel, d, key == "bf16")
                row[f"{key}_launch"] = {"blocks": blocks, "threads": threads, "smem_bytes": smem,
                                        "registers": regs[key] * threads}
                if dtype == torch.bfloat16:
                    row["plain_ms"] = cuda_ms(
                        lambda: neighborhood_attention_2d_plain(q, k, v, rpb, kernel, d, scale), 2)
                    row.update(bound_fields(*na_bound(B, H, W, nh, dh, kernel)))
                    if shape == layers[0] and kernel == cfg.backbone.dinat.kernel_size:
                        stage0.extend((q, k, v, rpb, ref, scale))
            del q, k, v, rpb, got, ref
        return row

    def measure_windows(shape):
        """K4 with a row window, as each of phase spatial's ranks calls it:
        the rank's query rows of the map, q, k and v read from one block of
        the rows their windows reach, against the plain version with the
        same window, bf16 and fp32; bf16 times and bound (the block's q, k
        and v rows read once, the output rows written once). One draw of
        the map a shape, on the card."""
        B, H, W, nh, dh, d = shape
        g_card = torch.Generator(device=dev).manual_seed(5)
        qkv32 = torch.randn((B, H, W, 3, nh, dh), generator=g_card, device=dev)
        rpb32 = torch.randn((nh, 2 * kernel - 1, 2 * kernel - 1), generator=g_card, device=dev) * 0.5
        rows = {}
        for r in range(SPATIAL_WORLD):
            lo, hi = H * r // SPATIAL_WORLD, H * (r + 1) // SPATIAL_WORLD
            k0, k1 = reach_rows(H, kernel, d, (lo, hi))
            row = rows[f"{shape} rank {r}"] = {"query_rows": [lo, hi], "key_rows": [k0, k1]}
            for dtype in (torch.float32, torch.bfloat16):
                key = "fp32" if dtype == torch.float32 else "bf16"
                block, rpb = qkv32[:, k0:k1].to(dtype), rpb32.to(dtype)
                args = (block[:, lo - k0:hi - k0, :, 0], block[:, :, :, 1], block[:, :, :, 2], rpb, kernel, d,
                        dh ** -0.5)
                with torch.inference_mode():
                    got = neighborhood_attention_2d_cuda(*args, rows=(H, lo, k0))
                    ref = neighborhood_attention_2d_plain(*args, rows=(H, lo, k0))
                    row[f"{key}_max_abs_err"] = compare_msda(got, ref, fp32=dtype == torch.float32,
                                                             name=f"K4 row window {shape} rows {lo}-{hi}")
                    if dtype == torch.bfloat16:
                        call = lambda: neighborhood_attention_2d_cuda(*args, rows=(H, lo, k0))  # noqa: E731
                        row["bf16_ms"] = cuda_ms(call, 20)
                        row["bf16_device_ms"] = cuda_graph_ms(call, 20)
                        row["bf16_launch"] = dict(zip(("blocks", "threads", "smem_bytes"),
                                                      k4_launch_shape(lib, B, H, W, nh, kernel, d, True, (lo, hi))))
                        nbytes, flops, logits = na_bound(B, hi - lo, W, nh, dh, kernel)
                        nbytes += 2 * B * (k1 - k0 - (hi - lo)) * W * nh * dh * 2  # k and v rows past the queries'
                        row.update(bound_fields(nbytes, flops, logits))
                del block, got, ref
        del qkv32, rpb32
        return rows

    stage0 = []
    shapes = {str(shape): measure(shape, kernel) for shape in sorted(set(layers) | set(pair_layers), reverse=True)}
    edges = {str(e): measure(e[:6], e[6]) for e in K4_EDGE_SHAPES}
    frame, pair = ({k: sum(shapes[str(s)][k] for s in ls)
                    for k in ("bf16_ms", "bf16_device_ms", "fp32_ms", "fp32_device_ms", "plain_ms", "bound_ms")}
                   for ls in (layers, pair_layers))
    # the row windows of phase spatial's ranks at each layer of the frame
    windows = {k: v for shape in sorted(set(layers), reverse=True) for k, v in measure_windows(shape).items()}
    window_frame = {f"rank{r}": {k: sum(windows[f"{s} rank {r}"][k] for s in layers)
                                 for k in ("bf16_ms", "bf16_device_ms", "bound_ms")} for r in range(SPATIAL_WORLD)}

    torch.cuda.empty_cache()
    B, H, W, nh, dh, _ = layers[0]
    emit("k4_vs_plain", kernel=kernel, dh_and_heads="from configs/cityscapes_dinat.yaml", shapes=shapes,
         edge_shapes_with_kernel=edges, frame={"layers": len(layers), **frame},
         row_windows={"world": SPATIAL_WORLD, "per_rank_frame": window_frame, "shapes": windows},
         pair={"layers": len(pair_layers), **pair}, library_stage0_dilation1="phase library_yardsticks",
         tolerance="fp32 atol/rtol 1e-5 (also the lse against torch.logsumexp of the plain logits); bf16 within 1 "
                   "ulp of the fp32-computed plain output + 1e-5",
         seconds=time.perf_counter() - t_phase, card=smi)
    s0 = shapes[str(layers[0])]
    rows = list(shapes.values()) + list(edges.values())
    return dict(max_abs_err=max(max(r["bf16_max_abs_err"], r["fp32_max_abs_err"]) for r in rows),
                lse_max_abs_err=max(r["fp32_lse_max_abs_err"] for r in rows),
                ms=s0["bf16_ms"], plain_ms=s0["plain_ms"], bound_ms=s0["bound_ms"], bound_by=s0["bound_by"],
                shape=[B, H, W, nh, dh, 1], fp32_ms=s0["fp32_ms"],
                frame_ms=frame["bf16_ms"], frame_plain_ms=frame["plain_ms"], frame_bound_ms=frame["bound_ms"],
                pair_ms=pair["bf16_ms"], pair_plain_ms=pair["plain_ms"], pair_bound_ms=pair["bound_ms"],
                device_ms=s0["bf16_device_ms"], frame_device_ms=frame["bf16_device_ms"],
                pair_device_ms=pair["bf16_device_ms"],
                row_window_max_abs_err=max(max(r["bf16_max_abs_err"], r["fp32_max_abs_err"])
                                           for r in windows.values()),
                row_window_frame_ms={r: f["bf16_ms"] for r, f in window_frame.items()},
                row_window_frame_device_ms={r: f["bf16_device_ms"] for r, f in window_frame.items()},
                row_window_stage0_ms=[windows[f"{layers[0]} rank {r}"]["bf16_ms"] for r in range(SPATIAL_WORLD)]
                ), lambda: k4_library(*stage0, kernel)


def k5_bound(B, H, W, nh, dh, kernel):
    """fp32: q, k, v and the output's gradient read once, dq, dk, dv and
    drpb written once (and the bias table read). The forward's output is
    not counted: the gradient needs only D = rowsum(dO . O) = sum P (dO . v),
    which the window walk can form, so reading O (as K5 does) is a choice of
    this design. Per query, head and window entry 5 dot products or scaled
    adds over dh (the logit q . k, dP = dO . v, and the dS k, dS q and P dO
    terms of dq, dk and dv) and 8 softmax operations, on the CUDA cores."""
    nbytes = (7 * B * H * W * nh * dh + 2 * nh * (2 * kernel - 1) ** 2) * 4
    flops = B * H * W * nh * kernel * kernel * (10 * dh + 8)
    return nbytes, flops


def k5_check(got, ref, B, H, W, dh):
    """tests/test_torch_port_cuda.py's tolerance, and the errors: dqkv atol
    2e-5 + rtol 1e-4 (up to k * k products per element, summed in another
    order), drpb atol 1e-6 * sqrt(B * H * W * dh) + rtol 1e-4 (each cell
    sums every query of a head, each term carrying the rounding of a dh-long
    dot product; where every window is one key the exact sum is 0)."""
    errs = {}
    for name, a, b, atol in (("dqkv", got[0], ref[0], 2e-5),
                             ("drpb", got[1], ref[1], 1e-6 * (B * H * W * dh) ** 0.5)):
        err = (a - b).abs()
        errs[name] = {"max_abs_err": err.max().item(), "max_rel_err": (err.max() / b.abs().max()).item()}
        if bool((err > atol + 1e-4 * b.abs()).any()):
            raise AssertionError(f"K5 {name} at {(B, H, W)}: {errs[name]}")
    return errs


def compile_yardstick(compile_fn):
    """Compile a library yardstick (`compile_fn()`: its fields and its
    compiled call, raising where it does not compile) into torch.compile's
    caches under build/, beside the kernels. It is compiled while this
    process waits for children (phases train_deterministic and
    multi_device), on the host's cores, and timed by `time_yardstick` once
    they are done. Returns (its fields with compile_s, the call or None)."""
    from uni_encoder_tpu_torch import kernels

    build = os.path.dirname(kernels.BUILD_DIR)
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(build, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    t0 = time.perf_counter()
    try:
        fields, call = compile_fn()
    except Exception as e:  # a yardstick only: its failure is reported, and the row says null
        fields, call = {"error": f"{type(e).__name__}: {str(e)[:400]}"}, None
    fields["compile_s"] = time.perf_counter() - t0
    return fields, call


def time_yardstick(compiled, context=contextlib.nullcontext):
    """A compiled yardstick's fields with `ms` (10 calls under `context`,
    the card otherwise idle), or with the error and no `ms` (the row then
    says null)."""
    fields, call = compiled
    if call is not None:
        try:
            with context():
                fields["ms"] = cuda_ms(call, 10)
        except Exception as e:  # a yardstick only
            fields["error"] = f"{type(e).__name__}: {str(e)[:400]}"
    return fields


def k4_library(q, k, v, rpb, ref, scale, kernel):
    """The library yardstick for K4 at stage 0, dilation 1 (no repeated
    keys there): torch.compile(flex_attention) (`flex_neighborhood`),
    compiled and held against the plain output; its call runs under
    torch.inference_mode, as it was compiled."""
    with torch.inference_mode():
        out, call = flex_neighborhood(q * scale, k, v, rpb, kernel, 1)
        torch.cuda.synchronize()
        return {"call": "torch.compile(flex_attention) with the window as mask_mod and rpb as score_mod",
                "max_abs_err_vs_plain": (out.float() - ref.float()).abs().max().item()}, call


def functorch_patch(**settings):
    """A context factory: torch._functorch's config patched by `settings`."""
    from torch._functorch import config as functorch_config

    return lambda: functorch_config.patch(**settings)


def k5_library(qkv, rpb, grad_out, dqkv, scale, kernel):
    """The library yardstick for K5 at dilation 1 (no repeated keys): the
    backward of torch.compile(flex_attention) (`flex_neighborhood`) for dq,
    dk and dv (its bias is a captured table: no drpb), compiled and held
    against K5's dqkv; its call is the backward alone on a retained graph,
    so it is compiled (and timed) without donated buffers."""
    with functorch_patch(donated_buffer=False)():
        leaf = qkv.clone().requires_grad_(True)
        out, _ = flex_neighborhood(leaf[:, :, :, 0] * scale, leaf[:, :, :, 1], leaf[:, :, :, 2], rpb, kernel, 1)
        grad = torch.autograd.grad(out, leaf, grad_out, retain_graph=True)[0]
        torch.cuda.synchronize()
    return ({"call": "backward of torch.compile(flex_attention), the window as mask_mod and rpb as score_mod: "
                     "dq, dk, dv", "max_abs_err_vs_k5_dqkv": (grad - dqkv).abs().max().item()},
            lambda: torch.autograd.grad(out, leaf, grad_out, retain_graph=True))


def k5_phase(dev, smi, usage):
    """K5, the backward of neighborhood attention, against autograd of the
    plain version at every NAT-layer shape of a DiNAT-L training step
    (configs/cityscapes_dinat.yaml; fp32): the crop pass (B=2, 512x1024)
    and the triples' pass (B=6: three 192x512 frames of 2 items; most of
    its sub-grids are shorter than the kernel), at K4_EDGE_SHAPES and at
    K5_STRESS_SHAPE; a rerun byte-identical; each shape's kernel time (20
    calls back to back, host included, and the device alone, replayed from a
    CUDA graph), plain time (autograd's backward alone), bound, blocks,
    shared memory and registers per block (`usage`: ptxas's, per kernel);
    each pass's 30 launches summed. Returns the kernels line's fields at the
    crop's stage 0, dilation 1, and the compilation of its library yardstick
    there (`k5_library`), to be run later (`compile_yardstick`)."""
    from uni_encoder_tpu_torch import kernels
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        _k5_launch_shape,
        _plain_logits,
        neighborhood_attention_2d_backward_cuda,
        neighborhood_attention_2d_cuda,
        neighborhood_attention_2d_plain,
    )

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), BACKBONE_CONFIGS["dinat"]))
    kernel = cfg.model.backbone.dinat.kernel_size
    TH, TW = cfg.input.seg_crop_train
    SH, SW = cfg.input.depth_hw_train
    crop = dinat_frame_layers(cfg.model, TH, TW, B=TRAIN_BATCH)
    triples = dinat_frame_layers(cfg.model, SH, SW, B=3 * TRAIN_BATCH)  # forward_sequence_train: one pass, 3 frames
    lib = kernels.load("neighborhood_attention_backward")
    regs = {k: max(u["registers"] for name, u in usage.items() if k in name) for k in K5_KERNELS}
    g = torch.Generator(device="cpu").manual_seed(5)

    def measure(shape, kernel, gain=None):
        B, H, W, nh, dh, d = shape
        if gain is None:
            qkv = torch.randn(B, H, W, 3, nh, dh, generator=g).to(dev)
            rpb = (torch.randn(nh, 2 * kernel - 1, 2 * kernel - 1, generator=g) * 0.5).to(dev)
            grad_out = torch.randn(B, H, W, nh, dh, generator=g).to(dev)
        else:  # tests/test_torch_port_cuda.py's draw, q and k times gain
            rng = np.random.RandomState(H * W + d)
            qkv = rng.randn(B, H, W, 3, nh, dh).astype(np.float32)
            qkv[:, :, :, :2] *= gain
            rpb = (0.5 * rng.randn(nh, 2 * kernel - 1, 2 * kernel - 1)).astype(np.float32)
            qkv, rpb = torch.from_numpy(qkv).to(dev), torch.from_numpy(rpb).to(dev)
            grad_out = torch.from_numpy(rng.randn(B, H, W, nh, dh).astype(np.float32)).to(dev)
        scale = dh ** -0.5
        with torch.no_grad():
            lse = torch.empty((B, H, W, nh), dtype=torch.float32, device=dev)
            out = neighborhood_attention_2d_cuda(qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb, kernel, d,
                                                 scale, lse)

        def call():
            return neighborhood_attention_2d_backward_cuda(qkv, rpb, out, lse, grad_out, kernel, d, scale)

        got = call()
        leaves = [qkv.clone().requires_grad_(True), rpb.clone().requires_grad_(True)]
        plain_out = neighborhood_attention_2d_plain(leaves[0][:, :, :, 0], leaves[0][:, :, :, 1],
                                                    leaves[0][:, :, :, 2], leaves[1], kernel, d, scale)

        def plain():
            return torch.autograd.grad(plain_out, leaves, grad_out, retain_graph=True)

        row = {"errors": k5_check(got, plain(), B, H, W, dh)}
        if gain is not None:
            row["logit_abs_max"] = _plain_logits(qkv[:, :, :, 0], qkv[:, :, :, 1], rpb, kernel, d,
                                                 scale).abs().max().item()
        again = call()
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(f"K5 rerun at {shape} kernel {kernel} is not byte-identical")
        row["max_abs_err"] = max(e["max_abs_err"] for e in row["errors"].values())
        row["ms"] = cuda_ms(call, 20)
        row["device_ms"] = cuda_graph_ms(call, 20)
        row["plain_ms"] = cuda_ms(plain, 2)
        blocks, threads, smem_a, smem_b = _k5_launch_shape(lib, B, H, W, nh, kernel, d)
        row["launch"] = {"blocks": blocks, "threads": threads, "query_pass_smem_bytes": smem_a,
                         "key_pass_smem_bytes": smem_b, "registers_per_thread": regs}
        row.update(bound_fields(*k5_bound(B, H, W, nh, dh, kernel)))
        if shape == crop[0] and kernel == cfg.model.backbone.dinat.kernel_size:
            stage0.extend((qkv, rpb, grad_out, got, scale))
        del out, got, again, leaves, plain_out
        return row

    stage0 = []
    shapes = {str(shape): measure(shape, kernel) for shape in sorted(set(crop) | set(triples), reverse=True)}
    edges = {str(e): measure(e[:6], e[6]) for e in K4_EDGE_SHAPES}
    edges[f"{K5_STRESS_SHAPE}: q, k x{K5_STRESS_SHAPE[7]}"] = measure(K5_STRESS_SHAPE[:6], *K5_STRESS_SHAPE[6:])
    torch.cuda.empty_cache()
    passes = {name: {"layers": len(ls), **{k: sum(shapes[str(s)][k] for s in ls)
                                           for k in ("ms", "device_ms", "plain_ms", "bound_ms")}}
              for name, ls in (("crop", crop), ("triples", triples))}

    qkv, rpb, grad_out, got, scale = stage0
    emit("k5_vs_plain", kernel=kernel, dtype="float32", shapes=shapes, edge_shapes_with_kernel=edges, **passes,
         library_stage0_dilation1="phase library_yardsticks",
         plain="autograd backward of neighborhood_attention_2d_plain",
         tolerance="dqkv atol 2e-5 + rtol 1e-4; drpb atol 1e-6 * sqrt(B*H*W*dh) + rtol 1e-4; reruns byte-identical",
         seconds=time.perf_counter() - t_phase, card=smi)
    s0 = shapes[str(crop[0])]
    rows = list(shapes.values()) + list(edges.values())
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), ms=s0["ms"], plain_ms=s0["plain_ms"],
                bound_ms=s0["bound_ms"], bound_by=s0["bound_by"],
                shape=list(crop[0][:5]) + [1], device_ms=s0["device_ms"], deterministic=True,
                crop_ms=passes["crop"]["ms"], crop_device_ms=passes["crop"]["device_ms"],
                crop_plain_ms=passes["crop"]["plain_ms"], crop_bound_ms=passes["crop"]["bound_ms"],
                triples_ms=passes["triples"]["ms"], triples_device_ms=passes["triples"]["device_ms"],
                triples_plain_ms=passes["triples"]["plain_ms"], triples_bound_ms=passes["triples"]["bound_ms"]), \
        lambda: k5_library(qkv, rpb, grad_out, got[0], scale, kernel)


def start_cpu_steps(tag, config, *specs):
    """The small step of `config` (a child's config argument) on the CPU, one
    child a spec of `specs` (`cpu_step_child`'s comma-separated steps), all
    started at once (`--cpu-step-child`); returns [(child, path)] in that
    order."""
    from uni_encoder_tpu_torch import kernels

    started = []
    for spec in map(str, specs):
        path = os.path.join(os.path.dirname(kernels.BUILD_DIR), f"{tag}_cpu_{spec.replace(',', '_')}.pt")
        child = start_child(CPU_STEP_CHILD, path, config, spec)
        kill_at_exit(child)
        started.append((child, path))
    return started


def train_backbones_phase(dev, smi, kernel_fns, dinat_deterministic, workspace, dinat_cpu_steps):
    """A full-width training step on each of configs/cityscapes_{r18,
    convnext,dinat}.yaml: fp32, TF32 off, a synthetic batch of TRAIN_BATCH
    512x1024 crops and TRAIN_BATCH 192x512 triples, random weights from
    seed 0; one warm-up step (its peak memory holds cuDNN's benchmarking),
    N_TRAIN_BACKBONE_TIMED timed (their peak is the steady one), one
    profiled. Fails unless the losses are finite, the parameters moved and
    the launches per step are exact (K2 and K3 6, K1 0, K4 and K5 60 on
    DiNAT-L, 0 on the others); on ResNet-18 the backbone's BatchNorm
    statistics must stay as stored. On DiNAT-L, one small step on the card
    against the CPU with the same draws (as train_reference_small, each
    quantity also allowed twice the difference between the CPU's step at
    DINAT_CPU_THREADS threads and at one thread; both CPU steps,
    `dinat_cpu_steps`, run in child processes started after the build),
    and `dinat_deterministic`, the two deterministic steps that phase
    train_deterministic's children took on that config (their runs and
    byte equality), against the card's small step. Returns each config's
    launches over its timed steps."""
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.training.train_step import Trainer

    launched = {}
    for name, path in BACKBONE_CONFIGS.items():
        t_phase = time.perf_counter()
        full_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), path)
        cfg = load_config(full_path)
        n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
        trainer = Trainer(cfg, device=dev)
        t0 = time.perf_counter()
        state = trainer.init(seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        seg_b, seq_b = train_batches(0, TRAIN_BATCH, cfg.input.seg_crop_train, cfg.input.depth_hw_train,
                                     TRAIN_SLOTS, TRAIN_VALID, n_texts, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        named = dict(state.model.named_parameters())
        params0 = {n: p.detach().clone() for n, p in named.items() if n.startswith("backbone.")}
        stats0 = {n: b.clone() for n, b in state.model.named_buffers() if "running_" in n}

        def step():
            return trainer.train_step(state, seg_b, seq_b, gen)[1]

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step()  # warm-up: cuDNN's benchmark of every convolution, the allocator
        torch.cuda.synchronize()
        warmup_ms = (time.perf_counter() - t0) * 1e3
        cold_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_launches(*kernel_fns.values())
        wall_ms, event_ms, metrics = [], [], []
        for _ in range(N_TRAIN_BACKBONE_TIMED):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            metrics.append(step())
            end.record()
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(start.elapsed_time(end))
        launched[name] = {k: f.launches for k, f in kernel_fns.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = profile_device(step, 1, float(np.median(wall_ms)))
        enc = cfg.model.sem_seg_head.transformer_enc_layers
        nat = 2 * sum(cfg.model.backbone.dinat.depths) if name == "dinat" else 0  # the crop pass and the triples'
        want = {"k1": 0, "k2": enc, "k3": enc, "k4": nat, "k5": nat}
        losses = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
        stats = dict(state.model.named_buffers())
        backbone_stats = [n for n in stats0 if n.startswith("backbone.")]
        checks = {
            "losses_finite": all(np.isfinite(v).all() for v in losses.values()),
            "launches": launched[name] == {k: n * N_TRAIN_BACKBONE_TIMED for k, n in want.items()},
            "backbone_params_moved": sum(not torch.equal(named[n], v) for n, v in params0.items())
            > 0.9 * len(params0),
            "decoder_bn_stats_moved": all(not torch.equal(stats[n], v) for n, v in stats0.items()
                                          if not n.startswith("backbone.")),
            "step_count": state.step == N_TRAIN_BACKBONE_TIMED + 2,
        }
        if name == "resnet":  # the JAX ResNet's batch_stats never move
            checks["backbone_bn_stats_as_stored"] = bool(backbone_stats) and all(
                torch.equal(stats[n], stats0[n]) for n in backbone_stats)
        fields = {}
        del trainer, state, named, params0, stats0, stats, seg_b, seq_b, metrics
        torch.cuda.empty_cache()
        if name == "dinat":
            # the card against the CPU on a small step, the same weights and
            # draws; and the CPU against itself at one thread (the child's):
            # on this random DiNAT-L the RANSAC ground-plane fit (condition
            # numbers to 4e6) and the pose and motion decoders' gradients
            # move by up to 2% and 4% with the order of fp32 sums alone
            watched = WATCHED_DINAT
            small = {}
            m, grads, _ = small_train_step(Trainer, cfg, dev, watched=watched)
            small["cuda"] = ({k: float(v) for k, v in m.items()}, {n: v.cpu() for n, v in grads.items()})
            del m, grads
            t0 = time.perf_counter()
            ref_run, one_thread = finish_children(*zip(*dinat_cpu_steps), timeout=600)
            noise_wait_s = time.perf_counter() - t0
            small["cpu"] = (ref_run[DINAT_CPU_THREADS]["losses"], ref_run[DINAT_CPU_THREADS]["grads"])
            noise = (one_thread[1]["losses"], one_thread[1]["grads"])
            cpu_steps = (noise, small["cpu"])
            loss_err, grad_err = small_step_errors("train_backbones dinat small", small["cuda"], small["cpu"],
                                                   watched, cpu_steps)
            noise_loss, noise_grad = step_differences(*cpu_steps, watched)
            # two deterministic steps in two processes: the same bytes
            runs, equal = dinat_deterministic
            det = ({k: float(v) for k, v in runs[0]["losses"].items()}, runs[0]["grads"])
            det_loss_err, det_grad_err = small_step_errors("train_backbones dinat deterministic", det,
                                                           small["cuda"], watched, cpu_steps)
            checks.update({f"deterministic_{k}_byte_equal": v for k, v in equal.items()})
            fields = {"reference_small": {"segmentation": [TRAIN_BATCH, 128, 256, 3],
                                          "sequence": [TRAIN_BATCH, 3, 64, 128, 3], "loss_abs_err": loss_err,
                                          "grad_relative_norm_err": grad_err,
                                          "cpu_threads": [DINAT_CPU_THREADS, 1],
                                          "cpu_children_wait_s": noise_wait_s,
                                          "cpu_vs_cpu_loss_abs_err": noise_loss,
                                          "cpu_vs_cpu_grad_relative_norm_err": noise_grad,
                                          "tolerance": "losses atol 1e-4 + rtol 1e-3; gradients |cuda - cpu| / "
                                                       "|cpu| < 1e-3; or within twice the CPU's own difference "
                                                       "at the other thread count"},
                      "deterministic": {"children": len(runs), "in_phase": "train_deterministic",
                                        "cublas_workspace_config": workspace,
                                        "child_step_s": [r["seconds"] for r in runs], "byte_equal": equal,
                                        "vs_default_step": {"loss_abs_err": det_loss_err,
                                                            "grad_relative_norm_err": det_grad_err}}}
            del small, runs, dinat_deterministic
        emit("train_backbones", config=path, backbone=name, dtype="float32", tf32=False,
             batch={"segmentation": [TRAIN_BATCH, *cfg.input.seg_crop_train, 3],
                    "sequence": [TRAIN_BATCH, 3, *cfg.input.depth_hw_train, 3], "target_slots": TRAIN_SLOTS,
                    "valid": TRAIN_VALID, "texts": n_texts},
             init_s=init_s, warmup_ms=warmup_ms, steps_timed=N_TRAIN_BACKBONE_TIMED, step_wall_ms=wall_ms,
             step_event_ms=event_ms, kernel_ms_per_step=prof["kernel_ms"],
             busy_share_untraced=prof["busy_share_untraced"], kernel_launches_per_step=prof["kernel_launches"],
             top_kernels_ms_per_step=prof["top_kernels_ms"], launches=launched[name],
             cold_step_peak_memory_gb=cold_peak_gb, steady_peak_memory_gb=peak_gb, losses=losses, checks=checks,
             **fields, seconds=time.perf_counter() - t_phase, card=smi)
        fail_unless(f"train_backbones {name}", checks)
    return launched


@contextlib.contextmanager
def cudnn_benchmark_limit(limit):
    """Within the block, cuDNN's benchmark tries `limit` algorithms a
    convolution."""
    saved = torch.backends.cudnn.benchmark_limit
    torch.backends.cudnn.benchmark_limit = limit
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark_limit = saved


@contextlib.contextmanager
def recorded_k3_calls(shapes):
    """Within the block, records the inputs of the first K3 call whose level
    grids are `shapes` (clones: value, offsets, logits, ref_abs, grad_out)
    into the yielded list, from the backward of the autograd function that
    launches it; the call itself runs and counts as it would."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import _FusedCuda

    backward = _FusedCuda.backward
    seen = []

    def recording(ctx, grad_out):
        if not seen and tuple(map(tuple, ctx.spatial_shapes)) == tuple(shapes):
            seen.append((tuple(ctx.spatial_shapes),
                         *(x.detach().clone() for x in (*ctx.saved_tensors, grad_out.contiguous()))))
        return backward(ctx, grad_out)

    _FusedCuda.backward = staticmethod(recording)
    try:
        yield seen
    finally:
        _FusedCuda.backward = staticmethod(backward)


def k3_on_recorded_call(seen):
    """K3 against autograd of its plain version on a `recorded_k3_calls`
    call, at k3_vs_plain's tolerance (it raises past it)."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_backward_cuda, ms_deform_attn_fused_plain

    (shapes, value, off, logits, ref_abs, grad_out), = seen
    got = ms_deform_attn_fused_backward_cuda(value, shapes, off, logits, ref_abs, grad_out)
    leaves = [x.clone().requires_grad_(True) for x in (value, off, logits)]
    ref = torch.autograd.grad(ms_deform_attn_fused_plain(leaves[0], shapes, leaves[1], leaves[2], ref_abs), leaves,
                              grad_out)
    err = {}
    for name, a, b in zip(("value", "offsets", "logits"), got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=f"K3 on the recorded call, grad {name}")
        err[name] = (a - b).abs().max().item()
    return {"max_abs_err": err, "value_shape": list(value.shape), "level_grids": [list(g) for g in shapes],
            "tolerance": "atol/rtol 1e-4 (k3_vs_plain's)"}


def train_decoders_phase(dev, smi, kernel_fns, cpu_steps):
    """A full-width training step on Swin-T with each DECODER_MODELS pair
    (configs/cityscapes_swin_unified.yaml and the decoder names' overrides):
    fp32, TF32 off, train's batch (TRAIN_BATCH 512x1024 crops, TRAIN_SLOTS
    target slots of which TRAIN_VALID valid, TRAIN_BATCH 192x512 triples),
    random weights from seed 0; one warm-up step (its peak holds cuDNN's
    benchmarking), N_TRAIN_DECODER_TIMED timed, one profiled. Fails unless
    the losses are finite, every parameter with a gradient moved, DCMNet's
    stored BatchNorm statistics stay as stored (the JAX DCMNet builds its
    FrozenBatchNorm with them in training), and the launches per step are
    exact: K2 and K3 6 for the segmentation side's deformable encoder
    where it runs and 6 more for DepthMSDeformAttn's on the sequence side,
    K1, K4 and K5 none. On the DepthMSDeformAttn model K3 is held against
    its plain version on the warm-up step's first sequence-side call. Then
    the small step on the card against the CPU's (`cpu_steps`: by model,
    the (child, path) of start_cpu_steps taking DECODER_CPU_STEPS: the
    reference at 2 threads, the step again at one thread and at one thread
    from ulp-moved images), small_step_errors' rule with both probes. Returns each model's launches over its timed
    steps."""
    from uni_encoder_tpu_torch.training.train_step import Trainer

    launched = {}
    for key, (pixel, depth) in DECODER_MODELS.items():
        t_model = time.perf_counter()
        cfg = decoder_config(key)
        n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
        trainer = Trainer(cfg, device=dev)
        t0 = time.perf_counter()
        state = trainer.init(seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        seg_b, seq_b = train_batches(0, TRAIN_BATCH, cfg.input.seg_crop_train, cfg.input.depth_hw_train,
                                     TRAIN_SLOTS, TRAIN_VALID, n_texts, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        named = dict(state.model.named_parameters())
        params0 = {n: p.detach().clone() for n, p in named.items()}
        stats0 = {n: b.clone() for n, b in state.model.named_buffers() if "running_" in n}

        def step():
            return trainer.train_step(state, seg_b, seq_b, gen)[1]

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sequence_msda = depth.startswith("DepthMSDeformAttn")
        h, w = cfg.input.depth_hw_train
        seq_grids = tuple((h // st, w // st) for st in (32, 16, 8))  # the deformable encoder's levels, res5 first
        t0 = time.perf_counter()
        with cudnn_benchmark_limit(DECODER_CUDNN_BENCHMARK_LIMIT), \
                (recorded_k3_calls(seq_grids) if sequence_msda else contextlib.nullcontext([])) as k3_seen:
            step()  # warm-up: cuDNN's benchmark of every new convolution, the allocator
            torch.cuda.synchronize()
        warmup_ms = (time.perf_counter() - t0) * 1e3
        cold_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_launches(*kernel_fns.values())
        wall_ms, event_ms, metrics = [], [], []
        for _ in range(N_TRAIN_DECODER_TIMED):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            metrics.append(step())
            end.record()
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(start.elapsed_time(end))
        launched[key] = {k: f.launches for k, f in kernel_fns.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        prof = profile_device(step, 1, float(np.median(wall_ms)))
        profile_s = time.perf_counter() - t0
        enc = cfg.model.sem_seg_head.transformer_enc_layers
        msda_calls = enc * (int(pixel.startswith("MSDeformAttn")) + int(sequence_msda))
        want = {"k1": 0, "k2": msda_calls, "k3": msda_calls, "k4": 0, "k5": 0}
        losses = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
        stats = dict(state.model.named_buffers())
        with_grad = [n for n, p in named.items() if p.grad is not None]
        frozen = [n for n in stats0 if n.startswith("sem_seg_head.depth_decoder.")]  # DCMNet's
        checks = {
            "losses_finite": all(np.isfinite(v).all() for v in losses.values()),
            "launches": launched[key] == {k: n * N_TRAIN_DECODER_TIMED for k, n in want.items()},
            "params_with_grad_moved": bool(with_grad) and all(not torch.equal(named[n], params0[n])
                                                               for n in with_grad),
            "depth_decoder_bn_stats_as_stored": bool(frozen) == (depth == "DCMNet") and all(
                torch.equal(stats[n], stats0[n]) for n in frozen),
            "other_bn_stats_moved": all(not torch.equal(stats[n], v) for n, v in stats0.items() if n not in frozen),
            "step_count": state.step == N_TRAIN_DECODER_TIMED + 2,
        }
        k3_sequence = k3_on_recorded_call(k3_seen) if sequence_msda else None
        n_params, n_with_grad = len(named), len(with_grad)
        del trainer, state, named, params0, stats0, stats, seg_b, seq_b, metrics, k3_seen
        torch.cuda.empty_cache()

        # the small step on the card against the CPU's, the same weights and
        # draws; and the CPU against itself at one thread
        watched = WATCHED_SHARED + WATCHED_DECODERS[key]
        t0 = time.perf_counter()
        with cudnn_benchmark_limit(DECODER_CUDNN_BENCHMARK_LIMIT):
            m, grads, _ = small_train_step(Trainer, cfg, dev, watched=watched + UNHELD_DECODERS)
        card = ({k: float(v) for k, v in m.items()}, {n: v.cpu() for n, v in grads.items()})
        del m, grads
        small_s = time.perf_counter() - t0
        child, path = cpu_steps[key]
        t0 = time.perf_counter()
        (cpu,) = finish_children([child], [path], timeout=600)
        cpu_wait_s = time.perf_counter() - t0
        ref, *probes = ((cpu[cpu_step_key(spec)]["losses"], cpu[cpu_step_key(spec)]["grads"])
                        for spec in DECODER_CPU_STEPS)
        loss_err, grad_err = step_differences(card, ref, watched + UNHELD_DECODERS)
        noise = {spec: step_differences(probe, ref, watched + UNHELD_DECODERS)
                 for spec, probe in zip(DECODER_CPU_STEPS[1:], probes)}
        emit("train_decoders", model=key, pixel_decoder=pixel, depth_decoder=depth, config=TRAIN_ENTRY_CONFIG,
             overrides=decoder_overrides(key), dtype="float32", tf32=False,
             batch={"segmentation": [TRAIN_BATCH, *cfg.input.seg_crop_train, 3],
                    "sequence": [TRAIN_BATCH, 3, *cfg.input.depth_hw_train, 3], "target_slots": TRAIN_SLOTS,
                    "valid": TRAIN_VALID, "texts": n_texts},
             init_s=init_s, warmup_ms=warmup_ms, steps_timed=N_TRAIN_DECODER_TIMED, step_wall_ms=wall_ms,
             step_event_ms=event_ms, kernel_ms_per_step=prof["kernel_ms"],
             busy_share_untraced=prof["busy_share_untraced"], kernel_launches_per_step=prof["kernel_launches"],
             top_kernels_ms_per_step=prof["top_kernels_ms"], launches=launched[key], launches_wanted_per_step=want,
             profile_s=profile_s, parameters=n_params, parameters_with_grad=n_with_grad,
             cold_step_peak_memory_gb=cold_peak_gb,
             steady_peak_memory_gb=peak_gb, losses=losses, k3_sequence_vs_plain=k3_sequence,
             reference_small={"segmentation": [TRAIN_BATCH, 128, 256, 3],
                              "sequence": [TRAIN_BATCH, 3, *small_seq_hw(cfg.model), 3],
                              "loss_abs_err": loss_err, "grad_relative_norm_err": grad_err,
                              "cpu_steps": list(DECODER_CPU_STEPS), "card_step_s": small_s,
                              "cpu_child_wait_s": cpu_wait_s,
                              "cpu_vs_cpu_loss_abs_err": {spec: n[0] for spec, n in noise.items()},
                              "cpu_vs_cpu_grad_relative_norm_err": {spec: n[1] for spec, n in noise.items()},
                              "unheld": list(UNHELD_DECODERS),
                              "tolerance": "losses atol 1e-4 + rtol 1e-3; gradients |cuda - cpu| / |cpu| < 1e-3; "
                                           "or within twice the larger of the CPU's own differences between "
                                           "2 threads and 1 thread, and 1 thread from images moved by one ulp"},
             checks=checks, seconds=time.perf_counter() - t_model, card=smi)
        fail_unless(f"train_decoders {key}", checks)
        small_step_errors(f"train_decoders {key} small", card, ref, watched, [(p, ref) for p in probes])
    return launched


def tools_phase(dev, smi, kernel_fns):
    """The port's tools on the card: tools/calc_throughput_torch.py on the
    default config at its defaults (192x512, 20 targets) but TRAIN_BATCH
    items a modality and TOOLS_THROUGHPUT_ITERS iterations, and
    tools/analyze_model_torch.py
    with every task at its defaults (512x1024, TOOLS_ANALYZE_ITERS
    forwards). Fails unless the loss is finite, K2 and K3 ran 6 times a
    step, K2 6 times a forward, and K1, K4 and K5 never. Returns each
    tool's launches."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import analyze_model_torch
    import calc_throughput_torch
    from uni_encoder_tpu_torch.config import Config

    cfg = Config()
    enc = cfg.model.sem_seg_head.transformer_enc_layers
    t0 = time.perf_counter()
    reset_launches(*kernel_fns.values())
    thr = calc_throughput_torch.throughput(cfg, batch=TRAIN_BATCH, iters=TOOLS_THROUGHPUT_ITERS, device=dev)
    launched = {"calc_throughput": {k: f.launches for k, f in kernel_fns.items()}}
    throughput_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_launches(*kernel_fns.values())
    ana = analyze_model_torch.analyze(cfg, analyze_model_torch.TASKS, iters=TOOLS_ANALYZE_ITERS, device=dev)
    launched["analyze_model"] = {k: f.launches for k, f in kernel_fns.items()}
    analyze_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    checks = {
        "throughput_loss_finite": bool(np.isfinite(thr["loss"])),
        "throughput_launches": launched["calc_throughput"] == {
            "k1": 0, "k2": enc * TOOLS_THROUGHPUT_ITERS, "k3": enc * TOOLS_THROUGHPUT_ITERS, "k4": 0, "k5": 0},
        "analyze_launches": launched["analyze_model"] == {"k1": 0, "k2": enc * ana["forwards"], "k3": 0, "k4": 0,
                                                          "k5": 0},
        "analyze_fields": ana["params_total"] > 0 and ana["flops"] > 0 and ana["activation_peak_bytes"] > 0,
    }
    emit("tools", calc_throughput={"config": "default", "batch": TRAIN_BATCH, "hw": [192, 512], "targets": 20,
                                   "iters": TOOLS_THROUGHPUT_ITERS, "img_per_s": thr["img_per_s"],
                                   "ms_per_step": thr["ms_per_step"], "loss": thr["loss"], "seconds": throughput_s},
         analyze_model={"config": "default", "hw": [512, 1024], "dtype": cfg.model.dtype,
                        "params_m": ana["params_total"] / 1e6, "params_sequence_heads_m":
                        ana["params_sequence_heads"] / 1e6, "gflop": ana["flops"] / 1e9,
                        "activation_peak_gb": ana["activation_peak_bytes"] / 1e9, "ms_per_img": ana["ms_per_img"],
                        "forwards": ana["forwards"], "seconds": analyze_s},
         launches=launched, tf32=False, checks=checks, card=smi)
    fail_unless("tools", checks)
    return launched


def serve_kinds(model, cfg, seg_inputs, pair, kernel_fns, want, n_requests, disp_stride=1, disp_low=0.01):
    """Serve `model` as a server does: segmentation requests (`seg_inputs`:
    images, tokens, thing mask) through serve_segmentation and sequence
    requests (`pair`: current, previous) through serve_sequence. Per kind a
    warm-up (cuDNN's plans for these shapes, the allocator), `n_requests`
    with the kernels' launches read and held to `want` per request, and one
    more profiled. Returns (per-kind fields, checks, per-kind launches, the
    last segmentation request's (outputs, post-processes)); the sequence
    checks take the disparity at 1 / `disp_stride` in [disp_low, 1]."""
    images = seg_inputs[0]
    kinds = {"segmentation": lambda: serve_segmentation(model, *seg_inputs),
             "sequence": lambda: serve_sequence(model, *pair)}
    fields, checks, launched = {}, {}, {}
    for kind, fn in kinds.items():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        warmup_ms = (time.perf_counter() - t0) * 1e3
        reset_launches(*kernel_fns.values())
        wall_ms = []
        for _ in range(n_requests):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
        launched[kind] = {k: f.launches for k, f in kernel_fns.items()}
        checks[f"{kind}_launches"] = launched[kind] == {k: n * n_requests for k, n in want[kind].items()}
        if kind == "segmentation":
            served = out
            out, posts = out
            Qm = cfg.one_former.num_object_queries
            H, W = images.shape[1:3]
            checks["pred_logits"] = tuple(out["pred_logits"].shape) == (1, Qm, cfg.sem_seg_head.num_classes + 1)
            checks["pred_masks"] = tuple(out["pred_masks"].shape) == (1, Qm, H // 4, W // 4)
            checks["finite_logits"] = bool(torch.isfinite(out["pred_logits"]).all()
                                           and torch.isfinite(out["pred_masks"]).all())
            checks["maps_u8"] = all(posts[0][k].dtype == torch.uint8 and tuple(posts[0][k].shape) == (H, W)
                                    for k in ("sem_seg_argmax", "panoptic_seg"))
            checks["finite_scores"] = bool(torch.isfinite(posts[0]["scores"]).all())
        else:
            H, W = pair[0].shape[1:3]
            checks.update({f"sequence_{k}": v for k, v in
                           check_sequence_outputs(out, 1, H, W, disp_stride, disp_low).items()})
        prof = profile_device(fn, 1, float(np.median(wall_ms)))
        fields[kind] = {"warmup_ms": warmup_ms, "request_wall_ms": wall_ms,
                        "device_ms_per_request": prof["kernel_ms"],
                        "busy_share_untraced": prof["busy_share_untraced"],
                        "kernel_launches_per_request": prof["kernel_launches"],
                        "top_kernels_ms": prof["top_kernels_ms"]}
    return fields, checks, launched, served


def small_output_check(got, ref, atol, rtol, other=None, outliers=False):
    """The card's `got` against the CPU's `ref`, elementwise within atol +
    rtol |ref|. With `other` (the CPU's own result at one thread, `ref`
    being at this process's count: the same function in another order of
    fp32 sums), an element past that bound also passes where it lies within
    atol + rtol |other| of `other`, for up to SMALL_CPU_CROSSED of the
    elements. With `outliers` (end to end pred_*), up to SMALL_PRED_OUTLIERS
    of the elements may lie past the bound besides, each within
    SMALL_PRED_MAX_ERR. Returns (the errors and counts, whether the check
    holds)."""
    err = (got - ref).abs()
    over = err > atol + rtol * ref.abs()
    fields = {"max_abs_err": err.max().item(), "ref_max_abs": ref.abs().max().item(),
              "beyond_tolerance": int(over.sum()), "elements": over.numel()}
    ok = True
    if other is not None:
        spread = (other - ref).abs()
        matched = over & ((got - other).abs() <= atol + rtol * other.abs())
        over = over & ~matched
        fields.update(cpu_1_thread_max_abs_diff=spread.max().item(),
                      cpu_1_thread_beyond_tolerance=int((spread > atol + rtol * ref.abs()).sum()),
                      passed_against_cpu_1_thread=int(matched.sum()))
        ok = int(matched.sum()) <= SMALL_CPU_CROSSED * over.numel()
    if outliers:
        return fields, (ok and int(over.sum()) <= SMALL_PRED_OUTLIERS * over.numel()
                        and err.max().item() <= SMALL_PRED_MAX_ERR)
    return fields, ok and not bool(over.any())


def card_against_cpu(cfg, rng, tokens, dev, checks):
    """The model `cfg` on the card (its kernels, fp32, TF32 off) against the
    CPU (the plain versions) on a 128x256 image and a 64x128 pair drawn from
    `rng`, random weights from seed 0 (class head x8): stage by stage, so
    that a difference is placed where it starts; the CPU first, so that the
    card's query decoder is also fed the CPU's pixel-decoder outputs and held
    alone (query_decoder_*). The backbone's features, the pixel decoder's
    outputs, the query decoder fed the CPU's inputs and the sequence outputs
    (the depth decoder's disparity at every scale, `disp_{s}`) at atol 1e-4,
    rtol 1e-3; end to end pred_logits and pred_masks at atol 5e-3, rtol 1e-3
    for all but SMALL_PRED_OUTLIERS of their elements, each within
    SMALL_PRED_MAX_ERR (small_output_check). An element of the query
    decoder's outputs (query_decoder_* and pred_*) past its bound also
    passes where it lies within that bound of the CPU's own query decoder
    run on the same inputs at one thread, for up to SMALL_CPU_CROSSED of the
    elements: its masked attention thresholds its own mask logits, so the
    order of fp32 sums alone can flip a mask bit and move the queries'
    outputs. Adds a check per output to `checks`; returns the errors."""
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    small = torch.from_numpy(rng.randn(1, 128, 256, 3).astype(np.float32))
    small_pair = [torch.from_numpy(rng.randn(1, 64, 128, 3).astype(np.float32)) for _ in range(2)]
    outs = {}
    for dname, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        m = UniEncoder(cfg, device=d, dtype=torch.float32, seed=0)
        with torch.no_grad():
            m.predictor.class_embed.weight.mul_(8.0)
        with torch.inference_mode():
            feats = m.backbone(small.to(d))
            mask_features, _, multi_scale = m.pixel_decoder(feats)
            task = m.task_mlp(tokens.to(d, torch.float32))
            if dname == "cpu":
                decoder_in = ([x.to(dev) for x in multi_scale], mask_features.to(dev), task.to(dev))
                alone = m.predictor(multi_scale, mask_features, task)
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    alone_1 = m.predictor(multi_scale, mask_features, task)
                finally:
                    torch.set_num_threads(threads)
                one_thread = {k: alone_1[k] for k in ("pred_logits", "pred_masks")}
                del alone_1
            else:
                alone = m.predictor(*decoder_in)
            outs[dname] = {**{f"backbone_{k}": v for k, v in feats.items()}, "mask_features": mask_features,
                           **{f"pixel_decoder_{i}": v for i, v in enumerate(multi_scale)},
                           **{f"query_decoder_{k}": alone[k] for k in ("pred_logits", "pred_masks")},
                           **m.forward_segmentation(small.to(d), tokens.to(d))}
            seq = serve_sequence(m, *(x.to(d) for x in small_pair))
            outs[dname].update({k: seq[k] for k in ("disp", "complete_flow", "motion_mask", "cam_T_cam")})
            outs[dname].update({f"disp_{s}": v for (_, s), v in seq["disps"].items()})
        del m
    del decoder_in
    # fp32 with TF32 off; cuBLAS, cuDNN, K2 and K4 sum in other orders than the CPU
    tolerances = {k: (1e-4, 1e-3) for k in outs["cpu"]
                  if k.startswith(("backbone_", "pixel_decoder_", "query_decoder_", "disp_"))}
    tolerances.update({"mask_features": (1e-4, 1e-3), "pred_logits": (5e-3, 1e-3), "pred_masks": (5e-3, 1e-3),
                       "disp": (1e-4, 1e-3), "complete_flow": (1e-4, 1e-3), "motion_mask": (1e-4, 1e-3),
                       "cam_T_cam": (1e-4, 1e-3)})
    small_errs = {}
    for k, (atol, rtol) in tolerances.items():
        # end to end (pred_*), the query decoder thresholds its own mask
        # logits at 0 for its masked attention, so the pixel decoder's fp32
        # noise can flip a mask bit and move a few outputs past the
        # tolerance: up to SMALL_PRED_OUTLIERS of the elements, by at most
        # SMALL_PRED_MAX_ERR; fed the CPU's inputs (query_decoder_*), the
        # decoder has no outlier beyond the elements that agree with the
        # CPU's own result at one thread
        decoder_key = k.removeprefix("query_decoder_")
        small_errs[k], checks[f"small_{k}"] = small_output_check(
            outs["cuda"][k].cpu().float(), outs["cpu"][k].float(), atol, rtol, one_thread.get(decoder_key),
            outliers=k.startswith("pred_"))
    del outs
    torch.cuda.empty_cache()
    return small_errs


def backbones_phase(dev, smi, kernel_fns):
    """The three backbone configs (read by the port's YAML reader) at full
    width and depth, random weights from seed 0 (class head x8), bf16:
    N_BACKBONE_REQUESTS 1024x2048 panoptic requests through
    serve_segmentation and as many 192x512 pairs through serve_sequence,
    each kind with the launch counts read (K1 1 and K2 6 per segmentation
    request, K4 one per NAT layer per backbone pass, K3 never) and once more
    profiled; then the card (its kernels, fp32, TF32 off) against the CPU
    (the plain versions) on a small input. Returns each config's launches."""
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    launched = {}
    for name, path in BACKBONE_CONFIGS.items():
        t_phase = time.perf_counter()
        cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), path)).model
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = UniEncoder(cfg, device=dev, dtype=torch.bfloat16, seed=0)
        with torch.no_grad():
            model.predictor.class_embed.weight.mul_(8.0)
        build_s = time.perf_counter() - t0
        nat_layers = sum(cfg.backbone.dinat.depths) if name == "dinat" else 0
        enc_layers = cfg.sem_seg_head.transformer_enc_layers
        rng = np.random.RandomState(0)
        images = torch.from_numpy(rng.randn(1, SEG_H, SEG_W, 3).astype(np.float32)).to(dev, torch.bfloat16)
        cur, prev = (torch.from_numpy(rng.randn(1, SEQ_H, SEQ_W, 3).astype(np.float32)).to(dev, torch.bfloat16)
                     for _ in range(2))
        tokens = torch.tensor([tokenize_task(TASK)], dtype=torch.int64, device=dev)
        thing = torch.isin(torch.arange(cfg.sem_seg_head.num_classes), torch.arange(11, 19)).to(dev)
        want = {"segmentation": {"k1": 1, "k2": enc_layers, "k3": 0, "k4": nat_layers, "k5": 0},
                "sequence": {"k1": 0, "k2": 0, "k3": 0, "k4": nat_layers, "k5": 0}}
        fields, checks, launched[name], _ = serve_kinds(model, cfg, (images, tokens, thing), (cur, prev), kernel_fns,
                                                        want, N_BACKBONE_REQUESTS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        params = sum(p.numel() for p in model.backbone.parameters())
        del model
        torch.cuda.empty_cache()

        small_errs = card_against_cpu(cfg, rng, tokens, dev, checks)
        emit("backbones", config=path, backbone=name, backbone_parameters=params, dtype="bfloat16",
             requests=N_BACKBONE_REQUESTS, image=[1, SEG_H, SEG_W, 3], pair=[1, SEQ_H, SEQ_W, 3],
             model_build_s=build_s, launches=launched[name], **fields, peak_memory_gb=peak_gb, checks=checks,
             reference_small={"image": [1, 128, 256, 3], "pair": [1, 64, 128, 3], "errors": small_errs,
                              "tolerance": SMALL_TOLERANCE},
             seconds=time.perf_counter() - t_phase, card=smi)
        fail_unless(f"backbones {name}", checks)
    return launched


def offpath_modules_against_cpu(dev, rng):
    """The modules no config selects, each at its full width on a 192x512
    input, random weights from seed 0, fp32, TF32 off: the card (cuBLAS,
    cuDNN) against the CPU at atol 1e-4, rtol 1e-3 (the sequence outputs'
    tolerance). MonodepthDecoder and MotionDecoderV1 (both output kinds) on
    a monodepth2 pyramid drawn from `rng` (MONODEPTH2_PYRAMID, and an
    8-channel full-resolution input), Monodepth2PoseModel on a 6-channel
    frame pair, ContextDecoder at its defaults (width 256, 6 layers,
    visual_dim 1024) on CONTEXT_TEXT / CONTEXT_VISUAL. Returns per module its
    inputs' shapes and errors, and the checks."""
    import copy

    from uni_encoder_tpu_torch.models.layers import random_init_
    from uni_encoder_tpu_torch.models.monodepth2_pose import Monodepth2PoseModel
    from uni_encoder_tpu_torch.models.motion_decoder import MotionDecoderV1
    from uni_encoder_tpu_torch.models.pixel_decoders.monodepth2 import MonodepthDecoder
    from uni_encoder_tpu_torch.models.text_transformer import ContextDecoder

    f32 = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))  # noqa: E731
    pyramid = {k: f32(1, SEQ_H // s, SEQ_W // s, c) for k, (s, c) in MONODEPTH2_PYRAMID.items()}
    pyramid_v1 = {"full_res_input": f32(1, SEQ_H, SEQ_W, 8), **pyramid}
    ego = f32(1, 1, 1, 6) * 0.01
    chans = {k: c for k, (_, c) in MONODEPTH2_PYRAMID.items()}
    cases = {
        "MonodepthDecoder": (MonodepthDecoder(chans), (pyramid,)),
        "MotionDecoderV1_flow": (MotionDecoderV1({"full_res_input": 8, **chans}, out_dim=3), (pyramid_v1, ego)),
        "MotionDecoderV1_mask": (MotionDecoderV1({"full_res_input": 8, **chans}, out_dim=1), (pyramid_v1, ego)),
        "Monodepth2PoseModel": (Monodepth2PoseModel(), (f32(1, SEQ_H, SEQ_W, 6),)),
        "ContextDecoder": (ContextDecoder(), (f32(*CONTEXT_TEXT), f32(*CONTEXT_VISUAL))),
    }
    results, checks = {}, {}

    def flat(out):
        if isinstance(out, dict):
            return {str(k): v for k, v in out.items()}
        if isinstance(out, tuple):
            return {str(i): v for i, v in enumerate(out)}
        return {"out": out}

    def to(args, d):
        return tuple({k: v.to(d) for k, v in a.items()} if isinstance(a, dict) else a.to(d) for a in args)

    for name, (cpu_module, args) in cases.items():
        random_init_(cpu_module, torch.Generator().manual_seed(0))
        cpu_module.eval()
        card_module = copy.deepcopy(cpu_module).to(dev)
        with torch.inference_mode():
            ref = flat(cpu_module(*args))
            got = flat(card_module(*to(args, dev)))
        errs = {}
        for k, r in ref.items():
            g = got[k].cpu()
            errs[k] = (g - r).abs().max().item()
            checks[f"{name}_{k}"] = tuple(g.shape) == tuple(r.shape) and bool(
                torch.isfinite(g).all()) and torch.allclose(g, r, atol=1e-4, rtol=1e-3)
        shapes = {k: list(v.shape) for a in args for k, v in (a.items() if isinstance(a, dict) else [("x", a)])}
        results[name] = {"inputs": shapes, "outputs": {k: list(v.shape) for k, v in ref.items()},
                         "max_abs_err": errs}
        del card_module
    torch.cuda.empty_cache()
    return results, checks


def decoders_phase(dev, smi, kernel_fns):
    """Swin-T (configs/cityscapes_swin_unified.yaml) with each of
    DECODER_MODELS' pixel and depth decoders (overrides of
    model.sem_seg_head.{pixel,depth}_decoder_name), at full width in bf16,
    random weights from seed 0 (class head x8): N_DECODER_REQUESTS 1024x2048
    panoptic requests through serve_segmentation and as many 192x512 pairs
    through serve_sequence, each kind once more profiled; launches exact (K1
    1 per segmentation request; K2 6 per request of either kind where an
    MSDeformAttn decoder runs it, 0 elsewhere), outputs finite, the disparity
    at its decoder's stride. On the first model one request's outputs also
    go through fused_multitask_inference with phase_layout=True, and
    deinterleave_phases_np of its maps must give the default call's maps
    byte for byte. Where DepthMSDeformAttn runs, K2 is held against its
    plain version on one more sequence request's layer 0 (k2_on_recorded_call,
    compare_msda's tolerance). Then each model fp32 on the card against the CPU
    (card_against_cpu), and the modules no config selects
    (offpath_modules_against_cpu). Returns each model's launches."""
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.inference.fused_postprocess import deinterleave_phases_np, fused_multitask_inference
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    t_phase = time.perf_counter()
    launched, models = {}, {}
    checks = {}
    for key, (pixel, depth) in DECODER_MODELS.items():
        t_model = time.perf_counter()
        overrides = decoder_overrides(key)
        cfg = decoder_config(key).model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = UniEncoder(cfg, device=dev, dtype=torch.bfloat16, seed=0)
        with torch.no_grad():
            model.predictor.class_embed.weight.mul_(8.0)
        build_s = time.perf_counter() - t0
        k2 = {"segmentation": cfg.sem_seg_head.transformer_enc_layers if pixel.startswith("MSDeformAttn") else 0,
              "sequence": cfg.sem_seg_head.transformer_enc_layers if depth.startswith("DepthMSDeformAttn") else 0}
        want = {kind: {"k1": int(kind == "segmentation"), "k2": k2[kind], "k3": 0, "k4": 0, "k5": 0} for kind in k2}
        rng = np.random.RandomState(0)
        images = torch.from_numpy(rng.randn(1, SEG_H, SEG_W, 3).astype(np.float32)).to(dev, torch.bfloat16)
        cur, prev = (torch.from_numpy(rng.randn(1, SEQ_H, SEQ_W, 3).astype(np.float32)).to(dev, torch.bfloat16)
                     for _ in range(2))
        tokens = torch.tensor([tokenize_task(TASK)], dtype=torch.int64, device=dev)
        thing = torch.isin(torch.arange(cfg.sem_seg_head.num_classes), torch.arange(11, 19)).to(dev)
        fields, model_checks, launched[key], (out, posts) = serve_kinds(
            model, cfg, (images, tokens, thing), (cur, prev), kernel_fns, want, N_DECODER_REQUESTS,
            disp_stride=DECODER_DISP_STRIDE[key], disp_low=0.0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        k2_sequence = None
        if depth.startswith("DepthMSDeformAttn"):
            # K2 against its plain version at the sequence path's own grids
            # and dtype: layer 0 of the depth decoder's encoder on one more
            # served pair
            with first_msda_call() as seen:
                serve_sequence(model, cur, prev)
            k2_sequence = k2_on_recorded_call(seen)
        if key == "a":
            Q = out["pred_logits"].shape[1]
            with torch.inference_mode():
                phases = fused_multitask_inference(out["pred_logits"][0], out["pred_masks"][0], thing,
                                                   object_mask_threshold=0.8, overlap_threshold=0.8, topk=Q,
                                                   phase_layout=True)
            for k in ("sem_seg_argmax", "panoptic_seg"):
                model_checks[f"phase_layout_{k}_shape"] = tuple(phases[k].shape) == (4, 4, SEG_H // 4, SEG_W // 4)
                model_checks[f"phase_layout_{k}_round_trip"] = bool(np.array_equal(
                    deinterleave_phases_np(phases[k].cpu().numpy()), posts[0][k].cpu().numpy()))
            del phases
        decoder_params = {"pixel_decoder": sum(p.numel() for p in model.pixel_decoder.parameters()),
                          "depth_decoder": sum(p.numel() for p in model.depth_decoder.parameters())}
        del model, out, posts
        torch.cuda.empty_cache()
        small_errs = card_against_cpu(cfg, rng, tokens, dev, model_checks)
        emit("decoders", model=key, pixel_decoder=pixel, depth_decoder=depth, config=TRAIN_ENTRY_CONFIG,
             overrides=overrides, decoder_parameters=decoder_params, dtype="bfloat16",
             requests=N_DECODER_REQUESTS, image=[1, SEG_H, SEG_W, 3], pair=[1, SEQ_H, SEQ_W, 3],
             disp_stride=DECODER_DISP_STRIDE[key], model_build_s=build_s, launches=launched[key], **fields,
             k2_sequence_vs_plain=k2_sequence, peak_memory_gb=peak_gb, checks=model_checks,
             reference_small={"image": [1, 128, 256, 3], "pair": [1, 64, 128, 3], "errors": small_errs,
                              "tolerance": SMALL_TOLERANCE},
             seconds=time.perf_counter() - t_model, card=smi)
        checks.update({f"{key} {k}": v for k, v in model_checks.items()})
    offpath, offpath_checks = offpath_modules_against_cpu(dev, np.random.RandomState(1))
    checks.update(offpath_checks)
    emit("decoders", modules_no_config_selects=offpath, dtype="float32", tf32=False,
         tolerance="atol 1e-4, rtol 1e-3", checks=offpath_checks, phase_seconds=time.perf_counter() - t_phase,
         card=smi)
    fail_unless("decoders", checks)
    return launched


def convert_phase(dev, smi, root):
    """The checkpoint-conversion command line at full width: eval's recipe
    of a reference-style .pth (random Swin-T weights from seed 0, class
    head x8, EVAL_PLANTED keys the model does not own) split into two .pth
    files, `tools/convert_checkpoint_torch.py` on them (`--backbone swin`:
    configs/cityscapes_swin_unified.yaml, tensors on the card) into
    root/converted, and `evaluate_torch.build_model` from its output against
    the .pth load, byte for byte. Returns the converted checkpoint's
    directory (the Swin-T demo's weights)."""
    import contextlib
    import io

    import evaluate_torch
    from uni_encoder_tpu_torch.config import load_config

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import convert_checkpoint_torch

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAIN_ENTRY_CONFIG))
    writer, saved, planted = reference_weights(cfg.model, dev)
    del writer
    state = {**saved, **planted}
    pth = os.path.join(root, "model_final.pth")
    torch.save({"model": state}, pth)
    keys = sorted(state)
    parts = [os.path.join(root, f"model_part{i}.pth") for i in (0, 1)]
    for path, part in zip(parts, (keys[: len(keys) // 2], keys[len(keys) // 2:])):
        torch.save({"model": {k: state[k] for k in part}}, path)
    out = os.path.join(root, "converted")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        written = convert_checkpoint_torch.main([*parts, "-o", out, "--backbone", "swin"])
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    converted, report = evaluate_torch.build_model(cfg, out, dev)
    load_s = time.perf_counter() - t0
    direct, direct_report = evaluate_torch.build_model(cfg, pth, dev)
    a, b = converted.state_dict(), direct.state_dict()
    lines = printed.getvalue().splitlines()
    checks = {
        "state_byte_equal_to_the_pth_load": sorted(a) == sorted(b) == sorted(saved) and all(
            a[k].cpu().numpy().tobytes() == b[k].cpu().numpy().tobytes() == saved[k].numpy().tobytes() for k in saved),
        "nothing_unused_in_the_converted": report.unused == [],
        "pth_unused_exactly_the_planted": direct_report.unused == sorted(planted),
        "printed_the_planted_keys": lines[1:1 + len(planted)] == [f"  {k}" for k in sorted(planted)],
        "checkpoint_file": written == os.path.join(out, "step_0.pt") and os.path.isfile(written),
    }
    del converted, direct, a, b
    torch.cuda.empty_cache()
    emit("convert", config=TRAIN_ENTRY_CONFIG, inputs=[os.path.basename(p) for p in parts],
         input_mb=[os.path.getsize(p) / 1e6 for p in parts], checkpoint_mb=os.path.getsize(written) / 1e6,
         printed=lines, convert_s=convert_s, build_model_from_converted_s=load_s, checks=checks,
         seconds=time.perf_counter() - t_phase, card=smi)
    fail_unless("convert", checks)
    return out


def demo_phase(dev, smi, kernel_fns, swin_weights):
    """The demo entry point, `demo_torch.main --task panoptic`, at full width
    and depth on the configs of DEMO_CONFIGS: Swin-T (`swin_weights`: the
    convert phase's checkpoint), any other with random weights from seed 0,
    class head x8, written as a .pth: DEMO_FRAMES synthetic 1024x2048 frames
    with their t-2 frames
    in leftImg8bit_sequence (`synthetic.write_cityscapes_sequence`). Checks
    the 8 renderings of every frame at their sizes (read back from the
    written PNGs), the launches per frame (K2 6, K1 0, K4 one per NAT layer
    in each of the two backbone passes on DiNAT-L, 0 on Swin-T) and that
    nothing imported matplotlib; reports predict / render seconds per frame.
    On Swin-T's first frame, K2 against its plain version on what the demo
    gave layer 0 of the pixel decoder (first_msda_call). Returns each
    config's launches."""
    import tempfile

    import demo_torch
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.data import image_io, synthetic

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    checks, launched, runs = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        synthetic.write_cityscapes_sequence(root, DEMO_FRAMES, (SEG_H, SEG_W), depth_hw=(8, 8))
        pattern = os.path.join(root, "cityscapes_crop/leftImg8bit/test", synthetic.CITY, "*_leftImg8bit.png")
        for name, path in DEMO_CONFIGS.items():
            cfg = load_config(os.path.join(here, path))
            weights = swin_weights if name == "swin" else None
            if weights is None:
                weights = os.path.join(root, f"{name}.pth")
                writer, saved, _ = reference_weights(cfg.model, dev, {})
                del writer
                torch.save({"model": saved}, weights)
                del saved
            reset_launches(*kernel_fns.values())
            timings = []
            t0 = time.perf_counter()
            with first_msda_call() if name == "swin" else contextlib.nullcontext() as seen:
                written = demo_torch.main(["--config", os.path.join(here, path), "--weights", weights, "--input",
                                           pattern, "--output", os.path.join(root, f"out_{name}"), "--task",
                                           "panoptic"], timings=timings)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launched[name] = {k: fn.launches for k, fn in kernel_fns.items()}
            if name == "swin":
                k2 = k2_on_recorded_call(seen)
                del seen
            shapes = {img: {r: image_io.read_png(p).shape for r, p in outs.items()} for img, outs in written.items()}
            n, nat_layers = len(written), (sum(cfg.model.backbone.dinat.depths) if name == "dinat" else 0)
            checks[f"{name}_frames"] = n == DEMO_FRAMES
            checks[f"{name}_renderings"] = all(s == DEMO_RENDERINGS for s in shapes.values())
            checks[f"{name}_k2_launches"] = launched[name]["k2"] == cfg.model.sem_seg_head.transformer_enc_layers * n
            checks[f"{name}_k4_launches"] = launched[name]["k4"] == 2 * nat_layers * n
            checks[f"{name}_k1_k3_k5_launches"] = launched[name]["k1"] == launched[name]["k3"] == launched[name]["k5"] == 0
            runs[name] = {"wall_s": wall_s, "launches": launched[name],
                          "per_frame": {k: [t[k] for t in timings] for k in ("predict_s", "render_s", "read_s",
                                                                             "write_s", "seconds", "segments",
                                                                             "instances")}}
            torch.cuda.empty_cache()
    checks["no_matplotlib_imported"] = "matplotlib" not in sys.modules
    emit("demo", frames=[DEMO_FRAMES, SEG_H, SEG_W], task="panoptic", configs=DEMO_CONFIGS,
         renderings={k: list(v) for k, v in DEMO_RENDERINGS.items()}, runs=runs, k2_swin_first_frame_layer0=k2,
         checks=checks,
         seconds=time.perf_counter() - t_phase, card=smi)
    fail_unless("demo", checks)
    return launched


def eval_ade20k_phase(dev, smi, kernel_fns):
    """ADE20K evaluation through `evaluate_torch.main` on the production
    Swin-T with the 150-class head (random weights from seed 0, class head
    x8, a .pth), at OneFormer's ADE20K test resize (shortest side 512,
    longest 2048), on ADE_IMAGES synthetic 512x683 val images
    (`synthetic.write_ade20k`), --task panoptic (PQ + mIoU) and --task
    instance (AP over the 100 thing classes). Checks finite metrics in the
    expected groups, K2 6 launches per image and K1, K3, K4, K5 none, an
    instance kept on every image of the instance run (the thing classes'
    logits biased by THING_LOGIT_BIAS), and that the same evaluators fed the
    GT score 100. On the panoptic run's first image, K2 against its plain
    version on what the run gave layer 0 of the pixel decoder
    (first_msda_call). Returns each task's launches."""
    import tempfile

    import evaluate_torch
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.data import synthetic
    from uni_encoder_tpu_torch.data.build import build_test_loader
    from uni_encoder_tpu_torch.data.mappers import TestMapper
    from uni_encoder_tpu_torch.data.prep import ade20k_150_categories

    t_phase = time.perf_counter()
    cfg = load_config(None, ADE_OVERRIDES)
    things = [c["id"] for c in ade20k_150_categories() if c["isthing"]]
    groups = {"panoptic": ["panoptic_seg", "sem_seg"], "instance": ["segm"]}
    checks, runs = {}, {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        synthetic.write_ade20k(root, "val", ADE_IMAGES, ADE_HW)
        fixture_s = time.perf_counter() - t0
        pth = os.path.join(root, "ade20k_model.pth")
        writer, saved, _ = reference_weights(cfg.model, dev, {}, things)
        del writer
        torch.save({"model": saved}, pth)
        del saved
        for task in groups:
            reset_launches(*kernel_fns.values())
            timings = []
            t0 = time.perf_counter()
            with first_msda_call() if task == "panoptic" else contextlib.nullcontext() as seen:
                results = evaluate_torch.main(["--weights", pth, "--datasets-root", root, "--task", task,
                                               *ADE_OVERRIDES], timings=timings)
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in kernel_fns.items()}
            if task == "panoptic":
                k2 = k2_on_recorded_call(seen)
                del seen
            runs[task] = {"wall_s": time.perf_counter() - t0, "launches": launches, "timing": eval_summary(timings),
                          "metrics": results["seg_and_depth"]}
            checks[f"{task}_metrics_finite"], runs[task]["nan_iou_classes"] = finite_metrics(results)
            checks[f"{task}_groups"] = sorted(results["seg_and_depth"]) == [f"{ADE_SET}/{g}" for g in groups[task]]
            checks[f"{task}_k2_launches"] = launches["k2"] == cfg.model.sem_seg_head.transformer_enc_layers * ADE_IMAGES
            checks[f"{task}_other_launches"] = launches["k1"] == launches["k3"] == launches["k4"] == launches["k5"] == 0
            torch.cuda.empty_cache()
        kept = runs["instance"]["timing"]["per_dataset"][ADE_SET]["per_image"]["instances"]
        checks["instance_kept_on_every_image"] = len(kept) == ADE_IMAGES and min(kept) > 0

        # ---- the same evaluators fed the GT
        perfect = {}
        for task in groups:
            ev = evaluate_torch.build_evaluator(ADE_SET, task)
            ev.reset()
            mapper = TestMapper(task=task, seg_min_size=cfg.input.seg_min_size_test,
                                seg_max_size=cfg.input.seg_max_size_test)
            for item in build_test_loader(ADE_SET, mapper):
                ev.process([item], [synthetic.ade20k_gt_as_prediction(item)])
            r = ev.evaluate()
            perfect.update({"PQ": r["panoptic_seg"]["PQ"], "mIoU": r["sem_seg"]["mIoU"]} if task == "panoptic"
                           else {"AP": r["segm"]["AP"]})
        checks["gt_fed_back_perfect"] = all(abs(v - 100.0) < 1e-9 for v in perfect.values())
    emit("eval_ade20k", images=[ADE_IMAGES, *ADE_HW], overrides=ADE_OVERRIDES, thing_logit_bias=THING_LOGIT_BIAS,
         fixture_s=fixture_s, runs=runs, k2_first_image_layer0=k2,
         gt_fed_back=perfect, checks=checks, seconds=time.perf_counter() - t_phase, card=smi)
    fail_unless("eval_ade20k", checks)
    return {task: r["launches"] for task, r in runs.items()}


def scale_aware_errors(got, ref):
    """Per tensor |got - ref| / max(|ref|, |ref_all| sqrt(n / n_all)) (a
    tensor's error against the whole set's root-mean-square scale where its
    own norm is below it: a gradient that is zero in exact arithmetic holds
    only rounding noise), and the whole set's relative error; in fp64 on
    the tensors' device."""
    ref = {k: v.double() for k, v in ref.items()}
    n_all = sum(v.numel() for v in ref.values())
    norm_all = float(torch.sqrt(sum((v * v).sum() for v in ref.values())))
    diffs = {k: float((got[k].double() - v).norm()) for k, v in ref.items()}
    per = {k: diffs[k] / max(float(v.norm()), norm_all * (v.numel() / n_all) ** 0.5, 1e-30) for k, v in ref.items()}
    return per, float(np.sqrt(sum(d * d for d in diffs.values()))) / norm_all


def moment_errors(got, ref):
    """`scale_aware_errors` of AdamW's moments of two OptStates, by
    parameter: of mu and of sqrt(nu) (in the gradient's units), each set
    scaled apart, as the gradients are; and the larger of the two sets'
    whole errors."""
    names = [n for bucket in ref.names for n in bucket]
    out, whole = {}, 0.0
    for key, label, fn in (("mu", "mu", lambda x: x), ("nu", "sqrt_nu", torch.sqrt)):
        g, r = ({n: fn(x) for n, x in zip(names, (x for bucket in getattr(o, key) for x in bucket))}
                for o in (got, ref))
        per, w = scale_aware_errors(g, r)
        out.update({f"{label} {n}": e for n, e in per.items()})
        whole = max(whole, w)
    return out, whole


def param_errors(gp, rp, lrs, clip_rel):
    """Each parameter's largest |got - ref| over its bound (`md_within_bounds`
    holds it to 1): the step's learning rate `lrs[name]` times MD_UPDATE_GAIN
    times the relative difference of its clipped gradient (its gradient's
    plus the clip scale's, `clip_rel`; + 1e-5, the update's own rounding),
    at most MD_PARAM_LRS, plus two ulps of the parameter. Where the reference
    gradient stands clear of rounding noise this is tight, so a wrong update
    shows; where it is noise (0 in exact arithmetic) AdamW moves an element
    by up to a learning rate either way."""
    out = {}
    for k, p in gp.items():
        r = rp[k]
        g = torch.zeros_like(r) if p.grad is None else p.grad
        g_ref = torch.zeros_like(r) if r.grad is None else r.grad
        rel = torch.where(g_ref != 0, (g - g_ref).abs() / g_ref.abs(), torch.full_like(g_ref, float("inf")))
        bound = lrs[k] * torch.clamp(MD_UPDATE_GAIN * (rel + clip_rel) + 1e-5, max=MD_PARAM_LRS) \
            + 2 * torch.finfo(torch.float32).eps * r.detach().abs()
        diff = (p.detach() - r.detach()).abs()
        out[k] = float(torch.where(diff == 0, 0.0, diff / bound).max())
    return out


def md_step_errors(got, ref, lrs):
    """Two steps' (state, losses) from the same state against each other:
    each loss term's relative error, `scale_aware_errors` of the gradients
    and of AdamW's moments (`moment_errors`), `param_errors` (`lrs`: each
    parameter's learning rate in the step, `step_lrs`), each BatchNorm
    statistic's largest difference over its largest element, and how many
    of each group's tensors are the same bytes."""
    gp, rp = dict(got[0].model.named_parameters()), dict(ref[0].model.named_parameters())
    gb, rb = dict(got[0].model.named_buffers()), dict(ref[0].model.named_buffers())
    grads = {k: p.grad for k, p in gp.items() if p.grad is not None}
    ref_grads = {k: p.grad for k, p in rp.items() if p.grad is not None}
    bn = [k for k in rb if "running_" in k]
    losses = {k: abs(float(v) - float(ref[1][k])) / max(abs(float(ref[1][k])), 1e-30) for k, v in got[1].items()}
    return {
        "losses": losses,
        "grads": scale_aware_errors(grads, ref_grads),
        "params": param_errors(gp, rp, lrs, losses["clip_scale"]),
        "moments": moment_errors(got[0].opt, ref[0].opt),
        "bn": {k: float((gb[k] - rb[k]).abs().max() / rb[k].abs().max()) for k in bn},
        "byte_equal": {"losses": sum(torch.equal(v, ref[1][k]) for k, v in got[1].items()),
                       "grads": sum(torch.equal(v, ref_grads[k]) for k, v in grads.items()),
                       "params": sum(torch.equal(p, rp[k]) for k, p in gp.items()),
                       "bn": sum(torch.equal(gb[k], rb[k]) for k in bn)},
        "counts": {"losses": len(got[1]), "grads": len(grads), "params": len(gp), "bn": len(bn)},
    }


def md_within_bounds(errs):
    """The quantities of `md_step_errors` past the CPU test's bounds, each
    also allowed twice its `spread` where the errors hold one (the same
    step's own difference with its images moved by one ulp); and how many
    passed by the spread alone."""
    spread = errs.get("spread")
    groups = {"loss": (errs["losses"], spread and spread["losses"],
                       lambda k: MD_D_GROUND_RTOL if k == "monodepth/d_ground" else MD_LOSS_RTOL),
              "grad": (errs["grads"][0], spread and spread["grads"][0], lambda k: MD_GRAD_RTOL),
              "moment": (errs["moments"][0], spread and spread["moments"][0], lambda k: MD_GRAD_RTOL),
              "bn": (errs["bn"], spread and spread["bn"], lambda k: MD_BN_RTOL),
              "param": (errs["params"], None, lambda k: 1.0)}
    bad, by_spread = [], 0
    for group, (got, noise, bound) in groups.items():
        for k, e in got.items():
            if not e <= max(bound(k), 2 * noise[k] if noise else 0.0):
                bad.append(f"{group} {k}")
            by_spread += e > bound(k)
    return bad, by_spread - len(bad)


def md_error_summary(errs):
    """The largest errors of each group and their tensors, how many
    gradients lie past 1e-5 ... 1e-1, and the byte-equal counts."""
    def worst(d, n=3):
        return sorted(d.items(), key=lambda kv: -kv[1])[:n]

    def past(d):
        return {f"{t:g}": sum(e > t for e in d.values()) for t in (1e-5, 1e-4, 1e-3, 1e-2, 1e-1)}

    return {"loss": worst(errs["losses"], 4), "grad": worst(errs["grads"][0]), "grads_whole": errs["grads"][1],
            "grads_past": past(errs["grads"][0]), "param_over_bound": worst(errs["params"]),
            "moment": worst(errs["moments"][0]), "moments_whole": errs["moments"][1],
            "moments_past": past(errs["moments"][0]), "bn": worst(errs["bn"], 2),
            "byte_equal": errs["byte_equal"], "counts": errs["counts"], **errs.get("extra", {})}


def fingerprint(x):
    """A position-weighted 64-bit sum of the 32-bit words of a tensor, and
    their plain sum, on its device: a word that differs changes the first
    (its difference, below 2^32, times an odd weight below 2^31 cannot
    vanish modulo 2^64)."""
    words = x.detach().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    weights = (torch.arange(words.numel(), device=words.device) * 2654435761 % (1 << 31)) | 1
    return [int((words * weights).sum()), int(words.sum())]


def fingerprints(state):
    """The `fingerprint` of every parameter, gradient, buffer and optimizer
    moment of a TrainState."""
    model = state.model
    tensors = list(model.parameters()) + [p.grad for p in model.parameters() if p.grad is not None]
    tensors += list(model.buffers()) + [m for bucket in state.opt.mu + state.opt.nu for m in bucket]
    return [fingerprint(x) for x in tensors]


def timed_collectives():
    """Time every all-reduce of `parallel/mesh.py` (fenced by
    synchronization; their calls and bytes counted) and the gradients' one
    apart; returns the running totals."""
    from uni_encoder_tpu_torch.parallel import mesh

    totals = {"calls": 0, "s": 0.0, "bytes": 0, "gradients_s": 0.0}
    all_reduce, gradients = mesh._all_reduce_, mesh.all_reduce_gradients

    def timed(x, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(x, *args)
        torch.cuda.synchronize()
        totals["calls"] += 1
        totals["s"] += time.perf_counter() - t0
        totals["bytes"] += x.numel() * x.element_size()
        return out

    def timed_gradients(params, *args):
        t0 = time.perf_counter()
        gradients(params, *args)
        totals["gradients_s"] += time.perf_counter() - t0

    mesh._all_reduce_, mesh.all_reduce_gradients = timed, timed_gradients
    return totals


def requested_bytes(dev):
    """The bytes the tensors on `dev` hold: the caching allocator's count of
    what was asked of it (`memory_allocated` adds its rounding and the
    slack of blocks taken whole from a cached segment, up to a MB each)."""
    return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]


def copy_state(dst, src):
    """Make TrainState `dst` hold `src`'s parameters, buffers, optimizer
    moments and counts, in place."""
    with torch.no_grad():
        for a, b in zip(list(dst.model.parameters()) + list(dst.model.buffers()),
                        list(src.model.parameters()) + list(src.model.buffers())):
            a.copy_(b)
        for a, b in zip([m for bucket in dst.opt.mu + dst.opt.nu for m in bucket],
                        [m for bucket in src.opt.mu + src.opt.nu for m in bucket]):
            a.copy_(b)
    dst.step, dst.opt.count = src.step, src.opt.count


def snapshot(state, losses, gather=None):
    """What `md_step_errors` reads of a step, copied: (a state-like holder
    of the model's parameters, gradients and buffers and AdamW's moments,
    the losses). `gather(p, x)`: the whole tensor of a parameter's block, or
    of its gradient's or moment's (`parallel/tensor.py::gather_param`, a
    collective of the model group), for a tensor-parallel state."""
    import types

    def whole(p, x):
        return (x if gather is None else gather(p, x)).detach().clone()

    model = types.SimpleNamespace(
        named_parameters=lambda: iter(params.items()), named_buffers=lambda: iter(buffers.items()))
    params, named = {}, dict(state.model.named_parameters())
    for k, p in named.items():
        params[k] = whole(p, p)
        params[k].grad = None if p.grad is None else whole(p, p.grad)
    buffers = {k: b.clone() for k, b in state.model.named_buffers()}
    opt = types.SimpleNamespace(names=state.opt.names, **{
        key: [[whole(named[n], m) for n, m in zip(names, b)] for names, b in zip(state.opt.names, getattr(state.opt, key))]
        for key in ("mu", "nu")})
    return types.SimpleNamespace(model=model, opt=opt), {k: v.clone() for k, v in losses.items()}


def step_lrs(optimizer, state):
    """Each parameter's learning rate in the next step of TrainState
    `state` (`FusedAdamW`'s poly LR times its bucket's multiplier)."""
    lr = optimizer.lr_at(state.opt.count)
    return {n: lr * optimizer.mults[i] for i, bucket in enumerate(state.opt.names) for n in bucket}


def kernel_wrappers():
    """Every kernel's wrapper by its key; each counts its launches."""
    from uni_encoder_tpu_torch.inference.fused_postprocess import fused_postprocess_cuda
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_backward_cuda, ms_deform_attn_fused_cuda
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d_backward_cuda,
        neighborhood_attention_2d_cuda,
    )

    return {"k1": fused_postprocess_cuda, "k2": ms_deform_attn_fused_cuda, "k3": ms_deform_attn_fused_backward_cuda,
            "k4": neighborhood_attention_2d_cuda, "k5": neighborhood_attention_2d_backward_cuda}


def ulp_moved(seg, seq):
    """The batch with every float of its images moved by one ulp up or down
    (a fixed random pattern): the same step from inputs that differ by
    rounding alone, whose difference shows how far rounding inside the step
    moves each quantity."""
    g = torch.Generator(device=seg["images"].device).manual_seed(7)

    def move(x):
        up = torch.rand(x.shape, generator=g, device=x.device) < 0.5
        return torch.where(up, torch.nextafter(x, torch.full_like(x, float("inf"))),
                           torch.nextafter(x, torch.full_like(x, float("-inf"))))

    return ({k: move(v) if k == "images" else v for k, v in seg.items()},
            {k: move(v) if k.endswith("images") else v for k, v in seq.items()})


def wait_for(path, timeout=1500):
    """Block until `path` exists: a phase multi_device child, set up while
    earlier phases run, waits there for the phase to begin."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout} s")
        time.sleep(0.2)


def md_train_rank(rank, rendezvous):
    """A training rank of phase multi_device: the default Swin-T model at
    full width (deterministic, fp32), its rows of train's synthetic batch
    (TRAIN_BATCH crops and triples: one each), MD_STEPS steps in a gloo
    group of MD_WORLD ranks on the one card. Before each of its steps rank 0
    takes one process's step on the whole batch from its own state, the
    group out of its sight (the other rank waits for it in a collective),
    and the same step from ulp-moved images (`ulp_moved`: what rounding
    alone moves), and holds its step, at one process's discrete choices,
    against the first (`md_step_errors`; the spread's as `spread`). Per
    step: the step's seconds, the collectives' seconds, every kernel's
    launches, peak GB, the state's `fingerprints` and the choices this
    rank's own sums would make otherwise."""
    from unittest import mock

    from uni_encoder_tpu_torch.config import Config
    from uni_encoder_tpu_torch.parallel import mesh
    from uni_encoder_tpu_torch.training import criterion as criterion_module
    from uni_encoder_tpu_torch.training.train_step import Trainer

    dev = torch.device("cuda", 0)
    mesh.init_process_group("gloo", rank, MD_WORLD, "file://" + rendezvous)
    cfg = Config()
    n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
    trainer = Trainer(cfg, device=dev, deterministic=True)
    seg, seq = train_batches(0, TRAIN_BATCH, cfg.input.seg_crop_train, cfg.input.depth_hw_train, TRAIN_SLOTS,
                             TRAIN_VALID, n_texts, dev)
    mine = mesh.shard_batch(seg, rank, MD_WORLD), mesh.shard_batch(seq, rank, MD_WORLD)
    state, gen = trainer.init(seed=0), torch.Generator(device=dev).manual_seed(0)
    if rank == 0:  # one more state: one process's step, then the same step from ulp-moved images
        before = requested_bytes(dev)
        other, ref_gen = trainer.init(seed=0), torch.Generator(device=dev).manual_seed(0)
        other_init_bytes = requested_bytes(dev) - before  # parameters, buffers, AdamW's moments
    wait_for(rendezvous + ".go")
    totals, wrappers = timed_collectives(), kernel_wrappers()
    # The step's two discrete choices, Hungarian matching and the mask
    # losses' most uncertain points, flip where their inputs nearly tie, as
    # they do on random weights (the queries' costs, the masks' logits): the
    # ranks' steps are held against one process's at its choices (pinned),
    # and how many of them this rank's own sums would make otherwise is
    # counted
    choices = {"assign_on_host": ("matching", criterion_module.assign_on_host),
               "uncertainty_points": ("points", criterion_module.uncertainty_points)}
    pinned, made = {}, {"matching": [], "points": []}

    def pinnable(key, fn):
        def run(*args):
            out = fn(*args)
            made[key].append(out)
            return pinned[key][len(made[key]) - 1] if key in pinned else out
        return run

    for name, (key, fn) in choices.items():
        setattr(criterion_module, name, pinnable(key, fn))
    b = TRAIN_BATCH // MD_WORLD
    rows_of = {"matching": lambda x: x[:, :, rank * b:(rank + 1) * b],  # (1 call, sets, B, slots)
               "points": lambda x: x[:, rank * b * TRAIN_SLOTS:(rank + 1) * b * TRAIN_SLOTS]}  # (sets, B * slots, ...)
    steps = []
    for _ in range(MD_STEPS):
        rec = {}
        pinned.clear()
        for v in made.values():
            v.clear()
        if rank == 0:  # one process's step and its spread, from this rank's state
            draws = trainer.make_draws(ref_gen, seg, seq, dev)
            lrs = step_lrs(trainer.optimizer, state)
            with mock.patch.object(mesh, "active", lambda: False):
                copy_state(other, state)
                torch.cuda.reset_peak_memory_stats(dev)
                before = requested_bytes(dev)
                got = trainer.train_step(other, seg, seq, draws=draws)
                after = requested_bytes(dev)
                # one process's training state after a step (its gradients now held) and the step's peak
                # without this rank's own state; the discrete choices the step made, kept here to pin,
                # apart: the blocks they hold measured by moving them off the card and back
                kept = {key: [t.cpu() for t in v] for key, v in made.items()}
                for v in made.values():
                    v.clear()
                held = after - requested_bytes(dev)
                made.update({key: [t.to(dev) for t in v] for key, v in kept.items()})
                one_state = {"bytes": other_init_bytes + after - before - held,
                             "choices_bytes": held,
                             "peak_gb": (torch.cuda.max_memory_allocated(dev) - other_init_bytes) / 1e9}
                ref = snapshot(*got)
                del got
                one_process = {key: torch.stack(v) for key, v in made.items()}
                pinned.update({key: list(v) for key, v in made.items()})
                for v in made.values():
                    v.clear()
                copy_state(other, state)
                spread = md_step_errors(trainer.train_step(other, *ulp_moved(seg, seq), draws=draws), ref, lrs)
            if not steps:  # the step from the seed-0 state: phase tensor_parallel's reference too
                save_tp_reference(ref, spread, one_process, lrs, one_state)
            torch.cuda.empty_cache()  # the batch-2 steps' blocks, for the other processes on the card
        else:
            sets = trainer.n_prediction_sets()
            crit = trainer.criterion
            one_process = {"matching": torch.zeros(1, sets, TRAIN_BATCH, TRAIN_SLOTS, dtype=torch.int64, device=dev),
                           "points": torch.zeros(sets, TRAIN_BATCH * TRAIN_SLOTS, crit.num_points, 2, device=dev)}
        # rank 0 hands every rank one process's choices (and both start the step together)
        pinned.update({key: rows_of[key](mesh.all_reduce_sum(one_process[key])) for key in sorted(one_process)})
        for v in made.values():
            v.clear()
        reset_launches(*wrappers.values())
        collectives = dict(totals)
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = trainer.train_step(state, *mine, gen)
        torch.cuda.synchronize()
        rec["step_s"] = time.perf_counter() - t0
        rec["collectives"] = {k: totals[k] - collectives[k] for k in totals}
        rec["launches"] = {key: f.launches for key, f in wrappers.items()}
        rec["peak_gb"], rec["resident_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9, resident / 1e9
        rec["fingerprints"] = fingerprints(state)
        own = torch.stack(made["matching"])[..., :TRAIN_VALID]
        rec["choices"] = {
            "valid_targets_matched_otherwise": int((own != pinned["matching"][..., :TRAIN_VALID]).sum()),
            "valid_targets": own.numel(),
            "uncertain_points_chosen_otherwise": int((torch.stack(made["points"]) != pinned["points"]).any(-1).sum()),
            "points": int(pinned["points"].shape[:-1].numel())}
        if rank == 0:
            rec["errors"] = md_step_errors(got, ref, lrs)
            rec["errors"]["spread"] = spread
        steps.append(rec)
    for name, (_, fn) in choices.items():  # the evaluation that follows runs unpinned
        setattr(criterion_module, name, fn)
    open(f"{rendezvous}.trained{rank}", "w").close()  # the nccl rank's steps wait for both ranks'
    return {"steps": steps, "local_batch": int(mine[0]["images"].shape[0])}


def md_train_nccl(rendezvous):
    """Phase multi_device's nccl rank: a training rank's step (rank 0's rows
    of train's batch, deterministic) without a process group (the group of
    one rank under nccl out of its sight), then in that group (the
    gradients all-reduced by NCCL on the card), from the same weights and
    draws, after the training ranks' steps: `md_step_errors` of the second
    against the first, and the backend."""
    from unittest import mock

    import torch.distributed as dist

    from uni_encoder_tpu_torch.config import Config
    from uni_encoder_tpu_torch.parallel import mesh
    from uni_encoder_tpu_torch.training.train_step import Trainer

    dev = torch.device("cuda", 0)
    cfg = Config()
    n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
    trainer = Trainer(cfg, device=dev, deterministic=True)
    seg, seq = (mesh.shard_batch(b, 0, MD_WORLD) for b in train_batches(
        0, TRAIN_BATCH, cfg.input.seg_crop_train, cfg.input.depth_hw_train, TRAIN_SLOTS, TRAIN_VALID, n_texts, dev))
    # NCCL's communicator and buffers (allocated outside torch's allocator)
    # while the card has room, then the steps once the training ranks are
    # done with theirs (a batch-2 step of rank 0 holds ≈43 GB)
    mesh.init_process_group("nccl", 0, 1, "file://" + rendezvous)
    mesh.all_reduce_sum(torch.zeros(1, device=dev))
    backend = dist.get_backend()
    state = trainer.init(seed=0)
    wait_for(rendezvous + ".go")
    for r in range(MD_WORLD):
        wait_for(os.path.join(os.path.dirname(rendezvous), f"rendezvous_train.trained{r}"))
    lrs = step_lrs(trainer.optimizer, state)
    with mock.patch.object(mesh, "active", lambda: False):
        ref = trainer.train_step(state, seg, seq, torch.Generator(device=dev).manual_seed(0))
    del state
    totals = timed_collectives()
    got = trainer.train_step(trainer.init(seed=0), seg, seq, torch.Generator(device=dev).manual_seed(0))
    errors = md_step_errors(got, ref, lrs)
    mesh.destroy_process_group()
    return {"backend": backend, "errors": errors, "collectives": dict(totals),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def output_digest(out):
    """sha256 of a Predictor output's arrays and values, in key order."""
    import hashlib

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                feed(v)
        elif torch.is_tensor(x) or isinstance(x, np.ndarray):
            a = x.detach().cpu().numpy() if torch.is_tensor(x) else x
            h.update(str((a.dtype, a.shape)).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        else:
            h.update(repr(x).encode())

    feed(out)
    return h.hexdigest()


def md_eval(root):
    """The evaluation of a phase multi_device child, after its training:
    `evaluate_torch.main` (the library path) on the synthetic tree under
    `root` with the default model's random weights from seed 0, as this
    process's rank of its gloo group on the card, or alone without one: the
    results, each prediction's `output_digest` by file, every kernel's
    launches, the seconds and the peak GB."""
    import evaluate_torch
    from uni_encoder_tpu_torch.engine.predictor import Predictor
    from uni_encoder_tpu_torch.parallel import mesh

    digests = {}
    for name in ("infer_segmentation", "infer_sequence"):
        def recorded(self, item, _run=getattr(Predictor, name)):
            out = _run(self, item)
            digests[item["file_name"]] = output_digest(out)
            return out
        setattr(Predictor, name, recorded)
    wrappers = kernel_wrappers()
    reset_launches(*wrappers.values())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = evaluate_torch.main(["--datasets-root", root, "--device", "cuda:0",
                                   "--task", "panoptic", "datasets.depth_test=[cityscapes_crop_test]",
                                   f"datasets.seg_test_panoptic=[{EVAL_SEG_SET}]"])
    torch.cuda.synchronize()
    return {"results": json.loads(json.dumps(results, default=float)), "digests": digests,
            "launches": {key: f.launches for key, f in wrappers.items()}, "seconds": time.perf_counter() - t0,
            "world": mesh.world(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def multi_device_child(out_path, role, rendezvous, root):
    """A child of phase multi_device, `role` train_rank<r> or train_nccl:
    its training (`md_train_rank`, `md_train_nccl`), then in the same
    process, its memory freed, its evaluation (`md_eval`: the training
    ranks as the evaluation's ranks, in their gloo group; the nccl rank,
    its group gone, as the one process); both saved to `out_path`."""
    import gc

    from uni_encoder_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if role.startswith("train_rank"):
        result = {"train": md_train_rank(int(role[-1]), rendezvous)}
    else:
        result = {"train": md_train_nccl(rendezvous)}
    gc.collect()
    torch.cuda.empty_cache()
    open(out_path + ".freed", "w").close()  # phase tensor_parallel's ranks wait for every child's
    result["eval"] = md_eval(root)
    mesh.destroy_process_group()
    torch.save(result, out_path)


def metrics_differences(got, ref, path=""):
    """Every scalar of two results trees with its absolute difference (NaN
    against NaN counts as equal)."""
    if isinstance(ref, dict):
        if sorted(got) != sorted(ref):
            raise AssertionError(f"{path}: keys {sorted(got)} against {sorted(ref)}")
        return {k: v for key in ref for k, v in metrics_differences(got[key], ref[key], f"{path}/{key}").items()}
    if isinstance(ref, (list, tuple)):
        return {k: v for i, r in enumerate(ref) for k, v in metrics_differences(got[i], r, f"{path}[{i}]").items()}
    g, r = float(got), float(ref)
    return {path: 0.0 if (g == r or (np.isnan(g) and np.isnan(r))) else abs(g - r)}


def start_multi_device():
    """Start phase multi_device's three children (`MULTI_DEVICE_CHILD`) and
    write its evaluation's synthetic tree: each child sets up its model,
    states and batch and then waits for its group's go file, so that their
    start-up overlaps the phases before it (a few GB of the card until
    then). Returns what `multi_device_phase` needs."""
    import tempfile

    from uni_encoder_tpu_torch import kernels
    from uni_encoder_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    work = os.path.join(os.path.dirname(kernels.BUILD_DIR), "multi_device")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    root = tempfile.mkdtemp(dir=work)
    synthetic.write_cityscapes_val(root, MD_EVAL_IMAGES, (SEG_H, SEG_W))
    synthetic.write_cityscapes_sequence(root, MD_EVAL_IMAGES, (SEG_H, SEG_W))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    children = {}
    for role in [f"train_rank{r}" for r in range(MD_WORLD)] + ["train_nccl"]:
        rendezvous = os.path.join(work, f"rendezvous_{role.rstrip('0123456789').replace('_rank', '')}")
        path = os.path.join(work, f"{role}.pt")
        children[role] = (start_child(MULTI_DEVICE_CHILD, path, role, rendezvous, root, env=env), path, rendezvous)
        kill_at_exit(children[role][0])
    return {"work": work, "children": children, "start_s": time.perf_counter() - t0}


def multi_device_phase(dev, smi, started, meanwhile=lambda: None):
    """Data-parallel training and sharded evaluation on the one card, in
    three child processes (`MULTI_DEVICE_CHILD`) at once, each training and
    then evaluating:
    - MD_WORLD gloo ranks take MD_STEPS full-width Swin-T steps at local
      batch 1 a modality (deterministic; gloo all-reduces the CUDA tensors
      through the host); rank 0 holds each step against one process's at
      the global batch 2 from the same state with the same draws and the
      same discrete choices (pinned: on random weights the matching's costs
      and the uncertain points' logits nearly tie, and the rank's own sums
      would choose some otherwise: counted), within the CPU test's bounds or
      twice that step's own difference from ulp-moved images
      (`md_within_bounds`);
      the ranks' states must have the same `fingerprints`, and K2 and K3 6
      launches a rank a step, K1, K4 and K5 none;
    - one nccl rank: a training rank's step (batch 1) in a group of one
      equals the step without a group (byte for byte where the arithmetic
      is the same, else within the same bounds), NCCL's all-reduce on the
      card;
    - `evaluate_torch`'s library path on MD_WORLD gloo ranks over a
      synthetic Cityscapes tree (MD_EVAL_IMAGES val images and depth
      frames, random weights from seed 0) against one process: each rank
      evaluates its shard (K2 6 an image, no other kernel) and both return
      the one process's metrics; each prediction's digest against the one
      process's.
    Two processes time-sharing one card through gloo's host path measure
    no scaling: the per-rank step seconds, the collectives' share of them
    and the peaks are what this layout costs. This process runs
    `meanwhile()` while the children do."""
    from uni_encoder_tpu_torch.config import Config

    t_phase = time.perf_counter()
    # three children at once (a batch-2 step holds ≈43 GB of the card): the
    # training ranks, then the evaluation ranks in the same processes and
    # group; the nccl rank, then the one-process evaluation
    children, work = started["children"], started["work"]
    for *_, rendezvous in children.values():
        open(rendezvous + ".go", "w").close()
    meanwhile()
    roles = list(children)
    done = dict(zip(roles, finish_children([children[r][0] for r in roles], [children[r][1] for r in roles],
                                           timeout=600)))
    loaded = {**{role: r["train"] for role, r in done.items()},
              **{role.replace("train_", "eval_").replace("eval_nccl", "eval_one"): r["eval"]
                 for role, r in done.items()}}
    roles = list(loaded)

    enc_layers = Config().model.sem_seg_head.transformer_enc_layers
    ranks = [loaded[f"train_rank{r}"] for r in range(MD_WORLD)]
    steps = ranks[0]["steps"]
    nccl = loaded["train_nccl"]
    evals = {role: loaded[role] for role in roles if role.startswith("eval")}
    one = evals["eval_one"]
    metric_diffs = {role: metrics_differences(e["results"], one["results"]) for role, e in evals.items()
                    if role != "eval_one"}
    shards = {role: sorted(e["digests"]) for role, e in evals.items() if role != "eval_one"}
    same_predictions = {f: all(e["digests"].get(f) == d for e in evals.values() if f in e["digests"])
                        for f, d in one["digests"].items()}
    checks = {
        "ranks_fingerprints_equal": all(ranks[0]["steps"][s]["fingerprints"] == ranks[1]["steps"][s]["fingerprints"]
                                        for s in range(MD_STEPS)),
        "local_batch_1": all(r["local_batch"] == TRAIN_BATCH // MD_WORLD for r in ranks),
        "train_within_cpu_bounds": all(not md_within_bounds(st["errors"])[0] for st in steps),
        "k2_k3_6_k1_k4_k5_0_per_rank_per_step": all(
            st["launches"] == {"k1": 0, "k2": enc_layers, "k3": enc_layers, "k4": 0, "k5": 0}
            for r in ranks for st in r["steps"]),
        "nccl_backend": nccl["backend"] == "nccl" and nccl["collectives"]["calls"] > 0,
        "nccl_within_cpu_bounds": not md_within_bounds(nccl["errors"])[0],
        "eval_shards_cover_the_sets": sorted(f for fs in shards.values() for f in fs) == sorted(one["digests"])
        and all(len(fs) == len(one["digests"]) // MD_WORLD for fs in shards.values()),
        "eval_k2_6_per_image_others_0": all(
            e["launches"] == {"k1": 0, "k2": enc_layers * MD_EVAL_IMAGES // e["world"], "k3": 0, "k4": 0, "k5": 0}
            for e in evals.values()),
        "eval_metrics_equal": all(d <= 1e-9 for diffs in metric_diffs.values() for d in diffs.values()),
    }
    per_rank = [{"step_s": [st["step_s"] for st in r["steps"]],
                 "collectives_s": [st["collectives"]["s"] for st in r["steps"]],
                 "gradient_all_reduce_s": [st["collectives"]["gradients_s"] for st in r["steps"]],
                 "collective_calls": [st["collectives"]["calls"] for st in r["steps"]],
                 "collectives_share": [st["collectives"]["s"] / st["step_s"] for st in r["steps"]],
                 "peak_gb": [st["peak_gb"] for st in r["steps"]], "resident_gb": [st["resident_gb"] for st in r["steps"]],
                 "launches": [st["launches"] for st in r["steps"]],
                 "choices": [st["choices"] for st in r["steps"]]} for r in ranks]
    emit("multi_device", world=MD_WORLD, backend_on_the_card="gloo", steps=MD_STEPS,
         batch={"global": TRAIN_BATCH, "per_rank": TRAIN_BATCH // MD_WORLD}, dtype="float32", deterministic=True,
         per_rank=per_rank, vs_one_process=[md_error_summary(st["errors"]) for st in steps],
         one_process_spread=[md_error_summary(st["errors"]["spread"]) for st in steps],
         nccl_one_rank={"vs_no_group": md_error_summary(nccl["errors"]), "collectives": nccl["collectives"],
                        "peak_gb": nccl["peak_gb"]},
         eval={"images_per_set": MD_EVAL_IMAGES, "seconds": {role: e["seconds"] for role, e in evals.items()},
               "peak_gb": {role: e["peak_gb"] for role, e in evals.items()},
               "launches": {role: e["launches"] for role, e in evals.items()},
               "predictions_byte_equal": sum(same_predictions.values()), "predictions": len(same_predictions),
               "metrics_max_abs_diff": {role: max(d.values()) for role, d in metric_diffs.items()},
               "metrics_exactly_equal": {role: sum(v == 0 for v in d.values()) for role, d in metric_diffs.items()},
               "metrics": len(next(iter(metric_diffs.values())))},
         bounds={"loss_rtol": MD_LOSS_RTOL, "d_ground_rtol": MD_D_GROUND_RTOL, "grad_moment_rtol": MD_GRAD_RTOL,
                 "bn_rtol": MD_BN_RTOL, "or_twice_the_ulp_spread": True,
                 "param": f"lr * min({MD_UPDATE_GAIN} * (|dg / g| + |dc / c|) + 1e-5, {MD_PARAM_LRS}) + 2 ulp",
                 "eval_metrics_atol": 1e-9},
         within_bounds=[dict(zip(("past", "by_spread_alone"), md_within_bounds(st["errors"]))) for st in steps],
         nccl_past_bounds=md_within_bounds(nccl["errors"])[0],
         start_s=started["start_s"], checks=checks, seconds=time.perf_counter() - t_phase, card=smi,
         note="two gloo ranks time-share one card through the host: no scaling is measured")
    fail_unless("multi_device", checks)
    shutil.rmtree(work, ignore_errors=True)
    return {"train_per_rank_per_step": [r["steps"][-1]["launches"] for r in ranks],
            "eval_per_rank": {role: e["launches"] for role, e in evals.items()}}


def tp_dir():
    """Phase tensor_parallel's work directory (under build/)."""
    from uni_encoder_tpu_torch import kernels

    return os.path.join(os.path.dirname(kernels.BUILD_DIR), "tensor_parallel")


def snapshot_dict(snap):
    """A `snapshot` as plain dicts and lists of tensors (what torch.save
    takes)."""
    state, losses = snap
    params = dict(state.model.named_parameters())
    return {"params": params, "grads": {k: p.grad for k, p in params.items()},
            "buffers": dict(state.model.named_buffers()), "names": state.opt.names, "mu": state.opt.mu,
            "nu": state.opt.nu, "losses": losses}


def snapshot_from(d):
    """The `snapshot` of a `snapshot_dict`."""
    import types

    params = d["params"]
    for k, p in params.items():
        p.grad = d["grads"][k]
    model = types.SimpleNamespace(named_parameters=lambda: iter(params.items()),
                                  named_buffers=lambda: iter(d["buffers"].items()))
    return types.SimpleNamespace(model=model, opt=types.SimpleNamespace(names=d["names"], mu=d["mu"], nu=d["nu"])), \
        d["losses"]


def save_tp_reference(ref, spread, choices, lrs, resident):
    """Phase multi_device's first one-process step (its snapshot, its
    ulp-moved spread, its pinned discrete choices and learning rates, and
    `resident`: the bytes the allocator holds for its training state after
    the step, parameters, buffers, gradients and moments, and the step's
    peak GB) for
    phase tensor_parallel, which takes the same step from the same state and
    draws on a (1 x 2) grid: the choices and the step in two files, each
    written whole before it appears."""
    os.makedirs(tp_dir(), exist_ok=True)
    for name, obj in (("reference.pt", {"ref": snapshot_dict(ref), "spread": spread, "lrs": lrs,
                                         "resident": resident}),
                      ("choices.pt", {k: v.cpu() for k, v in choices.items()})):
        path = os.path.join(tp_dir(), name)
        torch.save(obj, path + ".tmp")
        os.replace(path + ".tmp", path)


def tp_fingerprints(state):
    """The `fingerprint` of every parameter, gradient, AdamW moment and
    buffer of a tensor-parallel TrainState by name ("param ...", "grad ...",
    "mu ...", "nu ...", "buffer ..."), and the names of those of parameters
    split over the model group."""
    from uni_encoder_tpu_torch.parallel import tensor

    named = dict(state.model.named_parameters())
    out = {}
    for n, p in named.items():
        out["param " + n] = fingerprint(p)
        if p.grad is not None:
            out["grad " + n] = fingerprint(p.grad)
    for key in ("mu", "nu"):
        for names, bucket in zip(state.opt.names, getattr(state.opt, key)):
            out.update({f"{key} {n}": fingerprint(m) for n, m in zip(names, bucket)})
    out.update({"buffer " + n: fingerprint(b) for n, b in state.model.named_buffers()})
    return out, sorted(k for k in out if not k.startswith("buffer ") and tensor.shard_of(named[k.split(" ", 1)[1]]))


def tp_rank(rank, rendezvous):
    """A rank of phase tensor_parallel: a (1 x 2) grid of gloo ranks sharing
    the card, the default Swin-T model at full width (deterministic, fp32)
    with the production rule's parameters (TP_MIN_DIM) split over the model
    group, train's whole synthetic batch (the data axis is 1), one step with
    the draws of a generator seeded 0, after phase multi_device's children
    freed their training's memory: the step at one process's discrete
    choices (pinned from multi_device's first step, the same step), its
    seconds, collectives, every kernel's launches, peak GB, its training
    state's allocator bytes after the step (from before the model is
    built), its replicated gradients' fingerprints before their mean and
    its `tp_fingerprints`; then the step gathered whole, and on rank 0
    `md_step_errors` against multi_device's one-process step (its ulp spread
    as `spread`) and that step's training state bytes and peak; the
    selection and the elements held."""
    from uni_encoder_tpu_torch.config import Config
    from uni_encoder_tpu_torch.parallel import mesh, tensor
    from uni_encoder_tpu_torch.training import criterion as criterion_module
    from uni_encoder_tpu_torch.training.train_step import Trainer

    dev = torch.device("cuda", 0)
    mesh.init_process_group("gloo", rank, TP_WORLD, "file://" + rendezvous)
    mesh.init_grid(TP_WORLD)
    cfg = Config()
    n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
    trainer = Trainer(cfg, device=dev, deterministic=True)
    seg, seq = (mesh.shard_batch(b) for b in train_batches(
        0, TRAIN_BATCH, cfg.input.seg_crop_train, cfg.input.depth_hw_train, TRAIN_SLOTS, TRAIN_VALID, n_texts, dev))
    before = requested_bytes(dev)
    model = trainer.build_model(seed=0)
    specs = tensor.shard_params(model, mesh.model_group(), TP_MIN_DIM)
    state, gen = trainer.init(model=model), torch.Generator(device=dev).manual_seed(0)
    init_bytes = requested_bytes(dev) - before  # the blocks kept, the whole weights freed
    md_work = os.path.join(os.path.dirname(tp_dir()), "multi_device")
    t_wait = time.perf_counter()
    for role in [f"train_rank{r}" for r in range(MD_WORLD)] + ["train_nccl"]:
        wait_for(os.path.join(md_work, f"{role}.pt.freed"))
    wait_for(os.path.join(tp_dir(), "choices.pt"))
    rec = {"waited_s": time.perf_counter() - t_wait}
    choices = {k: v.to(dev) for k, v in torch.load(os.path.join(tp_dir(), "choices.pt")).items()}
    made = {"matching": 0, "points": 0}
    originals = {"assign_on_host": criterion_module.assign_on_host,
                 "uncertainty_points": criterion_module.uncertainty_points}

    def pinned(key, fn):
        def run(*args):
            fn(*args)  # the rank's own choice is computed (and its host copy counted), then one process's taken
            made[key] += 1
            return choices[key][made[key] - 1]
        return run

    criterion_module.assign_on_host = pinned("matching", originals["assign_on_host"])
    criterion_module.uncertainty_points = pinned("points", originals["uncertainty_points"])
    totals, wrappers = timed_collectives(), kernel_wrappers()
    reset_launches(*wrappers.values())
    # the replicated gradients before their mean over the world: the same bytes on both ranks where both
    # took the same convolution algorithms
    reduce_gradients, before_mean = mesh.all_reduce_gradients, {}

    def fingerprinted(params, group=None):
        params = list(params)
        if group is None:
            before_mean.update({id(p): fingerprint(p.grad) for p in params if p.grad is not None})
        reduce_gradients(params, group)

    mesh.all_reduce_gradients = fingerprinted
    torch.cuda.reset_peak_memory_stats(dev)
    rec["free_gb_at_step"] = torch.cuda.mem_get_info(dev)[0] / 1e9
    before = requested_bytes(dev)
    rec["resident_gb"] = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = trainer.train_step(state, seg, seq, gen)
    torch.cuda.synchronize()
    rec["step_s"] = time.perf_counter() - t0
    # the training state after the step (its gradients now held), as multi_device measures one process's
    rec["state_bytes"] = init_bytes + requested_bytes(dev) - before
    mesh.all_reduce_gradients = reduce_gradients
    rec["replicated_grads_before_mean"] = [before_mean[id(p)] for p in state.model.parameters()
                                           if id(p) in before_mean]
    rec["collectives"] = dict(totals)
    rec["launches"] = {key: f.launches for key, f in wrappers.items()}
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    rec["pinned_calls"] = dict(made)
    for name, fn in originals.items():
        setattr(criterion_module, name, fn)
    rec["fingerprints"], rec["sharded_tensors"] = tp_fingerprints(state)
    params = dict(state.model.named_parameters())
    rec["specs"] = {n: list(s) for n, s in specs.items()}
    rec["elements"] = {"rank": sum(p.numel() for p in params.values()),
                       "whole": sum(int(np.prod(tensor.whole_shape(p))) for p in params.values()),
                       "sharded_rank": sum(p.numel() for p in params.values() if tensor.shard_of(p)),
                       "sharded_whole": sum(int(np.prod(tensor.whole_shape(p))) for p in params.values()
                                            if tensor.shard_of(p))}
    t0 = time.perf_counter()
    whole = snapshot(*got, gather=tensor.gather_param)
    del got
    if rank == 0:
        d = torch.load(os.path.join(tp_dir(), "reference.pt"), map_location=dev)
        rec["errors"] = md_step_errors(whole, snapshot_from(d["ref"]), d["lrs"])
        rec["errors"]["spread"] = d["spread"]
        rec["one_process"] = d["resident"]
    rec["compare_s"] = time.perf_counter() - t0
    mesh.destroy_process_group()
    return rec


def tensor_parallel_child(out_path, rank, rendezvous):
    """A child of phase tensor_parallel (`tp_rank`), saved to `out_path`;
    its allocator capped at TP_MEMORY_CAP_GB."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(TP_MEMORY_CAP_GB * 1e9 / total)
    torch.save(tp_rank(int(rank), rendezvous), out_path)


def start_tensor_parallel():
    """Start phase tensor_parallel's TP_WORLD children (`TP_CHILD`): each
    sets up its sharded model and batch, then waits for multi_device's
    children to free their training's memory and for its reference."""
    t0 = time.perf_counter()
    shutil.rmtree(tp_dir(), ignore_errors=True)
    os.makedirs(tp_dir())
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    rendezvous = os.path.join(tp_dir(), "rendezvous")
    children = []
    for r in range(TP_WORLD):
        path = os.path.join(tp_dir(), f"rank{r}.pt")
        children.append((start_child(TP_CHILD, path, str(r), rendezvous, env=env), path))
        kill_at_exit(children[-1][0])
    return {"children": children, "start_s": time.perf_counter() - t0}


def start_tp_dryrun():
    """Start `tools/dryrun_multichip_torch.py TP_DRYRUN_RANKS` (gloo ranks
    sharing the card, one thread each), its output to files in `tp_dir()`."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "dryrun_multichip_torch.py")
    log = os.path.join(tp_dir(), "dryrun")
    with open(log + ".out", "w") as out, open(log + ".err", "w") as err:
        proc = subprocess.Popen([sys.executable, tool, str(TP_DRYRUN_RANKS), "--timeout", "600"], env=env,
                                stdout=out, stderr=err)
    kill_at_exit(proc)
    return proc, log, time.perf_counter()


def finish_tp_dryrun(started):
    """Wait for the dry run `start_tp_dryrun` started: its exit code, output
    lines, error output's tail and seconds."""
    proc, log, t0 = started
    proc.wait(timeout=600)
    seconds = time.perf_counter() - t0
    with open(log + ".out") as f_out, open(log + ".err") as f_err:
        out, err = f_out.read(), f_err.read()
    return {"returncode": proc.returncode, "lines": out.strip().splitlines(), "stderr": err, "seconds": seconds}


def tensor_parallel_phase(dev, smi, started, dryrun):
    """Tensor parallelism on the card:
    (a) TP_WORLD gloo ranks as a (1 x 2) grid (`tp_rank`) take one step of
        the shipped Swin-T config at full width with the production rule's
        parameters split over the model group: the split set is the JAX
        rule's TP_RULE_PARAMS parameters and TP_RULE_ELEMENTS elements; rank
        0's step, gathered whole, within multi_device's bounds (MD_*, or
        twice the ulp spread) of one process's step from the same state and
        draws at the same discrete choices (multi_device's first step); the
        replicated parameters, gradients, moments and buffers carry equal
        fingerprints on both ranks; K2 and K3 6 launches a rank, K1, K4 and K5
        none; a rank holds half of the split elements, and its training
        state after the step, measured by the allocator, lies
        TP_BYTES_PER_ELEMENT bytes an element it does not hold below one
        process's (multi_device's rank 0), within TP_SAVED_RTOL; under
        TP_MEMORY_CAP_GB both ranks took the same algorithms (their
        replicated gradients the same bytes before the mean);
    (b) `tools/dryrun_multichip_torch.py TP_DRYRUN_RANKS` (a (2 x 2) grid of
        the JAX dry run's micro config, 4 gloo ranks on the card; run
        earlier, `dryrun` is `finish_tp_dryrun`'s) exited 0 with its
        `dryrun_multichip(...)` line and a finite loss.
    Two ranks time-sharing one card through gloo's host path measure no
    speed: the memory a rank saves and the collectives' count, MB and
    seconds are what this layout costs."""
    from uni_encoder_tpu_torch.config import Config

    t_phase = time.perf_counter()
    children = started["children"]
    ranks = finish_children([c for c, _ in children], [p for _, p in children], timeout=600)
    lines = dryrun["lines"]
    dry = re.fullmatch(r"dryrun_multichip\(n=(\d+), mesh=\((\d+), (\d+)\)\): loss=(\S+) seg=(\S+) mono=(\S+)",
                       lines[-1] if lines else "")
    enc_layers = Config().model.sem_seg_head.transformer_enc_layers
    r0 = ranks[0]
    el = r0["elements"]
    one_process_bytes = TP_BYTES_PER_ELEMENT * el["whole"]
    rank_bytes = [TP_BYTES_PER_ELEMENT * r["elements"]["rank"] for r in ranks]
    # measured: one process's training state after its step (multi_device's rank 0) against each rank's
    counted_saving = [TP_BYTES_PER_ELEMENT * (r["elements"]["sharded_whole"] - r["elements"]["sharded_rank"])
                      for r in ranks]
    measured_saving = [r0["one_process"]["bytes"] - r["state_bytes"] for r in ranks]
    replicated = sorted(set(r0["fingerprints"]) - set(r0["sharded_tensors"]))
    replicated_differing = [k for k in replicated if r0["fingerprints"][k] != ranks[1]["fingerprints"].get(k)]
    checks = {
        "sharded_set_is_the_jax_rule": all(len(r["specs"]) == TP_RULE_PARAMS
                                           and r["elements"]["sharded_whole"] == TP_RULE_ELEMENTS for r in ranks)
        and ranks[1]["specs"] == r0["specs"],
        "replicated_fingerprints_equal": not replicated_differing and len(replicated) > 0,
        "blocks_differ": all(r0["fingerprints"][k] != ranks[1]["fingerprints"][k] for k in r0["sharded_tensors"]),
        "within_md_bounds": not md_within_bounds(r0["errors"])[0],
        "k2_k3_6_k1_k4_k5_0_per_rank": all(
            r["launches"] == {"k1": 0, "k2": enc_layers, "k3": enc_layers, "k4": 0, "k5": 0} for r in ranks),
        "rank_holds_half_the_split_elements": all(
            2 * r["elements"]["sharded_rank"] == TP_RULE_ELEMENTS for r in ranks),
        "measured_state_bytes_saved_as_counted": all(
            abs(m - c) <= TP_SAVED_RTOL * c for m, c in zip(measured_saving, counted_saving)),
        "same_algorithms_on_both_ranks": ranks[0]["replicated_grads_before_mean"]
        == ranks[1]["replicated_grads_before_mean"] and len(ranks[0]["replicated_grads_before_mean"]) > 0,
        "pinned_choices_used": all(r["pinned_calls"]["matching"] == 1 and r["pinned_calls"]["points"] > 0
                                   for r in ranks),
        "dryrun_exit_0": dryrun["returncode"] == 0,
        "dryrun_line_finite": bool(dry) and dry.group(1, 2, 3) == (str(TP_DRYRUN_RANKS), "2", "2")
        and all(np.isfinite(float(v)) for v in dry.group(4, 5, 6)),
    }
    emit("tensor_parallel", grid=[1, TP_WORLD], backend_on_the_card="gloo", min_dim=TP_MIN_DIM,
         batch={"global": TRAIN_BATCH, "per_rank": TRAIN_BATCH}, dtype="float32", deterministic=True,
         sharded={"params": len(r0["specs"]), "elements": el["sharded_whole"],
                  "column": sum(s == [None, "model"] for s in r0["specs"].values()),
                  "row": sum(s == ["model", None] for s in r0["specs"].values()), "of_elements": el["whole"]},
         bytes={"one_process": one_process_bytes, "per_rank": rank_bytes,
                "saved_per_rank": [one_process_bytes - b for b in rank_bytes],
                "counting": f"{TP_BYTES_PER_ELEMENT} bytes an fp32 element: parameter, gradient, AdamW's two moments"},
         measured_state_bytes={"one_process": r0["one_process"]["bytes"],
                               "per_rank": [r["state_bytes"] for r in ranks],
                               "saved_per_rank": measured_saving, "counted_saving": counted_saving,
                               "rtol": TP_SAVED_RTOL,
                               "how": "allocator's requested bytes from before the model is built to after the step",
                               "one_process_choices_kept_apart": r0["one_process"]["choices_bytes"]},
         peak_gb={"per_rank": [r["peak_gb"] for r in ranks], "cap_gb": TP_MEMORY_CAP_GB,
                  "one_process_step": r0["one_process"]["peak_gb"],
                  "free_gb_at_step": [r["free_gb_at_step"] for r in ranks],
                  "replicated_grads_differing_before_mean": sum(
                      a != b for a, b in zip(*(r["replicated_grads_before_mean"] for r in ranks)))},
         per_rank=[{"step_s": r["step_s"], "collectives": r["collectives"],
                    "collectives_share": r["collectives"]["s"] / r["step_s"], "peak_gb": r["peak_gb"],
                    "resident_gb": r["resident_gb"], "launches": r["launches"], "waited_s": r["waited_s"],
                    "compare_s": r["compare_s"]} for r in ranks],
         fingerprints={"replicated": len(replicated), "replicated_differing": replicated_differing[:20],
                       "sharded": len(r0["sharded_tensors"])},
         vs_one_process=md_error_summary(r0["errors"]), one_process_spread=md_error_summary(r0["errors"]["spread"]),
         within_bounds=dict(zip(("past", "by_spread_alone"), md_within_bounds(r0["errors"]))),
         dryrun={"lines": lines[-4:], "seconds": dryrun["seconds"],
                 "stderr_tail": dryrun["stderr"][-2000:] if dryrun["returncode"] else ""},
         start_s=started["start_s"], checks=checks, seconds=time.perf_counter() - t_phase, card=smi,
         note="two gloo ranks time-share one card through the host: no speed is measured")
    fail_unless("tensor_parallel", checks)
    shutil.rmtree(tp_dir(), ignore_errors=True)
    return {"per_rank_per_step": [r["launches"] for r in ranks]}


def spatial_config(key):
    """The model config of SPATIAL_MODELS[key]."""
    import dataclasses

    from uni_encoder_tpu_torch.config import Config, load_config

    path, pixel, _ = SPATIAL_MODELS[key]
    cfg = Config().model if path is None else load_config(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), path)).model
    if pixel is not None:
        cfg = dataclasses.replace(cfg, sem_seg_head=dataclasses.replace(cfg.sem_seg_head, pixel_decoder_name=pixel))
    return cfg


def spatial_model(cfg, dev, on_card=True):
    """The segmentation modules of `cfg`'s UniEncoder on the card (the
    sequence modules stay on the meta device: neither forward of the phase
    reaches them), random weights drawn from a generator seeded 0
    (`random_init_` on it) on the card, or with `on_card` False on the host
    (the weights `UniEncoder(cfg, seed=0)` gives them), the class head x8
    as in serve."""
    from uni_encoder_tpu_torch.models.layers import random_init_
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    model = UniEncoder(cfg, device="meta")
    g = torch.Generator(device=dev if on_card else "cpu").manual_seed(0)
    for m in (model.backbone, model.pixel_decoder, model.predictor, model.task_mlp):
        m.to_empty(device=dev)
        random_init_(m, g)
    with torch.no_grad():
        model.predictor.class_embed.weight.mul_(8.0)
    return model.eval()


def spatial_serve(key, ranked, dev, images, tokens, wrappers, totals, model=None):
    """One model of phase spatial in its child: SPATIAL_MODELS[key] built on
    the card (`spatial_model`), one fp32 forward (TF32 off), then in bf16 a
    warm-up request (on rank 0 the first K2 call, on its scattered queries,
    and the first K4 call, on its row window, recorded and held against
    their plain versions) and the timed ones, with every kernel's launches,
    the all-reduces' seconds, calls and bytes (from the running `totals`),
    and the peak memory of the timed requests (`model`: the model, built
    already). Returns the fp32 outputs (a rank's rows of the masks), on
    Swin-T also the last bf16 request's logits and whole masks
    (`gather_rows` on the ranks)."""
    from unittest import mock

    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_cuda, ms_deform_attn_fused_plain
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d_cuda,
        neighborhood_attention_2d_plain,
    )
    from uni_encoder_tpu_torch.parallel import mesh, spatial

    t0 = time.perf_counter()
    if model is None:
        model = spatial_model(spatial_config(key), dev)
    torch.cuda.synchronize()
    result = {"build_s": time.perf_counter() - t0}

    def request(x):
        if ranked:
            return spatial.spatial_inference(model, x, tokens)
        return model.forward_segmentation(x, tokens)

    with torch.inference_mode():
        t0 = time.perf_counter()
        out = request(images)
        torch.cuda.synchronize()
        result["fp32"] = {"pred_logits": out["pred_logits"].cpu(), "pred_masks": out["pred_masks"].cpu(),
                          "rows": out.get("rows", (0, SEG_H // 4)), "seconds": time.perf_counter() - t0}
        del out
        model.to(torch.bfloat16)
        x = images.to(torch.bfloat16)
        recorded = {}
        k2_fn, k4_fn = spatial.ms_deform_attn_fused, spatial.neighborhood_attention_2d

        def record_k2(*args):
            recorded.setdefault("k2", args)
            return k2_fn(*args)

        def record_k4(*args, rows=None):
            recorded.setdefault("k4", args + (rows,))
            return k4_fn(*args, rows=rows)

        t0 = time.perf_counter()
        with mock.patch.object(spatial, "ms_deform_attn_fused", record_k2), \
                mock.patch.object(spatial, "neighborhood_attention_2d", record_k4):
            request(x)
        torch.cuda.synchronize()
        result["warmup_ms"] = (time.perf_counter() - t0) * 1e3
        if ranked and mesh.rank() == 0 and "k2" in recorded:
            value, shapes, offsets, logits, ref_abs = recorded["k2"]
            result["k2_scattered_queries"] = {
                "max_abs_err": compare_msda(ms_deform_attn_fused_cuda(value, shapes, offsets, logits, ref_abs),
                                            ms_deform_attn_fused_plain(value, shapes, offsets, logits, ref_abs),
                                            fp32=False),
                "Lq": int(ref_abs.shape[1]), "S": int(value.shape[1]), "dtype": "bfloat16",
                "level_grids": [list(hw) for hw in shapes]}
        if ranked and mesh.rank() == 0 and "k4" in recorded:
            q, k, v, rpb, kernel, dilation, scale, rows = recorded["k4"]
            result["k4_row_window"] = {
                "max_abs_err": compare_msda(neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, dilation, scale,
                                                                           rows=rows),
                                            neighborhood_attention_2d_plain(q, k, v, rpb, kernel, dilation, scale,
                                                                            rows),
                                            fp32=False, name="K4 row window"),
                "q": list(q.shape), "key_rows": int(k.shape[1]), "rows_height_q_row_k_row": list(rows),
                "dilation": dilation, "dtype": "bfloat16"}
        del recorded
        reset_launches(*wrappers.values())
        before = dict(totals)
        torch.cuda.reset_peak_memory_stats(dev)
        request_ms = []
        for _ in range(SPATIAL_MODELS[key][2]):
            t0 = time.perf_counter()
            out = request(x)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
        result.update(request_ms=request_ms, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                      launches={k: w.launches for k, w in wrappers.items()},
                      collectives={k: totals[k] - before[k] for k in ("calls", "s", "bytes")},
                      weights_gb=sum(p.numel() * p.element_size() for p in model.parameters()
                                     if not p.is_meta) / 1e9)
        if key == "swin":  # gather_rows is a collective: every rank takes part
            masks = spatial.gather_rows(out["pred_masks"], out["rows"], out["height"]) if ranked else out["pred_masks"]
            if not ranked or mesh.rank() == 0:
                result["bf16"] = {"pred_logits": out["pred_logits"].cpu(), "pred_masks": masks.cpu()}
    return result


def spatial_child(out_path, role, rendezvous):
    """A child of phase spatial: `role` rank<r>, a gloo rank of SPATIAL_WORLD
    on the card running `spatial_inference` on its rows of the image, or
    one, the one-process `forward_segmentation`. A 1024x2048 image from seed
    0 and the Swin-T model (its weights drawn on the host, as
    `UniEncoder(seed=0)` draws them: the weights its K1 map checks were set
    on; slow, so before the go file) are set up first; at the go file every
    model of SPATIAL_MODELS in turn (`spatial_serve`), each freed before
    the next. Saves what each returns to `out_path`."""
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ranked = role != "one"
    if ranked:
        mesh.init_process_group("gloo", int(role[len("rank"):]), SPATIAL_WORLD, "file://" + rendezvous)
    t0 = time.perf_counter()
    images = torch.from_numpy(np.random.RandomState(0).randn(1, SEG_H, SEG_W, 3).astype(np.float32)).to(dev)
    tokens = torch.tensor([tokenize_task(TASK)], dtype=torch.int64, device=dev)
    prebuilt = {"swin": spatial_model(spatial_config("swin"), dev, on_card=False)}
    result = {"setup_s": time.perf_counter() - t0}
    wait_for(os.path.join(os.path.dirname(out_path), ("go_ranks" if ranked else "go_one")))
    wrappers = kernel_wrappers()
    totals = timed_collectives() if ranked else {"calls": 0, "s": 0.0, "bytes": 0}
    for key in SPATIAL_MODELS:
        result[key] = spatial_serve(key, ranked, dev, images, tokens, wrappers, totals, prebuilt.pop(key, None))
        torch.cuda.empty_cache()
    if ranked:
        mesh.destroy_process_group()
    torch.save(result, out_path)


def start_spatial():
    """Start phase spatial's children (`SPATIAL_CHILD`): SPATIAL_WORLD gloo
    ranks and one process, each setting up its model and image and then
    waiting for its go file, so that their start-up overlaps the phases
    before it (≈1 GB of the card each until then)."""
    from uni_encoder_tpu_torch import kernels

    work = os.path.join(os.path.dirname(kernels.BUILD_DIR), "spatial")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    children = {}
    for role in [f"rank{r}" for r in range(SPATIAL_WORLD)] + ["one"]:
        path = os.path.join(work, f"{role}.pt")
        children[role] = (start_child(SPATIAL_CHILD, path, role, os.path.join(work, "rendezvous")), path)
        kill_at_exit(children[role][0])
    return {"work": work, "children": children}


def spatial_phase(dev, smi, started):
    """One 1024x2048 image split by rows over SPATIAL_WORLD gloo ranks
    sharing the card (`uni_encoder_tpu_torch/parallel/spatial.py`), in
    child processes (`spatial_child`): first the one-process child, then
    the ranks, each serving every model of SPATIAL_MODELS in turn. One line
    per model. It fails unless, on every model, the ranks' fp32 logits are
    the same bytes, the partitioned fp32 forward equals the one-process one
    within SPATIAL_ATOL, SPATIAL_RTOL (the `backbones` end-to-end rule),
    each rank's peak is at most the one process's (on Swin-T at most
    SPATIAL_PEAK_SHARE of it), every process ran K2 6 times a request on the
    MSDeformAttn models and none on the FPN ones, K4 30 times a request on
    DiNAT-L and no other kernel ran, and on rank 0 the first K2 call (its
    scattered queries) and on DiNAT-L the first K4 call (its row window)
    agree with their plain versions. On Swin-T also: the semantic map that
    K1 makes of rank 0's gathered bf16 outputs mismatches the one-process
    bf16 request's in under 3e-3 of the pixels (K1's map tolerance), and
    its panoptic map mismatches the one process's in under 3e-3 of the
    pixels at bf16 or at fp32 (a segment whose keep or overlap decision lies
    within rounding of its threshold goes either way between two orders of
    bf16 sums, as between the one process's two precisions: the line counts
    the segments each side keeps). Two ranks time-sharing one card through
    gloo's host path measure no latency gain: the request ms and the
    collectives' share are what this layout costs. Returns every kernel's
    launches per process, summed over the models."""
    t_phase = time.perf_counter()
    children, work = started["children"], started["work"]
    roles = [f"rank{r}" for r in range(SPATIAL_WORLD)]
    open(os.path.join(work, "go_one"), "w").close()
    done = dict(zip(["one"], finish_children([children["one"][0]], [children["one"][1]], timeout=600)))
    open(os.path.join(work, "go_ranks"), "w").close()
    done.update(zip(roles, finish_children([children[r][0] for r in roles], [children[r][1] for r in roles],
                                           timeout=600)))
    totals = {role: {k: 0 for k in ("k1", "k2", "k3", "k4", "k5")} for role in ["one"] + roles}
    failed = []
    for key in SPATIAL_MODELS:
        one, ranks = done["one"][key], [done[r][key] for r in roles]
        cfg = spatial_config(key)
        n_req = SPATIAL_MODELS[key][2]
        Q, K = cfg.one_former.num_object_queries, cfg.sem_seg_head.num_classes
        msda = cfg.sem_seg_head.pixel_decoder_name == "MSDeformAttnPixelDecoder"
        dinat = cfg.backbone.name == "dinat"
        masks = torch.cat([r["fp32"]["pred_masks"] for r in ranks], dim=2)
        logits_fields, logits_ok = small_output_check(ranks[0]["fp32"]["pred_logits"], one["fp32"]["pred_logits"],
                                                      SPATIAL_ATOL, SPATIAL_RTOL, outliers=True)
        masks_fields, masks_ok = small_output_check(masks, one["fp32"]["pred_masks"], SPATIAL_ATOL, SPATIAL_RTOL,
                                                    outliers=True)
        peak_share = [r["peak_gb"] / one["peak_gb"] for r in ranks]
        want = {"k1": 0, "k2": (cfg.sem_seg_head.transformer_enc_layers * n_req if msda else 0), "k3": 0,
                "k4": (sum(cfg.backbone.dinat.depths) * n_req if dinat else 0), "k5": 0}
        checks = {
            "fp32_logits_same_bytes_on_ranks": all(
                torch.equal(r["fp32"]["pred_logits"], ranks[0]["fp32"]["pred_logits"]) for r in ranks),
            "rows_cover_the_map": [tuple(r["fp32"]["rows"]) for r in ranks] == [
                (SEG_H // 4 * i // SPATIAL_WORLD, SEG_H // 4 * (i + 1) // SPATIAL_WORLD)
                for i in range(SPATIAL_WORLD)],
            "fp32_pred_logits_within": logits_ok,
            "fp32_pred_masks_within": masks_ok,
            "fp32_finite": all(bool(torch.isfinite(r["fp32"]["pred_masks"]).all() and torch.isfinite(
                r["fp32"]["pred_logits"]).all()) for r in ranks + [one]),
            "launches_per_request_exact": all(r["launches"] == want for r in ranks + [one]),
            "rank_peak_at_most_one_process": all(s <= 1.0 for s in peak_share),
        }
        if msda:
            checks["k2_scattered_queries_checked"] = "k2_scattered_queries" in ranks[0]
        if dinat:
            checks["k4_row_window_checked"] = "k4_row_window" in ranks[0]
        k1_maps = None
        if key == "swin":
            k1_maps = spatial_k1_maps(one, ranks, masks, Q, K, dev)
            checks.update({
                "finite_bf16": all(bool(torch.isfinite(r["bf16"]["pred_masks"]).all() and torch.isfinite(
                    r["bf16"]["pred_logits"]).all()) for r in (ranks[0], one)),
                "k1_semantic_map_within_3e-3": k1_maps["rank0_bf16_vs_one_bf16"]["sem_seg_argmax"] < 3e-3,
                "k1_panoptic_map_within_3e-3_of_one_process_bf16_or_fp32": min(
                    k1_maps[f"rank0_bf16_vs_one_{p}"]["panoptic_seg"] for p in ("bf16", "fp32")) < 3e-3,
                "rank_peak_at_most_0.75_of_one_process": all(s <= SPATIAL_PEAK_SHARE for s in peak_share)})
        for role, r in zip(["one"] + roles, [one] + ranks):
            for k, n in r["launches"].items():
                totals[role][k] += n
        per_rank = [{"request_ms": r["request_ms"], "warmup_ms": r["warmup_ms"], "fp32_s": r["fp32"]["seconds"],
                     "peak_gb": r["peak_gb"], "peak_share_of_one_process": sh, "collectives_s": r["collectives"]["s"],
                     "collectives_share": r["collectives"]["s"] / (sum(r["request_ms"]) / 1e3),
                     "all_reduce_calls_per_request": r["collectives"]["calls"] / n_req,
                     "all_reduce_mb_per_request": r["collectives"]["bytes"] / n_req / 1e6,
                     "launches": r["launches"], "rows": r["fp32"]["rows"], "build_s": r["build_s"]}
                    for r, sh in zip(ranks, peak_share)]
        emit("spatial", model=key, config=SPATIAL_MODELS[key][0] or "default",
             pixel_decoder=cfg.sem_seg_head.pixel_decoder_name, backbone=cfg.backbone.name, world=SPATIAL_WORLD,
             backend_on_the_card="gloo", image=[1, SEG_H, SEG_W, 3], requests=n_req, per_rank=per_rank,
             one_process={"request_ms": one["request_ms"], "warmup_ms": one["warmup_ms"],
                          "fp32_s": one["fp32"]["seconds"], "peak_gb": one["peak_gb"], "launches": one["launches"],
                          "build_s": one["build_s"]},
             weights_gb=one["weights_gb"],
             fp32_vs_one_process={"pred_logits": logits_fields, "pred_masks": masks_fields},
             tolerance={"atol": SPATIAL_ATOL, "rtol": SPATIAL_RTOL, "outliers": SMALL_PRED_OUTLIERS,
                        "outlier_max_abs": SMALL_PRED_MAX_ERR},
             k1_map_mismatch=k1_maps, k2_scattered_queries=ranks[0].get("k2_scattered_queries"),
             k4_row_window=ranks[0].get("k4_row_window"), checks=checks, seconds=time.perf_counter() - t_phase,
             setup_s={"one": done["one"]["setup_s"], **{r: done[r]["setup_s"] for r in roles}}, card=smi,
             note="two gloo ranks time-share one card through the host: no latency gain is measured")
        failed += [f"{key}: {name}" for name, ok in checks.items() if not ok]
    fail_unless("spatial", {name: False for name in failed} or {"every_model": True})
    shutil.rmtree(work, ignore_errors=True)
    return totals


def spatial_k1_maps(one, ranks, masks, Q, K, dev):
    """K1 at the served thresholds on rank 0's gathered bf16 outputs, on the
    one process's bf16 request, on the one process's fp32 forward and on the
    ranks' fp32 forward (masks cast to bf16), and the share of pixels where
    their maps differ: a query whose keep or overlap decision lies within
    rounding of its threshold goes either way between two orders of bf16
    sums, as between the one process's two precisions."""
    from uni_encoder_tpu_torch.inference.fused_postprocess import fused_multitask_inference

    thing = torch.isin(torch.arange(K), torch.arange(11, 19)).to(dev)
    kw = dict(object_mask_threshold=0.8, overlap_threshold=0.8, topk=Q)
    post = {name: fused_multitask_inference(logits[0].to(dev), masks_[0].to(dev, torch.bfloat16), thing, **kw)
            for name, logits, masks_ in (
                ("rank0_bf16", ranks[0]["bf16"]["pred_logits"], ranks[0]["bf16"]["pred_masks"]),
                ("one_bf16", one["bf16"]["pred_logits"], one["bf16"]["pred_masks"]),
                ("one_fp32", one["fp32"]["pred_logits"], one["fp32"]["pred_masks"]),
                ("ranks_fp32", ranks[0]["fp32"]["pred_logits"], masks))}

    def segment_map(p):
        """The panoptic map with each segment named by its first query (-1:
        void), whatever its id."""
        new = p["is_new_segment"].bool()
        lut = torch.full((256,), -1, dtype=torch.long, device=dev)
        lut[p["seg_id"][new].long()] = torch.nonzero(new).flatten()
        lut[0] = -1
        return lut[p["panoptic_seg"].long()]

    def map_mismatch(a, b):
        kept = [set(torch.nonzero(post[x]["is_new_segment"]).flatten().tolist()) for x in (a, b)]
        return {"panoptic_seg": (post[a]["panoptic_seg"] != post[b]["panoptic_seg"]).float().mean().item(),
                "segments_by_first_query": (segment_map(post[a]) != segment_map(post[b])).float().mean().item(),
                "sem_seg_argmax": (post[a]["sem_seg_argmax"] != post[b]["sem_seg_argmax"]).float().mean().item(),
                "segments": [len(k) for k in kept], "segments_kept_by_one_side": sorted(kept[0] ^ kept[1])}

    return {"rank0_bf16_vs_one_bf16": map_mismatch("rank0_bf16", "one_bf16"),
            "rank0_bf16_vs_one_fp32": map_mismatch("rank0_bf16", "one_fp32"),
            "ranks_fp32_vs_one_fp32": map_mismatch("ranks_fp32", "one_fp32"),
            "one_bf16_vs_one_fp32": map_mismatch("one_bf16", "one_fp32")}


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
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d_backward_cuda,
        neighborhood_attention_2d_cuda,
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
    k4_usage = ptxas_usage(kernels.build_log_path("neighborhood_attention"), "na2d_kernel")
    k4_frames = ptxas_stack_frames(kernels.build_log_path("neighborhood_attention"), "na2d_kernel")
    k5_usage = ptxas_usage(kernels.build_log_path("neighborhood_attention_backward"), "na2d_bwd")
    k1_hmma = sass_count(kernels.library_path("fused_postprocess"), "HMMA")
    # K4's fp32 kernel runs on CUDA cores: every HMMA is the bf16 kernel's
    k4_hmma = sass_count(kernels.library_path("neighborhood_attention"), "HMMA")
    k5_hmma = sass_count(kernels.library_path("neighborhood_attention_backward"), "HMMA")
    emit("build", seconds=time.perf_counter() - t0, per_source=secs, ptxas=ptxas,
         k2_stack_frame_bytes=k2_frames, k3_stack_frame_bytes=k3_frames, k1_stack_frame_bytes=k1_frames,
         k4_stack_frame_bytes=k4_frames, k4_ptxas=k4_usage, k5_ptxas=k5_usage, k1_sass_hmma=k1_hmma,
         k4_sass_hmma=k4_hmma, k5_sass_hmma=k5_hmma)
    for name, frames in (("K2", k2_frames), *((f"K3 {k}", v) for k, v in k3_frames.items()), ("K4", k4_frames)):
        if not frames or any(frames):
            raise AssertionError(f"{name} stack frames {frames}: expected 0 bytes for every instantiation")
    if len(k4_usage) != 4 or any(u.get("spill_bytes") != 0 or "registers" not in u for u in k4_usage.values()):
        raise AssertionError(f"K4's four kernels (bf16 and fp32, each for whole maps and for row windows) must build "
                             f"without spills: {k4_usage}")
    if sorted(k for k in K5_KERNELS if any(k in n for n in k5_usage)) != sorted(K5_KERNELS) or any(
            u.get("stack_frame") != 0 or u.get("spill_bytes") != 0 or "registers" not in u for u in k5_usage.values()):
        raise AssertionError(f"K5's three kernels must build with 0-byte stack frames and no spills: {k5_usage}")
    if k1_hmma == 0:
        raise AssertionError("K1's SASS holds no HMMA: the semantic product is not on tensor cores")
    if k4_hmma == 0:
        raise AssertionError("K4's SASS holds no HMMA: the bf16 logits are not on tensor cores")
    if k5_hmma == 0:
        raise AssertionError("K5's SASS holds no HMMA: its 3xTF32 products are not on tensor cores")

    results = {}
    # train_backbones' DiNAT-L small step and train_decoders' small steps on
    # the CPU run in children from here on (up to 9 cores for the first
    # minute, then 6 and fewer), beside the card's phases up to train, which
    # drive it from one core
    dinat_cpu_steps = start_cpu_steps(
        "train_dinat", os.path.join(os.path.dirname(os.path.abspath(__file__)), BACKBONE_CONFIGS["dinat"]),
        DINAT_CPU_THREADS, 1)
    decoder_cpu_steps = {key: start_cpu_steps(f"train_decoders_{key}", DECODER_CHILD_CONFIG + key,
                                              ",".join(DECODER_CPU_STEPS))[0] for key in DECODER_MODELS}

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

    # ------------------------------------------------- K4 against its plain
    k4_fields, k4_compile = k4_phase(dev, smi, k4_usage)
    results["k4"] = dict(k4_fields, stack_frame_bytes=max(k4_frames))

    # ------------------------------- K5, K4's backward, against its plain
    k5_fields, k5_compile = k5_phase(dev, smi, k5_usage)
    results["k5"] = dict(k5_fields, stack_frame_bytes=max(u["stack_frame"] for u in k5_usage.values()))
    # their library yardsticks compile while this process waits for
    # children below, K4's in train_deterministic, K5's in multi_device
    yardsticks = {}

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
    # (held below, beside train_deterministic's one-thread CPU step)
    small = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        m, grads, _ = small_train_step(Trainer, train_cfg, d)
        small[name] = ({k: float(v) for k, v in m.items()}, {n: v.cpu() for n, v in grads.items()})
        del m, grads

    # The small Swin-T step on the CPU at one thread runs in a child, on one
    # core, beside the deterministic children only: the CPU's own spread
    # bounds the deterministic step's comparison with the default one
    # (RANSAC's plane fit and the motion decoder's gradients move with the
    # order of fp32 sums alone). Started earlier, it would share the host
    # with default steps, whose cuDNN benchmark picks algorithms by time
    swin_noise_path = os.path.join(os.path.dirname(kernels.BUILD_DIR), "train_swin_cpu_1_thread.pt")
    swin_noise_child = start_child(CPU_STEP_CHILD, swin_noise_path, DEFAULT_CONFIG, "1")
    kill_at_exit(swin_noise_child)

    # ---- the same step in two processes at once, deterministic: the same
    # bytes; each child then takes the DiNAT-L config's step, which phase
    # train_backbones holds
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    paths = [os.path.join(os.path.dirname(kernels.BUILD_DIR), f"train_deterministic_{i}.pt") for i in range(2)]
    dinat_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), BACKBONE_CONFIGS["dinat"])
    deterministic, workspace = deterministic_children(
        paths, (DEFAULT_CONFIG, dinat_path), meanwhile=lambda: yardsticks.update(k4=compile_yardstick(k4_compile)))
    children_s = time.perf_counter() - t0
    (runs, equal), dinat_deterministic = deterministic.pop(DEFAULT_CONFIG), deterministic.pop(dinat_path)
    # and a child's deterministic step against this process's default one:
    # the same function, not the same sums, so a quantity may also differ by
    # twice the CPU's own spread (its step at one thread against this
    # process's at its thread count)
    t1 = time.perf_counter()
    (swin_one_thread,) = finish_children([swin_noise_child], [swin_noise_path], timeout=600)
    noise_wait_s = time.perf_counter() - t1
    yardsticks["k4"] = time_yardstick(yardsticks["k4"], torch.inference_mode)
    noise = (swin_one_thread[1]["losses"], swin_one_thread[1]["grads"])
    det = ({k: float(v) for k, v in runs[0]["losses"].items()}, runs[0]["grads"])
    cpu_steps = (noise, small["cpu"])
    # the card's small step against the CPU's: the same rule as the
    # deterministic step's and train_backbones' (the motion decoder's
    # gradient moves by about 1e-3 with the order of fp32 sums alone)
    loss_err, grad_err = small_step_errors("train_reference_small", small["cuda"], small["cpu"], WATCHED, cpu_steps)
    noise_loss, noise_grad = step_differences(*cpu_steps, WATCHED)
    emit("train_reference_small", segmentation=[TRAIN_BATCH, 128, 256, 3], sequence=[TRAIN_BATCH, 3, 64, 128, 3],
         dtype="float32", loss_abs_err=loss_err, grad_relative_norm_err=grad_err,
         cpu_threads=[torch.get_num_threads(), 1], cpu_vs_cpu_loss_abs_err=noise_loss,
         cpu_vs_cpu_grad_relative_norm_err=noise_grad,
         tolerance="losses atol 1e-4 + rtol 1e-3; gradients |cuda - cpu| / |cpu| < 1e-3; or within twice the "
                   "CPU's own difference at 1 thread against the other count")
    det_loss_err, det_grad_err = small_step_errors("train_deterministic", det, small["cuda"], WATCHED, cpu_steps)
    emit("train_deterministic", children=len(paths), concurrent=True, cublas_workspace_config=workspace,
         child_step_s=[r["seconds"] for r in runs], byte_equal=equal,
         children_s_with_dinat_steps=children_s,
         compared={"losses": len(runs[0]["losses"]), "grads": len(runs[0]["grads"]),
                   "params": len(runs[0]["params"]),
                   "param_elements": sum(v.numel() for v in runs[0]["params"].values())},
         vs_default_step={"loss_abs_err": det_loss_err, "grad_relative_norm_err": det_grad_err,
                          "cpu_threads": [torch.get_num_threads(), 1], "one_thread_child_wait_s": noise_wait_s,
                          "cpu_vs_cpu_loss_abs_err": noise_loss, "cpu_vs_cpu_grad_relative_norm_err": noise_grad,
                          "tolerance": "losses atol 1e-4 + rtol 1e-3; gradients relative norm < 1e-3; or within "
                                       "twice the CPU's own difference at 1 thread against the other count"},
         seconds=time.perf_counter() - t0, card=smi)
    fail_unless("train_deterministic", equal)
    del small, runs

    # ---------------- training on the ResNet-18, ConvNeXt-L and DiNAT-L configs
    kernel_fns = {"k1": fused_postprocess_cuda, "k2": ms_deform_attn_fused_cuda,
                  "k3": ms_deform_attn_fused_backward_cuda, "k4": neighborhood_attention_2d_cuda,
                  "k5": neighborhood_attention_2d_backward_cuda}
    train_backbone_launches = train_backbones_phase(dev, smi, kernel_fns, dinat_deterministic, workspace,
                                                    dinat_cpu_steps)
    torch.cuda.empty_cache()

    # ---------------- training with the other pixel and depth decoders
    train_decoder_launches = train_decoders_phase(dev, smi, kernel_fns, decoder_cpu_steps)
    torch.cuda.empty_cache()

    # ---------------- the throughput and model-analysis tools
    tools_launches = tools_phase(dev, smi, kernel_fns)
    torch.cuda.empty_cache()

    # ---------------- the training entry point: the production config, full
    # width and depth, on a synthetic full-size tree (the train phase's state
    # is gone: two of its 52 GB training states do not fit the card), then
    # the DiNAT-L config (its convolutions' shapes benchmarked above)
    train_entry_launches = train_entry_phase(dev, smi)
    torch.cuda.empty_cache()

    # ---------------- the evaluation entry point on synthetic full-size data
    # (last: the shape-keyed device constants of its TTA scales stay cached)
    eval_launches = eval_phase(dev, smi)
    torch.cuda.empty_cache()

    # ---------------- the ResNet-18, ConvNeXt-L and DiNAT-L configs, served
    backbone_launches = backbones_phase(dev, smi, kernel_fns)
    torch.cuda.empty_cache()

    # ---------------- Swin-T with the other pixel and depth decoders, served;
    # the modules no config selects
    decoder_launches = decoders_phase(dev, smi, kernel_fns)
    torch.cuda.empty_cache()

    # ---------------- the checkpoint-conversion command line, the demo on its
    # output (Swin-T) and on DiNAT-L, and ADE20K evaluation (after eval, which
    # checks that the Cityscapes path imports neither PIL nor cv2: these draw
    # labels, read JPEG files and fill polygons)
    import tempfile

    # phases multi_device's and spatial's children set themselves up beside
    # the next phases
    multi_device = start_multi_device()
    tensor_parallel = start_tensor_parallel()
    tp_dryrun = start_tp_dryrun()  # beside the next phases: the card has room until multi_device trains
    spatial = start_spatial()
    with tempfile.TemporaryDirectory() as convert_root:
        converted = convert_phase(dev, smi, convert_root)
        demo_launches = demo_phase(dev, smi, kernel_fns, converted)
    torch.cuda.empty_cache()
    ade20k_eval_launches = eval_ade20k_phase(dev, smi, kernel_fns)
    torch.cuda.empty_cache()

    # ---------------- one image split by rows over ranks in child processes
    # sharing the card
    spatial_launches = spatial_phase(dev, smi, spatial)

    # ---------------- data-parallel training and sharded evaluation: ranks
    # in child processes sharing the card (full while they train: the
    # tensor_parallel dry run has ended before); phase tensor_parallel's ranks
    # take their step once multi_device's have freed their training's memory
    tp_dryrun = finish_tp_dryrun(tp_dryrun)
    multi_device_launches = multi_device_phase(
        dev, smi, multi_device, meanwhile=lambda: yardsticks.update(k5=compile_yardstick(k5_compile)))
    tensor_parallel_launches = tensor_parallel_phase(dev, smi, tensor_parallel, tp_dryrun)
    yardsticks["k5"] = time_yardstick(yardsticks["k5"], functorch_patch(donated_buffer=False))
    for key, fields in yardsticks.items():
        results[key]["library_ms"] = fields.get("ms")
    emit("library_yardsticks", at="stage 0, dilation 1", k4=yardsticks["k4"], k5=yardsticks["k5"],
         compiled_during={"k4": "train_deterministic", "k5": "multi_device"}, card=smi)

    print(smi, flush=True)
    rows = []
    # K1 and K2 launches are the served requests' (phase serve), K3's the
    # timed training steps' (phase train); train_entry_launches those of the
    # two train_torch runs (phase train_entry), eval_launches those of the
    # two evaluate_torch runs (phase eval), backbones_launches those of the
    # three configs' served requests (phase backbones), train_backbones_launches
    # those of the three configs' timed training steps (phase
    # train_backbones), train_decoders_launches those of the three decoder
    # models' timed steps (phase train_decoders), tools_launches those of the
    # two tools' runs (phase tools), demo_launches those of the two demo_torch runs (phase
    # demo), ade20k_eval_launches those of the two ADE20K evaluate_torch runs
    # (phase eval_ade20k); K4's launches are the DiNAT config's served requests',
    # both kinds, K5's the DiNAT config's timed training steps'
    launches["k3"] = train_launches["k3"]
    launches["k4"] = sum(backbone_launches["dinat"][kind]["k4"] for kind in ("segmentation", "sequence"))
    launches["k5"] = train_backbone_launches["dinat"]["k5"]
    for key, name, source, replaces in (
        ("k1", "fused_multitask_inference", "uni_encoder_tpu_torch/kernels/csrc/fused_postprocess.cu",
         "uni_encoder_tpu/inference/fused_postprocess.py:61"),
        ("k2", "ms_deform_attn_fused", "uni_encoder_tpu_torch/kernels/csrc/ms_deform_attn.cu",
         "uni_encoder_tpu/ops/ms_deform_attn.py:73"),
        ("k3", "ms_deform_attn_fused_backward", "uni_encoder_tpu_torch/kernels/csrc/ms_deform_attn_backward.cu",
         "uni_encoder_tpu/training/train_step.py:340"),
        ("k4", "neighborhood_attention_2d", "uni_encoder_tpu_torch/kernels/csrc/neighborhood_attention.cu",
         "uni_encoder_tpu/ops/neighborhood_attention.py:48"),
        ("k5", "neighborhood_attention_2d_backward",
         "uni_encoder_tpu_torch/kernels/csrc/neighborhood_attention_backward.cu",
         "uni_encoder_tpu/training/train_step.py:340"),
    ):
        r = results[key]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[key],
                     "train_entry_launches": {config: n.get(key, 0) for config, n in train_entry_launches.items()},
                     "eval_launches": {task: n.get(key, 0) for task, n in eval_launches.items()},
                     "backbones_launches": {name: {kind: n[key] for kind, n in per.items()}
                                            for name, per in backbone_launches.items()},
                     "train_backbones_launches": {name: n[key] for name, n in train_backbone_launches.items()},
                     "train_decoders_launches": {name: n[key] for name, n in train_decoder_launches.items()},
                     "tools_launches": {name: n[key] for name, n in tools_launches.items()},
                     "demo_launches": {name: n[key] for name, n in demo_launches.items()},
                     "decoders_launches": {name: {kind: n[key] for kind, n in per.items()}
                                           for name, per in decoder_launches.items()},
                     "ade20k_eval_launches": {task: n[key] for task, n in ade20k_eval_launches.items()},
                     "multi_device_launches": {
                         "train_per_rank_per_step": [n[key] for n in multi_device_launches["train_per_rank_per_step"]],
                         "eval_per_rank": {role: n[key]
                                           for role, n in multi_device_launches["eval_per_rank"].items()}},
                     "spatial_launches": {role: n[key] for role, n in spatial_launches.items()},
                     "tensor_parallel_launches": {"per_rank_per_step": [
                         n[key] for n in tensor_parallel_launches["per_rank_per_step"]]},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     **{k: r[k] for k in ("function_ms", "stack_frame_bytes", "deterministic", "shape", "fp32_ms",
                                          "device_ms", "frame_ms", "frame_device_ms", "frame_plain_ms",
                                          "frame_bound_ms", "pair_ms", "pair_device_ms", "pair_plain_ms",
                                          "pair_bound_ms", "crop_ms", "crop_device_ms", "crop_plain_ms",
                                          "crop_bound_ms", "triples_ms", "triples_device_ms", "triples_plain_ms",
                                          "triples_bound_ms", "row_window_max_abs_err", "row_window_frame_ms",
                                          "row_window_frame_device_ms", "row_window_stage0_ms") if k in r}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] in (DETERMINISTIC_CHILD, CPU_STEP_CHILD, MULTI_DEVICE_CHILD,
                                              SPATIAL_CHILD, TP_CHILD):
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        {DETERMINISTIC_CHILD: train_deterministic_child, CPU_STEP_CHILD: cpu_step_child,
         MULTI_DEVICE_CHILD: multi_device_child, SPATIAL_CHILD: spatial_child,
         TP_CHILD: tensor_parallel_child}[sys.argv[1]](*sys.argv[2:])
    else:
        main()
