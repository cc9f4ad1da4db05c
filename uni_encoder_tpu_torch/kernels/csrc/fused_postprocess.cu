// Fused full-resolution multi-task post-process, written for Hopper (sm_90a).
//
// Replaces: uni_encoder_tpu/inference/fused_postprocess.py:_fused_kernel
// (the Pallas TPU kernel driven by fused_multitask_inference). One pass over
// the stride-4 mask logits (Q, h, w) bf16 computes, per output pixel of the
// (4h, 4w) image:
//   * the 4x bilinear upsample (align_corners=False, edge clamp) in the JAX
//     association order: y then x, a*w0 + b*w1, every product and sum rounded
//     to bf16; first-tap weights 0.375, 0.125, 0.875, 0.625 by phase;
//   * sig = sigmoid(logit) in fp32;
//   * the semantic argmax over K of sum_q clsprob[q, k] * sig[q];
//   * the panoptic winner argmax over Q of sig * ks[q] + off[q] (dropped
//     queries have ks = 0, off = -1); ties go to the lowest index;
//   * the winner id where the winner's logit >= 0, else the sentinel Q;
// and per query: winner area, (logit >= 0) area, final (winner and >= 0)
// area, (logit > 0) area, the sigmoid sum inside (logit > 0), and the
// inclusive xyxy box of (logit > 0).
//
// What bounds it on an H100: operations. At Q = 150, K = 19, 256x512 ->
// 1024x2048 it reads ~39 MB of logits and writes ~4 MB of maps (~13 us at
// 3.35 TB/s) but does ~(2K + 20) * Q * H * W ~ 18 GFLOP of fp32 CUDA-core work
// (~0.27 ms at 67 TFLOP/s), so it is compute-bound, not HBM-bound.
//
// Design. The TPU kernel's 16-phase grid, phase-separated output layout,
// 128-lane column padding and h % 8 requirement exist only for Mosaic and are
// gone. Each block owns a 32-column x 64-row tile of output pixels; a warp
// is one output row segment of 32 consecutive columns, so the four source
// texels a lane reads are shared by its neighbours and stay in L1. Each
// thread loops over q and keeps K fp32 class sums in registers. Per-query
// quantities are reduced across the warp with ballots and a fixed-order
// butterfly, then across the block in shared memory:
//   * integer areas and min/max boxes use integer atomics (order-free, so
//     deterministic);
//   * the float sigmoid sums go to one shared slot per warp, written only
//     by that warp's lane 0 in a fixed order, are summed over warps in a
//     fixed order into a per-block partial, and a second kernel sums the
//     partials over blocks in a fixed order. Reruns are byte-identical.
// Moving the semantic product onto tensor cores is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileW = 32;
constexpr int kTileH = 64;
constexpr unsigned kFull = 0xffffffffu;

// per-query integer slots in shared and global memory
enum { kWin = 0, kBin, kFinal, kStrict, kXmin, kYmin, kXmax, kYmax, kSlots };

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// source taps and first-tap weight for output coordinate r of a 4x upsample
// of an axis of length n (edge-clamped = edge-replicated padding)
__device__ __forceinline__ void taps(int r, int n, int& i0, int& i1, float& w0) {
  const int k = r >> 2, j = r & 3;
  const int base = k - 1 + (j >> 1);
  i0 = min(max(base, 0), n - 1);
  i1 = min(max(base + 1, 0), n - 1);
  w0 = 0.375f + (float)(j >> 1) * 0.5f - (float)(j & 1) * 0.25f;
}

__global__ void init_kernel(int* slots, int Q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q * kSlots) return;
  const int s = i / Q;
  slots[i] = (s == kXmin || s == kYmin) ? INT_MAX : (s == kXmax || s == kYmax) ? INT_MIN : 0;
}

template <int KC>
__global__ void __launch_bounds__(kThreads) fused_kernel(
    const __nv_bfloat16* __restrict__ masks,  // (Q, h, w)
    const float* __restrict__ clsprob,        // (Q, K)
    const float* __restrict__ ks,             // (Q,)
    const float* __restrict__ off,            // (Q,)
    int Q, int K, int h, int w,
    uint8_t* __restrict__ sem,                // (4h, 4w)
    uint8_t* __restrict__ ids,                // (4h, 4w)
    int* __restrict__ slots,                  // (kSlots, Q)
    float* __restrict__ sig_partial) {        // (n_blocks, Q)
  extern __shared__ float smem[];
  float* s_cls = smem;                         // Q * K
  float* s_ks = s_cls + Q * K;                 // Q
  float* s_off = s_ks + Q;                     // Q
  float* s_sig = s_off + Q;                    // kWarps * Q
  int* s_int = (int*)(s_sig + kWarps * Q);     // kSlots * Q

  for (int i = threadIdx.x; i < Q * K; i += kThreads) s_cls[i] = clsprob[i];
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    s_ks[i] = ks[i];
    s_off[i] = off[i];
  }
  for (int i = threadIdx.x; i < kWarps * Q; i += kThreads) s_sig[i] = 0.f;
  for (int i = threadIdx.x; i < kSlots * Q; i += kThreads) {
    const int s = i / Q;
    s_int[i] = (s == kXmin || s == kYmin) ? INT_MAX : (s == kXmax || s == kYmax) ? INT_MIN : 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int H = 4 * h, W = 4 * w;
  const int x_base = blockIdx.x * kTileW;
  const int X = x_base + lane;
  const bool col_ok = X < W;
  int xa, xb;
  float wx0;
  taps(min(X, W - 1), w, xa, xb, wx0);
  const float wx1 = 1.f - wx0;
  const int hw = h * w;

  for (int pass = 0; pass < kTileH / kWarps; ++pass) {
    const int Y = blockIdx.y * kTileH + pass * kWarps + warp;
    if (Y >= H) break;  // warp-uniform
    int ya, yb;
    float wy0;
    taps(Y, h, ya, yb, wy0);
    const float wy1 = 1.f - wy0;
    const int o00 = ya * w + xa, o01 = ya * w + xb, o10 = yb * w + xa, o11 = yb * w + xb;

    float sem_best = -INFINITY;
    int sem_arg = 0;
    float pan_best = -INFINITY;
    int pan_arg = 0;
    float pan_logit = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      const bool first = k0 == 0;
      float acc[KC];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) acc[kk] = 0.f;

      for (int q = 0; q < Q; ++q) {
        const __nv_bfloat16* mq = masks + (long long)q * hw;
        const float a00 = __bfloat162float(mq[o00]);
        const float a01 = __bfloat162float(mq[o01]);
        const float a10 = __bfloat162float(mq[o10]);
        const float a11 = __bfloat162float(mq[o11]);
        const float by0 = rbf(rbf(a00 * wy0) + rbf(a10 * wy1));
        const float by1 = rbf(rbf(a01 * wy0) + rbf(a11 * wy1));
        const float logit = rbf(rbf(by0 * wx0) + rbf(by1 * wx1));
        const float sg = 1.f / (1.f + expf(-logit));

        const float* cq = s_cls + q * K + k0;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
          if (k0 + kk < K) acc[kk] += cq[kk] * sg;

        if (first) {
          const float pr = sg * s_ks[q] + s_off[q];
          if (pr > pan_best) {
            pan_best = pr;
            pan_arg = q;
            pan_logit = logit;
          }
          const unsigned bin = __ballot_sync(kFull, col_ok && logit >= 0.f);
          const unsigned strict = __ballot_sync(kFull, col_ok && logit > 0.f);
          if (strict) {  // warp-uniform
            float v = (col_ok && logit > 0.f) ? sg : 0.f;
            v += __shfl_xor_sync(kFull, v, 16);
            v += __shfl_xor_sync(kFull, v, 8);
            v += __shfl_xor_sync(kFull, v, 4);
            v += __shfl_xor_sync(kFull, v, 2);
            v += __shfl_xor_sync(kFull, v, 1);
            if (lane == 0) {
              s_sig[warp * Q + q] += v;
              atomicAdd(&s_int[kStrict * Q + q], __popc(strict));
              atomicMin(&s_int[kXmin * Q + q], x_base + __ffs(strict) - 1);
              atomicMax(&s_int[kXmax * Q + q], x_base + 31 - __clz(strict));
              atomicMin(&s_int[kYmin * Q + q], Y);
              atomicMax(&s_int[kYmax * Q + q], Y);
            }
          }
          if (lane == 0 && bin) atomicAdd(&s_int[kBin * Q + q], __popc(bin));
        }
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (k0 + kk < K && acc[kk] > sem_best) {
          sem_best = acc[kk];
          sem_arg = k0 + kk;
        }
      }
    }

    if (col_ok) {
      const long long pix = (long long)Y * W + X;
      const bool winbin = pan_logit >= 0.f;
      atomicAdd(&s_int[kWin * Q + pan_arg], 1);
      if (winbin) atomicAdd(&s_int[kFinal * Q + pan_arg], 1);
      sem[pix] = (uint8_t)sem_arg;
      ids[pix] = (uint8_t)(winbin ? pan_arg : Q);
    }
  }
  __syncthreads();

  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += s_sig[wi * Q + q];
    sig_partial[blk * Q + q] = s;
    for (int slot = kWin; slot <= kStrict; ++slot) {
      const int v = s_int[slot * Q + q];
      if (v) atomicAdd(&slots[slot * Q + q], v);
    }
    if (s_int[kStrict * Q + q]) {
      atomicMin(&slots[kXmin * Q + q], s_int[kXmin * Q + q]);
      atomicMin(&slots[kYmin * Q + q], s_int[kYmin * Q + q]);
      atomicMax(&slots[kXmax * Q + q], s_int[kXmax * Q + q]);
      atomicMax(&slots[kYmax * Q + q], s_int[kYmax * Q + q]);
    }
  }
}

// fixed-order sum of the per-block partials: one thread per query
__global__ void sig_sum_kernel(const float* __restrict__ sig_partial, int n_blocks, int Q,
                               float* __restrict__ sig_sum) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += sig_partial[(long long)b * Q + q];
  sig_sum[q] = s;
}

template <int KC>
cudaError_t launch_main(dim3 grid, size_t smem, cudaStream_t s, const __nv_bfloat16* masks,
                        const float* clsprob, const float* ks, const float* off, int Q, int K,
                        int h, int w, uint8_t* sem, uint8_t* ids, int* slots, float* partial) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_kernel<KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fused_kernel<KC><<<grid, kThreads, smem, s>>>(masks, clsprob, ks, off, Q, K, h, w, sem, ids,
                                                slots, partial);
  return cudaGetLastError();
}

}  // namespace

// Scratch size the caller allocates for sig_partial, in floats.
extern "C" long long fused_postprocess_partial_size(int Q, int h, int w) {
  const long long gx = (4LL * w + kTileW - 1) / kTileW;
  const long long gy = (4LL * h + kTileH - 1) / kTileH;
  return gx * gy * Q;
}

extern "C" long long fused_postprocess_smem_bytes(int Q, int K) {
  return (long long)(Q * K + 2 * Q + kWarps * Q) * 4 + (long long)kSlots * Q * 4;
}

// slots: (kSlots, Q) int32 = win, bin, final, strict, xmin, ymin, xmax, ymax
extern "C" int fused_postprocess(const void* masks, const void* clsprob, const void* ks,
                                 const void* off, int Q, int K, int h, int w, void* sem,
                                 void* ids, void* slots, void* sig_partial, void* sig_sum,
                                 void* stream) {
  if (Q < 1 || K < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  init_kernel<<<(Q * kSlots + 255) / 256, 256, 0, s>>>((int*)slots, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid((4 * w + kTileW - 1) / kTileW, (4 * h + kTileH - 1) / kTileH);
  const size_t smem = (size_t)fused_postprocess_smem_bytes(Q, K);
  const __nv_bfloat16* m = (const __nv_bfloat16*)masks;
  const float* c = (const float*)clsprob;
  const float* k = (const float*)ks;
  const float* o = (const float*)off;
  uint8_t* sm = (uint8_t*)sem;
  uint8_t* id = (uint8_t*)ids;
  int* sl = (int*)slots;
  float* pp = (float*)sig_partial;
  if (K <= 8) e = launch_main<8>(grid, smem, s, m, c, k, o, Q, K, h, w, sm, id, sl, pp);
  else if (K <= 16) e = launch_main<16>(grid, smem, s, m, c, k, o, Q, K, h, w, sm, id, sl, pp);
  else if (K <= 24) e = launch_main<24>(grid, smem, s, m, c, k, o, Q, K, h, w, sm, id, sl, pp);
  else e = launch_main<32>(grid, smem, s, m, c, k, o, Q, K, h, w, sm, id, sl, pp);
  if (e != cudaSuccess) return (int)e;

  sig_sum_kernel<<<(Q + 127) / 128, 128, 0, s>>>(pp, (int)(grid.x * grid.y), Q, (float*)sig_sum);
  return (int)cudaGetLastError();
}
