// Multi-scale deformable-attention sampling (forward) with its softmax and
// location math fused in, written for Hopper (sm_90a).
//
// Replaces: uni_encoder_tpu/ops/ms_deform_attn.py:ms_deform_attn (an XLA
// gather program on the TPU; the reference shipped a CUDA op) together with
// the producer half of uni_encoder_tpu/models/pixel_decoders/msdeformattn.py:
// MSDeformAttnModule (softmax over the L * P logits of each head, and the
// absolute location ref_abs + offset). Per (batch, query, head):
//   w[l, p]   = softmax over the L * P logits, taken in fp32 and rounded to
//               the logits' dtype (torch.softmax on a bf16 tensor returns
//               bf16), then used in fp32;
//   (fx, fy)  = ref_abs[l, q] + float(offset[l, p]), in fp32 (exact);
//   out[m, :] = sum over (l, p, corner) of w * bilinear weight * value[corner]
// with zero padding outside each level's map, fp32 accumulation in a fixed
// (level, point, corner) order and one rounding to the value dtype.
//
//   value    (B, S, M, D)          bf16 or fp32, S = sum_l H_l * W_l
//   offsets  (B, Lq, M * L * P * 2) same dtype, the sampling_offsets Linear
//   logits   (B, Lq, M * L * P)     same dtype, the attention_weights Linear
//   ref_abs  (L, Lq, 2)             fp32, ref * (W_l, H_l) - 0.5
//   out      (B, Lq, M * D)         same dtype
//
// What bounds it on an H100: memory. At the production shapes (Lq = S =
// 43008, M = 8, D = 32, L = 3, P = 4, bf16) one call reads ~22 MB of values,
// ~16.5 MB of offsets, ~8.3 MB of logits and ~1 MB of ref_abs and writes
// ~22 MB: ~70 MB, ~21 us at 3.35 TB/s. Its ~1.06 GB of corner-row reads hit
// the value table, which fits in the 50 MB L2: at ~0.23 ms a call moves
// them at ~4.6 TB/s out of L2, which, not HBM, now sets its pace.
//
// Design. A half-warp owns one (b, q, m); neighbouring half-warps take
// neighbouring queries of one head. The 16 lanes cover 32 channels, 2 each
// (__nv_bfloat162 or float2), so one corner read is a coalesced 64-byte
// bf16 row (128 bytes in fp32); D > 32 loops over 32-channel slices.
// The head's 24 offsets, 12 logits and 3 ref_abs pairs are read once,
// coalesced: lane j < L * P reads sample j's pair, logit and level origin,
// takes the softmax (max and sum by an xor butterfly over the 16 lanes, the
// order torch's warp softmax uses for 12 elements), the location, the four
// zero-padded bilinear corner weights times the attention weight and the
// corner token index, and hands them to the other lanes with __shfl_sync.
// L and P are compile-time constants, so every loop over them is unrolled and
// the level table is indexed statically: no stack frame. Offsets are 32-bit
// (the wrapper checks the sizes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;  // lanes per (b, q, m)
constexpr int L = 3;        // levels
constexpr int P = 4;        // points per level
constexpr int LP = L * P;
static_assert(LP <= kGroup, "one lane per sample");

struct Levels {
  int h[L];
  int w[L];
  int start[L];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// the softmax's rounding to the logits' dtype
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) msda_fused_kernel(
    const T* __restrict__ value, const T* __restrict__ offsets, const T* __restrict__ logits,
    const float* __restrict__ ref_abs, T* __restrict__ out, int Lq, int M, int D, int S,
    int units, Levels lv) {
  // work item v = ((b * M) + m) * Lq + q: neighbouring half-warps take
  // neighbouring queries of one head, whose samples share corner rows in L1
  const int v = (blockIdx.x * kThreads + threadIdx.x) / kGroup;
  if (v >= units) return;  // whole half-warps leave together
  const int j = threadIdx.x & (kGroup - 1);
  const unsigned mask = (threadIdx.x & 16) ? 0xffff0000u : 0x0000ffffu;
  const int q = v % Lq;
  const int m = (v / Lq) % M;
  const int b = v / (Lq * M);
  const int u = (b * Lq + q) * M + m;  // (b, q, m) in the row-major inputs and output

  // ---- lane j < LP: sample j = (l, p)
  const bool own = j < LP;
  const int jl = j / P;  // this lane's level
  float logit = -INFINITY;
  float2 o = make_float2(0.f, 0.f);
  float2 ref = make_float2(0.f, 0.f);
  if (own) {
    logit = to_f32(logits[(long long)u * LP + j]);
    o = load2(offsets + ((long long)u * LP + j) * 2);
    ref = *reinterpret_cast<const float2*>(ref_abs + ((long long)jl * Lq + q) * 2);
  }
  // softmax over the LP logits: -inf pads the idle lanes, as torch pads its
  // warp softmax; xor butterflies give every lane the same max and sum
  float mx = logit;
#pragma unroll
  for (int s = kGroup / 2; s > 0; s >>= 1) mx = fmaxf(mx, __shfl_xor_sync(mask, mx, s, kGroup));
  const float e = own ? expf(logit - mx) : 0.f;
  float sum = e;
#pragma unroll
  for (int s = kGroup / 2; s > 0; s >>= 1) sum += __shfl_xor_sync(mask, sum, s, kGroup);
  const float a = round_to(e / sum, logits);

  // location and corners; the level's shape by a static select
  int H = 0, W = 0, start = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (jl == l) {
      H = lv.h[l];
      W = lv.w[l];
      start = lv.start[l];
    }
  }
  const float fx = ref.x + o.x;
  const float fy = ref.y + o.y;
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
  int base = 0;  // token index of corner (y0, x0) in the batch's value rows
  // a 2x2 patch entirely outside the map contributes nothing (also keeps
  // the float -> int conversions in range; NaN fails the test too)
  if (own && x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f && y0f <= (float)(H - 1)) {
    const float wx = fx - x0f, wy = fy - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const bool xin0 = x0 >= 0, xin1 = x0 + 1 <= W - 1;
    const bool yin0 = y0 >= 0, yin1 = y0 + 1 <= H - 1;
    c00 = (yin0 && xin0) ? (1.f - wx) * (1.f - wy) * a : 0.f;
    c01 = (yin0 && xin1) ? wx * (1.f - wy) * a : 0.f;
    c10 = (yin1 && xin0) ? (1.f - wx) * wy * a : 0.f;
    c11 = (yin1 && xin1) ? wx * wy * a : 0.f;
    base = start + y0 * W + x0;
  }

  // ---- every lane: 2 channels of each 32-channel slice
  const int row = M * D;  // elements per token
  const T* vb = value + (long long)b * S * row + m * D;
  T* ob = out + (long long)u * D;
  for (int d0 = 0; d0 < D; d0 += 2 * kGroup) {
    const int d = d0 + 2 * j;
    const bool on = d < D;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int s = 0; s < LP; ++s) {
      const int Ws = lv.w[s / P];
      const int bs = __shfl_sync(mask, base, s, kGroup);
      const float w00 = __shfl_sync(mask, c00, s, kGroup);
      const float w01 = __shfl_sync(mask, c01, s, kGroup);
      const float w10 = __shfl_sync(mask, c10, s, kGroup);
      const float w11 = __shfl_sync(mask, c11, s, kGroup);
      if (on) {
        const T* r = vb + d;
        if (w00 != 0.f) {
          const float2 v = load2(r + bs * row);
          acc0 += v.x * w00;
          acc1 += v.y * w00;
        }
        if (w01 != 0.f) {
          const float2 v = load2(r + (bs + 1) * row);
          acc0 += v.x * w01;
          acc1 += v.y * w01;
        }
        if (w10 != 0.f) {
          const float2 v = load2(r + (bs + Ws) * row);
          acc0 += v.x * w10;
          acc1 += v.y * w10;
        }
        if (w11 != 0.f) {
          const float2 v = load2(r + (bs + Ws + 1) * row);
          acc0 += v.x * w11;
          acc1 += v.y * w11;
        }
      }
    }
    if (on) store2(ob + d, acc0, acc1);
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* offsets, const void* logits, const float* ref_abs,
                   void* out, int Lq, int M, int D, int S, int units, const Levels& lv, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((long long)units * kGroup + kThreads - 1) / kThreads);
  msda_fused_kernel<T><<<blocks, kThreads, 0, s>>>(
      (const T*)value, (const T*)offsets, (const T*)logits, ref_abs, (T*)out, Lq, M, D, S, units, lv);
  return cudaGetLastError();
}

}  // namespace

// Fused sampling. The wrapper checks shapes, dtypes, 3 levels, 4 points,
// even D and that every element offset fits in 32 bits.
extern "C" int msda_fused_forward(const void* value, const void* offsets, const void* logits,
                                  const void* ref_abs, void* out, int B, int S, int M, int D,
                                  int Lq, int n_levels, int n_points, const int* shapes_hw,
                                  int is_bf16, void* stream) {
  if (n_levels != L || n_points != P || D % 2 != 0) return (int)cudaErrorInvalidValue;
  Levels lv;
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes_hw[2 * l];
    lv.w[l] = shapes_hw[2 * l + 1];
    lv.start[l] = (int)start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  if (start != (long long)S) return (int)cudaErrorInvalidValue;
  const long long units = (long long)B * Lq * M;
  if (units == 0) return 0;
  if (units * kGroup > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)ref_abs;
  cudaError_t e = is_bf16
      ? launch<__nv_bfloat16>(value, offsets, logits, r, out, Lq, M, D, S, (int)units, lv, s)
      : launch<float>(value, offsets, logits, r, out, Lq, M, D, S, (int)units, lv, s);
  return (int)e;
}
