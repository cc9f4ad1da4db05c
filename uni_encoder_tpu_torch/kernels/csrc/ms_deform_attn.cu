// Multi-scale deformable-attention sampling (forward), written for Hopper
// (sm_90a).
//
// Replaces: uni_encoder_tpu/ops/ms_deform_attn.py:ms_deform_attn (an XLA
// gather program on the TPU; the reference shipped a CUDA op). Semantics are
// those of ms_deform_attn_corners in the same file: per (batch, query, head,
// level, point), bilinearly sample the level's value map at an ABSOLUTE
// source coordinate (fx, fy) = (loc_x * W - 0.5, loc_y * H - 0.5), with zero
// padding outside the map, weight by the attention weight, and sum in fp32.
// The output is written once, rounded to the value dtype.
//
//   value   (B, S, M, D)       bf16 or fp32, S = sum_l H_l * W_l
//   loc     (B, Lq, M, L, P, 2) fp32, absolute (fx, fy)
//   weight  (B, Lq, M, L, P)    fp32, already softmax-normalised
//   out     (B, Lq, M * D)      value dtype
//
// What bounds it on an H100: memory. At the production shapes (Lq = S =
// 43008, M = 8, D = 32, L = 3, P = 4) one call reads ~22 MB of bf16 values,
// ~33 MB of locations and ~16.5 MB of weights and writes ~22 MB, while it does
// only ~0.1 GFLOP. The ~1.06 GB of corner reads hit the value table, which
// fits in the 50 MB L2, so device-memory traffic is the inputs read once.
//
// Design: one thread per (b, q, m, d); for D = 32 one warp is one (b, q, m)
// with lanes over D, so every corner read is one coalesced 64-byte bf16 row
// and the location/weight reads are warp-wide broadcasts. Any D works: for
// D < 32 a warp spans several heads. Accumulation is in fp32 in a fixed
// (level, point, corner) order, so results are deterministic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) msda_forward_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ weight, T* __restrict__ out,
    int Lq, int M, int D, int L, int P, long long S, long long total, Levels lv) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = (int)(idx % D);
  const long long bqm = idx / D;  // ((b * Lq) + q) * M + m
  const int m = (int)(bqm % M);
  const long long b = bqm / ((long long)Lq * M);

  const long long row = (long long)M * D;  // stride of one token in value
  const T* vb = value + b * S * row + (long long)m * D + d;
  const float* lp = loc + bqm * L * P * 2;
  const float* wp = weight + bqm * L * P;

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const T* vl = vb + lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const float fx = lp[(l * P + p) * 2];
      const float fy = lp[(l * P + p) * 2 + 1];
      const float a = wp[l * P + p];
      const float x0f = floorf(fx);
      const float y0f = floorf(fy);
      // a 2x2 patch entirely outside the map contributes nothing (also
      // keeps the float -> int conversions below in range)
      if (!(x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f && y0f <= (float)(H - 1))) continue;
      const float wx = fx - x0f;
      const float wy = fy - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const bool xin0 = x0 >= 0, xin1 = x0 + 1 <= W - 1;
      const bool yin0 = y0 >= 0, yin1 = y0 + 1 <= H - 1;
      if (yin0) {
        const T* r = vl + (long long)y0 * W * row;
        if (xin0) acc += to_f32(r[(long long)x0 * row]) * ((1.f - wx) * (1.f - wy) * a);
        if (xin1) acc += to_f32(r[(long long)(x0 + 1) * row]) * (wx * (1.f - wy) * a);
      }
      if (yin1) {
        const T* r = vl + (long long)(y0 + 1) * W * row;
        if (xin0) acc += to_f32(r[(long long)x0 * row]) * ((1.f - wx) * wy * a);
        if (xin1) acc += to_f32(r[(long long)(x0 + 1) * row]) * (wx * wy * a);
      }
    }
  }
  // out[b, q, m * D + d] has the same flat index as (b, q, m, d)
  store(out + idx, acc);
}

}  // namespace

extern "C" int msda_forward(const void* value, const void* loc, const void* weight, void* out,
                            int B, int S, int M, int D, int Lq, int L, int P,
                            const int* shapes_hw, int value_is_bf16, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes_hw[2 * l];
    lv.w[l] = shapes_hw[2 * l + 1];
    lv.start[l] = start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  if (start != (long long)S) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * Lq * M * D;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (value_is_bf16) {
    msda_forward_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc, (const float*)weight,
        (__nv_bfloat16*)out, Lq, M, D, L, P, (long long)S, total, lv);
  } else {
    msda_forward_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)weight,
        (float*)out, Lq, M, D, L, P, (long long)S, total, lv);
  }
  return (int)cudaGetLastError();
}
