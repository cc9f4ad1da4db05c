// Backward of the fused multi-scale deformable-attention sampling
// (ms_deform_attn.cu), fp32, written for Hopper (sm_90a).
//
// Replaces: the XLA autodiff of uni_encoder_tpu/ops/ms_deform_attn.py:
// ms_deform_attn and of the producer half of
// uni_encoder_tpu/models/pixel_decoders/msdeformattn.py:MSDeformAttnModule
// (jax.grad in uni_encoder_tpu/training/train_step.py). Per (batch, query,
// head) it recomputes what the forward kernel computes (the softmax over the
// L * P logits and the locations ref_abs + offset), then for each sample
// (l, p) with attention weight a, bilinear corner weights w_c (zero for a
// corner outside the map) and g = grad_out[b, q, m, :]:
//   grad_value[b, corner, m, :] += a * w_c * g                (scatter)
//   da   = sum_c w_c <v_c, g>
//   dloc = a * sum_c (d w_c / d loc) <v_c, g>                  (= d offset)
//   dz   = a * (da - sum_s a_s da_s)                           (softmax)
// ref_abs gets no gradient: it is a constant of the shapes.
//
//   value      (B, S, M, D)          fp32, S = sum_l H_l * W_l
//   offsets    (B, Lq, M * L * P * 2) fp32
//   logits     (B, Lq, M * L * P)     fp32
//   ref_abs    (L, Lq, 2)             fp32
//   grad_out   (B, Lq, M * D)         fp32
//   grad_value (B, S, M, D)           fp32, zeroed by the caller
//   grad_offsets, grad_logits         like offsets and logits
//
// What bounds it on an H100. At the training shapes (B = 2, Lq = S = 10752,
// M = 8, D = 32, L = 3, P = 4) the bytes it must move are ~22 MB of values,
// ~22 MB of grad_out, ~16.5 MB of offsets and ~8.3 MB of logits read, and
// ~22 MB of grad_value, ~16.5 MB of grad_offsets and ~8.3 MB of grad_logits
// written: ~116 MB, ~35 us at 3.35 TB/s (the caller's zeroing of grad_value
// adds 22 MB). The corner rows it gathers and the atomics it scatters are
// ~1 GB each of L2 traffic (B * Lq * M * L * P * 4 corners * D * 4 bytes):
// the value table and its gradient (22 MB each) fit in the 50 MB L2
// together, and the L2's gather and atomic rate, not HBM, sets the pace.
//
// Design: the forward kernel's decomposition. A half-warp owns one
// (b, q, m); its 16 lanes cover 32 channels, 2 each, so a corner row is one
// coalesced 128-byte read and its gradient 32 coalesced atomics. Lane
// j < L * P owns sample j: it recomputes the softmax (xor butterflies over
// the 16 lanes), the location, the corner validity and the corner index, and
// hands them to the other lanes with __shfl_sync. For each sample every lane
// takes its channels' share of the four dot products <v_c, g>, folds them
// into its shares of da, dloc.x and dloc.y, and adds a * w_c * g into
// grad_value with fp32 atomicAdd (so grad_value sums in a run-dependent
// order: not bitwise deterministic). Three xor butterflies reduce the shares
// and the owning lane keeps the sums; the softmax backward is one more
// butterfly. grad_offsets and grad_logits are per query: each is written
// once by its owning lane, without atomics. L and P are compile-time
// constants, so the loops unroll and nothing spills to a stack frame.

#include <cuda_runtime.h>
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

__device__ __forceinline__ float half_warp_sum(float x, unsigned mask) {
#pragma unroll
  for (int s = kGroup / 2; s > 0; s >>= 1) x += __shfl_xor_sync(mask, x, s, kGroup);
  return x;
}

__global__ void __launch_bounds__(kThreads) msda_fused_backward_kernel(
    const float* __restrict__ value, const float* __restrict__ offsets, const float* __restrict__ logits,
    const float* __restrict__ ref_abs, const float* __restrict__ grad_out, float* __restrict__ grad_value,
    float* __restrict__ grad_offsets, float* __restrict__ grad_logits, int Lq, int M, int D, int S, int units,
    Levels lv) {
  // work item v = ((b * M) + m) * Lq + q, as in the forward kernel
  const int v = (blockIdx.x * kThreads + threadIdx.x) / kGroup;
  if (v >= units) return;  // whole half-warps leave together
  const int j = threadIdx.x & (kGroup - 1);
  const unsigned mask = (threadIdx.x & 16) ? 0xffff0000u : 0x0000ffffu;
  const int q = v % Lq;
  const int m = (v / Lq) % M;
  const int b = v / (Lq * M);
  const int u = (b * Lq + q) * M + m;  // (b, q, m) in the row-major inputs and outputs

  // ---- lane j < LP: sample j = (l, p), recomputed as the forward does
  const bool own = j < LP;
  const int jl = j / P;
  float logit = -INFINITY;
  float2 o = make_float2(0.f, 0.f);
  float2 ref = make_float2(0.f, 0.f);
  if (own) {
    logit = logits[(long long)u * LP + j];
    o = *reinterpret_cast<const float2*>(offsets + ((long long)u * LP + j) * 2);
    ref = *reinterpret_cast<const float2*>(ref_abs + ((long long)jl * Lq + q) * 2);
  }
  float mx = logit;
#pragma unroll
  for (int s = kGroup / 2; s > 0; s >>= 1) mx = fmaxf(mx, __shfl_xor_sync(mask, mx, s, kGroup));
  const float e = own ? expf(logit - mx) : 0.f;
  const float a = e / half_warp_sum(e, mask);

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
  float wx = 0.f, wy = 0.f;
  int base = 0;       // token index of corner (y0, x0) in the batch's value rows
  int corners = 0;    // validity bits: 1 = (y0, x0), 2 = (y0, x0+1), 4 = (y0+1, x0), 8 = (y0+1, x0+1)
  if (own && x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f && y0f <= (float)(H - 1)) {
    wx = fx - x0f;
    wy = fy - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const bool xin0 = x0 >= 0, xin1 = x0 + 1 <= W - 1;
    const bool yin0 = y0 >= 0, yin1 = y0 + 1 <= H - 1;
    corners = (yin0 && xin0) | ((yin0 && xin1) << 1) | ((yin1 && xin0) << 2) | ((yin1 && xin1) << 3);
    base = start + y0 * W + x0;
  }

  // ---- every lane: 2 channels of each 32-channel slice
  const int row = M * D;  // elements per token
  const long long boff = (long long)b * S * row + m * D;
  const float* vb = value + boff;
  float* gvb = grad_value + boff;
  const float* gb = grad_out + (long long)u * D;
  float my_da = 0.f, my_dx = 0.f, my_dy = 0.f;
#pragma unroll
  for (int s = 0; s < LP; ++s) {
    const int cs = __shfl_sync(mask, corners, s, kGroup);
    if (cs == 0) continue;  // the same for the whole half-warp
    const int Ws = lv.w[s / P];
    const int bs = __shfl_sync(mask, base, s, kGroup);
    const float ax = __shfl_sync(mask, wx, s, kGroup);
    const float ay = __shfl_sync(mask, wy, s, kGroup);
    const float as = __shfl_sync(mask, a, s, kGroup);
    const float w00 = (cs & 1) ? (1.f - ax) * (1.f - ay) : 0.f;
    const float w01 = (cs & 2) ? ax * (1.f - ay) : 0.f;
    const float w10 = (cs & 4) ? (1.f - ax) * ay : 0.f;
    const float w11 = (cs & 8) ? ax * ay : 0.f;
    // this lane's shares of <v_c, g>; 0 for a corner outside the map
    float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
    for (int d0 = 0; d0 < D; d0 += 2 * kGroup) {
      const int d = d0 + 2 * j;
      if (d < D) {
        const float2 g = *reinterpret_cast<const float2*>(gb + d);
        const int corner_tok[4] = {bs, bs + 1, bs + Ws, bs + Ws + 1};
        const float corner_w[4] = {w00, w01, w10, w11};
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cs & (1 << c)) {
            const long long at = (long long)corner_tok[c] * row + d;
            const float2 val = *reinterpret_cast<const float2*>(vb + at);
            dot[c] = val.x * g.x + val.y * g.y;
            const float k = as * corner_w[c];
            atomicAdd(gvb + at, k * g.x);
            atomicAdd(gvb + at + 1, k * g.y);
          }
        }
        p00 += dot[0];
        p01 += dot[1];
        p10 += dot[2];
        p11 += dot[3];
      }
    }
    const float pa = half_warp_sum(w00 * p00 + w01 * p01 + w10 * p10 + w11 * p11, mask);
    const float px = half_warp_sum((1.f - ay) * (p01 - p00) + ay * (p11 - p10), mask);
    const float py = half_warp_sum((1.f - ax) * (p10 - p00) + ax * (p11 - p01), mask);
    if (j == s) {
      my_da = pa;
      my_dx = as * px;
      my_dy = as * py;
    }
  }

  // ---- softmax backward over the LP weights of this head
  const float adot = half_warp_sum(own ? a * my_da : 0.f, mask);
  if (own) {
    grad_logits[(long long)u * LP + j] = a * (my_da - adot);
    *reinterpret_cast<float2*>(grad_offsets + ((long long)u * LP + j) * 2) = make_float2(my_dx, my_dy);
  }
}

}  // namespace

// Backward of the fused sampling. The wrapper checks shapes, fp32, 3 levels,
// 4 points, even D, that every element offset fits in 32 bits, and zeroes
// grad_value.
extern "C" int msda_fused_backward(const void* value, const void* offsets, const void* logits,
                                   const void* ref_abs, const void* grad_out, void* grad_value,
                                   void* grad_offsets, void* grad_logits, int B, int S, int M, int D, int Lq,
                                   int n_levels, int n_points, const int* shapes_hw, void* stream) {
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
  const unsigned blocks = (unsigned)((units * kGroup + kThreads - 1) / kThreads);
  msda_fused_backward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)value, (const float*)offsets, (const float*)logits, (const float*)ref_abs,
      (const float*)grad_out, (float*)grad_value, (float*)grad_offsets, (float*)grad_logits, Lq, M, D, S,
      (int)units, lv);
  return (int)cudaGetLastError();
}
