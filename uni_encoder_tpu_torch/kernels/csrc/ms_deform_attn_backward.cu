// Backward of the fused multi-scale deformable-attention sampling
// (ms_deform_attn.cu), fp32, bitwise deterministic, written for Hopper
// (sm_90a).
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
//   grad_value (B, S, M, D)           fp32
//   grad_offsets, grad_logits         like offsets and logits
//   acc        (B, S, M, D)           int64 scratch, zeroed by the caller
//   max_bits   (1,)                   uint32 scratch, zeroed by the caller
//
// Determinism. grad_value is a scatter, and float atomics would sum it in
// an order that changes from run to run. Here it is summed exactly, in
// fixed point, so the order does not matter:
//   1. msda_grad_out_absmax_kernel takes max|grad_out| as the largest bit
//      pattern of |g| (atomicMax on the bits: for non-negative floats the
//      bit order is the value order, and inf and NaN sort above every
//      finite value). A max is order-independent.
//   2. msda_fused_backward_kernel converts each contribution a * w_c * g (an
//      fp32 product, itself deterministic) to an integer in units of 2^-e,
//      rounding to nearest even in fp64, and adds it with a 64-bit integer
//      atomicAdd (two's complement wraps, and integer addition is
//      associative). e = shift - floor(log2 max|g|), shift = 61 -
//      ceil(log2 Lq) (fixed_point_shift in ops/ms_deform_attn.py): a value
//      row gets at most one corner of each sample and the weights a of a
//      query's samples sum to 1, so |sum| <= Lq * max|g| < 2^62 in those
//      units. At the training shapes (Lq = 10752) one unit is at most
//      2^-47 max|g|, far below fp32's own rounding of the sums.
//   3. msda_grad_value_epilogue_kernel writes (float)(acc * 2^-e). If
//      max|g| is 0 every sum is 0; if it is inf or NaN, grad_value is all
//      NaN (no atomics are made), so a non-finite gradient never becomes
//      silent zeros.
// grad_offsets and grad_logits are per query: each is written once by its
// owning lane, in a fixed order.
//
// What bounds it on an H100. At the training shapes (B = 2, Lq = S = 10752,
// M = 8, D = 32, L = 3, P = 4) the bytes it must move are ~22 MB of values,
// ~22 MB of grad_out, ~16.5 MB of offsets and ~8.3 MB of logits read, and
// ~22 MB of grad_value, ~16.5 MB of grad_offsets and ~8.3 MB of grad_logits
// written: ~116 MB, ~35 us at 3.35 TB/s. The fixed-point scratch adds ~44 MB
// zeroed and read once and 22 MB of grad_out read again. The corner rows it
// gathers (~0.9 GB) and its 64-bit atomics (~228 M at chip_smoke.py's
// offsets, at most 264 M: ~1.8 GB) are L2 traffic: the value table (22 MB)
// and the accumulator (44 MB) are read and added to one head at a time
// (work is ordered query-fastest within a head, so the live window is
// ~1.4 MB of values and ~2.8 MB of accumulator), which stays in the 50 MB
// L2. The L2's gather and atomic rate, not HBM, sets the pace.
//
// Design of the main kernel: the forward kernel's decomposition. A
// half-warp owns one (b, q, m); its 16 lanes cover 32 channels, 2 each, so a
// corner row is one coalesced 128-byte read (lane j: channels 2j, 2j + 1).
// Its gradient is 32 64-bit atomics in two instructions, lane j adding
// channels j and j + 16, so each instruction covers 128 contiguous bytes:
// four whole L2 sectors, as many sector operations per row as fp32 atomics
// on channel pairs would take. Lane j < L * P owns sample j: it recomputes
// the softmax (xor butterflies over the 16 lanes), the location, the corner
// validity and the corner index, and hands them to the other lanes with
// __shfl_sync. For each sample every lane takes its channels' share of the
// four dot products <v_c, g>, folds them into its shares of da, dloc.x and
// dloc.y, and adds its fixed-point contributions. Three xor butterflies
// reduce the shares and the owning lane keeps the sums; the softmax backward
// is one more butterfly. L and P are compile-time constants, so the loops
// unroll and nothing spills to a stack frame. Merging the corner rows that
// samples share before the atomics would save 11.5% of them within one
// (b, q, head) and 59% within a block of 16 queries at chip_smoke.py's
// offsets (its k3_vs_plain `scatter` counts); the kernel does not merge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;  // lanes per (b, q, m)
constexpr int L = 3;        // levels
constexpr int P = 4;        // points per level
constexpr int LP = L * P;
static_assert(LP <= kGroup, "one lane per sample");
constexpr unsigned kNonFinite = 0x7f800000u;  // |x|'s bits from here up: inf or NaN
constexpr int kMaxBlocks = 132 * 8;            // grid-stride passes: 8 blocks per SM

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

// floor(log2 x) of a finite x > 0, from the bit pattern of |x|
__device__ __forceinline__ int floor_log2(unsigned bits) {
  const int biased = (int)(bits >> 23);
  return biased > 0 ? biased - 127 : (31 - __clz((int)bits)) - 149;  // normal : subnormal
}

// max|x| over x, as the largest bit pattern of |x|
__global__ void __launch_bounds__(kThreads) msda_grad_out_absmax_kernel(const float* __restrict__ x,
                                                                        long long n,
                                                                        unsigned* __restrict__ max_bits) {
  unsigned m = 0u;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += (long long)gridDim.x * kThreads)
    m = max(m, __float_as_uint(x[i]) & 0x7fffffffu);
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) atomicMax(max_bits, m);
}

__global__ void __launch_bounds__(kThreads) msda_fused_backward_kernel(
    const float* __restrict__ value, const float* __restrict__ offsets, const float* __restrict__ logits,
    const float* __restrict__ ref_abs, const float* __restrict__ grad_out,
    unsigned long long* __restrict__ acc, float* __restrict__ grad_offsets, float* __restrict__ grad_logits,
    const unsigned* __restrict__ max_bits, int shift, int Lq, int M, int D, int S, int units, Levels lv) {
  // work item v = ((b * M) + m) * Lq + q, as in the forward kernel
  const int v = (blockIdx.x * kThreads + threadIdx.x) / kGroup;
  if (v >= units) return;  // whole half-warps leave together
  const int j = threadIdx.x & (kGroup - 1);
  const unsigned mask = (threadIdx.x & 16) ? 0xffff0000u : 0x0000ffffu;
  const int q = v % Lq;
  const int m = (v / Lq) % M;
  const int b = v / (Lq * M);
  const int u = (b * Lq + q) * M + m;  // (b, q, m) in the row-major inputs and outputs

  // the fixed-point scale 2^e; nothing to add when every g is 0, and no
  // adds at all when one is inf or NaN (the epilogue writes NaN)
  const unsigned mb = *max_bits;
  const bool scatter = mb != 0u && mb < kNonFinite;
  const double scale = scatter ? ldexp(1.0, shift - floor_log2(mb)) : 0.0;

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
  unsigned long long* ab = acc + boff;
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
    const int corner_tok[4] = {bs, bs + 1, bs + Ws, bs + Ws + 1};
    const float corner_w[4] = {w00, w01, w10, w11};
    // this lane's shares of <v_c, g>; 0 for a corner outside the map
    float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
    for (int d0 = 0; d0 < D; d0 += 2 * kGroup) {
      const int d = d0 + 2 * j;
      if (d < D) {
        const float2 g = *reinterpret_cast<const float2*>(gb + d);
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cs & (1 << c)) {
            const float2 val = *reinterpret_cast<const float2*>(vb + (long long)corner_tok[c] * row + d);
            dot[c] = val.x * g.x + val.y * g.y;
          }
        }
        p00 += dot[0];
        p01 += dot[1];
        p10 += dot[2];
        p11 += dot[3];
      }
      // the adds take channels d0 + j and d0 + j + 16, so that each atomic
      // instruction of the half-warp covers 16 consecutive int64: 128 bytes,
      // four whole L2 sectors
      if (scatter) {
        const int da = d0 + j, db = da + kGroup;
        const float ga = da < D ? gb[da] : 0.f;
        const float gc = db < D ? gb[db] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cs & (1 << c)) {
            const float k = as * corner_w[c];
            unsigned long long* at = ab + (long long)corner_tok[c] * row;
            if (da < D) atomicAdd(at + da, (unsigned long long)__double2ll_rn((double)(k * ga) * scale));
            if (db < D) atomicAdd(at + db, (unsigned long long)__double2ll_rn((double)(k * gc) * scale));
          }
        }
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

// grad_value = acc * 2^-e, or NaN everywhere if max|g| is not finite; pairs
// of channels (D is even), so an int64 pair is one 16-byte load
__global__ void __launch_bounds__(kThreads) msda_grad_value_epilogue_kernel(const longlong2* __restrict__ acc,
                                                                            float2* __restrict__ grad_value,
                                                                            long long pairs,
                                                                            const unsigned* __restrict__ max_bits,
                                                                            int shift) {
  const unsigned mb = *max_bits;
  const bool finite = mb < kNonFinite;
  const double inv = (mb != 0u && finite) ? ldexp(1.0, floor_log2(mb) - shift) : 0.0;
  const float nan = __int_as_float(0x7fc00000);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < pairs;
       i += (long long)gridDim.x * kThreads) {
    const longlong2 s = acc[i];
    grad_value[i] = finite ? make_float2((float)((double)s.x * inv), (float)((double)s.y * inv))
                           : make_float2(nan, nan);
  }
}

unsigned grid_stride_blocks(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

}  // namespace

// Backward of the fused sampling: three launches on `stream` (max|grad_out|,
// the fixed-point scatter with grad_offsets and grad_logits, the grad_value
// epilogue). The wrapper checks shapes, fp32, 3 levels, 4 points, even D,
// that every element offset fits in 32 bits, zeroes acc and max_bits, and
// passes shift = fixed_point_shift(Lq).
extern "C" int msda_fused_backward(const void* value, const void* offsets, const void* logits,
                                   const void* ref_abs, const void* grad_out, void* grad_value,
                                   void* grad_offsets, void* grad_logits, void* acc, void* max_bits, int B,
                                   int S, int M, int D, int Lq, int n_levels, int n_points, const int* shapes_hw,
                                   int shift, void* stream) {
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
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_grad = units * D;
  msda_grad_out_absmax_kernel<<<grid_stride_blocks(n_grad), kThreads, 0, st>>>((const float*)grad_out, n_grad,
                                                                               (unsigned*)max_bits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((units * kGroup + kThreads - 1) / kThreads);
  msda_fused_backward_kernel<<<blocks, kThreads, 0, st>>>(
      (const float*)value, (const float*)offsets, (const float*)logits, (const float*)ref_abs,
      (const float*)grad_out, (unsigned long long*)acc, (float*)grad_offsets, (float*)grad_logits,
      (const unsigned*)max_bits, shift, Lq, M, D, S, (int)units, lv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)B * S * M * D / 2;
  msda_grad_value_epilogue_kernel<<<grid_stride_blocks(pairs), kThreads, 0, st>>>(
      (const longlong2*)acc, (float2*)grad_value, pairs, (const unsigned*)max_bits, shift);
  return (int)cudaGetLastError();
}
