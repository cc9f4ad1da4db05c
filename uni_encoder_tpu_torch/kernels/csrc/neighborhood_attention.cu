// Dilated neighborhood attention (forward), written for Hopper (sm_90a).
//
// Replaces: uni_encoder_tpu/ops/neighborhood_attention.py:neighborhood_attention_2d
// (an XLA program on the TPU that loops over the k * k window offsets and
// gathers a shifted copy of K and of V for each; the reference ran NATTEN's
// CUDA kernel). Per (batch, query pixel (i, j), head):
//   window    the k x k keys on the dilation-d sub-grid of (i mod d, j mod d),
//             clamped inside the map along each axis as `_axis_indices` does:
//             start = min(max(i / d - k / 2, 0), max(sub_len - k, 0)),
//             element a at sub-grid index min(start + a, sub_len - 1), so a
//             sub-grid shorter than k repeats its last key (and its bias);
//   logit     (q * scale, rounded to the input dtype) . key in fp32, plus
//             rpb[head, rel_h, rel_w], rel = sub-grid index - i / d + k - 1;
//   out       softmax over the k * k logits, times the values, summed in
//             fp32 and stored once in the input dtype.
//
//   q, k, v  (B, H, W, heads, dh) bf16 or fp32, element strides
//            (sb, sh, sw, sn) shared by the three, the last dim contiguous:
//            the three views of the qkv projection's (B, H, W, 3, heads, dh)
//            output, read in place
//   rpb      (heads, 2k - 1, 2k - 1) the same dtype, contiguous
//   out      (B, H, W, heads, dh) contiguous, the same dtype
//
// What bounds it on an H100: per query and head it does 2 * k * k * dh
// multiply-adds (6272 FLOP at k = 7, dh = 32) on 3 * dh inputs and dh
// outputs. At DiNAT-L's stage 0 on a 1024x2048 frame (256x512 queries, 6
// heads, bf16) one call reads ~151 MB of q, k, v and writes ~50 MB
// (~0.06 ms at 3.35 TB/s); its ~4.9 GFLOP take ~0.04 ms with the logits on
// bf16 tensor cores and the rest at 67 TFLOP/s fp32, so bytes bind. Each
// key and value row is read by the k * k queries whose windows hold it;
// those reads come from L1 and L2, not HBM.
//
// Design (the first, simple one). One thread owns one (b, i, j, head), the
// head fastest, so a warp reads neighbouring heads of neighbouring pixels:
// the heads of one pixel are one contiguous row of the qkv output, and the
// same window element of neighbouring pixels is a neighbouring pixel of the
// same residue class. The thread keeps q and the running sum of values, dh
// floats each, in registers, computes the window's indices from (i, j, k, d)
// in integer arithmetic (no tables), and walks the k * k keys once with an
// online softmax (running max and sum, the sum of values rescaled when the
// max grows). Rows are read as 16-byte vectors (the wrapper checks the
// alignment). dh is fixed at 32, every DiNAT-L stage's, so q and the sum
// stay in registers: no stack frame.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int DH = 32;  // the head dim

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// q * scale rounded to the input dtype, as the module computes it
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// the two bf16 values in one 32-bit word, low half first
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One row of DH elements as floats, into out[0, DH), in 16-byte vectors.
__device__ __forceinline__ void load_row(const float* __restrict__ p, float* out) {
#pragma unroll
  for (int c = 0; c < DH / 4; ++c) {
    const float4 x = reinterpret_cast<const float4*>(p)[c];
    out[4 * c] = x.x;
    out[4 * c + 1] = x.y;
    out[4 * c + 2] = x.z;
    out[4 * c + 3] = x.w;
  }
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float* out) {
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const uint4 x = reinterpret_cast<const uint4*>(p)[c];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      out[8 * c + 2 * u] = lo_bf16(w[u]);
      out[8 * c + 2 * u + 1] = hi_bf16(w[u]);
    }
  }
}

__device__ __forceinline__ void store_row(float* __restrict__ p, const float* acc, float inv) {
#pragma unroll
  for (int d = 0; d < DH; ++d) p[d] = acc[d] * inv;
}

__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ p, const float* acc, float inv) {
#pragma unroll
  for (int d = 0; d < DH; d += 2)
    reinterpret_cast<__nv_bfloat162*>(p)[d / 2] = __floats2bfloat162_rn(acc[d] * inv, acc[d + 1] * inv);
}

// The clamped window of query position i along one axis (`_axis_indices`).
struct Axis {
  int m;        // residue class i mod d
  int q;        // sub-grid index of the query, i / d
  int start;    // sub-grid index of the window's first element
  int sub_len;  // length of the residue class's sub-grid
};

__device__ __forceinline__ Axis axis_window(int i, int size, int kernel, int dilation) {
  Axis a;
  a.m = i % dilation;
  a.q = i / dilation;
  a.sub_len = (size - a.m + dilation - 1) / dilation;
  a.start = min(max(a.q - kernel / 2, 0), max(a.sub_len - kernel, 0));
  return a;
}

// sub-grid index of window element e: the last one repeats where the sub-grid is short
__device__ __forceinline__ int window_sub(const Axis& ax, int e) { return min(ax.start + e, ax.sub_len - 1); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    na2d_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ rpb, T* __restrict__ out, int H, int W, int NH, long long sb,
                long long sh, long long sw, long long sn, int kernel, int dilation, float scale,
                long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int n = (int)(t % NH);
  const long long pix = t / NH;
  const int j = (int)(pix % W);
  const int i = (int)((pix / W) % H);
  const long long b = pix / ((long long)W * H);

  const Axis ah = axis_window(i, H, kernel, dilation);
  const Axis aw = axis_window(j, W, kernel, dilation);
  const long long base = b * sb + n * sn;

  float qf[DH];
  load_row(q + base + i * sh + j * sw, qf);
#pragma unroll
  for (int d = 0; d < DH; ++d) qf[d] = round_to(qf[d] * scale, q);

  const int span = 2 * kernel - 1;
  const T* bias = rpb + (long long)n * span * span;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float mx = -INFINITY, sum = 0.f;
  float row[DH];

  for (int a = 0; a < kernel; ++a) {
    const int sub_h = window_sub(ah, a);
    const long long off_h = base + (long long)(sub_h * dilation + ah.m) * sh;
    const T* bias_row = bias + (sub_h - ah.q + kernel - 1) * span;
    for (int c = 0; c < kernel; ++c) {
      const int sub_w = window_sub(aw, c);
      const long long off = off_h + (long long)(sub_w * dilation + aw.m) * sw;
      load_row(k + off, row);
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s = fmaf(qf[d], row[d], s);
      s += to_f32(bias_row[sub_w - aw.q + kernel - 1]);
      if (s > mx) {  // a new running max: rescale what was summed
        const float f = expf(mx - s);
        sum *= f;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= f;
        mx = s;
      }
      const float p = expf(s - mx);
      sum += p;
      load_row(v + off, row);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, row[d], acc[d]);
    }
  }
  store_row(out + t * DH, acc, 1.f / sum);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* rpb, void* out, int B, int H, int W,
                   int NH, long long sb, long long sh, long long sw, long long sn, int kernel, int dilation,
                   float scale, cudaStream_t s) {
  const long long total = (long long)B * H * W * NH;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  na2d_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)rpb, (T*)out, H, W, NH, sb, sh, sw, sn, kernel, dilation,
      scale, total);
  return cudaGetLastError();
}

}  // namespace

// Neighborhood attention forward. The wrapper checks shapes, dtypes, the
// head dim (32), shared strides with a contiguous last dim and, for the
// vector reads, 16-byte alignment.
extern "C" int na2d_forward(const void* q, const void* k, const void* v, const void* rpb, void* out, int B,
                            int H, int W, int NH, int head_dim, long long sb, long long sh, long long sw,
                            long long sn, int kernel, int dilation, float scale, int is_bf16, void* stream) {
  if (kernel < 1 || dilation < 1 || head_dim != DH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, rpb, out, B, H, W, NH, sb, sh, sw, sn, kernel, dilation, scale, s)
              : launch<float>(q, k, v, rpb, out, B, H, W, NH, sb, sh, sw, sn, kernel, dilation, scale, s);
  return (int)e;
}
