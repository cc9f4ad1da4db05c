// Dilated neighborhood attention, backward (K5), written for Hopper (sm_90a).
//
// Replaces: jax.grad of uni_encoder_tpu/ops/neighborhood_attention.py:
// neighborhood_attention_2d inside the JAX trainer's step
// (uni_encoder_tpu/training/train_step.py:340): the XLA transpose of its
// gathers, a scatter-add of 49 shifted copies of dK and dV per layer. Here,
// for the forward K4 computes (neighborhood_attention.cu: each query's k x k
// window on its residue class's sub-grid, clamped inside the map, repeating a
// short sub-grid's last key; q scaled by `scale` first; the bias rpb[head,
// rel_h, rel_w] of the clamped sub-grid offset):
//   P       the softmax over the window's k * k entries, recomputed from q, k
//           and rpb (K4 stores no log-sum-exp: the forward stays as it is)
//   D       rowsum(dO * O), per query and head
//   dS      P * (dO . v - D) per entry; a key that a window lists c times
//           (c = count_h * count_w, > 1 only for a short sub-grid's last key)
//           is stored once and its dS counted c times, as the plain version's
//           repeated entries are
//   dq      scale * sum dS k   (q is scaled inside)
//   dk, dv  sum over the queries whose windows hold the key of dS q_scaled
//           and c P dO
//   drpb    sum of dS over every query of a head, per (rel_h, rel_w)
// all in fp32 (training runs fp32 with TF32 off).
//
//   qkv       (B, H, W, 3, heads, 32) fp32 contiguous: the qkv projection's
//             output, q, k and v the three slots
//   rpb       (heads, 2k - 1, 2k - 1) fp32 contiguous
//   out, dout (B, H, W, heads, 32) fp32 contiguous: K4's output, its gradient
//   dqkv      (B, H, W, 3, heads, 32): dq, dk, dv in the qkv layout, so that
//             the projection gets its gradient without a cat
//   drpb      (heads, 2k - 1, 2k - 1)
//   scratch   lse and D (B, H, W, heads); per query block a (2k - 1)^2 table
//             of its drpb sums
//
// What bounds it on an H100: at DiNAT-L's stage 0 of a 512x1024 crop (B = 2,
// 128x256, 6 heads, dh 32) one call must read q, k, v, dO and O and write dq,
// dk and dv, ~403 MB: 0.12 ms at 3.35 TB/s; its ~6.4 GFLOP take 0.095 ms at
// fp32's 67 TFLOP/s. So bytes bind, by a little.
//
// Design: three kernels, no atomics, every sum in a fixed order, so reruns
// give the same bytes (the trainer's deterministic mode holds it).
//   (a) query tiles: K4's blocks (one (b, head, residue class, 8 x 8 tile of
//       sub-grid queries)) and its halo (the keys of every window of the tile,
//       each once; K and V in shared memory by cp.async), two threads per
//       query, each owning 16 of its 32 dims. Pass 1 walks the window for the
//       running max and the count-weighted sum (lse); pass 2 recomputes each
//       logit, forms dS, adds dS k to dq and keeps dS in shared memory. The
//       block then sums its dS per bias cell over its queries in order and
//       writes that table: its drpb partial. lse and D go to scratch.
//   (b) key tiles: the same blocks over keys. The queries whose windows hold
//       a key are one range per axis (a window's start never decreases):
//       [s - k + 1 + k/2, s + k/2] inside, widened to the map's edge where
//       the window is clamped, the whole sub-grid where it is shorter than k
//       (`_inverse_range` in ops/neighborhood_attention.py mirrors it). The
//       tile's inverse halo of queries (q scaled, dO, lse, D) goes to shared
//       memory; two threads per key walk its range, recompute each logit
//       exactly as (a) did and gather dk and dv. No scatter, no atomics.
//   (c) drpb: per head and bias cell, the partials of (a)'s blocks summed in
//       block order by 8 warps, then across the warps in order.
// The logits are recomputed twice (in (a) and in (b)); the copies through L2
// and shared memory weigh as much as the arithmetic, as in K4's fp32 path.
// Tensor cores, TMA and a fused (a)-(b) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 32;             // the head dim
constexpr int HALF = DH / 2;       // the dims a thread owns
constexpr int TQ = 8;              // a tile is TQ x TQ queries (or keys) of one residue class's sub-grid
constexpr int kThreads = 2 * TQ * TQ;  // two threads a query (or key)
constexpr int ROW = DH * 4 + 16;   // bytes of a row in shared memory (fp32, padded by 16)
constexpr int CPR = DH * 4 / 16;   // 16-byte copies per row
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may have on sm_90
constexpr int kRpbWarps = 8;       // (c): warps a block, each summing every 8th partial

// ------------------------------------------------------------- geometry
// The window and tile arithmetic of neighborhood_attention.cu (K4), the same
// expressions: mirrored in Python by `_window_start` and `_tile_halo`.
__host__ __device__ __forceinline__ int window_start(int q, int sub_len, int kernel) {
  return min(max(q - kernel / 2, 0), max(sub_len - kernel, 0));
}

// The queries whose windows hold sub-grid key s: [inverse_lo, inverse_hi]
// (`_inverse_range`).
__host__ __device__ __forceinline__ int inverse_lo(int s, int sub_len, int kernel) {
  if (sub_len <= kernel || s - kernel + 1 <= 0) return 0;
  return s - kernel + 1 + kernel / 2;
}

__host__ __device__ __forceinline__ int inverse_hi(int s, int sub_len, int kernel) {
  if (sub_len <= kernel || s >= sub_len - kernel) return sub_len - 1;
  return min(s + kernel / 2, sub_len - 1);
}

// One tile along one axis. For query tiles (a), h0 .. h0 + n - 1 are the halo
// keys; for key tiles (b), the inverse halo's queries.
struct AxisTile {
  int m;        // residue class
  int sub_len;  // length of its sub-grid
  int q0;       // sub-grid index of the tile's first query (or key)
  int nq;       // the tile's queries (or keys) on this axis (< 1: none, the block exits)
  int len;      // window length, min(kernel, sub_len)
  int h0;       // sub-grid index of the halo's first entry
  int n;        // halo length
  int rep;      // sub-grid index of the key each window repeats, -1 if none
  int cnt;      // how often each window holds it
};

__device__ __forceinline__ AxisTile axis_tile(int size, int kernel, int dilation, int m, int tile, bool keys) {
  AxisTile a;
  a.m = m;
  a.sub_len = (size - m + dilation - 1) / dilation;
  a.q0 = tile * TQ;
  a.nq = min(TQ, a.sub_len - a.q0);
  a.len = min(kernel, a.sub_len);
  if (keys) {
    a.h0 = inverse_lo(a.q0, a.sub_len, kernel);
    a.n = inverse_hi(a.q0 + a.nq - 1, a.sub_len, kernel) + 1 - a.h0;
  } else {
    a.h0 = window_start(a.q0, a.sub_len, kernel);
    a.n = window_start(a.q0 + a.nq - 1, a.sub_len, kernel) + a.len - a.h0;
  }
  a.rep = a.sub_len < kernel ? a.sub_len - 1 : -1;
  a.cnt = kernel - a.sub_len + 1;
  return a;
}

// Query tile t's window on one axis (past the tile's edge, its last query's):
// halo index of its first key, and the bias index of halo key 0.
struct AxisQuery {
  int lo;
  int rel;
};

__device__ __forceinline__ AxisQuery axis_query(const AxisTile& a, int t, int kernel) {
  const int q = a.q0 + min(t, a.nq - 1);
  AxisQuery r;
  r.lo = window_start(q, a.sub_len, kernel) - a.h0;
  r.rel = a.h0 - q + kernel - 1;
  return r;
}

struct Params {
  const float* qkv;
  const float* rpb;
  const float* out;
  const float* dout;
  float* dqkv;
  float* drpb;
  float* lse;
  float* dsum;
  float* partial;
  int H, W, NH;
  int kernel, dilation;
  float scale;
  int res_h, res_w;      // residue classes per axis, min(dilation, size)
  int tiles_h, tiles_w;  // tiles per residue class, from the longest sub-grid
  int halo_max;          // (a): K and V rows in shared memory
  int inv_max;           // (b): query rows in shared memory
  int span;              // 2 * kernel - 1
  long long blocks;      // blocks of (a) and (b)
};

// The block's (b, head) and its tile on each axis; false if it holds none.
__device__ __forceinline__ bool block_tile(const Params& p, bool keys, int& b, int& n, AxisTile& th,
                                           AxisTile& tw) {
  unsigned i = blockIdx.x;
  n = (int)(i % p.NH);
  i /= p.NH;
  const int tile_w = (int)(i % p.tiles_w);
  i /= p.tiles_w;
  const int tile_h = (int)(i % p.tiles_h);
  i /= p.tiles_h;
  const int mw = (int)(i % p.res_w);
  i /= p.res_w;
  const int mh = (int)(i % p.res_h);
  b = (int)(i / p.res_h);
  th = axis_tile(p.H, p.kernel, p.dilation, mh, tile_h, keys);
  tw = axis_tile(p.W, p.kernel, p.dilation, mw, tile_w, keys);
  return th.nq > 0 && tw.nq > 0;
}

// (b, row, col) as a pixel index; its qkv record holds 3 * NH * DH floats,
// its out / dout record and its lse / D entries NH * DH and NH
__device__ __forceinline__ long long pixel(const Params& p, int b, const AxisTile& th, int sub_h, const AxisTile& tw,
                                           int sub_w) {
  return ((long long)b * p.H + sub_h * p.dilation + th.m) * p.W + sub_w * p.dilation + tw.m;
}

__device__ __forceinline__ long long qkv_at(const Params& p, long long pix, int slot, int n) {
  return (pix * 3 + slot) * p.NH * DH + (long long)n * DH;
}

__host__ __device__ constexpr int bias_bytes(int span) { return (span * span * 4 + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// this thread's 16 of the row's 32 floats, from global memory
__device__ __forceinline__ void load_half(const float* src, float* x) {
#pragma unroll
  for (int i = 0; i < HALF / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void store_half(float* dst, const float* x, float f) {
#pragma unroll
  for (int i = 0; i < HALF / 4; ++i)
    reinterpret_cast<float4*>(dst)[i] = make_float4(x[4 * i] * f, x[4 * i + 1] * f, x[4 * i + 2] * f,
                                                    x[4 * i + 3] * f);
}

// The two lanes of a query (or key): they walk the same window, but the
// pairs of a warp may not (a key's range of queries is its own).
__device__ __forceinline__ float pair_sum(float s) {
  return s + __shfl_xor_sync(3u << (threadIdx.x & 30), s, 1);
}

// a . (this thread's half of a row in shared memory), then the other half's
// sum from the partner lane: the same sum in both lanes
__device__ __forceinline__ float dot_row(const float* a, const unsigned char* row, int half) {
  const float4* r = reinterpret_cast<const float4*>(row) + half * (HALF / 4);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < HALF / 4; ++i) {
    const float4 x = r[i];
    s = fmaf(a[4 * i], x.x, s);
    s = fmaf(a[4 * i + 1], x.y, s);
    s = fmaf(a[4 * i + 2], x.z, s);
    s = fmaf(a[4 * i + 3], x.w, s);
  }
  return pair_sum(s);
}

__device__ __forceinline__ float dot_half(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < HALF; ++i) s = fmaf(a[i], b[i], s);
  return pair_sum(s);
}

__device__ __forceinline__ void axpy_row(float* acc, float w, const unsigned char* row, int half) {
  const float4* r = reinterpret_cast<const float4*>(row) + half * (HALF / 4);
#pragma unroll
  for (int i = 0; i < HALF / 4; ++i) {
    const float4 x = r[i];
    acc[4 * i] = fmaf(w, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
  }
}

// ------------------------------------------------------ (a) query tiles
__global__ void __launch_bounds__(kThreads) na2d_bwd_query_kernel(const Params p) {
  const int span = p.span, kernel = p.kernel;
  float* partial = p.partial + (long long)blockIdx.x * span * span;
  int b, n;
  AxisTile th, tw;
  if (!block_tile(p, false, b, n, th, tw)) {
    for (int e = threadIdx.x; e < span * span; e += kThreads) partial[e] = 0.f;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);
  unsigned char* ks = smem + bias_bytes(span);
  unsigned char* vs = ks + p.halo_max * ROW;
  float* ds = reinterpret_cast<float*>(vs + p.halo_max * ROW);  // dS per (query slot, window entry)

  for (int c = threadIdx.x; c < th.n * tw.n * CPR; c += kThreads) {
    const int e = c / CPR, i = c % CPR;
    const long long pix = pixel(p, b, th, th.h0 + e / tw.n, tw, tw.h0 + e % tw.n);
    cp_async16(ks + e * ROW + i * 16, p.qkv + qkv_at(p, pix, 1, n) + i * 4);
    cp_async16(vs + e * ROW + i * 16, p.qkv + qkv_at(p, pix, 2, n) + i * 4);
  }
  const float* rpb = p.rpb + (long long)n * span * span;
  for (int e = threadIdx.x; e < span * span; e += kThreads) bias[e] = rpb[e];

  const int slot = threadIdx.x / 2, half = threadIdx.x % 2;
  const int tr = slot / TQ, tc = slot % TQ;  // past the tile's edge: its last query again
  const bool valid = tr < th.nq && tc < tw.nq;
  const AxisQuery qh = axis_query(th, tr, kernel), qw = axis_query(tw, tc, kernel);
  const long long pix = pixel(p, b, th, th.q0 + min(tr, th.nq - 1), tw, tw.q0 + min(tc, tw.nq - 1));
  float qf[HALF], go[HALF], acc[HALF];
  load_half(p.qkv + qkv_at(p, pix, 0, n) + half * HALF, qf);
#pragma unroll
  for (int d = 0; d < HALF; ++d) qf[d] *= p.scale;  // as the module scales q
  const long long orow = (pix * p.NH + n) * DH + half * HALF;
  load_half(p.out + orow, acc);
  load_half(p.dout + orow, go);
  const float dsum = dot_half(go, acc);  // D = dO . O
  cp_async_wait_all();
  __syncthreads();

  // pass 1: the running max and the count-weighted sum of exponentials
  float mx = -INFINITY, sum = 0.f;
  for (int a = 0; a < th.len; ++a) {
    const int kr = qh.lo + a;
    const float ch = th.h0 + kr == th.rep ? (float)th.cnt : 1.f;
    const float* brow = bias + (kr + qh.rel) * span + qw.rel;
    for (int c = 0; c < tw.len; ++c) {
      const int ww = qw.lo + c;
      const float s = dot_row(qf, ks + (kr * tw.n + ww) * ROW, half) + brow[ww];
      if (s > mx) {
        sum *= expf(mx - s);
        mx = s;
      }
      sum += ch * (tw.h0 + ww == tw.rep ? (float)tw.cnt : 1.f) * expf(s - mx);
    }
  }
  const float lse = mx + logf(sum);

  // pass 2: dS per entry, dq, and dS kept for the bias gradient
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
  float* ds_slot = ds + slot * kernel * kernel;
  for (int a = 0; a < th.len; ++a) {
    const int kr = qh.lo + a;
    const float ch = th.h0 + kr == th.rep ? (float)th.cnt : 1.f;
    const float* brow = bias + (kr + qh.rel) * span + qw.rel;
    for (int c = 0; c < tw.len; ++c) {
      const int ww = qw.lo + c;
      const int e = kr * tw.n + ww;
      const float s = dot_row(qf, ks + e * ROW, half) + brow[ww];
      const float pc = expf(s - lse);  // one copy's probability
      const float dp = dot_row(go, vs + e * ROW, half);
      const float g = ch * (tw.h0 + ww == tw.rep ? (float)tw.cnt : 1.f) * pc * (dp - dsum);
      axpy_row(acc, g, ks + e * ROW, half);
      if (half == 0) ds_slot[a * tw.len + c] = g;
    }
  }
  if (valid) {
    store_half(p.dqkv + qkv_at(p, pix, 0, n) + half * HALF, acc, p.scale);
    if (half == 0) {
      p.lse[pix * p.NH + n] = lse;
      p.dsum[pix * p.NH + n] = dsum;
    }
  }
  __syncthreads();

  // the block's drpb partial: per bias cell, its queries' dS in slot order
  for (int e = threadIdx.x; e < span * span; e += kThreads) {
    const int rh = e / span, rw = e % span;
    float total = 0.f;
    for (int s2 = 0; s2 < TQ * TQ; ++s2) {
      const int r2 = s2 / TQ, c2 = s2 % TQ;
      if (r2 >= th.nq || c2 >= tw.nq) continue;
      const AxisQuery h2 = axis_query(th, r2, kernel), w2 = axis_query(tw, c2, kernel);
      const int a = rh - h2.rel - h2.lo, c = rw - w2.rel - w2.lo;
      if ((unsigned)a < (unsigned)th.len && (unsigned)c < (unsigned)tw.len)
        total += ds[s2 * kernel * kernel + a * tw.len + c];
    }
    partial[e] = total;
  }
}

// -------------------------------------------------------- (b) key tiles
__global__ void __launch_bounds__(kThreads) na2d_bwd_key_kernel(const Params p) {
  const int span = p.span, kernel = p.kernel;
  int b, n;
  AxisTile th, tw;
  if (!block_tile(p, true, b, n, th, tw)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);
  unsigned char* qs = smem + bias_bytes(span);  // the inverse halo's q rows, scaled below
  unsigned char* gs = qs + p.inv_max * ROW;     // and its dO rows
  float* lse = reinterpret_cast<float*>(gs + p.inv_max * ROW);
  float* dsum = lse + p.inv_max;

  const int nq = th.n * tw.n;
  for (int c = threadIdx.x; c < nq * CPR; c += kThreads) {
    const int e = c / CPR, i = c % CPR;
    const long long pix = pixel(p, b, th, th.h0 + e / tw.n, tw, tw.h0 + e % tw.n);
    cp_async16(qs + e * ROW + i * 16, p.qkv + qkv_at(p, pix, 0, n) + i * 4);
    cp_async16(gs + e * ROW + i * 16, p.dout + (pix * p.NH + n) * DH + i * 4);
  }
  for (int e = threadIdx.x; e < nq; e += kThreads) {
    const long long pix = pixel(p, b, th, th.h0 + e / tw.n, tw, tw.h0 + e % tw.n);
    lse[e] = p.lse[pix * p.NH + n];
    dsum[e] = p.dsum[pix * p.NH + n];
  }
  const float* rpb = p.rpb + (long long)n * span * span;
  for (int e = threadIdx.x; e < span * span; e += kThreads) bias[e] = rpb[e];

  const int slot = threadIdx.x / 2, half = threadIdx.x % 2;
  const int tr = slot / TQ, tc = slot % TQ;  // past the tile's edge: its last key again
  const bool valid = tr < th.nq && tc < tw.nq;
  const int sh = th.q0 + min(tr, th.nq - 1), sw = tw.q0 + min(tc, tw.nq - 1);  // the key, sub-grid indices
  const long long pix = pixel(p, b, th, sh, tw, sw);
  float kf[HALF], vf[HALF], dk[HALF], dv[HALF];
  load_half(p.qkv + qkv_at(p, pix, 1, n) + half * HALF, kf);
  load_half(p.qkv + qkv_at(p, pix, 2, n) + half * HALF, vf);
  const float cnt = (sh == th.rep ? (float)th.cnt : 1.f) * (sw == tw.rep ? (float)tw.cnt : 1.f);
  cp_async_wait_all();
  __syncthreads();
  for (int c = threadIdx.x; c < nq * DH; c += kThreads) {  // q as the module scales it
    float* x = reinterpret_cast<float*>(qs + (c / DH) * ROW) + c % DH;
    *x *= p.scale;
  }
  __syncthreads();

#pragma unroll
  for (int d = 0; d < HALF; ++d) {
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const int qh_lo = inverse_lo(sh, th.sub_len, kernel), qh_hi = inverse_hi(sh, th.sub_len, kernel);
  const int qw_lo = inverse_lo(sw, tw.sub_len, kernel), qw_hi = inverse_hi(sw, tw.sub_len, kernel);
  for (int qh = qh_lo; qh <= qh_hi; ++qh) {
    const float* brow = bias + (sh - qh + kernel - 1) * span + kernel - 1 + sw;
    for (int qw = qw_lo; qw <= qw_hi; ++qw) {
      const int e = (qh - th.h0) * tw.n + qw - tw.h0;
      const unsigned char* qrow = qs + e * ROW;
      // the logit exactly as (a) formed it: q_scaled . k, then the bias
      float s = 0.f;
      {
        const float4* r = reinterpret_cast<const float4*>(qrow) + half * (HALF / 4);
#pragma unroll
        for (int i = 0; i < HALF / 4; ++i) {
          const float4 x = r[i];
          s = fmaf(x.x, kf[4 * i], s);
          s = fmaf(x.y, kf[4 * i + 1], s);
          s = fmaf(x.z, kf[4 * i + 2], s);
          s = fmaf(x.w, kf[4 * i + 3], s);
        }
        s = pair_sum(s);
      }
      s += brow[-qw];
      const float pc = cnt * expf(s - lse[e]);  // the key's probability, all its copies
      const float dp = dot_row(vf, gs + e * ROW, half);
      const float g = pc * (dp - dsum[e]);
      axpy_row(dk, g, qrow, half);
      axpy_row(dv, pc, gs + e * ROW, half);
    }
  }
  if (valid) {
    store_half(p.dqkv + qkv_at(p, pix, 1, n) + half * HALF, dk, 1.f);
    store_half(p.dqkv + qkv_at(p, pix, 2, n) + half * HALF, dv, 1.f);
  }
}

// -------------------------------------------------------------- (c) drpb
__global__ void __launch_bounds__(32 * kRpbWarps) na2d_bwd_rpb_kernel(const Params p) {
  __shared__ float red[kRpbWarps][32];
  const int n = blockIdx.x, cells = p.span * p.span;
  const int cell = blockIdx.y * 32 + threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long per_head = p.blocks / p.NH;  // (a)'s blocks of one head: every NH-th
  float total = 0.f;
  if (cell < cells)
    for (long long j = warp; j < per_head; j += kRpbWarps) total += p.partial[(j * p.NH + n) * cells + cell];
  red[warp][threadIdx.x % 32] = total;
  __syncthreads();
  if (warp == 0 && cell < cells) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRpbWarps; ++w) s += red[w][threadIdx.x];
    p.drpb[(long long)n * cells + cell] = s;
  }
}

// The longest inverse halo of any key tile along one axis.
int inverse_halo_max(int size, int kernel, int dilation) {
  int best = 1;
  for (int m = 0; m < dilation && m < size; ++m) {
    const int sub_len = (size - m + dilation - 1) / dilation;
    for (int k0 = 0; k0 < sub_len; k0 += TQ) {
      const int last = min(k0 + TQ, sub_len) - 1;
      best = max(best, inverse_hi(last, sub_len, kernel) + 1 - inverse_lo(k0, sub_len, kernel));
    }
  }
  return best;
}

// The launches: Params, (a)'s and (b)'s blocks and dynamic shared memory;
// false if the shapes are refused.
bool plan(int B, int H, int W, int NH, int kernel, int dilation, Params& p, int& smem_a, int& smem_b) {
  if (B < 0 || H < 0 || W < 0 || NH < 1 || kernel < 1 || dilation < 1) return false;
  p.H = H;
  p.W = W;
  p.NH = NH;
  p.kernel = kernel;
  p.dilation = dilation;
  p.res_h = dilation < H ? dilation : H;
  p.res_w = dilation < W ? dilation : W;
  p.tiles_h = ((H + dilation - 1) / dilation + TQ - 1) / TQ;
  p.tiles_w = ((W + dilation - 1) / dilation + TQ - 1) / TQ;
  const int halo = TQ + kernel - 1;  // the longest halo side
  p.halo_max = halo * halo;
  p.inv_max = H > 0 && W > 0 ? inverse_halo_max(H, kernel, dilation) * inverse_halo_max(W, kernel, dilation) : 1;
  p.span = 2 * kernel - 1;
  smem_a = bias_bytes(p.span) + 2 * p.halo_max * ROW + TQ * TQ * kernel * kernel * 4;
  smem_b = bias_bytes(p.span) + p.inv_max * (2 * ROW + 8);
  p.blocks = (long long)B * p.res_h * p.res_w * p.tiles_h * p.tiles_w * NH;
  return smem_a <= kMaxSmem && smem_b <= kMaxSmem && p.blocks <= 0x7fffffffLL;
}

cudaError_t launch(void (*fn)(Params), const Params& p, dim3 grid, int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  fn<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K5's launches for these shapes: (a)'s and (b)'s blocks (also the rows of
// the drpb partials the caller allocates, each (2k - 1)^2 floats), threads a
// block, and (a)'s and (b)'s dynamic shared memory. Returns 0, or
// cudaErrorInvalidValue for shapes it refuses.
extern "C" int na2d_backward_launch_shape(int B, int H, int W, int NH, int kernel, int dilation, long long* blocks,
                                          int* threads, int* smem_a, int* smem_b) {
  Params p;
  if (!plan(B, H, W, NH, kernel, dilation, p, *smem_a, *smem_b)) return (int)cudaErrorInvalidValue;
  *blocks = p.blocks;
  *threads = kThreads;
  return 0;
}

// Neighborhood attention backward: three kernels on `stream`. The wrapper
// checks shapes, fp32, head dim 32 and contiguity, and allocates the outputs
// and the scratch: lse and dsum (B, H, W, heads), partial (blocks, (2k-1)^2).
extern "C" int na2d_backward(const float* qkv, const float* rpb, const float* out, const float* dout, float* dqkv,
                             float* drpb, float* lse, float* dsum, float* partial, int B, int H, int W, int NH,
                             int head_dim, int kernel, int dilation, float scale, void* stream) {
  Params p;
  int smem_a, smem_b;
  if (head_dim != DH || !plan(B, H, W, NH, kernel, dilation, p, smem_a, smem_b)) return (int)cudaErrorInvalidValue;
  p.qkv = qkv;
  p.rpb = rpb;
  p.out = out;
  p.dout = dout;
  p.dqkv = dqkv;
  p.drpb = drpb;
  p.lse = lse;
  p.dsum = dsum;
  p.partial = partial;
  p.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  const int cells = p.span * p.span;
  if (p.blocks == 0) return (int)cudaMemsetAsync(drpb, 0, (size_t)NH * cells * sizeof(float), s);
  cudaError_t e = launch(na2d_bwd_query_kernel, p, dim3((unsigned)p.blocks), kThreads, smem_a, s);
  if (e != cudaSuccess) return (int)e;
  e = launch(na2d_bwd_key_kernel, p, dim3((unsigned)p.blocks), kThreads, smem_b, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch(na2d_bwd_rpb_kernel, p, dim3(NH, (cells + 31) / 32), 32 * kRpbWarps, 0, s);
}
