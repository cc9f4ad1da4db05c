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
//   P       the softmax over the window's k * k entries: exp(logit - lse),
//           lse the log-sum-exp K4's fp32 kernel wrote for the backward
//   D       rowsum(dO * O), per query and head
//   dS      P * (dO . v - D) per entry; a key that a window lists c times
//           (c = count_h * count_w, > 1 only for a short sub-grid's last key)
//           is stored once and its dS counted c times, as the plain version's
//           repeated entries are
//   dq      scale * sum dS k   (q is scaled inside)
//   dk, dv  sum over the queries whose windows hold the key of dS q_scaled
//           and c P dO
//   drpb    sum of dS over every query of a head, per (rel_h, rel_w)
// all to fp32 accuracy (training runs fp32 with TF32 off).
//
//   qkv       (B, H, W, 3, heads, 32) fp32 contiguous: the qkv projection's
//             output, q, k and v the three slots
//   rpb       (heads, 2k - 1, 2k - 1) fp32 contiguous
//   out, dout (B, H, W, heads, 32) fp32 contiguous: K4's output, its gradient
//   lse       (B, H, W, heads) fp32: K4's log-sum-exp of each window
//   dqkv      (B, H, W, 3, heads, 32): dq, dk, dv in the qkv layout, so that
//             the projection gets its gradient without a cat
//   drpb      (heads, 2k - 1, 2k - 1)
//   scratch   per query D', lse and 1 / r (B, H, W, heads, 4; the query
//             pass's, for the key pass); per query block a (2k - 1)^2 table
//             of its drpb sums
//
// What bounds it on an H100: at DiNAT-L's stage 0 of a 512x1024 crop (B = 2,
// 128x256, 6 heads, dh 32) one call must read q, k, v and dO and write dq, dk
// and dv, ~352 MB: 0.105 ms at 3.35 TB/s; its ~6.3 GFLOP take 0.094 ms at
// fp32's 67 TFLOP/s. So bytes bind, by a little.
//
// Design: three kernels, no atomics, every sum in a fixed order, so reruns
// give the same bytes (the trainer's deterministic mode holds it).
//   (a) query tiles: K4's blocks (one (b, head, residue class, 8 x 8 tile of
//       sub-grid queries)) and its halo (the keys of every window of the tile,
//       each once; K and V in shared memory by cp.async). Warp w owns tile
//       rows 2w and 2w + 1, the 16 rows of mma.sync m16n8k8; an n8 tile of
//       keys is 8 halo rows of one halo column (K4's bf16 walk). Per n8 tile
//       S = Q K^T and dP = dO V^T on the tensor cores, each logit once: P =
//       c exp(S + bias - lse), dS = P (dP - D), then dq += dS K, dS straight
//       from the C fragment as the next product's A fragment. The bias
//       gradient: each warp adds its dS to a (2k - 1)^2 table of its own in
//       two conflict-free steps per n8 tile; the block sums its four tables
//       in warp order into its partial. Each query's softmax is then made
//       this pass's own (below), and D', 1 / r and K4's lse go to scratch.
//   (b) key tiles: the same blocks over keys. The queries whose windows hold
//       a key are one range per axis (a window's start never decreases):
//       [s - k + 1 + k/2, s + k/2] inside, widened to the map's edge where
//       the window is clamped, the whole sub-grid where it is shorter than k
//       (`_inverse_range` in ops/neighborhood_attention.py mirrors it). The
//       tile's inverse halo of queries (q scaled, dO, and each query's lse,
//       D' and 1 / r) goes to shared memory; a warp's 16 keys are the m16
//       rows, an n8 tile is 8 halo rows of queries: S^T = K Q^T, dP^T = V
//       dO^T, then dk += dS^T Q and dv += P^T dO. No scatter, no atomics.
//   (c) drpb: per head and bias cell, the partials of (a)'s blocks summed in
//       block order by 8 warps, then across the warps in order.
// What the tensor cores buy: on the CUDA cores, with two threads per query
// (16 dims each), every window entry reads whole rows of K and V (or Q and
// dO) from shared memory, ~1 KB per entry, and the softmax needs each logit
// twice in the query pass; here a fragment in registers serves 16 rows, a
// 16 x 8 tile reads its 8 rows of each operand twice (once for S or dP,
// once for the products that follow), and each logit is formed once a pass.
// The price: an n8 tile is a whole halo column, so a pass forms 112
// entries a query at k = 7 for its 49.
//
// Precision: 3xTF32. A TF32 operand keeps 10 mantissa bits (about three
// digits): one TF32 product would miss this kernel's tolerances against
// plain fp32 autograd (dqkv atol 2e-5 + rtol 1e-4) wherever the logits are
// large, and the trainer runs with TF32 off. So every fp32 operand x is
// split as big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big) (x - big
// is exact in fp32), and each product is small*big + big*small + big*big
// with an fp32 accumulator: |x y - that| <= 3.01 * 2^-22 |x y| per product
// (the dropped terms are small*small and the two rounding errors of the
// small parts), the bound tests/test_torch_port_na_backward.py holds in
// numpy. The tensor core sums a product's 8 terms and its accumulator and
// truncates to fp32, so the running sums stay off it: a logit's 4 k-steps
// and a product's 14-odd n8 tiles are each summed from zero and added with
// a rounded fp32 add. The logits here and K4's (CUDA cores, in another order,
// whose max and sum gave the lse) differ by a few ulps: ~1e-6 at unit scale,
// ~1e-5 where the logits reach 30-100. So P with K4's lse sums to r = 1 + that
// and D = dO . O (K4's O) is sum P dP only to that order; where the logits
// are large both reach the gradients (by up to 3x the tolerance at 4x q and
// k), so the query pass divides by r and replaces D by D' = sum P dP / r at
// its end: dq = scale / r (sum dS k - (D' - D) sum P k), with sum P k in one
// TF32 product (it only scales the small D' - D). The key pass reads 1 / r
// and D'. drpb keeps K4's D and r (its tolerance is wider by sqrt(B H W dh)).
//
// Fragments (m16n8k8, lane = 4 g + t): A (16 x 8) holds rows g and g + 8 at
// columns t and t + 4, B (8 x 8) rows t and t + 4 at column g, C (16 x 8)
// rows g and g + 8 at columns 2t and 2t + 1. The orders below are free
// permutations of a product's inner index or of its output columns:
//   inner dims     k-step s = 2u + v takes dims 16u + 4t + 2v (column t) and
//                  16u + 4t + 2v + 1 (column t + 4): a lane's operand values
//                  of two k-steps are one float4 of a row
//   keys of an n8  C column n is halo row sigma(n) of the group: sigma(2t) =
//                  t, sigma(2t + 1) = 4 + ((t + 2) & 3), so that C's columns
//                  2t and 2t + 1 are the next product's inner columns t and
//                  t + 4 with no shuffle, and both read patterns below are
//                  free of bank conflicts
//   output dims    n-tile j, column c is dim 4c + j: a lane's B values of
//                  the four n-tiles are one float4 of a row, and its outputs
//                  dims 8t .. 8t + 7 of its two rows
// Shared rows are 128 bytes, 8 chunks of 16, chunk c of halo row r stored at
// c ^ (2 (r & 3)): the 16-byte reads of rows sigma(g) (chunks 4u + t) and
// of rows sigma(2t), sigma(2t + 1) (chunk g) each fall in 8 bank groups.
// Registers hold the A fragments of two operands (Q and dO, or K and V) as
// big and small parts: 64 of them, besides 32 of accumulators (dq and sum P
// k, or dk and dv). Capped at 128 registers (four blocks an SM) ptxas
// spills 152 and 96 bytes, at 168 (three) 40 bytes of the key kernel; so
// two blocks of 4 warps an SM (229 registers with both column loops
// unrolled by two, no spill). Shared memory ~53 KB a block at k = 7. dh is
// fixed at 32 (every DiNAT-L stage's). k5_variants.py builds the
// variants named here and times them beside this build.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 32;             // the head dim
constexpr int TQ = 8;              // a tile is TQ x TQ queries (or keys) of one residue class's sub-grid
constexpr int kWarps = 4;          // warp w owns tile rows 2w and 2w + 1
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;      // blocks an SM holds: up to 255 registers a thread (see the note above)
constexpr int ROW = DH * 4;        // bytes of a row in shared memory (fp32, swizzled, unpadded)
constexpr int CPR = ROW / 16;      // 16-byte chunks per row
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may have on sm_90
constexpr int kRpbWarps = 8;       // (c): warps a block, each summing every 8th partial
constexpr float kLog2e = 1.4426950408889634f;

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
  const float* lse;
  float* dqkv;
  float* drpb;
  float4* stats;  // per query: D', lse, 1 / (its P's sum), unused (the query pass's, for the key pass)
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
// its out / dout record NH * DH and its lse / D entries NH
__device__ __forceinline__ long long pixel(const Params& p, int b, const AxisTile& th, int sub_h, const AxisTile& tw,
                                           int sub_w) {
  return ((long long)b * p.H + sub_h * p.dilation + th.m) * p.W + sub_w * p.dilation + tw.m;
}

__device__ __forceinline__ long long qkv_at(const Params& p, long long pix, int slot, int n) {
  return (pix * 3 + slot) * p.NH * DH + (long long)n * DH;
}

__host__ __device__ constexpr int bias_bytes(int span) { return (span * span * 4 + 15) / 16 * 16; }

// byte offset of 16-byte chunk c in halo row r's entries (the swizzle)
__device__ __forceinline__ int chunk_at(int r, int c) { return (c ^ ((r & 3) << 1)) * 16; }

// the group's halo row (0 .. 7) in C column n (sigma above)
__device__ __forceinline__ int sigma(int n) { return n & 1 ? 4 + (((n >> 1) + 2) & 3) : n >> 1; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------- 3xTF32
// cvt.rna.tf32.f32 of a finite x: round to 10 mantissa bits, ties away
// from zero (the PTX instruction adds NaN handling the data never needs)
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = big + small to ~22 bits: big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += a b: a 16x8 tf32 (row), b 8x8 tf32 (col), c 16x8 fp32
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small terms first; b0, b1 are split here
__device__ __forceinline__ void mma3(float* c, const uint32_t* a_big, const uint32_t* a_small, float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma_tf32(c, a_small, bb0, bb1);
  mma_tf32(c, a_big, bs0, bs1);
  mma_tf32(c, a_big, bb0, bb1);
}

// The A fragments of 16 rows x 32 dims (rows g and g + 8 from r0 and r1,
// each DH floats in global memory), big and small parts per k-step; x scaled
// by f first (in fp32, as the module scales q).
__device__ __forceinline__ void load_a(const float* r0, const float* r1, int t, float f, uint32_t (&big)[4][4],
                                       uint32_t (&small)[4][4]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4 x = *reinterpret_cast<const float4*>((r ? r1 : r0) + 16 * u + 4 * t);
      split(x.x * f, big[2 * u][r], small[2 * u][r]);
      split(x.y * f, big[2 * u][r + 2], small[2 * u][r + 2]);
      split(x.z * f, big[2 * u + 1][r], small[2 * u + 1][r]);
      split(x.w * f, big[2 * u + 1][r + 2], small[2 * u + 1][r + 2]);
    }
}

// c = X Y^T over the 32 dims: X's fragments in registers, lane's row of Y
// (halo row sigma(g)) at `row` in shared memory with the chunk offsets of
// its chunks t and 4 + t. Each k-step's products are summed on their own
// and added to c once, rounded to nearest: the tensor core truncates every
// sum to the precision of its largest addend, and a running logit is the
// largest.
__device__ __forceinline__ void mma_rows(float* c, const uint32_t (&big)[4][4], const uint32_t (&small)[4][4],
                                         const unsigned char* row, int off0, int off1) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float4 y = *reinterpret_cast<const float4*>(row + (u ? off1 : off0));
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(part, big[2 * u + v], small[2 * u + v], yv[2 * v], yv[2 * v + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] += part[e];
    }
  }
}

// acc += W Z over the group's 8 halo rows: W (16 x 8) from a C fragment,
// Z's rows sigma(2t) and sigma(2t + 1) at za, zb in shared memory (this
// lane's chunk g of each): acc[j] is n-tile j, dims 4 col + j. With `rough`,
// also rough += V Z in one TF32 product (V another C fragment), where three
// digits will do.
template <bool kRough>
__device__ __forceinline__ void mma_cols(float (&acc)[4][4], const float* w, const unsigned char* za,
                                         const unsigned char* zb, float (&rough)[4][4], const float* v) {
  uint32_t big[4], small[4], vt[4];
  split(w[0], big[0], small[0]);  // A column t: C column 2t; A column t + 4: C column 2t + 1
  split(w[2], big[1], small[1]);
  split(w[1], big[2], small[2]);
  split(w[3], big[3], small[3]);
  if (kRough) {
    vt[0] = __float_as_uint(v[0]);  // the tensor core reads the top 19 bits
    vt[1] = __float_as_uint(v[2]);
    vt[2] = __float_as_uint(v[1]);
    vt[3] = __float_as_uint(v[3]);
  }
  const float4 a = *reinterpret_cast<const float4*>(za);
  const float4 b = *reinterpret_cast<const float4*>(zb);
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // the tile's sum on its own, then one rounded add to the running sum
    uint32_t bb0, bs0, bb1, bs1;
    split(av[j], bb0, bs0);
    split(bv[j], bb1, bs1);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(part, small, bb0, bb1);
    mma_tf32(part, big, bs0, bs1);
    mma_tf32(part, big, bb0, bb1);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
    if (kRough) mma_tf32(rough[j], vt, bb0, bb1);
  }
}

// a lane's outputs of acc (mma_cols' layout) for rows g and g + 8: dims
// 8t .. 8t + 7, times f0 and f1
__device__ __forceinline__ void store_rows(float* r0, float* r1, bool v0, bool v1, const float (&acc)[4][4], int t,
                                           float f0, float f1) {
  if (v0) {
    float4* o = reinterpret_cast<float4*>(r0 + 8 * t);
    o[0] = make_float4(acc[0][0] * f0, acc[1][0] * f0, acc[2][0] * f0, acc[3][0] * f0);
    o[1] = make_float4(acc[0][1] * f0, acc[1][1] * f0, acc[2][1] * f0, acc[3][1] * f0);
  }
  if (v1) {
    float4* o = reinterpret_cast<float4*>(r1 + 8 * t);
    o[0] = make_float4(acc[0][2] * f1, acc[1][2] * f1, acc[2][2] * f1, acc[3][2] * f1);
    o[1] = make_float4(acc[0][3] * f1, acc[1][3] * f1, acc[2][3] * f1, acc[3][3] * f1);
  }
}

// 2^x on the SFU (rel. error ~2^-22); 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cp.async of `rows` halo entries (row-major over a halo of `cols` columns)
// of slot-strided records into swizzled 128-byte rows
__device__ __forceinline__ void load_halo(unsigned char* dst, int rows, int cols, const float* src, const Params& p,
                                          int b, const AxisTile& th, const AxisTile& tw, int slot, int n) {
  for (int c = threadIdx.x; c < rows * cols * CPR; c += kThreads) {
    const int e = c / CPR, i = c % CPR, r = e / cols;
    const long long pix = pixel(p, b, th, th.h0 + r, tw, tw.h0 + e % cols);
    const long long at = slot < 0 ? (pix * p.NH + n) * DH : qkv_at(p, pix, slot, n);
    cp_async16(dst + e * ROW + chunk_at(r, i), src + at + i * 4);
  }
}

// ------------------------------------------------------ (a) query tiles
__global__ void __launch_bounds__(kThreads, kMinBlocks) na2d_bwd_query_kernel(const Params p) {
  const int span = p.span, kernel = p.kernel, cells = span * span;
  float* partial = p.partial + (long long)blockIdx.x * cells;
  int b, n;
  AxisTile th, tw;
  if (!block_tile(p, false, b, n, th, tw)) {
    for (int e = threadIdx.x; e < cells; e += kThreads) partial[e] = 0.f;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);  // rpb[head] * log2(e)
  const int pitch = bias_bytes(span) / 4;        // floats of a bias table
  float* tables = bias + pitch;                  // each warp's drpb sums, pitch floats apart
  unsigned char* ks = smem + (1 + kWarps) * bias_bytes(span);
  unsigned char* vs = ks + p.halo_max * ROW;

  load_halo(ks, th.n, tw.n, p.qkv, p, b, th, tw, 1, n);
  load_halo(vs, th.n, tw.n, p.qkv, p, b, th, tw, 2, n);
  const float* rpb = p.rpb + (long long)n * cells;
  for (int e = threadIdx.x; e < cells; e += kThreads) bias[e] = rpb[e] * kLog2e;
  for (int e = threadIdx.x; e < kWarps * pitch; e += kThreads) tables[e] = 0.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 2 * warp;  // tile row of mma rows 0-7 (row r0 + 1: mma rows 8-15)
  const bool active = r0 < th.nq;
  // this lane's queries: tile rows r0 + r, column g (past the tile's edge, its last)
  const long long pix0 = pixel(p, b, th, th.q0 + min(r0, th.nq - 1), tw, tw.q0 + min(g, tw.nq - 1));
  const long long pix1 = pixel(p, b, th, th.q0 + min(r0 + 1, th.nq - 1), tw, tw.q0 + min(g, tw.nq - 1));
  const bool valid0 = active && g < tw.nq, valid1 = valid0 && r0 + 1 < th.nq;
  uint32_t qb[4][4], qs[4][4], gb[4][4], gs[4][4];
  float lse[2], dsum[2];
  if (active) {
    load_a(p.qkv + qkv_at(p, pix0, 0, n), p.qkv + qkv_at(p, pix1, 0, n), t, p.scale, qb, qs);
    const float* d0 = p.dout + (pix0 * p.NH + n) * DH;
    const float* d1 = p.dout + (pix1 * p.NH + n) * DH;
    load_a(d0, d1, t, 1.f, gb, gs);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // D = dO . O: this lane's 8 dims, then the quad's in a fixed order
      const long long row = ((r ? pix1 : pix0) * p.NH + n) * DH;
      float d = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 o = *reinterpret_cast<const float4*>(p.out + row + 16 * u + 4 * t);
        const float4 go = *reinterpret_cast<const float4*>(p.dout + row + 16 * u + 4 * t);
        d = fmaf(go.x, o.x, fmaf(go.y, o.y, fmaf(go.z, o.z, fmaf(go.w, o.w, d))));
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      dsum[r] = d;
      lse[r] = p.lse[(r ? pix1 : pix0) * p.NH + n];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (active) {
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const AxisQuery qh0 = axis_query(th, r0, kernel), qh1 = axis_query(th, r0 + 1, kernel);
    const AxisQuery qw = axis_query(tw, g, kernel);
    // the warp's keys: halo rows [kr_lo, kr_hi) x columns [cw_lo, cw_hi) (all of the tile's)
    const int kr_lo = qh0.lo, kr_hi = qh1.lo + th.len;
    const int cw_lo = axis_query(tw, 0, kernel).lo, cw_hi = axis_query(tw, TQ - 1, kernel).lo + tw.len;
    float* table = tables + warp * pitch;
    float rs[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};  // this lane's part of each query's sum of P and of P dP
    float pk[4][4];  // sum of P k, for the correction of D below
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pk[j][e] = 0.f;
    const int sa = t, sb = 4 + ((t + 2) & 3);  // C columns 2t and 2t + 1: group rows sigma(2t), sigma(2t + 1)
    const int row_bytes = tw.n * ROW;

    // An n8 tile of keys is 8 halo rows of one column: rows rg .. rg + 7 (at
    // k <= 7 one group holds both query rows' windows).
    for (int rg = kr_lo; rg < kr_hi; rg += 8) {
      const int ka = rg + sa, kb = rg + sb;
      uint32_t row_in = 0;  // bit 2 r + j: key row (ka, kb)[j] inside query r's window, query valid
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kr = j ? kb : ka;
        row_in |= (uint32_t)(valid0 && (unsigned)(kr - qh0.lo) < (unsigned)th.len) << j;
        row_in |= (uint32_t)(valid1 && (unsigned)(kr - qh1.lo) < (unsigned)th.len) << (2 + j);
      }
      const float cha = th.h0 + ka == th.rep ? (float)th.cnt : 1.f;
      const float chb = th.h0 + kb == th.rep ? (float)th.cnt : 1.f;
      const int bias0 = (ka + qh0.rel) * span + qw.rel;  // bias cell of (query r0, key ka) in halo column 0
      // the lane's rows in shared memory (past the halo, its last row)
      const int ry = min(rg + sigma(g), th.n - 1), rza = min(ka, th.n - 1), rzb = min(kb, th.n - 1);
      const int y0 = chunk_at(ry, t), y1 = chunk_at(ry, 4 + t);
      const unsigned char* ky = ks + ry * row_bytes;
      const unsigned char* vy = vs + ry * row_bytes;
      const unsigned char* kza = ks + rza * row_bytes + chunk_at(rza, g);
      const unsigned char* kzb = ks + rzb * row_bytes + chunk_at(rzb, g);

#pragma unroll 2  // two columns in flight: the passes wait on latency more than on throughput
      for (int c = cw_lo; c < cw_hi; ++c) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows(s, qb, qs, ky + c * ROW, y0, y1);  // S = Q K^T
        mma_rows(dp, gb, gs, vy + c * ROW, y0, y1);  // dP = dO V^T
        const bool col_in = (unsigned)(c - qw.lo) < (unsigned)tw.len;
        const float cw = tw.h0 + c == tw.rep ? (float)tw.cnt : 1.f;
        // entry e: query r = e / 2, key (ka, kb)[e % 2]; P with its count, dS
        int cell[4];
        bool in[4];
        float pm[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, j = e % 2;
          in[e] = col_in && (row_in >> (2 * r + j) & 1u);
          cell[e] = in[e] ? bias0 + (j ? (sb - sa) * span : 0) - r * span + c : 0;
          // (S - lse) first: both are large where the logits are, their difference is not
          const float pe = (j ? chb : cha) * cw * exp2_approx(fmaf(s[e] - lse[r], kLog2e, bias[cell[e]]));
          pm[e] = in[e] ? pe : 0.f;
          rs[r] += pm[e];
          pd[r] = fmaf(pm[e], dp[e], pd[r]);
          s[e] = pm[e] * (dp[e] - dsum[r]);
        }
        // the bias gradient: cells of entries 0, 1 differ across the warp, as
        // do those of 2, 3 (lane t + 1's entry 2 is lane t's entry 1's cell)
        if (in[0]) table[cell[0]] += s[0];
        if (in[1]) table[cell[1]] += s[1];
        __syncwarp();
        if (in[2]) table[cell[2]] += s[2];
        if (in[3]) table[cell[3]] += s[3];
        __syncwarp();
        mma_cols<true>(acc, s, kza + c * ROW, kzb + c * ROW, pk, pm);  // dq += dS K, pk += P K
      }
    }
    // This pass's logits and K4's agree to a few ulps, not exactly: P with
    // K4's lse sums to r = 1 + O(1e-6 |logit|), and D = dO . O (K4's O) is
    // sum P dP only to that order. Both matter where the logits are large, so
    // the softmax here is made its own: P / r, and D' = sum P dP / r, dq =
    // scale / r (sum dS k - (D' - D) sum P k). The key pass reads 1 / r and D'.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 1);
      pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 2);
      inv[r] = 1.f / rs[r];
      pd[r] = pd[r] * inv[r] - dsum[r];  // D' - D
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(-pd[e / 2], pk[j][e], acc[j][e]);
    float* dq0 = p.dqkv + qkv_at(p, pix0, 0, n);
    float* dq1 = p.dqkv + qkv_at(p, pix1, 0, n);
    store_rows(dq0, dq1, valid0, valid1, acc, t, p.scale * inv[0], p.scale * inv[1]);
    if (t == 0) {
      if (valid0) p.stats[pix0 * p.NH + n] = make_float4(dsum[0] + pd[0], lse[0], inv[0], 0.f);
      if (valid1) p.stats[pix1 * p.NH + n] = make_float4(dsum[1] + pd[1], lse[1], inv[1], 0.f);
    }
  }
  __syncthreads();

  // the block's drpb partial: its warps' tables in warp order
  for (int e = threadIdx.x; e < cells; e += kThreads) {
    float total = tables[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += tables[w * pitch + e];
    partial[e] = total;
  }
}

// -------------------------------------------------------- (b) key tiles
__global__ void __launch_bounds__(kThreads, kMinBlocks) na2d_bwd_key_kernel(const Params p) {
  const int span = p.span, kernel = p.kernel, cells = span * span;
  int b, n;
  AxisTile th, tw;
  if (!block_tile(p, true, b, n, th, tw)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);  // rpb[head] * log2(e)
  unsigned char* qsm = smem + bias_bytes(span);  // the inverse halo's q rows, scaled below
  unsigned char* gsm = qsm + p.inv_max * ROW;    // and its dO rows
  float* lse = reinterpret_cast<float*>(gsm + p.inv_max * ROW);  // its lse, D and 1 / (sum of P)
  float* dsum = lse + p.inv_max;
  float* inv = dsum + p.inv_max;

  const int nq = th.n * tw.n;
  load_halo(qsm, th.n, tw.n, p.qkv, p, b, th, tw, 0, n);
  load_halo(gsm, th.n, tw.n, p.dout, p, b, th, tw, -1, n);
  for (int e = threadIdx.x; e < nq; e += kThreads) {
    const long long pix = pixel(p, b, th, th.h0 + e / tw.n, tw, tw.h0 + e % tw.n);
    const float4 st = p.stats[pix * p.NH + n];
    dsum[e] = st.x;
    lse[e] = st.y;
    inv[e] = st.z;
  }
  const float* rpb = p.rpb + (long long)n * cells;
  for (int e = threadIdx.x; e < cells; e += kThreads) bias[e] = rpb[e] * kLog2e;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 2 * warp;  // tile row of mma rows 0-7 (row r0 + 1: mma rows 8-15)
  const bool active = r0 < th.nq;
  // this lane's keys: tile rows r0 + r, column g (past the tile's edge, its last), sub-grid indices
  const int sh0 = th.q0 + min(r0, th.nq - 1), sh1 = th.q0 + min(r0 + 1, th.nq - 1), sw = tw.q0 + min(g, tw.nq - 1);
  const long long pix0 = pixel(p, b, th, sh0, tw, sw), pix1 = pixel(p, b, th, sh1, tw, sw);
  uint32_t kb_[4][4], ks_[4][4], vb[4][4], vs_[4][4];
  if (active) {
    load_a(p.qkv + qkv_at(p, pix0, 1, n), p.qkv + qkv_at(p, pix1, 1, n), t, 1.f, kb_, ks_);
    load_a(p.qkv + qkv_at(p, pix0, 2, n), p.qkv + qkv_at(p, pix1, 2, n), t, 1.f, vb, vs_);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int c = threadIdx.x; c < nq * CPR; c += kThreads) {  // q as the module scales it
    float4* x = reinterpret_cast<float4*>(qsm + c * 16);
    const float4 v = *x;
    *x = make_float4(v.x * p.scale, v.y * p.scale, v.z * p.scale, v.w * p.scale);
  }
  __syncthreads();
  if (!active) return;

  const float cw = sw == tw.rep ? (float)tw.cnt : 1.f;
  const float cnt0 = (sh0 == th.rep ? (float)th.cnt : 1.f) * cw, cnt1 = (sh1 == th.rep ? (float)th.cnt : 1.f) * cw;
  // the queries whose windows hold this lane's keys, in halo indices
  const int ih0 = inverse_lo(sh0, th.sub_len, kernel) - th.h0, ih0n = inverse_hi(sh0, th.sub_len, kernel) - th.h0;
  const int ih1 = inverse_lo(sh1, th.sub_len, kernel) - th.h0, ih1n = inverse_hi(sh1, th.sub_len, kernel) - th.h0;
  const int iw = inverse_lo(sw, tw.sub_len, kernel) - tw.h0, iwn = inverse_hi(sw, tw.sub_len, kernel) - tw.h0;
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.f;
      dv[j][e] = 0.f;
    }
  const int sa = t, sb = 4 + ((t + 2) & 3);  // C columns 2t and 2t + 1: group rows sigma(2t), sigma(2t + 1)
  const int row_bytes = tw.n * ROW;
  // bias cell of (key row r0, query halo (0, 0)): key - query + k - 1 per axis
  const int bias_00 = (sh0 - th.h0 + kernel - 1) * span + sw - tw.h0 + kernel - 1;
  const int bias_10 = bias_00 + (sh1 - sh0) * span;

  // An n8 tile of queries is 8 inverse-halo rows of one column: the warp's
  // rows [ih0, ih1n] in groups of 8, every column.
  for (int rg = ih0; rg <= ih1n; rg += 8) {
    const int qa = rg + sa, qb = rg + sb;
    uint32_t row_in = 0;  // bit 2 r + j: query row (qa, qb)[j] in key row r's inverse range
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qr = j ? qb : qa;
      row_in |= (uint32_t)(qr >= ih0 && qr <= ih0n) << j;
      row_in |= (uint32_t)(qr >= ih1 && qr <= ih1n) << (2 + j);
    }
    const int ry = min(rg + sigma(g), th.n - 1), rza = min(qa, th.n - 1), rzb = min(qb, th.n - 1);
    const int y0 = chunk_at(ry, t), y1 = chunk_at(ry, 4 + t);
    const unsigned char* qy = qsm + ry * row_bytes;
    const unsigned char* gy = gsm + ry * row_bytes;
    const int za = rza * row_bytes + chunk_at(rza, g), zb = rzb * row_bytes + chunk_at(rzb, g);
    const int ea = rza * tw.n, eb = rzb * tw.n;  // entries of the two query rows in column 0

#pragma unroll 2
    for (int c = 0; c < tw.n; ++c) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows(s, kb_, ks_, qy + c * ROW, y0, y1);  // S^T = K Q^T
      mma_rows(dp, vb, vs_, gy + c * ROW, y0, y1);  // dP^T = V dO^T
      const bool col_in = c >= iw && c <= iwn;
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // entry e: key row r = e / 2, query (qa, qb)[e % 2]
        const int r = e / 2, j = e % 2;
        const bool in = col_in && (row_in >> (2 * r + j) & 1u);
        const int cell = in ? (r ? bias_10 : bias_00) - (j ? qb : qa) * span - c : 0;
        const int q = (j ? eb : ea) + c;
        const float pe = (r ? cnt1 : cnt0) * inv[q] * exp2_approx(fmaf(s[e] - lse[q], kLog2e, bias[cell]));
        pr[e] = in ? pe : 0.f;
        s[e] = in ? pe * (dp[e] - dsum[q]) : 0.f;
      }
      mma_cols<false>(dv, pr, gsm + za + c * ROW, gsm + zb + c * ROW, dv, pr);  // dv += P^T dO
      mma_cols<false>(dk, s, qsm + za + c * ROW, qsm + zb + c * ROW, dk, s);    // dk += dS^T Q
    }
  }
  const bool valid0 = g < tw.nq, valid1 = valid0 && r0 + 1 < th.nq;
  store_rows(p.dqkv + qkv_at(p, pix0, 1, n), p.dqkv + qkv_at(p, pix1, 1, n), valid0, valid1, dk, t, 1.f, 1.f);
  store_rows(p.dqkv + qkv_at(p, pix0, 2, n), p.dqkv + qkv_at(p, pix1, 2, n), valid0, valid1, dv, t, 1.f, 1.f);
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
  smem_a = (1 + kWarps) * bias_bytes(p.span) + 2 * p.halo_max * ROW;
  smem_b = bias_bytes(p.span) + p.inv_max * (2 * ROW + 12);
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
// and the scratch: stats (B, H, W, heads, 4), partial (blocks, (2k-1)^2).
// `lse` is K4's (its fp32 kernel's optional output).
extern "C" int na2d_backward(const float* qkv, const float* rpb, const float* out, const float* dout, const float* lse,
                             float* dqkv, float* drpb, float* stats, float* partial, int B, int H, int W, int NH,
                             int head_dim, int kernel, int dilation, float scale, void* stream) {
  Params p;
  int smem_a, smem_b;
  if (head_dim != DH || !plan(B, H, W, NH, kernel, dilation, p, smem_a, smem_b)) return (int)cudaErrorInvalidValue;
  p.qkv = qkv;
  p.rpb = rpb;
  p.out = out;
  p.dout = dout;
  p.lse = lse;
  p.dqkv = dqkv;
  p.drpb = drpb;
  p.stats = reinterpret_cast<float4*>(stats);
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
