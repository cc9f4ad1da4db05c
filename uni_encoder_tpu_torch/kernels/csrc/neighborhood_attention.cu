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
//   lse      optional, fp32 only: (B, H, W, heads) fp32, each query's
//            log-sum-exp over its window (the repeat counts included), for
//            the backward K5 (neighborhood_attention_backward.cu); null when
//            no gradient is needed, and then nothing else changes
//
// Row window (one image's rows split over ranks, parallel/spatial.py): H is
// the whole map's height and the queries are its rows [row_lo, row_hi) only;
// `out` (and `lse`) hold those rows, (B, row_hi - row_lo, W, heads, dh). The
// windows, their clamping and the bias come from the whole map's geometry.
// The wrapper passes q, k and v as pointers to the whole map's row 0 (a
// rank's block shifted back by its first global row, never dereferenced
// outside the rows it holds), so every address below is a global row's. Each
// kernel is built twice: for the whole map (kWindow false, the code as it was
// before row windows, and launched for the window [0, H)) and for a row
// window (kWindow true): the tile set-up divides by the dilation per block,
// and the bf16 kernel sits at its register limit (a branch between the two
// in one build spilled).
//
// What bounds it on an H100: per query and head 2 * k * k * dh multiply-adds
// (6272 FLOP at k = 7, dh = 32) on 3 * dh inputs and dh outputs. At DiNAT-L's
// stage 0 on a 1024x2048 frame (256x512 queries, 6 heads, bf16) one call must
// read ~151 MB of q, k, v and write ~50 MB: 0.060 ms at 3.35 TB/s. Its 2.5
// GFLOP of logits take 0.003 ms on bf16 tensor cores and the other 2.6 GFLOP
// 0.039 ms on fp32 CUDA cores, so bytes bind; over a frame's 30 launches,
// 0.61 ms. The first design (one thread per (pixel, head) walking its 49
// keys) read every key and value row once per window that holds it, ~4.9 GB
// per stage-0 call through L1 and L2, all of it on CUDA cores: 11x its bound.
//
// Design. The queries of one residue class share one dilation lattice, so a
// tile of them has its windows inside one rectangle of keys, its halo.
//   Block     one (b, head, residue class (i mod d, j mod d), tile of TQ x TQ
//             = 8 x 8 sub-grid queries), 4 warps; the head is the fastest
//             index of the grid, so the blocks of one tile's heads run
//             together and read each pixel's qkv record once from device
//             memory. A sub-grid shorter than the tile is one tile (the large
//             dilations, the pair's small maps); blocks of residue classes or
//             tiles past a short sub-grid's end exit at once. Stage 0 launches
//             12288 blocks, the pair's smallest layer 192.
//   Halo      along each axis [start(first query), start(last query) +
//             min(k, sub_len)): start never decreases, so this holds every
//             window of the tile, at most (TQ + k - 1)^2 = 196 keys at k = 7
//             for 64 queries. K and V of the halo (and Q, bf16) go to shared
//             memory with cp.async, 16 bytes a copy, rows padded by 16 bytes
//             (80-byte bf16 rows for ldmatrix, 144-byte fp32 rows for the fp32
//             path's 16-byte reads) and, in bf16, halo rows kept at an odd
//             pitch of entries, so that 8 rows of one column fall in 8 bank
//             groups. A block walks one tile; the blocks sharing an SM (5 in
//             bf16, ~39 KB and 94 registers a thread each; 3 in fp32, ~57 KB)
//             overlap one block's copies with another's arithmetic. TMA is not
//             used: its element strides stop at 8 and DiNAT's dilations reach
//             20. The copies weigh as much as the arithmetic: a tile reads ~7 rows
//             of 64 bytes a query out of L2 (Q, and K and V of 196 keys for
//             64 queries). Tried on the H100 and dropped, each slower at the
//             DiNAT-L shapes: blocks that walk several tiles along a row,
//             copying only the next tile's new halo columns into a ring while
//             the current one computes (fewer blocks an SM, a barrier a step),
//             and 16 x 8 tiles of 8 warps.
//   bf16      warp w owns tile rows 2w and 2w + 1: 16 queries, the rows of
//             mma.sync m16n8k16. An n8 tile of keys is 8 halo rows of one halo
//             column, which at k <= 7 covers both rows' windows, so a warp
//             takes the halo's columns (14 at k = 7) kChunk at a time: S = Q
//             K^T on bf16 tensor cores (q scaled and rounded to bf16 first, as
//             the module does; the products are exact in fp32, so only the
//             order of the sum differs from the plain version's); each logit
//             masked to its query's clamped window in integer arithmetic and
//             given its bias from rpb[head] * log2(e) in shared memory (in the
//             C fragment a lane's keys sit on two fixed halo rows, so the row
//             tests and bias rows are computed once); an online softmax in
//             fp32 with 2^x on the SFU (row max and sum over the quad of lanes
//             that holds a row); then O += P V on the tensor cores with P split
//             into a bf16 high part and a bf16 low part (two products; P keeps
//             16 bits, its error below 2^-17 of each term), V's fragments by
//             ldmatrix.trans. O is normalised in fp32, rounded once, staged in
//             the warp's own Q rows and stored as 16-byte vectors.
//   fp32      the same blocks, tiles and halo; two threads per query, each
//             owning 16 of its 32 dims: the dot products half by half and one
//             shuffle, the window's keys walked once from shared memory with
//             an online softmax, all in fp32 on the CUDA cores (TF32 would
//             keep about three digits).
//   Repeats   in the halo each key is stored once. The plain version counts a
//             key as often as a clamped window lists it: only on an axis whose
//             sub-grid is shorter than k, and then only its last index, k -
//             sub_len + 1 times (every window of that axis is then the whole
//             sub-grid). So each key's exponential is weighted by count_h *
//             count_w, with its one bias. ops/neighborhood_attention.py's
//             `_tile_halo` mirrors this integer arithmetic for the tests.
// No atomics and a fixed order of every sum, so reruns give the same bytes.
// dh is fixed at 32 (every DiNAT-L stage's); registers hold the fragments
// (bf16) or q and the running sum (fp32): no stack frame. Shared memory
// bounds the kernel size: (7 + k)^2 rows of K and V fit up to k = 21 in fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 32;        // the head dim
constexpr int TQ = 8;         // a tile is TQ x TQ queries of one residue class's sub-grid
constexpr int kWarps = 4;     // warp w owns tile rows 2w and 2w + 1
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 4;     // bf16: n8 tiles of keys a softmax step takes
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have on sm_90
constexpr float kLog2e = 1.4426950408889634f;


// ------------------------------------------------------------- geometry
__device__ __forceinline__ int window_start(int q, int sub_len, int kernel) {
  return min(max(q - kernel / 2, 0), max(sub_len - kernel, 0));
}

// One tile along one axis (`_tile_halo`), of the queries in rows [lo, hi)
// (hi < 0: the whole axis). Halo indices count from h0.
struct AxisTile {
  int m;        // residue class
  int sub_len;  // length of its sub-grid
  int q0;       // sub-grid index of the tile's first query
  int nq;       // the tile's queries on this axis (< 1: no query, the block exits)
  int len;      // window length, min(kernel, sub_len)
  int h0;       // sub-grid index of the halo's first key
  int n;        // halo length
  int rep;      // halo index of the key each window repeats, -1 if none
  int cnt;      // how often each window holds it
};

__device__ __forceinline__ AxisTile axis_tile(int size, int kernel, int dilation, int m, int tile, int lo = 0,
                                              int hi = -1) {
  AxisTile a;
  a.m = m;
  a.sub_len = (size - m + dilation - 1) / dilation;
  // the sub-grid indices of the residue class's rows in [lo, hi): [first, end)
  int first = 0, end = a.sub_len;
  if (hi >= 0) {
    first = (lo - m + dilation - 1) / dilation;
    end = (hi - m + dilation - 1) / dilation;
  }
  a.q0 = first + tile * TQ;
  a.nq = min(TQ, end - a.q0);
  a.len = min(kernel, a.sub_len);
  a.h0 = window_start(a.q0, a.sub_len, kernel);
  a.n = window_start(a.q0 + a.nq - 1, a.sub_len, kernel) + a.len - a.h0;
  a.rep = a.sub_len < kernel ? a.sub_len - 1 - a.h0 : -1;
  a.cnt = kernel - a.sub_len + 1;
  return a;
}

// The window of the tile's t-th query on one axis (past the tile's edge, its
// last query): halo index of the first key, and the bias index of halo key 0
// (halo key e has bias index rel + e).
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
  const void* q;
  const void* k;
  const void* v;
  const void* rpb;
  void* out;
  int H, W, NH;
  long long sb, sh, sw, sn;
  int kernel, dilation;
  float scale;
  int res_h, res_w;      // residue classes per axis, min(dilation, rows)
  int tiles_h, tiles_w;  // tiles per residue class, from its most rows
  int halo_max;          // K and V rows in shared memory, for the longest halo
  int span;              // 2 * kernel - 1
};

// The query rows of a call: [lo, hi) of the whole map's H (a separate kernel
// argument: a field more in Params made the bf16 kernel spill)
struct Rows {
  int lo, hi;
};

// The block's (b, head) and its tile on each axis; false if it holds no query.
// Under a row window its row residue class counts from the window's first row.
template <bool kWindow>
__device__ __forceinline__ bool block_tile(const Params& p, const Rows& rows, int& b, int& n, AxisTile& th,
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
  if (kWindow)
    th = axis_tile(p.H, p.kernel, p.dilation, (rows.lo + mh) % p.dilation, tile_h, rows.lo, rows.hi);
  else
    th = axis_tile(p.H, p.kernel, p.dilation, mh, tile_h);
  tw = axis_tile(p.W, p.kernel, p.dilation, mw, tile_w);
  return th.nq > 0 && tw.nq > 0;
}

__device__ __forceinline__ long long pixel(const Params& p, const AxisTile& th, int sub_h, const AxisTile& tw,
                                           int sub_w) {
  return (long long)(sub_h * p.dilation + th.m) * p.sh + (long long)(sub_w * p.dilation + tw.m) * p.sw;
}

__host__ __device__ constexpr int bias_bytes(int span) { return (span * span * 4 + 15) / 16 * 16; }

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// (a, b) as a bf16 pair hi plus the bf16 pair lo of what hi leaves out
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// 2^x on the SFU (rel. error ~2^-22, far below a bf16 ulp); 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// q * scale rounded to bf16, as the module scales it, on a fragment register
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return bf16x2_bits(__floats2bfloat162_rn(f.x * scale, f.y * scale));
}

// ----------------------------------------------------------- block set-up
// cp.async of the halo's K and V rows (row pitch ROW bytes) and the bias
// table of head n as floats; the caller commits and waits.
template <typename T>
__device__ __forceinline__ void load_halo(const Params& p, long long base, int n, const AxisTile& th,
                                          const AxisTile& tw, int pitch, unsigned char* ks, unsigned char* vs,
                                          float* bias, float bias_scale) {
  constexpr int CPR = DH * (int)sizeof(T) / 16;  // 16-byte copies per row
  constexpr int ROW = DH * (int)sizeof(T) + 16;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  constexpr int STEP = kThreads / CPR;  // halo entries a pass of the block copies
  // this thread's 16 bytes of entries e, e + STEP, ... (row-major over the
  // halo), addresses advanced by adds: (hh, ww) moves STEP entries a pass
  int e = threadIdx.x / CPR, ww = e % tw.n;
  const int i = threadIdx.x % CPR, step_w = STEP % tw.n, step_h = STEP / tw.n;
  const long long dh = (long long)p.dilation * p.sh, dw = (long long)p.dilation * p.sw;
  const long long off_step = step_h * dh + step_w * dw, off_wrap = dh - tw.n * dw;
  const int dst_step = (step_h * pitch + step_w) * ROW, dst_wrap = (pitch - tw.n) * ROW;
  long long off = pixel(p, th, th.h0 + e / tw.n, tw, tw.h0 + ww) + i * (16 / (int)sizeof(T));
  int dst = ((e / tw.n) * pitch + ww) * ROW + i * 16;
  for (; e < th.n * tw.n; e += STEP) {
    cp_async16(ks + dst, k + off);
    cp_async16(vs + dst, v + off);
    ww += step_w;
    off += off_step;
    dst += dst_step;
    if (ww >= tw.n) {
      ww -= tw.n;
      off += off_wrap;
      dst += dst_wrap;
    }
  }
  const T* rpb = static_cast<const T*>(p.rpb) + (long long)n * p.span * p.span;
  for (int e = threadIdx.x; e < p.span * p.span; e += kThreads) bias[e] = (float)rpb[e] * bias_scale;
}

// the output holds the window's rows only
template <bool kWindow>
__device__ __forceinline__ long long out_row(const Params& p, const Rows& rows, int b, int n, const AxisTile& th,
                                             int sub_h, const AxisTile& tw, int sub_w) {
  const long long row = sub_h * p.dilation + th.m, col = sub_w * p.dilation + tw.m;
  if (kWindow)
    return (((long long)b * (rows.hi - rows.lo) + row - rows.lo) * p.W + col) * p.NH * DH + (long long)n * DH;
  return (((long long)b * p.H + row) * p.W + col) * p.NH * DH + (long long)n * DH;
}

// ------------------------------------------------------------------ bf16
template <bool kWindow>
__global__ void __launch_bounds__(kThreads, 5) na2d_kernel_bf16(const Params p, const Rows win) {
  constexpr int ROW = DH * 2 + 16;  // bytes of a row in shared memory
  int b, n;
  AxisTile th, tw;
  if (!block_tile<kWindow>(p, win, b, n, th, tw)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);  // rpb[head] * log2(e)
  unsigned char* qs = smem + bias_bytes(p.span);  // TQ * TQ query rows, later the output
  unsigned char* ks = qs + TQ * TQ * ROW;
  unsigned char* vs = ks + p.halo_max * ROW;
  // halo entries a row in shared memory: odd, so that 8 rows of one column
  // (an ldmatrix) fall in 8 different bank groups
  const int pitch = tw.n | 1;

  const long long base = (long long)b * p.sb + (long long)n * p.sn;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + base;
  // every slot of the tile; those past its edge repeat its last query
  for (int c = threadIdx.x; c < TQ * TQ * 4; c += kThreads) {
    const int slot = c / 4, i = c % 4;
    const int r = min(slot / TQ, th.nq - 1), col = min(slot % TQ, tw.nq - 1);
    cp_async16(qs + slot * ROW + i * 16, q + pixel(p, th, th.q0 + r, tw, tw.q0 + col) + i * 8);
  }
  load_halo<__nv_bfloat16>(p, base, n, th, tw, pitch, ks, vs, bias, kLog2e);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int r0 = 2 * warp;  // tile row of mma rows 0-7 (row r0 + 1: mma rows 8-15)
  if (r0 >= th.nq) return;
  const int kernel = p.kernel, span = p.span;

  // Q fragments for the two k16 steps of dh, scaled and rounded to bf16
  uint32_t qa[2][4];
  {
    const uint32_t a = smem_addr(qs) + (16 * warp + lane % 16) * ROW + (lane / 16) * 16;
    ldmatrix_x4(qa[0], a);
    ldmatrix_x4(qa[1], a + 32);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[s][i] = scale_bf16x2(qa[s][i], p.scale);
  }
  // this lane's two queries: tile rows r0 and r0 + 1, column g
  const AxisQuery qh[2] = {axis_query(th, r0, kernel), axis_query(th, r0 + 1, kernel)};
  const AxisQuery qw = axis_query(tw, g, kernel);
  // the warp's keys: halo rows [kr_lo, kr_hi) x columns [cw_lo, cw_hi) (all of the tile's)
  const int kr_lo = qh[0].lo, kr_hi = qh[1].lo + th.len;
  const int cw_lo = axis_query(tw, 0, kernel).lo, cw_hi = axis_query(tw, TQ - 1, kernel).lo + tw.len;
  const bool repeats = th.rep >= 0 || tw.rep >= 0;  // the same for the whole block

  float o[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  // An n8 tile of keys is 8 halo rows of one column: rows rg .. rg + 7 (at
  // k <= 7 one group holds both query rows' windows). In the C fragment this
  // lane holds keys rg + 2 tq + j (j = 0, 1) of each tile, so their row tests,
  // bias rows and counts are fixed for the group.
  for (int rg = kr_lo; rg < kr_hi; rg += 8) {
    uint32_t row_in = 0;  // bit 2 r + j: key row rg + 2 tq + j inside query r's window
    int brow[2][2];       // bias index of that key in halo column 0 (add the column)
    float ch[2];          // its row's repeat count
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kr = rg + 2 * tq + j;
      ch[j] = kr == th.rep ? (float)th.cnt : 1.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_in |= (uint32_t)((unsigned)(kr - qh[r].lo) < (unsigned)th.len) << (2 * r + j);
        brow[r][j] = (kr + qh[r].rel) * span + qw.rel;
      }
    }
    // this lane's ldmatrix row (key rg + lane % 8; past the halo, its last row)
    const int lrow_k = min(rg + lane % 8, th.n - 1) * pitch;
    const uint32_t kaddr = smem_addr(ks) + lrow_k * ROW + (lane / 8) * 16;
    const uint32_t vaddr = smem_addr(vs) + lrow_k * ROW + (lane / 16) * 16;

    for (int c0 = cw_lo; c0 < cw_hi; c0 += kChunk) {
      // S = Q K^T over kChunk columns, masked, biased, in log2 units
      float s[kChunk][4];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int c = c0 + t;
        const bool active = c < cw_hi;  // the same for the whole warp
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
        if (active) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kaddr + c * ROW);
          mma_bf16(s[t], qa[0], kb[0], kb[1]);
          mma_bf16(s[t], qa[1], kb[2], kb[3]);
        }
        const bool col_in = active && (unsigned)(c - qw.lo) < (unsigned)tw.len;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = col_in && (row_in >> e & 1u);
          const float bv = bias[valid ? brow[e / 2][e % 2] + c : 0];
          s[t][e] = valid ? fmaf(s[t][e], kLog2e, bv) : -INFINITY;
        }
      }
      // online softmax: row max over the quad, rescale what was summed
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mnew = fmaxf(mrow[r], mx);
        const float base = mnew == -INFINITY ? 0.f : mnew;
        const float alpha = exp2_approx(mrow[r] - base);  // 0 while nothing was summed
        mrow[r] = mnew;
        lrow[r] *= alpha;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          o[t][2 * r] *= alpha;
          o[t][2 * r + 1] *= alpha;
        }
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          s[t][2 * r] = exp2_approx(s[t][2 * r] - base);
          s[t][2 * r + 1] = exp2_approx(s[t][2 * r + 1] - base);
        }
      }
      // each key weighted by how often a window lists it (short sub-grids only)
      if (repeats) {
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const float cw = c0 + t == tw.rep ? (float)tw.cnt : 1.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] *= ch[e % 2] * cw;
        }
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        lrow[0] += s[t][0] + s[t][1];
        lrow[1] += s[t][2] + s[t][3];
      }
      // O += P V, P as bf16 hi + lo; a k16 step is columns c0 + 2j and c0 + 2j + 1
#pragma unroll
      for (int j = 0; j < kChunk / 2; ++j) {
        const int c = c0 + 2 * j;
        if (c >= cw_hi) continue;
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * j][0], s[2 * j][1], hi[0], lo[0]);
        split_bf16(s[2 * j][2], s[2 * j][3], hi[1], lo[1]);
        split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], hi[3], lo[3]);
        // lanes 8-15 and 24-31 address the second column; past the halo, its last
        const uint32_t va = vaddr + min(c + lane / 8 % 2, tw.n - 1) * ROW;
        uint32_t vb[8];
        ldmatrix_x4_trans(vb, va);           // dh 0-15
        ldmatrix_x4_trans(vb + 4, va + 32);  // dh 16-31
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          mma_bf16(o[t], hi, vb[2 * t], vb[2 * t + 1]);
          mma_bf16(o[t], lo, vb[2 * t], vb[2 * t + 1]);
        }
      }
    }
  }

  // normalise, round once, stage in the warp's own Q rows, store 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lrow[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
  __syncwarp();
  unsigned char* rows = qs + 16 * warp * ROW;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(rows + (8 * r + g) * ROW + (8 * t + 2 * tq) * 2) =
          __floats2bfloat162_rn(o[t][2 * r] * inv[r], o[t][2 * r + 1] * inv[r]);
  __syncwarp();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int c = lane; c < 16 * 4; c += 32) {
    const int slot = c / 4, i = c % 4;
    const int r = r0 + slot / TQ, col = slot % TQ;
    if (r < th.nq && col < tw.nq)
      *reinterpret_cast<uint4*>(out + out_row<kWindow>(p, win, b, n, th, th.q0 + r, tw, tw.q0 + col) + i * 8) =
          *reinterpret_cast<const uint4*>(rows + slot * ROW + i * 16);
  }
}

// ------------------------------------------------------------------ fp32
// lse: each query's log-sum-exp, or null (a separate argument, so that the
// bf16 kernel's Params and code stay as they were: it sits at its register
// limit)
template <bool kWindow>
__global__ void __launch_bounds__(kThreads) na2d_kernel_fp32(const Params p, float* lse, const Rows win) {
  constexpr int ROW = DH * 4 + 16;
  constexpr int HALF = DH / 2;  // the dims a thread owns
  int b, n;
  AxisTile th, tw;
  if (!block_tile<kWindow>(p, win, b, n, th, tw)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);
  unsigned char* ks = smem + bias_bytes(p.span);
  unsigned char* vs = ks + p.halo_max * ROW;

  const long long base = (long long)b * p.sb + (long long)n * p.sn;
  load_halo<float>(p, base, n, th, tw, tw.n, ks, vs, bias, 1.f);
  cp_async_wait_all();
  __syncthreads();

  if (2 * (threadIdx.x / 32) >= th.nq) return;  // a warp owns two tile rows
  const int slot = threadIdx.x / 2, half = threadIdx.x % 2;
  const int tr = slot / TQ, tc = slot % TQ;  // past the tile's edge: its last query again
  const int kernel = p.kernel, span = p.span;
  const AxisQuery qh = axis_query(th, tr, kernel), qw = axis_query(tw, tc, kernel);

  float qf[HALF];
  {
    const float* q = static_cast<const float*>(p.q) + base +
                     pixel(p, th, th.q0 + min(tr, th.nq - 1), tw, tw.q0 + min(tc, tw.nq - 1)) + half * HALF;
#pragma unroll
    for (int c = 0; c < HALF / 4; ++c) {
      const float4 x = reinterpret_cast<const float4*>(q)[c];
      qf[4 * c] = x.x * p.scale;
      qf[4 * c + 1] = x.y * p.scale;
      qf[4 * c + 2] = x.z * p.scale;
      qf[4 * c + 3] = x.w * p.scale;
    }
  }
  float acc[HALF];
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
  float mx = -INFINITY, sum = 0.f;

  for (int a = 0; a < th.len; ++a) {
    const int kr = qh.lo + a;
    const float ch = kr == th.rep ? (float)th.cnt : 1.f;
    const float* brow = bias + (kr + qh.rel) * span + qw.rel;
    for (int c = 0; c < tw.len; ++c) {
      const int ww = qw.lo + c;
      const int e = kr * tw.n + ww;
      const float4* kp = reinterpret_cast<const float4*>(ks + e * ROW) + half * (HALF / 4);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < HALF / 4; ++i) {
        const float4 x = kp[i];
        s = fmaf(qf[4 * i], x.x, s);
        s = fmaf(qf[4 * i + 1], x.y, s);
        s = fmaf(qf[4 * i + 2], x.z, s);
        s = fmaf(qf[4 * i + 3], x.w, s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);  // the other half; the same sum in both lanes
      s += brow[ww];
      if (s > mx) {  // a new running max: rescale what was summed
        const float f = expf(mx - s);
        sum *= f;
#pragma unroll
        for (int d = 0; d < HALF; ++d) acc[d] *= f;
        mx = s;
      }
      const float w = ch * (ww == tw.rep ? (float)tw.cnt : 1.f) * expf(s - mx);
      sum += w;
      const float4* vp = reinterpret_cast<const float4*>(vs + e * ROW) + half * (HALF / 4);
#pragma unroll
      for (int i = 0; i < HALF / 4; ++i) {
        const float4 x = vp[i];
        acc[4 * i] = fmaf(w, x.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
      }
    }
  }
  if (tr < th.nq && tc < tw.nq) {
    const float inv = 1.f / sum;
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.out) +
                                          out_row<kWindow>(p, win, b, n, th, th.q0 + tr, tw, tw.q0 + tc) + half * HALF);
#pragma unroll
    for (int i = 0; i < HALF / 4; ++i)
      o[i] = make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv, acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
    if (lse != nullptr && half == 0)  // K5's softmax statistics: the window walk's max and sum
      lse[out_row<kWindow>(p, win, b, n, th, th.q0 + tr, tw, tw.q0 + tc) / DH] = mx + logf(sum);
  }
}

// The launch for the query rows [row_lo, row_hi) of a map of H rows: its
// Params, grid and dynamic shared memory; false if the shapes are refused.
bool plan(int B, int H, int W, int NH, int kernel, int dilation, int is_bf16, int row_lo, int row_hi, Params& p,
          long long& blocks, int& smem) {
  if (B < 0 || H < 0 || W < 0 || NH < 1 || kernel < 1 || dilation < 1) return false;
  if (row_lo < 0 || row_hi < row_lo || row_hi > H) return false;
  const int rows = row_hi - row_lo;
  p.H = H;
  p.W = W;
  p.NH = NH;
  p.kernel = kernel;
  p.dilation = dilation;
  p.res_h = dilation < rows ? dilation : rows;
  p.res_w = dilation < W ? dilation : W;
  p.tiles_h = ((rows + dilation - 1) / dilation + TQ - 1) / TQ;
  p.tiles_w = ((W + dilation - 1) / dilation + TQ - 1) / TQ;
  const int halo = TQ + kernel - 1;  // the longest halo side
  p.halo_max = halo * (is_bf16 ? halo | 1 : halo);  // bf16 keeps halo rows at an odd pitch
  p.span = 2 * kernel - 1;
  const int row = is_bf16 ? DH * 2 + 16 : DH * 4 + 16;
  smem = bias_bytes(p.span) + (is_bf16 ? TQ * TQ * row : 0) + 2 * p.halo_max * row;
  blocks = (long long)B * p.res_h * p.res_w * p.tiles_h * p.tiles_w * NH;
  return smem <= kMaxSmem && blocks <= 0x7fffffffLL;
}

}  // namespace

// The launch K4 makes for the query rows [row_lo, row_hi) of these shapes
// (the whole map: [0, H)): blocks, threads a block and dynamic shared memory
// a block (bytes). Returns 0, or cudaErrorInvalidValue for shapes it refuses.
extern "C" int na2d_launch_shape(int B, int H, int W, int NH, int kernel, int dilation, int is_bf16, int row_lo,
                                 int row_hi, long long* blocks, int* threads, int* smem) {
  Params p;
  if (!plan(B, H, W, NH, kernel, dilation, is_bf16, row_lo, row_hi, p, *blocks, *smem))
    return (int)cudaErrorInvalidValue;
  *threads = kThreads;
  return 0;
}

// Neighborhood attention forward for the query rows [row_lo, row_hi) of a
// map of H rows (q, k and v addressed from the map's row 0: see the row
// window above). The wrapper checks shapes, dtypes, the head dim (32), shared
// strides with a contiguous last dim, for the vector reads 16-byte alignment,
// and that the rows it holds of k and v cover every window of the queries.
// `lse` (fp32 only) may be null.
extern "C" int na2d_forward(const void* q, const void* k, const void* v, const void* rpb, void* out, float* lse,
                            int B, int H, int W, int NH, int head_dim, long long sb, long long sh, long long sw,
                            long long sn, int kernel, int dilation, float scale, int is_bf16, int row_lo,
                            int row_hi, void* stream) {
  Params p;
  long long blocks;
  int smem;
  if (head_dim != DH || (is_bf16 && lse != nullptr) ||
      !plan(B, H, W, NH, kernel, dilation, is_bf16, row_lo, row_hi, p, blocks, smem))
    return (int)cudaErrorInvalidValue;
  const Rows win = {row_lo, row_hi};
  const bool window = row_lo > 0 || row_hi < H;
  if (blocks == 0) return 0;
  p.q = q;
  p.k = k;
  p.v = v;
  p.rpb = rpb;
  p.out = out;
  p.sb = sb;
  p.sh = sh;
  p.sw = sw;
  p.sn = sn;
  p.scale = scale;
  const void* fn = is_bf16 ? (window ? (const void*)na2d_kernel_bf16<true> : (const void*)na2d_kernel_bf16<false>)
                           : (window ? (const void*)na2d_kernel_fp32<true> : (const void*)na2d_kernel_fp32<false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (is_bf16 && window)
    na2d_kernel_bf16<true><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(p, win);
  else if (is_bf16)
    na2d_kernel_bf16<false><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(p, win);
  else if (window)
    na2d_kernel_fp32<true><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(p, lse, win);
  else
    na2d_kernel_fp32<false><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(p, lse, win);
  return (int)cudaGetLastError();
}
