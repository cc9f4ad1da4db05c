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
// 3.35 TB/s) but does ~(2K + 20) * Q * H * W ~ 18 GFLOP. All on CUDA cores
// that is ~0.27 ms at 67 TFLOP/s; with the semantic product (2K of the
// 2K + 20 per pixel and query) on TF32 tensor cores the rest, ~6.3 GFLOP of
// upsample, sigmoid, argmax and per-query work, sets the bound at ~0.09 ms.
//
// Design. A block of 256 threads owns a tile of 4 output rows x 64
// columns, one pixel per thread, and walks the queries in chunks of 32. It
// has 3 blocks on each SM (80 registers a thread, ~53 KB of shared memory).
//   * the chunk's source patch, (4/4 + 2) x (64/4 + 2) bf16 per query, is
//     staged in shared memory with the edge clamp applied while staging,
//     two queries to a 32-bit word (plain loads: a patch row is 36 bytes at
//     an odd source column, which cp.async cannot copy);
//   * the y-blend is computed once per (query, output row, source column)
//     and reused by the 4 output columns that share it; it and the x-blend
//     run two queries at a time in bf16x2 (mul.rn / add.rn), which equals
//     the reference's fp32 op rounded to bf16 (24 >= 2 * 8 + 2 bits make the
//     double rounding innocuous);
//   * the sigmoid is __fdividef(1, 1 + __expf(-x)), within a few ulp of the
//     accurate form; on the card the maps' mismatch against the plain
//     version did not change (PERF.md). It goes to a shared
//     (query x pixel) fp32 tile;
//   * the thread that owns a pixel keeps its panoptic winner over queries in
//     registers; each warp, one row segment of 32 pixels, stores the
//     logit >= 0 and logit > 0 masks as ballot words per query. The sign of a
//     logit is kept this way because the sigmoid cannot give it back (it
//     rounds to 0.5 for tiny negative logits);
//   * the semantic product runs on tensor cores: mma.sync m16n8k8 TF32 with
//     the sigmoid tile (a warp's 32 pixels x the chunk's queries, rounded
//     with cvt.rna) as A and clsprob (queries x classes in tiles of 8,
//     rounded with cvt.rna) as B; the fp32 accumulators stay in registers
//     across the query chunks, then the argmax over classes (ties to the
//     lowest index) takes shuffles. Up to 32 classes are one group; more
//     loop over groups of 32, recomputing the sigmoids;
//   * after each chunk one warp per query reduces that query's words and
//     sigmoids: areas with __popc, the box with __ffs / __clz, the sigmoid
//     sum inside the strict mask in a fixed order (skipped where the strict
//     mask misses the tile). Win and final areas come from the per-pixel
//     winners at the end.
// Determinism: integer areas and boxes use integer atomics (order-free); the
// float sigmoid sums are fixed-order per-block partials, summed over blocks
// in a fixed order by a second kernel (a warp per query). Reruns are
// byte-identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileW = 64;                 // output columns per block
constexpr int kTileH = 4;                  // output rows per block
constexpr int kPix = kTileW * kTileH;      // 256 pixels, one per thread
constexpr int kQC = 32;                    // queries per chunk (4 mma k-steps)
constexpr int kSrcW = kTileW / 4 + 2;      // source patch columns
constexpr int kSrcH = kTileH / 4 + 2;      // source patch rows
constexpr int kSigStride = kPix + 8;       // 8 mod 32: conflict-free B-fragment reads
constexpr int kClsStride = 40;             // 8 mod 32: conflict-free A-fragment reads
constexpr int kWords = kPix / 32;          // ballot words per query, one per warp
constexpr int kPatch = kQC * kSrcH * kSrcW;  // staged bf16 per chunk
constexpr int kMT = 32 / 16;               // mma m-tiles per warp: its 32 pixels
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTileW == 64 && kPix == kThreads, "pixel <-> thread mapping assumes 64-column tiles");

// per-query integer slots in global memory
enum { kWin = 0, kBin, kFinal, kStrict, kXmin, kYmin, kXmax, kYmax, kSlots };

// bf16x2 in a 32-bit word, low half first; correctly rounded ops (sm_90)
__device__ __forceinline__ uint32_t bf16x2(float x) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return b | (b << 16);
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// first-tap weight of output phase j = r & 3 of a 4x upsample
__device__ __forceinline__ float tap_w0(int j) {
  return 0.375f + (float)(j >> 1) * 0.5f - (float)(j & 1) * 0.25f;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void init_kernel(int* slots, int Q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q * kSlots) return;
  const int s = i / Q;
  slots[i] = (s == kXmin || s == kYmin) ? INT_MAX : (s == kXmax || s == kYmax) ? INT_MIN : 0;
}

// NC n8 tiles of classes per group: 8 * NC classes
template <int NC>
__global__ void __launch_bounds__(kThreads, 3) fused_kernel(
    const __nv_bfloat16* __restrict__ masks,  // (Q, h, w)
    const float* __restrict__ clsprob,        // (Q, K)
    const float* __restrict__ ks,             // (Q,)
    const float* __restrict__ off,            // (Q,)
    int Q, int K, int h, int w,
    uint8_t* __restrict__ sem,                // (4h, 4w)
    uint8_t* __restrict__ ids,                // (4h, 4w)
    int* __restrict__ slots,                  // (kSlots, Q)
    float* __restrict__ sig_partial) {        // (n_blocks, Q)
  constexpr int kGroup = 8 * NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Qp = (Q + 1) & ~1;
  uint32_t* s_cls = (uint32_t*)smem_raw;                     // kQC x kClsStride, tf32 bits
  float* s_sig = (float*)(s_cls + kQC * kClsStride);         // kQC x kSigStride
  uint32_t* s_yb = (uint32_t*)(s_sig + kQC * kSigStride);    // kQC/2 x kTileH x kSrcW bf16x2
  float* s_semv = (float*)(s_yb + kQC / 2 * kTileH * kSrcW);  // kPix
  int* s_sema = (int*)(s_semv + kPix);                       // kPix
  unsigned* s_bin = (unsigned*)(s_sema + kPix);              // kQC x kWords
  unsigned* s_strict = s_bin + kQC * kWords;                 // kQC x kWords
  float* s_ks = (float*)(s_strict + kQC * kWords);           // Qp
  float* s_off = s_ks + Qp;                                  // Qp
  int* s_win = (int*)(s_off + Qp);                           // Qp
  int* s_final = s_win + Qp;                                 // Qp
  __nv_bfloat16* s_patch = (__nv_bfloat16*)(s_final + Qp);   // kQC/2 x kSrcH x kSrcW bf16x2
  const uint32_t* s_patch2 = (const uint32_t*)s_patch;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int H = 4 * h, W = 4 * w;
  const int X0 = blockIdx.x * kTileW, Y0 = blockIdx.y * kTileH;
  const int sx0 = X0 / 4 - 1, sy0 = Y0 / 4 - 1;  // source column / row of patch index 0
  const int hw = h * w;
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;

  for (int i = tid; i < Qp; i += kThreads) {
    s_ks[i] = i < Q ? ks[i] : 0.f;
    s_off[i] = i < Q ? off[i] : 0.f;
    s_win[i] = 0;
    s_final[i] = 0;
  }

  // the chunk's inputs: the source patch, edge-clamped, element (ql, r, c)
  // at s_patch2[(ql / 2, r, c)] half ql & 1 so that one 32-bit word holds a
  // query pair; and the chunk's class probabilities of the group
  auto stage = [&](int q0, int k0) {
    for (int i = tid; i < kPatch; i += kThreads) {
      const int ql = i / (kSrcH * kSrcW), rc = i - ql * (kSrcH * kSrcW);
      const int r = rc / kSrcW, c = rc - r * kSrcW;
      const int q = q0 + ql;
      const __nv_bfloat16* src = masks + (long long)min(q, Q - 1) * hw +
                                 min(max(sy0 + r, 0), h - 1) * w + min(max(sx0 + c, 0), w - 1);
      s_patch[((ql >> 1) * kSrcH * kSrcW + rc) * 2 + (ql & 1)] = q < Q ? *src : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < kQC * kGroup; i += kThreads) {
      const int ql = i / kGroup, c = i - ql * kGroup;
      const int q = q0 + ql;
      const float v = (q < Q && k0 + c < K) ? clsprob[q * K + k0 + c] : 0.f;
      s_cls[ql * kClsStride + c] = to_tf32(v);
    }
  };

  // this thread's pixel p = tid: row p / 64, column p % 64, and its x taps
  // (patch column, weights packed for both queries of a pair)
  const int p = tid;
  const int prow = p >> 6, pcol = p & 63;
  const int pca = (pcol >> 2) + ((pcol & 3) >> 1);
  const uint32_t pwx0 = bf16x2(tap_w0(pcol & 3)), pwx1 = bf16x2(1.f - tap_w0(pcol & 3));
  const bool pin = X0 + pcol < W && Y0 + prow < H;
  float pan_best = -INFINITY, pan_logit = 0.f;
  int pan_arg = 0;

  const int n_groups = (K + kGroup - 1) / kGroup;
  for (int g = 0; g < n_groups; ++g) {
    const int k0 = g * kGroup;
    const bool first = g == 0;

    float acc[kMT][NC][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NC; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int q0 = 0; q0 < Q; q0 += kQC) {
      // every reader of the shared tiles from the previous chunk passed the
      // barrier after its x-blend or the one below
      __syncthreads();
      stage(q0, k0);
      __syncthreads();

      // ---- y-blend, once per (query pair, output row, source column), in
      // bf16x2: a correctly rounded bf16 op equals the fp32 op rounded to
      // bf16, since 24 >= 2 * 8 + 2 bits make the double rounding innocuous
      for (int i = tid; i < (kQC / 2) * kTileH * kSrcW; i += kThreads) {
        const int pq = i / (kTileH * kSrcW), rest = i - pq * (kTileH * kSrcW);
        const int yl = rest / kSrcW, c = rest - yl * kSrcW;
        const int j = yl & 3;  // Y0 % 4 == 0
        const int r = (yl >> 2) + (j >> 1);
        const uint32_t a0 = s_patch2[(pq * kSrcH + r) * kSrcW + c];
        const uint32_t a1 = s_patch2[(pq * kSrcH + r + 1) * kSrcW + c];
        s_yb[i] = add_bf16x2(mul_bf16x2(a0, bf16x2(tap_w0(j))), mul_bf16x2(a1, bf16x2(1.f - tap_w0(j))));
      }
      __syncthreads();

      // ---- x-blend, sigmoid, panoptic winner, sign words; a query pair
      // at a time
#pragma unroll 4
      for (int pq = 0; pq < kQC / 2; ++pq) {
        const int qa = q0 + 2 * pq;
        const float2 ks2 = *reinterpret_cast<const float2*>(s_ks + min(qa, Qp - 2));
        const float2 off2 = *reinterpret_cast<const float2*>(s_off + min(qa, Qp - 2));
        const uint32_t* yb = s_yb + (pq * kTileH + prow) * kSrcW + pca;
        const uint32_t l2 = add_bf16x2(mul_bf16x2(yb[0], pwx0), mul_bf16x2(yb[1], pwx1));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = qa + e;
          const bool valid = q < Q;
          const float logit = __uint_as_float(e ? (l2 & 0xffff0000u) : (l2 << 16));
          // fast exp and divide: within a few ulp of 1 / (1 + expf(-x)),
          // which the map mismatch against the plain version absorbs
          const float sg = __fdividef(1.f, 1.f + __expf(-logit));
          s_sig[(2 * pq + e) * kSigStride + p] = valid ? sg : 0.f;
          if (first) {  // block-uniform
            const float pr = sg * (e ? ks2.y : ks2.x) + (e ? off2.y : off2.x);
            if (valid && pr > pan_best) {
              pan_best = pr;
              pan_arg = q;
              pan_logit = logit;
            }
            const unsigned bin = __ballot_sync(kFull, valid && pin && logit >= 0.f);
            const unsigned strict = __ballot_sync(kFull, valid && pin && logit > 0.f);
            if (lane == 0) {
              s_bin[(2 * pq + e) * kWords + warp] = bin;
              s_strict[(2 * pq + e) * kWords + warp] = strict;
            }
          }
        }
      }
      __syncthreads();

      // ---- semantic product on tensor cores: acc += sig^T (this warp's 32
      // pixels x the chunk's queries) . clsprob (those queries x the group's classes)
#pragma unroll
      for (int kk = 0; kk < kQC / 8; ++kk) {
        const int qa = kk * 8 + tig;
        uint32_t a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float* sa = s_sig + qa * kSigStride + warp * 32 + mt * 16 + gid;
          a[mt][0] = to_tf32(sa[0]);
          a[mt][1] = to_tf32(sa[8]);
          a[mt][2] = to_tf32(sa[4 * kSigStride]);
          a[mt][3] = to_tf32(sa[4 * kSigStride + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < NC; ++nt) {
          const uint32_t b0 = s_cls[qa * kClsStride + nt * 8 + gid];
          const uint32_t b1 = s_cls[(qa + 4) * kClsStride + nt * 8 + gid];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[mt][nt], a[mt], b0, b1);
        }
      }

      // ---- per-query reductions of this chunk: one warp per query
      if (first) {
        for (int ql = warp; ql < kQC; ql += kWarps) {
          const int q = q0 + ql;
          if (q >= Q) break;  // warp-uniform
          const unsigned sw = lane < kWords ? s_strict[ql * kWords + lane] : 0u;
          const unsigned bw = lane < kWords ? s_bin[ql * kWords + lane] : 0u;
          const int n_strict = warp_sum(__popc(sw));
          const int n_bin = warp_sum(__popc(bw));
          if (lane == 0 && n_bin) atomicAdd(&slots[kBin * Q + q], n_bin);
          if (n_strict == 0) {  // warp-uniform: most queries miss most tiles
            if (lane == 0) sig_partial[blk * Q + q] = 0.f;
            continue;
          }
          int xmin = INT_MAX, ymin = INT_MAX, xmax = INT_MIN, ymax = INT_MIN;
          if (sw) {  // word `lane` covers row lane / 2, columns (lane & 1) * 32 + bit
            const int cb = X0 + (lane & 1) * 32;
            xmin = cb + __ffs(sw) - 1;
            xmax = cb + 31 - __clz(sw);
            ymin = ymax = Y0 + (lane >> 1);
          }
          // sigmoid sum inside the strict mask: lane sums its bit of each
          // word in word order, then a fixed butterfly
          float s = 0.f;
#pragma unroll
          for (int wi = 0; wi < kWords; ++wi) {
            if ((s_strict[ql * kWords + wi] >> lane) & 1u) s += s_sig[ql * kSigStride + wi * 32 + lane];
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            s += __shfl_xor_sync(kFull, s, o);
            xmin = min(xmin, __shfl_xor_sync(kFull, xmin, o));
            ymin = min(ymin, __shfl_xor_sync(kFull, ymin, o));
            xmax = max(xmax, __shfl_xor_sync(kFull, xmax, o));
            ymax = max(ymax, __shfl_xor_sync(kFull, ymax, o));
          }
          if (lane == 0) {
            sig_partial[blk * Q + q] = s;
            atomicAdd(&slots[kStrict * Q + q], n_strict);
            atomicMin(&slots[kXmin * Q + q], xmin);
            atomicMin(&slots[kYmin * Q + q], ymin);
            atomicMax(&slots[kXmax * Q + q], xmax);
            atomicMax(&slots[kYmax * Q + q], ymax);
          }
        }
      }
    }

    // ---- argmax over this group's classes, per pixel; ties to the lowest
    // index. Accumulator (mt, nt, half * 2 + e) holds pixel
    // warp*32 + mt*16 + half*8 + gid and class k0 + nt*8 + 2*tig + e.
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float best = -INFINITY;
        int arg = INT_MAX;
#pragma unroll
        for (int nt = 0; nt < NC; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + nt * 8 + 2 * tig + e;
            const float v = acc[mt][nt][half * 2 + e];
            if (c < K && v > best) {
              best = v;
              arg = c;
            }
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ov = __shfl_xor_sync(kFull, best, o);
          const int oa = __shfl_xor_sync(kFull, arg, o);
          if (ov > best || (ov == best && oa < arg)) {
            best = ov;
            arg = oa;
          }
        }
        if (tig == 0) {
          const int px = warp * 32 + mt * 16 + half * 8 + gid;
          if (first || best > s_semv[px]) {  // earlier groups hold lower classes
            s_semv[px] = best;
            s_sema[px] = arg;
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- per-pixel outputs and the win / final areas
  if (pin) {
    const long long pix = (long long)(Y0 + prow) * W + X0 + pcol;
    const bool winbin = pan_logit >= 0.f;
    atomicAdd(&s_win[pan_arg], 1);
    if (winbin) atomicAdd(&s_final[pan_arg], 1);
    sem[pix] = (uint8_t)s_sema[p];
    ids[pix] = (uint8_t)(winbin ? pan_arg : Q);
  }
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads) {
    if (s_win[q]) atomicAdd(&slots[kWin * Q + q], s_win[q]);
    if (s_final[q]) atomicAdd(&slots[kFinal * Q + q], s_final[q]);
  }
}

// fixed-order sum of the per-block partials: one warp per query, lane l
// sums blocks l, l + 32, ... in order, then a fixed butterfly
__global__ void sig_sum_kernel(const float* __restrict__ sig_partial, int n_blocks, int Q,
                               float* __restrict__ sig_sum) {
  const int q = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // whole warps
  float s = 0.f;
  for (int b = lane; b < n_blocks; b += 32) s += sig_partial[(long long)b * Q + q];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (lane == 0) sig_sum[q] = s;
}

template <int NC>
cudaError_t launch_main(dim3 grid, size_t smem, cudaStream_t s, const __nv_bfloat16* masks,
                        const float* clsprob, const float* ks, const float* off, int Q, int K,
                        int h, int w, uint8_t* sem, uint8_t* ids, int* slots, float* partial) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fused_kernel<NC><<<grid, kThreads, smem, s>>>(masks, clsprob, ks, off, Q, K, h, w, sem, ids,
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

extern "C" long long fused_postprocess_smem_bytes(int Q) {
  const long long Qp = (Q + 1) & ~1;
  const long long words = (long long)kQC * kClsStride + (long long)kQC * kSigStride +
                          (long long)kQC / 2 * kTileH * kSrcW + 2LL * kPix + 2LL * kQC * kWords + 4 * Qp;
  return words * 4 + (long long)kPatch * 2;
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
  const size_t smem = (size_t)fused_postprocess_smem_bytes(Q);
  const __nv_bfloat16* m = (const __nv_bfloat16*)masks;
  const float* c = (const float*)clsprob;
  const float* k = (const float*)ks;
  const float* o = (const float*)off;
  uint8_t* sm = (uint8_t*)sem;
  uint8_t* id = (uint8_t*)ids;
  int* sl = (int*)slots;
  float* pp = (float*)sig_partial;
  // classes in groups of 8 * NC: one group up to 32 classes, then groups of 32
  if (K <= 8) e = launch_main<1>(grid, smem, s, m, c, k, o, Q, K, h, w, sm, id, sl, pp);
  else if (K <= 16) e = launch_main<2>(grid, smem, s, m, c, k, o, Q, K, h, w, sm, id, sl, pp);
  else if (K <= 24) e = launch_main<3>(grid, smem, s, m, c, k, o, Q, K, h, w, sm, id, sl, pp);
  else e = launch_main<4>(grid, smem, s, m, c, k, o, Q, K, h, w, sm, id, sl, pp);
  if (e != cudaSuccess) return (int)e;

  sig_sum_kernel<<<(Q + 7) / 8, 256, 0, s>>>(pp, (int)(grid.x * grid.y), Q, (float*)sig_sum);
  return (int)cudaGetLastError();
}
