// Masked cosine top-k scans of the embedding arena, for Hopper (sm_90a): one
// templated scan, in two mask modes. masked_topk.cu exports the additive
// mode and fused_topk.cu the keyed mode; each includes this file.
//
// Additive mode (masked_topk, masked_topk_ragged) replaces the TPU kernels
// lazzaro_tpu/ops/pallas_topk.py:pallas_masked_topk (body _topk_block_kernel)
// and pallas_masked_topk_ragged, with their arena wrappers masked_topk_arena
// and masked_topk_arena_ragged. For every query q and arena row r,
//     s[q, r] = dot_f32(query[q], emb[r]) + madd[r]
// (madd is 0 for live rows and -1e30 for masked ones, added in f32 as the TPU
// kernel does), and the k best (s, r) pairs per query. Rows are i64.
//
// Keyed mode (fused_topk) is the scan of the fused serving path: it keeps the
// contract of pallas_masked_topk_ragged and replaces the XLA scan of the
// fused programs, lazzaro_tpu/core/state.py:_exact_two_tier +
// _ragged_topk_mask. With t_q the query's tenant,
//     s[q, r]   = dot_f32(query[q], emb[r])
//     gate[q]   = top-1 of s over rows with alive & tenant == t_q &  is_super
//     ann[q, :] = top-k of s over rows with alive & tenant == t_q & ~is_super
// where a row outside a tier scores exactly NEG = -1e30 (jnp.where), so a
// tier with fewer matching rows than its k fills its tail with the
// lowest-numbered other rows at NEG, and an empty gate is (NEG, row 0). One
// scan serves a batch of many tenants. Rows are i32.
//
// Both modes: order is score descending, ties to the lowest row (lax.top_k
// and the TPU kernel's first arg-max). With k_q [Q] i32 (the ragged forms)
// positions >= k_q[q] come back as (NEG, tail_row).
//
// Design. Blocks run in parallel on 132 SMs, so the work is cut two ways and
// merged in a second pass:
//   stage 1  grid = (query tiles) x (row splits) x (shard entries): each
//            block scores its queries against a row range of one shard and
//            keeps, per query, its top-kc list (and in keyed mode its gate
//            top-1) of the range, with global rows; on one of three routes,
//            below.
//   stage 2  one block per query merges the splits of every entry: the gate
//            by a block arg-max, the lists by a kc-round head merge, and
//            writes the k_q tail and the columns [kmax, k) as (NEG,
//            tail_row) (with mask_dead also every masked pair).
// A shard table (ShardTable, up to 64 entries in the kernel's parameters)
// lets one launch of each stage scan every shard of a row-sharded arena
// that one card holds: no two (score, global row) keys are equal, so the
// top k of all the shards' rows is the top k of the union of per-shard top
// k lists, ties falling to the lower global row as lax.top_k orders the
// all_gather (lazzaro_tpu/ops/topk.py:make_sharded_topk). A single device
// is a table of one entry.
// kmax is the longest list the caller needs (keyed mode: the largest k_q of
// the batch, as the columns past it are masked whatever is computed there).
// Lists hold at most kc = 128 entries; a larger kmax runs in passes of 128,
// pass p admitting only pairs that rank after the last pair pass p-1 wrote
// (the gate is taken in the first pass). A later pass may start from a
// masked pair, but every position it writes is past k_q too. No scratch is
// allocated here: the caller passes it.
//
// The three stage-1 routes (the wrapper picks one from the dtype, Q and d,
// never from N: the tensor cores for every bf16 arena, the streaming route
// for an f32 arena up to 16 queries where their values fit a lane's
// registers, the FMA route for any other f32 scan; the measured reasons
// are in PERF.md).
//
// Streaming route (scan_stage1_stream, f32, Q <= 16): see its section. At
// Q <= 16 the scan reads every arena row once: the bound is HBM bytes,
// N*d*itemsize (plus 4 B of madd or 6 B of row columns a row) over 3.35
// TB/s, 0.96 ms for 1,048,576 x 768 f32 (0.48 ms in bf16).
//
// FMA route (scan_stage1; f32 scans the streaming route does not take,
// past 16 queries or wider than its registers hold): a block of 4, 8, 16 or
// 64 queries (query_tile) walks its range in tiles of 128 rows with register-tiled f32 FMA dot
// products (16-byte loads, 32-dimension slices in shared memory); the tile's
// masked scores go to shared memory and one warp per query inserts each
// candidate that beats its list's last into the sorted list (rows arrive
// in ascending order, so equal scores keep the lower row), and takes the
// gate as a warp arg-max.
//
// Tensor-core route (scan_stage1_wgmma, bf16): one or two consumer
// warpgroups of 64 queries and a producer warpgroup whose one thread keeps
// TMA loads of (query panel, arena panel) pairs, 64 columns of 128-byte
// swizzled rows each, in an mbarrier ring; the arena tile is wgmma's B
// operand K-major straight from the row-major arena (K in the flash
// forward's Q.K^T), rows past N and columns past d arrive as zeros. Each
// warpgroup runs S = Q.E^T as a chain of SS wgmma m64nBNk16 over d with the
// f32 sums in registers, panel p issued behind panel p - 1, whose stage is
// released once it retires. The mask is applied to the accumulator after
// the product from three row words a tile stages in shared memory (madd's
// bits, or the list-tier and gate keys and the NEG fill), one compare and
// one select a tier; a row past the split's end scores -inf, never a
// candidate. Epilogues:
// - kc = 1 (the dedup probe; lists of one): 256-row tiles, one warpgroup at
//   Q <= 64, two past it (128 queries a block). Each thread keeps the best
//   (score, row) of its two queries across the walk in registers, replaced
//   only on a strictly better score; the quad's four threads are reduced
//   with better() at the end. The keyed gate is the same arg-max in
//   registers. No score tile goes through shared memory.
// - 1 < kc <= 128: 128-row tiles, one warpgroup. Each query keeps a sorted
//   list (kc entries) and a batch in shared memory, as exact 64-bit keys
//   (order-preserving f32 bits over the complement of the row, the key of
//   ops.topk.stable_topk, so no two are equal). A branch-free pass makes a
//   mask of the scores above the query's threshold (its list's last once
//   the list is full) and after the previous pass's last pair; the
//   survivors go to the batch at positions from a quad prefix sum. Once the
//   tile's scores are dead, a batch that could not take another tile, or
//   that can fill a list not yet full, is merged: lists of up to 32 by kc
//   rounds of a warp arg-max, longer ones by a bitonic sort of the batch (a
//   network of 32 to 256 keys) and a merge by rank (binary searches); then
//   the threshold rises to the list's last. A masked row scores NEG and is
//   a candidate like any other, so a tier with fewer rows than kc lists the
//   lowest other rows at NEG, in row order.
// What bounds it, at the smoke's shapes on the 1,048,576 x 768 arena: at Q =
// 64 the arena's 1.61 GB from HBM (0.48 ms; 2 * N * d * Q = 103 GFLOP is
// 0.10 ms at 989 TFLOP/s), so the grid is one wave of single blocks over
// ~131 splits and the ring is as deep as shared memory allows (5 stages of
// 40 KB at kc = 1, 3-5 of 24 KB for lists), the query panels (8 KB a stage)
// coming from L2. At Q = 8,192 it is arithmetic: 13.2 TFLOP, 13.3 ms at the
// bf16 tensor rate. There a block takes 128 queries and 256-row tiles: per
// tile it reads 12 x (16 + 32) KB of panels for 50.3 MFLOP, ~11 KB a MFLOP,
// which at the tensor rate would be 11 TB/s from L2. 64 query tiles x 33
// splits make 16 whole waves, launched query tiles first, so the 64 blocks
// of a split read the same rows together and the arena comes from HBM about
// once; the L2 traffic (~150 GB a scan) is what holds it near half the
// tensor rate.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBR = 128;           // arena rows per tile
constexpr int kDK = 32;            // dimensions per staged slice
constexpr int kLD = kDK + 1;       // padded row stride of the staged slices
constexpr int kMaxK = 128;
constexpr int kMaxSplits = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;     // the masked score (state.NEG_INF)
constexpr int kNoTenant = INT32_MIN;   // key of a dead row: matches no query
constexpr int kMaxShards = 64;         // entries of a shard table

// The arenas one launch scans: entry p is a shard of local_n rows whose
// first row is global row base[p]; words[p] is its madd [local_n] f32
// (additive mode) or row_tenant [local_n] i32 (keyed mode, with alive and
// is_super [local_n] u8). A single-device scan is a table of one entry at
// base 0. Candidates carry global rows, so every entry's blocks feed one
// stage-2 merge.
struct ShardTable {
  const void* emb[kMaxShards];
  const void* words[kMaxShards];
  const uint8_t* alive[kMaxShards];
  const uint8_t* is_super[kMaxShards];
  long long base[kMaxShards];
};

// 8 consecutive elements as f32 (one 16-byte load for bf16, two for f32).
__device__ __forceinline__ void load8(const uint16_t* p, float* out) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// (s, r) ranks before (s2, r2): higher score, then lower row.
__device__ __forceinline__ bool better(float s, int r, float s2, int r2) {
  return s > s2 || (s == s2 && r < r2);
}

// Output row type of a mode: i32 keyed, i64 additive.
template <bool kKeyed>
using RowT = typename std::conditional<kKeyed, int, long long>::type;

// Dynamic shared memory of stage 1 for a query tile of bq and lists of k.
template <bool kKeyed>
size_t stage1_smem(int bq, int k) {
  size_t b = sizeof(float) * ((size_t)(bq + kBR) * kLD + (size_t)bq * (kBR + 1))
             + (sizeof(float) + sizeof(int)) * (size_t)bq * k;
  if (kKeyed) b += (sizeof(float) + 2 * sizeof(int)) * bq + 2 * sizeof(int) * kBR;
  return b;
}

// The f32 sums of the BQ queries q0 .. against the kBR rows r0 .. of a tile
// (rows past r_end and columns past d add zeros), register-tiled: thread
// (tq, tr) of the (BQ/MQ) x (kThreads*MQ/BQ) grid keeps queries tq + i * TQ
// against rows tr + j * TR. Slices of kDK dimensions are staged in qs and
// rs by the whole block, in order, so a row's sum runs over d in order.
template <typename T, int BQ, int MQ, int MR>
__device__ __forceinline__ void fma_tile(float (&acc)[MQ][MR], float* qs, float* rs,
                                         const T* __restrict__ qry, const T* __restrict__ emb,
                                         int q0, int nq, long long r0, long long r_end, int d) {
  constexpr int TQ = BQ / MQ;
  constexpr int TR = kThreads / TQ;
  const int tid = threadIdx.x;
  const int tq = tid / TR;
  const int tr = tid % TR;
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int j = 0; j < MR; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kDK) {
    // Stage the slice: groups of 8 elements, kDK/8 groups per row.
    for (int g = tid; g < (BQ + kBR) * (kDK / 8); g += kThreads) {
      const int row = g / (kDK / 8);
      const int col = (g % (kDK / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float* dst;
      if (row < BQ) {
        const int q = q0 + row;
        if (q < nq && d0 + col < d) load8(qry + (long long)q * d + d0 + col, v);
        dst = qs + row * kLD + col;
      } else {
        const long long r = r0 + (row - BQ);
        if (r < r_end && d0 + col < d) load8(emb + r * d + d0 + col, v);
        dst = rs + (row - BQ) * kLD + col;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = v[e];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDK; ++kk) {
      float a[MQ], b[MR];
#pragma unroll
      for (int i = 0; i < MQ; ++i) a[i] = qs[(tq + i * TQ) * kLD + kk];
#pragma unroll
      for (int j = 0; j < MR; ++j) b[j] = rs[(tr + j * TR) * kLD + kk];
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The whole warp inserts the candidates of its 32 lanes (lane l: score s,
// row row0 + l, where ok) into one query's sorted list (lsq, lrq) of k
// entries, in lane order: each candidate that beats the list's last goes
// after every entry scoring >= it. Rows reach a list in ascending order, so
// equal scores keep the lower row first.
__device__ __forceinline__ void warp_list_insert(float* lsq, int* lrq, int k, float s,
                                                 int row0, bool ok) {
  const int lane = threadIdx.x & 31;
  unsigned hits = __ballot_sync(kFull, ok && s > lsq[k - 1]);
  while (hits) {
    const int src = __ffs(hits) - 1;
    hits &= hits - 1;
    const float sn = __shfl_sync(kFull, s, src);
    if (!(sn > lsq[k - 1])) continue;      // the list moved on
    // Position: after every entry scoring >= sn (all have lower rows).
    int cnt = 0;
    for (int e = lane; e < k; e += 32) cnt += lsq[e] >= sn;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    float vs[kMaxK / 32];
    int vr[kMaxK / 32];
#pragma unroll
    for (int m = 0; m < kMaxK / 32; ++m) {
      const int e = cnt + lane + 32 * m;
      if (e < k - 1) { vs[m] = lsq[e]; vr[m] = lrq[e]; }
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kMaxK / 32; ++m) {
      const int e = cnt + lane + 32 * m;
      if (e < k - 1) { lsq[e + 1] = vs[m]; lrq[e + 1] = vr[m]; }
    }
    __syncwarp();
    if (lane == 0) { lsq[cnt] = sn; lrq[cnt] = row0 + src; }
    __syncwarp();
  }
}

// T: uint16_t (bf16 bits) or float. BQ queries per block, MQ x MR outputs per
// thread; the thread grid is (BQ/MQ) x (kThreads*MQ/BQ) and covers kBR rows.
// Additive mode reads madd; keyed mode reads alive, row_tenant, is_super and
// q_tenant, and takes the gate when with_gate is set.
template <typename T, int BQ, int MQ, int MR, bool kKeyed>
__global__ void __launch_bounds__(kThreads)
scan_stage1(const ShardTable t, const T* __restrict__ qry,
            const int* __restrict__ q_tenant, long long n, int splits, int d,
            int nq, int k, long long rows_per_split, int with_gate,
            const float* __restrict__ after_s,
            const RowT<kKeyed>* __restrict__ after_r, int ld_after,
            float* __restrict__ gate_cs, int* __restrict__ gate_cr,
            float* __restrict__ cand_s, int* __restrict__ cand_r) {
  constexpr int TQ = BQ / MQ;
  constexpr int TR = kThreads / TQ;
  static_assert(TR * MR == kBR, "thread grid must cover one row tile");

  extern __shared__ float smem[];
  float* qs = smem;                          // [BQ][kLD]
  float* rs = qs + BQ * kLD;                 // [kBR][kLD]
  float* sc = rs + kBR * kLD;                // [BQ][kBR + 1] masked scores
  float* ls = sc + BQ * (kBR + 1);           // [BQ][k] list scores
  float* gs = ls + BQ * k;                   // keyed: [BQ] gate score
  int* lr = reinterpret_cast<int*>(gs + (kKeyed ? BQ : 0));  // [BQ][k] rows
  int* gr = lr + BQ * k;                     // keyed: [BQ] gate row
  int* qt = gr + BQ;                         // keyed: [BQ] query tenant
  int* rkey = qt + BQ;                       // keyed: [kBR] row tenant or none
  int* rsup = rkey + kBR;                    // keyed: [kBR] row is a super node

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tq = tid / TR;
  const int tr = tid % TR;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int p = blockIdx.z;                  // shard entry; n rows each
  const T* __restrict__ emb = static_cast<const T*>(t.emb[p]);
  const float* __restrict__ madd = static_cast<const float*>(t.words[p]);
  const int* __restrict__ row_tenant = static_cast<const int*>(t.words[p]);
  const uint8_t* __restrict__ alive = t.alive[p];
  const uint8_t* __restrict__ is_super = t.is_super[p];
  const int base = (int)t.base[p];           // rows leave global
  const long long slot = (long long)p * splits + split;
  const long long r_begin = (long long)split * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > n) r_end = n;

  for (int e = tid; e < BQ * k; e += kThreads) {
    ls[e] = -INFINITY;
    lr[e] = INT32_MAX;
  }
  if constexpr (kKeyed) {
    for (int e = tid; e < BQ; e += kThreads) {
      gs[e] = -INFINITY;
      gr[e] = INT32_MAX;
      qt[e] = q0 + e < nq ? q_tenant[q0 + e] : kNoTenant;
    }
  }

  for (long long r0 = r_begin; r0 < r_end; r0 += kBR) {
    if constexpr (kKeyed) {
      if (tid < kBR) {
        const long long r = r0 + tid;
        rkey[tid] = r < r_end && alive[r] ? row_tenant[r] : kNoTenant;
        rsup[tid] = r < r_end ? (int)is_super[r] : 0;
      }
    }
    float acc[MQ][MR];
    fma_tile<T, BQ, MQ, MR>(acc, qs, rs, qry, emb, q0, nq, r0, r_end, d);

    // Scores of the tile: additive mode adds the mask here, keyed mode
    // masks per query below. Rows past the range are never candidates.
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const int ri = tr + j * TR;
      float m = 0.f;
      if constexpr (!kKeyed) {
        if (r0 + ri < r_end) m = madd[r0 + ri];
      }
#pragma unroll
      for (int i = 0; i < MQ; ++i) sc[(tq + i * TQ) * (kBR + 1) + ri] = acc[i][j] + m;
    }
    __syncthreads();

    // One warp per query: fold the tile into its gate and its list.
    for (int qi = warp; qi < BQ; qi += kWarps) {
      if (q0 + qi >= nq) break;
      const float* scq = sc + qi * (kBR + 1);
      int ten = 0;
      if constexpr (kKeyed) {
        ten = qt[qi];
        if (with_gate) {
          float bs = -INFINITY;
          int br = INT32_MAX;
          for (int c = lane; c < kBR; c += 32) {
            const long long r = r0 + c;
            if (r < r_end) {
              const float s = (rkey[c] == ten && rsup[c]) ? scq[c] : kNeg;
              if (better(s, base + (int)r, bs, br)) { bs = s; br = base + (int)r; }
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float s2 = __shfl_xor_sync(kFull, bs, o);
            const int r2 = __shfl_xor_sync(kFull, br, o);
            if (better(s2, r2, bs, br)) { bs = s2; br = r2; }
          }
          if (lane == 0 && better(bs, br, gs[qi], gr[qi])) {
            gs[qi] = bs;
            gr[qi] = br;
          }
        }
      }
      float* lsq = ls + qi * k;
      int* lrq = lr + qi * k;
      // A later pass admits only pairs ranking after (ts, ta).
      const float ts = after_s ? after_s[(long long)(q0 + qi) * ld_after] : INFINITY;
      const long long ta =
          after_r ? (long long)after_r[(long long)(q0 + qi) * ld_after] : -1;
      for (int c = 0; c < kBR; c += 32) {
        const long long r = r0 + c + lane;
        const long long rg = base + r;
        float s = scq[c + lane];
        if constexpr (kKeyed) {
          if (!(rkey[c + lane] == ten && !rsup[c + lane])) s = kNeg;
        }
        const bool after = s < ts || (s == ts && rg > ta);
        warp_list_insert(lsq, lrq, k, s, base + (int)(r0 + c), r < r_end && after);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BQ * k; e += kThreads) {
    const int q = q0 + e / k;
    if (q < nq) {
      const long long o = (slot * nq + q) * k + e % k;
      cand_s[o] = ls[e];
      cand_r[o] = lr[e];
    }
  }
  if constexpr (kKeyed) {
    if (with_gate) {
      for (int e = tid; e < BQ; e += kThreads) {
        if (q0 + e < nq) {
          gate_cs[slot * nq + q0 + e] = gs[e];
          gate_cr[slot * nq + q0 + e] = gr[e];
        }
      }
    }
  }
}

// Block arg-max of (s, r, p) under `better`; every thread gets the winner.
__device__ void block_best(float& s, int& r, int& p, float* ws, int* wr,
                           int* wp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_down_sync(kFull, s, off);
    const int r2 = __shfl_down_sync(kFull, r, off);
    const int p2 = __shfl_down_sync(kFull, p, off);
    if (p2 >= 0 && (p < 0 || better(s2, r2, s, r))) { s = s2; r = r2; p = p2; }
  }
  if (lane == 0) { ws[warp] = s; wr[warp] = r; wp[warp] = p; }
  __syncthreads();
  s = ws[0]; r = wr[0]; p = wp[0];
  for (int w = 1; w < kWarps; ++w) {
    if (wp[w] >= 0 && (p < 0 || better(ws[w], wr[w], s, r))) {
      s = ws[w]; r = wr[w]; p = wp[w];
    }
  }
  __syncthreads();
}

// One block per query. Columns [k0, k0 + kc) of the output come from kc
// rounds of "best head among the splits' sorted lists" (the splits of every
// shard entry: rows are global); a column at or past k_q[q] is written as
// (kNeg, tail_row). The pass that ends at kmax also writes the columns
// [kmax, ldo) that way. with_gate merges the gate too. mask_dead writes
// tail_row for a pair scoring at or below kNeg / 2 (a masked row), as the
// cross-shard merge does with its sentinel.
template <typename R>
__global__ void __launch_bounds__(kThreads)
scan_merge(const float* __restrict__ gate_cs, const int* __restrict__ gate_cr,
           const float* __restrict__ cand_s, const int* __restrict__ cand_r,
           int splits, int nq, int kc, int k0, int kmax,
           const int* __restrict__ k_q, R tail_row, int mask_dead, int with_gate,
           float* __restrict__ gate_s, int* __restrict__ gate_r,
           float* __restrict__ out_s, R* __restrict__ out_r, int ldo) {
  constexpr int kOwn = kMaxSplits / kThreads;
  __shared__ float ws[kWarps];
  __shared__ int wr[kWarps];
  __shared__ int wp[kWarps];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int kq = k_q ? k_q[q] : ldo;

  if (with_gate) {
    float bs = -INFINITY;
    int br = INT32_MAX, bp = -1;
    for (int sp = tid; sp < splits; sp += kThreads) {
      const float s = gate_cs[(long long)sp * nq + q];
      const int r = gate_cr[(long long)sp * nq + q];
      if (bp < 0 || better(s, r, bs, br)) { bs = s; br = r; bp = sp; }
    }
    block_best(bs, br, bp, ws, wr, wp);
    if (tid == 0) {
      gate_s[q] = bs;
      gate_r[q] = mask_dead && bs <= kNeg / 2 ? (int)tail_row : br;
    }
  }

  int ptr[kOwn];
  float hs[kOwn];
  int hr[kOwn];
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int sp = tid + o * kThreads;
    ptr[o] = 0;
    hs[o] = -INFINITY;
    hr[o] = INT32_MAX;
    if (sp < splits) {
      const long long idx = ((long long)sp * nq + q) * kc;
      hs[o] = cand_s[idx];
      hr[o] = cand_r[idx];
    }
  }

  for (int t = 0; t < kc; ++t) {
    float bs = -INFINITY;
    int br = INT32_MAX, bp = -1;
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      const int sp = tid + o * kThreads;
      if (sp < splits && (bp < 0 || better(hs[o], hr[o], bs, br))) {
        bs = hs[o]; br = hr[o]; bp = sp;
      }
    }
    block_best(bs, br, bp, ws, wr, wp);
    if (tid == 0) {
      const bool live = k0 + t < kq;
      out_s[(long long)q * ldo + k0 + t] = live ? bs : kNeg;
      out_r[(long long)q * ldo + k0 + t] =
          live && !(mask_dead && bs <= kNeg / 2) ? (R)br : tail_row;
    }
    if (bp % kThreads == tid) {
      const int o = bp / kThreads;
      const int nxt = ++ptr[o];
      const long long idx = ((long long)bp * nq + q) * kc + nxt;
      hs[o] = nxt < kc ? cand_s[idx] : -INFINITY;
      hr[o] = nxt < kc ? cand_r[idx] : INT32_MAX;
    }
  }
  if (k0 + kc == kmax) {
    for (int t = kmax + tid; t < ldo; t += kThreads) {
      out_s[(long long)q * ldo + t] = kNeg;
      out_r[(long long)q * ldo + t] = tail_row;
    }
  }
}

// Queries a block of the FMA stage 1 takes: the least of 4, 8, 16 and 64
// that covers nq (an f32 scan too wide for the streaming route runs here at
// any Q).
inline int query_tile(int nq) {
  return nq <= 4 ? 4 : (nq <= 8 ? 8 : (nq <= 16 ? 16 : 64));
}

// Row splits of each of `shards` entries of n rows the FMA stage 1 uses for
// this shape on a card with `sms` multiprocessors: enough blocks for about
// four per SM.
int fma_splits(long long n, int shards, int nq, int sms) {
  const long long qtiles = (nq + query_tile(nq) - 1) / query_tile(nq);
  const long long rtiles = (n + kBR - 1) / kBR;
  long long want = (4LL * sms + qtiles * shards - 1) / (qtiles * shards);
  if (want > rtiles) want = rtiles;
  if (want > kMaxSplits / shards) want = kMaxSplits / shards;
  if (want < 1) want = 1;
  return (int)want;
}

// ---------------------------------------------------------------------------
// Stage 1, tensor-core route (bf16 arenas): wgmma score tiles fed by a TMA
// ring of arena and query panels
// ---------------------------------------------------------------------------

constexpr int kRouteFma = 0;
constexpr int kRouteWgmma = 1;
constexpr int kRowBytes = hopper::SWIZZLE_ROW_BYTES;  // one row of a 64-column panel
constexpr int kSortN = 256;                           // keys one warp sorts, 8 a lane

constexpr int kSmemMax = 232448;                      // a block's shared memory
constexpr int kMaxStages = 8;

// Tile shape of one pass. kc == 1 keeps a running arg-max in registers:
// 256 arena rows a tile, one warpgroup of 64 queries, or two (128 queries)
// past 64 queries; the ring takes the shared memory, up to kMaxStages
// stages. Lists (kc > 1) take 128 rows a tile and one warpgroup, per query
// lcap entries of sorted list (kc rounded up to 8) and bcap entries of
// batch, and a ring of what is left: lists of up to 32 keep a batch of a
// tile and 32 (a merge is cheap), longer ones the most that leaves 3
// stages.
struct WgShape {
  int wgs, bn, list, ns, lcap, bcap;
};

inline size_t wg_stage_bytes(const WgShape& sh) {
  return (size_t)(sh.wgs * 64 + sh.bn) * kRowBytes + 16;   // + two barriers
}

// 1 KB of alignment slack and two buffers of a tile's three row words per
// warpgroup.
inline size_t wg_cols_bytes(const WgShape& sh) {
  return 1024 + (size_t)sh.wgs * 6 * sh.bn * 4;
}

// Lists add 64 entries of (lcap + bcap) keys.
inline size_t wg_smem(const WgShape& sh) {
  return wg_cols_bytes(sh) + (sh.list ? (size_t)64 * (sh.lcap + sh.bcap) * 8 : 0) +
         sh.ns * wg_stage_bytes(sh);
}

inline WgShape wg_shape(int nq, int kc) {
  if (kc == 1) {
    WgShape sh{nq > 64 ? 2 : 1, 256, 0, 0, 0, 0};
    const size_t ns = (kSmemMax - wg_cols_bytes(sh)) / wg_stage_bytes(sh);
    sh.ns = (int)(ns < kMaxStages ? ns : kMaxStages);
    return sh;
  }
  WgShape sh{1, 128, 1, 3, ((kc + 7) / 8) * 8, 0};
  if (kc <= 32) {
    sh.bcap = sh.bn + 32;
  } else {
    const size_t per_query =
        (kSmemMax - wg_cols_bytes(sh) - sh.ns * wg_stage_bytes(sh)) / (64 * 8);
    sh.bcap = (int)(((per_query - sh.lcap) / 8) * 8);
    if (sh.bcap > kSortN) sh.bcap = kSortN;
  }
  const size_t ns = (kSmemMax - wg_cols_bytes(sh) - (size_t)64 * (sh.lcap + sh.bcap) * 8) /
                    wg_stage_bytes(sh);
  sh.ns = (int)(ns < kMaxStages ? ns : kMaxStages);
  return sh;
}

// One exact key per (score, row): the order-preserving bits of the f32
// score above the complement of the row, so that a larger key ranks first
// (better()'s order with no ties left; ops.topk.stable_topk builds the
// same key). 0 is below every key: an empty slot.
__device__ __forceinline__ uint64_t list_key(float s, int r) {
  uint32_t b = __float_as_uint(s);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)b << 32) | (uint32_t)(0xFFFFFFFFu - (uint32_t)r);
}

__device__ __forceinline__ float key_score(uint64_t k) {
  uint32_t b = (uint32_t)(k >> 32);
  b = (b & 0x80000000u) ? (b & 0x7FFFFFFFu) : ~b;
  return __uint_as_float(b);
}

__device__ __forceinline__ int key_row(uint64_t k) {
  return (int)(0xFFFFFFFFu - (uint32_t)k);
}

// (s, r) ranks after (ts, ta): the admission rule of a later pass.
__device__ __forceinline__ bool ranks_after(float s, long long r, float ts, long long ta) {
  return s < ts || (s == ts && r > ta);
}

// Exclusive offset and total of x over the four lanes of a quad (the four
// threads that hold one accumulator row).
__device__ __forceinline__ void quad_scan(int x, int& off, int& tot) {
  const int tq = threadIdx.x & 3;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o, 4);
    if (tq >= o) inc += y;
  }
  tot = __shfl_sync(kFull, inc, 3, 4);
  off = inc - x;
}

// The first n (<= S) keys at L sorted descending by the whole warp, a
// bitonic network of S keys in registers (zeros past n sort last): key[j]
// is position 32 j + lane.
template <int S>
__device__ __forceinline__ void warp_sort_desc(const uint64_t* L, int n,
                                               uint64_t (&key)[S / 32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < S / 32; ++j) {
    const int i = 32 * j + lane;
    key[j] = i < n ? L[i] : 0ull;
  }
#pragma unroll
  for (int size = 2; size <= S; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int js = stride / 32;
#pragma unroll
        for (int j = 0; j < S / 32; ++j) {
          if (j & js) continue;
          const bool desc = ((32 * j) & size) == 0;
          const uint64_t x = key[j], y = key[j | js];
          if (desc ? x < y : x > y) {
            key[j] = y;
            key[j | js] = x;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < S / 32; ++j) {
          const uint64_t y = __shfl_xor_sync(kFull, key[j], stride);
          const bool desc = ((32 * j + lane) & size) == 0;
          const bool lower = (lane & stride) == 0;
          const uint64_t x = key[j];
          key[j] = (lower == desc) ? (x > y ? x : y) : (x < y ? x : y);
        }
      }
    }
  }
}

// Keys greater than x in the descending keys arr[0, len).
__device__ __forceinline__ int count_greater(const uint64_t* arr, int len, uint64_t x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (arr[mid] > x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One query's batch B[0, nb) merged into its sorted list L[0, m) by the
// whole warp, keeping the best kc: the batch is sorted (a network of S >=
// nb keys) and written back, then every key's place in the merged order is
// its own index plus the keys of the other array above it (no two keys are
// equal), found by binary search; all reads end before the writes. Returns
// the new list length.
template <int S>
__device__ __forceinline__ int merge_batch(uint64_t* L, int m, uint64_t* B, int nb, int kc) {
  const int lane = threadIdx.x & 31;
  uint64_t key[S / 32];
  warp_sort_desc<S>(B, nb, key);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < S / 32; ++j)
    if (32 * j + lane < nb) B[32 * j + lane] = key[j];
  uint64_t lv[kMaxK / 32];
#pragma unroll
  for (int t = 0; t < kMaxK / 32; ++t)
    lv[t] = lane + 32 * t < m ? L[lane + 32 * t] : 0ull;
  __syncwarp();
  int pb[S / 32], pl[kMaxK / 32];
#pragma unroll
  for (int j = 0; j < S / 32; ++j) {
    const int i = 32 * j + lane;
    pb[j] = i < nb ? i + count_greater(L, m, key[j]) : kc;
  }
#pragma unroll
  for (int t = 0; t < kMaxK / 32; ++t) {
    const int i = lane + 32 * t;
    pl[t] = i < m ? i + count_greater(B, nb, lv[t]) : kc;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < S / 32; ++j)
    if (pb[j] < kc) L[pb[j]] = key[j];
#pragma unroll
  for (int t = 0; t < kMaxK / 32; ++t)
    if (pl[t] < kc) L[pl[t]] = lv[t];
  __syncwarp();
  return m + nb < kc ? m + nb : kc;
}

// The best kc (<= 32) of a query's sorted list L[0, m) and its batch
// B[0, nb) (nb <= 32 NB), chosen by the whole warp in kc rounds of a warp
// arg-max over the keys (each round takes the largest left; no two keys
// are equal) and written sorted to L. Returns the new list length.
template <int NB>
__device__ __forceinline__ int select_small(uint64_t* L, int m, const uint64_t* B, int nb,
                                            int kc) {
  const int lane = threadIdx.x & 31;
  uint64_t v[NB + 1];
  v[0] = lane < m ? L[lane] : 0ull;
#pragma unroll
  for (int j = 0; j < NB; ++j) v[j + 1] = 32 * j + lane < nb ? B[32 * j + lane] : 0ull;
  const int total = m + nb < kc ? m + nb : kc;
  uint64_t mine = 0ull;
  for (int r = 0; r < total; ++r) {
    uint64_t best = v[0];
#pragma unroll
    for (int j = 1; j <= NB; ++j) best = v[j] > best ? v[j] : best;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const uint64_t y = __shfl_xor_sync(kFull, best, o);
      best = y > best ? y : best;
    }
#pragma unroll
    for (int j = 0; j <= NB; ++j)
      if (v[j] == best) v[j] = 0ull;
    if (lane == r) mine = best;
  }
  __syncwarp();
  if (lane < total) L[lane] = mine;
  __syncwarp();
  return total;
}

// Merges the batch of each of the warp's 16 queries whose need bit is set
// (rows a at lanes 4g of need_a, rows b of need_b) into its list: lists of
// up to 32 by select_small, longer ones by merge_batch with a network sized
// to the batch. Raises the query's threshold to the list's last key once
// the list holds kc. Query row i of the warp keeps its list at lists + i *
// (lcap + bcap) and its batch lcap + boff entries on.
__device__ __forceinline__ void merge_pending(uint64_t* lists, int lcap, int bcap,
                                              int kc, bool need_a, bool need_b, int& m_a,
                                              int& m_b, int& nb_a, int& nb_b,
                                              float& thr_a, float& thr_b, int boff = 0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  unsigned bits_a = __ballot_sync(kFull, tq == 0 && need_a);
  unsigned bits_b = __ballot_sync(kFull, tq == 0 && need_b);
  while (bits_a | bits_b) {
    const bool is_a = bits_a != 0u;
    unsigned& bits = is_a ? bits_a : bits_b;
    const int src = __ffs(bits) - 1;
    bits &= bits - 1;
    const int i = src / 4 + (is_a ? 0 : 8);
    const int m = __shfl_sync(kFull, is_a ? m_a : m_b, src);
    const int nb = __shfl_sync(kFull, is_a ? nb_a : nb_b, src);
    uint64_t* L = lists + i * (lcap + bcap);
    uint64_t* B = L + lcap + boff;
    int m2;
    if (kc <= 32) {
      if (nb <= 32) m2 = select_small<1>(L, m, B, nb, kc);
      else if (nb <= 64) m2 = select_small<2>(L, m, B, nb, kc);
      else if (nb <= 128) m2 = select_small<4>(L, m, B, nb, kc);
      else m2 = select_small<8>(L, m, B, nb, kc);
    } else {
      if (nb <= 32) m2 = merge_batch<32>(L, m, B, nb, kc);
      else if (nb <= 64) m2 = merge_batch<64>(L, m, B, nb, kc);
      else if (nb <= 128) m2 = merge_batch<128>(L, m, B, nb, kc);
      else m2 = merge_batch<256>(L, m, B, nb, kc);
    }
    const float t = m2 == kc ? key_score(L[kc - 1]) : -INFINITY;
    if (g == src / 4) {
      if (is_a) { m_a = m2; nb_a = 0; thr_a = t; }
      else { m_b = m2; nb_b = 0; thr_b = t; }
    }
    __syncwarp();
  }
}

// n: rows of each shard entry; splits: row splits of each entry.
template <bool kKeyed>
struct WgArgs {
  ShardTable t;
  const int* q_tenant;
  long long n, rows_per_split;
  int splits, nq, kc, panels, ns, lcap, bcap, with_gate, ld_after;
  const float* after_s;
  const RowT<kKeyed>* after_r;
  float* gate_cs;
  int* gate_cr;
  float* cand_s;
  int* cand_r;
};

// Scores of a tile from its three row words (ca, cb, cc), one compare and
// one select a tier. Additive mode: ca holds madd's bits, added to the sum
// (-inf past the split's end). Keyed mode: ca is the row's tenant if it is
// a live non-super row, cb if it is a live super row (else a key no query
// has), cc the score of a row outside the tier: NEG, or -inf past the
// split's end, which no threshold admits. + 0.0f turns a -0 sum into +0.
template <bool kKeyed>
__device__ __forceinline__ float tier_score(float acc, uint32_t ca, uint32_t cc, int ten) {
  if constexpr (kKeyed) return (int)ca == ten ? acc + 0.0f : __uint_as_float(cc);
  return acc + __uint_as_float(ca);
}

__device__ __forceinline__ float gate_score(float acc, uint32_t cb, uint32_t cc, int ten) {
  return (int)cb == ten ? acc + 0.0f : __uint_as_float(cc);
}

// The producer of a tensor-core stage 1: one thread keeps TMA loads of
// (query panel, arena panel) pairs, 64 columns each, for `tiles` tiles of
// BN rows from r_begin, in a ring of ns stages. Item j uses stage j % ns;
// its full barrier waits for completion j / ns, the producer's empty wait
// for completion j / ns - 1 (hopper::Ring with a stage count known at
// launch).
template <int WGS, int BN>
__device__ __forceinline__ void wg_produce(const CUtensorMap* map_q, const CUtensorMap* map_e,
                                           uint8_t* ring, uint64_t* full, uint64_t* empty,
                                           int ns, int tiles, int panels, int q0,
                                           long long r_begin) {
  constexpr int QB = WGS * 64 * kRowBytes;   // query panel of a stage
  constexpr int STAGE = QB + BN * kRowBytes;
  const int items = tiles * panels;
  for (int j = 0; j < items; ++j) {
    const int s = j % ns, t = j / panels, p = j - t * panels;
    if (j >= ns) hopper::mbar_wait(empty + s, ((j / ns) - 1) & 1);
    hopper::mbar_arrive_expect_tx(full + s, STAGE);
    uint8_t* st = ring + s * STAGE;
    hopper::tma_load_4d(st, map_q, full + s, 64 * p, q0, 0, 0);
    hopper::tma_load_4d(st + QB, map_e, full + s, 64 * p,
                        (int)(r_begin + (long long)t * BN), 0, 0);
  }
}

// Warpgroup wg's scores of tile t, S = Q.E^T over d as a chain of SS wgmma
// m64nBNk16 into acc: panel p's four products go out behind panel p - 1's,
// whose stage is released once they retire (wait<1>), the last after the
// chain. tid is the thread's index in its warpgroup.
template <int WGS, int BN>
__device__ __forceinline__ void wg_product(float (&acc)[BN / 2], uint8_t* ring, uint64_t* full,
                                           uint64_t* empty, int ns, int t, int panels, int wg,
                                           int tid) {
  constexpr int QB = WGS * 64 * kRowBytes;
  constexpr int STAGE = QB + BN * kRowBytes;
  const int j0 = t * panels;
  for (int p = 0; p < panels; ++p) {
    const int j = j0 + p, s = j % ns;
    hopper::mbar_wait(full + s, (j / ns) & 1);
    const uint8_t* qs = ring + s * STAGE + wg * 64 * kRowBytes;
    const uint8_t* es = ring + s * STAGE + QB;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::sw128_desc(qs + 32 * kk, 16, 1024);
      const uint64_t db = hopper::sw128_desc(es + 32 * kk, 16, 1024);
      if constexpr (BN == 128) hopper::wgmma_ss_m64n128k16(acc, da, db, p > 0 || kk > 0);
      if constexpr (BN == 256) hopper::wgmma_ss_m64n256k16(acc, da, db, p > 0 || kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (p > 0 && tid == 0) hopper::mbar_arrive(empty + (j - 1) % ns);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if (tid == 0) hopper::mbar_arrive(empty + (j0 + panels - 1) % ns);
}

// Stage 1 on the tensor cores. Block (x, y) scores queries x * 64 WGS ..
// + 64 WGS - 1 (warpgroup w takes 64 of them) against the rows of split y,
// in tiles of BN rows. Warpgroup WGS produces (wg_produce); the consumers
// run S = Q.E^T (wg_product) with both operands in 128-byte swizzled shared
// memory and the f32 sums in registers, then fold the tile into their
// queries' results (see the header note).
// The arena tensor map of each shard entry.
struct MapTable {
  CUtensorMap e[kMaxShards];
};

template <int WGS, int BN, bool kList, bool kKeyed>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
scan_stage1_wgmma(const __grid_constant__ MapTable maps,
                  const __grid_constant__ CUtensorMap map_q, const WgArgs<kKeyed> a) {
  // Ring of a.ns stages (wg_produce).
  const int NS = a.ns;
  constexpr int STAGE = WGS * 64 * kRowBytes + BN * kRowBytes;
  constexpr int NF = BN / 2;                 // accumulator registers a thread
  constexpr int CPT = BN / 128;              // row columns a thread stages
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint32_t* cols = reinterpret_cast<uint32_t*>(ring + NS * STAGE);  // [WGS][2][3][BN]
  uint64_t* lists = reinterpret_cast<uint64_t*>(cols + WGS * 6 * BN);  // [64][lcap + bcap]
  uint64_t* full = lists + (kList ? 64 * (a.lcap + a.bcap) : 0);
  uint64_t* empty = full + NS;

  const int q0 = blockIdx.x * WGS * 64;
  const int split = blockIdx.y;
  const int sh = blockIdx.z;                   // shard entry
  const CUtensorMap* map_e = &maps.e[sh];
  const float* madd = static_cast<const float*>(a.t.words[sh]);
  const int* row_tenant = static_cast<const int*>(a.t.words[sh]);
  const uint8_t* alive = a.t.alive[sh];
  const uint8_t* is_super = a.t.is_super[sh];
  const int base = (int)a.t.base[sh];          // rows leave global
  const long long slot = (long long)sh * a.splits + split;
  const long long r_begin = (long long)split * a.rows_per_split;
  const long long r_end = min(r_begin + a.rows_per_split, a.n);
  const int tiles = r_end > r_begin ? (int)((r_end - r_begin + BN - 1) / BN) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, WGS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WGS) {
    // ---- producer: one thread issues every load
    if constexpr (WGS == 2) hopper::regs_shrink<24>();
    if (threadIdx.x == WGS * 128)
      wg_produce<WGS, BN>(&map_q, map_e, ring, full, empty, NS, tiles, a.panels, q0, r_begin);
    return;
  }

  // ---- consumers: warpgroup wg owns 64 queries; this thread rows a and b
  if constexpr (WGS == 2) hopper::regs_grow<240>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int la = 16 * warp + g, lb = la + 8;
  const int qa = q0 + 64 * wg + la, qb = qa + 8;
  const bool va = qa < a.nq, vb = qb < a.nq;
  uint32_t* wcols = cols + wg * 6 * BN;

  float ts_a = INFINITY, ts_b = INFINITY;
  long long ta_a = -1, ta_b = -1;
  if (a.after_s) {
    if (va) {
      ts_a = a.after_s[(long long)qa * a.ld_after];
      ta_a = (long long)a.after_r[(long long)qa * a.ld_after];
    }
    if (vb) {
      ts_b = a.after_s[(long long)qb * a.ld_after];
      ta_b = (long long)a.after_r[(long long)qb * a.ld_after];
    }
  }
  int ten_a = 0, ten_b = 0;
  if constexpr (kKeyed) {
    ten_a = va ? a.q_tenant[qa] : kNoTenant;
    ten_b = vb ? a.q_tenant[qb] : kNoTenant;
  }
  // kc == 1: running best of the list tier; keyed: the gate's.
  float bs_a = -INFINITY, bs_b = -INFINITY, gs_a = -INFINITY, gs_b = -INFINITY;
  int br_a = INT32_MAX, br_b = INT32_MAX, gr_a = INT32_MAX, gr_b = INT32_MAX;
  // Lists: the sorted list's length, the batch's, and the score a
  // candidate must beat (the list's last once it holds kc; +inf for a query
  // past nq).
  int m_a = 0, m_b = 0, nb_a = 0, nb_b = 0;
  float thr_a = va ? -INFINITY : INFINITY, thr_b = vb ? -INFINITY : INFINITY;
  const int stride = a.lcap + a.bcap;
  uint64_t* wlists = lists + 16 * warp * stride;   // this warp's 16 queries
  uint64_t* Ba = lists + la * stride + a.lcap;
  uint64_t* Bb = lists + lb * stride + a.lcap;
  const bool first_pass = a.after_s == nullptr;

  float acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    const long long r0 = r_begin + (long long)t * BN;
    const int g0 = base + (int)r0;               // global row of column 0
    // The tile's row words, loaded now and stored after the product.
    uint32_t ca[CPT], cb[CPT], cc[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const long long r = r0 + tid + 128 * u;
      const bool in = r < r_end;
      if constexpr (kKeyed) {
        const int key = in && alive[r] ? row_tenant[r] : kNoTenant;
        const bool sup = in && is_super[r];
        ca[u] = (uint32_t)(sup ? kNoTenant : key);
        cb[u] = (uint32_t)(sup ? key : kNoTenant);
        cc[u] = __float_as_uint(in ? kNeg : -INFINITY);
      } else {
        ca[u] = __float_as_uint(in ? madd[r] : -INFINITY);
        cb[u] = cc[u] = 0u;
      }
    }
    wg_product<WGS, BN>(acc, ring, full, empty, NS, t, a.panels, wg, tid);
    // Buffer t % 2 was last read in tile t - 2's epilogue, which every
    // thread finished before tile t - 1's barrier.
    uint32_t* colA = wcols + (t & 1) * 3 * BN;
    uint32_t* colB = colA + BN;
    uint32_t* colC = colB + BN;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      colA[tid + 128 * u] = ca[u];
      colB[tid + 128 * u] = cb[u];
      colC[tid + 128 * u] = cc[u];
    }
    hopper::named_sync(1 + wg, 128);

    // Fragment element 4c + e is row a, column 8c + 2tq + e; 4c + 2 + e row
    // b. A thread's two columns of chunk c are adjacent row words. Rows
    // reach a thread in ascending order, so an arg-max that replaces only on
    // a strictly better score keeps the lowest row.
    if constexpr (kKeyed) {
      if (a.with_gate) {
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          const uint2 kb = *reinterpret_cast<const uint2*>(colB + 8 * c + 2 * tq);
          const uint2 kc2 = *reinterpret_cast<const uint2*>(colC + 8 * c + 2 * tq);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = g0 + 8 * c + 2 * tq + e;
            const uint32_t cb = e ? kb.y : kb.x, cc = e ? kc2.y : kc2.x;
            const float sa = gate_score(acc[4 * c + e], cb, cc, ten_a);
            const float sb = gate_score(acc[4 * c + 2 + e], cb, cc, ten_b);
            gr_a = sa > gs_a ? r : gr_a;
            gs_a = sa > gs_a ? sa : gs_a;
            gr_b = sb > gs_b ? r : gr_b;
            gs_b = sb > gs_b ? sb : gs_b;
          }
        }
      }
    }
    if constexpr (!kList) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const uint2 ka = *reinterpret_cast<const uint2*>(colA + 8 * c + 2 * tq);
        uint2 kc2 = make_uint2(0u, 0u);
        if constexpr (kKeyed) kc2 = *reinterpret_cast<const uint2*>(colC + 8 * c + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = g0 + 8 * c + 2 * tq + e;
          const uint32_t ca = e ? ka.y : ka.x, cc = e ? kc2.y : kc2.x;
          const float sa = tier_score<kKeyed>(acc[4 * c + e], ca, cc, ten_a);
          const float sb = tier_score<kKeyed>(acc[4 * c + 2 + e], ca, cc, ten_b);
          const bool ua = sa > bs_a && (first_pass || ranks_after(sa, r, ts_a, ta_a));
          const bool ub = sb > bs_b && (first_pass || ranks_after(sb, r, ts_b, ta_b));
          bs_a = ua ? sa : bs_a;
          br_a = ua ? r : br_a;
          bs_b = ub ? sb : bs_b;
          br_b = ub ? r : br_b;
        }
      }
    } else {
      // Each score above its query's threshold (and, in a later pass, after
      // the previous pass's last pair) goes to the query's batch, which has
      // room for a whole tile: a branch-free mask first, then the few
      // survivors, a pair of columns at a time. Then, the tile's scores
      // dead, each batch that could not take another tile, or that can fill
      // a list not yet full, is merged into its list.
      uint32_t ma = 0u, mb = 0u;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const uint2 ka = *reinterpret_cast<const uint2*>(colA + 8 * c + 2 * tq);
        uint2 kc2 = make_uint2(0u, 0u);
        if constexpr (kKeyed) kc2 = *reinterpret_cast<const uint2*>(colC + 8 * c + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t ca = e ? ka.y : ka.x, cc = e ? kc2.y : kc2.x;
          const int r = g0 + 8 * c + 2 * tq + e;
          const float sa = tier_score<kKeyed>(acc[4 * c + e], ca, cc, ten_a);
          const float sb = tier_score<kKeyed>(acc[4 * c + 2 + e], ca, cc, ten_b);
          const bool ua = sa > thr_a && (first_pass || ranks_after(sa, r, ts_a, ta_a));
          const bool ub = sb > thr_b && (first_pass || ranks_after(sb, r, ts_b, ta_b));
          ma |= ua ? 1u << (2 * c + e) : 0u;
          mb |= ub ? 1u << (2 * c + e) : 0u;
        }
      }
      int off_a, tot_a, off_b, tot_b;
      quad_scan(__popc(ma), off_a, tot_a);
      quad_scan(__popc(mb), off_b, tot_b);
      if (ma | mb) {
        int pa = nb_a + off_a, pb = nb_b + off_b;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          if (!(((ma | mb) >> (2 * c)) & 3u)) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * c + 2 * tq + e, bit = 2 * c + e;
            const int r = g0 + col;
            if ((ma >> bit) & 1u)
              Ba[pa++] = list_key(
                  tier_score<kKeyed>(acc[4 * c + e], colA[col], colC[col], ten_a), r);
            if ((mb >> bit) & 1u)
              Bb[pb++] = list_key(
                  tier_score<kKeyed>(acc[4 * c + 2 + e], colA[col], colC[col], ten_b), r);
          }
        }
      }
      nb_a += tot_a;
      nb_b += tot_b;
      merge_pending(wlists, a.lcap, a.bcap, a.kc,
                    nb_a > 0 && (nb_a > a.bcap - BN || m_a < a.kc),
                    nb_b > 0 && (nb_b > a.bcap - BN || m_b < a.kc), m_a, m_b, nb_a, nb_b,
                    thr_a, thr_b);
    }
  }

  // ---- results of the split: quad reductions, or the last merges
  if constexpr (kKeyed) {
    if (a.with_gate) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float sa = __shfl_xor_sync(kFull, gs_a, o), sb = __shfl_xor_sync(kFull, gs_b, o);
        const int ra = __shfl_xor_sync(kFull, gr_a, o), rb = __shfl_xor_sync(kFull, gr_b, o);
        if (better(sa, ra, gs_a, gr_a)) { gs_a = sa; gr_a = ra; }
        if (better(sb, rb, gs_b, gr_b)) { gs_b = sb; gr_b = rb; }
      }
      if (tq == 0) {
        if (va) { a.gate_cs[slot * a.nq + qa] = gs_a; a.gate_cr[slot * a.nq + qa] = gr_a; }
        if (vb) { a.gate_cs[slot * a.nq + qb] = gs_b; a.gate_cr[slot * a.nq + qb] = gr_b; }
      }
    }
  }
  if constexpr (!kList) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float sa = __shfl_xor_sync(kFull, bs_a, o), sb = __shfl_xor_sync(kFull, bs_b, o);
      const int ra = __shfl_xor_sync(kFull, br_a, o), rb = __shfl_xor_sync(kFull, br_b, o);
      if (better(sa, ra, bs_a, br_a)) { bs_a = sa; br_a = ra; }
      if (better(sb, rb, bs_b, br_b)) { bs_b = sb; br_b = rb; }
    }
    if (tq == 0) {   // kc == 1
      if (va) { a.cand_s[slot * a.nq + qa] = bs_a; a.cand_r[slot * a.nq + qa] = br_a; }
      if (vb) { a.cand_s[slot * a.nq + qb] = bs_b; a.cand_r[slot * a.nq + qb] = br_b; }
    }
  } else {
    merge_pending(wlists, a.lcap, a.bcap, a.kc, nb_a > 0, nb_b > 0, m_a, m_b, nb_a, nb_b,
                  thr_a, thr_b);
    for (int i = 0; i < 16; ++i) {
      const int m = __shfl_sync(kFull, i < 8 ? m_a : m_b, 4 * (i & 7));
      const int q = q0 + 64 * wg + 16 * warp + i;
      if (q >= a.nq) continue;
      const uint64_t* L = wlists + i * stride;
      const long long o = (slot * a.nq + q) * a.kc;
      for (int idx = lane; idx < a.kc; idx += 32) {
        const bool live = idx < m;
        const uint64_t key = live ? L[idx] : 0ull;
        a.cand_s[o + idx] = live ? key_score(key) : -INFINITY;
        a.cand_r[o + idx] = live ? key_row(key) : INT32_MAX;
      }
    }
  }
}

template <int WGS, int BN, bool kList, bool kKeyed>
cudaError_t launch_stage1_wgmma(int shards, const void* qry, int d,
                                const WgArgs<kKeyed>& w, cudaStream_t stream) {
  auto kernel = scan_stage1_wgmma<WGS, BN, kList, kKeyed>;
  const size_t smem = wg_smem(WgShape{WGS, BN, kList, w.ns, w.lcap, w.bcap});
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // Rows past each shard's n and columns past d arrive as zeros.
  MapTable maps;
  CUtensorMap map_q;
  for (int p = 0; p < shards; ++p)
    if (!hopper::encode_rows_map(&maps.e[p], w.t.emb[p], d, w.n, 1, 1, d, 0, 0, BN))
      return cudaErrorNotSupported;
  if (!hopper::encode_rows_map(&map_q, qry, d, w.nq, 1, 1, d, 0, 0, WGS * 64))
    return cudaErrorNotSupported;
  dim3 grid((w.nq + WGS * 64 - 1) / (WGS * 64), w.splits, shards);
  kernel<<<grid, (WGS + 1) * 128, smem, stream>>>(maps, map_q, w);
  return cudaGetLastError();
}

// Splits of each of `shards` entries on the tensor-core route, for
// `qtiles` query tiles over all entries and `rtiles` row tiles an entry: the
// count whose blocks fill whole waves of one block per SM best (ties to the
// fewest); within one wave when every entry has a single query tile (more
// waves of equal fill only add block prologues and lists to merge). Blocks
// of one split read the same rows in the same order, and the grid launches
// query tiles fastest, so a wave shares its arena panels in L2.
int wave_splits(long long qtiles, long long rtiles, int shards, int sms) {
  long long cap = kMaxSplits / shards;
  if (qtiles == shards && shards <= sms && sms / shards < cap) cap = sms / shards;
  const long long top = rtiles < cap ? rtiles : cap;
  int best = 1;
  double best_eff = -1.0;
  for (long long s = 1; s <= top; ++s) {
    const long long per = (rtiles + s - 1) / s;
    const long long waves = (qtiles * s + sms - 1) / sms;
    const double eff = (double)(qtiles * rtiles) / ((double)waves * sms * per);
    if (eff > best_eff * (1.0 + 1e-9)) {
      best_eff = eff;
      best = (int)s;
    }
  }
  return best;
}

// wave_splits for an additive or keyed scan of n rows an entry, from the
// first pass's shape.
int wg_splits(long long n, int shards, int nq, int kmax, int sms) {
  const WgShape sh = wg_shape(nq, kmax < kMaxK ? kmax : kMaxK);
  return wave_splits((nq + sh.wgs * 64 - 1) / (sh.wgs * 64) * shards,
                     (n + sh.bn - 1) / sh.bn, shards, sms);
}

// ---------------------------------------------------------------------------
// Stage 1, streaming route (f32 arenas, Q <= 16 queries): a matrix-vector
// scan fed by 1-D bulk copies through an mbarrier ring
// ---------------------------------------------------------------------------
//
// What bounds it: HBM bytes (the route's whole point: a split's rows are one
// contiguous byte range, streamed once by the copy engine with no
// registers or instructions spent on addresses). The arithmetic is 2 Q
// FLOP an element on the CUDA cores in f32; an f32 row carries 4 bytes an
// element, so the scan stays near its bytes' bound up to Q = 8 or so. (A
// bf16 row carries half the bytes for the same FMAs: on an H100 the
// tensor-core route is as fast at one query and faster from two, so every
// bf16 scan takes it.) Each block takes one split (one wave of blocks); the
// ring is as deep as shared memory allows. A lane holds its slots of its
// queries in registers, kStreamQregs values at most: that caps d at 3,072
// up to 8 queries and 1,536 at 9 to 16 (the wrapper's rule sends wider
// scans to the FMA route; the launch refuses them).

constexpr int kRouteStream = 2;
constexpr int kStreamMaxQ = 16;
constexpr int kStreamStageBytes = 49152;   // arena bytes a ring stage aims at
constexpr int kStreamMaxRows = 128;        // rows of a chunk at most (a batch)
constexpr int kStreamHead = 512;           // barriers, batch sizes, thresholds
constexpr int kStreamMathWarps = 8;
constexpr int kStreamQregs = 96;           // query values a lane holds

// Layout of a streaming launch, fixed by d, the mode, the list length kc
// and the query tile qt (nq rounded up to a power of two):
//   cr    rows a chunk (one ring stage): the rows in kStreamStageBytes of
//         arena, rounded down to a multiple of 16 when there are 16 or
//         more (then the row words come by bulk copies too), at most
//         kStreamMaxRows; fewer than 16 are raised to one a math warp
//         where two stages of them fit;
//   g     lanes sharing a row: its d / 8 slots of 8 elements rounded up to
//         a power of two, at most 32; spl slots a lane (a row never spans
//         two warps);
//   qg    queries a math warp sums (its query group): the most of 4, 2, 1
//         whose qg * spl * 8 values fit in kStreamQregs registers (and qg
//         <= g); ng = qt / qg groups, pr = kStreamMathWarps / ng warps a
//         group (0 when the groups do not fit: the launch is refused);
//   ns    ring stages, as many as shared memory holds (at most kMaxStages);
//   bc    entries of each of a query's two batches: a batch takes the
//         candidates of every other chunk until it could not take another.
// A stage holds cr arena rows, then their row words (madd f32, or tenant
// i32, alive u8 and is_super u8, column by column), padded to 128 bytes.
struct StreamShape {
  int cr, g, spl, qg, ng, pr, ns, lcap, bc, row_bytes, words_off, stage_bytes, fin;
  size_t lists_off, fin_off, smem;
};

template <bool kKeyed>
inline StreamShape stream_shape(int d, int kc, int qt, int cr = 0) {
  StreamShape sh{};
  sh.row_bytes = d * 4;
  if (cr == 0) {
    // Wide rows: one a math warp if two such stages fit, else what fits.
    const int fit = kStreamStageBytes / sh.row_bytes;
    if (fit >= 16) return stream_shape<kKeyed>(d, kc, qt, fit / 16 * 16 > kStreamMaxRows
                                                              ? kStreamMaxRows : fit / 16 * 16);
    const StreamShape wide = stream_shape<kKeyed>(d, kc, qt, fit > kStreamMathWarps
                                                               ? fit : kStreamMathWarps);
    return wide.ns >= 2 ? wide : stream_shape<kKeyed>(d, kc, qt, fit < 1 ? 1 : fit);
  }
  sh.cr = cr;
  const int slots = d / 8;
  sh.g = 1;
  while (sh.g < slots && sh.g < 32) sh.g <<= 1;
  sh.spl = (slots + sh.g - 1) / sh.g;
  sh.qg = 4;
  while (sh.qg > 1 && (sh.qg > qt || sh.qg > sh.g || sh.qg * sh.spl * 8 > kStreamQregs))
    sh.qg >>= 1;
  sh.ng = qt / sh.qg;
  sh.pr = kStreamMathWarps / sh.ng;
  sh.words_off = sh.cr * sh.row_bytes;
  sh.stage_bytes = (sh.words_off + sh.cr * (kKeyed ? 6 : 4) + 127) / 128 * 128;
  sh.lcap = ((kc + 7) / 8) * 8;
  sh.bc = 2 * sh.cr + 32 < kSortN ? 2 * sh.cr + 32 : kSortN;
  sh.fin = sh.pr * (32 / sh.g);
  const size_t lists = kc > 1 ? (size_t)16 * (sh.lcap + 2 * sh.bc) * 8 : 0;
  const size_t fin = (size_t)qt * sh.fin * 8 * (kKeyed ? 2 : 1);
  const size_t fixed = kStreamHead + lists + fin;
  const size_t ns = fixed < (size_t)kSmemMax ? (kSmemMax - fixed) / sh.stage_bytes : 0;
  sh.ns = (int)(ns < kMaxStages ? ns : kMaxStages);
  sh.lists_off = kStreamHead + (size_t)sh.ns * sh.stage_bytes;
  sh.fin_off = sh.lists_off + lists;
  sh.smem = fixed + (size_t)sh.ns * sh.stage_bytes;
  return sh;
}

// n: rows of each shard entry; rows_per_split: a multiple of cr; words_bulk:
// cr is a multiple of 16 and every entry's row-word columns are 16-byte
// aligned (else the producer warp copies them with plain loads).
template <bool kKeyed>
struct StreamArgs {
  ShardTable t;
  const void* qry;
  const int* q_tenant;
  long long n, rows_per_split;
  int splits, d, nq, qt, kc, with_gate, ld_after, words_bulk;
  int cr, g, spl, ng, pr, ns, lcap, bc, row_bytes, words_off, stage_bytes, fin, lists_off,
      fin_off;
  const float* after_s;
  const RowT<kKeyed>* after_r;
  float* gate_cs;
  int* gate_cr;
  float* cand_s;
  int* cand_r;
};

// A lane's slot vs (8 elements) of a row: elements 4 vs .. 4 vs + 3 and d/2
// + 4 vs .. + 3 (two 16-byte reads, each 512 contiguous bytes over a
// warp). Zeros for a slot past the row.
__device__ __forceinline__ void load_slot(const float* row, int vs, int d, bool live,
                                          float* x) {
  if (!live) {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.f;
    return;
  }
  const float4 lo = *reinterpret_cast<const float4*>(row + 4 * vs);
  const float4 hi = *reinterpret_cast<const float4*>(row + d / 2 + 4 * vs);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// The xor mask m of a lane: sum j of its QG partial sums belongs to query
// j ^ m of its group, so that at every halving step of row_reduce both
// partners send their upper half and keep their lower one (no selects).
template <int QG>
__device__ __forceinline__ int query_xor(int sl, int g) {
  int m = 0;
#pragma unroll
  for (int st = 0; st < 5; ++st) {
    const int o = g >> (st + 1), h = QG >> (st + 1);
    if (o == 0 || h == 0) break;
    if (sl & o) m |= h;
  }
  return m;
}

// Reduce-scatter of one row's QG partial sums over the g lanes sharing the
// row: step ST (offset g >> (ST + 1)) halves the sums a lane holds while it
// holds more than one, then adds its partner's one sum. Lane sl ends with
// query m's full sum (the lanes whose low bits differ hold the same). The
// order of the additions depends on the lanes' places in the row only,
// never on the row's.
template <int QG, int ST = 0>
__device__ __forceinline__ void row_reduce(float (&v)[QG], int g) {
  if constexpr (ST < 5) {
    const int o = g >> (ST + 1);
    if (o == 0) return;
    constexpr int H = QG >> (ST + 1);
    if constexpr (H >= 1) {
#pragma unroll
      for (int j = 0; j < H; ++j) v[j] += __shfl_xor_sync(kFull, v[j + H], o);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], o);
    }
    row_reduce<QG, ST + 1>(v, g);
  }
}

// Stage 1 on the streaming route. Block (split, entry) scans the rows of
// split `split` of shard entry `entry` for all nq <= 16 queries, chunk by
// chunk.
// - Warp 0 produces: lane 0 keeps a chunk's rows (one contiguous byte range)
//   and its row words in flight by bulk copies into a ring of ns stages;
//   the lanes copy the words of a ragged last chunk.
// - Math warps (2 ..): warp w sums query group w % ng (QG queries) over the
//   row phase w / ng. A lane holds its slots of the group's queries in
//   registers, reads its slots of RU rows from the stage (16-byte reads),
//   sums 8 FMAs a slot and query, and the g lanes of a row reduce-scatter
//   the QG sums (row_reduce). The lane left with a query's full sum (its
//   owner) adds madd, or applies the tiers, and folds the score: kc = 1 and
//   the keyed gate into an arg-max in registers (replaced only on a
//   strictly better score; its rows ascend), lists into the query's batch
//   when the score beats the query's threshold (and, in a later pass, ranks
//   after the previous pass's last pair), at a position from a shared
//   atomic. A row's score is the same wherever it sits.
// - Warp 1 keeps the lists, as a warp of the tensor-core route's consumers
//   does (queries g and g + 8 of a quad). Chunks alternate between two
//   batches a query; after each chunk it merges the chunk's batch into the
//   sorted list (merge_pending) when the batch could not take another
//   chunk or the list is not full, and publishes the list's last score as
//   the threshold. At the end it merges what is left, reduces the owners'
//   arg-maxes and writes the split's candidates.
template <int QG, bool kList, bool kKeyed>
__global__ void __launch_bounds__(64 + 32 * kStreamMathWarps, 1)
scan_stage1_stream(const StreamArgs<kKeyed> a) {
  constexpr int SPLMAX = kStreamQregs / (8 * QG);
  constexpr int RU = QG == 1 ? 4 : 2;        // rows a lane sums at once
  constexpr int MW = kStreamMathWarps;
  extern __shared__ __align__(128) uint8_t stream_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(stream_smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* sfull = empty + kMaxStages;   // [2] batches written
  uint64_t* sempty = sfull + 2;           // [2] batches merged
  uint64_t* done = sempty + 2;            // the owners' arg-maxes written
  int* cnt = reinterpret_cast<int*>(stream_smem + 256);         // [2][16] batch sizes
  float* thrs = reinterpret_cast<float*>(stream_smem + 384);    // [16] thresholds
  uint8_t* ring = stream_smem + kStreamHead;
  uint64_t* lists = reinterpret_cast<uint64_t*>(stream_smem + a.lists_off);
  float* fin_s = reinterpret_cast<float*>(stream_smem + a.fin_off);   // [qt][fin]
  int* fin_r = reinterpret_cast<int*>(fin_s + a.qt * a.fin);
  float* gfin_s = reinterpret_cast<float*>(fin_r + a.qt * a.fin);     // keyed gate
  int* gfin_r = reinterpret_cast<int*>(gfin_s + a.qt * a.fin);
  const int stride = a.lcap + 2 * a.bc;   // a query's list and two batches

  const int split = blockIdx.x, entry = blockIdx.y;
  const long long slot = (long long)entry * a.splits + split;
  const int base = (int)a.t.base[entry];
  const long long r_begin = (long long)split * a.rows_per_split;
  const long long r_end = min(r_begin + a.rows_per_split, a.n);
  const int chunks = r_end > r_begin ? (int)((r_end - r_begin + a.cr - 1) / a.cr) : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.ns; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 32 * MW);
    }
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(sfull + b, 32 * MW);
      hopper::mbar_init(sempty + b, 32);
    }
    hopper::mbar_init(done, 32 * MW);
    hopper::mbar_init_fence();
  }
  if (threadIdx.x < 32) {
    cnt[threadIdx.x] = 0;
    if (threadIdx.x < 16) thrs[threadIdx.x] = -INFINITY;
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer
    const uint8_t* emb = static_cast<const uint8_t*>(a.t.emb[entry]);
    const uint8_t* words = static_cast<const uint8_t*>(a.t.words[entry]);
    const uint8_t* alive = a.t.alive[entry];
    const uint8_t* sup = a.t.is_super[entry];
    const uint32_t wbytes = (uint32_t)a.cr * (kKeyed ? 6 : 4);
    for (int j = 0; j < chunks; ++j) {
      const int s = j % a.ns;
      if (j >= a.ns) hopper::mbar_wait(empty + s, ((j / a.ns) - 1) & 1);
      const long long r0 = r_begin + (long long)j * a.cr;
      const int rows = (int)min((long long)a.cr, r_end - r0);
      uint8_t* st = ring + (size_t)s * a.stage_bytes;
      uint8_t* wst = st + a.words_off;
      const bool bulk_words = a.words_bulk && rows == a.cr;
      if (!bulk_words) {
        for (int i = lane; i < a.cr; i += 32) {
          const bool in = i < rows;
          reinterpret_cast<uint32_t*>(wst)[i] =
              in ? reinterpret_cast<const uint32_t*>(words)[r0 + i] : 0u;
          if constexpr (kKeyed) {
            wst[4 * a.cr + i] = in ? alive[r0 + i] : 0;
            wst[5 * a.cr + i] = in ? sup[r0 + i] : 0;
          }
        }
        __threadfence_block();
        __syncwarp();
      }
      if (lane == 0) {
        const uint32_t eb = (uint32_t)rows * a.row_bytes;
        hopper::mbar_arrive_expect_tx(full + s, eb + (bulk_words ? wbytes : 0u));
        hopper::bulk_load(st, emb + r0 * a.row_bytes, eb, full + s);
        if (bulk_words) {
          hopper::bulk_load(wst, words + 4 * r0, 4 * a.cr, full + s);
          if constexpr (kKeyed) {
            hopper::bulk_load(wst + 4 * a.cr, alive + r0, a.cr, full + s);
            hopper::bulk_load(wst + 5 * a.cr, sup + r0, a.cr, full + s);
          }
        }
      }
    }
    return;
  }

  if (warp == 1) {
    // ---- the lists' keeper: queries qa = g8 and qb = g8 + 8 of lane (g8, tq)
    const int g8 = lane >> 2, tq = lane & 3;
    const int qa = g8, qb = g8 + 8;
    const bool va = qa < a.nq, vb = qb < a.nq;
    if constexpr (kList) {
      int m_a = 0, m_b = 0, nb_a = 0, nb_b = 0;
      float thr_a = -INFINITY, thr_b = -INFINITY;
      for (int j = 0; j < chunks + 2; ++j) {
        // Chunk j's batch; past the last chunk, what is left in both.
        const int b = j & 1;
        const bool last = j >= chunks;
        if (!last) hopper::mbar_wait(sfull + b, (j >> 1) & 1);
        nb_a = va ? cnt[16 * b + qa] : 0;
        nb_b = vb ? cnt[16 * b + qb] : 0;
        merge_pending(lists, a.lcap, 2 * a.bc, a.kc,
                      nb_a > 0 && (last || nb_a > a.bc - a.cr || m_a < a.kc),
                      nb_b > 0 && (last || nb_b > a.bc - a.cr || m_b < a.kc), m_a, m_b,
                      nb_a, nb_b, thr_a, thr_b, b * a.bc);
        if (tq == 0) {
          if (va) { thrs[qa] = thr_a; cnt[16 * b + qa] = nb_a; }
          if (vb) { thrs[qb] = thr_b; cnt[16 * b + qb] = nb_b; }
        }
        __syncwarp();
        if (!last) hopper::mbar_arrive(sempty + b);
      }
      for (int i = 0; i < 16 && i < a.nq; ++i) {
        const int m = __shfl_sync(kFull, i < 8 ? m_a : m_b, 4 * (i & 7));
        const uint64_t* L = lists + i * stride;
        const long long o = (slot * a.nq + i) * a.kc;
        for (int idx = lane; idx < a.kc; idx += 32) {
          const bool live = idx < m;
          const uint64_t key = live ? L[idx] : 0ull;
          a.cand_s[o + idx] = live ? key_score(key) : -INFINITY;
          a.cand_r[o + idx] = live ? key_row(key) : INT32_MAX;
        }
      }
    }
    if (!kList || (kKeyed && a.with_gate)) {
      hopper::mbar_wait(done, 0);
      for (int q = lane; q < a.nq; q += 32) {
        if constexpr (!kList) {
          float bs = -INFINITY;
          int br = INT32_MAX;
          for (int i = 0; i < a.fin; ++i) {
            const float s = fin_s[q * a.fin + i];
            const int r = fin_r[q * a.fin + i];
            if (better(s, r, bs, br)) { bs = s; br = r; }
          }
          a.cand_s[slot * a.nq + q] = bs;
          a.cand_r[slot * a.nq + q] = br;
        }
        if constexpr (kKeyed) {
          if (a.with_gate) {
            float gs = -INFINITY;
            int gr = INT32_MAX;
            for (int i = 0; i < a.fin; ++i) {
              const float s = gfin_s[q * a.fin + i];
              const int r = gfin_r[q * a.fin + i];
              if (better(s, r, gs, gr)) { gs = s; gr = r; }
            }
            a.gate_cs[slot * a.nq + q] = gs;
            a.gate_cr[slot * a.nq + q] = gr;
          }
        }
      }
    }
    return;
  }

  // ---- math warps: warp mwi sums query group grp over row phase ph; lane
  // (sub, sl) takes slots sl, sl + g, .. of rows ph * rpw + sub, + P, ..
  const int mwi = warp - 2;
  const int grp = mwi % a.ng, ph = mwi / a.ng;
  const int rpw = 32 / a.g;
  const int sub = lane / a.g, sl = lane % a.g;
  const int P = a.pr * rpw;
  const int r_lane = ph * rpw + sub;
  const int slots = a.d / 8;
  const int m = query_xor<QG>(sl, a.g);
  const int q = grp * QG + m;                    // the query this lane may own
  const bool owner = (sl & (a.g / QG - 1)) == 0;
  const bool qlive = owner && q < a.nq;
  float qv[QG][SPLMAX * 8];
  const float* qry = static_cast<const float*>(a.qry);
#pragma unroll
  for (int j = 0; j < QG; ++j) {
    const int qj = grp * QG + (j ^ m);
#pragma unroll
    for (int s = 0; s < SPLMAX; ++s) {
      if (s < a.spl) {
        const int vs = s * a.g + sl;
        load_slot(qry + (long long)(qj < a.nq ? qj : 0) * a.d, vs, a.d,
                  vs < slots && qj < a.nq, &qv[j][8 * s]);
      }
    }
  }
  float ts = INFINITY;
  long long ta = -1;
  if (qlive && a.after_s) {
    ts = a.after_s[(long long)q * a.ld_after];
    ta = (long long)a.after_r[(long long)q * a.ld_after];
  }
  const bool first_pass = a.after_s == nullptr;
  int ten = 0;
  if constexpr (kKeyed) ten = qlive ? a.q_tenant[q] : kNoTenant;
  float bs = -INFINITY, gs = -INFINITY;
  int br = INT32_MAX, gr = INT32_MAX;
  float thr = -INFINITY;
  uint64_t* qlist = lists + (qlive ? q : 0) * stride + a.lcap;
  const int iters = (a.cr + P * RU - 1) / (P * RU);

  for (int j = 0; j < chunks; ++j) {
    const int s = j % a.ns, b = j & 1;
    hopper::mbar_wait(full + s, (j / a.ns) & 1);
    if constexpr (kList) {
      if (j >= 2) hopper::mbar_wait(sempty + b, ((j >> 1) - 1) & 1);
      thr = qlive ? thrs[q] : INFINITY;
    }
    const long long r0 = r_begin + (long long)j * a.cr;
    const int rows = (int)min((long long)a.cr, r_end - r0);
    const int g0 = base + (int)r0;               // global row of row 0
    const uint8_t* st = ring + (size_t)s * a.stage_bytes;
    const uint8_t* wst = st + a.words_off;
    for (int it = 0; it < iters; ++it) {
      float acc[RU][QG];
#pragma unroll
      for (int u = 0; u < RU; ++u)
#pragma unroll
        for (int jj = 0; jj < QG; ++jj) acc[u][jj] = 0.f;
#pragma unroll
      for (int sidx = 0; sidx < SPLMAX; ++sidx) {
        if (sidx < a.spl) {
          const int vs = sidx * a.g + sl;
          const bool live = vs < slots;
#pragma unroll
          for (int u = 0; u < RU; ++u) {
            const int row = r_lane + (it * RU + u) * P;
            float x[8];
            // A row past the chunk sums zeros and reads nothing.
            load_slot(reinterpret_cast<const float*>(
                          st + (size_t)(row < rows ? row : 0) * a.row_bytes),
                      vs, a.d, live && row < rows, x);
#pragma unroll
            for (int e = 0; e < 8; ++e)
#pragma unroll
              for (int jj = 0; jj < QG; ++jj)
                acc[u][jj] = fmaf(x[e], qv[jj][8 * sidx + e], acc[u][jj]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) row_reduce<QG>(acc[u], a.g);
      if (qlive) {
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          const int row = r_lane + (it * RU + u) * P;
          if (row < rows) {
            const int grow = g0 + row;
            float sc;
            if constexpr (kKeyed) {
              const int key = wst[4 * a.cr + row]
                                  ? reinterpret_cast<const int*>(wst)[row] : kNoTenant;
              const bool sp = wst[5 * a.cr + row];
              const uint32_t cc = __float_as_uint(kNeg);
              sc = tier_score<true>(acc[u][0], (uint32_t)(sp ? kNoTenant : key), cc, ten);
              if (a.with_gate) {
                const float sg = gate_score(acc[u][0], (uint32_t)(sp ? key : kNoTenant), cc,
                                            ten);
                gr = sg > gs ? grow : gr;
                gs = sg > gs ? sg : gs;
              }
            } else {
              sc = acc[u][0] + reinterpret_cast<const float*>(wst)[row];
            }
            if (first_pass || ranks_after(sc, grow, ts, ta)) {
              if constexpr (!kList) {
                br = sc > bs ? grow : br;
                bs = sc > bs ? sc : bs;
              } else if (sc > thr) {
                const int pos = atomicAdd(cnt + 16 * b + q, 1);
                qlist[b * a.bc + pos] = list_key(sc, grow);
              }
            }
          }
        }
      }
    }
    hopper::mbar_arrive(empty + s);
    if constexpr (kList) hopper::mbar_arrive(sfull + b);
  }
  if (qlive) {
    const int i = q * a.fin + ph * rpw + sub;
    if constexpr (!kList) { fin_s[i] = bs; fin_r[i] = br; }
    if constexpr (kKeyed) {
      if (a.with_gate) { gfin_s[i] = gs; gfin_r[i] = gr; }
    }
  }
  hopper::mbar_arrive(done);
}

template <int QG, bool kList, bool kKeyed>
cudaError_t launch_stream(const StreamArgs<kKeyed>& w, size_t smem, int shards,
                          cudaStream_t stream) {
  auto kernel = scan_stage1_stream<QG, kList, kKeyed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(w.splits, shards), 64 + 32 * kStreamMathWarps, smem, stream>>>(w);
  return cudaGetLastError();
}

template <bool kList, bool kKeyed>
cudaError_t launch_stream_qg(int qg, const StreamArgs<kKeyed>& w, size_t smem, int shards,
                             cudaStream_t st) {
  switch (qg) {
    case 1: return launch_stream<1, kList, kKeyed>(w, smem, shards, st);
    case 2: return launch_stream<2, kList, kKeyed>(w, smem, shards, st);
    default: return launch_stream<4, kList, kKeyed>(w, smem, shards, st);
  }
}

// The query tile of the streaming route: nq rounded up to a power of two.
inline int stream_tile(int nq) {
  int qt = 1;
  while (qt < nq) qt <<= 1;
  return qt;
}

// Splits of each of `shards` entries of n rows on the streaming route: one
// wave of blocks (the ring takes an SM's shared memory, so one block an
// SM), no split shorter than four chunks.
template <bool kKeyed>
int stream_splits(long long n, int shards, int nq, int kmax, int sms, int d) {
  const StreamShape sh = stream_shape<kKeyed>(d, kmax < kMaxK ? kmax : kMaxK, stream_tile(nq));
  const long long chunks = (n + sh.cr - 1) / sh.cr;
  long long want = sms / shards;
  if (want > chunks / 4) want = chunks / 4;
  if (want > kMaxSplits / shards) want = kMaxSplits / shards;
  if (want < 1) want = 1;
  return (int)want;
}

// Everything one scan needs: a table of `shards` arenas of n rows each
// (one entry at base 0 for a single device), the queries and the outputs;
// the mode's unused pointers are null. mask_dead writes tail_row for the
// masked pairs (the grouped keyed scan's global sentinel).
template <bool kKeyed>
struct Scan {
  using R = RowT<kKeyed>;
  ShardTable t;
  int shards;
  int is_bf16;
  const void* qry;
  const int* q_tenant;
  const int* k_q;
  long long n;
  int d, nq, k_out, kmax, splits;   // splits of each entry
  R tail_row;
  int mask_dead;
  float* gate_cs;
  int* gate_cr;
  float* cand_s;
  int* cand_r;
  float* gate_s;
  int* gate_r;
  float* out_s;
  R* out_r;
};

template <typename T, int BQ, int MQ, int MR, bool kKeyed>
cudaError_t launch_stage1(const Scan<kKeyed>& a, int kc, int k0,
                          long long rows_per_split, cudaStream_t stream) {
  auto kernel = scan_stage1<T, BQ, MQ, MR, kKeyed>;
  const size_t smem = stage1_smem<kKeyed>(BQ, kc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nq + BQ - 1) / BQ, a.splits, a.shards);
  kernel<<<grid, kThreads, smem, stream>>>(
      a.t, static_cast<const T*>(a.qry), a.q_tenant, a.n, a.splits, a.d, a.nq, kc,
      rows_per_split, kKeyed && k0 == 0, k0 ? a.out_s + k0 - 1 : nullptr,
      k0 ? a.out_r + k0 - 1 : nullptr, a.k_out, a.gate_cs, a.gate_cr,
      a.cand_s, a.cand_r);
  return cudaGetLastError();
}

template <typename T, bool kKeyed>
cudaError_t launch_stage1_for(const Scan<kKeyed>& a, int kc, int k0,
                              long long rows_per_split, cudaStream_t stream) {
  switch (query_tile(a.nq)) {
    case 4: return launch_stage1<T, 4, 1, 2, kKeyed>(a, kc, k0, rows_per_split, stream);
    case 8: return launch_stage1<T, 8, 1, 4, kKeyed>(a, kc, k0, rows_per_split, stream);
    case 16: return launch_stage1<T, 16, 1, 8, kKeyed>(a, kc, k0, rows_per_split, stream);
    default: return launch_stage1<T, 64, 4, 8, kKeyed>(a, kc, k0, rows_per_split, stream);
  }
}

// Row splits of each shard entry of n rows on a route for this shape (the
// scratch's leading dimension is shards times this).
template <bool kKeyed>
int scan_splits(long long n, int shards, int nq, int kmax, int route, int sms, int d) {
  if (shards < 1 || shards > kMaxShards || n < 1 || d < 8) return 1;
  if (route == kRouteWgmma) return wg_splits(n, shards, nq, kmax, sms);
  if (route == kRouteStream) return stream_splits<kKeyed>(n, shards, nq, kmax, sms, d);
  return fma_splits(n, shards, nq, sms);
}

// The tensor-core stage 1 of one pass (bf16 arenas only).
template <bool kKeyed>
cudaError_t launch_stage1_wg(const Scan<kKeyed>& a, int kc, int k0, cudaStream_t st) {
  if (!a.is_bf16) return cudaErrorInvalidValue;
  const WgShape sh = wg_shape(a.nq, kc);
  const long long rtiles = (a.n + sh.bn - 1) / sh.bn;
  WgArgs<kKeyed> w{};
  w.t = a.t;
  w.q_tenant = a.q_tenant;
  w.n = a.n;
  w.rows_per_split = ((rtiles + a.splits - 1) / a.splits) * sh.bn;
  w.splits = a.splits; w.nq = a.nq; w.kc = kc; w.panels = (a.d + 63) / 64;
  w.ns = sh.ns; w.lcap = sh.lcap; w.bcap = sh.bcap;
  w.with_gate = kKeyed && k0 == 0; w.ld_after = a.k_out;
  w.after_s = k0 ? a.out_s + k0 - 1 : nullptr;
  w.after_r = k0 ? a.out_r + k0 - 1 : nullptr;
  w.gate_cs = a.gate_cs; w.gate_cr = a.gate_cr; w.cand_s = a.cand_s; w.cand_r = a.cand_r;
  if (sh.list) return launch_stage1_wgmma<1, 128, true, kKeyed>(a.shards, a.qry, a.d, w, st);
  if (sh.wgs == 2) return launch_stage1_wgmma<2, 256, false, kKeyed>(a.shards, a.qry, a.d, w, st);
  return launch_stage1_wgmma<1, 256, false, kKeyed>(a.shards, a.qry, a.d, w, st);
}

// The streaming stage 1 of one pass (f32 arenas, Q <= 16).
template <bool kKeyed>
cudaError_t launch_stage1_stream(const Scan<kKeyed>& a, int kc, int k0, cudaStream_t st) {
  if (a.is_bf16 || a.nq > kStreamMaxQ) return cudaErrorInvalidValue;
  const int qt = stream_tile(a.nq);
  const StreamShape sh = stream_shape<kKeyed>(a.d, kc, qt);
  if (sh.ns < 2 || sh.pr < 1 || sh.qg * sh.spl * 8 > kStreamQregs)
    return cudaErrorInvalidValue;
  StreamArgs<kKeyed> w{};
  w.t = a.t;
  w.qry = a.qry; w.q_tenant = a.q_tenant;
  w.n = a.n;
  const long long chunks = (a.n + sh.cr - 1) / sh.cr;
  w.rows_per_split = ((chunks + a.splits - 1) / a.splits) * sh.cr;
  w.splits = a.splits; w.d = a.d; w.nq = a.nq; w.qt = qt; w.kc = kc;
  w.with_gate = kKeyed && k0 == 0; w.ld_after = a.k_out;
  // Bulk copies of the row words need 16-byte aligned columns in the stage
  // and in memory.
  w.words_bulk = sh.cr % 16 == 0;
  for (int p = 0; p < a.shards; ++p) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(a.t.words[p]) |
                           (kKeyed ? reinterpret_cast<uintptr_t>(a.t.alive[p]) |
                                         reinterpret_cast<uintptr_t>(a.t.is_super[p])
                                   : 0);
    if (bits % 16) w.words_bulk = 0;
  }
  w.cr = sh.cr; w.g = sh.g; w.spl = sh.spl; w.ng = sh.ng; w.pr = sh.pr; w.ns = sh.ns;
  w.lcap = sh.lcap; w.bc = sh.bc; w.row_bytes = sh.row_bytes; w.words_off = sh.words_off;
  w.stage_bytes = sh.stage_bytes; w.fin = sh.fin;
  w.lists_off = (int)sh.lists_off; w.fin_off = (int)sh.fin_off;
  w.after_s = k0 ? a.out_s + k0 - 1 : nullptr;
  w.after_r = k0 ? a.out_r + k0 - 1 : nullptr;
  w.gate_cs = a.gate_cs; w.gate_cr = a.gate_cr; w.cand_s = a.cand_s; w.cand_r = a.cand_r;
  return kc > 1 ? launch_stream_qg<true, kKeyed>(sh.qg, w, sh.smem, a.shards, st)
                : launch_stream_qg<false, kKeyed>(sh.qg, w, sh.smem, a.shards, st);
}

// Stage 1 on `route` and stage 2 for every pass of 128 list entries up to
// kmax: two launches a pass, whatever the number of shard entries, each
// added to *launched (when not null) once the card has taken it. A launch
// the card refuses returns its error: no route stands in for another.
template <bool kKeyed>
int run_scan(const Scan<kKeyed>& a, int route, int* launched, cudaStream_t st) {
  if (a.d % 8 != 0 || a.kmax < 1 || a.kmax > a.k_out || a.shards < 1 ||
      a.shards > kMaxShards || a.n < 1 || a.k_out > a.shards * a.n || a.nq < 1 ||
      a.splits < 1 || (long long)a.splits * a.shards > kMaxSplits ||
      (route != kRouteFma && route != kRouteWgmma && route != kRouteStream))
    return (int)cudaErrorInvalidValue;
  const long long rtiles = (a.n + kBR - 1) / kBR;
  const long long rows_per_split = ((rtiles + a.splits - 1) / a.splits) * kBR;
  for (int k0 = 0; k0 < a.kmax; k0 += kMaxK) {
    const int kc = a.kmax - k0 < kMaxK ? a.kmax - k0 : kMaxK;
    cudaError_t err;
    if (route == kRouteWgmma)
      err = launch_stage1_wg<kKeyed>(a, kc, k0, st);
    else if (route == kRouteStream)
      err = launch_stage1_stream<kKeyed>(a, kc, k0, st);
    else if (a.is_bf16)
      err = launch_stage1_for<uint16_t, kKeyed>(a, kc, k0, rows_per_split, st);
    else
      err = launch_stage1_for<float, kKeyed>(a, kc, k0, rows_per_split, st);
    if (err != cudaSuccess) return (int)err;
    if (launched) ++*launched;
    scan_merge<RowT<kKeyed>><<<a.nq, kThreads, 0, st>>>(
        a.gate_cs, a.gate_cr, a.cand_s, a.cand_r, a.shards * a.splits, a.nq, kc, k0,
        a.kmax, a.k_q, a.tail_row, a.mask_dead, kKeyed && k0 == 0, a.gate_s, a.gate_r,
        a.out_s, a.out_r, a.k_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (launched) ++*launched;
  }
  return 0;
}


// ---------------------------------------------------------------------------
// Ingest mode (exported by ingest_topk.cu): the whole-arena scan of the fused
// ingest
// ---------------------------------------------------------------------------
//
// Replaces the scan of lazzaro_tpu/core/state.py:_ingest_scan_core (and of
// _arena_link_candidates_multi), which the JAX package computes with nt_dot
// + lax.top_k, not with Pallas. For every query q (a new fact's embedding in
// the arena dtype) and arena row r, one tenant a launch:
//     s[q, r]      = dot_f32(qd[q], emb[r])
//     probe[q]     = top-1 of s over rows whose flag bit 0 is set (alive, the
//                    tenant's, not a super node, not probe-excluded)
//     list_m[q, :] = top-k of s over rows whose flag bit 1 is set (bit 0 and
//                    not link-excluded) and, for shard mode m, with
//                    shard[r] == q_shard[q] (1), != (-1) or either (0)
// A masked pair scores exactly NEG, so a mode with fewer eligible rows than
// k lists the lowest other rows at NEG (lax.top_k over jnp.where(m, s,
// NEG_INF)), and ties go to the lowest row. Rows are i32; k <= 128; at most
// two modes.
//
// Design. One pass over the arena feeds every mask from one score tile: the
// [Q, N] f32 scores never reach HBM. Stage 1 sums each row as the additive
// mode's route for the same dtype does, so that a probe scores bit for bit
// what masked_topk's dedup probe scores on that route:
// - bf16: the tensor-core product (wg_produce, wg_product) in one geometry
//   for every k: one consumer warpgroup of 64 queries and tiles of 128 rows
//   (m64n128k16), the list epilogue's. The kc = 1 epilogue's 256-row tiles
//   and second warpgroup would double the shared memory the lists take (two
//   modes of up to 64 x 128 keys of 8 bytes). Each tile is folded from the
//   accumulator registers, as scan_stage1_wgmma's list epilogue folds it:
//   the probe is the kc = 1 arg-max in registers; each mode filters its
//   masked scores against the query's threshold into a batch and merges it
//   into its sorted list (merge_pending). The modes share one batch of half
//   a tile, filtered and merged in two passes a tile: a merge after every
//   pass keeps two lists of 128 and the batch beside a ring of two stages.
//   (A first form held the tile's sums in shared memory and folded a query
//   a warp, the FMA route's way: 517 ms at Q = 8,192 on an H100, its warps
//   waiting on each dependent step; PERF.md.)
// - f32: the FMA product (fma_tile) at every Q, in its 4/8/16/64-query
//   tiles of 128 rows, its sums to shared memory, then one warp a query
//   folds its row (ingest_fold): the probe as a warp arg-max, each mode's
//   list by warp_list_insert (the FMA route's list epilogue) under its own
//   mask. The FMA product, not the fold, bounds this route. The streaming
//   route, which masked_topk takes for f32 up to 16 queries, sums in
//   another order: there an f32 probe matches masked_topk within rounding,
//   not bit for bit.
// Stage 2 is scan_merge, one launch a mode, the probe riding on the first.
// What bounds it: at the fill's mega-batch (Q = 8,192 over 1,048,576 x 768
// bf16) the product's 13.2 TFLOP, 13.3 ms at the bf16 tensor rate; at one
// conversation end (Q = 16) the arena's 1.61 GB, 0.48 ms. The folds run on
// the consumer warps between two products, so a tile pays both.

constexpr int kIngestModes = 2;
constexpr int kIngestBN = kBR;     // rows of a tile on both routes

struct IngestArgs {
  const void* emb;                 // [n, d] f32 or bf16
  const void* qry;                 // [nq, d] in the emb dtype
  const uint8_t* flags;            // [n] bit 0 probe mask, bit 1 link mask
  const int* shard;                // [n]
  const int* q_shard;              // [nq]
  long long n, rows_per_split;
  int d, nq, k, modes, with_probe, splits, panels, ns;
  int mode[kIngestModes];          // 1 same shard, -1 other shards, 0 any
  float* probe_cs;                 // [splits, nq] split probes
  int* probe_cr;
  float* cand_s;                   // [modes, splits, nq, k] split lists
  int* cand_r;
};

// The whole warp folds one query's row of a tile, scq[c] for c < cols (the
// first `live` columns rows row0 ..., with flags fl[c] and shard sh[c]),
// into its probe (*gs, *gr) and its lists (ls + m * lstride, lr + m *
// lstride, k entries each). A live pair scores its sum + 0.0f (-0 becomes
// +0, as masked_topk's madd of 0 makes it), a masked one NEG.
__device__ __forceinline__ void ingest_fold(const float* scq, const uint32_t* fl, const int* sh,
                                            int cols, int live, int row0, int qsh,
                                            const IngestArgs& a, float* gs, int* gr, float* ls,
                                            int* lr, int lstride) {
  const int lane = threadIdx.x & 31;
  if (a.with_probe) {
    float bs = -INFINITY;
    int br = INT32_MAX;
    for (int c = lane; c < live; c += 32) {
      const float s = (fl[c] & 1u) ? scq[c] + 0.0f : kNeg;
      if (better(s, row0 + c, bs, br)) { bs = s; br = row0 + c; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(kFull, bs, o);
      const int r2 = __shfl_xor_sync(kFull, br, o);
      if (better(s2, r2, bs, br)) { bs = s2; br = r2; }
    }
    if (lane == 0 && better(bs, br, *gs, *gr)) { *gs = bs; *gr = br; }
    __syncwarp();
  }
  for (int m = 0; m < a.modes; ++m) {
    const int mode = m == 0 ? a.mode[0] : a.mode[1];   // no local copy of a
    for (int c = 0; c < cols; c += 32) {
      const int cc = c + lane;
      const bool in = cc < live;
      float s = kNeg;
      if (in && (fl[cc] & 2u) && (mode == 0 || (sh[cc] == qsh) == (mode == 1)))
        s = scq[cc] + 0.0f;
      warp_list_insert(ls + m * lstride, lr + m * lstride, a.k, s, row0 + c, in);
    }
  }
}

// Shared memory of the FMA ingest stage 1 for a query tile of bq.
inline size_t ingest_fma_smem(int bq, int modes, int k) {
  return sizeof(float) * ((size_t)(bq + kBR) * kLD + (size_t)bq * (kBR + 1)) +
         sizeof(int) * (3 * (size_t)bq + 2 * (size_t)kBR) + 8 * (size_t)modes * bq * k;
}

// Stage 1 of the ingest mode on the FMA route (f32). Block (x, y) scores
// queries x * BQ .. against the rows of split y, tile by tile: fma_tile's
// sums to shared memory, then one warp a query folds its row.
template <int BQ, int MQ, int MR>
__global__ void __launch_bounds__(kThreads) ingest_stage1_fma(const IngestArgs a) {
  constexpr int TQ = BQ / MQ;
  constexpr int TR = kThreads / TQ;
  static_assert(TR * MR == kBR, "thread grid must cover one row tile");
  extern __shared__ float smem[];
  float* qs = smem;                                        // [BQ][kLD]
  float* rs = qs + BQ * kLD;                               // [kBR][kLD]
  float* sc = rs + kBR * kLD;                              // [BQ][kBR + 1] sums
  float* gs = sc + BQ * (kBR + 1);                         // [BQ] probe score
  int* gr = reinterpret_cast<int*>(gs + BQ);               // [BQ] probe row
  int* qsh = gr + BQ;                                      // [BQ] query shard
  uint32_t* fl = reinterpret_cast<uint32_t*>(qsh + BQ);    // [kBR] row flags
  int* sh = reinterpret_cast<int*>(fl + kBR);              // [kBR] row shard
  float* ls = reinterpret_cast<float*>(sh + kBR);          // [modes][BQ][k]
  int* lr = reinterpret_cast<int*>(ls + a.modes * BQ * a.k);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int tq = tid / TR;
  const int tr = tid % TR;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * a.rows_per_split;
  const long long r_end = min(r_begin + a.rows_per_split, a.n);
  const int lstride = BQ * a.k;

  for (int e = tid; e < a.modes * lstride; e += kThreads) {
    ls[e] = -INFINITY;
    lr[e] = INT32_MAX;
  }
  for (int e = tid; e < BQ; e += kThreads) {
    gs[e] = -INFINITY;
    gr[e] = INT32_MAX;
    qsh[e] = q0 + e < a.nq ? a.q_shard[q0 + e] : 0;
  }
  for (long long r0 = r_begin; r0 < r_end; r0 += kBR) {
    if (tid < kBR) {
      const long long r = r0 + tid;
      fl[tid] = r < r_end ? a.flags[r] : 0u;
      sh[tid] = r < r_end ? a.shard[r] : 0;
    }
    float acc[MQ][MR];
    fma_tile<float, BQ, MQ, MR>(acc, qs, rs, static_cast<const float*>(a.qry),
                                static_cast<const float*>(a.emb), q0, a.nq, r0, r_end, a.d);
#pragma unroll
    for (int j = 0; j < MR; ++j)
#pragma unroll
      for (int i = 0; i < MQ; ++i) sc[(tq + i * TQ) * (kBR + 1) + tr + j * TR] = acc[i][j];
    __syncthreads();
    const int live = (int)min((long long)kBR, r_end - r0);
    for (int qi = warp; qi < BQ; qi += kWarps) {
      if (q0 + qi >= a.nq) break;
      ingest_fold(sc + qi * (kBR + 1), fl, sh, kBR, live, (int)r0, qsh[qi], a, gs + qi, gr + qi,
                  ls + qi * a.k, lr + qi * a.k, lstride);
    }
    __syncthreads();
  }

  if (a.with_probe) {
    for (int e = tid; e < BQ; e += kThreads) {
      if (q0 + e < a.nq) {
        a.probe_cs[(long long)split * a.nq + q0 + e] = gs[e];
        a.probe_cr[(long long)split * a.nq + q0 + e] = gr[e];
      }
    }
  }
  for (int e = tid; e < a.modes * lstride; e += kThreads) {
    const int m = e / lstride, qi = (e % lstride) / a.k, j = e % a.k;
    if (q0 + qi < a.nq) {
      const long long o = (((long long)m * a.splits + split) * a.nq + q0 + qi) * a.k + j;
      a.cand_s[o] = ls[e];
      a.cand_r[o] = lr[e];
    }
  }
}

// Columns of a tile one filter pass of the tensor-core ingest stage takes:
// a query's batch holds the survivors of one pass.
constexpr int kIngestHalf = kIngestBN / 2;

__host__ __device__ inline int ingest_lcap(int k) { return (k + 7) / 8 * 8; }

// Shared memory of the tensor-core ingest stage 1 with ns ring stages: 1 KB
// of alignment slack, the ring and its barriers, two buffers of a tile's two
// row words, and per query its mode lists (lcap keys each) and one batch.
inline size_t ingest_wg_smem(int ns, int modes, int k) {
  const size_t stage = (size_t)(64 + kIngestBN) * kRowBytes;
  return 1024 + ns * (stage + 16) + 16 * (size_t)kIngestBN +
         (size_t)64 * (modes * ingest_lcap(k) + kIngestHalf) * 8;
}

// A score of the ingest mode from a tile's sum and its row words: past the
// split's end -inf (never a candidate), a pair outside the mask NEG, a live
// one the sum + 0.0f. f is the row's flags with bit 2 set for a row in the
// split; the probe takes bit 0, mode `mode` bit 1 and the shard match.
__device__ __forceinline__ float ingest_probe_score(float acc, uint32_t f) {
  return (f & 4u) ? ((f & 1u) ? acc + 0.0f : kNeg) : -INFINITY;
}

__device__ __forceinline__ float ingest_mode_score(float acc, uint32_t f, int sh, int qsh,
                                                   int mode) {
  const bool ok = (f & 2u) && (mode == 0 || (sh == qsh) == (mode == 1));
  return (f & 4u) ? (ok ? acc + 0.0f : kNeg) : -INFINITY;
}

// Stage 1 of the ingest mode on the tensor cores (bf16). Block (x, y) scores
// queries x * 64 .. against the rows of split y in tiles of BN rows:
// warpgroup 1's one thread produces (wg_produce), warpgroup 0 runs the
// product (wg_product) and folds each tile from its registers, as the list
// epilogue of scan_stage1_wgmma does: the probe is an arg-max in registers;
// each mode, in two passes of half a tile, masks its scores, sends those
// above the query's threshold to the query's batch (positions from a quad
// prefix sum) and merges the batch into the mode's sorted list
// (merge_pending), which raises the threshold to the list's last.
template <int BN>
__global__ void __launch_bounds__(256, 1)
ingest_stage1_wgmma(const __grid_constant__ CUtensorMap map_e,
                    const __grid_constant__ CUtensorMap map_q, const IngestArgs a) {
  constexpr int NF = BN / 2;                  // accumulator registers a thread
  constexpr int STAGE = (64 + BN) * kRowBytes;
  constexpr int HC = BN / 16;                 // 8-column chunks of a pass
  static_assert(BN == 2 * kIngestHalf && BN == 128, "one row word a consumer thread");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.ns * STAGE);
  uint64_t* empty = full + a.ns;
  uint32_t* cols = reinterpret_cast<uint32_t*>(empty + a.ns);    // [2][flags, shard][BN]
  uint64_t* lists = reinterpret_cast<uint64_t*>(cols + 4 * BN);  // [64][modes lists, batch]
  const int lcap = ingest_lcap(a.k);
  const int stride = a.modes * lcap + kIngestHalf;

  const int q0 = blockIdx.x * 64;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * a.rows_per_split;
  const long long r_end = min(r_begin + a.rows_per_split, a.n);
  const int tiles = r_end > r_begin ? (int)((r_end - r_begin + BN - 1) / BN) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.ns; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128)
      wg_produce<1, BN>(&map_q, &map_e, ring, full, empty, a.ns, tiles, a.panels, q0, r_begin);
    return;
  }

  // ---- consumers: this thread's query rows a and b of the accumulator
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int la = 16 * warp + g, lb = la + 8;
  const int qa = q0 + la, qb = qa + 8;
  const bool va = qa < a.nq, vb = qb < a.nq;
  const int qs_a = va ? a.q_shard[qa] : 0, qs_b = vb ? a.q_shard[qb] : 0;
  const int mode0 = a.mode[0], mode1 = a.mode[1];
  float bs_a = -INFINITY, bs_b = -INFINITY;
  int br_a = INT32_MAX, br_b = INT32_MAX;
  // Per mode: the sorted list's length and the score a candidate must beat
  // (the list's last once it holds k; +inf for a query past nq). The batch
  // is shared by the modes and empty between passes.
  int m_a[kIngestModes] = {0, 0}, m_b[kIngestModes] = {0, 0};
  float thr_a[kIngestModes], thr_b[kIngestModes];
#pragma unroll
  for (int m = 0; m < kIngestModes; ++m) {
    thr_a[m] = va ? -INFINITY : INFINITY;
    thr_b[m] = vb ? -INFINITY : INFINITY;
  }
  int nb_a = 0, nb_b = 0;
  uint64_t* wlists = lists + 16 * warp * stride;   // this warp's 16 queries
  uint64_t* Ba = lists + la * stride + a.modes * lcap;
  uint64_t* Bb = lists + lb * stride + a.modes * lcap;

  float acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    const long long r0 = r_begin + (long long)t * BN;
    const int g0 = (int)r0;                       // row of column 0
    const long long r = r0 + tid;
    const uint32_t fword = r < r_end ? (uint32_t)a.flags[r] | 4u : 0u;
    const int sword = r < r_end ? a.shard[r] : 0;
    wg_product<1, BN>(acc, ring, full, empty, a.ns, t, a.panels, 0, tid);
    // Buffer t % 2 was last read in tile t - 2's epilogue, which every
    // thread finished before tile t - 1's barrier.
    uint32_t* colF = cols + (t & 1) * 2 * BN;
    const int* colS = reinterpret_cast<const int*>(colF + BN);
    colF[tid] = fword;
    reinterpret_cast<int*>(colF + BN)[tid] = sword;
    hopper::named_sync(1, 128);

    // Fragment element 4c + e is row la, column 8c + 2tq + e; 4c + 2 + e
    // row lb. A thread's columns ascend, so an arg-max replaced only on a
    // strictly better score keeps the lowest row.
    if (a.with_probe) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const uint2 fw = *reinterpret_cast<const uint2*>(colF + 8 * c + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = g0 + 8 * c + 2 * tq + e;
          const uint32_t f = e ? fw.y : fw.x;
          const float sa = ingest_probe_score(acc[4 * c + e], f);
          const float sb = ingest_probe_score(acc[4 * c + 2 + e], f);
          br_a = sa > bs_a ? row : br_a;
          bs_a = sa > bs_a ? sa : bs_a;
          br_b = sb > bs_b ? row : br_b;
          bs_b = sb > bs_b ? sb : bs_b;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kIngestModes; ++m) {
      if (m >= a.modes) break;
      const int mode = m == 0 ? mode0 : mode1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A pair is a candidate only if its sum beats the threshold, or if
        // the list is not full (a threshold of -inf, which every sum
        // beats): a pass where no sum of the warp does is skipped whole.
        bool hit = false;
#pragma unroll
        for (int c = h * HC; c < (h + 1) * HC; ++c)
          hit |= (acc[4 * c] > thr_a[m]) | (acc[4 * c + 1] > thr_a[m]) |
                 (acc[4 * c + 2] > thr_b[m]) | (acc[4 * c + 3] > thr_b[m]);
        if (!__any_sync(kFull, hit)) continue;
        uint32_t ma = 0u, mb = 0u;
#pragma unroll
        for (int c = h * HC; c < (h + 1) * HC; ++c) {
          const uint2 fw = *reinterpret_cast<const uint2*>(colF + 8 * c + 2 * tq);
          const int2 sw = *reinterpret_cast<const int2*>(colS + 8 * c + 2 * tq);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t f = e ? fw.y : fw.x;
            const int sh = e ? sw.y : sw.x;
            const int bit = 2 * (c - h * HC) + e;
            const float sa = ingest_mode_score(acc[4 * c + e], f, sh, qs_a, mode);
            const float sb = ingest_mode_score(acc[4 * c + 2 + e], f, sh, qs_b, mode);
            ma |= sa > thr_a[m] ? 1u << bit : 0u;
            mb |= sb > thr_b[m] ? 1u << bit : 0u;
          }
        }
        int off_a, tot_a, off_b, tot_b;
        quad_scan(__popc(ma), off_a, tot_a);
        quad_scan(__popc(mb), off_b, tot_b);
        if (ma | mb) {
          int pa = nb_a + off_a, pb = nb_b + off_b;
#pragma unroll
          for (int c = h * HC; c < (h + 1) * HC; ++c) {
            if (!(((ma | mb) >> (2 * (c - h * HC))) & 3u)) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * c + 2 * tq + e, bit = 2 * (c - h * HC) + e;
              const int row = g0 + col;
              if ((ma >> bit) & 1u)
                Ba[pa++] = list_key(
                    ingest_mode_score(acc[4 * c + e], colF[col], colS[col], qs_a, mode), row);
              if ((mb >> bit) & 1u)
                Bb[pb++] = list_key(
                    ingest_mode_score(acc[4 * c + 2 + e], colF[col], colS[col], qs_b, mode),
                    row);
            }
          }
        }
        nb_a += tot_a;
        nb_b += tot_b;
        // The batch, shared by the modes, is merged after every pass.
        merge_pending(wlists + m * lcap, lcap, stride - lcap, a.k, nb_a > 0, nb_b > 0,
                      m_a[m], m_b[m], nb_a, nb_b, thr_a[m], thr_b[m],
                      (a.modes - m - 1) * lcap);
      }
    }
  }

  // ---- the split's results: the probe by quad reductions, the lists
  if (a.with_probe) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float sa = __shfl_xor_sync(kFull, bs_a, o), sb = __shfl_xor_sync(kFull, bs_b, o);
      const int ra = __shfl_xor_sync(kFull, br_a, o), rb = __shfl_xor_sync(kFull, br_b, o);
      if (better(sa, ra, bs_a, br_a)) { bs_a = sa; br_a = ra; }
      if (better(sb, rb, bs_b, br_b)) { bs_b = sb; br_b = rb; }
    }
    if (tq == 0) {
      const long long o = (long long)split * a.nq;
      if (va) { a.probe_cs[o + qa] = bs_a; a.probe_cr[o + qa] = br_a; }
      if (vb) { a.probe_cs[o + qb] = bs_b; a.probe_cr[o + qb] = br_b; }
    }
  }
#pragma unroll
  for (int m = 0; m < kIngestModes; ++m) {
    if (m >= a.modes) break;
    for (int i = 0; i < 16; ++i) {
      const int len = __shfl_sync(kFull, i < 8 ? m_a[m] : m_b[m], 4 * (i & 7));
      const int q = q0 + 16 * warp + i;
      if (q >= a.nq) continue;
      const uint64_t* L = wlists + m * lcap + i * stride;
      const long long o = (((long long)m * a.splits + split) * a.nq + q) * a.k;
      for (int idx = lane; idx < a.k; idx += 32) {
        const bool live = idx < len;
        const uint64_t key = live ? L[idx] : 0ull;
        a.cand_s[o + idx] = live ? key_score(key) : -INFINITY;
        a.cand_r[o + idx] = live ? key_row(key) : INT32_MAX;
      }
    }
  }
}

// Row splits of an ingest scan of n rows and nq queries on `route`. On the
// tensor cores: one wave of blocks with the rows cut as little as that
// allows (a single split past sms / 64 query tiles). Every split starts
// its lists empty, and a short split merges and filters far more often
// than a long one: at Q = 8,192 the 33 splits of wave_splits took 273 ms on
// an H100 for the two modes, against 47 ms for the probe alone.
inline int ingest_splits(long long n, int nq, int route, int sms) {
  if (n < 1 || nq < 1) return 1;
  if (route == kRouteWgmma) {
    const long long qtiles = (nq + 63) / 64, rtiles = (n + kIngestBN - 1) / kIngestBN;
    long long s = qtiles < sms ? sms / qtiles : 1;
    if (s > rtiles) s = rtiles;
    if (s > kMaxSplits) s = kMaxSplits;
    return (int)s;
  }
  return fma_splits(n, 1, nq, sms);
}

template <int BQ, int MQ, int MR>
cudaError_t launch_ingest_fma(const IngestArgs& a, cudaStream_t st) {
  auto kernel = ingest_stage1_fma<BQ, MQ, MR>;
  const size_t smem = ingest_fma_smem(BQ, a.modes, a.k);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.nq + BQ - 1) / BQ, a.splits), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_ingest_wg(IngestArgs a, cudaStream_t st) {
  int ns = kMaxStages;
  while (ns >= 2 && ingest_wg_smem(ns, a.modes, a.k) > (size_t)kSmemMax) --ns;
  if (ns < 2) return cudaErrorInvalidValue;
  a.ns = ns;
  const size_t smem = ingest_wg_smem(ns, a.modes, a.k);
  auto kernel = ingest_stage1_wgmma<BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // Rows past n and columns past d arrive as zeros.
  CUtensorMap map_e, map_q;
  if (!hopper::encode_rows_map(&map_e, a.emb, a.d, a.n, 1, 1, a.d, 0, 0, BN) ||
      !hopper::encode_rows_map(&map_q, a.qry, a.d, a.nq, 1, 1, a.d, 0, 0, 64))
    return cudaErrorNotSupported;
  kernel<<<dim3((a.nq + 63) / 64, a.splits), 256, smem, st>>>(map_e, map_q, a);
  return cudaGetLastError();
}

// Stage 1 on `route` (the tensor cores for bf16, FMA for f32), then stage 2
// (scan_merge) once a mode, the probe merged with the first (alone when
// there is no mode): each launch the card takes adds one to *launched.
// Outputs: probe_s/probe_r [nq], out_s/out_r [modes, nq, k]. A launch the
// card refuses returns its error.
template <int BN>
int run_ingest(IngestArgs a, int is_bf16, int route, float* probe_s, int* probe_r,
               float* out_s, int* out_r, int* launched, cudaStream_t st) {
  bool modes_ok = a.modes >= 0 && a.modes <= kIngestModes && (a.modes > 0 || a.with_probe);
  for (int m = 0; m < a.modes && modes_ok; ++m) modes_ok = a.mode[m] >= -1 && a.mode[m] <= 1;
  if (a.d % 8 != 0 || a.k < 1 || a.k > kMaxK || a.k > a.n || a.nq < 1 || !modes_ok ||
      a.splits < 1 || a.splits > kMaxSplits ||
      !(route == kRouteWgmma ? is_bf16 : route == kRouteFma && !is_bf16))
    return (int)cudaErrorInvalidValue;
  const long long rtiles = (a.n + BN - 1) / BN;
  a.rows_per_split = ((rtiles + a.splits - 1) / a.splits) * BN;
  a.panels = (a.d + 63) / 64;
  cudaError_t err;
  if (route == kRouteWgmma) {
    err = launch_ingest_wg<BN>(a, st);
  } else {
    switch (query_tile(a.nq)) {
      case 4: err = launch_ingest_fma<4, 1, 2>(a, st); break;
      case 8: err = launch_ingest_fma<8, 1, 4>(a, st); break;
      case 16: err = launch_ingest_fma<16, 1, 8>(a, st); break;
      default: err = launch_ingest_fma<64, 4, 8>(a, st); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  if (launched) ++*launched;
  const long long per = (long long)a.splits * a.nq * a.k;
  for (int m = 0; m < (a.modes > 0 ? a.modes : 1); ++m) {
    const bool lists = a.modes > 0;
    const int kc = lists ? a.k : 0;
    scan_merge<int><<<a.nq, kThreads, 0, st>>>(
        a.probe_cs, a.probe_cr, lists ? a.cand_s + m * per : a.probe_cs,
        lists ? a.cand_r + m * per : a.probe_cr, a.splits, a.nq, kc, 0, kc, nullptr, 0, 0,
        m == 0 && a.with_probe, probe_s, probe_r,
        lists ? out_s + (long long)m * a.nq * a.k : nullptr,
        lists ? out_r + (long long)m * a.nq * a.k : nullptr, kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (launched) ++*launched;
  }
  return 0;
}


// ---------------------------------------------------------------------------
// Pairwise mode (exported by pairwise_topk.cu): the all-pairs merge scan
// ---------------------------------------------------------------------------
//
// Replaces lazzaro_tpu/ops/graphops.py:pairwise_merge_candidates, which the
// JAX package computes in XLA (chunked nt_dot + where + lax.top_k), not with
// Pallas. The queries are the arena's own rows. The caller gathers the rows
// that take part (a tenant's live non-super rows) into an ascending compact
// copy E whose first n_live rows are live; the gather is monotone, so every
// sum and the order of ties are kept. For every pair a < b < n_live:
//     s[a, b]   = dot_f32(E[a], E[b])
//     list[a,:] = the k best (s, b) with b > a and s > threshold, in
//                 lax.top_k's order (score descending, ties to the lowest b)
// and the decode maps both back to arena rows: slot p of arena row r is
// list[pos[r], p] as (score, comp[b]), or (NEG, -1) where the list is
// shorter or r takes no part. k <= kPairMaxK.
//
// Design. Block (x, c) scores the 64 queries of query tile x against the row
// tiles (kBR rows) of chunk c (kPairTiles tiles) that hold a b > a for one of
// them: a tile wholly at or below the diagonal is never loaded, and the b > a
// test runs only on a tile that crosses it. The blocks are numbered chunk by
// chunk, chunk c listing the query tiles that reach it (the first 2 (c + 1)
// kPairTiles), so every block off the diagonal does the same work and the
// triangle fills whole waves evenly. bf16 rows take the tensor-core product
// (wg_produce / wg_product: one consumer warpgroup, m64n128k16 from a TMA
// ring), f32 rows the FMA product (fma_tile, 64 queries x 128 rows); the sums
// stay in registers. A warp none of whose sums beats the threshold skips the
// tile's list work (at 0.95 nearly every warp). A sum that beats it and the
// query's last list key goes into the query's list in device memory by a
// cascade of 64-bit atomicMax over its k slots, the key being list_key's
// (exact, one a pair): a slot that takes the key hands its old key on to the
// next slot, so in whatever order the blocks insert, slot p ends holding
// the p-th best key. Lists start at 0, below every key; a decode kernel
// writes the outputs. The grid is sized from the arena's rows (n_live stays
// on the device, so the launch never waits for it); blocks past n_live end
// at once.
// What bounds it: the product, 2 d n_live (n_live - 1) / 2 FLOP on the tensor
// cores for bf16 and on the FMA units for f32, and each live row read once.

constexpr int kPairMaxK = 8;
constexpr int kPairBQ = 64;                          // queries a block
constexpr int kPairTiles = 32;                       // row tiles a chunk
constexpr int kPairPerChunk = kBR * kPairTiles / kPairBQ;   // query tiles a chunk adds

struct PairArgs {
  const void* emb;                 // [n_rows, d] compact rows, the first *n_live live
  const int* n_live;               // [1] on the device
  long long n_rows, qtiles;        // rows of the copy; query tiles of the grid
  int d, k, panels, ns;
  float thr;
  unsigned long long* keys;        // [n_rows, k] lists, zeroed
};

// Blocks of a pairwise launch over n rows: chunk c holds min(qtiles, (c + 1)
// kPairPerChunk) query tiles.
inline long long pair_blocks(long long n) {
  const long long qt = (n + kPairBQ - 1) / kPairBQ;
  const long long chunks = (n + (long long)kBR * kPairTiles - 1) / ((long long)kBR * kPairTiles);
  long long b = 0;
  for (long long c = 0; c < chunks; ++c) {
    const long long cnt = (c + 1) * kPairPerChunk;
    b += cnt < qt ? cnt : qt;
  }
  return b;
}

// Block b's query tile x and row tiles [t0, t1); false when it has none (its
// queries or its chunk past n_live, or its tiles at or below the diagonal).
__device__ __forceinline__ bool pair_block(long long b, int n, long long qtiles, int& x,
                                           long long& t0, long long& t1) {
  long long c = 0;
  for (;; ++c) {
    const long long cnt = min(qtiles, (c + 1) * kPairPerChunk);
    if (b < cnt) break;
    b -= cnt;
  }
  x = (int)b;
  const long long q0 = (long long)x * kPairBQ;
  if (q0 >= n) return false;
  const long long first = (q0 + 1) / kBR, last = ((long long)n + kBR - 1) / kBR;
  t0 = max(c * kPairTiles, first);
  t1 = min((c + 1) * kPairTiles, last);
  return t0 < t1;
}

// Pair (a, b) with sum s into a's list of k slots L (see the design note).
__device__ __forceinline__ void pair_insert(unsigned long long* L, int k, float s, int b) {
  unsigned long long key = list_key(s, b);
  if (key <= *reinterpret_cast<volatile unsigned long long*>(L + k - 1)) return;
  for (int p = 0; p < k; ++p) {
    const unsigned long long old = atomicMax(L + p, key);
    if (old < key) {
      key = old;
      if (key == 0ull) return;
    }
  }
}

// Stage 1 on the FMA route (f32): 64 queries against 128-row tiles, thread
// (tq, tr) holding queries tq + 16 i against rows tr + 16 j.
__global__ void __launch_bounds__(kThreads) pair_stage1_fma(const PairArgs a) {
  constexpr int BQ = kPairBQ, MQ = 4, MR = 8, TQ = BQ / MQ, TR = kThreads / TQ;
  static_assert(TR * MR == kBR, "thread grid must cover one row tile");
  __shared__ float qs[BQ * kLD];
  __shared__ float rs[kBR * kLD];
  const int n = *a.n_live;
  int x;
  long long t0, t1;
  if (!pair_block(blockIdx.x, n, a.qtiles, x, t0, t1)) return;
  const int q0 = x * BQ, tid = threadIdx.x, tq = tid / TR, tr = tid % TR;
  const float* e = static_cast<const float*>(a.emb);
  for (long long t = t0; t < t1; ++t) {
    const long long r0 = t * kBR;
    float acc[MQ][MR];
    fma_tile<float, BQ, MQ, MR>(acc, qs, rs, e, e, q0, n, r0, n, a.d);
    bool hit = false;
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < MR; ++j) hit |= acc[i][j] > a.thr;
    if (!__any_sync(kFull, hit)) continue;
    const bool diag = r0 < q0 + BQ;
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int qi = q0 + tq + i * TQ;
#pragma unroll
      for (int j = 0; j < MR; ++j) {
        const long long rj = r0 + tr + j * TR;
        const float s = acc[i][j] + 0.0f;
        if (s > a.thr && qi < n && rj < n && (!diag || rj > qi))
          pair_insert(a.keys + (long long)qi * a.k, a.k, s, (int)rj);
      }
    }
  }
}

// Stage 1 on the tensor cores (bf16): warpgroup 1's one thread produces
// (query panel, row panel) pairs of the compact copy (wg_produce), warpgroup
// 0 runs the product (wg_product) and filters each tile from its registers.
template <int BN>
__global__ void __launch_bounds__(256, 1)
pair_stage1_wgmma(const __grid_constant__ CUtensorMap map_e,
                  const __grid_constant__ CUtensorMap map_q, const PairArgs a) {
  constexpr int NF = BN / 2;                  // accumulator registers a thread
  constexpr int STAGE = (64 + BN) * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.ns * STAGE);
  uint64_t* empty = full + a.ns;
  const int n = *a.n_live;
  int x;
  long long t0, t1;
  if (!pair_block(blockIdx.x, n, a.qtiles, x, t0, t1)) return;
  const int q0 = x * 64, tiles = (int)(t1 - t0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.ns; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128)
      wg_produce<1, BN>(&map_q, &map_e, ring, full, empty, a.ns, tiles, a.panels, q0, t0 * BN);
    return;
  }

  // Fragment element 4c + e is query ia, column 8c + 2tq + e; 4c + 2 + e
  // query ib.
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ia = q0 + 16 * warp + g, ib = ia + 8;
  unsigned long long* La = a.keys + (long long)ia * a.k;
  unsigned long long* Lb = a.keys + (long long)ib * a.k;
  float acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    wg_product<1, BN>(acc, ring, full, empty, a.ns, t, a.panels, 0, tid);
    bool hit = false;
#pragma unroll
    for (int i = 0; i < NF; ++i) hit |= acc[i] > a.thr;
    if (!__any_sync(kFull, hit)) continue;
    const long long r0 = (t0 + t) * BN;
    const bool diag = r0 < q0 + 64;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long j = r0 + 8 * c + 2 * tq + e;
        const float sa = acc[4 * c + e] + 0.0f, sb = acc[4 * c + 2 + e] + 0.0f;
        if (sa > a.thr && ia < n && j < n && (!diag || j > ia)) pair_insert(La, a.k, sa, (int)j);
        if (sb > a.thr && ib < n && j < n && (!diag || j > ib)) pair_insert(Lb, a.k, sb, (int)j);
      }
    }
  }
}

// Slot p of arena row r: list pos[r]'s key p as (score, comp[row]), or (NEG,
// -1) for an empty slot or a row outside the mask.
__global__ void __launch_bounds__(kThreads)
pair_decode(const unsigned long long* __restrict__ keys, const uint8_t* __restrict__ mask,
            const int* __restrict__ pos, const int* __restrict__ comp, long long n, int k,
            float* __restrict__ out_s, int* __restrict__ out_r) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const bool live = mask[r] != 0;
  const unsigned long long* L = keys + (live ? (long long)pos[r] * k : 0);
  for (int p = 0; p < k; ++p) {
    const unsigned long long key = live ? L[p] : 0ull;
    out_s[r * k + p] = key ? key_score(key) : kNeg;
    out_r[r * k + p] = key ? comp[key_row(key)] : -1;
  }
}

// Shared memory of the tensor-core pairwise stage 1 with ns ring stages: 1 KB
// of alignment slack and the ring with its barriers.
inline size_t pair_wg_smem(int ns) {
  return 1024 + ns * ((size_t)(64 + kBR) * kRowBytes + 16);
}

// The lists zeroed, stage 1 on `route` (the tensor cores for bf16, FMA for
// f32), the decode: each kernel the card takes adds one to *launched. A
// launch the card refuses returns its error.
inline int run_pairwise(PairArgs a, int is_bf16, int route, const uint8_t* mask, const int* pos,
                        const int* comp, float* out_s, int* out_r, int* launched,
                        cudaStream_t st) {
  if (a.d % 8 != 0 || a.k < 1 || a.k > kPairMaxK || a.n_rows < 1 ||
      !(route == kRouteWgmma ? is_bf16 : route == kRouteFma && !is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(a.keys, 0, sizeof(unsigned long long) * a.n_rows * a.k, st);
  if (err != cudaSuccess) return (int)err;
  a.qtiles = (a.n_rows + kPairBQ - 1) / kPairBQ;
  a.panels = (a.d + 63) / 64;
  const long long blocks = pair_blocks(a.n_rows);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (route == kRouteWgmma) {
    a.ns = kMaxStages;
    while (a.ns >= 2 && pair_wg_smem(a.ns) > (size_t)kSmemMax) --a.ns;
    const size_t smem = pair_wg_smem(a.ns);
    auto kernel = pair_stage1_wgmma<kBR>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // Rows past n_rows and columns past d arrive as zeros.
    CUtensorMap map_e, map_q;
    if (!hopper::encode_rows_map(&map_e, a.emb, a.d, a.n_rows, 1, 1, a.d, 0, 0, kBR) ||
        !hopper::encode_rows_map(&map_q, a.emb, a.d, a.n_rows, 1, 1, a.d, 0, 0, 64))
      return (int)cudaErrorNotSupported;
    kernel<<<(unsigned)blocks, 256, smem, st>>>(map_e, map_q, a);
  } else {
    pair_stage1_fma<<<(unsigned)blocks, kThreads, 0, st>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (launched) ++*launched;
  pair_decode<<<(unsigned)((a.n_rows + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      a.keys, mask, pos, comp, a.n_rows, a.k, out_s, out_r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (launched) ++*launched;
  return 0;
}

}  // namespace
