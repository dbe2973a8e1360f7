// Masked cosine top-k scans of the embedding arena, for Hopper (sm_90a): one
// templated scan, in two mask modes. masked_topk.cu exports the additive
// mode and fused_topk.cu the keyed mode; each includes this file. Three more
// modes at the end of the file share its building blocks: the ingest mode
// (ingest_topk.cu, K1), the pairwise mode (pairwise_topk.cu, K3) and the
// int8 mode (int8_topk.cu, K4). The IVF candidate scan (K5, ivf_topk.cu)
// includes this file for its keys and list merges.
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
// N*d*itemsize (plus 4 B of madd, 6 B of row columns, or the ingest mode's
// 5, a row) over 3.35 TB/s, 0.96 ms for 1,048,576 x 768 f32 (0.48 ms in
// bf16).
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
// equal scores keep the lower row first. KM bounds k (the int8 mode's
// lists reach 256).
template <int KM = kMaxK>
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
    float vs[KM / 32];
    int vr[KM / 32];
#pragma unroll
    for (int m = 0; m < KM / 32; ++m) {
      const int e = cnt + lane + 32 * m;
      if (e < k - 1) { vs[m] = lsq[e]; vr[m] = lrq[e]; }
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < KM / 32; ++m) {
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
// the new list length. KM bounds kc (the int8 mode's lists reach 256).
template <int S, int KM = kMaxK>
__device__ __forceinline__ int merge_batch(uint64_t* L, int m, uint64_t* B, int nb, int kc) {
  const int lane = threadIdx.x & 31;
  uint64_t key[S / 32];
  warp_sort_desc<S>(B, nb, key);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < S / 32; ++j)
    if (32 * j + lane < nb) B[32 * j + lane] = key[j];
  uint64_t lv[KM / 32];
#pragma unroll
  for (int t = 0; t < KM / 32; ++t)
    lv[t] = lane + 32 * t < m ? L[lane + 32 * t] : 0ull;
  __syncwarp();
  int pb[S / 32], pl[KM / 32];
#pragma unroll
  for (int j = 0; j < S / 32; ++j) {
    const int i = 32 * j + lane;
    pb[j] = i < nb ? i + count_greater(L, m, key[j]) : kc;
  }
#pragma unroll
  for (int t = 0; t < KM / 32; ++t) {
    const int i = lane + 32 * t;
    pl[t] = i < m ? i + count_greater(B, nb, lv[t]) : kc;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < S / 32; ++j)
    if (pb[j] < kc) L[pb[j]] = key[j];
#pragma unroll
  for (int t = 0; t < KM / 32; ++t)
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
// (lcap + bcap) and its batch lcap + boff entries on. KM bounds kc.
template <int KM = kMaxK>
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
      if (nb <= 32) m2 = merge_batch<32, KM>(L, m, B, nb, kc);
      else if (nb <= 64) m2 = merge_batch<64, KM>(L, m, B, nb, kc);
      else if (nb <= 128) m2 = merge_batch<128, KM>(L, m, B, nb, kc);
      else m2 = merge_batch<256, KM>(L, m, B, nb, kc);
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
// launch). j0 items went through the ring before (a persistent block's
// earlier work items); the consumers pass the same count to wg_product.
template <int WGS, int BN>
__device__ __forceinline__ void wg_produce(const CUtensorMap* map_q, const CUtensorMap* map_e,
                                           uint8_t* ring, uint64_t* full, uint64_t* empty,
                                           int ns, int tiles, int panels, int q0,
                                           long long r_begin, int j0 = 0) {
  constexpr int QB = WGS * 64 * kRowBytes;   // query panel of a stage
  constexpr int STAGE = QB + BN * kRowBytes;
  const int items = tiles * panels;
  for (int i = 0; i < items; ++i) {
    const int j = j0 + i, s = j % ns, t = i / panels, p = i - t * panels;
    if (j >= ns) hopper::mbar_wait(empty + s, ((j / ns) - 1) & 1);
    hopper::mbar_arrive_expect_tx(full + s, STAGE);
    uint8_t* st = ring + s * STAGE;
    hopper::tma_load_4d(st, map_q, full + s, 64 * p, q0, 0, 0);
    hopper::tma_load_4d(st + QB, map_e, full + s, 64 * p,
                        (int)(r_begin + (long long)t * BN), 0, 0);
  }
}

// Warpgroup wg's scores of tile t, S = Q.E^T over d as a chain of SS wgmma
// m64nBNk16 into acc (bf16 panels, f32 sums; int8 panels with int acc:
// m64n128k32, int32 sums): panel p's four products go out behind panel p -
// 1's, whose stage is released once they retire (wait<1>), the last after
// the chain. tid is the thread's index in its warpgroup; j_base is
// wg_produce's j0.
template <int WGS, int BN, typename Acc>
__device__ __forceinline__ void wg_product(Acc (&acc)[BN / 2], uint8_t* ring, uint64_t* full,
                                           uint64_t* empty, int ns, int t, int panels, int wg,
                                           int tid, int j_base = 0) {
  constexpr int QB = WGS * 64 * kRowBytes;
  constexpr int STAGE = QB + BN * kRowBytes;
  const int j0 = j_base + t * panels;
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
      if constexpr (std::is_same<Acc, int>::value) {
        static_assert(BN == 128, "the int8 product takes 128-row tiles");
        hopper::wgmma_ss_m64n128k32_s8(acc, da, db, p > 0 || kk > 0);
      } else if constexpr (BN == 128) {
        hopper::wgmma_ss_m64n128k16(acc, da, db, p > 0 || kk > 0);
      } else {
        hopper::wgmma_ss_m64n256k16(acc, da, db, p > 0 || kk > 0);
      }
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
// scans to the FMA route; the launch refuses them). The stage runs in the
// additive and keyed modes and in K1's ingest mode (probe and up to two
// shard-mode lists from one pass).

constexpr int kRouteStream = 2;
constexpr int kStreamMaxQ = 16;
constexpr int kStreamStageBytes = 49152;   // arena bytes a ring stage aims at
constexpr int kStreamMaxRows = 128;        // rows of a chunk at most (a batch)
constexpr int kStreamHead = 512;           // barriers, batch sizes, thresholds
constexpr int kStreamMathWarps = 8;
constexpr int kStreamQregs = 96;           // query values a lane holds
constexpr int kStreamMaxLists = 2;         // lists a query keeps (K1's shard modes)

// The modes of the streaming stage, by the row words a stage carries: madd
// f32 (additive), tenant i32, alive u8 and is_super u8 (keyed; a bool kKeyed
// converts to these two), or shard i32 and K1's flags u8 (ingest, below:
// the entry's words and alive columns carry them).
constexpr int kStreamAdd = 0, kStreamKeyed = 1, kStreamIngest = 2;

__host__ __device__ constexpr int stream_word_bytes(int mode) {
  return mode == kStreamAdd ? 4 : mode == kStreamKeyed ? 6 : 5;
}

// The head of the shared memory: barriers from 0, from 256 the batch sizes
// [lists][2][16] i32 and then the thresholds [lists][16] f32, for the most
// lists a query of the mode keeps.
__host__ __device__ constexpr int stream_head(int mode) {
  return mode == kStreamIngest ? 2 * kStreamHead : kStreamHead;
}

// Layout of a streaming launch, fixed by d, the mode, the list length kc,
// the lists a query keeps nl (1 for a list of kc > 1 in the additive and
// keyed modes, else 0; K1's shard modes in the ingest mode) and the query
// tile qt (nq rounded up to a power of two):
//   cr    rows a chunk (one ring stage): the rows in kStreamStageBytes of
//         arena, rounded down to a multiple of 16 when there are 16 or
//         more (then the row words come by bulk copies too), at most
//         kStreamMaxRows, halved while two stages do not fit beside the
//         lists; fewer than 16 are raised to one a math warp where two
//         stages of them fit;
//   g     lanes sharing a row: its d / 8 slots of 8 elements rounded up to
//         a power of two, at most 32; spl slots a lane (a row never spans
//         two warps);
//   qg    queries a math warp sums (its query group): the most of 4, 2, 1
//         whose qg * spl * 8 values fit in kStreamQregs registers (and qg
//         <= g); ng = qt / qg groups, pr = kStreamMathWarps / ng warps a
//         group (0 when the groups do not fit: the launch is refused);
//   ns    ring stages, as many as shared memory holds (at most kMaxStages);
//   bc    entries of each of a list's two batches: a batch takes the
//         candidates of every other chunk until it could not take another.
// A stage holds cr arena rows, then their row words column by column,
// padded to 128 bytes.
struct StreamShape {
  int cr, g, spl, qg, ng, pr, ns, lcap, bc, row_bytes, words_off, stage_bytes, fin;
  size_t head, lists_off, fin_off, smem;
};

template <int kMode>
inline StreamShape stream_shape(int d, int kc, int qt, int nl, int cr = 0) {
  StreamShape sh{};
  sh.row_bytes = d * 4;
  if (cr == 0) {
    // Wide rows: one a math warp if two such stages fit, else what fits.
    const int fit = kStreamStageBytes / sh.row_bytes;
    if (fit >= 16) {
      // Two lists of 128 and their batches (the ingest mode) can leave room
      // for one stage of 128 narrow rows: halve the chunk until two fit.
      int c = fit / 16 * 16 > kStreamMaxRows ? kStreamMaxRows : fit / 16 * 16;
      StreamShape narrow = stream_shape<kMode>(d, kc, qt, nl, c);
      while (narrow.ns < 2 && c >= 32) {
        c /= 2;
        narrow = stream_shape<kMode>(d, kc, qt, nl, c);
      }
      return narrow;
    }
    const StreamShape wide =
        stream_shape<kMode>(d, kc, qt, nl, fit > kStreamMathWarps ? fit : kStreamMathWarps);
    return wide.ns >= 2 ? wide : stream_shape<kMode>(d, kc, qt, nl, fit < 1 ? 1 : fit);
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
  sh.stage_bytes = (sh.words_off + sh.cr * stream_word_bytes(kMode) + 127) / 128 * 128;
  sh.lcap = ((kc + 7) / 8) * 8;
  sh.bc = 2 * sh.cr + 32 < kSortN ? 2 * sh.cr + 32 : kSortN;
  sh.fin = sh.pr * (32 / sh.g);
  sh.head = stream_head(kMode);
  const size_t lists = (size_t)nl * 16 * (sh.lcap + 2 * sh.bc) * 8;
  const size_t fin = (size_t)qt * sh.fin * 8 * (kMode == kStreamKeyed ? 2 : 1);
  const size_t fixed = sh.head + lists + fin;
  const size_t ns = fixed < (size_t)kSmemMax ? (kSmemMax - fixed) / sh.stage_bytes : 0;
  sh.ns = (int)(ns < kMaxStages ? ns : kMaxStages);
  sh.lists_off = sh.head + (size_t)sh.ns * sh.stage_bytes;
  sh.fin_off = sh.lists_off + lists;
  sh.smem = fixed + (size_t)sh.ns * sh.stage_bytes;
  return sh;
}

// n: rows of each shard entry; rows_per_split: a multiple of cr; words_bulk:
// cr is a multiple of 16 and every entry's row-word columns are 16-byte
// aligned (else the producer warp copies them with plain loads). The ingest
// mode: q_tenant holds each fact's shard, with_gate takes the probe into
// gate_c*, and list l (< nl) is shard mode mode[l]'s.
template <int kMode>
struct StreamArgs {
  ShardTable t;
  const void* qry;
  const int* q_tenant;
  long long n, rows_per_split;
  int splits, d, nq, qt, kc, nl, with_gate, ld_after, words_bulk;
  int mode[kStreamMaxLists];
  int cr, g, spl, ng, pr, ns, lcap, bc, row_bytes, words_off, stage_bytes, fin, head,
      lists_off, fin_off;
  const float* after_s;
  const RowT<kMode != kStreamAdd>* after_r;
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

// A score of the ingest mode from a row's sum and its row words: past the
// split's end -inf (never a candidate), a pair outside the mask NEG, a live
// one the sum + 0.0f (-0 becomes +0, as masked_topk's madd of 0 makes it).
// f is the row's flags with bit 2 set for a row in the split; the probe
// takes bit 0, mode `mode` bit 1 and the shard match.
__device__ __forceinline__ float ingest_probe_score(float acc, uint32_t f) {
  return (f & 4u) ? ((f & 1u) ? acc + 0.0f : kNeg) : -INFINITY;
}

__device__ __forceinline__ float ingest_mode_score(float acc, uint32_t f, int sh, int qsh,
                                                   int mode) {
  const bool ok = (f & 2u) && (mode == 0 || (sh == qsh) == (mode == 1));
  return (f & 4u) ? (ok ? acc + 0.0f : kNeg) : -INFINITY;
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
//   owner) adds madd, or applies the tiers, or K1's masks, and folds the
//   score: kc = 1, the keyed gate and K1's probe into an arg-max in
//   registers (replaced only on a strictly better score; its rows ascend),
//   each list into its batch when the score beats the list's threshold
//   (and, in a later pass, ranks after the previous pass's last pair), at a
//   position from a shared atomic. A row's score is the same wherever it
//   sits, and in every mode: K1's probe is bit for bit the additive mode's
//   k = 1 scan over the probe mask.
// - Warp 1 keeps the lists, as a warp of the tensor-core route's consumers
//   does (queries g and g + 8 of a quad), the nl lists of a query in turn.
//   Chunks alternate between two batches a list; after each chunk it merges
//   the chunk's batch into the sorted list (merge_pending) when the batch
//   could not take another chunk or the list is not full, and publishes the
//   list's last score as the threshold. At the end it merges what is left,
//   reduces the owners' arg-maxes and writes the split's candidates.
template <int QG, bool kList, int kMode>
__global__ void __launch_bounds__(64 + 32 * kStreamMathWarps, 1)
scan_stage1_stream(const StreamArgs<kMode> a) {
  constexpr bool kKeyed = kMode == kStreamKeyed, kIngest = kMode == kStreamIngest;
  constexpr int NL = kIngest ? kStreamMaxLists : 1;   // lists a query keeps at most
  constexpr int SPLMAX = kStreamQregs / (8 * QG);
  constexpr int RU = QG == 1 ? 4 : 2;        // rows a lane sums at once
  constexpr int MW = kStreamMathWarps;
  extern __shared__ __align__(128) uint8_t stream_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(stream_smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* sfull = empty + kMaxStages;   // [2] batches written
  uint64_t* sempty = sfull + 2;           // [2] batches merged
  uint64_t* done = sempty + 2;            // the owners' arg-maxes written
  int* cnt = reinterpret_cast<int*>(stream_smem + 256);   // [NL][2][16] batch sizes
  float* thrs = reinterpret_cast<float*>(cnt + 32 * NL);  // [NL][16] thresholds
  uint8_t* ring = stream_smem + a.head;
  uint64_t* lists = reinterpret_cast<uint64_t*>(stream_smem + a.lists_off);
  float* fin_s = reinterpret_cast<float*>(stream_smem + a.fin_off);   // [qt][fin]
  int* fin_r = reinterpret_cast<int*>(fin_s + a.qt * a.fin);
  float* gfin_s = reinterpret_cast<float*>(fin_r + a.qt * a.fin);     // keyed gate
  int* gfin_r = reinterpret_cast<int*>(gfin_s + a.qt * a.fin);
  const int stride = a.lcap + 2 * a.bc;   // a list and its two batches

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
  if (threadIdx.x < 32 * NL) {
    cnt[threadIdx.x] = 0;
    if (threadIdx.x < 16 * NL) thrs[threadIdx.x] = -INFINITY;
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer
    const uint8_t* emb = static_cast<const uint8_t*>(a.t.emb[entry]);
    const uint8_t* words = static_cast<const uint8_t*>(a.t.words[entry]);
    const uint8_t* alive = a.t.alive[entry];     // ingest: the flags
    const uint8_t* sup = a.t.is_super[entry];
    const uint32_t wbytes = (uint32_t)a.cr * stream_word_bytes(kMode);
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
          if constexpr (kMode != kStreamAdd) wst[4 * a.cr + i] = in ? alive[r0 + i] : 0;
          if constexpr (kKeyed) wst[5 * a.cr + i] = in ? sup[r0 + i] : 0;
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
          if constexpr (kMode != kStreamAdd)
            hopper::bulk_load(wst + 4 * a.cr, alive + r0, a.cr, full + s);
          if constexpr (kKeyed) hopper::bulk_load(wst + 5 * a.cr, sup + r0, a.cr, full + s);
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
      int m_a[NL], m_b[NL], nb_a[NL], nb_b[NL];
      float thr_a[NL], thr_b[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        m_a[l] = m_b[l] = nb_a[l] = nb_b[l] = 0;
        thr_a[l] = thr_b[l] = -INFINITY;
      }
      for (int j = 0; j < chunks + 2; ++j) {
        // Chunk j's batch; past the last chunk, what is left in both.
        const int b = j & 1;
        const bool last = j >= chunks;
        if (!last) hopper::mbar_wait(sfull + b, (j >> 1) & 1);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          if (l >= a.nl) break;
          int* c = cnt + 16 * (2 * l + b);
          nb_a[l] = va ? c[qa] : 0;
          nb_b[l] = vb ? c[qb] : 0;
          merge_pending(lists + 16 * l * stride, a.lcap, 2 * a.bc, a.kc,
                        nb_a[l] > 0 && (last || nb_a[l] > a.bc - a.cr || m_a[l] < a.kc),
                        nb_b[l] > 0 && (last || nb_b[l] > a.bc - a.cr || m_b[l] < a.kc),
                        m_a[l], m_b[l], nb_a[l], nb_b[l], thr_a[l], thr_b[l], b * a.bc);
          if (tq == 0) {
            if (va) { thrs[16 * l + qa] = thr_a[l]; c[qa] = nb_a[l]; }
            if (vb) { thrs[16 * l + qb] = thr_b[l]; c[qb] = nb_b[l]; }
          }
        }
        __syncwarp();
        if (!last) hopper::mbar_arrive(sempty + b);
      }
      // List l of every slot: [nl][entries * splits][nq][kc].
      const long long lslots = (long long)gridDim.y * a.splits;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (l >= a.nl) break;
        for (int i = 0; i < 16 && i < a.nq; ++i) {
          const int m = __shfl_sync(kFull, i < 8 ? m_a[l] : m_b[l], 4 * (i & 7));
          const uint64_t* L = lists + (16 * l + i) * stride;
          const long long o = ((l * lslots + slot) * a.nq + i) * a.kc;
          for (int idx = lane; idx < a.kc; idx += 32) {
            const bool live = idx < m;
            const uint64_t key = live ? L[idx] : 0ull;
            a.cand_s[o + idx] = live ? key_score(key) : -INFINITY;
            a.cand_r[o + idx] = live ? key_row(key) : INT32_MAX;
          }
        }
      }
    }
    if (!kList || (kMode != kStreamAdd && a.with_gate)) {
      hopper::mbar_wait(done, 0);
      for (int q = lane; q < a.nq; q += 32) {
        if constexpr (!kList && !kIngest) {
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
        if constexpr (kMode != kStreamAdd) {
          // The keyed gate, or K1's probe (in fin: K1 keeps no kc = 1 arg-max).
          const float* src_s = kIngest ? fin_s : gfin_s;
          const int* src_r = kIngest ? fin_r : gfin_r;
          if (a.with_gate) {
            float gs = -INFINITY;
            int gr = INT32_MAX;
            for (int i = 0; i < a.fin; ++i) {
              const float s = src_s[q * a.fin + i];
              const int r = src_r[q * a.fin + i];
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
  // The query's tenant (keyed) or the fact's shard (ingest).
  int ten = 0;
  if constexpr (kMode != kStreamAdd) ten = qlive ? a.q_tenant[q] : kNoTenant;
  float bs = -INFINITY, gs = -INFINITY;
  int br = INT32_MAX, gr = INT32_MAX;
  float thr[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) thr[l] = -INFINITY;
  const int iters = (a.cr + P * RU - 1) / (P * RU);

  for (int j = 0; j < chunks; ++j) {
    const int s = j % a.ns, b = j & 1;
    hopper::mbar_wait(full + s, (j / a.ns) & 1);
    if constexpr (kList) {
      if (j >= 2) hopper::mbar_wait(sempty + b, ((j >> 1) - 1) & 1);
#pragma unroll
      for (int l = 0; l < NL; ++l) thr[l] = qlive ? thrs[16 * l + q] : INFINITY;
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
            // The row's score for each list the query keeps; -inf takes no
            // place in any list (its threshold starts at -inf).
            float sc[NL];
            if constexpr (kIngest) {
              // The probe as the additive mode's k = 1 scan scores it (its
              // sum + madd, madd 0 or NEG); each list under its mode's mask.
              const uint32_t f = (uint32_t)wst[4 * a.cr + row] | 4u;
              if (a.with_gate) {
                const float sp = ingest_probe_score(acc[u][0], f);
                br = sp > bs ? grow : br;
                bs = sp > bs ? sp : bs;
              }
              const int sh = reinterpret_cast<const int*>(wst)[row];
#pragma unroll
              for (int l = 0; l < NL; ++l)
                sc[l] = ingest_mode_score(acc[u][0], f, sh, ten, a.mode[l]);
            } else {
              float s;
              if constexpr (kKeyed) {
                const int key = wst[4 * a.cr + row]
                                    ? reinterpret_cast<const int*>(wst)[row] : kNoTenant;
                const bool sp = wst[5 * a.cr + row];
                const uint32_t cc = __float_as_uint(kNeg);
                s = tier_score<true>(acc[u][0], (uint32_t)(sp ? kNoTenant : key), cc, ten);
                if (a.with_gate) {
                  const float sg = gate_score(acc[u][0], (uint32_t)(sp ? key : kNoTenant), cc,
                                              ten);
                  gr = sg > gs ? grow : gr;
                  gs = sg > gs ? sg : gs;
                }
              } else {
                s = acc[u][0] + reinterpret_cast<const float*>(wst)[row];
              }
              // A row that does not rank after the previous pass's last.
              sc[0] = first_pass || ranks_after(s, grow, ts, ta) ? s : -INFINITY;
              if constexpr (!kList) {
                br = sc[0] > bs ? grow : br;
                bs = sc[0] > bs ? sc[0] : bs;
              }
            }
            if constexpr (kList) {
#pragma unroll
              for (int l = 0; l < NL; ++l) {
                if (l >= a.nl) break;
                if (sc[l] > thr[l]) {
                  const int pos = atomicAdd(cnt + 16 * (2 * l + b) + q, 1);
                  lists[(16 * l + q) * stride + a.lcap + b * a.bc + pos] =
                      list_key(sc[l], grow);
                }
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
    if constexpr (!kList || kIngest) { fin_s[i] = bs; fin_r[i] = br; }
    if constexpr (kKeyed) {
      if (a.with_gate) { gfin_s[i] = gs; gfin_r[i] = gr; }
    }
  }
  hopper::mbar_arrive(done);
}

template <int QG, bool kList, int kMode>
cudaError_t launch_stream(const StreamArgs<kMode>& w, size_t smem, int shards,
                          cudaStream_t stream) {
  auto kernel = scan_stage1_stream<QG, kList, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(w.splits, shards), 64 + 32 * kStreamMathWarps, smem, stream>>>(w);
  return cudaGetLastError();
}

template <bool kList, int kMode>
cudaError_t launch_stream_qg(int qg, const StreamArgs<kMode>& w, size_t smem, int shards,
                             cudaStream_t st) {
  switch (qg) {
    case 1: return launch_stream<1, kList, kMode>(w, smem, shards, st);
    case 2: return launch_stream<2, kList, kMode>(w, smem, shards, st);
    default: return launch_stream<4, kList, kMode>(w, smem, shards, st);
  }
}

// The query tile of the streaming route: nq rounded up to a power of two.
inline int stream_tile(int nq) {
  int qt = 1;
  while (qt < nq) qt <<= 1;
  return qt;
}

// Splits of each of `shards` entries of `chunks` chunks on the streaming
// route: one wave of blocks (the ring takes an SM's shared memory, so one
// block an SM), no split shorter than four chunks.
inline int stream_wave_splits(long long chunks, int shards, int sms) {
  long long want = sms / shards;
  if (want > chunks / 4) want = chunks / 4;
  if (want > kMaxSplits / shards) want = kMaxSplits / shards;
  if (want < 1) want = 1;
  return (int)want;
}

template <bool kKeyed>
int stream_splits(long long n, int shards, int nq, int kmax, int sms, int d) {
  const int kc = kmax < kMaxK ? kmax : kMaxK;
  const StreamShape sh = stream_shape<kKeyed>(d, kc, stream_tile(nq), kc > 1);
  return stream_wave_splits((n + sh.cr - 1) / sh.cr, shards, sms);
}

// Whether a streaming launch of this shape runs: two ring stages, a math
// warp a query group, the queries in a lane's registers.
inline bool stream_ok(const StreamShape& sh) {
  return sh.ns >= 2 && sh.pr >= 1 && sh.qg * sh.spl * 8 <= kStreamQregs;
}

// A streaming launch's arguments from its shape; rows_per_split a multiple
// of cr covering n rows in `splits` splits.
template <int kMode>
void stream_layout(StreamArgs<kMode>& w, const StreamShape& sh, long long n, int splits) {
  const long long chunks = (n + sh.cr - 1) / sh.cr;
  w.n = n;
  w.splits = splits;
  w.rows_per_split = ((chunks + splits - 1) / splits) * sh.cr;
  w.cr = sh.cr; w.g = sh.g; w.spl = sh.spl; w.ng = sh.ng; w.pr = sh.pr; w.ns = sh.ns;
  w.lcap = sh.lcap; w.bc = sh.bc; w.row_bytes = sh.row_bytes; w.words_off = sh.words_off;
  w.stage_bytes = sh.stage_bytes; w.fin = sh.fin; w.head = (int)sh.head;
  w.lists_off = (int)sh.lists_off; w.fin_off = (int)sh.fin_off;
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
  const StreamShape sh = stream_shape<kKeyed>(a.d, kc, qt, kc > 1);
  if (!stream_ok(sh)) return cudaErrorInvalidValue;
  StreamArgs<kKeyed> w{};
  w.t = a.t;
  w.qry = a.qry; w.q_tenant = a.q_tenant;
  stream_layout(w, sh, a.n, a.splits);
  w.d = a.d; w.nq = a.nq; w.qt = qt; w.kc = kc; w.nl = kc > 1;
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
// - f32 up to 16 facts whose values fit a lane's registers (the additive
//   mode's streaming rule, stream_fits in the wrapper): the streaming stage
//   1 in its ingest mode (scan_stage1_stream, kStreamIngest), whose stages
//   carry each row's shard and flags beside it. The owner lane of a row's
//   sum folds the probe into an arg-max in registers, scoring it as the
//   additive mode's k = 1 scan does (the same row_reduce and query groups
//   for the same Q and d, the sum + 0 or NEG), so the probe is bit for bit
//   masked_topk's on that route; each mode's list takes the pairs above its
//   own threshold into its own batches, which warp 1 merges list by list.
//   One launch reads the arena once.
// - other f32 scans: the FMA product (fma_tile) in its 4/8/16/64-query
//   tiles of 128 rows, its sums to shared memory, then one warp a query
//   folds its row (ingest_fold): the probe as a warp arg-max, each mode's
//   list by warp_list_insert (the FMA route's list epilogue) under its own
//   mask. The FMA product, not the fold, bounds this route; its probe sums
//   as masked_topk's FMA route does.
// Stage 2 is scan_merge, one launch a mode, the probe riding on the first.
// What bounds it: at the fill's mega-batch (Q = 8,192 over 1,048,576 x 768
// bf16) the product's 13.2 TFLOP, 13.3 ms at the bf16 tensor rate; at one
// conversation end (Q = 16) the arena's bytes: 1.61 GB in bf16 (0.48 ms),
// 3.2 GB in f32 (0.97 ms). The folds run on the consumer warps between two
// products, so a tile pays both.

constexpr int kIngestModes = 2;
constexpr int kIngestBN = kBR;     // rows of a tile on the FMA and tensor-core routes
static_assert(kIngestModes == kStreamMaxLists, "the streaming stage keeps every mode's list");

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

// Row splits of an ingest scan of n rows, nq queries of width d, `modes`
// lists of k on `route`. On the tensor cores: one wave of blocks with the
// rows cut as little as that allows (a single split past sms / 64 query
// tiles). Every split starts its lists empty, and a short split merges and
// filters far more often than a long one: at Q = 8,192 the 33 splits of
// wave_splits took 273 ms on an H100 for the two modes, against 47 ms for
// the probe alone. Streaming: one wave, as the additive mode.
inline int ingest_splits(long long n, int nq, int d, int k, int modes, int route, int sms) {
  if (n < 1 || nq < 1) return 1;
  if (route == kRouteWgmma) {
    const long long qtiles = (nq + 63) / 64, rtiles = (n + kIngestBN - 1) / kIngestBN;
    long long s = qtiles < sms ? sms / qtiles : 1;
    if (s > rtiles) s = rtiles;
    if (s > kMaxSplits) s = kMaxSplits;
    return (int)s;
  }
  if (route == kRouteStream) {
    if (d < 8) return 1;
    const StreamShape sh = stream_shape<kStreamIngest>(d, k < 1 ? 1 : k, stream_tile(nq), modes);
    return stream_wave_splits((n + sh.cr - 1) / sh.cr, 1, sms);
  }
  return fma_splits(n, 1, nq, sms);
}

// Stage 1 of the ingest mode on the streaming route (f32, nq <= 16): one
// shard entry at base 0 whose words are the row shards and whose alive
// column is the flags.
inline cudaError_t launch_ingest_stream(const IngestArgs& a, cudaStream_t st) {
  if (a.nq > kStreamMaxQ) return cudaErrorInvalidValue;
  const int qt = stream_tile(a.nq);
  const StreamShape sh = stream_shape<kStreamIngest>(a.d, a.k, qt, a.modes);
  if (!stream_ok(sh)) return cudaErrorInvalidValue;
  StreamArgs<kStreamIngest> w{};
  w.t.emb[0] = a.emb;
  w.t.words[0] = a.shard;
  w.t.alive[0] = a.flags;
  w.qry = a.qry; w.q_tenant = a.q_shard;
  stream_layout(w, sh, a.n, a.splits);
  w.d = a.d; w.nq = a.nq; w.qt = qt; w.kc = a.k; w.nl = a.modes;
  w.mode[0] = a.mode[0]; w.mode[1] = a.mode[1];
  w.with_gate = a.with_probe;
  w.words_bulk = sh.cr % 16 == 0 &&
                 (reinterpret_cast<uintptr_t>(a.shard) | reinterpret_cast<uintptr_t>(a.flags)) %
                         16 == 0;
  w.gate_cs = a.probe_cs; w.gate_cr = a.probe_cr; w.cand_s = a.cand_s; w.cand_r = a.cand_r;
  return a.modes > 0 ? launch_stream_qg<true, kStreamIngest>(sh.qg, w, sh.smem, 1, st)
                     : launch_stream_qg<false, kStreamIngest>(sh.qg, w, sh.smem, 1, st);
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

// Stage 1 on `route` (the tensor cores for bf16, streaming or FMA for f32),
// then stage 2 (scan_merge) once a mode, the probe merged with the first
// (alone when there is no mode): each launch the card takes adds one to
// *launched. Outputs: probe_s/probe_r [nq], out_s/out_r [modes, nq, k]. A
// launch the card refuses returns its error: no route stands in for
// another.
template <int BN>
int run_ingest(IngestArgs a, int is_bf16, int route, float* probe_s, int* probe_r,
               float* out_s, int* out_r, int* launched, cudaStream_t st) {
  bool modes_ok = a.modes >= 0 && a.modes <= kIngestModes && (a.modes > 0 || a.with_probe);
  for (int m = 0; m < a.modes && modes_ok; ++m) modes_ok = a.mode[m] >= -1 && a.mode[m] <= 1;
  if (a.d % 8 != 0 || a.k < 1 || a.k > kMaxK || a.k > a.n || a.nq < 1 || !modes_ok ||
      a.splits < 1 || a.splits > kMaxSplits ||
      !(route == kRouteWgmma ? is_bf16
                             : (route == kRouteFma || route == kRouteStream) && !is_bf16))
    return (int)cudaErrorInvalidValue;
  const long long rtiles = (a.n + BN - 1) / BN;
  a.rows_per_split = ((rtiles + a.splits - 1) / a.splits) * BN;
  a.panels = (a.d + 63) / 64;
  cudaError_t err;
  if (route == kRouteWgmma) {
    err = launch_ingest_wg<BN>(a, st);
  } else if (route == kRouteStream) {
    err = launch_ingest_stream(a, st);
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
// Design. Stage 1 is a persistent grid: as many blocks as the card holds at
// once (on the tensor cores one an SM, whose ring takes the shared memory;
// four an SM on the FMA route), whatever the arena's size. Each block reads
// n_live on the device and walks the live triangle's work items: no block
// exists for rows past n_live, and the launch never waits for n_live on the
// host. On the tensor cores with a static stride (item blockIdx.x, then +
// gridDim.x, ...); on the FMA route each block takes its next item from a
// ticket in device memory, since its four blocks an SM share the FMA pipes
// unevenly and a static stride let them drift apart (on an H100 the
// 131,072-row f32 scan took 103 ms so, 93 with the ticket).
// Query tiles have QT rows and row tiles 2 QT, so the first row tile that
// holds a b > a for query tile x is x / 2, and it is the only one that
// crosses the diagonal: a tile wholly at or below it is never loaded, and
// the b > a test runs on that one tile alone. The row tiles form chunks of
// RUN tiles, and a work item is one query tile's tiles of one chunk that
// hold a b > a: all RUN of them, or fewer on the diagonal. Items are
// numbered chunk by chunk (chunk c: every query tile that reaches it,
// ascending), so the blocks in flight share the chunk's rows in L2 and each
// reloads only its own query tile; a block finds its next item by moving a
// cursor forward (PairWalk), never by a search from the start. (Numbered
// run by run instead, x fastest, the blocks in flight held ~54 MB of tiles,
// more than the L2, and on an H100 a scan of 194,726 bf16 rows took 86 ms,
// not 47.)
// bf16 rows take the tensor cores: 128 queries x 256-row tiles in chunks of
// 2,048 rows (the blocks in flight hold ~25 MB of query tiles and 3 MB of
// rows), two consumer warpgroups of 64 queries on wgmma m64n256k16 (128 f32
// sums a thread) and a producer warpgroup whose one thread keeps a ring of
// four 48 KB TMA stages, (128-query panel, 256-row panel) (wg_produce /
// wg_product; the ring runs on from one item to the next), so a pair and
// 64-column panel moves 1.5 bytes from L2. f32 rows take the FMA product
// (fma_tile, 64 queries x 128 rows) in chunks of 4,096 rows. The sums stay
// in registers, and each is the chain of its 64-column panels in ascending
// order. A warp none of whose
// sums beats the threshold skips the tile's list work (at 0.95 nearly every
// warp). A sum that beats it and the query's last list key goes into the
// query's list in device memory by a cascade of 64-bit atomicMax over its k
// slots, the key being list_key's (exact, one a pair): a slot that takes
// the key hands its old key on to the next slot, so in whatever order the
// blocks insert, slot p ends holding the p-th best key. Lists start at 0,
// below every key; a decode kernel writes the outputs.
// What bounds it: the product, 2 d n_live (n_live - 1) / 2 FLOP on the tensor
// cores for bf16 and on the FMA units for f32, and each live row read once;
// on the tensor cores also the L2's rate for the stages' bytes.

constexpr int kPairMaxK = 8;

struct PairArgs {
  const void* emb;                 // [n_rows, d] compact rows, the first *n_live live
  const int* n_live;               // [1] on the device
  long long n_rows;                // rows of the copy
  int d, k, panels, ns;
  float thr;
  unsigned long long* keys;        // [n_rows * k + 1]: the lists, then the ticket; zeroed
};

// The work items of the live triangle over n rows, for query tiles of QT
// rows, row tiles of 2 QT and chunks of RUN row tiles (see the design
// note). item() takes ascending item numbers and moves its cursor (chunk c,
// the items before it, the items of chunk c) forward, so over a block's
// life it steps over each chunk once. Trivially constructible, so that a
// block can keep one in shared memory: init() starts it.
template <int QT, int RUN>
struct PairWalk {
  long long x_tiles, r_tiles, c, before, count;

  __device__ void init(int n) {
    x_tiles = (n + QT - 1) / QT;
    r_tiles = (n + 2 * QT - 1) / (2 * QT);
    c = before = 0;
    count = items_of(0);
  }

  // Query tiles that reach chunk cc: those x with x / 2 < (cc + 1) RUN.
  __device__ long long items_of(long long cc) const {
    if (cc * RUN >= r_tiles) return 0;
    const long long m = 2 * (cc + 1) * RUN;
    return m < x_tiles ? m : x_tiles;
  }

  // Item i's query tile x and row tiles [t0, t1); false past the last item.
  __device__ bool item(long long i, int& x, long long& t0, long long& t1) {
    while (i >= before + count) {
      if (count == 0) return false;
      before += count;
      count = items_of(++c);
    }
    x = (int)(i - before);
    t0 = max(c * RUN, (long long)(x >> 1));
    t1 = min((c + 1) * RUN, r_tiles);
    return true;
  }
};

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
// (tq, tr) holding queries tq + 16 i against rows tr + 16 j. Thread 0 takes
// the block's items from the ticket, walks them and hands each to the block
// through shared memory, so that the walk takes none of the 64 registers a
// thread that keep four blocks on an SM.
__global__ void __launch_bounds__(kThreads, 4) pair_stage1_fma(const PairArgs a) {
  constexpr int BQ = 64, MQ = 4, MR = 8, TQ = BQ / MQ, TR = kThreads / TQ;
  static_assert(TR * MR == kBR, "thread grid must cover one row tile");
  static_assert(kBR == 2 * BQ, "the walk's row tiles are two query tiles");
  __shared__ float qs[BQ * kLD];
  __shared__ float rs[kBR * kLD];
  __shared__ PairWalk<BQ, 32> walk;
  __shared__ unsigned long long* ticket;
  __shared__ long long next;                  // the block's next item
  __shared__ int item[3];                     // its query tile (-1 past the last), t0, t1
  const int n = *a.n_live;
  const int tid = threadIdx.x, tq = tid / TR, tr = tid % TR;
  const float* e = static_cast<const float*>(a.emb);
  if (tid == 0) {
    walk.init(n);
    ticket = a.keys + a.n_rows * a.k;
    next = (long long)atomicAdd(ticket, 1ull);
  }
  for (;;) {
    // Every thread read the last item before fma_tile's first barrier.
    if (tid == 0) {
      int x;
      long long t0, t1;
      const bool more = walk.item(next, x, t0, t1);
      next = (long long)atomicAdd(ticket, 1ull);
      item[0] = more ? x : -1;
      item[1] = (int)t0;
      item[2] = (int)t1;
    }
    __syncthreads();
    if (item[0] < 0) return;
    const int q0 = item[0] * BQ, t1 = item[2];
    for (int t = item[1]; t < t1; ++t) {
      const long long r0 = (long long)t * kBR;
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
}

// Stage 1 on the tensor cores (bf16): warpgroup 2's one thread produces
// (query panel, row panel) stages of the compact copy for every tile of the
// block's items (wg_produce), warpgroups 0 and 1 run the product of 64
// queries each (wg_product) and filter each tile from their registers.
constexpr int kPairWgs = 2;                          // consumer warpgroups
constexpr int kPairQT = kPairWgs * 64;               // queries of a tile
constexpr int kPairBN = 2 * kPairQT;                 // rows of a tile

__global__ void __launch_bounds__((kPairWgs + 1) * 128, 1)
pair_stage1_wgmma(const __grid_constant__ CUtensorMap map_e,
                  const __grid_constant__ CUtensorMap map_q, const PairArgs a) {
  constexpr int NF = kPairBN / 2;             // accumulator registers a thread
  constexpr int STAGE = (kPairQT + kPairBN) * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.ns * STAGE);
  uint64_t* empty = full + a.ns;
  const int n = *a.n_live;
  PairWalk<kPairQT, 8> walk;
  walk.init(n);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.ns; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kPairWgs);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  int x;
  long long t0, t1;
  int j0 = 0;                                 // ring items of the earlier work items
  // The producer walks the items too, so it keeps 40 registers (the scan's
  // producer 24); 128 x 40 + 256 x 232 fits the SM's 65,536.
  if (threadIdx.x >= kPairWgs * 128) {
    hopper::regs_shrink<40>();
    if (threadIdx.x == kPairWgs * 128) {
      for (long long item = blockIdx.x; walk.item(item, x, t0, t1); item += gridDim.x) {
        const int tiles = (int)(t1 - t0);
        wg_produce<kPairWgs, kPairBN>(&map_q, &map_e, ring, full, empty, a.ns, tiles,
                                      a.panels, x * kPairQT, t0 * kPairBN, j0);
        j0 += tiles * a.panels;
      }
    }
    return;
  }
  hopper::regs_grow<232>();

  // Fragment element 4c + e is query ia, column 8c + 2tq + e; 4c + 2 + e
  // query ib.
  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  float acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0.0f;
  for (long long item = blockIdx.x; walk.item(item, x, t0, t1); item += gridDim.x) {
    const int q0 = x * kPairQT, tiles = (int)(t1 - t0);
    const int ia = q0 + 64 * wg + 16 * warp + g, ib = ia + 8;
    unsigned long long* La = a.keys + (long long)ia * a.k;
    unsigned long long* Lb = a.keys + (long long)ib * a.k;
    for (int t = 0; t < tiles; ++t) {
      wg_product<kPairWgs, kPairBN>(acc, ring, full, empty, a.ns, t, a.panels, wg, tid, j0);
      bool hit = false;
#pragma unroll
      for (int i = 0; i < NF; ++i) hit |= acc[i] > a.thr;
      if (!__any_sync(kFull, hit)) continue;
      const long long r0 = (t0 + t) * kPairBN;
      const bool diag = r0 < q0 + kPairQT;
#pragma unroll
      for (int c = 0; c < kPairBN / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long j = r0 + 8 * c + 2 * tq + e;
          const float sa = acc[4 * c + e] + 0.0f, sb = acc[4 * c + 2 + e] + 0.0f;
          if (sa > a.thr && ia < n && j < n && (!diag || j > ia)) pair_insert(La, a.k, sa, (int)j);
          if (sb > a.thr && ib < n && j < n && (!diag || j > ib)) pair_insert(Lb, a.k, sb, (int)j);
        }
      }
    }
    j0 += tiles * a.panels;
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
  return 1024 + ns * ((size_t)(kPairQT + kPairBN) * kRowBytes + 16);
}

// Multiprocessors of the current device, read once a device.
inline cudaError_t pair_sms(int& sms) {
  constexpr int kMaxDevices = 64;
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && cache[dev] == 0)
    err = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  sms = err == cudaSuccess ? cache[dev] : 0;
  return err;
}

// The lists zeroed, stage 1 on `route` (the tensor cores for bf16, FMA for
// f32) over a persistent grid sized from the SM count, the decode: each
// kernel the card takes adds one to *launched. A launch the card refuses
// returns its error.
inline int run_pairwise(PairArgs a, int is_bf16, int route, const uint8_t* mask, const int* pos,
                        const int* comp, float* out_s, int* out_r, int* launched,
                        cudaStream_t st) {
  if (a.d % 8 != 0 || a.k < 1 || a.k > kPairMaxK || a.n_rows < 1 ||
      !(route == kRouteWgmma ? is_bf16 : route == kRouteFma && !is_bf16))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = pair_sms(sms);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(a.keys, 0, sizeof(unsigned long long) * (a.n_rows * a.k + 1), st);
  if (err != cudaSuccess) return (int)err;
  a.panels = (a.d + 63) / 64;
  if (route == kRouteWgmma) {
    a.ns = kMaxStages;
    while (a.ns >= 2 && pair_wg_smem(a.ns) > (size_t)kSmemMax) --a.ns;
    const size_t smem = pair_wg_smem(a.ns);
    err = cudaFuncSetAttribute(pair_stage1_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    // Rows past n_rows and columns past d arrive as zeros.
    CUtensorMap map_e, map_q;
    if (!hopper::encode_rows_map(&map_e, a.emb, a.d, a.n_rows, 1, 1, a.d, 0, 0, kPairBN) ||
        !hopper::encode_rows_map(&map_q, a.emb, a.d, a.n_rows, 1, 1, a.d, 0, 0, kPairQT))
      return (int)cudaErrorNotSupported;
    pair_stage1_wgmma<<<(unsigned)sms, (kPairWgs + 1) * 128, smem, st>>>(map_e, map_q, a);
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_stage1_fma, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    pair_stage1_fma<<<(unsigned)(sms * (per_sm > 0 ? per_sm : 1)), kThreads, 0, st>>>(a);
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

// ---------------------------------------------------------------------------
// Int8 mode (exported by int8_topk.cu, K4): the coarse scan of quantized
// serving over the int8 shadow
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: the JAX package computes this scan in XLA, an
// int8 dot_general with an int32 result and lax.top_k, in
// lazzaro_tpu/ops/quant.py:quantized_topk (the classic int8 search) and the
// coarse stage of lazzaro_tpu/core/state.py:_quant_two_tier (the quantized
// fused serving program). It is a mode of this scan so that the [Q, N] int32
// score tile never reaches device memory. With codes [N, d] i8 and scale
// [N] f32 the shadow (ops/quant.py:quantize_rows of the arena), the f32
// queries quantized the same way into (qq [Q, d] i8, qs [Q] f32), for every
// query q and row r:
//     s[q, r] = (float(dot_i32(qq[q], codes[r])) * qs[q]) * scale[r]
// the int32 dot exact in any order (|dot| <= 127 * 127 * d < 2^31 for d <=
// 133,144) and converted to f32 once, to nearest (XLA's convert), then the
// two f32 products in JAX's order (no fused multiply-add: there is no add).
// So the scores, and with them the lists, are bit for bit those of the plain
// version in ops/int8_topk.py at every width.
//   additive form (one list): list[q, :] = top-k of s + madd[r] (madd 0 for
//       live rows, -1e30 for masked ones, which rounds to exactly -1e30, the
//       jnp.where of quantized_topk);
//   keyed form (two lists): with t_q the query's tenant,
//       gate[q, :] = top-g of s over rows with alive & tenant == t_q &  is_super
//       ann[q, :]  = top-k of s over rows with alive & tenant == t_q & ~is_super
//       a row outside a tier scoring exactly NEG (g = 1 + slack, k = k +
//       slack: the two lax.top_k calls of _quant_two_tier).
// Order: score descending, ties to the lowest row. Rows are i32; lists of
// any length up to N.
//
// Design. A scan quantizes its queries, then runs passes of a stage 1 and a
// stage 2 (one pass unless a list is longer than a pass holds).
// - i8_quantize, one block a row of the query panels: qq and qs as
//   quantize_rows computes them (the f32 max of |x|, scale = amax *
//   f32(1/127), inv = 1 / scale, rint and clip), laid out for the
//   tensor-core stage 1's TMA loads: a tile's queries spread over the four
//   consumer warps (i8_slot_of_row), and up to 16 queries in 4 or 2 copies.
// - Stage 1 on the tensor cores (i8_stage1_wgmma; d % 16 == 0, the 16-byte
//   row stride TMA needs): grid (query tiles) x (row splits), one wave of
//   one block an SM (more waves would only restart lists). One producer
//   thread keeps TMA loads of (query panel, shadow panel) pairs, 128 code
//   bytes of 64 query slots and of 128 rows each in the 128-byte swizzle
//   (wg_produce: rows past N and bytes past d arrive as zeros), in an
//   mbarrier ring; the shadow is read as it lies, K-major, the only layout
//   wgmma takes for 8-bit operands. One consumer warpgroup runs S = Q.C^T
//   as a chain of SS wgmma m64n128k32 s8 over d with the int32 sums in
//   registers (wg_product), stages them thread-private in shared memory
//   and folds the tile into its slots' lists in rolled loops: the score
//   (__int2float_rn, * qs, * scale, the tier's mask), a threshold filter
//   (and, in a later pass, the admission rule), the survivors to the slot's
//   batch at positions from a quad prefix sum, and the batch merged into
//   the sorted list of exact 64-bit keys (merge_pending: a bitonic sort and
//   a merge by rank, lists of up to kI8MaxK) when the next tile might not
//   fit it, and while the list is not full. The tile's row words (scale,
//   and madd or the two tier keys and the fill) are loaded a tile ahead
//   and pass through shared memory. (Folded from the registers, unrolled
//   over all 64 elements, the copies below ran no faster than one warp on
//   an H100: PERF.md.) The keyed form's first pass masks both lists in one
//   walk. Copies: at up to 8
//   queries each query has 4 slots, one a warp (2 up to 16), and copy r
//   folds the chunks of 8 columns c with c % rep == r, so the chat turn's
//   one query is folded by four warps, not one; a query's copies are
//   merged by rank at the end of the split. The keyed form keeps two lists
//   a slot, the ANN list and the gate list, each with its own batch, or one
//   batch shared where shared memory is short. The lists take live slots x
//   (lists + batches) x 8 bytes; past 32 queries, tiles of 32 where 64
//   slots' lists would take shorter passes (PERF.md).
// - Stage 1 on the dp4a route (i8_stage1; shadows whose width is no
//   multiple of 16, or forced): a block of 4 to 64 queries quantizes them
//   into shared memory and walks its rows in tiles of 128, code slices
//   staged in shared memory, int32 sums by __dp4a, and one warp a query
//   inserts the candidates into its sorted list(s) (warp_list_insert).
// - Stage 2 (i8_select, both routes): one block a (query, list) takes the
//   kc best of the splits' kc-entry lists. Every key (list_key: score bits
//   over the complement of the row) is unique, so these are the kc keys at
//   or above the kc-th largest: a radix select finds it (digits of 8 bits
//   from the top, a 256-bin histogram each, one shared atomic a run of
//   equal digits, as a split's list is sorted; the keys held in shared
//   memory where they fit; once a digit's bin holds at most 2,048 keys it
//   is gathered and the later digits read it alone), then the survivors are
//   gathered and one warp sorts them with a bitonic network. No loop of kc
//   rounds over the splits.
// A list longer than a pass holds (kI8MaxK, or less where the lists would
// not fit beside a 3-stage ring) runs in passes: pass p admits only pairs
// ranking after pass p - 1's last pair of that list, as the other modes'
// passes of 128 do.
// What bounds it: the shadow's bytes, N * (d + 4) plus the row columns (4 B
// of madd, or 6 B of tenant, alive and is_super), read once: 0.245 ms for
// 1,048,576 x 768 at 3.35 TB/s (the bf16 arena's scan reads twice that).
// The product, 2 * Q * N * d int8 operations, is 0.05 ms at Q = 64 at the
// int8 tensor rate. The folds run on the consumer warpgroup between two
// products: at one query they are near the bytes' time a tile, and at 64
// the lists' merges, not the bytes, set the time (PERF.md).

constexpr int kI8MaxK = 256;               // list entries of one pass
constexpr int kI8DW = 16;                  // code words (4 B) of a staged slice (dp4a)
constexpr int kI8LD = kI8DW + 1;           // padded row stride of the staged slices
constexpr int kI8BN = 128;                 // shadow rows of a tensor-core tile
constexpr int kI8SelThreads = 1024;        // threads of a stage-2 block
constexpr int kI8SelCache = 24576;         // keys a stage-2 block holds in shared memory
constexpr int kI8SelBin = 2048;            // keys of a bin stage 2 gathers
constexpr long long kI8MaxD = 133144;      // widest row whose int32 dot cannot overflow
constexpr int kI8Wgmma = 0;                // routes of stage 1
constexpr int kI8Dp4a = 1;
constexpr float kRecip127 = 0x1.0204080000000p-7f;   // f32(1 / 127)

struct I8Args {
  const int8_t* codes;             // [n, d]
  const float* scale;              // [n]
  const float* madd;               // additive form: [n]
  const int* row_tenant;           // keyed form: [n] with alive, is_super [n] u8
  const uint8_t* alive;
  const uint8_t* is_super;
  const float* qry;                // [nq, d] f32
  const int* q_tenant;             // keyed form: [nq]
  const int8_t* qq;                // tensor-core route: [nq, d] quantized queries
  const float* qsc;                //   and their scales [nq]
  long long n, rows_per_split;
  int d, nq, k, g, splits;
  int kc, gc;                      // this pass's list entries (0: that list is done)
  const float* after_s;            // a later pass: the ANN list's last pair so far,
  const int* after_r;              //   [nq] at stride k (null in the first pass)
  const float* gafter_s;           //   and the gate list's, at stride g
  const int* gafter_r;
  uint64_t* cand;                  // [splits, nq, kc] split lists as keys (0: empty)
  uint64_t* gcand;                 // keyed: [splits, nq, gc]
  int qstride;                     // dp4a: code words a query keeps
  int qt;                          // tensor cores: queries a block (64 / rep, or 32)
  int rep;                         //   copies of each query in a block (1, 2 or 4)
  int ns, lcap, glcap, bcap, gbcap, panels, live;   // tensor-core shape
};

// Which of the 64 slots of a tile the row of the tensor-core route's query
// panel holds: slot v sits at row 16 (v % 4) + v / 4, so that a tile's
// slots spread over the consumer warpgroup's four warps (warp w holds rows
// 16 w .. 16 w + 15; v = 4 s + w is its row 16 w + s), whose list work
// runs apart. Slot v holds copy v % rep of query v / rep: with rep copies
// (a tile of 64 / rep queries, for a few queries) copy r of a query lies in
// warp r and folds the tile's columns of chunks c with c % rep == r. A tile
// of 32 queries (rep 1) fills the first 8 rows of each warp.
__host__ __device__ __forceinline__ int i8_slot_of_row(int row) {
  return 4 * (row % 16) + row / 16;
}

// The queries quantized as ops/quant.py:quantize_rows does, one block a row
// of qq [tiles * 64, d] i8 (rows in i8_slot_of_row's order, zeros where no
// query sits), and qs [nq] f32.
__global__ void __launch_bounds__(kThreads)
i8_quantize(const float* __restrict__ qry, int d, int nq, int qt, int rep,
            int8_t* __restrict__ qq, float* __restrict__ qs) {
  __shared__ float red[kWarps];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int v = i8_slot_of_row(row % 64);
  const int q = row / 64 * qt + v / rep;
  int8_t* out = qq + (long long)row * d;
  if (v >= qt * rep || q >= nq) {
    for (int c = tid; c < d; c += kThreads) out[c] = 0;
    return;
  }
  const float* x = qry + (long long)q * d;
  float amax = 0.f;
  for (int j = tid; j < d; j += kThreads) amax = fmaxf(amax, fabsf(x[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  amax = red[0];
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red[w]);
  const float scale = amax > 0.f ? __fmul_rn(amax, kRecip127) : 0.f;
  const float inv = scale > 0.f ? __fdiv_rn(1.f, scale) : 0.f;
  for (int c = tid; c < d; c += kThreads)
    out[c] = (int8_t)(int)fminf(fmaxf(rintf(__fmul_rn(x[c], inv)), -127.f), 127.f);
  if (tid == 0 && v % rep == 0) qs[q] = scale;
}

// The key of a list entry, 0 for an empty one (row INT32_MAX).
__device__ __forceinline__ uint64_t entry_key(float s, int r) {
  return r == INT32_MAX ? 0ull : list_key(s, r);
}

// ---- stage 1, dp4a route

// Dynamic shared memory of a dp4a stage 1 for a query tile of bq.
inline size_t i8_smem(int bq, int qstride, int k, int g) {
  return sizeof(int) * ((size_t)bq * qstride + (size_t)kBR * kI8LD) +
         sizeof(float) * (size_t)bq * (kBR + 1) +
         (sizeof(float) + sizeof(int)) * (size_t)bq * (k + g) +
         (sizeof(float) + sizeof(int)) * bq + 3 * sizeof(int) * kBR;
}

template <int BQ, int MQ, int MR, bool kKeyed>
__global__ void __launch_bounds__(kThreads) i8_stage1(const I8Args a) {
  constexpr int TQ = BQ / MQ;
  constexpr int TR = kThreads / TQ;
  static_assert(TR * MR == kBR, "thread grid must cover one row tile");

  extern __shared__ int ismem[];
  const int k = a.kc, g = a.gc, qstride = a.qstride;
  int* qw = ismem;                           // [BQ][qstride] query code words
  int* rw = qw + BQ * qstride;               // [kBR][kI8LD] row code words
  float* sc = reinterpret_cast<float*>(rw + kBR * kI8LD);   // [BQ][kBR + 1]
  float* ls = sc + BQ * (kBR + 1);           // [BQ][k] list scores
  float* gls = ls + BQ * k;                  // keyed: [BQ][g] gate list scores
  float* qsc = gls + BQ * g;                 // [BQ] query scales
  float* rsc = qsc + BQ;                     // [kBR] row scales
  float* rmadd = rsc + kBR;                  // additive: [kBR] row madd
  int* lr = reinterpret_cast<int*>(rmadd + kBR);   // [BQ][k] list rows
  int* glr = lr + BQ * k;                    // keyed: [BQ][g]
  int* qt = glr + BQ * g;                    // keyed: [BQ] query tenant
  int* rkey = qt + BQ;                       // keyed: [kBR] row tenant or none
  int* rsup = reinterpret_cast<int*>(rmadd); // keyed: [kBR] row is a super node

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tq = tid / TR;
  const int tr = tid % TR;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int d = a.d, dw = (d + 3) / 4;       // code words of a row, the last partial
  const bool aligned = d % 8 == 0;           // rows 8-byte aligned: 8-byte loads
  const long long r_begin = (long long)split * a.rows_per_split;
  long long r_end = r_begin + a.rows_per_split;
  if (r_end > a.n) r_end = a.n;

  // Quantize the tile's queries, one warp a query (zeros past nq and d).
  for (int qi = warp; qi < BQ; qi += kWarps) {
    const int q = q0 + qi;
    const float* x = a.qry + (long long)(q < a.nq ? q : 0) * d;
    float amax = 0.f;
    if (q < a.nq)
      for (int j = lane; j < d; j += 32) amax = fmaxf(amax, fabsf(x[j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
    const float scale = amax > 0.f ? __fmul_rn(amax, kRecip127) : 0.f;
    const float inv = scale > 0.f ? __fdiv_rn(1.f, scale) : 0.f;
    for (int w = lane; w < qstride; w += 32) {
      unsigned word = 0;
      if (q < a.nq && w < dw) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * w + e < d) {
            const float v = fminf(fmaxf(rintf(__fmul_rn(x[4 * w + e], inv)), -127.f), 127.f);
            word |= ((unsigned)(int)v & 0xffu) << (8 * e);
          }
        }
      }
      qw[qi * qstride + w] = (int)word;
    }
    if (lane == 0) {
      qsc[qi] = scale;
      if constexpr (kKeyed) qt[qi] = q < a.nq ? a.q_tenant[q] : kNoTenant;
    }
  }
  for (int e = tid; e < BQ * k; e += kThreads) {
    ls[e] = -INFINITY;
    lr[e] = INT32_MAX;
  }
  for (int e = tid; e < BQ * g; e += kThreads) {
    gls[e] = -INFINITY;
    glr[e] = INT32_MAX;
  }
  __syncthreads();

  for (long long r0 = r_begin; r0 < r_end; r0 += kBR) {
    if (tid < kBR) {
      const long long r = r0 + tid;
      const bool in = r < r_end;
      rsc[tid] = in ? a.scale[r] : 0.f;
      if constexpr (kKeyed) {
        rkey[tid] = in && a.alive[r] ? a.row_tenant[r] : kNoTenant;
        rsup[tid] = in ? (int)a.is_super[r] : 0;
      } else {
        rmadd[tid] = in ? a.madd[r] : 0.f;
      }
    }
    int acc[MQ][MR];
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < MR; ++j) acc[i][j] = 0;
    for (int w0 = 0; w0 < dw; w0 += kI8DW) {
      // Stage the slice, two code words (8 bytes) at a time; bytes past d
      // are zeros.
      for (int e = tid; e < kBR * (kI8DW / 2); e += kThreads) {
        const int row = e / (kI8DW / 2);
        const int c = (e % (kI8DW / 2)) * 2;
        const long long r = r0 + row;
        uint2 v = make_uint2(0u, 0u);
        if (r < r_end && w0 + c < dw) {
          const int8_t* src = a.codes + r * d + 4 * (w0 + c);
          if (aligned) {
            v = *reinterpret_cast<const uint2*>(src);
          } else {
#pragma unroll
            for (int b = 0; b < 8; ++b) {
              const unsigned byte =
                  4 * (w0 + c) + b < d ? (unsigned)(uint8_t)src[b] : 0u;
              if (b < 4) v.x |= byte << (8 * b);
              else v.y |= byte << (8 * (b - 4));
            }
          }
        }
        rw[row * kI8LD + c] = (int)v.x;
        rw[row * kI8LD + c + 1] = (int)v.y;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kI8DW; ++kk) {
        int qa[MQ], rb[MR];
#pragma unroll
        for (int i = 0; i < MQ; ++i) qa[i] = qw[(tq + i * TQ) * qstride + w0 + kk];
#pragma unroll
        for (int j = 0; j < MR; ++j) rb[j] = rw[(tr + j * TR) * kI8LD + kk];
#pragma unroll
        for (int i = 0; i < MQ; ++i)
#pragma unroll
          for (int j = 0; j < MR; ++j) acc[i][j] = __dp4a(qa[i], rb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const int ri = tr + j * TR;
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const int qi = tq + i * TQ;
        float s = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), qsc[qi]), rsc[ri]);
        if constexpr (!kKeyed) s = __fadd_rn(s, rmadd[ri]);
        sc[qi * (kBR + 1) + ri] = s;
      }
    }
    __syncthreads();

    // One warp a query: fold the tile into its list(s); a later pass admits
    // only pairs ranking after the previous pass's last.
    for (int qi = warp; qi < BQ; qi += kWarps) {
      const int q = q0 + qi;
      if (q >= a.nq) break;
      const float* scq = sc + qi * (kBR + 1);
      const int ten = kKeyed ? qt[qi] : 0;
      const float ts = a.after_s ? a.after_s[(long long)q * a.k] : INFINITY;
      const long long ta = a.after_s ? (long long)a.after_r[(long long)q * a.k] : -1;
      float gts = INFINITY;
      long long gta = -1;
      if constexpr (kKeyed) {
        if (a.gafter_s) {
          gts = a.gafter_s[(long long)q * a.g];
          gta = a.gafter_r[(long long)q * a.g];
        }
      }
      for (int c = 0; c < kBR; c += 32) {
        const long long r = r0 + c + lane;
        const bool in = r < r_end;
        const float s = scq[c + lane];
        if constexpr (kKeyed) {
          const bool mine = rkey[c + lane] == ten;
          const bool sup = rsup[c + lane] != 0;
          if (k > 0) {
            const float sa = mine && !sup ? s : kNeg;
            warp_list_insert<kI8MaxK>(ls + qi * k, lr + qi * k, k, sa, (int)(r0 + c),
                                      in && ranks_after(sa, r, ts, ta));
          }
          if (g > 0) {
            const float sg = mine && sup ? s : kNeg;
            warp_list_insert<kI8MaxK>(gls + qi * g, glr + qi * g, g, sg, (int)(r0 + c),
                                      in && ranks_after(sg, r, gts, gta));
          }
        } else {
          warp_list_insert<kI8MaxK>(ls + qi * k, lr + qi * k, k, s, (int)(r0 + c),
                                    in && ranks_after(s, r, ts, ta));
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BQ * k; e += kThreads) {
    const int q = q0 + e / k;
    if (q < a.nq)
      a.cand[((long long)split * a.nq + q) * k + e % k] = entry_key(ls[e], lr[e]);
  }
  for (int e = tid; e < BQ * g; e += kThreads) {
    const int q = q0 + e / g;
    if (q < a.nq)
      a.gcand[((long long)split * a.nq + q) * g + e % g] = entry_key(gls[e], glr[e]);
  }
}

// Code words a query keeps in shared memory: d / 4 rounded up to a slice.
inline int i8_qstride(int d) { return (((d + 3) / 4 + kI8DW - 1) / kI8DW) * kI8DW; }

// The query tile of a dp4a stage 1: the FMA route's for nq, halved while
// the block's shared memory would not fit.
inline int i8_query_tile(int nq, int d, int k, int g) {
  int bq = query_tile(nq);
  while (bq > 4 && i8_smem(bq, i8_qstride(d), k, g) > (size_t)kSmemMax)
    bq = bq == 64 ? 16 : bq / 2;
  return bq;
}

// Blocks of one dp4a stage 1 that an SM holds at once (registers and
// shared memory), at least 1.
template <int BQ, int MQ, int MR, bool kKeyed>
int i8_resident(int qstride, int k, int g) {
  auto kernel = i8_stage1<BQ, MQ, MR, kKeyed>;
  const size_t smem = i8_smem(BQ, qstride, k, g);
  int blocks = 0;
  if (smem > (size_t)kSmemMax ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
          cudaSuccess)
    return 1;
  return blocks > 0 ? blocks : 1;
}

template <bool kKeyed>
int i8_resident_for(int bq, int qstride, int k, int g) {
  switch (bq) {
    case 4: return i8_resident<4, 1, 2, kKeyed>(qstride, k, g);
    case 8: return i8_resident<8, 1, 4, kKeyed>(qstride, k, g);
    case 16: return i8_resident<16, 1, 8, kKeyed>(qstride, k, g);
    default: return i8_resident<64, 4, 8, kKeyed>(qstride, k, g);
  }
}

// Row splits of a dp4a scan: one wave of the blocks the SMs hold at once
// (at most four an SM). Each split restarts its lists, whose early rows
// nearly all enter, so more splits than one wave would only add list work:
// at Q = 64 (one 167 KB block an SM) 528 splits took 9.9 ms, four waves.
int i8_splits(long long n, int nq, int k, int g, int d, int sms) {
  const int bq = i8_query_tile(nq, d, k, g);
  const int qstride = i8_qstride(d);
  int per_sm = g > 0 ? i8_resident_for<true>(bq, qstride, k, g)
                     : i8_resident_for<false>(bq, qstride, k, g);
  if (per_sm > 4) per_sm = 4;
  const long long qtiles = (nq + bq - 1) / bq;
  const long long rtiles = (n + kBR - 1) / kBR;
  long long want = ((long long)per_sm * sms + qtiles - 1) / qtiles;
  if (want > rtiles) want = rtiles;
  if (want > kMaxSplits) want = kMaxSplits;
  if (want < 1) want = 1;
  return (int)want;
}

template <int BQ, int MQ, int MR, bool kKeyed>
cudaError_t launch_i8(const I8Args& a, cudaStream_t st) {
  auto kernel = i8_stage1<BQ, MQ, MR, kKeyed>;
  const size_t smem = i8_smem(BQ, a.qstride, a.kc, a.gc);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nq + BQ - 1) / BQ, a.splits);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The tile is picked for the first pass's lists (the longest), so every
// pass of a scan runs the same tile.
template <bool kKeyed>
cudaError_t launch_i8_for(const I8Args& a, int bq, cudaStream_t st) {
  switch (bq) {
    case 4: return launch_i8<4, 1, 2, kKeyed>(a, st);
    case 8: return launch_i8<8, 1, 4, kKeyed>(a, st);
    case 16: return launch_i8<16, 1, 8, kKeyed>(a, st);
    default: return launch_i8<64, 4, 8, kKeyed>(a, st);
  }
}

// ---- stage 1, tensor cores

// Lists, batches and ring of a tensor-core stage 1 (entries of 8 bytes a
// query: lcap and glcap of sorted list, bcap and gbcap of batch; gbcap 0 in
// the keyed form: the gate shares the ANN list's batch).
struct I8WgShape {
  int ns, lcap, glcap, bcap, gbcap;
};

// The staged sums of a tile: 16 B a consumer thread and chunk of 8 columns.
constexpr int kI8SumBytes = (kI8BN / 8) * 128 * 16;

// 1 KB of alignment slack, the ring and its barriers, two buffers of a
// tile's four row words, the staged sums, and per live slot its lists and
// batches.
inline size_t i8_wg_smem(int live, const I8WgShape& s) {
  return 1024 + (size_t)s.ns * ((size_t)(64 + kI8BN) * kRowBytes + 16) +
         8 * sizeof(uint32_t) * kI8BN + kI8SumBytes +
         (size_t)live * (s.lcap + s.glcap + s.bcap + s.gbcap) * 8;
}

inline int i8_cap8(int c) { return (c + 7) / 8 * 8; }

// The shape for lists of kc and gc (0: none) at `live` queries a block: the
// largest batches that leave at least 3 stages (256 a list, 128 a list, or
// one shared batch of 128: a batch takes any tile's survivors once it has
// been merged), then the deepest ring; ns 0 if none fits.
inline I8WgShape i8_wg_shape(int live, int kc, int gc) {
  const int opts[3][2] = {{kSortN, kSortN}, {kI8BN, kI8BN}, {kI8BN, 0}};
  for (const auto& o : opts) {
    I8WgShape s{kMaxStages, i8_cap8(kc), gc ? i8_cap8(gc) : 0, o[0], gc ? o[1] : 0};
    while (s.ns >= 3 && i8_wg_smem(live, s) > (size_t)kSmemMax) --s.ns;
    if (s.ns >= 3) return s;
  }
  return I8WgShape{0, 0, 0, 0, 0};
}

// The entries a pass takes of lists of k and g on the tensor cores: both
// capped at kI8MaxK, the longer cut by 8 until a shape fits.
inline void i8_wg_caps(int live, int k, int g, int& kc, int& gc) {
  kc = k < kI8MaxK ? k : kI8MaxK;
  gc = g < kI8MaxK ? g : kI8MaxK;
  while (i8_wg_shape(live, kc, gc).ns == 0) {
    if (kc >= gc && kc > 8) kc -= 8;
    else if (gc > 8) gc -= 8;
    else break;
  }
}

// The score of a tier from the scaled sum s and its row words. Additive
// form: s + madd (w: madd's bits, -inf past the split's end). Keyed form: s
// where the row's tier key w (the ANN key, or the gate key) is the query's
// tenant, else the row's fill wc (NEG, or -inf past the split's end).
template <bool kKeyed>
__device__ __forceinline__ float i8_tier(float s, uint32_t w, uint32_t wc, int ten) {
  if constexpr (kKeyed) return (int)w == ten ? s : __uint_as_float(wc);
  return __fadd_rn(s, __uint_as_float(w));
}

// A pair's score from its int32 sum: (float(dot) * qs) * scale, no FMA.
__device__ __forceinline__ float i8_score(int dot, float qs, uint32_t scale_bits) {
  return __fmul_rn(__fmul_rn(__int2float_rn(dot), qs), __uint_as_float(scale_bits));
}

// Stage 1 on the tensor cores (see the section's note). Block (x, y)
// scores queries x * 64 .. + 63 against the rows of split y in tiles of
// kI8BN rows; warpgroup 1's one thread produces, warpgroup 0 computes and
// folds.
template <bool kKeyed>
__global__ void __launch_bounds__(256, 1)
i8_stage1_wgmma(const __grid_constant__ CUtensorMap map_e,
                const __grid_constant__ CUtensorMap map_q, const I8Args a) {
  constexpr int BN = kI8BN;
  constexpr int NF = BN / 2;                  // accumulator registers a thread
  constexpr int STAGE = (64 + BN) * kRowBytes;
  constexpr int NL = kKeyed ? 2 : 1;          // lists a query keeps
  extern __shared__ uint8_t smem_raw[];
  // Aligned by an offset from smem_raw (not through an integer), so that
  // every pointer below stays in the shared space: ld.shared, not generic
  // loads, in the epilogue and the merges.
  uint8_t* ring = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.ns * STAGE);
  uint64_t* empty = full + a.ns;
  uint32_t* cols = reinterpret_cast<uint32_t*>(empty + a.ns);    // [2][scale, A, B, C][BN]
  int4* sums = reinterpret_cast<int4*>(cols + 8 * BN);           // [BN / 8][128]
  uint64_t* lists = reinterpret_cast<uint64_t*>(sums + (BN / 8) * 128);  // [live][stride]
  // A query's region: ANN list, gate list, ANN batch, gate batch.
  const int stride = a.lcap + a.glcap + a.bcap + a.gbcap;
  const bool shared_batch = kKeyed && a.gbcap == 0;

  const int q0 = blockIdx.x * a.qt;            // the tile's first query
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
      wg_produce<1, BN>(&map_q, &map_e, ring, full, empty, a.ns, tiles, a.panels,
                        blockIdx.x * 64, r_begin);
    return;
  }

  // ---- consumers: this thread's query rows a and b of the accumulator,
  // slots xa and xb of the tile (i8_slot_of_row), copies part of queries
  // qa and qb
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rep = a.rep, part = warp % rep;
  const int xa = 4 * g + warp, xb = xa + 32;
  const int qa = q0 + xa / rep, qb = q0 + xb / rep;
  const bool va = xa < a.qt * rep && qa < a.nq, vb = xb < a.qt * rep && qb < a.nq;
  const bool warp_live = __any_sync(kFull, va || vb);   // a warp of no query skips the folds
  const float qs_a = va ? a.qsc[qa] : 0.f, qs_b = vb ? a.qsc[qb] : 0.f;
  int ten_a = 0, ten_b = 0;
  if constexpr (kKeyed) {
    ten_a = va ? a.q_tenant[qa] : kNoTenant;
    ten_b = vb ? a.q_tenant[qb] : kNoTenant;
  }
  // Per list: its entries this pass, where it and its batch lie, the
  // admission rule of a later pass, the sorted list's and the batch's
  // lengths, and the score a candidate must beat (the list's last once it
  // holds cnt; +inf for a query past nq).
  const int cnt[2] = {a.kc, kKeyed ? a.gc : 0};
  const int lcap[2] = {a.lcap, a.glcap};
  const int loff[2] = {0, a.lcap};
  const int boff[2] = {a.glcap, shared_batch ? 0 : a.bcap};
  const int bcap[2] = {a.bcap, shared_batch ? a.bcap : a.gbcap};
  const int bpos[2] = {0, shared_batch ? 0 : a.bcap};
  const float* after_s[2] = {a.after_s, a.gafter_s};
  const int* after_r[2] = {a.after_r, a.gafter_r};
  const long long ld[2] = {a.k, a.g};
  bool first[2];
  float ts_a[2], ts_b[2], thr_a[2], thr_b[2];
  long long ta_a[2], ta_b[2];
  int m_a[2], m_b[2], nb_a[2], nb_b[2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    first[l] = after_s[l] == nullptr;
    ts_a[l] = ts_b[l] = INFINITY;
    ta_a[l] = ta_b[l] = -1;
    if (!first[l] && l < NL) {
      if (va) { ts_a[l] = after_s[l][qa * ld[l]]; ta_a[l] = after_r[l][qa * ld[l]]; }
      if (vb) { ts_b[l] = after_s[l][qb * ld[l]]; ta_b[l] = after_r[l][qb * ld[l]]; }
    }
    thr_a[l] = va ? -INFINITY : INFINITY;
    thr_b[l] = vb ? -INFINITY : INFINITY;
    m_a[l] = m_b[l] = nb_a[l] = nb_b[l] = 0;
  }
  // Slot v's region is v's; the warp's row i holds slot 4 i + warp, so its
  // merges see regions 4 strides apart.
  uint64_t* wlists = lists + warp * stride;
  const int wstride = 4 * stride;
  uint64_t* Ba = lists + xa * stride + a.lcap + a.glcap;
  uint64_t* Bb = lists + xb * stride + a.lcap + a.glcap;
  // List l's merges where a lane of the warp needs one.
  auto merge = [&](int l, bool need_a, bool need_b) {
    if (!__any_sync(kFull, need_a || need_b)) return;
    merge_pending<kI8MaxK>(wlists + loff[l], lcap[l], wstride - lcap[l], cnt[l], need_a, need_b,
                           m_a[l], m_b[l], nb_a[l], nb_b[l], thr_a[l], thr_b[l], boff[l]);
  };

  // This thread's row of a tile: its scale, and madd or its tenant,
  // alive and is_super, loaded a whole tile ahead (independent loads: a
  // tile's product is too short to hide a round trip to HBM).
  uint32_t n_scale = 0u, n_word = 0u;
  uint8_t n_alive = 0, n_super = 0;
  auto prefetch = [&](int t) {
    const long long r = r_begin + (long long)t * BN + tid;
    if (t < tiles && r < r_end) {
      n_scale = __float_as_uint(a.scale[r]);
      if constexpr (kKeyed) {
        n_word = (uint32_t)a.row_tenant[r];
        n_alive = a.alive[r];
        n_super = a.is_super[r];
      } else {
        n_word = __float_as_uint(a.madd[r]);
      }
    }
  };
  prefetch(0);
  int acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0;
  for (int t = 0; t < tiles; ++t) {
    const long long r0 = r_begin + (long long)t * BN;
    const int g0 = (int)r0;                      // row of column 0
    const bool in = r0 + tid < r_end;
    const uint32_t ws = in ? n_scale : 0u;
    uint32_t wa, wb = 0u, wc = 0u;
    if constexpr (kKeyed) {
      const int key = in && n_alive ? (int)n_word : kNoTenant;
      const bool sup = in && n_super;
      wa = (uint32_t)(sup ? kNoTenant : key);
      wb = (uint32_t)(sup ? key : kNoTenant);
      wc = __float_as_uint(in ? kNeg : -INFINITY);
    } else {
      wa = in ? n_word : __float_as_uint(-INFINITY);
    }
    prefetch(t + 1);
    wg_product<1, BN>(acc, ring, full, empty, a.ns, t, a.panels, 0, tid);
    // Buffer t % 2 was last read in tile t - 2's epilogue, which every
    // thread finished before tile t - 1's barrier.
    uint32_t* colS = cols + (t & 1) * 4 * BN;
    uint32_t* colW[2] = {colS + BN, colS + 2 * BN};
    const uint32_t* colC = colS + 3 * BN;
    colS[tid] = ws;
    colW[0][tid] = wa;
    colW[1][tid] = wb;
    colS[3 * BN + tid] = wc;
    hopper::named_sync(1, 128);
    if (!warp_live) continue;

    // The tile's int32 sums, staged thread-private: chunk c of this thread
    // (fragment elements 4c .. 4c + 3: rows a and b, columns 8c + 2tq + {0,
    // 1}) at sums[c * 128 + tid], which the folds walk in rolled loops.
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
      sums[c * 128 + tid] = make_int4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);

    // The keyed form's first pass masks both lists in one walk, one score
    // an element for both tiers.
    uint32_t mla[2] = {0u, 0u}, mlb[2] = {0u, 0u};
    bool both = false;
    if constexpr (kKeyed) {
      both = cnt[0] > 0 && cnt[1] > 0 && first[0] && first[1];
      if (both) {
#pragma unroll 2
        for (int c = part; c < BN / 8; c += rep) {
          const int4 v = sums[c * 128 + tid];
          const uint2 sw = *reinterpret_cast<const uint2*>(colS + 8 * c + 2 * tq);
          const uint2 ka = *reinterpret_cast<const uint2*>(colW[0] + 8 * c + 2 * tq);
          const uint2 kb = *reinterpret_cast<const uint2*>(colW[1] + 8 * c + 2 * tq);
          const uint2 kf = *reinterpret_cast<const uint2*>(colC + 8 * c + 2 * tq);
          const float s0 = i8_score(v.x, qs_a, sw.x), s1 = i8_score(v.y, qs_a, sw.y);
          const float s2 = i8_score(v.z, qs_b, sw.x), s3 = i8_score(v.w, qs_b, sw.y);
          const float f0 = __uint_as_float(kf.x), f1 = __uint_as_float(kf.y);
          const uint32_t a0 = ((int)ka.x == ten_a ? s0 : f0) > thr_a[0] ? 1u : 0u;
          const uint32_t a1 = ((int)ka.y == ten_a ? s1 : f1) > thr_a[0] ? 2u : 0u;
          const uint32_t b0 = ((int)ka.x == ten_b ? s2 : f0) > thr_b[0] ? 1u : 0u;
          const uint32_t b1 = ((int)ka.y == ten_b ? s3 : f1) > thr_b[0] ? 2u : 0u;
          const uint32_t ga0 = ((int)kb.x == ten_a ? s0 : f0) > thr_a[1] ? 1u : 0u;
          const uint32_t ga1 = ((int)kb.y == ten_a ? s1 : f1) > thr_a[1] ? 2u : 0u;
          const uint32_t gb0 = ((int)kb.x == ten_b ? s2 : f0) > thr_b[1] ? 1u : 0u;
          const uint32_t gb1 = ((int)kb.y == ten_b ? s3 : f1) > thr_b[1] ? 2u : 0u;
          mla[0] |= (a0 | a1) << (2 * c);
          mlb[0] |= (b0 | b1) << (2 * c);
          mla[1] |= (ga0 | ga1) << (2 * c);
          mlb[1] |= (gb0 | gb1) << (2 * c);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (cnt[l] == 0) continue;
      const uint32_t* cw = colW[l];
      // A mask of the scores above the threshold (and after the previous
      // pass's last pair), this warp's copy's chunks; then the few
      // survivors, their scores computed again the same way.
      uint32_t ma = mla[l], mb = mlb[l];
#pragma unroll 4
      for (int c = both ? BN / 8 : part; c < BN / 8; c += rep) {
        const int4 v = sums[c * 128 + tid];
        const uint2 sw = *reinterpret_cast<const uint2*>(colS + 8 * c + 2 * tq);
        const uint2 kw = *reinterpret_cast<const uint2*>(cw + 8 * c + 2 * tq);
        uint2 kf = make_uint2(0u, 0u);
        if constexpr (kKeyed) kf = *reinterpret_cast<const uint2*>(colC + 8 * c + 2 * tq);
        const int row = g0 + 8 * c + 2 * tq;
        const float s0 = i8_tier<kKeyed>(i8_score(v.x, qs_a, sw.x), kw.x, kf.x, ten_a);
        const float s1 = i8_tier<kKeyed>(i8_score(v.y, qs_a, sw.y), kw.y, kf.y, ten_a);
        const float s2 = i8_tier<kKeyed>(i8_score(v.z, qs_b, sw.x), kw.x, kf.x, ten_b);
        const float s3 = i8_tier<kKeyed>(i8_score(v.w, qs_b, sw.y), kw.y, kf.y, ten_b);
        const bool u0 = s0 > thr_a[l] && (first[l] || ranks_after(s0, row, ts_a[l], ta_a[l]));
        const bool u1 = s1 > thr_a[l] && (first[l] || ranks_after(s1, row + 1, ts_a[l], ta_a[l]));
        const bool u2 = s2 > thr_b[l] && (first[l] || ranks_after(s2, row, ts_b[l], ta_b[l]));
        const bool u3 = s3 > thr_b[l] && (first[l] || ranks_after(s3, row + 1, ts_b[l], ta_b[l]));
        ma |= ((u0 ? 1u : 0u) | (u1 ? 2u : 0u)) << (2 * c);
        mb |= ((u2 ? 1u : 0u) | (u3 ? 2u : 0u)) << (2 * c);
      }
      int off_a, tot_a, off_b, tot_b;
      quad_scan(__popc(ma), off_a, tot_a);
      quad_scan(__popc(mb), off_b, tot_b);
      // A batch that could not take the survivors is merged first.
      merge(l, nb_a[l] > 0 && nb_a[l] + tot_a > bcap[l], nb_b[l] > 0 && nb_b[l] + tot_b > bcap[l]);
      if (ma | mb) {
        uint64_t* ba = Ba + bpos[l] + nb_a[l] + off_a;
        uint64_t* bb = Bb + bpos[l] + nb_b[l] + off_b;
        for (uint32_t m = ma; m; m &= m - 1) {
          const int bit = __ffs(m) - 1, c = bit >> 1, col = 8 * c + 2 * tq + (bit & 1);
          const int4 v = sums[c * 128 + tid];
          *ba++ = list_key(i8_tier<kKeyed>(i8_score(bit & 1 ? v.y : v.x, qs_a, colS[col]),
                                           cw[col], kKeyed ? colC[col] : 0u, ten_a),
                           g0 + col);
        }
        for (uint32_t m = mb; m; m &= m - 1) {
          const int bit = __ffs(m) - 1, c = bit >> 1, col = 8 * c + 2 * tq + (bit & 1);
          const int4 v = sums[c * 128 + tid];
          *bb++ = list_key(i8_tier<kKeyed>(i8_score(bit & 1 ? v.w : v.z, qs_b, colS[col]),
                                           cw[col], kKeyed ? colC[col] : 0u, ten_b),
                           g0 + col);
        }
      }
      nb_a[l] += tot_a;
      nb_b[l] += tot_b;
      // While the list is not full its threshold is -inf: merge now to
      // raise it; a shared batch is emptied before the other list's turn.
      merge(l, nb_a[l] > 0 && (shared_batch || m_a[l] < cnt[l]),
            nb_b[l] > 0 && (shared_batch || m_b[l] < cnt[l]));
    }
  }

  // ---- the split's lists: the last merges, then keys out (0: empty)
#pragma unroll
  for (int l = 0; l < NL; ++l)
    if (cnt[l] > 0) merge(l, nb_a[l] > 0, nb_b[l] > 0);
  if (rep == 1) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (cnt[l] == 0) continue;
      uint64_t* out = l ? a.gcand : a.cand;
      for (int i = 0; i < 16; ++i) {
        const int len = __shfl_sync(kFull, i < 8 ? m_a[l] : m_b[l], 4 * (i & 7));
        const int j = 4 * i + warp, q = q0 + j;
        if (j >= a.qt || q >= a.nq) continue;
        const uint64_t* L = wlists + loff[l] + i * wstride;
        const long long o = ((long long)split * a.nq + q) * cnt[l];
        for (int idx = lane; idx < cnt[l]; idx += 32) out[o + idx] = idx < len ? L[idx] : 0ull;
      }
    }
    return;
  }
  // A query's copies: each key's place in the split's list is its index in
  // its copy's list plus the keys of the other copies above it (no two keys
  // are equal), by binary search. The lists' lengths go through the row
  // words' buffers, which every warp is done with.
  int* mlen = reinterpret_cast<int*>(cols);          // [list][slot]
  hopper::named_sync(1, 128);
  if (tq == 0) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      mlen[64 * l + xa] = m_a[l];
      mlen[64 * l + xb] = m_b[l];
    }
  }
  hopper::named_sync(1, 128);
  for (int j = warp; j < a.qt; j += 4) {
    const int q = q0 + j;
    if (q >= a.nq) break;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (cnt[l] == 0) continue;
      uint64_t* out = (l ? a.gcand : a.cand) + ((long long)split * a.nq + q) * cnt[l];
      const int* ml = mlen + 64 * l + j * rep;
      int total = 0;
      for (int r = 0; r < rep; ++r) total += ml[r];
      for (int idx = total + lane; idx < cnt[l]; idx += 32) out[idx] = 0ull;
      for (int r = 0; r < rep; ++r) {
        const uint64_t* L = lists + (j * rep + r) * stride + loff[l];
        for (int idx = lane; idx < ml[r]; idx += 32) {
          const uint64_t key = L[idx];
          int rank = idx;
          for (int r2 = 0; r2 < rep; ++r2)
            if (r2 != r) rank += count_greater(lists + (j * rep + r2) * stride + loff[l], ml[r2], key);
          if (rank < cnt[l]) out[rank] = key;
        }
      }
    }
  }
}

template <bool kKeyed>
cudaError_t launch_i8_wg(const I8Args& a, const CUtensorMap& map_e, const CUtensorMap& map_q,
                         cudaStream_t st) {
  auto kernel = i8_stage1_wgmma<kKeyed>;
  const size_t smem = i8_wg_smem(a.live, I8WgShape{a.ns, a.lcap, a.glcap, a.bcap, a.gbcap});
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.nq + a.qt - 1) / a.qt, a.splits), 256, smem, st>>>(map_e, map_q, a);
  return cudaGetLastError();
}

// ---- stage 2

// Block (q, l) writes columns [c0, c0 + c) of list l of query q (0: the ANN
// or additive list, out [nq, ldk] from column k0; 1: the gate, gout [nq,
// ldg] from column g0), c = kc or gc (a block of a list with nothing left
// this pass returns), from the splits' c-entry lists of keys, split-major:
// the c largest keys (see the section's note). `cache` is the number of
// keys the launch's dynamic shared memory holds. The radix passes walk the
// keys a split at a time, a warp a split, so a warp's keys are one sorted
// run. Once the digit found so far leaves at most kI8SelBin keys in its
// bin, one pass gathers the bin (and the keys above it, which are in), and
// the later digits are found in the bin alone.
__global__ void __launch_bounds__(kI8SelThreads)
i8_select(const uint64_t* __restrict__ cand, const uint64_t* __restrict__ gcand, int splits,
          int nq, int kc, int gc, int k0, int g0, int ldk, int ldg, int cache,
          float* __restrict__ out_s, int* __restrict__ out_r, float* __restrict__ gout_s,
          int* __restrict__ gout_r) {
  constexpr int T = kI8SelThreads;
  constexpr int W = T / 32;
  extern __shared__ uint64_t held_keys[];    // [cache]
  __shared__ int hist[256];
  __shared__ uint64_t sel[kI8MaxK];
  __shared__ uint64_t bin[kI8SelBin];
  __shared__ int s_digit, s_need, s_size, s_count, s_nbin;
  const bool gate = blockIdx.y == 1;
  const int c = gate ? gc : kc;
  if (c == 0) return;
  const int q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint64_t* src = gate ? gcand : cand;
  const bool held = splits * c <= cache;
  auto key = [&](int sp, int j) -> uint64_t {
    return held ? held_keys[sp * c + j] : src[((long long)sp * nq + q) * c + j];
  };
  if (held) {
    for (int i = tid; i < splits * c; i += T) {
      const int sp = i / c;
      held_keys[i] = src[((long long)sp * nq + q) * c + (i - sp * c)];
    }
  }
  if (tid == 0) s_count = s_nbin = 0;
  __syncthreads();

  // The c-th largest key, a digit of 8 bits a pass from the top: each pass
  // counts the keys that share the digits found so far, by their next
  // digit, and one warp finds the digit where the count from the top
  // reaches what is needed.
  uint64_t prefix = 0ull;
  int need = c, shift = 56;
  bool narrowed = false;
  while (true) {
    const uint64_t hmask = shift == 56 ? 0ull : ~0ull << (shift + 8);
    for (int i = tid; i < 256; i += T) hist[i] = 0;
    __syncthreads();
    if (!narrowed) {
      // The keys of a warp that share the prefix come in runs of equal
      // digits: one shared atomic a run, its length from the ballot of run
      // starts (a new digit, or the first hit after a miss).
      for (int sp = warp; sp < splits; sp += W) {
        for (int j0 = 0; j0 < c; j0 += 32) {
          const int j = j0 + lane;
          const uint64_t x = j < c ? key(sp, j) : 0ull;
          const bool hit = x != 0ull && (x & hmask) == prefix;
          const int dg = (int)((x >> shift) & 255u);
          const int pdg = __shfl_up_sync(kFull, dg, 1);
          const bool phit = __shfl_up_sync(kFull, hit, 1);
          const bool start = hit && (lane == 0 || !phit || pdg != dg);
          const unsigned ends = __ballot_sync(kFull, start) | ~__ballot_sync(kFull, hit);
          if (start) {
            const unsigned after = lane == 31 ? 0u : ends >> (lane + 1);
            atomicAdd(&hist[dg], after ? __ffs(after) : 32 - lane);
          }
        }
      }
    } else {
      for (int i = tid; i < s_nbin; i += T)
        if ((bin[i] & hmask) == prefix) atomicAdd(&hist[(int)((bin[i] >> shift) & 255u)], 1);
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds digits 255 - 8l down to 248 - 8l.
      int h[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = hist[255 - 8 * lane - j];
        sum += h[j];
      }
      int inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      const int before = inc - sum;
      const bool mine = before < need && need <= inc;
      if (mine) {
        int run = before;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run + h[j] >= need) {
            s_digit = 255 - 8 * lane - j;
            s_need = need - run;
            s_size = h[j];
            break;
          }
          run += h[j];
        }
      }
      // Fewer keys than c (never, for lists of at most N rows): take all.
      if (__ballot_sync(kFull, mine) == 0u && lane == 0) {
        s_digit = 0;
        s_need = need;
        s_size = 0;
      }
    }
    __syncthreads();
    prefix |= (uint64_t)s_digit << shift;
    need = s_need;
    if (shift == 0) break;
    if (!narrowed && s_size <= kI8SelBin) {
      // Gather the bin, and the keys above it (c - need of them) into sel.
      const uint64_t mask = ~0ull << shift;
      for (int sp = warp; sp < splits; sp += W) {
        for (int j0 = 0; j0 < c; j0 += 32) {
          const int j = j0 + lane;
          const uint64_t x = j < c ? key(sp, j) : 0ull;
          const bool in_bin = x != 0ull && (x & mask) == prefix;
          const bool above = x != 0ull && (x & mask) > prefix;
          const unsigned bb = __ballot_sync(kFull, in_bin), ba = __ballot_sync(kFull, above);
          int pb = 0, pa = 0;
          if (lane == 0) {
            if (bb) pb = atomicAdd(&s_nbin, __popc(bb));
            if (ba) pa = atomicAdd(&s_count, __popc(ba));
          }
          pb = __shfl_sync(kFull, pb, 0);
          pa = __shfl_sync(kFull, pa, 0);
          const unsigned below = (1u << lane) - 1u;
          if (in_bin) bin[pb + __popc(bb & below)] = x;
          if (above && pa + __popc(ba & below) < c) sel[pa + __popc(ba & below)] = x;
        }
      }
      narrowed = true;
      __syncthreads();
    }
    shift -= 8;
  }

  // The keys at or above it: exactly c of them, gathered, then sorted by
  // one warp.
  if (narrowed) {
    for (int i = tid; i < s_nbin; i += T) {
      if (bin[i] >= prefix) {
        const int p = atomicAdd(&s_count, 1);
        if (p < c) sel[p] = bin[i];
      }
    }
  } else {
    for (int sp = warp; sp < splits; sp += W) {
      for (int j0 = 0; j0 < c; j0 += 32) {
        const int j = j0 + lane;
        const uint64_t x = j < c ? key(sp, j) : 0ull;
        const bool take = x != 0ull && x >= prefix;
        const unsigned b = __ballot_sync(kFull, take);
        if (b) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&s_count, __popc(b));
          base = __shfl_sync(kFull, base, 0);
          const int p = base + __popc(b & ((1u << lane) - 1u));
          if (take && p < c) sel[p] = x;
        }
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int n = s_count < c ? s_count : c;
    uint64_t k8[kI8MaxK / 32];
    warp_sort_desc<kI8MaxK>(sel, n, k8);
    float* os = gate ? gout_s : out_s;
    int* orow = gate ? gout_r : out_r;
    const long long o = (long long)q * (gate ? ldg : ldk) + (gate ? g0 : k0);
#pragma unroll
    for (int j = 0; j < kI8MaxK / 32; ++j) {
      const int idx = 32 * j + lane;
      if (idx < c) {
        os[o + idx] = k8[j] ? key_score(k8[j]) : -INFINITY;
        orow[o + idx] = k8[j] ? key_row(k8[j]) : INT32_MAX;
      }
    }
  }
}

// ---- host

// Route, row splits and the list entries one pass takes (kc; gc for the
// keyed form's gate) of an int8 scan. The route is the tensor cores where
// d % 16 == 0 (TMA's row stride), else dp4a, unless `route` (>= 0) forces
// one.
struct I8Plan {
  int route, splits, kc, gc, qt, rep;
};

// False where the card takes no such scan: d past kI8MaxD, lists longer
// than the shadow, the tensor cores forced at d % 16 != 0, or a dp4a query
// tile of 4 that shared memory cannot hold (d past ~50,000).
inline bool i8_plan(long long n, int nq, int k, int g, int d, int sms, int route, I8Plan& p) {
  if (n < 1 || nq < 1 || d < 1 || d > kI8MaxD || k < 1 || k > n || g < 0 || g > n ||
      route > kI8Dp4a || sms < 1)
    return false;
  if (route < 0) route = d % 16 == 0 ? kI8Wgmma : kI8Dp4a;
  if (route == kI8Wgmma && d % 16 != 0) return false;
  p.route = route;
  p.qt = 64;
  p.rep = 1;
  if (route == kI8Wgmma) {
    // Past 32 queries, tiles of 32 where 64 queries' lists would take
    // shorter passes (each pass streams the shadow again): the keyed form's
    // 136 + 9 at 64 queries.
    int kc64, gc64, kc32, gc32;
    i8_wg_caps(nq < 64 ? nq : 64, k, g, kc64, gc64);
    i8_wg_caps(nq < 32 ? nq : 32, k, g, kc32, gc32);
    if (nq > 32 && (kc64 < kc32 || gc64 < gc32)) p.qt = 32;
    // Up to 16 queries, 4 or 2 copies of each (one warp a copy), where
    // their lists take the whole lists in one pass with batches of their
    // own: at the chat turn's Q = 1 the four warps fold a quarter of each
    // tile each, where one warp would fold it all.
    for (int r = nq <= 8 ? 4 : (nq <= 16 ? 2 : 1); r > 1; r /= 2) {
      int kcr, gcr;
      i8_wg_caps(nq * r, k, g, kcr, gcr);
      const I8WgShape sr = i8_wg_shape(nq * r, kcr, gcr);
      if (sr.ns > 0 && kcr >= kc64 && gcr >= gc64 && (gcr == 0 || sr.gbcap > 0)) {
        p.rep = r;
        p.qt = 64 / r;
        break;
      }
    }
    const int live = (nq < p.qt ? nq : p.qt) * p.rep;
    i8_wg_caps(live, k, g, p.kc, p.gc);
    if (i8_wg_shape(live, p.kc, p.gc).ns == 0) return false;
    const long long qtiles = (nq + p.qt - 1) / p.qt, rtiles = (n + kI8BN - 1) / kI8BN;
    long long s = qtiles < sms ? sms / qtiles : 1;
    if (s > rtiles) s = rtiles;
    if (s > kMaxSplits) s = kMaxSplits;
    p.splits = s < 1 ? 1 : (int)s;
  } else {
    p.kc = k < kI8MaxK ? k : kI8MaxK;
    p.gc = g < kI8MaxK ? g : kI8MaxK;
    if (i8_smem(4, i8_qstride(d), p.kc, p.gc) > (size_t)kSmemMax) return false;
    p.splits = i8_splits(n, nq, p.kc, p.gc, d, sms);
  }
  return true;
}

// The quantization (tensor-core route), then a stage 1 and a stage 2 a
// pass until both lists are full; each launch the card takes is added to
// *launched. a.kc and a.gc are the plan's entries a pass; the keyed form
// is the one with a.row_tenant. A launch the card refuses returns its
// error: no route stands in for another.
int run_i8(I8Args a, int route, float* out_s, int* out_r, float* gout_s, int* gout_r,
           int* launched, cudaStream_t st) {
  const bool keyed = a.row_tenant != nullptr;
  if (a.n < 1 || a.d < 1 || a.d > kI8MaxD || a.k < 1 || a.k > a.n || a.g < 0 || a.g > a.n ||
      (a.g > 0) != keyed || a.nq < 1 || a.splits < 1 || a.splits > kMaxSplits || a.kc < 1 ||
      a.kc > kI8MaxK || a.kc > a.k || a.gc < 0 || a.gc > kI8MaxK || a.gc > a.g ||
      (keyed && a.gc < 1) || (keyed ? !a.alive || !a.is_super || !a.q_tenant : !a.madd) ||
      (route != kI8Wgmma && route != kI8Dp4a) ||
      (route == kI8Wgmma && (a.d % 16 != 0 || !a.qq || !a.qsc ||
                             (a.rep != 1 && a.rep != 2 && a.rep != 4) ||
                             (a.rep == 1 ? a.qt != 32 && a.qt != 64 : a.qt * a.rep != 64))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_e, map_q;
  int bq = 0;
  cudaError_t err;
  if (route == kI8Wgmma) {
    a.live = (a.nq < a.qt ? a.nq : a.qt) * a.rep;
    const I8WgShape sh = i8_wg_shape(a.live, a.kc, a.gc);
    if (sh.ns == 0) return (int)cudaErrorInvalidValue;
    a.ns = sh.ns; a.lcap = sh.lcap; a.glcap = sh.glcap; a.bcap = sh.bcap; a.gbcap = sh.gbcap;
    a.panels = (a.d + 127) / 128;
    const long long rtiles = (a.n + kI8BN - 1) / kI8BN;
    a.rows_per_split = ((rtiles + a.splits - 1) / a.splits) * kI8BN;
    // The codes as rows of d / 2 two-byte elements: a 64-element box is 128
    // code bytes; rows past n and bytes past d arrive as zeros.
    const int qrows = (a.nq + a.qt - 1) / a.qt * 64;
    if (!hopper::encode_rows_map(&map_e, a.codes, a.d / 2, a.n, 1, 1, a.d / 2, 0, 0, kI8BN) ||
        !hopper::encode_rows_map(&map_q, a.qq, a.d / 2, qrows, 1, 1, a.d / 2, 0, 0, 64))
      return (int)cudaErrorNotSupported;
    i8_quantize<<<qrows, kThreads, 0, st>>>(a.qry, a.d, a.nq, a.qt, a.rep,
                                            const_cast<int8_t*>(a.qq), const_cast<float*>(a.qsc));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (launched) ++*launched;
  } else {
    a.qstride = i8_qstride(a.d);
    bq = i8_query_tile(a.nq, a.d, a.kc, a.gc);
    const long long rtiles = (a.n + kBR - 1) / kBR;
    a.rows_per_split = ((rtiles + a.splits - 1) / a.splits) * kBR;
  }
  const int kcap = a.kc, gcap = a.gc;
  const long long mmax = (long long)a.splits * (kcap > gcap ? kcap : gcap);
  const int cache = (int)(mmax < kI8SelCache ? mmax : kI8SelCache);
  const size_t sel_smem = (size_t)cache * sizeof(uint64_t);
  err = cudaFuncSetAttribute(i8_select, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sel_smem);
  if (err != cudaSuccess) return (int)err;
  for (int k0 = 0, g0 = 0; k0 < a.k || g0 < a.g;) {
    I8Args p = a;
    p.kc = a.k - k0 < kcap ? a.k - k0 : kcap;
    p.gc = a.g - g0 < gcap ? a.g - g0 : gcap;
    p.after_s = k0 ? out_s + k0 - 1 : nullptr;
    p.after_r = k0 ? out_r + k0 - 1 : nullptr;
    p.gafter_s = g0 ? gout_s + g0 - 1 : nullptr;
    p.gafter_r = g0 ? gout_r + g0 - 1 : nullptr;
    if (route == kI8Wgmma)
      err = keyed ? launch_i8_wg<true>(p, map_e, map_q, st) : launch_i8_wg<false>(p, map_e, map_q, st);
    else
      err = keyed ? launch_i8_for<true>(p, bq, st) : launch_i8_for<false>(p, bq, st);
    if (err != cudaSuccess) return (int)err;
    if (launched) ++*launched;
    i8_select<<<dim3(a.nq, keyed ? 2 : 1), kI8SelThreads, sel_smem, st>>>(
        p.cand, p.gcand, a.splits, a.nq, p.kc, p.gc, k0, g0, a.k, a.g, cache, out_s, out_r,
        gout_s, gout_r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (launched) ++*launched;
    k0 += p.kc;
    g0 += p.gc;
  }
  return 0;
}

}  // namespace
