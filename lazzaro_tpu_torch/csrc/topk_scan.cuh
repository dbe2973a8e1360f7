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
//   stage 1  grid = (query tiles) x (row splits). A block walks its row range
//            in tiles of BR=128 rows: register-tiled f32 FMA dot products of
//            its BQ queries with the tile (16-byte loads, slices of DK=32
//            dimensions staged in shared memory). The tile's masked scores go
//            to shared memory, and one warp per query folds them into that
//            query's sorted top-kmax list (insertion on a strictly better
//            score; rows arrive in ascending order, so equal scores keep the
//            lower row) and, in keyed mode, its gate top-1 (a warp arg-max).
//            Keyed mode reads the row columns of a tile once into shared
//            memory as one key per row (tenant, or none if dead) and a super
//            bit, and compares each query's tenant against them.
//   stage 2  one block per query merges the splits: the gate by a block
//            arg-max, the lists by a kmax-round head merge, and writes the
//            k_q tail and the columns [kmax, k) as (NEG, tail_row).
// kmax is the longest list the caller needs (keyed mode: the largest k_q of
// the batch, as the columns past it are masked whatever is computed there).
// Lists hold at most 128 entries; a larger kmax runs in passes of 128, pass p
// admitting only pairs that rank after the last pair pass p-1 wrote (the
// gate is taken in the first pass). A later pass may start from a masked
// pair, but every position it writes is past k_q too. No scratch is
// allocated here: the caller passes it.
//
// What bounds it on an H100: at the chat and search shapes (Q <= 64) the scan
// reads every arena row once, so the bound is HBM bytes, N*d*itemsize (plus
// 4 B of madd or 6 B of row columns per row) over 3.35 TB/s: 0.48 ms for
// 1,048,576 x 768 bf16. At the dedup-probe shape (Q = 8,192) it is
// arithmetic, 2*N*d*Q operations, run here as f32 FMA on the CUDA cores, far
// from the tensor-core bound. The per-candidate list insertion at large kmax
// and the splits x kmax head merge are the other likely losses. Tensor cores
// (wgmma) and TMA are later work.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// T: uint16_t (bf16 bits) or float. BQ queries per block, MQ x MR outputs per
// thread; the thread grid is (BQ/MQ) x (kThreads*MQ/BQ) and covers kBR rows.
// Additive mode reads madd; keyed mode reads alive, row_tenant, is_super and
// q_tenant, and takes the gate when with_gate is set.
template <typename T, int BQ, int MQ, int MR, bool kKeyed>
__global__ void __launch_bounds__(kThreads)
scan_stage1(const T* __restrict__ emb, const float* __restrict__ madd,
            const uint8_t* __restrict__ alive, const int* __restrict__ row_tenant,
            const uint8_t* __restrict__ is_super, const T* __restrict__ qry,
            const int* __restrict__ q_tenant, long long n, int d, int nq, int k,
            long long rows_per_split, int with_gate,
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
              if (better(s, (int)r, bs, br)) { bs = s; br = (int)r; }
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
        float s = scq[c + lane];
        if constexpr (kKeyed) {
          if (!(rkey[c + lane] == ten && !rsup[c + lane])) s = kNeg;
        }
        const bool after = s < ts || (s == ts && r > ta);
        unsigned hits = __ballot_sync(kFull, r < r_end && after && s > lsq[k - 1]);
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
          if (lane == 0) { lsq[cnt] = sn; lrq[cnt] = (int)(r0 + c + src); }
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BQ * k; e += kThreads) {
    const int q = q0 + e / k;
    if (q < nq) {
      const long long o = ((long long)split * nq + q) * k + e % k;
      cand_s[o] = ls[e];
      cand_r[o] = lr[e];
    }
  }
  if constexpr (kKeyed) {
    if (with_gate) {
      for (int e = tid; e < BQ; e += kThreads) {
        if (q0 + e < nq) {
          gate_cs[(long long)split * nq + q0 + e] = gs[e];
          gate_cr[(long long)split * nq + q0 + e] = gr[e];
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
// rounds of "best head among the splits' sorted lists"; a column at or past
// k_q[q] is written as (kNeg, tail_row). The pass that ends at kmax also
// writes the columns [kmax, ldo) that way. with_gate merges the gate too.
template <typename R>
__global__ void __launch_bounds__(kThreads)
scan_merge(const float* __restrict__ gate_cs, const int* __restrict__ gate_cr,
           const float* __restrict__ cand_s, const int* __restrict__ cand_r,
           int splits, int nq, int kc, int k0, int kmax,
           const int* __restrict__ k_q, R tail_row, int with_gate,
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
    if (tid == 0) { gate_s[q] = bs; gate_r[q] = br; }
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
      out_r[(long long)q * ldo + k0 + t] = live ? (R)br : tail_row;
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

int query_tile(int nq) {
  return nq <= 4 ? 4 : (nq <= 8 ? 8 : (nq <= 16 ? 16 : 64));
}

// Number of row splits stage 1 uses for this shape on a card with `sms`
// multiprocessors: enough blocks for about four per SM.
int scan_splits(long long n, int nq, int sms) {
  const long long qtiles = (nq + query_tile(nq) - 1) / query_tile(nq);
  const long long rtiles = (n + kBR - 1) / kBR;
  long long want = (4LL * sms + qtiles - 1) / qtiles;
  if (want < 1) want = 1;
  if (want > rtiles) want = rtiles;
  if (want > kMaxSplits) want = kMaxSplits;
  return (int)want;
}

// Everything one scan needs; the mode's unused pointers are null.
template <bool kKeyed>
struct Scan {
  using R = RowT<kKeyed>;
  const void* emb;
  int is_bf16;
  const float* madd;
  const uint8_t* alive;
  const int* row_tenant;
  const uint8_t* is_super;
  const void* qry;
  const int* q_tenant;
  const int* k_q;
  long long n;
  int d, nq, k_out, kmax, splits;
  R tail_row;
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
  dim3 grid((a.nq + BQ - 1) / BQ, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.emb), a.madd, a.alive, a.row_tenant, a.is_super,
      static_cast<const T*>(a.qry), a.q_tenant, a.n, a.d, a.nq, kc,
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

// Stage 1 and stage 2 for every pass of 128 list entries up to kmax.
template <bool kKeyed>
int run_scan(const Scan<kKeyed>& a, cudaStream_t st) {
  if (a.d % 8 != 0 || a.kmax < 1 || a.kmax > a.k_out || a.k_out > a.n ||
      a.nq < 1 || a.splits < 1 || a.splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const long long rtiles = (a.n + kBR - 1) / kBR;
  const long long rows_per_split = ((rtiles + a.splits - 1) / a.splits) * kBR;
  for (int k0 = 0; k0 < a.kmax; k0 += kMaxK) {
    const int kc = a.kmax - k0 < kMaxK ? a.kmax - k0 : kMaxK;
    cudaError_t err =
        a.is_bf16 ? launch_stage1_for<uint16_t, kKeyed>(a, kc, k0, rows_per_split, st)
                  : launch_stage1_for<float, kKeyed>(a, kc, k0, rows_per_split, st);
    if (err != cudaSuccess) return (int)err;
    scan_merge<RowT<kKeyed>><<<a.nq, kThreads, 0, st>>>(
        a.gate_cs, a.gate_cr, a.cand_s, a.cand_r, a.splits, a.nq, kc, k0,
        a.kmax, a.k_q, a.tail_row, kKeyed && k0 == 0, a.gate_s, a.gate_r,
        a.out_s, a.out_r, a.k_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
