// Masked cosine top-k over an embedding arena, for Hopper (sm_90a).
//
// Replaces the TPU kernel lazzaro_tpu/ops/pallas_topk.py:pallas_masked_topk
// (body _topk_block_kernel) and its arena wrapper masked_topk_arena.
//
// Function: for every query q and arena row r,
//     score[q, r] = dot_f32(query[q], emb[r]) + madd[r]
// (madd is 0 for live rows and -1e30 for masked ones, added in f32 exactly as
// the TPU kernel does), and the k best (score, row) pairs per query in
// score-descending, row-ascending order: ties go to the lowest row, as
// lax.top_k and the TPU kernel's first-argmax do.
//
// Design. The TPU walks its grid in order on one core; here blocks run in
// parallel on 132 SMs, so the work is cut two ways and merged in a second
// pass:
//   stage 1  grid = (query tiles) x (row splits). A block walks its row range
//            in tiles of BR=128 rows. Per tile it stages slices of DK=32
//            dimensions of the rows (16-byte vector loads, converted to f32)
//            and of its BQ queries in shared memory and accumulates a
//            register-tiled BQ x BR block of f32 dot products on the CUDA
//            cores (FMA). The masked scores of the tile go to shared memory,
//            and one warp per query merges them into that query's running
//            top-k list (sorted, in shared memory). Rows are visited in
//            ascending order, so a candidate only enters on a strictly
//            better score and equal scores keep the lower row. Each block
//            writes its lists to cand[split, q, :].
//   stage 2  one block per query merges the splits' sorted lists (a k-round
//            head merge under the same order) into out[q, :].
// Lists hold at most 128 entries. A larger k runs in passes of 128: pass p
// admits only pairs that rank after the last pair pass p-1 wrote for the
// query, so the passes' outputs concatenate to the exact top-k.
// No scratch is allocated here: the caller passes cand_* and out_*.
//
// What bounds it on an H100: at the chat and search shapes (Q <= 64) the scan
// must read every arena row once, so the bound is HBM bytes, N*d*itemsize /
// 3.35 TB/s (0.48 ms for 1,048,576 x 768 bf16). At the dedup-probe shape
// (Q = 8,192) it is arithmetic, 2*N*d*Q operations; this kernel runs them as
// f32 FMA on the CUDA cores, far from the tensor-core bound. A wgmma/TMA
// version is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBR = 128;           // arena rows per tile
constexpr int kDK = 32;            // dimensions per staged slice
constexpr int kLD = kDK + 1;       // padded row stride of the staged slices
constexpr int kMaxK = 128;
constexpr int kMaxSplits = 1024;
constexpr unsigned kFull = 0xffffffffu;

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

// T: uint16_t (bf16 bits) or float. BQ queries per block, MQ x MR outputs per
// thread; the thread grid is (BQ/MQ) x (kThreads*MQ/BQ) and covers kBR rows.
template <typename T, int BQ, int MQ, int MR>
__global__ void __launch_bounds__(kThreads)
topk_stage1(const T* __restrict__ emb, const float* __restrict__ madd,
            const T* __restrict__ qry, long long n, int d, int nq, int k,
            long long rows_per_split, const float* __restrict__ after_s,
            const long long* __restrict__ after_r, int ld_after,
            float* __restrict__ cand_s, int* __restrict__ cand_r) {
  constexpr int TQ = BQ / MQ;
  constexpr int TR = kThreads / TQ;
  static_assert(TR * MR == kBR, "thread grid must cover one row tile");

  extern __shared__ float smem[];
  float* qs = smem;                          // [BQ][kLD]
  float* rs = qs + BQ * kLD;                 // [kBR][kLD]
  float* sc = rs + kBR * kLD;                // [BQ][kBR + 1]
  float* ls = sc + BQ * (kBR + 1);           // [BQ][k] list scores
  int* lr = reinterpret_cast<int*>(ls + BQ * k);   // [BQ][k] list rows

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

  for (long long r0 = r_begin; r0 < r_end; r0 += kBR) {
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

    // Masked scores of the tile; rows past the range are never candidates.
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      const int ri = tr + j * TR;
      const long long r = r0 + ri;
      const float m = r < r_end ? madd[r] : 0.f;
#pragma unroll
      for (int i = 0; i < MQ; ++i) sc[(tq + i * TQ) * (kBR + 1) + ri] = acc[i][j] + m;
    }
    __syncthreads();

    // One warp per query: merge the tile into the query's sorted list.
    for (int qi = warp; qi < BQ; qi += kWarps) {
      if (q0 + qi >= nq) break;
      float* lsq = ls + qi * k;
      int* lrq = lr + qi * k;
      // A later pass admits only pairs ranking after (ts, tr).
      const float ts = after_s ? after_s[(long long)(q0 + qi) * ld_after] : INFINITY;
      const long long tr = after_r ? after_r[(long long)(q0 + qi) * ld_after] : -1;
      for (int c = 0; c < kBR; c += 32) {
        const long long r = r0 + c + lane;
        const float s = sc[qi * (kBR + 1) + c + lane];
        const bool after = s < ts || (s == ts && r > tr);
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
}

// One block per query: k rounds of "best head among the splits' sorted
// lists", advancing the winning list. Query q's output starts at q * ldo.
__global__ void __launch_bounds__(kThreads)
topk_merge(const float* __restrict__ cand_s, const int* __restrict__ cand_r,
           int splits, int nq, int k, float* __restrict__ out_s,
           long long* __restrict__ out_r, int ldo) {
  constexpr int kOwn = kMaxSplits / kThreads;
  __shared__ float ws[kWarps];
  __shared__ int wr[kWarps];
  __shared__ int wsp[kWarps];
  __shared__ int win;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

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
      const long long idx = ((long long)sp * nq + q) * k;
      hs[o] = cand_s[idx];
      hr[o] = cand_r[idx];
    }
  }

  for (int t = 0; t < k; ++t) {
    float bs = -INFINITY;
    int br = INT32_MAX, bsp = -1;
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      const int sp = tid + o * kThreads;
      if (sp < splits && (bsp < 0 || better(hs[o], hr[o], bs, br))) {
        bs = hs[o]; br = hr[o]; bsp = sp;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s2 = __shfl_down_sync(kFull, bs, off);
      const int r2 = __shfl_down_sync(kFull, br, off);
      const int p2 = __shfl_down_sync(kFull, bsp, off);
      if (p2 >= 0 && (bsp < 0 || better(s2, r2, bs, br))) { bs = s2; br = r2; bsp = p2; }
    }
    if (lane == 0) { ws[warp] = bs; wr[warp] = br; wsp[warp] = bsp; }
    __syncthreads();
    if (tid == 0) {
      float s = ws[0];
      int r = wr[0], p = wsp[0];
      for (int w = 1; w < kWarps; ++w) {
        if (wsp[w] >= 0 && (p < 0 || better(ws[w], wr[w], s, r))) {
          s = ws[w]; r = wr[w]; p = wsp[w];
        }
      }
      out_s[(long long)q * ldo + t] = s;
      out_r[(long long)q * ldo + t] = r;
      win = p;
    }
    __syncthreads();
    const int w = win;
    if (w % kThreads == tid) {
      const int o = w / kThreads;
      const int nxt = ++ptr[o];
      const long long idx = ((long long)w * nq + q) * k + nxt;
      hs[o] = nxt < k ? cand_s[idx] : -INFINITY;
      hr[o] = nxt < k ? cand_r[idx] : INT32_MAX;
    }
    __syncthreads();
  }
}

int query_tile(int nq) { return nq <= 4 ? 4 : (nq <= 16 ? 16 : 64); }

template <typename T, int BQ, int MQ, int MR>
cudaError_t launch_stage1(const void* emb, const float* madd, const void* qry,
                          long long n, int d, int nq, int k, int splits,
                          long long rows_per_split, const float* after_s,
                          const long long* after_r, int ld_after,
                          float* cand_s, int* cand_r, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((BQ + kBR) * kLD + BQ * (kBR + 1))
                      + (sizeof(float) + sizeof(int)) * (size_t)BQ * k;
  cudaError_t err = cudaFuncSetAttribute(
      topk_stage1<T, BQ, MQ, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nq + BQ - 1) / BQ, splits);
  topk_stage1<T, BQ, MQ, MR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(emb), madd, static_cast<const T*>(qry), n, d, nq,
      k, rows_per_split, after_s, after_r, ld_after, cand_s, cand_r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stage1_for(int bq, const void* emb, const float* madd,
                              const void* qry, long long n, int d, int nq,
                              int k, int splits, long long rows_per_split,
                              const float* after_s, const long long* after_r,
                              int ld_after, float* cand_s, int* cand_r,
                              cudaStream_t stream) {
  if (bq == 4)
    return launch_stage1<T, 4, 1, 2>(emb, madd, qry, n, d, nq, k, splits,
                                     rows_per_split, after_s, after_r, ld_after,
                                     cand_s, cand_r, stream);
  if (bq == 16)
    return launch_stage1<T, 16, 1, 8>(emb, madd, qry, n, d, nq, k, splits,
                                      rows_per_split, after_s, after_r, ld_after,
                                      cand_s, cand_r, stream);
  return launch_stage1<T, 64, 4, 8>(emb, madd, qry, n, d, nq, k, splits,
                                    rows_per_split, after_s, after_r, ld_after,
                                    cand_s, cand_r, stream);
}

}  // namespace

extern "C" {

// Number of row splits stage 1 uses for this shape on a card with `sms`
// multiprocessors: enough blocks for about four per SM.
int masked_topk_splits(long long n, int nq, int sms) {
  const long long qtiles = (nq + query_tile(nq) - 1) / query_tile(nq);
  const long long rtiles = (n + kBR - 1) / kBR;
  long long want = (4LL * sms + qtiles - 1) / qtiles;
  if (want < 1) want = 1;
  if (want > rtiles) want = rtiles;
  if (want > kMaxSplits) want = kMaxSplits;
  return (int)want;
}

// emb [n, d] (bf16 when is_bf16, else f32), madd [n] f32, qry [nq, d] in the
// emb dtype; cand_* [splits, nq, min(k, 128)]; out_s [nq, k] f32, out_r
// [nq, k] i64. Needs d % 8 == 0, 16-byte aligned rows, 1 <= k <= n. Returns
// the CUDA error of the launches (0 on success).
int masked_topk(const void* emb, int is_bf16, const float* madd,
                const void* qry, long long n, int d, int nq, int k,
                int splits, float* cand_s, int* cand_r, float* out_s,
                long long* out_r, void* stream) {
  if (d % 8 != 0 || k < 1 || k > n || nq < 1 || splits < 1 ||
      splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rtiles = (n + kBR - 1) / kBR;
  const long long rows_per_split = ((rtiles + splits - 1) / splits) * kBR;
  const int bq = query_tile(nq);
  for (int k0 = 0; k0 < k; k0 += kMaxK) {
    const int kc = k - k0 < kMaxK ? k - k0 : kMaxK;
    const float* after_s = k0 ? out_s + k0 - 1 : nullptr;
    const long long* after_r = k0 ? out_r + k0 - 1 : nullptr;
    cudaError_t err = is_bf16
        ? launch_stage1_for<uint16_t>(bq, emb, madd, qry, n, d, nq, kc, splits,
                                      rows_per_split, after_s, after_r, k,
                                      cand_s, cand_r, st)
        : launch_stage1_for<float>(bq, emb, madd, qry, n, d, nq, kc, splits,
                                   rows_per_split, after_s, after_r, k, cand_s,
                                   cand_r, st);
    if (err != cudaSuccess) return (int)err;
    topk_merge<<<nq, kThreads, 0, st>>>(cand_s, cand_r, splits, nq, kc,
                                        out_s + k0, out_r + k0, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
