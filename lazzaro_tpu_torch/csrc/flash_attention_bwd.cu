// Causal grouped-query flash attention, backward: dQ, dK and dV from the
// forward's stored log-sum-exp, with no [T, S] tensor in device memory.
//
// Replaces the two kernels of the TPU function
// lazzaro_tpu/ops/flash_attention.py:_flash_bwd_bhtd: the dQ pallas_call
// (body _flash_dq_kernel) and the dK/dV pallas_call (body
// _flash_dkv_kernel), the backward half of its flash_attention custom VJP.
//
// What they compute, as those bodies do: q/dO [B, T, H, D] and k/v
// [B, S, Hkv, D] (bf16 or f32, read in place through their strides: no
// transpose, no padding copy), query head h reads kv head h / (H / Hkv), the
// causal diagonal end-aligned (query row i attends keys 0 .. (S - T) + i).
// Per score tile, in f32: s = (q . k) * scale with scale 1/sqrt(D),
// p = exp(s - lse) (0 above the diagonal), dp = dO . v,
// dS = p * (dp - delta) * scale, where lse [B, H, T] is the forward's and
// delta = rowsum(dO * O) [B, H, T] in f32 (JAX computes it in XLA outside
// its kernels; here the dQ kernel computes it for its q tile's rows from O
// and dO as it starts, and writes it out for the dK/dV kernel, which runs
// after it on the same stream). Then
// dQ = sum_kv cast(dS) . K, dV = sum cast(p)^T . dO and dK = sum cast(dS)^T . Q,
// the casts to the inputs' type, every product accumulated in f32, the
// outputs rounded once to the inputs' type.
//
// Bound on this card: operations. One causal product is
// 2*B*H*D*sum_i(S-T+i+1) operations; dQ does three (s, dP, dQ) and dK/dV
// four (s, dP, dV, dK). At the training shape B = 2, T = S = 2048, H = 8,
// Hkv = 2, D = 256 that is 51.6 and 68.7 GFLOP, 0.0521 and 0.0695 ms at the
// 989 TFLOP/s bf16 tensor-core rate, against 76 and 50 MB of bytes (dQ also
// reads O for delta; at most 0.023 ms at 3.35 TB/s). Only wgmma reaches
// that rate.
//
// bf16 design (flash_bwd_dq_wgmma, flash_bwd_dkv_wgmma; building blocks in
// flash_hopper.cuh). Both kernels run blocks of three warpgroups:
// warpgroups 0 and 1 compute with wgmma, accumulators in registers
// (setmaxnreg 240), and one warp of warpgroup 2 feeds 128-byte swizzled
// tiles by TMA (4-D maps over the tensors' own strides; ragged tails and
// columns past D arrive as zeros) into rings with full and empty
// mbarriers. A layout no map takes (a zero stride, e.g. a gradient
// broadcast over batch or heads) is loaded by the same warp with cp.async
// into the same tiles. Kv tiles are 32 keys, q tiles 64 rows.
// - dQ: a block owns 128 q rows of one (head, batch), 64 per consumer
//   warpgroup, Q and dO resident (128 KB at D = 256), K and V through a
//   ring of 3 (D = 256) or 4 stages. Each warpgroup first computes delta =
//   rowsum(dO * O) for its rows from O and dO in place and writes it out.
//   Per kv tile: S = Q.K^T and dP = dO.V^T are SS wgmma m64n32k16 chains
//   over D; P = exp2(s * scale * log2(e) - lse * log2(e)) and dS in
//   registers (each thread's rows' lse and delta in registers); dS's
//   accumulator fragment, rounded to bf16, is the A fragment of
//   dQ += dS.K (RS wgmma m64nDk16, K the transposed B operand). dS(j-1).K
//   is issued with S(j) and dP(j), so P and dS of tile j are computed while
//   it runs. dQ leaves through stmatrix and TMA stores. Blocks are handed
//   out as the forward's: adjacent 64-row tiles, the last first, or tile i
//   with n-1-i when the launch fits in one wave.
// - dK/dV: a block owns 32 keys of one (kv head, batch), K and V resident;
//   its items are (query head of the GQA group, 64-row q tile) for every
//   q tile whose causal window reaches the kv tile, Q and dO through a ring
//   of 2 (D = 256), 3 or 4 stages. The two consumer warpgroups take
//   alternate items. Per item: S and dP (m64n32, 64 q rows by 32 keys) as
//   in dQ, P and dS in registers, rounded to bf16 and stored transposed to
//   the warpgroup's own P^T and dS^T tiles; then dV^T += dO^T.P and
//   dK^T += Q^T.dS as SS wgmma m64n32k16 with dO and Q as MN-major A
//   operands, so that M runs along the head dimension: both accumulators
//   for all of D take D / 2 registers a thread, and a kv tile can be 32
//   keys, which gives twice the blocks of 64-key tiles (256 at the training
//   shape, handed out kv tile 0 first, whose walk is the longest). At the
//   end warpgroup 1's sums go through shared memory to warpgroup 0, which
//   adds them to its own, rounds once and stores dK and dV rows < S.
// - Each output element is summed by one block in one order (no atomics,
//   no partial sums in device memory), so results do not depend on the
//   run; the dK/dV kernel reads the delta that the dQ kernel wrote on the
//   same stream.
// - What bounds it on the H100 (PERF.md has the numbers): the n = 32 SS
//   products read 3 KB of shared memory per 64 K operations, which caps
//   them near two thirds of the tensor rate; in dK/dV a warpgroup holds
//   one ring stage per item at D = 256, so the next item's Q and dO load
//   only after it is done, and the other warpgroup covers that wait.
//
// f32 keeps the FMA bodies of the first version (no full-width path runs
// f32 attention): one block of 256 threads per (q tile, head, batch) or
// (kv tile, kv head, batch), 32 x 32 tiles staged through shared memory
// with cp.async, the score, dP and accumulator tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

using bf16 = __nv_bfloat16;

// Tile rows and row paddings (elements) of the f32 bodies: the operand
// whose rows a warp's threads walk side by side (PAD_WALK) gets an odd row
// length, so that they hit 32 banks.
template <typename E> struct Tile;
template <> struct Tile<float> {
  static constexpr int DQ_BQ = 32, DQ_BK = 32, KV_BK = 32, KV_BQ = 32;
  static constexpr int PAD_IN = 0, PAD_WALK = 1, PAD_F32 = 0, PAD_E = 0;
};

inline unsigned align128(unsigned x) { return (x + 127u) & ~127u; }

// Shared-memory regions of one block: two input tiles of `rows_a` rows
// (A0, A1: Q and dO in the dQ kernel, K and V in the dK/dV kernel), two of
// `rows_b` rows (B0, B1: K and V, or Q and dO), two f32 score-shaped tiles
// (S, dP), two element-typed ones (dS and, in the dK/dV kernel, P), the f32
// accumulators (one of rows_a rows, or two), and the lse and delta rows.
struct Layout {
  int lda, ldb, lds, ldp, ldo;
  unsigned off_a1, off_b0, off_b1, off_s, off_dp, off_e0, off_e1, off_acc0,
      off_acc1, off_lse, off_delta, bytes;
};

template <typename E>
Layout make_layout(int dp, int rows_a, int rows_b, int pad_a, int pad_b,
                   int n_acc, int n_e, int lse_rows) {
  using C = Tile<E>;
  Layout L;
  L.lda = dp + pad_a;
  L.ldb = dp + pad_b;
  L.lds = rows_b + C::PAD_F32;
  L.ldp = rows_b + C::PAD_E;
  L.ldo = dp + C::PAD_F32;
  unsigned at = align128(rows_a * L.lda * sizeof(E));   // A0 at 0
  L.off_a1 = at;
  at = align128(at + rows_a * L.lda * sizeof(E));
  L.off_b0 = at;
  at = align128(at + rows_b * L.ldb * sizeof(E));
  L.off_b1 = at;
  at = align128(at + rows_b * L.ldb * sizeof(E));
  L.off_s = at;
  at = align128(at + rows_a * L.lds * sizeof(float));
  L.off_dp = at;
  at = align128(at + rows_a * L.lds * sizeof(float));
  L.off_e0 = at;
  at = align128(at + rows_a * L.ldp * sizeof(E));
  L.off_e1 = at;
  if (n_e > 1) at = align128(at + rows_a * L.ldp * sizeof(E));
  L.off_acc0 = at;
  at = align128(at + rows_a * L.ldo * sizeof(float));
  L.off_acc1 = at;
  if (n_acc > 1) at = align128(at + rows_a * L.ldo * sizeof(float));
  L.off_lse = at;
  at += lse_rows * sizeof(float);
  L.off_delta = at;
  at += lse_rows * sizeof(float);
  L.bytes = align128(at);
  return L;
}

struct Strides {
  long long q_b, q_t, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_t, o_h,
      out_b, out_t, out_h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename E> __device__ __forceinline__ E from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// 16-byte asynchronous copy global -> shared (cp.async, sm_80+); with
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows row0 .. row0 + nrows - 1 of one head (row r at src + r * stride) into
// shared memory with leading dimension ld; rows at or past `limit` load as
// zeros. Columns D .. ld stay as they are (zeroed once at the start). Rows
// whose shared-memory start is 16-byte aligned go through cp.async and land
// at the caller's cp_async_wait_all + __syncthreads; odd-length f32 rows are
// copied through registers.
template <typename E>
__device__ void load_rows(E* dst, int ld, const E* src, long long stride,
                          int row0, int nrows, int limit, int D) {
  constexpr int VEC = 16 / sizeof(E);
  const int per_row = D / VEC;
  const bool async = (ld * sizeof(E)) % 16 == 0;
  for (int i = threadIdx.x; i < nrows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * VEC;
    const int g = row0 + r;
    const E* from = src + (long long)(g < limit ? g : 0) * stride + c;
    E* out = dst + r * ld + c;
    if (async) {
      cp_async16(out, from, g < limit);
    } else {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g < limit) val = *reinterpret_cast<const uint4*>(from);
      const E* parts = reinterpret_cast<const E*>(&val);
#pragma unroll
      for (int u = 0; u < VEC; ++u) out[u] = parts[u];
    }
  }
}

// lse and delta of rows row0 .. row0 + n - 1 of one (batch, head) into
// shared memory; rows at or past T read as 0 (they are masked).
__device__ void load_row_stats(float* Ls, float* Ds, const float* lse,
                               const float* delta, long long base, int row0,
                               int n, int T) {
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const int row = row0 + r;
    Ls[r] = row < T ? lse[base + row] : 0.0f;
    Ds[r] = row < T ? delta[base + row] : 0.0f;
  }
}

// C[M, N] = A[M, Kd] . Bm[N, Kd]^T in f32: rows of A against rows of Bm.
// One of the two row sets is keys, the other query rows (KEYS_ROWS says
// which); a 16 x 16 tile whose first key lies past its last query row's
// diagonal (pos0 + row) is skipped, and the caller masks by position.
template <typename E, int M, int N, bool KEYS_ROWS>
__device__ void product_nt(const E* A, int lda, const E* Bm, int ldb, float* C,
                           int ldc, int kd, int key0, int pos0) {
  for (int i = threadIdx.x; i < M * N; i += THREADS) {
    const int r = i / N, c = i % N;
    const int key = key0 + (KEYS_ROWS ? r : c);
    const int pos = pos0 + (KEYS_ROWS ? c : r);
    if (key > pos) continue;
    const E* ar = A + r * lda;
    const E* br = Bm + c * ldb;
    float acc = 0.0f;
    for (int d = 0; d < kd; ++d) acc = fmaf(ar[d], br[d], acc);
    C[r * ldc + c] = acc;
  }
}

// C[M, n] += A[M, KD] . Bm[KD, n] (f32 accumulation into shared memory).
template <typename E, int M, int KD>
__device__ void accumulate_nn(const E* A, int lda, const E* Bm, int ldb,
                              float* C, int ldc, int n) {
  for (int i = threadIdx.x; i < M * n; i += THREADS) {
    const int r = i / n, c = i % n;
    float acc = C[r * ldc + c];
    const E* ar = A + r * lda;
    for (int j = 0; j < KD; ++j) acc = fmaf(ar[j], Bm[j * ldb + c], acc);
    C[r * ldc + c] = acc;
  }
}

__device__ void zero_shared(unsigned char* smem, unsigned bytes) {
  for (unsigned i = threadIdx.x * 16; i < bytes; i += THREADS * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
}

// dQ, and delta for the dK/dV kernel. A0 = Q, A1 = dO (BQ rows), B0 = K,
// B1 = V (BK rows), E0 = dS.
template <typename E>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ out,
                    const E* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, E* __restrict__ dq,
                    int B, int T, int S, int H, int rep, int D, int dp,
                    Strides st, float scale, Layout L) {
  constexpr int BQ = Tile<E>::DQ_BQ, BK = Tile<E>::DQ_BK;
  extern __shared__ __align__(128) unsigned char smem[];
  E* Qs = reinterpret_cast<E*>(smem);
  E* dOs = reinterpret_cast<E*>(smem + L.off_a1);
  E* Ks = reinterpret_cast<E*>(smem + L.off_b0);
  E* Vs = reinterpret_cast<E*>(smem + L.off_b1);
  float* Ss = reinterpret_cast<float*>(smem + L.off_s);
  float* dPs = reinterpret_cast<float*>(smem + L.off_dp);
  E* dSs = reinterpret_cast<E*>(smem + L.off_e0);
  float* Acc = reinterpret_cast<float*>(smem + L.off_acc0);
  float* Ls = reinterpret_cast<float*>(smem + L.off_lse);
  float* Dls = reinterpret_cast<float*>(smem + L.off_delta);

  // Tile-major from the last q tile down: a tile's kv walk never grows
  // over the launch.
  const int tiles = (T + BQ - 1) / BQ, bh = (int)(blockIdx.x % (unsigned)(B * H));
  const int q0 = (tiles - 1 - (int)(blockIdx.x / (unsigned)(B * H))) * BQ;
  const int h = bh % H, b = bh / H;
  const int offset = S - T;          // end-aligned diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  zero_shared(smem, L.bytes);
  __syncthreads();
  load_rows(Qs, L.lda, q + b * st.q_b + h * st.q_h, st.q_t, q0, BQ, T, D);
  load_rows(dOs, L.lda, dout + b * st.o_b + h * st.o_h, st.o_t, q0, BQ, T, D);
  // delta = rowsum(dO * O) in f32, one warp per row, while the copies run.
  for (int r = warp; r < BQ; r += WARPS) {
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < T) {
      const E* orow = out + b * st.out_b + row * st.out_t + h * st.out_h;
      const E* grow = dout + b * st.o_b + row * st.o_t + h * st.o_h;
      for (int c = lane; c < D; c += 32) acc += to_f32(grow[c]) * to_f32(orow[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      Dls[r] = acc;
      if (row < T) delta[(long long)bh * T + row] = acc;
    }
    if (lane == 1) Ls[r] = row < T ? lse[(long long)bh * T + row] : 0.0f;
  }
  const E* kh = k + b * st.k_b + (h / rep) * st.k_h;
  const E* vh = v + b * st.v_b + (h / rep) * st.v_h;
  // Keys past the tile's last real row's window are never needed.
  const int kv_end = min(S, offset + min(q0 + BQ, T));
  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    load_rows(Ks, L.ldb, kh, st.k_s, j0, BK, S, D);
    load_rows(Vs, L.ldb, vh, st.v_s, j0, BK, S, D);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    product_nt<E, BQ, BK, false>(Qs, L.lda, Ks, L.ldb, Ss, L.lds, dp, j0,
                                 offset + q0);
    product_nt<E, BQ, BK, false>(dOs, L.lda, Vs, L.ldb, dPs, L.lds, dp, j0,
                                 offset + q0);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int row = q0 + r, key = j0 + c;
      float ds = 0.0f;
      if (row < T && key < S && key <= offset + row) {
        const float p = expf(Ss[r * L.lds + c] * scale - Ls[r]);
        ds = p * (dPs[r * L.lds + c] - Dls[r]) * scale;
      }
      dSs[r * L.ldp + c] = from_f32<E>(ds);
    }
    __syncthreads();
    accumulate_nn<E, BQ, BK>(dSs, L.ldp, Ks, L.ldb, Acc, L.ldo, dp);
    __syncthreads();                  // K and V are free for the next tile
  }

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, row = q0 + r;
    if (row < T)
      dq[(((long long)b * T + row) * H + h) * D + c] = from_f32<E>(Acc[r * L.ldo + c]);
  }
}

// dK and dV. A0 = K, A1 = V (BK rows), B0 = Q, B1 = dO (BQ rows); the
// score-shaped tiles are transposed ([BK, BQ]): E0 = dS^T, E1 = P^T;
// Acc0 = dK, Acc1 = dV.
template <typename E>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, const E* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, E* __restrict__ dk,
                     E* __restrict__ dv, int B, int T, int S, int H, int Hkv,
                     int D, int dp, Strides st, float scale, Layout L) {
  constexpr int BK = Tile<E>::KV_BK, BQ = Tile<E>::KV_BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  E* Ks = reinterpret_cast<E*>(smem);
  E* Vs = reinterpret_cast<E*>(smem + L.off_a1);
  E* Qs = reinterpret_cast<E*>(smem + L.off_b0);
  E* dOs = reinterpret_cast<E*>(smem + L.off_b1);
  float* St = reinterpret_cast<float*>(smem + L.off_s);
  float* dPt = reinterpret_cast<float*>(smem + L.off_dp);
  E* dSt = reinterpret_cast<E*>(smem + L.off_e0);
  E* Pt = reinterpret_cast<E*>(smem + L.off_e1);
  float* dKa = reinterpret_cast<float*>(smem + L.off_acc0);
  float* dVa = reinterpret_cast<float*>(smem + L.off_acc1);
  float* Ls = reinterpret_cast<float*>(smem + L.off_lse);
  float* Dls = reinterpret_cast<float*>(smem + L.off_delta);

  // Tile-major from kv tile 0 up: the longest walks start first.
  const int bh = (int)(blockIdx.x % (unsigned)(B * Hkv));
  const int j0 = (int)(blockIdx.x / (unsigned)(B * Hkv)) * BK;
  const int hk = bh % Hkv, b = bh / Hkv, rep = H / Hkv;
  const int offset = S - T;
  const int q_tiles = (T + BQ - 1) / BQ;
  // The first q tile whose last row's window reaches key j0.
  const int i_first = max(0, j0 - offset) / BQ;

  zero_shared(smem, L.bytes);
  __syncthreads();
  load_rows(Ks, L.lda, k + b * st.k_b + hk * st.k_h, st.k_s, j0, BK, S, D);
  load_rows(Vs, L.lda, v + b * st.v_b + hk * st.v_h, st.v_s, j0, BK, S, D);
  cp_async_commit();
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const E* qh = q + b * st.q_b + h * st.q_h;
    const E* oh = dout + b * st.o_b + h * st.o_h;
    for (int it = i_first; it < q_tiles; ++it) {
      const int i0 = it * BQ;
      load_row_stats(Ls, Dls, lse, delta, ((long long)b * H + h) * T, i0, BQ, T);
      load_rows(Qs, L.ldb, qh, st.q_t, i0, BQ, T, D);
      load_rows(dOs, L.ldb, oh, st.o_t, i0, BQ, T, D);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      product_nt<E, BK, BQ, true>(Ks, L.lda, Qs, L.ldb, St, L.lds, dp, j0,
                                  offset + i0);
      product_nt<E, BK, BQ, true>(Vs, L.lda, dOs, L.ldb, dPt, L.lds, dp, j0,
                                  offset + i0);
      __syncthreads();
      for (int i = threadIdx.x; i < BK * BQ; i += THREADS) {
        const int c = i / BQ, r = i % BQ;   // c: key in the tile, r: q row
        const int row = i0 + r, key = j0 + c;
        float p = 0.0f, ds = 0.0f;
        if (row < T && key < S && key <= offset + row) {
          p = expf(St[c * L.lds + r] * scale - Ls[r]);
          ds = p * (dPt[c * L.lds + r] - Dls[r]) * scale;
        }
        Pt[c * L.ldp + r] = from_f32<E>(p);
        dSt[c * L.ldp + r] = from_f32<E>(ds);
      }
      __syncthreads();
      accumulate_nn<E, BK, BQ>(Pt, L.ldp, dOs, L.ldb, dVa, L.ldo, dp);
      accumulate_nn<E, BK, BQ>(dSt, L.ldp, Qs, L.ldb, dKa, L.ldo, dp);
      __syncthreads();                // Q, dO and the stats are free again
    }
  }

  for (int i = threadIdx.x; i < BK * D; i += THREADS) {
    const int c = i / D, d = i % D, key = j0 + c;
    if (key < S) {
      const long long at = (((long long)b * S + key) * Hkv + hk) * D + d;
      dk[at] = from_f32<E>(dKa[c * L.ldo + d]);
      dv[at] = from_f32<E>(dVa[c * L.ldo + d]);
    }
  }
}

template <typename E>
Layout dq_layout(int dp) {
  using C = Tile<E>;
  return make_layout<E>(dp, C::DQ_BQ, C::DQ_BK, C::PAD_IN, C::PAD_WALK, 1, 1,
                        C::DQ_BQ);
}

template <typename E>
Layout dkv_layout(int dp) {
  using C = Tile<E>;
  return make_layout<E>(dp, C::KV_BK, C::KV_BQ, C::PAD_IN, C::PAD_WALK, 2, 2,
                        C::KV_BQ);
}

template <typename E>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, float* delta, void* dq,
              int B, int T,
              int S, int H, int Hkv, int D, const Strides& st, float scale,
              cudaStream_t stream) {
  const int dp = (D + 15) / 16 * 16;
  const Layout L = dq_layout<E>(dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int BQ = Tile<E>::DQ_BQ;
  const unsigned blocks = (unsigned)((T + BQ - 1) / BQ) * H * B;
  flash_bwd_dq_kernel<E><<<blocks, THREADS, L.bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(out),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dq), B, T, S,
      H, H / Hkv, D, dp, st, scale, L);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B,
               int T, int S, int H, int Hkv, int D, const Strides& st,
               float scale, cudaStream_t stream) {
  const int dp = (D + 15) / 16 * 16;
  const Layout L = dkv_layout<E>(dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int BK = Tile<E>::KV_BK;
  const unsigned blocks = (unsigned)((S + BK - 1) / BK) * Hkv * B;
  flash_bwd_dkv_kernel<E><<<blocks, THREADS, L.bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout), lse, delta,
      static_cast<E*>(dk), static_cast<E*>(dv), B, T, S, H, Hkv, D, dp, st,
      scale, L);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma with register accumulators, tiles through TMA rings
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG_THREADS = 384;            // warpgroups 0, 1 consume; 2 produces
constexpr int ROW_BYTES = hopper::SWIZZLE_ROW_BYTES;
constexpr int BQ = 64;                     // q rows of a warpgroup's tile
constexpr int BKV = 32;                    // keys of a kv tile
constexpr int Q_PANEL = BQ * ROW_BYTES;    // 64 rows x 64 columns
constexpr int KV_PANEL = BKV * ROW_BYTES;  // 32 rows x 64 columns

template <int DP>
struct BwdTiles {
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_TILE = PANELS * Q_PANEL;     // 64 rows x DP
  static constexpr int KV_TILE = PANELS * KV_PANEL;   // 32 rows x DP
};

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* out;
  const bf16* dout;
  const float* lse;
  float* delta;
  bf16* dk;
  bf16* dv;
  int B, T, S, H, rep, D;
  Strides st;
  float scale, scale_log2;
  int tma;        // bit 0: q by TMA, bit 1: k, bit 2: v, bit 3: dO
  int folded;     // dQ kernel: pair q tile i with n - 1 - i (one wave)
};

// Rows row0 .. row0 + R - 1 of one (head, batch) into a swizzled tile of R
// rows: by TMA from `map` (one arrival with its bytes, by lane 0), or, for a
// layout no map takes, by the whole warp with cp.async (32 arrivals).
template <int R, int DP>
__device__ __forceinline__ void load_tile(uint8_t* dst, bool tma, const CUtensorMap* map,
                                          uint64_t* bar, const bf16* src,
                                          long long row_stride, int row0, int rows,
                                          int cols, int h, int b) {
  if (tma) {
    if ((threadIdx.x & 31) == 0) {
      hopper::mbar_arrive_expect_tx(bar, (DP / 64) * R * ROW_BYTES);
      for (int p = 0; p < DP / 64; ++p)
        hopper::tma_load_4d(dst + p * R * ROW_BYTES, map, bar, p * 64, row0, h, b);
    }
  } else {
    hopper::warp_load_tile<R, DP>(dst, src, row_stride, row0, rows, cols, bar);
  }
}

// S = A . B^T over the head dimension for a 64-row tile A and a 32-row
// tile B, both K-major (Q.K^T or dO.V^T), issued, not committed.
template <int DP>
__device__ __forceinline__ void issue_scores(float (&sc)[16], const uint8_t* A,
                                             const uint8_t* Bt) {
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    hopper::wgmma_ss_m64n32k16<0>(
        sc, hopper::sw128_desc(A + (kd / 4) * Q_PANEL + (kd % 4) * 32, 16, 1024),
        hopper::sw128_desc(Bt + (kd / 4) * KV_PANEL + (kd % 4) * 32, 16, 1024), kd > 0);
  }
}

// This thread's rows' lse (log2 domain) and last visible key (-1 for rows
// past T) from the [B, H, T] rows of one (batch, head).
struct RowStats {
  float lse_a, lse_b;
  int last_a, last_b;
};

__device__ __forceinline__ RowStats row_stats(const BwdArgs& a, long long bh_row, int ra,
                                              int rb) {
  RowStats r;
  r.lse_a = ra < a.T ? a.lse[bh_row + ra] * LOG2E : 0.0f;
  r.lse_b = rb < a.T ? a.lse[bh_row + rb] * LOG2E : 0.0f;
  r.last_a = ra < a.T ? min(a.S - a.T + ra, a.S - 1) : -1;
  r.last_b = rb < a.T ? min(a.S - a.T + rb, a.S - 1) : -1;
  return r;
}

// P of one 64 x 32 score tile in place of S: sc[4c + e] is q row ra, key
// j0 + 8c + 2t + e (sc[4c + 2 + e] row rb); P = exp2(s * scale_log2 -
// lse_log2), exactly 0 past the row's last visible key where the tile is an
// edge tile (it crosses the diagonal or a tail).
__device__ __forceinline__ void p_tile(float (&sc)[16], const BwdArgs& a, const RowStats& r,
                                       int j0, bool edge, int t) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = j0 + 8 * c + 2 * t + e;
      float pa = hopper::ex2(fmaf(sc[4 * c + e], a.scale_log2, -r.lse_a));
      float pb = hopper::ex2(fmaf(sc[4 * c + 2 + e], a.scale_log2, -r.lse_b));
      if (edge) {
        if (col > r.last_a) pa = 0.0f;
        if (col > r.last_b) pb = 0.0f;
      }
      sc[4 * c + e] = pa;
      sc[4 * c + 2 + e] = pb;
    }
  }
}

// dS = P * (dP - delta) * scale in place of dP (same fragment layout).
__device__ __forceinline__ void ds_tile(const float (&p)[16], float (&dp)[16], float scale,
                                        float del_a, float del_b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dp[4 * c + e] = p[4 * c + e] * (dp[4 * c + e] - del_a) * scale;
      dp[4 * c + 2 + e] = p[4 * c + 2 + e] * (dp[4 * c + 2 + e] - del_b) * scale;
    }
  }
}

// ---- dQ kernel

template <int DP>
struct DqConfig {
  using Tl = BwdTiles<DP>;
  static constexpr int NS = DP == 256 ? 3 : 4;                   // K/V stages
  static constexpr int OFF_DO = 2 * Tl::Q_TILE;                  // after Q
  static constexpr int OFF_K = 4 * Tl::Q_TILE;
  static constexpr int OFF_V = OFF_K + NS * Tl::KV_TILE;
  static constexpr int OFF_BAR = OFF_V + NS * Tl::KV_TILE;
  // barriers: full Q, full dO, then full K, full V, empty K, empty V per stage
  static constexpr int BYTES = OFF_BAR + 8 * (2 + 4 * NS) + 1024;   // + alignment
};

// First q row of each warpgroup's 64 rows for block `item` (T: no rows), as
// the forward hands them out: adjacent 64-row tiles, the last pair first;
// folded (tile p with n - 1 - p) when the launch fits in one wave.
__device__ __forceinline__ void dq_rows(const BwdArgs& a, int item, int (&row0)[2]) {
  const int n64 = (a.T + BQ - 1) / BQ, pairs = (n64 + 1) / 2;
  int t0, t1;
  if (a.folded) {
    t0 = item;
    t1 = n64 - 1 - item;
    if (t1 == t0) t1 = n64;
  } else {
    t0 = 2 * (pairs - 1 - item);
    t1 = t0 + 1;
  }
  row0[0] = min(BQ * t0, a.T);
  row0[1] = min(BQ * t1, a.T);
}

// kv tiles that q rows row0 .. row0 + 63 need (0 when row0 >= T).
__device__ __forceinline__ int dq_kv_tiles(const BwdArgs& a, int row0) {
  if (row0 >= a.T) return 0;
  return (min(a.S, a.S - a.T + min(row0 + BQ, a.T)) + BKV - 1) / BKV;
}

// delta = rowsum(dO * O) in f32 of rows row0 .. row0 + 15 (one row at a time
// over the warp, 8 columns a lane, from O and dO in place), written out for
// rows < T; returns rows g and g + 8 of the warp's fragment in d_a, d_b.
__device__ void warp_delta(const BwdArgs& a, int b, int h, int row0, int g, float& d_a,
                           float& d_b) {
  const int lane = threadIdx.x & 31;
  d_a = d_b = 0.0f;
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    float acc = 0.0f;
    if (row < a.T && lane * 8 < a.D) {
      const uint4 o = *reinterpret_cast<const uint4*>(
          a.out + b * a.st.out_b + row * a.st.out_t + h * a.st.out_h + lane * 8);
      const uint4 d = *reinterpret_cast<const uint4*>(
          a.dout + b * a.st.o_b + row * a.st.o_t + h * a.st.o_h + lane * 8);
      const bf16* op = reinterpret_cast<const bf16*>(&o);
      const bf16* dp = reinterpret_cast<const bf16*>(&d);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        acc = fmaf(__bfloat162float(dp[u]), __bfloat162float(op[u]), acc);
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    if (r == g) d_a = acc;
    if (r == g + 8) d_b = acc;
    if (lane == 0 && row < a.T) a.delta[((long long)b * a.H + h) * a.T + row] = acc;
  }
}

// dS in bf16 as wgmma's A fragment: step kk covers keys 16kk .. 16kk + 15.
__device__ __forceinline__ void pack_ds(const float (&x)[16], uint32_t (&f)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    f[kk][0] = hopper::pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    f[kk][1] = hopper::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    f[kk][2] = hopper::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    f[kk][3] = hopper::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// dQ += dS . K (16 keys a step, K the transposed B operand), issued and
// committed, not waited for.
template <int DP>
__device__ __forceinline__ void issue_dq(float (&acc)[DP / 2], const uint32_t (&f)[2][4],
                                         const uint8_t* Kt) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    hopper::wgmma_rs_m64nDk16<DP>(
        acc, f[kk], hopper::sw128_desc(Kt + kk * 16 * ROW_BYTES, KV_PANEL, 1024), 1);
  hopper::wgmma_commit();
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_dq, const BwdArgs a) {
  using C = DqConfig<DP>;
  using Tl = BwdTiles<DP>;
  using Ring = hopper::Ring<C::NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;                 // [warpgroup][panel][64 rows]
  uint8_t* dOs = smem + C::OFF_DO;
  uint8_t* Ks = smem + C::OFF_K;      // [stage][panel][32 rows]
  uint8_t* Vs = smem + C::OFF_V;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_q = bars;
  uint64_t* full_do = bars + 1;
  uint64_t* full_k = bars + 2;
  uint64_t* full_v = full_k + C::NS;
  uint64_t* empty_k = full_v + C::NS;
  uint64_t* empty_v = empty_k + C::NS;

  const bool q_tma = a.tma & 1, k_tma = a.tma & 2, v_tma = a.tma & 4, do_tma = a.tma & 8;
  const int bh = (int)(blockIdx.x % (unsigned)(a.B * a.H));
  const int h = bh % a.H, b = bh / a.H, hk = h / a.rep;
  int row0s[2];
  dq_rows(a, (int)(blockIdx.x / (unsigned)(a.B * a.H)), row0s);
  const int n_tiles = max(dq_kv_tiles(a, row0s[0]), dq_kv_tiles(a, row0s[1]));

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, q_tma ? 2 : 64);
    hopper::mbar_init(full_do, do_tma ? 2 : 64);
    for (int s = 0; s < C::NS; ++s) {
      hopper::mbar_init(full_k + s, k_tma ? 1 : 32);
      hopper::mbar_init(full_v + s, v_tma ? 1 : 32);
      hopper::mbar_init(empty_k + s, 2);
      hopper::mbar_init(empty_v + s, 2);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one warp loads, the other three only give registers
    hopper::regs_shrink<24>();
    if (threadIdx.x / 32 != 8) return;
    const bf16* q_src = a.q + b * a.st.q_b + h * a.st.q_h;
    const bf16* do_src = a.dout + b * a.st.o_b + h * a.st.o_h;
    for (int w = 0; w < 2; ++w) {
      load_tile<BQ, DP>(Qs + w * Tl::Q_TILE, q_tma, &map_q, full_q, q_src, a.st.q_t,
                        row0s[w], a.T, a.D, h, b);
      load_tile<BQ, DP>(dOs + w * Tl::Q_TILE, do_tma, &map_do, full_do, do_src, a.st.o_t,
                        row0s[w], a.T, a.D, h, b);
    }
    const bf16* k_src = a.k + b * a.st.k_b + hk * a.st.k_h;
    const bf16* v_src = a.v + b * a.st.v_b + hk * a.st.v_h;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = Ring::stage(j);
      if (j >= C::NS) hopper::mbar_wait(empty_k + s, Ring::empty_parity(j));
      load_tile<BKV, DP>(Ks + s * Tl::KV_TILE, k_tma, &map_k, full_k + s, k_src, a.st.k_s,
                         j * BKV, a.S, a.D, hk, b);
      if (j >= C::NS) hopper::mbar_wait(empty_v + s, Ring::empty_parity(j));
      load_tile<BKV, DP>(Vs + s * Tl::KV_TILE, v_tma, &map_v, full_v + s, v_src, a.st.v_s,
                         j * BKV, a.S, a.D, hk, b);
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows row0 .. row0 + 63
    hopper::regs_grow<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = wg == 0 ? row0s[0] : row0s[1], offset = a.S - a.T;
    const int ra = row0 + 16 * warp + g, rb = ra + 8;   // this thread's rows
    const int wg_tiles = dq_kv_tiles(a, row0);

    if (wg_tiles > 0) {
      const long long bh_row = ((long long)b * a.H + h) * a.T;
      const RowStats rs = row_stats(a, bh_row, ra, rb);
      float del_a, del_b;
      warp_delta(a, b, h, row0 + 16 * warp, g, del_a, del_b);
      const uint8_t* Qw = Qs + wg * Tl::Q_TILE;
      const uint8_t* dOw = dOs + wg * Tl::Q_TILE;
      // A tile needs masking where it crosses the warpgroup's first row's
      // diagonal, the end of S or the end of T.
      auto edge = [&](int j0) {
        return j0 + BKV - 1 > offset + row0 || j0 + BKV > a.S || row0 + BQ > a.T;
      };

      float acc[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
      float sc[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.0f;
      uint32_t df[2][4];

      // Tile 0: S and dP, then P and dS (dQ is still zero).
      hopper::mbar_wait(full_q, 0);
      hopper::mbar_wait(full_do, 0);
      hopper::mbar_wait(full_k, 0);
      hopper::mbar_wait(full_v, 0);
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      issue_scores<DP>(sc, Qw, Ks);
      issue_scores<DP>(dp, dOw, Vs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      if (tid == 0) hopper::mbar_arrive(empty_v);
      p_tile(sc, a, rs, 0, edge(0), t);
      ds_tile(sc, dp, a.scale, del_a, del_b);
      pack_ds(dp, df);

      // Tile j: S(j), dP(j) and dS(j - 1).K(j - 1) go to the tensor cores
      // together; P and dS of tile j are computed while dQ's product runs.
      for (int j = 1; j < wg_tiles; ++j) {
        const int s = Ring::stage(j), sp = Ring::stage(j - 1);
        hopper::mbar_wait(full_k + s, Ring::full_parity(j));
        hopper::mbar_wait(full_v + s, Ring::full_parity(j));
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        issue_scores<DP>(sc, Qw, Ks + s * Tl::KV_TILE);
        issue_scores<DP>(dp, dOw, Vs + s * Tl::KV_TILE);
        hopper::wgmma_commit();
        issue_dq<DP>(acc, df, Ks + sp * Tl::KV_TILE);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        if (tid == 0) hopper::mbar_arrive(empty_v + s);
        p_tile(sc, a, rs, j * BKV, edge(j * BKV), t);
        ds_tile(sc, dp, a.scale, del_a, del_b);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::fence_regs(df[0]);
        hopper::fence_regs(df[1]);
        if (tid == 0) hopper::mbar_arrive(empty_k + sp);
        pack_ds(dp, df);
      }
      // The last tile's dS.K.
      const int sl = Ring::stage(wg_tiles - 1);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      issue_dq<DP>(acc, df, Ks + sl * Tl::KV_TILE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (tid == 0) hopper::mbar_arrive(empty_k + sl);

      // Epilogue: dQ in bf16 through this warpgroup's Q tile (its last
      // reader is done) to TMA stores; rows past T and columns past D are
      // not written. stmatrix.x4 per pair of 8-column chunks: matrices
      // (rows 0-7, c), (rows 8-15, c), (rows 0-7, c + 1), (rows 8-15, c + 1)
      // of the warp's 16 rows; lane l addresses row l % 8 of matrix l / 8.
      uint8_t* Qo = Qs + wg * Tl::Q_TILE;
      const int mrow = 16 * warp + 8 * ((lane / 8) & 1) + lane % 8, mchunk = lane / 16;
#pragma unroll
      for (int c = 0; c < DP / 8; c += 2) {
        const int chunk = c + mchunk;
        hopper::stmatrix_x4(
            hopper::smem_u32(Qo + (chunk / 8) * Q_PANEL) + hopper::sw128_offset(mrow, chunk % 8),
            hopper::pack_bf16(acc[4 * c], acc[4 * c + 1]),
            hopper::pack_bf16(acc[4 * c + 2], acc[4 * c + 3]),
            hopper::pack_bf16(acc[4 * c + 4], acc[4 * c + 5]),
            hopper::pack_bf16(acc[4 * c + 6], acc[4 * c + 7]));
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
      if (tid == 0) {
        for (int p = 0; p < Tl::PANELS; ++p)
          hopper::tma_store_4d(&map_dq, Qo + p * Q_PANEL, p * 64, row0, h, b);
        hopper::tma_store_drain();
      }
    }
    // Release the tiles this warpgroup does not need, each after it has
    // landed (so that the arrival counts toward its own use of the stage).
    if (tid == 0) {
      for (int j = wg_tiles; j < n_tiles; ++j) {
        const int s = Ring::stage(j);
        hopper::mbar_wait(full_k + s, Ring::full_parity(j));
        hopper::mbar_arrive(empty_k + s);
        hopper::mbar_wait(full_v + s, Ring::full_parity(j));
        hopper::mbar_arrive(empty_v + s);
      }
    }
  }
}

// ---- dK/dV kernel

template <int DP>
struct DkvConfig {
  using Tl = BwdTiles<DP>;
  static constexpr int NS = DP == 256 ? 2 : DP == 192 ? 3 : 4;   // Q/dO stages
  static constexpr int OFF_V = Tl::KV_TILE;                      // K at 0
  static constexpr int OFF_RING = 2 * Tl::KV_TILE;
  static constexpr int STAGE = 2 * Tl::Q_TILE;                   // Q, then dO
  static constexpr int OFF_PT = OFF_RING + NS * STAGE;           // [warpgroup][P^T, dS^T]
  static constexpr int OFF_BAR = OFF_PT + 4 * KV_PANEL;
  // barriers: full K, full V, then full Q, full dO, empty per stage
  static constexpr int BYTES = OFF_BAR + 8 * (2 + 3 * NS) + 1024;   // + alignment
  // After the walk the ring holds warpgroup 1's accumulators (DP / 2 f32 a
  // thread), then dK and dV in bf16, [32 keys][DP] each.
  static constexpr int RED_BYTES = 128 * (DP / 2) * 4;
  static_assert(RED_BYTES + 2 * BKV * DP * 2 <= NS * STAGE, "ring too small");
};

// A 64 x 32 fragment (q rows x keys) in bf16, transposed into a swizzled
// 32-row tile of 64 q columns (P^T or dS^T: the K-major B operand of
// dV^T = dO^T . P and dK^T = Q^T . dS).
__device__ __forceinline__ void store_transposed(uint8_t* tile, const float (&x)[16],
                                                 int warp, int g, int t) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = 8 * c + 2 * t + e;
      *reinterpret_cast<bf16*>(tile + hopper::sw128_offset(key, 2 * warp) + 2 * g) =
          __float2bfloat16(x[4 * c + e]);
      *reinterpret_cast<bf16*>(tile + hopper::sw128_offset(key, 2 * warp + 1) + 2 * g) =
          __float2bfloat16(x[4 * c + 2 + e]);
    }
  }
}

// acc[mb] (+)= A^T . B: A a 64-row tile [q rows][DP] whose 64-column panel mb
// is the MN-major A operand (64 rows of the head dimension), B a 32-key
// transposed tile (P^T or dS^T); 16 q rows a step. Issued, not committed.
template <int DP>
__device__ __forceinline__ void issue_transposed(float (&acc)[DP / 64][16], const uint8_t* A,
                                                 const uint8_t* Bt) {
#pragma unroll
  for (int mb = 0; mb < DP / 64; ++mb) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::wgmma_ss_m64n32k16<1>(
          acc[mb], hopper::sw128_desc(A + mb * Q_PANEL + kk * 16 * ROW_BYTES, Q_PANEL, 1024),
          hopper::sw128_desc(Bt + kk * 32, 16, 1024), 1);
  }
}

template <int DP>
__device__ __forceinline__ void fence_acc(float (&acc)[DP / 64][16]) {
#pragma unroll
  for (int mb = 0; mb < DP / 64; ++mb) hopper::fence_regs(acc[mb]);
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, const BwdArgs a) {
  using C = DkvConfig<DP>;
  using Tl = BwdTiles<DP>;
  using Ring = hopper::Ring<C::NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = smem;                 // [panel][32 rows]
  uint8_t* Vs = smem + C::OFF_V;
  uint8_t* ring = smem + C::OFF_RING;   // [stage][Q, dO][panel][64 rows]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_k = bars;
  uint64_t* full_v = bars + 1;
  uint64_t* full_q = bars + 2;
  uint64_t* full_do = full_q + C::NS;
  uint64_t* empty = full_do + C::NS;

  const bool q_tma = a.tma & 1, k_tma = a.tma & 2, v_tma = a.tma & 4, do_tma = a.tma & 8;
  // Tile-major from kv tile 0 up: the longest walks start first.
  const int Hkv = a.H / a.rep;
  const int bh = (int)(blockIdx.x % (unsigned)(a.B * Hkv));
  const int j0 = (int)(blockIdx.x / (unsigned)(a.B * Hkv)) * BKV;
  const int hk = bh % Hkv, b = bh / Hkv, offset = a.S - a.T;
  // Items: (query head of the group, q tile) for every q tile whose last
  // row's window reaches key j0, head-major.
  const int q_tiles = (a.T + BQ - 1) / BQ;
  const int i_first = max(0, j0 - offset) / BQ, nq = q_tiles - i_first;
  const int items = a.rep * nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_k, k_tma ? 1 : 32);
    hopper::mbar_init(full_v, v_tma ? 1 : 32);
    for (int s = 0; s < C::NS; ++s) {
      hopper::mbar_init(full_q + s, q_tma ? 1 : 32);
      hopper::mbar_init(full_do + s, do_tma ? 1 : 32);
      hopper::mbar_init(empty + s, 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: K and V once, then Q and dO of every item
    hopper::regs_shrink<24>();
    if (threadIdx.x / 32 != 8) return;
    load_tile<BKV, DP>(Ks, k_tma, &map_k, full_k, a.k + b * a.st.k_b + hk * a.st.k_h,
                       a.st.k_s, j0, a.S, a.D, hk, b);
    load_tile<BKV, DP>(Vs, v_tma, &map_v, full_v, a.v + b * a.st.v_b + hk * a.st.v_h,
                       a.st.v_s, j0, a.S, a.D, hk, b);
    for (int it = 0; it < items; ++it) {
      const int s = Ring::stage(it);
      const int h = hk * a.rep + it / nq, q0 = (i_first + it % nq) * BQ;
      if (it >= C::NS) hopper::mbar_wait(empty + s, Ring::empty_parity(it));
      uint8_t* Qt = ring + s * C::STAGE;
      load_tile<BQ, DP>(Qt, q_tma, &map_q, full_q + s, a.q + b * a.st.q_b + h * a.st.q_h,
                        a.st.q_t, q0, a.T, a.D, h, b);
      load_tile<BQ, DP>(Qt + Tl::Q_TILE, do_tma, &map_do, full_do + s,
                        a.dout + b * a.st.o_b + h * a.st.o_h, a.st.o_t, q0, a.T, a.D, h, b);
    }
  } else {
    // ---- consumers: warpgroup wg takes items wg, wg + 2, ... and keeps
    // dV^T and dK^T of the whole head dimension (64-row blocks of it in M,
    // the 32 keys in N) in registers.
    hopper::regs_grow<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    uint8_t* Pt = smem + C::OFF_PT + wg * 2 * KV_PANEL;
    uint8_t* dSt = Pt + KV_PANEL;

    float acc_v[DP / 64][16], acc_k[DP / 64][16];
#pragma unroll
    for (int mb = 0; mb < DP / 64; ++mb)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc_v[mb][i] = acc_k[mb][i] = 0.0f;
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.0f;

    hopper::mbar_wait(full_k, 0);
    hopper::mbar_wait(full_v, 0);
    for (int it = wg; it < items; it += 2) {
      const int s = Ring::stage(it);
      const int h = hk * a.rep + it / nq, q0 = (i_first + it % nq) * BQ;
      const int ra = q0 + 16 * warp + g, rb = ra + 8;
      const long long bh_row = ((long long)b * a.H + h) * a.T;
      const float del_a = ra < a.T ? a.delta[bh_row + ra] : 0.0f;
      const float del_b = rb < a.T ? a.delta[bh_row + rb] : 0.0f;
      const RowStats rs = row_stats(a, bh_row, ra, rb);   // loads issued before the waits
      const bool edge = j0 + BKV - 1 > offset + q0 || j0 + BKV > a.S || q0 + BQ > a.T;
      const uint8_t* Qt = ring + s * C::STAGE;
      const uint8_t* dOt = Qt + Tl::Q_TILE;

      // S = Q.K^T and dP = dO.V^T (64 q rows x 32 keys), then P and dS.
      hopper::mbar_wait(full_q + s, Ring::full_parity(it));
      hopper::mbar_wait(full_do + s, Ring::full_parity(it));
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      issue_scores<DP>(sc, Qt, Ks);
      issue_scores<DP>(dp, dOt, Vs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      p_tile(sc, a, rs, j0, edge, t);
      ds_tile(sc, dp, a.scale, del_a, del_b);
      store_transposed(Pt, sc, warp, g, t);
      store_transposed(dSt, dp, warp, g, t);
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);

      // dV^T += dO^T . P and dK^T += Q^T . dS.
      fence_acc<DP>(acc_v);
      fence_acc<DP>(acc_k);
      hopper::wgmma_fence();
      issue_transposed<DP>(acc_v, dOt, Pt);
      issue_transposed<DP>(acc_k, Qt, dSt);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_acc<DP>(acc_v);
      fence_acc<DP>(acc_k);
      if (tid == 0) hopper::mbar_arrive(empty + s);
    }

    // Sum the two warpgroups' halves of the walk (warpgroup 0's + warpgroup
    // 1's, in one order), round once and store dK and dV rows < S.
    hopper::named_sync(3, 256);       // both are done with the ring
    float* red = reinterpret_cast<float*>(ring);
    if (wg == 1) {
#pragma unroll
      for (int mb = 0; mb < DP / 64; ++mb)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          red[((2 * mb) * 16 + i) * 128 + tid] = acc_v[mb][i];
          red[((2 * mb + 1) * 16 + i) * 128 + tid] = acc_k[mb][i];
        }
    }
    hopper::named_sync(3, 256);
    if (wg == 0) {
      bf16* out_k = reinterpret_cast<bf16*>(ring + C::RED_BYTES);   // [32 keys][DP]
      bf16* out_v = out_k + BKV * DP;
#pragma unroll
      for (int mb = 0; mb < DP / 64; ++mb) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 8 * c + 2 * t + e, d = mb * 64 + 16 * warp + g;
            const int i = 4 * c + e;
            out_v[key * DP + d] =
                __float2bfloat16(acc_v[mb][i] + red[((2 * mb) * 16 + i) * 128 + tid]);
            out_v[key * DP + d + 8] =
                __float2bfloat16(acc_v[mb][i + 2] + red[((2 * mb) * 16 + i + 2) * 128 + tid]);
            out_k[key * DP + d] =
                __float2bfloat16(acc_k[mb][i] + red[((2 * mb + 1) * 16 + i) * 128 + tid]);
            out_k[key * DP + d + 8] = __float2bfloat16(
                acc_k[mb][i + 2] + red[((2 * mb + 1) * 16 + i + 2) * 128 + tid]);
          }
        }
      }
      hopper::named_sync(1, 128);
      const int chunks = a.D / 8;
      for (int i = tid; i < BKV * chunks; i += 128) {
        const int key = i / chunks, c = i % chunks;
        if (j0 + key >= a.S) break;
        const long long at = (((long long)b * a.S + j0 + key) * Hkv + hk) * a.D + c * 8;
        *reinterpret_cast<uint4*>(a.dk + at) =
            *reinterpret_cast<const uint4*>(out_k + key * DP + c * 8);
        *reinterpret_cast<uint4*>(a.dv + at) =
            *reinterpret_cast<const uint4*>(out_v + key * DP + c * 8);
      }
    }
  }
}

// ---- bf16 launches

// Per device: the shared-memory opt-in of each kernel instance is set once.
constexpr int MAX_DEVICES = 64;

template <int DP>
int launch_dq_wgmma(const BwdArgs& args, const CUtensorMap* maps, unsigned blocks, int dev,
                    cudaStream_t stream) {
  using C = DqConfig<DP>;
  static bool opted_in[MAX_DEVICES] = {};
  if (!opted_in[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  flash_bwd_dq_wgmma<DP><<<blocks, WG_THREADS, C::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], args);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv_wgmma(const BwdArgs& args, const CUtensorMap* maps, unsigned blocks, int dev,
                     cudaStream_t stream) {
  using C = DkvConfig<DP>;
  static bool opted_in[MAX_DEVICES] = {};
  if (!opted_in[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  flash_bwd_dkv_wgmma<DP><<<blocks, WG_THREADS, C::BYTES, stream>>>(maps[0], maps[1], maps[2],
                                                                    maps[3], args);
  return (int)cudaGetLastError();
}

// The arguments and tensor maps of either bf16 kernel: q and dO in boxes of
// 64 rows, k and v in boxes of 32, each by TMA where a map takes its
// strides (bits of args.tma). Returns the CUDA error of the device query.
int prepare_bf16(BwdArgs& args, CUtensorMap* maps, int& dev, int& sms) {
  const Strides& st = args.st;
  const void* bases[4] = {args.q, args.k, args.v, args.dout};
  const long long rows[4] = {args.T, args.S, args.S, args.T};
  const long long heads[4] = {args.H, args.H / args.rep, args.H / args.rep, args.H};
  const long long s_row[4] = {st.q_t, st.k_s, st.v_s, st.o_t};
  const long long s_head[4] = {st.q_h, st.k_h, st.v_h, st.o_h};
  const long long s_batch[4] = {st.q_b, st.k_b, st.v_b, st.o_b};
  const int box[4] = {BQ, BKV, BKV, BQ};
  args.tma = 0;
  for (int i = 0; i < 4; ++i)
    if (hopper::encode_rows_map(maps + i, bases[i], args.D, rows[i], heads[i], args.B,
                                s_row[i], s_head[i], s_batch[i], box[i]))
      args.tma |= 1 << i;
  static int sm_count[MAX_DEVICES] = {};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= MAX_DEVICES) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && sm_count[dev] == 0)
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
  sms = err == cudaSuccess ? sm_count[dev] : 0;
  return (int)err;
}

BwdArgs bf16_args(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const float* lse, float* delta, void* dk, void* dv,
                  int B, int T, int S, int H, int Hkv, int D, const Strides& st,
                  float scale) {
  return BwdArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(out),
                 static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
                 static_cast<bf16*>(dv), B, T, S, H, H / Hkv, D, st, scale,
                 scale * LOG2E, 0, 0};
}

int launch_dq_bf16(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, int B,
                   int T, int S, int H, int Hkv, int D, const Strides& st, float scale,
                   cudaStream_t stream) {
  BwdArgs args = bf16_args(q, k, v, out, dout, lse, delta, nullptr, nullptr, B, T, S, H,
                           Hkv, D, st, scale);
  CUtensorMap maps[5] = {};
  int dev = 0, sms = 0;
  const int err = prepare_bf16(args, maps, dev, sms);
  if (err != 0) return err;
  // dq is dense [B, T, H, D] with 16-byte rows: a map takes it whenever
  // cuTensorMapEncodeTiled is available.
  if (!hopper::encode_rows_map(maps + 4, dq, D, T, H, B, (long long)H * D, D,
                               (long long)T * H * D, BQ))
    return (int)cudaErrorNotSupported;
  // One block per SM: fold when one wave holds the launch.
  const unsigned blocks = (unsigned)(((T + BQ - 1) / BQ + 1) / 2) * H * B;
  args.folded = blocks <= (unsigned)sms;
  if (D <= 64) return launch_dq_wgmma<64>(args, maps, blocks, dev, stream);
  if (D <= 128) return launch_dq_wgmma<128>(args, maps, blocks, dev, stream);
  if (D <= 192) return launch_dq_wgmma<192>(args, maps, blocks, dev, stream);
  return launch_dq_wgmma<256>(args, maps, blocks, dev, stream);
}

int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int B,
                    int T, int S, int H, int Hkv, int D, const Strides& st, float scale,
                    cudaStream_t stream) {
  BwdArgs args = bf16_args(q, k, v, nullptr, dout, lse, const_cast<float*>(delta), dk, dv,
                           B, T, S, H, Hkv, D, st, scale);
  CUtensorMap maps[4] = {};
  int dev = 0, sms = 0;
  const int err = prepare_bf16(args, maps, dev, sms);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((S + BKV - 1) / BKV) * Hkv * B;
  if (D <= 64) return launch_dkv_wgmma<64>(args, maps, blocks, dev, stream);
  if (D <= 128) return launch_dkv_wgmma<128>(args, maps, blocks, dev, stream);
  if (D <= 192) return launch_dkv_wgmma<192>(args, maps, blocks, dev, stream);
  return launch_dkv_wgmma<256>(args, maps, blocks, dev, stream);
}

bool valid_shape(int B, int T, int S, int H, int Hkv, int D) {
  // 32-row tiles are the smallest either kernel takes, so this bounds both
  // grids below 2^31 blocks.
  return B >= 1 && T >= 1 && S >= T && Hkv >= 1 && H % Hkv == 0 && D >= 8 &&
         D % 8 == 0 && D <= 256 &&
         (long long)((T + 31) / 32) * H * B <= 2147483647LL &&
         (long long)((S + 31) / 32) * Hkv * B <= 2147483647LL;
}

}  // namespace

extern "C" {

// q, out and dout [B, T, H, D] with element strides (x_b, x_t, x_h, 1); k/v
// [B, S, Hkv, D] likewise; lse [B, H, T] f32 contiguous. Needs
// H % Hkv == 0, D % 8 == 0, D <= 256, 1 <= T <= S and 16-byte aligned rows
// of q, k, v and dout. Each returns the CUDA error of the attribute call or
// of the launch (0 on success).

// Writes dq [B, T, H, D] contiguous in q's type and delta [B, H, T] f32.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* out, const void* dout, const float* lse,
                           float* delta, void* dq, int is_bf16, int B, int T,
                           int S, int H, int Hkv, int D, long long q_sb,
                           long long q_st, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, long long o_sb,
                           long long o_st, long long o_sh, long long out_sb,
                           long long out_st, long long out_sh, float scale,
                           void* stream) {
  if (!valid_shape(B, T, S, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Strides st = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                      v_sh, o_sb, o_st, o_sh, out_sb, out_st, out_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dq_bf16(q, k, v, out, dout, lse, delta, dq, B, T, S, H,
                                  Hkv, D, st, scale, s)
                 : launch_dq<float>(q, k, v, out, dout, lse, delta, dq, B, T,
                                    S, H, Hkv, D, st, scale, s);
}

// Reads the delta that flash_attention_bwd_dq wrote (out is not read);
// writes dk and dv [B, S, Hkv, D] contiguous in k's type.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* out, const void* dout,
                            const float* lse, const float* delta, void* dk,
                            void* dv, int is_bf16, int B, int T, int S, int H,
                            int Hkv, int D, long long q_sb, long long q_st,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, long long o_sb, long long o_st,
                            long long o_sh, long long out_sb, long long out_st,
                            long long out_sh, float scale, void* stream) {
  (void)out;
  if (!valid_shape(B, T, S, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Strides st = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                      v_sh, o_sb, o_st, o_sh, out_sb, out_st, out_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dkv_bf16(q, k, v, dout, lse, delta, dk, dv, B, T, S, H,
                                   Hkv, D, st, scale, s)
                 : launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, T,
                                     S, H, Hkv, D, st, scale, s);
}

}  // extern "C"
