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
// dQ kernel: one block per (q tile, head, batch) on a 1-D grid that hands
// out the last q tiles (the longest causal rows) first, as the forward does;
// it walks the kv tiles up to the diagonal (tiles wholly above it are never
// loaded) and keeps the dQ accumulator in shared memory across the walk.
// dK/dV kernel: one block per (kv tile, kv head, batch), kv tile 0 (the
// longest walk) first; it walks the rep query heads of its GQA group and,
// for each, every q tile whose causal window reaches the kv tile (from
// max(0, j0 - (S - T)) / BQ on), keeping both accumulators in shared memory
// for the whole walk. No atomics: each output element is summed by one block
// in one order, so the result does not depend on run order (the TPU kernel
// gets the same from its sequential (h, iq) grid dims).
//
// bf16 runs every product on the tensor cores through wmma (16x16x16, f32
// accumulation); f32 runs them on FMA. Tiles (rows): dQ kernel BQ = 64,
// BK = 32 in bf16; dK/dV kernel BK = 32, BQ = 64 in bf16; 32 x 32 for both
// in f32. The ragged T and S tails load as zeros (cp.async zero-fill) and
// are masked; head_dim is any multiple of 8 up to 256, zero-padded to a
// multiple of 16 in shared memory only. At D = 256 the dQ kernel holds Q,
// dO, K, V, the f32 score and dP tiles, the dS tile and the f32 accumulator
// in ~188 KB of shared memory and the dK/dV kernel K, V, Q, dO, the f32
// score and dP tiles, the P and dS tiles and two f32 accumulators in
// ~191 KB (one block per SM each, dynamic shared memory past 48 KB through
// cudaFuncSetAttribute). At the training shape B = 2, T = S = 2048, H = 8,
// Hkv = 2, D = 256 the dQ kernel runs 512 blocks (3.9 waves on 132 SMs)
// and the dK/dV kernel 256 blocks (1.9 waves; kv tiles of 32 rows give
// twice the blocks of 64-row tiles, which would leave 64 blocks at B = 1).
//
// Bound on this card: operations. One causal product is
// 2*B*H*D*sum_i(S-T+i+1) operations; dQ does three (s, dP, dQ) and dK/dV
// four (s, dP, dV, dK). At the training shape that is 51.6 and 68.7 GFLOP,
// 0.0521 and 0.0695 ms at the 989 TFLOP/s bf16 tensor-core rate, against
// 76 and 50 MB of bytes (dQ also reads O for delta; at most 0.023 ms at
// 3.35 TB/s). wmma through shared
// memory (scores and accumulators make round trips there) and one block
// per SM keep this first version far from that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

using bf16 = __nv_bfloat16;

// Tile rows and row paddings (elements) per element type. bf16: wmma needs
// ldm % 8 == 0 for 16-bit tiles and % 4 for f32 ones; the paddings also
// spread rows over the shared-memory banks. f32: the operand whose rows a
// warp's threads walk side by side (PAD_WALK) gets an odd row length, so
// that they hit 32 banks.
template <typename E> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int DQ_BQ = 64, DQ_BK = 32, KV_BK = 32, KV_BQ = 64;
  static constexpr int PAD_IN = 8, PAD_WALK = 8, PAD_F32 = 4, PAD_E = 8;
};
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
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename E> __device__ __forceinline__ E from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype
}

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
  const int warp = threadIdx.x / 32;
  if constexpr (sizeof(E) == 2) {
    constexpr int NT = N / 16;
    for (int t = warp; t < (M / 16) * NT; t += WARPS) {
      const int ti = t / NT, tj = t % NT;
      const int key = key0 + (KEYS_ROWS ? ti : tj) * 16;
      const int pos = pos0 + (KEYS_ROWS ? tj : ti) * 16 + 15;
      if (key > pos) continue;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      for (int kk = 0; kk < kd; kk += 16) {
        wmma::load_matrix_sync(a, A + ti * 16 * lda + kk, lda);
        // col_major B: element (k, n) = Bm[n][k]
        wmma::load_matrix_sync(b, Bm + tj * 16 * ldb + kk, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + ti * 16 * ldc + tj * 16, c, ldc,
                              wmma::mem_row_major);
    }
  } else {
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
}

// C[M, n] += A[M, KD] . Bm[KD, n] (f32 accumulation into shared memory).
template <typename E, int M, int KD>
__device__ void accumulate_nn(const E* A, int lda, const E* Bm, int ldb,
                              float* C, int ldc, int n) {
  const int warp = threadIdx.x / 32;
  if constexpr (sizeof(E) == 2) {
    const int ntc = n / 16;
    for (int t = warp; t < (M / 16) * ntc; t += WARPS) {
      const int ti = t / ntc, tc = t % ntc;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* o = C + ti * 16 * ldc + tc * 16;
      wmma::load_matrix_sync(c, o, ldc, wmma::mem_row_major);
      for (int kk = 0; kk < KD; kk += 16) {
        wmma::load_matrix_sync(a, A + ti * 16 * lda + kk, lda);
        wmma::load_matrix_sync(b, Bm + kk * ldb + tc * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(o, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * n; i += THREADS) {
      const int r = i / n, c = i % n;
      float acc = C[r * ldc + c];
      const E* ar = A + r * lda;
      for (int j = 0; j < KD; ++j) acc = fmaf(ar[j], Bm[j * ldb + c], acc);
      C[r * ldc + c] = acc;
    }
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
  return is_bf16 ? launch_dq<bf16>(q, k, v, out, dout, lse, delta, dq, B, T, S,
                                   H, Hkv, D, st, scale, s)
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
  return is_bf16 ? launch_dkv<bf16>(q, k, v, dout, lse, delta, dk, dv, B, T, S,
                                    H, Hkv, D, st, scale, s)
                 : launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, T,
                                     S, H, Hkv, D, st, scale, s);
}

}  // extern "C"
