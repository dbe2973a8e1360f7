// Causal grouped-query flash attention, forward: O and the per-row
// log-sum-exp, with the score tile kept out of device memory.
//
// Replaces the TPU kernel lazzaro_tpu/ops/flash_attention.py:_flash_fwd_bhtd
// (body _flash_kernel), the forward half of its flash_attention custom VJP.
//
// What it computes, as _flash_kernel does: q [B, T, H, D], k/v [B, S, Hkv, D]
// (bf16 or f32, read in place through their strides: no transpose, no
// padding copy), query head h reads kv head h / (H / Hkv). The causal
// diagonal is end-aligned: query row i attends keys 0 .. (S - T) + i, masked
// scores are -1e30. Scores s = (q . k) * scale in f32 with scale
// 1/sqrt(D); an online softmax keeps the running max m, sum l and the output
// accumulator in f32; P is cast to V's type before the P.V product (f32
// accumulation); l is clamped at 1e-30; O = acc / l in q's type and
// LSE = m + log(l) per row, stored [B, H, T] f32 (the TPU kernel stores it
// broadcast over 128 lanes).
//
// Design: one block of 256 threads (8 warps) per (q tile of 64 rows, head,
// batch), on a 1-D grid that hands out the last q tiles (the longest causal
// rows) of every head first, so short tiles fill the last wave. K/V tiles (64 rows for bf16, 32 for f32) are staged through
// shared memory with cp.async, V(j) loading while the scores of tile j are
// computed and K(j + 1) while P.V runs. kv tiles wholly above the diagonal
// are never loaded; score tiles of a crossing kv tile that lie wholly above
// it are skipped.
// bf16 runs Q.K^T and P.V on the tensor cores through wmma (16x16x16,
// f32 accumulation); f32 runs them on FMA. The ragged T and S tails are
// masked here: rows past T load as zeros and are never stored, keys past S
// load as zeros and are masked. head_dim is any multiple of 8 up to 256; it
// is zero-padded to a multiple of 16 in shared memory only. The f32 O
// accumulator, the Q/K/V tiles and the score and P tiles all sit in shared
// memory: ~191 KB at D = 256 bf16, which needs dynamic shared memory past
// 48 KB (cudaFuncSetAttribute) and leaves one block per SM.
//
// Bound on this card: compute. A causal forward does 4*B*H*D*sum_i(S-T+i+1)
// operations; at B=1, T=S=2048, H=8, D=256 that is 17.2 GFLOP, 0.0174 ms at
// the 989 TFLOP/s bf16 tensor-core rate, against 21 MB of bytes (0.0063 ms
// at 3.35 TB/s). wmma through shared memory (scores and the accumulator
// make round trips there), one copy in flight behind each phase and one
// block per SM keep this first version far from that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;
constexpr float NEG = -1e30f;

using bf16 = __nv_bfloat16;

template <typename E> struct Tile;
// bf16: 64-row kv tiles; rows of Q/K/V padded by 8 elements and the f32
// tiles by 4 against shared-memory bank conflicts (wmma needs ldm % 8 == 0
// for 16-bit types and % 4 for f32).
template <> struct Tile<bf16> {
  static constexpr int BK = 64;
  static constexpr int PAD_IN = 8, PAD_KT = 8, PAD_F32 = 4, PAD_P = 8;
};
// f32: 32-row kv tiles (the D = 256 tiles would not fit at 64); K rows
// padded by one so that a warp reading K column-wise hits 32 banks.
template <> struct Tile<float> {
  static constexpr int BK = 32;
  static constexpr int PAD_IN = 0, PAD_KT = 1, PAD_F32 = 0, PAD_P = 0;
};

// Leading dimensions (elements) and byte offsets of the shared regions.
struct Layout {
  int ldq, ldk, ldv, lds, ldp, ldo;
  unsigned off_k, off_v, off_s, off_p, off_o, off_m, off_l, bytes;
};

inline unsigned align128(unsigned x) { return (x + 127u) & ~127u; }

template <typename E>
Layout make_layout(int dp) {
  using C = Tile<E>;
  Layout L;
  L.ldq = dp + C::PAD_IN;
  L.ldk = dp + C::PAD_KT;
  L.ldv = dp + C::PAD_IN;
  L.lds = C::BK + C::PAD_F32;
  L.ldp = C::BK + C::PAD_P;
  L.ldo = dp + C::PAD_F32;
  unsigned at = align128(BQ * L.ldq * sizeof(E));
  L.off_k = at;
  at = align128(at + C::BK * L.ldk * sizeof(E));
  L.off_v = at;
  at = align128(at + C::BK * L.ldv * sizeof(E));
  L.off_s = at;
  at = align128(at + BQ * L.lds * sizeof(float));
  L.off_p = at;
  at = align128(at + BQ * L.ldp * sizeof(E));
  L.off_o = at;
  at = align128(at + BQ * L.ldo * sizeof(float));
  L.off_m = at;
  at += BQ * sizeof(float);
  L.off_l = at;
  at += BQ * sizeof(float);
  L.bytes = align128(at);
  return L;
}

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
// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows row0 .. row0 + nrows - 1 of one head (row r at src + r * stride) into
// shared memory with leading dimension ld; rows at or past `limit` load as
// zeros. Columns D .. ld stay as they are (zeroed once at the start). Rows
// whose shared-memory start is 16-byte aligned go through cp.async and land
// at the caller's cp_async_wait + __syncthreads; the f32 K tile (ld = dp +
// 1) is copied through registers.
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

// S[BQ, BK] = Q . K^T (raw dots, f32). Score tiles wholly above the causal
// diagonal are skipped; the softmax masks them by position.
template <typename E>
__device__ void scores(const E* Qs, const E* Ks, float* Ss, const Layout& L,
                       int dp, int diag0, int j0) {
  constexpr int BK = Tile<E>::BK;
  const int warp = threadIdx.x / 32;
  if constexpr (sizeof(E) == 2) {
    constexpr int NTJ = BK / 16;
    for (int t = warp; t < (BQ / 16) * NTJ; t += WARPS) {
      const int ti = t / NTJ, tj = t % NTJ;
      if (j0 + tj * 16 > diag0 + ti * 16 + 15) continue;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      for (int kk = 0; kk < dp; kk += 16) {
        wmma::load_matrix_sync(a, Qs + ti * 16 * L.ldq + kk, L.ldq);
        // col_major B: element (k, n) = K[n][k]
        wmma::load_matrix_sync(b, Ks + tj * 16 * L.ldk + kk, L.ldk);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(Ss + ti * 16 * L.lds + tj * 16, c, L.lds,
                              wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      if (j0 + c > diag0 + r) continue;
      const E* qr = Qs + r * L.ldq;
      const E* kr = Ks + c * L.ldk;
      float acc = 0.0f;
      for (int d = 0; d < dp; ++d) acc = fmaf(qr[d], kr[d], acc);
      Ss[r * L.lds + c] = acc;
    }
  }
}

// O[BQ, Dp] += P . V (f32 accumulation into the shared accumulator).
template <typename E>
__device__ void accumulate_pv(const E* Ps, const E* Vs, float* Os,
                              const Layout& L, int dp) {
  constexpr int BK = Tile<E>::BK;
  const int warp = threadIdx.x / 32;
  if constexpr (sizeof(E) == 2) {
    const int ntc = dp / 16;
    for (int t = warp; t < (BQ / 16) * ntc; t += WARPS) {
      const int ti = t / ntc, tc = t % ntc;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* o = Os + ti * 16 * L.ldo + tc * 16;
      wmma::load_matrix_sync(c, o, L.ldo, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::load_matrix_sync(a, Ps + ti * 16 * L.ldp + kk, L.ldp);
        wmma::load_matrix_sync(b, Vs + kk * L.ldv + tc * 16, L.ldv);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(o, c, L.ldo, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < BQ * dp; i += THREADS) {
      const int r = i / dp, c = i % dp;
      float acc = Os[r * L.ldo + c];
      const E* pr = Ps + r * L.ldp;
      for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], Vs[j * L.ldv + c], acc);
      Os[r * L.ldo + c] = acc;
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, E* __restrict__ out,
                 float* __restrict__ lse, int B, int T, int S, int H, int rep, int D,
                 int dp, long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, float scale,
                 Layout L) {
  constexpr int BK = Tile<E>::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  E* Qs = reinterpret_cast<E*>(smem);
  E* Ks = reinterpret_cast<E*>(smem + L.off_k);
  E* Vs = reinterpret_cast<E*>(smem + L.off_v);
  float* Ss = reinterpret_cast<float*>(smem + L.off_s);
  E* Ps = reinterpret_cast<E*>(smem + L.off_p);
  float* Os = reinterpret_cast<float*>(smem + L.off_o);
  float* Ms = reinterpret_cast<float*>(smem + L.off_m);
  float* Ls = reinterpret_cast<float*>(smem + L.off_l);

  // Blocks start in index order: tile-major from the last tile down, so a
  // tile's causal work never grows over the launch.
  const int tiles = (T + BQ - 1) / BQ, bh = (int)(blockIdx.x % (unsigned)(B * H));
  const int q0 = (tiles - 1 - (int)(blockIdx.x / (unsigned)(B * H))) * BQ;
  const int h = bh % H, b = bh / H;
  const int offset = S - T;          // end-aligned diagonal
  const int diag0 = offset + q0;     // last key of the tile's first row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Zero everything once: padding columns, the accumulator, the sums.
  for (unsigned i = threadIdx.x * 16; i < L.bytes; i += THREADS * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (threadIdx.x < BQ) Ms[threadIdx.x] = NEG;

  const E* kh = k + b * k_sb + (h / rep) * k_sh;
  const E* vh = v + b * v_sb + (h / rep) * v_sh;
  // Keys past the tile's last real row's window are never needed.
  const int kv_end = min(S, offset + min(q0 + BQ, T));
  // Copy groups, in order: {Q, K(0)}, then per kv tile V(j) and K(j + 1).
  // V(j) lands behind the score phase, K(j + 1) behind the P.V phase.
  load_rows(Qs, L.ldq, q + b * q_sb + h * q_sh, q_st, q0, BQ, T, D);
  load_rows(Ks, L.ldk, kh, k_ss, 0, BK, S, D);
  cp_async_commit();
  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    load_rows(Vs, L.ldv, vh, v_ss, j0, BK, S, D);
    cp_async_commit();
    cp_async_wait<1>();               // Q and K(j) are in
    __syncthreads();
    scores<E>(Qs, Ks, Ss, L, dp, diag0, j0);
    __syncthreads();
    // Online softmax, one warp per 8 rows, each lane BK/32 columns; the
    // warp then rescales its rows of the accumulator by exp(m_prev - m_new).
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int last = diag0 + r;     // row's last visible key
      float s[BK / 32];
      float mx = NEG;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u, col = j0 + c;
        const float x = Ss[r * L.lds + c] * scale;
        s[u] = (col <= last && col < S) ? x : NEG;
        mx = fmaxf(mx, s[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = expf(s[u] - m_new);
        sum += p;
        Ps[r * L.ldp + lane + 32 * u] = from_f32<E>(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m_prev - m_new);
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + sum;
      }
      for (int c = lane; c < dp; c += 32) Os[r * L.ldo + c] *= corr;
    }
    if (j0 + BK < kv_end) {           // the scores are done with K(j)
      load_rows(Ks, L.ldk, kh, k_ss, j0 + BK, BK, S, D);
      cp_async_commit();
      cp_async_wait<1>();             // V(j) is in
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    accumulate_pv<E>(Ps, Vs, Os, L, dp);
    __syncthreads();
  }

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr, row = q0 + r;
    if (row >= T) break;
    const float l = fmaxf(Ls[r], 1e-30f);
    E* orow = out + (((long long)b * T + row) * H + h) * D;
    for (int c = lane; c < D; c += 32) orow[c] = from_f32<E>(Os[r * L.ldo + c] / l);
    if (lane == 0) lse[((long long)b * H + h) * T + row] = Ms[r] + logf(l);
  }
}

template <typename E>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int T, int S, int H, int Hkv, int D, const long long* st,
           float scale, cudaStream_t stream) {
  const int dp = (D + 15) / 16 * 16;
  const Layout L = make_layout<E>(dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((T + BQ - 1) / BQ) * H * B;
  flash_fwd_kernel<E><<<blocks, THREADS, L.bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(out), lse, B, T, S, H, H / Hkv, D,
      dp, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, T, H, D] with element strides (q_sb, q_st, q_sh, 1); k/v [B, S, Hkv,
// D] likewise; out [B, T, H, D] contiguous in q's type; lse [B, H, T] f32.
// Needs H % Hkv == 0, D % 8 == 0, D <= 256, 1 <= T <= S, at most 2^31 - 1
// blocks (ceil(T / 64) * H * B) and 16-byte aligned rows. Returns the CUDA
// error of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        float* lse, int is_bf16, int B, int T, int S, int H,
                        int Hkv, int D, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, float scale, void* stream) {
  if (B < 1 || T < 1 || S < T || Hkv < 1 || H % Hkv || D < 8 || D % 8 ||
      D > 256 || (long long)((T + BQ - 1) / BQ) * H * B > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(q, k, v, out, lse, B, T, S, H, Hkv, D, st, scale, s)
                 : launch<float>(q, k, v, out, lse, B, T, S, H, Hkv, D, st, scale, s);
}

}  // extern "C"
