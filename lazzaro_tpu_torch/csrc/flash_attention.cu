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
// Bound on this card: compute. A causal forward does 4*B*H*D*sum_i(S-T+i+1)
// operations; at B=1, T=S=2048, H=8, D=256 that is 17.2 GFLOP, 0.0174 ms at
// the 989 TFLOP/s bf16 tensor-core rate, against 21 MB of bytes (0.0063 ms
// at 3.35 TB/s). Only wgmma reaches that rate, and only if the tensor cores
// never wait for the softmax, for copies or for shared-memory round trips.
//
// bf16 design (flash_fwd_wgmma, building blocks in flash_hopper.cuh):
// - A block of three warpgroups owns 128 query rows of one (head, batch):
//   warpgroups 0 and 1 each compute 64 of them, warpgroup 2 produces. One
//   warp of the producer loads Q once and then K and V tiles of 64 keys by
//   TMA into a ring of 2-4 stages (by head dimension) with full and empty
//   mbarriers, K and V on barriers of their own so that Q.K^T starts
//   before V has landed. Tensor maps are 4-D over (D, rows, heads, batch)
//   with the tensors' own strides; ragged T and S tails and columns past D
//   arrive as zeros. A layout no map can express (a zero stride) is loaded
//   by the same warp with cp.async into the same swizzled tiles and
//   signalled on the same barriers.
// - The producer warpgroup gives its registers to the consumers
//   (setmaxnreg 24 / 240): the O accumulator of 64 x D f32 is D / 2
//   registers a thread.
// - S = Q.K^T is a chain of wgmma m64n64k16 over D with both operands in
//   128-byte swizzled shared memory; the online softmax runs on the S
//   fragment in registers (a row's max and sum over the four threads that
//   hold it), in the log2 domain (exp2 of s * scale * log2(e) - m); P is
//   rounded to bf16 in registers and is wgmma's A operand for
//   O += P.V (m64nDk16, V the transposed B operand from shared memory); O
//   and its rescale by exp2(m_prev - m_new) stay in registers. S(j) and
//   P(j-1).V(j-1) are issued together, and the softmax of tile j runs while
//   P.V is in flight; O is rescaled after it lands, and not at all when no
//   row's max moved. No score, P or O tile goes to shared memory during
//   the walk; at the end O / l goes to the warpgroup's own Q tile with
//   stmatrix and from there to device memory by TMA stores (a fourth map,
//   over the dense output).
// - Schedule: kv tiles wholly above a warpgroup's diagonal are skipped and
//   only crossing and tail tiles are masked. A launch of more blocks than
//   the card has SMs gives the two warpgroups adjacent 64-row q tiles and
//   hands out the last tiles (the longest causal rows) first, so short
//   blocks fill the last wave. A launch that fits in one wave (the
//   2,047-token logits_for: 128 blocks) lasts as long as its longest block,
//   so it pairs tile i with tile n - 1 - i instead, and no block walks two
//   long rows of tiles. The head dimension is a template parameter
//   rounded up to 64, 128, 192 or 256. Each output element is computed by
//   one block in one order: results do not depend on the run.
// - What bounds it on the H100 (PERF.md has the numbers): a launch of one
//   wave lasts as long as its longest block, one warpgroup walking 32 kv
//   tiles mostly alone, about 2.4x the bound at the 2,047-token
//   logits_for shape; launches of several waves reach ~55% of the tensor
//   rate. Inside a warpgroup the next S cannot go out before the softmax
//   of this tile: a second S buffer would need 32 more registers a thread,
//   and at D = 256 the O accumulator, S and P already take 176 of 240.
//
// f32 keeps the FMA body of the first version (no full-width path runs f32
// attention): one block of 256 threads per (q tile of 64 rows, head,
// batch), 32-row K/V tiles staged through shared memory with cp.async, the
// score, P and O tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: wgmma with register accumulators, K/V through a TMA ring
// ---------------------------------------------------------------------------

constexpr int WG_BK = 64;             // keys per ring stage
constexpr int WG_THREADS = 384;       // warpgroups 0, 1 consume; 2 produces
constexpr int TILE_ROW_BYTES = hopper::SWIZZLE_ROW_BYTES;
constexpr int PANEL_BYTES = 64 * TILE_ROW_BYTES;   // 64 rows x 64 columns

template <int DP>
struct WgConfig {
  static constexpr int PANELS = DP / 64;
  static constexpr int NS = DP == 256 ? 2 : DP == 192 ? 3 : 4;   // ring stages
  static constexpr int TILE = PANELS * PANEL_BYTES;             // 64 rows x DP
  static constexpr int OFF_K = 2 * TILE;                        // after Q
  static constexpr int OFF_V = OFF_K + NS * TILE;
  static constexpr int OFF_BAR = OFF_V + NS * TILE;
  // barriers: full Q, then full K, full V, empty K, empty V per stage
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 4 * NS) + 1024;  // + alignment
};

struct WgArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;
  int B, T, S, H, rep, D;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale_log2;                   // scale * log2(e)
  int tma;                            // bit 0: q by TMA, bit 1: k, bit 2: v
  int folded;                         // pair q tile i with n - 1 - i (one wave)
};

// First q row of each warpgroup's 64 rows for block `item` of a launch in
// index order (a.T: no rows). Adjacent: warpgroups take 64-row tiles 2p and
// 2p + 1, the last pairs (the longest causal rows) first. Folded: tiles p
// and n - 1 - p, so that every block walks about the same number of kv
// tiles, the pair with the longest tile first; taken when the launch fits
// in one wave, where the longest block is the kernel's time.
__device__ __forceinline__ void wg_rows(const WgArgs& a, int item, int (&row0)[2]) {
  const int n64 = (a.T + 63) / 64, pairs = (n64 + 1) / 2;
  int t0, t1;
  if (a.folded) {
    t0 = item;
    t1 = n64 - 1 - item;
    if (t1 == t0) t1 = n64;
  } else {
    t0 = 2 * (pairs - 1 - item);
    t1 = t0 + 1;
  }
  row0[0] = min(64 * t0, a.T);
  row0[1] = min(64 * t1, a.T);
}

// kv tiles that rows row0 .. row0 + 63 need (0 when row0 >= T).
__device__ __forceinline__ int wg_kv_tiles(const WgArgs& a, int row0) {
  if (row0 >= a.T) return 0;
  return (min(a.S, a.S - a.T + min(row0 + 64, a.T)) + WG_BK - 1) / WG_BK;
}

// The online softmax of one kv tile on the S fragment, in place: sc[4c + e]
// is row ra, column j0 + 8c + 2t + e (sc[4c + 2 + e] row rb). Raw scores
// are masked to NEG only where the tile crosses the warpgroup's diagonal
// or the end of S; m (log2 domain) moves to max(m, rowmax * scale_log2)
// (scale > 0, so the max of the raw scores gives the max of the scaled
// ones), p = exp2(s * scale_log2 - m) in one FFMA and one MUFU.EX2, and l
// to l * corr + this thread's sum of p. Returns the rows' rescale factors
// in corr; a masked score's p and a first tile's corr are exactly 0.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], const WgArgs& a,
                                             int j0, bool edge, int ra, int rb, int t,
                                             float& m_a, float& m_b, float& l_a,
                                             float& l_b, float& corr_a, float& corr_b) {
  if (edge) {
    const int last_a = min(a.S - a.T + ra, a.S - 1), last_b = min(a.S - a.T + rb, a.S - 1);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + 8 * c + 2 * t + e;
        if (col > last_a) sc[4 * c + e] = NEG;
        if (col > last_b) sc[4 * c + 2 + e] = NEG;
      }
    }
  }
  // Row maxes as trees of four chains (max is exact in any order).
  float ma[4] = {NEG, NEG, NEG, NEG}, mb[4] = {NEG, NEG, NEG, NEG};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ma[(2 * c + e) & 3] = fmaxf(ma[(2 * c + e) & 3], sc[4 * c + e]);
      mb[(2 * c + e) & 3] = fmaxf(mb[(2 * c + e) & 3], sc[4 * c + 2 + e]);
    }
  }
  float mx_a = fmaxf(fmaxf(ma[0], ma[1]), fmaxf(ma[2], ma[3]));
  float mx_b = fmaxf(fmaxf(mb[0], mb[1]), fmaxf(mb[2], mb[3]));
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
  }
  const float mn_a = fmaxf(m_a, mx_a * a.scale_log2);
  const float mn_b = fmaxf(m_b, mx_b * a.scale_log2);
  corr_a = hopper::ex2(m_a - mn_a);
  corr_b = hopper::ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sa[2] = {0.0f, 0.0f}, sb[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * c + e] = hopper::ex2(fmaf(sc[4 * c + e], a.scale_log2, -mn_a));
      sc[4 * c + 2 + e] = hopper::ex2(fmaf(sc[4 * c + 2 + e], a.scale_log2, -mn_b));
      sa[e] += sc[4 * c + e];
      sb[e] += sc[4 * c + 2 + e];
    }
  }
  l_a = l_a * corr_a + (sa[0] + sa[1]);
  l_b = l_b * corr_b + (sb[0] + sb[1]);
}

// P in bf16 as wgmma's A fragment from the softmax's p: step kk covers
// columns 16kk .. 16kk + 15 (fragment chunks 2kk and 2kk + 1).
__device__ __forceinline__ void pack_p(const float (&sc)[32], uint32_t (&pf)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pf[kk][0] = hopper::pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pf[kk][1] = hopper::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = hopper::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = hopper::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// S = Q . K^T over the head dimension (16 columns a step), issued, not
// waited for.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[32], const uint8_t* Qw,
                                         const uint8_t* Kt) {
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    const int at = (kd / 4) * PANEL_BYTES + (kd % 4) * 32;
    hopper::wgmma_ss_m64n64k16(sc, hopper::sw128_desc(Qw + at, 16, 1024),
                               hopper::sw128_desc(Kt + at, 16, 1024), kd > 0);
  }
  hopper::wgmma_commit();
}

// O += P . V (16 keys a step, V the transposed B operand), issued, not
// waited for.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2], const uint32_t (&pf)[4][4],
                                         const uint8_t* Vt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc =
        hopper::sw128_desc(Vt + kk * 16 * TILE_ROW_BYTES, PANEL_BYTES, 1024);
    if constexpr (DP == 64) hopper::wgmma_rs_m64n64k16(o, pf[kk], desc, 1);
    if constexpr (DP == 128) hopper::wgmma_rs_m64n128k16(o, pf[kk], desc, 1);
    if constexpr (DP == 192) hopper::wgmma_rs_m64n192k16(o, pf[kk], desc, 1);
    if constexpr (DP == 256) hopper::wgmma_rs_m64n256k16(o, pf[kk], desc, 1);
  }
  hopper::wgmma_commit();
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_o, const WgArgs a) {
  using C = WgConfig<DP>;
  using Ring = hopper::Ring<C::NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;                 // [warpgroup][panel][64 rows]
  uint8_t* Ks = smem + C::OFF_K;      // [stage][panel][64 rows]
  uint8_t* Vs = smem + C::OFF_V;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + C::NS;
  uint64_t* empty_k = full_v + C::NS;
  uint64_t* empty_v = empty_k + C::NS;

  const bool q_tma = a.tma & 1, k_tma = a.tma & 2, v_tma = a.tma & 4;
  const int bh = (int)(blockIdx.x % (unsigned)(a.B * a.H));
  const int h = bh % a.H, b = bh / a.H, hk = h / a.rep;
  int row0s[2];
  wg_rows(a, (int)(blockIdx.x / (unsigned)(a.B * a.H)), row0s);
  const int n_tiles = max(wg_kv_tiles(a, row0s[0]), wg_kv_tiles(a, row0s[1]));

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, q_tma ? 1 : 64);
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
    const bool lead = threadIdx.x == 256;
    if (q_tma) {
      if (lead) {
        hopper::mbar_arrive_expect_tx(full_q, 2 * C::TILE);
        for (int w = 0; w < 2; ++w)
          for (int p = 0; p < C::PANELS; ++p)
            hopper::tma_load_4d(Qs + w * C::TILE + p * PANEL_BYTES, &map_q, full_q,
                                p * 64, row0s[w], h, b);
      }
    } else {
      const bf16* src = a.q + b * a.q_sb + h * a.q_sh;
      for (int w = 0; w < 2; ++w)
        hopper::warp_load_tile<64, DP>(Qs + w * C::TILE, src, a.q_st, row0s[w], a.T,
                                       a.D, full_q);
    }
    const bf16* k_src = a.k + b * a.k_sb + hk * a.k_sh;
    const bf16* v_src = a.v + b * a.v_sb + hk * a.v_sh;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = Ring::stage(j);
      if (j >= C::NS) hopper::mbar_wait(empty_k + s, Ring::empty_parity(j));
      if (k_tma) {
        if (lead) {
          hopper::mbar_arrive_expect_tx(full_k + s, C::TILE);
          for (int p = 0; p < C::PANELS; ++p)
            hopper::tma_load_4d(Ks + s * C::TILE + p * PANEL_BYTES, &map_k,
                                full_k + s, p * 64, j * WG_BK, hk, b);
        }
      } else {
        hopper::warp_load_tile<64, DP>(Ks + s * C::TILE, k_src, a.k_ss, j * WG_BK,
                                       a.S, a.D, full_k + s);
      }
      if (j >= C::NS) hopper::mbar_wait(empty_v + s, Ring::empty_parity(j));
      if (v_tma) {
        if (lead) {
          hopper::mbar_arrive_expect_tx(full_v + s, C::TILE);
          for (int p = 0; p < C::PANELS; ++p)
            hopper::tma_load_4d(Vs + s * C::TILE + p * PANEL_BYTES, &map_v,
                                full_v + s, p * 64, j * WG_BK, hk, b);
        }
      } else {
        hopper::warp_load_tile<64, DP>(Vs + s * C::TILE, v_src, a.v_ss, j * WG_BK,
                                       a.S, a.D, full_v + s);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows row0 .. row0 + 63
    hopper::regs_grow<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = wg == 0 ? row0s[0] : row0s[1], offset = a.S - a.T;
    const int ra = row0 + 16 * warp + g, rb = ra + 8;   // this thread's rows
    const int wg_tiles = wg_kv_tiles(a, row0);
    const uint8_t* Qw = Qs + wg * C::TILE;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    uint32_t pf[4][4];
    float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f;   // l: this thread's part
    // A tile needs masking where it crosses the warpgroup's first row's
    // diagonal or the end of S.
    auto edge = [&](int j0) { return j0 + WG_BK - 1 > offset + row0 || j0 + WG_BK > a.S; };

    if (wg_tiles > 0) {
      // Tile 0: S, then its softmax (O is still zero: nothing to rescale).
      hopper::mbar_wait(full_q, 0);
      hopper::mbar_wait(full_k, 0);
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
      issue_qk<DP>(sc, Qw, Ks);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (tid == 0) hopper::mbar_arrive(empty_k);
      float corr_a, corr_b;
      softmax_tile(sc, a, 0, edge(0), ra, rb, t, m_a, m_b, l_a, l_b, corr_a, corr_b);
      pack_p(sc, pf);

      // Tile j: S(j) and P(j - 1).V(j - 1) go to the tensor cores together;
      // the softmax of tile j runs while P.V is in flight, O's rescale after.
      for (int j = 1; j < wg_tiles; ++j) {
        const int s = Ring::stage(j), sp = Ring::stage(j - 1);
        hopper::mbar_wait(full_k + s, Ring::full_parity(j));
        hopper::mbar_wait(full_v + sp, Ring::full_parity(j - 1));
        hopper::fence_regs(sc);
        hopper::fence_regs(o);
        hopper::wgmma_fence();
        issue_qk<DP>(sc, Qw, Ks + s * C::TILE);
        issue_pv<DP>(o, pf, Vs + sp * C::TILE);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        if (tid == 0) hopper::mbar_arrive(empty_k + s);
        softmax_tile(sc, a, j * WG_BK, edge(j * WG_BK), ra, rb, t, m_a, m_b, l_a, l_b,
                     corr_a, corr_b);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(pf[kk]);
        if (tid == 0) hopper::mbar_arrive(empty_v + sp);
        // Skipping a factor of exactly 1 changes no bit.
        if (__any_sync(0xffffffffu, corr_a != 1.0f || corr_b != 1.0f)) {
#pragma unroll
          for (int c = 0; c < DP / 8; ++c) {
            o[4 * c] *= corr_a;
            o[4 * c + 1] *= corr_a;
            o[4 * c + 2] *= corr_b;
            o[4 * c + 3] *= corr_b;
          }
        }
        pack_p(sc, pf);
      }
      // The last tile's P.V.
      const int sl = Ring::stage(wg_tiles - 1);
      hopper::mbar_wait(full_v + sl, Ring::full_parity(wg_tiles - 1));
      hopper::fence_regs(o);
      hopper::wgmma_fence();
      issue_pv<DP>(o, pf, Vs + sl * C::TILE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (tid == 0) hopper::mbar_arrive(empty_v + sl);

      // Epilogue: row sums over the four threads of a row, LSE, then O / l
      // through this warpgroup's Q tile (its last reader is done) to TMA
      // stores.
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
      }
      l_a = fmaxf(l_a, 1e-30f);
      l_b = fmaxf(l_b, 1e-30f);
      if (t == 0) {
        float* lrow = a.lse + ((long long)b * a.H + h) * a.T;
        if (ra < a.T) lrow[ra] = m_a * LN2 + logf(l_a);
        if (rb < a.T) lrow[rb] = m_b * LN2 + logf(l_b);
      }
      const float inv_a = 1.0f / l_a, inv_b = 1.0f / l_b;
      uint8_t* Qo = Qs + wg * C::TILE;
      // stmatrix.x4 per pair of 8-column chunks: matrices (rows 0-7, c),
      // (rows 8-15, c), (rows 0-7, c + 1), (rows 8-15, c + 1) of the warp's
      // 16 rows; lane l addresses row l % 8 of matrix l / 8.
      const int mrow = 16 * warp + 8 * ((lane / 8) & 1) + lane % 8, mchunk = lane / 16;
#pragma unroll
      for (int c = 0; c < DP / 8; c += 2) {
        const int chunk = c + mchunk;
        hopper::stmatrix_x4(
            hopper::smem_u32(Qo + (chunk / 8) * PANEL_BYTES) +
                hopper::sw128_offset(mrow, chunk % 8),
            hopper::pack_bf16(o[4 * c] * inv_a, o[4 * c + 1] * inv_a),
            hopper::pack_bf16(o[4 * c + 2] * inv_b, o[4 * c + 3] * inv_b),
            hopper::pack_bf16(o[4 * c + 4] * inv_a, o[4 * c + 5] * inv_a),
            hopper::pack_bf16(o[4 * c + 6] * inv_b, o[4 * c + 7] * inv_b));
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
      if (tid == 0) {   // rows past T and columns past D are not written
        for (int p = 0; p < C::PANELS; ++p)
          hopper::tma_store_4d(&map_o, Qo + p * PANEL_BYTES, p * 64, row0, h, b);
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

// Per device: the shared-memory opt-in of each kernel instance is set once.
constexpr int MAX_DEVICES = 64;

template <int DP>
int launch_wgmma(const WgArgs& args, const CUtensorMap* maps, unsigned blocks,
                 int dev, cudaStream_t stream) {
  using C = WgConfig<DP>;
  static bool opted_in[MAX_DEVICES] = {};
  if (!opted_in[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  flash_fwd_wgmma<DP><<<blocks, WG_THREADS, C::BYTES, stream>>>(maps[0], maps[1],
                                                                maps[2], maps[3], args);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                int B, int T, int S, int H, int Hkv, int D, const long long* st,
                float scale, cudaStream_t stream) {
  WgArgs args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<bf16*>(out), lse,
              B, T, S, H, H / Hkv, D,
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
              scale * LOG2E, 0, 0};
  CUtensorMap maps[4] = {};
  const void* bases[3] = {q, k, v};
  const long long rows[3] = {T, S, S}, heads[3] = {H, Hkv, Hkv};
  for (int i = 0; i < 3; ++i)
    if (hopper::encode_rows_map(maps + i, bases[i], D, rows[i], heads[i], B,
                                st[3 * i + 1], st[3 * i + 2], st[3 * i], 64))
      args.tma |= 1 << i;
  // out is dense [B, T, H, D] with 16-byte rows: a map takes it whenever
  // cuTensorMapEncodeTiled is available.
  if (!hopper::encode_rows_map(maps + 3, out, D, T, H, B, (long long)H * D, D,
                               (long long)T * H * D, 64))
    return (int)cudaErrorNotSupported;
  // One block per SM (shared memory and registers): fold when one wave holds
  // the launch.
  const unsigned blocks = (unsigned)(((T + 63) / 64 + 1) / 2) * H * B;
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= MAX_DEVICES) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && sms[dev] == 0)
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  args.folded = blocks <= (unsigned)sms[dev];
  if (D <= 64) return launch_wgmma<64>(args, maps, blocks, dev, stream);
  if (D <= 128) return launch_wgmma<128>(args, maps, blocks, dev, stream);
  if (D <= 192) return launch_wgmma<192>(args, maps, blocks, dev, stream);
  return launch_wgmma<256>(args, maps, blocks, dev, stream);
}

// ---------------------------------------------------------------------------
// f32: FMA through shared memory
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;
constexpr int F_BK = 32;              // the D = 256 tiles would not fit at 64
constexpr int F_THREADS = 256;
constexpr int F_WARPS = F_THREADS / 32;
constexpr int ROWS_PER_WARP = F_BQ / F_WARPS;

// Leading dimensions (elements) and byte offsets of the shared regions. K
// rows are padded by one so that a warp reading K column-wise hits 32 banks.
struct Layout {
  int ldq, ldk, ldv, lds, ldp, ldo;
  unsigned off_k, off_v, off_s, off_p, off_o, off_m, off_l, bytes;
};

inline unsigned align128(unsigned x) { return (x + 127u) & ~127u; }

Layout make_layout(int dp) {
  Layout L;
  L.ldq = dp;
  L.ldk = dp + 1;
  L.ldv = dp;
  L.lds = F_BK;
  L.ldp = F_BK;
  L.ldo = dp;
  unsigned at = align128(F_BQ * L.ldq * sizeof(float));
  L.off_k = at;
  at = align128(at + F_BK * L.ldk * sizeof(float));
  L.off_v = at;
  at = align128(at + F_BK * L.ldv * sizeof(float));
  L.off_s = at;
  at = align128(at + F_BQ * L.lds * sizeof(float));
  L.off_p = at;
  at = align128(at + F_BQ * L.ldp * sizeof(float));
  L.off_o = at;
  at = align128(at + F_BQ * L.ldo * sizeof(float));
  L.off_m = at;
  at += F_BQ * sizeof(float);
  L.off_l = at;
  at += F_BQ * sizeof(float);
  L.bytes = align128(at);
  return L;
}

// 16-byte asynchronous copy global -> shared (cp.async, sm_80+); with
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  hopper::cp_async16(hopper::smem_u32(dst), src, valid);
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
// at the caller's cp_async_wait + __syncthreads; the K tile (ld = dp + 1)
// is copied through registers.
__device__ void load_rows(float* dst, int ld, const float* src, long long stride,
                          int row0, int nrows, int limit, int D) {
  constexpr int VEC = 4;
  const int per_row = D / VEC;
  const bool async = (ld * sizeof(float)) % 16 == 0;
  for (int i = threadIdx.x; i < nrows * per_row; i += F_THREADS) {
    const int r = i / per_row, c = (i % per_row) * VEC;
    const int g = row0 + r;
    const float* from = src + (long long)(g < limit ? g : 0) * stride + c;
    float* out = dst + r * ld + c;
    if (async) {
      cp_async16(out, from, g < limit);
    } else {
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < limit) val = *reinterpret_cast<const float4*>(from);
      out[0] = val.x;
      out[1] = val.y;
      out[2] = val.z;
      out[3] = val.w;
    }
  }
}

// S[BQ, BK] = Q . K^T (raw dots). Entries above the causal diagonal are
// skipped; the softmax masks them by position.
__device__ void scores(const float* Qs, const float* Ks, float* Ss, const Layout& L,
                       int dp, int diag0, int j0) {
  for (int i = threadIdx.x; i < F_BQ * F_BK; i += F_THREADS) {
    const int r = i / F_BK, c = i % F_BK;
    if (j0 + c > diag0 + r) continue;
    const float* qr = Qs + r * L.ldq;
    const float* kr = Ks + c * L.ldk;
    float acc = 0.0f;
    for (int d = 0; d < dp; ++d) acc = fmaf(qr[d], kr[d], acc);
    Ss[r * L.lds + c] = acc;
  }
}

// O[BQ, Dp] += P . V into the shared accumulator.
__device__ void accumulate_pv(const float* Ps, const float* Vs, float* Os,
                              const Layout& L, int dp) {
  for (int i = threadIdx.x; i < F_BQ * dp; i += F_THREADS) {
    const int r = i / dp, c = i % dp;
    float acc = Os[r * L.ldo + c];
    const float* pr = Ps + r * L.ldp;
    for (int j = 0; j < F_BK; ++j) acc = fmaf(pr[j], Vs[j * L.ldv + c], acc);
    Os[r * L.ldo + c] = acc;
  }
}

__global__ void __launch_bounds__(F_THREADS, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int B, int T, int S, int H, int rep, int D,
              int dp, long long q_sb, long long q_st, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh, long long v_sb,
              long long v_ss, long long v_sh, float scale, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + L.off_k);
  float* Vs = reinterpret_cast<float*>(smem + L.off_v);
  float* Ss = reinterpret_cast<float*>(smem + L.off_s);
  float* Ps = reinterpret_cast<float*>(smem + L.off_p);
  float* Os = reinterpret_cast<float*>(smem + L.off_o);
  float* Ms = reinterpret_cast<float*>(smem + L.off_m);
  float* Ls = reinterpret_cast<float*>(smem + L.off_l);

  // Blocks start in index order: tile-major from the last tile down, so a
  // tile's causal work never grows over the launch.
  const int tiles = (T + F_BQ - 1) / F_BQ, bh = (int)(blockIdx.x % (unsigned)(B * H));
  const int q0 = (tiles - 1 - (int)(blockIdx.x / (unsigned)(B * H))) * F_BQ;
  const int h = bh % H, b = bh / H;
  const int offset = S - T;          // end-aligned diagonal
  const int diag0 = offset + q0;     // last key of the tile's first row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Zero everything once: padding columns, the accumulator, the sums.
  for (unsigned i = threadIdx.x * 16; i < L.bytes; i += F_THREADS * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (threadIdx.x < F_BQ) Ms[threadIdx.x] = NEG;

  const float* kh = k + b * k_sb + (h / rep) * k_sh;
  const float* vh = v + b * v_sb + (h / rep) * v_sh;
  // Keys past the tile's last real row's window are never needed.
  const int kv_end = min(S, offset + min(q0 + F_BQ, T));
  // Copy groups, in order: {Q, K(0)}, then per kv tile V(j) and K(j + 1).
  // V(j) lands behind the score phase, K(j + 1) behind the P.V phase.
  load_rows(Qs, L.ldq, q + b * q_sb + h * q_sh, q_st, q0, F_BQ, T, D);
  load_rows(Ks, L.ldk, kh, k_ss, 0, F_BK, S, D);
  cp_async_commit();
  for (int j0 = 0; j0 < kv_end; j0 += F_BK) {
    load_rows(Vs, L.ldv, vh, v_ss, j0, F_BK, S, D);
    cp_async_commit();
    cp_async_wait<1>();               // Q and K(j) are in
    __syncthreads();
    scores(Qs, Ks, Ss, L, dp, diag0, j0);
    __syncthreads();
    // Online softmax, one warp per 8 rows, each lane one column; the warp
    // then rescales its rows of the accumulator by exp(m_prev - m_new).
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int last = diag0 + r;     // row's last visible key
      const int col = j0 + lane;
      const float x = Ss[r * L.lds + lane] * scale;
      const float s = (col <= last && col < S) ? x : NEG;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      Ps[r * L.ldp + lane] = p;
      float sum = p;
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
    if (j0 + F_BK < kv_end) {         // the scores are done with K(j)
      load_rows(Ks, L.ldk, kh, k_ss, j0 + F_BK, F_BK, S, D);
      cp_async_commit();
      cp_async_wait<1>();             // V(j) is in
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    accumulate_pv(Ps, Vs, Os, L, dp);
    __syncthreads();
  }

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr, row = q0 + r;
    if (row >= T) break;
    const float l = fmaxf(Ls[r], 1e-30f);
    float* orow = out + (((long long)b * T + row) * H + h) * D;
    for (int c = lane; c < D; c += 32) orow[c] = Os[r * L.ldo + c] / l;
    if (lane == 0) lse[((long long)b * H + h) * T + row] = Ms[r] + logf(l);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
               int B, int T, int S, int H, int Hkv, int D, const long long* st,
               float scale, cudaStream_t stream) {
  const int dp = (D + 15) / 16 * 16;
  const Layout L = make_layout(dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((T + F_BQ - 1) / F_BQ) * H * B;
  flash_fwd_f32<<<blocks, F_THREADS, L.bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, B, T, S, H,
      H / Hkv, D, dp, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, L);
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
      D > 256 || (long long)((T + 63) / 64) * H * B > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(q, k, v, out, lse, B, T, S, H, Hkv, D, st, scale, s)
                 : launch_f32(q, k, v, out, lse, B, T, S, H, Hkv, D, st, scale, s);
}

}  // extern "C"
