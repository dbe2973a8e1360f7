// Two-tier ragged masked top-k, the arena scan of the fused serving path: the
// keyed mode of the templated scan in topk_scan.cuh (what it computes, how it
// is laid out and what bounds it are described there).
//
// Replaces, on that path, the TPU function
// lazzaro_tpu/ops/pallas_topk.py:pallas_masked_topk_ragged, whose contract it
// keeps, and the XLA scan it stands for in the fused programs,
// lazzaro_tpu/core/state.py:_exact_two_tier + _ragged_topk_mask; over a
// table of shards on one card (fused_topk_grouped), the shard-local scans
// and both merges of make_fused_sharded's exact mode.

#include "topk_scan.cuh"

extern "C" {

// Row splits of each of `shards` arenas of n rows for `route` (0: FMA, 1:
// tensor cores, 2: streaming) and the longest list kmax: shards times this
// is the leading dimension of the scratch.
int fused_topk_splits(long long n, int shards, int nq, int kmax, int route, int sms, int d) {
  return scan_splits<true>(n, shards, nq, kmax, route, sms, d);
}

// Keyed mode over a table of `shards` arenas: embs[p] [n, d] (bf16 when
// is_bf16, else f32), alives[p]/supers[p] [n] u8, tenants[p] [n] i32, rows
// global from bases[p]; qry [nq, d] in the emb dtype, q_tenant [nq] i32,
// k_q [nq] i32 or null. Scratch: gate_c* [shards * splits, nq], cand_*
// [shards * splits, nq, min(kmax, 128)]. Outputs: gate_s/gate_r [nq],
// out_s/out_r [nq, k_out] (f32, i32, global rows). mask_dead writes
// tail_row for every masked pair (the gate's included). Needs d % 8 == 0,
// 16-byte aligned arenas and queries, 1 <= kmax <= k_out <= shards * n,
// 1 <= shards <= 64. route 0 runs the FMA stage 1, 1 the tensor-core one
// (bf16 only), 2 the streaming one (f32, nq <= 16). Two launches a pass of
// 128 list entries, counted into *launched. Returns the CUDA error of the
// launches (0 on success).
int fused_topk_grouped(const void* const* embs, const uint8_t* const* alives,
                       const int* const* tenants, const uint8_t* const* supers,
                       const long long* bases, int shards, int is_bf16, const void* qry,
                       const int* q_tenant, const int* k_q, long long n, int d, int nq,
                       int k_out, int kmax, int tail_row, int mask_dead, int route,
                       int splits, float* gate_cs, int* gate_cr, float* cand_s,
                       int* cand_r, float* gate_s, int* gate_r, float* out_s, int* out_r,
                       int* launched, void* stream) {
  if (shards < 1 || shards > kMaxShards) return (int)cudaErrorInvalidValue;
  Scan<true> a{};
  for (int p = 0; p < shards; ++p) {
    a.t.emb[p] = embs[p];
    a.t.words[p] = tenants[p];
    a.t.alive[p] = alives[p];
    a.t.is_super[p] = supers[p];
    a.t.base[p] = bases[p];
  }
  a.shards = shards; a.is_bf16 = is_bf16; a.qry = qry;
  a.q_tenant = q_tenant; a.k_q = k_q;
  a.n = n; a.d = d; a.nq = nq; a.k_out = k_out; a.kmax = kmax;
  a.splits = splits; a.tail_row = tail_row; a.mask_dead = mask_dead;
  a.gate_cs = gate_cs; a.gate_cr = gate_cr; a.cand_s = cand_s;
  a.cand_r = cand_r; a.gate_s = gate_s; a.gate_r = gate_r;
  a.out_s = out_s; a.out_r = out_r;
  return run_scan(a, route, launched, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
