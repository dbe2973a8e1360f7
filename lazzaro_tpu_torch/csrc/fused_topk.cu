// Two-tier ragged masked top-k, the arena scan of the fused serving path: the
// keyed mode of the templated scan in topk_scan.cuh (what it computes, how it
// is laid out and what bounds it are described there).
//
// Replaces, on that path, the TPU function
// lazzaro_tpu/ops/pallas_topk.py:pallas_masked_topk_ragged, whose contract it
// keeps, and the XLA scan it stands for in the fused programs,
// lazzaro_tpu/core/state.py:_exact_two_tier + _ragged_topk_mask.

#include "topk_scan.cuh"

extern "C" {

// Row splits of stage 1 for `route` (0: FMA, 1: tensor cores) and the
// longest list kmax: the leading dimension of the scratch.
int fused_topk_splits(long long n, int nq, int kmax, int route, int sms) {
  return scan_splits(n, nq, kmax, route, sms);
}

// Keyed mode. emb [n, d] (bf16 when is_bf16, else f32), alive/is_super [n]
// u8, row_tenant [n] i32; qry [nq, d] in the emb dtype, q_tenant [nq] i32,
// k_q [nq] i32 or null. Scratch: gate_c* [splits, nq], cand_* [splits, nq,
// min(kmax, 128)]. Outputs: gate_s/gate_r [nq], out_s/out_r [nq, k_out]
// (f32, i32). Needs d % 8 == 0, 16-byte aligned rows, 1 <= kmax <= k_out <=
// n. route 0 runs the FMA stage 1, route 1 the tensor-core one (bf16 only;
// 16-byte aligned emb and qry). Returns the CUDA error of the launches (0 on
// success).
int fused_topk(const void* emb, int is_bf16, const uint8_t* alive,
               const int* row_tenant, const uint8_t* is_super, const void* qry,
               const int* q_tenant, const int* k_q, long long n, int d, int nq,
               int k_out, int kmax, int tail_row, int route, int splits,
               float* gate_cs, int* gate_cr, float* cand_s, int* cand_r,
               float* gate_s, int* gate_r, float* out_s, int* out_r,
               void* stream) {
  Scan<true> a{};
  a.emb = emb; a.is_bf16 = is_bf16; a.alive = alive;
  a.row_tenant = row_tenant; a.is_super = is_super; a.qry = qry;
  a.q_tenant = q_tenant; a.k_q = k_q;
  a.n = n; a.d = d; a.nq = nq; a.k_out = k_out; a.kmax = kmax;
  a.splits = splits; a.tail_row = tail_row;
  a.gate_cs = gate_cs; a.gate_cr = gate_cr; a.cand_s = cand_s;
  a.cand_r = cand_r; a.gate_s = gate_s; a.gate_r = gate_r;
  a.out_s = out_s; a.out_r = out_r;
  return run_scan(a, route, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
