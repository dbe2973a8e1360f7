// The IVF candidate scan (K5): the gather mode of the templated scan in
// topk_scan.cuh (what it computes, how it is laid out and what bounds it
// are described there).
//
// Replaces no TPU kernel: the JAX package computes this scan in XLA, a
// gather of the candidate rows and an einsum, then lax.top_k, in
// lazzaro_tpu/core/state.py:_ivf_two_tier (the fused IVF serving programs)
// and lazzaro_tpu/ops/ivf.py:ivf_search (the classic IVF search). Bound:
// the live member rows and extras of the probed clusters, read once.

#include "topk_scan.cuh"

extern "C" {

// The row splits and the positions of a split of a scan of l candidate
// positions for nq queries on a card of `sms` multiprocessors.
void ivf_topk_plan(int l, int nq, int sms, int* plan) {
  int splits = 1, span = kGvTile;
  gv_plan(l, nq, sms, splits, span);
  plan[0] = splits;
  plan[1] = span;
}

// form 0 (exact, keyed), 1 (int8, keyed) or 2 (classic, one list). rows:
// the arena [n, d] (bf16 when is_bf16, else f32), or the shadow's codes [n,
// d] i8 with scale [n] f32 (form 1). members [c, m], extras [e] and cids
// [nq, p] i32. Keyed forms: alive / is_super [n] u8, row_tenant [n] i32,
// q_tenant [nq] i32 and nprobe_q [nq] i32 or null; classic: mask [n] u8.
// qry [nq, d] f32 (exact forms), or qq [nq, d] i8 and qs [nq] f32 (form
// 1). splits, span from ivf_topk_plan; kc = min(k, 256), gc = min(g, 256)
// (g = 0 in the classic form). Scratch: cand [splits, nq, kc] and gcand
// [splits, nq, gc] u64 keys. Outputs: out_s / out_p / out_r [nq, k] (f32
// scores, i32 candidate positions and rows) and gout_s / gout_p / gout_r
// [nq, g]. Every launch the card takes is counted into *launched. Returns
// the CUDA error of the launches (0 on success).
int ivf_topk(int form, const void* rows, int is_bf16, const float* scale, const int* members,
             const int* extras, const int* cids, const uint8_t* alive, const int* row_tenant,
             const uint8_t* is_super, const uint8_t* mask, const float* qry, const int8_t* qq,
             const float* qs, const int* q_tenant, const int* nprobe_q, int d, int nq, int m,
             int p, int e, int k, int g, int splits, int span, int kc, int gc,
             unsigned long long* cand, unsigned long long* gcand, float* out_s, int* out_p,
             int* out_r, float* gout_s, int* gout_p, int* gout_r, int* launched,
             void* stream) {
  GvArgs a{};
  a.rows = rows; a.scale = scale; a.members = members; a.extras = extras; a.cids = cids;
  a.alive = alive; a.row_tenant = row_tenant; a.is_super = is_super; a.mask = mask;
  a.qry = qry; a.qq = qq; a.qs = qs; a.q_tenant = q_tenant; a.nprobe_q = nprobe_q;
  a.d = d; a.nq = nq; a.m = m; a.p = p; a.e = e;
  a.l = (long long)p * m + e > INT32_MAX ? -1 : p * m + e;
  a.splits = splits; a.span = span; a.kc = kc; a.gc = gc;
  a.cand = reinterpret_cast<uint64_t*>(cand);
  a.gcand = reinterpret_cast<uint64_t*>(gcand);
  return run_gv(a, form, is_bf16, k, g, out_s, out_p, out_r, gout_s, gout_p, gout_r, launched,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
