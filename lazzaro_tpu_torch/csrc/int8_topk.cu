// The int8 coarse scan of quantized serving (K4): the int8 mode of the
// templated scan in topk_scan.cuh (what it computes, how it is laid out and
// what bounds it are described there).
//
// Replaces no TPU kernel: the JAX package computes this scan in XLA, in
// lazzaro_tpu/ops/quant.py:quantized_topk (the additive form, the classic
// int8 search) and the coarse stage of
// lazzaro_tpu/core/state.py:_quant_two_tier (the keyed form, the quantized
// fused serving program). Bound: the shadow's bytes, N * (d + 4) plus the
// row columns, read once (0.245 ms for 1,048,576 x 768 at 3.35 TB/s).

#include "topk_scan.cuh"

extern "C" {

// The plan of an int8 scan of n rows of d codes, nq queries, lists of k
// (and gate lists of g, keyed form; 0 otherwise) on a card with `sms`
// multiprocessors: plan[0] the route (0 tensor cores, 1 dp4a; `route` >= 0
// forces it, -1 picks by d), plan[1] the row splits, plan[2] and plan[3]
// the ANN and gate entries of one pass, plan[4] the queries of a
// tensor-core block and plan[5] the copies of each there (the scratch's
// shapes). Returns 0, or cudaErrorInvalidValue where the card takes no
// such scan.
int int8_topk_plan(long long n, int nq, int k, int g, int d, int sms, int route, int* plan) {
  I8Plan p{};
  if (!i8_plan(n, nq, k, g, d, sms, route, p)) return (int)cudaErrorInvalidValue;
  plan[0] = p.route;
  plan[1] = p.splits;
  plan[2] = p.kc;
  plan[3] = p.gc;
  plan[4] = p.qt;
  plan[5] = p.rep;
  return 0;
}

// codes [n, d] i8 (16-byte aligned), scale [n] f32; the additive form
// takes madd [n] f32 and null tenant columns, the keyed form row_tenant [n]
// i32, alive / is_super [n] u8, q_tenant [nq] i32 and g >= 1. qry [nq, d]
// f32 (quantized on the card). route, splits, kc, gc, qt and rep from
// int8_topk_plan. Scratch: qq [ceil(nq / qt) * 64, d] i8 and qsc [nq] f32
// (tensor-core route), cand [splits, nq, kc] and gcand [splits, nq, gc]
// u64 keys.
// Outputs: out_s / out_r [nq, k], gout_s / gout_r [nq, g] (f32, i32 rows).
// Every launch the card takes is counted into *launched. Returns the CUDA
// error of the launches (0 on success).
int int8_topk(const int8_t* codes, const float* scale, const float* madd,
              const int* row_tenant, const uint8_t* alive, const uint8_t* is_super,
              const float* qry, const int* q_tenant, long long n, int d, int nq, int k,
              int g, int route, int splits, int kc, int gc, int qt, int rep, int8_t* qq,
              float* qsc,
              unsigned long long* cand, unsigned long long* gcand, float* out_s, int* out_r,
              float* gout_s, int* gout_r, int* launched, void* stream) {
  I8Args a{};
  a.codes = codes; a.scale = scale; a.madd = madd;
  a.row_tenant = row_tenant; a.alive = alive; a.is_super = is_super;
  a.qry = qry; a.q_tenant = q_tenant; a.qq = qq; a.qsc = qsc;
  a.n = n; a.d = d; a.nq = nq; a.k = k; a.g = g; a.splits = splits; a.kc = kc; a.gc = gc;
  a.qt = qt;
  a.rep = rep;
  a.cand = reinterpret_cast<uint64_t*>(cand);
  a.gcand = reinterpret_cast<uint64_t*>(gcand);
  return run_i8(a, route, out_s, out_r, gout_s, gout_r, launched,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
