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

// Row splits of an int8 scan of n rows, nq queries, lists of k (and gate
// lists of g, keyed form; 0 otherwise): the leading dimension of the
// scratch.
int int8_topk_splits(long long n, int nq, int k, int g, int d, int sms) {
  return i8_splits(n, nq, k, g, d, sms);
}

// codes [n, d] i8 (8-byte aligned rows), scale [n] f32; the additive form
// takes madd [n] f32 and null tenant columns, the keyed form row_tenant [n]
// i32, alive / is_super [n] u8, q_tenant [nq] i32 and g >= 1. qry [nq, d]
// f32 (quantized in the kernel). Scratch: cand_* [splits, nq, k], gcand_*
// [splits, nq, g]. Outputs: out_s / out_r [nq, k], gout_s / gout_r [nq, g]
// (f32, i32 rows). Needs d % 8 == 0, d <= 1,040, 1 <= k <= min(n, 256),
// g <= min(n, 256). Stage 1 and a stage 2 a list, counted into *launched.
// Returns the CUDA error of the launches (0 on success).
int int8_topk(const int8_t* codes, const float* scale, const float* madd,
              const int* row_tenant, const uint8_t* alive, const uint8_t* is_super,
              const float* qry, const int* q_tenant, long long n, int d, int nq, int k,
              int g, int splits, float* cand_s, int* cand_r, float* gcand_s, int* gcand_r,
              float* out_s, int* out_r, float* gout_s, int* gout_r, int* launched,
              void* stream) {
  I8Args a{};
  a.codes = codes; a.scale = scale; a.madd = madd;
  a.row_tenant = row_tenant; a.alive = alive; a.is_super = is_super;
  a.qry = qry; a.q_tenant = q_tenant;
  a.n = n; a.d = d; a.nq = nq; a.k = k; a.g = g; a.splits = splits;
  a.cand_s = cand_s; a.cand_r = cand_r; a.gcand_s = gcand_s; a.gcand_r = gcand_r;
  return run_i8(a, out_s, out_r, gout_s, gout_r, launched,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
