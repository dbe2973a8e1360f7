// Masked cosine top-k over the embedding arena: the additive mode of the
// templated scan in topk_scan.cuh (what it computes, how it is laid out and
// what bounds it are described there).
//
// Replaces the TPU kernels lazzaro_tpu/ops/pallas_topk.py:pallas_masked_topk
// (body _topk_block_kernel) and pallas_masked_topk_ragged, with their arena
// wrappers masked_topk_arena and masked_topk_arena_ragged.

#include "topk_scan.cuh"

extern "C" {

// Row splits of stage 1 for `route` (0: FMA, 1: tensor cores): the leading
// dimension of the scratch.
int masked_topk_splits(long long n, int nq, int k, int route, int sms) {
  return scan_splits(n, nq, k, route, sms);
}

// Additive mode. emb [n, d] (bf16 when is_bf16, else f32), madd [n] f32, qry
// [nq, d] in the emb dtype; k_q [nq] i32 or null; cand_* [splits, nq,
// min(k, 128)]; out_s [nq, k] f32, out_r [nq, k] i64. route 0 runs the FMA
// stage 1, route 1 the tensor-core one (bf16 only; 16-byte aligned emb and
// qry). Needs d % 8 == 0, 16-byte aligned rows, 1 <= k <= n. Returns the
// CUDA error of the launches (0 on success).
int masked_topk_ragged(const void* emb, int is_bf16, const float* madd,
                       const void* qry, long long n, int d, int nq, int k,
                       const int* k_q, long long tail_row, int route,
                       int splits, float* cand_s, int* cand_r, float* out_s,
                       long long* out_r, void* stream) {
  Scan<false> a{};
  a.emb = emb; a.is_bf16 = is_bf16; a.madd = madd; a.qry = qry; a.k_q = k_q;
  a.n = n; a.d = d; a.nq = nq; a.k_out = k; a.kmax = k; a.splits = splits;
  a.tail_row = tail_row;
  a.cand_s = cand_s; a.cand_r = cand_r; a.out_s = out_s; a.out_r = out_r;
  return run_scan(a, route, static_cast<cudaStream_t>(stream));
}

// The classic form on the FMA route: every position live.
int masked_topk(const void* emb, int is_bf16, const float* madd,
                const void* qry, long long n, int d, int nq, int k,
                int splits, float* cand_s, int* cand_r, float* out_s,
                long long* out_r, void* stream) {
  return masked_topk_ragged(emb, is_bf16, madd, qry, n, d, nq, k, nullptr, -1,
                            kRouteFma, splits, cand_s, cand_r, out_s, out_r,
                            stream);
}

}  // extern "C"
