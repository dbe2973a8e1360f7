// Masked cosine top-k over the embedding arena: the additive mode of the
// templated scan in topk_scan.cuh (what it computes, how it is laid out and
// what bounds it are described there).
//
// Replaces the TPU kernels lazzaro_tpu/ops/pallas_topk.py:pallas_masked_topk
// (body _topk_block_kernel) and pallas_masked_topk_ragged, with their arena
// wrappers masked_topk_arena and masked_topk_arena_ragged (a table of one
// arena), and the per-shard scans of lazzaro_tpu/ops/topk.py:make_sharded_topk
// with their merge when the shards share a card.

#include "topk_scan.cuh"

extern "C" {

// Row splits of each of `shards` arenas of n rows for `route` (0: FMA, 1:
// tensor cores, 2: streaming): shards times this is the leading dimension
// of the scratch.
int masked_topk_splits(long long n, int shards, int nq, int k, int route, int sms, int d) {
  return scan_splits<false>(n, shards, nq, k, route, sms, d);
}

// Additive mode over a table of `shards` arenas: embs[p] [n, d] (bf16 when
// is_bf16, else f32) whose rows are global rows bases[p] ..; madds[p] [n]
// f32. qry [nq, d] in the emb dtype; k_q [nq] i32 or null; cand_* [shards *
// splits, nq, min(k, 128)]; out_s [nq, k] f32, out_r [nq, k] i64 (global
// rows). route 0 runs the FMA stage 1, 1 the tensor-core one (bf16 only), 2
// the streaming one (f32, nq <= 16); every route needs 16-byte aligned arenas
// and queries. Needs d % 8 == 0, 1 <= k <= shards * n, 1 <= shards <= 64.
// Two launches a pass of 128 list entries, counted into *launched. Returns
// the CUDA error of the launches (0 on success).
int masked_topk_grouped(const void* const* embs, const float* const* madds,
                        const long long* bases, int shards, int is_bf16, const void* qry,
                        long long n, int d, int nq, int k, const int* k_q,
                        long long tail_row, int route, int splits, float* cand_s,
                        int* cand_r, float* out_s, long long* out_r, int* launched,
                        void* stream) {
  if (shards < 1 || shards > kMaxShards) return (int)cudaErrorInvalidValue;
  Scan<false> a{};
  for (int p = 0; p < shards; ++p) {
    a.t.emb[p] = embs[p];
    a.t.words[p] = madds[p];
    a.t.base[p] = bases[p];
  }
  a.shards = shards; a.is_bf16 = is_bf16; a.qry = qry; a.k_q = k_q;
  a.n = n; a.d = d; a.nq = nq; a.k_out = k; a.kmax = k; a.splits = splits;
  a.tail_row = tail_row;
  a.cand_s = cand_s; a.cand_r = cand_r; a.out_s = out_s; a.out_r = out_r;
  return run_scan(a, route, launched, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
