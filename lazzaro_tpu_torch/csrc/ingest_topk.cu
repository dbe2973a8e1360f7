// The whole-arena scan of the fused ingest: the ingest mode of the templated
// scan in topk_scan.cuh (what it computes, how it is laid out and what
// bounds it are described there).
//
// Replaces the scan of lazzaro_tpu/core/state.py:_ingest_scan_core and
// _arena_link_candidates_multi, which the JAX package computes with nt_dot +
// lax.top_k in XLA: a dedup-probe top-1 and one link top-k per shard mode
// from one pass over the arena.

#include "topk_scan.cuh"

extern "C" {

// Row splits of a scan of n rows, nq queries of width d and `modes` lists of
// k on `route` (0: FMA, 1: tensor cores, 2: streaming): the leading
// dimension of the scratch.
int ingest_topk_splits(long long n, int nq, int d, int k, int modes, int route, int sms) {
  return ingest_splits(n, nq, d, k, modes, route, sms);
}

// emb [n, d] (bf16 when is_bf16, else f32), flags [n] u8 (bit 0 probe mask,
// bit 1 link mask), shard [n] i32; qry [nq, d] in the emb dtype, q_shard
// [nq] i32; modes (0 to 2) shard modes mode0, mode1 (1 same shard, -1 other
// shards, 0 any); with_probe takes the probe. Scratch: probe_c* [splits,
// nq], cand_* [modes, splits, nq, k]. Outputs: probe_s/probe_r [nq], out_s/
// out_r [modes, nq, k] (f32, i32 rows). route 1 (tensor cores) takes bf16
// only, routes 0 (FMA) and 2 (streaming: nq <= 16 whose values fit a lane's
// registers) f32 only. Needs d % 8 == 0, 16-byte aligned rows, 1 <= k <=
// min(128, n). Stage 1 and one stage 2 a mode (one when there is no
// mode), counted into *launched. Returns the CUDA error of the launches (0
// on success).
int ingest_topk(const void* emb, int is_bf16, const uint8_t* flags, const int* shard,
                const void* qry, const int* q_shard, long long n, int d, int nq, int k,
                int modes, int mode0, int mode1, int with_probe, int route, int splits,
                float* probe_cs, int* probe_cr, float* cand_s, int* cand_r, float* probe_s,
                int* probe_r, float* out_s, int* out_r, int* launched, void* stream) {
  IngestArgs a{};
  a.emb = emb; a.qry = qry; a.flags = flags; a.shard = shard; a.q_shard = q_shard;
  a.n = n; a.d = d; a.nq = nq; a.k = k; a.modes = modes; a.with_probe = with_probe;
  a.splits = splits; a.mode[0] = mode0; a.mode[1] = mode1;
  a.probe_cs = probe_cs; a.probe_cr = probe_cr; a.cand_s = cand_s; a.cand_r = cand_r;
  return run_ingest<kIngestBN>(a, is_bf16, route, probe_s, probe_r, out_s, out_r, launched,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
