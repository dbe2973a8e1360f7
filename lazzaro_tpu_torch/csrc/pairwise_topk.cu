// The all-pairs merge scan of run_consolidation: the pairwise mode of the
// templated scan in topk_scan.cuh (what it computes, how it is laid out and
// what bounds it are described there).
//
// Replaces lazzaro_tpu/ops/graphops.py:pairwise_merge_candidates, which the
// JAX package computes with chunked nt_dot + where + lax.top_k in XLA: for
// every row of a mask, its k best later rows of the mask above a threshold.

#include "topk_scan.cuh"

extern "C" {

// emb_c [n, d] (bf16 when is_bf16, else f32): the mask's rows gathered in
// ascending order, *n_live (on the device) of them live; mask [n] u8 over
// the arena rows, pos [n] i32 each row's place in the gather, comp [n] i32
// the arena row of each place. Scratch: keys [n, k] u64. Outputs: out_s /
// out_r [n, k] (f32, i32 arena rows; (-1e30, -1) past a row's list). route
// 1 (tensor cores) takes bf16 only, route 0 (FMA) f32 only. Needs d % 8 ==
// 0, 16-byte aligned rows, 1 <= k <= 8. Stage 1 and the decode, counted
// into *launched. Returns the CUDA error of the launches (0 on success).
int pairwise_topk(const void* emb_c, int is_bf16, const int* n_live, const uint8_t* mask,
                  const int* pos, const int* comp, long long n, int d, float threshold, int k,
                  int route, unsigned long long* keys, float* out_s, int* out_r, int* launched,
                  void* stream) {
  PairArgs a{};
  a.emb = emb_c; a.n_live = n_live; a.n_rows = n; a.d = d; a.k = k; a.thr = threshold;
  a.keys = keys;
  return run_pairwise(a, is_bf16, route, mask, pos, comp, out_s, out_r, launched,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
