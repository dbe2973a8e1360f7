// Cross-shard merge of per-shard top-k candidate lists, for Hopper (sm_90a):
// the combine of the row-sharded top-k.
//
// Replaces the cross-chip half of the TPU kernel
// lazzaro_tpu/ops/topk.py:make_sharded_topk (:115): its all_gather + global
// lax.top_k, sharded_topk_merge (:47), together with the row globalization of
// :165 and of lazzaro_tpu/core/state.py:_globalize_rows. Each shard's scan
// (the masked top-k kernel, or the two-tier kernel on the fused path) runs on
// its own rows first; this kernel merges what they found.
//
// What it computes. Shard p of n holds the arena rows [p*L, (p+1)*L) and
// handed in a list of kl candidates per query, (score f32, local row i32 or
// i64), ordered as the scans and lax.top_k order them: score descending,
// ties to the lower row. For each query the output is the top k of the n*kl
// candidates taken shard-major, i.e. ties to the lower shard and then to the
// earlier list position, which is global-row order, as lax.top_k orders the
// shard-major all_gather. Scores compare in the total order of
// ops.topk.stable_topk (the f32 bits mapped to an order-preserving int).
// Rows come out global, local + p*L; with mask_dead, an entry scoring <=
// -1e30/2 (a masked row) becomes `sentinel` instead. With k_q [nq] i32, the
// positions >= k_q[q] come out as (-1e30, sentinel).
//
// Design: one thread per candidate, no loop over the output and no atomics.
// A candidate's output position is its index in its own list plus, for each
// other shard, a binary search in that shard's sorted list counting the
// entries that rank before it (>= its key for a lower shard, > for a higher
// one). The positions of all candidates are a permutation of [0, n*kl), so
// with k <= n*kl every output position is written exactly once, and the
// result is deterministic. The lists are read where the scans wrote them:
// their device pointers ride in the kernel's parameters.
//
// What bounds it on an H100: the bytes are n*Q*kl*8 read and Q*k*8 written,
// under a microsecond at 3.35 TB/s for every shape of the serving and ingest
// paths (at most 8 x 8,192 x 3 candidates), so a call is bound by its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

struct Lists {
  const float* s[kMaxShards];
  const void* r[kMaxShards];
};

// The order-preserving int of an f32 (ops.topk.stable_topk's key).
__device__ __forceinline__ int key_of(float x) {
  int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// Entries of a list (non-increasing keys) that rank before key kk: those
// with a key > kk, or >= kk when or_equal.
__device__ __forceinline__ int count_before(const float* s, int kl, int kk,
                                            bool or_equal) {
  int lo = 0, hi = kl;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    int km = key_of(s[mid]);
    if (or_equal ? km >= kk : km > kk) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(Lists lists, int rows_i64, int n, int nq, int kl, int k,
             long long local_n, const int* __restrict__ k_q, int mask_dead,
             int sentinel, float* __restrict__ out_s, int* __restrict__ out_r) {
  long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long per_shard = (long long)nq * kl;
  if (t >= per_shard * n) return;
  int p = (int)(t / per_shard);
  long long off = t - p * per_shard;       // q * kl + j
  int q = (int)(off / kl);
  int j = (int)(off - (long long)q * kl);
  float s = lists.s[p][off];
  int kk = key_of(s);
  int pos = j;
  for (int o = 0; o < n && pos < k; ++o) {
    if (o != p) pos += count_before(lists.s[o] + (long long)q * kl, kl, kk, o < p);
  }
  if (pos >= k) return;
  long long local = rows_i64 ? static_cast<const long long*>(lists.r[p])[off]
                             : (long long)static_cast<const int*>(lists.r[p])[off];
  int row = (mask_dead && s <= kNeg / 2) ? sentinel : (int)(local + p * local_n);
  if (k_q != nullptr && pos >= k_q[q]) {
    s = kNeg;
    row = sentinel;
  }
  out_s[(long long)q * k + pos] = s;
  out_r[(long long)q * k + pos] = row;
}

}  // namespace

extern "C" {

int sharded_merge_max_shards() { return kMaxShards; }

// s_ptrs / r_ptrs: host arrays of n device pointers to the shards' lists,
// [nq, kl] f32 scores and local rows (i64 when rows_i64, else i32), each
// score-descending with ties to the lower row. k_q [nq] i32 or null. out_s
// [nq, k] f32, out_r [nq, k] i32. Needs 1 <= n <= 64 and 1 <= k <= n*kl.
// Returns the CUDA error of the launch (0 on success).
int sharded_merge(const float* const* s_ptrs, const void* const* r_ptrs,
                  int rows_i64, int n, int nq, int kl, int k,
                  long long local_n, const int* k_q, int mask_dead,
                  int sentinel, float* out_s, int* out_r, void* stream) {
  if (n < 1 || n > kMaxShards || kl < 1 || k < 1 || k > (long long)n * kl)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  Lists lists{};
  for (int p = 0; p < n; ++p) {
    lists.s[p] = s_ptrs[p];
    lists.r[p] = r_ptrs[p];
  }
  long long total = (long long)n * nq * kl;
  unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  merge_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lists, rows_i64, n, nq, kl, k, local_n, k_q, mask_dead, sentinel, out_s,
      out_r);
  return (int)cudaGetLastError();
}

}  // extern "C"
