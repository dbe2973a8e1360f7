// The sequential duplicate resolve of the fused dedup ingest, for Hopper.
//
// Replaces the lax.scan of lazzaro_tpu/core/state.py:_dedup_resolve (XLA; no
// Pallas kernel). For facts i = 0 .. b - 1 in order, from the intra-batch
// gram's best earlier fact (g_s, g_j) and the arena probe's top-1 (p_s, p_r):
//     use_g     = g_s[i] > p_s[i]
//     best      = use_g ? (g_s[i], target[g_j[i]]) : (p_s[i], p_r[i])
//     dup[i]    = valid[i] && best score > gate
//     target[i] = dup[i] ? best row : rows[i]       (a dup of a dup chains)
//     chain_src[i] = the last live fact of group chain_gid[i] before i, or
//                    -1 (a dup in the middle bridges its neighbours)
// in f32, as the JAX scan compares. chain_gid < b (densified), -1 padding.
//
// Design: the scan is sequential (target[i] may read target[g_j[i]] of any
// earlier i), so one thread walks it; what bounds it is the latency of its
// dependent steps, a few shared-memory accesses each. The block stages the
// inputs in chunks of kChunk facts in shared memory, and keeps target and
// last[gid] there when 8 b bytes fit (b <= ~25,000; the fused ingest's
// mega-batch is at most ingest_coalesce_max = 8,192), else in global memory
// (the target output and the caller's scratch). One launch a batch, in
// place of b steps of separate device ops or a second readback to the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;           // facts staged at a time
constexpr int kStaged = 7;             // staged input columns
constexpr int kSmemMax = 232448;

__global__ void __launch_bounds__(kThreads)
dedup_resolve_kernel(const float* __restrict__ g_s, const int* __restrict__ g_j,
                     const float* __restrict__ p_s, const int* __restrict__ p_r,
                     const uint8_t* __restrict__ valid, const int* __restrict__ rows,
                     const int* __restrict__ chain_gid, int b, int cap, float gate,
                     int in_smem, int* target, int* __restrict__ dup,
                     int* __restrict__ chain_src, int* last_scratch) {
  extern __shared__ int smem[];
  float* cgs = reinterpret_cast<float*>(smem);
  int* cgj = smem + kChunk;
  float* cps = reinterpret_cast<float*>(smem + 2 * kChunk);
  int* cpr = smem + 3 * kChunk;
  int* cval = smem + 4 * kChunk;
  int* crow = smem + 5 * kChunk;
  int* cgid = smem + 6 * kChunk;
  int* tgt = in_smem ? smem + kStaged * kChunk : target;
  int* last = in_smem ? tgt + b : last_scratch;
  for (int i = threadIdx.x; i < b; i += kThreads) {
    tgt[i] = cap;
    last[i] = -1;
  }
  for (int c0 = 0; c0 < b; c0 += kChunk) {
    const int n = min(kChunk, b - c0);
    __syncthreads();                   // the previous chunk's walk is done
    for (int j = threadIdx.x; j < n; j += kThreads) {
      cgs[j] = g_s[c0 + j];
      cgj[j] = g_j[c0 + j];
      cps[j] = p_s[c0 + j];
      cpr[j] = p_r[c0 + j];
      cval[j] = valid[c0 + j];
      crow[j] = rows[c0 + j];
      cgid[j] = chain_gid[c0 + j];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n; ++j) {
        const int i = c0 + j;
        const bool use_g = cgs[j] > cps[j];
        const float best_s = use_g ? cgs[j] : cps[j];
        const int best_t = use_g ? tgt[cgj[j]] : cpr[j];
        const bool is_dup = cval[j] && best_s > gate;
        tgt[i] = is_dup ? best_t : crow[j];
        dup[i] = is_dup;
        const bool live = cval[j] && !is_dup;
        const int gid = max(cgid[j], 0);
        const int prev = cgid[j] >= 0 ? last[gid] : -1;
        chain_src[i] = live && prev >= 0 ? prev : -1;
        if (live) last[gid] = crow[j];
      }
    }
  }
  __syncthreads();
  if (in_smem)
    for (int i = threadIdx.x; i < b; i += kThreads) target[i] = tgt[i];
}

}  // namespace

extern "C" {

// One batch of b facts: g_s/p_s [b] f32, g_j/p_r/rows/chain_gid [b] i32,
// valid [b] u8; outputs target/dup/chain_src [b] i32; last_scratch [b] i32
// (used when target and last do not fit shared memory). One launch on
// `stream`; returns its CUDA error (0 on success).
int dedup_resolve(const float* g_s, const int* g_j, const float* p_s, const int* p_r,
                  const uint8_t* valid, const int* rows, const int* chain_gid, int b, int cap,
                  float gate, int* target, int* dup, int* chain_src, int* last_scratch,
                  void* stream) {
  if (b < 1) return (int)cudaErrorInvalidValue;
  const size_t staged = (size_t)kStaged * kChunk * sizeof(int);
  const size_t whole = staged + 2 * (size_t)b * sizeof(int);
  const int in_smem = whole <= (size_t)kSmemMax;
  const size_t smem = in_smem ? whole : staged;
  cudaError_t err = cudaFuncSetAttribute(
      dedup_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dedup_resolve_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g_s, g_j, p_s, p_r, valid, rows, chain_gid, b, cap, gate, in_smem, target, dup,
      chain_src, last_scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
