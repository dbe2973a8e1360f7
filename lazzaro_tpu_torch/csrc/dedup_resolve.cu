// The duplicate resolve of the fused dedup ingest, for Hopper.
//
// Replaces lazzaro_tpu/core/state.py:_dedup_resolve after its gram product
// (XLA: a masked arg-max, a gather and a lax.scan; no Pallas kernel). From
// the f32 gram of a batch of b facts, the arena probe's top-1 (p_s, p_r),
// the facts' validity, rows and shard groups chain_gid (densified, < b, -1
// padding):
//     (g_s[i], g_j[i]) = the largest gram[i, j] over j < i with valid[j],
//                        the first column on ties; (NEG_INF, 0) if none
//     use_g     = g_s[i] > p_s[i]
//     best      = use_g ? (g_s[i], target[g_j[i]]) : (p_s[i], p_r[i])
//     dup[i]    = valid[i] && best score > gate
//     target[i] = dup[i] ? best row : rows[i]       (a dup of a dup chains)
//     chain_src[i] = the row of the last live fact of group
//                    max(chain_gid[i], 0) before i, or -1 (a live fact of
//                    group -1 moves group 0's last and gets -1 itself)
// in f32, as the JAX scan compares: the result equals the plain loop's bit
// for bit, on any finite input.
//
// Design. One C entry, two forms. The gram form launches stage A, then
// stage B; the walk form takes (g_s, g_j) and launches stage B alone.
//
// Stage A (resolve_gram_argmax) is the only part that moves bytes: it reads
// the strict lower triangle of the gram once (b (b - 1) / 2 floats, 134 MB
// at b = 8,192) and nothing above it. A warp takes rows i and b - 1 - i,
// b - 1 columns in all, so every warp streams the same amount; its lanes
// read 16-byte vectors, four in flight, from the first 16-byte boundary of
// the row (a row of an unaligned b starts with up to three single loads),
// and fold (value, column) with a strict compare and the lower column on
// ties, then across the warp by shuffles. Its bound is the HBM rate.
//
// Stage B (resolve_walk) is one block of 1,024 threads. The scan is
// sequential only on its face:
//   - dup[i] depends on fact i alone, so the verdicts are elementwise;
//   - target[i] follows g_j[i] < i where it follows anything, so the
//     targets form a forest whose roots hold their value (rows[i], p_r[i],
//     or cap for a gram duplicate whose g_j[i] >= i: the loop reads a
//     target not yet written there); rounds of pointer jumping, double
//     buffered, resolve it in ceil(log2 depth) + 1 rounds (13 + 1 for a
//     chain of 8,191 duplicates), ending when no pointer moves;
//   - chain_src[i] is the predecessor of i among the live facts of its
//     group: per tile of 8,192 facts, a block radix sort (cub, stable) of
//     the live facts by group puts each one after its predecessor in the
//     tile, the first of a group in the tile reads the group's last row of
//     the tiles before, and the last of each group then writes it.
// Pointers, root values, chain keys and the group table (20 bytes a fact)
// live in shared memory while they fit beside the sort's storage (b up to
// ~9,700, which holds the fused ingest's mega-batch, ingest_coalesce_max =
// 8,192), else in the caller's global scratch. Its time is latency, not
// bytes: one block on one SM, reading its columns four facts at a time,
// a barrier per pointer round, a few per tile and per 4-bit pass of the
// sort. The C entry counts the launches the card took; the wrapper's
// launches counts calls.

#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;        // NEG_INF of the masked gram
constexpr int kRowWarps = 8;             // row pairs a block of stage A
constexpr int kInFlight = 4;             // 16-byte loads a lane keeps in flight
constexpr int kWalkThreads = 1024;
constexpr int kPerThread = 8;
constexpr int kTile = kWalkThreads * kPerThread;   // facts a chain sort takes
constexpr int kSmemMax = 232448;
constexpr int kNotLive = -1;             // chain key of a fact that is not live
constexpr int kGroupless = -2;           // of a live fact of group -1 (sorts as 0)

using ChainSort = cub::BlockRadixSort<unsigned, kWalkThreads, kPerThread, int>;

// (v, j) replaces (bv, bj) if it is larger, or equal at a lower column:
// torch.argmax's first maximum.
__device__ __forceinline__ void take(float v, int j, float& bv, int& bj) {
  if (v > bv || (v == bv && j < bj)) {
    bv = v;
    bj = j;
  }
}

__device__ __forceinline__ float masked(float x, const uint8_t* __restrict__ valid, int j) {
  return valid[j] ? x : kNegInf;
}

// One lane's arg-max over columns [0, n) of a gram row.
__device__ __forceinline__ void scan_row(const float* __restrict__ row,
                                         const uint8_t* __restrict__ valid, int n, int lane,
                                         float& bv, int& bj) {
  const int off = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const int head = min((4 - off) & 3, n);
  if (lane < head) take(masked(__ldcs(row + lane), valid, lane), lane, bv, bj);
  const float4* body = reinterpret_cast<const float4*>(row + head);
  const int nv = (n - head) >> 2;
  for (int v0 = lane; v0 < nv; v0 += 32 * kInFlight) {
    float4 x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      x[u] = v0 + 32 * u < nv ? __ldcs(body + v0 + 32 * u) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int j = head + 4 * (v0 + 32 * u);
      if (v0 + 32 * u < nv) {
        take(masked(x[u].x, valid, j), j, bv, bj);
        take(masked(x[u].y, valid, j + 1), j + 1, bv, bj);
        take(masked(x[u].z, valid, j + 2), j + 2, bv, bj);
        take(masked(x[u].w, valid, j + 3), j + 3, bv, bj);
      }
    }
  }
  const int t = head + 4 * nv + lane;
  if (t < n) take(masked(__ldcs(row + t), valid, t), t, bv, bj);
}

__global__ void __launch_bounds__(kRowWarps * 32)
resolve_gram_argmax(const float* __restrict__ gram, const uint8_t* __restrict__ valid, int b,
                    float* __restrict__ g_s, int* __restrict__ g_j) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (w >= (b + 1) / 2) return;
  for (int p = 0; p < 2; ++p) {
    const int r = p ? b - 1 - w : w;
    if (p && r == w) break;
    float bv = -INFINITY;
    int bj = INT_MAX;
    scan_row(gram + (size_t)r * b, valid, r, lane, bv, bj);
#pragma unroll
    for (int s = 16; s; s >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, s);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, s);
      take(ov, oj, bv, bj);
    }
    // Columns r .. b - 1 are masked to NEG_INF: the first of them is r.
    take(kNegInf, r, bv, bj);
    if (lane == 0) {
      g_s[r] = bv;
      g_j[r] = bj;
    }
  }
}

__global__ void __launch_bounds__(kWalkThreads, 1)
resolve_walk(const float* __restrict__ g_s, const int* __restrict__ g_j,
             const float* __restrict__ p_s, const int* __restrict__ p_r,
             const uint8_t* __restrict__ valid, const int* __restrict__ rows,
             const int* __restrict__ chain_gid, int b, int cap, float gate, int in_smem,
             int* __restrict__ target, uint8_t* __restrict__ dup, int* __restrict__ chain_src,
             int* scratch) {
  extern __shared__ int smem[];
  __shared__ typename ChainSort::TempStorage sort_tmp;
  __shared__ unsigned warp_first[kWalkThreads / 32];   // a warp's first sorted key
  __shared__ unsigned warp_last[kWalkThreads / 32];    // its last key
  __shared__ int warp_last_pos[kWalkThreads / 32];     // and that fact's position
  __shared__ int tile_top;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* ptr = in_smem ? smem : scratch;
  int* ptr2 = ptr + b;
  int* val = ptr + 2 * b;              // a root's target (a live fact's row)
  int* key = ptr + 3 * b;              // a fact's chain key
  int* last = ptr + 4 * b;             // a group's last live row

  // Verdicts, the forest of targets and the chain keys, elementwise.
#pragma unroll 4
  for (int i = tid; i < b; i += kWalkThreads) {
    const float gs = g_s[i], ps = p_s[i];
    const int gj = g_j[i], row = rows[i], pr = p_r[i], gid = chain_gid[i];
    const bool ok = valid[i] != 0;
    const bool use_g = gs > ps;
    const bool is_dup = ok && (use_g ? gs : ps) > gate;
    dup[i] = is_dup;
    chain_src[i] = -1;
    ptr[i] = is_dup && use_g && gj >= 0 && gj < i ? gj : i;
    val[i] = !is_dup ? row : use_g ? cap : pr;
    key[i] = !ok || is_dup ? kNotLive : gid >= 0 ? gid : kGroupless;
    last[i] = -1;
  }
  __syncthreads();
  for (;;) {
    int moved = 0;
    for (int i = tid; i < b; i += kWalkThreads) {
      const int p = ptr[i], pp = ptr[p];
      ptr2[i] = pp;
      moved |= pp != p;
    }
    int* t = ptr;
    ptr = ptr2;
    ptr2 = t;
    if (!__syncthreads_or(moved)) break;
  }
  for (int i = tid; i < b; i += kWalkThreads) target[i] = val[ptr[i]];

  // Chain predecessors, a tile at a time.
  for (int t0 = 0; t0 < b; t0 += kTile) {
    if (tid == 0) tile_top = -1;
    __syncthreads();
    unsigned skey[kPerThread];
    int pos[kPerThread];
    int top = -1;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = t0 + tid * kPerThread + q;
      const int k = i < b && key[i] != kNotLive ? max(key[i], 0) : -1;
      skey[q] = (unsigned)k;
      pos[q] = i;
      top = max(top, k);
    }
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0) atomicMax(&tile_top, top);
    __syncthreads();
    top = tile_top;
    __syncthreads();                                   // read before the next reset
    if (top < 0) continue;                             // no live fact in the tile
    const unsigned none = (unsigned)top + 1;           // the key of a fact not live
#pragma unroll
    for (int q = 0; q < kPerThread; ++q)
      if (skey[q] == 0xffffffffu) skey[q] = none;
    ChainSort(sort_tmp).Sort(skey, pos, 0, 32 - __clz(none));
    // The sorted neighbours across threads: by shuffles inside a warp,
    // through shared memory across warps.
    unsigned pk = __shfl_up_sync(0xffffffffu, skey[kPerThread - 1], 1);
    int pp = __shfl_up_sync(0xffffffffu, pos[kPerThread - 1], 1);
    unsigned nk = __shfl_down_sync(0xffffffffu, skey[0], 1);
    if (lane == 0) warp_first[warp] = skey[0];
    if (lane == 31) {
      warp_last[warp] = skey[kPerThread - 1];
      warp_last_pos[warp] = pos[kPerThread - 1];
    }
    __syncthreads();
    if (lane == 0) {
      pk = warp ? warp_last[warp - 1] : none;
      pp = warp ? warp_last_pos[warp - 1] : 0;
    }
    if (lane == 31) nk = warp + 1 < kWalkThreads / 32 ? warp_first[warp + 1] : none;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const unsigned k = skey[q];
      if (k == none) continue;
      const unsigned kp = q ? skey[q - 1] : pk;
      const int prev = kp == k ? val[q ? pos[q - 1] : pp] : k < (unsigned)b ? last[k] : -1;
      const int i = pos[q];
      if (key[i] >= 0 && prev >= 0) chain_src[i] = prev;
    }
    __syncthreads();                                   // every read of last is done
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const unsigned k = skey[q];
      const unsigned kn = q + 1 < kPerThread ? skey[q + 1] : nk;
      if (k != none && k < (unsigned)b && kn != k) last[k] = val[pos[q]];
    }
    __syncthreads();
  }
}

int walk_smem_static = -1;               // resolve_walk's static shared bytes

}  // namespace

extern "C" {

// One batch of b facts. The gram form: gram [b, b] f32 (row-major) and
// g_s/g_j null; stage A writes the arg-max into gram_s [b] f32 / gram_j
// [b] i32. The walk form: gram null, g_s [b] f32 and g_j [b] i32 given.
// p_s [b] f32, p_r/rows/chain_gid [b] i32, valid [b] u8 (nonzero: valid);
// outputs target/chain_src [b] i32, dup [b] u8 (0 or 1); scratch [5 b] i32
// (read when the walk's tables do not fit shared memory). The launches on
// `stream` that the card took are counted into *launched. Returns the
// first CUDA error (0 on success).
int dedup_resolve(const float* gram, const float* g_s, const int* g_j, const float* p_s,
                  const int* p_r, const uint8_t* valid, const int* rows, const int* chain_gid,
                  int b, int cap, float gate, float* gram_s, int* gram_j, int* target,
                  uint8_t* dup, int* chain_src, int* scratch, int* launched, void* stream) {
  if (b < 1 || (gram == nullptr) == (g_s == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (walk_smem_static < 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, resolve_walk);
    if (err != cudaSuccess) return (int)err;
    walk_smem_static = (int)attr.sharedSizeBytes;
  }
  const size_t tables = 5 * (size_t)b * sizeof(int);
  const int in_smem = walk_smem_static + tables <= (size_t)kSmemMax;
  const int dyn = in_smem ? (int)tables : 0;
  err = cudaFuncSetAttribute(resolve_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  if (gram != nullptr) {
    const int warps = (b + 1) / 2;
    resolve_gram_argmax<<<(warps + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, st>>>(
        gram, valid, b, gram_s, gram_j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
    g_s = gram_s;
    g_j = gram_j;
  }
  resolve_walk<<<1, kWalkThreads, dyn, st>>>(g_s, g_j, p_s, p_r, valid, rows, chain_gid, b, cap,
                                            gate, in_smem, target, dup, chain_src, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}

}  // extern "C"
