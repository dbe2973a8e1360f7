// The IVF candidate scan (K5), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this scan in XLA, as a
// gather of the candidate rows into a [Q, L, d] tensor and an einsum, then
// lax.top_k, in lazzaro_tpu/core/state.py:_ivf_two_tier (the fused IVF
// serving programs: the exact form and the int8 form's gathered coarse
// scan) and lazzaro_tpu/ops/ivf.py:ivf_search (the classic one-list form).
// Neither the [Q, L] candidate rows nor the [Q, L, d] gathered vectors
// reach device memory: a block reads the member table through the query's
// cluster ids itself and loads a row only for a valid slot.
//
// Candidates. With cids [Q, P] a query's P nearest clusters (the coarse
// stage, a masked top-k over the centroid table), members [C, M] and
// extras [E] (i32, -1 padded), query q's L = P * M + E candidate positions
// are the member slots of its clusters in rank order, then the extras:
//     cand[q, j] = members[cids[q, j / M], j % M]   for j < P * M,
//                  extras[j - P * M]                 otherwise.
// Candidate j is valid when cand >= 0 and
//   keyed forms: alive[cand] & row_tenant[cand] == q_tenant[q], and for a
//                member slot j / M < nprobe_q[q] (when given);
//   classic form: mask[cand] (the [N] alive-and-tenant mask).
// Scores:
//   exact forms: s = dot_f32(qry[q], row[cand]), qry the f32 values the
//                caller scores (the query cast to the arena dtype and back
//                in the fused form, the f32 query in the classic form);
//   int8 form:   s = (float(dot_i32(qq[q], codes[cand])) * qs[q]) *
//                scale[cand] (K4's score, exact whatever the order).
// Lists, each over all L positions, a position outside the list's tier
// scoring exactly NEG (jnp.where):
//   keyed forms: ann[q, :k] over valid & ~is_super, gate[q, :g] over valid &
//                is_super (g = 1 exact, 1 + slack int8);
//   classic:     one list over valid.
// Order: score descending, ties to the lower POSITION (lax.top_k over the
// [Q, L] tile), so a list with fewer valid candidates than its length
// fills with the lowest other positions at NEG. The outputs are scores,
// positions and the candidate rows there (whatever cand holds: -1
// padding, another tenant's row).
//
// Occupancy. occ [C] i32 (or null: every cluster M) and e_live: every
// member slot at or past occ[c] and every extra at or past e_live holds -1
// (a build fills each cluster's first slots, the online ingest appends at
// the cluster's cursor, a repack moves holes behind the live rows; the
// extras are packed rows first). So only the query's occupied positions,
// slots [r M, r M + occ[cids[q, r]]) of each rank r < nprobe_q[q], then
// extras [P M, P M + e_live), can hold a valid candidate; keys keep the
// positions above, so ties and outputs stay lax.top_k's.
//
// Design.
// Stage 1 (gv_stage1): grid (splits, queries), 8 warps a block. A block
// builds its query's prefix sums of occupancy over its probed ranks in
// shared memory and takes an even share of the query's occupied positions
// (their count exists only on the device: the host plans the splits from
// the tables' shape, and any plan is correct). Each warp walks groups of 32
// occupied positions (groups warp, warp + 8, ...), one position a lane:
// its slot read, then its row's columns; a ballot compacts the valid slots.
// The warp works ahead of the group it scores: the slot reads of group
// g + 3 and the column reads of g + 2 are in flight while it scores g, and
// g + 1 is compacted. Valid rows come into a ring of row slots a warp by
// 16-byte cp.async, a cp.async group a row, issued ahead across rows and
// into the next group (10 KB a warp, two blocks an SM). Up to four rows are
// summed side by side; each lane adds its chunks' products in
// column order, each product rounded before it is added (__fmul_rn, never
// a fused multiply-add), then a butterfly across the warp: the order of
// ops/ivf_topk.py:lane_dot. The int8 form sums __dp4a words (exact in any
// order). A valid row's key (list_key over the position) above the warp's
// list threshold joins the warp's batch; at the end of a group the warp
// merges its batch into its own sorted list (merge_batch) while its next
// rows are in flight and the other warps score. At the end the block
// merges the 8 warps' lists pairwise in three rounds and writes its list
// with the row at each key's position. Only valid candidates make keys.
// Stage 2 (gv_select): a block a (query, list) merges the splits' lists
// (at most kGvSelKeys keys: the host caps splits x entries) pairwise in
// rounds, carrying the rows. Where the valid keys leave room in the list,
// the fill (the lowest positions that hold no valid candidate, at NEG)
// comes from the positions themselves: a walk upward from the first
// position the pass admits, past the valid ones, then a merge by rank.
// Stage 2 writes scores, positions and rows. Lists past kI8MaxK entries
// run in passes, each admitting only keys after the previous pass's last:
// two launches a pass.
// What bounds it: the bytes of the valid member rows and extras read once
// (chip_smoke.py:ivf_bound), plus the slot and row columns. The rows are
// gathered at random addresses in 0.75 to 3 KB runs; the tensor cores are
// left out (wgmma sums in an order lane_dot cannot repeat). What holds it
// back (measured with phase stamps on an H100): a chain of dependent reads
// (cluster ids, occupancy, slots, columns, rows: ~6 us before the first row
// is summed at Q = 1) and a warp's latency a row, not the copy path (a
// bulk copy a row and rows from a 96 MB region take the same time).

#include "topk_scan.cuh"

namespace {

constexpr int kGvExact = 0;                 // forms
constexpr int kGvInt8 = 1;
constexpr int kGvClassic = 2;
constexpr int kGvGroup = 32;                // occupied positions a warp classifies at once
constexpr int kGvTile = kWarps * kGvGroup;  // positions the host plans a block for, at least
constexpr int kGvRingWarp = 10240;          // ring bytes of a warp (or one row, if longer)
constexpr int kGvMaxRows = 16;              // rows a warp keeps in flight, at most
constexpr int kGvBatch = 4;                 // rows a warp sums side by side
constexpr int kGvSelKeys = 4096;            // keys of one list stage 2 holds: splits x entries
constexpr int kGvSelThreads = 1024;

struct GvArgs {
  const void* rows;                // exact forms: [n, d] f32 or bf16; int8: codes [n, d] i8
  const float* scale;              // int8 form: [n]
  const int* members;              // [c, m]
  const int* extras;               // [e]
  const int* cids;                 // [nq, p]
  const int* occ;                  // [c], or null: every cluster m
  const uint8_t* alive;            // keyed forms: [n], with row_tenant [n] and is_super [n]
  const int* row_tenant;
  const uint8_t* is_super;
  const uint8_t* mask;             // classic form: [n]
  const float* qry;                // exact forms: [nq, d]
  const int8_t* qq;                // int8 form: [nq, d] and qs [nq]
  const float* qs;
  const int* q_tenant;             // keyed forms: [nq]
  const int* nprobe_q;             // keyed forms, optional: [nq]
  int d, nq, c, m, p, e, e_live, splits, l;
  int ring_warp;                   // ring bytes of a warp (gv_layout)
  int kcap, gcap;                  // list entries a pass holds at most (shared memory)
  int kc, gc;                      // this pass's list entries (0: that list is done)
  int ldk, ldg;                    // full list lengths (the stride of the outputs)
  const float* after_s;            // a later pass: each list's last pair so far
  const int* after_p;
  const float* gafter_s;
  const int* gafter_p;
  uint64_t* cand;                  // [splits, nq, kc] split lists as keys (0: empty)
  uint64_t* gcand;                 // keyed forms: [splits, nq, gc]
  int* candr;                      // the candidate rows of those keys, alike
  int* gcandr;
  // stage 1's dynamic shared memory, byte offsets (gv_layout)
  int off_pre, off_ring, off_wl, off_wb, off_gl, off_gb, off_ent, off_esc;
};

// Bytes a lane's ring unit holds: one 8-element chunk of an f32 (32) or
// bf16 (16) row, or 16 code bytes of an int8 row.
template <typename T>
__host__ __device__ constexpr int gv_lane_bytes() {
  return std::is_same<T, float>::value ? 32 : 16;
}

// Chunks of a row (a lane's unit each): d / 8 elements, or d / 16 code
// bytes rounded up (the tail zero-filled).
template <typename T>
__host__ __device__ __forceinline__ int gv_chunks(int d) {
  return std::is_same<T, int8_t>::value ? (d + 15) / 16 : d / 8;
}

// Byte offsets of stage 1's shared memory (bf16: the exact forms' element
// type), its ring kGvRingWarp a warp rounded down to whole rows (at most
// kGvMaxRows, at least one); returns the total.
inline size_t gv_layout(GvArgs& a, int form, int bf16) {
  auto up16 = [](size_t x) { return (x + 15) / 16 * 16; };
  const size_t qbytes = form == kGvInt8 ? (size_t)(a.d + 15) / 16 * 16 : (size_t)a.d * 4;
  size_t off = up16(qbytes);
  a.off_pre = (int)off;                                   // pre [p + 1], cluster ids [p]
  off = up16(off + (size_t)(2 * a.p + 1) * 4);
  const size_t row = (size_t)(form == kGvInt8 ? (a.d + 15) / 16 * 16 : a.d * 4 / (bf16 ? 2 : 1));
  const size_t units = (row / (form == kGvInt8 ? 16 : (bf16 ? 16 : 32)) + 31) / 32;
  const size_t slot = units * 32 * (form == kGvInt8 ? 16 : (bf16 ? 16 : 32));
  size_t rows = (size_t)kGvRingWarp / slot;
  rows = rows < 1 ? 1 : (rows > kGvMaxRows ? kGvMaxRows : rows);
  a.ring_warp = (int)(rows * slot);
  a.off_ring = (int)off;
  off += (size_t)kWarps * a.ring_warp;
  a.off_wl = (int)off;                                    // warp lists [8][kcap]
  off += (size_t)kWarps * a.kcap * 8;
  a.off_wb = (int)off;                                    // warp batches [8][32]
  off += (size_t)kWarps * kGvGroup * 8;
  a.off_gl = (int)off;                                    // gate lists and batches
  off += (size_t)kWarps * a.gcap * 8;
  a.off_gb = (int)off;
  off += (size_t)(a.gcap ? kWarps * kGvGroup * 8 : 0);
  a.off_ent = (int)off;                                   // compacted slots [8][2][32]
  off += (size_t)kWarps * 2 * kGvGroup * 8;
  a.off_esc = (int)off;                                   // their int8 scales
  off += (size_t)kWarps * 2 * kGvGroup * 4;
  return off;
}

// 4-byte cp.async global -> shared; `valid` false zero-fills without reading.
__device__ __forceinline__ void gv_cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void gv_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void gv_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until at most n (>= 0) of this thread's cp.async groups are pending.
template <int U>
__device__ __forceinline__ void gv_wait_upto(int n) {
  if constexpr (U <= 1) {
    gv_wait<0>();
  } else {
    if (n >= U - 1) gv_wait<U - 1>();
    else gv_wait_upto<U - 1>(n);
  }
}

// Keys greater than x in the descending keys arr[0, len) (len <= kI8MaxK;
// zeros past the keys count as below every key), in fixed steps.
__device__ __forceinline__ int gv_count_gt(const uint64_t* arr, int len, uint64_t x) {
  int lo = 0;
#pragma unroll
  for (int s = kI8MaxK; s > 0; s >>= 1)
    if (lo + s <= len && arr[lo + s - 1] > x) lo += s;
  return lo;
}

// The candidate row at position j of query q (cand above); rank is the
// cluster's rank, -1 for an extra.
__device__ __forceinline__ int gv_cand(const GvArgs& a, int q, int j, int& rank) {
  const int pm = a.p * a.m;
  if (j < pm) {
    rank = j / a.m;
    const int cid = a.cids[(long long)q * a.p + rank];
    if (cid < 0 || cid >= a.c) return -1;
    return a.members[(long long)cid * a.m + (j - rank * a.m)];
  }
  rank = -1;
  return a.extras[j - pm];
}

__device__ __forceinline__ int gv_probes(const GvArgs& a, int q) {
  int probes = a.nprobe_q ? a.nprobe_q[q] : a.p;
  return probes < 0 ? 0 : (probes > a.p ? a.p : probes);
}

// A lane's position of a group: the slot read (stage A), then its row's
// columns (stage B), loaded a group or two before they are used.
struct GvSlot {
  int row, pos;
  int tenant;             // keyed: the row's tenant
  unsigned flags;         // keyed: alive | super << 1; classic: mask
  float scale;            // int8 form
};

template <int kForm>
__device__ __forceinline__ void gv_load_cols(const GvArgs& a, GvSlot& s) {
  s.tenant = 0;
  s.flags = 0;
  s.scale = 0.f;
  if (s.row < 0) return;
  if constexpr (kForm == kGvClassic) {
    s.flags = a.mask[s.row];
  } else {
    s.flags = (a.alive[s.row] ? 1u : 0u) | (a.is_super[s.row] ? 2u : 0u);
    s.tenant = a.row_tenant[s.row];
    if constexpr (kForm == kGvInt8) s.scale = a.scale[s.row];
  }
}

// The kc best keys of the 8 warps' sorted lists (lists + w * cap, len[w]
// keys each) into dst [kc], zeros past them: the lists merge pairwise in
// three rounds (8, 4, 2, 1 lists), each key placed at its index plus the
// keys above it in its partner list (no two are equal), each merged list
// cut to kc. scratch holds 6 lists of cap keys; len is rewritten.
__device__ __forceinline__ void gv_block_merge(const uint64_t* lists, int cap, int* len, int kc,
                                               uint64_t* scratch, uint64_t* dst) {
  const uint64_t* src = lists;
  for (int n = kWarps; n > 1; n >>= 1) {
    uint64_t* out = n == 2 ? dst : (n == kWarps ? scratch : scratch + 4 * cap);
    for (int f = threadIdx.x; f < n * cap; f += kThreads) {
      const int l = f / cap, j = f - l * cap;
      if (j >= len[l]) continue;
      const uint64_t x = src[f];
      const int r = j + gv_count_gt(src + (l ^ 1) * cap, len[l ^ 1], x);
      if (r < kc) out[(l >> 1) * cap + r] = x;
    }
    const int t = threadIdx.x;
    const int merged = t < n / 2 ? len[2 * t] + len[2 * t + 1] : 0;
    __syncthreads();
    if (t < n / 2) len[t] = merged < kc ? merged : kc;
    __syncthreads();
    src = out;
  }
  for (int r = len[0] + threadIdx.x; r < kc; r += kThreads) dst[r] = 0ull;
}

// Stage 1: block (split, q) keeps the best kc (and gc) keys of its share
// of query q's occupied positions, with their rows. T: float, uint16_t
// (bf16 bits) or int8_t (the int8 form).
template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads, 2) gv_stage1(const GvArgs a) {
  constexpr bool kKeyed = kForm != kGvClassic;
  constexpr int kLane = gv_lane_bytes<T>();
  extern __shared__ __align__(16) unsigned char gv_smem[];
  __shared__ int s_m[kWarps], s_gm[kWarps];
  const int split = blockIdx.x, q = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d;
  int* pre = reinterpret_cast<int*>(gv_smem + a.off_pre);
  int* cl = pre + a.p + 1;
  uint64_t* WL = reinterpret_cast<uint64_t*>(gv_smem + a.off_wl) + warp * a.kcap;
  uint64_t* WB = reinterpret_cast<uint64_t*>(gv_smem + a.off_wb) + warp * kGvGroup;
  uint64_t* GL = reinterpret_cast<uint64_t*>(gv_smem + a.off_gl) + warp * a.gcap;
  uint64_t* GB = reinterpret_cast<uint64_t*>(gv_smem + a.off_gb) + warp * kGvGroup;
  int2* ent = reinterpret_cast<int2*>(gv_smem + a.off_ent) + warp * 2 * kGvGroup;
  float* esc = reinterpret_cast<float*>(gv_smem + a.off_esc) + warp * 2 * kGvGroup;
  const int chunks = gv_chunks<T>(d);
  const int nu = (chunks + 31) / 32;                 // units a row
  const bool al16 = (d % 16) == 0;

  // The query in shared memory: f32 [d], or the int8 codes zero-padded to
  // the chunks' bytes.
  if constexpr (kForm == kGvInt8) {
    const int* src = reinterpret_cast<const int*>(a.qq + (long long)q * d);
    for (int i = tid; i < chunks * 4; i += kThreads)
      reinterpret_cast<int*>(gv_smem)[i] = i < d / 4 ? src[i] : 0;
  } else {
    for (int i = tid; i < d; i += kThreads)
      reinterpret_cast<float*>(gv_smem)[i] = a.qry[(long long)q * d + i];
  }
  // The probed clusters' occupancy as prefix sums: pre[r] occupied
  // positions before rank r.
  const int probes = kKeyed ? gv_probes(a, q) : a.p;
  if (warp == 0) {
    int carry = 0;
    for (int r0 = 0; r0 < probes; r0 += 32) {
      const int r = r0 + lane;
      int o = 0;
      if (r < probes) {
        const int cid = a.cids[(long long)q * a.p + r];
        cl[r] = cid;
        if (cid >= 0 && cid < a.c) {
          o = a.occ ? a.occ[cid] : a.m;
          o = o < 0 ? 0 : (o > a.m ? a.m : o);
        }
      }
      int inc = o;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += y;
      }
      if (r < probes) pre[r + 1] = carry + inc;
      carry += __shfl_sync(kFull, inc, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();
  const int pre_p = pre[probes];
  const int e_live = a.e_live;
  const long long total = (long long)pre_p + e_live;
  const long long per = (total + a.splits - 1) / a.splits;
  const long long lo_ll = (long long)split * per < total ? (long long)split * per : total;
  const long long hi_ll = lo_ll + per < total ? lo_ll + per : total;
  const int lo = (int)lo_ll, hi = (int)hi_ll;
  const int ng = (hi - lo + kGvGroup - 1) / kGvGroup;

  const uint64_t after = a.after_s ? list_key(a.after_s[(long long)q * a.ldk],
                                              a.after_p[(long long)q * a.ldk]) : ~0ull;
  const uint64_t gafter = (kKeyed && a.gafter_s)
                              ? list_key(a.gafter_s[(long long)q * a.ldg],
                                         a.gafter_p[(long long)q * a.ldg]) : ~0ull;
  const int tenant = kKeyed ? a.q_tenant[q] : 0;
  const float qscale = kForm == kGvInt8 ? a.qs[q] : 0.f;
  const T* rows = reinterpret_cast<const T*>(a.rows);
  const float* qv = reinterpret_cast<const float*>(gv_smem);
  const int* qw = reinterpret_cast<const int*>(gv_smem);

  // Stage A of the warp's group number s (group warp + 8 s of the block).
  auto load_slot = [&](int s) {
    GvSlot t;
    t.row = -1;
    t.pos = -1;
    const int gi = warp + kWarps * s;
    const int i = lo + gi * kGvGroup + lane;
    if (gi < ng && i < hi) {
      if (i < pre_p) {
        int rl = 0, rh = probes;                 // pre[rl] <= i < pre[rh]
        while (rh - rl > 1) {
          const int mid = (rl + rh) >> 1;
          if (pre[mid] <= i) rl = mid;
          else rh = mid;
        }
        const int slot = i - pre[rl];
        t.pos = rl * a.m + slot;
        t.row = a.members[(long long)cl[rl] * a.m + slot];
      } else {
        const int x = i - pre_p;
        t.pos = a.p * a.m + x;
        t.row = a.extras[x];
      }
    }
    return t;
  };
  // Compacts a classified group's valid slots into buffer b; returns their
  // count.
  auto compact = [&](const GvSlot& t, int b) {
    bool ok;
    if constexpr (kKeyed) ok = t.row >= 0 && (t.flags & 1u) && t.tenant == tenant;
    else ok = t.row >= 0 && t.flags != 0u;
    const unsigned bal = __ballot_sync(kFull, ok);
    __syncwarp();
    if (ok) {
      const int at = b * kGvGroup + __popc(bal & ((1u << lane) - 1u));
      const unsigned sup = kKeyed ? (t.flags & 2u) << 30 : 0u;
      ent[at] = make_int2(t.row, (int)((unsigned)t.pos | sup));
      if constexpr (kForm == kGvInt8) esc[at] = t.scale;
    }
    __syncwarp();
    return __popc(bal);
  };

  // The warp's pipeline: cur (group s, buffer s & 1) is scored, nxt (s + 1)
  // is compacted, sb holds the columns of s + 2 in flight, sa the slots of
  // s + 3.
  int ncur, nnxt;
  GvSlot sa, sb;
  {
    GvSlot t0 = load_slot(0);
    gv_load_cols<kForm>(a, t0);
    GvSlot t1 = load_slot(1);
    ncur = compact(t0, 0);
    gv_load_cols<kForm>(a, t1);
    sb = load_slot(2);
    nnxt = compact(t1, 1);
    gv_load_cols<kForm>(a, sb);
    sa = load_slot(3);
  }
  int m = 0, gm = 0, nb = 0, gnb = 0;
  uint64_t thr = 0ull, gthr = 0ull;
  // The ring: R slots of a row each (its nu units of kLane bytes a lane),
  // a cp.async group a row, so the wait counts rows.
  const int slot_bytes = nu * 32 * kLane;
  const int R = a.ring_warp / slot_bytes < kGvMaxRows ? a.ring_warp / slot_bytes : kGvMaxRows;
  const uint32_t ring = hopper::smem_u32(gv_smem + a.off_ring) +
                        (uint32_t)(warp * a.ring_warp + lane * kLane);
  const unsigned char* ring_g = gv_smem + a.off_ring + warp * a.ring_warp + lane * kLane;
  int issued = 0, consumed = 0;                  // rows
  int ig = 0, ir = 0;                            // the issue cursor: group (0 cur, 1 nxt), row
  for (int s = 0; warp + kWarps * s < ng; ++s) {
    const int bc = s & 1;
    for (int cr = 0; cr < ncur;) {
      // Keep up to R rows in flight, into the next group too.
      while (issued - consumed < R) {
        if (ig == 0 && ir >= ncur) {
          ig = 1;
          ir = 0;
        }
        if (ig == 1 && ir >= nnxt) break;
        const T* rp = rows + (long long)ent[(bc ^ ig) * kGvGroup + ir].x * d;
        const uint32_t dst = ring + (uint32_t)((issued % R) * slot_bytes);
        for (int u = 0, ch = lane; ch < chunks; ++u, ch += 32) {
          const uint32_t at = dst + (uint32_t)(u * 32 * kLane);
          if constexpr (std::is_same<T, float>::value) {
            hopper::cp_async16(at, rp + 8 * ch, true);
            hopper::cp_async16(at + 16, rp + 8 * ch + 4, true);
          } else if constexpr (std::is_same<T, uint16_t>::value) {
            hopper::cp_async16(at, rp + 8 * ch, true);
          } else if (al16) {
            hopper::cp_async16(at, rp + 16 * ch, true);
          } else {
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const bool in = 16 * ch + 4 * w < d;
              gv_cp4(at + 4 * w, in ? rp + 16 * ch + 4 * w : rp, in);
            }
          }
        }
        gv_commit();
        ++issued;
        ++ir;
      }
      // Rows cr .. cr + nr - 1 side by side: each lane sums its chunks of
      // each row in column order, then a butterfly a row (every lane gets
      // the same totals); then their keys and the batches of their lists.
      int nr = ncur - cr < kGvBatch ? ncur - cr : kGvBatch;
      nr = nr < R ? nr : R;
      gv_wait_upto<kGvMaxRows>(issued - consumed - nr);
      const unsigned char* slot[kGvBatch];
#pragma unroll
      for (int r = 0; r < kGvBatch; ++r)
        slot[r] = ring_g + ((consumed + (r < nr ? r : 0)) % R) * slot_bytes;
      float sc[kGvBatch];
      if constexpr (kForm == kGvInt8) {
        int acc[kGvBatch] = {};
        for (int u = 0, ch = lane; ch < chunks; ++u, ch += 32) {
          const int4 q4 = *reinterpret_cast<const int4*>(qw + 4 * ch);
#pragma unroll
          for (int r = 0; r < kGvBatch; ++r) {
            if (r >= nr) continue;
            const int4 w4 = *reinterpret_cast<const int4*>(slot[r] + u * 32 * kLane);
            acc[r] = __dp4a(q4.x, w4.x, acc[r]);
            acc[r] = __dp4a(q4.y, w4.y, acc[r]);
            acc[r] = __dp4a(q4.z, w4.z, acc[r]);
            acc[r] = __dp4a(q4.w, w4.w, acc[r]);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int r = 0; r < kGvBatch; ++r) acc[r] += __shfl_xor_sync(kFull, acc[r], o);
#pragma unroll
        for (int r = 0; r < kGvBatch; ++r)
          sc[r] = r < nr ? __fmul_rn(__fmul_rn(__int2float_rn(acc[r]), qscale),
                                     esc[bc * kGvGroup + cr + r])
                         : 0.f;
      } else {
        float acc[kGvBatch] = {};
        for (int u = 0, ch = lane; ch < chunks; ++u, ch += 32) {
          const float4 q0 = *reinterpret_cast<const float4*>(qv + 8 * ch);
          const float4 q1 = *reinterpret_cast<const float4*>(qv + 8 * ch + 4);
          const float qc[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
          for (int r = 0; r < kGvBatch; ++r) {
            if (r >= nr) continue;
            float x[8];
            load8(reinterpret_cast<const T*>(slot[r] + u * 32 * kLane), x);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r] = __fadd_rn(acc[r], __fmul_rn(qc[i], x[i]));
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int r = 0; r < kGvBatch; ++r) acc[r] += __shfl_xor_sync(kFull, acc[r], o);
#pragma unroll
        for (int r = 0; r < kGvBatch; ++r) sc[r] = acc[r];
      }
      consumed += nr;
#pragma unroll
      for (int r = 0; r < kGvBatch; ++r) {
        if (r >= nr) continue;
        const int2 en = ent[bc * kGvGroup + cr + r];
        const uint64_t key = list_key(sc[r], en.y & 0x7fffffff);
        if (kKeyed && en.y < 0) {
          if (a.gc && key < gafter && key > gthr) {
            if (lane == 0) GB[gnb] = key;
            ++gnb;
          }
        } else if (a.kc && key < after && key > thr) {
          if (lane == 0) WB[nb] = key;
          ++nb;
        }
      }
      cr += nr;
    }
    // Merge the group's batches (the next group's units stay in flight).
    __syncwarp();
    if (nb) {
      m = merge_batch<kGvGroup, kI8MaxK>(WL, m, WB, nb, a.kc);
      nb = 0;
      thr = m == a.kc ? WL[a.kc - 1] : 0ull;
    }
    if (kKeyed && gnb) {
      gm = merge_batch<kGvGroup, kI8MaxK>(GL, gm, GB, gnb, a.gc);
      gnb = 0;
      gthr = gm == a.gc ? GL[a.gc - 1] : 0ull;
    }
    // Advance: nxt becomes cur, s + 2 is compacted into cur's buffer, the
    // columns of s + 3 and the slots of s + 4 are loaded.
    ncur = nnxt;
    nnxt = compact(sb, bc);
    gv_load_cols<kForm>(a, sa);
    sb = sa;
    sa = load_slot(s + 4);
    if (ig == 1) ig = 0;
    else ir = 0;
  }
  gv_wait<0>();
  if (lane == 0) {
    s_m[warp] = m;
    s_gm[warp] = gm;
  }
  __syncthreads();
  // The block's lists into the ring's room (no copy is in flight), then out
  // with the row at each key's position (the member slot or extra read
  // through the cluster ids in shared memory).
  uint64_t* out = reinterpret_cast<uint64_t*>(gv_smem + a.off_ring);
  uint64_t* scratch = out + a.kcap + a.gcap;
  gv_block_merge(reinterpret_cast<const uint64_t*>(gv_smem + a.off_wl), a.kcap, s_m, a.kc,
                 scratch, out);
  if (kKeyed)
    gv_block_merge(reinterpret_cast<const uint64_t*>(gv_smem + a.off_gl), a.gcap, s_gm, a.gc,
                   scratch, out + a.kcap);
  __syncthreads();
  const int pm = a.p * a.m;
  for (int i = tid; i < a.kc + (kKeyed ? a.gc : 0); i += kThreads) {
    const bool g = i >= a.kc;
    const int j = g ? i - a.kc : i;
    const uint64_t x = out[g ? a.kcap + j : j];
    int row = -1;
    if (x) {
      const int pos = key_row(x);
      const int rank = pos / a.m;
      row = pos < pm ? a.members[(long long)cl[rank] * a.m + (pos - rank * a.m)]
                     : a.extras[pos - pm];
    }
    const long long o = ((long long)split * a.nq + q) * (g ? a.gc : a.kc) + j;
    (g ? a.gcand : a.cand)[o] = x;
    (g ? a.gcandr : a.candr)[o] = row;
  }
}

// Whether position j of query q holds a valid candidate of the list (the
// gate list: a super row; the ANN or classic list: any other); *row is the
// candidate row there.
template <int kForm>
__device__ __forceinline__ bool gv_valid(const GvArgs& a, int q, int j, bool gate, int probes,
                                         int tenant, int* row) {
  int rank;
  const int r = gv_cand(a, q, j, rank);
  *row = r;
  if (r < 0 || rank >= probes) return false;
  if constexpr (kForm == kGvClassic) {
    return a.mask[r] != 0;
  } else {
    return a.alive[r] && a.row_tenant[r] == tenant && ((a.is_super[r] != 0) == gate);
  }
}

// Stage 2: block (q, l) writes columns [c0, c0 + c) of list l of query q
// (0: the ANN or classic list, out [nq, ldk] from column k0; 1: the gate,
// gout [nq, ldg] from column g0), c = kc or gc (a block of a list with
// nothing left this pass returns): the c best of the splits' keys and the
// fill positions the pass admits, with the rows at the positions. The
// splits' sorted lists merge pairwise in rounds, each key placed at its
// index plus the keys above it in its partner list (no two keys are
// equal), each merged list cut to c: log2(splits) rounds of one search a
// key.
template <int kForm>
__global__ void __launch_bounds__(kGvSelThreads)
gv_select(const GvArgs a, int k0, int g0, float* __restrict__ out_s, int* __restrict__ out_p,
          int* __restrict__ out_r, float* __restrict__ gout_s, int* __restrict__ gout_p,
          int* __restrict__ gout_r) {
  constexpr bool kKeyed = kForm != kGvClassic;
  constexpr int T = kGvSelThreads;
  extern __shared__ __align__(16) unsigned char gs_smem[];   // keys and rows, two of each
  __shared__ uint64_t band[kI8MaxK], fin[kI8MaxK];
  __shared__ int band_r[kI8MaxK], fin_r[kI8MaxK];
  __shared__ int wc[T / 32];
  __shared__ int s_nr, s_got;
  const bool gate = blockIdx.y == 1;
  const int c = gate ? a.gc : a.kc;
  if (c == 0) return;
  const int q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.splits * c;
  uint64_t* ka = reinterpret_cast<uint64_t*>(gs_smem);
  uint64_t* kb = ka + n;
  int* ra = reinterpret_cast<int*>(kb + n);
  int* rb = ra + n;
  const uint64_t* src = gate ? a.gcand : a.cand;
  const int* srcr = gate ? a.gcandr : a.candr;
  {
    // All of a thread's loads first (n <= kGvSelKeys = 4 T), then the stores.
    constexpr int kPer = kGvSelKeys / T;
    uint64_t xk[kPer];
    int xr[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * T;
      const int sp = i / c;
      const long long o = ((long long)sp * a.nq + q) * c + (i - sp * c);
      xk[t] = i < n ? src[o] : 0ull;
      xr[t] = i < n ? srcr[o] : -1;
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      if (tid + t * T < n) {
        ka[tid + t * T] = xk[t];
        ra[tid + t * T] = xr[t];
      }
    }
  }
  for (int i = tid; i < c; i += T) fin[i] = 0ull;
  if (tid == 0) {
    s_nr = 0;
    s_got = 0;
  }
  __syncthreads();
  for (int lists = a.splits; lists > 1;) {
    const int half = (lists + 1) >> 1;
    for (int i = tid; i < half * c; i += T) kb[i] = 0ull;
    __syncthreads();
    for (int f = tid; f < lists * c; f += T) {
      const uint64_t x = ka[f];
      if (x == 0ull) continue;
      const int l = f / c, j = f - l * c;
      const int other = l ^ 1;
      const int r = j + (other < lists ? gv_count_gt(ka + other * c, c, x) : 0);
      if (r < c) {
        kb[(l >> 1) * c + r] = x;
        rb[(l >> 1) * c + r] = ra[f];
      }
    }
    __syncthreads();
    uint64_t* tk = ka;
    ka = kb;
    kb = tk;
    int* tr = ra;
    ra = rb;
    rb = tr;
    lists = half;
  }
  for (int i0 = 0; i0 < c; i0 += T) {
    const unsigned b = __ballot_sync(kFull, i0 + tid < c && ka[i0 + tid] != 0ull);
    if (lane == 0 && b) atomicAdd(&s_nr, __popc(b));
  }
  __syncthreads();
  const int nr = s_nr;
  // The fill: positions with no valid candidate of the list score NEG and
  // rank by position; the pass admits those after its predecessor's last
  // pair (list_key(NEG, j) < after).
  const float* as = gate ? a.gafter_s : a.after_s;
  const int* ap = gate ? a.gafter_p : a.after_p;
  const int ld = gate ? a.ldg : a.ldk;
  const uint64_t after = as ? list_key(as[(long long)q * ld], ap[(long long)q * ld]) : ~0ull;
  const uint64_t neg_hi = list_key(kNeg, 0) >> 32;
  long long j0 = a.l;
  if (after == ~0ull || (after >> 32) > neg_hi) j0 = 0;
  else if ((after >> 32) == neg_hi) j0 = (long long)key_row(after) + 1;
  const uint64_t best = j0 < a.l ? list_key(kNeg, (int)j0) : 0ull;
  const bool need = best != 0ull && (nr < c || ka[c - 1] < best);
  if (need) {
    const int probes = kKeyed ? gv_probes(a, q) : a.p;
    const int tenant = kKeyed ? a.q_tenant[q] : 0;
    for (long long base = j0; base < a.l; base += T) {
      if (s_got >= c) break;
      const long long j = base + tid;
      int row = -1;
      const bool fill = j < a.l && !gv_valid<kForm>(a, q, (int)j, gate, probes, tenant, &row);
      const unsigned b = __ballot_sync(kFull, fill);
      if (lane == 0) wc[warp] = __popc(b);
      __syncthreads();
      int off = s_got, tot = 0;
#pragma unroll
      for (int w = 0; w < T / 32; ++w) {
        off += w < warp ? wc[w] : 0;
        tot += wc[w];
      }
      const int at = off + __popc(b & ((1u << lane) - 1u));
      if (fill && at < c) {
        band[at] = list_key(kNeg, (int)j);
        band_r[at] = row;
      }
      __syncthreads();
      if (tid == 0) s_got = s_got + tot < c ? s_got + tot : c;
      __syncthreads();
    }
    const int nf = s_got;
    for (int i = tid; i < nr + nf; i += T) {
      const bool is_sel = i < nr;
      const uint64_t x = is_sel ? ka[i] : band[i - nr];
      const int r = is_sel ? i + gv_count_gt(band, nf, x) : i - nr + gv_count_gt(ka, nr, x);
      if (r < c) {
        fin[r] = x;
        fin_r[r] = is_sel ? ra[i] : band_r[i - nr];
      }
    }
    __syncthreads();
  }
  const uint64_t* res = need ? fin : ka;
  const int* res_r = need ? fin_r : ra;
  float* os = gate ? gout_s : out_s;
  int* op = gate ? gout_p : out_p;
  int* orow = gate ? gout_r : out_r;
  const long long o = (long long)q * ld + (gate ? g0 : k0);
  for (int i = tid; i < c; i += T) {
    const uint64_t x = res[i];
    os[o + i] = x ? key_score(x) : -INFINITY;
    op[o + i] = x ? key_row(x) : INT32_MAX;
    orow[o + i] = x ? res_r[i] : -1;
  }
}

// Splits of the occupied positions a launch of nq queries takes on a card
// of `sms` multiprocessors: about two blocks an SM, no more
// than the planned work's kGvTile-position tiles, and at most kGvSelKeys
// keys of a list (kcap entries a split) for stage 2. `work` is the host's
// estimate of a query's occupied positions; the blocks share the true
// count, read on the device, so any plan is correct.
inline int gv_plan(long long work, int nq, int sms, int kcap) {
  long long tiles = (work + kGvTile - 1) / kGvTile;
  long long s = (2LL * sms + nq - 1) / nq;
  if (s > tiles) s = tiles;
  if (s > kGvSelKeys / kcap) s = kGvSelKeys / kcap;
  return s < 1 ? 1 : (int)s;
}

template <typename T, int kForm>
cudaError_t launch_gv(const GvArgs& a, size_t smem, size_t sel_smem, int k0, int g0,
                      float* out_s, int* out_p, int* out_r, float* gout_s, int* gout_p,
                      int* gout_r, int* launched, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(gv_stage1<T, kForm>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gv_select<kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sel_smem);
  if (err != cudaSuccess) return err;
  gv_stage1<T, kForm><<<dim3(a.splits, a.nq), kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (launched) ++*launched;
  gv_select<kForm><<<dim3(a.nq, kForm == kGvClassic ? 1 : 2), kGvSelThreads, sel_smem, st>>>(
      a, k0, g0, out_s, out_p, out_r, gout_s, gout_p, gout_r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (launched) ++*launched;
  return cudaSuccess;
}

// A stage 1 and a stage 2 a pass until both lists hold k (and g) entries;
// each launch the card takes is added to *launched. form: kGvExact,
// kGvInt8 or kGvClassic; bf16 picks the exact forms' element type. Returns
// the CUDA error of the launches.
int run_gv(GvArgs a, int form, int bf16, int k, int g, float* out_s, int* out_p, int* out_r,
           float* gout_s, int* gout_p, int* gout_r, int* launched, cudaStream_t st) {
  const bool keyed = form != kGvClassic;
  const long long lmax = (long long)a.p * a.m + a.e;
  if (form < kGvExact || form > kGvClassic || a.nq < 1 || a.nq > 65535 || a.d < 1 || a.p < 1 ||
      a.m < 1 || a.c < 1 || a.e < 0 || a.e_live < 0 || a.e_live > a.e || lmax != a.l ||
      lmax > INT32_MAX - 1 || k < 1 || k > a.l || g < 0 || g > a.l || (g > 0) != keyed ||
      a.kcap != (k < kI8MaxK ? k : kI8MaxK) ||
      a.gcap != (keyed ? (g < kI8MaxK ? g : kI8MaxK) : 0) || a.splits < 1 ||
      (long long)a.splits * (a.kcap > a.gcap ? a.kcap : a.gcap) > kGvSelKeys || !a.rows ||
      !a.members || !a.cids || (a.e > 0 && !a.extras) || !a.cand || !a.candr ||
      (keyed && (!a.gcand || !a.gcandr)) ||
      (form == kGvInt8 ? (a.d % 4 != 0 || a.d > kI8MaxD || !a.qq || !a.qs || !a.scale)
                       : (a.d % 8 != 0 || !a.qry)) ||
      (keyed ? (!a.alive || !a.row_tenant || !a.is_super || !a.q_tenant) : !a.mask))
    return (int)cudaErrorInvalidValue;
  const size_t smem = gv_layout(a, form, bf16);
  if (smem > (size_t)kSmemMax - 1024) return (int)cudaErrorInvalidValue;
  const size_t sel_smem =
      (size_t)a.splits * (a.kcap > a.gcap ? a.kcap : a.gcap) * 2 * (sizeof(uint64_t) + 4);
  a.ldk = k;
  a.ldg = g;
  for (int k0 = 0, g0 = 0; k0 < k || g0 < g;) {
    // A list that is done takes 0 entries: stage 1 skips it and stage 2's
    // blocks of it return.
    GvArgs p = a;
    p.kc = k - k0 < a.kcap ? k - k0 : a.kcap;
    p.gc = g - g0 < a.gcap ? g - g0 : a.gcap;
    p.after_s = k0 ? out_s + k0 - 1 : nullptr;
    p.after_p = k0 ? out_p + k0 - 1 : nullptr;
    p.gafter_s = g0 ? gout_s + g0 - 1 : nullptr;
    p.gafter_p = g0 ? gout_p + g0 - 1 : nullptr;
    cudaError_t err;
    if (form == kGvInt8)
      err = launch_gv<int8_t, kGvInt8>(p, smem, sel_smem, k0, g0, out_s, out_p, out_r, gout_s,
                                       gout_p, gout_r, launched, st);
    else if (form == kGvClassic)
      err = bf16 ? launch_gv<uint16_t, kGvClassic>(p, smem, sel_smem, k0, g0, out_s, out_p,
                                                   out_r, gout_s, gout_p, gout_r, launched, st)
                 : launch_gv<float, kGvClassic>(p, smem, sel_smem, k0, g0, out_s, out_p, out_r,
                                                gout_s, gout_p, gout_r, launched, st);
    else
      err = bf16 ? launch_gv<uint16_t, kGvExact>(p, smem, sel_smem, k0, g0, out_s, out_p,
                                                 out_r, gout_s, gout_p, gout_r, launched, st)
                 : launch_gv<float, kGvExact>(p, smem, sel_smem, k0, g0, out_s, out_p, out_r,
                                              gout_s, gout_p, gout_r, launched, st);
    if (err != cudaSuccess) return (int)err;
    k0 += p.kc;
    g0 += p.gc;
  }
  return 0;
}

}  // namespace

extern "C" {

// The splits of a scan of nq queries whose occupied positions a query
// holds about `work` of, with lists of kcap entries a pass, on a card of
// `sms` multiprocessors.
int ivf_topk_plan(long long work, int nq, int sms, int kcap) {
  return gv_plan(work, nq, sms, kcap);
}

// form 0 (exact, keyed), 1 (int8, keyed) or 2 (classic, one list). rows:
// the arena [n, d] (bf16 when is_bf16, else f32), or the shadow's codes [n,
// d] i8 with scale [n] f32 (form 1). members [c, m], extras [e] and cids
// [nq, p] i32; occ [c] i32 or null, e_live: every member slot at or past
// occ[c] and every extra at or past e_live holds -1. Keyed forms: alive /
// is_super [n] u8, row_tenant [n] i32, q_tenant [nq] i32 and nprobe_q [nq]
// i32 or null; classic: mask [n] u8. qry [nq, d] f32 (exact forms), or qq
// [nq, d] i8 and qs [nq] f32 (form 1). splits from ivf_topk_plan;
// kcap = min(k, 256), gcap = min(g, 256) (0 in the classic form). Scratch:
// cand / candr [splits, nq, kcap] and gcand / gcandr [splits, nq, gcap]
// (u64 keys, i32 rows). Outputs: out_s / out_p / out_r [nq, k] (f32
// scores, i32 candidate positions and rows) and gout_s / gout_p / gout_r
// [nq, g]. Every launch the card takes is counted into *launched. Returns
// the CUDA error of the launches (0 on success).
int ivf_topk(int form, const void* rows, int is_bf16, const float* scale, const int* members,
             const int* extras, const int* cids, const int* occ, const uint8_t* alive,
             const int* row_tenant, const uint8_t* is_super, const uint8_t* mask,
             const float* qry, const int8_t* qq, const float* qs, const int* q_tenant,
             const int* nprobe_q, int d, int nq, int c, int m, int p, int e, int e_live, int k,
             int g, int splits, int kcap, int gcap, unsigned long long* cand,
             int* candr, unsigned long long* gcand, int* gcandr, float* out_s, int* out_p,
             int* out_r, float* gout_s, int* gout_p, int* gout_r, int* launched, void* stream) {
  GvArgs a{};
  a.rows = rows; a.scale = scale; a.members = members; a.extras = extras; a.cids = cids;
  a.occ = occ; a.alive = alive; a.row_tenant = row_tenant; a.is_super = is_super;
  a.mask = mask; a.qry = qry; a.qq = qq; a.qs = qs; a.q_tenant = q_tenant;
  a.nprobe_q = nprobe_q;
  a.d = d; a.nq = nq; a.c = c; a.m = m; a.p = p; a.e = e; a.e_live = e_live;
  a.l = (long long)p * m + e > INT32_MAX ? -1 : p * m + e;
  a.splits = splits; a.kcap = kcap; a.gcap = gcap;
  a.cand = reinterpret_cast<uint64_t*>(cand);
  a.gcand = reinterpret_cast<uint64_t*>(gcand);
  a.candr = candr;
  a.gcandr = gcandr;
  return run_gv(a, form, is_bf16, k, g, out_s, out_p, out_r, gout_s, gout_p, gout_r, launched,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
