// K5: the multi-walk SA walker — the port's counterpart of the TPU kernel
// tnco_tpu/kernels/pallas_walker.py:_make_kernel, in its infinite-memory
// form (fw=False, launched by _run_walker; entry point tnco_walker_im) and
// its finite-width form (fw=True, launched once per segment by
// _walker_fw_segment; entry point tnco_walker_fw).  Both are one template,
// walker_kernel<FW, TOPO>, sharing every device function.
//
// One CTA runs one replica through K iterations of P-walk SA in one
// launch.  Each iteration, for every walk p < P:
//   - restart at the parent of a drawn leaf when the walk sits on NULL or
//     on the root; B = the walk's node, A = par(B), C = the sibling of B;
//   - pick D/E among B's children with the shared-index rule, build
//     new_inds_b = (inds_d ^ inds_c) | hyper(A) | hyper(B), and the two
//     new log2 costs ln_b = width(inds_d | inds_c), ln_a = width(new_inds_b
//     | inds_e) with the pinned (w-major, then bit) halving tree;
//   - Metropolis-accept against the pre-round total lt:
//       m = max(lt, ln_a, ln_b)
//       s = 2^(lt-m) - 2^(l_a-m) - 2^(l_b-m) + 2^(ln_a-m) + 2^(ln_b-m)
//       l_new = m + log2(max(s, 2^-60)),  accept: log2(u) <= -beta (l_new-lt)
// then keep a pairwise-disjoint set (lower walk index wins, only kept
// walks block), write the kept rows, advance every walk to A, recompute
// the exact total with the pinned tree and snapshot the state into the
// min buffer on a strict improvement.
//
// Finite width adds, per walk, the replica's slice lanes sl (kept in
// registers for the launch): new_width_b = width(new_inds_b), the sliced
// width(new_inds_b & ~sl) against the cap (fits = sliced <= max_width +
// 1e-4f, folded into the acceptance), slice-aware costs ln_b = width(d | c
// | sl) and ln_a = width(new_inds_b | e | sl), and the kept walk's
// pre-slicing width of B written as w_b + (new_width_b - w_b).  With
// defer_last the last iteration takes no snapshot: the caller reslices
// after it and snapshots itself.  The reslice runs between launches.
//
// The results equal the plain versions in tnco_tpu_torch.kernels.
// sa_multiwalk (run_multiwalk; the FW segment iterations of
// run_multiwalk_fw) bitwise on the same draws: the float expressions are
// evaluated in the same order with exp2f/log2f, which round as torch's
// CUDA exp2/log2, and this file is built with -fmad=false (no
// contraction).
//
// Layout (the port's own; the TPU's 128-lane rows, transposed column
// cache and equality-matrix scatter exist only because lane-dynamic
// indexing is expensive there):
//   rows     int32 [B, N', R]: c0, c1, par, lcc bits, then (FW) the
//            pre-slicing width bits, then inds[0..W), 0 pad; R = header + W
//            rounded up to a multiple of 4 (16-byte rows).  IM: N' = N.
//            FW: N' = N + 1, and row N holds the replica's slice lanes in
//            the inds words, so the snapshot copies them with the state.
//   min_rows int32 [B, N', R]: the min state (its lcc and width words are
//            not used).
//   pos      int32 [B, P]; min_lt float [B]; applied int32 [B] (kept
//            moves, accumulated over launches); leaf, rand_bit int32 and u
//            float [K, P, B]; betas float [K]; log2d float [W * 32].
// rows, min_rows, pos, min_lt and applied are updated in place.
//
// What bounds it on an H100: latency, not bandwidth or arithmetic.  One
// CTA (256 threads, one warp per walk) runs one replica's iterations in
// order, so an iteration costs the sum of its phases' dependent chains.
// The first design spent 69-88% of an iteration in the proposal
// (scripts/profile_torch_walker.py; PERF.md): its width trees looped over
// the 32 bit positions with a chain of shuffles each, every log2d read of
// that loop a 32-way shared-memory bank conflict, and the pointer chain
// par(pos) -> leaf -> par(leaf) -> par(B) -> children went to global
// memory (4-5 dependent round trips).  Each strict improvement copied the
// whole state (0.88 MB IM, 0.93 MB FW) with one dependent load per thread
// in flight, about 70-160 us a copy; the claim scan and the total took 2-4
// us each.  This design:
//   a. Widths.  Popcount route: where every nonzero log2d entry equals
//      one integer c and W*32*c < 2^24 (decided in the prologue from the
//      table; no argument, no host sync), width = c * popcount(x & nz):
//      integer-valued float sums are exact, so it equals the tree bitwise.
//      Tree route (any dims): lane l halves its own words l + 32 j over j
//      (the tree's levels over W zero-padded to 128 words; an exact zero
//      changes no sum), then a butterfly halves over the lanes (levels
//      16..1) so that lane s ends with bit s's sum over every word, and
//      the 32 lanes halve over the bits: every add has the operands of
//      _width_bn's (w*32+s)-ordered tree.  log2d is kept transposed
//      ([bit][word]) so those reads are conflict-free; 31 + 5 shuffles a
//      width instead of 32 x 6, and two widths share one pass of reads.
//   b. Topology in shared memory (TOPO): c0, c1, par and lcc of every node
//      live in shared memory for the launch (N=3241: 52 KB), so the
//      proposal's pointer chain runs at shared-memory latency and a walk
//      costs one global round trip (its five index rows, and FW the width
//      of B, issued together).  new_inds_b stays in shared memory (P x W
//      words), so the apply writes B's words without rereading a row and
//      updates the topology in shared memory; topology and lcc go back to
//      the rows at the end.  Networks whose topology does not fit (the
//      walker admits N < 30000) take the TOPO=false instantiation, chosen
//      by shape in launch(): topology from global memory, the apply
//      rereading its rows, as in the first design.
//   c. Dirty-row snapshots: a bitmap of the N' rows marks the rows written
//      since the last snapshot (a, b, c, e of each kept walk); a snapshot
//      copies the marked rows (one warp per row, lanes over its 16-byte
//      chunks) and clears them.  At launch start every row counts as dirty
//      (the state does not carry across launches), so the first snapshot
//      of a launch is a full copy, with 8 loads in flight per thread.
//   d. From the measured split: each walk's warp accepts it right after
//      its widths (no phase of its own); the claim builds the walk-pair
//      conflict masks in parallel (one ballot per walk and 32 earlier
//      walks) and scans them in one thread; the total runs the halving
//      levels >= 256 in each thread's own column of its buffer (no
//      barrier) and the last eight in warp 0's registers and shuffles (3
//      barriers instead of about 12); the next iteration's draws and beta
//      load during the current one.  A total kept as a tree in shared
//      memory and updated along the kept walks' paths measured slower than
//      this full pass (PERF.md) and is not used.
// One CTA per replica leaves 68 of 132 SMs idle at B=64; several CTAs or
// a cluster per replica are later work; wgmma and TMA do not apply to
// this integer walk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 4;  // index words per lane: W <= 128
constexpr int kMaxWalks = 128;
constexpr int kWalkChunks = kMaxWalks / 32;  // conflict-mask words a walk
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNull = -1;
constexpr int kC0 = 0, kC1 = 1, kPar = 2, kLcc = 3, kInds = 4;
// Finite-width rows: the pre-slicing width at kWpre, inds from kIndsFw.
constexpr int kWpre = 4, kIndsFw = 5;
enum { kMh = 0, kGreedy = 1, kBase = 2 };

// Profiling build (-DTNCO_WALKER_PROFILE, scripts/profile_torch_walker.py
// only): the clock64() cycles of each phase, measured between block
// barriers, are summed in registers and thread 0 adds them at the end to
// g_walker_prof[FW][replica][phase]; slot kProfSnaps counts the snapshots
// taken.  kAccept stays 0 here (the acceptance runs inside the proposal);
// the slot keeps the layout of scripts/walker_first_design.cu, which the
// script profiles beside this kernel.  The main build has none of it.
enum { kPropose = 0, kAccept, kClaim, kApply, kTotal, kSnapshot, kPrologue,
       kProfSnaps, kEpilogue, kProfSlots };
#ifdef TNCO_WALKER_PROFILE
constexpr int kProfMaxB = 1024;
__device__ unsigned long long g_walker_prof[2][kProfMaxB][kProfSlots];
#define PROF_START()                   \
  long long prof_t = clock64();        \
  unsigned long long prof_acc[kProfSlots] = {}
#define PROF_MARK(slot)                        \
  do {                                         \
    __syncthreads();                           \
    const long long prof_now = clock64();      \
    prof_acc[slot] += prof_now - prof_t;       \
    prof_t = prof_now;                         \
  } while (0)
#define PROF_COUNT(slot) prof_acc[slot] += 1
#define PROF_FLUSH()                                                \
  if (threadIdx.x == 0 && blockIdx.x < kProfMaxB) {                 \
    _Pragma("unroll") for (int s = 0; s < kProfSlots; ++s)          \
      g_walker_prof[FW][blockIdx.x][s] += prof_acc[s];              \
  }
#else
#define PROF_START() (void)0
#define PROF_MARK(slot) (void)0
#define PROF_COUNT(slot) (void)0
#define PROF_FLUSH() (void)0
#endif

struct Params {
  int32_t* rows;
  int32_t* min_rows;
  int32_t* pos;
  float* min_lt;
  int32_t* applied;
  const int32_t* leaf;
  const int32_t* rand_bit;
  const float* u;
  const float* betas;
  const float* log2d;
  int b, n, n_leaves, w, r, p, k, n_int_pad, prob_kind, disable_shared;
  float max_width;  // FW only
  int defer_last;   // FW only: no snapshot at the last iteration
};

// Per-walk scalars kept in shared memory between the phases.
struct Walk {
  int b, a, c, d, e, c0a, c1a, c0b, c1b, take0, acc, keep, fits;
  float l_a, l_b, ln_a, ln_b, new_width_b, w_b;
};

// Shared-memory layout, in 4-byte words.
struct Layout {
  int lcc, red, log2dt, scal, walk, pos, draws, dirty, conf, topo, nib,
      words;
};

__host__ __device__ inline Layout layout(int n, int n_rows, int n_int_pad,
                                         int w, int p, bool topo) {
  Layout l;
  int o = 0;
  l.lcc = o;    o += n;                                 // lcc [N]
  l.red = o;    o += n_int_pad > 1 ? n_int_pad / 2 : 1; // total's buffer
  l.log2dt = o; o += (w | 1) * 32;                      // log2d [32][W|1]
  l.scal = o;   o += kWarps + 1;                        // block scalars
  l.walk = o;   o += p * (int)(sizeof(Walk) / 4);       // Walk [P]
  l.pos = o;    o += p;                                 // pos [P]
  l.draws = o;  o += 6 * p + 2;                         // 2 x (leaf, bit,
                                                        //   u, beta)
  l.dirty = o;  o += (n_rows + 31) / 32;                // dirty bitmap
  l.conf = o;   o += kWalkChunks * p;                   // conflict masks
  l.topo = o;   o += topo ? 3 * n : 0;                  // c0, c1, par [N]
  l.nib = o;    o += topo ? p * w : 0;                  // new_inds_b [P][W]
  l.words = o;
  return l;
}

// Field f (kC0, kC1, kPar) of node id, 0 outside [0, N) (the plain
// version's masked gathers read zeros there).
template <bool TOPO>
__device__ __forceinline__ int field(const int32_t* rows, const int* s_topo,
                                     const Params& q, int id, int f) {
  if (id < 0 || id >= q.n) return 0;
  if constexpr (TOPO) return s_topo[f * q.n + id];
  return rows[(size_t)id * q.r + f];
}

template <int IO>
__device__ __forceinline__ void load_words(const int32_t* rows,
                                           const Params& q, int id, int lane,
                                           uint32_t (&out)[kMaxWords]) {
  const bool ok = id >= 0 && id < q.n;
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    const int w = lane + 32 * j;
    out[j] = (ok && w < q.w) ? (uint32_t)rows[(size_t)id * q.r + IO + w]
                             : 0u;
  }
}

// Popcount route: c * popcount(x & nz) over the warp's words.
__device__ __forceinline__ float pc_width(const uint32_t (&x)[kMaxWords],
                                          const uint32_t (&nz)[kMaxWords],
                                          float c) {
  unsigned cnt = 0;
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) cnt += __popc(x[j] & nz[j]);
  return (float)__reduce_add_sync(kFull, cnt) * c;
}

// The tree's levels over the lanes and then the bits: on entry u[s] is
// lane l's sum of bit s over its words; the butterfly halves over the
// lanes (levels 16..1: lane l's partial of bit s meets lane l ^ h's, and
// each lane keeps half of the bits) so that lane s ends with bit s's sum,
// then the 32 lanes halve over the bits.  Every lane returns the width.
template <int H>
__device__ __forceinline__ void butterfly(float (&u)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = upper ? u[i + H] : u[i];
    const float send = upper ? u[i] : u[i + H];
    u[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

__device__ __forceinline__ float lanes_then_bits(float (&u)[32], int lane) {
  butterfly<16>(u, lane);
  butterfly<8>(u, lane);
  butterfly<4>(u, lane);
  butterfly<2>(u, lane);
  butterfly<1>(u, lane);
  float t = u[0];
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) t = t + __shfl_down_sync(kFull, t, h);
  return __shfl_sync(kFull, t, 0);
}

// Tree route for two lane sets x and y at once (word w = lane + 32 j in
// [j]): the pinned tree of bitops/_width_bn — terms log2d[w, s] for set
// bits, halved over w (zero-padded to 128 words) first, then over the 32
// bits.  s_log2dt is log2d transposed, [s * (W | 1) + w].
__device__ __forceinline__ void tree_widths(const uint32_t (&x)[kMaxWords],
                                            const uint32_t (&y)[kMaxWords],
                                            const float* s_log2dt,
                                            int w_count, int lane, float& wx,
                                            float& wy) {
  float u[32], v[32];
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    float tx[kMaxWords], ty[kMaxWords];
#pragma unroll
    for (int j = 0; j < kMaxWords; ++j) {
      const int w = lane + 32 * j;
      const float d = w < w_count ? s_log2dt[s * (w_count | 1) + w] : 0.0f;
      tx[j] = ((x[j] >> s) & 1u) ? d : 0.0f;
      ty[j] = ((y[j] >> s) & 1u) ? d : 0.0f;
    }
    u[s] = (tx[0] + tx[2]) + (tx[1] + tx[3]);
    v[s] = (ty[0] + ty[2]) + (ty[1] + ty[3]);
  }
  wx = lanes_then_bits(u, lane);
  wy = lanes_then_bits(v, lane);
}

// log2 of the sum of 2^lcc over the internal window [n_leaves, n_leaves +
// n_int_pad) (ids >= N are -inf): max shift, exp2, pinned halving sum —
// costs.log2_total_from_lcc.  The first level pairs the terms while they
// are made; the levels with h >= 256 run in each thread's own column of
// s_red (entries t + 256 k) with no barrier; warp 0 runs the last eight
// (h = 128 .. 1) in registers and shuffles, where zero entries above the
// live count change no sum.  Every thread returns the total.
__device__ float block_log2_total(const float* s_lcc, float* s_red,
                                  float* s_scal, const Params& q) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float mx = -INFINITY;
  for (int i = q.n_leaves + tid; i < q.n; i += kThreads)
    mx = fmaxf(mx, s_lcc[i]);
  for (int h = 16; h >= 1; h >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, h));
  if (lane == 0) s_scal[warp] = mx;
  __syncthreads();
  float m = s_scal[0];
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, s_scal[i]);
  auto term = [&](int j) {
    const int i = q.n_leaves + j;
    return i < q.n ? exp2f(s_lcc[i] - m) : 0.0f;
  };
  const int h = q.n_int_pad >> 1;
  if (h == 0) return m + log2f(term(0));
  for (int i = tid; i < h; i += kThreads) s_red[i] = term(i) + term(i + h);
  for (int hm = h >> 1; hm >= kThreads; hm >>= 1)
    for (int i = tid; i < hm; i += kThreads)
      s_red[i] = s_red[i] + s_red[i + hm];
  __syncthreads();
  if (warp == 0) {
    const int live = h < kThreads ? h : kThreads;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = lane + 32 * k;
      v[k] = i < live ? s_red[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = v[k] + v[k + 4];   // h = 128
    v[0] = v[0] + v[2];                                  // h = 64
    v[1] = v[1] + v[3];
    v[0] = v[0] + v[1];                                  // h = 32
    for (int hh = 16; hh >= 1; hh >>= 1)
      v[0] = v[0] + __shfl_down_sync(kFull, v[0], hh);
    if (lane == 0) s_scal[kWarps] = v[0];
  }
  __syncthreads();
  return m + log2f(s_scal[kWarps]);
}

// Copies row i's 16-byte chunk ch from rows to the min rows; with the
// topology in shared memory, chunk 0 of a node row (c0, c1, par, lcc) is
// taken from there.
template <bool TOPO>
__device__ __forceinline__ void copy_chunk(const int32_t* rows,
                                           int32_t* mrows, const int* s_topo,
                                           const float* s_lcc,
                                           const Params& q, int i, int ch) {
  const size_t off = (size_t)i * q.r + 4 * ch;
  int4 v;
  if (TOPO && ch == 0 && i < q.n)
    v = make_int4(s_topo[i], s_topo[q.n + i], s_topo[2 * q.n + i],
                  __float_as_int(s_lcc[i]));
  else
    v = *reinterpret_cast<const int4*>(rows + off);
  *reinterpret_cast<int4*>(mrows + off) = v;
}

template <bool FW, bool TOPO>
__global__ void __launch_bounds__(kThreads, 1) walker_kernel(Params q) {
  constexpr int kIo = FW ? kIndsFw : kInds;
  extern __shared__ float smem[];
  PROF_START();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = blockIdx.x;
  // FW rows carry the slice row N after the N node rows.
  const int n_rows = q.n + (FW ? 1 : 0);
  const int n_dirty = (n_rows + 31) / 32;
  const size_t rep_words = (size_t)n_rows * q.r;
  int32_t* rows = q.rows + rep * rep_words;
  int32_t* mrows = q.min_rows + rep * rep_words;

  const Layout L = layout(q.n, n_rows, q.n_int_pad, q.w, q.p, TOPO);
  float* s_lcc = smem + L.lcc;
  float* s_red = smem + L.red;
  float* s_log2dt = smem + L.log2dt;
  float* s_scal = smem + L.scal;
  Walk* s_walk = reinterpret_cast<Walk*>(smem + L.walk);
  int* s_pos = reinterpret_cast<int*>(smem + L.pos);
  int* s_leaf = reinterpret_cast<int*>(smem + L.draws);      // [2][P]
  int* s_bit = s_leaf + 2 * q.p;                             // [2][P]
  float* s_u = reinterpret_cast<float*>(s_bit + 2 * q.p);    // [2][P]
  float* s_beta = s_u + 2 * q.p;                             // [2]
  uint32_t* s_dirty = reinterpret_cast<uint32_t*>(smem + L.dirty);
  uint32_t* s_conf = reinterpret_cast<uint32_t*>(smem + L.conf);
  int* s_topo = reinterpret_cast<int*>(smem + L.topo);       // [3][N]
  uint32_t* s_nib = reinterpret_cast<uint32_t*>(smem + L.nib);

  // Each node's chunk 0 (c0, c1, par, lcc): 8 loads in flight a thread.
  for (int i0 = tid; i0 < q.n; i0 += 8 * kThreads) {
    int4 h[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kThreads;
      if (i < q.n)
        h[u] = *reinterpret_cast<const int4*>(rows + (size_t)i * q.r);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= q.n) continue;
      if constexpr (TOPO) {
        s_topo[i] = h[u].x;
        s_topo[q.n + i] = h[u].y;
        s_topo[2 * q.n + i] = h[u].z;
      }
      s_lcc[i] = __int_as_float(h[u].w);
    }
  }
  // log2d transposed, [s * ldt + w]: the odd row stride ldt keeps its
  // filling and every read of it free of bank conflicts.
  const int ldt = q.w | 1;
  for (int i = tid; i < q.w * 32; i += kThreads)
    s_log2dt[(i & 31) * ldt + (i >> 5)] = q.log2d[i];
  for (int i = tid; i < q.p; i += kThreads) {
    s_pos[i] = q.pos[rep * q.p + i];
    const size_t d0 = (size_t)i * q.b + rep;                 // iteration 0
    s_leaf[i] = q.leaf[d0];
    s_bit[i] = q.rand_bit[d0];
    s_u[i] = q.u[d0];
  }
  if (tid == 0) s_beta[0] = q.betas[0];
  for (int i = tid; i < n_dirty; i += kThreads) s_dirty[i] = 0u;
  // Every row counts as dirty until the first snapshot of the launch.
  bool all_dirty = true;
  // The replica's slice lanes, word lane + 32 j in sl[j] (FW).
  uint32_t sl[kMaxWords];
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    const int w = lane + 32 * j;
    sl[j] = (FW && w < q.w) ? (uint32_t)rows[(size_t)q.n * q.r + kIo + w]
                            : 0u;
  }
  const float width_cap = q.max_width + 1e-4f;
  __syncthreads();

  // Width route: popcount where every nonzero log2 dim is one integer c
  // and every partial sum of the tree (at most W * 32 * c) is exact.
  float c = 0.0f;
  for (int i = tid; i < q.w * 32; i += kThreads)
    c = fmaxf(c, s_log2dt[(i & 31) * ldt + (i >> 5)]);
  for (int h = 16; h >= 1; h >>= 1)
    c = fmaxf(c, __shfl_xor_sync(kFull, c, h));
  if (lane == 0) s_scal[warp] = c;
  __syncthreads();
  c = s_scal[0];
  for (int i = 1; i < kWarps; ++i) c = fmaxf(c, s_scal[i]);
  bool uniform = true;
  for (int i = tid; i < q.w * 32; i += kThreads) {
    const float d = s_log2dt[(i & 31) * ldt + (i >> 5)];
    uniform = uniform && (d == 0.0f || d == c);
  }
  const bool pc_route = __syncthreads_and(uniform) && c == truncf(c) &&
                        (float)(q.w * 32) * c < 16777216.0f;
  // The bits with a nonzero log2 dim, word lane + 32 j in nz[j].
  uint32_t nz[kMaxWords];
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) {
    const int w = lane + 32 * j;
    nz[j] = 0u;
    if (w < q.w)
      for (int s = 0; s < 32; ++s)
        nz[j] |= (s_log2dt[s * ldt + w] != 0.0f ? 1u : 0u) << s;
  }

  float min_lt = q.min_lt[rep];
  int applied = 0;
  float lt = block_log2_total(s_lcc, s_red, s_scal, q);
  PROF_MARK(kPrologue);

  for (int it = 0; it < q.k; ++it) {
    const int cur = (it & 1) * q.p, nxt = q.p - cur;
    // The next iteration's draws and beta, loaded now and stored after
    // the apply.
    int n_leaf = 0, n_bit = 0;
    float n_u = 0.0f, n_beta = 0.0f;
    if (tid < q.p && it + 1 < q.k) {
      const size_t dn = ((size_t)(it + 1) * q.p + tid) * q.b + rep;
      n_leaf = q.leaf[dn];
      n_bit = q.rand_bit[dn];
      n_u = q.u[dn];
      if (tid == 0) n_beta = q.betas[it + 1];
    }
    const float beta = s_beta[it & 1];

    // ---- Proposal: one warp per walk, lanes over the index words.
    for (int p = warp; p < q.p; p += kWarps) {
      const int pos = s_pos[p];
      const int par_pos = pos < 0 ? kNull
                                  : field<TOPO>(rows, s_topo, q, pos, kPar);
      const int b = (pos == kNull || par_pos == kNull)
                        ? field<TOPO>(rows, s_topo, q, s_leaf[cur + p], kPar)
                        : pos;
      Walk wk;
      wk.b = b;
      wk.a = b == kNull ? kNull : field<TOPO>(rows, s_topo, q, b, kPar);
      wk.c0b = field<TOPO>(rows, s_topo, q, b, kC0);
      wk.c1b = field<TOPO>(rows, s_topo, q, b, kC1);
      wk.c0a = field<TOPO>(rows, s_topo, q, wk.a, kC0);
      wk.c1a = field<TOPO>(rows, s_topo, q, wk.a, kC1);
      wk.c = wk.c0a == b ? wk.c1a : wk.c0a;
      // The five index rows (and B's width), issued together.
      uint32_t vb[kMaxWords], va[kMaxWords], vc[kMaxWords], x0[kMaxWords],
          x1[kMaxWords];
      load_words<kIo>(rows, q, wk.b, lane, vb);
      load_words<kIo>(rows, q, wk.a, lane, va);
      load_words<kIo>(rows, q, wk.c, lane, vc);
      load_words<kIo>(rows, q, wk.c0b, lane, x0);
      load_words<kIo>(rows, q, wk.c1b, lane, x1);
      wk.w_b = 0.0f;
      if (FW && b >= 0 && b < q.n)
        wk.w_b = __int_as_float(rows[(size_t)b * q.r + kWpre]);
      uint32_t or0 = 0, or1 = 0;
#pragma unroll
      for (int j = 0; j < kMaxWords; ++j) {
        or0 |= x0[j] & vc[j];
        or1 |= x1[j] & vc[j];
      }
      const bool i0 = __any_sync(kFull, or0 != 0);
      const bool i1 = __any_sync(kFull, or1 != 0);
      wk.take0 = (q.disable_shared || (i0 && i1)) ? (s_bit[cur + p] != 0)
                                                  : i0;
      wk.d = wk.take0 ? wk.c0b : wk.c1b;
      wk.e = wk.take0 ? wk.c1b : wk.c0b;
      uint32_t set_b[kMaxWords], set_a[kMaxWords], nib[kMaxWords],
          sliced[kMaxWords];
#pragma unroll
      for (int j = 0; j < kMaxWords; ++j) {
        const uint32_t d = wk.take0 ? x0[j] : x1[j];
        const uint32_t e = wk.take0 ? x1[j] : x0[j];
        nib[j] = (d ^ vc[j]) | (va[j] & vb[j] & vc[j]) |
                 (vb[j] & x0[j] & x1[j]);
        set_b[j] = (d | vc[j]) | sl[j];      // sl is 0 without FW
        set_a[j] = (nib[j] | e) | sl[j];
        sliced[j] = nib[j] & ~sl[j];
      }
      if constexpr (TOPO) {
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j) {
          const int w = lane + 32 * j;
          if (w < q.w) s_nib[p * q.w + w] = nib[j];
        }
      }
      wk.fits = 1;
      wk.new_width_b = 0.0f;
      if (pc_route) {
        if constexpr (FW) {
          wk.new_width_b = pc_width(nib, nz, c);
          wk.fits = pc_width(sliced, nz, c) <= width_cap;
        }
        wk.ln_b = pc_width(set_b, nz, c);
        wk.ln_a = pc_width(set_a, nz, c);
      } else {
        if constexpr (FW) {
          float w_sliced;
          tree_widths(nib, sliced, s_log2dt, q.w, lane, wk.new_width_b,
                      w_sliced);
          wk.fits = w_sliced <= width_cap;
        }
        tree_widths(set_b, set_a, s_log2dt, q.w, lane, wk.ln_b, wk.ln_a);
      }
      const bool a_ok = wk.a >= 0 && wk.a < q.n;
      wk.l_a = a_ok ? s_lcc[wk.a] : 0.0f;
      wk.l_b = (b >= 0 && b < q.n) ? s_lcc[b] : 0.0f;
      // Accept against the pre-round total; the walk advances to A.
      const float m = fmaxf(lt, fmaxf(wk.ln_a, wk.ln_b));
      const float s = exp2f(lt - m) - exp2f(wk.l_a - m) - exp2f(wk.l_b - m) +
                      exp2f(wk.ln_a - m) + exp2f(wk.ln_b - m);
      const float l_new = m + log2f(fmaxf(s, 0x1p-60f));
      bool acc;
      if (q.prob_kind == kMh) {
        acc = log2f(s_u[cur + p]) <= -beta * (l_new - lt);
      } else if (q.prob_kind == kGreedy) {
        acc = l_new <= lt;
      } else {
        acc = true;
      }
      wk.acc = acc && wk.b != kNull && wk.a != kNull && wk.fits;
      wk.keep = 0;
      if (lane == 0) {
        s_walk[p] = wk;
        s_pos[p] = wk.a;
      }
    }
    __syncthreads();
    PROF_MARK(kPropose);

    // ---- Claim: one warp per (walk p, 32 earlier walks) ballots which of
    // them share a node of {A, B, C, D, E} with p; then one thread scans
    // over P: an accepted walk is kept unless it meets a kept walk of
    // lower index (mask words past the walks' chunks meet only zero kept
    // bits).
    const int n_chunks = (q.p + 31) / 32;
    for (int item = warp; item < q.p * n_chunks; item += kWarps) {
      const int p = item / n_chunks, ch = item - p * n_chunks;
      const int o = 32 * ch + lane;
      bool hit = false;
      if (o < p) {
        const Walk& x = s_walk[p];
        const Walk& y = s_walk[o];
        const int xs[5] = {x.a, x.b, x.c, x.d, x.e};
        const int ys[5] = {y.a, y.b, y.c, y.d, y.e};
#pragma unroll
        for (int i = 0; i < 5; ++i)
#pragma unroll
          for (int k = 0; k < 5; ++k) hit |= xs[i] == ys[k];
      }
      const unsigned m = __ballot_sync(kFull, hit);
      if (lane == 0) s_conf[p * kWalkChunks + ch] = m;
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t kept[kWalkChunks] = {0u, 0u, 0u, 0u};
      for (int p = 0; p < q.p; ++p) {
        uint32_t hit = 0u;
#pragma unroll
        for (int ch = 0; ch < kWalkChunks; ++ch)
          hit |= s_conf[p * kWalkChunks + ch] & kept[ch];
        const int keep = s_walk[p].acc && hit == 0u;
        s_walk[p].keep = keep;
        applied += keep;
#pragma unroll
        for (int ch = 0; ch < kWalkChunks; ++ch)
          kept[ch] |= (keep && ch == (p >> 5)) ? 1u << (p & 31) : 0u;
      }
    }
    __syncthreads();
    PROF_MARK(kClaim);

    // ---- Apply: one warp per kept walk (kept row sets are disjoint).
    for (int p = warp; p < q.p; p += kWarps) {
      const Walk wk = s_walk[p];
      if (!wk.keep) continue;
      int32_t* row_b = rows + (size_t)wk.b * q.r;
      if constexpr (TOPO) {
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j) {
          const int w = lane + 32 * j;
          if (w < q.w) row_b[kIo + w] = (int32_t)s_nib[p * q.w + w];
        }
      } else {
        uint32_t vb[kMaxWords], va[kMaxWords], vc[kMaxWords], x0[kMaxWords],
            x1[kMaxWords];
        load_words<kIo>(rows, q, wk.b, lane, vb);
        load_words<kIo>(rows, q, wk.a, lane, va);
        load_words<kIo>(rows, q, wk.c, lane, vc);
        load_words<kIo>(rows, q, wk.c0b, lane, x0);
        load_words<kIo>(rows, q, wk.c1b, lane, x1);
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j) {
          const int w = lane + 32 * j;
          const uint32_t d = wk.take0 ? x0[j] : x1[j];
          if (w < q.w)
            row_b[kIo + w] = (int32_t)((d ^ vc[j]) |
                                       (va[j] & vb[j] & vc[j]) |
                                       (vb[j] & x0[j] & x1[j]));
        }
      }
      if (lane == 0) {
        const int b0 = wk.c0b == wk.e ? wk.c : wk.c0b;
        const int b1 = wk.c1b == wk.e ? wk.c : wk.c1b;
        const int a0 = wk.c0a == wk.c ? wk.e : wk.c0a;
        const int a1 = wk.c1a == wk.c ? wk.e : wk.c1a;
        if constexpr (TOPO) {
          s_topo[wk.b] = b0;
          s_topo[q.n + wk.b] = b1;
          s_topo[2 * q.n + wk.b] = wk.a;
          s_topo[wk.a] = a0;
          s_topo[q.n + wk.a] = a1;
          s_topo[2 * q.n + wk.c] = wk.b;
          s_topo[2 * q.n + wk.e] = wk.a;
        } else {
          int32_t* row_a = rows + (size_t)wk.a * q.r;
          row_b[kC0] = b0;
          row_b[kC1] = b1;
          row_b[kPar] = wk.a;
          row_a[kC0] = a0;
          row_a[kC1] = a1;
          rows[(size_t)wk.c * q.r + kPar] = wk.b;
          rows[(size_t)wk.e * q.r + kPar] = wk.a;
        }
        if constexpr (FW)
          row_b[kWpre] = __float_as_int(wk.w_b + (wk.new_width_b - wk.w_b));
        s_lcc[wk.b] = wk.l_b + (wk.ln_b - wk.l_b);
        s_lcc[wk.a] = wk.l_a + (wk.ln_a - wk.l_a);
        const int touched[4] = {wk.a, wk.b, wk.c, wk.e};
#pragma unroll
        for (int t = 0; t < 4; ++t)
          atomicOr(&s_dirty[touched[t] >> 5], 1u << (touched[t] & 31));
      }
    }
    if (tid < q.p && it + 1 < q.k) {
      s_leaf[nxt + tid] = n_leaf;
      s_bit[nxt + tid] = n_bit;
      s_u[nxt + tid] = n_u;
      if (tid == 0) s_beta[(it + 1) & 1] = n_beta;
    }
    __syncthreads();
    PROF_MARK(kApply);

    // ---- Exact total and the min snapshot on a strict improvement
    // (deferred at the last iteration of a segment that ends in a
    // reslice: the caller snapshots after it).
    lt = block_log2_total(s_lcc, s_red, s_scal, q);
    PROF_MARK(kTotal);
    const bool deferred = FW && q.defer_last && it == q.k - 1;
    if (lt < min_lt && !deferred) {
      min_lt = lt;
      if (all_dirty) {
        // Every row: 8 independent 16-byte loads in flight per thread.
        const int4* src = reinterpret_cast<const int4*>(rows);
        int4* dst = reinterpret_cast<int4*>(mrows);
        const int n4 = (int)(rep_words / 4);
        for (int i0 = tid; i0 < n4; i0 += 8 * kThreads) {
          int4 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = i0 + u * kThreads;
            if (i < n4) v[u] = src[i];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = i0 + u * kThreads;
            if (i < n4) dst[i] = v[u];
          }
        }
        if constexpr (TOPO) {
          __syncthreads();  // chunk 0 of the node rows from shared memory
          for (int i = tid; i < q.n; i += kThreads)
            copy_chunk<true>(rows, mrows, s_topo, s_lcc, q, i, 0);
        }
        for (int i = tid; i < n_dirty; i += kThreads) s_dirty[i] = 0u;
        all_dirty = false;
      } else {
        // The marked rows: one warp per row, lanes over its chunks.
        const int n_ch = q.r / 4;
        for (int wi = warp; wi < n_dirty; wi += kWarps) {
          uint32_t bits = s_dirty[wi];
          __syncwarp();
          if (lane == 0) s_dirty[wi] = 0u;
          while (bits) {
            const int i = 32 * wi + __ffs(bits) - 1;
            bits &= bits - 1;
            if (lane < n_ch)
              copy_chunk<TOPO>(rows, mrows, s_topo, s_lcc, q, i, lane);
          }
        }
      }
      PROF_COUNT(kProfSnaps);
    }
    PROF_MARK(kSnapshot);
  }

  __syncthreads();
  for (int i = tid; i < q.n; i += kThreads) {
    if constexpr (TOPO) {
      *reinterpret_cast<int4*>(rows + (size_t)i * q.r) =
          make_int4(s_topo[i], s_topo[q.n + i], s_topo[2 * q.n + i],
                    __float_as_int(s_lcc[i]));
    } else {
      rows[(size_t)i * q.r + kLcc] = __float_as_int(s_lcc[i]);
    }
  }
  for (int i = tid; i < q.p; i += kThreads) q.pos[rep * q.p + i] = s_pos[i];
  if (tid == 0) {
    q.min_lt[rep] = min_lt;
    q.applied[rep] += applied;
  }
  PROF_MARK(kEpilogue);
  PROF_FLUSH();
}

template <bool FW, bool TOPO>
int start(const Params& q, size_t smem, void* stream) {
  // Raise the kernel's dynamic shared-memory limit once per new size, so
  // that launches captured into a CUDA graph make no attribute call.
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        walker_kernel<FW, TOPO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  walker_kernel<FW, TOPO><<<q.b, kThreads, smem, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}

template <bool FW>
int launch(const Params& q, void* stream) {
  if (q.b <= 0 || q.k <= 0) return 0;
  const int io = FW ? kIndsFw : kInds;
  if (q.w > 32 * kMaxWords || q.w + io > 128 || q.r % 4 || q.r < io + q.w ||
      q.p < 1 || q.p > kMaxWalks || q.n <= q.n_leaves)
    return (int)cudaErrorInvalidValue;
  // The block's shared-memory limit, read once (no call under capture).
  static int smem_optin = 0;
  if (smem_optin == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // The topology in shared memory where it fits: chosen by shape only.
  const int n_rows = q.n + (FW ? 1 : 0);
  const size_t topo = sizeof(float) *
      (size_t)layout(q.n, n_rows, q.n_int_pad, q.w, q.p, true).words;
  if (topo <= (size_t)smem_optin) return start<FW, true>(q, topo, stream);
  const size_t flat = sizeof(float) *
      (size_t)layout(q.n, n_rows, q.n_int_pad, q.w, q.p, false).words;
  return start<FW, false>(q, flat, stream);
}

}  // namespace

#ifdef TNCO_WALKER_PROFILE
// Copies the phase cycles of the first b replicas of form fw (0 IM, 1 FW)
// to host memory out[b][kProfSlots] and zeroes them.
extern "C" int tnco_walker_prof(void* out, int fw, int b) {
  const size_t off = (size_t)fw * kProfMaxB * kProfSlots;
  const size_t bytes = sizeof(unsigned long long) * (size_t)b * kProfSlots;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_walker_prof, bytes,
                               off * sizeof(unsigned long long));
  static unsigned long long zeros[kProfMaxB * kProfSlots];
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_walker_prof, zeros, sizeof(zeros),
                             off * sizeof(unsigned long long));
  return (int)err;
}
#endif

extern "C" int tnco_walker_im(void* rows, void* min_rows, void* pos,
                              void* min_lt, void* applied,
                              const void* leaf,
                              const void* rand_bit, const void* u,
                              const void* betas, const void* log2d, int b,
                              int n, int n_leaves, int w, int r, int p, int k,
                              int n_int_pad, int prob_kind,
                              int disable_shared, void* stream) {
  const Params q{(int32_t*)rows, (int32_t*)min_rows, (int32_t*)pos,
                 (float*)min_lt, (int32_t*)applied, (const int32_t*)leaf,
                 (const int32_t*)rand_bit, (const float*)u,
                 (const float*)betas, (const float*)log2d, b, n, n_leaves, w,
                 r, p, k, n_int_pad, prob_kind, disable_shared, 0.0f, 0};
  return launch<false>(q, stream);
}

extern "C" int tnco_walker_fw(void* rows, void* min_rows, void* pos,
                              void* min_lt, void* applied,
                              const void* leaf,
                              const void* rand_bit, const void* u,
                              const void* betas, const void* log2d, int b,
                              int n, int n_leaves, int w, int r, int p, int k,
                              int n_int_pad, int prob_kind,
                              int disable_shared, float max_width,
                              int defer_last, void* stream) {
  const Params q{(int32_t*)rows, (int32_t*)min_rows, (int32_t*)pos,
                 (float*)min_lt, (int32_t*)applied, (const int32_t*)leaf,
                 (const int32_t*)rand_bit, (const float*)u,
                 (const float*)betas, (const float*)log2d, b, n, n_leaves, w,
                 r, p, k, n_int_pad, prob_kind, disable_shared, max_width,
                 defer_last};
  return launch<true>(q, stream);
}
