// The walker kernel's first design, kept as the baseline that
// scripts/profile_torch_walker.py --baseline runs in turns with
// tnco_tpu_torch/csrc/walker.cu: that file as it was before its redesign
// (topology in shared memory, per-lane width sums, dirty-row snapshots;
// see its header), unchanged but for the profiling macros (PROF_*, active
// only with -DTNCO_WALKER_PROFILE) at its phase boundaries and
// tnco_walker_prof.  Built without the define, it is that kernel as the
// main path ran it.  Nothing on the main path builds this file.
//
// K5: the multi-walk SA walker — the port's counterpart of the TPU kernel
// tnco_tpu/kernels/pallas_walker.py:_make_kernel, in its infinite-memory
// form (fw=False, launched by _run_walker; entry point tnco_walker_im) and
// its finite-width form (fw=True, launched once per segment by
// _walker_fw_segment; entry point tnco_walker_fw).  Both are one template,
// walker_kernel<FW>, sharing every device function.
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
// Bound on an H100: memory latency, not bandwidth or arithmetic.  The
// replica's state (3241 x 68 words = 0.88 MB at Sycamore m=20, 3242 x 72
// in the FW layout) does not fit an SM's 228 KB of shared memory, so rows
// stay in global memory (L2); only the lcc column (N floats), the
// pinned-tree buffer, the log2 dims and the per-walk scalars live in
// shared memory, which makes the per-iteration total a shared-memory
// pass.  Per iteration a walk reads 5 rows (one warp per walk, lanes over
// the index words), the claim scan is sequential over P in one warp, and
// kept walks write their B and A rows and the par of C and E directly
// (kept sets are disjoint).  A snapshot copies the replica's rows with
// 16-byte loads.  One CTA per replica leaves 68 of 132 SMs idle at B=64;
// wgmma, TMA and several replicas per CTA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 4;  // index words per lane: W <= 128
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNull = -1;
constexpr int kC0 = 0, kC1 = 1, kPar = 2, kLcc = 3, kInds = 4;
// Finite-width rows: the pre-slicing width at kWpre, inds from kIndsFw.
constexpr int kWpre = 4, kIndsFw = 5;
enum { kMh = 0, kGreedy = 1, kBase = 2 };

// Profiling build (-DTNCO_WALKER_PROFILE, scripts/profile_torch_walker.py
// only): thread 0 adds the clock64() cycles of each phase, measured
// between block barriers, to g_walker_prof[FW][replica][phase]; slot
// kProfSnaps counts the snapshots taken.  The main build has none of it.
enum { kPropose = 0, kAccept, kClaim, kApply, kTotal, kSnapshot, kOther,
       kProfSnaps, kEpilogue, kProfSlots };
#ifdef TNCO_WALKER_PROFILE
constexpr int kProfMaxB = 1024;
__device__ unsigned long long g_walker_prof[2][kProfMaxB][kProfSlots];
#define PROF_START() long long prof_t = clock64()
#define PROF_MARK(slot)                                             \
  do {                                                              \
    __syncthreads();                                                \
    if (threadIdx.x == 0 && blockIdx.x < kProfMaxB) {               \
      const long long t = clock64();                                \
      g_walker_prof[FW][blockIdx.x][slot] += t - prof_t;            \
      prof_t = t;                                                   \
    }                                                               \
  } while (0)
#define PROF_COUNT(slot) \
  if (threadIdx.x == 0 && blockIdx.x < kProfMaxB) g_walker_prof[FW][blockIdx.x][slot] += 1
#else
#define PROF_START() (void)0
#define PROF_MARK(slot) (void)0
#define PROF_COUNT(slot) (void)0
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
  float l_a, l_b, ln_a, ln_b, new_width_b;
};

__device__ __forceinline__ int field(const int32_t* rows, const Params& q,
                                     int id, int f) {
  return (id >= 0 && id < q.n) ? rows[(size_t)id * q.r + f] : 0;
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

// Width of a warp's lane set (word w = lane + 32 j in x[j]): the pinned
// tree of bitops/_width_bn — terms log2d[w, s] for set bits, halved over
// w (zero-padded to wp = pow2(W)) first, then over the 32 bits.
__device__ float warp_width(const uint32_t (&x)[kMaxWords],
                            const float* s_log2d, int w_count, int wp,
                            int lane) {
  float mine = 0.0f;
  for (int s = 0; s < 32; ++s) {
    float t[kMaxWords];
#pragma unroll
    for (int j = 0; j < kMaxWords; ++j) {
      const int w = lane + 32 * j;
      t[j] = (w < w_count && ((x[j] >> s) & 1u)) ? s_log2d[w * 32 + s]
                                                 : 0.0f;
    }
    int h = wp >> 1;
    if (h == 64) {
      t[0] = t[0] + t[2];
      t[1] = t[1] + t[3];
      h = 32;
    }
    if (h == 32) {
      t[0] = t[0] + t[1];
      h = 16;
    }
    for (; h >= 1; h >>= 1) t[0] = t[0] + __shfl_down_sync(kFull, t[0], h);
    const float v = __shfl_sync(kFull, t[0], 0);
    if (lane == s) mine = v;
  }
  for (int h = 16; h >= 1; h >>= 1)
    mine = mine + __shfl_down_sync(kFull, mine, h);
  return __shfl_sync(kFull, mine, 0);
}

// log2 of the sum of 2^lcc over the internal window [n_leaves, n_leaves +
// n_int_pad) (ids >= N are -inf): max shift, exp2, pinned halving sum —
// costs.log2_total_from_lcc.  Every thread returns the total.
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
  float total;
  int h = q.n_int_pad >> 1;
  if (h == 0) {
    total = term(0);
  } else {
    for (int i = tid; i < h; i += kThreads) s_red[i] = term(i) + term(i + h);
    __syncthreads();
    for (h >>= 1; h >= 1; h >>= 1) {
      for (int i = tid; i < h; i += kThreads) s_red[i] = s_red[i] + s_red[i + h];
      __syncthreads();
    }
    total = s_red[0];
  }
  __syncthreads();  // s_scal and s_red are reused by the next call
  return m + log2f(total);
}

// The five index rows of a walk's neighbourhood and new_inds_b.
struct Words {
  uint32_t b[kMaxWords], a[kMaxWords], c[kMaxWords], x0[kMaxWords],
      x1[kMaxWords];
};

template <int IO>
__device__ __forceinline__ void walk_words(const int32_t* rows,
                                           const Params& q, const Walk& wk,
                                           int lane, Words& v) {
  load_words<IO>(rows, q, wk.b, lane, v.b);
  load_words<IO>(rows, q, wk.a, lane, v.a);
  load_words<IO>(rows, q, wk.c, lane, v.c);
  load_words<IO>(rows, q, wk.c0b, lane, v.x0);
  load_words<IO>(rows, q, wk.c1b, lane, v.x1);
}

__device__ __forceinline__ uint32_t new_inds_b(const Words& v, int take0,
                                               int j) {
  const uint32_t d = take0 ? v.x0[j] : v.x1[j];
  return (d ^ v.c[j]) | (v.a[j] & v.b[j] & v.c[j]) |
         (v.b[j] & v.x0[j] & v.x1[j]);
}

template <bool FW>
__global__ void __launch_bounds__(kThreads) walker_kernel(Params q) {
  constexpr int kIo = FW ? kIndsFw : kInds;
  extern __shared__ float smem[];
  PROF_START();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = blockIdx.x;
  // FW rows carry the slice row N after the N node rows.
  const size_t rep_words = (size_t)(q.n + (FW ? 1 : 0)) * q.r;
  int32_t* rows = q.rows + rep * rep_words;
  int32_t* mrows = q.min_rows + rep * rep_words;

  float* s_lcc = smem;                                   // [N]
  float* s_red = s_lcc + q.n;                            // [n_int_pad / 2]
  float* s_log2d = s_red + (q.n_int_pad > 1 ? q.n_int_pad / 2 : 1);
  float* s_scal = s_log2d + q.w * 32;                    // [kWarps]
  Walk* s_walk = reinterpret_cast<Walk*>(s_scal + kWarps);  // [P]
  int* s_pos = reinterpret_cast<int*>(s_walk + q.p);     // [P]

  for (int i = tid; i < q.n; i += kThreads)
    s_lcc[i] = __int_as_float(rows[(size_t)i * q.r + kLcc]);
  for (int i = tid; i < q.w * 32; i += kThreads) s_log2d[i] = q.log2d[i];
  for (int i = tid; i < q.p; i += kThreads) s_pos[i] = q.pos[rep * q.p + i];
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

  int wp = 1;
  while (wp < q.w) wp <<= 1;
  float min_lt = q.min_lt[rep];
  int applied = 0;
  float lt = block_log2_total(s_lcc, s_red, s_scal, q);
  PROF_MARK(kOther);

  for (int it = 0; it < q.k; ++it) {
    const size_t draw0 = (size_t)it * q.p * q.b;
    // ---- Proposal: one warp per walk, lanes over the index words.
    for (int p = warp; p < q.p; p += kWarps) {
      const size_t di = draw0 + (size_t)p * q.b + rep;
      const int pos = s_pos[p];
      const int par_pos = pos < 0 ? kNull : field(rows, q, pos, kPar);
      const int b = (pos == kNull || par_pos == kNull)
                        ? field(rows, q, q.leaf[di], kPar) : pos;
      Walk wk;
      wk.b = b;
      wk.a = b == kNull ? kNull : field(rows, q, b, kPar);
      wk.c0b = field(rows, q, b, kC0);
      wk.c1b = field(rows, q, b, kC1);
      wk.c0a = field(rows, q, wk.a, kC0);
      wk.c1a = field(rows, q, wk.a, kC1);
      wk.c = wk.c0a == b ? wk.c1a : wk.c0a;
      Words v;
      walk_words<kIo>(rows, q, wk, lane, v);
      uint32_t or0 = 0, or1 = 0;
#pragma unroll
      for (int j = 0; j < kMaxWords; ++j) {
        or0 |= v.x0[j] & v.c[j];
        or1 |= v.x1[j] & v.c[j];
      }
      const bool i0 = __any_sync(kFull, or0 != 0);
      const bool i1 = __any_sync(kFull, or1 != 0);
      wk.take0 = (q.disable_shared || (i0 && i1)) ? (q.rand_bit[di] != 0)
                                                  : i0;
      wk.d = wk.take0 ? wk.c0b : wk.c1b;
      wk.e = wk.take0 ? wk.c1b : wk.c0b;
      uint32_t set_b[kMaxWords], set_a[kMaxWords], nib[kMaxWords];
#pragma unroll
      for (int j = 0; j < kMaxWords; ++j) {
        const uint32_t d = wk.take0 ? v.x0[j] : v.x1[j];
        const uint32_t e = wk.take0 ? v.x1[j] : v.x0[j];
        nib[j] = new_inds_b(v, wk.take0, j);
        set_b[j] = (d | v.c[j]) | sl[j];      // sl is 0 without FW
        set_a[j] = (nib[j] | e) | sl[j];
      }
      wk.fits = 1;
      wk.new_width_b = 0.0f;
      if constexpr (FW) {
        uint32_t sliced[kMaxWords];
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j) sliced[j] = nib[j] & ~sl[j];
        wk.new_width_b = warp_width(nib, s_log2d, q.w, wp, lane);
        wk.fits = warp_width(sliced, s_log2d, q.w, wp, lane) <= width_cap;
      }
      wk.ln_b = warp_width(set_b, s_log2d, q.w, wp, lane);
      wk.ln_a = warp_width(set_a, s_log2d, q.w, wp, lane);
      const bool a_ok = wk.a >= 0 && wk.a < q.n;
      wk.l_a = a_ok ? s_lcc[wk.a] : 0.0f;
      wk.l_b = (b >= 0 && b < q.n) ? s_lcc[b] : 0.0f;
      wk.acc = 0;
      wk.keep = 0;
      if (lane == 0) s_walk[p] = wk;
    }
    __syncthreads();
    PROF_MARK(kPropose);

    // ---- Accept: one thread per walk; every walk advances to A.
    const float beta = q.betas[it];
    for (int p = tid; p < q.p; p += kThreads) {
      Walk& wk = s_walk[p];
      const float m = fmaxf(lt, fmaxf(wk.ln_a, wk.ln_b));
      const float s = exp2f(lt - m) - exp2f(wk.l_a - m) - exp2f(wk.l_b - m) +
                      exp2f(wk.ln_a - m) + exp2f(wk.ln_b - m);
      const float l_new = m + log2f(fmaxf(s, 0x1p-60f));
      bool acc;
      if (q.prob_kind == kMh) {
        acc = log2f(q.u[draw0 + (size_t)p * q.b + rep]) <=
              -beta * (l_new - lt);
      } else if (q.prob_kind == kGreedy) {
        acc = l_new <= lt;
      } else {
        acc = true;
      }
      wk.acc = acc && wk.b != kNull && wk.a != kNull && wk.fits;
      s_pos[p] = wk.a;
    }
    __syncthreads();
    PROF_MARK(kAccept);

    // ---- Claim scan: sequential over P in warp 0.
    if (warp == 0) {
      for (int p = 0; p < q.p; ++p) {
        const Walk& wk = s_walk[p];
        bool blocked = false;
        if (wk.acc) {
          const int x[5] = {wk.a, wk.b, wk.c, wk.d, wk.e};
          for (int o = lane; o < p; o += 32) {
            const Walk& ot = s_walk[o];
            if (!ot.keep) continue;
            const int y[5] = {ot.a, ot.b, ot.c, ot.d, ot.e};
#pragma unroll
            for (int i = 0; i < 5; ++i)
#pragma unroll
              for (int j = 0; j < 5; ++j) blocked |= x[i] == y[j];
          }
          blocked = __any_sync(kFull, blocked);
        }
        if (lane == 0) {
          s_walk[p].keep = wk.acc && !blocked;
          applied += s_walk[p].keep;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    PROF_MARK(kClaim);

    // ---- Apply: one warp per kept walk (kept row sets are disjoint).
    for (int p = warp; p < q.p; p += kWarps) {
      const Walk wk = s_walk[p];
      if (!wk.keep) continue;
      Words v;
      walk_words<kIo>(rows, q, wk, lane, v);
      int32_t* row_b = rows + (size_t)wk.b * q.r;
#pragma unroll
      for (int j = 0; j < kMaxWords; ++j) {
        const int w = lane + 32 * j;
        if (w < q.w) row_b[kIo + w] = (int32_t)new_inds_b(v, wk.take0, j);
      }
      if (lane == 0) {
        int32_t* row_a = rows + (size_t)wk.a * q.r;
        row_b[kC0] = wk.c0b == wk.e ? wk.c : wk.c0b;
        row_b[kC1] = wk.c1b == wk.e ? wk.c : wk.c1b;
        row_b[kPar] = wk.a;
        if constexpr (FW) {
          const float w_b = __int_as_float(row_b[kWpre]);
          row_b[kWpre] = __float_as_int(w_b + (wk.new_width_b - w_b));
        }
        row_a[kC0] = wk.c0a == wk.c ? wk.e : wk.c0a;
        row_a[kC1] = wk.c1a == wk.c ? wk.e : wk.c1a;
        rows[(size_t)wk.c * q.r + kPar] = wk.b;
        rows[(size_t)wk.e * q.r + kPar] = wk.a;
        s_lcc[wk.b] = wk.l_b + (wk.ln_b - wk.l_b);
        s_lcc[wk.a] = wk.l_a + (wk.ln_a - wk.l_a);
      }
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
      const int4* src = reinterpret_cast<const int4*>(rows);
      int4* dst = reinterpret_cast<int4*>(mrows);
      const size_t n4 = rep_words / 4;
      for (size_t i = tid; i < n4; i += kThreads) dst[i] = src[i];
      PROF_COUNT(kProfSnaps);
    }
    PROF_MARK(kSnapshot);
  }

  __syncthreads();
  for (int i = tid; i < q.n; i += kThreads)
    rows[(size_t)i * q.r + kLcc] = __float_as_int(s_lcc[i]);
  for (int i = tid; i < q.p; i += kThreads) q.pos[rep * q.p + i] = s_pos[i];
  if (tid == 0) {
    q.min_lt[rep] = min_lt;
    q.applied[rep] += applied;
  }
  PROF_MARK(kOther);
}

size_t smem_bytes(int n, int n_int_pad, int w, int p) {
  return sizeof(float) * ((size_t)n + (n_int_pad > 1 ? n_int_pad / 2 : 1) +
                          (size_t)w * 32 + kWarps) +
         sizeof(Walk) * (size_t)p + sizeof(int) * (size_t)p;
}

template <bool FW>
int launch(const Params& q, void* stream) {
  if (q.b <= 0 || q.k <= 0) return 0;
  const int io = FW ? kIndsFw : kInds;
  if (q.w > 32 * kMaxWords || q.w + io > 128 || q.r % 4 || q.r < io + q.w ||
      q.p < 1 || q.n <= q.n_leaves)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(q.n, q.n_int_pad, q.w, q.p);
  // Raise the kernel's dynamic shared-memory limit once per new size, so
  // that launches captured into a CUDA graph make no attribute call.
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        walker_kernel<FW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  walker_kernel<FW><<<q.b, kThreads, smem, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
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
