// tnco-tpu-torch native host core (C++17, ctypes ABI): the port's own copy
// of the JAX package's native core, unchanged below this comment, so that
// both libraries built on one host with the same flags compute the same
// bits.  tnco_tpu_torch/native/__init__.py builds it with g++ at first use.
//
// Host-side exactness and CPU engines mirroring the reference's native
// surface (include/tnco/*.hpp): flat-tree validation, exact big-integer
// total-cost audit (replacing MPFR float1024, include/tnco/fixed_float.hpp),
// and a multithreaded CPU SA engine (the reference's single-thread C++ SA
// kernel x joblib processes, run here as std::thread replicas).
//
// Data model matches the device kernels: nodes int32[N,3] (c0,c1,parent,
// -1=null, leaves first, root last), index sets uint32[N,W] bitset lanes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int32_t kNull = -1;

// ---------------------------------------------------------------------------
// Minimal unsigned bigint: sum of products of dimensions (exact audit).
// ---------------------------------------------------------------------------
struct BigUint {
  // little-endian 32-bit limbs
  std::vector<uint32_t> limbs;

  BigUint() : limbs{0} {}
  explicit BigUint(uint64_t v) {
    limbs.push_back(static_cast<uint32_t>(v));
    limbs.push_back(static_cast<uint32_t>(v >> 32));
    trim();
  }

  void trim() {
    while (limbs.size() > 1 && limbs.back() == 0) limbs.pop_back();
  }

  bool is_zero() const { return limbs.size() == 1 && limbs[0] == 0; }

  void mul_u32(uint32_t m) {
    uint64_t carry = 0;
    for (auto& limb : limbs) {
      uint64_t cur = static_cast<uint64_t>(limb) * m + carry;
      limb = static_cast<uint32_t>(cur);
      carry = cur >> 32;
    }
    while (carry) {
      limbs.push_back(static_cast<uint32_t>(carry));
      carry >>= 32;
    }
    trim();
  }

  void add(const BigUint& other) {
    const size_t n = std::max(limbs.size(), other.limbs.size());
    limbs.resize(n, 0);
    uint64_t carry = 0;
    for (size_t i = 0; i < n; ++i) {
      uint64_t cur = static_cast<uint64_t>(limbs[i]) + carry +
                     (i < other.limbs.size() ? other.limbs[i] : 0);
      limbs[i] = static_cast<uint32_t>(cur);
      carry = cur >> 32;
    }
    if (carry) limbs.push_back(static_cast<uint32_t>(carry));
  }

  // log2 with ~double precision (top 128 bits as long double mantissa)
  double log2() const {
    if (is_zero()) return -std::numeric_limits<double>::infinity();
    long double mant = 0.0L;
    int taken = 0;
    size_t i = limbs.size();
    while (i > 0 && taken < 4) {
      --i;
      mant = mant * 4294967296.0L + limbs[i];
      ++taken;
    }
    // i limbs remain below the mantissa
    return static_cast<double>(std::log2(mant) + 32.0L * i);
  }

  // decimal string (repeated division by 1e9)
  std::string to_decimal() const {
    if (is_zero()) return "0";
    std::vector<uint32_t> work(limbs);
    std::string out;
    while (!(work.size() == 1 && work[0] == 0)) {
      uint64_t rem = 0;
      for (size_t i = work.size(); i-- > 0;) {
        uint64_t cur = (rem << 32) | work[i];
        work[i] = static_cast<uint32_t>(cur / 1000000000ULL);
        rem = cur % 1000000000ULL;
      }
      while (work.size() > 1 && work.back() == 0) work.pop_back();
      char buf[16];
      if (work.size() == 1 && work[0] == 0) {
        std::snprintf(buf, sizeof(buf), "%llu",
                      static_cast<unsigned long long>(rem));
      } else {
        std::snprintf(buf, sizeof(buf), "%09llu",
                      static_cast<unsigned long long>(rem));
      }
      out.insert(0, buf);
    }
    return out;
  }
};

struct TreeView {
  const int32_t* nodes;  // [n, 3]
  int64_t n;

  int32_t c0(int64_t i) const { return nodes[3 * i]; }
  int32_t c1(int64_t i) const { return nodes[3 * i + 1]; }
  int32_t parent(int64_t i) const { return nodes[3 * i + 2]; }
  bool is_leaf(int64_t i) const { return c0(i) == kNull; }
};

BigUint contraction_cost(const uint32_t* lanes_a, const uint32_t* lanes_b,
                         int64_t w, const int64_t* dims) {
  BigUint cost(1);
  for (int64_t word = 0; word < w; ++word) {
    uint32_t bits = lanes_a[word] | lanes_b[word];
    while (bits) {
      const int bit = __builtin_ctz(bits);
      bits &= bits - 1;
      cost.mul_u32(static_cast<uint32_t>(dims[32 * word + bit]));
    }
  }
  return cost;
}

}  // namespace

extern "C" {

// Validates the flat tree + per-contraction index rules.
// Returns 0 if valid, else a positive error code:
//  1 bad node links, 2 last not root, 3 root count != 1, 4 leaves not
//  first, 5 bad node count, 6 parent/child mismatch, 7 invalid contraction
//  (xor not subset / out not subset), 8 missing shared index.
int32_t tnco_validate(const int32_t* nodes, int64_t n,
                      const uint32_t* inds, int64_t w,
                      int32_t check_shared) {
  TreeView t{nodes, n};
  int64_t n_leaves = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t a = t.c0(i), b = t.c1(i), p = t.parent(i);
    if ((a == kNull) != (b == kNull)) return 1;
    for (int32_t x : {a, b, p}) {
      if (x != kNull && (x < 0 || x >= n)) return 1;
    }
    if (a != kNull && a == b) return 1;
    if (a != kNull && p != kNull && (p == a || p == b)) return 1;
    if (t.is_leaf(i)) ++n_leaves;
  }
  if (t.parent(n - 1) != kNull) return 2;
  int64_t roots = 0;
  for (int64_t i = 0; i < n; ++i) roots += (t.parent(i) == kNull);
  if (roots != 1) return 3;
  for (int64_t i = 0; i < n_leaves; ++i) {
    if (!t.is_leaf(i)) return 4;
  }
  if (n != 2 * n_leaves - 1) return 5;

  std::vector<int32_t> child_claims(n, 0), parent_claims(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    if (!t.is_leaf(i)) {
      ++child_claims[t.c0(i)];
      ++child_claims[t.c1(i)];
    }
    if (t.parent(i) != kNull) ++parent_claims[t.parent(i)];
  }
  for (int64_t i = 0; i < n; ++i) {
    if (child_claims[i] != (t.parent(i) == kNull ? 0 : 1)) return 6;
    if (parent_claims[i] != (t.is_leaf(i) ? 0 : 2)) return 6;
  }

  for (int64_t i = 0; i < n; ++i) {
    if (t.is_leaf(i)) continue;
    const uint32_t* xa = inds + w * t.c0(i);
    const uint32_t* xb = inds + w * t.c1(i);
    const uint32_t* xo = inds + w * i;
    bool shared = false;
    for (int64_t k = 0; k < w; ++k) {
      const uint32_t sym = xa[k] ^ xb[k];
      const uint32_t uni = xa[k] | xb[k];
      if (sym & ~xo[k]) return 7;
      if (xo[k] & ~uni) return 7;
      shared |= (xa[k] & xb[k]) != 0;
    }
    if (check_shared && !shared) return 8;
  }
  return 0;
}

// Exact total cost: writes the decimal string into out (returns length
// needed; out may be null to query). Also writes log2 into *log2_out.
int64_t tnco_total_cost(const int32_t* nodes, int64_t n,
                        const uint32_t* inds, int64_t w,
                        const int64_t* dims, double* log2_out, char* out,
                        int64_t out_cap) {
  TreeView t{nodes, n};
  BigUint total(0);
  for (int64_t i = 0; i < n; ++i) {
    if (t.is_leaf(i)) continue;
    BigUint c =
        contraction_cost(inds + w * t.c0(i), inds + w * t.c1(i), w, dims);
    total.add(c);
  }
  if (log2_out) *log2_out = total.log2();
  const std::string dec = total.to_decimal();
  const int64_t needed = static_cast<int64_t>(dec.size()) + 1;
  if (out && out_cap >= needed) {
    std::memcpy(out, dec.c_str(), needed);
  }
  return needed;
}

namespace {

// ---------------------------------------------------------------------------
// CPU SA engine: one replica (mt19937, log2-domain doubles).
// ---------------------------------------------------------------------------
struct SAReplica {
  int64_t n, w, n_leaves;
  std::vector<int32_t> c0, c1, par;
  std::vector<uint32_t> inds, hyper;
  std::vector<double> lcc;
  const double* log2d;  // [w*32]
  // > 0 when every index has the same log2 dim: widths become
  // popcount * uniform_d (one popcnt per word instead of per-bit
  // table adds) — the common case for circuit TNs (all dims 2).
  double uniform_d = -1.0;
  std::mt19937 prng;

  void detect_uniform(int64_t n_inds) {
    uniform_d = -1.0;
    if (n_inds <= 0) return;
    const double d = log2d[0];
    if (d <= 0) return;
    for (int64_t i = 1; i < n_inds; ++i) {
      if (log2d[i] != d) return;
    }
    uniform_d = d;
  }

  // Dirty-row tracking for incremental best-state snapshots: rows whose
  // nodes/inds diverge from the best buffers since the last sync.  An
  // improving sweep then copies O(moves-since-last-best) rows instead of
  // the whole state (the full copy dominated Sycamore-scale runs).
  std::vector<int32_t> dirty_rows;
  std::vector<uint8_t> dirty_flag;

  void mark_dirty(int32_t row) {
    if (!dirty_flag[row]) {
      dirty_flag[row] = 1;
      dirty_rows.push_back(row);
    }
  }

  void init_dirty() {
    dirty_flag.assign(n, 0);
    dirty_rows.clear();
  }

  // Sync the best buffers (flat [n,3] nodes + [n,w] inds) to the current
  // state by copying only the dirty rows.
  void sync_best(int32_t* bnodes, uint32_t* binds) {
    for (int32_t r : dirty_rows) {
      bnodes[3 * r] = c0[r];
      bnodes[3 * r + 1] = c1[r];
      bnodes[3 * r + 2] = par[r];
      std::copy(inds.begin() + w * r, inds.begin() + w * (r + 1),
                binds + w * r);
      dirty_flag[r] = 0;
    }
    dirty_rows.clear();
  }

  double width_union(const uint32_t* a, const uint32_t* b) const {
    if (uniform_d > 0) {
      int64_t cnt = 0;
      for (int64_t k = 0; k < w; ++k) {
        cnt += __builtin_popcount(a[k] | b[k]);
      }
      return cnt * uniform_d;
    }
    double acc = 0.0;
    for (int64_t k = 0; k < w; ++k) {
      uint32_t bits = a[k] | b[k];
      while (bits) {
        const int bit = __builtin_ctz(bits);
        bits &= bits - 1;
        acc += log2d[32 * k + bit];
      }
    }
    return acc;
  }

  void rebuild_caches() {
    for (int64_t i = 0; i < n; ++i) {
      if (c0[i] == kNull) {
        lcc[i] = -std::numeric_limits<double>::infinity();
        std::fill(hyper.begin() + w * i, hyper.begin() + w * (i + 1), 0u);
      } else {
        lcc[i] = width_union(&inds[w * c0[i]], &inds[w * c1[i]]);
        for (int64_t k = 0; k < w; ++k) {
          hyper[w * i + k] =
              inds[w * i + k] & inds[w * c0[i] + k] & inds[w * c1[i] + k];
        }
      }
    }
  }

  double log2_total() const {
    double m = -std::numeric_limits<double>::infinity();
    for (int64_t i = n_leaves; i < n; ++i) m = std::max(m, lcc[i]);
    if (!std::isfinite(m)) return m;
    double s = 0.0;
    for (int64_t i = n_leaves; i < n; ++i) s += std::exp2(lcc[i] - m);
    return m + std::log2(s);
  }

  // One leaf-to-root sweep; returns the number of proposals evaluated.
  int64_t sweep(double beta, double& lt) {
    std::uniform_real_distribution<double> uniform;
    int64_t moves = 0;
    int32_t b = static_cast<int32_t>(prng() % n_leaves);
    b = par[b];
    if (b == kNull) return 0;
    std::vector<uint32_t> new_inds_b(w);
    while (par[b] != kNull) {
      ++moves;
      const int32_t a = par[b];
      const int32_t c = (c0[a] == b) ? c1[a] : c0[a];
      const int32_t cb0 = c0[b], cb1 = c1[b];
      bool i0 = false, i1 = false;
      for (int64_t k = 0; k < w; ++k) {
        i0 |= (inds[w * cb0 + k] & inds[w * c + k]) != 0;
        i1 |= (inds[w * cb1 + k] & inds[w * c + k]) != 0;
      }
      int32_t d, e;
      if (i0 && i1) {
        const bool flip = prng() & 1u;
        d = flip ? cb0 : cb1;
        e = flip ? cb1 : cb0;
      } else {
        d = i0 ? cb0 : cb1;
        e = i0 ? cb1 : cb0;
      }
      for (int64_t k = 0; k < w; ++k) {
        new_inds_b[k] = (inds[w * d + k] ^ inds[w * c + k]) |
                        hyper[w * a + k] | hyper[w * b + k];
      }
      const double ln_b = width_union(&inds[w * d], &inds[w * c]);
      const double ln_a = width_union(new_inds_b.data(), &inds[w * e]);
      const double l_a = lcc[a], l_b = lcc[b];
      const double mx = std::max({lt, ln_a, ln_b});
      const double s = std::exp2(lt - mx) - std::exp2(l_a - mx) -
                       std::exp2(l_b - mx) + std::exp2(ln_a - mx) +
                       std::exp2(ln_b - mx);
      const double l_new = mx + std::log2(std::max(s, 0x1p-60));
      const double u = uniform(prng);
      const bool accept =
          std::log2(std::max(u, 0x1p-60)) <= -beta * (l_new - lt);
      if (accept) {
        // swap C <-> E
        (c0[a] == c ? c0[a] : c1[a]) = e;
        (c0[b] == e ? c0[b] : c1[b]) = c;
        par[c] = b;
        par[e] = a;
        std::copy(new_inds_b.begin(), new_inds_b.end(),
                  inds.begin() + w * b);
        for (int64_t k = 0; k < w; ++k) {
          hyper[w * a + k] =
              inds[w * a + k] & inds[w * b + k] & inds[w * e + k];
          hyper[w * b + k] =
              inds[w * b + k] & inds[w * d + k] & inds[w * c + k];
        }
        lcc[a] = ln_a;
        lcc[b] = ln_b;
        lt = l_new;
        mark_dirty(a);
        mark_dirty(b);
        mark_dirty(c);
        mark_dirty(e);
      }
      b = a;
    }
    return moves;
  }
};

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// Finite-width extension: slices + width caches + greedy reslice
// (mirrors kernels/sa_finite.py; dense cost model, max_new_slices = 0).
// ---------------------------------------------------------------------------
struct SAReplicaFW : SAReplica {
  std::vector<uint32_t> slices;   // [w]
  std::vector<uint32_t> skip;     // [w]
  std::vector<double> width_pre;  // [n] pre-slicing widths
  double max_width = 0.0;
  int64_t max_new_slices = 0;

  double width_lanes(const uint32_t* xs, const uint32_t* minus) const {
    if (uniform_d > 0) {
      int64_t cnt = 0;
      for (int64_t k = 0; k < w; ++k) {
        cnt += __builtin_popcount(xs[k] & ~(minus ? minus[k] : 0u));
      }
      return cnt * uniform_d;
    }
    double acc = 0.0;
    for (int64_t k = 0; k < w; ++k) {
      uint32_t bits = xs[k] & ~(minus ? minus[k] : 0u);
      while (bits) {
        const int bit = __builtin_ctz(bits);
        bits &= bits - 1;
        acc += log2d[32 * k + bit];
      }
    }
    return acc;
  }

  double ccost_fw(const uint32_t* a, const uint32_t* b) const {
    // width of (a | b | slices)
    if (uniform_d > 0) {
      int64_t cnt = 0;
      for (int64_t k = 0; k < w; ++k) {
        cnt += __builtin_popcount(a[k] | b[k] | slices[k]);
      }
      return cnt * uniform_d;
    }
    double acc = 0.0;
    for (int64_t k = 0; k < w; ++k) {
      uint32_t bits = a[k] | b[k] | slices[k];
      while (bits) {
        const int bit = __builtin_ctz(bits);
        bits &= bits - 1;
        acc += log2d[32 * k + bit];
      }
    }
    return acc;
  }

  void rebuild_caches_fw() {
    width_pre.resize(n);
    for (int64_t i = 0; i < n; ++i) {
      width_pre[i] = width_lanes(&inds[w * i], nullptr);
      if (c0[i] == kNull) {
        lcc[i] = -std::numeric_limits<double>::infinity();
        std::fill(hyper.begin() + w * i, hyper.begin() + w * (i + 1), 0u);
      } else {
        lcc[i] = ccost_fw(&inds[w * c0[i]], &inds[w * c1[i]]);
        for (int64_t k = 0; k < w; ++k) {
          hyper[w * i + k] =
              inds[w * i + k] & inds[w * c0[i] + k] & inds[w * c1[i] + k];
        }
      }
    }
  }

  // Greedy slice derivation (kernels/sa_finite.greedy_slices semantics).
  std::vector<uint32_t> greedy_slices() {
    std::vector<uint32_t> out(w, 0u);
    std::vector<int64_t> n_big(32 * w, 0);
    for (int64_t i = 0; i < n; ++i) {
      if (width_pre[i] > max_width + 1e-4) {
        for (int64_t k = 0; k < w; ++k) {
          uint32_t bits = inds[w * i + k];
          while (bits) {
            const int bit = __builtin_ctz(bits);
            bits &= bits - 1;
            ++n_big[32 * k + bit];
          }
        }
      }
    }
    for (int64_t i = 0; i < n; ++i) {
      if (width_pre[i] <= max_width + 1e-4) continue;
      // sliced width under current out
      double sw = 0.0;
      std::vector<int> cand;
      for (int64_t k = 0; k < w; ++k) {
        uint32_t bits = inds[w * i + k] & ~out[k];
        while (bits) {
          const int bit = __builtin_ctz(bits);
          bits &= bits - 1;
          const int pos = 32 * k + bit;
          sw += log2d[pos];
          if (!(skip[k] >> bit & 1u)) cand.push_back(pos);
        }
      }
      if (sw <= max_width + 1e-4) continue;
      std::shuffle(cand.begin(), cand.end(), prng);
      std::stable_sort(cand.begin(), cand.end(),
                       [&](int x, int y) {
                         if (n_big[x] != n_big[y]) {
                           return n_big[x] > n_big[y];
                         }
                         return log2d[x] > log2d[y];
                       });
      for (int pos : cand) {
        if (sw <= max_width + 1e-4) break;
        out[pos / 32] |= 1u << (pos % 32);
        sw -= log2d[pos];
      }
    }
    return out;
  }

  // One width-capped sweep; optionally reslice afterwards.
  int64_t sweep_fw(double beta, double& lt, bool update_slices) {
    std::uniform_real_distribution<double> uniform;
    int64_t moves = 0;
    int32_t b = static_cast<int32_t>(prng() % n_leaves);
    b = par[b];
    if (b == kNull) return 0;
    std::vector<uint32_t> new_inds_b(w);
    while (par[b] != kNull) {
      ++moves;
      const int32_t a = par[b];
      const int32_t c = (c0[a] == b) ? c1[a] : c0[a];
      const int32_t cb0 = c0[b], cb1 = c1[b];
      bool i0 = false, i1 = false;
      for (int64_t k = 0; k < w; ++k) {
        i0 |= (inds[w * cb0 + k] & inds[w * c + k]) != 0;
        i1 |= (inds[w * cb1 + k] & inds[w * c + k]) != 0;
      }
      int32_t d, e;
      if (i0 && i1) {
        const bool flip = prng() & 1u;
        d = flip ? cb0 : cb1;
        e = flip ? cb1 : cb0;
      } else {
        d = i0 ? cb0 : cb1;
        e = i0 ? cb1 : cb0;
      }
      for (int64_t k = 0; k < w; ++k) {
        new_inds_b[k] = (inds[w * d + k] ^ inds[w * c + k]) |
                        hyper[w * a + k] | hyper[w * b + k];
      }
      const double new_sliced_width =
          width_lanes(new_inds_b.data(), slices.data());
      if (new_sliced_width <= max_width + 1e-4) {
        const double ln_b = ccost_fw(&inds[w * d], &inds[w * c]);
        const double ln_a = ccost_fw(new_inds_b.data(), &inds[w * e]);
        const double l_a = lcc[a], l_b = lcc[b];
        const double mx = std::max({lt, ln_a, ln_b});
        const double s = std::exp2(lt - mx) - std::exp2(l_a - mx) -
                         std::exp2(l_b - mx) + std::exp2(ln_a - mx) +
                         std::exp2(ln_b - mx);
        const double l_new = mx + std::log2(std::max(s, 0x1p-60));
        const double u = uniform(prng);
        if (std::log2(std::max(u, 0x1p-60)) <= -beta * (l_new - lt)) {
          (c0[a] == c ? c0[a] : c1[a]) = e;
          (c0[b] == e ? c0[b] : c1[b]) = c;
          par[c] = b;
          par[e] = a;
          std::copy(new_inds_b.begin(), new_inds_b.end(),
                    inds.begin() + w * b);
          for (int64_t k = 0; k < w; ++k) {
            hyper[w * a + k] =
                inds[w * a + k] & inds[w * b + k] & inds[w * e + k];
            hyper[w * b + k] =
                inds[w * b + k] & inds[w * d + k] & inds[w * c + k];
          }
          lcc[a] = ln_a;
          lcc[b] = ln_b;
          width_pre[b] = width_lanes(&inds[w * b], nullptr);
          lt = l_new;
          mark_dirty(a);
          mark_dirty(b);
          mark_dirty(c);
          mark_dirty(e);
        }
      } else if (max_new_slices > 0) {
        // Rescue branch (reference greedy/optimizer.hpp:226-321): add up
        // to max_new_slices random new slices until the node fits, re-cost
        // the whole tree under the candidate slice set, accept/reject on
        // the full delta.
        std::vector<int> cand;
        for (int64_t k = 0; k < w; ++k) {
          uint32_t bits = new_inds_b[k] & ~slices[k] & ~skip[k];
          while (bits) {
            const int bit = __builtin_ctz(bits);
            bits &= bits - 1;
            cand.push_back(static_cast<int>(32 * k + bit));
          }
        }
        std::shuffle(cand.begin(), cand.end(), prng);
        std::vector<uint32_t> cand_slices = slices;
        double sw = new_sliced_width;
        int64_t picked = 0;
        for (int pos : cand) {
          if (sw <= max_width + 1e-4 || picked >= max_new_slices) break;
          cand_slices[pos / 32] |= 1u << (pos % 32);
          sw -= log2d[pos];
          ++picked;
        }
        if (sw <= max_width + 1e-4) {
          // Full re-cost of the *proposed* tree (swap applied virtually).
          auto row = [&](int32_t x) -> const uint32_t* {
            return (x == b) ? new_inds_b.data() : &inds[w * x];
          };
          auto ccost_cand = [&](int32_t x, int32_t y) {
            const uint32_t* xa = row(x);
            const uint32_t* xb = row(y);
            double acc = 0.0;
            for (int64_t k = 0; k < w; ++k) {
              uint32_t bits = xa[k] | xb[k] | cand_slices[k];
              while (bits) {
                const int bit = __builtin_ctz(bits);
                bits &= bits - 1;
                acc += log2d[32 * k + bit];
              }
            }
            return acc;
          };
          std::vector<double> lcc_try(n);
          for (int64_t i = 0; i < n; ++i) {
            if (c0[i] == kNull) {
              lcc_try[i] = -std::numeric_limits<double>::infinity();
            } else if (i == a) {
              lcc_try[i] = ccost_cand(b, e);
            } else if (i == b) {
              lcc_try[i] = ccost_cand(d, c);
            } else {
              lcc_try[i] = ccost_cand(c0[i], c1[i]);
            }
          }
          double mx = -std::numeric_limits<double>::infinity();
          for (int64_t i = n_leaves; i < n; ++i) {
            mx = std::max(mx, lcc_try[i]);
          }
          double s = 0.0;
          for (int64_t i = n_leaves; i < n; ++i) {
            s += std::exp2(lcc_try[i] - mx);
          }
          const double lt_try = mx + std::log2(s);
          const double u2 = uniform(prng);
          if (std::log2(std::max(u2, 0x1p-60)) <= -beta * (lt_try - lt)) {
            (c0[a] == c ? c0[a] : c1[a]) = e;
            (c0[b] == e ? c0[b] : c1[b]) = c;
            par[c] = b;
            par[e] = a;
            std::copy(new_inds_b.begin(), new_inds_b.end(),
                      inds.begin() + w * b);
            for (int64_t k = 0; k < w; ++k) {
              hyper[w * a + k] =
                  inds[w * a + k] & inds[w * b + k] & inds[w * e + k];
              hyper[w * b + k] =
                  inds[w * b + k] & inds[w * d + k] & inds[w * c + k];
            }
            slices = std::move(cand_slices);
            lcc = std::move(lcc_try);
            width_pre[b] = width_lanes(&inds[w * b], nullptr);
            lt = lt_try;
            mark_dirty(a);
            mark_dirty(b);
            mark_dirty(c);
            mark_dirty(e);
          }
        }
      }
      b = a;
    }

    bool has_slices = false;
    for (int64_t k = 0; k < w; ++k) has_slices |= slices[k] != 0;
    if (update_slices && has_slices) {
      auto new_slices = greedy_slices();
      auto old_slices = slices;
      auto old_lcc = lcc;
      slices = new_slices;
      for (int64_t i = 0; i < n; ++i) {
        if (c0[i] != kNull) {
          lcc[i] = ccost_fw(&inds[w * c0[i]], &inds[w * c1[i]]);
        }
      }
      const double new_lt = log2_total();
      if (new_lt < lt) {
        lt = new_lt;
      } else {
        slices = std::move(old_slices);
        lcc = std::move(old_lcc);
      }
    }
    return moves;
  }
};

}  // namespace

// Runs n_replicas independent SA chains over n_threads OS threads.
// nodes/inds: per-replica arrays [R, N, 3] / [R, N, W]; updated in place
// with each replica's FINAL tree when best_nodes/best_inds are provided
// (chunked resume), else with its BEST tree (legacy one-shot mode).
// best_nodes/best_inds (optional, same shapes) receive the best trees;
// best_log2 [R] gets the best cost; returns total move evaluations.
int64_t tnco_sa_run(int32_t* nodes, uint32_t* inds, int64_t n_replicas,
                    int64_t n, int64_t w, const double* log2_dims,
                    int64_t n_inds, const double* betas, int64_t n_sweeps,
                    const uint64_t* seeds, double* best_log2,
                    int32_t* best_nodes, uint32_t* best_inds,
                    int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  }
  n_threads = std::min<int64_t>(n_threads, n_replicas);
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> total_moves{0};
  const int64_t n_leaves = (n + 1) / 2;

  auto worker = [&]() {
    for (;;) {
      const int64_t r = next.fetch_add(1);
      if (r >= n_replicas) return;
      SAReplica rep;
      rep.n = n;
      rep.w = w;
      rep.n_leaves = n_leaves;
      rep.log2d = log2_dims;
      rep.c0.resize(n);
      rep.c1.resize(n);
      rep.par.resize(n);
      int32_t* nd = nodes + 3 * n * r;
      for (int64_t i = 0; i < n; ++i) {
        rep.c0[i] = nd[3 * i];
        rep.c1[i] = nd[3 * i + 1];
        rep.par[i] = nd[3 * i + 2];
      }
      rep.inds.assign(inds + w * n * r, inds + w * n * (r + 1));
      rep.hyper.resize(n * w);
      rep.lcc.resize(n);
      rep.detect_uniform(n_inds);
      rep.prng.seed(seeds[r]);
      rep.rebuild_caches();
      rep.init_dirty();

      double lt = rep.log2_total();
      double best = lt;
      // Flat best buffers, synced incrementally via dirty rows.
      std::vector<int32_t> bnodes(3 * n);
      std::vector<uint32_t> binds(w * n);
      for (int64_t i = 0; i < n; ++i) {
        bnodes[3 * i] = rep.c0[i];
        bnodes[3 * i + 1] = rep.c1[i];
        bnodes[3 * i + 2] = rep.par[i];
      }
      std::copy(rep.inds.begin(), rep.inds.end(), binds.begin());
      int64_t moves = 0;
      for (int64_t k = 0; k < n_sweeps; ++k) {
        moves += rep.sweep(betas[k], lt);
        // Full cache-derived totals are O(n) exp2s; the f64 incremental
        // update drifts only ~1e-14/sweep, so re-derive lazily: on any
        // candidate improvement (so best snapshots are never taken on a
        // drifted or cancellation-clamped value) and every 16th sweep.
        if (lt < best || (k & 15) == 15) {
          lt = rep.log2_total();
          if (lt < best) {
            best = lt;
            rep.sync_best(bnodes.data(), binds.data());
          }
        }
      }
      total_moves.fetch_add(moves);
      if (best_nodes && best_inds) {
        // Chunked mode: arrays keep the final tree; bests go aside.
        for (int64_t i = 0; i < n; ++i) {
          nd[3 * i] = rep.c0[i];
          nd[3 * i + 1] = rep.c1[i];
          nd[3 * i + 2] = rep.par[i];
        }
        std::copy(rep.inds.begin(), rep.inds.end(), inds + w * n * r);
        std::copy(bnodes.begin(), bnodes.end(), best_nodes + 3 * n * r);
        std::copy(binds.begin(), binds.end(), best_inds + w * n * r);
      } else {
        std::copy(bnodes.begin(), bnodes.end(), nd);
        std::copy(binds.begin(), binds.end(), inds + w * n * r);
      }
      best_log2[r] = best;
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t i = 0; i < n_threads; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return total_moves.load();
}

}  // extern "C"

extern "C" {

// Finite-width variant: per-replica slices co-optimized with the tree.
// slices: uint32 [R, W] in/out (final slices when chunked, else best);
// best_slices (optional with best_nodes/best_inds): best slice sets.
// reslice_every: sweeps between greedy reslices (0 = never).
// max_new_slices: rescue budget per move (0 = reject over-width moves).
int64_t tnco_sa_run_fw(int32_t* nodes, uint32_t* inds, uint32_t* slices,
                       int64_t n_replicas, int64_t n, int64_t w,
                       const double* log2_dims, int64_t n_inds,
                       const uint32_t* skip_lanes,
                       double max_width, const double* betas,
                       int64_t n_sweeps, int64_t reslice_every,
                       int64_t max_new_slices, const uint64_t* seeds,
                       double* best_log2, int32_t* best_nodes,
                       uint32_t* best_inds, uint32_t* best_slices,
                       int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  }
  n_threads = std::min<int64_t>(n_threads, n_replicas);
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> total_moves{0};
  const int64_t n_leaves = (n + 1) / 2;

  auto worker = [&]() {
    for (;;) {
      const int64_t r = next.fetch_add(1);
      if (r >= n_replicas) return;
      SAReplicaFW rep;
      rep.n = n;
      rep.w = w;
      rep.n_leaves = n_leaves;
      rep.log2d = log2_dims;
      rep.max_width = max_width;
      rep.max_new_slices = max_new_slices;
      rep.c0.resize(n);
      rep.c1.resize(n);
      rep.par.resize(n);
      int32_t* nd = nodes + 3 * n * r;
      for (int64_t i = 0; i < n; ++i) {
        rep.c0[i] = nd[3 * i];
        rep.c1[i] = nd[3 * i + 1];
        rep.par[i] = nd[3 * i + 2];
      }
      rep.inds.assign(inds + w * n * r, inds + w * n * (r + 1));
      rep.hyper.resize(n * w);
      rep.lcc.resize(n);
      rep.slices.assign(slices + w * r, slices + w * (r + 1));
      rep.skip.assign(skip_lanes, skip_lanes + w);
      rep.detect_uniform(n_inds);
      rep.prng.seed(seeds[r]);
      rep.rebuild_caches_fw();
      rep.init_dirty();

      double lt = rep.log2_total();
      double best = lt;
      std::vector<int32_t> bnodes(3 * n);
      std::vector<uint32_t> binds(w * n);
      for (int64_t i = 0; i < n; ++i) {
        bnodes[3 * i] = rep.c0[i];
        bnodes[3 * i + 1] = rep.c1[i];
        bnodes[3 * i + 2] = rep.par[i];
      }
      std::copy(rep.inds.begin(), rep.inds.end(), binds.begin());
      std::vector<uint32_t> bslices = rep.slices;
      int64_t moves = 0;
      for (int64_t k = 0; k < n_sweeps; ++k) {
        const bool upd =
            reslice_every > 0 && (k % reslice_every) == 0;
        moves += rep.sweep_fw(betas[k], lt, upd);
        if (lt < best || (k & 15) == 15) {
          lt = rep.log2_total();
          if (lt < best) {
            best = lt;
            rep.sync_best(bnodes.data(), binds.data());
            bslices = rep.slices;
          }
        }
      }
      total_moves.fetch_add(moves);
      const bool chunked = best_nodes && best_inds && best_slices;
      if (chunked) {
        for (int64_t i = 0; i < n; ++i) {
          nd[3 * i] = rep.c0[i];
          nd[3 * i + 1] = rep.c1[i];
          nd[3 * i + 2] = rep.par[i];
        }
        std::copy(rep.inds.begin(), rep.inds.end(), inds + w * n * r);
        std::copy(bnodes.begin(), bnodes.end(), best_nodes + 3 * n * r);
        std::copy(binds.begin(), binds.end(), best_inds + w * n * r);
        std::copy(rep.slices.begin(), rep.slices.end(), slices + w * r);
        std::copy(bslices.begin(), bslices.end(), best_slices + w * r);
      } else {
        std::copy(bnodes.begin(), bnodes.end(), nd);
        std::copy(binds.begin(), binds.end(), inds + w * n * r);
        std::copy(bslices.begin(), bslices.end(), slices + w * r);
      }
      best_log2[r] = best;
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t i = 0; i < n_threads; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return total_moves.load();
}

}  // extern "C"
