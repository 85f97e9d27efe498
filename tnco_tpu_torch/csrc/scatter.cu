// K2, K3 and K4: id inversion and the in-place and out-of-place row
// scatters, the port's counterparts of the TPU kernels
// tnco_tpu/kernels/pallas_scatter.py: _inv_kernel (:116, entry point
// inv_ids), _inplace_kernel (:354, entry point scatter_rows_inplace), and
// _scatter_kernel_wide / _scatter_kernel (:228, :248, entry point
// scatter_rows_gbn).
//
// K2  inv[b, n] = q such that ids[b, q] == n, else -1.  Ids outside
//     [0, n) are ignored; on duplicate ids the LAST q wins, as in the TPU
//     kernel.  One block per (replica, slice of `slice` columns, which
//     the wrapper picks: kernels/scatter.py INV_SLICE): the block reads
//     its replica's Q ids once, coalesced, keeps those in its slice,
//     resolves "last q wins" with atomicMax into a slice-word map in
//     shared memory (exact and independent of thread order), and writes
//     its slice with 16-byte stores where n is a multiple of 4.  One
//     route for every n: the map is a slice whatever n is.
//
// K3  vals[lo + g, b, ids[b, q]] = upd[g, b, q] for in-range ids, the last
//     q winning on duplicates (the TPU kernel's result); -1 and
//     out-of-range ids write nothing.  In place: only the addressed words
//     of each plane of the range are written; every other word of the
//     caller's tensor is untouched (the TPU kernel aliases and rewrites
//     whole planes).  The inversion is folded in: one launch per call.
//     One block per (plane chunk, replica) resolves the winners of its
//     replica once: atomicMax of q into an [n] map in shared memory (in a
//     global scratch row when the map does not fit 48 KB, with one block
//     per replica), then a compact list of (column, q) pairs, in q order
//     within each warp.  For each plane of the chunk, a thread reads the
//     upd words of its winners and writes them to their columns.  No word
//     is looked up per plane and no division is done per word.
//
// K4  out[g, b, n] = upd[g, b, inv[b, n]] where inv[b, n] >= 0, else
//     vals[lo + g, b, n]: a new tensor holding only the plane range; the
//     caller's vals is never written.  One pass in gather form, one
//     thread per output word with n fastest, so the reads of vals and
//     inv and the stores are coalesced; only the upd reads land on
//     data-dependent columns (Q words of a row, cached).  One kernel
//     takes the place of both Pallas bodies: their wide/tiled split is a
//     choice of VMEM block sizes that has no counterpart here.
//
// Bound on an H100: memory.  K2 reads B*Q ids and writes B*n words (0.92
// MB at B=64, Q=256, n=3328: 0.27 us at 3.35 TB/s, under the cost of a
// launch, whose floor, an empty kernel on the same grid, is measured beside
// it by scripts/profile_torch_probe_inv.py).  K3
// reads B*Q ids and the G*K update words of its K winners and writes
// G*K words: 8.7 MB for the 132-plane merged apply at B=64, Q=256 with
// half the ids kept (2.6 us at 3.35 TB/s).  Its stores put one word in a
// 32-byte sector at random columns of 13 KB rows, 45% of the 64-byte DRAM
// atoms of a 112 MB region that does not fit the 50 MB L2, and each such
// atom is read and written back whole: the apply is bound by that
// read-modify-write in any layout of the writes (PERF.md measures it
// against the same writes at contiguous columns).  With about 128
// winners in 3328 columns, consecutive winners sit ~26 words apart, so
// sorting them by column would not let a warp's stores share sectors.
// K4 reads the G planes of vals, inv once and upd once, and writes G
// planes: at G=132, B=64, N=3328, Q=256 that is 2 * 112.46 MB of planes +
// 0.85 MB of inv + 8.65 MB of upd (+ 0.07 MB of ids for K2), about 234.5
// MB, or 0.070 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemBytes = 48 * 1024;
constexpr int kInvThreads = 256;  // K2's threads per block

__global__ void __launch_bounds__(kInvThreads)
    inv_ids_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ inv,
                   int n, int q, int slice, int n_slices) {
  extern __shared__ int4 map4[];  // [slice / 4]
  int32_t* map = reinterpret_cast<int32_t*>(map4);
  const int bi = blockIdx.x / n_slices;
  const int s0 = (blockIdx.x - bi * n_slices) * slice;
  const int len = min(slice, n - s0);
  // The first id a thread takes is loaded before the map is set, so that
  // its latency overlaps the initialisation.
  const int32_t* row = ids + (size_t)bi * q;
  const int j0 = threadIdx.x;
  const int32_t first = j0 < q ? __ldg(row + j0) : -1;
  for (int i = threadIdx.x; i < slice / 4; i += kInvThreads) {
    map4[i] = make_int4(-1, -1, -1, -1);
  }
  __syncthreads();
  for (int j = j0; j < q; j += kInvThreads) {
    // Unsigned: -1 and ids outside [s0, s0 + len) fall out of range.
    const unsigned rel =
        (unsigned)(j == j0 ? first : __ldg(row + j)) - (unsigned)s0;
    if (rel < (unsigned)len) atomicMax(map + rel, j);
  }
  __syncthreads();
  int32_t* out = inv + (size_t)bi * n + s0;
  if ((n & 3) == 0) {  // s0 is a multiple of 4 too: 16-byte aligned rows
    for (int i = threadIdx.x; i < len / 4; i += kInvThreads) {
      reinterpret_cast<int4*>(out)[i] = map4[i];
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kInvThreads) out[i] = map[i];
  }
}

constexpr int kScatterThreads = 256;
// Blocks to aim for: K3 is bound by the device memory's partial-sector
// writes at the walks engine's apply, and measured fastest with about one
// block per SM (two per replica at B=64; PERF.md).
constexpr int kScatterBlocks = 128;

// K3.  blockIdx.x = plane chunk, blockIdx.y = replica.  With SMEM, shared
// memory holds the winner list (2 * min(q, n) words) and the [n] map; else
// both live in the replica's row of `scratch` ([b, n + 2 * min(q, n)]
// words) and the grid has one plane chunk.
template <bool SMEM>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_rows_kernel(int32_t* __restrict__ vals,
                        const int32_t* __restrict__ ids,
                        const int32_t* __restrict__ upd,
                        int32_t* __restrict__ scratch, int g, int b, int n,
                        int q, int gchunk) {
  extern __shared__ int32_t smem[];
  __shared__ int n_win;
  const int bi = blockIdx.y;
  const int cap = min(q, n);
  int32_t* win_col = SMEM ? smem : scratch + (size_t)bi * (n + 2 * cap);
  int32_t* win_q = win_col + cap;
  int32_t* map = win_q + cap;
  for (int i = threadIdx.x; i < n; i += blockDim.x) map[i] = -1;
  if (threadIdx.x == 0) n_win = 0;
  __syncthreads();
  const int32_t* row = ids + (size_t)bi * q;
  for (int j = threadIdx.x; j < q; j += blockDim.x) {
    const int id = __ldg(row + j);
    if ((unsigned)id < (unsigned)n) atomicMax(map + id, j);
  }
  __syncthreads();
  // Compact the winners: a warp's in q order, warps in any order (the
  // columns are distinct, so the order changes no result).
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < q; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    int id = -1;
    bool win = false;
    if (j < q) {
      id = __ldg(row + j);
      win = (unsigned)id < (unsigned)n &&
            (SMEM ? map[id] : __ldcg(map + id)) == j;
    }
    const unsigned m = __ballot_sync(0xFFFFFFFFu, win);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&n_win, __popc(m));
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    if (win) {
      const int at = base + __popc(m & ((1u << lane) - 1));
      win_col[at] = id;
      win_q[at] = j;
    }
  }
  __syncthreads();
  const int k = n_win;
  const int g0 = blockIdx.x * gchunk;
  const int g1 = min(g, g0 + gchunk);
  const size_t val_plane = (size_t)b * n;
  const size_t upd_plane = (size_t)b * q;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const int col = SMEM ? win_col[i] : __ldcg(win_col + i);
    const int qi = SMEM ? win_q[i] : __ldcg(win_q + i);
    const int32_t* src = upd + ((size_t)g0 * b + bi) * q + qi;
    int32_t* dst = vals + ((size_t)g0 * b + bi) * n + col;
    for (int gi = g0; gi < g1; ++gi) {
      *dst = __ldg(src);
      src += upd_plane;
      dst += val_plane;
    }
  }
}

// blockIdx.y walks the (g, b) rows, x the n words of a row: no 64-bit
// division per word.
__global__ void scatter_gbn_kernel(const int32_t* __restrict__ vals,
                                   const int32_t* __restrict__ inv,
                                   const int32_t* __restrict__ upd,
                                   int32_t* __restrict__ out, int g, int b,
                                   int n, int q) {
  const long long rows = (long long)g * b;
  for (long long gb = blockIdx.y; gb < rows; gb += gridDim.y) {
    const int32_t* inv_row = inv + (gb % b) * (long long)n;
    const int32_t* upd_row = upd + gb * q;
    const long long base = gb * n;
    for (int ni = blockIdx.x * blockDim.x + threadIdx.x; ni < n;
         ni += blockDim.x * gridDim.x) {
      const int s = __ldg(inv_row + ni);
      out[base + ni] = s >= 0 ? __ldg(upd_row + s) : __ldg(vals + base + ni);
    }
  }
}

}  // namespace

// inv: [b, n] int32, 16-byte aligned (a fresh tensor from the wrapper);
// slice: columns per block, a multiple of 4 (its map is shared memory).
extern "C" int tnco_inv_ids(const void* ids, void* inv, int b, int n, int q,
                            int slice, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (slice <= 0 || slice % 4) return (int)cudaErrorInvalidValue;
  const int n_slices = (n + slice - 1) / slice;
  const long long blocks = (long long)b * n_slices;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  inv_ids_kernel<<<(unsigned)blocks, kInvThreads, 4 * (size_t)slice,
                   (cudaStream_t)stream>>>((const int32_t*)ids, (int32_t*)inv,
                                           n, q, slice, n_slices);
  return (int)cudaGetLastError();
}

// scratch: null for the shared-memory route, else [b, n + 2 * min(q, n)]
// int32 words (kernels/scatter.py: scatter_route).
extern "C" int tnco_scatter_rows(void* vals, const void* ids, const void* upd,
                                 void* scratch, int g, int b, int n, int q,
                                 void* stream) {
  if ((long long)g * b * q <= 0 || n <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  const int cap = q < n ? q : n;
  const long long words = (long long)n + 2LL * cap;
  const cudaStream_t st = (cudaStream_t)stream;
  if (scratch == nullptr) {
    if (words * 4 > kSmemBytes) return (int)cudaErrorInvalidValue;
    long long n_chunks = (kScatterBlocks + b - 1) / b;
    if (n_chunks > g) n_chunks = g;
    const int gchunk = (int)((g + n_chunks - 1) / n_chunks);
    const int n_grid = (g + gchunk - 1) / gchunk;
    scatter_rows_kernel<true><<<dim3((unsigned)n_grid, (unsigned)b),
                                kScatterThreads, (size_t)words * 4, st>>>(
        (int32_t*)vals, (const int32_t*)ids, (const int32_t*)upd, nullptr,
        g, b, n, q, gchunk);
  } else {
    scatter_rows_kernel<false><<<dim3(1u, (unsigned)b), kScatterThreads, 0,
                                 st>>>(
        (int32_t*)vals, (const int32_t*)ids, (const int32_t*)upd,
        (int32_t*)scratch, g, b, n, q, g);
  }
  return (int)cudaGetLastError();
}

extern "C" int tnco_scatter_gbn(const void* vals, const void* inv,
                                const void* upd, void* out, int g, int b,
                                int n, int q, void* stream) {
  const long long rows = (long long)g * b;
  if (rows <= 0 || n <= 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned int)((n + threads - 1) / threads),
                  (unsigned int)(rows < 65535 ? rows : 65535));
  scatter_gbn_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)vals, (const int32_t*)inv, (const int32_t*)upd,
      (int32_t*)out, g, b, n, q);
  return (int)cudaGetLastError();
}
