// K1: per-replica row gather, the port's counterpart of the TPU kernel
// tnco_tpu/kernels/pallas_gather.py:112 (_kernel; entry point gather_gbn).
//
//   out[g, b, q] = vals[g, b, ids[b, q]]   for 0 <= ids[b, q] < n,
//   out[g, b, q] = 0                       otherwise.
//
// Any 32-bit dtype: the kernel moves words and never does arithmetic on
// them.  `vals` points at the first plane of the requested range (the
// wrapper offsets the pointer), so a plane range is read without a copy.
//
// Bound on an H100: memory.  The word bound counts the B*Q ids, each
// distinct addressed word and each output word once: 19.3 MB at the walks
// engine's index gather (G=64, B=64, N=3328, Q=640), 5.8 us at 3.35 TB/s.
// The access pattern forces more.  A warp's reads land on 32 random
// columns of a 13 KB row, and the 640 reads of a row touch 82% of its
// 32-byte sectors (51 MB in all, 15 us) and nearly every 64-byte DRAM
// atom, while the 64 planes (54.5 MB) do not fit the 50 MB L2: the
// gather then costs about what streaming the planes does.  The plane
// slicer's sorted-space gather (G=128, B=64, N=64, Q=2048) re-reads 2 MB
// of 256-byte rows 32 times over and is bound by its 67 MB of stores
// (21 us).
//
// The routes put a (replica, column tile) and a plane chunk on the grid,
// so the index math is 32-bit with one division per block and none per
// word.  Each thread owns VEC consecutive columns (VEC=4 with 16-byte id
// loads and stores where Q % 4 == 0 and the pointers are aligned): it
// reads their ids once, with the range test done once, and keeps them in
// registers for every plane of its chunk.  The wrapper picks the route
// from the shape (kernels/gather.py: gather_route):
//
//   row     dense small rows (the slicer's shape): a block copies the [N]
//           row of each plane of its chunk into shared memory with
//           coalesced 16-byte loads (a zero word after each row takes the
//           out-of-range ids), then gathers from shared memory and stores
//           16 bytes a thread;
//   sparse  everything else (the index gather, the walks engine's pulls,
//           the slicer's row windows): loads straight from global memory,
//           VEC loads in flight a thread, with blocks ordered so that the
//           blocks running together read the same planes.
//
// A third form, the sparse route with each replica's (id, q) pairs sorted
// in shared memory so that a warp's loads share sectors, measured 3x
// slower than `sparse` at the index gather (the bitonic sort's shared
// memory traffic); it is kept beside the first design in
// scripts/gather_scatter_first_design.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
// Blocks to aim for: the sparse route is bound by the device memory's
// random sector reads at the walks engine's shapes and ran fastest on the
// card with many small blocks; the row route amortises its row copies
// over a few planes a block.
constexpr int kSparseBlocks = 132 * 32;
constexpr int kRowBlocks = 132 * 8;
constexpr int kRowSmemBytes = 32 * 1024;

// Stride of a row in shared memory: n words and a zero word, rounded up to
// 16 bytes.
__host__ __device__ inline int row_stride(int n) { return (n + 1 + 3) & ~3; }

template <int VEC>
__device__ inline void load_ids(const int32_t* __restrict__ p, int n,
                                int (&id)[VEC], bool (&ok)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    id[0] = v.x;
    id[1] = v.y;
    id[2] = v.z;
    id[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) id[k] = __ldg(p + k);
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) ok[k] = (unsigned)id[k] < (unsigned)n;
}

template <int VEC>
__device__ inline void store_words(int32_t* __restrict__ p,
                                   const int32_t (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

// Sparse route.  blockIdx.x = replica * n_qtiles + column tile, blockIdx.y
// = plane chunk: the blocks that run together read the same planes.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    gather_sparse_kernel(const int32_t* __restrict__ vals,
                         const int32_t* __restrict__ ids,
                         int32_t* __restrict__ out, int g, int b, int n,
                         int q, int gchunk, int n_qtiles) {
  const int bi = blockIdx.x / n_qtiles;
  const int qt = blockIdx.x - bi * n_qtiles;
  const int q0 = (qt * blockDim.x + threadIdx.x) * VEC;
  if (q0 >= q) return;
  const int g0 = blockIdx.y * gchunk;
  const int g1 = min(g, g0 + gchunk);
  int id[VEC];
  bool ok[VEC];
  load_ids<VEC>(ids + (size_t)bi * q + q0, n, id, ok);
  const size_t in_plane = (size_t)b * n;
  const size_t out_plane = (size_t)b * q;
  const int32_t* src = vals + ((size_t)g0 * b + bi) * n;
  int32_t* dst = out + ((size_t)g0 * b + bi) * q + q0;
  for (int gi = g0; gi < g1; ++gi) {
    int32_t v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = ok[k] ? __ldg(src + id[k]) : 0;
    store_words<VEC>(dst, v);
    src += in_plane;
    dst += out_plane;
  }
}

// Row route.  blockIdx.x = plane chunk * n_qtiles + column tile; the
// chunk's rows ([gchunk][row_stride(n)] words) fill shared memory.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    gather_rows_kernel(const int32_t* __restrict__ vals,
                       const int32_t* __restrict__ ids,
                       int32_t* __restrict__ out, int g, int b, int n,
                       int q, int gchunk, int n_qtiles, int qtile,
                       bool vec_rows) {
  extern __shared__ int4 smem4[];
  int32_t* rows = reinterpret_cast<int32_t*>(smem4);
  const int bi = blockIdx.y;
  const int gc = blockIdx.x / n_qtiles;
  const int qt = blockIdx.x - gc * n_qtiles;
  const int g0 = gc * gchunk;
  const int gn = min(g, g0 + gchunk) - g0;
  const int ns = row_stride(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  // Rows of the chunk: a warp per row, 16-byte loads where the rows are
  // 16-byte aligned (n % 4 == 0 and an aligned first plane).
  for (int r = warp; r < gn; r += n_warps) {
    const int32_t* src = vals + ((size_t)(g0 + r) * b + bi) * n;
    int32_t* dst = rows + r * ns;
    if (vec_rows) {
      for (int c = lane * 4; c < n; c += 128) {
        *reinterpret_cast<int4*>(dst + c) =
            __ldg(reinterpret_cast<const int4*>(src + c));
      }
    } else {
      for (int c = lane; c < n; c += 32) dst[c] = __ldg(src + c);
    }
    if (lane == 0) dst[n] = 0;
  }
  __syncthreads();
  const size_t out_plane = (size_t)b * q;
  const int q_end = min(q, (qt + 1) * qtile);
  for (int q0 = qt * qtile + threadIdx.x * VEC; q0 < q_end;
       q0 += blockDim.x * VEC) {
    int id[VEC];
    bool ok[VEC];
    load_ids<VEC>(ids + (size_t)bi * q + q0, n, id, ok);
#pragma unroll
    for (int k = 0; k < VEC; ++k) id[k] = ok[k] ? id[k] : n;
    int32_t* dst = out + ((size_t)g0 * b + bi) * q + q0;
#pragma unroll 4
    for (int r = 0; r < gn; ++r) {
      int32_t v[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = rows[r * ns + id[k]];
      store_words<VEC>(dst + r * out_plane, v);
    }
  }
}

// Planes per block for about `target` blocks in all.
int plane_chunk(int g, long long blocks_per_chunk, long long target) {
  long long n_chunks = (target + blocks_per_chunk - 1) / blocks_per_chunk;
  if (n_chunks > g) n_chunks = g;
  if (n_chunks > 65535) n_chunks = 65535;  // the grid's y limit
  return (int)((g + n_chunks - 1) / n_chunks);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// route: 0 sparse, 1 row (kernels/gather.py: _ROUTES).
extern "C" int tnco_gather_gbn(const void* vals, const void* ids, void* out,
                               int g, int b, int n, int q, int route,
                               void* stream) {
  if ((long long)g * b * q <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* v = (const int32_t*)vals;
  const int32_t* ix = (const int32_t*)ids;
  int32_t* o = (int32_t*)out;
  const bool vec = (q & 3) == 0 && aligned16(ids) && aligned16(out);
  const int vw = vec ? 4 : 1;
  const int cols = (q + vw - 1) / vw;  // column threads per replica
  if (route == 0) {
    int threads = ((cols + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const int n_qtiles = (cols + threads - 1) / threads;
    const int gchunk = plane_chunk(g, (long long)n_qtiles * b,
                                   kSparseBlocks);
    const int n_chunks = (g + gchunk - 1) / gchunk;
    const dim3 grid((unsigned)(b * n_qtiles), (unsigned)n_chunks);
    if (vec) {
      gather_sparse_kernel<4><<<grid, threads, 0, st>>>(
          v, ix, o, g, b, n, q, gchunk, n_qtiles);
    } else {
      gather_sparse_kernel<1><<<grid, threads, 0, st>>>(
          v, ix, o, g, b, n, q, gchunk, n_qtiles);
    }
  } else if (route == 1) {
    const int ns = row_stride(n);
    const int max_rows = kRowSmemBytes / (ns * 4);
    if (max_rows < 1 || b > 65535) return (int)cudaErrorInvalidValue;
    const bool vec_rows = (n & 3) == 0 && aligned16(vals);
    const int threads = kMaxThreads;
    const int qtile = threads * vw * 4;  // four passes of the block
    const int n_qtiles = (q + qtile - 1) / qtile;
    int gchunk = plane_chunk(g, (long long)n_qtiles * b, kRowBlocks);
    if (gchunk > max_rows) gchunk = max_rows;
    const int n_chunks = (g + gchunk - 1) / gchunk;
    const dim3 grid((unsigned)(n_chunks * n_qtiles), (unsigned)b);
    const size_t smem = (size_t)gchunk * ns * 4;
    if (vec) {
      gather_rows_kernel<4><<<grid, threads, smem, st>>>(
          v, ix, o, g, b, n, q, gchunk, n_qtiles, qtile, vec_rows);
    } else {
      gather_rows_kernel<1><<<grid, threads, smem, st>>>(
          v, ix, o, g, b, n, q, gchunk, n_qtiles, qtile, vec_rows);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
