// The first design of the row gather K1 and the in-place row scatter K3
// (with the id inversion K2 that K3 read), kept as the baseline that
// scripts/profile_torch_gather_scatter.py runs in turns with
// tnco_tpu_torch/csrc/gather.cu and csrc/scatter.cu: those kernels as they
// were before their redesign, unchanged but for the names of the entry
// points (tnco_gather_gbn_first, tnco_inv_ids_first,
// tnco_scatter_rows_first), so that both builds load side by side.
// It also holds the sorted variant of the redesigned K1's sparse route
// (entry point tnco_gather_sorted_variant), which the same script times
// beside it.  Nothing on the main path builds this file.
//
// K1  out[g, b, q] = vals[g, b, ids[b, q]] for 0 <= ids[b, q] < n, else 0:
//     one thread per output word with q fastest, in a flat grid-stride
//     loop (three 64-bit divisions or remainders per word).
// K2  inv[b, n] = the last q with ids[b, q] == n, else -1 (one block per
//     replica, atomicMax over q in shared memory, or in the output row
//     above 48 KB).
// K3  vals[g, b, ids[b, q]] = upd[g, b, q] where inv[b, ids[b, q]] == q,
//     one thread per (g, b, q) in the same flat loop; the caller launches
//     K2 first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_gbn_kernel(const int32_t* __restrict__ vals,
                                  const int32_t* __restrict__ ids,
                                  int32_t* __restrict__ out, int g, int b,
                                  int n, int q) {
  const long long total = (long long)g * b * q;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int qi = (int)(i % q);
    const long long gb = i / q;
    const int bi = (int)(gb % b);
    const long long gi = gb / b;
    const int id = __ldg(ids + (long long)bi * q + qi);
    int32_t v = 0;
    if (id >= 0 && id < n) {
      v = __ldg(vals + (gi * b + bi) * (long long)n + id);
    }
    out[i] = v;
  }
}



constexpr int kSmemBytes = 48 * 1024;

__global__ void inv_ids_smem_kernel(const int32_t* __restrict__ ids,
                                    int32_t* __restrict__ inv, int n, int q) {
  extern __shared__ int32_t buf[];
  const long long bi = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = -1;
  __syncthreads();
  const int32_t* row = ids + bi * q;
  for (int j = threadIdx.x; j < q; j += blockDim.x) {
    const int id = row[j];
    if (id >= 0 && id < n) atomicMax(buf + id, j);
  }
  __syncthreads();
  int32_t* out = inv + bi * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = buf[i];
}

__global__ void inv_ids_global_kernel(const int32_t* __restrict__ ids,
                                      int32_t* __restrict__ inv, int n,
                                      int q) {
  const long long bi = blockIdx.x;
  int32_t* out = inv + bi * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = -1;
  __syncthreads();
  const int32_t* row = ids + bi * q;
  for (int j = threadIdx.x; j < q; j += blockDim.x) {
    const int id = row[j];
    if (id >= 0 && id < n) atomicMax(out + id, j);
  }
}

__global__ void scatter_rows_kernel(int32_t* __restrict__ vals,
                                    const int32_t* __restrict__ ids,
                                    const int32_t* __restrict__ inv,
                                    const int32_t* __restrict__ upd, int g,
                                    int b, int n, int q) {
  const long long total = (long long)g * b * q;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int qi = (int)(i % q);
    const long long gb = i / q;
    const int bi = (int)(gb % b);
    const long long gi = gb / b;
    const int id = __ldg(ids + (long long)bi * q + qi);
    if (id >= 0 && id < n && __ldg(inv + (long long)bi * n + id) == qi) {
      vals[(gi * b + bi) * (long long)n + id] = __ldg(upd + i);
    }
  }
}

constexpr int kUnroll = 4;  // planes per staging pass of the variant
constexpr int kSortMaxQ = 1024;

// The sorted variant of K1's sparse route, measured in turns against it
// and not taken: one block per (plane chunk, replica), all Q columns; the
// block sorts the replica's (id, q) pairs in shared memory so that a
// warp's loads share sectors, and writes the values back through a shared
// staging buffer so that the stores stay coalesced (Q <= 1024).  Shared
// memory: P2 keys of 8 bytes (P2 = Q rounded up to a power of two), then
// kUnroll staging rows of Q words.
__global__ void __launch_bounds__(256)
    gather_sorted_kernel(const int32_t* __restrict__ vals,
                         const int32_t* __restrict__ ids,
                         int32_t* __restrict__ out, int g, int b, int n,
                         int q, int gchunk, int p2) {
  extern __shared__ int4 smem4[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem4);
  int32_t* stage = reinterpret_cast<int32_t*>(keys + p2);
  const int bi = blockIdx.y;
  const int g0 = blockIdx.x * gchunk;
  const int g1 = min(g, g0 + gchunk);
  const int32_t* row_ids = ids + (size_t)bi * q;
  for (int i = threadIdx.x; i < p2; i += blockDim.x) {
    unsigned long long key = ~0ULL;
    if (i < q) {
      const int id = __ldg(row_ids + i);
      const unsigned hi = (unsigned)id < (unsigned)n ? (unsigned)id
                                                     : 0xFFFFFFFFu;
      key = ((unsigned long long)hi << 32) | (unsigned)i;
    }
    keys[i] = key;
  }
  __syncthreads();
  // Bitonic sort of the p2 keys, ascending.
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = keys[i], c = keys[l];
          const bool up = (i & k) == 0;
          if ((a > c) == up) {
            keys[i] = c;
            keys[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const size_t in_plane = (size_t)b * n;
  const size_t out_plane = (size_t)b * q;
  for (int gi = g0; gi < g1; gi += kUnroll) {
    const int un = min(kUnroll, g1 - gi);
    const int32_t* src = vals + ((size_t)gi * b + bi) * n;
    for (int s = threadIdx.x; s < q; s += blockDim.x) {
      const unsigned long long key = keys[s];
      const unsigned hi = (unsigned)(key >> 32);
      const int qi = (int)(key & 0xFFFFFFFFu);
      int32_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = (hi != 0xFFFFFFFFu && u < un) ? __ldg(src + u * in_plane + hi)
                                             : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) stage[u * q + qi] = v[u];
    }
    __syncthreads();
    for (int u = 0; u < un; ++u) {
      int32_t* dst = out + ((size_t)(gi + u) * b + bi) * q;
      for (int i = threadIdx.x; i < q; i += blockDim.x) {
        dst[i] = stage[u * q + i];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tnco_gather_gbn_first(const void* vals, const void* ids,
                                     void* out, int g, int b, int n,
                                     int q, void* stream) {
  const long long total = (long long)g * b * q;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride loop covers it
  gather_gbn_kernel<<<(unsigned int)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)vals, (const int32_t*)ids, (int32_t*)out, g, b, n, q);
  return (int)cudaGetLastError();
}

extern "C" int tnco_inv_ids_first(const void* ids, void* inv, int b, int n,
                                  int q, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const int threads = 256;
  const long long smem = (long long)n * sizeof(int32_t);
  if (smem <= kSmemBytes) {
    inv_ids_smem_kernel<<<b, threads, (size_t)smem, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (int32_t*)inv, n, q);
  } else {
    inv_ids_global_kernel<<<b, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (int32_t*)inv, n, q);
  }
  return (int)cudaGetLastError();
}

extern "C" int tnco_scatter_rows_first(void* vals, const void* ids,
                                       const void* inv, const void* upd,
                                       int g, int b, int n, int q,
                                       void* stream) {
  const long long total = (long long)g * b * q;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride loop covers it
  scatter_rows_kernel<<<(unsigned int)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (int32_t*)vals, (const int32_t*)ids, (const int32_t*)inv,
      (const int32_t*)upd, g, b, n, q);
  return (int)cudaGetLastError();
}

extern "C" int tnco_gather_sorted_variant(const void* vals, const void* ids,
                                          void* out, int g, int b, int n,
                                          int q, void* stream) {
  if ((long long)g * b * q <= 0) return 0;
  if (q > kSortMaxQ || b > 65535) return (int)cudaErrorInvalidValue;
  int p2 = 1;
  while (p2 < q) p2 <<= 1;
  // Planes a block: about 8 blocks per SM, at least kUnroll planes.
  long long n_chunks = (132 * 8 + b - 1) / b;
  const long long most = (g + kUnroll - 1) / kUnroll;
  if (n_chunks > most) n_chunks = most;
  const int gchunk = (int)((g + n_chunks - 1) / n_chunks);
  const int n_grid = (g + gchunk - 1) / gchunk;
  const size_t smem = (size_t)p2 * 8 + (size_t)kUnroll * q * 4;
  gather_sorted_kernel<<<dim3((unsigned)n_grid, (unsigned)b), 256, smem,
                         (cudaStream_t)stream>>>(
      (const int32_t*)vals, (const int32_t*)ids, (int32_t*)out, g, b, n, q,
      gchunk, p2);
  return (int)cudaGetLastError();
}
