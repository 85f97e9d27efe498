// K2, K3 and K4: id inversion and the in-place and out-of-place row
// scatters, the port's counterparts of the TPU kernels
// tnco_tpu/kernels/pallas_scatter.py: _inv_kernel (entry point inv_ids),
// _inplace_kernel (entry point scatter_rows_inplace), and
// _scatter_kernel_wide / _scatter_kernel (entry point scatter_rows_gbn).
//
// K2  inv[b, n] = q such that ids[b, q] == n, else -1.  Ids outside
//     [0, n) are ignored; on duplicate ids the LAST q wins, as in the TPU
//     kernel.  One block per replica: the row lives in shared memory
//     (int[n], 13 KB at n = 3328) when it fits the 48 KB default, else in
//     the output row in global memory.  atomicMax over q makes "last q
//     wins" exact and independent of thread order.
//
// K3  vals[lo + g, b, ids[b, q]] = upd[g, b, q] for in-range ids whose
//     q is the winner in inv (from K2), so contract-violating duplicates
//     keep the TPU kernel's last-q-wins result without a race.  -1 ids
//     write nothing.  In place: only the Q addressed words of each plane
//     of the range are written; every other word of the caller's tensor
//     is untouched (the TPU kernel aliases and rewrites whole planes).
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
// Bound on an H100: memory.  K2 reads B*Q ids and writes B*n words.  K3
// reads G*B*Q update words, B*Q ids and their inv entries, and writes at
// most G*B*Q words: about 17 MB for the 132-plane merged apply at B=64,
// Q=256 (~5 us at 3.35 TB/s).  One thread per (g, b, q) with q fastest
// keeps the update reads coalesced; the stores land on data-dependent
// columns.  K4 reads the G planes of vals, inv once and upd once, and
// writes G planes: at G=132, B=64, N=3328, Q=256 that is 2 * 112.46 MB of
// planes + 0.85 MB of inv + 8.65 MB of upd (+ 0.07 MB of ids for K2),
// about 234.5 MB, or 0.070 ms at 3.35 TB/s.  Faster tilings are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

extern "C" int tnco_inv_ids(const void* ids, void* inv, int b, int n, int q,
                            void* stream) {
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

extern "C" int tnco_scatter_rows(void* vals, const void* ids, const void* inv,
                                 const void* upd, int g, int b, int n, int q,
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
