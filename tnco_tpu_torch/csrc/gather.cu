// K1: per-replica row gather, the port's counterpart of the TPU kernel
// tnco_tpu/kernels/pallas_gather.py:_kernel (entry point gather_gbn).
//
//   out[g, b, q] = vals[g, b, ids[b, q]]   for 0 <= ids[b, q] < n,
//   out[g, b, q] = 0                       otherwise.
//
// Any 32-bit dtype: the kernel moves words and never does arithmetic on
// them.  `vals` points at the first plane of the requested range (the
// wrapper offsets the pointer), so a plane range is read without a copy.
//
// Bound on an H100: memory.  Each output word costs one id read (cached:
// B*Q ids are reused across all G planes) and one 4-byte read at a
// data-dependent column of its plane row, plus one 4-byte store.  The
// least traffic is G*B*Q*8 bytes + B*Q*4 (about 21 MB for the W=64 index
// gather at B=64, Q=640: ~6 us at 3.35 TB/s).  One thread per output
// word with q fastest keeps the stores and the id reads coalesced; the
// gathered reads hit random columns of one [N] row, which the L2 (50 MB)
// absorbs at these sizes.  TMA tiling is later work.

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

}  // namespace

extern "C" int tnco_gather_gbn(const void* vals, const void* ids, void* out,
                               int g, int b, int n, int q, void* stream) {
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
