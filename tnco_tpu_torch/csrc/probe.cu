// P1: the row-read probe, the port's counterpart of the TPU kernels
// benchmarks/pallas_gather_probe.py: _loop_kernel (probe(..., 'loop'))
// and _take_kernel (probe(..., 'take')).  State rows are 128 int32 words;
// ids are [R, P], in [0, N) by contract; the kernels clamp them to that
// range (as the plain versions do), so no launch reads or writes out of
// bounds.
//
// loop  R rounds; round r reads the P rows state[ids[r, i]] into scratch
//       in order, then writes state[ids[r, i]] = scratch[i] + 1 in order
//       (a repeated id: the last i wins); returns the last round's
//       scratch [P, 128].  The Pallas body is one sequential loop, but a
//       row op copies a whole row, so the order only matters within a
//       column: one CTA of 128 threads, thread c owning column c, keeps
//       the TPU's order exactly with no barrier.  The scratch [P, 128]
//       lives in shared memory (64 KB at P=128: dynamic shared memory
//       above 48 KB); the working copy of the state is a global buffer
//       the wrapper allocates (1.7 MB at N=3328, more than an SM holds;
//       it sits in L2), filled from the input first, as the Pallas body's
//       state_ref[:] = state_in[:] does.  The input is not modified.
//
// take  out[p, :] = sum over r of state[ids[r, p], :], int32 wrapping.
//       One CTA per output row p, 128 threads over the columns, the sum
//       in a register.
//
// Bound on an H100 by the usual rule (each input read once, each output
// written once): the state 1.70 MB + ids 0.13 MB + out 0.07 MB = 1.90 MB
// at N=3328, P=128, R=256, about 0.57 us at 3.35 TB/s, for both.  That
// bound does not describe what the probe measures: a chain of dependent
// row reads and writes (loop: 2*R*P row ops of 512 B; take: R*P), whose
// cost per row op, in ns/row, is the number the walker's redesign needs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;

__device__ __forceinline__ long long clamp_row(int id, int n) {
  return (long long)(id < 0 ? 0 : (id >= n ? n - 1 : id)) * kCols;
}

__global__ void probe_loop_kernel(const int32_t* __restrict__ ids,
                                  const int32_t* __restrict__ state_in,
                                  int32_t* work, int32_t* __restrict__ out,
                                  int n, int p, int rounds) {
  extern __shared__ int32_t scratch[];  // [p, kCols]
  const int c = threadIdx.x;
  for (long long r = 0; r < n; ++r) {
    work[r * kCols + c] = state_in[r * kCols + c];
  }
  for (int r = 0; r < rounds; ++r) {
    const int32_t* row = ids + (long long)r * p;
    for (int i = 0; i < p; ++i) {
      scratch[i * kCols + c] = work[clamp_row(__ldg(row + i), n) + c];
    }
    for (int i = 0; i < p; ++i) {
      work[clamp_row(__ldg(row + i), n) + c] =
          (int32_t)((uint32_t)scratch[i * kCols + c] + 1u);
    }
  }
  for (int i = 0; i < p; ++i) out[i * kCols + c] = scratch[i * kCols + c];
}

__global__ void probe_take_kernel(const int32_t* __restrict__ ids,
                                  const int32_t* __restrict__ state,
                                  int32_t* __restrict__ out, int n, int p,
                                  int rounds) {
  const int pi = blockIdx.x;
  const int c = threadIdx.x;
  uint32_t acc = 0;
  for (int r = 0; r < rounds; ++r) {
    const int id = __ldg(ids + (long long)r * p + pi);
    acc += (uint32_t)__ldg(state + clamp_row(id, n) + c);
  }
  out[(long long)pi * kCols + c] = (int32_t)acc;
}

}  // namespace

extern "C" int tnco_probe_loop(const void* ids, const void* state_in,
                               void* work, void* out, int n, int p,
                               int rounds, void* stream) {
  if (n <= 0 || p <= 0 || rounds <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)p * kCols * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      probe_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_loop_kernel<<<1, kCols, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)state_in, (int32_t*)work,
      (int32_t*)out, n, p, rounds);
  return (int)cudaGetLastError();
}

extern "C" int tnco_probe_take(const void* ids, const void* state, void* out,
                               int n, int p, int rounds, void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  probe_take_kernel<<<p, kCols, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)state, (int32_t*)out, n, p,
      rounds);
  return (int)cudaGetLastError();
}
