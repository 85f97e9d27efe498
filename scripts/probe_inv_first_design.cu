// The first design of the row-read probe P1 (loop and take) and of the id
// inversion K2, kept as the baseline that scripts/profile_torch_probe_inv.py
// runs in turns with tnco_tpu_torch/csrc/probe.cu and csrc/scatter.cu:
// those kernels as they were before their redesign, unchanged but for the
// names of the entry points (tnco_probe_loop_first, tnco_probe_take_first,
// tnco_inv_ids_first), so that both builds load side by side.  It also
// holds the floors measured beside the new kernels (also by chip_smoke.py
// phase 10):
//   tnco_barrier_floor  the loop's grid doing its 2 R __syncthreads() and
//                       no memory work;
//   tnco_l2_read        a streaming read of an L2-resident buffer, passes
//                       times (the L2 read rate under the take kernel);
//   tnco_empty_floor    an empty kernel on a given grid (a launch's floor,
//                       under K2).
// And the launch forms of the redesigned loop that the card measured
// slower than the kept one (tnco_probe_loop_form): CPB columns a block
// (1, 2, 4 or 8; 128 down to 16 blocks) and NPP (i, column) pairs a
// thread (1, 2, 4 or 8), and, at three of those forms, the next round's
// ids read in the write phase.  Form (1, 1) without that is the kept
// kernel (csrc/probe.cu probe_loop_smem_kernel).  Nothing on the main
// path builds this file.
//
// P1 loop  one block of 128 threads, thread c owning column c, in the
//          TPU's order with no barrier; the scratch [P, 128] in shared
//          memory, the working copy of the state in a global buffer (L2).
// P1 take  one block of 128 threads per output row p, the sum over R in a
//          register (scalar 4-byte loads).
// K2       one block per replica, atomicMax over q into the row in shared
//          memory (n <= 12288), else into the output row in global memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;
constexpr int kSmemBytes = 48 * 1024;

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

__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The redesigned loop's smem route with CPB columns a block and NPP
// (i, column) pairs a thread (a template argument: a first try with a
// run-time count of pairs, guarded, and plain loads in the prologue
// measured 8x slower; PERF.md).  NEXT: the write
// phase also reads the next round's ids (within a stage), so that a read
// phase is one shared-memory load and the barrier.
template <int CPB, int NPP, bool NEXT>
__global__ void __launch_bounds__(1024)
    probe_loop_form_kernel(const int32_t* __restrict__ ids,
                           const int32_t* __restrict__ state,
                           int32_t* __restrict__ out, int n, int p,
                           int rounds, int rps) {
  extern __shared__ int32_t smem[];
  int32_t* st = smem;                        // [n][CPB]
  int32_t* stage = smem + (size_t)n * CPB;   // [2][rps * p]
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int c0 = blockIdx.x * CPB;
  const int stage_words = rps * p;
  const int n_stages = (rounds + rps - 1) / rps;
  auto fetch = [&](int s) {
    int32_t* dst = stage + (s & 1) * stage_words;
    const int32_t* src = ids + (size_t)s * stage_words;
    const int words = min(stage_words, (rounds - s * rps) * p);
    for (int w = t; w < words; w += nt) cp_async4(dst + w, src + w);
    cp_async_commit();
  };
  for (int e = t; e < n * CPB; e += nt) {
    cp_async4(st + e, state + (size_t)(e / CPB) * kCols + c0 + e % CPB);
  }
  fetch(0);
  // The thread's pairs k = t + j * nt: row i = k / CPB of a round's ids,
  // column k % CPB; the same every round.
  int at[NPP], col[NPP], off[NPP];
  int32_t val[NPP];
  bool mine[NPP];
#pragma unroll
  for (int j = 0; j < NPP; ++j) {
    const int k = t + j * nt;
    mine[j] = k < p * CPB;
    at[j] = mine[j] ? k / CPB : 0;
    col[j] = k % CPB;
  }
  auto offsets = [&](const int32_t* rid) {
#pragma unroll
    for (int j = 0; j < NPP; ++j) {
      off[j] = clamp_id(rid[at[j]], n) * CPB + col[j];
    }
  };
  cp_async_wait_all();
  __syncthreads();
  if (NEXT) offsets(stage);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) fetch(s + 1);
    const int32_t* rid = stage + (s & 1) * stage_words;
    const int r_end = min(rps, rounds - s * rps);
    for (int rr = 0; rr < r_end; ++rr) {
      if (!NEXT) offsets(rid + rr * p);
#pragma unroll
      for (int j = 0; j < NPP; ++j) val[j] = st[off[j]];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NPP; ++j) {
        if (mine[j]) st[off[j]] = (int32_t)((uint32_t)val[j] + 1u);
      }
      if (NEXT && rr + 1 < r_end) offsets(rid + (rr + 1) * p);
      if (rr == r_end - 1) cp_async_wait_all();
      __syncthreads();
    }
    if (NEXT && s + 1 < n_stages) {
      offsets(stage + ((s + 1) & 1) * stage_words);
    }
  }
#pragma unroll
  for (int j = 0; j < NPP; ++j) {
    if (mine[j]) out[(size_t)at[j] * kCols + c0 + col[j]] = val[j];
  }
}

// rps: rounds of ids a stage buffer (benchmarks/gather_probe.py:
// loop_stage_rounds).
template <int CPB, int NPP, bool NEXT>
int launch_form(const void* ids, const void* state, void* out, int n, int p,
                int rounds, int rps, cudaStream_t st) {
  const int threads = (p * CPB + NPP - 1) / NPP;
  const size_t smem = 4 * ((size_t)n * CPB + 2 * (size_t)rps * p);
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      probe_loop_form_kernel<CPB, NPP, NEXT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_loop_form_kernel<CPB, NPP, NEXT>
      <<<kCols / CPB, (threads + 31) / 32 * 32, smem, st>>>(
          (const int32_t*)ids, (const int32_t*)state, (int32_t*)out, n, p,
          rounds, rps);
  return (int)cudaGetLastError();
}

template <int CPB>
int launch_pairs(int pairs, const void* ids, const void* state, void* out,
                 int n, int p, int rounds, int rps, cudaStream_t st) {
  switch (pairs) {
    case 1: return launch_form<CPB, 1, false>(ids, state, out, n, p, rounds,
                                              rps, st);
    case 2: return launch_form<CPB, 2, false>(ids, state, out, n, p, rounds,
                                              rps, st);
    case 4: return launch_form<CPB, 4, false>(ids, state, out, n, p, rounds,
                                              rps, st);
    case 8: return launch_form<CPB, 8, false>(ids, state, out, n, p, rounds,
                                              rps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

__global__ void barrier_floor_kernel(int32_t* out, int rounds) {
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = rounds;
}

__global__ void l2_read_kernel(const uint4* __restrict__ buf, long long n4,
                               int passes, uint32_t* out) {
  uint32_t acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int pass = 0; pass < passes; ++pass) {
#pragma unroll 4
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += stride) {
      const uint4 v = __ldcg(buf + i);  // L2 only: no L1 hits across passes
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x9E3779B9u) out[0] = acc;  // keeps the loads live
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int tnco_probe_loop_first(const void* ids, const void* state_in,
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

extern "C" int tnco_probe_take_first(const void* ids, const void* state,
                                     void* out, int n, int p, int rounds,
                                     void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  probe_take_kernel<<<p, kCols, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)state, (int32_t*)out, n, p,
      rounds);
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

// cols columns a block (1, 2, 4 or 8), pairs a thread (1, 2, 4 or 8, in
// at most 1024 threads); next: the next round's ids read in the write
// phase, at (cols, pairs) (1, 1), (2, 1) and (4, 2) only.
extern "C" int tnco_probe_loop_form(const void* ids, const void* state,
                                    void* out, int n, int p, int rounds,
                                    int rps, int cols, int pairs, int next,
                                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (next) {
    if (cols == 1 && pairs == 1)
      return launch_form<1, 1, true>(ids, state, out, n, p, rounds, rps, st);
    if (cols == 2 && pairs == 1)
      return launch_form<2, 1, true>(ids, state, out, n, p, rounds, rps, st);
    if (cols == 4 && pairs == 2)
      return launch_form<4, 2, true>(ids, state, out, n, p, rounds, rps, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (cols) {
    case 1: return launch_pairs<1>(pairs, ids, state, out, n, p, rounds, rps,
                                   st);
    case 2: return launch_pairs<2>(pairs, ids, state, out, n, p, rounds, rps,
                                   st);
    case 4: return launch_pairs<4>(pairs, ids, state, out, n, p, rounds, rps,
                                   st);
    case 8: return launch_pairs<8>(pairs, ids, state, out, n, p, rounds, rps,
                                   st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: at least `blocks` int32 words.
extern "C" int tnco_barrier_floor(void* out, int blocks, int threads,
                                  int rounds, void* stream) {
  barrier_floor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, rounds);
  return (int)cudaGetLastError();
}

// buf: 16-byte aligned, `words` a multiple of 4.
extern "C" int tnco_l2_read(const void* buf, long long words, int passes,
                            void* out, int blocks, int threads,
                            void* stream) {
  l2_read_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)buf, words / 4, passes, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int tnco_empty_floor(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
