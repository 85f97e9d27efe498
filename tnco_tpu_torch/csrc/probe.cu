// P1: the row-read probe, the port's counterpart of the TPU kernels
// benchmarks/pallas_gather_probe.py: _loop_kernel (probe(..., 'loop'))
// and _take_kernel (probe(..., 'take')).  State rows are 128 int32 words;
// ids are [R, P], in [0, N) by contract; the kernels clamp them to that
// range (as the plain versions do), so no launch reads or writes out of
// bounds.  The caller's state is never written.
//
// loop  R rounds; round r reads the P rows state[ids[r, i]] into scratch
//       in order, then writes state[ids[r, i]] = scratch[i] + 1 in order
//       (a repeated id: the last i wins); returns the last round's
//       scratch [P, 128].  Two facts about that function shape the
//       kernel:
//       1. Columns are independent: a row op copies a whole row, so
//          column c of the result depends only on column c of the state.
//       2. The writes of a round commute: all P reads of a round come
//          before any of its writes, so two equal ids in one round read
//          the same row and write the same value, scratch + 1.  "The last
//          i wins" needs no ordering, and a round's writes may land in
//          any order.
//       Route 'smem' (benchmarks/gather_probe.py: loop_route): one block
//       per column keeps that column of all N rows in shared memory (13 KB
//       at N = 3328), copied in once with cp.async by all of its threads.
//       Thread i owns pair i of a round, its scratch word in a register.
//       A round is a read phase (the round's id, then the row's word),
//       __syncthreads(), a write phase, __syncthreads(): no round touches
//       global memory.  The ids come into shared memory a stage of rps
//       rounds at a time (cp.async, two buffers): the copy of stage s + 1
//       starts when stage s starts and is waited for at the last barrier
//       of stage s.  The output is written from the last round's
//       registers.  The wrapper picks the launch: threads (P in whole
//       warps), rps, and the route, from what fits a block's shared
//       memory.  (More columns a block, more pairs a thread, and reading
//       the next round's ids in the write phase measured slower on the
//       card: scripts/probe_inv_first_design.cu keeps them, PERF.md.)
//       Route 'global' (larger N): the first design, one block of 128
//       threads, thread c owning column c, keeping the TPU's order with
//       no barrier; the scratch [P, 128] in shared memory (P <= 454),
//       the working copy of the state in a global buffer that the
//       wrapper allocates (it sits in L2).
//
// take  out[p, :] = sum over r of state[ids[r, p], :], int32 wrapping.
//       One block of kTakeWarps warps per output row p.  A warp reads a
//       whole 512-byte row with one 16-byte load a lane, kTakeUnroll rows
//       in flight; the warps split the R rounds in chunks of 32 (a lane
//       loads one id of the chunk and the warp broadcasts it), keep their
//       sums in registers and add them up in shared memory.  The wrapping
//       sum is associative and commutative, so any order is bitwise the
//       plain version's.
//
// Bound on an H100 by the usual rule (each input read once, each output
// written once): the state 1.70 MB + ids 0.13 MB + out 0.07 MB = 1.90 MB
// at N = 3328, P = 128, R = 256, about 0.57 us at 3.35 TB/s, for both.
// That bound does not describe what the probe measures: dependent rounds
// of row reads and writes (loop: 2 R P row ops of 512 B, 2 R barrier-
// separated phases per block) and R P row reads (take: 16.8 MB from L2).
// Their floors are measured beside them (scripts/profile_torch_probe_inv.py:
// the same barriers with no memory work; a streaming read of an
// L2-resident buffer).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;
constexpr int kTakeWarps = 8;
constexpr int kTakeUnroll = 8;

__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

__device__ __forceinline__ long long clamp_row(int id, int n) {
  return (long long)clamp_id(id, n) * kCols;
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

__global__ void __launch_bounds__(1024)
    probe_loop_smem_kernel(const int32_t* __restrict__ ids,
                           const int32_t* __restrict__ state,
                           int32_t* __restrict__ out, int n, int p,
                           int rounds, int rps) {
  extern __shared__ int32_t smem[];
  int32_t* st = smem;                  // [n]: column c of the state
  int32_t* stage = smem + n;           // [2][rps * p]
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int c = blockIdx.x;
  const int stage_words = rps * p;
  const int n_stages = (rounds + rps - 1) / rps;

  auto fetch = [&](int s) {
    int32_t* dst = stage + (s & 1) * stage_words;
    const int32_t* src = ids + (size_t)s * stage_words;
    const int words = min(stage_words, (rounds - s * rps) * p);
    for (int w = t; w < words; w += nt) cp_async4(dst + w, src + w);
    cp_async_commit();
  };

  // The block's column and the first stage of ids, all copies in flight
  // at once.
  for (int r = t; r < n; r += nt) {
    cp_async4(st + r, state + (size_t)r * kCols + c);
  }
  fetch(0);
  const bool mine = t < p;
  const int at = mine ? t : 0;
  int off = 0;
  int32_t val = 0;
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) fetch(s + 1);
    const int32_t* rid = stage + (s & 1) * stage_words;
    const int r_end = min(rps, rounds - s * rps);
    for (int rr = 0; rr < r_end; ++rr, rid += p) {
      off = clamp_id(rid[at], n);
      val = st[off];
      __syncthreads();
      if (mine) st[off] = (int32_t)((uint32_t)val + 1u);
      if (rr == r_end - 1) cp_async_wait_all();
      __syncthreads();
    }
  }
  if (mine) out[(size_t)t * kCols + c] = val;
}

__global__ void probe_loop_global_kernel(const int32_t* __restrict__ ids,
                                         const int32_t* __restrict__ state_in,
                                         int32_t* work,
                                         int32_t* __restrict__ out, int n,
                                         int p, int rounds) {
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

__global__ void __launch_bounds__(kTakeWarps * 32)
    probe_take_kernel(const int32_t* __restrict__ ids,
                      const int32_t* __restrict__ state,
                      int32_t* __restrict__ out, int n, int p, int rounds) {
  __shared__ uint4 part[kTakeWarps][32];
  const int pi = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint4* rows = reinterpret_cast<const uint4*>(state);
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int r0 = warp * 32; r0 < rounds; r0 += kTakeWarps * 32) {
    const int cnt = min(32, rounds - r0);
    int mine = 0;
    if (lane < cnt) {
      mine = clamp_id(__ldg(ids + (size_t)(r0 + lane) * p + pi), n);
    }
    for (int j0 = 0; j0 < cnt; j0 += kTakeUnroll) {
      uint4 v[kTakeUnroll];
#pragma unroll
      for (int u = 0; u < kTakeUnroll; ++u) {
        const int id = __shfl_sync(0xFFFFFFFFu, mine, (j0 + u) & 31);
        v[u] = j0 + u < cnt ? __ldg(rows + (size_t)id * (kCols / 4) + lane)
                            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kTakeUnroll; ++u) {
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    uint4 sum = part[0][lane];
#pragma unroll
    for (int w = 1; w < kTakeWarps; ++w) {
      sum.x += part[w][lane].x;
      sum.y += part[w][lane].y;
      sum.z += part[w][lane].z;
      sum.w += part[w][lane].w;
    }
    reinterpret_cast<uint4*>(out)[(size_t)pi * (kCols / 4) + lane] = sum;
  }
}

}  // namespace

// threads > 0: the smem route, in `threads` threads (whole warps, at
// least p) with the ids staged `rps` rounds a buffer; threads = 0: the
// global route, whose working copy `work` ([n, 128] int32) the caller
// allocates (null otherwise).  benchmarks/gather_probe.py: _launch_loop.
extern "C" int tnco_probe_loop(const void* ids, const void* state_in,
                               void* work, void* out, int n, int p,
                               int rounds, int threads, int rps,
                               void* stream) {
  if (n <= 0 || p <= 0 || rounds <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* id32 = (const int32_t*)ids;
  const int32_t* s32 = (const int32_t*)state_in;
  int32_t* o32 = (int32_t*)out;
  if (threads == 0) {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)p * kCols * sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        probe_loop_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    probe_loop_global_kernel<<<1, kCols, smem, st>>>(id32, s32, (int32_t*)work,
                                                    o32, n, p, rounds);
    return (int)cudaGetLastError();
  }
  if (threads < p || threads % 32 || rps <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 4 * ((size_t)n + 2 * (size_t)rps * p);
  cudaError_t err = cudaFuncSetAttribute(
      probe_loop_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_loop_smem_kernel<<<kCols, threads, smem, st>>>(id32, s32, o32, n, p,
                                                       rounds, rps);
  return (int)cudaGetLastError();
}

// state and out 16-byte aligned (the wrapper checks the state).
extern "C" int tnco_probe_take(const void* ids, const void* state, void* out,
                               int n, int p, int rounds, void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  probe_take_kernel<<<p, kTakeWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const int32_t*)state, (int32_t*)out, n, p,
      rounds);
  return (int)cudaGetLastError();
}
