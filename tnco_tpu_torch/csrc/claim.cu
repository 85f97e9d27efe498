// The walk engines' sequential (priority) claim in one launch, the port's
// counterpart of the claim scan of tnco_tpu/kernels/sa_multiwalk.py:282-302
// (a `fori_loop` inside one XLA program; no pallas_call site).  Its plain
// version is kernels/claim.py: claim_disjoint_plain.
//
//   keep[b, i] = accept[b, i] and none of the five ids {a, b, c, d, e}[b, i]
//                equals any of the five ids of a KEPT walk j < i of the
//                same replica.
//
// Ids compare as plain int32 values: NULL (-1) equals NULL, as in the plain
// version's conflict matrix, and an id within one walk may repeat.
//
// Bound on an H100: the bytes are about 22 B a walk (five int32 ids and the
// accept byte in, the keep byte out): 5.8 MB, 1.7 us at 3.35 TB/s, at the
// FW walks cell's B=2048, P=128.  What bounds the kernel is the priority
// chain: walk i's decision depends on every earlier walk's, so a replica
// takes P dependent steps.
//
// Design: one warp per replica, several replicas a block, every replica at
// once across the SMs, so the launch takes about one replica's chain, and
// the chain's steps touch no device memory.  The warp reads its walks 32 at
// a time, lane t holding walk t's ids and accept bit in registers (one
// coalesced load a group where the walk axis is contiguous); a step takes
// its walk from lane t with __shfl_sync.  The warp keeps the replica's kept
// ids in shared memory (5 int32 per kept walk, 5P words at most): the lanes
// compare the walk's ids against that list 32 entries at a time and vote
// with __any_sync, and five lanes append the ids if the walk is kept.  A
// rejected walk skips the compares.  Lane t keeps walk t's bit and stores
// it with the group.  This replaces the plain version's [B, P, P] conflict
// matrix (50 broadcast passes) and its ~5 launches a walk.  Any P that fits
// the shared memory (P <= 11622 at one warp a block) and any strides of the
// inputs are taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;  // replicas a block
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // an H100 block's opt-in shared memory
constexpr unsigned kFull = 0xffffffffu;

// The five id planes and the accept plane, each addressed by its own
// strides (elements) over (replica, walk).
struct Inputs {
  const int32_t* ids[5];
  long long ids_sb[5];
  long long ids_sp[5];
  const bool* accept;
  long long acc_sb;
  long long acc_sp;
};

__global__ void claim_disjoint_kernel(Inputs in, bool* __restrict__ keep,
                                      int nb, int p, int warps) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * warps + warp;
  if (r >= nb) return;  // the whole warp leaves; no block barrier follows
  int32_t* kept = smem + (long long)warp * 5 * p;
  int n_kept = 0;
  for (int base = 0; base < p; base += 32) {
    // Lane t holds walk base + t of this group of 32.
    const int j = base + lane;
    int32_t my[5] = {0, 0, 0, 0, 0};
    bool my_acc = false;
    if (j < p) {
#pragma unroll
      for (int k = 0; k < 5; ++k)
        my[k] = __ldg(in.ids[k] + r * in.ids_sb[k] + j * in.ids_sp[k]);
      my_acc = in.accept[r * in.acc_sb + j * in.acc_sp];
    }
    const int m = p - base < 32 ? p - base : 32;
    bool mine = false;
    for (int t = 0; t < m; ++t) {
      bool kp = __shfl_sync(kFull, my_acc, t);
      if (kp) {  // uniform across the warp
        int32_t x[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) x[k] = __shfl_sync(kFull, my[k], t);
        bool hit = false;
        for (int k = lane; k < n_kept; k += 32) {
          const int32_t v = kept[k];
          hit |= (v == x[0]) | (v == x[1]) | (v == x[2]) | (v == x[3]) |
                 (v == x[4]);
        }
        kp = !__any_sync(kFull, hit);
        if (kp) {
          const int32_t v = lane == 0   ? x[0]
                            : lane == 1 ? x[1]
                            : lane == 2 ? x[2]
                            : lane == 3 ? x[3]
                                        : x[4];
          if (lane < 5) kept[n_kept + lane] = v;
          n_kept += 5;
          __syncwarp();
        }
      }
      if (lane == t) mine = kp;
    }
    if (j < p) keep[r * p + j] = mine;
  }
}

}  // namespace

// ids: five pointers; ids_sb, ids_sp: their strides in elements; accept
// with strides acc_sb, acc_sp; keep: a contiguous [nb, p] bool output.
extern "C" int tnco_claim_disjoint(const void* const* ids,
                                   const long long* ids_sb,
                                   const long long* ids_sp,
                                   const void* accept, long long acc_sb,
                                   long long acc_sp, void* keep, int nb,
                                   int p, void* stream) {
  if ((long long)nb * p <= 0) return 0;
  Inputs in;
  for (int k = 0; k < 5; ++k) {
    in.ids[k] = (const int32_t*)ids[k];
    in.ids_sb[k] = ids_sb[k];
    in.ids_sp[k] = ids_sp[k];
  }
  in.accept = (const bool*)accept;
  in.acc_sb = acc_sb;
  in.acc_sp = acc_sp;
  const long long per_warp = 5LL * p * 4;
  int warps = kMaxWarps;
  while (warps > 1 && warps * per_warp > kStaticSmem) warps /= 2;
  const long long smem = warps * per_warp;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        claim_disjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (nb + warps - 1) / warps;
  claim_disjoint_kernel<<<blocks, warps * 32, (size_t)smem,
                          (cudaStream_t)stream>>>(in, (bool*)keep, nb, p,
                                                  warps);
  return (int)cudaGetLastError();
}
