// scatter_acc.cu — scatter-accumulate of tap rows into a row table, for
// Hopper (sm_90a): the backward of the texture sampler's gather.
//
// Replaces the two Pallas TPU accumulators of the sampler-backward
// harnesses: scripts/sampler_bwd_variants2.py::acc_kernel (S1, via
// pallas_acc) and scripts/sampler_bwd_variants3.py::make_acc's kernel (S2,
// acc1/acc4 on taps in any order, acc1s on taps sorted by index).  Both
// compute, for taps idx[N] in [0, S) and values g[N, C],
//     out[S, C] = sum of g[n] over the n with idx[n] = s,
// the transpose of `flat[idx]`, i.e. zeros((S, C)).at[idx].add(g).  Modes,
// as scatter_accumulate_cuda.launches names them:
//   * "unsorted": taps in any order.  One thread per element of g (tap n,
//     channel c), which adds g[n, c] into out[idx[n], c] with atomicAdd.
//   * "sorted": taps sorted by idx (ops/texture.py::take_segsum sorts them
//     first).  One thread per tap; a thread whose tap starts a run of equal
//     indices within its block (the block's first tap, or idx[n-1] !=
//     idx[n]) sums the run's rows in tap order and adds the run's total
//     once per channel.  A run cut by a block boundary adds once per
//     piece.  Taps in any order still give the right sums (more, shorter
//     runs); sorting only makes the runs long.
// The output must be zero-filled (the wrapper allocates it with
// torch.zeros).  Taps outside [0, S) are skipped, for memory safety: the
// texture fetch makes only in-range indices.
//
// What the TPU layout was for, and why it is gone.  The TPU kernels keep
// P phase-interleaved accumulators in VMEM (serial row read-modify-writes
// with P independent chains, then a tree add) to hide VMEM load-use
// latency, and pad C to the 128-lane tile.  The card has neither problem:
// its L2 performs the atomic adds, thousands of them in flight, and rows
// of C floats need no lane padding.
//
// Bound.  Reading idx (4 bytes) and g (4·C bytes) per tap and writing the
// S·C·4-byte output: the kernel is bound by memory, N·(4 + 4C) + 4·S·C
// bytes over the HBM rate (the atomics resolve in L2).  Heavy duplication
// serialises the atomics of one address in "unsorted" mode; "sorted" mode
// turns a run into one add per channel.  This first version reads g with
// plain loads in both modes (a run's head walks its run serially); a
// warp-level segmented reduction is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) scatter_unsorted_kernel(
    const int* __restrict__ idx, const float* __restrict__ g, long long n,
    int c, long long s, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n * c) return;
  const long long tap = e / c;
  const int ch = (int)(e - tap * c);
  const int i = idx[tap];
  if (i < 0 || i >= s) return;
  atomicAdd(out + (long long)i * c + ch, g[e]);
}

__global__ void __launch_bounds__(kThreads) scatter_sorted_kernel(
    const int* __restrict__ idx, const float* __restrict__ g, long long n,
    int c, long long s, float* __restrict__ out) {
  const long long block0 = (long long)blockIdx.x * kThreads;
  const long long tap = block0 + threadIdx.x;
  if (tap >= n) return;
  const int i = idx[tap];
  // a run starts at the block's first tap or where the index changes
  if (tap != block0 && idx[tap - 1] == i) return;
  if (i < 0 || i >= s) return;
  long long end = block0 + kThreads;
  if (end > n) end = n;
  long long last = tap + 1;
  while (last < end && idx[last] == i) ++last;
  for (int ch = 0; ch < c; ++ch) {
    float sum = 0.0f;
    for (long long k = tap; k < last; ++k) sum += g[k * c + ch];
    atomicAdd(out + (long long)i * c + ch, sum);
  }
}

}  // namespace

// Adds the n taps (idx [n] int32, g [n, c] float32, both contiguous) into
// out [s, c] float32 (zero-filled by the caller) on `stream`; sorted != 0
// runs the sorted mode.  Returns the launch's cudaError_t.
extern "C" int texir_scatter_acc(const int* idx, const float* g, long long n,
                                 int c, long long s, int sorted, float* out,
                                 void* stream) {
  if (n < 0 || c <= 0 || s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long work = sorted ? n : n * c;
  const long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (sorted)
    scatter_sorted_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(idx, g, n, c,
                                                                 s, out);
  else
    scatter_unsorted_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        idx, g, n, c, s, out);
  return static_cast<int>(cudaGetLastError());
}
