// scatter_acc.cu — scatter-accumulate of tap rows into a row table, for
// Hopper (sm_90a): the backward of the texture sampler's gather.
//
// Replaces the two Pallas TPU accumulators of the sampler-backward
// harnesses: scripts/sampler_bwd_variants2.py::acc_kernel (S1, via
// pallas_acc) and scripts/sampler_bwd_variants3.py::make_acc's kernel (S2,
// acc1/acc4 on taps in any order, acc1s on taps sorted by index).  Both
// compute, for taps idx[N] in [0, S) and values g[N, C],
//     out[S, C] = sum of g[n] over the n with idx[n] = s,
// the transpose of `flat[idx]`, i.e. zeros((S, C)).at[idx].add(g).  Taps
// outside [0, S) add nothing (memory safety: the texture fetch makes only
// in-range indices).  idx is int32 or int64, taken as it is (templated on
// the index type: no cast copy).  Modes, as scatter_accumulate_cuda.launches
// names them:
//
//   * "sorted": taps in ASCENDING index order (ops/texture.py::take_segsum
//     sorts them first).  This is a contract: taps out of order give an
//     undefined result (the kernel stays memory-safe).  One pass that
//     writes every output element exactly once, with no zero fill and no
//     global atomics, and the same bits on every run.
//   * "unsorted": taps in any order.  The output is zero-filled by the
//     caller (the only extra pass); one thread per tap adds its C channels
//     with warp-aggregated atomics.
//
// Bound.  Reading idx (4 bytes a tap, counted as int32) and g (4·C bytes)
// and writing the output once: N·(4 + 4C) + 4·S·C bytes over the HBM rate.
// On the Mat rows S·C is 5.6-22 M floats against 0.8 M taps, so the output
// write dominates: what counts is writing it once, coalesced and wide.
//
// "sorted" design.  The output rows and the taps are merged into one
// sequence (a tap of row s comes before the end of row s) and cut into
// slices of `items` items (merge path; at most 8192 / C, a 32 KB tile of
// rows, fewer where that leaves the card short of blocks): a block owns
// the rows whose end falls in its slice and the taps of its slice, so
// every block does at most `items` rows + taps of work, however long a
// run of equal indices is (a coarse mip texel takes thousands of taps).
// Two warps find the slice's ends in idx with a 32-way search (four
// dependent loads for 0.8 M taps) while the other six zero the block's
// tile of rows in shared memory; then each warp reduces a contiguous eighth of
// the slice's taps in chunks of 32 with a segmented scan over the lanes
// (shuffles; the sum of a run is built by many lanes, never one thread
// walking it), carrying an open run from chunk to chunk and loading the
// next chunk while it scans this one.  A run inside a warp's range is
// stored to the tile directly; a warp's first and last run go to a
// per-warp slot, and one thread combines the slots in warp order.  A run that crosses a block edge: each block publishes its last,
// open row's partial sum (its carry), one 64-bit word a channel that
// holds a tag beside the value (no fence); the block that owns the row's
// end adds the carries of the blocks before it (a warp reads 32 at a
// time and sums them with a fixed shuffle tree).  A block waits only on
// blocks of lower index, which the card starts first, and publishes
// before it waits: no wait can deadlock.  (No counter is shared by the
// blocks: same-address atomics of thousands of blocks serialise in L2.)
// Every sum is taken in an order fixed by the data alone, so the result
// is deterministic.  The tile is stored with 16-byte stores.
// The carry words are a scratch the caller keeps, and their tags hold an
// epoch the caller numbers per launch.  So launches that share a scratch
// must run in order (the wrapper keeps one per stream), and a launch must
// not be captured in a CUDA graph: every replay would reuse its epoch, a
// block could accept the previous replay's carry, and the sum would be
// wrong (the wrapper refuses while a stream is capturing).
//
// "unsorted" design.  One thread per element of g (coalesced loads, and
// the adds of a warp land on few rows' contiguous floats); consecutive
// taps into the same row (neighbouring pixels' texels in the sampler's
// order) sum in a warp's segmented scan first, and one lane adds each run
// with atomicAdd.  The atomics resolve in L2.  (Matching equal rows
// anywhere in the warp with __match_any_sync cost more than the atomics it
// saved on the harness rows.)
//
// What the TPU layout was for, and why it is gone.  The TPU kernels keep
// P phase-interleaved accumulators in VMEM (serial row read-modify-writes
// with P independent chains, then a tree add) to hide VMEM load-use
// latency, and pad C to the 128-lane tile.  The card needs neither: rows
// of C floats need no lane padding, and the latency is hidden by blocks.
//
// Why CUDA and not Triton: the segmented reduction needs warp shuffles, a
// fixed order of combination and a tagged hand-off between blocks, which
// CUDA expresses directly.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The most rows + taps a "sorted" block takes: 8192 floats of tile rows,
// so that a block's fixed latency (the slice's search, the hand-off) buys
// as much output as shared memory allows.  Fewer when the launch would
// otherwise not give every SM several blocks (sorted_items).
template <int kC>
__host__ __device__ constexpr int items_of() {
  return kC == 1 ? 8192 : kC == 2 ? 4096 : kC == 3 ? 2560 : 2048;
}

// the row of tap t, clamped into [0, s) (an out-of-range tap adds 0)
template <typename TI>
__device__ __forceinline__ int tap_row(const TI* idx, long long t, int s) {
  const long long i = static_cast<long long>(idx[t]);
  return i < 0 ? 0 : (i >= s ? s - 1 : static_cast<int>(i));
}

template <typename TI>
__device__ __forceinline__ bool tap_in_range(const TI* idx, long long t,
                                             int s) {
  const long long i = static_cast<long long>(idx[t]);
  return i >= 0 && i < s;
}

// The merge path's split at diagonal d: the first tap t with
// row(t) + t >= d (the taps before it come before the end of row d - t),
// in [max(0, d - s), min(d, n)].  row(t) + t strictly increases for
// ascending taps; the search is a 32-way bisection by one warp.
template <typename TI>
__device__ long long merge_split(const TI* idx, long long n, int s,
                                 long long d, int lane) {
  long long lo = d > s ? d - s : 0;
  long long hi = d < n ? d : n;
  while (hi > lo) {
    const long long step = (hi - lo + 31) / 32;
    const long long first = lo + static_cast<long long>(lane) * step;
    long long q = first + step - 1;
    if (q >= hi) q = hi - 1;
    const bool p = first < hi && tap_row(idx, q, s) + q >= d;
    const unsigned b = __ballot_sync(kFull, p);
    if (b == 0) {
      lo = hi;
    } else {
      const int f = __ffs(b) - 1;
      const long long f_lo = lo + static_cast<long long>(f) * step;
      long long f_q = f_lo + step - 1;
      if (f_q >= hi) f_q = hi - 1;
      lo = f_lo;
      hi = f_q;
    }
  }
  return lo;
}

template <typename TI, int kC>
__global__ void __launch_bounds__(kThreads) scatter_sorted_kernel(
    const TI* __restrict__ idx, const float* __restrict__ g, long long n,
    int s, int ld, int items, float* __restrict__ out,
    unsigned long long* __restrict__ carries, unsigned epoch) {
  constexpr int kItems = items_of<kC>();  // the tile's rows; items <= kItems
  // the tile: kItems + 1 rows (one spare for taps out of order), shifted by
  // `pad` floats so that a 16-byte-aligned output address is a 16-byte-
  // aligned tile address
  constexpr int kTile = ((kItems + 1) * kC + 4 + 3) / 4 * 4;
  __shared__ __align__(16) float tile[kTile];
  __shared__ int piece_key[kWarps][2];
  __shared__ float piece_val[kWarps][2][kC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const long long total = static_cast<long long>(s) + n;
  const long long d0 = static_cast<long long>(b) * items;
  const long long d1 = d0 + items < total ? d0 + items : total;
  __shared__ long long split[2];
  if (warp < 2) {
    const long long t = merge_split(idx, n, s, warp ? d1 : d0, lane);
    if (lane == 0) split[warp] = t;
  } else {
    float4* z = reinterpret_cast<float4*>(tile);
    for (int i = threadIdx.x - 64; i < kTile / 4; i += kThreads - 64)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x < kWarps * 2) piece_key[threadIdx.x >> 1][threadIdx.x & 1] = -1;
  __syncthreads();
  const long long t0 = split[0];
  const long long t1 = split[1] > t0 ? split[1] : t0;
  const long long r0 = d0 - t0;  // rows [r0, r1) end here; row r1 is open
  const long long r1 = d1 - t1;
  const bool strided = ld != kC;
  const int pad = strided ? 0 : static_cast<int>((r0 * kC) & 3);
  float* trow = tile + pad;  // trow[(row - r0) * kC + c]

  // each warp reduces a contiguous share of the taps [t0, t1)
  const long long nt = t1 - t0;
  const long long per = (nt + kWarps - 1) / kWarps;
  const long long a = t0 + (warp * per < nt ? warp * per : nt);
  const long long e = t0 + ((warp + 1) * per < nt ? (warp + 1) * per : nt);
  if (a < e) {
    const int first_key = tap_row(idx, a, s);
    int carry_key = -1;
    float carry[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) carry[c] = 0.f;
    // chunk k+1's taps are loaded while chunk k is scanned
    int next_key = INT_MAX;
    float next_v[kC];
    {
      const long long t = a + lane;
      if (t < e) next_key = tap_row(idx, t, s);
      const bool live = t < e && tap_in_range(idx, t, s);
#pragma unroll
      for (int c = 0; c < kC; ++c) next_v[c] = live ? g[t * ld + c] : 0.f;
    }
    for (long long base = a; base < e; base += 32) {
      const long long t = base + lane;
      const bool valid = t < e;
      const int key = next_key;
      float v[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) v[c] = next_v[c];
      {
        const long long tn = t + 32;
        next_key = INT_MAX;
        if (tn < e) next_key = tap_row(idx, tn, s);
        const bool live = tn < e && tap_in_range(idx, tn, s);
#pragma unroll
        for (int c = 0; c < kC; ++c) next_v[c] = live ? g[tn * ld + c] : 0.f;
      }
      // segmented inclusive scan over the lanes (keys ascend)
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int kk = __shfl_up_sync(kFull, key, off);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float vv = __shfl_up_sync(kFull, v[c], off);
          if (lane >= off && kk == key) v[c] = vv + v[c];
        }
      }
      if (key == carry_key) {
#pragma unroll
        for (int c = 0; c < kC; ++c) v[c] = carry[c] + v[c];
      }
      // the key after each lane's tap: the next lane's, or the next chunk's
      // first
      const int down = __shfl_down_sync(kFull, key, 1);
      const int ahead = __shfl_sync(kFull, next_key, 0);
      const int next = lane == 31 ? ahead : down;
      const bool end = valid && next != key;
      if (end) {
        const int slot = key == first_key ? 0 : (t == e - 1 ? 1 : -1);
        if (slot >= 0) {
          piece_key[warp][slot] = key;
#pragma unroll
          for (int c = 0; c < kC; ++c) piece_val[warp][slot][c] = v[c];
        } else {
          const long long row = key - r0;
          if (row >= 0 && row <= kItems) {
#pragma unroll
            for (int c = 0; c < kC; ++c) trow[row * kC + c] = v[c];
          }
        }
      }
      carry_key = __shfl_sync(kFull, valid && !end ? key : -1, 31);
#pragma unroll
      for (int c = 0; c < kC; ++c) carry[c] = __shfl_sync(kFull, v[c], 31);
    }
  }
  __syncthreads();

  // warp 0: combine the warps' first/last runs in warp order, publish the
  // carry of the open row r1, then add the carries of earlier blocks to row
  // r0 if its run began before this block
  if (warp == 0) {
    const bool need_in = t0 > 0 && r0 < r1 && tap_row(idx, t0 - 1, s) == r0;
    float own[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) own[c] = 0.f;
    if (lane == 0) {
      float out_carry[kC], acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) out_carry[c] = acc[c] = 0.f;
      long long cur = -1;
      for (int p = 0; p <= 2 * kWarps; ++p) {
        const int key = p < 2 * kWarps ? piece_key[p >> 1][p & 1] : -2;
        if (key == -1) continue;
        if (key == cur) {
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[c] = acc[c] + piece_val[p >> 1][p & 1][c];
          continue;
        }
        if (cur >= 0) {  // flush the finished run `cur`
          if (cur == r1) {
#pragma unroll
            for (int c = 0; c < kC; ++c) out_carry[c] = acc[c];
          } else if (cur == r0 && need_in) {
#pragma unroll
            for (int c = 0; c < kC; ++c) own[c] = acc[c];
          } else if (cur - r0 >= 0 && cur - r0 <= kItems) {
#pragma unroll
            for (int c = 0; c < kC; ++c) trow[(cur - r0) * kC + c] = acc[c];
          }
        }
        if (key == -2) break;
        cur = key;
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = piece_val[p >> 1][p & 1][c];
      }
      // one 64-bit word a channel: the tag (epoch, and whether the block is
      // all one open row) beside the value, so a reader that sees the tag
      // sees the value with it, and no fence is needed
      const unsigned long long tag =
          static_cast<unsigned long long>((epoch << 1) | (r0 == r1 ? 1u : 0u)) << 32;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        atomicExch(carries + 4LL * b + c, tag | __float_as_uint(out_carry[c]));
    }
    if (need_in) {
      float acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = 0.f;
      for (int k0 = b - 1;; k0 -= 32) {
        const int k = k0 - lane;
        unsigned st = 0;
        float v[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          v[c] = 0.f;
          if (k < 0) continue;
          // block k < b was dispatched before this one (blocks start in
          // index order) and publishes before it waits on anything; the
          // bound turns a broken scratch into a launch failure (after
          // seconds) instead of a hang
          const volatile unsigned long long* word = carries + 4LL * k + c;
          unsigned long long w;
          long long spins = 0;
          while (static_cast<unsigned>((w = *word) >> 33) != epoch) {
            if (++spins > (1LL << 26)) __trap();
            __nanosleep(32);
          }
          st = static_cast<unsigned>(w >> 32);
          v[c] = __uint_as_float(static_cast<unsigned>(w));
        }
        // the chain of carries ends at the first block that is not all one
        // open row (or at block 0)
        const unsigned stop = __ballot_sync(kFull, k < 0 || !(st & 1u));
        const int last = stop ? __ffs(stop) - 1 : 31;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          float x = lane <= last ? v[c] : 0.f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) x = x + __shfl_xor_sync(kFull, x, off);
          acc[c] = acc[c] + x;
        }
        if (stop) break;
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kC; ++c) trow[c] = own[c] + acc[c];
      }
    }
  }
  __syncthreads();

  // store rows [r0, r1): 16-byte stores where the layout is contiguous
  const long long nrow = r1 - r0 < kItems + 1 ? r1 - r0 : kItems + 1;
  if (!strided) {
    float* dst = out + r0 * kC;
    const long long nf = nrow * kC;
    const int head = (4 - pad) & 3;
    if (threadIdx.x < head && threadIdx.x < nf) dst[threadIdx.x] = trow[threadIdx.x];
    if (nf > head) {
      const long long n4 = (nf - head) / 4;
      float4* d4 = reinterpret_cast<float4*>(dst + head);
      const float4* s4 = reinterpret_cast<const float4*>(trow + head);
      for (long long i = threadIdx.x; i < n4; i += kThreads) d4[i] = s4[i];
      const long long done = head + n4 * 4;
      if (done + threadIdx.x < nf) dst[done + threadIdx.x] = trow[done + threadIdx.x];
    }
  } else {
    for (long long i = threadIdx.x; i < nrow * kC; i += kThreads) {
      const long long row = i / kC;
      out[(r0 + row) * ld + (i - row * kC)] = trow[i];
    }
  }
}

template <typename TI>
__global__ void __launch_bounds__(kThreads) scatter_unsorted_kernel(
    const TI* __restrict__ idx, const float* __restrict__ g, long long n,
    int c, int s, float* __restrict__ out) {
  // one thread an element of g (tap e / c, channel e % c): neighbouring
  // lanes load neighbouring floats and add into neighbouring floats
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long dst = -1;  // the output element, -1 for none
  float v = 0.f;
  if (e < n * c) {
    const long long tap = e / c;
    const long long i = static_cast<long long>(idx[tap]);
    if (i >= 0 && i < s) {
      dst = i * c + (e - tap * c);
      v = g[e];
    }
  }
  // runs of consecutive taps into the same element (lanes c apart) sum in
  // a segmented scan first; the run's last lane adds the sum
  const long long prev = __shfl_up_sync(kFull, dst, c);
  bool head = lane < c || prev != dst;
  for (int off = c; off < 32; off <<= 1) {
    const float vv = __shfl_up_sync(kFull, v, off);
    const bool hh = __shfl_up_sync(kFull, head, off);
    if (lane >= off && !head) {
      v = vv + v;
      head = hh;
    }
  }
  const long long next = __shfl_down_sync(kFull, dst, c);
  const bool last = lane + c > 31 || next != dst;
  if (dst >= 0 && last) atomicAdd(out + dst, v);
}

// rows + taps a sorted block takes: as many as its tile holds, or fewer so
// that the launch has at least 8 blocks an SM (the card's SM count is read
// once)
int sorted_items(long long n, int s, int c) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  const int most = c == 1 ? items_of<1>() : c == 2 ? items_of<2>()
                   : c == 3 ? items_of<3>() : items_of<4>();
  const long long fill = (static_cast<long long>(s) + n) / (8LL * sms);
  const long long items = (fill + 255) / 256 * 256;
  return static_cast<int>(items < 256 ? 256 : (items > most ? most : items));
}

long long sorted_blocks(long long n, int s, int c) {
  const int items = sorted_items(n, s, c);
  return (static_cast<long long>(s) + n + items - 1) / items;
}

template <typename TI>
int launch(const TI* idx, const float* g, long long n, int c, int ld, int s,
           int sorted, float* out, unsigned long long* carries,
           unsigned epoch, cudaStream_t st) {
  if (!sorted) {
    const long long blocks = (n * c + kThreads - 1) / kThreads;
    if (blocks == 0) return 0;
    scatter_unsorted_kernel<TI><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        idx, g, n, c, s, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (c > 4) return static_cast<int>(cudaErrorInvalidValue);
  const int items = sorted_items(n, s, c);
  const int blocks = static_cast<int>(sorted_blocks(n, s, c));
  switch (c) {
#define TEXIR_SORTED(C)                                                    \
  case C:                                                                  \
    scatter_sorted_kernel<TI, C><<<blocks, kThreads, 0, st>>>(             \
        idx, g, n, s, ld, items, out, carries, epoch);                     \
    break;
    TEXIR_SORTED(1)
    TEXIR_SORTED(2)
    TEXIR_SORTED(3)
    TEXIR_SORTED(4)
#undef TEXIR_SORTED
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of one "sorted" launch over n taps, s rows and c <= 4 channels:
// the wrapper sizes the scratch (carries: blocks × 4 int64, zeroed once)
// by it.
extern "C" long long texir_scatter_acc_blocks(long long n, int s, int c) {
  return sorted_blocks(n, s, c);
}

// Adds the n taps (idx [n] int32 if idx_bytes == 4, int64 if 8; g rows of
// c floats, ld apart) into out [s rows, ld apart] on `stream`.  sorted != 0
// runs the sorted mode (ascending taps; c <= 4; writes every element of
// the c columns; carries: the scratch above, epoch: a number
// that differs from the previous launch's on the same scratch, in
// [1, 2^31)); else the unsorted mode (ld == c; out zero-filled by the
// caller).  Returns the launch's cudaError_t.
extern "C" int texir_scatter_acc(const void* idx, int idx_bytes,
                                 const float* g, long long n, int c, int ld,
                                 int s, int sorted, float* out,
                                 unsigned long long* carries, unsigned epoch,
                                 void* stream) {
  if (n < 0 || c <= 0 || s <= 0 || ld < c || (sorted && c > 4) ||
      (!sorted && ld != c) || (idx_bytes != 4 && idx_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && !sorted) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (idx_bytes == 4)
    return launch(static_cast<const int*>(idx), g, n, c, ld, s, sorted, out,
                  carries, epoch, st);
  return launch(static_cast<const long long*>(idx), g, n, c, ld, s, sorted,
                out, carries, epoch, st);
}
