// gate_pulses: each block's first native-gate trigger and the PIE pulse count
// at it, from the packed flags, in one launch.
//
// Replaces no Pallas kernel: the JAX package counts the pulses with the
// segmented doubling scan of gen2_rfid_tpu/dsp/gate.py:108-137
// (_rises_since_reset), tests the trigger at :273-280 and takes each block's
// first trigger with the pad and amin of :282-305.  The port's plain version
// is dsp/gate.py::gate_pulses_plain, that chain in PyTorch; the kernel gives
// its outputs bit for bit.
//
// Per sample i, with the flags' bits RISE 1, QUALIFY 2, MARKER 4 and QUIET 8
// (kernels/gate_stack.py):
//
//   reset[i]  = (rise & !qualify) | marker
//   clean[i]  = rise & !reset
//   pulses(i) = #{j : max(p(i), i - W) < j <= i, clean[j]}, p(i) the last
//               reset <= i; samples before 0 hold no flag.  W is the scan's
//               reach: the least power of two >= the command span.
//   trig[i]   = rise & pulses(i) > npc & quiet & i + nt1 + 1 < n
//
// Outputs, for block b of bsz samples (bsz 1 where gate_detect takes no
// blocks): cand[b], the least i + nt1 + 1 over the block's triggers, else n,
// and pulses[b], pulses(i) at that trigger, else 0; counts[0], the
// triggers in all, and counts[1], pulses(max(n - nt1 - 2, 0)), which the
// event table's invalid slots keep.
//
// Design.  A thread block takes a tile of T samples and the H >= W samples
// before it (its halo), so every window it counts lies in what it read; a
// tile is a multiple of bsz, so no block straddles two.
//
// 1. masks: a warp loads 1024 samples (32 coalesced loads in flight a
//    lane, streaming: the flags are read once) and turns them into 32 words
//    of three masks with ballots (clean rises, resets, and rises with quiet
//    after them, the trigger's candidates), lane k keeping word k, into
//    shared memory.
// 2. scans: each thread sums its run of words, a block scan combines the
//    runs, and each word gets P, the clean rises before it in the tile and
//    halo, and L, the last word up to it that holds a reset.
// 3. triggers: for each candidate bit, p(i) is the highest reset bit at or
//    below it in its word, else the highest in word L[w - 1]; the count is
//    two prefix lookups, P plus a popcount of the word below the bit, at i
//    and at max(p(i), i - W).  The candidate word becomes the trigger word.
// 4. blocks: a thread per block of bsz samples finds its first trigger bit
//    and counts there again.
//
// Nothing but the outputs goes to device memory.  Bound on an H100: bytes,
// the int32 flags read once and the two block outputs written (at the
// benchmark's Ny = 46.6 M, 186.4 MB + 5.8 MB, about 57 us at 3.35 TB/s); the
// halo's second read mostly hits L2, where its tile's left neighbour has
// just put it.  The loads alone run at 87% of the bound (0.066 ms at the
// cell's Ny); the ballots bring the kernel to about 75% (PERF.md).
// counts[0] is zeroed by a memset on the stream before the kernel, and each
// block adds its triggers with one integer atomic, which gives the same sum
// in any order.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;                // resident blocks an SM: at most 64 registers
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 1024;                 // samples a warp masks at a time
constexpr int kMinWords = 2;                 // words a thread, at the least (PERF.md)
constexpr long long kSmemLimit = 227 * 1024;

struct Geometry {
  int halo, tile, wpt;
  long long smem;
};

bool is_pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

// A launch's tile for a window and block: kThreads * wpt words of 32
// samples, H of them the halo; wpt is kMinWords, or H / 2048 (3 H of tile)
// once that is more.
bool geometry(int window, int step, Geometry* g) {
  if (!is_pow2(window) || !is_pow2(step) || step > 512) return false;
  g->halo = window > step ? window : step;
  if (g->halo < 32) g->halo = 32;
  g->wpt = g->halo / 2048 > kMinWords ? g->halo / 2048 : kMinWords;
  const long long span = 32LL * kThreads * g->wpt;
  if (span <= g->halo || span > INT_MAX) return false;
  g->tile = static_cast<int>(span - g->halo);
  g->smem = static_cast<long long>(kThreads) * g->wpt * 16 + (g->tile / 32) * 4;
  return g->tile % step == 0 && g->smem <= kSmemLimit;
}

// Clean rises in local samples [0, x]: P of x's word and the word's bits up
// to x.
__device__ __forceinline__ int rises_to(const unsigned* c, const int* p, int x) {
  return p[x >> 5] + __popc(c[x >> 5] & ((2u << (x & 31)) - 1u));
}

// pulses at local sample li (li >= H >= window, so li - window >= 0 and the
// word before li's exists).
__device__ __forceinline__ int pulses_at(const unsigned* c, const unsigned* r, const int* p,
                                         const int* l, int li, int window) {
  const int w = li >> 5;
  const unsigned here = r[w] & ((2u << (li & 31)) - 1u);
  int last;
  if (here) {
    last = (w << 5) + 31 - __clz(here);
  } else {
    const int lw = l[w - 1];
    last = lw >= 0 ? (lw << 5) + 31 - __clz(r[lw]) : -1;
  }
  const int lo = max(last, li - window);
  return rises_to(c, p, li) - rises_to(c, p, lo);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
gate_pulses_kernel(const int* __restrict__ flags, int n, int nt1, int npc, int step,
                   int window, int halo, int tile, int wpt, int q, int* __restrict__ cand,
                   int* __restrict__ pulses, int* __restrict__ counts) {
  extern __shared__ unsigned smem[];
  __shared__ int warp_sum[kWarps];
  __shared__ int warp_last[kWarps];
  const int nw = kThreads * wpt;
  unsigned* s_c = smem;                       // clean rises
  unsigned* s_r = s_c + nw;                   // resets
  int* s_p = reinterpret_cast<int*>(s_r + nw);
  int* s_l = s_p + nw;
  unsigned* s_k = reinterpret_cast<unsigned*>(s_l + nw);   // tile words only
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * tile;           // < n: the wrapper keeps n + span < 2^31
  const int base = t0 - halo;                 // local sample 0; may be negative
  const int halo_words = halo >> 5;

  // 1. masks.
  for (int grp = warp; grp < nw / 32; grp += kWarps) {
    const int g0 = base + grp * kGroup;
    int v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int i = g0 + k * 32 + lane;
      v[k] = i >= 0 && i < n ? __ldcs(flags + i) : 0;
    }
    unsigned wc = 0;
    unsigned wr = 0;
    unsigned wk = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      // Of rise, qualify and marker (t): a clean rise is t == 3, a reset
      // t in {1, 4, 5, 6, 7} (bits of 0xF2); a candidate has rise and quiet.
      const int t = v[k] & 7;
      const unsigned bc = __ballot_sync(kFull, t == 3);
      const unsigned br = __ballot_sync(kFull, (0xF2u >> t) & 1u);
      const unsigned bk = __ballot_sync(kFull, (v[k] & 9) == 9);
      if (lane == k) {
        wc = bc;
        wr = br;
        wk = bk;
      }
    }
    const int lw = grp * 32 + lane;
    s_c[lw] = wc;
    s_r[lw] = wr;
    if (lw >= halo_words) s_k[lw - halo_words] = wk;
  }
  __syncthreads();

  // 2. scans: thread t takes words [t * wpt, (t + 1) * wpt).
  const int w0 = threadIdx.x * wpt;
  int cnt = 0;
  int last = -1;
  for (int k = 0; k < wpt; ++k) {
    cnt += __popc(s_c[w0 + k]);
    if (s_r[w0 + k]) last = w0 + k;
  }
  int inc_cnt = cnt;
  int inc_last = last;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFull, inc_cnt, o);
    const int b = __shfl_up_sync(kFull, inc_last, o);
    if (lane >= o) {
      inc_cnt += a;
      inc_last = max(inc_last, b);
    }
  }
  int before_last = __shfl_up_sync(kFull, inc_last, 1);
  if (lane == 0) before_last = -1;
  if (lane == 31) {
    warp_sum[warp] = inc_cnt;
    warp_last[warp] = inc_last;
  }
  __syncthreads();
  int before = inc_cnt - cnt;
  for (int w = 0; w < warp; ++w) {
    before += warp_sum[w];
    before_last = max(before_last, warp_last[w]);
  }
  for (int k = 0; k < wpt; ++k) {
    const int lw = w0 + k;
    s_p[lw] = before;
    before += __popc(s_c[lw]);
    if (s_r[lw]) before_last = lw;
    s_l[lw] = before_last;
  }
  __syncthreads();

  // 3. triggers.
  const int lim = n - nt1 - 1;                // a trigger at i needs i < lim
  const int tile_words = tile >> 5;
  int n_trig = 0;
  for (int tw = threadIdx.x; tw < tile_words; tw += kThreads) {
    const int lw = tw + halo_words;
    const int gi0 = t0 + (tw << 5);
    unsigned k = s_k[tw];
    unsigned t = 0;
    while (k) {
      const int b = __ffs(k) - 1;
      k &= k - 1;
      if (gi0 + b < lim && pulses_at(s_c, s_r, s_p, s_l, (lw << 5) + b, window) > npc)
        t |= 1u << b;
    }
    s_k[tw] = t;
    n_trig += __popc(t);
    if (q >= gi0 && q - gi0 < 32)
      counts[1] = pulses_at(s_c, s_r, s_p, s_l, (lw << 5) + (q - gi0), window);
  }
  n_trig = __reduce_add_sync(kFull, n_trig);
  if (lane == 0) warp_sum[warp] = n_trig;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += warp_sum[w];
    if (sum) atomicAdd(counts, sum);
  }

  // 4. each block's first trigger.
  const int per_tile = tile / step;
  const int nb = n / step + (n % step != 0);
  const int b0 = t0 / step;
  for (int k = threadIdx.x; k < per_tile && b0 + k < nb; k += kThreads) {
    const int s0 = k * step;                  // the block's first tile sample
    int first = -1;
    if (step >= 32) {
      for (int w = s0 >> 5; w < (s0 + step) >> 5; ++w) {
        const unsigned t = s_k[w];
        if (t) {
          first = (w << 5) + __ffs(t) - 1;
          break;
        }
      }
    } else {
      const unsigned t = (s_k[s0 >> 5] >> (s0 & 31)) & ((1u << step) - 1u);
      if (t) first = s0 + __ffs(t) - 1;
    }
    int c = n;
    int p = 0;
    if (first >= 0) {
      c = t0 + first + nt1 + 1;
      p = pulses_at(s_c, s_r, s_p, s_l, halo + first, window);
    }
    cand[b0 + k] = c;
    pulses[b0 + k] = p;
  }
}

}  // namespace

// The tile of a launch: out = {halo, tile, words a thread, shared bytes}.
// Returns 0, or cudaErrorInvalidValue where the kernel cannot take the window
// and block (each a power of two, the block at most 512).
extern "C" int gate_pulses_geometry(int window, int step, long long* out) {
  Geometry g;
  if (!geometry(window, step, &g)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = g.halo;
  out[1] = g.tile;
  out[2] = g.wpt;
  out[3] = g.smem;
  return 0;
}

// flags: (n,) int32, contiguous.  Outputs allocated by the caller: cand and
// pulses (ceil(n / step),) int32, counts (2,) int32.  Zeroes counts[0] and
// launches one kernel on the stream; returns a cudaError_t (0 on success).
extern "C" int gate_pulses_launch(const int* flags, long long n, int nt1, int npc, int step,
                                  int window, int* cand, int* pulses, int* counts,
                                  void* stream) {
  Geometry g;
  if (n <= 0 || nt1 < 0 || !geometry(window, step, &g) ||
      n + nt1 + 2LL * (g.halo + g.tile) >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gate_pulses_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ni = static_cast<int>(n);
  const unsigned grid = static_cast<unsigned>((n + g.tile - 1) / g.tile);
  const int q = ni - nt1 - 2 > 0 ? ni - nt1 - 2 : 0;
  gate_pulses_kernel<<<grid, kThreads, static_cast<size_t>(g.smem), s>>>(
      flags, ni, nt1, npc, step, window, g.halo, g.tile, g.wpt, q, cand, pulses, counts);
  return static_cast<int>(cudaGetLastError());
}
