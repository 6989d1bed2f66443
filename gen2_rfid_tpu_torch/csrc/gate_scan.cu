// gate_scan: the reference gate's state machine, walked from edge to edge.
//
// Replaces no Pallas kernel: the JAX package runs this FSM as a lax.scan in
// gen2_rfid_tpu/dsp/gate.py::gate_detect_scan (step function :341-362), the
// exact sequential oracle behind exact_gate=True, cloned from
// gate_impl.cc:127-195.  Per sample i, with thresh = avg[i] * frac:
//
//   closed    = open_rem == 0
//   n_samp   += closed
//   to_neg    = closed & amp < thresh & state == POS
//   to_pos    = closed & amp > thresh & state == NEG
//   to_pos:     pulses = n_samp > pw_half ? pulses + 1 : 0
//   an edge:    n_samp = 0, state flips
//   trig      = closed & n_samp > nt1 & state == POS & pulses > npc
//   pulses_out[i] = pulses;  trig: pulses = 0, n_samp = 0,
//               open_rem = (next_epc ? epc_window : rn16_window) - 1,
//               next_epc flips;  else open_rem = max(open_rem - 1, 0)
//
// Outputs trig[i] (0/1) and pulses_out[i], the scan's two outputs.
//
// Why a walk from edge to edge gives the same outputs (nt1 >= 0, npc >= 0,
// windows >= 1; kernels/gate_scan.py::gate_scan_edges_plain is its model):
//
// 1. Edges happen only at decisive samples.  In NEG the next edge is the
//    next sample with amp > __fmul_rn(avg, frac); in POS the next with
//    amp < that product.  A tie is never an edge.
// 2. n_samp at a closed sample i is i - e, e the last edge.  The start is
//    an edge at -1 in NEG.  A trigger at t counts as an edge at t + W - 1
//    that leaves the state POS and pulses at 0; W is the window it opens
//    (rn16_window and epc_window alternate, RN16 first).
// 3. At a rise r, pulses becomes pulses + 1 if r - e_prev > pw_half, else
//    0.  Falls leave pulses alone.
// 4. If a rise at r leaves pulses > npc, the trigger fires at
//    t = r + nt1 + 1 when t <= n - 1 and the next fall comes after t.  The
//    walk resumes at t + W.  No other sample can trigger.
// 5. pulses_out is piecewise constant.  It changes at each rise (to the new
//    count) and at t + 1 for each trigger (to 0, through the open window);
//    at t itself it holds the count from before the reset.
//
// Bound on an H100: bytes.  At Ny = 1.94 M it moves 13 bytes a sample
// (amp and avg in, trig and pulses_out out), 25 MB, about 7.5 us at
// 3.35 TB/s.  The walk is serial, and each of its steps is a chain of
// dependent operations: a walk that found each edge with __ffs on mask
// words took about 130 ns a step on an H100 (PERF.md), so this one takes
// the edges 32 at a time.  The free-running state (the FSM's state
// if no window ever opened: a decisive sample sets it, a tie keeps it) has
// its edges at fixed places that do not depend on the walk, so the grid
// lists them first; between two windows the FSM's edges are exactly these.
//
// 1. masks (whole grid, a warp per 1024 samples): warp ballots pack the
//    decisions into two bit masks (hi: above, lo: below; neither on a
//    tie), one word per 32 samples.  Each lane then takes one word and
//    finds its free-running edges with bit operations: a five-step
//    doubling fill carries each decisive sample's state up to the next,
//    and an edge is a decisive sample whose state differs from the one
//    before it.  A word's incoming state is the last decisive sample's
//    before it, found with a ballot of the nonzero words and a shuffle.
//    Each group stores its first and last decisive state and its edge
//    count given its own first state.
// 2. offsets (one warp): the same ballot-and-shuffle over groups gives
//    each group's incoming state, and a prefix sum its first index in the
//    edge list.
// 3. edges (whole grid, a warp per group): the word edges again, with the
//    true incoming state, written in order at the group's offset.  The list
//    starts with a rise and alternates.
// 4. walk (one warp): 32 list edges (16 rises) a step, lane i holding edge
//    k + i, with the next 32 already loaded.  A rise qualifies when its gap
//    from the edge before exceeds pw_half; a ballot of the rises that do not
//    gives each rise's pulse count (the rises since the last reset, plus the
//    carried count when there is none); a ballot of the candidates
//    (pulses > npc, t = r + nt1 + 1 <= n - 1, the next edge after t) gives
//    the first trigger.  Lanes up to it write their change points
//    (position, pulses) in parallel; the trigger writes (t + 1, -1).  The
//    walk then resumes at the first list edge at or after t + W (W the
//    window it opens), found from the group offsets and one ballot, in state
//    POS: a fall there is the FSM's next edge; a rise there means that the
//    samples from t + W on are below or tied, so the FSM falls at the first
//    below sample, if one comes before the rise, and takes the rise, or
//    else ignores the rise and takes the fall after it.
// 5. fill (whole grid): a block per 4096 samples binary-searches the change
//    list for its first and last sample, each thread for its 16 samples,
//    and writes trig and pulses_out with 16-byte stores.
//
// At the bench shape the walk takes 3840 steps (batches of 32 list edges,
// and 1280 resumptions after triggers, each a few dependent loads from L2)
// and about 95% of the kernel's time, some 320 ns a step on an H100: a
// batch is a chain of dependent shuffles, ballots and bit counts in one
// warp (PERF.md).  The scratch (int32, from the wrapper) holds the masks, the group tables, the
// edge list (at most n) and the change points (at most n + 2: no more
// triggers than rises, no more rises than (n + 1) / 2).
//
// --fmad=false and __fmul_rn keep the threshold the plain version's float32
// product.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaskThreads = 256;          // 8 warps: 8 groups of 1024 samples
constexpr int kFillTile = 4096;
constexpr int kFillThreads = 256;
constexpr int kPerThread = kFillTile / kFillThreads;   // 16 samples a thread

// Scratch layout in 32-bit words.  Mask words are padded to whole groups of
// 1024 samples (the masks kernel writes the padding as 0).
struct Layout {
  long long ns, nw, hi, lo, gfirst, glast, gcount, goff, edges, cpos, cval, count, total;
};

__host__ __device__ inline long long up4(long long v) { return (v + 3) / 4 * 4; }

__host__ __device__ Layout layout(long long n) {
  Layout L;
  L.ns = (n + 1023) / 1024;
  L.nw = L.ns * 32;
  L.hi = 0;
  L.lo = L.nw;
  L.gfirst = 2 * L.nw;
  L.glast = L.gfirst + up4(L.ns);
  L.gcount = L.glast + up4(L.ns);
  L.goff = L.gcount + up4(L.ns);             // ns + 1 entries: the last is the count
  L.edges = L.goff + up4(L.ns + 1);
  L.cpos = L.edges + up4(n);
  L.cval = L.cpos + up4(n + 2);
  L.count = L.cval + up4(n + 2);
  L.total = L.count + 4;
  return L;
}

// Free-running edges of one word given the state coming in (pos: POS);
// *last_pos: the state after its last sample.
__device__ __forceinline__ unsigned word_edges(unsigned hi, unsigned lo, bool pos,
                                               bool* last_pos) {
  const unsigned d = hi | lo;
  const unsigned seed = pos ? 1u : 0u;
  unsigned state = hi;
  unsigned known = d;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned low = (1u << s) - 1;
    state |= ((state << s) | (seed * low)) & ~known;
    known |= (known << s) | low;
  }
  *last_pos = state >> 31;
  return d & (hi ^ ((state << 1) | seed));
}

// Lane k holds word k of a group (hi, lo); in: the group's incoming state.
// Returns the word's edge mask; the word's incoming state is the state
// after the nearest lower nonzero word, else the group's.
__device__ __forceinline__ unsigned group_word_edges(unsigned hi, unsigned lo, bool in,
                                                     int lane) {
  bool last_pos;
  word_edges(hi, lo, false, &last_pos);      // a nonzero word's last state
  const unsigned nz = __ballot_sync(kFull, (hi | lo) != 0);
  const unsigned lower = nz & ((1u << lane) - 1);
  const int src = lower ? 31 - __clz(lower) : lane;
  const bool from = __shfl_sync(kFull, static_cast<int>(last_pos), src);
  bool unused;
  return word_edges(hi, lo, lower ? from : in, &unused);
}

__global__ void __launch_bounds__(kMaskThreads)
masks_kernel(const float* __restrict__ amp, const float* __restrict__ avg,
             int n, float frac, long long ns, unsigned* __restrict__ hi,
             unsigned* __restrict__ lo, int* __restrict__ gfirst,
             int* __restrict__ glast, int* __restrict__ gcount) {
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * (kMaskThreads / 32) +
                      (threadIdx.x >> 5);
  if (g >= ns) return;                       // whole warps leave together
  unsigned my_hi = 0;
  unsigned my_lo = 0;
  const long long s0 = g * 1024;
#pragma unroll 8
  for (int k = 0; k < 32; ++k) {
    const long long i = s0 + k * 32 + lane;
    bool h = false;
    bool l = false;
    if (i < n) {
      const float a = amp[i];
      const float th = __fmul_rn(avg[i], frac);
      h = a > th;
      l = a < th;
    }
    const unsigned bh = __ballot_sync(kFull, h);
    const unsigned bl = __ballot_sync(kFull, l);
    if (lane == k) {
      my_hi = bh;
      my_lo = bl;
    }
  }
  hi[g * 32 + lane] = my_hi;
  lo[g * 32 + lane] = my_lo;
  // The group's first and last decisive states (+1 POS, -1 NEG, 0 none).
  const unsigned d = my_hi | my_lo;
  const unsigned nz = __ballot_sync(kFull, d != 0);
  bool last_pos;
  word_edges(my_hi, my_lo, false, &last_pos);
  const bool first_pos = d && ((my_hi >> (__ffs(d) - 1)) & 1u);
  const int f = __shfl_sync(kFull, static_cast<int>(first_pos), nz ? __ffs(nz) - 1 : 0);
  const int l = __shfl_sync(kFull, static_cast<int>(last_pos), nz ? 31 - __clz(nz) : 0);
  // Edges given the group's own first state: the first decisive sample is
  // then no edge, whatever comes in.
  int cnt = __popc(group_word_edges(my_hi, my_lo, f != 0, lane));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  if (lane == 0) {
    gfirst[g] = nz ? (f ? 1 : -1) : 0;
    glast[g] = nz ? (l ? 1 : -1) : 0;
    gcount[g] = cnt;
  }
}

// One warp: each group's incoming state (into gfirst's place as +1/-1, read
// back by edges_kernel) and first index in the edge list; goff[ns] = count.
__global__ void __launch_bounds__(32)
offsets_kernel(int ns, int* __restrict__ gfirst, const int* __restrict__ glast,
               const int* __restrict__ gcount, int* __restrict__ goff) {
  const int lane = threadIdx.x;
  int carry_in = -1;                         // the start is NEG
  int carry_off = 0;
  for (int g0 = 0; g0 < ns; g0 += 32) {
    const int g = g0 + lane;
    const bool valid = g < ns;
    const int first = valid ? gfirst[g] : 0;
    const int last = valid ? glast[g] : 0;
    const int c = valid ? gcount[g] : 0;
    const unsigned nz = __ballot_sync(kFull, last != 0);
    const unsigned lower = nz & ((1u << lane) - 1);
    const int from = __shfl_sync(kFull, last, lower ? 31 - __clz(lower) : lane);
    const int in = lower ? from : carry_in;
    const int cnt = c + (first != 0 && first != in);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (valid) {
      gfirst[g] = in;
      goff[g] = carry_off + incl - cnt;
    }
    carry_off += __shfl_sync(kFull, incl, 31);
    if (nz) carry_in = __shfl_sync(kFull, last, 31 - __clz(nz));
  }
  if (lane == 0) goff[ns] = carry_off;
}

__global__ void __launch_bounds__(kMaskThreads)
edges_kernel(const unsigned* __restrict__ hi, const unsigned* __restrict__ lo,
             long long ns, const int* __restrict__ ginc, const int* __restrict__ goff,
             int* __restrict__ edges) {
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * (kMaskThreads / 32) +
                      (threadIdx.x >> 5);
  if (g >= ns) return;
  unsigned e = group_word_edges(hi[g * 32 + lane], lo[g * 32 + lane], ginc[g] > 0, lane);
  const int cnt = __popc(e);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  int* out = edges + goff[g] + (incl - cnt);
  const int base = static_cast<int>(g * 1024) + lane * 32;
  for (; e; e &= e - 1) *out++ = base + __ffs(e) - 1;
}

__device__ __forceinline__ int edge_at(const int* __restrict__ edges, int m, int k) {
  return k < m ? edges[k] : INT_MAX;
}

// First below-threshold sample in [p, lim), else lim; warp-uniform.
__device__ int find_lo(const unsigned* __restrict__ lo, int nw, int p, int lim, int lane) {
  int w = p >> 5;
  const unsigned bits = lo[w] & (kFull << (p & 31));
  if (bits) return min(w * 32 + __ffs(bits) - 1, lim);
  for (++w; static_cast<long long>(w) * 32 < lim; w += 32) {
    const unsigned v = w + lane < nw ? lo[w + lane] : 0u;
    const unsigned any = __ballot_sync(kFull, v != 0);
    if (any) {
      const int l = __ffs(any) - 1;
      return min((w + l) * 32 + __ffs(__shfl_sync(kFull, v, l)) - 1, lim);
    }
  }
  return lim;
}

__global__ void __launch_bounds__(32)
walk_kernel(const int* __restrict__ edges, const int* __restrict__ goff,
            const unsigned* __restrict__ lo, int nw, int ns, int n, int pw_half,
            int nt1, int npc, int rn16_window, int epc_window,
            int* __restrict__ cpos, int* __restrict__ cval, int* __restrict__ count) {
  const int lane = threadIdx.x;
  const int m = goff[ns];
  const bool odd = lane & 1;
  int k = 0;                                 // the next list edge: a rise
  int e_prev = -1;                           // the FSM's last edge (rule 2)
  int pulses = 0;
  bool next_epc = false;
  int nch = 0;
  int cur = edge_at(edges, m, lane);
  int nxt = edge_at(edges, m, 32 + lane);
  while (k < m) {
    const int v = cur;
    const int up = __shfl_up_sync(kFull, v, 1);
    const int dn = __shfl_down_sync(kFull, v, 1);
    const int first_next = __shfl_sync(kFull, nxt, 0);
    const int prev = lane == 0 ? e_prev : up;
    const int next = lane == 31 ? first_next : dn;
    const bool rise = !odd && k + lane < m;
    const bool qual = rise && static_cast<long long>(v) - prev > pw_half;
    const unsigned rises = __ballot_sync(kFull, rise);
    const unsigned resets = __ballot_sync(kFull, rise && !qual);
    const unsigned upto = (2u << lane) - 1;              // lanes <= this one
    const unsigned r_here = resets & upto;
    const int p = r_here ? __popc(rises & upto & ~((2u << (31 - __clz(r_here))) - 1))
                         : pulses + __popc(rises & upto);
    const bool cand = rise && p > npc && v <= n - 2 - nt1 && next > v + nt1 + 1;
    const unsigned cands = __ballot_sync(kFull, cand);
    const int i = cands ? __ffs(cands) - 1 : 31;
    const unsigned commit = rises & ((2u << i) - 1);
    if ((commit >> lane) & 1u) {
      const int at = nch + __popc(commit & ((1u << lane) - 1));
      cpos[at] = v;
      cval[at] = p;
    }
    nch += __popc(commit);
    if (!cands) {
      pulses = __shfl_sync(kFull, p, 31 - __clz(rises));
      e_prev = __shfl_sync(kFull, v, 31);    // a fall, or past the end
      k += 32;
      cur = nxt;
      nxt = edge_at(edges, m, k + 32 + lane);
      continue;
    }
    const int t = __shfl_sync(kFull, v, i) + nt1 + 1;
    if (lane == 0) {
      cpos[nch] = t + 1;
      cval[nch] = -1;
    }
    ++nch;
    const int resume = t + (next_epc ? epc_window : rn16_window);
    next_epc = !next_epc;
    pulses = 0;
    if (resume >= n) break;
    int kp = max(k + i + 1, goff[resume >> 10]);
    for (;; kp += 32) {
      const unsigned at = __ballot_sync(kFull, edge_at(edges, m, kp + lane) >= resume);
      if (at) {
        kp += __ffs(at) - 1;
        break;
      }
    }
    if (kp >= m) break;
    const int ek = edges[kp];
    if (kp & 1) {                            // a fall: the FSM's next edge
      e_prev = ek;
      k = kp + 1;
    } else {
      const int f = find_lo(lo, nw, resume, ek, lane);
      if (f < ek) {                          // falls first, then the rise
        e_prev = f;
        k = kp;
      } else {                               // ignores the rise
        if (kp + 1 >= m) break;
        e_prev = edges[kp + 1];
        k = kp + 2;
      }
    }
    cur = edge_at(edges, m, k + lane);
    nxt = edge_at(edges, m, k + 32 + lane);
  }
  if (lane == 0) *count = nch;
}

// Largest c in [lo, hi) with cpos[c] <= x, else lo - 1.
__device__ __forceinline__ int last_le(const int* cpos, int lo, int hi, long long x) {
  int a = lo;
  int b = hi;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (cpos[mid] <= x) a = mid + 1; else b = mid;
  }
  return a - 1;
}

__global__ void __launch_bounds__(kFillThreads)
fill_kernel(const int* __restrict__ cpos, const int* __restrict__ cval,
            const int* __restrict__ count, int n, unsigned char* __restrict__ trig,
            int* __restrict__ pulses_out) {
  __shared__ int range[2];
  const int nch = *count;
  const int s0 = blockIdx.x * kFillTile;
  if (threadIdx.x == 0) {
    range[0] = last_le(cpos, 0, nch, s0);
    range[1] = last_le(cpos, 0, nch, static_cast<long long>(s0) + kFillTile - 1);
  }
  __syncthreads();
  const int a = s0 + threadIdx.x * kPerThread;
  if (a >= n) return;
  const int lo = max(range[0], 0);
  int c = last_le(cpos, lo, range[1] + 1, a);   // >= range[0]: cpos[range[0]] <= s0 <= a
  int next = c + 1 < nch ? cpos[c + 1] : INT_MAX;
  int cur = c >= 0 ? max(cval[c], 0) : 0;
  int po[kPerThread];
  unsigned char tr[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = a + k;
    while (next <= i) {
      ++c;
      cur = max(cval[c], 0);
      next = c + 1 < nch ? cpos[c + 1] : INT_MAX;
    }
    po[k] = cur;
    tr[k] = next == i + 1 && cval[c + 1] < 0;
  }
  if (a + kPerThread <= n) {
    int4* dp = reinterpret_cast<int4*>(pulses_out + a);
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q)
      dp[q] = make_int4(po[4 * q], po[4 * q + 1], po[4 * q + 2], po[4 * q + 3]);
    uint4 t;
    unsigned* tw = &t.x;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tw[q] = tr[4 * q] | (tr[4 * q + 1] << 8) | (tr[4 * q + 2] << 16) |
              (static_cast<unsigned>(tr[4 * q + 3]) << 24);
    *reinterpret_cast<uint4*>(trig + a) = t;
  } else {
    for (int k = 0; k < kPerThread && a + k < n; ++k) {
      pulses_out[a + k] = po[k];
      trig[a + k] = tr[k];
    }
  }
}

}  // namespace

// int32 words of scratch gate_scan_launch needs for n samples.
extern "C" long long gate_scan_scratch_words(long long n) { return layout(n).total; }

// amp, avg: (n,) float32, contiguous.  Outputs: trig (n,) uint8 and
// pulses_out (n,) int32, both 16-byte aligned.  scratch: at least
// gate_scan_scratch_words(n) int32 words, contents ignored.  Launches five
// kernels on the stream; returns a cudaError_t (0 on success).
extern "C" int gate_scan_launch(const float* amp, const float* avg, long long n,
                                float frac, int pw_half, int nt1, int npc,
                                int rn16_window, int epc_window,
                                unsigned char* trig, int* pulses_out, int* scratch,
                                void* stream) {
  if (n <= 0) return 0;
  if (rn16_window < 1 || epc_window < 1 || nt1 < 0 || npc < 0 ||
      n + static_cast<long long>(nt1) + rn16_window + epc_window + 2048 >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L = layout(n);
  unsigned* words = reinterpret_cast<unsigned*>(scratch);
  const int ni = static_cast<int>(n);
  const unsigned group_blocks =
      static_cast<unsigned>((L.ns + kMaskThreads / 32 - 1) / (kMaskThreads / 32));
  masks_kernel<<<group_blocks, kMaskThreads, 0, s>>>(
      amp, avg, ni, frac, L.ns, words + L.hi, words + L.lo, scratch + L.gfirst,
      scratch + L.glast, scratch + L.gcount);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  offsets_kernel<<<1, 32, 0, s>>>(static_cast<int>(L.ns), scratch + L.gfirst,
                                  scratch + L.glast, scratch + L.gcount, scratch + L.goff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  edges_kernel<<<group_blocks, kMaskThreads, 0, s>>>(
      words + L.hi, words + L.lo, L.ns, scratch + L.gfirst, scratch + L.goff,
      scratch + L.edges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_kernel<<<1, 32, 0, s>>>(scratch + L.edges, scratch + L.goff, words + L.lo,
                               static_cast<int>(L.nw), static_cast<int>(L.ns), ni,
                               pw_half, nt1, npc, rn16_window, epc_window,
                               scratch + L.cpos, scratch + L.cval, scratch + L.count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned fill_blocks = static_cast<unsigned>((n + kFillTile - 1) / kFillTile);
  fill_kernel<<<fill_blocks, kFillThreads, 0, s>>>(scratch + L.cpos, scratch + L.cval,
                                                  scratch + L.count, ni, trig, pulses_out);
  return static_cast<int>(cudaGetLastError());
}
