// compat_gate: compat mode's gate triggers as three device-wide scans.
//
// Replaces no Pallas kernel: the JAX package runs compat's gate as full-array
// scans in gen2_rfid_tpu/dsp/gate.py::gate_detect (lax.cummax / lax.cummin at
// :92, :208, :245, :256), which XLA lowers to parallel associative scans.
// PyTorch's cummax / cummin give one row to one thread block, so on an H100
// the plain version's scans took some 5 ms each at the bench length (PERF.md);
// this kernel computes the same function in a handful of passes.  Per sample
// i < n, with thresh = __fmul_rn(avg[i], frac):
//
//   dec[i]   = +1 above, -1 below, 0 on a tie (or NaN)
//   state[i] = the last nonzero dec at or before i, else -1 (NEG)
//   prev[i]  = state[i-1], prev[0] = -1;  rise: state POS, prev NEG;
//              edge: state != prev
//   run_at   = i - (the last edge before i, else -1);  disq = rise & run_at <= pw_half
//   rc[i]    = the rises at or before i
//   quiet[i] = (the first edge after i, else n) > i + nt1 + 1
//   cand[i]  = rise & quiet & i + nt1 + 1 < n
//   reset0   = disq ? rc : 0;  M0 = its running maximum
//   trig0    = cand & rc - M0 > npc
//   reset2[i] = max(reset0[i], trig0[i-1] ? rc[i-1] : 0);  M2 = its running maximum
//   trig     = cand & rc - M2 > npc;  pulses_at = rc - M2
//
// (the two passes of the reference's fixed point, gate.py:238-256).
//
// Bound on an H100: bytes.  8 bytes a sample in (amp, avg), 5 out (trig,
// pulses_at): at Ny = 1.94 M, 25 MB, 7.5 us at 3.35 TB/s.
//
// Design: tiles of kTile = 4096 samples, a block of 512 threads each, a
// thread 8 consecutive samples.  Inside a tile every scan is a thread's own
// loop over its 8 samples, a warp scan of the threads' aggregates with
// shuffles and a scan of the warps' through shared memory (block_scan).
// Across tiles every running quantity is a carry, found by a scan of the
// tiles' aggregates in one block of 1024 threads:
//
// 1. aggregate (a block a tile): the tile's summary whatever state comes in.
//    An internal edge is a decisive sample whose sign differs from the
//    tile's decisive sample before it.  The tile's first decisive sample f
//    is an edge only if its sign differs from the incoming state, and at
//    most one rise of a tile can have its previous edge outside the tile:
//    f when it rises, or, when f falls, the first internal edge e1 (its
//    previous edge f when f is an edge, else outside).  So the tile stores
//    f and its sign, its last decisive sign, its internal rises, its first
//    and last internal edge, and the internal rise count at its last short
//    rise among the internal rises with an internal edge before them (a).
// 2. carry (one block): the incoming state (the last nonzero last-sign
//    before, else -1), then each tile's rises, last and first edge under
//    that state; the rise count (a sum) and last edge (a maximum) coming
//    in; then whether f or e1 is short against the incoming last edge, the
//    tile's largest reset0 and reset0's running maximum coming in; and,
//    from the end, the first edge after each tile (a minimum).
// 3. apply (a block a tile): the state, the edges, the short rises, rc,
//    reset0's running maximum, the next edge (a scan from the last thread
//    down) and trig0, from the carries.  It writes rc and a flag byte a
//    sample (cand, disq, trig0), and the tile's last trig0 count.
// 4. a one-block scan of those counts: reset2's running maximum coming into
//    each tile is the larger of reset0's and the last trig0 count before the
//    tile (whose shift lands at or after the tile's first sample).
// 5. finish (a block a tile): reset2, its running maximum, trig, pulses_at.
//
// A capture of one tile (the live windows) runs 3 and 5 in one launch with
// the carries at their start values.  The scratch (int32, from the wrapper)
// holds 8 words a tile of aggregates and 8 of carries, rc and the flags.
// kernels/compat_gate.py::compat_gate_tiles_plain models these passes.
//
// --fmad=false and __fmul_rn keep the threshold the plain version's float32
// product.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;

// Flag bits a sample, written by apply and read by finish.
constexpr unsigned kCand = 1, kDisq = 2, kTrig0 = 4;

// Aggregates of a tile (pass 1), 8 words.
enum { kFPos, kFSign, kLastSign, kNInt, kE1, kLastInt, kA, kAggWords = 8 };
// Carries into a tile (passes 2 and 4), 8 words.
enum { kSIn, kCountIn, kLIn, kM0In, kNextAfter, kM2In, kLastTrig0, kCarWords = 8 };

struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct Min {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
// a before b in sample order.
struct LastNz {
  __device__ int operator()(int a, int b) const { return b != 0 ? b : a; }
};
struct FirstNz {
  __device__ int operator()(int a, int b) const { return a != 0 ? a : b; }
};

// Exclusive scan of one int a thread over the block's threads in sample
// order (Reverse: from the last thread down, for a commutative op), ident
// for the first.  *total gets the whole block's.  Every thread calls it;
// smem holds 33 ints and is free again when it returns to a next call.
template <int Threads, bool Reverse, typename Op>
__device__ __forceinline__ int block_scan(int v, int ident, Op op, int* smem, int* total) {
  constexpr int kWarpsN = Threads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = Reverse ? __shfl_down_sync(kFull, x, d) : __shfl_up_sync(kFull, x, d);
    if (Reverse ? lane + d < 32 : lane >= d) x = Reverse ? op(x, y) : op(y, x);
  }
  int excl = Reverse ? __shfl_down_sync(kFull, x, 1) : __shfl_up_sync(kFull, x, 1);
  if (lane == (Reverse ? 31 : 0)) excl = ident;
  __syncthreads();                        // the previous call's reads are done
  if (lane == (Reverse ? 0 : 31)) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarpsN ? smem[lane] : ident;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = Reverse ? __shfl_down_sync(kFull, s, d) : __shfl_up_sync(kFull, s, d);
      if (Reverse ? lane + d < 32 : lane >= d) s = Reverse ? op(s, y) : op(y, s);
    }
    int we = Reverse ? __shfl_down_sync(kFull, s, 1) : __shfl_up_sync(kFull, s, 1);
    if (lane == (Reverse ? 31 : 0)) we = ident;
    const int tot = __shfl_sync(kFull, s, Reverse ? 0 : 31);
    if (lane < kWarpsN) smem[lane] = we;
    if (lane == 0) smem[32] = tot;
  }
  __syncthreads();
  *total = smem[32];
  return op(smem[warp], excl);
}

template <typename Op>
__device__ __forceinline__ int tile_scan(int v, int ident, Op op, int* smem, int* total) {
  return block_scan<kThreads, false>(v, ident, op, smem, total);
}

template <typename Op>
__device__ __forceinline__ int tile_reduce(int v, int ident, Op op, int* smem) {
  int total;
  block_scan<kThreads, false>(v, ident, op, smem, &total);
  return total;
}

// The decisions of a thread's 8 samples from base; 0 past n.
__device__ __forceinline__ void load_dec(const float* __restrict__ amp,
                                         const float* __restrict__ avg, int n, float frac,
                                         int base, bool vec, int* dec) {
  float a[kItems], v[kItems];
  if (vec && base + kItems <= n) {
    const float4* a4 = reinterpret_cast<const float4*>(amp + base);
    const float4* v4 = reinterpret_cast<const float4*>(avg + base);
    const float4 a0 = __ldg(a4), a1 = __ldg(a4 + 1), v0 = __ldg(v4), v1 = __ldg(v4 + 1);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    v[0] = v0.x; v[1] = v0.y; v[2] = v0.z; v[3] = v0.w;
    v[4] = v1.x; v[5] = v1.y; v[6] = v1.z; v[7] = v1.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = base + j < n;
      a[j] = in ? __ldg(amp + base + j) : 0.0f;
      v[j] = in ? __ldg(avg + base + j) : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const float t = __fmul_rn(v[j], frac);
    dec[j] = base + j < n ? (a[j] > t) - (a[j] < t) : 0;
  }
}

// ---- pass 1: the tiles' aggregates ------------------------------------------

__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const float* __restrict__ amp, const float* __restrict__ avg, int n,
                 float frac, int pw_half, bool vec, int* __restrict__ agg) {
  __shared__ int smem[33];
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int dec[kItems];
  load_dec(amp, avg, n, frac, base, vec, dec);
  int my_last = 0, my_first = 0, my_fpos = INT_MAX;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (dec[j] != 0) {
      my_last = dec[j];
      if (my_fpos == INT_MAX) {
        my_fpos = base + j;
        my_first = dec[j];
      }
    }
  }
  int last_sign;
  int p = tile_scan(my_last, 0, LastNz(), smem, &last_sign);
  // Internal edges: decisive samples whose sign differs from the tile's
  // decisive sample before them.
  unsigned ie = 0;
  int my_rises = 0, my_e1 = INT_MAX, my_le = -1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (dec[j] != 0) {
      if (p != 0 && dec[j] != p) {
        ie |= 1u << j;
        my_rises += dec[j] > 0;
        if (my_e1 == INT_MAX) my_e1 = base + j;
        my_le = base + j;
      }
      p = dec[j];
    }
  }
  int last_int, n_int;
  int lie = tile_scan(my_le, -1, Max(), smem, &last_int);
  int c = tile_scan(my_rises, 0, Sum(), smem, &n_int);
  int my_a = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (ie >> j & 1u) {
      const int gi = base + j;
      if (dec[j] > 0) {
        ++c;
        if (lie >= 0 && gi - lie <= pw_half) my_a = c;
      }
      lie = gi;
    }
  }
  const int a = tile_reduce(my_a, 0, Max(), smem);
  const int e1 = tile_reduce(my_e1, INT_MAX, Min(), smem);
  const int f_pos = tile_reduce(my_fpos, INT_MAX, Min(), smem);
  const int f_sign = tile_reduce(my_first, 0, FirstNz(), smem);
  if (threadIdx.x == 0) {
    int* g = agg + static_cast<long long>(blockIdx.x) * kAggWords;
    g[kFPos] = f_pos == INT_MAX ? -1 : f_pos;
    g[kFSign] = f_sign;
    g[kLastSign] = last_sign;
    g[kNInt] = n_int;
    g[kE1] = e1 == INT_MAX ? -1 : e1;
    g[kLastInt] = last_int;
    g[kA] = a;
  }
}

// ---- pass 2: the carries into each tile, one block ------------------------

__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(const int* __restrict__ agg, int ntiles, int n, int pw_half, int* __restrict__ car) {
  __shared__ int smem[33];
  int s_c = 0, count_c = 0, l_c = -1, m0_c = 0, tot;
  for (int t0 = 0; t0 < ntiles; t0 += kCarryThreads) {
    const int t = t0 + threadIdx.x;
    const bool in = t < ntiles;
    const int* g = agg + static_cast<long long>(in ? t : 0) * kAggWords;
    const int f_pos = in ? g[kFPos] : -1, f_sign = in ? g[kFSign] : 0;
    const int last_sign = in ? g[kLastSign] : 0, n_int = in ? g[kNInt] : 0;
    const int e1 = in ? g[kE1] : -1, last_int = in ? g[kLastInt] : -1, a = in ? g[kA] : 0;

    int s_in = block_scan<kCarryThreads, false>(last_sign, 0, LastNz(), smem, &tot);
    if (s_in == 0) s_in = s_c != 0 ? s_c : -1;
    if (tot != 0) s_c = tot;
    const bool f_edge = f_sign != 0 && f_sign != s_in;
    const bool f_rise = f_edge && f_sign > 0;
    const int rises = n_int + (f_rise ? 1 : 0);
    const int last_edge = last_int >= 0 ? last_int : (f_edge ? f_pos : -1);
    const int first_edge = f_edge ? f_pos : e1;

    const int count_in = count_c + block_scan<kCarryThreads, false>(rises, 0, Sum(), smem, &tot);
    count_c += tot;
    const int l_ex = block_scan<kCarryThreads, false>(last_edge, -1, Max(), smem, &tot);
    const int l_in = l_ex > l_c ? l_ex : l_c;
    if (tot > l_c) l_c = tot;
    // The rise whose previous edge may lie outside the tile: f when it rises
    // (count 1, the internal rises then count from 2), else e1 when f falls
    // (its previous edge f if f is an edge, else the incoming last edge).
    int local;
    if (f_rise) {
      local = a > 0 ? a + 1 : (f_pos - l_in <= pw_half ? 1 : 0);
    } else if (f_sign < 0) {
      const int e1_prev = s_in < 0 ? l_in : f_pos;
      local = a > 0 ? a : (e1 >= 0 && e1 - e1_prev <= pw_half ? 1 : 0);
    } else {
      local = a;
    }
    const int m0 = local > 0 ? count_in + local : 0;
    const int m_ex = block_scan<kCarryThreads, false>(m0, 0, Max(), smem, &tot);
    const int m0_in = m_ex > m0_c ? m_ex : m0_c;
    if (tot > m0_c) m0_c = tot;
    if (in) {
      int* c = car + static_cast<long long>(t) * kCarWords;
      c[kSIn] = s_in;
      c[kCountIn] = count_in;
      c[kLIn] = l_in;
      c[kM0In] = m0_in;
      c[kNextAfter] = first_edge;          // replaced below
    }
  }
  // From the end: the first edge after each tile, else n.  Each thread reads
  // back only what it wrote above.
  int nx_c = n;
  for (int t0 = (ntiles - 1) / kCarryThreads * kCarryThreads; t0 >= 0; t0 -= kCarryThreads) {
    const int t = t0 + threadIdx.x;
    const bool in = t < ntiles;
    int* c = car + static_cast<long long>(in ? t : 0) * kCarWords;
    const int fe = in ? c[kNextAfter] : -1;
    const int ex = block_scan<kCarryThreads, true>(fe >= 0 ? fe : INT_MAX, INT_MAX, Min(), smem,
                                                   &tot);
    if (in) c[kNextAfter] = ex < nx_c ? ex : nx_c;
    if (tot < nx_c) nx_c = tot;
  }
}

// ---- pass 3: apply the carries; trig0 ---------------------------------------

// A tile from its carries (c null: the capture's start): each sample's rc and
// flag byte in registers; returns the tile's last trig0 count.
__device__ __forceinline__ int apply_tile(const float* __restrict__ amp,
                                          const float* __restrict__ avg, int n, float frac,
                                          int pw_half, int nt1, int npc, bool vec,
                                          const int* __restrict__ c, int* smem,
                                          unsigned* fl, int* rc) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  const int s_in = c ? c[kSIn] : -1, count_in = c ? c[kCountIn] : 0;
  const int l_in = c ? c[kLIn] : -1, m0_in = c ? c[kM0In] : 0;
  const int next_after = c ? c[kNextAfter] : n;
  int dec[kItems];
  load_dec(amp, avg, n, frac, base, vec, dec);
  int my_last = 0, tot;
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (dec[j] != 0) my_last = dec[j];
  const int p = tile_scan(my_last, 0, LastNz(), smem, &tot);
  int st = p != 0 ? p : s_in;
  unsigned rise = 0, edge = 0;
  int my_rises = 0, my_first = INT_MAX, my_le = -1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int prev = st;
    if (dec[j] != 0) st = dec[j];
    if (st != prev) {
      edge |= 1u << j;
      if (st > 0) {
        rise |= 1u << j;
        ++my_rises;
      }
      if (my_first == INT_MAX) my_first = base + j;
      my_le = base + j;
    }
  }
  int pe = tile_scan(my_le, -1, Max(), smem, &tot);
  if (l_in > pe) pe = l_in;
  int cnt = count_in + tile_scan(my_rises, 0, Sum(), smem, &tot);
  unsigned disq = 0;
  int my_reset = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int gi = base + j;
    if (rise >> j & 1u) {
      ++cnt;
      if (gi - pe <= pw_half) {
        disq |= 1u << j;
        my_reset = cnt;
      }
    }
    rc[j] = cnt;
    if (edge >> j & 1u) pe = gi;
  }
  int m = tile_scan(my_reset, 0, Max(), smem, &tot);
  if (m0_in > m) m = m0_in;
  int nx = block_scan<kThreads, true>(my_first, INT_MAX, Min(), smem, &tot);
  if (next_after < nx) nx = next_after;
  unsigned quiet = 0;
#pragma unroll
  for (int j = kItems - 1; j >= 0; --j) {
    const long long gi = base + j;
    if (nx > gi + nt1 + 1) quiet |= 1u << j;
    if (edge >> j & 1u) nx = base + j;
  }
  int my_t = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long gi = base + j;
    if ((disq >> j & 1u) && rc[j] > m) m = rc[j];
    const bool cand = (rise >> j & 1u) && (quiet >> j & 1u) && gi + nt1 + 1 < n;
    const bool t0 = cand && rc[j] - m > npc;
    fl[j] = (cand ? kCand : 0u) | ((disq >> j & 1u) ? kDisq : 0u) | (t0 ? kTrig0 : 0u);
    if (t0) my_t = rc[j];
  }
  return tile_reduce(my_t, 0, Max(), smem);
}

// ---- pass 5: reset2's running maximum; trig and pulses_at ------------------

__device__ __forceinline__ void finish_tile(const unsigned* fl, const int* rc, int m2_in,
                                            int n, int npc, bool vec, int* smem, int* tails,
                                            uint8_t* __restrict__ trig,
                                            int* __restrict__ pulses) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  // The previous thread's last sample's trig0 count: reset2's shift into
  // this thread's first sample (the tile's first has it in m2_in).
  tails[threadIdx.x] = (fl[kItems - 1] & kTrig0) ? rc[kItems - 1] : 0;
  __syncthreads();
  int shift = threadIdx.x > 0 ? tails[threadIdx.x - 1] : 0;
  int r2[kItems], my_max = 0, tot;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    int r = (fl[j] & kDisq) ? rc[j] : 0;
    if (shift > r) r = shift;
    r2[j] = r;
    if (r > my_max) my_max = r;
    shift = (fl[j] & kTrig0) ? rc[j] : 0;
  }
  int m = tile_scan(my_max, 0, Max(), smem, &tot);
  if (m2_in > m) m = m2_in;
  uint8_t t[kItems];
  int p[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (r2[j] > m) m = r2[j];
    t[j] = (fl[j] & kCand) && rc[j] - m > npc;
    p[j] = rc[j] - m;
  }
  if (vec && base + kItems <= n) {
    uint2 tw;
    tw.x = t[0] | t[1] << 8 | t[2] << 16 | static_cast<unsigned>(t[3]) << 24;
    tw.y = t[4] | t[5] << 8 | t[6] << 16 | static_cast<unsigned>(t[7]) << 24;
    *reinterpret_cast<uint2*>(trig + base) = tw;
    int4* p4 = reinterpret_cast<int4*>(pulses + base);
    p4[0] = make_int4(p[0], p[1], p[2], p[3]);
    p4[1] = make_int4(p[4], p[5], p[6], p[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (base + j < n) {
        trig[base + j] = t[j];
        pulses[base + j] = p[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ amp, const float* __restrict__ avg, int n, float frac,
             int pw_half, int nt1, int npc, bool vec, int* __restrict__ car,
             uint8_t* __restrict__ flags, int* __restrict__ rcs) {
  __shared__ int smem[33];
  int* c = car + static_cast<long long>(blockIdx.x) * kCarWords;
  unsigned fl[kItems];
  int rc[kItems];
  const int last = apply_tile(amp, avg, n, frac, pw_half, nt1, npc, vec, c, smem, fl, rc);
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  if (vec && base + kItems <= n) {
    uint2 fw;
    fw.x = fl[0] | fl[1] << 8 | fl[2] << 16 | fl[3] << 24;
    fw.y = fl[4] | fl[5] << 8 | fl[6] << 16 | fl[7] << 24;
    *reinterpret_cast<uint2*>(flags + base) = fw;
    int4* r4 = reinterpret_cast<int4*>(rcs + base);
    r4[0] = make_int4(rc[0], rc[1], rc[2], rc[3]);
    r4[1] = make_int4(rc[4], rc[5], rc[6], rc[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (base + j < n) {
        flags[base + j] = static_cast<uint8_t>(fl[j]);
        rcs[base + j] = rc[j];
      }
    }
  }
  if (threadIdx.x == 0) c[kLastTrig0] = last;
}

// ---- pass 4: reset2's running maximum coming into each tile, one block -----

__global__ void __launch_bounds__(kCarryThreads)
shift_carry_kernel(int ntiles, int* __restrict__ car) {
  __shared__ int smem[33];
  int m_c = 0, tot;
  for (int t0 = 0; t0 < ntiles; t0 += kCarryThreads) {
    const int t = t0 + threadIdx.x;
    const bool in = t < ntiles;
    int* c = car + static_cast<long long>(in ? t : 0) * kCarWords;
    const int ex = block_scan<kCarryThreads, false>(in ? c[kLastTrig0] : 0, 0, Max(), smem, &tot);
    int m = ex > m_c ? ex : m_c;
    if (in) {
      if (c[kM0In] > m) m = c[kM0In];
      c[kM2In] = m;
    }
    if (tot > m_c) m_c = tot;
  }
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const uint8_t* __restrict__ flags, const int* __restrict__ rcs, int n, int npc,
              bool vec, const int* __restrict__ car, uint8_t* __restrict__ trig,
              int* __restrict__ pulses) {
  __shared__ int smem[33];
  __shared__ int tails[kThreads];
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  unsigned fl[kItems];
  int rc[kItems];
  if (vec && base + kItems <= n) {
    const uint2 fw = *reinterpret_cast<const uint2*>(flags + base);
    const int4* r4 = reinterpret_cast<const int4*>(rcs + base);
    const int4 r0 = r4[0], r1 = r4[1];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fl[j] = fw.x >> (8 * j) & 0xffu;
      fl[4 + j] = fw.y >> (8 * j) & 0xffu;
    }
    rc[0] = r0.x; rc[1] = r0.y; rc[2] = r0.z; rc[3] = r0.w;
    rc[4] = r1.x; rc[5] = r1.y; rc[6] = r1.z; rc[7] = r1.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = base + j < n;
      fl[j] = in ? flags[base + j] : 0u;
      rc[j] = in ? rcs[base + j] : 0;
    }
  }
  const int m2_in = car[static_cast<long long>(blockIdx.x) * kCarWords + kM2In];
  finish_tile(fl, rc, m2_in, n, npc, vec, smem, tails, trig, pulses);
}

// One tile: apply and finish in one block, from the capture's start.
__global__ void __launch_bounds__(kThreads)
single_tile_kernel(const float* __restrict__ amp, const float* __restrict__ avg, int n,
                   float frac, int pw_half, int nt1, int npc, bool vec,
                   uint8_t* __restrict__ trig, int* __restrict__ pulses) {
  __shared__ int smem[33];
  __shared__ int tails[kThreads];
  unsigned fl[kItems];
  int rc[kItems];
  apply_tile(amp, avg, n, frac, pw_half, nt1, npc, vec, nullptr, smem, fl, rc);
  finish_tile(fl, rc, 0, n, npc, vec, smem, tails, trig, pulses);
}

struct Layout {
  long long agg, car, rc, flags, total;
};

Layout layout(long long n) {
  const long long ntiles = (n + kTile - 1) / kTile;
  Layout L;
  L.agg = 0;
  L.car = L.agg + ntiles * kAggWords;
  L.rc = L.car + ntiles * kCarWords;
  L.flags = L.rc + (n + 3) / 4 * 4;
  L.total = L.flags + (n + 15) / 16 * 4;
  return L;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

int compat_gate_tile() { return kTile; }

long long compat_gate_scratch_words(long long n) { return layout(n).total; }

// amp, avg: (n,) float32; trig: (n,) bytes 0/1; pulses: (n,) int32; scratch:
// compat_gate_scratch_words(n) int32 words (16-byte aligned).  n < 2^31 -
// nt1 - kTile - 2.  Returns the CUDA error of the launches (0: none).
int compat_gate_launch(const float* amp, const float* avg, long long n, float frac,
                       int pw_half, int nt1, int npc, uint8_t* trig, int* pulses,
                       int* scratch, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int ni = static_cast<int>(n);
  const int ntiles = static_cast<int>((n + kTile - 1) / kTile);
  const bool vec_in = aligned16(amp) && aligned16(avg);
  const bool vec_out = aligned16(trig) && aligned16(pulses);
  if (ntiles == 1) {
    single_tile_kernel<<<1, kThreads, 0, stream>>>(amp, avg, ni, frac, pw_half, nt1, npc,
                                                  vec_in && vec_out, trig, pulses);
    return static_cast<int>(cudaGetLastError());
  }
  const Layout L = layout(n);
  int* agg = scratch + L.agg;
  int* car = scratch + L.car;
  int* rcs = scratch + L.rc;
  uint8_t* flags = reinterpret_cast<uint8_t*>(scratch + L.flags);
  const bool vec_mid = aligned16(rcs) && aligned16(flags);
  aggregate_kernel<<<ntiles, kThreads, 0, stream>>>(amp, avg, ni, frac, pw_half, vec_in, agg);
  carry_kernel<<<1, kCarryThreads, 0, stream>>>(agg, ntiles, ni, pw_half, car);
  apply_kernel<<<ntiles, kThreads, 0, stream>>>(amp, avg, ni, frac, pw_half, nt1, npc,
                                                vec_in && vec_mid, car, flags, rcs);
  shift_carry_kernel<<<1, kCarryThreads, 0, stream>>>(ntiles, car);
  finish_kernel<<<ntiles, kThreads, 0, stream>>>(flags, rcs, ni, npc, vec_mid && vec_out, car,
                                                 trig, pulses);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
