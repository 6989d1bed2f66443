// compat_gate: compat mode's gate triggers in one launch, a single-pass scan
// with decoupled look-back.
//
// Replaces no Pallas kernel: the JAX package runs compat's gate as full-array
// scans in gen2_rfid_tpu/dsp/gate.py::gate_detect (lax.cummax / lax.cummin at
// :92, :208, :245, :256), which XLA lowers to parallel associative scans.
// PyTorch's cummax / cummin give one row to one thread block, so on an H100
// the plain version's scans took some 5 ms each at the bench length (PERF.md).
// Per sample i < n, with thresh = __fmul_rn(avg[i], frac):
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
// pulses_at): at the bench Ny = 1.94 M, 25 MB, 7.5 us at 3.35 TB/s.
//
// Design.  Route (a) of the two known: a single-pass scan with decoupled
// look-back (Merrill and Garland, 2016), for it needs no grid barrier and no
// bound on the tiles resident; the CPU model (kernels/compat_gate.py) showed
// first that the carry summary below stays closed under composition.  A
// block takes a tile of T threads x W words x 32 samples, in the order of a
// ticket from an atomic counter (never blockIdx: a tile then never waits on
// one that is not resident).  Its samples stay on chip from the read of
// amp / avg to the write of trig / pulses_at, as two bit masks a word
// (above, below).
//
// * The carry across samples is C = (s, cnt, l, m0, t): the state, the rise
//   count, the last edge, reset0's running maximum and the rise count at the
//   last trig0 (reset2's maximum is max(m0, t) brought forward).  A span's
//   descriptor (20 int32, kernels/compat_gate.py has the algebra) maps any C
//   to the C that leaves it: per incoming state, the state, rises and last
//   edge it adds, the one test of its first rise against l (short iff l >=
//   LT), and per outcome its last short rise and its last trig0, which fires
//   past one value of the pulses coming in (cnt - m0).  Composition keeps that
//   form, so one scan of descriptors serves every quantity at once.
// * Within a tile: each word's descriptor from its masks (the state mask by
//   carry arithmetic, the rises' loop sparse), one warp-shuffle scan of the
//   threads' descriptors and one shared-memory round across the warps: the
//   tile's descriptor and each thread's prefix.  The kernel's earlier five-pass
//   form ran six or seven three-barrier block scans of one int each a tile.
// * Across tiles: the tile publishes its descriptor (status AGG, st.release),
//   then warp 0 polls the statuses of up to kWindow predecessors (relaxed
//   loads, one acquire fence), the nearest published inclusive carry (INC)
//   cuts the window, the block stages the aggregates after it in shared
//   memory and warp 0 composes them (a run a lane, then the warp); the tile
//   publishes its inclusive carry.  No pass runs on a single block while
//   the card waits: the earlier form's two one-block carry passes and its
//   reverse scan are gone.
// * The scratch (kept by the wrapper per device and stream, zeroed once when
//   it grows) holds its own per-launch state, so every launch of a shape
//   takes the same arguments (a CUDA graph may replay it) and two host
//   threads on one stream cannot race on it: one 64-bit word, the launches
//   so far above kTicketBits bits of tickets taken.  A tile's one atomic add
//   gives its tile index and its launch's epoch (the launches before it +
//   1), with which it tags its statuses, so no status is cleared between
//   launches; the tile that takes a launch's last ticket moves the word on
//   to the next launch (tickets 0), when every tile of its own has read it.
//   Statuses are 64-bit and sit at offsets fixed by the scratch's capacity;
//   an epoch recurs after 2^44 launches (5.6 years of launches of 10 us).
// * The next edge after a rise is the next below sample (the state is high
//   until one), so the T1-quiet test needs no state: a tile reads the
//   decisions of the nt1 + 1 samples past its end (its halo) and takes the
//   first below there.  At ReaderConfig()'s nt1 = 96 that is 2.4% more bytes
//   at a 4,096-sample tile; at 16 Msps (nt1 = 3,840) 94% at 4,096 and 23% at
//   16,384, the tile the wrapper takes there.
// * One tile (a live window): no ticket, no scratch, no look-back, and words
//   of 16 samples on twice the threads (a thread's serial work sets the
//   time there); its carries come from two scans, the state, rises and last
//   edge for both incoming states, then the pulse part under them.
// * Loads: 16 bytes a lane, each thread its own words; coalesced across the
//   warp (nibbles OR-ed into words by shuffles) once the tiles outnumber the
//   SMs and the loads share the memory's bandwidth.
// * Bytes: amp, avg and the halo in, trig and pulses_at out; 13 a sample plus
//   the halo, against the earlier form's 31 in five launches.
//
// Configurations (T, W): see COMPAT_GATE_CONFIGS; the wrapper picks one by
// length and T1 window (kernels/compat_gate.py::choose_config), from the
// sweep chip_smoke.py records.
//
// --fmad=false and __fmul_rn keep the threshold the plain version's float32
// product.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MAX;

// A descriptor: two branches (incoming state -1, +1) of 10 words each.
enum { kSo, kNr, kLe, kLt, kMs, kTk, kTt, kBranch = 10, kDescWords = 20 };
// Status kinds; a status word (64-bit) is epoch << 2 | kind.
enum { kAgg = 1, kInc = 2 };
constexpr int kIncWords = 8;
// Scratch words 0-1: the launch word (launches << kTicketBits | tickets);
// the statuses from word kStatusOff.  n < 2^31 and tiles of 2,048 samples
// or more give at most 2^20 tiles.
constexpr int kTicketBits = 20;
constexpr int kStatusOff = 4;
// A look-back waits on tiles that hold their tickets and run; a wait of some
// seconds is a fault, and the kernel traps (the launch fails) rather than
// hang the card.
constexpr int kMaxSpins = 1 << 24;
// Predecessors a look-back round reads, kWindow / T a thread.
constexpr int kWindow = 256;

struct Desc {
  int v[kDescWords];
};

struct Carry {
  int s, cnt, l, m0, t;
};

__device__ __forceinline__ Desc identity() {
  Desc d;
#pragma unroll
  for (int i = 0; i < kDescWords; ++i) d.v[i] = 0;
  d.v[kBranch + kSo] = 1;
  d.v[kLe] = d.v[kBranch + kLe] = -1;
  d.v[kLt] = d.v[kBranch + kLt] = kNone;
  return d;
}

// The descriptor of span a followed by span b (compat_gate.py::desc_compose).
__device__ __forceinline__ Desc compose(const Desc& a, const Desc& b) {
  Desc r;
#pragma unroll
  for (int br = 0; br < 2; ++br) {
    const int* A = a.v + br * kBranch;
    const bool m = A[kSo] != 0;
    int B[kBranch];
#pragma unroll
    for (int f = 0; f < kBranch; ++f) B[f] = m ? b.v[kBranch + f] : b.v[f];
    const bool test_a = A[kLt] != kNone;
    const bool noedge_a = A[kLe] < 0;
    const bool ub_fix = B[kLt] != kNone && A[kLe] >= B[kLt];
    const int nr_a = A[kNr];
    int* R = r.v + br * kBranch;
    R[kSo] = B[kSo];
    R[kNr] = nr_a + B[kNr];
    R[kLe] = B[kLe] >= 0 ? B[kLe] : A[kLe];
    R[kLt] = test_a ? A[kLt] : (noedge_a ? B[kLt] : kNone);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool ua = u && test_a;
      const bool ub = test_a ? ub_fix : (noedge_a ? (u != 0) : ub_fix);
      const int ms_a = ua ? A[kMs + 3] : A[kMs], tk_a = ua ? A[kTk + 3] : A[kTk];
      const int tt_a = ua ? A[kTt + 3] : A[kTt];
      const int ms_b = ub ? B[kMs + 3] : B[kMs], tk_b = ub ? B[kTk + 3] : B[kTk];
      const int tt_b = ub ? B[kTt + 3] : B[kTt];
      const bool from_b = tk_b > 0 && (ms_a == 0 || nr_a - ms_a >= tt_b);
      const int tt_bs = tt_b - nr_a > 0 ? tt_b - nr_a : 0;
      R[kMs + 3 * u] = ms_b > 0 ? nr_a + ms_b : ms_a;
      R[kTk + 3 * u] = from_b ? nr_a + tk_b : tk_a;
      R[kTt + 3 * u] = from_b ? (ms_a > 0 ? 0 : tt_bs) : tt_a;
    }
  }
  return r;
}

// The carry leaving a span of descriptor d that c enters.
__device__ __forceinline__ Carry apply(const Desc& d, const Carry& c) {
  const bool b = c.s > 0;
  int D[kBranch];
#pragma unroll
  for (int f = 0; f < kBranch; ++f) D[f] = b ? d.v[kBranch + f] : d.v[f];
  const bool u = c.l >= D[kLt];
  const int ms = u ? D[kMs + 3] : D[kMs], tk = u ? D[kTk + 3] : D[kTk];
  const int tt = u ? D[kTt + 3] : D[kTt];
  Carry o;
  o.s = D[kSo] ? 1 : -1;
  o.cnt = c.cnt + D[kNr];
  o.l = D[kLe] >= 0 ? D[kLe] : c.l;
  o.m0 = ms > 0 ? c.cnt + ms : c.m0;
  o.t = tk > 0 && c.cnt - c.m0 >= tt ? c.cnt + tk : c.t;
  return o;
}

__device__ __forceinline__ Desc shfl_up(const Desc& d, int delta) {
  Desc r;
#pragma unroll
  for (int i = 0; i < kDescWords; ++i) r.v[i] = __shfl_up_sync(kFull, d.v[i], delta);
  return r;
}

__device__ __forceinline__ Desc shfl_down(const Desc& d, int delta) {
  Desc r;
#pragma unroll
  for (int i = 0; i < kDescWords; ++i) r.v[i] = __shfl_down_sync(kFull, d.v[i], delta);
  return r;
}

__device__ __forceinline__ void store_desc(int* dst, const Desc& d) {
  int4* p = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int i = 0; i < kDescWords / 4; ++i)
    p[i] = make_int4(d.v[4 * i], d.v[4 * i + 1], d.v[4 * i + 2], d.v[4 * i + 3]);
}

// Reads published words past L1 (another SM wrote them).
__device__ __forceinline__ Desc load_desc_cg(const int* src) {
  Desc d;
  const int4* p = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int i = 0; i < kDescWords / 4; ++i) {
    const int4 q = __ldcg(p + i);
    d.v[4 * i] = q.x;
    d.v[4 * i + 1] = q.y;
    d.v[4 * i + 2] = q.z;
    d.v[4 * i + 3] = q.w;
  }
  return d;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Polls without ordering (an acquire load orders every later load after it,
// so a run of them would wait on each other); fence_acquire then orders the
// reads of what the polled statuses published.
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The state-high mask of a word (bit p: the state after sample p is POS):
// the last decisive bit at or before p is above, or none is and the state
// coming in (s_hi) is.  Ties copy the state forward; a run of ties that
// starts low is cleared by one carry chain: M + (its first bit) clears it.
__device__ __forceinline__ unsigned state_high(unsigned above, unsigned below, unsigned s_hi) {
  const unsigned x = ~below, m = ~(above | below);
  const unsigned starts = x & ~((x << 1) | s_hi);
  return x & ~(m & ~(m + (starts & m)));
}

struct WordBits {
  unsigned rise, edge, high;
};

__device__ __forceinline__ WordBits word_bits(unsigned above, unsigned below, unsigned s_hi) {
  WordBits w;
  w.high = state_high(above, below, s_hi);
  const unsigned prev = (w.high << 1) | s_hi;
  w.rise = w.high & ~prev;
  w.edge = w.rise | (prev & ~w.high);
  return w;
}

// A word's descriptor (compat_gate.py::span_descriptors on its 32 samples):
// cand, whether a rise at a sample would be a trigger candidate.
__device__ __forceinline__ Desc word_desc(unsigned above, unsigned below, unsigned cand,
                                          int base, int pw_half, int npc) {
  Desc d;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const WordBits w = word_bits(above, below, b);
    int* h = d.v + b * kBranch;
    h[kSo] = static_cast<int>(w.high >> 31);
    h[kNr] = __popc(w.rise);
    h[kLe] = w.edge ? base + 31 - __clz(w.edge) : -1;
    h[kLt] = kNone;
    int ms0 = 0, tk0 = 0, tt0 = 0, ms1 = 0, tk1 = 0, tt1 = 0, k = 0;
    for (unsigned r = w.rise; r; r &= r - 1) {
      const int p = __ffs(r) - 1;
      ++k;
      const unsigned before = w.edge & ((1u << p) - 1u);
      bool sh0, sh1;
      if (before) {
        sh0 = sh1 = p - (31 - __clz(before)) <= pw_half;
      } else {                          // the first rise: its previous edge is before the word
        h[kLt] = base + p - pw_half;
        sh0 = false;
        sh1 = true;
      }
      if (sh0) ms0 = k;
      if (sh1) ms1 = k;
      if (cand >> p & 1u) {
        const int tt = npc + 1 - k > 0 ? npc + 1 - k : 0;
        if (ms0 == 0) {
          tk0 = k;
          tt0 = tt;
        } else if (k - ms0 > npc) {
          tk0 = k;
          tt0 = 0;
        }
        if (ms1 == 0) {
          tk1 = k;
          tt1 = tt;
        } else if (k - ms1 > npc) {
          tk1 = k;
          tt1 = 0;
        }
      }
    }
    h[kMs] = ms0;
    h[kTk] = tk0;
    h[kTt] = tt0;
    h[kMs + 3] = ms1;
    h[kTk + 3] = tk1;
    h[kTt + 3] = tt1;
  }
  return d;
}

// What a word does to the carry c entering it (c becomes the carry leaving):
// its rises, the short ones (disq, they reset M0), the candidates past npc
// pulses since M0 (trig0) and past npc since M2 = max(M0, the last trig0
// before) (trig, in tbits).
struct WordWalk {
  WordBits w;
  unsigned disq, trig0, tbits;
};

__device__ __forceinline__ WordWalk walk_word(unsigned above, unsigned below, unsigned cand,
                                              int base, int pw_half, int npc, Carry& c) {
  WordWalk r;
  r.w = word_bits(above, below, c.s > 0);
  r.disq = r.trig0 = r.tbits = 0;
  int k = 0;
  for (unsigned rr = r.w.rise; rr; rr &= rr - 1) {
    const int p = __ffs(rr) - 1;
    const int rc = c.cnt + (++k);
    const unsigned before = r.w.edge & ((1u << p) - 1u);
    const int pe = before ? base + 31 - __clz(before) : c.l;
    if (base + p - pe <= pw_half) {
      r.disq |= 1u << p;
      c.m0 = rc;
    }
    if (cand >> p & 1u) {
      if (rc - (c.m0 > c.t ? c.m0 : c.t) > npc) r.tbits |= 1u << p;
      if (rc - c.m0 > npc) {
        r.trig0 |= 1u << p;
        c.t = rc;
      }
    }
  }
  c.s = (r.w.high >> 31) ? 1 : -1;
  c.cnt += k;
  if (r.w.edge) c.l = base + 31 - __clz(r.w.edge);
  return r;
}

// A word's outputs (WB samples) from the carry c entering it; c becomes
// the carry leaving.
template <int WB>
__device__ __forceinline__ void finish_word(unsigned above, unsigned below, unsigned cand,
                                            int base, int n, int pw_half, int npc, bool vec,
                                            Carry& c, uint8_t* __restrict__ trig,
                                            int* __restrict__ pulses) {
  const Carry c_in = c;
  const WordWalk r = walk_word(above, below, cand, base, pw_half, npc, c);
  const WordBits& w = r.w;
  const unsigned disq = r.disq, trig0 = r.trig0, tbits = r.tbits;
  // pulses_at = rc - M2; M2 moves only at a short rise (to its rc) and one
  // sample after a trig0 (to the trig0's rc).  Most words hold neither:
  // then M2 is the carry's and rc a population count.  Else a walk.
  const int m2_in = c_in.m0 > c_in.t ? c_in.m0 : c_in.t;
  int out[WB];
  if ((disq | (trig0 << 1)) == 0) {
#pragma unroll
    for (int p = 0; p < WB; ++p)
      out[p] = c_in.cnt - m2_in + __popc(w.rise & (0xffffffffu >> (31 - p)));
  } else {
    int rc = c_in.cnt, m2 = m2_in;
#pragma unroll
    for (int p = 0; p < WB; ++p) {
      const int prev = rc;
      if (w.rise >> p & 1u) ++rc;
      if (disq >> p & 1u) m2 = rc;
      if (p > 0 && (trig0 >> (p - 1) & 1u) && prev > m2) m2 = prev;
      out[p] = rc - m2;
    }
  }
  if (vec && base + WB <= n) {
    int4* p4 = reinterpret_cast<int4*>(pulses + base);
    uint4* t4 = reinterpret_cast<uint4*>(trig + base);
#pragma unroll
    for (int q = 0; q < WB / 4; ++q)
      p4[q] = make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
#pragma unroll
    for (int h = 0; h < WB / 16; ++h) {
      unsigned tw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned nib = tbits >> (16 * h + 4 * q);
        tw[q] = (nib & 1u) | (nib >> 1 & 1u) << 8 | (nib >> 2 & 1u) << 16 | (nib >> 3 & 1u) << 24;
      }
      t4[h] = make_uint4(tw[0], tw[1], tw[2], tw[3]);
    }
  } else {
#pragma unroll
    for (int p = 0; p < WB; ++p) {
      if (base + p < n) {
        pulses[base + p] = out[p];
        trig[base + p] = static_cast<uint8_t>(tbits >> p & 1u);
      }
    }
  }
}

// A word's decisions (WB samples): bit p of above (below) is set when
// sample base + p lies above (below) its threshold; none past n (nor past
// WB: those bits act as ties).
template <int WB>
__device__ __forceinline__ void load_word(const float* __restrict__ amp,
                                          const float* __restrict__ avg, int base, int n,
                                          float frac, bool vec, unsigned& above,
                                          unsigned& below) {
  above = below = 0;
  if (vec && base + WB <= n) {
    const float4* a4 = reinterpret_cast<const float4*>(amp + base);
    const float4* v4 = reinterpret_cast<const float4*>(avg + base);
    float4 a[WB / 4], v[WB / 4];
#pragma unroll
    for (int q = 0; q < WB / 4; ++q) {
      a[q] = __ldg(a4 + q);
      v[q] = __ldg(v4 + q);
    }
#pragma unroll
    for (int q = 0; q < WB / 4; ++q) {
      const float as[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
      const float vs[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float th = __fmul_rn(vs[j], frac);
        above |= static_cast<unsigned>(as[j] > th) << (4 * q + j);
        below |= static_cast<unsigned>(as[j] < th) << (4 * q + j);
      }
    }
  } else if (base < n) {
#pragma unroll 8
    for (int p = 0; p < WB; ++p) {
      if (base + p < n) {
        const float a = __ldg(amp + base + p);
        const float th = __fmul_rn(__ldg(avg + base + p), frac);
        above |= static_cast<unsigned>(a > th) << p;
        below |= static_cast<unsigned>(a < th) << p;
      }
    }
  }
}

// A warp's 32 * W words from 16-byte loads of consecutive samples a lane
// (coalesced): a lane's 4 decisions a nibble, OR-ed into words across 8
// lanes by shuffles, and each word handed to the lane that keeps it.
template <int W>
__device__ __forceinline__ void load_words_coalesced(const float* __restrict__ amp,
                                                     const float* __restrict__ avg,
                                                     int warp_base, int n, float frac,
                                                     unsigned (&above)[W], unsigned (&below)[W]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < W; ++k) above[k] = below[k] = 0;
#pragma unroll
  for (int c = 0; c < 8 * W; ++c) {
    const int s = warp_base + 128 * c + 4 * lane;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (s + 4 <= n) {
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(amp + s));
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(avg + s));
      a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
      v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s + j < n) {
          a[j] = __ldg(amp + s + j);
          v[j] = __ldg(avg + s + j);
        }
    }
    unsigned na = 0, nb = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float th = __fmul_rn(v[j], frac);
      const bool in = s + j < n;
      na |= static_cast<unsigned>(in && a[j] > th) << j;
      nb |= static_cast<unsigned>(in && a[j] < th) << j;
    }
    unsigned wa = na << (4 * (lane & 7)), wb = nb << (4 * (lane & 7));
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      wa |= __shfl_xor_sync(kFull, wa, d);
      wb |= __shfl_xor_sync(kFull, wb, d);
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = lane * W + k;
      const unsigned ga = __shfl_sync(kFull, wa, 8 * (j & 3));
      const unsigned gb = __shfl_sync(kFull, wb, 8 * (j & 3));
      if ((j >> 2) == c) {
        above[k] = ga;
        below[k] = gb;
      }
    }
  }
}

// The scratch of a capacity of cap tiles: the launch state, cap statuses,
// cap descriptors and cap inclusive carries.  The offsets depend on cap
// alone, so a status word never lies where an earlier launch of fewer tiles
// wrote a descriptor.
struct Layout {
  long long desc, inc, total;
};

__host__ __device__ __forceinline__ Layout layout(long long cap) {
  Layout L;
  L.desc = (kStatusOff + 2 * cap + 3) / 4 * 4;
  L.inc = L.desc + cap * kDescWords;
  L.total = L.inc + cap * kIncWords;
  return L;
}

// A one-tile launch finds its threads' carries in two scans.  The first
// runs over the state, the rises and the last edge, for both incoming
// states (so[b], nr[b], le[b]); the second, once those are known, over the
// rises, the last short rise and the last trig0 with its threshold on the
// pulses coming in (the descriptor's u-part with its test resolved).
struct Edges {
  int so[2], nr[2], le[2];
};

struct Pulses {
  int nr, ms, tk, tt;
};

__device__ __forceinline__ Edges compose_edges(const Edges& a, const Edges& b) {
  Edges r;
#pragma unroll
  for (int br = 0; br < 2; ++br) {
    const bool m = a.so[br] != 0;
    const int le_b = m ? b.le[1] : b.le[0];
    r.so[br] = m ? b.so[1] : b.so[0];
    r.nr[br] = a.nr[br] + (m ? b.nr[1] : b.nr[0]);
    r.le[br] = le_b >= 0 ? le_b : a.le[br];
  }
  return r;
}

__device__ __forceinline__ Pulses compose_pulses(const Pulses& a, const Pulses& b) {
  const bool from_b = b.tk > 0 && (a.ms == 0 || a.nr - a.ms >= b.tt);
  Pulses r;
  r.nr = a.nr + b.nr;
  r.ms = b.ms > 0 ? a.nr + b.ms : a.ms;
  r.tk = from_b ? a.nr + b.tk : a.tk;
  r.tt = from_b ? (a.ms > 0 ? 0 : (b.tt - a.nr > 0 ? b.tt - a.nr : 0)) : a.tt;
  return r;
}

// Scans of one small struct a thread (K ints, composed by op) in thread
// order.  warp_scan: the inclusive scan across the warp (returned) and the
// exclusive one (*excl), by shuffles; cross_warp: after a barrier, the
// warps' totals before this one (s_warp) composed ahead of excl.
template <int K, typename S, typename Op>
__device__ __forceinline__ S warp_scan(S v, const S& ident, Op op, S* excl) {
  static_assert(sizeof(S) == K * sizeof(int), "a struct of K ints");
  const int lane = threadIdx.x & 31;
  S x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    S y;
    const int* xs = reinterpret_cast<const int*>(&x);
    int* ys = reinterpret_cast<int*>(&y);
#pragma unroll
    for (int i = 0; i < K; ++i) ys[i] = __shfl_up_sync(kFull, xs[i], d);
    if (lane >= d) x = op(y, x);
  }
  const int* xs = reinterpret_cast<const int*>(&x);
  int* es = reinterpret_cast<int*>(excl);
#pragma unroll
  for (int i = 0; i < K; ++i) es[i] = __shfl_up_sync(kFull, xs[i], 1);
  if (lane == 0) *excl = ident;
  return x;
}

template <int T, typename S, typename Op>
__device__ __forceinline__ S cross_warp(const S& excl, const S& ident, Op op, const S* s_warp) {
  const int warp = threadIdx.x >> 5;
  S pre = ident;
#pragma unroll
  for (int w2 = 0; w2 < T / 32; ++w2)
    if (w2 < warp) pre = op(pre, s_warp[w2]);
  return op(pre, excl);
}

// kOne: a capture of one tile (no ticket, no scratch, no look-back), in
// words of WB = 16 samples, twice the threads of the configuration, so a
// thread's serial work halves where nothing else hides it; every other
// launch in words of WB = 32.
template <int T, int W, bool kOne, int WB = kOne ? 16 : 32>
__global__ void __launch_bounds__(T)
compat_gate_kernel(const float* __restrict__ amp, const float* __restrict__ avg, int n,
                   float frac, int pw_half, int nt1, int npc, int ntiles, int cap, bool vec_in,
                   bool coalesce, bool vec_out, uint8_t* __restrict__ trig, int* __restrict__ pulses,
                   int* scratch) {
  constexpr int kWarps = T / 32;
  constexpr int kTile = T * W * WB;
  constexpr int kLook = kWindow / T;  // predecessors a thread reads a look-back round
  __shared__ int s_tile, s_halo;
  __shared__ unsigned long long s_epoch;
  __shared__ int s_int[kWarps];
  __shared__ __align__(16) int s_desc[kWarps][kDescWords];
  __shared__ __align__(16) int s_total[kDescWords];
  __shared__ __align__(16) int s_window[kWindow][kDescWords];
  __shared__ Edges s_edges[kWarps];
  __shared__ Pulses s_pulses[kWarps];
  __shared__ int s_q;
  __shared__ Carry s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // A tile's index from the ticket counter, and the launch's epoch (one
  // tile: 0, with no barrier before its loads).
  if constexpr (!kOne) {
    if (tid == 0) {
      unsigned long long* word = reinterpret_cast<unsigned long long*>(scratch);
      const unsigned long long t = atomicAdd(word, 1ull);
      s_tile = static_cast<int>(t & ((1ull << kTicketBits) - 1));
      if (s_tile == ntiles - 1) atomicAdd(word, (1ull << kTicketBits) - ntiles);
      s_epoch = (t >> kTicketBits) + 1;
      s_halo = kNone;
    }
    __syncthreads();
  }
  const int tile = kOne ? 0 : s_tile;
  const unsigned long long epoch = kOne ? 0 : s_epoch;
  const int tile_base = tile * kTile;

  // The halo: the first below sample in [tile end, tile end + nt1].  A
  // thread's first halo sample is loaded before its words.
  const int tile_end = tile_base + kTile < n ? tile_base + kTile : n;
  const int halo = tile_end < n ? (n - tile_end < nt1 + 1 ? n - tile_end : nt1 + 1) : 0;
  float halo_a = 0.0f, halo_v = 0.0f;
  if (tid < halo) {
    halo_a = __ldg(amp + tile_end + tid);
    halo_v = __ldg(avg + tile_end + tid);
  }
  // The tile's decisions: each thread its own W words, 16-byte loads all
  // issued before the compares.
  const int my_base = tile_base + tid * (W * WB);
  unsigned above[W], below[W];
  if (!kOne && coalesce) {              // words of 32 samples
    load_words_coalesced<W>(amp, avg, tile_base + warp * (W * 1024), n, frac, above, below);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k)
      load_word<WB>(amp, avg, my_base + WB * k, n, frac, vec_in, above[k], below[k]);
  }
  int hb = tid < halo && halo_a < __fmul_rn(halo_v, frac) ? tile_end + tid : kNone;
#pragma unroll 1
  for (int j = tid + T; hb == kNone && j < halo; j += T) {
    const int i = tile_end + j;
    if (__ldg(amp + i) < __fmul_rn(__ldg(avg + i), frac)) hb = i;
  }
  hb = __reduce_min_sync(kFull, hb);
  if (lane == 0 && hb != kNone) atomicMin(&s_halo, hb);

  // The first below after each of the thread's words: a suffix minimum of
  // the words' first below samples across the tile, then the halo.
  int first_b = kNone;
#pragma unroll
  for (int k = W - 1; k >= 0; --k)
    if (below[k]) first_b = my_base + WB * k + __ffs(below[k]) - 1;
  int suffix = first_b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_down_sync(kFull, suffix, d);
    if (lane + d < 32 && y < suffix) suffix = y;
  }
  int after = __shfl_down_sync(kFull, suffix, 1);
  if (lane == 31) after = kNone;
  if (lane == 0) s_int[warp] = suffix;
  // One tile: the first scan (the state, the rises and the last edge for
  // both incoming states) needs only the decisions, and shares the barrier.
  const Edges e_id = {{0, 1}, {0, 0}, {-1, -1}};
  const auto edges_op = [](const Edges& a, const Edges& b) { return compose_edges(a, b); };
  Edges e_ex = e_id;
  if constexpr (kOne) {
    Edges e = e_id;
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int br = 0; br < 2; ++br) {
        const WordBits wb = word_bits(above[k], below[k], e.so[br]);
        e.so[br] = wb.high >> 31;
        e.nr[br] += __popc(wb.rise);
        if (wb.edge) e.le[br] = my_base + WB * k + 31 - __clz(wb.edge);
      }
    }
    const Edges x = warp_scan<6>(e, e_id, edges_op, &e_ex);
    if (lane == 31) s_edges[warp] = x;
  }
  __syncthreads();
  if (!kOne && s_halo < after) after = s_halo;
#pragma unroll
  for (int w2 = 0; w2 < kWarps; ++w2)
    if (w2 > warp && s_int[w2] < after) after = s_int[w2];

  // Candidates (quiet and inside the tail) at every sample that rises under
  // either incoming state; then the words' descriptors and the thread's.
  unsigned cand[W];
  Desc mine = identity();
#pragma unroll
  for (int k = W - 1; k >= 0; --k) {
    const int base = my_base + WB * k;
    const unsigned rises = word_bits(above[k], below[k], 0).rise |
                           word_bits(above[k], below[k], 1).rise;
    unsigned cm = 0;
    for (unsigned r = rises; r; r &= r - 1) {
      const int p = __ffs(r) - 1;
      const int gi = base + p;
      const unsigned hi = p < 31 ? below[k] >> (p + 1) : 0u;
      const int nb = hi ? gi + __ffs(hi) : after;
      if (nb > gi + nt1 + 1 && gi + nt1 + 1 < n) cm |= 1u << p;
    }
    cand[k] = cm;
    if (below[k]) after = base + __ffs(below[k]) - 1;
  }

  Carry c;                              // into the thread's first word
  if constexpr (kOne) {
    // One tile: its carry is the capture's start, and the threads' carries
    // come from two scans: the state, the rises and the last edge (begun
    // above), then the pulses part under them.
    const Edges e = cross_warp<T>(e_ex, e_id, edges_op, s_edges);
    c = {e.so[0] ? 1 : -1, e.nr[0], e.le[0], 0, 0};   // from the start: state -1
    // The pulses part, each word's rises under the carry now known.
    Pulses pu = {0, 0, 0, 0};
    Carry w = c;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int base = my_base + WB * k;
      const WordBits wb = word_bits(above[k], below[k], w.s > 0);
      Pulses q = {0, 0, 0, 0};
      for (unsigned r = wb.rise; r; r &= r - 1) {
        const int p = __ffs(r) - 1;
        ++q.nr;
        const unsigned before = wb.edge & ((1u << p) - 1u);
        const int pe = before ? base + 31 - __clz(before) : w.l;
        if (base + p - pe <= pw_half) q.ms = q.nr;
        if (cand[k] >> p & 1u) {
          if (q.ms == 0) {
            q.tk = q.nr;
            q.tt = npc + 1 - q.nr > 0 ? npc + 1 - q.nr : 0;
          } else if (q.nr - q.ms > npc) {
            q.tk = q.nr;
            q.tt = 0;
          }
        }
      }
      pu = compose_pulses(pu, q);
      w.s = (wb.high >> 31) ? 1 : -1;
      if (wb.edge) w.l = base + 31 - __clz(wb.edge);
    }
    const Pulses p_id = {0, 0, 0, 0};
    const auto pulses_op = [](const Pulses& a, const Pulses& b) { return compose_pulses(a, b); };
    Pulses p_ex;
    const Pulses px = warp_scan<4>(pu, p_id, pulses_op, &p_ex);
    if (lane == 31) s_pulses[warp] = px;
    __syncthreads();
    pu = cross_warp<T>(p_ex, p_id, pulses_op, s_pulses);
    // From the capture's start (no rise, no reset, no pulse before it).
    c.m0 = pu.ms;
    c.t = pu.tk > 0 && pu.tt == 0 ? pu.tk : 0;
  } else {
#pragma unroll 1
    for (int k = 0; k < W; ++k)
      mine = compose(mine, word_desc(above[k], below[k], cand[k], my_base + WB * k, pw_half,
                                     npc));

    // One scan of the threads' descriptors: shuffles in the warp, one round
    // of shared memory across the warps.
    Desc x = mine;
#pragma unroll 1
    for (int d = 1; d < 32; d <<= 1) {
      const Desc y = shfl_up(x, d);
      if (lane >= d) x = compose(y, x);
    }
    Desc ex = shfl_up(x, 1);
    if (lane == 0) ex = identity();
    if (lane == 31) {
#pragma unroll
      for (int i = 0; i < kDescWords; ++i) s_desc[warp][i] = x.v[i];
    }
    __syncthreads();
    if (warp == 0) {
      Desc y = identity();
      if (lane < kWarps) {
#pragma unroll
        for (int i = 0; i < kDescWords; ++i) y.v[i] = s_desc[lane][i];
      }
#pragma unroll 1
      for (int d = 1; d < kWarps; d <<= 1) {
        const Desc z = shfl_up(y, d);
        if (lane >= d) y = compose(z, y);
      }
      Desc wex = shfl_up(y, 1);
      if (lane == 0) wex = identity();
      __syncwarp();
      if (lane < kWarps) {
#pragma unroll
        for (int i = 0; i < kDescWords; ++i) s_desc[lane][i] = wex.v[i];
      }
      if (lane == kWarps - 1) {
#pragma unroll
        for (int i = 0; i < kDescWords; ++i) s_total[i] = y.v[i];
      }
    }
    __syncthreads();
    {
      Desc wp;
#pragma unroll
      for (int i = 0; i < kDescWords; ++i) wp.v[i] = s_desc[warp][i];
      ex = compose(wp, ex);               // the thread's prefix in the tile
    }

    // The carry into the tile.
    const Carry c0 = {-1, 0, -1, 0, 0};
    {
      unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + kStatusOff);
      const Layout L = layout(cap);
      int* descs = scratch + L.desc;
      int* incs = scratch + L.inc;
      Desc total;
#pragma unroll
      for (int i = 0; i < kDescWords; ++i) total.v[i] = s_total[i];
      if (tile == 0) {
        if (tid == 0) {
          const Carry o = apply(total, c0);
          reinterpret_cast<int4*>(incs)[0] = make_int4(o.s, o.cnt, o.l, o.m0);
          reinterpret_cast<int4*>(incs)[1] = make_int4(o.t, 0, 0, 0);
          st_release(status, epoch << 2 | kInc);
          s_carry = c0;
        }
      } else {
        if (tid == 0) {
          store_desc(descs + static_cast<long long>(tile) * kDescWords, total);
          st_release(status + tile, epoch << 2 | kAgg);
        }
        // Look back over kWindow predecessors a round: wait for each to
        // publish, cut at the nearest inclusive carry, stage the aggregates
        // after it in shared memory (one round trip) and compose them.
        Desc acc = identity();            // thread 0's: the rounds so far
        int hi = tile, q = -1;
        while (true) {
          const int lo = hi - kWindow;
          if (warp == 0) {
            // Each lane polls kWindow / 32 statuses until all carry this
            // launch's epoch, keeping two bits of each (this launch's, INC)
            // so that the 64-bit words take no registers.
            constexpr unsigned kAll = (1u << (kWindow / 32)) - 1;
            unsigned seen = 0, inc = 0;
            for (int spins = 0; !__all_sync(kFull, seen == kAll); ++spins) {
              if (spins > kMaxSpins) __trap();
              if (spins) __nanosleep(64);
#pragma unroll
              for (int j = 0; j < kWindow / 32; ++j) {
                const int p = lo + 32 * j + lane;
                if (!(seen >> j & 1u)) {
                  const unsigned long long st = p >= 0 ? ld_relaxed(status + p) : epoch << 2;
                  if ((st >> 2) == epoch) {
                    seen |= 1u << j;
                    if ((st & 3u) == kInc) inc |= 1u << j;
                  }
                }
              }
            }
            fence_acquire();
            int my_q = inc ? lo + 32 * (31 - __clz(inc)) + lane : -1;
            my_q = __reduce_max_sync(kFull, my_q);
            if (lane == 0) s_q = my_q;
          }
          __syncthreads();                // s_q is this round's; s_window is free again
          q = s_q;
          // The aggregates in [first, hi): staged at their offset from lo.
          const int first = q >= lo ? q + 1 : (lo > 0 ? lo : 0);
#pragma unroll
          for (int j = 0; j < kLook; ++j) {
            const int p = lo + j * T + tid;
            if (p >= first && p < hi) {
              const Desc e = load_desc_cg(descs + static_cast<long long>(p) * kDescWords);
              int4* dst = reinterpret_cast<int4*>(s_window[p - lo]);
#pragma unroll
              for (int i = 0; i < kDescWords / 4; ++i)
                dst[i] = make_int4(e.v[4 * i], e.v[4 * i + 1], e.v[4 * i + 2], e.v[4 * i + 3]);
            }
          }
          __syncthreads();
          // Warp 0 composes them, a run a lane, then across the warp; the
          // other warps wait at the next barrier.
          if (warp == 0) {
            const int count = hi - first, per = (count + 31) / 32;
            const int p0 = first + lane * per, p1 = p0 + per < hi ? p0 + per : hi;
            Desc dv = identity();
#pragma unroll 1
            for (int p = p0; p < p1; ++p) {
              Desc e;
              const int4* src = reinterpret_cast<const int4*>(s_window[p - lo]);
#pragma unroll
              for (int i = 0; i < kDescWords / 4; ++i) {
                const int4 v = src[i];
                e.v[4 * i] = v.x;
                e.v[4 * i + 1] = v.y;
                e.v[4 * i + 2] = v.z;
                e.v[4 * i + 3] = v.w;
              }
              dv = compose(dv, e);
            }
            if (__any_sync(kFull, p0 < p1)) {
#pragma unroll 1
              for (int d = 1; d < 32; d <<= 1) {
                const Desc y = shfl_down(dv, d);
                if (lane + d < 32) dv = compose(dv, y);
              }
            }
            if (lane == 0) acc = compose(dv, acc);
          }
          if (q >= 0) break;              // block-uniform: tile 0 publishes INC only
          hi = lo;
        }
        if (tid == 0) {
          // The nearest inclusive carry, and this tile's.
          for (int spins = 0; (ld_acquire(status + q) >> 2) != epoch; ++spins) {
            if (spins > kMaxSpins) __trap();
            __nanosleep(32);
          }
          const int4* src = reinterpret_cast<const int4*>(incs + static_cast<long long>(q) *
                                                                 kIncWords);
          const int4 a = __ldcg(src), b = __ldcg(src + 1);
          const Carry cq = {a.x, a.y, a.z, a.w, b.x};
          const Carry cin = apply(acc, cq);
          const Carry o = apply(total, cin);
          int4* dst = reinterpret_cast<int4*>(incs + static_cast<long long>(tile) * kIncWords);
          dst[0] = make_int4(o.s, o.cnt, o.l, o.m0);
          dst[1] = make_int4(o.t, 0, 0, 0);
          st_release(status + tile, epoch << 2 | kInc);
          s_carry = cin;
        }
      }
    }
    __syncthreads();
    c = apply(ex, s_carry);
  }

  // The thread's words from its carry: outputs, written as whole words.
#pragma unroll
  for (int k = 0; k < W; ++k)
    finish_word<WB>(above[k], below[k], cand[k], my_base + WB * k, n, pw_half, npc, vec_out, c,
                    trig, pulses);
}

// (threads a block, words a thread); a tile is 32 * T * W samples.
#define COMPAT_GATE_CONFIGS(X) \
  X(0, 64, 1) X(1, 128, 1) X(2, 256, 1) X(3, 256, 2)
#define COMPAT_GATE_ROW(i, t, w) {t, w},
constexpr int kConfigs[][2] = {COMPAT_GATE_CONFIGS(COMPAT_GATE_ROW)};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

template <int T, int W>
int launch(const float* amp, const float* avg, int n, float frac, int pw_half, int nt1, int npc,
           bool vec_in, bool vec_out, uint8_t* trig, int* pulses, int* scratch, int cap,
           cudaStream_t stream) {
  static const bool carveout = [] {
    // As much shared memory as the SM gives, so the look-back's staging
    // never limits the blocks an SM holds; a hint, its error cleared.
    (void)cudaFuncSetAttribute(compat_gate_kernel<T, W, false>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    (void)cudaGetLastError();
    return true;
  }();
  (void)carveout;
  static const int sms = [] {
    int device = 0, count = 0;
    (void)cudaGetDevice(&device);
    (void)cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return count;
  }();
  const int ntiles = (n + T * W * 32 - 1) / (T * W * 32);
  // Coalesced loads once the tiles outnumber the SMs (the loads then share
  // the memory's bandwidth); each thread's own words below that (fewer
  // instructions on the path of one tile).
  const bool coalesce = vec_in && ntiles > sms;
  if (ntiles == 1) {
    compat_gate_kernel<2 * T, W, true><<<1, 2 * T, 0, stream>>>(
        amp, avg, n, frac, pw_half, nt1, npc, 1, 0, vec_in, false, vec_out, trig, pulses,
        nullptr);
  } else {
    compat_gate_kernel<T, W, false><<<ntiles, T, 0, stream>>>(
        amp, avg, n, frac, pw_half, nt1, npc, ntiles, cap, vec_in, coalesce, vec_out, trig,
        pulses, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

int compat_gate_configs() { return kNumConfigs; }

int compat_gate_tile(int config) {
  if (config < 0 || config >= kNumConfigs) return 0;
  return kConfigs[config][0] * kConfigs[config][1] * 32;
}

// Scratch words for a capacity of cap tiles: the launch word, and a status,
// a descriptor and an inclusive carry a tile.
long long compat_gate_scratch_words(long long cap) { return layout(cap).total; }

// amp, avg: (n,) float32; trig: (n,) bytes 0/1; pulses: (n,) int32.  For
// more than one tile, scratch holds compat_gate_scratch_words(cap) int32
// words (16-byte aligned) for cap >= the tiles, laid out for cap at every
// launch (zeroed once, then written by this kernel alone); one stream at a
// time.  n + nt1 + tile + 2 < 2^31.  Returns the CUDA error
// of the launch (0: none), or -1 for an unknown configuration.
int compat_gate_launch(const float* amp, const float* avg, long long n, float frac,
                       int pw_half, int nt1, int npc, int config, uint8_t* trig, int* pulses,
                       int* scratch, int cap, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int ni = static_cast<int>(n);
  const bool vec_in = aligned16(amp) && aligned16(avg);
  const bool vec_out = aligned16(trig) && aligned16(pulses);
#define COMPAT_GATE_CASE(i, t, w)                                                          \
  case i:                                                                                  \
    return launch<t, w>(amp, avg, ni, frac, pw_half, nt1, npc, vec_in, vec_out, trig,     \
                        pulses, scratch, cap, stream);
  switch (config) {
    COMPAT_GATE_CONFIGS(COMPAT_GATE_CASE)
    default: return -1;
  }
}

}  // extern "C"
