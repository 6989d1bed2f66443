// gate_scan: the reference gate's per-sample state machine, walked in order.
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
// Bound on an H100: neither bytes nor operations.  Each sample's state
// depends on the previous one, so one thread walks the capture; at
// Ny = 1.94 M that is 13 bytes a sample (amp and avg in, trig and
// pulses_out out), 25 MB, about 7.5 us at 3.35 TB/s, while a serial walk of
// tens of cycles a sample takes milliseconds.  It cannot come near that
// bound.  Design: one block of kThreads walks the capture in chunks of
// kChunk samples, and keeps everything but the FSM itself parallel.  All
// threads load a chunk's amp and avg (coalesced), compare each amp with its
// threshold and pack the decisions into two bit masks per 32 samples with
// warp ballots (above, below; neither on equality), and zero the chunk's
// staged outputs.  Thread 0 runs the FSM with its decisions in registers,
// one pair of mask words per 32 samples, and jumps over open windows
// whole: inside one nothing changes but the count, and its outputs are 0
// (pulses was reset by the trigger that opened it).  All threads then write
// the staged outputs back (coalesced).  --fmad=false and __fmul_rn keep the
// threshold the plain version's float32 product.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;
constexpr int kWords = kChunk / 32;

__global__ void __launch_bounds__(kThreads)
gate_scan_kernel(const float* __restrict__ amp, const float* __restrict__ avg,
                 long long n, float frac, int pw_half, int nt1, int npc,
                 int rn16_window, int epc_window,
                 unsigned char* __restrict__ trig, int* __restrict__ pulses_out) {
  __shared__ unsigned above_w[kWords];
  __shared__ unsigned below_w[kWords];
  __shared__ unsigned char tr[kChunk];
  __shared__ int po[kChunk];
  const int lane = threadIdx.x & 31;
  // The FSM's state, live in thread 0 only: NEG = -1, POS = +1.
  int state = -1;
  int n_samp = 0;
  int pulses = 0;
  int open_rem = 0;
  bool next_epc = false;

  for (long long c0 = 0; c0 < n; c0 += kChunk) {
    const int len = static_cast<int>(n - c0 < kChunk ? n - c0 : kChunk);
    for (int base = threadIdx.x - lane; base < len; base += blockDim.x) {
      const int u = base + lane;
      bool hi = false;
      bool lo = false;
      if (u < len) {
        const float a = amp[c0 + u];
        const float th = __fmul_rn(avg[c0 + u], frac);
        hi = a > th;
        lo = a < th;
        tr[u] = 0;
        po[u] = 0;
      }
      const unsigned hi_mask = __ballot_sync(0xffffffffu, hi);
      const unsigned lo_mask = __ballot_sync(0xffffffffu, lo);
      if (lane == 0) {
        above_w[base >> 5] = hi_mask;
        below_w[base >> 5] = lo_mask;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int u = 0;
      while (u < len) {
        if (open_rem > 0) {            // gate open: jump to where it closes
          const int skip = open_rem < len - u ? open_rem : len - u;
          u += skip;
          open_rem -= skip;
          continue;
        }
        const int end = min(len, (u | 31) + 1);
        const unsigned hi_bits = above_w[u >> 5];
        const unsigned lo_bits = below_w[u >> 5];
        for (; u < end; ++u) {
          ++n_samp;
          const int b = u & 31;
          const bool to_neg = ((lo_bits >> b) & 1u) && state == 1;
          const bool to_pos = ((hi_bits >> b) & 1u) && state == -1;
          if (to_pos) pulses = n_samp > pw_half ? pulses + 1 : 0;
          if (to_neg || to_pos) {
            n_samp = 0;
            state = to_pos ? 1 : -1;
          }
          po[u] = pulses;
          if (n_samp > nt1 && state == 1 && pulses > npc) {
            tr[u] = 1;
            pulses = 0;
            n_samp = 0;
            open_rem = (next_epc ? epc_window : rn16_window) - 1;
            next_epc = !next_epc;
            ++u;
            break;
          }
        }
      }
    }
    __syncthreads();
    for (int u = threadIdx.x; u < len; u += blockDim.x) {
      trig[c0 + u] = tr[u];
      pulses_out[c0 + u] = po[u];
    }
    __syncthreads();   // the next chunk overwrites the masks and the outputs
  }
}

}  // namespace

// amp, avg: (n,) float32, contiguous.  Outputs: trig (n,) uint8 and
// pulses_out (n,) int32.  One block; returns a cudaError_t (0 on success).
extern "C" int gate_scan_launch(const float* amp, const float* avg, long long n,
                                float frac, int pw_half, int nt1, int npc,
                                int rn16_window, int epc_window,
                                unsigned char* trig, int* pulses_out,
                                void* stream) {
  if (n <= 0) return 0;
  if (rn16_window < 1 || epc_window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gate_scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      amp, avg, n, frac, pw_half, nt1, npc, rn16_window, epc_window, trig,
      pulses_out);
  return static_cast<int>(cudaGetLastError());
}
