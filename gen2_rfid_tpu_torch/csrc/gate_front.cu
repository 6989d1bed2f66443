// gate_front: fused gate front end on one pass over planar ADC-rate I/Q.
//
// Replaces the Pallas TPU kernel gen2_rfid_tpu/kernels/gate_front.py::gate_front
// (kernel body `_kernel`).  For every post-decimation sample k < Ny = N / decim:
//
//   y[k]      = sum_{j<T} x[k*decim - (T-1) + j]   boxcar FIR, zero history,
//                                                  taps summed in order j = 0..T-1
//   amp[k]    = sqrt(y_re^2 + y_im^2)
//   avgsum[k] = amp[k] + amp[k-1] + ... + amp[k-W+1]   (this association)
//   dcsum[k]  = y[k] + y[k-1] + ... + y[k-D+1]         (per plane)
//
// The summation orders are those of the Pallas kernel, so this kernel and the
// plain PyTorch version (kernels/gate_front.py::gate_front_plain) agree bit
// for bit.  Built with --fmad=false and written with __fadd_rn/__fmul_rn so no
// product is contracted into an FMA; sqrt is the IEEE __fsqrt_rn.
//
// Bound on an H100: memory.  The function reads 8 bytes per ADC sample and
// writes 24 bytes per output sample; at N = 9.7 M that is 77.6 MB in and
// 46.6 MB out, about 37 us at 3.35 TB/s.  Design: one block owns block_y
// outputs, stages the x it needs (its slab plus a (max(W,D)-1)*decim + T-1
// halo) in shared memory with coalesced loads, builds y and amp for the slab
// and its halo there, then each thread sums its windows from shared memory.
// The halo re-read (about (max(W,D)-1)/block_y of the input) is served mostly
// by L2.  The windowed sums cost W + 2D shared-memory reads per output; that,
// not DRAM, is what a faster version would attack (register blocking).
//
// The Pallas kernel's polyphase transpose, 128-lane DMA padding and
// lh = max(win, 128) halo were Mosaic constraints; here the halo follows
// from the parameters.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gate_front_kernel(const float* __restrict__ x2, long long n, int decim,
                  int n_taps, int win, int dcw, int block_y, long long ny,
                  float* __restrict__ y2, float* __restrict__ amp,
                  float* __restrict__ avgsum, float* __restrict__ dcsum2) {
  extern __shared__ float smem[];
  const int halo = max(win, dcw) - 1;                // y lookback of the sums
  const int ext = halo + block_y;                    // staged y samples
  const int xlen = (ext - 1) * decim + n_taps;       // staged x samples/plane
  float* xs_re = smem;
  float* xs_im = xs_re + xlen;
  float* ys_re = xs_im + xlen;
  float* ys_im = ys_re + ext;
  float* amps = ys_im + ext;

  const long long k0 = static_cast<long long>(blockIdx.x) * block_y;
  const long long x0 = (k0 - halo) * decim - (n_taps - 1);
  const float* xre = x2;
  const float* xim = x2 + n;

  // Zero history: samples before the capture (and past its end, which no
  // output reads) are zero.
  for (int u = threadIdx.x; u < xlen; u += blockDim.x) {
    const long long g = x0 + u;
    const bool in = g >= 0 && g < n;
    xs_re[u] = in ? xre[g] : 0.f;
    xs_im[u] = in ? xim[g] : 0.f;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < ext; e += blockDim.x) {
    const float* pr = xs_re + e * decim;
    const float* pi = xs_im + e * decim;
    float ar = 0.f;
    float ai = 0.f;
    for (int j = 0; j < n_taps; ++j) {
      ar = __fadd_rn(ar, pr[j]);
      ai = __fadd_rn(ai, pi[j]);
    }
    ys_re[e] = ar;
    ys_im[e] = ai;
    amps[e] = __fsqrt_rn(__fadd_rn(__fmul_rn(ar, ar), __fmul_rn(ai, ai)));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < block_y; i += blockDim.x) {
    const long long k = k0 + i;
    if (k >= ny) break;
    const int e = halo + i;
    float s = amps[e];
    for (int w = 1; w < win; ++w) s = __fadd_rn(s, amps[e - w]);
    float dr = ys_re[e];
    float di = ys_im[e];
    for (int w = 1; w < dcw; ++w) {
      dr = __fadd_rn(dr, ys_re[e - w]);
      di = __fadd_rn(di, ys_im[e - w]);
    }
    y2[k] = ys_re[e];
    y2[ny + k] = ys_im[e];
    amp[k] = amps[e];
    avgsum[k] = s;
    dcsum2[k] = dr;
    dcsum2[ny + k] = di;
  }
}

}  // namespace

// x2: (2, n) float32 planar, contiguous.  Outputs: y2 (2, ny), amp (ny),
// avgsum (ny), dcsum2 (2, ny) with ny = n / decim.  Returns a cudaError_t
// (0 on success); launches nothing when ny == 0.
extern "C" int gate_front_launch(const float* x2, long long n, int decim,
                                 int n_taps, int win, int dcw, int block_y,
                                 float* y2, float* amp, float* avgsum,
                                 float* dcsum2, void* stream) {
  const long long ny = n / decim;
  if (ny <= 0) return 0;
  if (decim < 1 || n_taps < 1 || win < 1 || dcw < 1 || block_y < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int halo = (win > dcw ? win : dcw) - 1;
  const long long ext = halo + block_y;
  const long long xlen = (ext - 1) * decim + n_taps;
  const size_t smem = static_cast<size_t>(2 * xlen + 3 * ext) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gate_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = (ny + block_y - 1) / block_y;
  gate_front_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x2, n, decim, n_taps, win, dcw, block_y, ny, y2, amp, avgsum, dcsum2);
  return static_cast<int>(cudaGetLastError());
}
