// gate_front: fused gate front end on one pass over planar ADC-rate I/Q.
// Two builds: the full one here (compat mode and the exact gate), and the
// y build further down (gate_front_y: y alone, every path that reads only
// y).
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
// product is contracted into an FMA; sqrt is the IEEE __fsqrt_rn.  No sum is
// kept running with a subtraction: that would change the rounding, and compat
// mode and the exact gate threshold on avgsum.
//
// Bound on an H100: memory.  The function reads 8 bytes per ADC sample and
// writes 24 bytes per output sample; at N = 9.7 M that is 77.6 MB in and
// 46.6 MB out, about 37 us at 3.35 TB/s.  Summing each output's windows
// from shared memory, one ld.shared per add, takes about 250 shared loads
// per output, 60-70 us of shared-memory issue at the bench shape, so this
// kernel blocks the sums in registers, and it overlaps its loads with its
// adds:
//
// * The outputs are cut into tiles of block_y.  One wave of blocks (as many
//   as fit on the card) walks them, tile blockIdx.x, then + gridDim.x, ...
//   A tile's x slab (its outputs plus a halo of max(W,D)-1 y samples,
//   (ext-1)*decim + T ADC samples a plane) lands in shared memory by
//   cp.async, 4 bytes a lane, so that xs[u] = x[x0 + u] whatever x0's
//   alignment and every later shared load is a 16-byte one; samples outside
//   the capture are zero-filled (zero history).  Two buffers: the block
//   issues the next tile's copies, then sums this one.
// * Each thread computes R = 4 consecutive y: it walks the union of their
//   tap spans once, (R-1)*decim + T values instead of R*T, and adds each
//   value to the accumulators r whose tap index j = u - r*decim lies in
//   [0, T), in increasing j.  The y stay
//   in registers until the block is done with the slab and are then written
//   over it, so a buffer takes the larger of the two, not their sum.
// * Each thread then sums R consecutive outputs' windows.  At step w,
//   accumulator r adds amp[k0 + r - w]; the R values a step needs are a
//   register window that shifts by one a step, so R outputs take W + R + 3
//   loads (four at a time) instead of R*W.  The same for both dcsum planes.
// * Stores are 16-byte, one a thread per output array.
// * ReaderConfig's defaults (decim 5, T 25, W 100, D 48) compile with every
//   loop bound a constant: no add is predicated, and the window loops unroll
//   so that the shifting register window costs no moves.
//
// Shared loads per output fall from about 250 (4 bytes each) to about 18
// (16 bytes each) at R = 4.  What is left is the W + 2D - 3 adds per output
// that the fixed order needs, the tap adds, the halo's re-read and
// recompute ((max(W,D)-1) / block_y of the y work), each block's first
// slab, which nothing overlaps, and the last round of tiles, which only
// some blocks have (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int R = 4;        // consecutive outputs a thread (8 ran slower on the H100)
// Passes of the y loop a thread makes at most: 3 for ReaderConfig's defaults
// and the widths up to 8 Msps; 6 for a halo of up to 3,999 y (W 4000, 16
// Msps at decim 1) at a tile of 924.
constexpr int kPassesFew = 3;
constexpr int kPassesMany = 6;

// Shared-memory layout of one tile's buffer, in floats.
struct Shape {
  int halo;   // y lookback of the sums
  int ext;    // staged y samples: halo + block_y
  int ngr;    // groups of R staged y samples
  int span4;  // tap span of a group, rounded up to 4
  int xcap;   // staged x samples per plane
  int off;    // offset of staged y index 0, chosen so window loads are aligned
  int ycap;   // floats per staged y plane
};

__host__ __device__ inline Shape shape(int decim, int n_taps, int win, int dcw,
                                       int block_y) {
  Shape s;
  s.halo = (win > dcw ? win : dcw) - 1;
  s.ext = s.halo + block_y;
  s.ngr = (s.ext + R - 1) / R;
  s.span4 = ((R - 1) * decim + n_taps + 3) / 4 * 4;
  s.xcap = (s.ngr - 1) * R * decim + s.span4;      // a multiple of 4
  // off + halo = 3 (mod 4) puts each thread's first window load on 16
  // bytes; off >= 4 keeps the last (partly unused) load in the array.
  s.off = 4 + ((3 - s.halo) % 4 + 4) % 4;
  s.ycap = (s.off + s.ngr * R + 4 + 3) / 4 * 4;
  return s;
}

// One buffer holds a tile's x slab, then its y (written over the slab once
// every thread has its y in registers).  A multiple of 4 floats.
__host__ __device__ inline int buffer_floats(const Shape& s) {
  const int xs = 2 * s.xcap;
  const int ys = 3 * s.ycap;
  return xs > ys ? xs : ys;
}

// Two buffers: the next tile's slab lands in one while the block sums the
// other.
__host__ __device__ inline size_t smem_bytes(const Shape& s) {
  return 2 * static_cast<size_t>(buffer_floats(s)) * sizeof(float);
}

// The y passes a tile needs: kPassesFew, kPassesMany, or 0 if it needs more.
__host__ __device__ inline int passes(const Shape& s) {
  return s.ngr <= kPassesFew * kThreads ? kPassesFew
         : s.ngr <= kPassesMany * kThreads ? kPassesMany : 0;
}

// acc[r] = a[e0+r] + a[e0+r-1] + ... + a[e0+r-W+1], added in that order;
// first[r] = a[e0+r].  a + e0 - 3 is 16-byte aligned (Shape::off).
__device__ __forceinline__ void window_sums(const float* __restrict__ a, int e0, int W,
                                            float (&acc)[R], float (&first)[R]) {
  float v[R + 4];                  // v[m] = a[e0 - wb - 3 + m] in chunk wb
#pragma unroll
  for (int q = 0; q < (R + 4) / 4; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(a + e0 - 3 + 4 * q);
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) first[r] = acc[r] = v[r + 3];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (k < W) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], v[r - k + 3]);
    }
  }
#pragma unroll
  for (int wb = 4; wb < W; wb += 4) {
#pragma unroll
    for (int m = R + 3; m >= 4; --m) v[m] = v[m - 4];
    const float4 f = *reinterpret_cast<const float4*>(a + e0 - wb - 3);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    if (wb + 3 < W) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], v[r - k + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (wb + k < W) {
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = __fadd_rn(acc[r], v[r - k + 3]);
        }
      }
    }
  }
}

// dst[k..k+N) = v, 16 bytes a store where vec and the N outputs are all in
// [0, ny); the outputs past ny are dropped.
template <int N>
__device__ __forceinline__ void store(float* __restrict__ dst, long long k, long long ny,
                                      const float (&v)[N], bool vec) {
  if (vec && k + N <= ny) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      *reinterpret_cast<float4*>(dst + k + 4 * q) =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (k + r < ny) dst[k + r] = v[r];
  }
}

// 4 bytes from global to shared without the registers; src_bytes 0 writes 0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Issue the copies of one tile's x slab (both planes) into buf by the
// kBlock threads of a block: buf[u] = x_re[x0 + u], buf[xcap + u] =
// x_im[x0 + u], 0 outside [0, n).
template <int kBlock = kThreads>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ xre,
                                      const float* __restrict__ xim, long long x0,
                                      long long n, int xcap) {
  for (int u = threadIdx.x; u < xcap; u += kBlock) {
    const long long g = x0 + u;
    const bool in = g >= 0 && g < n;
    const long long gs = in ? g : 0;
    cp_async4(buf + u, xre + gs, in ? 4 : 0);
    cp_async4(buf + xcap + u, xim + gs, in ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// kDecim, kTaps, kWin, kDc: compile-time decim, T, W and D, or 0 to read
// the runtime values; kPasses: the y passes a thread makes at most.
template <int kDecim, int kTaps, int kWin, int kDc, int kPasses>
__global__ void __launch_bounds__(kThreads)
gate_front_kernel(const float* __restrict__ x2, long long n, int decim_rt, int taps_rt,
                  int win_rt, int dcw_rt, int block_y, long long ny, long long ntiles,
                  float* __restrict__ y2, float* __restrict__ amp,
                  float* __restrict__ avgsum, float* __restrict__ dcsum2) {
  extern __shared__ __align__(16) float smem[];
  const int decim = kDecim ? kDecim : decim_rt;
  const int n_taps = kTaps ? kTaps : taps_rt;
  const int win = kWin ? kWin : win_rt;
  const int dcw = kDc ? kDc : dcw_rt;
  const Shape s = shape(decim, n_taps, win, dcw, block_y);
  const int buf_floats = buffer_floats(s);
  const float* xre = x2;
  const float* xim = x2 + n;
  const bool vec1 = (ny & 3) == 0;                 // plane-1 outputs on 16 bytes

  long long tile = blockIdx.x;
  if (tile < ntiles)
    stage(smem, xre, xim, (tile * block_y - s.halo) * decim - (n_taps - 1), n, s.xcap);
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    float* buf = smem + (it & 1) * buf_floats;
    float* xs_re = buf;
    float* xs_im = buf + s.xcap;
    float* ys_re = buf + s.off;                    // staged y index e at ys_re[e]
    float* ys_im = ys_re + s.ycap;
    float* amps = ys_im + s.ycap;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // Every copy of this tile has landed, and every thread is done with the
    // other buffer (the last tile's sums): the next tile may go there.
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < ntiles)
      stage(smem + ((it + 1) & 1) * buf_floats, xre, xim,
            (next * block_y - s.halo) * decim - (n_taps - 1), n, s.xcap);
    const long long k0 = tile * block_y;

    // y of R consecutive staged samples a thread, kept in registers until
    // every thread is done with the x slab, then written over it.
    float yr[kPasses][R];
    float yi[kPasses][R];
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int q = threadIdx.x + pass * kThreads;
      if (q >= s.ngr) break;
      const float* pr = xs_re + q * R * decim;
      const float* pi = xs_im + q * R * decim;
#pragma unroll
      for (int r = 0; r < R; ++r) yr[pass][r] = yi[pass][r] = 0.f;
#pragma unroll
      for (int u4 = 0; u4 < s.span4; u4 += 4) {
        const float4 fr = *reinterpret_cast<const float4*>(pr + u4);
        const float4 fi = *reinterpret_cast<const float4*>(pi + u4);
        const float vr[4] = {fr.x, fr.y, fr.z, fr.w};
        const float vi[4] = {fi.x, fi.y, fi.z, fi.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int j = u4 + t - r * decim;
            if (j >= 0 && j < n_taps) {
              yr[pass][r] = __fadd_rn(yr[pass][r], vr[t]);
              yi[pass][r] = __fadd_rn(yi[pass][r], vi[t]);
            }
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int q = threadIdx.x + pass * kThreads;
      if (q >= s.ngr) break;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = q * R + r;
        const float ar = yr[pass][r];
        const float ai = yi[pass][r];
        ys_re[e] = ar;
        ys_im[e] = ai;
        amps[e] = __fsqrt_rn(__fadd_rn(__fmul_rn(ar, ar), __fmul_rn(ai, ai)));
      }
    }
    __syncthreads();

    for (int i0 = threadIdx.x * R; i0 < block_y; i0 += kThreads * R) {
      const long long k = k0 + i0;
      if (k >= ny) break;
      const int e0 = s.halo + i0;
      float acc[R];
      float first[R];
      window_sums(amps, e0, win, acc, first);
      store(amp, k, ny, first, true);
      store(avgsum, k, ny, acc, true);
      window_sums(ys_re, e0, dcw, acc, first);
      store(y2, k, ny, first, true);
      store(dcsum2, k, ny, acc, true);
      window_sums(ys_im, e0, dcw, acc, first);
      store(y2 + ny, k, ny, first, vec1);
      store(dcsum2 + ny, k, ny, acc, vec1);
    }
  }
}

// The grid of one wave of persistent blocks of ``kernel`` (as many as fit on
// the card at ``threads`` a block and ``smem`` bytes of shared memory a
// block), at most ntiles.
template <typename Kernel>
cudaError_t wave_grid(Kernel kernel, int threads, size_t smem, long long ntiles,
                      unsigned* grid) {
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                            smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long wave = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<unsigned>(ntiles < wave ? ntiles : wave);
  return cudaSuccess;
}

template <int kDecim, int kTaps, int kWin, int kDc, int kPasses>
int launch(const float* x2, long long n, int decim, int n_taps, int win, int dcw,
           int block_y, long long ny, float* y2, float* amp, float* avgsum,
           float* dcsum2, cudaStream_t stream) {
  const Shape shp = shape(decim, n_taps, win, dcw, block_y);
  if (shp.ngr > kPasses * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(shp);
  auto* kernel = gate_front_kernel<kDecim, kTaps, kWin, kDc, kPasses>;
  const long long ntiles = (ny + block_y - 1) / block_y;
  unsigned grid = 0;
  const cudaError_t err = wave_grid(kernel, kThreads, smem, ntiles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      x2, n, decim, n_taps, win, dcw, block_y, ny, ntiles, y2, amp, avgsum, dcsum2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory one block takes (two buffers), or -1 when block_y
// is too large (the y of a slab and its halo must fit kPassesMany passes of
// the block's threads); the wrapper checks it against the card's limit.
extern "C" long long gate_front_smem_bytes(int decim, int n_taps, int win, int dcw,
                                           int block_y) {
  const Shape s = shape(decim, n_taps, win, dcw, block_y);
  return passes(s) ? static_cast<long long>(smem_bytes(s)) : -1;
}

// x2: (2, n) float32 planar, contiguous.  Outputs: y2 (2, ny), amp (ny),
// avgsum (ny), dcsum2 (2, ny) with ny = n / decim, each 16-byte aligned.
// block_y: outputs per tile, a multiple of 4.  Returns a cudaError_t (0 on
// success); launches nothing when ny == 0.
extern "C" int gate_front_launch(const float* x2, long long n, int decim,
                                 int n_taps, int win, int dcw, int block_y,
                                 float* y2, float* amp, float* avgsum,
                                 float* dcsum2, void* stream) {
  const long long ny = n / decim;
  if (ny <= 0) return 0;
  if (decim < 1 || n_taps < 1 || win < 1 || dcw < 1 || block_y < 1 || block_y % R != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ReaderConfig's defaults compile with every loop bound a constant; other
  // widths take the runtime-bound build with as many y passes as the tile
  // and its halo need.
  const bool few = passes(shape(decim, n_taps, win, dcw, block_y)) == kPassesFew;
  if (few && decim == 5 && n_taps == 25 && win == 100 && dcw == 48)
    return launch<5, 25, 100, 48, kPassesFew>(x2, n, decim, n_taps, win, dcw, block_y, ny, y2,
                                              amp, avgsum, dcsum2, s);
  if (few)
    return launch<0, 0, 0, 0, kPassesFew>(x2, n, decim, n_taps, win, dcw, block_y, ny, y2, amp,
                                          avgsum, dcsum2, s);
  return launch<0, 0, 0, 0, kPassesMany>(x2, n, decim, n_taps, win, dcw, block_y, ny, y2, amp,
                                         avgsum, dcsum2, s);
}

// ===========================================================================
// gate_front_y: y alone, for the callers that read nothing else.
//
// Every native decode (FM0 and Miller, every rate), the MRC decode, the
// EPC-window recovery, the live reader's native windows, the stream's chunks
// and the native shards read only y: the gate-stack kernel makes its own
// |y| and dyadic average.  For them this kernel replaces the full build
// above, whose window sums (W + 2D adds an output in their fixed order) and
// window halo (max(W, D) - 1 y recomputed a tile) they threw away.  It is
// what the JAX package's default path computes there
// (gen2_rfid_tpu/dsp/filters.py::matched_filter_decimate); on the TPU the
// Pallas kernel gen2_rfid_tpu/kernels/gate_front.py::gate_front computes it
// as the first of its four outputs.  For k < Ny = N / decim:
//
//   y[k] = sum_{j<T} x[k*decim - (T-1) + j]   zero history, j = 0..T-1
//
// in the full build's order, so its y is bit-equal to the full build's and
// to kernels/gate_front.py::gate_front_y_plain's.
//
// Bound on an H100: 8 bytes a sample in and 8 a y out against 2T adds a y.
// ReaderConfig's widths (decim 5, T 25) and the Miller widths move bytes
// (0.028 ms at the bench shape); at 8 and 16 Msps, decim 1, T 100 and 200,
// the adds bound it.  A float add issues at 128 a clock an SM, half the 67
// TFLOP/s that counts an FMA as two operations, so an add-bound shape
// reaches at most half of its bound.
//
// * The halo is the taps' alone: a tile of block_y outputs reads
//   (block_y - 1)*decim + T samples a plane.  One wave of persistent blocks
//   walks the tiles; a tile's slab lands in shared memory by the full
//   build's 4-byte cp.async (stage(): any alignment of x2, zero fill
//   outside the capture), in two buffers, so the block issues the next
//   tile's copies and then sums this one.
// * A thread sums RY = 8 consecutive y: one walk of their union span,
//   (RY-1)*decim + T values a plane, 16 bytes a shared load, with RY
//   independent add chains a plane.  The walk is three loops: the span's
//   middle, where every chain takes all four values of a load
//   ((RY-1)*decim <= u and u + 3 < T), adds with no test; only its head
//   and tail test the tap index.
// * A block is 128 threads, one group of 8 outputs each at the default
//   tile of 1024: small blocks keep every thread busy and let more blocks
//   share an SM, so that the last round of tiles, which only some blocks
//   have, is a smaller share of an add-bound shape's time.
// * ReaderConfig's widths compile with decim and T constant: the walk
//   unrolls whole and every test folds away.
// * Stores are 16-byte, two a plane a thread (plane 1 when Ny % 4 == 0).

namespace {

constexpr int RY = 8;            // consecutive y a thread sums
constexpr int kYThreads = 128;   // a block of the y build

struct YShape {
  int span4;  // tap span of a thread's RY outputs, rounded up to 4
  int xcap;   // staged x samples per plane
};

__host__ __device__ inline YShape y_shape(int decim, int n_taps, int block_y) {
  YShape s;
  s.span4 = ((RY - 1) * decim + n_taps + 3) / 4 * 4;
  s.xcap = (block_y / RY - 1) * RY * decim + s.span4;  // a multiple of 4
  return s;
}

// Two buffers of two planes.
__host__ __device__ inline size_t y_smem_bytes(const YShape& s) {
  return 4 * static_cast<size_t>(s.xcap) * sizeof(float);
}

// Staged values u..u+3 (u a multiple of 4) of both planes.
__device__ __forceinline__ void load4(const float* xs_re, const float* xs_im, int u,
                                      float (&vr)[4], float (&vi)[4]) {
  const float4 fr = *reinterpret_cast<const float4*>(xs_re + u);
  const float4 fi = *reinterpret_cast<const float4*>(xs_im + u);
  vr[0] = fr.x; vr[1] = fr.y; vr[2] = fr.z; vr[3] = fr.w;
  vi[0] = fi.x; vi[1] = fi.y; vi[2] = fi.z; vi[3] = fi.w;
}

// Values u4..u4+3 of a thread's span into every accumulator.
__device__ __forceinline__ void add_all(const float (&vr)[4], const float (&vi)[4],
                                        float (&yr)[RY], float (&yi)[RY]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      yr[r] = __fadd_rn(yr[r], vr[t]);
      yi[r] = __fadd_rn(yi[r], vi[t]);
    }
  }
}

// Values u4..u4+3 of a thread's span into the accumulators r whose tap
// index u - r*decim lies in [0, T).
__device__ __forceinline__ void add_tested(int u4, int decim, int n_taps, const float (&vr)[4],
                                           const float (&vi)[4], float (&yr)[RY],
                                           float (&yi)[RY]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      if (static_cast<unsigned>(u4 + t - r * decim) < static_cast<unsigned>(n_taps)) {
        yr[r] = __fadd_rn(yr[r], vr[t]);
        yi[r] = __fadd_rn(yi[r], vi[t]);
      }
    }
  }
}

// kDecim, kTaps: compile-time decim and T, or 0 to read the runtime values.
template <int kDecim, int kTaps>
__global__ void __launch_bounds__(kYThreads)
gate_front_y_kernel(const float* __restrict__ x2, long long n, int decim_rt, int taps_rt,
                    int block_y, long long ny, long long ntiles, float* __restrict__ y2) {
  extern __shared__ __align__(16) float smem[];
  const int decim = kDecim ? kDecim : decim_rt;
  const int n_taps = kTaps ? kTaps : taps_rt;
  const YShape s = y_shape(decim, n_taps, block_y);
  const int ngr = block_y / RY;
  const float* xre = x2;
  const float* xim = x2 + n;
  const bool vec1 = (ny & 3) == 0;  // plane-1 outputs on 16 bytes
  // The loads u4 whose four values every accumulator takes, (RY-1)*decim
  // <= u4 and u4 + 3 < T, are [m0, m1); the walk's ends test the tap index.
  const int m0 = min(((RY - 1) * decim + 3) & ~3, s.span4);
  const int m1 = max(m0, min(n_taps & ~3, s.span4));

  long long tile = blockIdx.x;
  if (tile < ntiles)
    stage<kYThreads>(smem, xre, xim, tile * block_y * decim - (n_taps - 1), n, s.xcap);
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const float* xs_re = smem + (it & 1) * 2 * s.xcap;
    const float* xs_im = xs_re + s.xcap;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // Every copy of this tile has landed, and every thread is done with the
    // other buffer: the next tile may go there.
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < ntiles)
      stage<kYThreads>(smem + ((it + 1) & 1) * 2 * s.xcap, xre, xim,
                       next * block_y * decim - (n_taps - 1), n, s.xcap);
    const long long k0 = tile * block_y;
    for (int q = threadIdx.x; q < ngr; q += kYThreads) {
      const long long k = k0 + static_cast<long long>(q) * RY;
      if (k >= ny) break;
      const int base = q * RY * decim;
      float yr[RY];
      float yi[RY];
#pragma unroll
      for (int r = 0; r < RY; ++r) yr[r] = yi[r] = 0.f;
      // Value u of the span goes to accumulator r when its tap index
      // j = u - r*decim lies in [0, T); each accumulator takes its values
      // in increasing u, so in increasing j.
      float vr[4];
      float vi[4];
      int u4 = 0;
#pragma unroll
      for (; u4 < m0; u4 += 4) {
        load4(xs_re, xs_im, base + u4, vr, vi);
        add_tested(u4, decim, n_taps, vr, vi, yr, yi);
      }
#pragma unroll (kTaps ? 64 : 4)
      for (; u4 < m1; u4 += 4) {
        load4(xs_re, xs_im, base + u4, vr, vi);
        add_all(vr, vi, yr, yi);
      }
#pragma unroll
      for (; u4 < s.span4; u4 += 4) {
        load4(xs_re, xs_im, base + u4, vr, vi);
        add_tested(u4, decim, n_taps, vr, vi, yr, yi);
      }
      store(y2, k, ny, yr, true);
      store(y2 + ny, k, ny, yi, vec1);
    }
  }
}

template <int kDecim, int kTaps>
int launch_y(const float* x2, long long n, int decim, int n_taps, int block_y, long long ny,
             float* y2, cudaStream_t stream) {
  const size_t smem = y_smem_bytes(y_shape(decim, n_taps, block_y));
  auto* kernel = gate_front_y_kernel<kDecim, kTaps>;
  const long long ntiles = (ny + block_y - 1) / block_y;
  unsigned grid = 0;
  const cudaError_t err = wave_grid(kernel, kYThreads, smem, ntiles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kYThreads, smem, stream>>>(x2, n, decim, n_taps, block_y, ny, ntiles, y2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory one block of the y build takes (two buffers); the
// wrapper checks it against the card's limit.
extern "C" long long gate_front_y_smem_bytes(int decim, int n_taps, int block_y) {
  return static_cast<long long>(y_smem_bytes(y_shape(decim, n_taps, block_y)));
}

// x2: (2, n) float32 planar, contiguous.  Output: y2 (2, ny), ny = n / decim,
// 16-byte aligned.  block_y: outputs per tile, a multiple of RY.  Returns a
// cudaError_t (0 on success); launches nothing when ny == 0.
extern "C" int gate_front_y_launch(const float* x2, long long n, int decim, int n_taps,
                                   int block_y, float* y2, void* stream) {
  if (decim < 1 || n_taps < 1 || block_y < RY || block_y % RY != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ny = n / decim;
  if (ny <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ReaderConfig's widths compile with every loop bound a constant.
  if (decim == 5 && n_taps == 25)
    return launch_y<5, 25>(x2, n, decim, n_taps, block_y, ny, y2, s);
  return launch_y<0, 0>(x2, n, decim, n_taps, block_y, ny, y2, s);
}
