// probe: out = x * 2 + 1, elementwise on float32 -- a check that a
// hand-written kernel builds, launches and computes on this card.
//
// Replaces the Pallas TPU kernel of tools/tpu_gate_sums_experiment.py
// (`run`, kernel body `k`: o_ref[:] = x_ref[:] * 2.0 + 1.0), the JAX
// tool's hardware-execution probe on an (8, 128) float32 tile.
//
// Bound on an H100: launch latency.  The tool's tile is 4 KiB in and 4 KiB
// out, about 2.4 ns at 3.35 TB/s, three orders of magnitude under the few
// microseconds any launch costs.  Design: one thread per element, four
// elements a thread when the count allows it (16-byte loads and stores),
// grid-stride.  __fmul_rn and __fadd_rn keep the two roundings of the plain
// version (x * 2 is exact, so an FMA would round the same; the intrinsics
// just say so).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ x, long long n, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n4; i += stride) {
    float4 v = x4[i];
    v.x = __fadd_rn(__fmul_rn(v.x, 2.f), 1.f);
    v.y = __fadd_rn(__fmul_rn(v.y, 2.f), 1.f);
    v.z = __fadd_rn(__fmul_rn(v.z, 2.f), 1.f);
    v.w = __fadd_rn(__fmul_rn(v.w, 2.f), 1.f);
    o4[i] = v;
  }
  for (long long i = 4 * n4 + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    out[i] = __fadd_rn(__fmul_rn(x[i], 2.f), 1.f);
  }
}

}  // namespace

// x, out: n float32 values, contiguous, 16-byte aligned (as every PyTorch
// CUDA allocation is at offset 0).  Returns a cudaError_t (0 on success).
extern "C" int probe_launch(const float* x, long long n, float* out, void* stream) {
  if (n <= 0) return 0;
  const long long per_block = 4LL * kThreads;
  long long grid = (n + per_block - 1) / per_block;
  if (grid > 4096) grid = 4096;
  probe_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, n, out);
  return static_cast<int>(cudaGetLastError());
}
