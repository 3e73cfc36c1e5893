// P1, the elementwise dtype probe for Hopper (sm_90a): replaces the Pallas
// TPU probe tools/vpu_dtype_probe.py:make.<locals>.call. It runs the decoder
// block's post-matmul chain, 12 times x = lrelu(x + s*n + b) (max form,
// lrelu(v) = max(v, 0.2 v) * sqrt2), over one array, once in f32 and once in
// bf16, to ask whether native bf16 arithmetic is faster than f32 here.
//
// The bf16 variant runs packed bf16x2 instructions (add.rn/mul.rn.bf16x2 in
// PTX, max through __hmax2), two values a register; the f32 variant scalar
// f32. Every product and sum is rounded on its own (explicit .rn / __f*_rn:
// no FMA contraction) in the order (x + s*n) + b, with the constants rounded
// to the dtype first, so the kernel matches the plain PyTorch chain
// (cips3dpp_torch/tools/elem_dtype_probe.py:elem_chain_plain) bit for bit.
//
// Bound: bytes. Each element is read twice (x, n) and written once: 12 bytes
// in f32, 6 in bf16, against 72 operations; 6 operations a byte is far below
// the card's ~20 f32 operations per byte of HBM bandwidth. Each thread takes
// 16 bytes of each array per step (float4, or 8 bf16), grid-stride.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int REPS = 12;
constexpr int NTHREADS = 256;

__device__ __forceinline__ float chain_f32(float x, float n) {
  const float s = 0.31f, b = 0.013f, slope = 0.2f, sqrt2 = 1.4142135623730951f;
#pragma unroll
  for (int i = 0; i < REPS; ++i) {
    const float v = __fadd_rn(__fadd_rn(x, __fmul_rn(s, n)), b);
    x = __fmul_rn(fmaxf(v, __fmul_rn(slope, v)), sqrt2);
  }
  return x;
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t splat(float v) {
  const __nv_bfloat162 r = __float2bfloat162_rn(v);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t chain_bf16x2(uint32_t x, uint32_t n) {
  const uint32_t s = splat(0.31f), b = splat(0.013f), slope = splat(0.2f),
                 sqrt2 = splat(1.4142135623730951f);
#pragma unroll
  for (int i = 0; i < REPS; ++i) {
    const uint32_t v = add2(add2(x, mul2(s, n)), b);
    x = mul2(max2(v, mul2(slope, v)), sqrt2);
  }
  return x;
}

__global__ void __launch_bounds__(NTHREADS) probe_f32(const float4* __restrict__ x,
                                                      const float4* __restrict__ n,
                                                      float4* __restrict__ out,
                                                      long long count4) {
  for (long long i = blockIdx.x * (long long)NTHREADS + threadIdx.x; i < count4;
       i += (long long)gridDim.x * NTHREADS) {
    const float4 a = x[i], m = n[i];
    out[i] = make_float4(chain_f32(a.x, m.x), chain_f32(a.y, m.y), chain_f32(a.z, m.z),
                         chain_f32(a.w, m.w));
  }
}

__global__ void __launch_bounds__(NTHREADS) probe_bf16(const uint4* __restrict__ x,
                                                       const uint4* __restrict__ n,
                                                       uint4* __restrict__ out,
                                                       long long count8) {
  for (long long i = blockIdx.x * (long long)NTHREADS + threadIdx.x; i < count8;
       i += (long long)gridDim.x * NTHREADS) {
    const uint4 a = x[i], m = n[i];
    out[i] = make_uint4(chain_bf16x2(a.x, m.x), chain_bf16x2(a.y, m.y),
                        chain_bf16x2(a.z, m.z), chain_bf16x2(a.w, m.w));
  }
}

int grid_for(long long items) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (items + NTHREADS - 1) / NTHREADS;
  const long long cap = 8LL * (sms > 0 ? sms : 132);
  return int(blocks < cap ? blocks : cap);
}

}  // namespace

// count: elements, a multiple of 4 (f32) or 8 (bf16); 16-byte aligned arrays
extern "C" int elem_probe_forward(const void* x, const void* n, void* out,
                                  long long count, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count <= 0) return int(cudaErrorInvalidValue);
  if (bf16) {
    if (count % 8) return int(cudaErrorInvalidValue);
    const long long items = count / 8;
    probe_bf16<<<grid_for(items), NTHREADS, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(n),
        static_cast<uint4*>(out), items);
  } else {
    if (count % 4) return int(cudaErrorInvalidValue);
    const long long items = count / 4;
    probe_f32<<<grid_for(items), NTHREADS, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const float4*>(n),
        static_cast<float4*>(out), items);
  }
  return int(cudaGetLastError());
}
