// Fused FiLM-SIREN render + SDF volume integration for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cips3dpp_tpu/kernels/siren_render.py:_kernel
// (launched by siren_render_prepared). Per ray: normalised points -> two
// FiLM-SIREN layers sin(g*(x@W) + g*b + beta) -> sdf head; view layer with the
// per-ray view term split out -> rgb head; sigma = sigmoid(-sdf/beta)/beta,
// alpha, exclusive transmittance product, weights; outputs thumb, feat, xyz,
// [mask, depth], sdf. The plain PyTorch version is
// cips3dpp_torch/kernels/siren_render.py:siren_render_plain.
//
// What bounds it on the H100: operations. At the serving shape (4096 rays x
// 24 samples, width 256) the two (rows,256)@(256,256) products per sample are
// ~26 GFLOP in bf16 (>= 26 us at 989 TFLOP/s); the 75M polynomial sines are
// ~1.5 GFLOP of f32 on the CUDA cores (~22 us at 67 TFLOP/s); the I/O is ~7 MB.
//
// Design:
//  - A block owns 4 rays x 24 samples = 96 rows, ordered sample-major
//    (row = s*4 + ray), so a 16-row tensor-core tile holds 4 samples of all
//    4 rays and the two rows a thread's accumulators cover belong to one ray.
//  - Both 256x256 products run on the tensor cores with mma.sync m16n8k16
//    (bf16 inputs, f32 accumulation). 12 warps = 6 row tiles x 2 column
//    halves. The activation tile (96 x 256 bf16) stays in shared memory; the
//    weight, stored (out, in) = (n, k), is streamed through shared memory in
//    K-chunks of 32 (a 256x256 bf16 weight alone is 128 KB), so the block
//    needs ~113 KB. Row strides are padded by 8 bf16 so fragment loads hit 32
//    distinct banks.
//  - Layer 0 (K=3), the sdf/rgb heads (N=1, N=3) and the per-ray view term are
//    FMAs on the CUDA cores; the head dot products are reduced with warp
//    shuffles and shared-memory atomics (two addends per row: deterministic).
//  - Integration is a running product per ray (the TPU kernel's triangular
//    matmul only worked around Mosaic). The compositing weights depend only on
//    sdf and z, so they are computed after the trunk, and the view layer's
//    features are summed into per-ray sums as they come out of the second
//    product: the (rows, 256) per-sample features are never stored. Each of
//    the 6 row-tile warps writes its own partial sums (24 KB of shared memory
//    in all) and the 6 partials are added in a fixed order, so the outputs
//    are the same bit for bit from run to run.
//  - Same arithmetic as the TPU kernel: bias folded on the host as
//    beff = g*b + beta with the weights unfolded, the degree-9 range-reduced
//    polynomial sin, matmul inputs rounded to bf16, phase math and compositing
//    in f32 with products and sums kept separate (no contraction) where the
//    plain version has them separate.
//  - Rays past the end (R not a multiple of 4) read zeros and are not written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int W = 256;             // SIREN width
constexpr int S = 24;              // samples per ray
constexpr int TR = 4;              // rays per block
constexpr int M = TR * S;          // 96 rows per block
constexpr int MT = M / 16;         // 6 row tiles
constexpr int NWARPS = 2 * MT;     // 12 warps: (row tile, column half)
constexpr int NTHREADS = 32 * NWARPS;
constexpr int KC = 32;             // K chunk of the streamed weight
constexpr int ACT_LD = W + 8;      // padded activation row stride (bf16)
constexpr int WC_LD = KC + 8;      // padded weight-chunk row stride (bf16)
constexpr int NT = W / 2 / 8;      // 16 n-tiles of 8 per warp

constexpr float INV_2PI = 0.15915494309189535f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float SC0 = 0.9999727636431689f;
constexpr float SC1 = -0.16661501432840328f;
constexpr float SC2 = 0.008305441787505873f;
constexpr float SC3 = -0.00019215724206787978f;
constexpr float SC4 = 2.125150239026409e-06f;

struct __align__(16) Smem {
  __nv_bfloat16 act[M * ACT_LD];  // activation tile, bf16
  __nv_bfloat16 wc[W * WC_LD];    // weight K-chunk, (n, k)
  float w0[3 * W];                // layer-0 weight (k, n), bf16-rounded
  float g0[W], be0[W], g1[W], be1[W], gv[W];
  float wsdf[W];                  // bf16-rounded
  float wrgb[W * 3];              // (n, j), bf16-rounded
  float vphase[TR * W];           // per-ray view phase gv*vterm + bev
  float featp[MT * TR * W];        // per-ray weighted feature sums of each row tile
  float pts[M * 3];
  float z[M];
  float sdf[M];                   // sdf head sums (without bias)
  float wgt[M];                   // compositing weights
  float rgb[M * 3];               // rgb head sums (without bias)
  float dnorm[TR];
};

__device__ __forceinline__ float bfr(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a*b + c with the product and the sum rounded separately (as PyTorch does)
__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return __fadd_rn(__fmul_rn(a, b), c);
}

__device__ __forceinline__ float fast_sin(float x) {
  float k = rintf(__fmul_rn(x, INV_2PI));  // round half to even
  float r = __fsub_rn(x, __fmul_rn(k, TWO_PI));
  float r2 = __fmul_rn(r, r);
  float p = mul_add(r2, SC4, SC3);
  p = mul_add(r2, p, SC2);
  p = mul_add(r2, p, SC1);
  p = mul_add(r2, p, SC0);
  return __fmul_rn(r, p);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc = act (M x W, bf16) @ wt^T, wt (W x W) bf16 stored (n, k) in global
// memory; each warp accumulates its 16 rows x 128 columns.
__device__ __forceinline__ void gemm_act_w(Smem& sm, const __nv_bfloat16* __restrict__ wt,
                           float (&acc)[NT][4], int mt, int nh, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const __nv_bfloat16* arow0 = sm.act + (mt * 16 + g) * ACT_LD + 2 * t;
  const __nv_bfloat16* arow1 = arow0 + 8 * ACT_LD;
  for (int kc = 0; kc < W / KC; ++kc) {
    for (int i = threadIdx.x; i < W * (KC / 8); i += NTHREADS) {
      int n = i / (KC / 8), q = i % (KC / 8);
      *reinterpret_cast<uint4*>(sm.wc + n * WC_LD + q * 8) =
          *reinterpret_cast<const uint4*>(wt + n * W + kc * KC + q * 8);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int k = kc * KC + ks * 16;
      uint32_t a0 = ld32(arow0 + k), a1 = ld32(arow1 + k);
      uint32_t a2 = ld32(arow0 + k + 8), a3 = ld32(arow1 + k + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* b = sm.wc + (nh * 128 + j * 8 + g) * WC_LD + ks * 16 + 2 * t;
        mma_bf16(acc[j], a0, a1, a2, a3, ld32(b), ld32(b + 8));
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) siren_render_kernel(
    const float* __restrict__ pts, const float* __restrict__ viewdirs,
    const float* __restrict__ z_vals, const float* __restrict__ dnorm,
    const float* __restrict__ w0, const float* __restrict__ g0,
    const float* __restrict__ be0, const __nv_bfloat16* __restrict__ w1t,
    const float* __restrict__ g1, const float* __restrict__ be1,
    const __nv_bfloat16* __restrict__ wvht, const float* __restrict__ wvv,
    const float* __restrict__ gv, const float* __restrict__ bev,
    const float* __restrict__ wsdf, const float* __restrict__ bsdf,
    const float* __restrict__ wrgb, const float* __restrict__ brgb,
    float scale, float sbeta, float* __restrict__ thumb,
    float* __restrict__ feat, float* __restrict__ xyz,
    float* __restrict__ maskd, float* __restrict__ sdf_out, int n_rays) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % MT, nh = warp / MT;
  const int ray0 = blockIdx.x * TR;

  // ---- constants and per-ray inputs ----
  for (int i = tid; i < 3 * W; i += NTHREADS) {
    sm.w0[i] = bfr(w0[i]);
    sm.wrgb[i] = bfr(wrgb[i]);
  }
  for (int i = tid; i < W; i += NTHREADS) {
    sm.g0[i] = g0[i]; sm.be0[i] = be0[i];
    sm.g1[i] = g1[i]; sm.be1[i] = be1[i];
    sm.gv[i] = gv[i];
    sm.wsdf[i] = bfr(wsdf[i]);
  }
  for (int i = tid; i < M; i += NTHREADS) {
    const int s = i / TR, ray = ray0 + i % TR;
    const bool ok = ray < n_rays;
    for (int c = 0; c < 3; ++c)
      sm.pts[i * 3 + c] = ok ? pts[(size_t(ray) * S + s) * 3 + c] : 0.f;
    sm.z[i] = ok ? z_vals[size_t(ray) * S + s] : 0.f;
    sm.sdf[i] = 0.f;
    sm.rgb[i * 3] = sm.rgb[i * 3 + 1] = sm.rgb[i * 3 + 2] = 0.f;
  }
  for (int i = tid; i < TR * W; i += NTHREADS) {
    const int r = i / W, n = i % W, ray = ray0 + r;
    float vt = 0.f;
    if (ray < n_rays) {
      const float* v = viewdirs + size_t(ray) * 3;
      vt = __fadd_rn(__fadd_rn(__fmul_rn(bfr(v[0]), bfr(wvv[n])),
                               __fmul_rn(bfr(v[1]), bfr(wvv[W + n]))),
                     __fmul_rn(bfr(v[2]), bfr(wvv[2 * W + n])));
    }
    sm.vphase[i] = mul_add(gv[n], vt, bev[n]);
  }
  if (tid < TR) sm.dnorm[tid] = ray0 + tid < n_rays ? dnorm[ray0 + tid] : 0.f;
  __syncthreads();

  // ---- layer 0 (K = 3) on the CUDA cores ----
  for (int i = tid; i < M * (W / 2); i += NTHREADS) {
    const int row = i / (W / 2), n = (i % (W / 2)) * 2;
    const float x0 = bfr(__fmul_rn(sm.pts[row * 3], scale));
    const float x1 = bfr(__fmul_rn(sm.pts[row * 3 + 1], scale));
    const float x2 = bfr(__fmul_rn(sm.pts[row * 3 + 2], scale));
    float h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n + e;
      float lin = __fadd_rn(__fadd_rn(__fmul_rn(x0, sm.w0[c]), __fmul_rn(x1, sm.w0[W + c])),
                            __fmul_rn(x2, sm.w0[2 * W + c]));
      h[e] = fast_sin(mul_add(sm.g0[c], lin, sm.be0[c]));
    }
    *reinterpret_cast<__nv_bfloat162*>(sm.act + row * ACT_LD + n) =
        __floats2bfloat162_rn(h[0], h[1]);
  }
  __syncthreads();

  // ---- layer 1 on the tensor cores, then the sdf head ----
  float acc[NT][4];
  gemm_act_w(sm, w1t, acc, mt, nh, lane);  // ends with __syncthreads()
  {
    float ps0 = 0.f, ps1 = 0.f;
    const int r0 = mt * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = nh * 128 + j * 8 + 2 * t;
      float h00 = bfr(fast_sin(mul_add(sm.g1[c], acc[j][0], sm.be1[c])));
      float h01 = bfr(fast_sin(mul_add(sm.g1[c + 1], acc[j][1], sm.be1[c + 1])));
      float h10 = bfr(fast_sin(mul_add(sm.g1[c], acc[j][2], sm.be1[c])));
      float h11 = bfr(fast_sin(mul_add(sm.g1[c + 1], acc[j][3], sm.be1[c + 1])));
      *reinterpret_cast<__nv_bfloat162*>(sm.act + r0 * ACT_LD + c) = __floats2bfloat162_rn(h00, h01);
      *reinterpret_cast<__nv_bfloat162*>(sm.act + r1 * ACT_LD + c) = __floats2bfloat162_rn(h10, h11);
      ps0 += h00 * sm.wsdf[c] + h01 * sm.wsdf[c + 1];
      ps1 += h10 * sm.wsdf[c] + h11 * sm.wsdf[c + 1];
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    if (t == 0) {
      atomicAdd(&sm.sdf[r0], ps0);
      atomicAdd(&sm.sdf[r1], ps1);
    }
  }
  __syncthreads();

  // ---- integration: a running transmittance product per ray ----
  if (tid < TR) {
    const int ray = ray0 + tid;
    const float b = bsdf[0];
    float trans = 1.f, x = 0.f, y = 0.f, zz = 0.f, w = 0.f;
    for (int s = 0; s < S; ++s) {
      const int row = s * TR + tid;
      const float sd = __fadd_rn(sm.sdf[row], b);
      const float gap = s + 1 < S ? __fsub_rn(sm.z[row + TR], sm.z[row]) : 1e10f;
      const float dist = __fmul_rn(gap, sm.dnorm[tid]);
      const float sig = __fdiv_rn(__fdiv_rn(1.f, __fadd_rn(1.f, expf(__fdiv_rn(sd, sbeta)))), sbeta);
      const float alpha = __fsub_rn(1.f, expf(-__fmul_rn(sig, dist)));
      w = __fmul_rn(alpha, trans);
      trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
      sm.wgt[row] = w;
      x += w * sm.pts[row * 3];
      y += w * sm.pts[row * 3 + 1];
      zz += w * sm.pts[row * 3 + 2];
      if (ray < n_rays) sdf_out[size_t(ray) * S + s] = sd;
    }
    if (ray < n_rays) {
      xyz[size_t(ray) * 3] = x;
      xyz[size_t(ray) * 3 + 1] = y;
      xyz[size_t(ray) * 3 + 2] = zz;
      maskd[size_t(ray) * 2] = w;
      maskd[size_t(ray) * 2 + 1] = -sqrtf(x * x + y * y + zz * zz);
    }
  }
  __syncthreads();

  // ---- view layer on the tensor cores; features summed per ray ----
  gemm_act_w(sm, wvht, acc, mt, nh, lane);
  {
    const int r0 = mt * 16 + g, r1 = r0 + 8, ray = r0 % TR;  // r1 % TR == ray
    const float w0r = sm.wgt[r0], w1r = sm.wgt[r1];
    float pr0[3] = {0.f, 0.f, 0.f}, pr1[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = nh * 128 + j * 8 + 2 * t;
      const float* vp = sm.vphase + ray * W;
      float f00 = fast_sin(mul_add(sm.gv[c], acc[j][0], vp[c]));
      float f01 = fast_sin(mul_add(sm.gv[c + 1], acc[j][1], vp[c + 1]));
      float f10 = fast_sin(mul_add(sm.gv[c], acc[j][2], vp[c]));
      float f11 = fast_sin(mul_add(sm.gv[c + 1], acc[j][3], vp[c + 1]));
      float s0 = w0r * f00 + w1r * f10;
      float s1 = w0r * f01 + w1r * f11;
      s0 += __shfl_xor_sync(0xffffffffu, s0, 16);  // rows g and g+4: same ray
      s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
      if (lane < 16) {  // one writer for each (row tile, ray, column)
        sm.featp[(mt * TR + ray) * W + c] = s0;
        sm.featp[(mt * TR + ray) * W + c + 1] = s1;
      }
      const float b00 = bfr(f00), b01 = bfr(f01), b10 = bfr(f10), b11 = bfr(f11);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        pr0[q] += b00 * sm.wrgb[c * 3 + q] + b01 * sm.wrgb[(c + 1) * 3 + q];
        pr1[q] += b10 * sm.wrgb[c * 3 + q] + b11 * sm.wrgb[(c + 1) * 3 + q];
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      pr0[q] += __shfl_xor_sync(0xffffffffu, pr0[q], 1);
      pr0[q] += __shfl_xor_sync(0xffffffffu, pr0[q], 2);
      pr1[q] += __shfl_xor_sync(0xffffffffu, pr1[q], 1);
      pr1[q] += __shfl_xor_sync(0xffffffffu, pr1[q], 2);
      if (t == 0) {
        atomicAdd(&sm.rgb[r0 * 3 + q], pr0[q]);
        atomicAdd(&sm.rgb[r1 * 3 + q], pr1[q]);
      }
    }
  }
  __syncthreads();

  // ---- per-ray outputs ----
  if (tid < TR && ray0 + tid < n_rays) {
    float acc3[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < S; ++s) {
      const int row = s * TR + tid;
      for (int q = 0; q < 3; ++q) {
        const float v = __fadd_rn(sm.rgb[row * 3 + q], brgb[q]);
        acc3[q] += sm.wgt[row] * __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
      }
    }
    for (int q = 0; q < 3; ++q)
      thumb[size_t(ray0 + tid) * 3 + q] = -1.f + 2.f * acc3[q];
  }
  for (int i = tid; i < TR * W; i += NTHREADS) {
    const int ray = ray0 + i / W;
    float f = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) f += sm.featp[m * TR * W + i];
    if (ray < n_rays) feat[size_t(ray) * W + i % W] = f;
  }
}

}  // namespace

extern "C" int siren_render_forward(
    const float* pts, const float* viewdirs, const float* z_vals,
    const float* dnorm, const float* w0, const float* g0, const float* be0,
    const void* w1t, const float* g1, const float* be1, const void* wvht,
    const float* wvv, const float* gv, const float* bev, const float* wsdf,
    const float* bsdf, const float* wrgb, const float* brgb, float scale,
    float sigmoid_beta, float* thumb, float* feat, float* xyz, float* maskd,
    float* sdf, int n_rays, void* stream) {
  const int smem = int(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      siren_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const int blocks = (n_rays + TR - 1) / TR;
  siren_render_kernel<<<blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, viewdirs, z_vals, dnorm, w0, g0, be0,
      static_cast<const __nv_bfloat16*>(w1t), g1, be1,
      static_cast<const __nv_bfloat16*>(wvht), wvv, gv, bev, wsdf, bsdf, wrgb,
      brgb, scale, sigmoid_beta, thumb, feat, xyz, maskd, sdf, n_rays);
  return int(cudaGetLastError());
}
