// Fused CIPS-decoder upsample block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// cips3dpp_tpu/kernels/decoder_block.py:_packed_kernel (launched by
// decoder_block_packed). For y1 (F*Hp, Wp, C) bf16, conv_a's output at the
// previous resolution with F frames stacked on rows:
//   2x separable [1,3,3,1] upsample, taps (.25,.75,.75,.25), zero edges at
//   each frame's border (rows in f32, rounded to bf16 before the column blend)
//   -> + nw1*noise1 + b1 -> lrelu*sqrt2 -> bf16
//   -> 1x1 conv_b on the tensor cores (bf16 in, f32 accumulate)
//   -> + nw2*noise2 + b2 -> lrelu*sqrt2 -> feat (bf16, stored unless skipped)
//   -> rgb = feat @ wrgb (bf16 wrgb, f32 sum), ToRGB before bias and skip.
// The plain PyTorch version is
// cips3dpp_torch/kernels/decoder_block.py:decoder_block_plain.
//
// What bounds it on the H100: bytes. conv_b is ~2.1 GFLOP per block at the
// serving shapes, while y1 + noise + feat + rgb are 11-46 MB per block
// (~113 MB a frame, ~34 us at 3.35 TB/s).
//
// Design:
//  - A block is persistent: it loads the C x C conv_b weight (stored (out, in))
//    into shared memory once and walks output tiles of 2 rows x 32 columns
//    (64 pixels), the 2x upsample of one input row segment of 16 pixels. The
//    one-row halo above and below and the one-column halo left and right come
//    from y1 directly (L2-resident), zero at image and frame edges.
//  - The TPU layouts (lane packing, kron-expanded weights, column-upsample
//    matrices, the RGBx store) are gone: pixels and channels are indexed
//    directly, conv_b is a (64, C) @ (C, C) mma.sync m16n8k16 product by 8
//    warps, ToRGB is 3 dot products over C per pixel in the epilogue, rgb is
//    stored planar (pixels, 3) in f32, feat as bf16 rows of 16-byte stores.
//  - Rounding points are those of the serving path: y1 and the noise maps
//    bf16, the row-upsampled values rounded to bf16 before the column blend,
//    conv_b inputs bf16, feat stored bf16 and ToRGB reading that stored feat.
//    Elementwise f32 math keeps products and sums separate, as the plain
//    version has them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;   // 8 warps
constexpr int TW_IN = 16;       // input columns per tile
constexpr int TW = 2 * TW_IN;   // 32 output columns per tile
constexpr int TM = 2 * TW;      // 64 output pixels per tile (2 rows)
constexpr float SQRT2 = 1.4142135623730951f;

template <int C>
struct __align__(16) Smem {
  static constexpr int LD = C + 8;         // padded row stride (bf16)
  __nv_bfloat16 w2t[C * LD];               // conv_b weight (n, k)
  __nv_bfloat16 act[TM * LD];              // activation / feat tile
  __nv_bfloat16 xs[2 * (TW_IN + 2) * C];   // row-upsampled y1, bf16
  float b1[C], b2[C];
  float wrgb[3 * C];                       // (j, k), bf16-rounded
};

__device__ __forceinline__ float lrelu(float v) {
  return __fmul_rn(v >= 0.f ? v : __fmul_rn(v, 0.2f), SQRT2);
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

template <int C>
__global__ void __launch_bounds__(NTHREADS) decoder_block_kernel(
    const __nv_bfloat16* __restrict__ y1, const __nv_bfloat16* __restrict__ n1,
    const __nv_bfloat16* __restrict__ n2, const __nv_bfloat16* __restrict__ w2t,
    const float* __restrict__ b1, const float* __restrict__ b2,
    const float* __restrict__ nw, const __nv_bfloat16* __restrict__ wrgbt,
    __nv_bfloat16* __restrict__ feat, float* __restrict__ rgb, int frames,
    int hp, int wp) {
  using S = Smem<C>;
  constexpr int LD = S::LD;
  constexpr int NT = C / 16;  // n-tiles of 8 per warp (each warp: C/2 columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, nh = warp >> 2;

  for (int i = tid; i < C * (C / 8); i += NTHREADS) {
    const int n = i / (C / 8), q = i % (C / 8);
    *reinterpret_cast<uint4*>(sm.w2t + n * LD + q * 8) =
        *reinterpret_cast<const uint4*>(w2t + n * C + q * 8);
  }
  for (int i = tid; i < C; i += NTHREADS) {
    sm.b1[i] = b1[i];
    sm.b2[i] = b2[i];
  }
  if (wrgbt != nullptr)
    for (int i = tid; i < 3 * C; i += NTHREADS) sm.wrgb[i] = __bfloat162float(wrgbt[i]);
  const float nw1 = nw[0], nw2 = nw[1];
  const int wo = 2 * wp;                  // output width
  const int segs = wp / TW_IN;
  const int n_tiles = frames * hp * segs;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r = tile / segs;             // input row, frames stacked
    const int c0 = (tile % segs) * TW_IN;  // first input column
    const int rf = r % hp;                 // row within its frame
    __syncthreads();  // previous tile done with xs/act (and weights loaded)

    // row upsample of input columns c0-1 .. c0+16 (f32), rounded to bf16
    for (int i = tid; i < 2 * (TW_IN + 2) * (C / 2); i += NTHREADS) {
      const int ch = (i % (C / 2)) * 2;
      const int j = (i / (C / 2)) % (TW_IN + 2);
      const int par = i / ((C / 2) * (TW_IN + 2));
      const int ic = c0 - 1 + j;
      float v0 = 0.f, v1 = 0.f;
      if (ic >= 0 && ic < wp) {
        const size_t base = (size_t(r) * wp + ic) * C + ch;
        const float2 yc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y1 + base));
        float2 ynb = make_float2(0.f, 0.f);
        const bool has_nb = par == 0 ? rf > 0 : rf < hp - 1;
        if (has_nb) {
          const size_t nb = par == 0 ? base - size_t(wp) * C : base + size_t(wp) * C;
          ynb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y1 + nb));
        }
        // even output row: .25*y[r-1] + .75*y[r]; odd: .75*y[r] + .25*y[r+1]
        const float kn = 0.25f, kc = 0.75f;
        v0 = par == 0 ? __fadd_rn(__fmul_rn(kn, ynb.x), __fmul_rn(kc, yc.x))
                      : __fadd_rn(__fmul_rn(kc, yc.x), __fmul_rn(kn, ynb.x));
        v1 = par == 0 ? __fadd_rn(__fmul_rn(kn, ynb.y), __fmul_rn(kc, yc.y))
                      : __fadd_rn(__fmul_rn(kc, yc.y), __fmul_rn(kn, ynb.y));
      }
      *reinterpret_cast<__nv_bfloat162*>(sm.xs + (par * (TW_IN + 2) + j) * C + ch) =
          __floats2bfloat162_rn(v0, v1);
    }
    __syncthreads();

    // column upsample + noise1 + b1 + lrelu -> bf16 activation tile
    for (int i = tid; i < TM * (C / 2); i += NTHREADS) {
      const int ch = (i % (C / 2)) * 2;
      const int p = i / (C / 2);
      const int par = p / TW, oc = p % TW;
      const int j = oc / 2 + 1;
      const __nv_bfloat16* xr = sm.xs + par * (TW_IN + 2) * C + ch;
      const float2 xc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + j * C));
      const float2 xn = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xr + (oc & 1 ? j + 1 : j - 1) * C));
      float u0, u1;
      if (oc & 1) {
        u0 = __fadd_rn(__fmul_rn(0.75f, xc.x), __fmul_rn(0.25f, xn.x));
        u1 = __fadd_rn(__fmul_rn(0.75f, xc.y), __fmul_rn(0.25f, xn.y));
      } else {
        u0 = __fadd_rn(__fmul_rn(0.25f, xn.x), __fmul_rn(0.75f, xc.x));
        u1 = __fadd_rn(__fmul_rn(0.25f, xn.y), __fmul_rn(0.75f, xc.y));
      }
      const float nz = __bfloat162float(n1[size_t(2 * rf + par) * wo + 2 * c0 + oc]);
      const float nzw = __fmul_rn(nw1, nz);
      const float h0 = lrelu(__fadd_rn(__fadd_rn(u0, nzw), sm.b1[ch]));
      const float h1 = lrelu(__fadd_rn(__fadd_rn(u1, nzw), sm.b1[ch + 1]));
      *reinterpret_cast<__nv_bfloat162*>(sm.act + p * LD + ch) = __floats2bfloat162_rn(h0, h1);
    }
    __syncthreads();

    // conv_b: (64, C) @ (C, C); warp = (16-row tile, column half)
    float acc[NT][4];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
    const __nv_bfloat16* arow0 = sm.act + (mt * 16 + g) * LD + 2 * t;
    const __nv_bfloat16* arow1 = arow0 + 8 * LD;
#pragma unroll 4
    for (int k = 0; k < C; k += 16) {
      const uint32_t a0 = ld32(arow0 + k), a1 = ld32(arow1 + k);
      const uint32_t a2 = ld32(arow0 + k + 8), a3 = ld32(arow1 + k + 8);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const __nv_bfloat16* b = sm.w2t + (nh * (C / 2) + jn * 8 + g) * LD + k + 2 * t;
        mma_bf16(acc[jn], a0, a1, a2, a3, ld32(b), ld32(b + 8));
      }
    }
    __syncthreads();  // every warp is done reading act

    // noise2 + b2 + lrelu -> bf16 feat, written back into act
    {
      const int p0 = mt * 16 + g, p1 = p0 + 8;
      const int orow0 = 2 * rf + p0 / TW, orow1 = 2 * rf + p1 / TW;
      const float nz0 = __fmul_rn(nw2, __bfloat162float(n2[size_t(orow0) * wo + 2 * c0 + p0 % TW]));
      const float nz1 = __fmul_rn(nw2, __bfloat162float(n2[size_t(orow1) * wo + 2 * c0 + p1 % TW]));
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int ch = nh * (C / 2) + jn * 8 + 2 * t;
        const float v00 = lrelu(__fadd_rn(__fadd_rn(acc[jn][0], nz0), sm.b2[ch]));
        const float v01 = lrelu(__fadd_rn(__fadd_rn(acc[jn][1], nz0), sm.b2[ch + 1]));
        const float v10 = lrelu(__fadd_rn(__fadd_rn(acc[jn][2], nz1), sm.b2[ch]));
        const float v11 = lrelu(__fadd_rn(__fadd_rn(acc[jn][3], nz1), sm.b2[ch + 1]));
        *reinterpret_cast<__nv_bfloat162*>(sm.act + p0 * LD + ch) = __floats2bfloat162_rn(v00, v01);
        *reinterpret_cast<__nv_bfloat162*>(sm.act + p1 * LD + ch) = __floats2bfloat162_rn(v10, v11);
      }
    }
    __syncthreads();

    const size_t out_px0 = size_t(2 * r) * wo + 2 * c0;  // first pixel, row 0
    if (feat != nullptr) {
      for (int i = tid; i < TM * (C / 8); i += NTHREADS) {
        const int p = i / (C / 8), q = i % (C / 8);
        const size_t px = out_px0 + size_t(p / TW) * wo + p % TW;
        *reinterpret_cast<uint4*>(feat + px * C + q * 8) =
            *reinterpret_cast<const uint4*>(sm.act + p * LD + q * 8);
      }
    }
    if (rgb != nullptr) {
      // 4 threads per pixel, each a quarter of the channels
      const int p = tid >> 2, part = tid & 3;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int ch = part * (C / 4); ch < (part + 1) * (C / 4); ++ch) {
        const float f = __bfloat162float(sm.act[p * LD + ch]);
        s0 += f * sm.wrgb[ch];
        s1 += f * sm.wrgb[C + ch];
        s2 += f * sm.wrgb[2 * C + ch];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (part == 0) {
        const size_t px = out_px0 + size_t(p / TW) * wo + p % TW;
        rgb[px * 3] = s0;
        rgb[px * 3 + 1] = s1;
        rgb[px * 3 + 2] = s2;
      }
    }
  }
}

template <int C>
int launch(const void* y1, const void* n1, const void* n2, const void* w2t,
           const float* b1, const float* b2, const float* nw, const void* wrgbt,
           void* feat, float* rgb, int frames, int hp, int wp,
           cudaStream_t stream) {
  auto kernel = decoder_block_kernel<C>;
  const int smem = int(sizeof(Smem<C>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem)) !=
      cudaSuccess)
    return int(err);
  const int n_tiles = frames * hp * (wp / TW_IN);
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_tiles) blocks = n_tiles;
  kernel<<<blocks, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(y1), static_cast<const __nv_bfloat16*>(n1),
      static_cast<const __nv_bfloat16*>(n2), static_cast<const __nv_bfloat16*>(w2t),
      b1, b2, nw, static_cast<const __nv_bfloat16*>(wrgbt),
      static_cast<__nv_bfloat16*>(feat), rgb, frames, hp, wp);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int decoder_block_forward(
    const void* y1, const void* n1, const void* n2, const void* w2t,
    const float* b1, const float* b2, const float* nw, const void* wrgbt,
    void* feat, float* rgb, int frames, int hp, int wp, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wp % TW_IN != 0 || frames < 1 || hp < 1) return int(cudaErrorInvalidValue);
  switch (c) {
    case 32: return launch<32>(y1, n1, n2, w2t, b1, b2, nw, wrgbt, feat, rgb, frames, hp, wp, s);
    case 64: return launch<64>(y1, n1, n2, w2t, b1, b2, nw, wrgbt, feat, rgb, frames, hp, wp, s);
    case 128: return launch<128>(y1, n1, n2, w2t, b1, b2, nw, wrgbt, feat, rgb, frames, hp, wp, s);
    case 256: return launch<256>(y1, n1, n2, w2t, b1, b2, nw, wrgbt, feat, rgb, frames, hp, wp, s);
    default: return int(cudaErrorInvalidValue);
  }
}
