// The fused CIPS-decoder upsample block for Hopper (sm_90a), with two entry
// points at the end of this file:
//   - decoder_block_forward (K2): replaces the Pallas TPU kernel
//     cips3dpp_tpu/kernels/decoder_block.py:_packed_kernel, the serving block
//     with bf16 or f32 storage, noise from buffers or hashed in the kernel,
//     F frames stacked on rows and an optional ToRGB fold;
//   - decoder_block_fused_forward (K3): replaces _block_kernel (the v1 block,
//     f32 in and out), which adds the ToRGB bias and the upsampled RGB skip;
//     the row halo the TPU kernel took from three host-side row-shifted
//     copies is read from y1 and skip in the kernel.
// Wrappers: decoder_block_packed and decoder_block_fused in
// cips3dpp_torch/kernels/decoder_block.py.
//
// For y1 (F*Hp, Wp, C), conv_a's output at the previous resolution:
//   2x separable [1,3,3,1] upsample, taps (.25,.75,.75,.25), zero edges at
//   each frame's border -> + nw1*noise1 + b1 -> lrelu*sqrt2 -> bf16
//   -> 1x1 conv_b on the tensor cores (bf16 in, f32 accumulate)
//   -> + nw2*noise2 + b2 -> lrelu*sqrt2 -> feat (stored unless skipped)
//   -> rgb = feat @ wrgb [+ brgb + up2(skip) in K3].
// The plain PyTorch versions are decoder_block_plain and
// decoder_block_fused_plain in cips3dpp_torch/kernels/decoder_block.py.
//
// What bounds it on the H100: bytes. conv_b is ~2.1 GFLOP per block at the
// serving shapes, while y1 + noise + feat + rgb are 11-46 MB per block in
// bf16 (~113 MB a frame, ~34 us at 3.35 TB/s), twice that in f32.
//
// Design:
//  - A block is persistent: it loads the C x C conv_b weight (stored (out, in),
//    bf16) into shared memory once and walks output tiles of 2 rows x 32
//    columns (64 pixels), the 2x upsample of one input row segment of 16
//    pixels. The one-row halo above and below and the one-column halo left and
//    right come from y1 directly (L2-resident), zero at image and frame edges.
//  - The tile's 64 noise values of each map are staged in shared memory first:
//    read from the buffers, or made by the hash generator (hash_normal below,
//    the counterpart of decoder_block.py:hash_normal), once per pixel and not
//    once per channel.
//  - conv_b is a (64, C) @ (C, C) mma.sync m16n8k16 product by 8 warps.
//  - Storage T = bf16: the row-upsampled values are rounded to bf16 before the
//    column blend, feat is rounded to bf16 into shared memory and stored in
//    16-byte rows, and ToRGB reads that stored feat. T = float: no rounding
//    between the row and column passes (the staging tile is f32, so shared
//    memory grows by 18 KB at C=256, to 208 KB), feat is stored in f32 straight
//    from the accumulators, and ToRGB is summed from the accumulators: each
//    thread its channels, then the 4 lanes of a row by shuffles, then the two
//    column halves through shared memory, in a fixed order.
//  - RGB_BF16 (K3): ToRGB multiplies bf16(feat) by the bf16 wrgb; the epilogue
//    adds brgb and the 2x-upsampled skip, computed per pixel in f32 from its
//    4 neighbours (the TPU kernel's host-side row-shifted copies are gone).
//  - Elementwise f32 math keeps products and sums separate, as the plain
//    version has them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace dblock {

constexpr int NTHREADS = 256;   // 8 warps
constexpr int TW_IN = 16;       // input columns per tile
constexpr int TW = 2 * TW_IN;   // 32 output columns per tile
constexpr int TM = 2 * TW;      // 64 output pixels per tile (2 rows)
constexpr float SQRT2 = 1.4142135623730951f;

struct Params {
  const void* y1;        // (F*Hp, Wp, C) T
  const void* n1;        // (2Hp, 2Wp) T, buffer mode
  const void* n2;
  const __nv_bfloat16* w2t;  // (C out, C in)
  const float* b1;       // (C,)
  const float* b2;
  const float* nw;       // (2,) noise weights
  const void* wrgbt;     // (3, C) T (K2) or bf16 (K3), or null: no rgb
  const float* skip;     // (Hp, Wp, 3) K3 only
  const float* brgb;     // (3,) K3 only
  void* feat;            // (2F*Hp, 2Wp, C) T, or null: not stored
  float* rgb;            // (2F*Hp, 2Wp, 3)
  int frames, hp, wp;
  uint32_t seed1, seed2; // hash mode
};

template <int C, typename T>
struct __align__(16) Smem {
  static constexpr int LD = C + 8;         // padded row stride (bf16)
  __nv_bfloat16 w2t[C * LD];               // conv_b weight (n, k)
  __nv_bfloat16 act[TM * LD];              // activation tile (and bf16 feat)
  T xs[2 * (TW_IN + 2) * C];               // row-upsampled y1
  float b1[C], b2[C];
  float wrgb[3 * C];                       // (j, k)
  float nz1[TM], nz2[TM];                  // the tile's noise
  float rgbp[2 * TM * 3];                  // ToRGB partials of the column halves
};

__device__ __forceinline__ float lrelu(float v) {
  return __fmul_rn(v >= 0.f ? v : __fmul_rn(v, 0.2f), SQRT2);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- hash noise (decoder_block.py:_hash_u32, _fast_sin, hash_normal) ----

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// degree-9 odd polynomial sin, round-half-even range reduction (jnp.round)
__device__ __forceinline__ float fast_sin(float x) {
  const float k = rintf(__fmul_rn(x, 0.15915494309189535f));
  const float r = __fsub_rn(x, __fmul_rn(k, 6.283185307179586f));
  const float r2 = __fmul_rn(r, r);
  float p = __fmul_rn(r2, 2.125150239026409e-06f);
  p = __fmul_rn(r2, __fadd_rn(-0.00019215724206787978f, p));
  p = __fmul_rn(r2, __fadd_rn(0.008305441787505873f, p));
  p = __fmul_rn(r2, __fadd_rn(-0.16661501432840328f, p));
  return __fmul_rn(r, __fadd_rn(0.9999727636431689f, p));
}

// N(0,1) from a uint32 pixel id and seed: Box-Muller over two avalanche
// hashes, 24-bit uniforms through int32 as on the TPU
__device__ __forceinline__ float hash_normal(uint32_t pix, uint32_t seed) {
  const uint32_t h1 = hash_u32(pix ^ seed);
  const uint32_t h2 = hash_u32(pix + 0x9E3779B9u + seed * 0x85EBCA6Bu);
  const float u1 = __fadd_rn(__fmul_rn(float(int32_t(h1 >> 8)), 1.0f / 16777216.0f),
                             1.0f / 33554432.0f);
  const float u2 = __fmul_rn(float(int32_t(h2 >> 8)), 1.0f / 16777216.0f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, fast_sin(__fadd_rn(__fmul_rn(6.283185307179586f, u2),
                                         1.5707963267948966f)));
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

// The 2x-upsampled skip at output pixel (oy, ox): rows then columns in f32,
// zero outside the (hp, wp) image.
__device__ __forceinline__ float skip_up(const float* skip, int hp, int wp, int oy,
                                         int ox, int j) {
  const int iy = oy >> 1, ix = ox >> 1;
  const bool odd_y = oy & 1, odd_x = ox & 1;
  auto at = [&](int y, int x) -> float {
    return (y >= 0 && y < hp && x >= 0 && x < wp) ? skip[(size_t(y) * wp + x) * 3 + j] : 0.f;
  };
  auto row = [&](int x) -> float {
    if (x < 0 || x >= wp) return 0.f;
    return odd_y ? __fadd_rn(__fmul_rn(0.75f, at(iy, x)), __fmul_rn(0.25f, at(iy + 1, x)))
                 : __fadd_rn(__fmul_rn(0.25f, at(iy - 1, x)), __fmul_rn(0.75f, at(iy, x)));
  };
  return odd_x ? __fadd_rn(__fmul_rn(0.75f, row(ix)), __fmul_rn(0.25f, row(ix + 1)))
               : __fadd_rn(__fmul_rn(0.25f, row(ix - 1)), __fmul_rn(0.75f, row(ix)));
}

// T: storage of y1, buffer noise and feat. HASH: noise made in the kernel.
// RGB_BF16: K3 (bf16 ToRGB operands, bias and skip epilogue; T = float).
template <int C, typename T, bool HASH, bool RGB_BF16>
__global__ void __launch_bounds__(NTHREADS) block_kernel(const Params P) {
  using S = Smem<C, T>;
  using WT = typename std::conditional<RGB_BF16, __nv_bfloat16, T>::type;
  constexpr int LD = S::LD;
  constexpr int NT = C / 16;  // n-tiles of 8 per warp (each warp: C/2 columns)
  constexpr bool F32 = std::is_same<T, float>::value;
  static_assert(F32 || !RGB_BF16, "K3 stores f32");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const T* __restrict__ y1 = static_cast<const T*>(P.y1);
  const WT* __restrict__ wrgbt = static_cast<const WT*>(P.wrgbt);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, nh = warp >> 2;
  const int hp = P.hp, wp = P.wp;

  for (int i = tid; i < C * (C / 8); i += NTHREADS) {
    const int n = i / (C / 8), q = i % (C / 8);
    *reinterpret_cast<uint4*>(sm.w2t + n * LD + q * 8) =
        *reinterpret_cast<const uint4*>(P.w2t + n * C + q * 8);
  }
  for (int i = tid; i < C; i += NTHREADS) {
    sm.b1[i] = P.b1[i];
    sm.b2[i] = P.b2[i];
  }
  if (wrgbt != nullptr)
    for (int i = tid; i < 3 * C; i += NTHREADS) sm.wrgb[i] = to_f(wrgbt[i]);
  const float nw1 = P.nw[0], nw2 = P.nw[1];
  const int wo = 2 * wp;                  // output width
  const int segs = wp / TW_IN;
  const int n_tiles = P.frames * hp * segs;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r = tile / segs;             // input row, frames stacked
    const int c0 = (tile % segs) * TW_IN;  // first input column
    const int rf = r % hp;                 // row within its frame
    __syncthreads();  // previous tile done with smem (and weights loaded)

    // the tile's noise: pixel ids are per frame (every frame reuses one map)
    if (tid < 2 * TM) {
      const int second = tid >= TM, p = tid % TM;
      const int orow = 2 * rf + p / TW, ocol = 2 * c0 + p % TW;
      float v;
      if constexpr (HASH) {
        v = hash_normal(uint32_t(orow) * uint32_t(wo) + uint32_t(ocol),
                        second ? P.seed2 : P.seed1);
      } else {
        const T* nb = static_cast<const T*>(second ? P.n2 : P.n1);
        v = to_f(nb[size_t(orow) * wo + ocol]);
      }
      (second ? sm.nz2 : sm.nz1)[p] = v;
    }

    // row upsample of input columns c0-1 .. c0+16 (f32), stored as T
    for (int i = tid; i < 2 * (TW_IN + 2) * (C / 2); i += NTHREADS) {
      const int ch = (i % (C / 2)) * 2;
      const int j = (i / (C / 2)) % (TW_IN + 2);
      const int par = i / ((C / 2) * (TW_IN + 2));
      const int ic = c0 - 1 + j;
      float v0 = 0.f, v1 = 0.f;
      if (ic >= 0 && ic < wp) {
        const size_t base = (size_t(r) * wp + ic) * C + ch;
        const float2 yc = load2(y1 + base);
        float2 ynb = make_float2(0.f, 0.f);
        const bool has_nb = par == 0 ? rf > 0 : rf < hp - 1;
        if (has_nb) ynb = load2(y1 + (par == 0 ? base - size_t(wp) * C : base + size_t(wp) * C));
        // even output row: .25*y[r-1] + .75*y[r]; odd: .75*y[r] + .25*y[r+1]
        const float kn = 0.25f, kc = 0.75f;
        v0 = par == 0 ? __fadd_rn(__fmul_rn(kn, ynb.x), __fmul_rn(kc, yc.x))
                      : __fadd_rn(__fmul_rn(kc, yc.x), __fmul_rn(kn, ynb.x));
        v1 = par == 0 ? __fadd_rn(__fmul_rn(kn, ynb.y), __fmul_rn(kc, yc.y))
                      : __fadd_rn(__fmul_rn(kc, yc.y), __fmul_rn(kn, ynb.y));
      }
      store2(sm.xs + (par * (TW_IN + 2) + j) * C + ch, v0, v1);
    }
    __syncthreads();

    // column upsample + noise1 + b1 + lrelu -> bf16 activation tile
    for (int i = tid; i < TM * (C / 2); i += NTHREADS) {
      const int ch = (i % (C / 2)) * 2;
      const int p = i / (C / 2);
      const int par = p / TW, oc = p % TW;
      const int j = oc / 2 + 1;
      const T* xr = sm.xs + par * (TW_IN + 2) * C + ch;
      const float2 xc = load2(xr + j * C);
      const float2 xn = load2(xr + (oc & 1 ? j + 1 : j - 1) * C);
      float u0, u1;
      if (oc & 1) {
        u0 = __fadd_rn(__fmul_rn(0.75f, xc.x), __fmul_rn(0.25f, xn.x));
        u1 = __fadd_rn(__fmul_rn(0.75f, xc.y), __fmul_rn(0.25f, xn.y));
      } else {
        u0 = __fadd_rn(__fmul_rn(0.25f, xn.x), __fmul_rn(0.75f, xc.x));
        u1 = __fadd_rn(__fmul_rn(0.25f, xn.y), __fmul_rn(0.75f, xc.y));
      }
      const float nzw = __fmul_rn(nw1, sm.nz1[p]);
      const float h0 = lrelu(__fadd_rn(__fadd_rn(u0, nzw), sm.b1[ch]));
      const float h1 = lrelu(__fadd_rn(__fadd_rn(u1, nzw), sm.b1[ch + 1]));
      store2(sm.act + p * LD + ch, h0, h1);
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

    const int p0 = mt * 16 + g, p1 = p0 + 8;
    const float nz0 = __fmul_rn(nw2, sm.nz2[p0]);
    const float nz1 = __fmul_rn(nw2, sm.nz2[p1]);
    const size_t out_px0 = size_t(2 * r) * wo + 2 * c0;  // first pixel, row 0
    const size_t px0 = out_px0 + size_t(p0 / TW) * wo + p0 % TW;
    const size_t px1 = out_px0 + size_t(p1 / TW) * wo + p1 % TW;

    if constexpr (!F32) {
      // noise2 + b2 + lrelu -> bf16 feat, written back into act
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int ch = nh * (C / 2) + jn * 8 + 2 * t;
        const float v00 = lrelu(__fadd_rn(__fadd_rn(acc[jn][0], nz0), sm.b2[ch]));
        const float v01 = lrelu(__fadd_rn(__fadd_rn(acc[jn][1], nz0), sm.b2[ch + 1]));
        const float v10 = lrelu(__fadd_rn(__fadd_rn(acc[jn][2], nz1), sm.b2[ch]));
        const float v11 = lrelu(__fadd_rn(__fadd_rn(acc[jn][3], nz1), sm.b2[ch + 1]));
        store2(sm.act + p0 * LD + ch, v00, v01);
        store2(sm.act + p1 * LD + ch, v10, v11);
      }
      __syncthreads();

      T* feat = static_cast<T*>(P.feat);
      if (feat != nullptr) {
        for (int i = tid; i < TM * (C / 8); i += NTHREADS) {
          const int p = i / (C / 8), q = i % (C / 8);
          const size_t px = out_px0 + size_t(p / TW) * wo + p % TW;
          *reinterpret_cast<uint4*>(feat + px * C + q * 8) =
              *reinterpret_cast<const uint4*>(sm.act + p * LD + q * 8);
        }
      }
      if (P.rgb != nullptr) {
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
          P.rgb[px * 3] = s0;
          P.rgb[px * 3 + 1] = s1;
          P.rgb[px * 3 + 2] = s2;
        }
      }
    } else {
      // noise2 + b2 + lrelu in registers -> f32 feat; ToRGB partial sums
      float* feat = static_cast<float*>(P.feat);
      float s0[3] = {0.f, 0.f, 0.f}, s1[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int ch = nh * (C / 2) + jn * 8 + 2 * t;
        const float v00 = lrelu(__fadd_rn(__fadd_rn(acc[jn][0], nz0), sm.b2[ch]));
        const float v01 = lrelu(__fadd_rn(__fadd_rn(acc[jn][1], nz0), sm.b2[ch + 1]));
        const float v10 = lrelu(__fadd_rn(__fadd_rn(acc[jn][2], nz1), sm.b2[ch]));
        const float v11 = lrelu(__fadd_rn(__fadd_rn(acc[jn][3], nz1), sm.b2[ch + 1]));
        if (feat != nullptr) {
          store2(feat + px0 * C + ch, v00, v01);
          store2(feat + px1 * C + ch, v10, v11);
        }
        const float a00 = RGB_BF16 ? bf16r(v00) : v00, a01 = RGB_BF16 ? bf16r(v01) : v01;
        const float a10 = RGB_BF16 ? bf16r(v10) : v10, a11 = RGB_BF16 ? bf16r(v11) : v11;
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          const float w0 = sm.wrgb[jj * C + ch], w1 = sm.wrgb[jj * C + ch + 1];
          s0[jj] += a00 * w0 + a01 * w1;
          s1[jj] += a10 * w0 + a11 * w1;
        }
      }
      if (P.rgb != nullptr) {
#pragma unroll
        for (int jj = 0; jj < 3; ++jj)
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            s0[jj] += __shfl_xor_sync(0xffffffffu, s0[jj], o);
            s1[jj] += __shfl_xor_sync(0xffffffffu, s1[jj], o);
          }
        if (t == 0)
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            sm.rgbp[(nh * TM + p0) * 3 + jj] = s0[jj];
            sm.rgbp[(nh * TM + p1) * 3 + jj] = s1[jj];
          }
        __syncthreads();
        if (tid < TM) {
          const int p = tid;
          const size_t px = out_px0 + size_t(p / TW) * wo + p % TW;
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            float v = __fadd_rn(sm.rgbp[p * 3 + jj], sm.rgbp[(TM + p) * 3 + jj]);
            if constexpr (RGB_BF16)
              v = __fadd_rn(__fadd_rn(v, P.brgb[jj]),
                            skip_up(P.skip, hp, wp, 2 * rf + p / TW, 2 * c0 + p % TW, jj));
            P.rgb[px * 3 + jj] = v;
          }
        }
      }
    }
  }
}

template <int C, typename T, bool HASH, bool RGB_BF16>
int launch(const Params& P, cudaStream_t stream) {
  auto kernel = block_kernel<C, T, HASH, RGB_BF16>;
  const int smem = int(sizeof(Smem<C, T>));
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
  const int n_tiles = P.frames * P.hp * (P.wp / TW_IN);
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_tiles) blocks = n_tiles;
  kernel<<<blocks, NTHREADS, smem, stream>>>(P);
  return int(cudaGetLastError());
}

template <typename T, bool HASH, bool RGB_BF16>
int launch_c(int c, const Params& P, cudaStream_t s) {
  if (P.wp % TW_IN != 0 || P.frames < 1 || P.hp < 1) return int(cudaErrorInvalidValue);
  switch (c) {
    case 32: return launch<32, T, HASH, RGB_BF16>(P, s);
    case 64: return launch<64, T, HASH, RGB_BF16>(P, s);
    case 128: return launch<128, T, HASH, RGB_BF16>(P, s);
    case 256: return launch<256, T, HASH, RGB_BF16>(P, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace dblock

extern "C" int decoder_block_forward(
    const void* y1, const void* n1, const void* n2, const void* w2t,
    const float* b1, const float* b2, const float* nw, const void* wrgbt,
    void* feat, float* rgb, int frames, int hp, int wp, int c, int f32_storage,
    int hash, unsigned int seed1, unsigned int seed2, void* stream) {
  using namespace dblock;
  Params P{y1, n1, n2, static_cast<const __nv_bfloat16*>(w2t), b1, b2, nw, wrgbt,
           nullptr, nullptr, feat, rgb, frames, hp, wp, seed1, seed2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32_storage)
    return hash ? launch_c<float, true, false>(c, P, s) : launch_c<float, false, false>(c, P, s);
  return hash ? launch_c<__nv_bfloat16, true, false>(c, P, s)
              : launch_c<__nv_bfloat16, false, false>(c, P, s);
}

extern "C" int decoder_block_fused_forward(
    const float* y1, const float* skip, const float* n1, const float* n2,
    const void* w2t, const float* b1, const float* b2, const float* nw,
    const void* wrgbt, const float* brgb, float* feat, float* rgb, int hp, int wp,
    int c, void* stream) {
  using namespace dblock;
  Params P{y1, n1, n2, static_cast<const __nv_bfloat16*>(w2t), b1, b2, nw, wrgbt,
           skip, brgb, feat, rgb, 1, hp, wp, 0u, 0u};
  return launch_c<float, false, true>(c, P, static_cast<cudaStream_t>(stream));
}
