// The fused CIPS-decoder upsample block for Hopper (sm_90a), with three entry
// points at the end of this file:
//   - decoder_block_forward (K2): replaces the Pallas TPU kernel
//     cips3dpp_tpu/kernels/decoder_block.py:_packed_kernel, the serving block
//     with bf16 or f32 storage, noise from buffers or hashed in the kernel,
//     F frames stacked on rows and an optional ToRGB fold, at C = 16, 32,
//     64, 128, 256 (block_kernel) and 192 and every multiple of 64 from 320
//     up (block_kernel_wide); the wrapper zero-pads every other C JAX's
//     kernel admits up to the next of these (weights, biases and y1's
//     extra channels zero: exact but for f32 summation order), and Wp up
//     to a multiple of 16 (zero columns: the upsample's zero edge), with
//     hash noise counting pixel ids in the caller's width (hash_wo);
//   - decoder_block_fused_forward (K3): replaces _block_kernel (the v1 block,
//     f32 in and out, the same channel counts), which adds the ToRGB bias
//     and the upsampled RGB skip;
//     the row halo the TPU kernel took from three host-side row-shifted
//     copies is read from y1 and skip in the kernel;
//   - decoder_block_info: shared memory, blocks an SM, registers, local
//     memory and tile width of one instantiation (nothing is launched).
// There is no ceiling on C: device memory alone limits it.
// Wrappers: decoder_block_packed, decoder_block_fused and decoder_block_info
// in cips3dpp_torch/kernels/decoder_block.py.
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
// What bounds it on the H100: bytes and the f32 pipe, by shape. Every output
// value takes ~10.25 f32 instructions at the plain version's rounding points
// (row and column blends, noise and bias adds, two lrelus: decoder_block_work
// counts them) plus 3 ToRGB FMAs, while conv_b is ~2.1 GFLOP a block on the
// tensor cores. At the r1024 serving shapes in bf16 the bytes (y1, noise,
// feat, rgb: ~113 MB a frame) bound the 128^2-512^2 blocks; at the 1024^2
// block, which stores no feat, the f32 work is the larger. So the design
// keeps memory streaming while the f32 pipe works, and spends as few f32
// instructions as the rounding points allow: .25*a is exact, so a blend is a
// multiply and a fused multiply-add, and the .75 product is shared by the
// two outputs that take the same centre.
//
// Design:
//  - A block is persistent (grid = SMs x blocks an SM) and walks tiles of one
//    input row x TW_IN = 2048 / C input columns: 2 output rows x 2*TW_IN
//    columns, TM = 8192 / C output pixels, so a tile holds 8192 values at
//    every C (32 pixels at C=256 up to 256 at C=32). The 128^2 block (C=256)
//    gets 512 tiles for 132 SMs. The ragged last tile of a row (Wp not a
//    multiple of TW_IN) reads zeros and writes nothing past the row's end.
//  - Staging: each tile's y1 rows (r-1, r, r+1; columns c0-1 .. c0+TW_IN, zero
//    outside the frame) and its noise row segments go into a 2-slot ring in
//    shared memory by 16-byte cp.async copies (zero-filled where out of
//    range), one tile ahead: the next tile's bytes fly while this tile
//    upsamples, multiplies and stores. Hash noise for the next tile is made
//    at the same point, once per pixel. The C x C conv_b weight (stored (out,
//    in), bf16) is loaded once a block, in the first tile's copy group.
//  - Upsample: each thread takes 4 channels x 2 adjacent input columns, row-
//    blends the 4 staged columns they need (rounded to the storage type), and
//    column-blends them into 8 output pixels; + noise1 + b1 + lrelu -> bf16
//    activation tile.
//  - conv_b: (TM, C) @ (C, C) by mma.sync m16n8k16 with ldmatrix fragments.
//    8 warps = MW pixel groups x NW column groups: at C <= 64 a warp owns all
//    C output columns (NW = 1); at C = 128 / 256 a warp tile is 32 pixels x
//    32 columns (NW = 4 / 8).
//  - Epilogue in registers in every mode: noise2 + b2 + lrelu on the
//    accumulators, rounded to bf16 in registers where the storage is bf16,
//    ToRGB from the rounded values times wrgb (rounded to the storage type;
//    bf16 in K3), summed over a thread's channels, then over the 4 lanes of a
//    row by shuffles. f32 feat goes out as 16-byte stores after one shuffle
//    between lane pairs; bf16 feat through a warp-private slice of shared
//    memory (__syncwarp, no block barrier) as 16-byte rows. ToRGB's column-
//    group partials (NW of them, 1 at C <= 64) wait in shared memory and are
//    summed in a fixed order and stored as runs of float4 over the tile's
//    output rows after the next tile's first barrier (bias and upsampled skip
//    added in K3).
//  - Two block barriers a tile: one after the tile's copies land (the ring
//    slot is full; every warp is done with the last tile), one after the
//    activation tile is written.
//  - Elementwise f32 math rounds where the plain version rounds; every sum
//    is in a fixed order, so two launches on the same inputs give the same
//    bits.
//  - Built with -DDBLOCK_PHASE_CLOCKS, every warp also counts its clock
//    cycles by phase of a tile (PHASE_MARK below); the plain build has no
//    trace of it.
//  - C = 16 to 256 take this template (block_kernel). At C = 16 a tile is
//    one row x 128 input columns (512 output pixels) and conv_b is one
//    k-step. C = 320 and up (the 64^2 to 256^2 blocks of decoders at
//    channel multipliers 3 and up) have a kernel of their own,
//    block_kernel_wide below: their weight cannot stay in shared memory;
//    past C = 2048 its staged build keeps not even the activation tile
//    there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace dblock {

constexpr int NTHREADS = 256;         // 8 warps
constexpr int TILE_VALUES = 8192;     // output pixels x channels of a tile
constexpr float SQRT2 = 1.4142135623730951f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* y1;        // (F*Hp, Wp, C) T
  const void* n1;        // (2Hp, 2Wp) T, buffer mode
  const void* n2;
  union {                      // block_kernel reads w2t, the staged build of
    const __nv_bfloat16* w2t;  // block_kernel_wide (which reads no w2t) its
    unsigned char* scratch;    // CTAs' activation tiles: one slot keeps Params
  };                           // at 128 bytes. w2t: (C out, C in); scratch: 128 C
                               // bytes a CTA of the grid
  const float* b1;       // (C,)
  const float* b2;
  const float* nw;       // (2,) noise weights
  const void* wrgbt;     // (3, C) T (K2) or bf16 (K3), or null: no rgb
  const float* skip;     // (Hp, Wp, 3) K3 only
  union {               // K3 has no hash, K2 no ToRGB bias: one slot keeps
    const float* brgb;   // Params at 128 bytes, where block_kernel<16, float>
    int hash_wo;         // fits its registers (at 136 bytes ptxas spilled 36 B)
  };                     // brgb: (3,) K3 only. hash_wo: hash mode, the output
                         // width the pixel ids count in (2 Wp of the caller's
                         // y1, which the wrapper may have padded past)
  void* feat;            // (2F*Hp, 2Wp, C) T, or null: not stored
  float* rgb;            // (2F*Hp, 2Wp, 3)
  int frames, hp, wp;
  uint32_t seed1, seed2; // hash mode
  int c;                 // channels (block_kernel_wide; block_kernel's is a template argument)
  const void* w2c;       // block_kernel_wide: w2t in swizzled 16 KB chunks (chunk_weight)
};

// Tile geometry and warp layout by channel count.
template <int C, typename T>
struct Geo {
  static constexpr int TW_IN = TILE_VALUES / 4 / C;      // input columns a tile
  static constexpr int TW = 2 * TW_IN;                   // output columns a tile row
  static constexpr int TM = 2 * TW;                      // output pixels a tile
  // warps across conv_b's columns: at C >= 128 a warp owns 32 of them (32
  // pixels x 32 columns), which halves the shared-memory reads of the weight
  // against 16 x 64 warp tiles; at C <= 64 a warp owns all C
  static constexpr int NW = C >= 128 ? C / 32 : 1;
  static constexpr int MW = 8 / NW;                      // warps across the pixels
  static constexpr int MT = TM / 16 / MW;                // m-tiles of 16 pixels a warp
  static constexpr int NT = C / NW / 8;                  // n-tiles of 8 columns a warp
  static constexpr int LD = C + 8;                       // bf16 row stride: weight, act
  // staged y1 column stride. A half-warp's 8-byte reads (bf16) or a quarter-
  // warp's 16-byte reads (f32) are 128 bytes: C / 4 threads a column, so
  // 2 (a 64-byte column: bf16 C = 32, f32 C = 16) or 4 (a 32-byte column:
  // bf16 C = 16) even columns at once. Padding the column to 96 or 48 bytes
  // puts those columns' bytes in distinct banks.
  static constexpr int SLD_PAD = C * sizeof(T) == 64 ? 32 : C * sizeof(T) == 32 ? 16 : 0;
  static constexpr int SLD = C + SLD_PAD / int(sizeof(T));
  static constexpr int SCOLS = TW_IN + 2;                // staged columns, halo included
  static constexpr int FLD = C / NW + 8;                 // warp feat slice row stride
  static_assert((C / 4) * (TW_IN / 2) == NTHREADS, "one upsample item a thread");
  static_assert(MT * 16 * MW == TM && NT % 2 == 0, "warp layout");
};

template <int C, typename T, bool HASH>
struct __align__(16) Smem {
  using G = Geo<C, T>;
  using NZ = typename std::conditional<HASH, float, T>::type;
  // bf16 feat slices: a warp that owns all columns (NW = 1) reuses its own
  // rows of the activation tile instead
  static constexpr int FS =
      std::is_same<T, float>::value || G::NW == 1 ? 8 : 8 * G::MT * 16 * G::FLD;
  __nv_bfloat16 w2t[C * G::LD];             // conv_b weight (n, k)
  __nv_bfloat16 act[G::TM * G::LD];         // activation tile
  T ys[2][3 * G::SCOLS * G::SLD];           // ring: y1 rows r-1, r, r+1 of the tile
  NZ nz[2][2][G::TM];                       // ring: the tile's noise1, noise2
  __nv_bfloat16 fs[FS];                     // bf16 feat, a 16 MT-row slice a warp (NW > 1)
  float b1[C], b2[C];
  float wrgb[3 * C];                        // (j, k)
  float rgbp[G::NW * G::TM * 3];            // ToRGB partials of the column groups
};

// (v >= 0 ? v : 0.2v) * sqrt2; max(v, 0.2v) picks the same value
__device__ __forceinline__ float lrelu(float v) {
  return __fmul_rn(fmaxf(v, __fmul_rn(v, 0.2f)), SQRT2);
}

// .25 * a + k, where k = .75 * b is rounded: .25 * a is exact (a power of
// two), so one fused multiply-add rounds as the plain version's sum does
__device__ __forceinline__ float blend(float a, float k) { return __fmaf_rn(0.25f, a, k); }

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack_bf16(u.x), b = unpack_bf16(u.y);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}

// the storage rounding of 4 values: bf16 (round to nearest even) or none
template <typename T>
__device__ __forceinline__ void round4(float (&v)[4]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const float2 a = unpack_bf16(pack_bf16(v[0], v[1])), b = unpack_bf16(pack_bf16(v[2], v[3]));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// The upsample's row pass on a thread's 4 channels of one input column:
// even output row .25*y[r-1] + .75*y[r], odd .75*y[r] + .25*y[r+1] (up, c,
// dn: rows r-1, r, r+1), each rounded to the storage type T.
template <typename T>
__device__ __forceinline__ void row_pass(const float (&up)[4], const float (&c)[4],
                                         const float (&dn)[4], float (&x)[2][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float kc = __fmul_rn(0.75f, c[e]);
    x[0][e] = blend(up[e], kc);
    x[1][e] = blend(dn[e], kc);
  }
  round4<T>(x[0]);
  round4<T>(x[1]);
}

// The column pass on a thread's row-passed input columns j0-1 .. j0+2
// (x[k], k = 0..3), + noise1 + b1 + lrelu: output columns 2*j0 .. 2*j0+3
// of both output rows, stored in bf16 to the activation tile `act` (row
// p = par * TW + output column, row stride ld) at channels ch .. ch+3;
// with SW128, to block_kernel_wide's swizzled tile instead (channel k of
// pixel p in block k / 64, ld apart, row p of 128 bytes, 16-byte column
// ((k / 8) % 8) ^ (p % 8)).
// nz1: the tile's noise1 by output pixel; bb: b1 at those channels.
template <int TW, bool SW128 = false, typename NZ>
__device__ __forceinline__ void column_pass(const float (&x)[4][2][4], const float (&bb)[4],
                                            float nw1, const NZ* nz1, int j0, int ch,
                                            __nv_bfloat16* act, int ld) {
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int jc = 1; jc < 3; ++jc) {  // the centre input column
      float kc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) kc[e] = __fmul_rn(0.75f, x[jc][par][e]);
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {  // output column 2*(j0 + jc - 1) + odd
        const int p = par * TW + 2 * (j0 + jc - 1) + odd;
        const float(&xn)[4] = x[odd ? jc + 1 : jc - 1][par];
        const float nzw = __fmul_rn(nw1, to_f(nz1[p]));
        float h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = lrelu(__fadd_rn(__fadd_rn(blend(xn[e], kc[e]), nzw), bb[e]));
        const int at = SW128 ? (ch >> 6) * ld + p * 64 + ((((ch >> 3) & 7) ^ (p & 7)) << 3) +
                                   (ch & 7)
                             : p * ld + ch;
        *reinterpret_cast<uint2*>(act + at) =
            make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
      }
    }
}

#ifdef DBLOCK_PHASE_CLOCKS
// Instrumented build only (python -m cips3dpp_torch.tools.decoder_block_phase_split):
// every warp adds the SM clock cycles since its previous mark to that
// phase's count in registers, and lane 0 adds its counts to these totals at
// the end, so a phase's count is the warps' time in it, waits included. No
// barrier is added.
constexpr int NPHASES = 9;
__device__ unsigned long long g_phase_cycles[NPHASES];
#define PHASE_MARK(k)                                    \
  do {                                                   \
    const long long now = clock64();                     \
    phase_cyc[k] += (unsigned long long)(now - mark);    \
    mark = now;                                          \
  } while (0)
#else
#define PHASE_MARK(k) \
  do {                \
  } while (0)
#endif

// T: storage of y1, buffer noise and feat. HASH: noise made in the kernel.
// RGB_BF16: K3 (bf16 ToRGB operands, bias and skip epilogue; T = float).
template <int C, typename T, bool HASH, bool RGB_BF16>
__global__ void __launch_bounds__(NTHREADS, C == 256 ? 1 : 2) block_kernel(const Params P) {
  using G = Geo<C, T>;
  using S = Smem<C, T, HASH>;
  using WT = typename std::conditional<RGB_BF16, __nv_bfloat16, T>::type;
  constexpr int TW_IN = G::TW_IN, TW = G::TW, TM = G::TM, NW = G::NW, MT = G::MT,
                NT = G::NT, LD = G::LD, SLD = G::SLD, SCOLS = G::SCOLS, FLD = G::FLD;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int VT = 16 / sizeof(T);  // values of T in 16 bytes
  static_assert(F32 || !RGB_BF16, "K3 stores f32");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const T* __restrict__ y1 = static_cast<const T*>(P.y1);
  const WT* __restrict__ wrgbt = static_cast<const WT*>(P.wrgbt);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mg = warp / NW, nq = warp % NW;  // pixel group, column group
  const int hp = P.hp, wp = P.wp, wo = 2 * wp;
  const int segs = (wp + TW_IN - 1) / TW_IN;
  const int n_tiles = P.frames * hp * segs;
  const float nw1 = P.nw[0], nw2 = P.nw[1];
#ifdef DBLOCK_PHASE_CLOCKS
  unsigned long long phase_cyc[NPHASES] = {};
  long long mark = clock64();
#endif

  // ---- the first copy group: conv_b's weight, then the first tile ----
  for (int i = tid; i < C * (C / 8); i += NTHREADS) {
    const int n = i / (C / 8), q = i % (C / 8);
    cp_async16(sm.w2t + n * LD + q * 8, P.w2t + n * C + q * 8);
  }
  for (int i = tid; i < C; i += NTHREADS) {
    sm.b1[i] = P.b1[i];
    sm.b2[i] = P.b2[i];
  }
  if (wrgbt != nullptr)
    for (int i = tid; i < 3 * C; i += NTHREADS) sm.wrgb[i] = to_f(wrgbt[i]);

  // tile -> input row r (frames stacked), row in its frame rf, first column c0
  auto where = [&](int tile, int& r, int& rf, int& c0) {
    r = tile / segs;
    rf = r % hp;
    c0 = (tile % segs) * TW_IN;
  };

  // The tile's y1 rows and noise into ring slot s (copies not committed).
  auto stage = [&](int tile, int s) {
    int r, rf, c0;
    where(tile, r, rf, c0);
    constexpr int CH = C / VT;  // 16-byte chunks of a pixel; a thread keeps its chunk q
    const int q = tid % CH;
#pragma unroll
    for (int row = 0; row < 3; ++row) {
      const bool row_ok = rf - 1 + row >= 0 && rf - 1 + row < hp;
      const T* src = y1 + (long long)(r - 1 + row) * wp * C + q * VT;  // read only where ok
      T* dst = sm.ys[s] + row * SCOLS * SLD + q * VT;
      for (int col = tid / CH; col < SCOLS; col += NTHREADS / CH) {
        const int ic = c0 - 1 + col;
        const bool ok = row_ok && ic >= 0 && ic < wp;
        cp_async16(dst + col * SLD, ok ? src + ic * C : y1, ok);
      }
    }
    if constexpr (HASH) {
      // pixel ids are per frame (every frame takes one realization)
      for (int i = tid; i < 2 * TM; i += NTHREADS) {
        const int m = i / TM, p = i % TM;
        const int orow = 2 * rf + p / TW, ocol = 2 * c0 + p % TW;
        sm.nz[s][m][p] = hash_normal(uint32_t(orow) * uint32_t(P.hash_wo) + uint32_t(ocol),
                                     m ? P.seed2 : P.seed1);
      }
    } else {
      constexpr int NCH = TW / VT;  // 16-byte chunks of a noise row segment
      for (int i = tid; i < 4 * NCH; i += NTHREADS) {
        const int q = i % NCH, par = (i / NCH) & 1, m = i / (2 * NCH);
        const int ocol = 2 * c0 + q * VT;
        const bool ok = ocol < wo;
        const T* nb = static_cast<const T*>(m ? P.n2 : P.n1);
        cp_async16(&sm.nz[s][m][par * TW + q * VT],
                   ok ? nb + size_t(2 * rf + par) * wo + ocol : nb, ok);
      }
    }
  };

  // Upsample + noise1 + b1 + lrelu of ring slot s -> the bf16 activation
  // tile. Thread: channels ch .. ch+3 of input columns j0, j0+1 (staged
  // columns j0 .. j0+3), output pixels 2*j0 .. 2*j0+3 of both rows.
  auto upsample = [&](int s) {
    const int ch = 4 * (tid % (C / 4)), j0 = 2 * (tid / (C / 4));
    const T* ys = sm.ys[s] + j0 * SLD + ch;
    float x[4][2][4];  // row-upsampled staged columns, even and odd output row
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float up[4], c[4], dn[4];
      load4(ys + k * SLD, up);
      load4(ys + (SCOLS + k) * SLD, c);
      load4(ys + (2 * SCOLS + k) * SLD, dn);
      row_pass<T>(up, c, dn, x[k]);
    }
    float bb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bb[e] = sm.b1[ch + e];
    column_pass<TW>(x, bb, nw1, sm.nz[s][0], j0, ch, sm.act, LD);
  };

  // conv_b: the warp's (16 MT, 8 NT) block of act @ w2t^T.
  auto product = [&](float (&acc)[MT][NT][4]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.f;
    // ldmatrix rows: A pixel (lane & 15) at k + (lane >> 4) * 8; B output
    // column (lane & 7) + (lane >> 4) * 8 at k + ((lane >> 3) & 1) * 8
    const uint32_t a_addr =
        smem_u32(sm.act + (mg * MT * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
    const uint32_t b_addr = smem_u32(sm.w2t + (nq * NT * 8 + (lane & 7) + (lane >> 4) * 8) * LD +
                                     ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int k = 0; k < C; k += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], a_addr + 2 * (i * 16 * LD + k));
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];  // b0, b1 of n-tile 2jp, then of 2jp + 1
        ldmatrix_x4(b, b_addr + 2 * (jp * 16 * LD + k));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  };

  // noise2 + b2 + lrelu, feat stores and ToRGB partials of a tile.
  auto epilogue = [&](int tile, int s, const float (&acc)[MT][NT][4]) {
    int r, rf, c0;
    where(tile, r, rf, c0);
    const size_t out0 = size_t(2 * r) * wo + 2 * c0;  // the tile's first output pixel
    T* feat = static_cast<T*>(P.feat);
    const bool emit_rgb = P.rgb != nullptr;
    const int col0 = nq * NT * 8;  // the warp's first output column
    // the warp's (16 MT) x (C / NW) bf16 feat slice: its own act rows when it
    // owns all columns (its product has read them), else its own slice
    __nv_bfloat16* fsw = NW == 1 ? sm.act + mg * MT * 16 * LD
                                 : sm.fs + (F32 ? 0 : warp * MT * 16 * FLD);
    bool inside[MT];    // an m-tile lies in one output row, inside or past its end
    size_t px0[MT];     // its first output pixel
    float z[MT][2];     // nw2 * noise2 of rows g, g + 8
    float srgb[MT][2][3];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int pm = (mg * MT + i) * 16;
      inside[i] = 2 * c0 + pm % TW < wo;
      px0[i] = out0 + size_t(pm / TW) * wo + pm % TW;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        z[i][rr] = __fmul_rn(nw2, to_f(sm.nz[s][1][pm + g + 8 * rr]));
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) srgb[i][rr][jj] = 0.f;
      }
    }
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      float v[MT][2][2][2];  // [m-tile][n-tile of the pair][row g, g + 8][column 2t, 2t + 1]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jn = 2 * jp + h, ch = col0 + jn * 8 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(sm.b2 + ch);
        float2 w[3];
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) w[jj] = *reinterpret_cast<const float2*>(sm.wrgb + jj * C + ch);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float v0 = lrelu(__fadd_rn(__fadd_rn(acc[i][jn][2 * rr], z[i][rr]), bb.x));
            float v1 = lrelu(__fadd_rn(__fadd_rn(acc[i][jn][2 * rr + 1], z[i][rr]), bb.y));
            if constexpr (!F32) {  // feat rounded in registers; ToRGB reads it
              const uint32_t pk = pack_bf16(v0, v1);
              if (feat != nullptr)
                *reinterpret_cast<uint32_t*>(fsw + (16 * i + g + 8 * rr) * FLD + jn * 8 + 2 * t) = pk;
              const float2 f = unpack_bf16(pk);
              v0 = f.x, v1 = f.y;
            }
            v[i][h][rr][0] = v0, v[i][h][rr][1] = v1;
            if (emit_rgb) {
              const float a0 = RGB_BF16 ? bf16r(v0) : v0, a1 = RGB_BF16 ? bf16r(v1) : v1;
#pragma unroll
              for (int jj = 0; jj < 3; ++jj)
                srgb[i][rr][jj] = __fmaf_rn(a1, w[jj].y, __fmaf_rn(a0, w[jj].x, srgb[i][rr][jj]));
            }
          }
      }
      if constexpr (F32) {
        // one exchange between lanes t, t^1 gives each 4 adjacent channels:
        // even lanes those of n-tile 2jp, odd lanes those of 2jp + 1
        if (feat != nullptr) {
          const bool odd = t & 1;
          const int ch = col0 + (2 * jp + odd) * 8 + 2 * (t & 2);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const float s0 = odd ? v[i][0][rr][0] : v[i][1][rr][0];
              const float s1 = odd ? v[i][0][rr][1] : v[i][1][rr][1];
              const float r0 = __shfl_xor_sync(FULL, s0, 1), r1 = __shfl_xor_sync(FULL, s1, 1);
              const float4 o = odd ? make_float4(r0, r1, v[i][1][rr][0], v[i][1][rr][1])
                                   : make_float4(v[i][0][rr][0], v[i][0][rr][1], r0, r1);
              if (inside[i])
                *reinterpret_cast<float4*>(feat + (px0[i] + g + 8 * rr) * C + ch) = o;
            }
        }
      }
    }
    if constexpr (!F32) {
      // the warp's slice as 16-byte rows
      if (feat != nullptr) {
        __syncwarp();
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (inside[i])
            for (int u = lane; u < 16 * NT; u += 32) {
              const int row = u / NT, q = u % NT;
              *reinterpret_cast<uint4*>(feat + (px0[i] + row) * C + col0 + q * 8) =
                  *reinterpret_cast<const uint4*>(fsw + (16 * i + row) * FLD + q * 8);
            }
        __syncwarp();
      }
    }
    if (emit_rgb) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            srgb[i][rr][jj] += __shfl_xor_sync(FULL, srgb[i][rr][jj], 1);
            srgb[i][rr][jj] += __shfl_xor_sync(FULL, srgb[i][rr][jj], 2);
          }
      if (t == 0)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int jj = 0; jj < 3; ++jj)
              sm.rgbp[(nq * TM + (mg * MT + i) * 16 + g + 8 * rr) * 3 + jj] = srgb[i][rr][jj];
    }
  };

  // The column groups' ToRGB partials of a tile, summed in order (+ brgb
  // and the upsampled skip in K3), as float4 runs over its output rows.
  auto flush_rgb = [&](int tile) {
    if (P.rgb == nullptr) return;
    int r, rf, c0;
    where(tile, r, rf, c0);
    const size_t out0 = size_t(2 * r) * wo + 2 * c0;
    for (int u = tid; u < TM * 3 / 4; u += NTHREADS) {
      const int f = 4 * u, par = f / (3 * TW), fr = f % (3 * TW);
      if (2 * c0 + fr / 3 >= wo) continue;  // past the row's end (16-pixel aligned)
      // rgbp holds (pixel, j) in the order rgb does: float4 f / 4 of each group
      float4 a = *reinterpret_cast<const float4*>(sm.rgbp + f);
#pragma unroll
      for (int q = 1; q < NW; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(sm.rgbp + q * TM * 3 + f);
        a = make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                        __fadd_rn(a.w, b.w));
      }
      if constexpr (RGB_BF16) {
        float o[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = (f + e) / 3, jj = (f + e) % 3;
          o[e] = __fadd_rn(__fadd_rn(o[e], P.brgb[jj]),
                           skip_up(P.skip, hp, wp, 2 * rf + p / TW, 2 * c0 + p % TW, jj));
        }
        a = make_float4(o[0], o[1], o[2], o[3]);
      }
      *reinterpret_cast<float4*>(P.rgb + (out0 + size_t(par) * wo) * 3 + fr) = a;
    }
  };

  stage(blockIdx.x, 0);
  cp_async_commit();
  PHASE_MARK(0);  // prologue: constants, the first tile's copies started
  int s = 0, prev = -1;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, s ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // slot s landed; every warp is done with the last tile
    PHASE_MARK(1);    // wait for the copies, barrier
    if (prev >= 0) flush_rgb(prev);
    PHASE_MARK(2);  // the last tile's rgb
    if (tile + int(gridDim.x) < n_tiles) stage(tile + gridDim.x, s ^ 1);
    cp_async_commit();
    PHASE_MARK(3);  // the next tile's copies started (and its hash noise)
    upsample(s);
    PHASE_MARK(4);  // upsample
    __syncthreads();  // the activation tile is complete
    PHASE_MARK(5);    // barrier
    float acc[MT][NT][4];
    product(acc);
    PHASE_MARK(6);  // conv_b
    epilogue(tile, s, acc);
    PHASE_MARK(7);  // epilogue
    prev = tile;
  }
  __syncthreads();
  flush_rgb(prev);
  PHASE_MARK(8);  // the last rgb
#ifdef DBLOCK_PHASE_CLOCKS
  if (lane == 0)
    for (int k = 0; k < NPHASES; ++k) atomicAdd(&g_phase_cycles[k], phase_cyc[k]);
#endif
}

// ---- C = 320 and up: block_kernel_wide, the conv_b weight streamed ----
//
// From C = 320 up, conv_b's weight (C x C bf16: 200 KB at 320, 8 MB at
// 2048, 128 MB at 8192) cannot stay in shared memory as in block_kernel.
// A tile is one input row x TW_IN input columns (2 output rows x TM / 2
// columns, TW_IN = TM / 4, so with Wp a multiple of 16 no tile is ragged)
// whose bf16 activation tile (TM pixels x C) meets the whole weight as it
// streams past. Up to C = 2048 the activation tile stays in shared memory
// beside the weight ring (40-128 KB): TM = 64 output pixels at C <= 1024
// and 32 to 2048. At C <= 512 the 64-pixel tile gives y1 (64, 64, C) 256
// tiles, enough for every SM. C is taken at run time (every multiple of
// 64, below); C = 384, 512, 1024 and 2048 (the 128^2 blocks at channel
// multipliers 3, 4, 8 and 16), and 192 and 320 (the 1024^2 and 512^2
// blocks that multipliers 9-12 and 17 pad to) are also built with C fixed
// (CT), which folds the index arithmetic: at (512, 512, 272) the run-time
// build at 320 took 2.09 ms in bf16 storage, the fixed one 1.40 (k2_times
// on an H100 80GB HBM3 at 700 W).
//
// Past C = 2048 the staged build (CT = STAGED, C at run time, no ceiling)
// keeps 64-pixel tiles and nothing in shared memory that grows with C. A
// tile in shared memory would have to shrink as C grows (16 pixels to 4096,
// 8 to 8192 in the earlier build), and a cluster reads the whole weight
// once for each CL tiles, so small tiles multiply the weight bytes into the
// SMs (137 GB a launch at y1 (64, 64, 8192) with 8-pixel tiles). Instead:
//  - the upsample writes the tile to the CTA's scratch in global memory
//    (128 C bytes a CTA, allocated by the caller), in the layout wgmma's B
//    operand reads: C / 64 K-chunks of 64 pixels x 64 channels (8 KB), a
//    pixel's 16-byte group j at j ^ (pixel % 8);
//  - a ring slot (STAGED_SLOT_BYTES, 24 KB) holds a 16 KB weight chunk,
//    multicast to the cluster as below, and the 8 KB activation chunk it
//    multiplies, bulk-copied from the CTA's own scratch (no multicast: the
//    pixels are the CTA's own), both completing on the slot's full barrier;
//  - so a tile takes in C^2 bytes of weight (2 C^2 a cluster of 2) and C^2
//    of activation (C / 64 chunks a pass, C / 128 passes): 512 C^2 bytes a
//    launch at y1 (64, 64, C), against 2048 C^2 for 8-pixel tiles;
//  - the upsample's writers fence the generic proxy against the async one
//    (fence.proxy.async.global) and meet at a consumer barrier; one thread
//    then arrives on the tile's ready mbarrier. The producer waits on it
//    (and fences) before it copies the tile's first activation chunk;
//    until then it copies weight chunks up to NS slots ahead. The scratch
//    is rewritten by the next tile's upsample only after every consumer
//    has waited on the full barrier of the tile's last chunk, by which
//    time every copy out of it has landed;
//  - 8 slots of 24 KB, ~210 KB of shared memory at every C; offsets into
//    y1, feat, the weight and the scratch are 64-bit.
// Every rounding point, mode, sum order (the walk's start and the ToRGB
// reduce-scatter included) and the epilogue are the 64-pixel tile's.
//
// conv_b runs transposed, out^T (channels x pixels) = W (C out x C in) .
// act^T, on wgmma: the weight is the 64-row A operand and the activation
// tile the N = TM-column B operand (32 or 64), both K-major in shared
// memory in the 128-byte swizzle, so a 32-pixel tile still fills wgmma's
// 64 rows.
// A consumer warpgroup takes the chunk's 64 rows of its half: 64 x TM
// outputs, TM / 2 accumulators a thread.
// decoder_block_prepare lays the weight out as (128 out x 64 in) chunks of
// 16 KB, pass by pass (128 output channels over C / 64 chunks), each
// already swizzled (chunk_weight in kernels/decoder_block.py), so one 1-D
// bulk copy (cp.async.bulk) fills a ring slot; no tensor map.
// The run-time-C builds (CT <= 0) take every multiple of 64: where C % 128
// == 64 a tile walks C / 128 full passes and a tail pass of 64 output
// channels, whose chunks (64 out x 64 in, 8 KB, laid out after the full
// passes' in the same swizzle) fill half a slot; the producer expects and
// copies 8 KB (8 + 8 KB in the staged build). In the tail pass both
// consumer warpgroups take the chunk's 64 rows, each for half the tile's
// pixels (one output row of the tile: wgmma at N = TM / 2), so neither
// idles through the tail's wgmma or its epilogue; the ToRGB partials keep
// their places by pixel. The staged build, at its 168 registers, spilled
// with that split; there warpgroup 0 takes the tail's 64 rows for every
// pixel and warpgroup 1's products (of the slot's stale upper half) are
// dropped: it waits on its intake, not on wgmma. A fixed C of
// whole passes (384, 512, 1024, 2048) has no tail, and the tail code
// compiles away there (if constexpr). Tile group g
// walks the passes from pass g % P and each pass's chunks from chunk
// g / P % (C / 64), so the clusters on the card at once read different
// parts of the weight instead of the same chunk (3% at C = 384-1024).
//
// Roles: warps 0-7 are two consumer warpgroups, warp 8 the producer. The
// producer's first thread keeps an NS-slot ring full (NS = 5-8, as many as
// shared memory leaves, by C; 8 in the staged build) under full / empty
// mbarriers: wait for the slot's empty barrier, expect 16 KB (24 KB staged)
// on its full barrier, copy. A cluster
// of CL CTAs (launched with cudaLaunchKernelEx on a persistent grid of as
// many clusters as cudaOccupancyMaxActiveClusters allows) walks CL
// neighbouring tiles in lockstep and shares every chunk: CTA q % CL
// copies chunk q into all CL CTAs by .multicast::cluster, so L2 serves
// each chunk once a cluster; every consumer warpgroup frees a slot by
// arriving on that slot's empty barrier in each CTA of the cluster. A CTA
// whose tile lies past the last one still consumes and frees every chunk
// and stores nothing.
//
// A consumer warpgroup waits for a chunk's full barrier, issues its 4
// k16 wgmmas (N = TM), and frees the slot of the previous chunk once that
// chunk's wgmma group is done (one group left in flight), by a CTA-scope
// arrival: what it orders is wgmma's reads of the
// slot, complete by then, and a cluster-scope release would stall the
// arriving warp, and so its warpgroup's next wgmma, on a fence. No block
// barrier a chunk. After a pass of C / 64 chunks the epilogue runs on the
// accumulators, whose rows are channels and columns pixels: noise2 + b2 +
// lrelu (rounded to bf16 where the storage is bf16), feat through a
// warp-private staging slice (stmatrix .trans for bf16) as 16-byte rows,
// ToRGB partials in registers over the passes. At the end of the tile
// they are reduced over a warp's 8 row lanes (a reduce-scatter by
// shuffles) into the warp's sums in shared memory, then the eight warps'
// sums are added in a fixed order (+ brgb and the upsampled skip in K3)
// and stored as float4 runs. Every sum is in an order fixed by the tile
// (the walk's start included), so two launches give the same bits. b1, b2
// and wrgb are read from global memory (L1) where they are needed, which
// leaves their 40 KB at C = 2048 to the ring.
//
// The upsample (all 256 consumer threads) reads y1 straight from global
// memory, rounds where block_kernel rounds and writes the activation tile
// in the swizzled layout with ordinary stores (to shared memory, or in the
// staged build to the scratch), then fence.proxy.async and a consumer
// barrier before wgmma (or the bulk copies) read it. Every rounding point, the
// modes (K3's bf16 ToRGB operands, bias and upsampled skip included), the
// frames and the skipped feat store are block_kernel's.
constexpr int WIDE_CONSUMERS = 256;                  // two consumer warpgroups
constexpr int WIDE_THREADS = WIDE_CONSUMERS + 32;    // and the producer warp
constexpr int CHUNK_ROWS = 128;                      // output channels a chunk (a pass)
constexpr int CHUNK_K = 64;                          // input channels a chunk: 128 bytes
constexpr int CHUNK_BYTES = CHUNK_ROWS * CHUNK_K * 2;
constexpr int TAIL_ROWS = 64;                        // output channels of a tail pass's chunk
constexpr int TAIL_BYTES = TAIL_ROWS * CHUNK_K * 2;  // 8 KB
constexpr int MAX_SLOTS = 8;
constexpr int SMEM_LIMIT = 232448;                   // a block's shared memory on sm_90
#ifndef DBLOCK_WIDE_CLUSTER
#define DBLOCK_WIDE_CLUSTER 2                        // another size: a build with -D
#endif
constexpr int WIDE_CLUSTER = DBLOCK_WIDE_CLUSTER;    // CTAs a cluster
static_assert(WIDE_CLUSTER >= 1 && WIDE_CLUSTER <= 8, "a portable cluster size");

template <int TM_>
struct Wide {
  static constexpr int TM = TM_;                     // output pixels a tile
  static constexpr int TW = TM / 2;                  // output columns a tile row
  static constexpr int TW_IN = TW / 2;               // input columns a tile
  static constexpr int RV = 3 * TM / 4;              // a thread's ToRGB partials
  static constexpr int RVP = (RV + 7) / 8 * 8;       // ... padded for an 8-lane reduce-scatter
  static constexpr int NB = TM / 8;                  // n-blocks of 8 pixels
  static constexpr int NH = 2;                       // n-blocks an epilogue group (16 pixels)
  static_assert(TW_IN <= 16, "Wp, a multiple of 16, is a whole number of tiles");
  static_assert(TM == 32 || TM == 64, "wgmma N");

  // Shared memory, from a 1024-byte aligned base: the activation tile (C /
  // 64 blocks of TM swizzled 128-byte rows), the ring, then the full and
  // empty barriers, noise1 / noise2 of the tile (f32), the warps' ToRGB
  // partials and the warps' feat staging slices (16 pixels x 16 channels,
  // rows padded to 48 bytes in bf16 and 80 in f32 against bank conflicts).
  template <typename T>
  __host__ __device__ static constexpr int stage_ld() { return sizeof(T) == 2 ? 24 : 20; }
  __host__ __device__ static constexpr int act_bytes(int c) { return TM * c * 2; }
  template <typename T>
  __host__ __device__ static constexpr int small_bytes() {
    return 2 * MAX_SLOTS * 8 + 2 * TM * 4 + 8 * TM * 3 * 4 +
           8 * 16 * stage_ld<T>() * int(sizeof(T));
  }
  template <typename T>
  __host__ __device__ static constexpr int slots(int c) {
    const int n = (SMEM_LIMIT - 1024 - act_bytes(c) - small_bytes<T>()) / CHUNK_BYTES;
    return n < MAX_SLOTS ? n : MAX_SLOTS;
  }
  template <typename T>
  __host__ __device__ static constexpr int smem_bytes(int c) {
    return 1024 + act_bytes(c) + slots<T>(c) * CHUNK_BYTES + small_bytes<T>();
  }
};

// The staged build (past C = 2048): 64-pixel tiles, CT = STAGED, and a
// ring of 24 KB slots, each a weight chunk and the activation chunk it
// multiplies (ACT_CHUNK_BYTES: 64 pixels x 64 channels); its shared memory,
// the same at every C: the alignment pad, the ring, the small arrays of
// the 64-pixel tile (full and empty barriers among them) and the ready
// barrier (16 bytes, which keeps what follows it 16-byte aligned).
constexpr int STAGED = -1;
constexpr int STAGED_FROM = 2048;                    // the largest C not staged
constexpr int STAGED_TM = 64;
constexpr int ACT_CHUNK_BYTES = STAGED_TM * CHUNK_K * 2;
constexpr int STAGED_SLOT_BYTES = CHUNK_BYTES + ACT_CHUNK_BYTES;
constexpr int STAGED_SLOTS = MAX_SLOTS;
template <typename T>
constexpr int staged_smem_bytes() {
  return 1024 + STAGED_SLOTS * STAGED_SLOT_BYTES + Wide<STAGED_TM>::small_bytes<T>() + 16;
}
static_assert(staged_smem_bytes<float>() <= SMEM_LIMIT, "the staged ring fits");

// ---- Hopper primitives: mbarriers, bulk copies, clusters, wgmma ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive on the barrier at the same offset in CTA `cta` of the cluster
// (the default CTA-scope release: see block_kernel_wide's slot release)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// `bytes` from global memory into shared memory at `dst` of every CTA in
// `mask` (the same offset in each), completing on the barrier at `bar`'s
// offset in each
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar,
                                          uint16_t mask, bool multicast) {
  if (multicast)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar), "h"(mask)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_reg(int which) {
  uint32_t v;
  switch (which) {
    case 0: asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v)); break;
    case 1: asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(v)); break;
    case 2: asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v)); break;
    default: asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(v)); break;
  }
  return v;
}

// i + 1, or 0 past n - 1
__device__ __forceinline__ int next_mod(int i, int n) { return i + 1 == n ? 0 : i + 1; }

// the 256 consumer threads only (named barrier 1; the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WIDE_CONSUMERS) : "memory");
}

// the activation tile's generic-proxy stores, seen by wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the staged build: the scratch's generic-proxy stores, seen by the bulk copies
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this layout)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are not read or written by other code around here
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 16, f32) += A (64 x 16) . B (16 x 16)^T, bf16, both from shared
// memory (the tail pass of a 32-pixel tile: 16 pixels a warpgroup)
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16) . B (32 x 16)^T, bf16, both from shared memory
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16) . B (64 x 16)^T
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x N) += A . B^T at N = 16, 32 or 64
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 16) wgmma_n16(d, a, b);
  else if constexpr (N == 32) wgmma_n32(d, a, b);
  else wgmma_n64(d, a, b);
}

// four 8x8 bf16 matrices from the mma fragment layout, each stored
// transposed: the row of lane l holds column l % 8 of matrix l / 8
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
                   "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// One step of a reduce-scatter over the lanes that differ in `mask`: of
// x[0 .. 2H), the lane keeps the upper half where its `mask` bit is set
// and the lower where it is not, adds its partner's copy of that half,
// and leaves the sums in x[0 .. H).
template <int H>
__device__ __forceinline__ void reduce_half(float* x, int mask, bool upper) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? x[i] : x[i + H], keep = upper ? x[i + H] : x[i];
    x[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, mask));
  }
}

#ifdef DBLOCK_PHASE_CLOCKS
// Instrumented build only (decoder_block_phase_split --streamed): the
// producer's thread counts its waits for an empty slot and, in the staged
// build, for a tile's ready barrier; every consumer
// warp counts its waits for a full slot, its wgmma issue and group waits,
// the tile's noise and upsample (their barriers included) and the
// epilogue (feat, ToRGB, the rgb store, their barriers). Lane 0 of each
// warp adds its counts to these totals at the end.
constexpr int NWIDE_PHASES = 6;
__device__ unsigned long long g_wide_cycles[NWIDE_PHASES];
#define WIDE_MARK(k)                                          \
  do {                                                        \
    const long long now_ = clock64();                         \
    wide_cyc[k] += (unsigned long long)(now_ - wmark);        \
    wmark = now_;                                             \
  } while (0)
#define WIDE_RESTART() \
  do {                 \
    wmark = clock64(); \
  } while (0)
#else
#define WIDE_MARK(k) \
  do {               \
  } while (0)
#define WIDE_RESTART() \
  do {                 \
  } while (0)
#endif

// CT: C fixed at compile time (192, 320, 384, 512, 1024 and 2048: see
// launch_c), 0: C taken from P.c at run time, or STAGED: C at
// run time past 2048, the activation tile staged through the CTA's scratch
// (TM = 64). Under -DDBLOCK_PLANT_RING_FAULT the staged build's producer
// copies activation chunks without waiting for the tile's ready barrier;
// under -DDBLOCK_PLANT_TAIL_FAULT the tail pass issues 3 of each chunk's 4
// k16 wgmmas (faults the card tests and chip_smoke.py must catch); nothing
// else changes.
template <int TM, int CT, typename T, bool HASH, bool RGB_BF16>
__global__ void __launch_bounds__(WIDE_THREADS, 1) block_kernel_wide(const Params P) {
  using W = Wide<TM>;
  constexpr bool STG = CT == STAGED;
  static_assert(!STG || TM == STAGED_TM, "the staged tile");
  constexpr int TW_IN = W::TW_IN, TW = W::TW, RV = W::RV, RVP = W::RVP, NB = W::NB,
                NH = W::NH;
  constexpr int SLD = W::template stage_ld<T>();
  constexpr bool F32 = std::is_same<T, float>::value;
  static_assert(F32 || !RGB_BF16, "K3 stores f32");
  using WT = typename std::conditional<RGB_BF16, __nv_bfloat16, T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = CT > 0 ? CT : P.c;
  // chunks a pass, passes a tile: the last pass is a tail of 64 output
  // channels where C % 128 == 64 (never at a fixed C of whole passes)
  constexpr bool WHOLE = CT > 0 && CT % CHUNK_ROWS == 0;
  const int KCH = C / CHUNK_K,
            PASSES = WHOLE ? C / CHUNK_ROWS : (C + CHUNK_ROWS - 1) / CHUNK_ROWS;
  auto is_tail = [&](int pass) -> bool {
    if constexpr (WHOLE) return false;
    else return pass == PASSES - 1 && C % CHUNK_ROWS != 0;
  };
  // the weight chunk of pass `pass`, chunk kc in w2c (a tail pass's chunks
  // are 8 KB, after the full passes' 16 KB ones), and its bytes
  auto chunk_at = [&](int pass, int kc) -> size_t {
    return is_tail(pass) ? size_t(pass * KCH) * CHUNK_BYTES + size_t(kc) * TAIL_BYTES
                         : size_t(pass * KCH + kc) * CHUNK_BYTES;
  };
  auto chunk_bytes = [&](int pass) -> int { return is_tail(pass) ? TAIL_BYTES : CHUNK_BYTES; };
  const int NS = STG ? STAGED_SLOTS : W::template slots<T>(C);
  constexpr int SLOT = STG ? STAGED_SLOT_BYTES : CHUNK_BYTES;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_act = (raw + 1023u) & ~1023u;  // the swizzle wants 1024-byte alignment
  unsigned char* const base = smem_raw + (s_act - raw);
  const uint32_t s_ring = s_act + (STG ? 0 : W::act_bytes(C));
  const uint32_t s_full = s_ring + NS * SLOT, s_empty = s_full + 8 * MAX_SLOTS;
  [[maybe_unused]] const uint32_t s_ready = s_empty + 8 * MAX_SLOTS;  // the staged build's
  float* const nz =
      reinterpret_cast<float*>(base + (s_empty + 8 * MAX_SLOTS + (STG ? 16 : 0) - s_act));
  float* const rgbp = nz + 2 * TM;       // the warps' ToRGB sums, [warp][pixel][colour]
  T* const stage = reinterpret_cast<T*>(rgbp + 8 * TM * 3);
  // the activation tile: in shared memory, or the CTA's C / 64 K-chunks in
  // the scratch
  __nv_bfloat16* const act =
      STG ? reinterpret_cast<__nv_bfloat16*>(P.scratch) + size_t(blockIdx.x) * TM * C
          : reinterpret_cast<__nv_bfloat16*>(base);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_reg(0), ncta = cluster_reg(1), cid = cluster_reg(2),
                 ncl = cluster_reg(3);
  const int hp = P.hp, wp = P.wp, wo = 2 * wp;
  const int segs = (wp + TW_IN - 1) / TW_IN;
  const int n_tiles = P.frames * hp * segs;
  const int groups = (n_tiles + int(ncta) - 1) / int(ncta);  // a cluster's CL tiles
#ifdef DBLOCK_PHASE_CLOCKS
  unsigned long long wide_cyc[NWIDE_PHASES] = {};
  long long wmark = clock64();
#endif

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(s_full + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(s_empty + 8 * s, 2 * int(ncta));      // each warpgroup of the cluster
    }
    if constexpr (STG) mbar_init(s_ready, 1);         // one consumer thread a tile
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every barrier of the cluster initialized before any copy or arrival

  if (warp == WIDE_CONSUMERS / 32) {
    // ---- producer: chunk after chunk, the same sequence in every CTA ----
    if (lane == 0) {
      const unsigned char* const w2c = static_cast<const unsigned char*>(P.w2c);
      const uint16_t mask = uint16_t((1u << ncta) - 1);
      int slot = 0;
      uint32_t phase = 0, issuer = 0;
      if constexpr (STG) {
        // each chunk's weight as below; beside it, the K-chunk of the
        // tile's activation it multiplies, from this CTA's scratch once
        // the consumers report the tile complete there
        const unsigned char* const asrc = P.scratch + size_t(blockIdx.x) * TM * 2 * size_t(C);
        uint32_t ready_parity = 0;
        for (int grp = int(cid); grp < groups; grp += int(ncl), ready_parity ^= 1) {
          const int kc0 = grp / PASSES % KCH, slot0 = slot;
          int acts = 0;  // the tile's chunks whose activation copy is issued
          bool ready = false;
          auto issue_acts = [&](int upto) {  // the activations of chunks acts .. upto - 1
            if (!ready) {
#ifndef DBLOCK_PLANT_RING_FAULT
              WIDE_RESTART();
              mbar_wait(s_ready, ready_parity);
              WIDE_MARK(5);
#endif
              fence_proxy_async_global();
              ready = true;
            }
            for (; acts < upto; ++acts) {
              const int s = (slot0 + acts) % NS, kc = (kc0 + acts % KCH) % KCH;
              bulk_load(s_ring + s * SLOT + CHUNK_BYTES, asrc + size_t(kc) * ACT_CHUNK_BYTES,
                        ACT_CHUNK_BYTES, s_full + 8 * s, 0, false);
            }
          };
          for (int i = 0, pass = grp % PASSES; i < PASSES; ++i, pass = next_mod(pass, PASSES))
            for (int j = 0, kc = kc0; j < KCH; ++j, kc = next_mod(kc, KCH)) {
              const int q = i * KCH + j;
              // the slot of chunk q holds chunk q - NS, whose activation
              // must be issued before the slot can free
              if (q - acts == NS) issue_acts(q);
              WIDE_RESTART();
              mbar_wait(s_empty + 8 * slot, phase ^ 1);  // free in every CTA of the cluster
              WIDE_MARK(0);
              mbar_expect_tx(s_full + 8 * slot, chunk_bytes(pass) + ACT_CHUNK_BYTES);
              if (issuer == rank)
                bulk_load(s_ring + slot * SLOT, w2c + chunk_at(pass, kc), chunk_bytes(pass),
                          s_full + 8 * slot, mask, ncta > 1);
              if (++issuer == ncta) issuer = 0;
#ifdef DBLOCK_PLANT_RING_FAULT
              issue_acts(q + 1);
#else
              if (ready) issue_acts(q + 1);
#endif
              if (++slot == NS) slot = 0, phase ^= 1;
            }
          issue_acts(PASSES * KCH);
        }
      } else {
        for (int grp = int(cid); grp < groups; grp += int(ncl))
          for (int i = 0, pass = grp % PASSES; i < PASSES; ++i, pass = next_mod(pass, PASSES))
            for (int j = 0, kc = grp / PASSES % KCH; j < KCH; ++j, kc = next_mod(kc, KCH)) {
              WIDE_RESTART();
              mbar_wait(s_empty + 8 * slot, phase ^ 1);  // free in every CTA of the cluster
              WIDE_MARK(0);
              mbar_expect_tx(s_full + 8 * slot, chunk_bytes(pass));
              if (issuer == rank)
                bulk_load(s_ring + slot * CHUNK_BYTES, w2c + chunk_at(pass, kc),
                          chunk_bytes(pass), s_full + 8 * slot, mask, ncta > 1);
              if (++issuer == ncta) issuer = 0;
              if (++slot == NS) slot = 0, phase ^= 1;
            }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers ----
    const T* __restrict__ y1 = static_cast<const T*>(P.y1);
    const WT* __restrict__ wrgbt = static_cast<const WT*>(P.wrgbt);
    const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, tq = lane & 3;
    const int r0 = wg * 64;  // the warpgroup's first row of a chunk
    const float nw1 = P.nw[0], nw2 = P.nw[1];
    const bool emit_rgb = P.rgb != nullptr;
    T* const feat = static_cast<T*>(P.feat);
    T* const stw = stage + warp * 16 * SLD;      // the warp's staging slice
    // the upsample's items: the thread's first (group cg0 of pair jp0) and
    // the stride of 256 items in groups and pairs
    const int cgroups = C / 4, cg0 = tid % cgroups, jp0 = tid / cgroups;
    const int dcg = WIDE_CONSUMERS % cgroups, djp = WIDE_CONSUMERS / cgroups;
    // B: the activation tile in shared memory, or the slot's activation chunk
    const uint64_t desc_a = sw128_desc(s_ring + r0 * 128),
                   desc_b = sw128_desc(STG ? s_ring + CHUNK_BYTES : s_act);
    int slot = 0;
    uint32_t phase = 0;
    for (int grp = int(cid); grp < groups; grp += int(ncl)) {
      const int tile = grp * int(ncta) + int(rank);
      const bool live = tile < n_tiles;
      const int r = live ? tile / segs : 0, rf = r % hp, c0 = live ? (tile % segs) * TW_IN : 0;
      const size_t out0 = size_t(2 * r) * wo + 2 * c0;  // the tile's first output pixel
      consumer_sync();  // every warp is done with the last tile's noise and partials

      // the tile's noise in f32 (buffer values are exact in f32)
      if (live)
        for (int i = tid; i < 2 * TM; i += WIDE_CONSUMERS) {
          const int m = i / TM, p = i % TM;
          const int orow = 2 * rf + p / TW, ocol = 2 * c0 + p % TW;
          if constexpr (HASH)
            nz[i] = hash_normal(uint32_t(orow) * uint32_t(P.hash_wo) + uint32_t(ocol),
                                m ? P.seed2 : P.seed1);
          else
            nz[i] = to_f(static_cast<const T*>(m ? P.n2 : P.n1)[size_t(orow) * wo + ocol]);
        }
      consumer_sync();

      // Upsample + noise1 + b1 + lrelu -> the swizzled bf16 activation
      // tile, as block_kernel's: an item is channels ch .. ch+3 (group cg)
      // of input columns j0, j0+1 (pair jp; their neighbours j0-1 .. j0+2
      // read, zero outside the frame), strided over the threads, group
      // fastest.
      if (live) {
        const T* frame = y1 + size_t(r - rf) * wp * C;  // the frame's first row
        for (int cg = cg0, jp = jp0; jp < TW_IN / 2;) {
          const int ch = 4 * cg, j0 = 2 * jp;
          const float bb[4] = {__ldg(P.b1 + ch), __ldg(P.b1 + ch + 1), __ldg(P.b1 + ch + 2),
                               __ldg(P.b1 + ch + 3)};
          float x[4][2][4];  // row-upsampled columns, even and odd output row
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int ic = c0 - 1 + j0 + k;
            float v[3][4];
#pragma unroll
            for (int row = 0; row < 3; ++row) {
              const int ir = rf - 1 + row;
              if (ir >= 0 && ir < hp && ic >= 0 && ic < wp) {
                load4(frame + (size_t(ir) * wp + ic) * C + ch, v[row]);
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) v[row][e] = 0.f;
              }
            }
            row_pass<T>(v[0], v[1], v[2], x[k]);
          }
          column_pass<TW, true>(x, bb, nw1, nz, j0, ch, act, TM * 64);
          cg += dcg, jp += djp;  // the next item: 256 on
          if (cg >= cgroups) cg -= cgroups, ++jp;
        }
      }
      if constexpr (STG) {
        fence_proxy_async_global();
        consumer_sync();  // the activation tile is complete in the scratch
        if (tid == 0) mbar_arrive(s_ready);  // the producer may copy it
      } else {
        fence_proxy_async();
        consumer_sync();  // the activation tile is complete
      }
      WIDE_MARK(3);

      // ToRGB partials, [n-block j][pixel 2tq + e][colour], summed over the
      // passes (RV of them, zeros up to RVP); reduce_rgb reduces them over
      // the warp's row lanes g (lane bits 2-4; lane g keeps values
      // g * RVP / 8 .. of its tq) into the warp's sums in shared memory
      float srgb[RVP];
#pragma unroll
      for (int k = 0; k < RVP; ++k) srgb[k] = 0.f;
      auto reduce_rgb = [&]() {
        reduce_half<RVP / 2>(srgb, 16, lane & 16);
        reduce_half<RVP / 4>(srgb, 8, lane & 8);
        reduce_half<RVP / 8>(srgb, 4, lane & 4);
#pragma unroll
        for (int k = 0; k < RVP / 8; ++k) {
          const int vi = g * (RVP / 8) + k, j = vi / 6, e = (vi / 3) & 1, jj = vi % 3;
          if (vi < RV) rgbp[(warp * TM + 8 * j + 2 * tq + e) * 3 + jj] = srgb[k];
        }
      };

      // The pass's epilogue: noise2 + b2 + lrelu (rounded to bf16 where
      // the storage is bf16), feat through the staging slice, ToRGB
      // partials. cb: the warp's first channel. Accumulator i of M block
      // mb holds row 16 wi + g (+ 8 for i % 4 >= 2) and pixel 8 (JB + i /
      // 4) + 2 tq + i % 2: the accumulators cover n-blocks JB .. of the
      // tile (JB = 0 and all of them in a full pass; half of them from 0
      // or NB / 2 in the tail pass).
      auto epilogue = [&](int cb, const auto& acc, auto jb) {
        constexpr int JB = decltype(jb)::value;
        // the accumulators' n-blocks
        constexpr int NBA = int(std::extent<std::remove_reference_t<decltype(acc)>>::value) / 4;
        const float bA = __ldg(P.b2 + cb + g), bB = __ldg(P.b2 + cb + g + 8);
        float wA[3] = {}, wB[3] = {};
        if (emit_rgb)
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            wA[jj] = to_f(wrgbt[jj * C + cb + g]);
            wB[jj] = to_f(wrgbt[jj * C + cb + g + 8]);
          }
#pragma unroll
        for (int jq = 0; jq < NBA / NH; ++jq) {  // 8 NH pixels: n-blocks JB + NH jq ..
          // [n-block of the group][row g, g + 8][pixel 2tq + e]
          float v[2][2][2] = {};
#pragma unroll
          for (int h = 0; h < NH; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ja = NH * jq + h, j = JB + ja, p = 8 * j + 2 * tq + e;
              const float z = __fmul_rn(nw2, nz[TM + p]);
              float va = lrelu(__fadd_rn(__fadd_rn(acc[4 * ja + e], z), bA));
              float vb = lrelu(__fadd_rn(__fadd_rn(acc[4 * ja + 2 + e], z), bB));
              if constexpr (!F32) va = bf16r(va), vb = bf16r(vb);  // feat rounded; ToRGB reads it
              v[h][0][e] = va, v[h][1][e] = vb;
              if (emit_rgb) {
                const float a0 = RGB_BF16 ? bf16r(va) : va, a1 = RGB_BF16 ? bf16r(vb) : vb;
#pragma unroll
                for (int jj = 0; jj < 3; ++jj) {
                  float& s = srgb[(j * 2 + e) * 3 + jj];
                  s = __fmaf_rn(a1, wB[jj], __fmaf_rn(a0, wA[jj], s));
                }
              }
            }
          if (feat == nullptr) continue;
          // the warp's 16 pixels x 16 channels as staged rows of pixels
          if constexpr (F32) {
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float* row = reinterpret_cast<float*>(stw) + (8 * h + 2 * tq + e) * SLD;
                row[g] = v[h][0][e];
                row[g + 8] = v[h][1][e];
              }
          } else {
            // matrix 2h + u: rows g + 8u (channels) x pixels of n-block JB + NH jq + h
            const uint32_t pk[4] = {pack_bf16(v[0][0][0], v[0][0][1]),
                                    pack_bf16(v[0][1][0], v[0][1][1]),
                                    pack_bf16(v[1][0][0], v[1][0][1]),
                                    pack_bf16(v[1][1][0], v[1][1][1])};
            const int m = lane >> 3;
            stmatrix_x4_trans(smem_u32(stw + (8 * (m >> 1) + (lane & 7)) * SLD + 8 * (m & 1)),
                              pk);
          }
          __syncwarp();
          if (live) {
            constexpr int VPR = 16 * int(sizeof(T)) / 16;  // 16-byte vectors a staged row
#pragma unroll
            for (int u = lane; u < 8 * NH * VPR; u += 32) {
              const int row = u / VPR, qv = u % VPR;
              const int p = 8 * (JB + NH * jq) + row;
              *reinterpret_cast<uint4*>(feat + (out0 + size_t(p / TW) * wo + p % TW) * C + cb +
                                        qv * (16 / int(sizeof(T)))) =
                  *reinterpret_cast<const uint4*>(stw + row * SLD + qv * (16 / int(sizeof(T))));
            }
          }
          __syncwarp();
        }
      };

      for (int i = 0, pass = grp % PASSES; i < PASSES; ++i, pass = next_mod(pass, PASSES)) {
        if constexpr (!WHOLE && !STG) {
          if (is_tail(pass)) {
            // the tail pass: the chunk's 64 rows (both warpgroups), for
            // this warpgroup's TN pixels from pixel wg TN, one output row
            // of the tile
            constexpr int TN = TM / 2;
#ifdef DBLOCK_PLANT_TAIL_FAULT
            constexpr int KS = CHUNK_K / 16 - 1;
#else
            constexpr int KS = CHUNK_K / 16;
#endif
            const uint64_t desc_t = sw128_desc(s_ring);
            float acc[TN / 2];
#pragma unroll
            for (int k = 0; k < TN / 2; ++k) acc[k] = 0.f;
            int prev = -1;
            for (int j = 0, kc = grp / PASSES % KCH; j < KCH; ++j, kc = next_mod(kc, KCH)) {
              WIDE_MARK(2);
              mbar_wait(s_full + 8 * slot, phase);
              WIDE_MARK(1);
              wgmma_fence();
#pragma unroll
              for (int ks = 0; ks < KS; ++ks)
                wgmma<TN>(acc, desc_t + ((slot * SLOT + ks * 32) >> 4),
                          desc_b + (((STG ? slot * SLOT : kc * TM * 128) + wg * TN * 128 +
                                     ks * 32) >> 4));
              wgmma_commit();
              if (prev >= 0) {
                wgmma_wait<1>();
                if (wi == 0 && lane < int(ncta)) mbar_arrive_cluster(s_empty + 8 * prev, lane);
              }
              prev = slot;
              if (++slot == NS) slot = 0, phase ^= 1;
            }
            wgmma_wait<0>();
            fence_acc(acc);
            if (wi == 0 && lane < int(ncta)) mbar_arrive_cluster(s_empty + 8 * prev, lane);
            WIDE_MARK(2);
            const int cb = pass * CHUNK_ROWS + 16 * wi;
            if (wg == 0) epilogue(cb, acc, std::integral_constant<int, 0>{});
            else epilogue(cb, acc, std::integral_constant<int, NB / 2>{});
            WIDE_MARK(4);
            continue;
          }
        }
        float acc[TM / 2];
#pragma unroll
        for (int k = 0; k < TM / 2; ++k) acc[k] = 0.f;
        int prev = -1;
        for (int j = 0, kc = grp / PASSES % KCH; j < KCH; ++j, kc = next_mod(kc, KCH)) {
          WIDE_MARK(2);
          mbar_wait(s_full + 8 * slot, phase);
          WIDE_MARK(1);
          wgmma_fence();
#ifdef DBLOCK_PLANT_TAIL_FAULT
          for (int ks = 0; ks < CHUNK_K / 16 - int(is_tail(pass)); ++ks)
#else
#pragma unroll
          for (int ks = 0; ks < CHUNK_K / 16; ++ks)
#endif
            wgmma<TM>(acc, desc_a + ((slot * SLOT + ks * 32) >> 4),
                      desc_b + (((STG ? slot * SLOT : kc * TM * 128) + ks * 32) >> 4));
          wgmma_commit();
          if (prev >= 0) {  // the previous chunk's products are done: free its slot
            wgmma_wait<1>();
            if (wi == 0 && lane < int(ncta)) mbar_arrive_cluster(s_empty + 8 * prev, lane);
          }
          prev = slot;
          if (++slot == NS) slot = 0, phase ^= 1;
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (wi == 0 && lane < int(ncta)) mbar_arrive_cluster(s_empty + 8 * prev, lane);
        WIDE_MARK(2);
        // the staged build's tail pass: warpgroup 0 takes the chunk's 64
        // rows for every pixel; warpgroup 1's products read the slot's
        // stale upper half and are dropped (a tail split as in the other
        // builds spilled the staged build past its 168 registers)
        bool dropped = false;
        if constexpr (STG) dropped = wg == 1 && is_tail(pass);
        if (!dropped)
          epilogue(pass * CHUNK_ROWS + r0 + 16 * wi, acc, std::integral_constant<int, 0>{});
        WIDE_MARK(4);
      }
      if (emit_rgb) reduce_rgb();

      // ToRGB: the eight warps' sums over their channels added in order (+
      // brgb and the upsampled skip in K3), as float4 runs over the tile's
      // output rows
      consumer_sync();  // the partials are complete
      if (emit_rgb && live)
        for (int u = tid; u < TM * 3 / 4; u += WIDE_CONSUMERS) {
          const int f = 4 * u, par = f / (3 * TW), fr = f % (3 * TW);
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = (f + e) / 3, jj = (f + e) % 3;
            float a = rgbp[p * 3 + jj];
#pragma unroll
            for (int k = 1; k < 8; ++k) a = __fadd_rn(a, rgbp[(k * TM + p) * 3 + jj]);
            if constexpr (RGB_BF16)
              a = __fadd_rn(__fadd_rn(a, P.brgb[jj]),
                            skip_up(P.skip, hp, wp, 2 * rf + p / TW, 2 * c0 + p % TW, jj));
            o[e] = a;
          }
          *reinterpret_cast<float4*>(P.rgb + (out0 + size_t(par) * wo) * 3 + fr) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      WIDE_MARK(4);
    }
  }
#ifdef DBLOCK_PHASE_CLOCKS
  if (lane == 0)
    for (int k = 0; k < NWIDE_PHASES; ++k) atomicAdd(&g_wide_cycles[k], wide_cyc[k]);
#endif
  cluster_sync();  // no CTA leaves while a peer may still copy into it or arrive on it
}

// Launches the instantiation, or with `info` (INFO_VALUES ints) fills in
// its shared memory bytes, blocks an SM, registers a thread, local (spill)
// bytes a thread, input columns a tile, output pixels a tile, CTAs a
// cluster and the clusters (blocks, for block_kernel) the card holds at
// once, and launches nothing.
constexpr int INFO_VALUES = 8;

template <typename K>
cudaError_t kernel_info(K kernel, int smem, int threads, int tw_in, int tm, int cluster,
                        int resident, int* info) {
  cudaError_t err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  const int vals[INFO_VALUES] = {smem, per_sm, attr.numRegs, int(attr.localSizeBytes),
                                 tw_in, tm, cluster, resident};
  for (int i = 0; i < INFO_VALUES; ++i) info[i] = vals[i];
  return cudaSuccess;
}

template <typename K>
int launch_kernel(K kernel, int smem, int tw_in, int tm, const Params& P, cudaStream_t stream,
                  int* info) {
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
  if (info != nullptr)
    return int(kernel_info(kernel, smem, NTHREADS, tw_in, tm, 1, sms * per_sm, info));
  const int n_tiles = P.frames * P.hp * ((P.wp + tw_in - 1) / tw_in);
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_tiles) blocks = n_tiles;
  kernel<<<blocks, NTHREADS, smem, stream>>>(P);
  return int(cudaGetLastError());
}

template <int C, typename T, bool HASH, bool RGB_BF16>
int launch(const Params& P, cudaStream_t stream, int* info) {
  return launch_kernel(block_kernel<C, T, HASH, RGB_BF16>, int(sizeof(Smem<C, T, HASH>)),
                       Geo<C, T>::TW_IN, Geo<C, T>::TM, P, stream, info);
}

// block_kernel_wide on a persistent grid of clusters: as many as the card
// holds at once (cudaOccupancyMaxActiveClusters), at most one a tile
// group. A cluster the card cannot place is an error, never a fallback.
// The shared-memory limit (the most any C takes) is set once a device and
// the cluster count found once a device and C (once a device in the
// staged build, whose shared memory is the same at every C), on the first
// launch; later launches read them. static: a template's local statics
// are otherwise one object across every build loaded in the process (GNU
// unique symbols), and another build's kernel would go without its
// setting. The staged build takes `scratch_bytes` of scratch at
// P.scratch, at least 128 C bytes a CTA of the grid (one CTA an SM at
// most), or returns cudaErrorInvalidValue.
constexpr int MAX_DEVICES = 16;
constexpr int WIDE_FROM = 192;                       // the least C the streamed kernel takes
// the counts the unstaged builds take: every multiple of 64 from WIDE_FROM
// to STAGED_FROM (one cached cluster count each)
constexpr int WIDE_CS = (STAGED_FROM - WIDE_FROM) / CHUNK_K + 1;

template <int TM, int CT, typename T, bool HASH, bool RGB_BF16>
static int launch_wide(const Params& P, cudaStream_t stream, int* info,
                       long long scratch_bytes) {
  using W = Wide<TM>;
  constexpr bool STG = CT == STAGED;
  auto kernel = block_kernel_wide<TM, CT, T, HASH, RGB_BF16>;
  static std::atomic<int> smem_set[MAX_DEVICES], clusters_at[MAX_DEVICES][STG ? 1 : WIDE_CS];
  const int smem = STG ? staged_smem_bytes<T>() : W::template smem_bytes<T>(P.c),
            cl = WIDE_CLUSTER;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= MAX_DEVICES) return int(cudaErrorInvalidDevice);
  if (!smem_set[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return int(err);
    smem_set[dev].store(1, std::memory_order_relaxed);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(WIDE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  std::atomic<int>& cached = clusters_at[dev][STG ? 0 : (P.c - WIDE_FROM) / CHUNK_K];
  int clusters = cached.load(std::memory_order_relaxed);
  if (clusters == 0) {
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess)
      return int(err);
    if (clusters < 1) return int(cudaErrorLaunchOutOfResources);
    cached.store(clusters, std::memory_order_relaxed);
  }
  if (info != nullptr)
    return int(kernel_info(kernel, smem, WIDE_THREADS, W::TW_IN, TM, cl, clusters, info));
  const int n_tiles = P.frames * P.hp * ((P.wp + W::TW_IN - 1) / W::TW_IN);
  const int groups = (n_tiles + cl - 1) / cl;
  cfg.gridDim = dim3((clusters < groups ? clusters : groups) * cl);
  if (STG && (P.scratch == nullptr ||
              (long long)cfg.gridDim.x * TM * 2 * P.c > scratch_bytes))
    return int(cudaErrorInvalidValue);
  if ((err = cudaLaunchKernelEx(&cfg, kernel, P)) != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// C = 16, 32, 64, 128 and 256: block_kernel; 192 and every multiple of 64
// from 320 up: block_kernel_wide (a tail pass where C % 128 == 64; C fixed
// at 192, 320, 384, 512, 1024 and 2048), its tile by C: 64 pixels to C =
// 1024 and 32 to 2048 with the bf16 activation tile in shared memory, 64
// pixels staged through the scratch past 2048. K2 and K3 take the same
// channel counts; the wrapper pads any other C with zeros up to the count
// it runs it at, and Wp up to a multiple of 16.
template <typename T, bool HASH, bool RGB_BF16>
int launch_c(int c, const Params& P, cudaStream_t s, int* info = nullptr,
             long long scratch_bytes = 0) {
  if (info == nullptr && (P.wp % 16 != 0 || P.frames < 1 || P.hp < 1))
    return int(cudaErrorInvalidValue);
  switch (c) {
    case 16: return launch<16, T, HASH, RGB_BF16>(P, s, info);
    case 32: return launch<32, T, HASH, RGB_BF16>(P, s, info);
    case 64: return launch<64, T, HASH, RGB_BF16>(P, s, info);
    case 128: return launch<128, T, HASH, RGB_BF16>(P, s, info);
    case 256: return launch<256, T, HASH, RGB_BF16>(P, s, info);
    default: break;
  }
  if (c < WIDE_FROM || c % CHUNK_K != 0 || P.c != c) return int(cudaErrorInvalidValue);
  // the 128^2 blocks of decoders at channel multipliers 3, 4, 8 and 16, and
  // the 1024^2 / 512^2 blocks multipliers 9-12 and 17 run at 192 and 320
  switch (c) {
    case 192: return launch_wide<64, 192, T, HASH, RGB_BF16>(P, s, info, 0);
    case 320: return launch_wide<64, 320, T, HASH, RGB_BF16>(P, s, info, 0);
    case 384: return launch_wide<64, 384, T, HASH, RGB_BF16>(P, s, info, 0);
    case 512: return launch_wide<64, 512, T, HASH, RGB_BF16>(P, s, info, 0);
    case 1024: return launch_wide<64, 1024, T, HASH, RGB_BF16>(P, s, info, 0);
    case 2048: return launch_wide<32, 2048, T, HASH, RGB_BF16>(P, s, info, 0);
    default: break;
  }
  if (c <= 1024) return launch_wide<64, 0, T, HASH, RGB_BF16>(P, s, info, 0);
  if (c <= STAGED_FROM) return launch_wide<32, 0, T, HASH, RGB_BF16>(P, s, info, 0);
  return launch_wide<STAGED_TM, STAGED, T, HASH, RGB_BF16>(P, s, info, scratch_bytes);
}

template <bool RGB_BF16>
int launch_mode(int c, int f32_storage, int hash, const Params& P, cudaStream_t s, int* info,
                long long scratch_bytes = 0) {
  if constexpr (RGB_BF16) return launch_c<float, false, true>(c, P, s, info, scratch_bytes);
  if (f32_storage)
    return hash ? launch_c<float, true, false>(c, P, s, info, scratch_bytes)
                : launch_c<float, false, false>(c, P, s, info, scratch_bytes);
  return hash ? launch_c<__nv_bfloat16, true, false>(c, P, s, info, scratch_bytes)
              : launch_c<__nv_bfloat16, false, false>(c, P, s, info, scratch_bytes);
}

}  // namespace dblock

// Both entries: past C = 2048 (the staged build) `scratch` is
// `scratch_bytes` of device memory, at least 128 C bytes a CTA of the
// grid, one CTA an SM at most (cudaErrorInvalidValue otherwise); w2t is
// then not read. At C <= 2048 the scratch is not read.
extern "C" int decoder_block_forward(
    const void* y1, const void* n1, const void* n2, const void* w2t, const void* w2c,
    const float* b1, const float* b2, const float* nw, const void* wrgbt,
    void* feat, float* rgb, int frames, int hp, int wp, int c, int f32_storage,
    int hash, int hash_wo, unsigned int seed1, unsigned int seed2, void* stream,
    void* scratch, long long scratch_bytes) {
  using namespace dblock;
  Params P{y1, n1, n2, {static_cast<const __nv_bfloat16*>(w2t)}, b1, b2, nw, wrgbt,
           nullptr, {nullptr}, feat, rgb, frames, hp, wp, seed1, seed2, c, w2c};
  P.hash_wo = hash_wo;
  if (c > STAGED_FROM) P.scratch = static_cast<unsigned char*>(scratch);
  return launch_mode<false>(c, f32_storage, hash, P, static_cast<cudaStream_t>(stream),
                            nullptr, scratch_bytes);
}

extern "C" int decoder_block_fused_forward(
    const float* y1, const float* skip, const float* n1, const float* n2,
    const void* w2t, const void* w2c, const float* b1, const float* b2, const float* nw,
    const void* wrgbt, const float* brgb, float* feat, float* rgb, int hp, int wp,
    int c, void* stream, void* scratch, long long scratch_bytes) {
  using namespace dblock;
  Params P{y1, n1, n2, {static_cast<const __nv_bfloat16*>(w2t)}, b1, b2, nw, wrgbt,
           skip, {brgb}, feat, rgb, 1, hp, wp, 0u, 0u, c, w2c};
  if (c > STAGED_FROM) P.scratch = static_cast<unsigned char*>(scratch);
  return launch_mode<true>(c, 1, 0, P, static_cast<cudaStream_t>(stream), nullptr,
                           scratch_bytes);
}

#ifdef DBLOCK_PHASE_CLOCKS
// Copies the `n` counts of `counts` to `out` and, with `reset`, sets them to 0.
template <size_t N>
int copy_cycles(const unsigned long long (&counts)[N], unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, counts, sizeof(counts));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[N] = {};
    err = cudaMemcpyToSymbol(counts, zero, sizeof(zero));
  }
  return int(err);
}

// block_kernel's phase counts (NPHASES values, returned through `n`)
extern "C" int decoder_block_phase_cycles(unsigned long long* out, int* n, int reset) {
  *n = dblock::NPHASES;
  return copy_cycles(dblock::g_phase_cycles, out, reset);
}

// block_kernel_wide's phase counts (NWIDE_PHASES values)
extern "C" int decoder_block_wide_phase_cycles(unsigned long long* out, int* n, int reset) {
  *n = dblock::NWIDE_PHASES;
  return copy_cycles(dblock::g_wide_cycles, out, reset);
}
#endif

extern "C" int decoder_block_info(int c, int f32_storage, int hash, int k3, int* info) {
  using namespace dblock;
  Params P{};
  P.c = c;
  return k3 ? launch_mode<true>(c, 1, 0, P, nullptr, info)
            : launch_mode<false>(c, f32_storage, hash, P, nullptr, info);
}
