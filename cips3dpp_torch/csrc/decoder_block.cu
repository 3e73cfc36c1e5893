// The fused CIPS-decoder upsample block for Hopper (sm_90a), with three entry
// points at the end of this file:
//   - decoder_block_forward (K2): replaces the Pallas TPU kernel
//     cips3dpp_tpu/kernels/decoder_block.py:_packed_kernel, the serving block
//     with bf16 or f32 storage, noise from buffers or hashed in the kernel,
//     F frames stacked on rows and an optional ToRGB fold, at C = 16, 32,
//     64, 128, 256 (block_kernel) and every multiple of 128 from 384 to
//     2048 (block_kernel_wide);
//   - decoder_block_fused_forward (K3): replaces _block_kernel (the v1 block,
//     f32 in and out, the same channel counts), which adds the ToRGB bias
//     and the upsampled RGB skip;
//     the row halo the TPU kernel took from three host-side row-shifted
//     copies is read from y1 and skip in the kernel;
//   - decoder_block_info: shared memory, blocks an SM, registers, local
//     memory and tile width of one instantiation (nothing is launched).
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
//    k-step. C = 384 to 2048 (the 64^2 to 256^2 blocks of decoders at
//    channel multipliers 4, 8 and 16) have a kernel of their own,
//    block_kernel_wide below: their weight cannot stay in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
  int c;                 // channels (block_kernel_wide; block_kernel's is a template argument)
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
// p = par * TW + output column, row stride ld) at channels ch .. ch+3.
// nz1: the tile's noise1 by output pixel; bb: b1 at those channels.
template <int TW, typename NZ>
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
        *reinterpret_cast<uint2*>(act + p * ld + ch) =
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
        sm.nz[s][m][p] = hash_normal(uint32_t(orow) * uint32_t(wo) + uint32_t(ocol),
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

// ---- C = 384 to 2048: block_kernel_wide, the conv_b weight streamed ----
//
// From C = 384 up, conv_b's weight (C x C bf16: 288 KB at 384, 8 MB at
// 2048) cannot stay in shared memory as in block_kernel. Every byte of it
// read from L2 has to serve as many pixels as shared memory allows, so the
// tile is one input row x TW_IN input columns whose bf16 activation tile
// (TM x C, 100-131 KB) stays in shared memory while conv_b walks C / 128
// passes of NB = 128 output columns, each over C / 64 k-chunks of KC = 64
// input channels. C is taken at run time; the tile (TM = 128 output pixels
// at C <= 512, 64 at C <= 1024, 32 at C <= 2048: 2 output rows x TM / 2
// columns, TW_IN = TM / 4) and the warp layout are a template argument.
// The counts the shipped multipliers' blocks reach (512, 1024, 2048) are
// also built with C fixed at compile time (CT), which folds the index
// arithmetic a run-time C costs; the same source serves both.
// The weight's (128, 64) chunks stream through an NS-slot cp.async ring,
// NS - 1 chunks ahead, across tile boundaries, so a tile reads the whole
// weight from L2 once: 64 MB of L2 reads for the 128^2 block of m = 4
// (three times its ~21 MB of HBM bytes), 512 MB at y1 (64, 64, 1024) and
// 4 GB at (64, 64, 2048). That L2 stream is what bounds this simple first
// design from C = 1024 up; a cluster sharing each chunk (TMA multicast
// into distributed shared memory) would cut it. The upsample reads y1
// straight from global memory (L2: the input is resident), no staging
// ring: shared memory is the activation tile and the weight ring. Every
// rounding point, the modes (K3's bf16 ToRGB operands, bias and upsampled
// skip included), the frames, the ragged last tile (at TM = 128 only: Wp
// is a multiple of 16), the skipped feat store and the folded ToRGB are
// block_kernel's; ToRGB sums a pixel's C channels in a fixed order (pass by
// pass in a thread, then lanes by shuffles, then the NW column-group
// partials in order), so two launches give the same bits. At C = 512 the
// tile, the layout and the order are those this kernel had when 512 was
// its only C.
template <int TM_>
struct Wide {
  static constexpr int TM = TM_;                     // output pixels a tile
  static constexpr int TW = TM / 2;                  // output columns a tile row
  static constexpr int TW_IN = TW / 2;               // input columns a tile
  static constexpr int NB = 128;                     // conv_b output columns a pass
  static constexpr int KC = 64;                      // input channels a weight chunk
  // weight ring slots: three at TM = 32, where the activation tile of C =
  // 2048 leaves no room for a fourth
  static constexpr int NS = TM == 32 ? 3 : 4;
  static constexpr int NW = TM == 128 ? 2 : 4;       // warps across a pass's columns
  static constexpr int MW = 8 / NW;                  // warps across the pixels
  static constexpr int MT = TM / 16 / MW;            // m-tiles of 16 pixels a warp
  static constexpr int NT = NB / NW / 8;             // n-tiles of 8 columns a warp
  static constexpr int WLD = KC + 8;                 // weight chunk row stride (bf16)
  static_assert(MT >= 1 && MT * 16 * MW == TM && NT % 2 == 0, "warp layout");

  // Shared memory at C channels, in order: the bf16 activation tile (row
  // stride C + 8), the weight ring, noise1 / noise2 of the tile, b1, b2,
  // wrgb (j, k) and the column groups' ToRGB partials; every part 16-byte
  // aligned (C is a multiple of 128).
  __host__ __device__ static constexpr size_t act_bytes(int c) { return size_t(TM) * (c + 8) * 2; }
  __host__ __device__ static constexpr size_t ring_bytes() { return size_t(NS) * NB * WLD * 2; }
  __host__ __device__ static constexpr size_t smem_bytes(int c) {
    return act_bytes(c) + ring_bytes() + 4 * (2 * TM + 5 * size_t(c) + NW * TM * 3);
  }
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// CT: C fixed at compile time (the channel counts of the shipped
// multipliers' blocks), or 0: C taken from P.c at run time.
template <int TM, int CT, typename T, bool HASH, bool RGB_BF16>
__global__ void __launch_bounds__(NTHREADS, 1) block_kernel_wide(const Params P) {
  using W = Wide<TM>;
  constexpr int TW_IN = W::TW_IN, TW = W::TW, NB = W::NB, KC = W::KC, NW = W::NW,
                MT = W::MT, NT = W::NT, WLD = W::WLD, NS = W::NS;
  constexpr bool F32 = std::is_same<T, float>::value;
  static_assert(F32 || !RGB_BF16, "K3 stores f32");
  using WT = typename std::conditional<RGB_BF16, __nv_bfloat16, T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = CT > 0 ? CT : P.c, LD = C + 8;  // LD: act row stride (bf16)
  const int KCH = C / KC;         // chunks a pass
  const int CHUNKS = (C / NB) * KCH;  // chunks a tile
  __nv_bfloat16* const act = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* const wring = reinterpret_cast<__nv_bfloat16*>(smem_raw + W::act_bytes(C));
  float* const nz = reinterpret_cast<float*>(smem_raw + W::act_bytes(C) + W::ring_bytes());
  float* const b1 = nz + 2 * TM;
  float* const b2 = b1 + C;
  float* const wrgb = b2 + C;
  float* const rgbp = wrgb + 3 * C;
  const T* __restrict__ y1 = static_cast<const T*>(P.y1);
  const WT* __restrict__ wrgbt = static_cast<const WT*>(P.wrgbt);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mg = warp / NW, nq = warp % NW;  // pixel group, column group
  const int hp = P.hp, wp = P.wp, wo = 2 * wp;
  const int segs = (wp + TW_IN - 1) / TW_IN;
  const int n_tiles = P.frames * hp * segs;
  const int my_chunks = (n_tiles - 1 - int(blockIdx.x)) / int(gridDim.x) * CHUNKS + CHUNKS;
  const float nw1 = P.nw[0], nw2 = P.nw[1];
  const bool emit_rgb = P.rgb != nullptr;
  T* feat = static_cast<T*>(P.feat);

  // The block's chunks are loaded in sequence, CHUNKS a tile: chunk lq
  // holds output columns ln0 .. ln0+NB-1 (the pass) and input channels
  // lk0 .. lk0+KC-1 (the k-chunk) of the weight and goes to ring slot
  // lq % NS; past the block's last tile the copy group stays empty. The
  // position advances by adds, not by divisions by the run-time C.
  int lq = 0, ln0 = 0, lk0 = 0;
  auto load_next = [&]() {
    if (lq < my_chunks) {
      __nv_bfloat16* dst = wring + (lq % NS) * NB * WLD;
      const __nv_bfloat16* src = P.w2t + size_t(ln0) * C + lk0;
      for (int i = tid; i < NB * (KC / 8); i += NTHREADS) {
        const int n = i / (KC / 8), u = i % (KC / 8);
        cp_async16(dst + n * WLD + u * 8, src + size_t(n) * C + u * 8);
      }
      if ((lk0 += KC) == C) {
        lk0 = 0;
        if ((ln0 += NB) == C) ln0 = 0;
      }
    }
    ++lq;
  };
  for (int i = 0; i < NS - 1; ++i) {
    load_next();
    cp_async_commit();
  }
  for (int i = tid; i < C; i += NTHREADS) {
    b1[i] = P.b1[i];
    b2[i] = P.b2[i];
  }
  if (wrgbt != nullptr)
    for (int i = tid; i < 3 * C; i += NTHREADS) wrgb[i] = to_f(wrgbt[i]);

  // ldmatrix rows: A pixel (lane & 15) at k + (lane >> 4) * 8; B output
  // column (lane & 7) + (lane >> 4) * 8 at k + ((lane >> 3) & 1) * 8
  const uint32_t a_addr = smem_u32(act + (mg * MT * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const int b_off = (nq * NT * 8 + (lane & 7) + (lane >> 4) * 8) * WLD + ((lane >> 3) & 1) * 8;
  // the upsample's items: the thread's first (group cg0 of pair jp0) and
  // the stride of NTHREADS items in groups and pairs
  const int groups = C / 4, cg0 = tid % groups, jp0 = tid / groups;
  const int dcg = NTHREADS % groups, djp = NTHREADS / groups;

  int q = 0;  // the next chunk to multiply
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r = tile / segs, rf = r % hp, c0 = (tile % segs) * TW_IN;
    const size_t out0 = size_t(2 * r) * wo + 2 * c0;  // the tile's first output pixel

    // the tile's noise in f32 (buffer values are exact in f32), 0 past the row's end
    for (int i = tid; i < 2 * TM; i += NTHREADS) {
      const int m = i / TM, p = i % TM;
      const int orow = 2 * rf + p / TW, ocol = 2 * c0 + p % TW;
      if constexpr (HASH) {
        nz[i] = hash_normal(uint32_t(orow) * uint32_t(wo) + uint32_t(ocol),
                            m ? P.seed2 : P.seed1);
      } else {
        const T* nb = static_cast<const T*>(m ? P.n2 : P.n1);
        nz[i] = ocol < wo ? to_f(nb[size_t(orow) * wo + ocol]) : 0.f;
      }
    }
    __syncthreads();  // noise staged; every warp is done with the last tile

    // Upsample + noise1 + b1 + lrelu -> the bf16 activation tile, as
    // block_kernel's: an item is channels ch .. ch+3 (group cg) of input
    // columns j0, j0+1 (pair jp; their neighbours j0-1 .. j0+2 read, zero
    // outside the frame); the C / 4 x TW_IN / 2 items are strided over the
    // threads, group fastest
    {
      const T* frame = y1 + size_t(r - rf) * wp * C;  // the frame's first row
      for (int cg = cg0, jp = jp0; jp < TW_IN / 2;) {
        const int ch = 4 * cg, j0 = 2 * jp;
        const float4 b1v = *reinterpret_cast<const float4*>(b1 + ch);
        const float bb[4] = {b1v.x, b1v.y, b1v.z, b1v.w};
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
        column_pass<TW>(x, bb, nw1, nz, j0, ch, act, LD);
        cg += dcg, jp += djp;  // the next item: NTHREADS on
        if (cg >= groups) cg -= groups, ++jp;
      }
    }
    __syncthreads();  // the activation tile is complete

    bool inside[MT];  // an m-tile lies in one output row, inside or past its end
    size_t px0[MT];   // its first output pixel
    float z[MT][2];   // nw2 * noise2 of rows g, g + 8
    float srgb[MT][2][3];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int pm = (mg * MT + i) * 16;
      inside[i] = 2 * c0 + pm % TW < wo;
      px0[i] = out0 + size_t(pm / TW) * wo + pm % TW;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        z[i][rr] = __fmul_rn(nw2, nz[TM + pm + g + 8 * rr]);
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) srgb[i][rr][jj] = 0.f;
      }
    }

    for (int pass = 0; pass < C / NB; ++pass) {
      float acc[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.f;
      for (int kc = 0; kc < KCH; ++kc, ++q) {
        cp_async_wait<NS - 2>();
        __syncthreads();  // chunk q landed; every warp is done with slot (q - 1) % NS
        load_next();      // chunk q + NS - 1
        cp_async_commit();
        const uint32_t b_addr = smem_u32(wring + (q % NS) * NB * WLD + b_off);
#pragma unroll
        for (int k = 0; k < KC; k += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            ldmatrix_x4(a[i], a_addr + 2 * (i * 16 * LD + kc * KC + k));
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t b[4];  // b0, b1 of n-tile 2jp, then of 2jp + 1
            ldmatrix_x4(b, b_addr + 2 * (jp * 16 * WLD + k));
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
              mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
            }
          }
        }
      }

      // the pass's epilogue: noise2 + b2 + lrelu (rounded to bf16 where the
      // storage is bf16), feat stores, ToRGB partial sums
      const int col0 = pass * NB + nq * NT * 8;  // the warp's first output column
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        float v[MT][2][2][2];  // [m-tile][n-tile of the pair][row g, g + 8][column 2t, 2t + 1]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jn = 2 * jp + h, ch = col0 + jn * 8 + 2 * t;
          const float2 bb = *reinterpret_cast<const float2*>(b2 + ch);
          float2 w[3];
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) w[jj] = *reinterpret_cast<const float2*>(wrgb + jj * C + ch);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float v0 = lrelu(__fadd_rn(__fadd_rn(acc[i][jn][2 * rr], z[i][rr]), bb.x));
              float v1 = lrelu(__fadd_rn(__fadd_rn(acc[i][jn][2 * rr + 1], z[i][rr]), bb.y));
              if constexpr (!F32) {
                const float2 f = unpack_bf16(pack_bf16(v0, v1));
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
              if (!inside[i]) continue;
              T* dst = feat + (px0[i] + g + 8 * rr) * C + ch;
              if constexpr (F32)
                *reinterpret_cast<float4*>(dst) = o;
              else  // the values are bf16 already: packing is exact
                *reinterpret_cast<uint2*>(dst) =
                    make_uint2(pack_bf16(o.x, o.y), pack_bf16(o.z, o.w));
            }
        }
      }
    }

    // ToRGB: a thread's sums over its lanes' channels, then the column
    // groups' partials in order (+ brgb and the upsampled skip in K3), as
    // float4 runs over the tile's output rows
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
              rgbp[(nq * TM + (mg * MT + i) * 16 + g + 8 * rr) * 3 + jj] = srgb[i][rr][jj];
    }
    __syncthreads();  // the partials are complete
    if (emit_rgb)
      for (int u = tid; u < TM * 3 / 4; u += NTHREADS) {
        const int f = 4 * u, par = f / (3 * TW), fr = f % (3 * TW);
        if (2 * c0 + fr / 3 >= wo) continue;  // past the row's end (32-pixel aligned)
        float4 a = *reinterpret_cast<const float4*>(rgbp + f);
#pragma unroll
        for (int qn = 1; qn < NW; ++qn) {
          const float4 b = *reinterpret_cast<const float4*>(rgbp + qn * TM * 3 + f);
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
  }
  cp_async_wait_all();
}

// Launches the instantiation, or with `info` (6 ints) fills in its shared
// memory bytes, blocks an SM, registers a thread, local (spill) bytes a
// thread, input columns a tile and output pixels a tile, and launches nothing.
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
  if (info != nullptr) {
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return int(err);
    const int vals[6] = {smem, per_sm, attr.numRegs, int(attr.localSizeBytes), tw_in, tm};
    for (int i = 0; i < 6; ++i) info[i] = vals[i];
    return 0;
  }
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

template <int TM, int CT, typename T, bool HASH, bool RGB_BF16>
int launch_wide(const Params& P, cudaStream_t stream, int* info) {
  using W = Wide<TM>;
  return launch_kernel(block_kernel_wide<TM, CT, T, HASH, RGB_BF16>, int(W::smem_bytes(P.c)),
                       W::TW_IN, W::TM, P, stream, info);
}

// C = 16 to 256: block_kernel; every multiple of 128 from 384 to 2048:
// block_kernel_wide, its tile by C. K2 and K3 take the same channel counts.
template <typename T, bool HASH, bool RGB_BF16>
int launch_c(int c, const Params& P, cudaStream_t s, int* info = nullptr) {
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
  if (c < 384 || c > 2048 || c % 128 != 0 || P.c != c) return int(cudaErrorInvalidValue);
  switch (c) {  // the blocks of decoders at channel multipliers 4, 8 and 16
    case 512: return launch_wide<128, 512, T, HASH, RGB_BF16>(P, s, info);
    case 1024: return launch_wide<64, 1024, T, HASH, RGB_BF16>(P, s, info);
    case 2048: return launch_wide<32, 2048, T, HASH, RGB_BF16>(P, s, info);
    default: break;
  }
  if (c <= 512) return launch_wide<128, 0, T, HASH, RGB_BF16>(P, s, info);
  if (c <= 1024) return launch_wide<64, 0, T, HASH, RGB_BF16>(P, s, info);
  return launch_wide<32, 0, T, HASH, RGB_BF16>(P, s, info);
}

template <bool RGB_BF16>
int launch_mode(int c, int f32_storage, int hash, const Params& P, cudaStream_t s, int* info) {
  if constexpr (RGB_BF16) return launch_c<float, false, true>(c, P, s, info);
  if (f32_storage)
    return hash ? launch_c<float, true, false>(c, P, s, info)
                : launch_c<float, false, false>(c, P, s, info);
  return hash ? launch_c<__nv_bfloat16, true, false>(c, P, s, info)
              : launch_c<__nv_bfloat16, false, false>(c, P, s, info);
}

}  // namespace dblock

extern "C" int decoder_block_forward(
    const void* y1, const void* n1, const void* n2, const void* w2t,
    const float* b1, const float* b2, const float* nw, const void* wrgbt,
    void* feat, float* rgb, int frames, int hp, int wp, int c, int f32_storage,
    int hash, unsigned int seed1, unsigned int seed2, void* stream) {
  using namespace dblock;
  Params P{y1, n1, n2, static_cast<const __nv_bfloat16*>(w2t), b1, b2, nw, wrgbt,
           nullptr, nullptr, feat, rgb, frames, hp, wp, seed1, seed2, c};
  return launch_mode<false>(c, f32_storage, hash, P, static_cast<cudaStream_t>(stream),
                            nullptr);
}

extern "C" int decoder_block_fused_forward(
    const float* y1, const float* skip, const float* n1, const float* n2,
    const void* w2t, const float* b1, const float* b2, const float* nw,
    const void* wrgbt, const float* brgb, float* feat, float* rgb, int hp, int wp,
    int c, void* stream) {
  using namespace dblock;
  Params P{y1, n1, n2, static_cast<const __nv_bfloat16*>(w2t), b1, b2, nw, wrgbt,
           skip, brgb, feat, rgb, 1, hp, wp, 0u, 0u, c};
  return launch_mode<true>(c, 1, 0, P, static_cast<cudaStream_t>(stream), nullptr);
}

#ifdef DBLOCK_PHASE_CLOCKS
// Copies the phase counts to `out` (NPHASES values) and, with `reset`, sets
// them to 0. Returns NPHASES through `n`.
extern "C" int decoder_block_phase_cycles(unsigned long long* out, int* n, int reset) {
  *n = dblock::NPHASES;
  cudaError_t err = cudaMemcpyFromSymbol(out, dblock::g_phase_cycles, sizeof(dblock::g_phase_cycles));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[dblock::NPHASES] = {};
    err = cudaMemcpyToSymbol(dblock::g_phase_cycles, zero, sizeof(zero));
  }
  return int(err);
}
#endif

extern "C" int decoder_block_info(int c, int f32_storage, int hash, int k3, int* info) {
  using namespace dblock;
  Params P{};
  P.c = c;
  return k3 ? launch_mode<true>(c, 1, 0, P, nullptr, info)
            : launch_mode<false>(c, f32_storage, hash, P, nullptr, info);
}
