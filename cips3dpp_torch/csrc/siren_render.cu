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
// What bounds it on the H100: operations, on two pipes. At the serving shape
// (4096 rays x 24 samples, width 256) the two (rows,256)@(256,256) products
// are 25.8 GFLOP of bf16: >= 26 us at 989 TFLOP/s on the tensor cores. The
// rest is ~1.53 G f32 operations on the CUDA cores. The phases, the 75M
// polynomial sines and the feat sums (1.18 G) keep products and sums rounded
// apart to match the plain version, so they cannot contract to FMA and each
// issues as one instruction, at half the 67 TFLOP/s FMA peak: >= 35 us. The
// dot products of layer 0 and the two heads (0.35 G) may contract: >= 5 us.
// So >= ~41 us on the f32 pipe; the I/O is ~7 MB (2 us). The f32 pipe is the
// floor this design is up against: the tensor work is the smaller of the
// two, so wgmma would not lower the floor. A block runs its products and its
// sine epilogues in turn, between barriers, so the two pipes rarely work at
// once and the time is nearer their sum than the larger; overlapping them
// needs warps specialised by role.
//
// Design:
//  - Persistent blocks: the entry point launches one block per SM, and each
//    block walks the 8-ray tiles blockIdx.x, blockIdx.x + gridDim.x, ...
//    It loads and rounds its constants (w0, wvv, wrgb, wsdf to bf16; g*, be*,
//    bev) into shared memory once, not once a tile.
//  - A tile is 8 rays x 24 samples = 192 rows, sample-major (row = s*8 + ray),
//    so the rows g and g+8 of a thread's mma.sync accumulators are two
//    samples of the same ray. 12 warps = 3 row groups (4 row tiles of 16)
//    x 4 column quarters (8 n-tiles of 8): 128 f32 accumulators a thread.
//  - Both 256x256 products run on the tensor cores with mma.sync m16n8k16
//    (bf16 operands through ldmatrix, f32 accumulation). The 192 x 256 bf16
//    activation tile stays in shared memory. The weights, stored (out, in) =
//    (n, k), stream through a 3-stage ring of 32-wide K-chunks filled by
//    cp.async.cg, with one block barrier a chunk. The chunks of all of a
//    block's products form one stream (w1, wv, then w1 of the next tile, ...)
//    issued two chunks ahead, so the view weight's first chunks are in flight
//    while integration runs, and the next tile's first w1 chunks while its
//    inputs and layer 0 run. Each weight pass serves 192 rows: 134 MB from L2
//    to shared memory a launch at the serving shape (4-ray tiles would move
//    268 MB).
//  - Layer 0 (K=3) is on the CUDA cores, one column pair a thread with its
//    constants in registers. The head dot products (N=1, N=3) are reduced
//    over a warp's columns with shuffles and over the 4 column quarters from
//    shared-memory partials added in a fixed order.
//  - Integration: sigma, alpha and the sdf output in parallel over the 192
//    rows; the running transmittance product and xyz on one thread a ray;
//    w*sigmoid(rgb) in parallel over the rows beside the feat sums, then one
//    thread a (ray, channel) sums them. The view layer's features never reach
//    shared memory: each thread sums w*feat over its 8 samples (all one ray)
//    into the partial of its (row group, ray, column)s, which it alone owns
//    (25 KB in all; kept out of registers, which the 128 accumulators
//    fill), and the 3 partials are added in a fixed order. Every sum has a fixed
//    order, so two launches on the same inputs give the same bits.
//  - Same arithmetic as the TPU kernel: bias folded on the host as
//    beff = g*b + beta with the weights unfolded, the degree-9 range-reduced
//    polynomial sin, matmul inputs rounded to bf16, phase math and compositing
//    in f32 with products and sums kept separate (no contraction) where the
//    plain version has them separate.
//  - Rays past the end (R not a multiple of 8) read zeros and are not written.
//  - Built with -DSIREN_PHASE_CLOCKS, the kernel also counts each block's
//    clock cycles by phase (PHASE_MARK below); the plain build has no trace
//    of it.
//
// Other geometries. One library is built per (width, sample mode):
// -DK1_W=<32|64|128|256|512> picks the width and its tile layout below, and
// -DK1_FIXED_S=<S> fixes the sample count at compile time (0: the count is
// the launch's, any S >= 1). The build without flags is width 256 with S
// fixed at 24, the serving geometry, and compiles to the design above. A
// tile is TR rays x SC samples; a ray of S samples is walked in ceil(S/SC)
// chunks of SC, each a unit of the weight stream, carrying each ray's
// running transmittance, xyz, thumb sums and feat partials from chunk to
// chunk. The samples past S in the last chunk are computed on zeros and
// weigh 0, and the far gap (1e10) belongs to the last real sample: a
// chunk's last sample reads the next sample's depth from global memory.
// Every sum keeps a fixed order. TR divides 8, so the rows g and g+8 of a
// thread's accumulators stay on one ray; below TR = 8 a ray's samples are
// spread over 8/TR threads of a row tile, and the feat partials are kept
// by (row group, accumulator row g), then summed over the ray's g.
// Width 512 takes 2-ray tiles of 16 samples: the 123 KB weight ring and
// 33 KB of constants leave room for 32 rows of activations. Each 32-row
// unit then streams both 512 x 512 weights (1 MiB) from L2: 4.3 GB a
// launch at 4096 rays x 24 samples (two chunks a ray), 32x the serving
// build's 134 MB. That stream, not the operations, bounds this build.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef K1_W
#define K1_W 256
#endif
#ifndef K1_FIXED_S
#define K1_FIXED_S 24
#endif

namespace {

constexpr int W = K1_W;                // SIREN width
constexpr int FIXED_S = K1_FIXED_S;    // samples per ray; 0: the launch's
// TR rays a tile, SC samples a chunk, RG row groups x CQ column quarters
#if K1_W == 32
constexpr int TR = 8, SC = 24, RG = 3, CQ = 2;
#elif K1_W == 64 || K1_W == 128 || K1_W == 256
constexpr int TR = 8, SC = 24, RG = 3, CQ = 4;
#elif K1_W == 512
constexpr int TR = 2, SC = 16, RG = 1, CQ = 8;
#else
#error "K1_W must be 32, 64, 128, 256 or 512"
#endif
constexpr int M = TR * SC;             // rows per tile: 192 at width 256
constexpr int NWARPS = RG * CQ;        // 12 warps: (row group, column quarter)
constexpr int NTHREADS = 32 * NWARPS;
constexpr int RT = M / 16 / RG;        // 4 row tiles of 16 a warp
constexpr int NTW = W / CQ / 8;        // 8 n-tiles of 8 a warp
constexpr int KC = 32;                 // K chunk of the streamed weight
constexpr int NKC = W / KC;            // 8 chunks a product
constexpr int STAGES = 3;              // weight ring depth
constexpr int ACT_LD = W + 8;          // padded row strides (bf16): ldmatrix
constexpr int WC_LD = KC + 8;          // rows hit 8 distinct 16-byte units
constexpr int VEC_LD = W + 8;          // padded per-ray rows (f32)
constexpr int FG = 8 / TR;             // accumulator rows g of one ray
static_assert(8 % TR == 0 && M % (16 * RG) == 0 && NTW % 2 == 0 && W % KC == 0,
              "tile layout");

constexpr float INV_2PI = 0.15915494309189535f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float SC0 = 0.9999727636431689f;
constexpr float SC1 = -0.16661501432840328f;
constexpr float SC2 = 0.008305441787505873f;
constexpr float SC3 = -0.00019215724206787978f;
constexpr float SC4 = 2.125150239026409e-06f;

struct Integ {
  float alpha[M];
  float fac[M];                        // 1 - alpha + 1e-10
};

struct __align__(16) Smem {
  __nv_bfloat16 act[M * ACT_LD];       // activation tile, bf16
  __nv_bfloat16 ring[STAGES][W * WC_LD];  // weight K-chunks, (n, k)
  float featp[RG * 8 * VEC_LD];        // w*feat partials by (row group, g)
  float vphase[TR * VEC_LD];           // per-ray view phase gv*vterm + bev
  float w0[3 * W];                     // (k, n), bf16-rounded
  float wvv[3 * W];                    // (k, n), bf16-rounded
  float wrgb[W * 3];                   // (n, j), bf16-rounded
  float g0[W], be0[W], g1[W], be1[W], gv[W], bev[W];
  float wsdf[W];                       // bf16-rounded
  union {
    float sdf[CQ * M];                 // sdf head partials by column quarter
    float rgb[CQ * M * 3];             // rgb head partials by column quarter
  } head;
  union {
    Integ it;
    float wsig[M * 3];                 // w * sigmoid(rgb + brgb)
  } rows;
  float pts[M * 3];
  float xs[M * 3];                     // bf16(pts * scale)
  float z[M];
  float wgt[M];                        // compositing weights
  float dnorm[TR];
  float carry[TR * 4];                 // per ray, chunk to chunk: trans, xyz
  float tcarry[TR * 3];                // thumb sums, chunk to chunk
};
static_assert(sizeof(Smem) <= 232448, "shared memory over the 227 KB a block may use");
static_assert(NTHREADS % (W / 2) == 0, "layer 0 gives each thread one column pair");

#ifdef SIREN_PHASE_CLOCKS
// Instrumented build only (python -m cips3dpp_torch.tools.siren_phase_split):
// at each mark, after a block barrier (some of them added by the mark),
// thread 0 adds the SM clock cycles since the previous mark to that phase's
// counter, so a phase's count is the blocks' time in it, waits included.
constexpr int NPHASES = 11;
__device__ unsigned long long g_phase_cycles[NPHASES];
#define PHASE_MARK(k)                                                      \
  do {                                                                     \
    __syncthreads();                                                       \
    if (tid == 0) {                                                        \
      const long long now = clock64();                                     \
      atomicAdd(&g_phase_cycles[k], (unsigned long long)(now - mark));     \
      mark = now;                                                          \
    }                                                                      \
  } while (0)
#else
#define PHASE_MARK(k) \
  do {                \
  } while (0)
#endif

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

// a and b rounded to bf16 as one packed pair (one conversion), and the two
// rounded values back as floats from its bits
__device__ __forceinline__ __nv_bfloat162 pack_bf16(float a, float b, float& ra, float& rb) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&p);
  ra = __uint_as_float(u << 16);
  rb = __uint_as_float(u & 0xffff0000u);
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Chunk q of the block's weight stream: K-chunk q % NKC of w1t when q / NKC
// is even (layer 1) and of wvht when it is odd (the view layer), copied into
// ring stage q % STAGES. Every thread commits one group a chunk, an empty
// one past the block's last chunk, so that wait_group counts chunks.
__device__ __forceinline__ void issue_chunk(Smem& sm, const __nv_bfloat16* __restrict__ w1t,
                                            const __nv_bfloat16* __restrict__ wvht, int q,
                                            int q_end) {
  if (q < q_end) {
    const __nv_bfloat16* src = ((q / NKC) & 1 ? wvht : w1t) + (q % NKC) * KC;
    __nv_bfloat16* dst = sm.ring[q % STAGES];
    for (int i = threadIdx.x; i < W * (KC / 8); i += NTHREADS) {
      const int n = i / (KC / 8), c = (i % (KC / 8)) * 8;
      cp_async16(dst + n * WC_LD + c, src + n * W + c);
    }
  }
  cp_async_commit();
}

// acc = act (M x W, bf16) @ w^T over the warp's 64 rows x 64 columns, the
// weight arriving as chunks q0 .. q0 + NKC - 1 of the stream. The one barrier
// a chunk publishes chunk q (each thread waited for its own copies) and
// frees the stage read at q - 1, which then takes chunk q + STAGES - 1.
__device__ __forceinline__ void gemm(Smem& sm, const __nv_bfloat16* __restrict__ w1t,
                                     const __nv_bfloat16* __restrict__ wvht, int q0, int q_end,
                                     float (&acc)[RT][NTW][4], int rg, int cq, int lane) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // ldmatrix row addresses (shared space, bytes): A rows (lane & 15) at
  // k + (lane >> 4) * 8; B rows n (lane & 7) + (lane >> 4) * 8 at
  // k + ((lane >> 3) & 1) * 8
  const uint32_t a_addr =
      smem_u32(sm.act) + 2 * ((rg * RT * 16 + (lane & 15)) * ACT_LD + (lane >> 4) * 8);
  const uint32_t b_addr = smem_u32(sm.ring[0]) +
      2 * ((cq * (W / CQ) + (lane & 7) + (lane >> 4) * 8) * WC_LD + ((lane >> 3) & 1) * 8);
  for (int kc = 0; kc < NKC; ++kc) {
    const int q = q0 + kc;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue_chunk(sm, w1t, wvht, q + STAGES - 1, q_end);
    const uint32_t wc = b_addr + 2 * (q % STAGES) * (W * WC_LD);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[RT][4];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        ldmatrix_x4(a[i], a_addr + 2 * (i * 16 * ACT_LD + kc * KC + ks * 16));
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        uint32_t b[4];  // b0, b1 of n-tile 2jp, then of 2jp + 1
        ldmatrix_x4(b, wc + 2 * (jp * 16 * WC_LD + ks * 16));
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
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
    float* __restrict__ maskd, float* __restrict__ sdf_out, int n_rays,
    int n_samples) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / CQ, cq = warp % CQ;
  // samples a ray, and chunks of SC a ray: compile-time in a fixed build
  const int S = FIXED_S > 0 ? FIXED_S : n_samples;
  const int nch = (S + SC - 1) / SC;
  const int n_tiles = (n_rays + TR - 1) / TR;
  if (int(blockIdx.x) >= n_tiles) return;
  const int q_end = 2 * NKC * nch * ((n_tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1);
#ifdef SIREN_PHASE_CLOCKS
  long long mark = clock64();
#endif

  // ---- the first weight chunks, then the constants, once a block ----
  for (int q = 0; q < STAGES - 1; ++q) issue_chunk(sm, w1t, wvht, q, q_end);
  for (int i = tid; i < 3 * W; i += NTHREADS) {
    sm.w0[i] = bfr(w0[i]);
    sm.wvv[i] = bfr(wvv[i]);
    sm.wrgb[i] = bfr(wrgb[i]);
  }
  for (int i = tid; i < W; i += NTHREADS) {
    sm.g0[i] = g0[i]; sm.be0[i] = be0[i];
    sm.g1[i] = g1[i]; sm.be1[i] = be1[i];
    sm.gv[i] = gv[i]; sm.bev[i] = bev[i];
    sm.wsdf[i] = bfr(wsdf[i]);
  }
  __syncthreads();
  PHASE_MARK(0);  // constants

  float acc[RT][NTW][4];
  int q = 0;  // the unit's first layer-1 chunk in the block's stream
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray0 = tile * TR;
    // one unit of the weight stream a chunk of SC samples
    for (int ch = 0; ch < nch; ++ch, q += 2 * NKC) {
      const int s0 = ch * SC;                           // the chunk's first sample
      const int sn = S - s0 < SC ? S - s0 : SC;         // its real samples
      const bool last = ch == nch - 1;

      // ---- per-chunk inputs (the view phase and |d| once a tile) ----
      for (int i = tid; i < M; i += NTHREADS) {  // i = ray * SC + s: coalesced
        const int r = i / SC, s = i % SC, row = s * TR + r;
        const bool ok = ray0 + r < n_rays && s < sn;
        const size_t src = size_t(ray0 + r) * S + s0 + s;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float p = ok ? pts[src * 3 + c] : 0.f;
          sm.pts[row * 3 + c] = p;
          sm.xs[row * 3 + c] = bfr(__fmul_rn(p, scale));  // layer 0's operand
        }
        sm.z[row] = ok ? z_vals[src] : 0.f;
      }
      if (ch == 0) {
        for (int i = tid; i < TR * W; i += NTHREADS) {
          const int r = i / W, n = i % W, ray = ray0 + r;
          float vt = 0.f;
          if (ray < n_rays) {
            const float* v = viewdirs + size_t(ray) * 3;
            vt = __fadd_rn(__fadd_rn(__fmul_rn(bfr(v[0]), sm.wvv[n]),
                                     __fmul_rn(bfr(v[1]), sm.wvv[W + n])),
                           __fmul_rn(bfr(v[2]), sm.wvv[2 * W + n]));
          }
          sm.vphase[r * VEC_LD + n] = mul_add(sm.gv[n], vt, sm.bev[n]);
        }
        if (tid < TR) sm.dnorm[tid] = ray0 + tid < n_rays ? dnorm[ray0 + tid] : 0.f;
      }
      __syncthreads();
      PHASE_MARK(1);  // per-tile inputs

      // ---- layer 0 (K = 3) on the CUDA cores, one column pair a thread with
      //      its constants in registers (loaded here: not held through the
      //      products) ----
      const int l0c = (tid % (W / 2)) * 2;
      float lw[3][2], lg[2], lb[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int k = 0; k < 3; ++k) lw[k][e] = sm.w0[k * W + l0c + e];
        lg[e] = sm.g0[l0c + e];
        lb[e] = sm.be0[l0c + e];
      }
#pragma unroll 1  // unrolled, it measured slower
      for (int row = tid / (W / 2); row < M; row += NTHREADS / (W / 2)) {
        const float x0 = sm.xs[row * 3], x1 = sm.xs[row * 3 + 1], x2 = sm.xs[row * 3 + 2];
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lin = __fadd_rn(__fadd_rn(__fmul_rn(x0, lw[0][e]), __fmul_rn(x1, lw[1][e])),
                                      __fmul_rn(x2, lw[2][e]));
          h[e] = fast_sin(mul_add(lg[e], lin, lb[e]));
        }
        *reinterpret_cast<__nv_bfloat162*>(sm.act + row * ACT_LD + l0c) =
            __floats2bfloat162_rn(h[0], h[1]);
      }
      PHASE_MARK(2);  // layer 0

      // ---- layer 1 on the tensor cores (its first barrier publishes act) ----
      gemm(sm, w1t, wvht, q, q_end, acc, rg, cq, lane);
      __syncthreads();  // every warp has read act before it is overwritten
      PHASE_MARK(3);  // layer 1 product
      // one row tile at a time (rows g and g + 8), its column constants
      // re-read from shared memory: few registers beside the accumulators
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r0 = (rg * RT + i) * 16 + g, r1 = r0 + 8;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int c = cq * (W / CQ) + j * 8 + 2 * t;
          const float2 gc = *reinterpret_cast<const float2*>(sm.g1 + c);
          const float2 bc = *reinterpret_cast<const float2*>(sm.be1 + c);
          const float2 wc = *reinterpret_cast<const float2*>(sm.wsdf + c);
          float h00, h01, h10, h11;
          *reinterpret_cast<__nv_bfloat162*>(sm.act + r0 * ACT_LD + c) =
              pack_bf16(fast_sin(mul_add(gc.x, acc[i][j][0], bc.x)),
                        fast_sin(mul_add(gc.y, acc[i][j][1], bc.y)), h00, h01);
          *reinterpret_cast<__nv_bfloat162*>(sm.act + r1 * ACT_LD + c) =
              pack_bf16(fast_sin(mul_add(gc.x, acc[i][j][2], bc.x)),
                        fast_sin(mul_add(gc.y, acc[i][j][3], bc.y)), h10, h11);
          ps0 += h00 * wc.x + h01 * wc.y;
          ps1 += h10 * wc.x + h11 * wc.y;
        }
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
        if (t == 0) {
          sm.head.sdf[cq * M + r0] = ps0;
          sm.head.sdf[cq * M + r1] = ps1;
        }
      }
      __syncthreads();
      PHASE_MARK(4);  // layer 1 epilogue and sdf head

      // ---- integration: sigma and alpha over the rows in parallel ----
      for (int i = tid; i < M; i += NTHREADS) {
        const int r = i / SC, s = i % SC, row = s * TR + r, sg = s0 + s;
        const float* hp = sm.head.sdf + row;
        float sd = hp[0];
#pragma unroll
        for (int p = 1; p < CQ; ++p) sd = __fadd_rn(sd, hp[p * M]);
        sd = __fadd_rn(sd, bsdf[0]);
        // the gap to the next sample: in this chunk, in the next one (read
        // from global memory), or the far gap after the ray's last sample
        float gap = 1e10f;
        if (sg + 1 < S) {
          if (s + 1 < SC)
            gap = __fsub_rn(sm.z[row + TR], sm.z[row]);
          else if (ray0 + r < n_rays)
            gap = __fsub_rn(z_vals[size_t(ray0 + r) * S + sg + 1], sm.z[row]);
        }
        const float dist = __fmul_rn(gap, sm.dnorm[r]);
        const float sig = __fdiv_rn(__fdiv_rn(1.f, __fadd_rn(1.f, expf(__fdiv_rn(sd, sbeta)))), sbeta);
        const float alpha = __fsub_rn(1.f, expf(-__fmul_rn(sig, dist)));
        sm.rows.it.alpha[row] = alpha;
        sm.rows.it.fac[row] = __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f);
        if (ray0 + r < n_rays && s < sn) sdf_out[size_t(ray0 + r) * S + sg] = sd;
      }
      __syncthreads();
      PHASE_MARK(5);  // sigma and alpha
      // ... and the running transmittance product, one thread a ray, carried
      // from chunk to chunk; the samples past S weigh 0
      if (tid < TR) {
        const int ray = ray0 + tid;
        float* cy = sm.carry + tid * 4;
        float trans = 1.f, x = 0.f, y = 0.f, zz = 0.f, w = 0.f;
        if (ch > 0) {
          trans = cy[0]; x = cy[1]; y = cy[2]; zz = cy[3];
        }
        for (int s = 0; s < sn; ++s) {
          const int row = s * TR + tid;
          w = __fmul_rn(sm.rows.it.alpha[row], trans);
          trans = __fmul_rn(trans, sm.rows.it.fac[row]);
          sm.wgt[row] = w;
          x = __fadd_rn(x, __fmul_rn(w, sm.pts[row * 3]));
          y = __fadd_rn(y, __fmul_rn(w, sm.pts[row * 3 + 1]));
          zz = __fadd_rn(zz, __fmul_rn(w, sm.pts[row * 3 + 2]));
        }
        for (int s = sn; s < SC; ++s) sm.wgt[s * TR + tid] = 0.f;
        if (!last) {
          cy[0] = trans; cy[1] = x; cy[2] = y; cy[3] = zz;
        } else if (ray < n_rays) {
          xyz[size_t(ray) * 3] = x;
          xyz[size_t(ray) * 3 + 1] = y;
          xyz[size_t(ray) * 3 + 2] = zz;
          maskd[size_t(ray) * 2] = w;
          maskd[size_t(ray) * 2 + 1] = -sqrtf(x * x + y * y + zz * zz);
        }
      }
      PHASE_MARK(6);  // transmittance product, xyz, mask and depth

      // ---- view layer on the tensor cores (its first barrier publishes wgt);
      //      features summed per ray ----
      gemm(sm, w1t, wvht, q + NKC, q_end, acc, rg, cq, lane);
      PHASE_MARK(7);  // view product
      {
        // one row tile at a time, as for layer 1. w*feat over the thread's
        // samples (all of ray g % TR), in sample order and chunk after chunk,
        // is summed in the thread's own slots of featp (one owner a (row
        // group, g, column))
        float* fp = sm.featp + (rg * 8 + g) * VEC_LD + cq * (W / CQ) + 2 * t;
        const float* vp = sm.vphase + (g % TR) * VEC_LD;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int r0 = (rg * RT + i) * 16 + g, r1 = r0 + 8;
          const float w0r = sm.wgt[r0], w1r = sm.wgt[r1];
          float pr[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            const int c = cq * (W / CQ) + j * 8 + 2 * t;
            const float2 gvc = *reinterpret_cast<const float2*>(sm.gv + c);
            const float2 vpc = *reinterpret_cast<const float2*>(vp + c);
            const float f00 = fast_sin(mul_add(gvc.x, acc[i][j][0], vpc.x));
            const float f01 = fast_sin(mul_add(gvc.y, acc[i][j][1], vpc.y));
            const float f10 = fast_sin(mul_add(gvc.x, acc[i][j][2], vpc.x));
            const float f11 = fast_sin(mul_add(gvc.y, acc[i][j][3], vpc.y));
            float2 fs = i == 0 && ch == 0 ? make_float2(0.f, 0.f)
                                          : *reinterpret_cast<float2*>(fp + j * 8);
            fs.x = __fadd_rn(__fadd_rn(fs.x, __fmul_rn(w0r, f00)), __fmul_rn(w1r, f10));
            fs.y = __fadd_rn(__fadd_rn(fs.y, __fmul_rn(w0r, f01)), __fmul_rn(w1r, f11));
            *reinterpret_cast<float2*>(fp + j * 8) = fs;
            float b00, b01, b10, b11;  // the rgb head's bf16 operands
            pack_bf16(f00, f01, b00, b01);
            pack_bf16(f10, f11, b10, b11);
            const float* wr = sm.wrgb + c * 3;  // columns c and c + 1
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              pr[0][k] += b00 * wr[k] + b01 * wr[3 + k];
              pr[1][k] += b10 * wr[k] + b11 * wr[3 + k];
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              pr[e][k] += __shfl_xor_sync(0xffffffffu, pr[e][k], 1);
              pr[e][k] += __shfl_xor_sync(0xffffffffu, pr[e][k], 2);
              if (t == 0) sm.head.rgb[(cq * M + r0 + 8 * e) * 3 + k] = pr[e][k];
            }
        }
      }
      __syncthreads();
      PHASE_MARK(8);  // view epilogue: feat partials and rgb head

      // ---- per-ray outputs: feat (after the last chunk), and w*sigmoid(rgb)
      //      for thumb ----
      if (last) {
        for (int i = tid; i < TR * W; i += NTHREADS) {
          const int r = i / W, n = i % W;
          // the partials of (row group p, g = r + k*TR), p-major
          const float* fp = sm.featp + r * VEC_LD + n;
          float f = fp[0];
#pragma unroll
          for (int j = 1; j < RG * FG; ++j)
            f = __fadd_rn(f, fp[((j / FG) * 8 + (j % FG) * TR) * VEC_LD]);
          if (ray0 + r < n_rays) feat[size_t(ray0) * W + i] = f;
        }
      }
      for (int i = tid; i < M * 3; i += NTHREADS) {
        const int row = i / 3, k = i % 3;
        const float* hp = sm.head.rgb + i;
        float v = hp[0];
#pragma unroll
        for (int p = 1; p < CQ; ++p) v = __fadd_rn(v, hp[p * M * 3]);
        v = __fadd_rn(v, brgb[k]);
        sm.rows.wsig[i] = __fmul_rn(sm.wgt[row], __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))));
      }
      __syncthreads();
      PHASE_MARK(9);  // feat output, w*sigmoid(rgb)
      // thumb, one thread a (ray, channel), carried from chunk to chunk; the
      // other threads go on to the next chunk's inputs, which touch none of
      // wsig
      if (tid < TR * 3) {
        const int r = tid / 3, k = tid % 3;
        float a = ch > 0 ? sm.tcarry[tid] : 0.f;
        for (int s = 0; s < sn; ++s) a = __fadd_rn(a, sm.rows.wsig[(s * TR + r) * 3 + k]);
        if (!last)
          sm.tcarry[tid] = a;
        else if (ray0 + r < n_rays)
          thumb[size_t(ray0 + r) * 3 + k] = -1.f + 2.f * a;
      }
      PHASE_MARK(10);  // thumb
    }
  }
}

}  // namespace

#ifdef SIREN_PHASE_CLOCKS
// Copies the phase counters to `out` (NPHASES values) and, with `reset`,
// sets them to 0. Returns NPHASES through `n`.
extern "C" int siren_render_phase_cycles(unsigned long long* out, int* n, int reset) {
  *n = NPHASES;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[NPHASES] = {};
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return int(err);
}
#endif

// One block an SM (at most one a tile); each block walks the TR-ray tiles
// with a stride of the grid. The SM count is read once: it sets only how the
// tiles are shared, never what a launch computes. `n_samples` is each ray's
// sample count: any count >= 1, or in a fixed build that build's count
// (cudaErrorInvalidValue otherwise).
extern "C" int siren_render_forward(
    const float* pts, const float* viewdirs, const float* z_vals,
    const float* dnorm, const float* w0, const float* g0, const float* be0,
    const void* w1t, const float* g1, const float* be1, const void* wvht,
    const float* wvv, const float* gv, const float* bev, const float* wsdf,
    const float* bsdf, const float* wrgb, const float* brgb, float scale,
    float sigmoid_beta, float* thumb, float* feat, float* xyz, float* maskd,
    float* sdf, int n_rays, int n_samples, void* stream) {
  if (n_samples < 1 || (FIXED_S > 0 && n_samples != FIXED_S))
    return int(cudaErrorInvalidValue);
  static int sms = 0;
  cudaError_t err;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
  }
  const int smem = int(sizeof(Smem));
  err = cudaFuncSetAttribute(
      siren_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const int tiles = (n_rays + TR - 1) / TR;
  const int blocks = tiles < sms ? tiles : sms;
  siren_render_kernel<<<blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, viewdirs, z_vals, dnorm, w0, g0, be0,
      static_cast<const __nv_bfloat16*>(w1t), g1, be1,
      static_cast<const __nv_bfloat16*>(wvht), wvv, gv, bev, wsdf, bsdf, wrgb,
      brgb, scale, sigmoid_beta, thumb, feat, xyz, maskd, sdf, n_rays, n_samples);
  return int(cudaGetLastError());
}

