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
// floor the design below is up against at widths up to 256: the tensor work
// is the smaller of the two, so wgmma would not lower the floor there. A
// block runs its products and its sine epilogues in turn, between barriers,
// so the two pipes rarely work at once and the time is nearer their sum than
// the larger; overlapping them needs warps specialised by role. Width 512
// has a design of its own (siren_render_kernel_wide, at the end).
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
// -DK1_W=<32|64|128|256|512> picks the width and its tile layout below
// (-DK1_W=0: the width read at launch, any multiple of 128 past 512), and
// -DK1_FIXED_S=<S> fixes the sample count at compile time (0: the count is
// the launch's, any S >= 1). The build without flags is width
// 256 with S fixed at 24, the serving geometry, and compiles to the design
// above. Any other width runs in the build of the next width up, its
// operands zero-padded by the caller (kernels/siren_render.py:
// kernel_build): a padded unit has g = 0 and beff = 0, so its phase is 0,
// its sine exactly 0, and it meets zero weight rows. Every build takes the
// caller's width as feat's row stride and stores only its columns. A
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
// Width 512 and every width past it are another kernel,
// siren_render_kernel_wide, below: at 512 its width is fixed, the
// run-time-width build (-DK1_W=0) takes any multiple of 128 past 512.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#ifndef K1_W
#define K1_W 256
#endif
#ifndef K1_FIXED_S
#define K1_FIXED_S 24
#endif

namespace {

constexpr float INV_2PI = 0.15915494309189535f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float SC0 = 0.9999727636431689f;
constexpr float SC1 = -0.16661501432840328f;
constexpr float SC2 = 0.008305441787505873f;
constexpr float SC3 = -0.00019215724206787978f;
constexpr float SC4 = 2.125150239026409e-06f;

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

}  // namespace

#if K1_W != 512 && K1_W != 0

namespace {

constexpr int W = K1_W;                // SIREN width
constexpr int FIXED_S = K1_FIXED_S;    // samples per ray; 0: the launch's
// TR rays a tile, SC samples a chunk, RG row groups x CQ column quarters
#if K1_W == 32
constexpr int TR = 8, SC = 24, RG = 3, CQ = 2;
#elif K1_W == 64 || K1_W == 128 || K1_W == 256
constexpr int TR = 8, SC = 24, RG = 3, CQ = 4;
#else
#error "K1_W must be 32, 64, 128, 256, 512 or 0 (the width read at launch)"
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

// PAD: the caller's width (feat's row stride) is less than W, the operands
// zero-padded to W; without it feat is stored as before padded widths were
// taken, its stride W
template <bool PAD>
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
    int n_samples, int feat_width) {
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
          if constexpr (PAD) {  // in the caller's width: the padded units' columns go
            if (ray0 + r < n_rays && n < feat_width)
              feat[size_t(ray0 + r) * feat_width + n] = f;
          } else if (ray0 + r < n_rays) {
            feat[size_t(ray0) * W + i] = f;
          }
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
// sample count: any count >= 1, or in a fixed build that build's count;
// `width` the operands' width, the build's; `feat_width` the caller's, feat's
// row stride, 1 to `width` (cudaErrorInvalidValue otherwise). `scratch` is
// read only by the run-time-width build (below).
extern "C" int siren_render_forward(
    const float* pts, const float* viewdirs, const float* z_vals,
    const float* dnorm, const float* w0, const float* g0, const float* be0,
    const void* w1t, const float* g1, const float* be1, const void* wvht,
    const float* wvv, const float* gv, const float* bev, const float* wsdf,
    const float* bsdf, const float* wrgb, const float* brgb, float scale,
    float sigmoid_beta, float* thumb, float* feat, float* xyz, float* maskd,
    float* sdf, int n_rays, int n_samples, int width, int feat_width, void* stream,
    void* scratch, long long scratch_bytes) {
  if (n_samples < 1 || (FIXED_S > 0 && n_samples != FIXED_S) || width != W ||
      feat_width < 1 || feat_width > W)
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
  auto* kernel = feat_width < W ? siren_render_kernel<true> : siren_render_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const int tiles = (n_rays + TR - 1) / TR;
  const int blocks = tiles < sms ? tiles : sms;
  kernel<<<blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, viewdirs, z_vals, dnorm, w0, g0, be0,
      static_cast<const __nv_bfloat16*>(w1t), g1, be1,
      static_cast<const __nv_bfloat16*>(wvht), wvv, gv, bev, wsdf, bsdf, wrgb,
      brgb, scale, sigmoid_beta, thumb, feat, xyz, maskd, sdf, n_rays, n_samples, feat_width);
  return int(cudaGetLastError());
}
#else  // K1_W = 512 or 0 (the width read at launch): siren_render_kernel_wide

// Width 512 (-DK1_W=512): what bounds it on the H100. At 4096 rays x 24
// samples the two (rows,512)@(512,512) products are 103 GFLOP of bf16:
// >= 104 us on the tensor cores. The f32 work, kept apart as above, is
// 2.37 G operations (>= 71 us) and the dot products 0.70 G (>= 10 us).
// Here the tensor work is the larger, so this build runs its products on
// wgmma. Both weights (1 MiB in bf16) no longer fit beside the activations,
// so they stream past them: the weight intake of a launch is (rows / rows
// a unit) MiB, and what the design does about it is more rows a unit and a
// weight shared across a cluster. With the stream cut so, the f32 work is
// what keeps it from its bound: the sine epilogues and layer 0 take most
// of the consumer warps' cycles, the producer waits on free slots most of
// its time, and a cluster of 1 runs as fast as one of 2 (measured by
// tools/siren_phase_split.py --width 512 and tools/k1_times.py --cluster).
//
// Past 512 (-DK1_W=0: the width W read at launch, any multiple of 128
// above 512, no ceiling) the products grow as W^2 a row and the weights as
// W^2 a unit, so the weight stream is what bounds this build: at 4096 x 24
// the products are 412 GFLOP at W = 1024 (>= 0.42 ms) and 1.65 TFLOP at
// 2048 (>= 1.67 ms). Every unit takes in both weights whatever its rows,
// so the intake into the SMs is (rows / rows a unit) x 4 W^2 bytes: this
// build keeps the 512 build's 64-row units at every width (6.4 GB at
// 1024, 25.8 GB at 2048) by staging the activations in 64-feature
// K-chunks beside the weight chunks, so that nothing in shared memory
// grows with W (~204 KB at every width, of the 227 KB a block may use):
//
//  - h0 and h1 go through a scratch in global memory, one tile of each a
//    CTA (64 rows x W bf16 each, 256 W bytes a CTA in all, allocated by
//    the caller), laid out as the swizzled 8 KB K-chunks wgmma reads (64
//    rows x 64 features, a row's 16-byte group j at j ^ (row % 8)). A ring
//    slot holds a 16 KB weight chunk and the 8 KB activation chunk it
//    multiplies; the producer copies the latter from its CTA's own scratch
//    by a bulk copy (no multicast: the rays are the CTA's own), both
//    completing on the slot's full barrier. A unit writes 64 x W x 2 bytes
//    of each activation once and reads them back W / 128 times: at 2048, 8
//    MB against the unit's 16 MB of weights.
//  - Why h0 is not recomputed for each layer-1 pass instead (layer 0 has
//    K = 3): that is W / 128 x 64 x W sines a unit, 2.1 M at 2048, ~190 us
//    of the consumers' f32 pipe against the unit's 143 us of tensor work,
//    where the f32 pipe already sets the 512 build's pace; the scratch
//    costs 4 MB of L2 reads instead. Why h1 is not split across the
//    cluster's shared memory: 64 x W bf16 is 256 KB at 2048, more than a
//    CTA has, and it grows with W. So both take one path: one layout, one
//    producer loop and one descriptor form for both products.
//  - Layer 0 is made by the producer warpgroup's other three warps, a unit
//    ahead of the consumers: a unit's h0 as soon as the last unit's layer
//    1 has consumed the old one (its h1 ready), so it runs beside the last
//    unit's view product and is off the consumers' path. Each layer-1
//    pass's epilogue writes its 128 features of h1 with 4-byte stores (a
//    shuffle pairs two features of one row in a lane). The writers fence
//    the generic proxy against the async one (fence.proxy.async.global),
//    meet at a barrier, and one thread arrives on the product's ready
//    mbarrier. The producer waits on it before it copies the product's
//    first activation chunk; until then it copies the weight chunks of up
//    to NS slots ahead.
//  - The view phase is made in registers, per pass, for a thread's two
//    features (gv * (bf16(d) . bf16(wvv)) + bev, the 512 build's
//    roundings); the feat sums carry from unit to unit in feat itself; the
//    unit's inputs (points, depths, view directions) are read after the
//    layer-1 product, which needs none of them.
//  - The pass loop is peeled (pass 0, then pairs of passes, the two
//    accumulator sets by name, then the odd pass left), so no branch
//    decides at run time whether a pass has slices before it, and each
//    pass ends in a wait for its wgmma groups, with the loads of its
//    epilogue constants issued just before. Without that wait a group in
//    flight crossed the run-time pass loop's back-edge and tail into code
//    that reads the other accumulator set, and ptxas serialized every
//    wgmma of the build (C7514, "non wgmma instructions reading
//    accumulator registers of a wgmma between start and end of the
//    pipeline stage").
//  - 8 ring slots of 24 KB: what the 512 build's two activation tiles held
//    goes to a deeper ring.
//
// Both builds:
//
//  - A unit is 8 rays x 8 samples = 64 rows, ray-major (row = ray * 8 +
//    s): 1.6 GB into the SMs at 512, 4096 x 24 (three chunks a 24-sample
//    ray, no padding), 0.8 GB from L2 with every weight chunk multicast to
//    a cluster of 2. A ray of S samples is walked in ceil(S/8) units,
//    carrying its transmittance, xyz, thumb and feat sums from unit to
//    unit.
//  - The products run transposed, out^T (features x rows) = W . act^T, on
//    wgmma m64n64k16: the weight is the 64-row A operand and the bf16
//    activation (64 rows x 64 features a K-chunk) the N = 64 B operand,
//    both K-major in the 128-byte swizzle. siren_prepare lays each weight
//    out as (128 out x 64 in) 16 KB chunks, pass by pass (128 output
//    features over W / 64 chunks), already swizzled (chunk_weight,
//    kernels/decoder_block.py), so one 1-D bulk copy fills a ring slot; no
//    tensor map. Warpgroup wg of the two consumer warpgroups takes chunk
//    rows wg*64..: a pass leaves it 64 features x 64 rows, 32 accumulators
//    a thread. At 512 the activations are two whole tiles in shared
//    memory (act0 h0, act1 h1, 64 KB each); past it the ring's chunks.
//  - The third warpgroup is the producer: its first thread keeps the ring
//    of chunks full under full / empty mbarriers, the same sequence in
//    both CTAs of the cluster (w1's W^2 / 8192 chunks, then wv's, a unit);
//    CTA q % 2 copies weight chunk q into both by .multicast::cluster. A
//    consumer warpgroup waits for a chunk's full barrier, issues its 4 k16
//    wgmmas, and frees the slot of the previous chunk once that chunk's
//    wgmma group is done, by a CTA-scope arrival on the slot's empty
//    barrier in each CTA of the cluster. No block barrier a chunk. A CTA
//    whose tile lies past the last one consumes every chunk and stores
//    nothing.
//  - At 512 layer 0 (K = 3) on the CUDA cores writes h0 into the swizzled
//    tile act0 with ordinary stores; each layer-1 pass's epilogue writes
//    its 128 features of h1 into act1 by stmatrix .trans (the accumulators
//    are features x rows); fence.proxy.async and a consumer barrier before
//    wgmma reads either. The sdf and rgb heads, which reduce over features,
//    are summed in registers over the passes, then over a warp's 8 feature
//    lanes by a shuffle reduce-scatter, then over the 8 warps in order. The
//    feat sums (w * feat over a ray's samples) are summed over a lane's two
//    samples, then over the four lanes of the ray by a reduce-scatter, and
//    carried from unit to unit: in registers at 512, in feat itself past
//    it (each value has one owning lane, which reads back what it wrote
//    the unit before), where the passes are counted at run time and
//    registers cannot be indexed.
//  - Every sum keeps a fixed order, the same for every ray: two launches
//    give the same bits, and a ray's outputs do not depend on which rays
//    share its tile. The arithmetic and its rounding points are the other
//    builds'.
//  - A pass's epilogue runs in 8 slices, one a ray, after each of the next
//    pass's first 8 chunks while their wgmma groups run, so the f32 pipe
//    works beside the tensor cores; the accumulators alternate between two
//    sets by pass (64 registers a thread: setmaxnreg gives the consumer
//    warpgroups 232 a thread, the producer warpgroup 40). The last pass's
//    epilogue, integration and the outputs (at 512 layer 0 too) run in
//    turn between consumer barriers, the ring streaming meanwhile up to
//    its slots.
//  - Built with -DSIREN_PHASE_CLOCKS, every warp also counts its clock
//    cycles by phase (WIDE_MARK); with -DK1_PLANT_RING_FAULT a consumer
//    reads the ring slot after the one it waited for (a fault the card
//    tests must catch).

namespace {

constexpr int FIXED_W = K1_W;              // SIREN width at 512; 0: read at launch
constexpr bool RUN_TIME_W = FIXED_W == 0;
constexpr int FIXED_S = K1_FIXED_S;        // samples per ray; 0: the launch's
constexpr int TR = 8;                      // rays a tile
constexpr int SC = 8;                      // samples a chunk of a ray
constexpr int M = TR * SC;                 // 64 rows a unit: wgmma's N
constexpr int NACC = M / 2;                // accumulators a thread a pass
constexpr int CONSUMERS = 256;             // two consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 128;  // and the producer warpgroup
// registers a thread after setmaxnreg: the producer warpgroup gives the
// consumers what the 384-thread launch (168 a thread) holds beyond its own
constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 232;
static_assert(CONSUMERS * REGS_CONSUMER + 128 * REGS_PRODUCER <= NTHREADS * 168,
              "the CTA's register pool");
constexpr int CHUNK_ROWS = 128;            // output features a chunk: a pass
constexpr int CHUNK_K = 64;                // input features a chunk: 128-byte rows
constexpr int CHUNK_BYTES = CHUNK_ROWS * CHUNK_K * 2;  // 16 KB
constexpr int ACT_BLOCK = M * 128;         // 64 input features of the M rows: 8 KB
// at 512 a whole bf16 activation tile (64 KB), two of them; past it none
constexpr int ACT_BYTES = RUN_TIME_W ? 0 : FIXED_W / CHUNK_K * ACT_BLOCK;
// a ring slot: a weight chunk, and past 512 the activation chunk it multiplies
constexpr int SLOT_BYTES = CHUNK_BYTES + (RUN_TIME_W ? ACT_BLOCK : 0);
constexpr int NS = RUN_TIME_W ? 8 : 4;     // ring slots
static_assert(FIXED_W == 512 || RUN_TIME_W, "K1_W of the wide kernel");
static_assert(ACT_BYTES == (RUN_TIME_W ? 0 : 65536) && ACT_BLOCK % 1024 == 0 &&
                  SLOT_BYTES % 1024 == 0,
              "activation tiles and ring slots keep the swizzle's 1024-byte alignment");
// the passes are unrolled two at a time at 512, where their count is known
[[maybe_unused]] constexpr int PASS_UNROLL = RUN_TIME_W ? 1 : FIXED_W / CHUNK_ROWS / 2;
constexpr int SMEM_LIMIT = 232448;         // a block's shared memory on sm_90
constexpr unsigned FULL = 0xffffffffu;
#ifndef K1_WIDE_CLUSTER
#define K1_WIDE_CLUSTER 2                  // another size: a build with -D
#endif
constexpr int CLUSTER = K1_WIDE_CLUSTER;   // CTAs a cluster
static_assert(CLUSTER >= 1 && CLUSTER <= 8, "a portable cluster size");

// Everything but the two activation tiles and the ring
struct __align__(16) Small {
  unsigned long long full[NS], empty[NS];  // the ring's mbarriers
  float vphase[RUN_TIME_W ? 1 : TR * FIXED_W];  // at 512: per-ray view phase gv*vterm + bev
  float part[8 * M * 3];                   // the consumer warps' head partials:
                                           // sdf [warp][row], rgb [warp][row][3]
  float pts[M * 3];
  float xs[M * 3];                         // bf16(pts * scale): layer 0's operand
  float z[M];
  float alpha[M];
  float fac[M];                            // 1 - alpha + 1e-10
  float wgt[M];                            // compositing weights
  float wsig[M * 3];                       // w * sigmoid(rgb + brgb)
  float dnorm[TR];
  float carry[TR * 4];                     // per ray, chunk to chunk: trans, xyz
  float tcarry[TR * 3];                    // thumb sums, chunk to chunk
  // past 512: bf16(viewdir) a ray; layer 0's operand of the unit the
  // layer-0 warps are on; and the mbarriers on which h0 and h1 are
  // reported complete in the scratch
  float vdir[TR * 3];
  float xs0[M * 3];
  unsigned long long ready[2];
};
// from a 1024-byte aligned base (the swizzle's): act0 (h0), act1 (h1), ring, Small
constexpr int SMEM_BYTES = 1024 + 2 * ACT_BYTES + NS * SLOT_BYTES + int(sizeof(Small));
static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory over the 227 KB a block may use");

struct Params {
  const float *pts, *viewdirs, *z_vals, *dnorm, *w0, *g0, *be0;
  const unsigned char* w1c;                // w1t in swizzled 16 KB chunks
  const float *g1, *be1;
  const unsigned char* wvhc;               // wvht in swizzled 16 KB chunks
  const float *wvv, *gv, *bev, *wsdf, *bsdf, *wrgb, *brgb;
  float scale, sbeta;
  float *thumb, *feat, *xyz, *maskd, *sdf;
  int n_rays, n_samples;
  int width;                               // the operands' (a multiple of 128)
  int feat_width;                          // the caller's: feat's row stride
  unsigned char* scratch;                  // past 512: h0 and h1, 2 x W x 128 bytes a CTA
};

// Phases of the instrumented build (-DSIREN_PHASE_CLOCKS), by the names
// tools/siren_phase_split.py prints (WIDE_PHASES there, in this order)
enum WidePhase {
  WP_producer_wait_empty,
  WP_inputs_layer0,
  WP_layer1_wait_full,
  WP_layer1_wgmma,
  WP_layer1_epilogue_sdf_head,
  WP_integration,
  WP_view_wait_full,
  WP_view_wgmma,
  WP_view_epilogue_feat_rgb_head,
  WP_outputs,
  NWIDE_PHASES
};

#ifdef SIREN_PHASE_CLOCKS
// Instrumented build only (python -m cips3dpp_torch.tools.siren_phase_split
// --width 512): every warp adds the SM clock cycles since its previous mark
// to that phase's count in registers, and lane 0 adds its counts to these
// totals at the end, so a phase's count is the warps' time in it, waits
// included. No barrier is added.
__device__ unsigned long long g_wide_cycles[NWIDE_PHASES];
#define WIDE_MARK(k)                                   \
  do {                                                 \
    const long long now_ = clock64();                  \
    wide_cyc[k] += (unsigned long long)(now_ - wmark); \
    wmark = now_;                                      \
  } while (0)
#else
#define WIDE_MARK(k) \
  do {               \
  } while (0)
#endif

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

// arrive on the barrier at the same offset in CTA `cta` of the cluster, with
// the default CTA-scope release: what it orders is wgmma's reads of a ring
// slot, complete by then, and a cluster-scope release fence would stall the
// arriving warp (decoder_block.cu's block_kernel_wide found the same)
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

// the 256 consumer threads only (named barrier 1; the producer warpgroup never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// past 512: the producer warpgroup's three layer-0 warps (named barrier 2)
constexpr int L0_THREADS = 96;
[[maybe_unused]] __device__ __forceinline__ void l0_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(L0_THREADS) : "memory");
}

// the activation tiles' generic-proxy stores, seen by wgmma (async proxy)
[[maybe_unused]] __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// past 512: the scratch's generic-proxy stores, seen by the bulk copies
// (async proxy) that read them back
[[maybe_unused]] __device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// arrive on a barrier of this CTA (release at CTA scope)
[[maybe_unused]] __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += A (64 x 16) . B (64 x 16)^T, bf16, both from shared memory
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

// four 8x8 bf16 matrices from the mma fragment layout, each stored
// transposed: the row of lane l holds column l % 8 of matrix l / 8
[[maybe_unused]] __device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                                   const uint32_t (&r)[4]) {
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

// The consumer warp's head partials x of rows 8j + 2t + e at (2j + e) * K
// + k (K head outputs) summed over its 8 feature lanes g (lane masks 16,
// 8, 4) by a reduce-scatter, then the warp's sums into part[warp][row][k].
// Every row's sum takes the same tree of adds.
template <int K>
__device__ __forceinline__ void head_partials(float (&x)[2 * TR * K], float* part, int warp,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  reduce_half<TR * K>(x, 16, lane & 16);
  reduce_half<TR * K / 2>(x, 8, lane & 8);
  reduce_half<TR * K / 4>(x, 4, lane & 4);
#pragma unroll
  for (int i = 0; i < TR / 4; ++i) {  // lane g keeps the rows v = g * TR / 4 + i
    const int v = g * (TR / 4) + i;
#pragma unroll
    for (int k = 0; k < K; ++k)
      part[(warp * M + 8 * (v >> 1) + 2 * t + (v & 1)) * K + k] = x[i * K + k];
  }
}

__device__ __forceinline__ uint32_t pack_bits(float a, float b, float& ra, float& rb) {
  const __nv_bfloat162 p = pack_bf16(a, b, ra, rb);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The byte offset of (row, input feature k) in a swizzled activation tile:
// block k / 64 of 64 rows x 128 bytes, row `row`, 16-byte group
// ((k / 8) % 8) ^ (row % 8), as wgmma's 128-byte swizzle reads it
__device__ __forceinline__ uint32_t act_offset(int row, int k) {
  return uint32_t((k >> 6) * ACT_BLOCK + row * 128 + ((((k >> 3) & 7) ^ (row & 7)) << 4) +
                  (k & 7) * 2);
}

// PAD: the caller's width (feat's row stride) is less than the operands'
// (at 512; past it feat carries the sums at the caller's stride in either)
template <bool PAD>
__global__ void __launch_bounds__(NTHREADS, 1) siren_render_kernel_wide(const Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_act0 = (raw + 1023u) & ~1023u;  // the swizzle wants 1024-byte alignment
  const uint32_t s_act1 = s_act0 + ACT_BYTES, s_ring = s_act1 + ACT_BYTES;
  unsigned char* const base = smem_raw + (s_act0 - raw);
  Small& sm = *reinterpret_cast<Small*>(base + 2 * ACT_BYTES + NS * SLOT_BYTES);
  const uint32_t s_full = smem_u32(sm.full), s_empty = smem_u32(sm.empty);
  const uint32_t s_ready = smem_u32(sm.ready);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_reg(0), ncta = cluster_reg(1), cid = cluster_reg(2),
                 ncl = cluster_reg(3);
  // samples a ray, and chunks of SC a ray: compile-time in a fixed build
  const int S = FIXED_S > 0 ? FIXED_S : P.n_samples;
  const int nch = (S + SC - 1) / SC;
  const int n_tiles = (P.n_rays + TR - 1) / TR;
  const int groups = (n_tiles + int(ncta) - 1) / int(ncta);  // a cluster's CL tiles
  // the width, and the passes and chunks of a product: compile-time at 512
  const int W = RUN_TIME_W ? P.width : FIXED_W;
  const int PASSES = W / CHUNK_ROWS, KCH = W / CHUNK_K;
  const int PRODUCT_CHUNKS = PASSES * KCH;
  // past 512: the CTA's h0 (0) or h1 (1) tile in the scratch, KCH K-chunks
  auto h_tile = [&](int which) {
    return P.scratch + (size_t(blockIdx.x) * 2 + which) * size_t(KCH) * ACT_BLOCK;
  };
#ifdef SIREN_PHASE_CLOCKS
  unsigned long long wide_cyc[NWIDE_PHASES] = {};
  long long wmark = clock64();
#endif

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(s_full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(s_empty + 8 * s, 2 * int(ncta));   // each warpgroup of the cluster
    }
    if constexpr (RUN_TIME_W)
      for (int b = 0; b < 2; ++b) mbar_init(s_ready + 8 * b, 1);  // one consumer thread
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every barrier of the cluster initialized before any copy or arrival
  // each role ends here (the two never reconverge, so setmaxnreg holds)
  auto finish = [&]() {
#ifdef SIREN_PHASE_CLOCKS
    if (lane == 0)
      for (int k = 0; k < NWIDE_PHASES; ++k) atomicAdd(&g_wide_cycles[k], wide_cyc[k]);
#endif
    cluster_sync();  // no CTA leaves while a peer may still copy into it or arrive on it
  };

  if (warp >= CONSUMERS / 32) {
    // ---- producer: chunk after chunk, the same sequence in every CTA of
    //      the cluster; CTA q % CL copies chunk q into all of them ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS_PRODUCER));
    if (warp == CONSUMERS / 32 && lane == 0) {
      const uint16_t mask = uint16_t((1u << ncta) - 1);
      int slot = 0;
      uint32_t phase = 0, issuer = 0;
      if constexpr (RUN_TIME_W) {
        // each product's weight chunks as at 512; beside each, the K-chunk
        // of h0 (layer 1) or h1 (the view layer) it multiplies, from this
        // CTA's scratch once the consumers report it complete
        uint32_t ready_parity = 0;
        for (int grp = int(cid); grp < groups; grp += int(ncl))
          for (int ch = 0; ch < nch; ++ch, ready_parity ^= 1)
            for (int prod = 0; prod < 2; ++prod) {
              const unsigned char* const wsrc = prod ? P.wvhc : P.w1c;
              const unsigned char* const asrc = h_tile(prod);
              const int slot0 = slot;
              int acts = 0;  // the product's chunks whose activation copy is issued
              bool ready = false;
              auto issue_acts = [&](int upto) {
                if (!ready) {
#ifdef SIREN_PHASE_CLOCKS
                  wmark = clock64();
#endif
                  mbar_wait(s_ready + 8 * prod, ready_parity);
                  WIDE_MARK(WP_producer_wait_empty);
                  fence_proxy_async_global();
                  ready = true;
                }
                for (; acts < upto; ++acts) {
                  const int s = (slot0 + acts) % NS;
                  bulk_load(s_ring + s * SLOT_BYTES + CHUNK_BYTES,
                            asrc + size_t(acts % KCH) * ACT_BLOCK, ACT_BLOCK, s_full + 8 * s, 0,
                            false);
                }
              };
              for (int q = 0; q < PRODUCT_CHUNKS; ++q) {
                // the slot of chunk q holds chunk q - NS, whose activation
                // must be issued before the slot can free
                if (q - acts == NS) issue_acts(q);
#ifdef SIREN_PHASE_CLOCKS
                wmark = clock64();
#endif
                mbar_wait(s_empty + 8 * slot, phase ^ 1);  // free in every CTA of the cluster
                WIDE_MARK(WP_producer_wait_empty);
                mbar_expect_tx(s_full + 8 * slot, SLOT_BYTES);
                if (issuer == rank)
                  bulk_load(s_ring + slot * SLOT_BYTES, wsrc + size_t(q) * CHUNK_BYTES,
                            CHUNK_BYTES, s_full + 8 * slot, mask, ncta > 1);
                if (++issuer == ncta) issuer = 0;
                if (ready) issue_acts(q + 1);
                if (++slot == NS) slot = 0, phase ^= 1;
              }
              issue_acts(PRODUCT_CHUNKS);
            }
      } else {
      for (int grp = int(cid); grp < groups; grp += int(ncl))
        for (int ch = 0; ch < nch; ++ch)
          for (int q = 0; q < 2 * PRODUCT_CHUNKS; ++q) {
#ifdef SIREN_PHASE_CLOCKS
            wmark = clock64();
#endif
            mbar_wait(s_empty + 8 * slot, phase ^ 1);  // free in every CTA of the cluster
            WIDE_MARK(WP_producer_wait_empty);
            mbar_expect_tx(s_full + 8 * slot, CHUNK_BYTES);
            if (issuer == rank)
              bulk_load(s_ring + slot * CHUNK_BYTES,
                        (q < PRODUCT_CHUNKS ? P.w1c : P.wvhc) +
                            size_t(q % PRODUCT_CHUNKS) * CHUNK_BYTES,
                        CHUNK_BYTES, s_full + 8 * slot, mask, ncta > 1);
            if (++issuer == ncta) issuer = 0;
            if (++slot == NS) slot = 0, phase ^= 1;
          }
      }
    }
    if constexpr (RUN_TIME_W) {
      if (warp > CONSUMERS / 32) {
        // ---- past 512, the producer warpgroup's other three warps: layer 0
        //      (K = 3) of each unit into h0 in the scratch, a unit ahead of
        //      the consumers: a unit's h0 once the last unit's layer 1 has
        //      consumed the old one (h1 ready), while the consumers run the
        //      last unit's view product ----
        const int lt = tid - CONSUMERS - 32;
        unsigned char* const h0 = h_tile(0);
        const int NP = W / 2;  // feature pairs
        uint32_t parity = 0;
        bool first = true;
        for (int grp = int(cid); grp < groups; grp += int(ncl))
          for (int ch = 0; ch < nch; ++ch) {
            if (!first) {
              mbar_wait(s_ready + 8, parity);
              parity ^= 1;
            }
            first = false;
#ifdef SIREN_PHASE_CLOCKS
            wmark = clock64();  // the warps' layer-0 time, not their wait for h1
#endif
            const int ray0 = (grp * int(ncta) + int(rank)) * TR, s0 = ch * SC;
            const int sn = S - s0 < SC ? S - s0 : SC;
            for (int i = lt; i < M * 3; i += L0_THREADS) {
              const int row = i / 3, r = row / SC, s = row % SC, ray = ray0 + r;
              const bool ok = ray < P.n_rays && s < sn;
              sm.xs0[i] =
                  ok ? bfr(__fmul_rn(P.pts[(size_t(ray) * S + s0 + s) * 3 + i % 3], P.scale))
                     : 0.f;
            }
            l0_sync();
#pragma unroll 1
            for (int it = lt; it < NP * (M / 8); it += L0_THREADS) {
              const int n0 = 2 * (it % NP), r0 = 8 * (it / NP);
              float lw[3][2], lg[2], lb[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
#pragma unroll
                for (int k = 0; k < 3; ++k) lw[k][e] = bfr(__ldg(P.w0 + k * W + n0 + e));
                lg[e] = __ldg(P.g0 + n0 + e);
                lb[e] = __ldg(P.be0 + n0 + e);
              }
#pragma unroll 2
              for (int row = r0; row < r0 + 8; ++row) {
                const float x0 = sm.xs0[row * 3], x1 = sm.xs0[row * 3 + 1],
                            x2 = sm.xs0[row * 3 + 2];
                float h[2], ra, rb;
#pragma unroll
                for (int d = 0; d < 2; ++d) {
                  const float lin =
                      __fadd_rn(__fadd_rn(__fmul_rn(x0, lw[0][d]), __fmul_rn(x1, lw[1][d])),
                                __fmul_rn(x2, lw[2][d]));
                  h[d] = fast_sin(mul_add(lg[d], lin, lb[d]));
                }
                *reinterpret_cast<uint32_t*>(h0 + act_offset(row, n0)) =
                    pack_bits(h[0], h[1], ra, rb);
              }
            }
            fence_proxy_async_global();
            l0_sync();  // h0 is complete: the producer may copy it
            if (lt == 0) mbar_arrive(s_ready);
            WIDE_MARK(WP_inputs_layer0);
          }
      }
    }
    __syncwarp();
    finish();
  } else {
    // ---- consumers: warpgroup wg takes rows wg*64 .. of each chunk (its
    //      64 output features of the pass), warp wi of it 16 of them ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS_CONSUMER));
    const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
    const uint64_t desc_a = sw128_desc(s_ring + wg * 64 * 128);
    // the B operand: at 512 the activation tiles, past it the ring slot's
    // activation chunk
    const uint64_t desc_h0 = sw128_desc(RUN_TIME_W ? s_ring + CHUNK_BYTES : s_act0);
    const uint64_t desc_h1 = sw128_desc(RUN_TIME_W ? s_ring + CHUNK_BYTES : s_act1);
    int slot = 0;
    uint32_t phase = 0;

    // free ring slot s in every CTA of the cluster, once a warpgroup
    auto release = [&](int s) {
      if (wi == 0 && lane < int(ncta)) mbar_arrive_cluster(s_empty + 8 * s, lane);
    };
    // One product: PASSES passes, each the warpgroup's 64 features x M
    // rows of act . W^T over its KCH chunks, each a full slot of the ring.
    // A chunk's slot is freed once its wgmma group is done (one group left
    // in flight); no barrier a chunk. The accumulators alternate between
    // two sets by pass, and pass q's epilogue runs in TR slices (ray j in
    // slice j), one after each of the first TR chunks of pass q + 1 is
    // issued, while that chunk's wgmma group runs; the last pass's slices
    // after the product. `slice(q, j, acc)` is the epilogue's slice;
    // `prep(q)` loads pass q's epilogue constants (past 512, at the end of
    // pass q; at 512 the slices load them at j = 0).
    auto product = [&](uint64_t desc_b, bool view, auto&& prep, auto&& slice) {
      float acc[2][NACC];
      int prev = -1;
      // chunk j of the pass, into `cur`
      auto chunk = [&](int j, float (&cur)[NACC]) {
        mbar_wait(s_full + 8 * slot, phase);
#ifdef SIREN_PHASE_CLOCKS
        if (view) WIDE_MARK(WP_view_wait_full);
        else WIDE_MARK(WP_layer1_wait_full);
#endif
#ifdef K1_PLANT_RING_FAULT
        // a planted fault for the card tests: read the slot after the
        // one whose full barrier was waited on
        const int rs = slot + 1 == NS ? 0 : slot + 1;
#else
        const int rs = slot;
#endif
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < CHUNK_K / 16; ++ks)
          wgmma_n64(cur, desc_a + ((rs * SLOT_BYTES + ks * 32) >> 4),
                    desc_b + (((RUN_TIME_W ? rs * SLOT_BYTES : j * ACT_BLOCK) + ks * 32) >> 4));
        wgmma_commit();
        if constexpr (RUN_TIME_W) {  // a wait every chunk: nothing in flight at a product's first
          wgmma_wait<1>();
          if (prev >= 0) release(prev);
        } else if (prev >= 0) {  // the previous chunk's products are done: free its slot
          wgmma_wait<1>();
          release(prev);
        }
        prev = slot;
        if (++slot == NS) slot = 0, phase ^= 1;
#ifdef SIREN_PHASE_CLOCKS
        if (view) WIDE_MARK(WP_view_wgmma);
        else WIDE_MARK(WP_layer1_wgmma);
#endif
      };
      // pass p into `cur`, with the slices of pass p - 1 (in `last`)
      auto pass = [&](int p, float (&cur)[NACC], float (&last)[NACC]) {
#pragma unroll
        for (int k = 0; k < NACC; ++k) cur[k] = 0.f;
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          chunk(j, cur);
          if (p > 0) {
            if (j == 0) fence_acc(last);  // the last pass is done
            slice(p - 1, j, last);
#ifdef SIREN_PHASE_CLOCKS
            if (view) WIDE_MARK(WP_view_epilogue_feat_rgb_head);
            else WIDE_MARK(WP_layer1_epilogue_sdf_head);
#endif
          }
        }
#pragma unroll 1
        for (int j = TR; j < KCH; ++j) chunk(j, cur);
        if constexpr (RUN_TIME_W) {
          // the loads of this pass's epilogue constants go out before the
          // wait, and no accumulator set crosses the pass loop with a
          // group in flight (ptxas serializes wgmma if one does: C7514)
          prep(p);
          wgmma_wait<0>();
        }
      };
      // the last pass's slices, its products done
      auto last_pass = [&](float (&last)[NACC]) {
        fence_acc(last);
        release(prev);
#ifdef SIREN_PHASE_CLOCKS
        if (view) WIDE_MARK(WP_view_wgmma);
        else WIDE_MARK(WP_layer1_wgmma);
#endif
#pragma unroll
        for (int j = 0; j < TR; ++j) slice(PASSES - 1, j, last);
      };
      if constexpr (RUN_TIME_W) {
        // pass 0, then pairs of passes, then the odd pass left: whether a
        // pass has slices before it is never decided at run time
        pass(0, acc[0], acc[1]);
        int p = 1;
#pragma unroll 1
        for (; p + 1 < PASSES; p += 2) {
          pass(p, acc[1], acc[0]);
          pass(p + 1, acc[0], acc[1]);
        }
        // the odd pass left, then the last pass's slices, each branch
        // naming its accumulator set
        if (p < PASSES) {
          pass(p, acc[1], acc[0]);
          last_pass(acc[1]);
        } else {
          last_pass(acc[0]);
        }
      } else {
#pragma unroll PASS_UNROLL
        for (int p = 0; p < PASSES; p += 2) {
          pass(p, acc[0], acc[1]);
          if (p + 1 < PASSES) pass(p + 1, acc[1], acc[0]);
        }
        wgmma_wait<0>();
        if ((PASSES - 1) & 1)
          last_pass(acc[1]);
        else
          last_pass(acc[0]);
      }
    };

    // Accumulator i of a pass holds feature fa + 8 * ((i >> 1) & 1) (fa =
    // pass * 128 + wg * 64 + 16 * wi + g) of row 8 * (i >> 2) + 2 * t +
    // (i & 1): ray j = i >> 2 of the tile, its samples 2t and 2t + 1.
    // the feat sums a lane keeps, chunk to chunk (at 512; past it in feat)
    [[maybe_unused]] float fcar[RUN_TIME_W ? 1 : FIXED_W / CHUNK_ROWS][TR / 2];
    for (int grp = int(cid); grp < groups; grp += int(ncl)) {
      const int ray0 = (grp * int(ncta) + int(rank)) * TR;  // past n_rays: every ray dead
      // one unit of the weight stream a chunk of SC samples
      for (int ch = 0; ch < nch; ++ch) {
        const int s0 = ch * SC;                        // the chunk's first sample
        const int sn = S - s0 < SC ? S - s0 : SC;      // its real samples
        const bool last = ch == nch - 1;

        // ---- per-chunk inputs, rows ray-major (the view phase and |d|
        //      once a tile); past 512 after the layer-1 product (below),
        //      which reads none of them ----
        if constexpr (!RUN_TIME_W) {
          consumer_sync();  // the last unit is done with the small buffers
          if (tid < M) {
            const int r = tid / SC, s = tid % SC, ray = ray0 + r;
            const bool ok = ray < P.n_rays && s < sn;
            const size_t src = size_t(ray) * S + s0 + s;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float p = ok ? P.pts[src * 3 + c] : 0.f;
              sm.pts[tid * 3 + c] = p;
              sm.xs[tid * 3 + c] = bfr(__fmul_rn(p, P.scale));
            }
            sm.z[tid] = ok ? P.z_vals[src] : 0.f;
          }
          if (ch == 0) {
            for (int i = tid; i < TR * W; i += CONSUMERS) {
              const int r = i / W, n = i % W, ray = ray0 + r;
              float vt = 0.f;
              if (ray < P.n_rays) {
                const float* v = P.viewdirs + size_t(ray) * 3;
                vt = __fadd_rn(__fadd_rn(__fmul_rn(bfr(v[0]), bfr(__ldg(P.wvv + n))),
                                         __fmul_rn(bfr(v[1]), bfr(__ldg(P.wvv + W + n)))),
                               __fmul_rn(bfr(v[2]), bfr(__ldg(P.wvv + 2 * W + n))));
              }
              sm.vphase[i] = mul_add(__ldg(P.gv + n), vt, __ldg(P.bev + n));
            }
            if (tid < TR) sm.dnorm[tid] = ray0 + tid < P.n_rays ? P.dnorm[ray0 + tid] : 0.f;
          }
          consumer_sync();
        }

        // ---- layer 0 (K = 3) on the CUDA cores into h0 at 512: a thread
        //      takes 8 features (one 16-byte group) of every RS-th row (RS =
        //      4); past 512 the producer warpgroup's layer-0 warps make h0
        //      (above) ----
        if constexpr (!RUN_TIME_W) {
          if (const int NG = W / 8, RS = CONSUMERS / NG; tid < NG * RS) {
            const int n0 = 8 * (tid % NG);
            float lw[3][8], lg[8], lb[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
#pragma unroll
              for (int k = 0; k < 3; ++k) lw[k][e] = bfr(__ldg(P.w0 + k * W + n0 + e));
              lg[e] = __ldg(P.g0 + n0 + e);
              lb[e] = __ldg(P.be0 + n0 + e);
            }
#pragma unroll 1
            for (int row = tid / NG; row < M; row += RS) {
              const float x0 = sm.xs[row * 3], x1 = sm.xs[row * 3 + 1], x2 = sm.xs[row * 3 + 2];
              uint32_t pk[4];
#pragma unroll
              for (int e = 0; e < 8; e += 2) {
                float h[2], ra, rb;
#pragma unroll
                for (int d = 0; d < 2; ++d) {
                  const float lin = __fadd_rn(
                      __fadd_rn(__fmul_rn(x0, lw[0][e + d]), __fmul_rn(x1, lw[1][e + d])),
                      __fmul_rn(x2, lw[2][e + d]));
                  h[d] = fast_sin(mul_add(lg[e + d], lin, lb[e + d]));
                }
                pk[e / 2] = pack_bits(h[0], h[1], ra, rb);
              }
              *reinterpret_cast<uint4*>(base + act_offset(row, n0)) =
                  make_uint4(pk[0], pk[1], pk[2], pk[3]);
            }
          }
          fence_proxy_async();
          consumer_sync();  // h0 is complete
        }
        WIDE_MARK(WP_inputs_layer0);

        // ---- layer 1 on the tensor cores; each pass's epilogue writes
        //      its 128 features of h1 (stmatrix .trans into the swizzled
        //      tile) and adds to the sdf head ----
        float ps[2 * TR];  // sdf head partials of rows 8j + 2t + e, at 2j + e
#pragma unroll
        for (int v = 0; v < 2 * TR; ++v) ps[v] = 0.f;
        {
          float gc[2], bc[2], wc[2];  // the pass's constants at features fa, fa + 8
          uint32_t pk[4];             // a stmatrix's two rays
          // stmatrix: matrix m = lane / 8 of a store is rays j - 1 + m / 2,
          // features fa - g + 8 (m % 2); lane l gives row l % 8 of it
          [[maybe_unused]] const int m = lane >> 3;
          auto prep = [&](int q) {
            const int fa = q * CHUNK_ROWS + wg * 64 + 16 * wi + g;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              gc[u] = __ldg(P.g1 + fa + 8 * u);
              bc[u] = __ldg(P.be1 + fa + 8 * u);
              wc[u] = bfr(__ldg(P.wsdf + fa + 8 * u));
            }
          };
          product(desc_h0, false, prep, [&](int q, int j, const float (&acc)[NACC]) {
            [[maybe_unused]] const int fa = q * CHUNK_ROWS + wg * 64 + 16 * wi + g;
            if (j == 0 && !RUN_TIME_W) prep(q);
            float r[2][2];  // [u][e]: the bf16-rounded h1
#pragma unroll
            for (int u = 0; u < 2; ++u)
              pk[2 * (j & 1) + u] =
                  pack_bits(fast_sin(mul_add(gc[u], acc[4 * j + 2 * u], bc[u])),
                            fast_sin(mul_add(gc[u], acc[4 * j + 2 * u + 1], bc[u])), r[u][0],
                            r[u][1]);
#pragma unroll
            for (int e = 0; e < 2; ++e) ps[2 * j + e] += r[0][e] * wc[0] + r[1][e] * wc[1];
            if constexpr (RUN_TIME_W) {
              // into the scratch: lanes g and g ^ 1 (features fa and fa + 1)
              // swap halves by a shuffle, so the even lane holds both
              // features of row 8j + 2t and the odd lane both of row 8j +
              // 2t + 1, each stored as one 4-byte pair (per u: a warp's
              // store, 8 rows x 16 bytes)
              unsigned char* const h1 = h_tile(1);
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const uint32_t mine = pk[2 * (j & 1) + u];
                const uint32_t other = __shfl_xor_sync(FULL, mine, 4);
                const int odd = g & 1;
                const uint32_t v = odd ? __byte_perm(other, mine, 0x7632)
                                       : __byte_perm(mine, other, 0x5410);
                *reinterpret_cast<uint32_t*>(h1 + act_offset(8 * j + 2 * t + odd,
                                                             fa + 8 * u - odd)) = v;
              }
            } else if (j & 1) {
              const int row = 8 * (j - 1 + (m >> 1)) + (lane & 7);
              stmatrix_x4_trans(s_act1 + (2 * q + wg) * ACT_BLOCK + row * 128 +
                                    (((2 * wi + (m & 1)) ^ (row & 7)) << 4),
                                pk);
            }
          });
        }
        WIDE_MARK(WP_layer1_epilogue_sdf_head);
        if constexpr (RUN_TIME_W) {
          fence_proxy_async_global();
          // the unit's inputs (the view directions and |d| once a tile):
          // the last unit's readers of them are past its barriers
          if (tid < M) {
            const int r = tid / SC, s = tid % SC, ray = ray0 + r;
            const bool ok = ray < P.n_rays && s < sn;
            const size_t src = size_t(ray) * S + s0 + s;
#pragma unroll
            for (int c = 0; c < 3; ++c) sm.pts[tid * 3 + c] = ok ? P.pts[src * 3 + c] : 0.f;
            sm.z[tid] = ok ? P.z_vals[src] : 0.f;
          }
          if (ch == 0) {
            if (tid < TR * 3) {
              const int ray = ray0 + tid / 3;
              sm.vdir[tid] = ray < P.n_rays ? bfr(P.viewdirs[size_t(ray) * 3 + tid % 3]) : 0.f;
            }
            if (tid < TR) sm.dnorm[tid] = ray0 + tid < P.n_rays ? P.dnorm[ray0 + tid] : 0.f;
          }
        } else {
          fence_proxy_async();
        }
        // the sdf partials over the warp's 8 feature lanes g, then the 8
        // warps' in order
        head_partials<1>(ps, sm.part, warp, lane);
        consumer_sync();  // h1 and the sdf partials (past 512 the inputs) are complete
        if constexpr (RUN_TIME_W)
          if (tid == 0) mbar_arrive(s_ready + 8);  // the producer may copy h1
        WIDE_MARK(WP_layer1_epilogue_sdf_head);

        // ---- integration: sigma and alpha over the rows in parallel ----
        if (tid < M) {
          const int r = tid / SC, s = tid % SC, sg = s0 + s, ray = ray0 + r;
          float sd = sm.part[tid];
#pragma unroll
          for (int w = 1; w < 8; ++w) sd = __fadd_rn(sd, sm.part[w * M + tid]);
          sd = __fadd_rn(sd, __ldg(P.bsdf));
          // the gap to the next sample: in this chunk, in the next one (read
          // from global memory), or the far gap after the ray's last sample
          float gap = 1e10f;
          if (sg + 1 < S) {
            if (s + 1 < SC)
              gap = __fsub_rn(sm.z[tid + 1], sm.z[tid]);
            else if (ray < P.n_rays)
              gap = __fsub_rn(P.z_vals[size_t(ray) * S + sg + 1], sm.z[tid]);
          }
          const float dist = __fmul_rn(gap, sm.dnorm[r]);
          const float sig = __fdiv_rn(
              __fdiv_rn(1.f, __fadd_rn(1.f, expf(__fdiv_rn(sd, P.sbeta)))), P.sbeta);
          const float alpha = __fsub_rn(1.f, expf(-__fmul_rn(sig, dist)));
          sm.alpha[tid] = alpha;
          sm.fac[tid] = __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f);
          if (ray < P.n_rays && s < sn) P.sdf[size_t(ray) * S + sg] = sd;
        }
        consumer_sync();
        // ... and the running transmittance product, one thread a ray,
        // carried from chunk to chunk; the samples past S weigh 0
        if (tid < TR) {
          const int ray = ray0 + tid;
          float* cy = sm.carry + tid * 4;
          float trans = 1.f, x = 0.f, y = 0.f, zz = 0.f, w = 0.f;
          if (ch > 0) {
            trans = cy[0]; x = cy[1]; y = cy[2]; zz = cy[3];
          }
          for (int s = 0; s < sn; ++s) {
            const int row = tid * SC + s;
            w = __fmul_rn(sm.alpha[row], trans);
            trans = __fmul_rn(trans, sm.fac[row]);
            sm.wgt[row] = w;
            x = __fadd_rn(x, __fmul_rn(w, sm.pts[row * 3]));
            y = __fadd_rn(y, __fmul_rn(w, sm.pts[row * 3 + 1]));
            zz = __fadd_rn(zz, __fmul_rn(w, sm.pts[row * 3 + 2]));
          }
          for (int s = sn; s < SC; ++s) sm.wgt[tid * SC + s] = 0.f;
          if (!last) {
            cy[0] = trans; cy[1] = x; cy[2] = y; cy[3] = zz;
          } else if (ray < P.n_rays) {
            P.xyz[size_t(ray) * 3] = x;
            P.xyz[size_t(ray) * 3 + 1] = y;
            P.xyz[size_t(ray) * 3 + 2] = zz;
            P.maskd[size_t(ray) * 2] = w;
            P.maskd[size_t(ray) * 2 + 1] = -sqrtf(x * x + y * y + zz * zz);
          }
        }
        consumer_sync();  // the weights are complete
        WIDE_MARK(WP_integration);

        // ---- view layer on the tensor cores; its features are summed per
        //      ray in registers and dotted with the rgb head ----
        float pr[6 * TR];  // rgb head partials of rows 8j + 2t + e, at (2j + e) * 3 + k
#pragma unroll
        for (int v = 0; v < 6 * TR; ++v) pr[v] = 0.f;
        {
          float gvc[2], wr[2][3];  // the pass's constants at features fa, fa + 8
          [[maybe_unused]] float wv[2][3], bv[2];  // past 512 also bf16(wvv) and bev there
          float fs[2 * TR];  // w * feat over the lane's two samples, (ray j, u) at 2j + u
          [[maybe_unused]] float fprev[TR / 2];  // past 512: the feat sums of the units before
          // after the reduce-scatter below, lane t keeps (ray j, u) at v =
          // t * TR / 2 + k = 2j + u: its feat value, and whether it is stored
          auto feat_at = [&](int fa, int k, bool& mine) {
            const int v = t * (TR / 2) + k, ray = ray0 + (v >> 1), n = fa + 8 * (v & 1);
            mine = ray < P.n_rays && n < P.feat_width;
            return P.feat + size_t(ray) * P.feat_width + n;
          };
          auto prep = [&](int q) {
            const int fa = q * CHUNK_ROWS + wg * 64 + 16 * wi + g;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              gvc[u] = __ldg(P.gv + fa + 8 * u);
#pragma unroll
              for (int k = 0; k < 3; ++k) wr[u][k] = bfr(__ldg(P.wrgb + (fa + 8 * u) * 3 + k));
            }
            if constexpr (RUN_TIME_W) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
#pragma unroll
                for (int k = 0; k < 3; ++k) wv[u][k] = bfr(__ldg(P.wvv + k * W + fa + 8 * u));
                bv[u] = __ldg(P.bev + fa + 8 * u);
              }
#pragma unroll
              for (int k = 0; k < TR / 2; ++k) {
                bool mine;
                const float* at = feat_at(fa, k, mine);
                fprev[k] = ch > 0 && mine ? *at : 0.f;
              }
            }
          };
          product(desc_h1, true, prep, [&](int q, int j, const float (&acc)[NACC]) {
            const int fa = q * CHUNK_ROWS + wg * 64 + 16 * wi + g;
            if (j == 0 && !RUN_TIME_W) prep(q);
            const float w0r = sm.wgt[8 * j + 2 * t], w1r = sm.wgt[8 * j + 2 * t + 1];
            float b[2][2];  // [u][e]: the rgb head's bf16 operands
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float vp;  // the view phase of ray j at feature fa + 8u: past 512 made here
              if constexpr (RUN_TIME_W) {
                const float* d = sm.vdir + 3 * j;
                vp = mul_add(gvc[u],
                             __fadd_rn(__fadd_rn(__fmul_rn(d[0], wv[u][0]),
                                                 __fmul_rn(d[1], wv[u][1])),
                                       __fmul_rn(d[2], wv[u][2])),
                             bv[u]);
              } else {
                vp = sm.vphase[j * W + fa + 8 * u];
              }
              const float f0 = fast_sin(mul_add(gvc[u], acc[4 * j + 2 * u], vp));
              const float f1 = fast_sin(mul_add(gvc[u], acc[4 * j + 2 * u + 1], vp));
              fs[2 * j + u] = __fadd_rn(__fmul_rn(w0r, f0), __fmul_rn(w1r, f1));
              pack_bf16(f0, f1, b[u][0], b[u][1]);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int k = 0; k < 3; ++k)
                pr[(2 * j + e) * 3 + k] += b[0][e] * wr[0][k] + b[1][e] * wr[1][k];
            if (j == TR - 1) {
              // over the ray's 8 samples: the four lanes t (a reduce-
              // scatter), then chunk after chunk; stored in the caller's
              // width (the padded units' columns go)
              reduce_half<TR>(fs, 2, lane & 2);
              reduce_half<TR / 2>(fs, 1, lane & 1);
#pragma unroll
              for (int k = 0; k < TR / 2; ++k) {
                if constexpr (RUN_TIME_W) {
                  bool mine;
                  float* at = feat_at(fa, k, mine);
                  const float f = ch == 0 ? fs[k] : __fadd_rn(fprev[k], fs[k]);
                  if (mine) *at = f;
                } else {
                  fcar[q][k] = ch == 0 ? fs[k] : __fadd_rn(fcar[q][k], fs[k]);
                }
              }
              if constexpr (!RUN_TIME_W) {
                if (last) {
#pragma unroll
                  for (int k = 0; k < TR / 2; ++k) {
                    if constexpr (PAD) {
                      bool mine;
                      float* at = feat_at(fa, k, mine);
                      if (mine) *at = fcar[q][k];
                    } else {
                      const int ray = ray0 + 2 * t + (k >> 1);
                      if (ray < P.n_rays) P.feat[size_t(ray) * W + fa + 8 * (k & 1)] = fcar[q][k];
                    }
                  }
                }
              }
            }
          });
        }
        WIDE_MARK(WP_view_epilogue_feat_rgb_head);
        // the rgb partials over the warp's 8 feature lanes, then the 8
        // warps' in order
        head_partials<3>(pr, sm.part, warp, lane);
        consumer_sync();  // the rgb partials are complete

        // ---- w*sigmoid(rgb) for thumb, then thumb, one thread a (ray,
        //      channel), carried from chunk to chunk ----
        for (int i = tid; i < M * 3; i += CONSUMERS) {
          const int row = i / 3, k = i % 3;
          float v = sm.part[i];
#pragma unroll
          for (int w = 1; w < 8; ++w) v = __fadd_rn(v, sm.part[w * M * 3 + i]);
          v = __fadd_rn(v, __ldg(P.brgb + k));
          sm.wsig[i] = __fmul_rn(sm.wgt[row], __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))));
        }
        consumer_sync();
        if (tid < TR * 3) {
          const int r = tid / 3, k = tid % 3;
          float a = ch > 0 ? sm.tcarry[tid] : 0.f;
          for (int s = 0; s < sn; ++s) a = __fadd_rn(a, sm.wsig[(r * SC + s) * 3 + k]);
          if (!last)
            sm.tcarry[tid] = a;
          else if (ray0 + r < P.n_rays)
            P.thumb[size_t(ray0 + r) * 3 + k] = -1.f + 2.f * a;
        }
        WIDE_MARK(WP_outputs);
      }
    }
    finish();
  }
}

// siren_render_kernel_wide on a persistent grid of clusters: as many as the
// card holds at once (cudaOccupancyMaxActiveClusters), at most one a tile
// group. A cluster the card cannot place is an error, never a fallback.
// The shared-memory limit is set and the cluster count found once a
// device, on the first launch; later launches read them. static: a local
// static of a function with external linkage could be one object across
// every build loaded in the process.
constexpr int MAX_DEVICES = 16;

template <bool PAD>
static int launch_wide(const Params& P, cudaStream_t stream, long long scratch_bytes) {
  static std::atomic<int> smem_set[MAX_DEVICES], clusters_at[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= MAX_DEVICES) return int(cudaErrorInvalidDevice);
  if (!smem_set[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(siren_render_kernel_wide<PAD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return int(err);
    smem_set[dev].store(1, std::memory_order_relaxed);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = clusters_at[dev].load(std::memory_order_relaxed);
  if (clusters == 0) {
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, siren_render_kernel_wide<PAD>,
                                              &cfg)) != cudaSuccess)
      return int(err);
    if (clusters < 1) return int(cudaErrorLaunchOutOfResources);
    clusters_at[dev].store(clusters, std::memory_order_relaxed);
  }
  const int n_tiles = (P.n_rays + TR - 1) / TR;
  const int groups = (n_tiles + CLUSTER - 1) / CLUSTER;
  cfg.gridDim = dim3((clusters < groups ? clusters : groups) * CLUSTER);
  // past 512: h0 and h1 of every CTA of the grid in the caller's scratch
  if (RUN_TIME_W && (P.scratch == nullptr ||
                     (long long)cfg.gridDim.x * 256 * P.width > scratch_bytes))
    return int(cudaErrorInvalidValue);
  if ((err = cudaLaunchKernelEx(&cfg, siren_render_kernel_wide<PAD>, P)) != cudaSuccess)
    return int(err);
  return int(cudaGetLastError());
}

}  // namespace

#ifdef SIREN_PHASE_CLOCKS
// Copies the phase counters to `out` (NWIDE_PHASES values) and, with
// `reset`, sets them to 0. Returns NWIDE_PHASES through `n`.
extern "C" int siren_render_phase_cycles(unsigned long long* out, int* n, int reset) {
  *n = NWIDE_PHASES;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_wide_cycles, sizeof(g_wide_cycles));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[NWIDE_PHASES] = {};
    err = cudaMemcpyToSymbol(g_wide_cycles, zero, sizeof(zero));
  }
  return int(err);
}
#endif

// The same C entry as the other builds; w1t and wvht are the weights in
// swizzled chunks (kernels/siren_render.py: siren_prepare's w1c, wvhc).
// `n_samples` is each ray's sample count: any count >= 1, or in a fixed
// build that build's count; `width` the operands' width: 512 in that
// build, any multiple of 128 past 512 in the run-time-width build;
// `feat_width` the caller's, feat's row stride, 1 to `width`; `scratch`
// (run-time width only) `scratch_bytes` of device memory, at least 256 x
// `width` bytes a CTA of the grid, one CTA an SM at most
// (cudaErrorInvalidValue otherwise).
extern "C" int siren_render_forward(
    const float* pts, const float* viewdirs, const float* z_vals,
    const float* dnorm, const float* w0, const float* g0, const float* be0,
    const void* w1t, const float* g1, const float* be1, const void* wvht,
    const float* wvv, const float* gv, const float* bev, const float* wsdf,
    const float* bsdf, const float* wrgb, const float* brgb, float scale,
    float sigmoid_beta, float* thumb, float* feat, float* xyz, float* maskd,
    float* sdf, int n_rays, int n_samples, int width, int feat_width, void* stream,
    void* scratch, long long scratch_bytes) {
  const bool width_ok = RUN_TIME_W ? width > 512 && width % CHUNK_ROWS == 0 : width == FIXED_W;
  if (n_samples < 1 || (FIXED_S > 0 && n_samples != FIXED_S) || !width_ok ||
      feat_width < 1 || feat_width > width)
    return int(cudaErrorInvalidValue);
  const Params P{pts, viewdirs, z_vals, dnorm, w0, g0, be0,
                 static_cast<const unsigned char*>(w1t), g1, be1,
                 static_cast<const unsigned char*>(wvht), wvv, gv, bev, wsdf, bsdf, wrgb, brgb,
                 scale, sigmoid_beta, thumb, feat, xyz, maskd, sdf, n_rays, n_samples, width,
                 feat_width, static_cast<unsigned char*>(scratch)};
  // past 512 the kernel takes feat's stride at run time in one instantiation
  if (!RUN_TIME_W && feat_width < width)
    return launch_wide<!RUN_TIME_W>(P, static_cast<cudaStream_t>(stream), scratch_bytes);
  return launch_wide<false>(P, static_cast<cudaStream_t>(stream), scratch_bytes);
}

#endif  // K1_W
