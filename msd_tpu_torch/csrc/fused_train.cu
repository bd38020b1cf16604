// Fused SDF loss and gradients (K2, variants a to e) for NVIDIA Hopper
// (sm_90a).
//
// Replaces msd_tpu/ops/fused_train.py:_make_kernel, the Pallas TPU kernel
// called at build_fused_train: the clamped-L1 sum, the eikonal sum with its
// second-order chain, every weight gradient and the per-scene bias
// gradients of the DeepSDF decoder, in one pass over the batch's points.
// Per point, with layer l = Mp_l (hidden input) + Mx_l (xyz) + c_l (the
// latent's and the bias's share, computed per scene outside the kernels):
//   primal    h_l = bf16(relu(Mp_l h_{l-1} + Mx_l x + c_l)); y = tanh(a_last)
//   u-chain   u_last = m tau; u_{l-1} = bf16(D_{l-1} Mp_l^T u_l)
//   eikonal   g = Mx_0^T u_0 + Mx_L^T u_L; gbar = eik_coef (|g|-1)/|g| g
//   ubar/t    t_0 = bf16(D_0 Mx_0 gbar); t_l = bf16(D_l (Mp_l t_{l-1} + Mx_L gbar))
//   delta     delta_last = m tau sign(yc-gt)/N_tot - 2 y gbar.g;
//             delta_{l-1} = D_{l-1} Mp_l^T bf16(delta_l)
//   gradients dMp_l = delta_l^T h_{l-1} + u_l^T t_{l-1};
//             dMx_l = delta_l^T x + u_l^T gbar; dc_l = sum over the scene of delta_l
// with D_l = 1[h_l > 0] read from the bf16 h, products of bf16 operands
// accumulated in float32 and every epilogue in float32, as the TPU kernel.
//
// Variant d (frozen decoder, the Stage-2 step) computes the primal, the loss
// and the delta chain for the per-scene dc sums only: no weight gradients,
// and the layer-0 delta, which nothing reads but its column sums, is not
// stored (chain_kernel with out == null).
//
// Variant c (EikonalNumPoints) runs the eikonal work on the first E points
// of each scene only, as the TPU kernel's pl.when on the tile index: the
// u and t chains, eik_kernel and the u (x) t, u (x) gbar and t (x) m tau
// products run over S E "gated rows", with u, t, gbar and m tau stored
// compactly; gated row i is point (i / E) P + i % E, which the chain
// kernel's D mask and eik_kernel's per-point operands read through. Every
// other point's delta seed is the L1 seed alone. Variant e (pad-and-mask
// batches) multiplies the L1 and eikonal lanes, the L1 seed and gbar by a
// per-scene 0/1 weight, so a weight-0 scene adds exactly zero everywhere.
//
// Bound on an H100: operations. Variant b costs 18.9 MFLOP per point at the
// flagship width (9.44 for a, 6.29 for d), so the flagship step (32 x 16384
// points) needs at least 10.0 ms (5.0 ms, 3.3 ms) at the 989 TFLOP/s dense
// bf16 peak.
//
// Design. The TPU kernel held a 1024-point tile's h and u and f32
// accumulators for every weight gradient in 100 MB of VMEM and carried them
// from grid step to grid step. Neither holds on Hopper: one point's h and u
// at width 512 are 16 KB, and blocks run in parallel in no order. So the
// chains run layer by layer over a chunk of whole scenes, each product one
// launch of a tiled GEMM whose operands are the chunk's bf16 activations in
// device memory (point-major [n][width]) and the layer's bf16 weights:
//   chain_kernel  [64 points x 128 outputs] per block, K tiles of 64 staged
//                 by cp.async (3 stages), mma.sync.m16n8k16 with ldmatrix
//                 fragment loads, a 32 x 32 block per warp; the epilogue adds
//                 the xyz (or gbar) term and c_l, applies ReLU or the D mask,
//                 stores bf16 and, on the delta chain, writes each block's
//                 float32 column sums (the dc partials). The transposed
//                 products (u and delta chains) read Mp_l^T, transposed once
//                 per call by the wrapper, so every chain product is "NT".
//   wgrad_kernel  dMp_l partials over a split of the chunk's points: a
//                 [64 x 128] output tile per block, both operands point-major
//                 and loaded into fragments by ldmatrix.trans; plain float32
//                 stores of partials, no atomics, so the sums are
//                 deterministic.
//   last_kernel, eik_kernel   per-point work of the one-output last layer
//                 and the eikonal lane, one warp per point, per-128-point-tile
//                 loss partials.
//   skinny_kernel the three-column (dMx) and one-row (last layer) weight
//                 gradients as segmented column sums.
// Hidden widths arrive zero-padded to multiples of 128; padded rows and
// columns stay zero and the wrapper cuts them off.
//
// Plain C interface, loaded with ctypes (msd_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64, BN = 128, BK = 64, PAD = 8, NTHREADS = 256, STAGES = 3;
constexpr int SK = BK + PAD;   // chain tiles: row stride of [rows][BK] tiles
constexpr int SAT = BM + PAD;  // wgrad tiles: row stride of the [BK][BM] A tile
constexpr int SBT = BN + PAD;  // wgrad tiles: row stride of the [BK][BN] B tile
constexpr int PT_TILE = 128;   // points per block of the per-point kernels

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 warps as 2 (rows) x 4 (cols) over a 64 x 128 output tile, each warp a
// 32 x 32 block = 2 x 4 m16n8 tiles; accumulator i = 16 m + 4 j + e sits at
// (row, col) of the tile.
__device__ __forceinline__ void coord(int i, int& r, int& c) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, m = i >> 4, j = (i >> 2) & 3, e = i & 3;
  r = 32 * (w & 1) + 16 * m + g + ((e >> 1) << 3);
  c = 32 * (w >> 1) + 8 * j + 2 * t + (e & 1);
}

// acc += A[0:64, 0:BK] . B[0:128, 0:BK]^T, both K-contiguous in shared memory
// (row strides SK). ldmatrix.x4: lane l addresses row (l & 7) of 8x8 matrix
// l >> 3; A's four matrices are (rows 0-7 | 8-15) x (k 0-7 | 8-15), B's are
// (k 0-7 | 8-15) x (n tile 2q | 2q+1).
__device__ __forceinline__ void mac_nt(float* acc, const bf16* As, const bf16* Bs) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int li = lane >> 3, lr = lane & 7;
  const bf16* A = As + (32 * (w & 1) + lr + 8 * (li & 1)) * SK + 8 * (li >> 1);
  const bf16* B = Bs + (32 * (w >> 1) + 8 * (li >> 1) + lr) * SK + 8 * (li & 1);
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4], b[2][4];
    ldmatrix_x4(a[0], A + kk);
    ldmatrix_x4(a[1], A + 16 * SK + kk);
    ldmatrix_x4(b[0], B + kk);
    ldmatrix_x4(b[1], B + 16 * SK + kk);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        mma_bf16(acc + 16 * m + 8 * q, a[m], b[q][0], b[q][1]);
        mma_bf16(acc + 16 * m + 8 * q + 4, a[m], b[q][2], b[q][3]);
      }
    }
  }
}

// acc += At[0:BK, 0:64]^T . Bt[0:BK, 0:128]: both tiles are point-major
// ([k][m] and [k][n], rows SAT and SBT), so fragments come from
// ldmatrix.trans. A's matrix i covers k + 8 (i >> 1), m + 8 (i & 1); B's
// covers k + 8 (i & 1), n + 8 (i >> 1).
__device__ __forceinline__ void mac_tn(float* acc, const bf16* At, const bf16* Bt) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int li = lane >> 3, lr = lane & 7;
  const bf16* A = At + (8 * (li >> 1) + lr) * SAT + 32 * (w & 1) + 8 * (li & 1);
  const bf16* B = Bt + (8 * (li & 1) + lr) * SBT + 32 * (w >> 1) + 8 * (li >> 1);
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4], b[2][4];
    ldmatrix_x4_trans(a[0], A + kk * SAT);
    ldmatrix_x4_trans(a[1], A + kk * SAT + 16);
    ldmatrix_x4_trans(b[0], B + kk * SBT);
    ldmatrix_x4_trans(b[1], B + kk * SBT + 16);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        mma_bf16(acc + 16 * m + 8 * q, a[m], b[q][0], b[q][1]);
        mma_bf16(acc + 16 * m + 8 * q + 4, a[m], b[q][2], b[q][3]);
      }
    }
  }
}

// Copy a [rows][cols] bf16 tile (cols a multiple of 8) from global memory
// with row stride ld into shared memory with row stride sst.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int sst, const bf16* src, long long ld) {
  constexpr int CPR = COLS / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NTHREADS) {
    const int r = c / CPR, q = c % CPR;
    cp_async16(dst + r * sst + q * 8, src + (long long)r * ld + q * 8);
  }
}

struct ChainParams {
  const bf16* A;      // [n][K] activations of the chunk, or null when K == 0
  const bf16* B;      // [N][K] weights (Mp_l, or Mp_l^T for the u and delta chains)
  long long n;        // points (a multiple of 128)
  int N, K;           // output width (a multiple of 128), depth (a multiple of 64, or 0)
  const float* xv;    // [n][4] per-point 3-vector (x or gbar, bf16-rounded), or null
  const float* wx;    // [N][4] its weights (bf16-rounded), or null
  const float* cvec;  // [n / P][N] per-scene constants, or null
  int P;              // points per scene
  int R;              // gated rows per scene (variant c): output row i reads mask
                      // row (i / R) P + i % R; 0: mask rows are the output rows
  int relu;           // 1: ReLU; 0: multiply by D = 1[mask > 0]
  const bf16* mask;   // [rows][N] (relu == 0)
  bf16* out;          // [n][N], or null when only colsum is wanted
  float* colsum;      // [n / 64][N] column sums of the float32 output, or null
};

__global__ void __launch_bounds__(NTHREADS) chain_kernel(const ChainParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);        // [STAGES][BM][SK]
  bf16* Bs = As + STAGES * BM * SK;                // [STAGES][BN][SK]
  float* red = reinterpret_cast<float*>(Bs + STAGES * BN * SK);  // [2][BN]
  const int n0 = blockIdx.x * BN;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  const int kt_n = p.K / BK;
  const bf16* Ab = p.A + m0 * p.K;
  const bf16* Bb = p.B + static_cast<long long>(n0) * p.K;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) {
      load_tile<BM, BK>(As + s * BM * SK, SK, Ab + s * BK, p.K);
      load_tile<BN, BK>(Bs + s * BN * SK, SK, Bb + s * BK, p.K);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and tile kt-1's buffers are free
    const int nx = kt + STAGES - 1;
    if (nx < kt_n) {
      load_tile<BM, BK>(As + (nx % STAGES) * BM * SK, SK, Ab + nx * BK, p.K);
      load_tile<BN, BK>(Bs + (nx % STAGES) * BN * SK, SK, Bb + nx * BK, p.K);
    }
    cp_async_commit();
    mac_nt(acc, As + (kt % STAGES) * BM * SK, Bs + (kt % STAGES) * BN * SK);
  }
  cp_async_wait<0>();

  // epilogue: float32, then one bf16 store per output
  float cs[8];  // this thread's column sums over its rows, by (j, e & 1)
#pragma unroll
  for (int i = 0; i < 8; ++i) cs[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int r, c;
    coord(i, r, c);
    const long long pr = m0 + r;
    const int pc = n0 + c;
    float v = acc[i];
    if (p.xv != nullptr) {
      const float* x = p.xv + 4 * pr;
      const float* w = p.wx + 4 * pc;
      v += x[0] * w[0] + x[1] * w[1] + x[2] * w[2];
    }
    if (p.cvec != nullptr) v += p.cvec[(pr / p.P) * p.N + pc];
    if (p.relu) {
      v = fmaxf(v, 0.0f);
    } else {
      const long long mr = p.R ? (pr / p.R) * p.P + pr % p.R : pr;
      v = bf(p.mask[mr * p.N + pc]) > 0.0f ? v : 0.0f;
    }
    if (p.out != nullptr) p.out[pr * p.N + pc] = __float2bfloat16_rn(v);
    cs[2 * ((i >> 2) & 3) + (i & 1)] += v;
  }
  if (p.colsum == nullptr) return;
  // reduce over the 8 row groups of the warp (lane bits 2-4), then over the
  // two warp rows in a fixed order: deterministic
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], off);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[(w & 1) * BN + 32 * (w >> 1) + 8 * (i >> 1) + 2 * lane + (i & 1)] = cs[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += NTHREADS)
    p.colsum[blockIdx.y * static_cast<long long>(p.N) + n0 + c] = red[c] + red[BN + c];
}

struct WgradParams {
  const bf16* A[2];  // [n_q][M] (delta_l, u_l)
  const bf16* B[2];  // [n_q][N] (h_{l-1}, t_{l-1})
  long long n[2];    // rows of each pair (0: no second pair)
  int M, N, nsplit;
  float* out;  // [nsplit][M][N] partial sums
};

__global__ void __launch_bounds__(NTHREADS) wgrad_kernel(const WgradParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][BK][SAT]
  bf16* Bs = As + STAGES * BK * SAT;         // [STAGES][BK][SBT]
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const long long tiles0 = p.n[0] / BK;
  const long long total = tiles0 + p.n[1] / BK;
  const long long chunk = (total + p.nsplit - 1) / p.nsplit;
  const long long kb = split * chunk;
  const long long ke = kb + chunk < total ? kb + chunk : total;
  const int kt_n = ke > kb ? static_cast<int>(ke - kb) : 0;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  auto load = [&](int buf, long long kt) {
    const int q = kt < tiles0 ? 0 : 1;
    const long long row = (q ? kt - tiles0 : kt) * BK;
    load_tile<BK, BM>(As + buf * BK * SAT, SAT, p.A[q] + row * p.M + m0, p.M);
    load_tile<BK, BN>(Bs + buf * BK * SBT, SBT, p.B[q] + row * p.N + n0, p.N);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load(s, kb + s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = kt + STAGES - 1;
    if (nx < kt_n) load(nx % STAGES, kb + nx);
    cp_async_commit();
    mac_tn(acc, As + (kt % STAGES) * BK * SAT, Bs + (kt % STAGES) * BK * SBT);
  }
  cp_async_wait<0>();
  float* out = p.out + static_cast<long long>(split) * p.M * p.N;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int r, c;
    coord(i, r, c);
    out[static_cast<long long>(m0 + r) * p.N + n0 + c] = acc[i];
  }
}

// Sum of 128 values in shared memory by one warp, in a fixed order.
__device__ __forceinline__ float warp_sum128(const float* v) {
  const int lane = threadIdx.x & 31;
  float s = v[lane] + v[lane + 32] + v[lane + 64] + v[lane + 96];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

struct LastParams {
  const bf16* h;      // [n][K] last hidden activations
  const bf16* wl;     // [K] last layer's weights
  int K;
  const float* clast; // [n / P] per-scene constant of the last layer
  const float* gt;    // [n] clipped ground truth
  const float* w;     // [n / P] per-scene 0/1 weights (variant e), or null
  long long n;
  int P, E;           // E: rows per scene that run the eikonal chains (0: none)
  float clamp, inv_ntot;
  float* pt;          // [n][4] (y, m tau, l1 seed, 0)
  float* mtc;         // [n / P * E][4] (bf16(m tau), 0, 0, 0) of the gated rows, compact
  float* sb;          // [n][4] (bf16(delta_last), 0, 0, 0); written outside the gated rows
  float* loss;        // [n / 128][4] (l1 sum, eikonal sum, delta_last sum, 0)
};

__global__ void __launch_bounds__(NTHREADS) last_kernel(const LastParams p) {
  __shared__ float l1s[PT_TILE], sbs[PT_TILE];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * PT_TILE;
  // a tile lies wholly inside or outside the gated rows (E and P are
  // multiples of the tile)
  const bool gated = base % p.P < p.E;
  for (int r = w; r < PT_TILE; r += NTHREADS / 32) {
    const long long pt = base + r;
    const bf16* h = p.h + pt * p.K;
    float s = 0.0f;
    for (int k = lane; k < p.K; k += 32) s += bf(h[k]) * bf(p.wl[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const float a = s + p.clast[pt / p.P];
      const float y = tanhf(a);
      const float tau = 1.0f - y * y;
      const float m = fabsf(y) < p.clamp ? 1.0f : 0.0f;
      const float yc = fminf(fmaxf(y, -p.clamp), p.clamp);
      const float d = yc - p.gt[pt];
      const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
      const float mt = m * tau;
      float seed = mt * sgn * p.inv_ntot;
      float l1 = fabsf(d);
      if (p.w != nullptr) {  // msd_tpu/ops/fused_train.py:225-226, :295-296
        const float wt = p.w[pt / p.P];
        l1 *= wt;
        seed *= wt;
      }
      float4* o = reinterpret_cast<float4*>(p.pt) + pt;
      *o = make_float4(y, mt, seed, 0.0f);
      if (gated)
        reinterpret_cast<float4*>(p.mtc)[(pt / p.P) * p.E + pt % p.P] = make_float4(rnd(mt), 0.0f, 0.0f, 0.0f);
      else
        reinterpret_cast<float4*>(p.sb)[pt] = make_float4(rnd(seed), 0.0f, 0.0f, 0.0f);
      l1s[r] = l1;
      sbs[r] = seed;
    }
  }
  __syncthreads();
  if (w == 0) {
    const float l1 = warp_sum128(l1s);
    const float sbar = warp_sum128(sbs);
    if (lane == 0) {
      p.loss[4 * blockIdx.x] = l1;
      if (!gated) p.loss[4 * blockIdx.x + 2] = sbar;
    }
  }
}

// Over the gated rows only: row i of the compact operands (u, gb) is point
// (i / E) P + i % E of the chunk (pt, sb, loss).
struct EikParams {
  const bf16* u0;     // [n][W0]
  const float* mx0;   // [W0][4]
  int W0;
  const bf16* uL;     // [n][WL] latent_in layer, or null
  const float* mxL;   // [WL][4]
  int WL;
  const float* pt;    // [points][4] from last_kernel
  const float* w;     // [n / E] per-scene 0/1 weights (variant e), or null
  long long n;        // gated rows
  int P, E;
  float eik_coef;
  float* gb;          // [n][4] (bf16(gbar), 0)
  float* sb;          // [points][4] (bf16(delta_last), 0, 0, 0)
  float* loss;        // [points / 128][4]
};

__global__ void __launch_bounds__(NTHREADS) eik_kernel(const EikParams p) {
  __shared__ float eks[PT_TILE], sbs[PT_TILE];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * PT_TILE;
  const long long pbase = (base / p.E) * p.P + base % p.E;  // the tile's first point
  for (int r = w; r < PT_TILE; r += NTHREADS / 32) {
    const long long i = base + r, pt = pbase + r;
    float g[3] = {0.0f, 0.0f, 0.0f};
    const bf16* u = p.u0 + i * p.W0;
    for (int o = lane; o < p.W0; o += 32) {
      const float v = bf(u[o]);
#pragma unroll
      for (int j = 0; j < 3; ++j) g[j] += v * p.mx0[4 * o + j];
    }
    if (p.uL != nullptr) {
      u = p.uL + i * p.WL;
      for (int o = lane; o < p.WL; o += 32) {
        const float v = bf(u[o]);
#pragma unroll
        for (int j = 0; j < 3; ++j) g[j] += v * p.mxL[4 * o + j];
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) g[j] += __shfl_xor_sync(0xffffffffu, g[j], off);
    }
    if (lane == 0) {
      const float gsq = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
      const float gn = sqrtf(fmaxf(gsq, 1e-24f));
      const float coef = p.eik_coef * (gn - 1.0f) / gn;
      // variant e scales the eikonal lane and gbar, hence its whole reverse
      // pass (msd_tpu/ops/fused_train.py:248-258)
      const float wt = p.w != nullptr ? p.w[i / p.E] : 1.0f;
      float gbar[3], gdot = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gbar[j] = coef * g[j];
        if (p.w != nullptr) gbar[j] *= wt;
        gdot += gbar[j] * g[j];
      }
      const float4 q = reinterpret_cast<const float4*>(p.pt)[pt];  // (y, m tau, l1 seed, 0)
      const float sbar = q.z + (-2.0f * q.x) * gdot;
      reinterpret_cast<float4*>(p.gb)[i] = make_float4(rnd(gbar[0]), rnd(gbar[1]), rnd(gbar[2]), 0.0f);
      reinterpret_cast<float4*>(p.sb)[pt] = make_float4(rnd(sbar), 0.0f, 0.0f, 0.0f);
      float ek = (1.0f - gn) * (1.0f - gn);
      if (p.w != nullptr) ek *= wt;
      eks[r] = ek;
      sbs[r] = sbar;
    }
  }
  __syncthreads();
  if (w == 0) {
    const float ek = warp_sum128(eks);
    const float sbar = warp_sum128(sbs);
    if (lane == 0) {
      p.loss[4 * (pbase / PT_TILE) + 1] = ek;
      p.loss[4 * (pbase / PT_TILE) + 2] = sbar;
    }
  }
}

struct SkinnyParams {
  const bf16* A[2];   // [n_q][W]
  const float* V[2];  // [n_q][4]
  long long n[2];     // rows of each pair (0: no second pair)
  int W, nseg;
  float* out;         // [nseg][W][4]: sum over the segment's rows of A[p][o] V[p][0:3]
};

__global__ void __launch_bounds__(128) skinny_kernel(const SkinnyParams p) {
  const int o = blockIdx.x * 128 + threadIdx.x;
  const int seg = blockIdx.y;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (o < p.W) {
    for (int q = 0; q < 2; ++q) {
      const long long len = (p.n[q] + p.nseg - 1) / p.nseg;
      const long long b = seg * len;
      const long long e = b + len < p.n[q] ? b + len : p.n[q];
      for (long long pt = b; pt < e; ++pt) {
        const float a = bf(p.A[q][pt * p.W + o]);
        const float* v = p.V[q] + 4 * pt;
        acc[0] += a * v[0];
        acc[1] += a * v[1];
        acc[2] += a * v[2];
      }
    }
    float* out = p.out + (static_cast<long long>(seg) * p.W + o) * 4;
    out[0] = acc[0];
    out[1] = acc[1];
    out[2] = acc[2];
    out[3] = 0.0f;
  }
}

constexpr int CHAIN_SMEM = STAGES * (BM + BN) * SK * 2 + 2 * BN * 4;
constexpr int WGRAD_SMEM = STAGES * BK * (SAT + SBT) * 2;

inline int err(cudaError_t e) { return static_cast<int>(e); }
inline int bad() { return err(cudaErrorInvalidValue); }

}  // namespace

extern "C" {

// Every function returns a cudaError_t code; launches go to ``stream`` and
// do not synchronise.

int msd_ft_chain(const void* A, const void* B, long long n, int N, int K, const void* xv, const void* wx,
                 const void* cvec, int P, int R, int relu, const void* mask, void* out, void* colsum,
                 void* stream) {
  if (n <= 0 || n % PT_TILE || N <= 0 || N % BN || K < 0 || K % BK || (K > 0) != (A != nullptr) ||
      (K > 0 && B == nullptr) || (xv == nullptr) != (wx == nullptr) || ((cvec != nullptr || R) && P <= 0) ||
      R < 0 || R > P || (R && (R % BM || n % R)) || (!relu && mask == nullptr) ||
      (out == nullptr && colsum == nullptr) || n / BM > 65535)
    return bad();
  ChainParams p;
  p.A = static_cast<const bf16*>(A);
  p.B = static_cast<const bf16*>(B);
  p.n = n;
  p.N = N;
  p.K = K;
  p.xv = static_cast<const float*>(xv);
  p.wx = static_cast<const float*>(wx);
  p.cvec = static_cast<const float*>(cvec);
  p.P = P;
  p.R = R;
  p.relu = relu;
  p.mask = static_cast<const bf16*>(mask);
  p.out = static_cast<bf16*>(out);
  p.colsum = static_cast<float*>(colsum);
  cudaError_t e = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CHAIN_SMEM);
  if (e != cudaSuccess) return err(e);
  dim3 grid(N / BN, static_cast<unsigned>(n / BM));
  chain_kernel<<<grid, NTHREADS, CHAIN_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return err(cudaGetLastError());
}

int msd_ft_wgrad(const void* A0, const void* B0, long long n0, const void* A1, const void* B1, long long n1,
                 int M, int N, int nsplit, void* out, void* stream) {
  if (n0 <= 0 || n0 % BK || n1 < 0 || n1 % BK || (n1 > 0) != (A1 != nullptr) || M <= 0 || M % BM ||
      N <= 0 || N % BN || nsplit < 1 || nsplit > 65535 || A0 == nullptr || B0 == nullptr ||
      (A1 == nullptr) != (B1 == nullptr) || out == nullptr)
    return bad();
  WgradParams p;
  p.A[0] = static_cast<const bf16*>(A0);
  p.B[0] = static_cast<const bf16*>(B0);
  p.A[1] = static_cast<const bf16*>(A1);
  p.B[1] = static_cast<const bf16*>(B1);
  p.n[0] = n0;
  p.n[1] = n1;
  p.M = M;
  p.N = N;
  p.nsplit = nsplit;
  p.out = static_cast<float*>(out);
  cudaError_t e = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WGRAD_SMEM);
  if (e != cudaSuccess) return err(e);
  dim3 grid(N / BN, M / BM, nsplit);
  wgrad_kernel<<<grid, NTHREADS, WGRAD_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return err(cudaGetLastError());
}

int msd_ft_last(const void* h, const void* wl, int K, const void* clast, const void* gt, const void* w,
                long long n, int P, int E, float clamp, float inv_ntot, void* pt, void* mtc, void* sb, void* loss,
                void* stream) {
  if (n <= 0 || n % PT_TILE || P <= 0 || P % PT_TILE || n % P || E < 0 || E > P || E % PT_TILE || K <= 0 ||
      h == nullptr || wl == nullptr || clast == nullptr || gt == nullptr || pt == nullptr ||
      (E > 0 && mtc == nullptr) || loss == nullptr || (E < P && sb == nullptr))
    return bad();
  LastParams p;
  p.h = static_cast<const bf16*>(h);
  p.wl = static_cast<const bf16*>(wl);
  p.K = K;
  p.clast = static_cast<const float*>(clast);
  p.gt = static_cast<const float*>(gt);
  p.w = static_cast<const float*>(w);
  p.n = n;
  p.P = P;
  p.E = E;
  p.clamp = clamp;
  p.inv_ntot = inv_ntot;
  p.pt = static_cast<float*>(pt);
  p.mtc = static_cast<float*>(mtc);
  p.sb = static_cast<float*>(sb);
  p.loss = static_cast<float*>(loss);
  last_kernel<<<static_cast<unsigned>(n / PT_TILE), NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return err(cudaGetLastError());
}

int msd_ft_eik(const void* u0, const void* mx0, int W0, const void* uL, const void* mxL, int WL, const void* pt,
               const void* w, long long n, int P, int E, float eik_coef, void* gb, void* sb, void* loss,
               void* stream) {
  if (n <= 0 || n % PT_TILE || P <= 0 || E <= 0 || E > P || E % PT_TILE || P % PT_TILE || n % E ||
      u0 == nullptr || mx0 == nullptr || W0 <= 0 || (uL == nullptr) != (mxL == nullptr) ||
      (uL != nullptr && WL <= 0) || pt == nullptr || gb == nullptr || sb == nullptr || loss == nullptr)
    return bad();
  EikParams p;
  p.u0 = static_cast<const bf16*>(u0);
  p.mx0 = static_cast<const float*>(mx0);
  p.W0 = W0;
  p.uL = static_cast<const bf16*>(uL);
  p.mxL = static_cast<const float*>(mxL);
  p.WL = WL;
  p.pt = static_cast<const float*>(pt);
  p.w = static_cast<const float*>(w);
  p.n = n;
  p.P = P;
  p.E = E;
  p.eik_coef = eik_coef;
  p.gb = static_cast<float*>(gb);
  p.sb = static_cast<float*>(sb);
  p.loss = static_cast<float*>(loss);
  eik_kernel<<<static_cast<unsigned>(n / PT_TILE), NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return err(cudaGetLastError());
}

int msd_ft_skinny(const void* A0, const void* V0, long long n0, const void* A1, const void* V1, long long n1, int W,
                  int nseg, void* out, void* stream) {
  if (n0 <= 0 || n1 < 0 || (n1 > 0) != (A1 != nullptr) || W <= 0 || nseg < 1 || nseg > 65535 || A0 == nullptr ||
      V0 == nullptr || (A1 == nullptr) != (V1 == nullptr) || out == nullptr)
    return bad();
  SkinnyParams p;
  p.A[0] = static_cast<const bf16*>(A0);
  p.V[0] = static_cast<const float*>(V0);
  p.A[1] = static_cast<const bf16*>(A1);
  p.V[1] = static_cast<const float*>(V1);
  p.n[0] = n0;
  p.n[1] = n1;
  p.W = W;
  p.nseg = nseg;
  p.out = static_cast<float*>(out);
  dim3 grid((W + 127) / 128, nseg);
  skinny_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return err(cudaGetLastError());
}

const char* msd_ft_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
