// The latent fit's loss and latent gradient for NVIDIA Hopper (sm_90a), in
// exact float32 (ops/fused_fit.py; the reconstruct loop, train/reconstruct.py).
//
// Replaces no TPU kernel: the JAX package runs the fit as a lax.scan of XLA
// operations. It replaces the autograd route of the fit's iteration on the
// card (cuBLAS and CUTLASS float32 products, about 20 PyTorch elementwise,
// copy and reduction kernels), with the mathematics of K2 variant d (frozen
// decoder: the primal, the clamped L1, the delta chain's per-shape column
// sums) in float32 on the FMA pipe, no TF32.
//
// Layout: activations are feature-major, [width][M] with M = S x P points, P
// the shape's rows padded to a multiple of TILE, so no tile spans two
// shapes. Padded rows read xyz and sdf 0 and get a zero seed, so they add
// nothing to the loss or to the sums.
//
// Per iteration (H hidden layers, the flagship 8 x 512 with latent_in [4]):
//   fit_consts_kernel  c_l = W_l[:, latent] z + b_l for layer 0 and each
//                      latent_in layer, per shape (one small product);
//   fit_first_kernel   h_0 = relu(c_0 + Wx_0 xyz): three FMAs a column, and
//                      xyz and sdf transposed to [4][M];
//   fit_gemm_kernel<0> h_l = relu(W_l[:, hidden] h_{l-1} + c_l (+ Wx_l xyz)),
//                      layers 1 .. H-1: the latent's columns never multiply
//                      a point;
//   fit_last_kernel    the last layer's dot product, tanh, the clamp, the L1
//                      against the clamped sdf (per-tile sums) and the seed
//                      of the delta chain, delta_{H-1} = D_{H-1} (g w_last),
//                      written over h_{H-1};
//   fit_loss_kernel    per-shape means of the tile sums;
// and for the latent's gradient:
//   fit_gemm_kernel<1> delta_{l-1} = D_{l-1} (W_l[:, hidden]^T delta_l), D the
//                      mask h > 0 read in the epilogue and delta written
//                      over h, layers H-1 .. 1; at layer 0 and each latent_in
//                      layer the epilogue writes per-tile column sums of
//                      delta (layer 0's delta itself is not stored: no input
//                      gradient product runs);
//   fit_grad_kernel    dz = sum_l W_l[:, latent]^T colsum_l per shape, the
//                      tile sums added in tile order.
// Every sum runs in an order fixed by the tile and the thread, never by S,
// so a shape's loss and gradient have the same bits whatever other shapes
// share the batch (reconstruct_batch over ranks relies on it). The per-point
// kernels take a range of point tiles (jt0 and a count): the wrapper runs
// the tiles as two chains of launches on two streams, so the last partial
// wave of one chain's launch overlaps the other's work.
//
// Bound on an H100: the FP32 FMA pipe, 67 TFLOP/s. The flagship's products
// are 6.28 MFLOP a point and iteration, 402 GFLOP over 8 x 8000 points: 6.0
// ms. Their bytes (each activation written once and read about twice, 132
// MB a layer) are 3.4 GB, 1.0 ms at 3.35 TB/s. The products:
//   * a 128 x 128 output tile per block of 256 threads, 8 x 8 outputs a
//     thread as two 4-wide halves in each direction, so each k step is four
//     16-byte shared-memory loads for 64 FMAs, and a warp's loads of one
//     operand are 16 consecutive float4 (no bank conflict);
//   * both operands are k-major in device memory (weights pre-transposed
//     once per fit, activations feature-major), so each 16-deep k tile is a
//     pair of contiguous [16][128] slabs, copied by cp.async (16 bytes a
//     thread, no registers) through a 3-stage ring: 48 KB a block, two
//     blocks an SM (128 registers a thread at most);
//   * the block order walks the output tiles of one point tile first, so
//     the 2-4 blocks that read the same activations run together and read
//     them once from device memory;
//   * measured on an H100 (PERF.md): 46.4 TFLOP/s over the fit's products,
//     torch.matmul 47.1 on the same products. Not kept: 8- and 32-deep k
//     tiles, 2 and 4 stages (within 1%), a 4 x 8 lane layout of each warp
//     (fewer shared-memory wavefronts; no change), one block an SM with
//     more registers (4% slower), xyz reloaded per row in the epilogue
//     (1% slower).
//
// Plain C interface, loaded with ctypes (msd_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 128;        // points per tile; shapes' rows are padded to a multiple
constexpr int BI = 128;          // outputs per GEMM block
constexpr int BK = 16;           // depth of one pipeline stage
constexpr int STAGES = 3;        // k tiles in flight
constexpr int THREADS = 256;     // GEMM block: 16 x 16 threads of 8 x 8 outputs
constexpr int STAGE_FLOATS = 2 * BK * BI;               // a [BK][128] slab of each operand
constexpr int GEMM_SMEM = STAGES * STAGE_FLOATS * 4;    // 48 KB
constexpr int MAX_GROUPS = 8;    // layer 0 and the latent_in layers
static_assert(BK * 32 % THREADS == 0, "each thread copies whole float4 of a stage");
static_assert(GEMM_SMEM <= 48 * 1024, "dynamic shared memory past 48 KB needs cudaFuncSetAttribute");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// C[i][j] = sum_k P[k][i] Q[k][j] over the point tiles jt0, jt0 + 1, ... of
// the launch: P [K][I], Q [K][ld], C [I][ld], all row-major; I a multiple of
// BI, K of BK. MODE 0 (forward):
// C = relu(acc + cvec[s][i] (+ wx[i] . xyz[j])), s the tile's shape
// (cstride 0: one vector for every shape). MODE 1 (backward): C = acc where
// mask[i][j] > 0, else 0; C may be mask itself or null; part, if given,
// gets the tile's column sums, part[j tile][i].
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
    fit_gemm_kernel(const float* __restrict__ P, const float* __restrict__ Q, float* C, int I, int K, long long ld,
                    long long jt0, const float* __restrict__ cvec, int cstride, int tiles_per_shape,
                    const float* __restrict__ wx, const float* __restrict__ xt, const float* mask,
                    float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ni = I / BI;
  const int it = static_cast<int>(blockIdx.x % ni);
  const long long jt = jt0 + blockIdx.x / ni;
  const int i0 = it * BI;
  const long long j0 = jt * TILE;
  const int kt_n = K / BK;

  // this thread's copies: float4 column c4 of rows r0 + 8 u of each slab;
  // pointers advance by a k tile and the ring's slots rotate, so a k tile
  // costs few instructions besides its FMAs and shared-memory loads
  const int c4 = (tid & 31) * 4, r0 = tid >> 5;
  const float* pg = P + static_cast<long long>(r0) * I + i0 + c4;
  const float* qg = Q + static_cast<long long>(r0) * ld + j0 + c4;
  const uint32_t s0 = smem_u32(smem) + (r0 * BI + c4) * 4;
  auto load = [&](int stage) {
    const uint32_t sp = s0 + stage * STAGE_FLOATS * 4;
#pragma unroll
    for (int u = 0; u < BK * 32 / THREADS; ++u) {
      cp_async16(sp + u * (THREADS / 32) * BI * 4, pg + static_cast<long long>(u) * (THREADS / 32) * I);
      cp_async16(sp + (BK + u * (THREADS / 32)) * BI * 4, qg + static_cast<long long>(u) * (THREADS / 32) * ld);
    }
    pg += BK * I;
    qg += BK * ld;
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load(s);
    cp_async_commit();
  }
  int rd = 0, wr = STAGES - 1;  // the slot read this k tile, the slot loaded
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();  // k tile kt has landed (this thread's copies) ...
    __syncthreads();              // ... every thread's, and slot wr (read at kt - 1) is free
    if (kt + STAGES - 1 < kt_n) load(wr);
    cp_async_commit();
    const float* ps = smem + rd * STAGE_FLOATS;
    const float* qs = ps + BK * BI;
    rd = rd + 1 == STAGES ? 0 : rd + 1;
    wr = wr + 1 == STAGES ? 0 : wr + 1;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(ps + kk * BI + 4 * ty);
      const float4 p1 = *reinterpret_cast<const float4*>(ps + kk * BI + 64 + 4 * ty);
      const float4 q0 = *reinterpret_cast<const float4*>(qs + kk * BI + 4 * tx);
      const float4 q1 = *reinterpret_cast<const float4*>(qs + kk * BI + 64 + 4 * tx);
      const float a[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float b[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
  cp_async_wait<0>();

  // this thread's outputs: rows i0 + 4 ty + {0..3} and + 64; columns
  // j0 + 4 tx + {0..3} and + 64
  const long long jc[2] = {j0 + 4 * tx, j0 + 64 + 4 * tx};
  if (MODE == 0) {
    const int s = static_cast<int>(jt) / tiles_per_shape;
    float xv[3][8];
    if (wx != nullptr) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(xt + d * ld + jc[h]);
          xv[d][4 * h] = v.x;
          xv[d][4 * h + 1] = v.y;
          xv[d][4 * h + 2] = v.z;
          xv[d][4 * h + 3] = v.w;
        }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
      const float cst = cvec[static_cast<long long>(s) * cstride + i];
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = acc[r][c] + cst;
      if (wx != nullptr) {
        const float4 w = reinterpret_cast<const float4*>(wx)[i];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = fmaf(w.z, xv[2][c], fmaf(w.y, xv[1][c], fmaf(w.x, xv[0][c], v[c])));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(C + i * ld + jc[h]) =
            make_float4(fmaxf(v[4 * h], 0.0f), fmaxf(v[4 * h + 1], 0.0f), fmaxf(v[4 * h + 2], 0.0f),
                        fmaxf(v[4 * h + 3], 0.0f));
    }
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
      float v[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 m = *reinterpret_cast<const float4*>(mask + i * ld + jc[h]);
        v[4 * h] = m.x > 0.0f ? acc[r][4 * h] : 0.0f;
        v[4 * h + 1] = m.y > 0.0f ? acc[r][4 * h + 1] : 0.0f;
        v[4 * h + 2] = m.z > 0.0f ? acc[r][4 * h + 2] : 0.0f;
        v[4 * h + 3] = m.w > 0.0f ? acc[r][4 * h + 3] : 0.0f;
      }
      if (C != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(C + i * ld + jc[h]) = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
      }
      if (part != nullptr) {  // the tile's sum over its 128 points: 8 here, then the 16 lanes of this row
        float sum = v[0];
#pragma unroll
        for (int c = 1; c < 8; ++c) sum += v[c];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (tx == 0) part[jt * I + i] = sum;
      }
    }
  }
}

// per shape s and group g: out_g[s][i] = sum_j wzt_g[j][i] z[s][j] + bias_g[i]
struct Groups {
  const float* wzt[MAX_GROUPS];   // [L][width]
  const float* bias[MAX_GROUPS];  // [width]
  float* out[MAX_GROUPS];         // [S][width]
  const float* part[MAX_GROUPS];  // [S * tiles_per_shape][width] column sums
  const float* wz[MAX_GROUPS];    // [width][L]
  int width[MAX_GROUPS];
  int n;
};

// block (s, g, 32 outputs): warp w sums the latent columns w, w + 8, ..., the
// eight partial sums are added in warp order
__global__ void __launch_bounds__(256) fit_consts_kernel(const __grid_constant__ Groups g, const float* __restrict__ z,
                                                         int L) {
  __shared__ float red[8][32];
  const int s = blockIdx.x, grp = blockIdx.y, W = g.width[grp];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, i = blockIdx.z * 32 + lane;
  if (blockIdx.z * 32 >= W) return;
  const float* wzt = g.wzt[grp];
  const float* zs = z + static_cast<long long>(s) * L;
  float a = 0.0f;
  for (int j = warp; j < L; j += 8) a = fmaf(wzt[static_cast<long long>(j) * W + i], zs[j], a);
  red[warp][lane] = a;
  __syncthreads();
  if (warp == 0) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += red[w][lane];
    g.out[grp][static_cast<long long>(s) * W + i] = t + g.bias[grp][i];
  }
}

// one thread a point, FIRST_ROWS outputs a block: h0[i][p] = relu(c0[s][i] +
// wx0[i] . xyz); the first row of blocks also writes xyz and sdf to xt
// [4][M] (0 on padded rows)
constexpr int FIRST_ROWS = 64;

__global__ void __launch_bounds__(TILE)
    fit_first_kernel(const float4* __restrict__ batch, int n, int ppad, const float* __restrict__ c0,
                     const float4* __restrict__ wx0, int I0, long long M, long long jt0, float* __restrict__ h0,
                     float* __restrict__ xt) {
  const long long tile = jt0 + blockIdx.x;
  const long long p = tile * TILE + threadIdx.x;
  const int tps = ppad / TILE;
  const int s = static_cast<int>(tile / tps);
  const int row = static_cast<int>(tile % tps) * TILE + threadIdx.x;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row < n) v = batch[static_cast<long long>(s) * n + row];
  if (blockIdx.y == 0) {
    xt[p] = v.x;
    xt[M + p] = v.y;
    xt[2 * M + p] = v.z;
    xt[3 * M + p] = v.w;
  }
  const float* cs = c0 + static_cast<long long>(s) * I0;
  const int i1 = min(I0, static_cast<int>(blockIdx.y + 1) * FIRST_ROWS);
#pragma unroll 8
  for (int i = blockIdx.y * FIRST_ROWS; i < i1; ++i) {
    const float4 w = wx0[i];
    h0[i * M + p] = fmaxf(fmaf(w.z, v.z, fmaf(w.y, v.y, fmaf(w.x, v.x, cs[i]))), 0.0f);
  }
}

// one thread a point: y = tanh(w . h[:, p] + b), the clamped L1 against the
// clamped sdf, its tile sum, and the seed g = d|pred - gt|/dy / n written as
// delta[i][p] = (h[i][p] > 0) g w[i] over h
__global__ void __launch_bounds__(TILE)
    fit_last_kernel(float* h, int I, const float* __restrict__ w, const float* __restrict__ b,
                    const float* __restrict__ xt, long long M, long long jt0, int n, int ppad, float clamp,
                    float inv_n, float* __restrict__ loss_part) {
  __shared__ float red[TILE / 32];
  const long long tile = jt0 + blockIdx.x;
  const long long p = tile * TILE + threadIdx.x;
  const int row = static_cast<int>(tile % (ppad / TILE)) * TILE + threadIdx.x;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < I; i += 16) {  // I a multiple of 16: 16 loads in flight a thread
    float hv[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) hv[e] = h[(i + e) * M + p];
#pragma unroll
    for (int e = 0; e < 16; ++e) a[e & 3] = fmaf(w[i + e], hv[e], a[e & 3]);
  }
  const float y = tanhf(((a[0] + a[1]) + (a[2] + a[3])) + b[0]);
  float l1 = 0.0f, g = 0.0f;
  if (row < n) {
    const float pred = fminf(fmaxf(y, -clamp), clamp);
    const float gt = fminf(fmaxf(xt[3 * M + p], -clamp), clamp);
    const float d = pred - gt;
    l1 = fabsf(d);
    // autograd's conventions: sign(0) = 0; the clamp passes its edges
    const float sg = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
    if (y >= -clamp && y <= clamp) g = inv_n * sg * (1.0f - y * y);
  }
  for (int i = 0; i < I; i += 16) {  // the loads of 16 rows before their stores (h is written in place)
    float hv[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) hv[e] = h[(i + e) * M + p];
#pragma unroll
    for (int e = 0; e < 16; ++e) h[(i + e) * M + p] = hv[e] > 0.0f ? g * w[i + e] : 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = l1;
  __syncthreads();
  if (threadIdx.x == 0) loss_part[tile] = (red[0] + red[1]) + (red[2] + red[3]);
}

// loss[s] = the tile sums of shape s, in tile order, over n
__global__ void fit_loss_kernel(const float* __restrict__ loss_part, int S, int tiles_per_shape, int n,
                                float* __restrict__ loss) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float a = 0.0f;
  for (int t = 0; t < tiles_per_shape; ++t) a += loss_part[static_cast<long long>(s) * tiles_per_shape + t];
  loss[s] = a / static_cast<float>(n);
}

// block (s, 32 latent columns): colsum_g = shape s's tile sums in tile
// order; warp w sums rows w, w + 8, ... of dz[s][j] = go[s] sum_g sum_i
// wz_g[i][j] colsum_g[i], the eight partial sums added in warp order
__global__ void __launch_bounds__(256) fit_grad_kernel(const __grid_constant__ Groups g, int tiles_per_shape, int L,
                                                       const float* __restrict__ go, float* __restrict__ dz) {
  extern __shared__ float cs[];  // the groups' column sums, then [8][32] partial sums
  const int s = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, j = blockIdx.y * 32 + lane;
  int off = 0;
  for (int grp = 0; grp < g.n; ++grp) {
    const int W = g.width[grp];
    const float* part = g.part[grp] + static_cast<long long>(s) * tiles_per_shape * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      float a = 0.0f;
      int t = 0;
      for (; t + 8 <= tiles_per_shape; t += 8) {  // 8 loads in flight, added in tile order
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = part[static_cast<long long>(t + e) * W + i];
#pragma unroll
        for (int e = 0; e < 8; ++e) a += v[e];
      }
      for (; t < tiles_per_shape; ++t) a += part[static_cast<long long>(t) * W + i];
      cs[off + i] = a;
    }
    off += W;
  }
  float* red = cs + off;
  __syncthreads();
  float a = 0.0f;
  if (j < L) {
    off = 0;
    for (int grp = 0; grp < g.n; ++grp) {
      const int W = g.width[grp];
      const float* wz = g.wz[grp];
      for (int i = warp; i < W; i += 8) a = fmaf(wz[static_cast<long long>(i) * L + j], cs[off + i], a);
      off += W;
    }
  }
  red[warp * 32 + lane] = a;
  __syncthreads();
  if (warp == 0 && j < L) {
    float t = red[lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += red[w * 32 + lane];
    dz[static_cast<long long>(s) * L + j] = t * go[s];
  }
}

Groups make_groups(int n, const float* const* wzt, const float* const* bias, float* const* out,
                   const float* const* part, const float* const* wz, const int* width) {
  Groups g{};
  g.n = n;
  for (int k = 0; k < n; ++k) {
    g.wzt[k] = wzt != nullptr ? wzt[k] : nullptr;
    g.bias[k] = bias != nullptr ? bias[k] : nullptr;
    g.out[k] = out != nullptr ? out[k] : nullptr;
    g.part[k] = part != nullptr ? part[k] : nullptr;
    g.wz[k] = wz != nullptr ? wz[k] : nullptr;
    g.width[k] = width[k];
  }
  return g;
}

int max_width(const int* width, int n) {
  int w = 0;
  for (int k = 0; k < n; ++k) w = width[k] > w ? width[k] : w;
  return w;
}

}  // namespace

extern "C" {

int msd_fit_consts(int n_groups, const float* z, int S, int L, const float* const* wzt, const float* const* bias,
                   float* const* out, const int* width, void* stream) {
  if (n_groups < 1 || n_groups > MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  const Groups g = make_groups(n_groups, wzt, bias, out, nullptr, nullptr, width);
  const dim3 grid(S, n_groups, (max_width(width, n_groups) + 31) / 32);
  fit_consts_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(g, z, L);
  return static_cast<int>(cudaGetLastError());
}

int msd_fit_first(const float* batch, int S, int n, int ppad, const float* c0, const float* wx0, int I0, long long jt0,
                  long long tiles, float* h0, float* xt, void* stream) {
  const long long M = static_cast<long long>(S) * ppad;
  const dim3 grid(static_cast<unsigned>(tiles), (I0 + FIRST_ROWS - 1) / FIRST_ROWS);
  fit_first_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(batch), n, ppad, c0, reinterpret_cast<const float4*>(wx0), I0, M, jt0, h0, xt);
  return static_cast<int>(cudaGetLastError());
}

int msd_fit_gemm(const float* P, const float* Q, float* C, int I, int K, long long ld, long long jt0, long long tiles,
                 int mode, const float* cvec, int cstride, int tiles_per_shape, const float* wx, const float* xt,
                 const float* mask, float* part, void* stream) {
  if (I % BI != 0 || K % BK != 0 || ld % TILE != 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((I / BI) * tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    fit_gemm_kernel<0><<<grid, THREADS, GEMM_SMEM, st>>>(P, Q, C, I, K, ld, jt0, cvec, cstride, tiles_per_shape, wx,
                                                         xt, nullptr, nullptr);
  } else {
    fit_gemm_kernel<1><<<grid, THREADS, GEMM_SMEM, st>>>(P, Q, C, I, K, ld, jt0, nullptr, 0, tiles_per_shape,
                                                         nullptr, nullptr, mask, part);
  }
  return static_cast<int>(cudaGetLastError());
}

int msd_fit_last(float* h, int I, const float* w, const float* b, const float* xt, long long M, long long jt0,
                 long long tiles, int n, int ppad, float clamp, float inv_n, float* loss_part, void* stream) {
  if (I % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  fit_last_kernel<<<static_cast<unsigned>(tiles), TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      h, I, w, b, xt, M, jt0, n, ppad, clamp, inv_n, loss_part);
  return static_cast<int>(cudaGetLastError());
}

int msd_fit_loss(const float* loss_part, int S, int tiles_per_shape, int n, float* loss, void* stream) {
  fit_loss_kernel<<<(S + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(loss_part, S, tiles_per_shape, n,
                                                                                   loss);
  return static_cast<int>(cudaGetLastError());
}

int msd_fit_grad(int n_groups, const float* const* part, const float* const* wz, const int* width, int S,
                 int tiles_per_shape, int L, const float* go, float* dz, void* stream) {
  if (n_groups < 1 || n_groups > MAX_GROUPS) return static_cast<int>(cudaErrorInvalidValue);
  const Groups g = make_groups(n_groups, nullptr, nullptr, nullptr, part, wz, width);
  int total = 0;
  for (int k = 0; k < n_groups; ++k) total += width[k];
  fit_grad_kernel<<<dim3(S, (L + 31) / 32), 256, (total + 256) * 4, static_cast<cudaStream_t>(stream)>>>(
      g, tiles_per_shape, L, go, dz);
  return static_cast<int>(cudaGetLastError());
}

const char* msd_fit_error_string(int rc) { return cudaGetErrorString(static_cast<cudaError_t>(rc)); }

// The layout constants the wrapper pads to (ops/fused_fit.py checks them at load).
int msd_fit_tile() { return TILE; }
int msd_fit_width_pad() { return BI; }
int msd_fit_max_groups() { return MAX_GROUPS; }

}  // extern "C"
