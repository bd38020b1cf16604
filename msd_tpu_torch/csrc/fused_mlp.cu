// Fused DeepSDF decoder forward (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces msd_tpu/ops/fused_mlp.py:_fused_kernel_body, the Pallas TPU
// kernel: one latent over N query points. Layer l computes
//   a = Mp_l . h (+ Mx_l . xyz) + c_l,     c_l = z @ W_z + b (host side)
// then, on all layers but the last, optional LayerNorm over the true width
// (eps 1e-5) and ReLU, rounding h to the operand type T before the next
// product; the last layer (one output) applies the optional use_tanh and
// the final tanh and stores float32. Products accumulate in float32.
//
// Bound on an H100: compute. The flagship decoder has 1,573,376 weights in
// the kernel (3.147 MFLOP per point) against 16 bytes of point I/O, so 2^20
// points take at least 3.34 ms at the 989 TFLOP/s dense bf16 peak.
//
// Three routes, chosen by the decoder once (ops/fused_mlp.py, spec.route):
//   wgmma     bf16 operands, hidden widths up to 512, with or without
//             LayerNorm (every shipped config): fused_mlp_wgmma_kernel<LN>;
//   f32       float32 operands, hidden widths up to 512, with or without
//             LayerNorm: fused_mlp_f32_kernel;
//   mma_sync  hidden widths over 512, either operand type: fused_mlp_kernel,
//             described next (also callable on any spec, for measurements).
//
// mma_sync design. The TPU kernel kept all weights resident on chip; 3.15 MB of bf16
// weights are far over a block's 227 KB of shared memory, but they sit in
// the 50 MB L2 many times over. So:
//   * one block owns a tile of BM points (64 for bf16, 32 for float32); the
//     grid covers N and masks the ragged edge;
//   * the tile's activations live in dynamic shared memory as two
//     ping-pong buffers [BM][kmax+pad] of T; they never go to device memory.
//     Only a decoder too wide for that (bf16 or float32 hidden widths over
//     640) keeps them in a device scratch [2][n_pad][kmax] instead (GACT),
//     staging each [BM x 64] activation tile into shared memory beside its
//     weight tile;
//   * per layer, the block walks BN-wide output tiles (128 for bf16, 64 for
//     float32) and 64-deep K tiles, staging each [BN x 64] weight tile into
//     shared memory with cp.async (STAGES tiles in flight) and
//     accumulating in float32 registers: bf16 on mma.sync.m16n8k16 with
//     ldmatrix fragment loads (a 32 x 32 block per warp), float32 on FMAs;
//   * the xyz term (3 values) is added in the epilogue with FMAs;
//   * LayerNorm layers run the layer's product three times (row mean, row
//     variance, normalise + store), so no float32 copy of the layer is kept;
//   * the last layer is a per-point dot product reduced with warp shuffles.
// Hidden widths arrive zero-padded to multiples of BN (exact for ReLU
// layers; LayerNorm statistics use the true width).
//
// Plain C interface, loaded with ctypes (msd_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_LAYERS = 32;
constexpr int BK = 64;  // K tile (the output tile, BN, is per operand type)
constexpr int NTHREADS = 256;
constexpr float LN_EPS = 1e-5f;
constexpr int STAGES = 3;  // weight tiles in flight per block
constexpr long long MAX_SMEM_BYTES = 232448;  // dynamic shared memory of one block on sm_90

struct Params {
  const float* xyz;  // [n, 3]
  float* out;        // [n]
  long long n;
  int n_layers;
  int kmax;  // widest padded hidden width (activation buffer width)
  int use_tanh;
  const void* wp[MAX_LAYERS];    // [out_pad, in_pad] T, or null (layer 0)
  const void* wx[MAX_LAYERS];    // [out_pad, 3] T, or null
  const float* cl[MAX_LAYERS];   // [out_pad] latent consts + bias
  const float* lns[MAX_LAYERS];  // [out_pad] LayerNorm scale, or null
  const float* lnb[MAX_LAYERS];  // [out_pad] LayerNorm bias, or null
  void* scratch;                 // GACT only: activations [2][n_pad][kmax] of T
  long long n_pad;               // n rounded up to the point tile
  int in_pad[MAX_LAYERS];
  int out_pad[MAX_LAYERS];
  int out_true[MAX_LAYERS];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> struct Tile;

// bf16: 64-point tile, 128-wide output tiles; 8 warps as 2 (rows) x 4
// (cols), each warp a 32 x 32 block = 2 x 4 m16n8 tensor-core tiles.
template <> struct Tile<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int BM = 64, BN = 128, APAD = 8, WPAD = 8, NACC = 32;

  // accumulator i = 16 m + 4 j + e -> (row, col) within the output tile
  __device__ static void coord(int i, int& r, int& c) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3, m = i >> 4, j = (i >> 2) & 3, e = i & 3;
    r = 32 * (w & 1) + 16 * m + g + ((e >> 1) << 3);
    c = 32 * (w >> 1) + 8 * j + 2 * t + (e & 1);
  }

  // acc += act[:, k0:k0+BK] . wt^T, wt = [BN][BK] tile in shared memory
  __device__ static void mac(float* acc, const T* act, int astride, int k0, const T* wt, int wstride) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    // ldmatrix.x4: lane l addresses row (l & 7) of 8x8 matrix l >> 3. A's
    // four matrices are (rows 0-7 | 8-15) x (k 0-7 | 8-15) of 16 rows; B's
    // are (k 0-7 | 8-15) x (n tile 2p | 2p+1).
    const int li = lane >> 3, lr = lane & 7;
    const T* A = act + (32 * (w & 1) + lr + 8 * (li & 1)) * astride + k0 + 8 * (li >> 1);
    const T* B = wt + (32 * (w >> 1) + 8 * (li >> 1) + lr) * wstride + 8 * (li & 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[2][4];
      ldmatrix_x4(a[0], A + kk);
      ldmatrix_x4(a[1], A + 16 * astride + kk);
      ldmatrix_x4(b[0], B + kk);
      ldmatrix_x4(b[1], B + 16 * wstride + kk);
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
};

// float32: 32-point tile; thread (tr, tc) owns rows 2tr, 2tr+1 and columns
// tc + 16j (j < 4) of the 32 x 64 output tile.
template <> struct Tile<float> {
  using T = float;
  static constexpr int BM = 32, BN = 64, APAD = 4, WPAD = 4, NACC = 8;

  __device__ static void coord(int i, int& r, int& c) {
    r = 2 * (threadIdx.x >> 4) + (i >> 2);
    c = (threadIdx.x & 15) + 16 * (i & 3);
  }

  __device__ static void mac(float* acc, const T* act, int astride, int k0, const T* wt, int wstride) {
    const int r0 = 2 * (threadIdx.x >> 4), tc = threadIdx.x & 15;
    const T* A0 = act + r0 * astride + k0;
    const T* A1 = A0 + astride;
    const T* B = wt + tc * wstride;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float x0 = A0[kk], x1 = A1[kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = B[16 * j * wstride + kk];
        acc[j] = fmaf(x0, b, acc[j]);
        acc[4 + j] = fmaf(x1, b, acc[4 + j]);
      }
    }
  }
};

// Dynamic shared memory of one block: the activations (two [BM][kmax+pad]
// buffers, or with GACT STAGES staged [BM][BK+pad] tiles), STAGES weight
// tiles [BN][BK+pad], the tile's xyz [BM][4] and row statistics [2][BM].
template <typename T, bool GACT>
constexpr long long smem_bytes_t(int kmax) {
  using TL = Tile<T>;
  const long long act = GACT ? static_cast<long long>(STAGES) * TL::BM * (BK + TL::APAD)
                             : 2LL * TL::BM * (kmax + TL::APAD);
  return (act + static_cast<long long>(STAGES) * TL::BN * (BK + TL::WPAD)) * sizeof(T)
       + TL::BM * 16 + 2LL * TL::BM * 4;
}

// Device scratch of a launch over n points: 0 when the activations fit in
// shared memory, else two [n_pad][kmax] buffers of T.
template <typename T>
long long scratch_bytes_t(int kmax, long long n) {
  if (smem_bytes_t<T, false>(kmax) <= MAX_SMEM_BYTES) return 0;
  const long long n_pad = (n + Tile<T>::BM - 1) / Tile<T>::BM * Tile<T>::BM;
  return 2LL * n_pad * kmax * sizeof(T);
}

// Stage W[n0:n0+BN, k0:k0+BK] (row length in_pad) into dst [BN][wstride].
template <typename T>
__device__ __forceinline__ void load_wtile(T* dst, const T* W, int in_pad, int n0, int k0, int wstride) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = BK / PER;        // chunks per row
  for (int c = threadIdx.x; c < Tile<T>::BN * CPR; c += NTHREADS) {
    const int r = c / CPR, q = c % CPR;
    cp_async16(dst + r * wstride + q * PER, W + (size_t)(n0 + r) * in_pad + k0 + q * PER);
  }
}

// Stage A[0:BM, k0:k0+BK] (row length kmax, device scratch) into dst [BM][sstride].
template <typename T>
__device__ __forceinline__ void load_atile(T* dst, const T* A, int kmax, int k0, int sstride) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int CPR = BK / PER;
  for (int c = threadIdx.x; c < Tile<T>::BM * CPR; c += NTHREADS) {
    const int r = c / CPR, q = c % CPR;
    cp_async16(dst + r * sstride + q * PER, A + (size_t)r * kmax + k0 + q * PER);
  }
}

enum Mode { STORE = 0, ROW_SUM = 1, ROW_SQ = 2, NORM_STORE = 3 };

template <typename T>
__device__ __forceinline__ void epilogue(const float* acc, int n0, int mode, const Params& p, int l,
                                         const float* xs, float* stat, T* outb, int astride) {
  using TL = Tile<T>;
  const T* wx = static_cast<const T*>(p.wx[l]);
  const float* cl = p.cl[l];
  const int out_true = p.out_true[l];
#pragma unroll
  for (int i = 0; i < TL::NACC; ++i) {
    int r, c;
    TL::coord(i, r, c);
    c += n0;
    float v = acc[i];
    if (wx != nullptr) {
      const float* x = xs + 4 * r;
      v += x[0] * to_f(wx[3 * c]) + x[1] * to_f(wx[3 * c + 1]) + x[2] * to_f(wx[3 * c + 2]);
    }
    v += cl[c];
    if (mode == ROW_SUM) {
      if (c < out_true) atomicAdd(&stat[r], v);
    } else if (mode == ROW_SQ) {
      if (c < out_true) {
        const float d = v - stat[r];
        atomicAdd(&stat[TL::BM + r], d * d);
      }
    } else {
      if (mode == NORM_STORE) v = (v - stat[r]) * stat[TL::BM + r] * p.lns[l][c] + p.lnb[l][c];
      outb[r * astride + c] = from_f<T>(fmaxf(v, 0.0f));
    }
  }
}

template <typename T, bool GACT>
__global__ void __launch_bounds__(NTHREADS) fused_mlp_kernel(const Params p) {
  using TL = Tile<T>;
  constexpr int BM = TL::BM, BN = TL::BN;
  constexpr int sstride = BK + TL::APAD;  // GACT: staged activation tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const long long base = static_cast<long long>(blockIdx.x) * BM;
  const int wstride = BK + TL::WPAD;
  // act[i]: this tile's rows of activation buffer i, row stride astride
  T* act[2];
  T* at0;  // GACT: STAGES activation tiles [BM][sstride]
  T* wt0;  // STAGES weight tiles [BN][wstride]
  int astride;
  if constexpr (GACT) {
    astride = p.kmax;
    T* s = static_cast<T*>(p.scratch);
    act[0] = s + base * p.kmax;
    act[1] = s + (p.n_pad + base) * p.kmax;
    at0 = reinterpret_cast<T*>(smem);
    wt0 = at0 + STAGES * BM * sstride;
  } else {
    astride = p.kmax + TL::APAD;
    act[0] = reinterpret_cast<T*>(smem);
    act[1] = act[0] + BM * astride;
    at0 = nullptr;
    wt0 = act[1] + BM * astride;
  }
  float* xs = reinterpret_cast<float*>(wt0 + STAGES * BN * wstride);  // [BM][4]
  float* stat = xs + 4 * BM;                                   // [2][BM]

  for (int i = threadIdx.x; i < 4 * BM; i += NTHREADS) {
    const int r = i >> 2, j = i & 3;
    float x = 0.0f;
    if (j < 3 && base + r < p.n) x = p.xyz[3 * (base + r) + j];
    xs[i] = to_f(from_f<T>(x));  // xyz is rounded to the operand type
  }
  __syncthreads();

  float acc[TL::NACC];
  const int last = p.n_layers - 1;
  for (int l = 0; l < last; ++l) {
    const T* in = act[(l + 1) & 1];
    T* outb = act[l & 1];
    const T* Wp = static_cast<const T*>(p.wp[l]);
    const int n_tiles = p.out_pad[l] / BN;
    const int k_tiles = Wp != nullptr ? p.in_pad[l] / BK : 0;
    const bool has_ln = p.lns[l] != nullptr;
    const int npass = has_ln ? 3 : 1;
    for (int pass = 0; pass < npass; ++pass) {
      const int mode = !has_ln ? STORE : (pass == 0 ? ROW_SUM : (pass == 1 ? ROW_SQ : NORM_STORE));
      if (mode == ROW_SUM || mode == ROW_SQ) {
        for (int r = threadIdx.x; r < BM; r += NTHREADS) stat[(pass == 0 ? 0 : BM) + r] = 0.0f;
        __syncthreads();
      }
      if (k_tiles == 0) {
        for (int nt = 0; nt < n_tiles; ++nt) {
#pragma unroll
          for (int i = 0; i < TL::NACC; ++i) acc[i] = 0.0f;
          epilogue<T>(acc, nt * BN, mode, p, l, xs, stat, outb, astride);
        }
      } else {
        const int total = n_tiles * k_tiles;
#pragma unroll
        for (int i = 0; i < TL::NACC; ++i) acc[i] = 0.0f;
        // STAGES-deep pipeline over the flattened (n tile, k tile) walk:
        // tiles it+1 .. it+STAGES-1 are in flight while tile it computes
        // (GACT: each stage also takes the tile's [BM x BK] activations)
        for (int s = 0; s < STAGES - 1; ++s) {
          if (s < total) {
            load_wtile<T>(wt0 + s * BN * wstride, Wp, p.in_pad[l], (s / k_tiles) * BN, (s % k_tiles) * BK, wstride);
            if constexpr (GACT) load_atile<T>(at0 + s * BM * sstride, in, p.kmax, (s % k_tiles) * BK, sstride);
          }
          cp_async_commit();
        }
        for (int it = 0; it < total; ++it) {
          const int nt = it / k_tiles, kt = it % k_tiles;
          cp_async_wait<STAGES - 2>();  // tile it has landed (this thread's copies)
          __syncthreads();              // ... everyone's; and tile it-1's buffer is free
          const int nx = it + STAGES - 1;
          if (nx < total) {
            load_wtile<T>(wt0 + (nx % STAGES) * BN * wstride, Wp, p.in_pad[l], (nx / k_tiles) * BN,
                          (nx % k_tiles) * BK, wstride);
            if constexpr (GACT)
              load_atile<T>(at0 + (nx % STAGES) * BM * sstride, in, p.kmax, (nx % k_tiles) * BK, sstride);
          }
          cp_async_commit();
          if constexpr (GACT)
            TL::mac(acc, at0 + (it % STAGES) * BM * sstride, sstride, 0, wt0 + (it % STAGES) * BN * wstride, wstride);
          else
            TL::mac(acc, in, astride, kt * BK, wt0 + (it % STAGES) * BN * wstride, wstride);
          if (kt == k_tiles - 1) {
            epilogue<T>(acc, nt * BN, mode, p, l, xs, stat, outb, astride);
#pragma unroll
            for (int i = 0; i < TL::NACC; ++i) acc[i] = 0.0f;
          }
        }
        cp_async_wait<0>();
      }
      __syncthreads();
      if (mode == ROW_SUM || mode == ROW_SQ) {
        const float inv = 1.0f / static_cast<float>(p.out_true[l]);
        for (int r = threadIdx.x; r < BM; r += NTHREADS) {
          if (mode == ROW_SUM) stat[r] *= inv;  // mean
          else stat[BM + r] = 1.0f / sqrtf(stat[BM + r] * inv + LN_EPS);  // rstd
        }
        __syncthreads();
      }
    }
  }

  // last layer: one output per point, a dot product over the input row
  const T* in = act[(last + 1) & 1];
  const T* w = static_cast<const T*>(p.wp[last]);
  const T* wx = static_cast<const T*>(p.wx[last]);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < BM; r += NTHREADS / 32) {
    float s = 0.0f;
    if (w != nullptr) {
      for (int k = lane; k < p.in_pad[last]; k += 32) s += to_f(in[r * astride + k]) * to_f(w[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && base + r < p.n) {
      float v = s;
      if (wx != nullptr) v += xs[4 * r] * to_f(wx[0]) + xs[4 * r + 1] * to_f(wx[1]) + xs[4 * r + 2] * to_f(wx[2]);
      v += p.cl[last][0];
      if (p.use_tanh) v = tanhf(v);
      p.out[base + r] = tanhf(v);
    }
  }
}

template <typename T, bool GACT>
int launch_t(const Params& p, cudaStream_t stream) {
  const long long smem = smem_bytes_t<T, GACT>(p.kmax);
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel<T, GACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = p.n_pad / Tile<T>::BM;
  if (blocks == 0) return 0;
  fused_mlp_kernel<T, GACT><<<static_cast<unsigned>(blocks), NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(Params& p, long long scratch_bytes, cudaStream_t stream) {
  p.n_pad = (p.n + Tile<T>::BM - 1) / Tile<T>::BM * Tile<T>::BM;
  const long long need = scratch_bytes_t<T>(p.kmax, p.n);
  if (need == 0) return launch_t<T, false>(p, stream);
  if (p.scratch == nullptr || scratch_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  return launch_t<T, true>(p, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// The wgmma route: bf16, hidden widths padded to 256 or 512, LayerNorm or not.
//
// Why the mma_sync design stays far from the bound: a 64-point block streams all
// 3.15 MB of bf16 weights from L2 (51.6 GB per 2^20 points) and ends every
// 64-deep K tile in a block barrier. This design:
//   * a block owns 128 points: two consumer warpgroups of 64 rows each run
//     wgmma.mma_async m64n256k16 (bf16 in, float32 accumulators) on the
//     same weight tile, so each weight byte read from L2 feeds 128 points;
//   * the weights arrive as 32 KB tiles ([256 outputs][64 inputs], already
//     in the 128-byte-swizzled K-major layout a wgmma descriptor reads:
//     ops/fused_mlp.py lays them out once per spec, in the order they are
//     consumed) through a 3-stage ring of mbarriers. One producer thread
//     issues 1-D bulk copies (cp.async.bulk); setmaxnreg gives its
//     warpgroup's registers to the consumers. No block barrier per K tile;
//   * the blocks are persistent (one per SM): block b walks point tiles b,
//     b + blocks, ..., so the producer runs ahead into the next tile's
//     weights while the consumers finish a tile;
//   * a warpgroup's 64 rows of activations stay in shared memory as bf16 in
//     the swizzled layout (8 k-blocks of [64 rows][64], 64 KB) and are
//     overwritten in place by the layer's output: a 512-wide layer runs as
//     two 256-wide N tiles, the first one's outputs held as packed bf16 in
//     registers (64) while the second accumulates (128), then both are
//     written once every product has read the input;
//   * the epilogue runs in float32: the xyz term (three FMAs, layer 0 and
//     latent_in layers), c_l, ReLU, then bf16 into the next layer's layout.
//     The last layer (one output) is a per-row dot product fused into the
//     last hidden layer's epilogue, reduced over the quad of threads that
//     shares a row, then c_last, the optional use_tanh and tanh;
//   * LayerNorm layers (the LN = true instantiation) take the row mean and
//     variance in float32 over the true width before ReLU: per N tile two
//     passes reduced over the quad, the two N tiles of a 512-wide layer
//     merged by Chan's formula. N tile 0's float32 values wait in a device
//     scratch (L2-resident) until N tile 1's statistics exist; the layer
//     before the last feeds the dot product only after both;
//   * rows past n read xyz 0 and are not stored.
// Measured slower on an H100 and not kept (PERF.md): sharing each weight
// tile across a 2-block cluster by .multicast::cluster (half the L2
// traffic; L2 was not the limit, and a ring slot then waits for the
// slower of four consumer warpgroups), 128-wide N tiles in a 6 x 16 KB
// ring, and LayerNorm's row sum taken in the pass that adds c_l (fewer
// spills, yet slower on the flagship-width LayerNorm decoder).
// Shared memory: 1024 (alignment) + 128 KB activations + 3 x 32 KB ring +
// the barriers = 230,448 bytes: one block per SM.
// ---------------------------------------------------------------------------

namespace {

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;                        // points per block
constexpr int TN = 256;                        // outputs per N tile
constexpr int TK = 64;                         // inputs per K tile (one 128-byte row)
constexpr int KMAX = 512;                      // widest hidden layer
constexpr int STAGES = 3;                      // weight tiles in the ring
constexpr int THREADS = 384;                   // producer warpgroup + two consumers
constexpr int TILE_BYTES = TN * TK * 2;        // one weight tile (32 KB)
constexpr int KB_BYTES = 64 * TK * 2;          // a warpgroup's k-block [64 rows][64] (8 KB)
constexpr int WG_ACT_BYTES = KMAX / TK * KB_BYTES;  // a warpgroup's activations (64 KB)
constexpr int SMEM = 1024 + 2 * WG_ACT_BYTES + STAGES * TILE_BYTES + 2 * STAGES * 8;

struct Params {
  const float* xyz;  // [n, 3]
  float* out;        // [n]
  long long n;
  long long tiles;   // point tiles of BM
  int n_layers, use_tanh;
  int wtiles;                     // weight tiles per point tile
  const bf16* wt;                 // [wtiles][TN][TK], swizzled, in consumption order
  const bf16* wlast;              // [in_pad of the last layer]
  const float* wx[MAX_LAYERS];    // [out_pad][4] bf16-rounded xyz weights, or null
  const float* cl[MAX_LAYERS];    // [out_pad] latent consts + bias
  const float* lns[MAX_LAYERS];   // LN: [out_pad] LayerNorm scale (zero-padded), or null
  const float* lnb[MAX_LAYERS];   // LN: [out_pad] LayerNorm bias (zero-padded), or null
  float4* scratch;                // LN: [grid][2][32][128] float4, N tile 0 of a 512-wide LayerNorm layer
  int in_pad[MAX_LAYERS];         // 0 for layer 0
  int out_pad[MAX_LAYERS];        // 256 or 512; 1 for the last layer
  int out_true[MAX_LAYERS];       // true widths (LayerNorm statistics)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait for the completion of the barrier's phase of parity ``parity``; a
// wait that does not end (a fault in the barrier protocol) traps, so the
// launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++tries == (1u << 26)) __trap();
  } while (!done);
}

// 1-D bulk copy global -> shared, completing on ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma descriptor of a K-major operand in 128-byte swizzle ([rows][64]
// bf16, 128-byte rows, 8-row groups 1024 B apart); fields in 16-byte units
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 256] += A[64 x 16] B[16 x 256], both K-major bf16 in shared memory,
// float32 accumulators. Accumulator 4 j + 2 h + e of thread t of the
// warpgroup sits at row 16 (t / 32) + (t % 32) / 4 + 8 h, column
// 8 j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// After wgmma_wait: no read of the accumulators moves above it
__device__ __forceinline__ void acc_fence(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// xyz of a row, rounded to bf16 (0 past the end)
__device__ __forceinline__ void load_xyz(const Params& p, long long row, float* x) {
#pragma unroll
  for (int j = 0; j < 3; ++j) x[j] = row < p.n ? bf(__float2bfloat16_rn(p.xyz[3 * row + j])) : 0.0f;
}

// LN selects the epilogue at compile time: LN = false (every shipped
// config) is the kernel without LayerNorm; LN = true adds the LayerNorm
// layers' epilogue and leaves the other layers' as they are.
template <bool LN>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_wgmma_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + 2 * WG_ACT_BYTES;
  const uint32_t bars = ring + STAGES * TILE_BYTES;  // full[s], then empty[s]

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 2);  // both consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int i = 0; i < p.wtiles; ++i) {
          mbar_wait(bars + 8 * (STAGES + s), ph ^ 1);
          mbar_expect_tx(bars + 8 * s, TILE_BYTES);
          const unsigned char* src = reinterpret_cast<const unsigned char*>(p.wt) + static_cast<size_t>(i) * TILE_BYTES;
          bulk_load(ring + s * TILE_BYTES, src, TILE_BYTES, bars + 8 * s);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, w = t >> 5, q = t & 3, g = (t & 31) >> 2;
    const uint32_t a_base = base + c * WG_ACT_BYTES;  // this warpgroup's k-blocks
    // this thread's first accumulator row (the other is 8 further): its
    // 4-byte column pair q of 16-byte chunk 0 before the swizzle
    unsigned char* const arow = smem_raw + (a_base - raw) + (16 * w + g) * 128 + 4 * q;
    // the bf16 pair (j, h) of k-block kb: chunk j % 8 swizzled by the row's
    // low three bits, which are g for both rows
    auto pair = [&](int kb, int j, int h) {
      return reinterpret_cast<__nv_bfloat162*>(arow + kb * KB_BYTES + 8 * h * 128 + (((j & 7) ^ g) << 4));
    };
    const int last = p.n_layers - 1;
    int s = 0;
    uint32_t ph = 0;

    // acc = the K tiles of one N tile, read from the ring in order; each
    // slot is released once its products
    // are done, one stage's products staying in flight
    auto mma = [&](float(&acc)[128], int kt_n) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      int prev = 0;
      for (int kt = 0; kt < kt_n; ++kt) {
        mbar_wait(bars + 8 * s, ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
          wgmma_m64n256k16(acc, desc_k(a_base + kt * KB_BYTES + 32 * kk), desc_k(ring + s * TILE_BYTES + 32 * kk));
        wgmma_commit();
        wgmma_wait<1>();
        if (kt > 0 && t == 0) mbar_arrive(bars + 8 * (STAGES + prev));
        prev = s;
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      if (kt_n > 0 && t == 0) mbar_arrive(bars + 8 * (STAGES + prev));
      acc_fence(acc);
    };

    // float32 values of N tile nt of ``layer``: the products plus the xyz
    // term and c_l; take(j, h, v0, v1) takes each pair of columns
    auto xyz_cl = [&](const float(&acc)[128], int layer, int nt, long long row, auto take) {
      const float* wx = p.wx[layer];
      float x[2][3];
      if (wx != nullptr) {
        load_xyz(p, row, x[0]);
        load_xyz(p, row + 8, x[1]);
      }
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = nt * TN + 8 * j + 2 * q;
        const float2 cc = __ldg(reinterpret_cast<const float2*>(p.cl[layer] + col));
        float4 w0 = make_float4(0.f, 0.f, 0.f, 0.f), w1 = w0;
        if (wx != nullptr) {
          w0 = __ldg(reinterpret_cast<const float4*>(wx) + col);
          w1 = __ldg(reinterpret_cast<const float4*>(wx) + col + 1);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (wx != nullptr) {
            v0 += x[h][0] * w0.x + x[h][1] * w0.y + x[h][2] * w0.z;
            v1 += x[h][0] * w1.x + x[h][1] * w1.y + x[h][2] * w1.z;
          }
          take(j, h, v0 + cc.x, v1 + cc.y);
        }
      }
    };

    // float32 epilogue of N tile nt of ``layer``: xyz term, c_l, ReLU, bf16;
    // emit(j, h, pair) takes each bf16 pair
    auto epilogue = [&](float(&acc)[128], int layer, int nt, long long row, auto emit) {
      xyz_cl(acc, layer, nt, row, [&](int j, int h, float v0, float v1) {
        emit(j, h, __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f)));
      });
    };

    // LayerNorm layers (LN only). Each row's values lie in a quad of
    // threads, 64 per thread per N tile. ``pre`` turns the products into
    // the float32 pre-LayerNorm values in place (``xyz_cl``), ``stats``
    // takes an N tile's row mean and sum of squared deviations over its
    // columns below the true width (two passes, reduced over the quad), and
    // ``norm`` normalises, scales, shifts, applies ReLU and hands each bf16
    // pair to ``emit``. Padded columns have scale and bias 0, so they stay 0.
    auto pre = [&](float(&acc)[128], int layer, int nt, long long row) {
      xyz_cl(acc, layer, nt, row, [&](int j, int h, float v0, float v1) {
        acc[4 * j + 2 * h] = v0;
        acc[4 * j + 2 * h + 1] = v1;
      });
    };
    auto stats = [&](const float(&acc)[128], int valid, float(&mean)[2], float(&m2)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (8 * (i >> 1) + 2 * q + (i & 1) < valid) s += acc[4 * (i >> 1) + 2 * h + (i & 1)];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        mean[h] = s / static_cast<float>(valid);
        float d2 = 0.0f;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (8 * (i >> 1) + 2 * q + (i & 1) < valid) {
            const float d = acc[4 * (i >> 1) + 2 * h + (i & 1)] - mean[h];
            d2 += d * d;
          }
        }
        d2 += __shfl_xor_sync(0xffffffffu, d2, 1);
        d2 += __shfl_xor_sync(0xffffffffu, d2, 2);
        m2[h] = d2;
      }
    };
    auto norm = [&](const float(&acc)[128], int layer, int nt, const float(&mean)[2], const float(&rstd)[2],
                    auto emit) {
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = nt * TN + 8 * j + 2 * q;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(p.lns[layer] + col));
        const float2 sh = __ldg(reinterpret_cast<const float2*>(p.lnb[layer] + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = (acc[4 * j + 2 * h] - mean[h]) * rstd[h] * sc.x + sh.x;
          const float v1 = (acc[4 * j + 2 * h + 1] - mean[h]) * rstd[h] * sc.y + sh.y;
          emit(j, h, __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f)));
        }
      }
    };
    // N tile 0's pre-LayerNorm values of a 512-wide LayerNorm layer wait
    // in this thread's slice of the block's device scratch (float32, so
    // the rounding points stay those of the plain version) until N tile
    // 1's statistics exist: 128 registers cannot hold them beside tile
    // 1's accumulators, shared memory is full, and running tile 0's
    // products again would cost 1.45 times the products of those layers.
    // Coalesced: float4 i of thread t at [i][t]; 17 MB on 132 SMs, L2-resident.
    float4* const stash =
        LN && p.scratch != nullptr ? p.scratch + (static_cast<size_t>(blockIdx.x) * 2 + c) * 32 * 128 + t : nullptr;

    for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const long long row = tile * BM + 64 * c + 16 * w + g;  // and row + 8
      float dot[2] = {0.0f, 0.0f};
      for (int layer = 0; layer < last; ++layer) {
        const int nt_n = p.out_pad[layer] / TN, kt_n = p.in_pad[layer] / TK;
        float acc[128];
        if constexpr (LN) {
          if (p.lns[layer] != nullptr) {
            const int out_true = p.out_true[layer];
            float mean[2], m2[2], rstd[2];
            if (nt_n == 2) {
              mma(acc, kt_n);
              pre(acc, layer, 0, row);
              stats(acc, TN, mean, m2);  // tile 0 is all inside the true width
#pragma unroll
              for (int i = 0; i < 32; ++i)
                stash[i * 128] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
            }
            const int nt = nt_n - 1;
            mma(acc, kt_n);
            pre(acc, layer, nt, row);
            const int n1 = out_true - nt * TN;
            float mean1[2], m21[2];
            stats(acc, n1, mean1, m21);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float mu = mean1[h], s2 = m21[h];
              if (nt_n == 2) {  // Chan's merge of tile 0 (TN columns) and tile 1 (n1)
                const float n0 = static_cast<float>(TN), nb = static_cast<float>(n1), nn = n0 + nb;
                const float delta = mean1[h] - mean[h];
                mu = mean[h] + delta * (nb / nn);
                s2 = m2[h] + m21[h] + delta * delta * (n0 * nb / nn);
              }
              mean[h] = mu;
              rstd[h] = rsqrtf(s2 / static_cast<float>(out_true) + LN_EPS);
            }
            if (layer == last - 1) {  // the dot product over the normalised outputs
              auto to_dot = [&](int ntile, int j, int h, __nv_bfloat162 v) {
                const __nv_bfloat162 wl =
                    *reinterpret_cast<const __nv_bfloat162*>(p.wlast + ntile * TN + 8 * j + 2 * q);
                dot[h] += bf(v.x) * bf(wl.x) + bf(v.y) * bf(wl.y);
              };
              norm(acc, layer, nt, mean, rstd, [&](int j, int h, __nv_bfloat162 v) { to_dot(nt, j, h, v); });
              if (nt_n == 2) {
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                  const float4 v = stash[i * 128];
                  acc[4 * i] = v.x, acc[4 * i + 1] = v.y, acc[4 * i + 2] = v.z, acc[4 * i + 3] = v.w;
                }
                norm(acc, layer, 0, mean, rstd, [&](int j, int h, __nv_bfloat162 v) { to_dot(0, j, h, v); });
              }
            } else {
              named_bar_sync(1 + c, 128);  // every warp's products have read the layer's input
              norm(acc, layer, nt, mean, rstd,
                   [&](int j, int h, __nv_bfloat162 v) { *pair(4 * nt + (j >> 3), j, h) = v; });
              if (nt_n == 2) {
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                  const float4 v = stash[i * 128];
                  acc[4 * i] = v.x, acc[4 * i + 1] = v.y, acc[4 * i + 2] = v.z, acc[4 * i + 3] = v.w;
                }
                norm(acc, layer, 0, mean, rstd, [&](int j, int h, __nv_bfloat162 v) { *pair(j >> 3, j, h) = v; });
              }
              fence_proxy_async();
              named_bar_sync(1 + c, 128);  // the output is the next layer's input
            }
            continue;
          }
        }
        if (layer == last - 1) {
          // the last layer's dot product over this layer's bf16 outputs
          for (int nt = 0; nt < nt_n; ++nt) {
            mma(acc, kt_n);
            epilogue(acc, layer, nt, row, [&](int j, int h, __nv_bfloat162 v) {
              const __nv_bfloat162 wl =
                  *reinterpret_cast<const __nv_bfloat162*>(p.wlast + nt * TN + 8 * j + 2 * q);
              dot[h] += bf(v.x) * bf(wl.x) + bf(v.y) * bf(wl.y);
            });
          }
        } else {
          uint32_t held[TN / 4];  // N tile 0's outputs while N tile 1 accumulates
          if (nt_n == 2) {
            mma(acc, kt_n);
            epilogue(acc, layer, 0, row, [&](int j, int h, __nv_bfloat162 v) {
              held[2 * j + h] = *reinterpret_cast<uint32_t*>(&v);
            });
          }
          mma(acc, kt_n);
          named_bar_sync(1 + c, 128);  // every warp's products have read the layer's input
          const int nt = nt_n - 1;
          epilogue(acc, layer, nt, row, [&](int j, int h, __nv_bfloat162 v) { *pair(4 * nt + (j >> 3), j, h) = v; });
          if (nt_n == 2) {
#pragma unroll
            for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
              for (int h = 0; h < 2; ++h) *reinterpret_cast<uint32_t*>(pair(j >> 3, j, h)) = held[2 * j + h];
            }
          }
          fence_proxy_async();
          named_bar_sync(1 + c, 128);  // the output is the next layer's input
        }
      }
      // last layer: the quad of threads holding a row sums its dot product
      const float* wxl = p.wx[last];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = dot[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const long long r = row + 8 * h;
        if (q == 0 && r < p.n) {
          if (wxl != nullptr) {
            float x[3];
            load_xyz(p, r, x);
            v += x[0] * wxl[0] + x[1] * wxl[1] + x[2] * wxl[2];
          }
          v += p.cl[last][0];
          if (p.use_tanh) v = tanhf(v);
          p.out[r] = tanhf(v);
        }
      }
    }
  }
}

// bytes of LN scratch per block: two warpgroups' N tile 0 (64 x 256 float32 each)
constexpr long long SCRATCH_PER_BLOCK = 2LL * 32 * 128 * 16;

// persistent grid over ``tiles`` point tiles: one block per SM, or fewer
// when there are fewer tiles
cudaError_t grid_for(long long tiles, long long* grid) {
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) *grid = tiles < sms ? tiles : sms;
  return e;
}

template <bool LN>
int launch(const Params& p, long long grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_wgmma_kernel<LN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_mlp_wgmma_kernel<LN><<<static_cast<unsigned>(grid), THREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The f32 route: float32 operands, hidden widths up to 512, with or without
// LayerNorm (create_mesh(eval_dtype=torch.float32), PointEvaluator(dtype=
// torch.float32): the counterparts of msd_tpu's eval_dtype).
//
// Bound on an H100: the FP32 FMA pipe (exact float32 products and sums, no
// TF32), 67 TFLOP/s: 49.25 ms per 2^20 flagship points. Why fused_mlp_kernel's
// float32 path stays far from it: a 32-point block streams every float32
// weight from L2 (206 GB per 2^20 points), keeps 8 accumulators a thread (6
// shared-memory loads per 8 FMAs) and ends every 64-deep K tile in a block
// barrier. This design:
//   * persistent blocks (one per SM) walk 64-point tiles. Eight warps:
//     warp w owns rows 8w..8w+7 of the tile, lane l the columns
//     4l + 128i (i < 4, four float4), so a 512-wide layer's output sits in
//     128 float32 registers a thread and each weight byte read from L2 feeds
//     64 points (103 GB per 2^20 points);
//   * the activations stay in shared memory ([64][512] float32, 128 KB). A
//     warp reads and writes only its own 8 rows, so a __syncwarp orders a
//     layer's output after its products, and no block barrier runs;
//   * the weights, laid out once per spec K-major ([in_pad][out_pad], rows
//     of out_pad floats; ops/fused_mlp.py, spec.wk), arrive as 16-deep K
//     tiles (16 x out_pad x 4 bytes, at most 32 KB) through a 3-stage ring
//     of mbarriers, by 1-D bulk copies that thread 0 issues into each slot
//     once all eight warps have released it (no block barrier either);
//   * per 4 K steps a thread loads 8 float4 of activations (a broadcast:
//     the warp reads one address) and 16 float4 of weights for 512 FMAs, so
//     the FMA pipe, not shared memory, sets the pace. The products take the
//     count of float4 columns as a compile-time constant, with no branch
//     inside, so the next K step's loads overlap this one's FMAs;
//   * the epilogue: the xyz term, c_l, then LayerNorm where the layer has
//     one (a row's values lie in one warp: two-pass statistics over the
//     true width by warp shuffles) and ReLU; the last layer's dot product
//     is fused into the epilogue of the layer before it;
//   * rows past n read xyz 0 and are not stored. A width padded to an odd
//     multiple of 64 leaves half the lanes' last float4 column outside the
//     layer: they multiply into accumulators that nothing reads.
// Measured slower on an H100 and not kept (PERF.md): 16 warps of 4 rows
// (128 registers a thread, twice the weight loads per FMA).
// Shared memory: 3 x 32 KB ring + 128 KB activations + xyz + barriers =
// 230,448 bytes: one block per SM.
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 64;                        // points per tile
constexpr int KMAX = 512;                     // widest hidden layer
constexpr int TK = 16;                        // K rows per weight tile
constexpr int STAGES = 3;                     // weight tiles in the ring
constexpr int WARPS = 8;                      // 8 rows each
constexpr int THREADS = 32 * WARPS;
constexpr int SLOT_FLOATS = TK * KMAX;        // one ring slot (32 KB)
constexpr int SMEM = (STAGES * SLOT_FLOATS + BM * KMAX + BM * 4) * 4 + 2 * STAGES * 8;

struct Params {
  const float* xyz;  // [n, 3]
  float* out;        // [n]
  long long n;
  long long tiles;   // point tiles of BM
  int n_layers, use_tanh;
  const float* wk[MAX_LAYERS];   // [in_pad][out_pad] K-major, or null (layer 0)
  const float* wx[MAX_LAYERS];   // [out_pad][4] xyz weights, or null
  const float* cl[MAX_LAYERS];   // [out_pad] latent consts + bias
  const float* lns[MAX_LAYERS];  // [out_pad] LayerNorm scale (zero-padded), or null
  const float* lnb[MAX_LAYERS];  // [out_pad] LayerNorm bias (zero-padded), or null
  const float* wlast;            // [in_pad of the last layer]
  int in_pad[MAX_LAYERS];        // 0 for layer 0
  int out_pad[MAX_LAYERS];       // multiples of 64 up to 512; 1 for the last layer
  int out_true[MAX_LAYERS];      // true widths (LayerNorm statistics)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(THREADS, 1) fused_mlp_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char f32_smem[];
  float* const ring = reinterpret_cast<float*>(f32_smem);
  float* const act = ring + STAGES * SLOT_FLOATS;  // [BM][KMAX]
  float* const xs = act + BM * KMAX;               // [BM][4]
  const uint32_t ring_s = wg::smem_u32(ring);
  const uint32_t bars = wg::smem_u32(xs + BM * 4);  // full[s], then empty[s]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = p.n_layers - 1;

  // Thread 0 also feeds the ring: every K tile of every layer with
  // products, per point tile, in the order the warps consume them, each
  // into the slot that every warp has just released. A dedicated producer
  // warp would make 9 warps, 3 on one SM sub-partition, and cap every
  // thread at 168 registers; the accumulators alone take 128.
  bool feeds = false;  // whether any layer has products (else the ring is unused)
  for (int layer = 0; layer < last; ++layer) feeds = feeds || p.wk[layer] != nullptr;
  long long ld_tile = blockIdx.x;  // the next K tile to load: point tile, layer, K tile, slot
  int ld_layer = -1, ld_kt = 0, ld_s = 0;
  auto next_layer = [&]() {  // the next layer with products, wrapping to the next point tile
    do {
      if (++ld_layer == last) {
        ld_layer = 0;
        ld_tile += gridDim.x;
      }
    } while (p.wk[ld_layer] == nullptr);
  };
  auto issue_next = [&]() {
    if (ld_tile >= p.tiles) return;
    const int out_pad = p.out_pad[ld_layer];
    const uint32_t bytes = TK * out_pad * 4;
    wg::mbar_expect_tx(bars + 8 * ld_s, bytes);
    wg::bulk_load(ring_s + ld_s * SLOT_FLOATS * 4, p.wk[ld_layer] + static_cast<size_t>(ld_kt) * TK * out_pad, bytes,
                  bars + 8 * ld_s);
    ld_s = ld_s + 1 == STAGES ? 0 : ld_s + 1;
    if (++ld_kt == p.in_pad[ld_layer] / TK) {
      ld_kt = 0;
      next_layer();
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(bars + 8 * s, 1);
      wg::mbar_init(bars + 8 * (STAGES + s), WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (feeds) {
      next_layer();  // the first layer with products
      for (int s = 0; s < STAGES; ++s) issue_next();
    }
  }
  __syncthreads();

  float* const arow = act + 8 * warp * KMAX;  // this warp's 8 rows
  float* const xw = xs + 32 * warp;           // their xyz, [8][4]
  int s = 0;
  uint32_t ph = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long row0 = tile * BM + 8 * warp;
    __syncwarp();  // the previous tile's last reads of xw are done
    if (lane < 24) {
      const int r = lane / 3, j = lane % 3;
      xw[4 * r + j] = row0 + r < p.n ? p.xyz[3 * (row0 + r) + j] : 0.0f;
    }
    __syncwarp();
    for (int layer = 0; layer < last; ++layer) {
      const int out_pad = p.out_pad[layer];
      float acc[8][16];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[r][c] = 0.0f;
      bool on[4];  // which of this lane's four float4 columns lie inside out_pad
#pragma unroll
      for (int i = 0; i < 4; ++i) on[i] = 128 * i + 4 * lane < out_pad;

      // the products, at a compile-time count of float4 columns per lane
      // (ceil(out_pad / 128)) with no branch inside, so the compiler can
      // load the next K step's operands while this one's FMAs run (behind a
      // per-lane branch each weight load stalled its own 32 FMAs). A lane
      // past out_pad in the last float4 column multiplies neighbouring ring
      // floats into accumulators that nothing reads.
      auto products = [&](auto nch_c) {
        constexpr int NCH = decltype(nch_c)::value;
        const int kt_n = p.in_pad[layer] / TK;
        for (int kt = 0; kt < kt_n; ++kt) {
          wg::mbar_wait(bars + 8 * s, ph);
          const float* wt = ring + s * SLOT_FLOATS + 4 * lane;
          const float* a = arow + kt * TK;
#pragma unroll
          for (int k4 = 0; k4 < TK; k4 += 4) {
            float4 av[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) av[r] = *reinterpret_cast<const float4*>(a + r * KMAX + k4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float* wrow = wt + (k4 + kk) * out_pad;
#pragma unroll
              for (int i = 0; i < NCH; ++i) {
                const float4 wv = *reinterpret_cast<const float4*>(wrow + 128 * i);
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                  const float x = comp(av[r], kk);
                  acc[r][4 * i] = fmaf(x, wv.x, acc[r][4 * i]);
                  acc[r][4 * i + 1] = fmaf(x, wv.y, acc[r][4 * i + 1]);
                  acc[r][4 * i + 2] = fmaf(x, wv.z, acc[r][4 * i + 2]);
                  acc[r][4 * i + 3] = fmaf(x, wv.w, acc[r][4 * i + 3]);
                }
              }
            }
          }
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(bars + 8 * (STAGES + s));
          if (threadIdx.x == 0) {  // slot s is free once every warp has arrived
            wg::mbar_wait(bars + 8 * (STAGES + s), ph);
            issue_next();
          }
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      };
      if (p.wk[layer] != nullptr) {
        switch ((out_pad + 127) / 128) {
          case 1: products(std::integral_constant<int, 1>()); break;
          case 2: products(std::integral_constant<int, 2>()); break;
          case 3: products(std::integral_constant<int, 3>()); break;
          default: products(std::integral_constant<int, 4>()); break;
        }
      }

      // epilogue: xyz term and c_l
      const float* wx = p.wx[layer];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!on[i]) continue;
        const int col = 128 * i + 4 * lane;
        const float4 cc = __ldg(reinterpret_cast<const float4*>(p.cl[layer] + col));
        float4 w4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w4[e] = wx != nullptr ? __ldg(reinterpret_cast<const float4*>(wx) + col + e) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float x0 = xw[4 * r], x1 = xw[4 * r + 1], x2 = xw[4 * r + 2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = acc[r][4 * i + e];
            if (wx != nullptr) v += x0 * w4[e].x + x1 * w4[e].y + x2 * w4[e].z;
            acc[r][4 * i + e] = v + comp(cc, e);
          }
        }
      }
      // LayerNorm over the true width (two passes, warp shuffles), then ReLU
      if (p.lns[layer] != nullptr) {
        const int out_true = p.out_true[layer];
        const float inv = 1.0f / static_cast<float>(out_true);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float sum = 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (on[i] && 128 * i + 4 * lane + e < out_true) sum += acc[r][4 * i + e];
          const float mean = warp_sum(sum) * inv;
          float d2 = 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (on[i] && 128 * i + 4 * lane + e < out_true) {
                const float d = acc[r][4 * i + e] - mean;
                d2 += d * d;
              }
          const float rstd = rsqrtf(warp_sum(d2) * inv + LN_EPS);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (!on[i]) continue;
            const int col = 128 * i + 4 * lane;
            const float4 sc = __ldg(reinterpret_cast<const float4*>(p.lns[layer] + col));
            const float4 sh = __ldg(reinterpret_cast<const float4*>(p.lnb[layer] + col));
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][4 * i + e] = (acc[r][4 * i + e] - mean) * rstd * comp(sc, e) + comp(sh, e);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[r][c] = fmaxf(acc[r][c], 0.0f);

      if (layer < last - 1) {
        __syncwarp();  // every lane's products have read the layer's input
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!on[i]) continue;
#pragma unroll
          for (int r = 0; r < 8; ++r)
            *reinterpret_cast<float4*>(arow + r * KMAX + 128 * i + 4 * lane) =
                make_float4(acc[r][4 * i], acc[r][4 * i + 1], acc[r][4 * i + 2], acc[r][4 * i + 3]);
        }
        __syncwarp();  // the output is the next layer's input
        continue;
      }
      // the last layer: one output per row, a dot product over this layer's outputs
      float dot[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) dot[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!on[i]) continue;
        const float4 wl = __ldg(reinterpret_cast<const float4*>(p.wlast + 128 * i + 4 * lane));
#pragma unroll
        for (int r = 0; r < 8; ++r)
          dot[r] += acc[r][4 * i] * wl.x + acc[r][4 * i + 1] * wl.y + acc[r][4 * i + 2] * wl.z + acc[r][4 * i + 3] * wl.w;
      }
      const float* wxl = p.wx[last];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float v = warp_sum(dot[r]);
        if (lane == r && row0 + r < p.n) {
          if (wxl != nullptr) v += xw[4 * r] * wxl[0] + xw[4 * r + 1] * wxl[1] + xw[4 * r + 2] * wxl[2];
          v += p.cl[last][0];
          if (p.use_tanh) v = tanhf(v);
          p.out[row0 + r] = tanhf(v);
        }
      }
    }
  }
}

int launch(const Params& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  long long grid = 0;
  if (e == cudaSuccess) e = wg::grid_for(p.tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_mlp_f32_kernel<<<static_cast<unsigned>(grid), THREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

extern "C" {

// Bytes of device scratch msd_fused_mlp_forward needs for n points at this
// width: 0 when a tile's activations fit in shared memory; -1 for a bad dtype.
long long msd_fused_mlp_scratch_bytes(int dtype, int kmax, long long n) {
  if (dtype == 0) return scratch_bytes_t<__nv_bfloat16>(kmax, n);
  if (dtype == 1) return scratch_bytes_t<float>(kmax, n);
  return -1;
}

// dtype: 0 = bf16 operands, 1 = float32 operands. Pointer arrays are host
// arrays of device pointers, one per layer. scratch holds scratch_bytes
// bytes of device memory (msd_fused_mlp_scratch_bytes; may be null when
// that is 0). Returns a cudaError_t code.
int msd_fused_mlp_forward(int dtype, int n_layers, const void* xyz, void* out, long long n,
                          const void* const* wp, const void* const* wx, const void* const* cl,
                          const void* const* lns, const void* const* lnb, const int* in_pad,
                          const int* out_pad, const int* out_true, int kmax, int use_tanh,
                          void* scratch, long long scratch_bytes, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bn = dtype == 0 ? Tile<__nv_bfloat16>::BN : Tile<float>::BN;
  if (n_layers < 1 || n_layers > MAX_LAYERS || kmax < bn || kmax % bn != 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xyz = static_cast<const float*>(xyz);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.n_layers = n_layers;
  p.kmax = kmax;
  p.use_tanh = use_tanh;
  p.scratch = scratch;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    if (cl[l] == nullptr || (lns[l] == nullptr) != (lnb[l] == nullptr) || (last && lns[l] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (wp[l] != nullptr && (in_pad[l] % BK != 0 || in_pad[l] > kmax || in_pad[l] < BK))
      return static_cast<int>(cudaErrorInvalidValue);
    if (!last && (out_pad[l] % bn != 0 || out_pad[l] > kmax || out_true[l] > out_pad[l]))
      return static_cast<int>(cudaErrorInvalidValue);
    if (last && out_pad[l] != 1) return static_cast<int>(cudaErrorInvalidValue);
    p.wp[l] = wp[l];
    p.wx[l] = wx[l];
    p.cl[l] = static_cast<const float*>(cl[l]);
    p.lns[l] = static_cast<const float*>(lns[l]);
    p.lnb[l] = static_cast<const float*>(lnb[l]);
    p.in_pad[l] = in_pad[l];
    p.out_pad[l] = out_pad[l];
    p.out_true[l] = out_true[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(p, scratch_bytes, s);
  return launch<float>(p, scratch_bytes, s);
}

// The wgmma route. wt: the hidden layers' weight tiles, wtiles of them
// ([256][64] bf16 each, 128-byte swizzled, in the order of the layers, N
// tiles and K tiles); wlast: the last layer's [in_pad] bf16 weights; wx:
// per layer [out_pad][4] float32 or null; cl: per layer [out_pad] float32;
// lns, lnb: per layer [out_pad] float32 LayerNorm scale and bias
// (zero-padded), both null or both set, never on the last layer; out_true:
// per layer true widths. in_pad[0] is 0; hidden out_pad is 256 or 512, the
// last layer's 1. scratch: scratch_bytes bytes of device memory, at least
// msd_fused_mlp_wgmma_scratch_bytes(n) when a LayerNorm layer is 512 wide
// (else it may be null). Returns a cudaError_t code.
int msd_fused_mlp_wgmma(int n_layers, const void* xyz, void* out, long long n, const void* wt, int wtiles,
                        const void* wlast, const void* const* wx, const void* const* cl,
                        const void* const* lns, const void* const* lnb, const int* in_pad,
                        const int* out_pad, const int* out_true, int use_tanh, void* scratch,
                        long long scratch_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_layers < 2 || n_layers > MAX_LAYERS || n < 0 || wlast == nullptr ||
      in_pad[0] != 0 || out_pad[n_layers - 1] != 1 || wtiles < 0 || (wtiles > 0) != (wt != nullptr))
    return bad;
  wg::Params p;
  p.xyz = static_cast<const float*>(xyz);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.n_layers = n_layers;
  p.use_tanh = use_tanh;
  p.wtiles = wtiles;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.wlast = static_cast<const __nv_bfloat16*>(wlast);
  p.scratch = static_cast<float4*>(scratch);
  long long tiles = 0;
  bool ln = false, wide_ln = false;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    if (cl[l] == nullptr || (l > 0 && in_pad[l] != out_pad[l - 1])) return bad;
    if ((lns[l] == nullptr) != (lnb[l] == nullptr) || (last && lns[l] != nullptr)) return bad;
    if (!last && (out_pad[l] != wg::TN && out_pad[l] != 2 * wg::TN)) return bad;
    if (!last && (out_true[l] < 1 || out_true[l] > out_pad[l] || out_true[l] <= out_pad[l] - wg::TN)) return bad;
    if (!last) tiles += static_cast<long long>(out_pad[l] / wg::TN) * (in_pad[l] / wg::TK);
    ln = ln || lns[l] != nullptr;
    wide_ln = wide_ln || (lns[l] != nullptr && out_pad[l] == 2 * wg::TN);
    p.wx[l] = static_cast<const float*>(wx[l]);
    p.cl[l] = static_cast<const float*>(cl[l]);
    p.lns[l] = static_cast<const float*>(lns[l]);
    p.lnb[l] = static_cast<const float*>(lnb[l]);
    p.in_pad[l] = in_pad[l];
    p.out_pad[l] = out_pad[l];
    p.out_true[l] = out_true[l];
  }
  if (tiles != wtiles) return bad;
  if (n == 0) return 0;
  p.tiles = (n + wg::BM - 1) / wg::BM;
  long long grid = 0;
  const cudaError_t e = wg::grid_for(p.tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (wide_ln && (scratch == nullptr || scratch_bytes < grid * wg::SCRATCH_PER_BLOCK)) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ln ? wg::launch<true>(p, grid, s) : wg::launch<false>(p, grid, s);
}

// Bytes of device scratch msd_fused_mlp_wgmma needs for n points when a
// LayerNorm layer is 512 wide (one block's share per SM the launch uses);
// -1 on a CUDA error.
long long msd_fused_mlp_wgmma_scratch_bytes(long long n) {
  long long grid = 0;
  if (wg::grid_for((n + wg::BM - 1) / wg::BM, &grid) != cudaSuccess) return -1;
  return grid * wg::SCRATCH_PER_BLOCK;
}

// The f32 route. wk: per layer the [in_pad][out_pad] float32 weights of the
// previous layer's output, K-major (null for layer 0 and the last layer);
// wlast: the last layer's [in_pad] float32 weights; wx: per layer
// [out_pad][4] float32 or null; cl: per layer [out_pad] float32; lns, lnb:
// per layer [out_pad] LayerNorm scale and bias (zero-padded), both null or
// both set, never on the last layer; out_true: per layer true widths.
// in_pad[0] is 0; hidden out_pad is a multiple of 64 up to 512, the last
// layer's 1. Returns a cudaError_t code.
int msd_fused_mlp_f32(int n_layers, const void* xyz, void* out, long long n, const void* const* wk,
                      const void* wlast, const void* const* wx, const void* const* cl, const void* const* lns,
                      const void* const* lnb, const int* in_pad, const int* out_pad, const int* out_true,
                      int use_tanh, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_layers < 2 || n_layers > MAX_LAYERS || n < 0 || wlast == nullptr || in_pad[0] != 0 || wk[0] != nullptr ||
      out_pad[n_layers - 1] != 1)
    return bad;
  f32::Params p;
  p.xyz = static_cast<const float*>(xyz);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.n_layers = n_layers;
  p.use_tanh = use_tanh;
  p.wlast = static_cast<const float*>(wlast);
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    if (cl[l] == nullptr || (l > 0 && in_pad[l] != out_pad[l - 1])) return bad;
    if ((lns[l] == nullptr) != (lnb[l] == nullptr) || (last && lns[l] != nullptr)) return bad;
    if (!last && (out_pad[l] < 64 || out_pad[l] > f32::KMAX || out_pad[l] % 64 != 0)) return bad;
    if (!last && (out_true[l] < 1 || out_true[l] > out_pad[l])) return bad;
    if (!last && l > 0 && (wk[l] == nullptr) != (in_pad[l] == 0)) return bad;
    p.wk[l] = last ? nullptr : static_cast<const float*>(wk[l]);
    p.wx[l] = static_cast<const float*>(wx[l]);
    p.cl[l] = static_cast<const float*>(cl[l]);
    p.lns[l] = static_cast<const float*>(lns[l]);
    p.lnb[l] = static_cast<const float*>(lnb[l]);
    p.in_pad[l] = in_pad[l];
    p.out_pad[l] = out_pad[l];
    p.out_true[l] = out_true[l];
  }
  if (n == 0) return 0;
  p.tiles = (n + f32::BM - 1) / f32::BM;
  return f32::launch(p, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block: route 0 the mma_sync kernel (bf16,
// activations in shared memory) at hidden width kmax, route 1 the wgmma
// kernel, route 2 the f32 kernel.
long long msd_fused_mlp_smem_bytes(int route, int kmax) {
  return route == 1 ? wg::SMEM : route == 2 ? f32::SMEM : smem_bytes_t<__nv_bfloat16, false>(kmax);
}

const char* msd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
