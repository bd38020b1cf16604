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
// Design. The TPU kernel kept all weights resident on chip; 3.15 MB of bf16
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

const char* msd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
