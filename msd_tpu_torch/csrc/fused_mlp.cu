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
// Four routes, one kernel each, chosen by the decoder once (ops/fused_mlp.py,
// spec.route) by operand type and width, LayerNorm or not:
//   wgmma       bf16, hidden widths up to 512 (every shipped config):
//               fused_mlp_wgmma_kernel<LN>, activations in shared memory;
//   wgmma_wide  bf16, wider: fused_mlp_wgmma_wide_kernel<LN>, activations
//               streamed from a per-block device scratch;
//   f32         float32 up to 512: fused_mlp_f32_kernel;
//   f32_wide    float32, wider: fused_mlp_f32_wide_kernel (the same split).
// A wide kernel takes a decoder with no hidden layer too.
//
// Plain C interface, loaded with ctypes (msd_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_LAYERS = 32;
constexpr float LN_EPS = 1e-5f;

}  // namespace

// ---------------------------------------------------------------------------
// The wgmma route: bf16, hidden widths padded to 256 or 512, LayerNorm or not.
//
// Why a 64-point block on mma.sync (this route's first design, since
// retired) stays far from the bound: it streams all 3.15 MB of bf16 weights
// from L2 (51.6 GB per 2^20 points) and ends every 64-deep K tile in a
// block barrier. This design:
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
// TF32), 67 TFLOP/s: 49.25 ms per 2^20 flagship points. Why the first
// float32 design (since retired) stayed far from it: a 32-point block
// streamed every float32 weight from L2 (206 GB per 2^20 points), kept 8
// accumulators a thread (6 shared-memory loads per 8 FMAs) and ended every
// 64-deep K tile in a block barrier. This design:
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

// ---------------------------------------------------------------------------
// The wgmma route past 512: bf16, any hidden width (padded to a multiple of
// 256), LayerNorm or not, and decoders with no hidden layer.
//
// Why the 512 design does not stretch: a warpgroup's 64 rows of bf16
// activations take 128 bytes per unit of width in shared memory (128 KB at
// 1024), and the block has 227 KB beside its weight ring. So both operands
// stream here, and each layer is a chain of [128 x W_in] x [W_in x 256]
// products, one per 256-wide N tile:
//   * a block owns 128 points as in the 512 design (two consumer warpgroups
//     of 64 rows share every weight tile; persistent blocks, one producer
//     thread); the tile's activations live in the block's share of a device
//     scratch, two ping-pong buffers of [W / 64 k-blocks][128 rows][64] bf16
//     in the 128-byte swizzle a wgmma descriptor reads, so the K tile of the
//     input that a weight tile multiplies is one contiguous 16 KB;
//   * a ring stage holds a weight tile (32 KB) and that input K tile (16 KB),
//     both copied by cp.async.bulk onto one mbarrier;
//   * each N tile's epilogue (the xyz term, c_l, ReLU, bf16) stores straight
//     into the other buffer; once a layer's outputs are all stored, every
//     consumer thread fences them for the async proxy and arrives on the
//     ``ready`` mbarrier, and only then does the producer copy the next
//     layer's input (one wait per layer and point tile);
//   * LayerNorm over any number of N tiles: each N tile's float32
//     pre-LayerNorm values wait in a per-block float32 scratch (each thread
//     reads back only what it wrote, coalesced as [float4 i][thread]) while
//     the row's mean and sum of squared deviations merge tile by tile by
//     Chan's formula; a second pass normalises, applies ReLU and stores or
//     feeds the last layer's dot product. A layer without products (layer 0)
//     is recomputed from xyz in the second pass instead of parked;
//   * the last layer's dot product is fused into the epilogue of the layer
//     before it, as in the 512 design; rows past n read xyz 0 and are not
//     stored.
// What bounds it: the bytes each SM pulls from L2. Every input K tile is
// read once per N tile and every weight tile once per 128 points: 85 FLOP a
// byte (the 512 design reads only weights there: 128). Tried on an H100 and
// found to move the time little: every input K tile an L2 hit, L2 eviction
// hints, and no wait for a layer's input before copying it (the first and
// last give wrong results: bounds only). A third consumer warpgroup (192
// points, 112 FLOP a byte) does not build: 512 threads leave ptxas 128
// registers a thread, fewer than a 64 x 256 float32 accumulator takes
// (setmaxnreg moves registers at run time, not in ptxas's budget).
// The scratch (2 x 128 x W bf16 of activations, 128 x W float32 for
// LayerNorm layers with products) is per block, so a launch whose scratch
// would pass the wrapper's cap runs fewer persistent blocks.
// Shared memory: 1024 (alignment) + 4 x 48 KB ring + the barriers.
// ---------------------------------------------------------------------------

namespace wgw {

using wg::BM;
using wg::TN;
using wg::TK;
using wg::THREADS;
using wg::TILE_BYTES;
using wg::KB_BYTES;
using wg::bf16;
using wg::acc_fence;
using wg::bf;
using wg::bulk_load;
using wg::desc_k;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::setmaxnreg_dec;
using wg::setmaxnreg_inc;
using wg::smem_u32;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_m64n256k16;
using wg::wgmma_wait;
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * TK * 2;                   // an input K tile [128 rows][64] (16 KB)
constexpr int STAGE_BYTES = TILE_BYTES + A_BYTES;      // weight tile + input K tile (48 KB)
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8;
constexpr int CONSUMERS = 256;                         // threads of the two consumer warpgroups
constexpr long long PARK_TILE_BYTES = 2LL * 32 * 128 * 16;  // both warpgroups' float32 N tile

struct Params {
  const float* xyz;  // [n, 3]
  float* out;        // [n]
  long long n;
  long long tiles;   // point tiles of BM
  int n_layers, use_tanh;
  const bf16* wt;                 // the hidden layers' weight tiles [TN][TK], swizzled, in consumption order
  const bf16* wlast;              // [in_pad of the last layer]; null without a hidden layer
  const float* wx[MAX_LAYERS];    // [out_pad][4] bf16-rounded xyz weights, or null
  const float* cl[MAX_LAYERS];    // [out_pad] latent consts + bias
  const float* lns[MAX_LAYERS];   // LN: [out_pad] LayerNorm scale (zero-padded), or null
  const float* lnb[MAX_LAYERS];   // LN: [out_pad] LayerNorm bias (zero-padded), or null
  unsigned char* act;             // [grid][2][act_kb][BM][TK] bf16 swizzled, or null
  long long act_buf;              // bytes of one activation buffer (act_kb * A_BYTES)
  float4* park;                   // LN: [grid][2 warpgroups][park_nt][32][128] float4, or null
  int park_nt;                    // N tiles of the widest parked layer
  int in_pad[MAX_LAYERS];         // 0 for layer 0
  int out_pad[MAX_LAYERS];        // multiples of 256; 1 for the last layer
  int out_true[MAX_LAYERS];       // true widths (LayerNorm statistics)
};

// the bf16-rounded xyz of a row (0 past the end)
__device__ __forceinline__ void load_xyz(const Params& p, long long row, float* x) {
#pragma unroll
  for (int j = 0; j < 3; ++j) x[j] = row < p.n ? bf(__float2bfloat16_rn(p.xyz[3 * row + j])) : 0.0f;
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

template <bool LN>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_wgmma_wide_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * STAGE_BYTES;  // full[s], empty[s], then ready
  const uint32_t ready = bars + 16 * STAGES;          // a layer's outputs are stored
  unsigned char* const act = p.act == nullptr ? nullptr : p.act + 2 * p.act_buf * blockIdx.x;
  const int last = p.n_layers - 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 2);  // both consumer warpgroups
    }
    mbar_init(ready, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0, rph = 0;
      for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const unsigned char* w = reinterpret_cast<const unsigned char*>(p.wt);
        for (int layer = 1; layer < last; ++layer) {
          mbar_wait(ready, rph);  // the layer's input is stored
          rph ^= 1;
          const unsigned char* in = act + ((layer - 1) & 1) * p.act_buf;
          const int nt_n = p.out_pad[layer] / TN, kt_n = p.in_pad[layer] / TK;
          for (int nt = 0; nt < nt_n; ++nt) {
            for (int kt = 0; kt < kt_n; ++kt) {
              mbar_wait(bars + 8 * (STAGES + s), ph ^ 1);
              mbar_expect_tx(bars + 8 * s, STAGE_BYTES);
              bulk_load(ring + s * STAGE_BYTES, w, TILE_BYTES, bars + 8 * s);
              bulk_load(ring + s * STAGE_BYTES + TILE_BYTES, in + static_cast<size_t>(kt) * A_BYTES, A_BYTES,
                        bars + 8 * s);
              w += TILE_BYTES;
              if (++s == STAGES) {
                s = 0;
                ph ^= 1;
              }
            }
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, w = t >> 5, q = t & 3, g = (t & 31) >> 2;
    // this thread's first row of a k-block (the other is 8 further), its
    // 4-byte column pair q of 16-byte chunk 0 before the swizzle
    const size_t row_off = static_cast<size_t>(64 * c + 16 * w + g) * 128 + 4 * q;
    // the bf16 pair (j, h) of k-block kb of an activation buffer: chunk j % 8
    // swizzled by the row's low three bits, which are g for both rows
    auto pair = [&](unsigned char* buf, int kb, int j, int h) {
      return reinterpret_cast<__nv_bfloat162*>(buf + static_cast<size_t>(kb) * A_BYTES + row_off + 8 * h * 128 +
                                               (((j & 7) ^ g) << 4));
    };
    float4* const park =
        LN && p.park != nullptr ? p.park + (static_cast<size_t>(blockIdx.x) * 2 + c) * p.park_nt * 32 * 128 + t
                                : nullptr;
    int s = 0;
    uint32_t ph = 0;

    // acc = one N tile: the input K tiles against the weight tiles, read
    // from the ring in order; each slot is released once its products are
    // done, one stage's products staying in flight (kt_n 0: acc = 0)
    auto mma = [&](float(&acc)[128], int kt_n) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      int prev = 0;
      for (int kt = 0; kt < kt_n; ++kt) {
        mbar_wait(bars + 8 * s, ph);
        wgmma_fence();
        const uint32_t slot = ring + s * STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
          wgmma_m64n256k16(acc, desc_k(slot + TILE_BYTES + c * KB_BYTES + 32 * kk), desc_k(slot + 32 * kk));
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

    // N tile nt of ``layer`` in float32, in place: the products plus the
    // xyz term and c_l
    auto xyz_cl = [&](float(&acc)[128], int layer, int nt, long long row) {
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
          acc[4 * j + 2 * h] = v0 + cc.x;
          acc[4 * j + 2 * h + 1] = v1 + cc.y;
        }
      }
    };

    for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const long long row = tile * BM + 64 * c + 16 * w + g;  // and row + 8
      float dot[2] = {0.0f, 0.0f};
      for (int layer = 0; layer < last; ++layer) {
        const int nt_n = p.out_pad[layer] / TN, kt_n = p.in_pad[layer] / TK;
        const bool to_dot = layer == last - 1;
        unsigned char* const out = to_dot ? nullptr : act + (layer & 1) * p.act_buf;
        // takes N tile nt's bf16 pair (j, h): into the last layer's dot
        // product, or stored as the next layer's input
        auto emit = [&](int nt, int j, int h, __nv_bfloat162 v) {
          if (to_dot) {
            const __nv_bfloat162 wl = *reinterpret_cast<const __nv_bfloat162*>(p.wlast + nt * TN + 8 * j + 2 * q);
            dot[h] += bf(v.x) * bf(wl.x) + bf(v.y) * bf(wl.y);
          } else {
            *pair(out, 4 * nt + (j >> 3), j, h) = v;
          }
        };
        float acc[128];
        bool ln = false;
        if constexpr (LN) ln = p.lns[layer] != nullptr;
        if (!ln) {
          for (int nt = 0; nt < nt_n; ++nt) {
            mma(acc, kt_n);
            xyz_cl(acc, layer, nt, row);
#pragma unroll
            for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
              for (int h = 0; h < 2; ++h)
                emit(nt, j, h, __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * h], 0.0f),
                                                     fmaxf(acc[4 * j + 2 * h + 1], 0.0f)));
            }
          }
        } else {
          // each N tile's row mean and sum of squared deviations over its
          // columns below the true width (two passes, reduced over the quad
          // that holds a row), merged into the row's by Chan's formula; every
          // N tile before the last lies wholly inside the true width
          const int out_true = p.out_true[layer];
          float mean[2] = {0.0f, 0.0f}, m2[2] = {0.0f, 0.0f};
          for (int nt = 0; nt < nt_n; ++nt) {
            mma(acc, kt_n);
            xyz_cl(acc, layer, nt, row);
            const int valid = min(TN, out_true - nt * TN);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float sum = 0.0f;
#pragma unroll
              for (int i = 0; i < 64; ++i)
                if (8 * (i >> 1) + 2 * q + (i & 1) < valid) sum += acc[4 * (i >> 1) + 2 * h + (i & 1)];
              sum += __shfl_xor_sync(0xffffffffu, sum, 1);
              sum += __shfl_xor_sync(0xffffffffu, sum, 2);
              const float mt = sum / static_cast<float>(valid);
              float d2 = 0.0f;
#pragma unroll
              for (int i = 0; i < 64; ++i) {
                if (8 * (i >> 1) + 2 * q + (i & 1) < valid) {
                  const float d = acc[4 * (i >> 1) + 2 * h + (i & 1)] - mt;
                  d2 += d * d;
                }
              }
              d2 += __shfl_xor_sync(0xffffffffu, d2, 1);
              d2 += __shfl_xor_sync(0xffffffffu, d2, 2);
              if (nt == 0) {
                mean[h] = mt;
                m2[h] = d2;
              } else {
                const float na = static_cast<float>(nt * TN), nb = static_cast<float>(valid), nn = na + nb;
                const float delta = mt - mean[h];
                mean[h] += delta * (nb / nn);
                m2[h] += d2 + delta * delta * (na * nb / nn);
              }
            }
            if (kt_n > 0) {
#pragma unroll
              for (int i = 0; i < 32; ++i)
                park[(nt * 32 + i) * 128] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
            }
          }
          float rstd[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(m2[h] / static_cast<float>(out_true) + LN_EPS);
          for (int nt = 0; nt < nt_n; ++nt) {
            if (kt_n > 0) {
#pragma unroll
              for (int i = 0; i < 32; ++i) {
                const float4 v = park[(nt * 32 + i) * 128];
                acc[4 * i] = v.x, acc[4 * i + 1] = v.y, acc[4 * i + 2] = v.z, acc[4 * i + 3] = v.w;
              }
            } else {
#pragma unroll
              for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
              xyz_cl(acc, layer, nt, row);
            }
#pragma unroll
            for (int j = 0; j < TN / 8; ++j) {
              const int col = nt * TN + 8 * j + 2 * q;
              const float2 sc = __ldg(reinterpret_cast<const float2*>(p.lns[layer] + col));
              const float2 sh = __ldg(reinterpret_cast<const float2*>(p.lnb[layer] + col));
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float v0 = (acc[4 * j + 2 * h] - mean[h]) * rstd[h] * sc.x + sh.x;
                const float v1 = (acc[4 * j + 2 * h + 1] - mean[h]) * rstd[h] * sc.y + sh.y;
                emit(nt, j, h, __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f)));
              }
            }
          }
        }
        if (!to_dot) {  // the next layer's input is stored: the producer may copy it
          fence_proxy_async_global();
          mbar_arrive(ready);
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

template <bool LN>
int launch(const Params& p, long long grid, cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(fused_mlp_wgmma_wide_kernel<LN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_mlp_wgmma_wide_kernel<LN><<<static_cast<unsigned>(grid), THREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgw

// ---------------------------------------------------------------------------
// The f32 route past 512: float32 operands, any hidden width (padded to a
// multiple of 64), LayerNorm or not, and decoders with no hidden layer.
//
// Why the 512 design does not stretch: a 512-wide output already takes 128
// float32 registers a thread, and the [64][W] float32 activations outgrow
// shared memory past 512 (256 KB at 1024). So here:
//   * persistent blocks walk 64-point tiles as in the 512 design, but with a
//     producer warpgroup (one thread issues the copies; setmaxnreg gives its
//     registers away) and eight consumer warps: warp w owns rows 8w..8w+7,
//     lane l the columns 4l + 128i (i < 4) of a pass of at most 512 outputs,
//     so a layer W wide runs ceil(W / 512) passes, each a [64 x W_in] x
//     [W_in x 512] product with 128 accumulators a thread;
//   * the tile's activations live in the block's share of a device scratch,
//     two ping-pong buffers of [W / 16 K tiles][64 rows][16] float32, so the
//     K tile of the input that a weight tile multiplies is one contiguous
//     4 KB; the weights are laid out once per spec pass-major
//     (ops/fused_mlp.py, f32_pass_weights: per pass [in_pad][pass width]),
//     so a 16-deep weight K tile is one contiguous copy of at most 32 KB;
//   * a ring stage holds a weight K tile and the input K tile beside it,
//     both copied by cp.async.bulk onto one mbarrier; the consumers' inner
//     loop is the 512 design's (8 float4 activation broadcasts and 16 float4
//     weights per 512 FMAs, the float4 column count a compile-time constant);
//   * each pass's epilogue (the xyz term, c_l, ReLU) stores float4 straight
//     into the other buffer; once a layer is stored, every consumer thread
//     fences it for the async proxy and arrives on the ``ready`` mbarrier
//     before the producer copies it back as the next layer's input;
//   * LayerNorm over any number of passes: each pass's float32 pre-LayerNorm
//     values wait in the output buffer itself, at their final place (each
//     lane reads back only what it wrote), while each row's mean and sum of
//     squared deviations merge pass by pass by Chan's formula (warp
//     shuffles); a second pass normalises, applies ReLU and stores in place
//     or feeds the last layer's dot product. A layer without products
//     (layer 0) is recomputed in the second pass instead of parked.
// What bounds it: the FP32 FMA pipe, as in the 512 design; beside it each
// input K tile is read once per pass from L2 and the layer boundary waits
// for the copies of the next input. The scratch (2 x 64 x W float32) is per
// block, so a launch whose scratch would pass the wrapper's cap runs fewer
// persistent blocks.
// Shared memory: 4 x 36 KB ring + xyz + the barriers.
// ---------------------------------------------------------------------------

namespace f32w {

using f32::comp;
using f32::warp_sum;
using wg::bulk_load;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::setmaxnreg_dec;
using wg::setmaxnreg_inc;
using wg::smem_u32;
using wgw::fence_proxy_async_global;
constexpr int BM = 64;                              // points per tile
constexpr int PASS = 512;                           // outputs per pass
constexpr int TK = 16;                              // K rows per weight tile
constexpr int STAGES = 4;                           // stages in the ring
constexpr int WARPS = 8;                            // consumer warps, 8 rows each
constexpr int THREADS = 128 + 32 * WARPS;           // producer warpgroup + consumers
constexpr int W_FLOATS = TK * PASS;                 // a weight K tile of a pass (at most 32 KB)
constexpr int A_FLOATS = BM * TK;                   // an input K tile [64 rows][16] (4 KB)
constexpr int STAGE_FLOATS = W_FLOATS + A_FLOATS;
constexpr int SMEM = (STAGES * STAGE_FLOATS + BM * 4) * 4 + (2 * STAGES + 1) * 8;

struct Params {
  const float* xyz;  // [n, 3]
  float* out;        // [n]
  long long n;
  long long tiles;   // point tiles of BM
  int n_layers, use_tanh;
  const float* wk[MAX_LAYERS];   // pass-major: per pass [in_pad][pass width]; null for layer 0 and the last
  const float* wx[MAX_LAYERS];   // [out_pad][4] xyz weights, or null
  const float* cl[MAX_LAYERS];   // [out_pad] latent consts + bias
  const float* lns[MAX_LAYERS];  // [out_pad] LayerNorm scale (zero-padded), or null
  const float* lnb[MAX_LAYERS];  // [out_pad] LayerNorm bias (zero-padded), or null
  const float* wlast;            // [in_pad of the last layer]; null without a hidden layer
  float* act;                    // [grid][2][act_kt][BM][TK], or null
  long long act_buf;             // floats of one activation buffer (act_kt * A_FLOATS)
  int in_pad[MAX_LAYERS];        // 0 for layer 0
  int out_pad[MAX_LAYERS];       // multiples of 64; 1 for the last layer
  int out_true[MAX_LAYERS];      // true widths (LayerNorm statistics)
};

__global__ void __launch_bounds__(THREADS, 1) fused_mlp_f32_wide_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char f32w_smem[];
  float* const ring = reinterpret_cast<float*>(f32w_smem);
  float* const xs = ring + STAGES * STAGE_FLOATS;     // [BM][4]
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t bars = smem_u32(xs + BM * 4);        // full[s], empty[s], then ready
  const uint32_t ready = bars + 16 * STAGES;          // a layer's outputs are stored
  float* const act = p.act == nullptr ? nullptr : p.act + 2 * p.act_buf * blockIdx.x;
  const int last = p.n_layers - 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), WARPS);
    }
    mbar_init(ready, 32 * WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0, rph = 0;
      for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int layer = 1; layer < last; ++layer) {
          mbar_wait(ready, rph);  // the layer's input is stored
          rph ^= 1;
          const float* in = act + ((layer - 1) & 1) * p.act_buf;
          const float* w = p.wk[layer];
          const int out_pad = p.out_pad[layer], kt_n = p.in_pad[layer] / TK;
          for (int col0 = 0; col0 < out_pad; col0 += PASS) {
            const int pw = min(PASS, out_pad - col0);
            for (int kt = 0; kt < kt_n; ++kt) {
              mbar_wait(bars + 8 * (STAGES + s), ph ^ 1);
              mbar_expect_tx(bars + 8 * s, (TK * pw + A_FLOATS) * 4);
              bulk_load(ring_s + s * STAGE_FLOATS * 4, w, TK * pw * 4, bars + 8 * s);
              bulk_load(ring_s + (s * STAGE_FLOATS + W_FLOATS) * 4, in + static_cast<size_t>(kt) * A_FLOATS,
                        A_FLOATS * 4, bars + 8 * s);
              w += TK * pw;
              if (++s == STAGES) {
                s = 0;
                ph ^= 1;
              }
            }
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x >> 5) - 4, lane = threadIdx.x & 31;
    float* const xw = xs + 32 * warp;  // this warp's rows' xyz, [8][4]
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
      float dot[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) dot[r] = 0.0f;
      for (int layer = 0; layer < last; ++layer) {
        const int out_pad = p.out_pad[layer], kt_n = p.in_pad[layer] / TK;
        const bool to_dot = layer == last - 1, ln = p.lns[layer] != nullptr;
        // the output buffer: the next layer's input, or (the layer before
        // the last, with LayerNorm and products) where its values wait
        float* const out = act == nullptr ? nullptr : act + (layer & 1) * p.act_buf + 8 * warp * TK;
        float acc[8][16];
        bool on[4];

        // the products of the pass at col0, pw wide, at a compile-time count
        // of float4 columns per lane (ceil(pw / 128)) with no branch inside.
        // A lane past pw in the last float4 column multiplies neighbouring
        // ring floats into accumulators that nothing reads.
        auto products = [&](auto nch_c, int pw) {
          constexpr int NCH = decltype(nch_c)::value;
          for (int kt = 0; kt < kt_n; ++kt) {
            mbar_wait(bars + 8 * s, ph);
            const float* wt = ring + s * STAGE_FLOATS + 4 * lane;
            const float* a = ring + s * STAGE_FLOATS + W_FLOATS + 8 * warp * TK;
#pragma unroll
            for (int k4 = 0; k4 < TK; k4 += 4) {
              float4 av[8];
#pragma unroll
              for (int r = 0; r < 8; ++r) av[r] = *reinterpret_cast<const float4*>(a + r * TK + k4);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float* wrow = wt + (k4 + kk) * pw;
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
            if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));
            if (++s == STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
        };
        // acc = the pass at col0, pw wide, in float32: the products plus the
        // xyz term and c_l
        auto pre = [&](int col0, int pw) {
#pragma unroll
          for (int i = 0; i < 4; ++i) on[i] = 128 * i + 4 * lane < pw;
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[r][e] = 0.0f;
          if (kt_n > 0) {
            switch ((pw + 127) / 128) {
              case 1: products(std::integral_constant<int, 1>(), pw); break;
              case 2: products(std::integral_constant<int, 2>(), pw); break;
              case 3: products(std::integral_constant<int, 3>(), pw); break;
              default: products(std::integral_constant<int, 4>(), pw); break;
            }
          }
          const float* wx = p.wx[layer];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (!on[i]) continue;
            const int col = col0 + 128 * i + 4 * lane;
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
        };
        // float4 (r, i) of the pass at col0 in the output buffer
        auto slot = [&](int col0, int r, int i) {
          const int col = col0 + 128 * i + 4 * lane;
          return reinterpret_cast<float4*>(out + static_cast<size_t>(col >> 4) * A_FLOATS + r * TK + (col & 15));
        };
        // ReLU, then the last layer's dot product or the store
        auto emit = [&](int col0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (!on[i]) continue;
            float4 wl = make_float4(0.f, 0.f, 0.f, 0.f);
            if (to_dot) wl = __ldg(reinterpret_cast<const float4*>(p.wlast + col0 + 128 * i + 4 * lane));
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float4 v = make_float4(fmaxf(acc[r][4 * i], 0.0f), fmaxf(acc[r][4 * i + 1], 0.0f),
                                           fmaxf(acc[r][4 * i + 2], 0.0f), fmaxf(acc[r][4 * i + 3], 0.0f));
              if (to_dot)
                dot[r] += v.x * wl.x + v.y * wl.y + v.z * wl.z + v.w * wl.w;
              else
                *slot(col0, r, i) = v;
            }
          }
        };

        if (!ln) {
          for (int col0 = 0; col0 < out_pad; col0 += PASS) {
            pre(col0, min(PASS, out_pad - col0));
            emit(col0);
          }
        } else {
          // each pass's row mean and sum of squared deviations over its
          // columns below the true width (two passes over the registers,
          // warp shuffles), merged into the row's by Chan's formula; every
          // pass before the last lies wholly inside the true width
          const int out_true = p.out_true[layer];
          float mean[8], m2[8];
          for (int col0 = 0; col0 < out_pad; col0 += PASS) {
            pre(col0, min(PASS, out_pad - col0));
            const int valid = min(PASS, out_true - col0);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              float sum = 0.0f;
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (on[i] && 128 * i + 4 * lane + e < valid) sum += acc[r][4 * i + e];
              const float mt = warp_sum(sum) / static_cast<float>(valid);
              float d2 = 0.0f;
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (on[i] && 128 * i + 4 * lane + e < valid) {
                    const float d = acc[r][4 * i + e] - mt;
                    d2 += d * d;
                  }
              d2 = warp_sum(d2);
              if (col0 == 0) {
                mean[r] = mt;
                m2[r] = d2;
              } else {
                const float na = static_cast<float>(col0), nb = static_cast<float>(valid), nn = na + nb;
                const float delta = mt - mean[r];
                mean[r] += delta * (nb / nn);
                m2[r] += d2 + delta * delta * (na * nb / nn);
              }
            }
            if (kt_n > 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (!on[i]) continue;
#pragma unroll
                for (int r = 0; r < 8; ++r)
                  *slot(col0, r, i) = make_float4(acc[r][4 * i], acc[r][4 * i + 1], acc[r][4 * i + 2], acc[r][4 * i + 3]);
              }
            }
          }
          float rstd[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) rstd[r] = rsqrtf(m2[r] / static_cast<float>(out_true) + LN_EPS);
          for (int col0 = 0; col0 < out_pad; col0 += PASS) {
            const int pw = min(PASS, out_pad - col0);
            if (kt_n > 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                on[i] = 128 * i + 4 * lane < pw;
                if (!on[i]) continue;
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                  const float4 v = *slot(col0, r, i);
                  acc[r][4 * i] = v.x, acc[r][4 * i + 1] = v.y, acc[r][4 * i + 2] = v.z, acc[r][4 * i + 3] = v.w;
                }
              }
            } else {
              pre(col0, pw);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (!on[i]) continue;
              const int col = col0 + 128 * i + 4 * lane;
              const float4 sc = __ldg(reinterpret_cast<const float4*>(p.lns[layer] + col));
              const float4 sh = __ldg(reinterpret_cast<const float4*>(p.lnb[layer] + col));
#pragma unroll
              for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[r][4 * i + e] = (acc[r][4 * i + e] - mean[r]) * rstd[r] * comp(sc, e) + comp(sh, e);
            }
            emit(col0);
          }
        }
        if (!to_dot) {  // the next layer's input is stored: the producer may copy it
          fence_proxy_async_global();
          mbar_arrive(ready);
        }
      }
      // the last layer: one output per row, a dot product over the layer before
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

int launch(const Params& p, long long grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_f32_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_mlp_f32_wide_kernel<<<static_cast<unsigned>(grid), THREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32w

}  // namespace

extern "C" {

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

// Device scratch one block of a wide kernel needs (msd_fused_mlp_wgmma_wide
// with dtype 0, msd_fused_mlp_f32_wide with dtype 1): the two activation
// buffers of its point tile, as wide as the widest layer whose output a
// later layer's products read (and, in float32, the layer before the last
// when it has LayerNorm and products: its values wait there), and in bf16
// the float32 values of the widest LayerNorm layer with products. -1 for a
// bad dtype. The per-layer arrays are those of the launch.
long long msd_fused_mlp_wide_scratch_per_block(int dtype, int n_layers, const int* in_pad, const int* out_pad,
                                               const void* const* lns) {
  if (dtype != 0 && dtype != 1) return -1;
  const int last = n_layers - 1;
  long long act = 0, park = 0;
  for (int l = 0; l < last; ++l) {
    const bool parked = lns[l] != nullptr && in_pad[l] > 0;
    if (l < last - 1 || (dtype == 1 && parked)) act = out_pad[l] > act ? out_pad[l] : act;
    if (dtype == 0 && parked) park = out_pad[l] > park ? out_pad[l] : park;
  }
  if (dtype == 1) return 2 * act * f32w::BM * 4;
  return 2 * (act / wg::TK) * wgw::A_BYTES + park / wg::TN * wgw::PARK_TILE_BYTES;
}

// The wgmma route past 512 (and with no hidden layer). Arguments as
// msd_fused_mlp_wgmma, but hidden out_pad is any multiple of 256 (1 for the
// last layer), wlast is null exactly when n_layers is 1, and the launch runs
// ``grid`` persistent blocks (at most one per point tile of 128) with
// scratch_bytes of device scratch, at least grid times
// msd_fused_mlp_wide_scratch_per_block(0, ...) (null when that is 0).
int msd_fused_mlp_wgmma_wide(int n_layers, const void* xyz, void* out, long long n, const void* wt, int wtiles,
                             const void* wlast, const void* const* wx, const void* const* cl,
                             const void* const* lns, const void* const* lnb, const int* in_pad,
                             const int* out_pad, const int* out_true, int use_tanh, long long grid, void* scratch,
                             long long scratch_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_layers < 1 || n_layers > MAX_LAYERS || n < 0 || (wlast == nullptr) != (n_layers == 1) || in_pad[0] != 0 ||
      out_pad[n_layers - 1] != 1 || wtiles < 0 || (wtiles > 0) != (wt != nullptr) || grid < 1)
    return bad;
  wgw::Params p;
  p.xyz = static_cast<const float*>(xyz);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.n_layers = n_layers;
  p.use_tanh = use_tanh;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.wlast = static_cast<const __nv_bfloat16*>(wlast);
  long long tiles = 0;
  bool ln = false;
  int act_kb = 0, park_nt = 0;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    if (cl[l] == nullptr || (l > 0 && in_pad[l] != out_pad[l - 1])) return bad;
    if ((lns[l] == nullptr) != (lnb[l] == nullptr) || (last && lns[l] != nullptr)) return bad;
    if (!last && (out_pad[l] < wg::TN || out_pad[l] % wg::TN != 0)) return bad;
    if (!last && (out_true[l] < 1 || out_true[l] > out_pad[l] || out_true[l] <= out_pad[l] - wg::TN)) return bad;
    if (!last) tiles += static_cast<long long>(out_pad[l] / wg::TN) * (in_pad[l] / wg::TK);
    if (l < n_layers - 2) act_kb = out_pad[l] / wg::TK > act_kb ? out_pad[l] / wg::TK : act_kb;
    if (lns[l] != nullptr && in_pad[l] > 0) park_nt = out_pad[l] / wg::TN > park_nt ? out_pad[l] / wg::TN : park_nt;
    ln = ln || lns[l] != nullptr;
    p.wx[l] = static_cast<const float*>(wx[l]);
    p.cl[l] = static_cast<const float*>(cl[l]);
    p.lns[l] = static_cast<const float*>(lns[l]);
    p.lnb[l] = static_cast<const float*>(lnb[l]);
    p.in_pad[l] = in_pad[l];
    p.out_pad[l] = out_pad[l];
    p.out_true[l] = out_true[l];
  }
  if (tiles != wtiles) return bad;
  const long long per_block = msd_fused_mlp_wide_scratch_per_block(0, n_layers, in_pad, out_pad, lns);
  if ((per_block > 0 && scratch == nullptr) || scratch_bytes < grid * per_block) return bad;
  unsigned char* const s = static_cast<unsigned char*>(scratch);
  p.act_buf = static_cast<long long>(act_kb) * wgw::A_BYTES;
  p.act = act_kb > 0 ? s : nullptr;
  p.park_nt = park_nt;
  p.park = park_nt > 0 ? reinterpret_cast<float4*>(s + grid * 2 * p.act_buf) : nullptr;
  if (n == 0) return 0;
  p.tiles = (n + wgw::BM - 1) / wgw::BM;
  if (grid > p.tiles) grid = p.tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ln ? wgw::launch<true>(p, grid, st) : wgw::launch<false>(p, grid, st);
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

// The f32 route past 512 (and with no hidden layer). Arguments as
// msd_fused_mlp_f32, but wk holds each hidden layer's weights pass-major
// (per 512-wide pass [in_pad][pass width]), hidden out_pad is any multiple
// of 64 (1 for the last layer), wlast is null exactly when n_layers is 1,
// and the launch runs ``grid`` persistent blocks (at most one per point
// tile of 64) with scratch_bytes of device scratch, at least grid times
// msd_fused_mlp_wide_scratch_per_block(1, ...) (null when that is 0).
int msd_fused_mlp_f32_wide(int n_layers, const void* xyz, void* out, long long n, const void* const* wk,
                           const void* wlast, const void* const* wx, const void* const* cl, const void* const* lns,
                           const void* const* lnb, const int* in_pad, const int* out_pad, const int* out_true,
                           int use_tanh, long long grid, void* scratch, long long scratch_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_layers < 1 || n_layers > MAX_LAYERS || n < 0 || (wlast == nullptr) != (n_layers == 1) || in_pad[0] != 0 ||
      wk[0] != nullptr || out_pad[n_layers - 1] != 1 || grid < 1)
    return bad;
  f32w::Params p;
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
    if (!last && (out_pad[l] < 64 || out_pad[l] % 64 != 0)) return bad;
    if (!last && (out_true[l] < 1 || out_true[l] > out_pad[l] || out_true[l] <= out_pad[l] - 64)) return bad;
    if (!last && l > 0 && wk[l] == nullptr) return bad;
    p.wk[l] = last ? nullptr : static_cast<const float*>(wk[l]);
    p.wx[l] = static_cast<const float*>(wx[l]);
    p.cl[l] = static_cast<const float*>(cl[l]);
    p.lns[l] = static_cast<const float*>(lns[l]);
    p.lnb[l] = static_cast<const float*>(lnb[l]);
    p.in_pad[l] = in_pad[l];
    p.out_pad[l] = out_pad[l];
    p.out_true[l] = out_true[l];
  }
  const long long per_block = msd_fused_mlp_wide_scratch_per_block(1, n_layers, in_pad, out_pad, lns);
  if ((per_block > 0 && scratch == nullptr) || scratch_bytes < grid * per_block) return bad;
  p.act = per_block > 0 ? static_cast<float*>(scratch) : nullptr;
  p.act_buf = per_block / 8;  // floats of one buffer: per_block is two of them in bytes
  if (n == 0) return 0;
  p.tiles = (n + f32w::BM - 1) / f32w::BM;
  if (grid > p.tiles) grid = p.tiles;
  return f32w::launch(p, grid, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block: route 1 the wgmma kernel, 2 the f32
// kernel, 3 the wide wgmma kernel, 4 the wide f32 kernel; -1 otherwise.
long long msd_fused_mlp_smem_bytes(int route) {
  switch (route) {
    case 1: return wg::SMEM;
    case 2: return f32::SMEM;
    case 3: return wgw::SMEM;
    case 4: return f32w::SMEM;
    default: return -1;
  }
}

const char* msd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
