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
// Bound on an H100: operations for the whole step. Variant b costs 18.9
// MFLOP per point at the flagship width (9.44 for a, 6.29 for d), so the
// flagship step (32 x 16384 points) needs at least 10.0 ms (5.0 ms, 3.3 ms)
// at the 989 TFLOP/s dense bf16 peak.
//
// Design. The TPU kernel held a 1024-point tile's h and u and f32
// accumulators for every weight gradient in 100 MB of VMEM and carried them
// from grid step to grid step. Neither holds on Hopper: one point's h and u
// at width 512 are 16 KB, and blocks run in parallel in no order. So the
// chains run layer by layer over a chunk of whole scenes, each product one
// launch of a GEMM whose operands are the chunk's bf16 activations in
// device memory (point-major [n][width]) and the layer's bf16 weights.
// One such product is bound by bytes, not operations: a 512 x 512 chain
// product over 65536 points reads A (67 MB) and its bf16 D mask (67 MB) and
// writes 67 MB, 60 us at 3.35 TB/s, against 35 us of bf16 operations (the
// primal reads no mask: 40 us). A weight-gradient launch of variant b reads
// 268 MB (80 us) for 69 us of operations. So both GEMM kernels keep the
// tensor cores fed from a deep asynchronous ring and move every tile as
// whole 128-byte rows:
//   chain_kernel  persistent, one block per SM walking 128 x 128 output
//                 tiles. One producer thread issues TMA loads
//                 (cp.async.bulk.tensor, 128-byte swizzle) of the A and B
//                 K tiles (depth 64) into a 4-stage ring guarded by
//                 mbarriers; two consumer warpgroups take the tiles in turn
//                 ("ping-pong"), each running wgmma.mma_async m64n128k16
//                 from shared memory into float32 registers for all 128 rows
//                 of its tile, so one warpgroup's epilogue runs while the
//                 other's products run; setmaxnreg moves registers from the
//                 producer to them. B is [N][K], K-major: the u and delta
//                 chains read Mp_l^T, transposed once per call by the
//                 wrapper, so every chain product is "NT". The epilogue adds
//                 the xyz (or gbar) term and c_l, applies ReLU or the D mask,
//                 which a second producer thread has loaded by TMA into the
//                 warpgroup's swizzled tile in shared memory (a 128-row tile
//                 of gated rows is 128 contiguous points, since E and P are
//                 multiples of 128), writes bf16 into that tile in place,
//                 which that thread stores by TMA, and on the delta chain
//                 writes float32 column sums over each 64 rows (the dc
//                 partials) in a fixed order.
//   wgrad_kernel  dMp_l partials over splits of the chunk's points: the same
//                 producer/consumer ring (4 stages, 256-column tiles, both
//                 warpgroups on each tile), both operands
//                 point-major, so both are MN-major in shared memory (two
//                 64-wide TMA boxes per 128-wide tile) and wgmma reads them
//                 through the transpose bits of its descriptors; persistent
//                 blocks walk (split, tile) units; plain float32 stores of
//                 the partials, no atomics, so the sums are deterministic.
//   last_kernel, eik_kernel, skinny_kernel   row streamers: the
//                 one-output last layer (y, the seeds, the loss tile sums)
//                 with the rank-one last hidden layer D_{H-1} xv w_last
//                 (the u-chain's seed rows, or the delta chain's when there
//                 is no eikonal), the eikonal lane, and the three-column
//                 (dMx) and one-row (last layer) weight gradients. Each
//                 reads bf16 rows of W contiguous values once and does a
//                 few FMAs per value, so it is bound by bytes: at 3.35 TB/s
//                 and about 1 us of latency the card needs some 25 KB of
//                 loads in flight per SM. Every thread issues 16-byte loads
//                 of several rows before its first FMA, and the grid is
//                 sized to the SMs, so a 16384-row launch (variant c) fills
//                 the card too.
// Hidden widths arrive zero-padded to multiples of 128; padded rows and
// columns stay zero and the wrapper cuts them off.
//
// Plain C interface, loaded with ctypes (msd_tpu_torch/ops/_build.py). The
// TMA descriptors are encoded here by cuTensorMapEncodeTiled, fetched from
// the driver through the runtime (no link against libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;  // per-point kernels
constexpr int PT_TILE = 128;   // points per loss tile of the per-point kernels
// skinny_kernel: a block takes 128 columns (16 threads of 8 columns each,
// one 16-byte vector) of 16 rows side by side, and each thread loads
// SK_DEPTH rows before its first FMA (32 KB in flight per block)
constexpr int SK_COLS = 128, SK_LANES = NTHREADS / 16, SK_DEPTH = 8;
// eik_kernel: a warp takes EIK_ROWS rows side by side, each lane
// EIK_VECS 16-byte vectors of each (1024 columns per pass; 8 KB in flight
// per warp)
constexpr int EIK_ROWS = 4, EIK_VECS = 4;
// last_kernel: a warp takes LAST_ROWS rows side by side, each lane
// LAST_VECS 16-byte vectors of each per pass (512 columns; 4 KB in flight
// per warp)
constexpr int LAST_ROWS = 4, LAST_VECS = 2;

// GEMM kernels: tiles of 128 rows, depth TK per ring stage (one 128-byte
// swizzle row of bf16); a producer warpgroup and two consumer warpgroups of
// 64 rows each. chain_kernel's tiles are 128 columns wide, wgrad_kernel's
// 256.
constexpr int TM = 128, TK = 64;
constexpr int CHAIN_TN = 128, WGRAD_TN = 256;
constexpr int GEMM_THREADS = 384;
constexpr int CHAIN_STAGES = 4, WGRAD_STAGES = 4;
constexpr int A_BYTES = TM * TK * 2;              // a stage of the 128-row operand (16 KB)
constexpr int CHAIN_B_BYTES = CHAIN_TN * TK * 2;  // a stage of the weights (16 KB)
constexpr int WGRAD_B_BYTES = WGRAD_TN * TK * 2;  // a stage of the 256-column operand (32 KB)
constexpr int BOX_BYTES = TM * 128;               // one [128 rows][64 bf16] box (16 KB)
constexpr int EPI_BYTES = TM * CHAIN_TN * 2;      // a chain tile's mask/out: two such boxes (32 KB)
constexpr int RED_FLOATS = 2 * 2 * 4 * CHAIN_TN;  // a warpgroup's column-sum partials: 2 buffers x 2 halves x 4 warps
constexpr int CHAIN_SMEM =
    1024 + CHAIN_STAGES * (A_BYTES + CHAIN_B_BYTES) + 2 * EPI_BYTES + 2 * RED_FLOATS * 4 + 128;
constexpr int WGRAD_SMEM = 1024 + WGRAD_STAGES * (A_BYTES + WGRAD_B_BYTES) + 128;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// wait for the completion of the barrier's phase of parity ``parity``. Every
// wait is on work of the same block and lasts microseconds; one that does
// not end (a fault in the barrier protocol) traps, so the launch fails
// instead of hanging the card.
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

// TMA: a 2-D box at (c0 inner, c1 outer) into shared memory, completing
// on ``bar``; a box out of shared memory, in a bulk group
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory, made visible to the TMA unit
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

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1 at bit
// 62); fields in 16-byte units. K-major ([rows][64] tiles of 128-byte
// rows): 8-row groups 1024 B apart (SBO), LBO unused (1). MN-major ([k][64]
// boxes, the MN index contiguous): 64-wide MN atoms one box (8 KB) apart
// (LBO), 8-k-row groups 1024 B apart (SBO).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(TK * 128 / 16) << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128], bf16 from shared memory, float32
// accumulators; TA, TB: the operand is MN-major (transposed). Accumulator
// 4 j + 2 h + e of thread t of the warpgroup sits at row 16 (t / 32) +
// (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + e.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64 x 256] += A[64 x 16] B[16 x 256], bf16 from shared memory, float32
// accumulators; TA, TB: the operand is MN-major (transposed). Accumulator
// 4 j + 2 h + e of thread t of the warpgroup sits at row 16 (t / 32) +
// (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + e.
template <int TA, int TB>
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
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The shared memory of a GEMM block, from a 1024-aligned base: the ring's
// A stages, its B stages, then (chain) the two mask/out tiles and the
// column-sum partials, then the mbarriers: full[s] and empty[s] per stage,
// then (chain) efull[c], edone[c] and turn[c] per consumer warpgroup.
struct Ring {
  uint32_t base, bars;
  int stages, b_bytes;
  __device__ uint32_t a(int s) const { return base + s * A_BYTES; }
  __device__ uint32_t b(int s) const { return base + stages * A_BYTES + s * b_bytes; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
};

__device__ __forceinline__ uint32_t align1024(uint32_t a) { return (a + 1023u) & ~1023u; }

// A consumer warpgroup's K loop over one tile: wait for each stage, issue its
// k16 products (issue(stage, kk)), and release the stage once they are done
// (one stage's products stay in flight while the next stage's are issued).
// ``lead`` is one thread of the warpgroup; the stage's empty barrier counts
// one arrival per warpgroup that reads it.
template <typename Issue>
__device__ __forceinline__ void consume(const Ring& ring, int& s, uint32_t& ph, int kt_n, bool lead, Issue issue) {
  int prev = 0;
  for (int kt = 0; kt < kt_n; ++kt) {
    mbar_wait(ring.full(s), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) issue(s, kk);
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && lead) mbar_arrive(ring.empty(prev));
    prev = s;
    if (++s == ring.stages) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  if (kt_n > 0 && lead) mbar_arrive(ring.empty(prev));
}

// After wgmma_wait: no read of the accumulators moves above it
template <int NACC> __device__ __forceinline__ void acc_fence(float (&acc)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

struct ChainParams {
  long long n;        // output rows (a multiple of 128)
  int N, K;           // output width (a multiple of 128), depth (a multiple of 64, or 0)
  const float* xv;    // [n][4] per-point 3-vector (x or gbar, bf16-rounded), or null
  const float* wx;    // [N][4] its weights (bf16-rounded), or null
  const float* cvec;  // [n / P][N] per-scene constants, or null
  int P;              // points per scene
  int R;              // gated rows per scene (variant c): output row i reads mask
                      // row (i / R) P + i % R; 0: mask rows are the output rows
  int relu;           // 1: ReLU; 0: multiply by D = 1[mask > 0]
  int store;          // 1: store the bf16 output; 0: column sums only
  float* colsum;      // [n / 64][N] column sums of the float32 output, or null
};

// tm_a, tm_b: TMA maps of the [n][K] activations and the [N][K] weights;
// tm_mask: the [rows][N] bf16 h; tm_out: the [n][N] output; boxes
// [128][64]. The block walks tiles it = 0, 1, 2, ... (tile blockIdx.x +
// it gridDim.x); consumer warpgroup c takes the tiles it = c, c + 2, ...,
// all 128 rows of each, so while one warpgroup runs a tile's products the
// other runs the previous tile's epilogue. Their main loops take turns
// (turn[c]), which also keeps every ring barrier at most one phase ahead of
// a warpgroup that waits on it. Thread 0 loads the K stages of every tile
// into the ring in tile order. Thread 32 owns the two mask/out tiles, one
// per warpgroup: it loads a tile's mask into its warpgroup's tile, stores
// the finished output from there by TMA, and once the store has read it,
// loads the mask of that warpgroup's next tile.
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    chain_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_mask, const __grid_constant__ CUtensorMap tm_out,
                 const ChainParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = align1024(raw);
  const uint32_t epi = base + CHAIN_STAGES * (A_BYTES + CHAIN_B_BYTES);  // two mask/out tiles
  float* red = reinterpret_cast<float*>(smem_raw + (epi - raw) + 2 * EPI_BYTES);
  const Ring ring{base, epi + 2 * EPI_BYTES + 2 * RED_FLOATS * 4, CHAIN_STAGES, CHAIN_B_BYTES};
  const uint32_t efull = ring.bars + 16 * CHAIN_STAGES, edone = efull + 16, turn = edone + 16;

  const int tiles_n = p.N / CHAIN_TN;
  const long long tiles = p.n / TM * tiles_n;
  const int kt_n = p.K / TK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < CHAIN_STAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), 1);
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(efull + 8 * c, 1);
      mbar_init(edone + 8 * c, 1);
      mbar_init(turn + 8 * c, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: thread 0 loads the ring, thread 32 the masks and stores
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = static_cast<int>(tile / tiles_n * TM);
        const int col0 = static_cast<int>(tile % tiles_n) * CHAIN_TN;
        for (int kt = 0; kt < kt_n; ++kt) {
          mbar_wait(ring.empty(s), ph ^ 1);
          mbar_expect_tx(ring.full(s), A_BYTES + CHAIN_B_BYTES);
          tma_load(ring.a(s), &tm_a, kt * TK, row0, ring.full(s));
          tma_load(ring.b(s), &tm_b, kt * TK, col0, ring.full(s));
          if (++s == CHAIN_STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else if (threadIdx.x == 32) {
      // mask/out tile c is ready for the warpgroup's next tile: its D (or,
      // under ReLU, just the free tile)
      auto ready = [&](long long tile, int c) {
        if (tile >= tiles) return;
        if (p.relu) {
          mbar_arrive(efull + 8 * c);
          return;
        }
        // the tile's 128 rows of D: contiguous points, also when gated
        const int row0 = static_cast<int>(tile / tiles_n * TM);
        const int col0 = static_cast<int>(tile % tiles_n) * CHAIN_TN;
        const int mrow = p.R ? row0 / p.R * p.P + row0 % p.R : row0;
        mbar_expect_tx(efull + 8 * c, EPI_BYTES);
        tma_load(epi + c * EPI_BYTES, &tm_mask, col0, mrow, efull + 8 * c);
        tma_load(epi + c * EPI_BYTES + BOX_BYTES, &tm_mask, col0 + 64, mrow, efull + 8 * c);
      };
      ready(blockIdx.x, 0);
      ready(blockIdx.x + gridDim.x, 1);
      long long it = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        const int c = static_cast<int>(it & 1);
        mbar_wait(edone + 8 * c, static_cast<uint32_t>((it >> 1) & 1));
        if (p.store) {
          const int row0 = static_cast<int>(tile / tiles_n * TM);
          const int col0 = static_cast<int>(tile % tiles_n) * CHAIN_TN;
          tma_store(&tm_out, epi + c * EPI_BYTES, col0, row0);
          tma_store(&tm_out, epi + c * EPI_BYTES + BOX_BYTES, col0 + 64, row0);
          bulk_commit();
          bulk_wait_read<0>();
        }
        ready(tile + 2 * static_cast<long long>(gridDim.x), c);
      }
    }
  } else {
    // consumer warpgroup c: tiles it = c, c + 2, ...; rows 64 hf + 16 w + g
    // (+ 8) of each for half hf
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, w = t >> 5, l = t & 31, q = l & 3, g = l >> 2;
    unsigned char* const E = smem_raw + (epi - raw) + c * EPI_BYTES + (16 * w + g) * 128 + 4 * q;
    long long it = c;
    for (long long tile = blockIdx.x + c * static_cast<long long>(gridDim.x); tile < tiles;
         tile += 2 * static_cast<long long>(gridDim.x), it += 2) {
      const long long row0 = tile / tiles_n * TM;
      const int col0 = static_cast<int>(tile % tiles_n) * CHAIN_TN;
      float acc0[64], acc1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.0f;
      // the ring position of the tile's first K stage
      int s = static_cast<int>(it * kt_n % CHAIN_STAGES);
      uint32_t ph = static_cast<uint32_t>(it * kt_n / CHAIN_STAGES & 1);
      if (it > 0) mbar_wait(turn + 8 * c, static_cast<uint32_t>((it - 1) >> 1 & 1));
      consume(ring, s, ph, kt_n, t == 0, [&](int st, int kk) {
        const uint64_t db = desc_k(ring.b(st) + 32 * kk);
        wgmma_m64n128k16<0, 0>(acc0, desc_k(ring.a(st) + 32 * kk), db);
        wgmma_m64n128k16<0, 0>(acc1, desc_k(ring.a(st) + A_BYTES / 2 + 32 * kk), db);
      });
      acc_fence(acc0);
      acc_fence(acc1);
      if (t == 0) mbar_arrive(turn + 8 * (1 - c));

      // epilogue, float32: xyz term, c_l, ReLU or D, bf16 in place of D
      // P is a multiple of the tile: one scene per tile
      const float* cv = p.cvec != nullptr ? p.cvec + row0 / p.P * p.N + col0 : nullptr;
      float* rb = red + c * RED_FLOATS + (it >> 1 & 1) * (RED_FLOATS / 2);  // [half][warp][column]
      mbar_wait(efull + 8 * c, static_cast<uint32_t>(it >> 1 & 1));
      auto half = [&](float(&acc)[64], const int hf) {
        const long long r0 = row0 + 64 * hf + 16 * w + g;  // this thread's rows: r0 and r0 + 8
        float4 x[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
        if (p.xv != nullptr) {
          x[0] = __ldg(reinterpret_cast<const float4*>(p.xv) + r0);
          x[1] = __ldg(reinterpret_cast<const float4*>(p.xv) + r0 + 8);
        }
        // pair (j, h): row r0 + 8 h of box j / 8; its 16-byte chunk j % 8
        // swizzled by row % 8 == g
        auto pair = [&](int j, int h) {
          return reinterpret_cast<__nv_bfloat162*>(E + (j >> 3) * BOX_BYTES + (64 * hf + 8 * h) * 128 +
                                                   (((j & 7) ^ g) << 4));
        };
        float cs[32];
#pragma unroll
        for (int j = 0; j < CHAIN_TN / 8; ++j) {
          const int col = 8 * j + 2 * q;
          float2 cvv = make_float2(0.f, 0.f);
          if (cv != nullptr) cvv = __ldg(reinterpret_cast<const float2*>(cv + col));
          float4 w0 = make_float4(0.f, 0.f, 0.f, 0.f), w1 = w0;
          if (p.xv != nullptr) {
            w0 = __ldg(reinterpret_cast<const float4*>(p.wx) + col0 + col);
            w1 = __ldg(reinterpret_cast<const float4*>(p.wx) + col0 + col + 1);
          }
          cs[2 * j] = cs[2 * j + 1] = 0.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[4 * j + 2 * h];
            float v1 = acc[4 * j + 2 * h + 1];
            if (p.xv != nullptr) {
              v0 += x[h].x * w0.x + x[h].y * w0.y + x[h].z * w0.z;
              v1 += x[h].x * w1.x + x[h].y * w1.y + x[h].z * w1.z;
            }
            if (cv != nullptr) {
              v0 += cvv.x;
              v1 += cvv.y;
            }
            if (p.relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            } else {
              const __nv_bfloat162 m = *pair(j, h);
              v0 = bf(m.x) > 0.0f ? v0 : 0.0f;
              v1 = bf(m.y) > 0.0f ? v1 : 0.0f;
            }
            if (p.store) *pair(j, h) = __floats2bfloat162_rn(v0, v1);
            cs[2 * j] += v0;
            cs[2 * j + 1] += v1;
          }
        }
        // column sums over the warp's 16 rows of the half (lane bits 2-4)
        if (p.colsum != nullptr) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
            for (int i = 0; i < 32; ++i) cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], off);
          }
          if (g == 0) {
#pragma unroll
            for (int j = 0; j < CHAIN_TN / 8; ++j) {
              rb[(4 * hf + w) * CHAIN_TN + 8 * j + 2 * q] = cs[2 * j];
              rb[(4 * hf + w) * CHAIN_TN + 8 * j + 2 * q + 1] = cs[2 * j + 1];
            }
          }
        }
      };
      half(acc0, 0);
      half(acc1, 1);
      if (p.store) fence_proxy_async();  // the output, for the TMA store
      named_bar_sync(1 + c, 128);
      if (t == 0) mbar_arrive(edone + 8 * c);
      // then over the half's 4 warps, in a fixed order: one partial per 64 rows
      if (p.colsum != nullptr) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* v = rb + 4 * hf * CHAIN_TN + t;
          p.colsum[(row0 / 64 + hf) * p.N + col0 + t] = ((v[0] + v[CHAIN_TN]) + v[2 * CHAIN_TN]) + v[3 * CHAIN_TN];
        }
      }
    }
  }
}

struct WgradParams {
  long long kt0, kts;  // 64-point K tiles of the first pair, of both
  int M, N, nsplit;
  float* out;          // [nsplit][M][N] partial sums
};

// tm_aq: TMA maps of the [n_q][M] delta_l (u_l), tm_bq of the [n_q][N]
// h_{l-1} (t_{l-1}); boxes [64 points][64 columns]. A B box wholly right
// of N is not loaded (its columns are not stored).
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap tm_a0, const __grid_constant__ CUtensorMap tm_b0,
                 const __grid_constant__ CUtensorMap tm_a1, const __grid_constant__ CUtensorMap tm_b1,
                 const WgradParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  const Ring ring{base, base + WGRAD_STAGES * (A_BYTES + WGRAD_B_BYTES), WGRAD_STAGES, WGRAD_B_BYTES};
  const int tiles_n = (p.N + WGRAD_TN - 1) / WGRAD_TN;
  const int tiles = p.M / TM * tiles_n;
  const long long units = static_cast<long long>(tiles) * p.nsplit;
  const long long chunk = (p.kts + p.nsplit - 1) / p.nsplit;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WGRAD_STAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // unit u: split u / tiles (the units of one split run side by side and
  // share their rows in L2), output tile u % tiles
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const int tile = static_cast<int>(u % tiles);
        const int m0 = tile / tiles_n * TM, n0 = tile % tiles_n * WGRAD_TN;
        const int nbox = (p.N - n0) / 64 < WGRAD_TN / 64 ? (p.N - n0) / 64 : WGRAD_TN / 64;
        const long long kb = u / tiles * chunk, ke = kb + chunk < p.kts ? kb + chunk : p.kts;
        for (long long kt = kb; kt < ke; ++kt) {
          const bool second = kt >= p.kt0;
          const CUtensorMap* ma = second ? &tm_a1 : &tm_a0;
          const CUtensorMap* mb = second ? &tm_b1 : &tm_b0;
          const int row = static_cast<int>((second ? kt - p.kt0 : kt) * TK);
          mbar_wait(ring.empty(s), ph ^ 1);
          mbar_expect_tx(ring.full(s), A_BYTES + nbox * (WGRAD_B_BYTES / 4));
          for (int bx = 0; bx < 2; ++bx) tma_load(ring.a(s) + bx * (A_BYTES / 2), ma, m0 + 64 * bx, row, ring.full(s));
          for (int bx = 0; bx < nbox; ++bx) tma_load(ring.b(s) + bx * (WGRAD_B_BYTES / 4), mb, n0 + 64 * bx, row, ring.full(s));
          if (++s == WGRAD_STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
    int s = 0;
    uint32_t ph = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int tile = static_cast<int>(u % tiles);
      const int m0 = tile / tiles_n * TM, n0 = tile % tiles_n * WGRAD_TN;
      const long long split = u / tiles;
      const long long kb = split * chunk, ke = kb + chunk < p.kts ? kb + chunk : p.kts;
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      // A: box c of the stage ([64 points][64 rows of dMp]); B: its four boxes
      consume(ring, s, ph, ke > kb ? static_cast<int>(ke - kb) : 0, t == 0, [&](int st, int kk) {
        wgmma_m64n256k16<1, 1>(acc, desc_mn(ring.a(st) + c * (A_BYTES / 2) + 2048 * kk), desc_mn(ring.b(st) + 2048 * kk));
      });
      acc_fence(acc);
      float* out = p.out + split * p.M * p.N;
      const int r = m0 + 64 * c + 16 * w + (l >> 2);
#pragma unroll
      for (int j = 0; j < WGRAD_TN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (l & 3);
        if (col < p.N) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(out + static_cast<long long>(r + 8 * h) * p.N + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
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

// The eight bf16 values of a 16-byte vector, as float32 (exact)
__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float4 add4(float4 a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

struct LastParams {
  const bf16* h;      // [n][K] last hidden activations, K a multiple of 128
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
  bf16* out;          // the rank-one last hidden layer bf16(D_{H-1} xv w_last), D = 1[h > 0], or null:
                      // E > 0: u_{H-1} of the gated rows, compact as mtc (xv = bf16(m tau));
                      // E = 0: delta_{H-1} of every row (xv = bf16(l1 seed))
  float* colsum;      // E = 0: [n / 64][K] float32 column sums of delta_{H-1} over each 64 rows, or null
};

// last_kernel's shared column-sum partials: two buffers of one float32 row
// of K per warp, when it writes column sums
inline int last_smem(int K, bool colsum) { return colsum ? 2 * (NTHREADS / 32) * K * 4 : 0; }

// Persistent blocks walk the 128-row tiles (tile blockIdx.x + k gridDim.x).
// Warp w takes the tile's rows 16 w + 4 k + r (k, r < 4), four side by
// side: lane l reads each row's 16-byte vectors l + 32 j (j < LAST_VECS per
// pass of 512 columns), all of a pass before its first FMA, against its own
// columns of w_last, which it holds in registers as float32 for the whole
// launch (one pass: K <= 512; a wider K reloads them per pass). A butterfly
// gives every lane the rows' sums; lane r runs row r's scalar epilogue
// (msd_tpu/ops/fused_train.py:216-227, :294-296) and the rows' xv come back
// by shuffles. Then each lane writes its columns of the rank-one rows from
// the h vectors it holds, as the K = 0 chain product would (the float32
// product of two bf16 values is exact), and, for E = 0, adds them into the
// warp's column sums (either output may be absent: a decoder of one hidden
// layer stores no delta rows, only their sums), a shared row of K floats (warps 0-3 hold rows 0-63,
// warps 4-7 rows 64-127); after the tile's one barrier the block sums its
// four warps per 64 rows, and warp 0 the tile's L1 and seed sums, in a fixed
// order, so equal inputs give equal bits.
__global__ void __launch_bounds__(NTHREADS) last_kernel(const LastParams p) {
  extern __shared__ float4 last_red[];  // [2][NTHREADS / 32][K] float32 (column sums)
  __shared__ float l1s[2][PT_TILE], sbs[2][PT_TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = p.K, nvec = K / 8;
  const bool one_pass = nvec <= 32 * LAST_VECS;
  float* const red = reinterpret_cast<float*>(last_red);
  float wr[LAST_VECS][8];
  auto load_w = [&](int v0) {
#pragma unroll
    for (int j = 0; j < LAST_VECS; ++j) {
      const int v = v0 + 32 * j + lane;
      unpack8(v < nvec ? __ldg(reinterpret_cast<const uint4*>(p.wl) + v) : make_uint4(0u, 0u, 0u, 0u), wr[j]);
    }
  };
  load_w(0);
  const long long tiles = p.n / PT_TILE;
  int buf = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long long base = tile * PT_TILE;
    // a tile lies wholly inside or outside the gated rows (E and P are
    // multiples of the tile)
    const bool gated = base % p.P < p.E;
    // the tile's rank-one rows: u of a gated tile, delta of every tile when
    // E = 0, none else (variant c outside the gated rows)
    bf16* const out = p.out == nullptr ? nullptr
                      : p.E == 0       ? p.out + base * K
                      : gated          ? p.out + ((base / p.P) * p.E + base % p.P) * K
                                       : nullptr;
    float* const cs_row = red + (buf * (NTHREADS / 32) + warp) * K;
#pragma unroll 1
    for (int k = 0; k < PT_TILE / (NTHREADS / 32) / LAST_ROWS; ++k) {
      const int r0 = PT_TILE / (NTHREADS / 32) * warp + LAST_ROWS * k;  // rows base + r0 + r, r < LAST_ROWS
      uint4 a[LAST_ROWS][LAST_VECS];
      auto load_h = [&](int v0) {
#pragma unroll
        for (int j = 0; j < LAST_VECS; ++j) {
          const int v = v0 + 32 * j + lane;
#pragma unroll
          for (int r = 0; r < LAST_ROWS; ++r)
            a[r][j] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(p.h + (base + r0 + r) * K) + v)
                               : make_uint4(0u, 0u, 0u, 0u);
        }
      };
      float s[LAST_ROWS];
#pragma unroll
      for (int r = 0; r < LAST_ROWS; ++r) s[r] = 0.0f;
      for (int v0 = 0; v0 < nvec; v0 += 32 * LAST_VECS) {
        if (!one_pass) load_w(v0);
        load_h(v0);
#pragma unroll
        for (int j = 0; j < LAST_VECS; ++j) {
#pragma unroll
          for (int r = 0; r < LAST_ROWS; ++r) {
            float x[8];
            unpack8(a[r][j], x);
#pragma unroll
            for (int e = 0; e < 8; ++e) s[r] = fmaf(x[e], wr[j][e], s[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < LAST_ROWS; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
      }
      float xv = 0.0f;
      if (lane < LAST_ROWS) {
        float sv = s[0];
#pragma unroll
        for (int r = 1; r < LAST_ROWS; ++r) {
          if (lane == r) sv = s[r];
        }
        const long long pt = base + r0 + lane;
        const float a_last = sv + p.clast[pt / p.P];
        const float y = tanhf(a_last);
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
        reinterpret_cast<float4*>(p.pt)[pt] = make_float4(y, mt, seed, 0.0f);
        if (gated) {
          xv = rnd(mt);
          reinterpret_cast<float4*>(p.mtc)[(pt / p.P) * p.E + pt % p.P] = make_float4(xv, 0.0f, 0.0f, 0.0f);
        } else {
          xv = rnd(seed);
          reinterpret_cast<float4*>(p.sb)[pt] = make_float4(xv, 0.0f, 0.0f, 0.0f);
        }
        l1s[buf][r0 + lane] = l1;
        sbs[buf][r0 + lane] = seed;
      }
      float xr[LAST_ROWS];
#pragma unroll
      for (int r = 0; r < LAST_ROWS; ++r) xr[r] = __shfl_sync(0xffffffffu, xv, r);
      if (out == nullptr && p.colsum == nullptr) continue;
      // the rank-one rows: bf16(D xv w_last), +0 where masked, as the chain's
      // epilogue (fmaf with +0 turns a -0 product into +0)
      for (int v0 = 0; v0 < nvec; v0 += 32 * LAST_VECS) {
        if (!one_pass) {
          load_w(v0);
          load_h(v0);
        }
#pragma unroll
        for (int j = 0; j < LAST_VECS; ++j) {
          const int v = v0 + 32 * j + lane;
          if (v >= nvec) continue;
          float cs[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) cs[e] = 0.0f;
#pragma unroll
          for (int r = 0; r < LAST_ROWS; ++r) {
            float x[8];
            unpack8(a[r][j], x);
            uint32_t o[4];
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              const float v_lo = x[e] > 0.0f ? fmaf(xr[r], wr[j][e], 0.0f) : 0.0f;
              const float v_hi = x[e + 1] > 0.0f ? fmaf(xr[r], wr[j][e + 1], 0.0f) : 0.0f;
              cs[e] += v_lo;
              cs[e + 1] += v_hi;
              const __nv_bfloat162 b2 = __floats2bfloat162_rn(v_lo, v_hi);
              o[e / 2] = *reinterpret_cast<const uint32_t*>(&b2);
            }
            if (out != nullptr)
              reinterpret_cast<uint4*>(out + static_cast<long long>(r0 + r) * K)[v] = make_uint4(o[0], o[1], o[2], o[3]);
          }
          if (p.colsum != nullptr) {  // this warp's 16 rows of the tile, pass by pass
            float4* c = reinterpret_cast<float4*>(cs_row + 8 * v);
            float4 lo = make_float4(cs[0], cs[1], cs[2], cs[3]), hi = make_float4(cs[4], cs[5], cs[6], cs[7]);
            if (k > 0) {
              lo = add4(c[0], lo);
              hi = add4(c[1], hi);
            }
            c[0] = lo;
            c[1] = hi;
          }
        }
      }
    }
    // one barrier per tile: a warp that runs ahead writes the other buffers
    __syncthreads();
    if (warp == 0) {
      const float l1 = warp_sum128(l1s[buf]);
      const float sbar = warp_sum128(sbs[buf]);
      if (lane == 0) {
        p.loss[4 * tile] = l1;
        if (!gated) p.loss[4 * tile + 2] = sbar;
      }
    }
    if (p.colsum != nullptr) {  // 64 rows: four warps' rows, in order
      const float* rb = red + buf * (NTHREADS / 32) * K;
      for (int i = threadIdx.x; i < 2 * K; i += NTHREADS) {
        const int hf = i / K, col = i - hf * K;
        const float* v = rb + 4 * hf * K + col;
        p.colsum[(base / 64 + hf) * K + col] = ((v[0] + v[K]) + v[2 * K]) + v[3 * K];
      }
    }
  }
}

// Persistent blocks walk the 128-row tiles (tile blockIdx.x + k gridDim.x).
// Warp w takes rows 32 k + 4 w + r (k, r < 4) of a tile, four side by side:
// its lanes read the rows' u0 and uL as one virtual row of W0 + WL columns,
// lane l the 16-byte vectors l + 32 j, all EIK_ROWS x EIK_VECS of a pass
// before the first FMA; the Mx columns come from shared memory (three
// float32 planes, loaded once per block), each read serving four rows. A
// butterfly over the lanes gives every lane the rows' g; lane r runs row
// r's scalar epilogue.
__global__ void __launch_bounds__(NTHREADS) eik_kernel(const EikParams p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float eks[2][PT_TILE], sbs[2][PT_TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wt = p.W0 + p.WL, nvec = wt / 8, nvec0 = p.W0 / 8;
  float* const mx = reinterpret_cast<float*>(smem_raw + ((16u - (smem_u32(smem_raw) & 15u)) & 15u));  // [3][wt]
  for (int o = threadIdx.x; o < wt; o += NTHREADS) {
    const float4 m = o < p.W0 ? reinterpret_cast<const float4*>(p.mx0)[o]
                              : reinterpret_cast<const float4*>(p.mxL)[o - p.W0];
    mx[o] = m.x;
    mx[wt + o] = m.y;
    mx[2 * wt + o] = m.z;
  }
  __syncthreads();
  const long long tiles = p.n / PT_TILE;
  int buf = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long long base = tile * PT_TILE;
    const long long pbase = (base / p.E) * p.P + base % p.E;  // the tile's first point
#pragma unroll 1
    for (int k = 0; k < PT_TILE / (EIK_ROWS * NTHREADS / 32); ++k) {
      const int r0 = EIK_ROWS * (NTHREADS / 32 * k + warp);  // the rows base + r0 + r, r < EIK_ROWS
      float g[EIK_ROWS][3];
#pragma unroll
      for (int r = 0; r < EIK_ROWS; ++r) g[r][0] = g[r][1] = g[r][2] = 0.0f;
      for (int v0 = 0; v0 < nvec; v0 += 32 * EIK_VECS) {
        uint4 a[EIK_ROWS][EIK_VECS];
#pragma unroll
        for (int j = 0; j < EIK_VECS; ++j) {
          const int v = v0 + 32 * j + lane;
#pragma unroll
          for (int r = 0; r < EIK_ROWS; ++r) {
            const long long i = base + r0 + r;
            const bf16* src = v < nvec0 ? p.u0 + i * p.W0 + 8 * v : p.uL + i * p.WL + 8 * (v - nvec0);
            a[r][j] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int j = 0; j < EIK_VECS; ++j) {
          const int v = v0 + 32 * j + lane;
          if (v >= nvec) continue;
          float m[3][8];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float4* pl = reinterpret_cast<const float4*>(mx + c * wt + 8 * v);
            const float4 lo = pl[0], hi = pl[1];
            m[c][0] = lo.x, m[c][1] = lo.y, m[c][2] = lo.z, m[c][3] = lo.w;
            m[c][4] = hi.x, m[c][5] = hi.y, m[c][6] = hi.z, m[c][7] = hi.w;
          }
#pragma unroll
          for (int r = 0; r < EIK_ROWS; ++r) {
            float x[8];
            unpack8(a[r][j], x);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              g[r][0] = fmaf(x[e], m[0][e], g[r][0]);
              g[r][1] = fmaf(x[e], m[1][e], g[r][1]);
              g[r][2] = fmaf(x[e], m[2][e], g[r][2]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < EIK_ROWS; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) g[r][c] += __shfl_xor_sync(0xffffffffu, g[r][c], off);
        }
      }
      if (lane < EIK_ROWS) {
        float gv[3] = {g[0][0], g[0][1], g[0][2]};
#pragma unroll
        for (int r = 1; r < EIK_ROWS; ++r) {
          if (lane == r) gv[0] = g[r][0], gv[1] = g[r][1], gv[2] = g[r][2];
        }
        const long long i = base + r0 + lane, pt = pbase + r0 + lane;
        const float gsq = gv[0] * gv[0] + gv[1] * gv[1] + gv[2] * gv[2];
        const float gn = sqrtf(fmaxf(gsq, 1e-24f));
        const float coef = p.eik_coef * (gn - 1.0f) / gn;
        // variant e scales the eikonal lane and gbar, hence its whole reverse
        // pass (msd_tpu/ops/fused_train.py:248-258)
        const float wt_e = p.w != nullptr ? p.w[i / p.E] : 1.0f;
        float gbar[3], gdot = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          gbar[j] = coef * gv[j];
          if (p.w != nullptr) gbar[j] *= wt_e;
          gdot += gbar[j] * gv[j];
        }
        const float4 q = reinterpret_cast<const float4*>(p.pt)[pt];  // (y, m tau, l1 seed, 0)
        const float sbar = q.z + (-2.0f * q.x) * gdot;
        reinterpret_cast<float4*>(p.gb)[i] = make_float4(rnd(gbar[0]), rnd(gbar[1]), rnd(gbar[2]), 0.0f);
        reinterpret_cast<float4*>(p.sb)[pt] = make_float4(rnd(sbar), 0.0f, 0.0f, 0.0f);
        float ek = (1.0f - gn) * (1.0f - gn);
        if (p.w != nullptr) ek *= wt_e;
        eks[buf][r0 + lane] = ek;
        sbs[buf][r0 + lane] = sbar;
      }
    }
    // one barrier per tile: a warp that runs ahead writes the other buffer
    __syncthreads();
    if (warp == 0) {
      const float ek = warp_sum128(eks[buf]);
      const float sbar = warp_sum128(sbs[buf]);
      if (lane == 0) {
        p.loss[4 * (pbase / PT_TILE) + 1] = ek;
        p.loss[4 * (pbase / PT_TILE) + 2] = sbar;
      }
    }
  }
}

struct SkinnyParams {
  const bf16* A[2];   // [n_q][W]
  const float* V[2];  // [n_q][4]
  long long n[2];     // rows of each pair (0: no second pair)
  int W, splits;
  float* part;        // [splits][W][4] scratch: each block's partial sums
  unsigned* ticket;   // [W / SK_COLS] arrival counts: 0 before the launch, and after it
  float* out;         // [W][4] accumulator: columns 0-2 += the sums over the rows of A[q][o] V[q][0:3]
};

static_assert(NTHREADS == 2 * SK_COLS && PT_TILE % (EIK_ROWS * NTHREADS / 32) == 0, "per-point block shapes");

// Block (split, column group): the split's rows of the two pairs laid end
// to end, [s c, (s + 1) c) with c = ceil((n0 + n1) / splits), for the
// group's 128 columns. Thread (row lane rl, column vector cg) sums the
// rows rl + 16 i in order, 24 float32 accumulators; the block reduces its
// 16 row lanes in a fixed order into its [128][4] partial. The last block
// of a column group to arrive (a ticket counted after a fence) sums the
// group's partials in split order and adds them to ``out``: no float
// atomics, so equal inputs give equal bits.
__global__ void __launch_bounds__(NTHREADS, 2) skinny_kernel(const SkinnyParams p) {
  __shared__ float4 red[NTHREADS / 32][SK_COLS];
  __shared__ unsigned arrived;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cg = t & 15, rl = t >> 4;
  const int split = blockIdx.x, group = blockIdx.y;
  const int col0 = group * SK_COLS + 8 * cg;
  float acc[8][3];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = 0.0f;
  const long long total = p.n[0] + p.n[1];
  const long long len = (total + p.splits - 1) / p.splits;
  const long long b = split * len, e = b + len < total ? b + len : total;
  long long off = 0;
  for (int q = 0; q < 2; off += p.n[q], ++q) {
    const long long qb = b - off > 0 ? b - off : 0;
    const long long qe = e - off < p.n[q] ? e - off : p.n[q];
    if (qb >= qe) continue;
    const bf16* A = p.A[q] + col0;
    const float4* V = reinterpret_cast<const float4*>(p.V[q]);
    for (long long r0 = qb + rl; r0 < qe; r0 += SK_LANES * SK_DEPTH) {
      uint4 a[SK_DEPTH];
      float4 v[SK_DEPTH];
#pragma unroll
      for (int d = 0; d < SK_DEPTH; ++d) {
        const long long r = r0 + d * SK_LANES;
        const bool ok = r < qe;
        a[d] = ok ? __ldg(reinterpret_cast<const uint4*>(A + r * p.W)) : make_uint4(0u, 0u, 0u, 0u);
        v[d] = ok ? __ldg(V + r) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int d = 0; d < SK_DEPTH; ++d) {
        float x[8];
        unpack8(a[d], x);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[c][0] = fmaf(x[c], v[d].x, acc[c][0]);
          acc[c][1] = fmaf(x[c], v[d].y, acc[c][1]);
          acc[c][2] = fmaf(x[c], v[d].z, acc[c][2]);
        }
      }
    }
  }
  // row lanes 2 w and 2 w + 1 share warp w (lanes l and l ^ 16), then the
  // warps in order
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], 16);
  }
  if (lane < 16) {
#pragma unroll
    for (int c = 0; c < 8; ++c) red[warp][8 * cg + c] = make_float4(acc[c][0], acc[c][1], acc[c][2], 0.0f);
  }
  __syncthreads();
  float4* const part = reinterpret_cast<float4*>(p.part) + group * SK_COLS;
  if (t < SK_COLS) {
    float4 s = red[0][t];
#pragma unroll
    for (int w = 1; w < NTHREADS / 32; ++w) s = add4(s, red[w][t]);
    part[static_cast<long long>(split) * p.W + t] = s;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) arrived = atomicAdd(p.ticket + group, 1u);
  __syncthreads();
  if (arrived != static_cast<unsigned>(p.splits - 1)) return;
  __threadfence();
  // the last block: threads t and t + 128 sum the first and second half of
  // the splits of column t, then thread t adds both to out
  const int col = t & (SK_COLS - 1), half = t / SK_COLS;
  const int per = (p.splits + 1) / 2;
  const int s0 = half * per, s1 = s0 + per < p.splits ? s0 + per : p.splits;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int sp = s0; sp < s1; ++sp) s = add4(s, __ldcg(part + static_cast<long long>(sp) * p.W + col));
  red[half][col] = s;
  __syncthreads();
  if (t < SK_COLS) {
    const float4 lo = red[0][t], hi = red[1][t];
    float* o = p.out + 4 * (group * SK_COLS + t);
    o[0] += lo.x + hi.x;
    o[1] += lo.y + hi.y;
    o[2] += lo.z + hi.z;
  }
  if (t == 0) p.ticket[group] = 0;
}

inline int err(cudaError_t e) { return static_cast<int>(e); }
inline int bad() { return err(cudaErrorInvalidValue); }
// the row streamers' 16-byte loads (null passes)
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
// eik_kernel's Mx planes, 3 x width float32, plus 16 bytes of alignment
inline int eik_smem(int width) { return 12 * width + 16; }
// the most dynamic shared memory a row streamer takes (wider rows are refused)
constexpr int STREAM_MAX_SMEM = 200 * 1024;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The TMA map of a row-major [outer][inner] bf16 tensor in boxes of
// [box_outer][box_inner], 128-byte swizzle, zeros past the edges. An
// unused map stays zero.
bool bf16_map(CUtensorMap* m, const void* ptr, long long inner, long long outer, int box_inner, int box_outer) {
  memset(m, 0, sizeof(*m));
  if (ptr == nullptr) return true;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Persistent row-streamer grids: as many blocks as are resident at once,
// each taking the same number of 128-row tiles (to one)
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int smem, long long tiles, unsigned* grid) {
  int dev, sms, per_sm;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
  if (e != cudaSuccess) return e;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long waves = (tiles + resident - 1) / resident;
  *grid = static_cast<unsigned>((tiles + waves - 1) / waves);
  return cudaSuccess;
}

// Persistent GEMM grids: one block per SM, or fewer when there is less work
cudaError_t gemm_grid(long long units, unsigned* grid) {
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = static_cast<unsigned>(units < sms ? units : sms);
  return e;
}

}  // namespace

extern "C" {

// Every function returns a cudaError_t code; launches go to ``stream`` and
// do not synchronise.

int msd_ft_chain(const void* A, const void* B, long long n, int N, int K, const void* xv, const void* wx,
                 const void* cvec, int P, int R, int relu, const void* mask, void* out, void* colsum,
                 void* stream) {
  if (n <= 0 || n % TM || n > INT32_MAX || N <= 0 || N % CHAIN_TN || K < 0 || K % TK || (K > 0) != (A != nullptr) ||
      (K > 0 && B == nullptr) || (xv == nullptr) != (wx == nullptr) || ((cvec != nullptr || R) && P <= 0) ||
      (cvec != nullptr && P % TM) || R < 0 || R > P || (R && (R % TM || n % R)) || (!relu && mask == nullptr) ||
      (out == nullptr && colsum == nullptr))
    return bad();
  const ChainParams p{n, N, K, static_cast<const float*>(xv), static_cast<const float*>(wx),
                      static_cast<const float*>(cvec), P, R, relu, out != nullptr, static_cast<float*>(colsum)};
  CUtensorMap ta, tb, tmask, tout;
  if (!bf16_map(&ta, K > 0 ? A : nullptr, K, n, TK, TM) || !bf16_map(&tb, K > 0 ? B : nullptr, K, N, TK, CHAIN_TN) ||
      !bf16_map(&tmask, relu ? nullptr : mask, N, R ? n / R * P : n, 64, TM) ||
      !bf16_map(&tout, out, N, n, 64, TM))
    return bad();
  unsigned grid;
  cudaError_t e = gemm_grid(n / TM * (N / CHAIN_TN), &grid);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CHAIN_SMEM);
  if (e != cudaSuccess) return err(e);
  chain_kernel<<<grid, GEMM_THREADS, CHAIN_SMEM, static_cast<cudaStream_t>(stream)>>>(ta, tb, tmask, tout, p);
  return err(cudaGetLastError());
}

int msd_ft_wgrad(const void* A0, const void* B0, long long n0, const void* A1, const void* B1, long long n1,
                 int M, int N, int nsplit, void* out, void* stream) {
  if (n0 <= 0 || n0 % TK || n0 > INT32_MAX || n1 < 0 || n1 % TK || n1 > INT32_MAX || (n1 > 0) != (A1 != nullptr) ||
      M <= 0 || M % TM || N <= 0 || N % 128 || nsplit < 1 || A0 == nullptr || B0 == nullptr ||
      (A1 == nullptr) != (B1 == nullptr) || out == nullptr)
    return bad();
  const WgradParams p{n0 / TK, (n0 + n1) / TK, M, N, nsplit, static_cast<float*>(out)};
  CUtensorMap a0, b0, a1, b1;
  if (!bf16_map(&a0, A0, M, n0, 64, TK) || !bf16_map(&b0, B0, N, n0, 64, TK) ||
      !bf16_map(&a1, n1 > 0 ? A1 : nullptr, M, n1, 64, TK) || !bf16_map(&b1, n1 > 0 ? B1 : nullptr, N, n1, 64, TK))
    return bad();
  unsigned grid;
  cudaError_t e = gemm_grid(static_cast<long long>(M / TM) * ((N + WGRAD_TN - 1) / WGRAD_TN) * nsplit, &grid);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WGRAD_SMEM);
  if (e != cudaSuccess) return err(e);
  wgrad_kernel<<<grid, GEMM_THREADS, WGRAD_SMEM, static_cast<cudaStream_t>(stream)>>>(a0, b0, a1, b1, p);
  return err(cudaGetLastError());
}

// Dynamic shared memory, bytes, of chain_kernel (0), wgrad_kernel (1),
// eik_kernel (2) over ``width`` = W0 + WL columns, skinny_kernel (3),
// last_kernel (4) at K = ``width`` with column sums (none without)
int msd_ft_dynamic_smem(int kernel, int width) {
  switch (kernel) {
    case 0: return CHAIN_SMEM;
    case 1: return WGRAD_SMEM;
    case 2: return eik_smem(width);
    case 4: return last_smem(width, true);
    default: return 0;
  }
}

// out: the rank-one last hidden layer, [n / P * E][K] bf16 (E > 0) or
// [n][K] (E = 0), or null; colsum: [n / 64][K] float32, only when E = 0, or
// null
int msd_ft_last(const void* h, const void* wl, int K, const void* clast, const void* gt, const void* w,
                long long n, int P, int E, float clamp, float inv_ntot, void* pt, void* mtc, void* sb, void* loss,
                void* out, void* colsum, void* stream) {
  if (n <= 0 || n % PT_TILE || P <= 0 || P % PT_TILE || n % P || E < 0 || E > P || E % PT_TILE || K <= 0 ||
      K % 128 || h == nullptr || wl == nullptr || clast == nullptr || gt == nullptr || pt == nullptr ||
      (E > 0 && mtc == nullptr) || loss == nullptr || (E < P && sb == nullptr) || (E > 0 && colsum != nullptr) ||
      !aligned16(h) || !aligned16(wl) || !aligned16(out) || last_smem(K, colsum != nullptr) > STREAM_MAX_SMEM)
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
  p.out = static_cast<bf16*>(out);
  p.colsum = static_cast<float*>(colsum);
  const int smem = last_smem(K, colsum != nullptr);
  unsigned grid;
  const cudaError_t e = resident_grid(last_kernel, smem, n / PT_TILE, &grid);
  if (e != cudaSuccess) return err(e);
  last_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return err(cudaGetLastError());
}

int msd_ft_eik(const void* u0, const void* mx0, int W0, const void* uL, const void* mxL, int WL, const void* pt,
               const void* w, long long n, int P, int E, float eik_coef, void* gb, void* sb, void* loss,
               void* stream) {
  if (uL == nullptr) WL = 0;
  if (n <= 0 || n % PT_TILE || P <= 0 || E <= 0 || E > P || E % PT_TILE || P % PT_TILE || n % E ||
      u0 == nullptr || mx0 == nullptr || W0 <= 0 || W0 % 8 || (uL == nullptr) != (mxL == nullptr) ||
      (uL != nullptr && (WL <= 0 || WL % 8)) || !aligned16(u0) || !aligned16(uL) || !aligned16(mx0) ||
      !aligned16(mxL) || eik_smem(W0 + WL) > STREAM_MAX_SMEM || pt == nullptr || gb == nullptr || sb == nullptr ||
      loss == nullptr)
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
  const int smem = eik_smem(W0 + WL);
  unsigned grid;
  const cudaError_t e = resident_grid(eik_kernel, smem, n / PT_TILE, &grid);
  if (e != cudaSuccess) return err(e);
  eik_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return err(cudaGetLastError());
}

// ticket: [W / 128] int32, zero (the kernel leaves it zero); part: [splits][W][4] float32 scratch
int msd_ft_skinny(const void* A0, const void* V0, long long n0, const void* A1, const void* V1, long long n1, int W,
                  int splits, void* part, void* ticket, void* out, void* stream) {
  if (n0 <= 0 || n1 < 0 || (n1 > 0) != (A1 != nullptr) || W <= 0 || W % SK_COLS || W / SK_COLS > 65535 ||
      splits < 1 || A0 == nullptr || V0 == nullptr || (A1 == nullptr) != (V1 == nullptr) || !aligned16(A0) ||
      !aligned16(V0) || !aligned16(A1) || !aligned16(V1) || !aligned16(part) || part == nullptr ||
      ticket == nullptr || out == nullptr)
    return bad();
  SkinnyParams p;
  p.A[0] = static_cast<const bf16*>(A0);
  p.V[0] = static_cast<const float*>(V0);
  p.A[1] = static_cast<const bf16*>(A1);
  p.V[1] = static_cast<const float*>(V1);
  p.n[0] = n0;
  p.n[1] = n1;
  p.W = W;
  p.splits = splits;
  p.part = static_cast<float*>(part);
  p.ticket = static_cast<unsigned*>(ticket);
  p.out = static_cast<float*>(out);
  skinny_kernel<<<dim3(splits, W / SK_COLS), NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return err(cudaGetLastError());
}

const char* msd_ft_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
