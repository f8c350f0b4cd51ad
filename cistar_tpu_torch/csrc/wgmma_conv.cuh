// The "same" KKxKK conv (KK 3 or 5, any dilation with zero padding) of the
// port's int8 and bf16 kernels on Hopper's wgmma + TMA (sm_90a), templated
// on the operand type: int8 x int8 -> int32 (K1 and K2,
// csrc/int8_resblock.cu: both convs of every block, the bn=True form and
// cistar_conv3x3_reflect_s8_acc; K7a, K7b and their bn forms,
// csrc/int8_tiled.cu: conv 1, the grouped conv 2 and
// cistar_conv3x3_reflect_grouped_s8_acc; K5, csrc/int8_atrous.cu: the
// four dilated branch convs in one launch, the reflect conv and
// cistar_conv3x3_zero_s8_acc; K6, same file: its four branch convs, in
// wg_branch_kernel below; K8, csrc/int8_msrb.cu: both branches, 3x3 and
// 5x5, and cistar_conv_zero_grouped_s8_acc) and bf16 x bf16 -> fp32
// (K3, csrc/conv3x3_in_act.cu; K10, csrc/conv_s2.cu: the UNet's 7x7
// stride-2 downs, STRIDE 2 and EPI_BF16).
//
// Serves the TPU kernels' convs
//   cistar_tpu/ops/quant_pallas.py::_conv9_int8 (:114-134), the conv of
//     _resblock_int8_bf16io_kernel (K1) and _resblock_int8_kernel (K2)
//   quant_pallas.py::_resblock_a_kernel (:455-470, K7a)
//   quant_pallas.py::_resblock_b_kernel (:471-490, K7b) and
//     _msrb_branch_kernel (:720-750, K8), whose K loops run group by group
//   quant_pallas.py::_atrous_resblock_int8_kernel (:930-970, K5): four
//     dilated zero-pad convs and one reflect conv
//   quant_pallas.py::_multi_atrous_stage_int8_kernel (:1121-1140, K6):
//     four dilated zero-pad convs, IN + ReLU each, summed
//   cistar_tpu/ops/pallas_kernels.py::fused_conv3x3_in_act's body
//     (:181-200, K3)
// each a padded halo in VMEM and KK*KK shifted (H*W, Cin) x (Cin, Cout)
// matmuls.
//
// What bounds it: operations. At the trunk shape (64, 32, 32, 512) one
// 3x3 conv is an implicit GEMM of M = 65,536 pixels, N = 512, K = 9 * 512
// = 4,608: 309.2 G operations, 0.156 ms at 1,979 int8 TOPS and 0.313 ms at
// 989 bf16 TFLOP/s, against ~40 MB of input and weights (0.012 ms at 3.35
// TB/s). K8's 5x5 branches have 25/9 of a 3x3's operations on the same
// bytes.
//
// Design (what it does about that):
//   * Tap (dy, dx) of an M tile that covers image rows y0 .. y0+R-1 is one
//     4-D TMA box at (c0, x0 + dx*r + pad_off, y0 + dy*r + pad_off, n), box
//     (KB bytes of C, min(W, 128), R = 128 / min(W, 128), 1), r the
//     dilation (ConvArgs::dil): the TPU kernel's KK*KK shifted windows,
//     fetched by the copy engine with no address arithmetic in the SM. TMA
//     fills zeros, not reflections, outside the tensor, so reflect padding
//     reads a reflect-padded (N, H+2, W+2, C) copy at pad_off 0 and r 1
//     (written by K1's and K7a's quantize passes directly, K5's requantize
//     of its branch sum too, by reflect_pad_kernel for K2's input, K7b's
//     rq, the RAW entries and K3). Zero padding needs no copy: the box
//     starts at pad_off -(KK/2)*r on the unpadded tensor and TMA
//     zero-fills what lies outside (K3, K8, K5's branches at r 2/4/6/8; a
//     box may lie wholly outside, and still completes its bytes).
//   * K5's four branch convs (one input, four weights, four dilations) run
//     as one launch (ConvArgs::branches): the tile's column block picks
//     the branch, its dilation (bdil), its rows of the (4*Cout, 9*Cin)
//     weight matrix, its f slab, statistics and scale / bias rows.
//   * Persistent blocks (PERSIST, K5): with a K loop of 9 stages the ring's
//     fill and the epilogue weigh as much as the products, so one block
//     per SM walks the output tiles and the producer loads the next tile
//     while the consumers run this one's epilogue; the ring is one or two
//     stages shorter and the epilogue's partial sums get their own shared
//     memory. Measured on an H100 at K5's shapes: the four branch convs
//     ~15% faster than one block a tile; K7a's long K loops gain nothing,
//     and keep one block a tile.
//   * The weights (Cout, KK*KK*Cin), K-contiguous, are a 2-D box of (KB
//     bytes of K, BN rows). Both operands are K-major with KB-byte swizzle,
//     the layout wgmma reads (and the only kind it takes for 8-bit types).
//     KB, the bytes of K a stage, is 128 (one 128-byte swizzle row) or 64
//     (64-byte swizzle, 8-row groups 512 B apart): K6's 64 input channels
//     are 64 bytes, and a 128-byte stage would span two taps.
//   * A ring of STAGES tiles in shared memory (4 at BN 256, 6 at BN 128,
//     192 KB; PERSIST 3 / 5; twice as many at KB 64), each an A tile of
//     128 pixels and a B tile of BN channels x KB bytes of K, filled by
//     one producer thread through an mbarrier per stage ("full") and
//     released by the consumers through another ("empty").
//   * Two consumer warpgroups, 64 rows each, run wgmma.mma_async
//     m64nBNk32 (s8) / k16 (bf16) on the arrived tiles: KB / 32 a stage, one
//     group kept in flight, so a stage is released while the next one's
//     products run. setmaxnreg moves registers from the producer warpgroup
//     (40) to the consumers (232): BN 256 holds 128 accumulators a thread.
//   * Input groups (K7b, K8): the K loop runs group by group, tap by tap
//     inside a group (conv_s8_kernel's order). At a group's last K stage the
//     consumers wait for all its products (wgmma_wait<0>) and flush the
//     exact int32 partial: EPI_RAW writes it, EPI_GSTATS / EPI_GRELU add
//     float(acc) * gs[n, g] to an fp32 sum in group order; the accumulators
//     restart from 0. Each stage is still released once, by the next
//     iteration.
//   * BN per launch: the ungrouped 3x3 callers take 256 where the grid still
//     has 2 blocks per SM (132 SMs on an H100 SXM), else 128, so a batch of
//     8 fills the card (256 blocks of 128 x 128 at (8, 32, 32, 512)). The
//     grouped ones take 128 (WG_BN_GROUPED): 64 int32 accumulators and 64
//     fp32 group sums a thread.
//   * The epilogues are conv_s8_kernel's (int8_common.cuh), op for op:
//     EPI_RAW writes the int32 accumulators of each group; EPI_STATS writes
//     f = acc * (xs[n] * ws[c]) + bias[c] (s8) or acc + bias[c] (bf16) in
//     fp32 with __fmul_rn / __fadd_rn, and adds each (image, channel)'s
//     sum, sum of squares and (WANT_MAX) max with atomics; with st_sum null,
//     the max only. EPI_GSTATS the same on f = gsum * ws[c] + bias[c];
//     EPI_GRELU relu(gsum * ws[c] + bias[c]), written as TO, or (WANT_MAX)
//     as fp32 f with an integer atomicMax per (image, ct tile). The wgmma
//     accumulator of a warp covers 16 rows (lane / 4 and lane / 4 + 8) of
//     the 64, so the column sums reduce over lane bits 2-4 by shuffles,
//     then over the 8 consumer warps in shared memory.
//
//   * Stride (STRIDE 2, K10): tile rows and columns are output pixels, and
//     tap (dy, dx) of a tile at output (y0, x0) is the box at input (2*y0 +
//     dy + pad_off, 2*x0 + dx + pad_off). The caller's map over x has
//     element strides of 2 on W and H and a box twice as wide and high, so
//     TMA fetches every other pixel into the same dense 128-pixel A tile.
//     Its shapes follow conv_s2.cu's own rule (s2_shape_ok), not the one
//     below.
//
// The tile rule (wg_tile_ok): W divides 128 or 128 divides W (a tile is
// whole image rows, or 128 pixels of one row), H*W % 128 == 0 (a tile lies
// in one image), KK 3 or 5, the stage's KB bytes divide Cin / groups (a K
// stage lies in one tap of one group) and Cout % 128 == 0; the dilation
// does not enter it. wg_kbytes takes KB 128 wherever that holds, else 64;
// only int8_atrous.cu (K5, K6) asks it, the other libraries keep KB 128.
// Every K1 shape on the ported paths (ResNet-9 and multiscale 256² at (B,
// 32, 32, 512), the JAX budget configuration's (B, 16, 16, 128)), K3's (B,
// 32, 32, 512), K7a's and K7b's (B, 32, 32, 1024) and (B, 64, 64, 512) (K7b
// in 256- or 128-channel groups), K5's (B, 64, 64, 128) and K8's (B, 64,
// 64, 512 | 1024) in 1 or 8 groups meet it; other shapes keep
// conv_s8_kernel (K1, K2, K5, K7, K8; K6's 256² stage 1, 32 -> 64 channels)
// or conv_ffma_kernel (K3), chosen by shape. K6's stage 2 (B, 64, 64, 64 ->
// 128) takes KB 64.
//
// The TMA descriptors hold the tensors' pointers, so they are encoded on
// the host for each launch (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint: the libraries link no libcuda) and passed as
// __grid_constant__ kernel parameters.

#pragma once

#include <cuda.h>

#include "int8_common.cuh"

namespace {

constexpr int WG_BM = 128;        // output pixels per block
constexpr int WG_THREADS = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int WG_KBYTES = 128;    // bytes of K per stage, unless KB says 64
constexpr int WG_SMS = 132;       // SMs of an H100 SXM, for the choice of BN
constexpr int WG_SMEM_MAX = 232448;  // dynamic shared memory a block may have

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One bulk copy (no tensor map) of `bytes` contiguous bytes, completing on
// bar's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with KB-byte swizzle:
// rows of KB bytes, 8-row groups 8 * KB bytes apart (SBO), layout type 1
// (128-byte swizzle) or 2 (64-byte). The tile starts at a row of a pattern
// laid out from a 1024-byte boundary; a K step of 32 bytes inside the
// swizzle row adds 2 to the address field.
template <int KB>
__device__ __forceinline__ uint64_t sw_desc(const void* p) {
  static_assert(KB == 128 || KB == 64, "a K stage of 128 or 64 bytes");
  // the swizzle follows the absolute shared-memory address (base offset
  // 0), so a tile may start rows into its pattern (K6's halo windows)
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * KB / 16) << 32) | ((KB == 128 ? 1ull : 2ull) << 62);
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
// v rounded to bf16 (to nearest even), back in fp32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Keeps the compiler from moving an accumulator access across a wait.
__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// wgmma.mma_async m64nNk32 s8 / m64nNk16 bf16, A and B from shared memory
// (K-major), d += A * B.

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n256(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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

// The accumulator and TMA element type of each operand type.
template <typename T>
struct WgOperand;
template <>
struct WgOperand<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType tma = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
template <>
struct WgOperand<__nv_bfloat16> {
  using Acc = float;
  static constexpr CUtensorMapDataType tma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <int BN>
__device__ __forceinline__ void wg_mma(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_s8_n256(d, da, db);
  else wgmma_s8_n128(d, da, db);
}
template <int BN>
__device__ __forceinline__ void wg_mma(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_bf16_n256(d, da, db);
  else wgmma_bf16_n128(d, da, db);
}

// Ring stages. A persistent block keeps its epilogue's partial sums out of
// the ring (the producer refills it meanwhile), so it takes one stage
// fewer (BN 128) or two (BN 256): shared memory stays under the 196 KB
// carveout, above which the SM keeps 28 KB of L1 instead of 60: a 9-stage
// K loop (K5's convs) ran ~10% slower there on an H100. A 64-byte stage
// is half as large: the same bytes hold twice the stages.
template <int BN, bool PERSIST, int KB = WG_KBYTES>
__host__ __device__ constexpr int wg_stages() {
  return (PERSIST ? (BN == 256 ? 3 : 5) : (BN == 256 ? 4 : 6)) * (WG_KBYTES / KB);
}

template <int BN, bool PERSIST, int KB = WG_KBYTES>
__host__ __device__ constexpr int wg_smem_bytes() {
  // the ring, 1 KB of slack to align it to 1024, the barriers; PERSIST:
  // the epilogue's partial sums (8 warps x 3 x BN fp32), else they reuse
  // the drained ring
  return wg_stages<BN, PERSIST, KB>() * (WG_BM + BN) * KB + 1024 +
         2 * wg_stages<BN, PERSIST, KB>() * 8 + (PERSIST ? 8 * 3 * BN * 4 : 0);
}

// Where output tile `tile` lies: tiles run M tile fastest, then the BN
// columns of (branches x Cout).
struct WgTile {
  long m0;           // first output pixel
  int img, y0, x0;   // its image and position: the tile is whole rows or
                     // 128 pixels of one row
  int wrow;          // first row of the (branches*Cout, K) weights
  int br, n0;        // its branch (K5's four, else 0) and first channel there
  int dil, pad_off;  // the branch's dilation and the box offset of tap (0, 0)
};

// The dilation of branch b (ConvArgs::bdil), without indexing the kernel
// parameter by a register.
__device__ __forceinline__ int branch_dil(const ConvArgs& a, int b) {
  return b == 0 ? a.bdil[0] : b == 1 ? a.bdil[1] : b == 2 ? a.bdil[2] : a.bdil[3];
}

__device__ __forceinline__ WgTile wg_tile(const ConvArgs& a, int tile, int mtiles, int bn,
                                          int kk, int padded) {
  WgTile c;
  const int nt = tile / mtiles, HW = a.h * a.w;
  c.m0 = static_cast<long>(tile - nt * mtiles) * WG_BM;
  c.img = static_cast<int>(c.m0 / HW);
  const int rem = static_cast<int>(c.m0 - static_cast<long>(c.img) * HW);
  c.y0 = rem / a.w;
  c.x0 = rem - c.y0 * a.w;
  c.wrow = nt * bn;
  c.br = c.wrow / a.cout;
  c.n0 = c.wrow - c.br * a.cout;
  c.dil = a.branches == 1 ? a.dil : branch_dil(a, c.br);
  c.pad_off = padded ? 0 : -(kk / 2) * c.dil;
  return c;
}

// One block computes output tiles of 128 pixels x BN channels: tile
// blockIdx.x, then every gridDim.x-th after it. Without PERSIST the grid
// has one block per tile; with it one block per SM, and the producer
// fills the ring with the next tile's stages while the consumers run this
// tile's epilogue. Thread layout: warpgroup 0 the
// producer (thread 0 starts every TMA load), warpgroups 1 and 2 the
// consumers of rows 0-63 and 64-127. The input map `tx` is
// (C, W', H', N) over the padded tensor (padded: box offset 0) or the
// unpadded one (offset -(KK/2)*dil, zero padding by TMA's fill); `tw` is
// (KK*KK*Cin, branches*Cout).
// The K loop runs group by group (Cin = a.groups x cg channels) and, inside
// a group, tap by tap: K stage kt is group kt / SPG, tap (kt % SPG) / CPG,
// channels grp*cg + (kt % CPG)*KE .. +KE, conv_s8_kernel's order. At the
// last stage of a group its exact partial is flushed: EPI_RAW writes it to
// acc_out (groups, M, Cout), EPI_GSTATS / EPI_GRELU add float(acc) * gs[img,
// grp] to an fp32 sum in group order; the accumulators restart from 0.
// Epilogue fields of `a` as conv_s8_kernel's.
template <typename T, int BN, int EPI, bool WANT_MAX, int KK = 3, typename TO = float,
          bool PERSIST = false, int KB = WG_KBYTES, int STRIDE = 1>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wg_conv_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw, const ConvArgs a,
                   int padded) {
  using Acc = typename WgOperand<T>::Acc;
  constexpr bool GROUPED = EPI == EPI_GSTATS || EPI == EPI_GRELU;
  constexpr int STAGES = wg_stages<BN, PERSIST, KB>();
  constexpr int A_BYTES = WG_BM * KB, B_BYTES = BN * KB;
  constexpr int KE = KB / static_cast<int>(sizeof(T));  // K elements a stage
  constexpr int NA = BN / 2;  // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sa = smem;
  uint8_t* sb = smem + STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;
  // the epilogue's partial sums red[8 warps][3][BN]: after the barriers,
  // or (one tile a block) in the drained ring
  float* red = reinterpret_cast<float*>(PERSIST ? reinterpret_cast<uint8_t*>(empty + STAGES)
                                                : smem);

  const int W = a.w, HW = a.h * a.w, Cout = a.cout;
  const int mtiles = static_cast<int>(static_cast<long>(a.n) * HW / WG_BM);
  const int tiles = mtiles * (a.branches * Cout / BN);
  const int cg = a.cin / a.groups;  // channels of one input group
  const int CPG = cg / KE;          // K stages per tap of one group
  const int SPG = KK * KK * CPG;    // K stages per group
  const int KT = a.groups * SPG;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage use u (over all tiles of this block) is ring slot u % STAGES in
  // its phase u / STAGES.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      for (int tile = blockIdx.x, u = 0; tile < tiles; tile += gridDim.x) {
        const WgTile tc = wg_tile(a, tile, mtiles, BN, KK, padded);
        for (int kt = 0; kt < KT; ++kt, ++u) {
          const int s = u % STAGES;
          if (u >= STAGES) mbar_wait(&empty[s], ((u / STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
          const int grp = kt / SPG, r = kt - grp * SPG, tap = r / CPG;
          const int c0 = grp * cg + (r - tap * CPG) * KE;
          tma_load_4d(sa + s * A_BYTES, &tx, &full[s], c0,
                      tc.x0 * STRIDE + (tap % KK) * tc.dil + tc.pad_off,
                      tc.y0 * STRIDE + (tap / KK) * tc.dil + tc.pad_off, tc.img);
          tma_load_2d(sb + s * B_BYTES, &tw, &full[s], tap * a.cin + c0, tc.wrow);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;  // rows cw*64 .. cw*64+63 of the tile
  // Accumulator i of thread t: n8 block j = i / 4, row 16 * (t / 32) +
  // (t % 32) / 4 + 8 * ((i / 2) % 2), column 8 * j + 2 * (t % 4) + i % 2.
  const int wi = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int cwarp = cw * 4 + wi;
  const bool sums = a.st_sum != nullptr;
  // EPI_GRELU without WANT_MAX writes TO and reduces nothing (st_sum null)
  const bool reduce = sums || WANT_MAX;
  Acc acc[NA];
  float fv[GROUPED ? NA : 1];  // the fp32 group sum
  for (int tile = blockIdx.x, u = 0; tile < tiles; tile += gridDim.x) {
    const WgTile tc = wg_tile(a, tile, mtiles, BN, KK, padded);
    const int img = tc.img, n0 = tc.n0;
    const long row0 = tc.m0 + cw * 64 + wi * 16 + g;  // and row0 + 8
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0;
    if constexpr (GROUPED) {
#pragma unroll
      for (int i = 0; i < NA; ++i) fv[i] = 0.f;
    }
    for (int kt = 0, grp = 0, gk = 0; kt < KT; ++kt, ++u) {
      const int s = u % STAGES;
      mbar_wait(&full[s], (u / STAGES) & 1);
      const uint64_t da = sw_desc<KB>(sa + s * A_BYTES + cw * 64 * KB);
      const uint64_t db = sw_desc<KB>(sb + s * B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KB / 32; ++k) wg_mma<BN>(acc, da + 2 * k, db + 2 * k);
      wgmma_commit();
      // keep this stage's group in flight; the previous one is done: release
      // it. Each stage use is released exactly once: here, by the next
      // iteration, or (the tile's last) after the K loop.
      wgmma_wait<1>();
      if (kt > 0 && t == 0) mbar_arrive(&empty[(u - 1) % STAGES]);
      if (++gk < SPG) continue;
      // The last K stage of group grp: wait for its products, then flush.
      gk = 0;
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NA; ++i) reg_fence(acc[i]);
      if constexpr (EPI == EPI_RAW) {
        int32_t* out = a.acc_out + static_cast<long>(grp) * a.n * a.h * W * Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<int2*>(out + (row0 + 8 * h) * Cout + n0 + 8 * j + 2 * q) =
                make_int2(static_cast<int>(acc[4 * j + 2 * h]),
                          static_cast<int>(acc[4 * j + 2 * h + 1]));
      } else if constexpr (GROUPED) {
        const float gsc = a.gs[img * a.groups + grp];
#pragma unroll
        for (int i = 0; i < NA; ++i)
          fv[i] = __fadd_rn(fv[i], __fmul_rn(static_cast<float>(acc[i]), gsc));
      }
      if constexpr (EPI == EPI_RAW || GROUPED) {
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[i] = 0;
      }
      ++grp;
    }
    // the tile's last stage use: its products are done (wgmma_wait<0> of the
    // last group), so the producer may refill it for the next tile
    if (t == 0) mbar_arrive(&empty[(u - 1) % STAGES]);
    if constexpr (EPI == EPI_RAW) continue;
    if constexpr (EPI == EPI_BF16) {
      // the plain bf16 conv's roundings: the sum, then the sum + bias
      __nv_bfloat16* const out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        const float b0 = a.bias != nullptr ? bf16_round(a.bias[col]) : 0.f;
        const float b1 = a.bias != nullptr ? bf16_round(a.bias[col + 1]) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store2(out + (row0 + 8 * h) * Cout + col,
                 __fadd_rn(bf16_round(acc[4 * j + 2 * h]), b0),
                 __fadd_rn(bf16_round(acc[4 * j + 2 * h + 1]), b1));
      }
      continue;
    }

    // the branch's f, statistics and scale / bias rows (all at offset 0 for
    // one conv)
    const long bs = static_cast<long>(tc.br) * a.n * Cout;
    float* const fo = a.f + bs * HW;
    const float* const wsc = a.ws + static_cast<long>(tc.br) * a.sb_stride;
    const float* const bia = a.bias + static_cast<long>(tc.br) * a.sb_stride;
    // Both consumer warpgroups are done with the ring (one tile a block) or
    // with the previous tile's partial sums (PERSIST) before this tile
    // writes them.
    if (reduce) asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const float xsc = EPI == EPI_STATS && sizeof(T) == 1 ? a.xs[img] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      float v[2][2], s[2], sq[2], mx[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = bia[col + e];
        // the grouped sum already holds the input scales
        const float scale = GROUPED ? wsc[col + e]
                                    : (sizeof(T) == 1 ? __fmul_rn(xsc, wsc[col + e]) : 0.f);
        s[e] = 0.f;
        sq[e] = 0.f;
        mx[e] = -INFINITY;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          float x;
          if constexpr (GROUPED)
            x = __fadd_rn(__fmul_rn(fv[i], scale), b);
          else
            x = sizeof(T) == 1 ? __fadd_rn(__fmul_rn(static_cast<float>(acc[i]), scale), b)
                               : __fadd_rn(static_cast<float>(acc[i]), b);
          if (EPI == EPI_GRELU) x = fmaxf(x, 0.f);
          v[h][e] = x;
          s[e] = __fadd_rn(s[e], x);
          sq[e] = __fadd_rn(sq[e], __fmul_rn(x, x));
          mx[e] = fmaxf(mx[e], x);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (EPI == EPI_GRELU && !WANT_MAX)
          store2(static_cast<TO*>(a.out) + (row0 + 8 * h) * Cout + col, v[h][0], v[h][1]);
        else
          store2(fo + (row0 + 8 * h) * Cout + col, v[h][0], v[h][1]);
      }
      if (reduce) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            if (EPI != EPI_GRELU) {
              s[e] = __fadd_rn(s[e], __shfl_xor_sync(0xffffffffu, s[e], o));
              sq[e] = __fadd_rn(sq[e], __shfl_xor_sync(0xffffffffu, sq[e], o));
            }
            mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], o));
          }
          if (g == 0) {
            const int c = 8 * j + 2 * q + e;
            red[(cwarp * 3 + 0) * BN + c] = s[e];
            red[(cwarp * 3 + 1) * BN + c] = sq[e];
            red[(cwarp * 3 + 2) * BN + c] = mx[e];
          }
        }
      }
    }
    if (!reduce) continue;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int c = threadIdx.x - 128;
    if (c < BN) {
      float s = 0.f, sq = 0.f, m = -INFINITY;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        s = __fadd_rn(s, red[(w * 3 + 0) * BN + c]);
        sq = __fadd_rn(sq, red[(w * 3 + 1) * BN + c]);
        m = fmaxf(m, red[(w * 3 + 2) * BN + c]);
      }
      if (EPI == EPI_GRELU) {
        // the max of each (image, tile of a.ct channels); m >= 0 after the
        // ReLU, so its bits order like ints
        atomicMax(reinterpret_cast<int*>(a.st_max + static_cast<long>(img) * (Cout / a.ct) +
                                         (n0 + c) / a.ct),
                  __float_as_int(m));
      } else {
        const long o = bs + static_cast<long>(img) * Cout + n0 + c;
        if (sums) {
          atomicAdd(a.st_sum + o, s);
          atomicAdd(a.st_sq + o, sq);
        }
        if (WANT_MAX) atomic_max_float(a.st_max + o, m);
      }
    }
  }
}

// x (N, H, W, C) -> reflect-pad-1 (N, H+2, W+2, C), 16 bytes a thread.
template <typename T>
__global__ void reflect_pad_kernel(const T* __restrict__ x, T* __restrict__ xp,
                                   int n, int h, int w, int c) {
  const int vec = 16 / static_cast<int>(sizeof(T));
  const int cv = c / vec;
  const long total = static_cast<long>(n) * (h + 2) * (w + 2) * cv;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i % cv);
    long p = i / cv;
    const int xx = static_cast<int>(p % (w + 2));
    p /= w + 2;
    const int yy = static_cast<int>(p % (h + 2));
    const long im = p / (h + 2);
    const long src = ((im * h + reflect1(yy - 1, h)) * w + reflect1(xx - 1, w)) * c + k * vec;
    reinterpret_cast<uint4*>(xp)[i] = *reinterpret_cast<const uint4*>(x + src);
  }
}

template <typename T>
void launch_reflect_pad(const T* x, T* xp, int n, int h, int w, int c, cudaStream_t st) {
  const long total = static_cast<long>(n) * (h + 2) * (w + 2) * c * sizeof(T) / 16;
  const long blocks = (total + EW_THREADS - 1) / EW_THREADS;
  reflect_pad_kernel<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), EW_THREADS, 0,
                          st>>>(x, xp, n, h, w, c);
}

// Whether a conv takes wg_conv_kernel at K stages of kbytes bytes (see the
// note at the top); elem: bytes of one operand value; kk: 3 or 5 taps a
// side; groups: input groups, each Cin / groups wide, of which kbytes must
// divide.
bool wg_tile_ok(int n, int h, int w, int cin, int cout, int elem, int kk = 3,
                int groups = 1, int kbytes = WG_KBYTES) {
  const bool rows = (w <= WG_BM && WG_BM % w == 0) || w % WG_BM == 0;
  return n > 0 && h >= 2 && w >= 2 && rows && (h * w) % WG_BM == 0 &&
         (kk == 3 || kk == 5) && groups > 0 && cin % groups == 0 &&
         (cin / groups * elem) % kbytes == 0 && cout % 128 == 0;
}

// The K stage a conv takes: 128 bytes wherever wg_tile_ok holds at 128,
// else 64 where it holds at 64, else 0 (conv_s8_kernel).
int wg_kbytes(int n, int h, int w, int cin, int cout, int elem, int kk = 3,
              int groups = 1) {
  return wg_tile_ok(n, h, w, cin, cout, elem, kk, groups, 128)  ? 128
         : wg_tile_ok(n, h, w, cin, cout, elem, kk, groups, 64) ? 64
                                                                 : 0;
}

// BN 256 where Cout allows it and the grid keeps 2 blocks per SM, else 128.
int wg_bn(int n, int h, int w, int cout) {
  const long tiles = static_cast<long>(n) * h * w / WG_BM;
  return cout % 256 == 0 && tiles * (cout / 256) >= 2L * WG_SMS ? 256 : 128;
}

// The conv an ungrouped C -> C int8 3x3 (K1, K2, K7a and K1's RAW entry)
// takes: the BN of wg_bn, or 0 for conv_s8_kernel.
int wg_variant_s8(int n, int h, int w, int c) {
  return wg_tile_ok(n, h, w, c, c, 1) ? wg_bn(n, h, w, c) : 0;
}

// The BN of the grouped convs (K7b, K8 and their RAW entries): a consumer
// thread holds 64 int32 accumulators and 64 fp32 group sums at BN 128; BN
// 256 would need 256 registers for them alone.
constexpr int WG_BN_GROUPED = 128;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// One block per output tile, or (PERSIST) one per SM of the current
// device, each walking the tiles gridDim.x apart. a.h, a.w: the output's.
template <typename T, int BN, int EPI, bool WANT_MAX, int KK, typename TO, bool PERSIST,
          int KB, int STRIDE = 1>
cudaError_t wg_launch(const CUtensorMap& tx, const CUtensorMap& tw, const ConvArgs& a,
                      int padded, cudaStream_t st) {
  auto kern = wg_conv_kernel<T, BN, EPI, WANT_MAX, KK, TO, PERSIST, KB, STRIDE>;
  constexpr int smem = wg_smem_bytes<BN, PERSIST, KB>();
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  long blocks = static_cast<long>(a.n) * a.h * a.w / WG_BM * (a.branches * a.cout / BN);
  if (PERSIST) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (sms < blocks) blocks = sms;
  }
  kern<<<static_cast<unsigned>(blocks), WG_THREADS, smem, st>>>(tx, tw, a, padded);
  return cudaGetLastError();
}

// The KKxKK conv of `a` (n, h, w, cin, cout, groups, dil and the
// epilogue's pointers) on x and wk (Cout, KK*KK*Cin), BN output channels a
// block. padded: x is the reflect-padded (N, H+2, W+2, Cin) (KK 3,
// dilation 1); else x is (N, H, W, Cin) and the padding is zeros,
// (KK/2)*dil a side. a.branches > 1 (EPI_STATS): that many convs of x in
// one launch, wk (branches*Cout, KK*KK*Cin), at the dilations a.bdil.
// PERSIST: one block per SM walks the tiles (short K loops, K5). KB: the
// bytes of K a stage, 128 or 64. The shape meets wg_tile_ok at KB. Returns
// the launch's error, or cudaErrorInvalidValue where the arguments or a
// descriptor cannot be taken.
template <int BN, typename T, int EPI, bool WANT_MAX, int KK = 3, typename TO = float,
          bool PERSIST = false, int KB = WG_KBYTES>
cudaError_t launch_wg_conv_bn(const T* x, bool padded, const T* wk, const ConvArgs& a,
                              cudaStream_t st) {
  if (a.branches < 1 || a.branches > 4 || a.dil < 1 ||
      (padded && (a.dil != 1 || a.branches != 1)))
    return cudaErrorInvalidValue;
  if (a.branches > 1)
    for (int b = 0; b < a.branches; ++b)
      if (a.bdil[b] < 1) return cudaErrorInvalidValue;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorInvalidValue;
  const int es = static_cast<int>(sizeof(T)), ke = KB / es, p = KK / 2;
  const CUtensorMapSwizzle swz =
      KB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint32_t bxw = static_cast<cuuint32_t>(a.w < WG_BM ? a.w : WG_BM);
  const cuuint64_t wp = a.w + (padded ? 2 * p : 0), hp = a.h + (padded ? 2 * p : 0);
  const cuuint64_t c = a.cin, kc = static_cast<cuuint64_t>(KK * KK) * c;
  CUtensorMap tx, tw;
  const cuuint64_t xdim[4] = {c, wp, hp, static_cast<cuuint64_t>(a.n)};
  const cuuint64_t xstride[3] = {c * es, wp * c * es, hp * wp * c * es};
  const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(ke), bxw, WG_BM / bxw, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (enc(&tx, WgOperand<T>::tma, 4, const_cast<T*>(x), xdim, xstride, xbox, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {kc, static_cast<cuuint64_t>(a.branches) * a.cout};
  const cuuint64_t wstride[1] = {kc * es};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(ke), static_cast<cuuint32_t>(BN)};
  if (enc(&tw, WgOperand<T>::tma, 2, const_cast<T*>(wk), wdim, wstride, wbox, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return wg_launch<T, BN, EPI, WANT_MAX, KK, TO, PERSIST, KB>(tx, tw, a, padded ? 1 : 0, st);
}

// The 3x3 conv of the ungrouped callers (K1, K2, K3, K7a) at the BN of
// wg_bn.
template <typename T, int EPI, bool WANT_MAX, bool PERSIST = false>
cudaError_t launch_wg_conv(const T* x, bool padded, const T* wk, const ConvArgs& a,
                           cudaStream_t st) {
  constexpr bool P = PERSIST;
  return wg_bn(a.n, a.h, a.w, a.cout) == 256
             ? launch_wg_conv_bn<256, T, EPI, WANT_MAX, 3, float, P>(x, padded, wk, a, st)
             : launch_wg_conv_bn<128, T, EPI, WANT_MAX, 3, float, P>(x, padded, wk, a, st);
}

// ---------------------------------------------------------------------------
// K6's four branch convs (quant_pallas.py::_multi_atrous_stage_int8_kernel:
// four dilated zero-pad 3x3 convs of one input, each dequantized, IN +
// ReLU, summed), twice over the same products: EPI_BSTATS sums each
// branch's IN statistics, EPI_BSUM adds relu(IN f_b) in branch order. No
// f_b leaves the SM (as f_b, K5's route would move 537 MB at batch 32).
//
// wg_branch_kernel<EPI, TO>: persistent blocks of four warpgroups, a tile
// of 128 pixels x WB_BN channels, Cin = 64 int8 (one 64-byte K stage a
// tap), the tile's K loop the four branches x 9 taps:
//   * warpgroup 0, thread 0 (the producer): per tile, one TMA box of the
//     tile's input and a halo of a.hpad pixels a side (zeros outside the
//     image) into one of two buffers; per K stage, one bulk copy of its B
//     tile, pre-swizzled (branch_weights_kernel), into a ring of
//     WB_STAGES. A box a tap would read each input pixel 36 times over the
//     L2, in rows of 64 bytes.
//   * warpgroups 1 and 2 (64 rows each: one image row, W % 64 == 0):
//     wgmma m64n128k32 with A the tap's window of the halo, 64 consecutive
//     pixels (the swizzle follows the shared-memory address, so a window
//     may start at any pixel), and B the ring's stage. At a branch's last
//     stage they wait for its products, copy the int32 accumulators into
//     a 64 KB buffer and go on with the next branch.
//   * warpgroup 3, one thread a channel of the tile (the epilogue): the
//     flush of each branch from that buffer, f = acc * (xs * ws) + bias
//     (EPI_STATS's ops), then
//       EPI_BSTATS  the column's sum and sum of squares over the tile's
//                   128 pixels in order, into the (branch, image, channel)
//                   statistics with atomics;
//       EPI_BSUM    v += relu((f - mean) * rsig) into fp32 registers, in
//                   branch order (branch_sum_kernel's ops: given the same
//                   statistics, its output bit for bit), the tile's sum
//                   written once as TO.
//     A branch's flush runs while the tensor cores work on the next one:
//     in the MMA warpgroups it would stall them about as long as the
//     products take (a second register set there makes ptxas serialize
//     the wgmmas).
constexpr int WB_THREADS = 512;  // producer, 2 MMA warpgroups, epilogue warpgroup
constexpr int WB_BN = 128;       // output channels a tile
constexpr int WB_KB = 64;        // bytes of K a stage: Cin
constexpr int WB_STAGES = 8;     // B stages in the ring
constexpr int WB_EP = WG_BM + 4;  // words a column of the accumulator buffer

// The tile's input and its halo of hpad pixels a side: (cols + 2 hpad) x
// (rows + 2 hpad) pixels of WB_KB bytes (the tile is rows image rows of
// cols pixels). Bytes of the TMA box, and of a buffer (a multiple of 1 KB).
__host__ __device__ inline int wb_halo_box_bytes(int w, int hpad) {
  const int cols = w < WG_BM ? w : WG_BM;
  return (cols + 2 * hpad) * (WG_BM / cols + 2 * hpad) * WB_KB;
}
__host__ __device__ inline int wb_halo_stride(int w, int hpad) {
  return (wb_halo_box_bytes(w, hpad) + 1023) / 1024 * 1024;
}

// Dynamic shared memory of wg_branch_kernel: two halo buffers, the B ring,
// the accumulator buffer (WB_BN columns of WB_EP int32), 1 KB of alignment
// slack, the barriers.
inline int wb_smem_bytes(int w, int hpad) {
  return 2 * wb_halo_stride(w, hpad) + WB_STAGES * WB_BN * WB_KB + WB_BN * WB_EP * 4 + 1024 +
         (2 * WB_STAGES + 6) * 8;
}

// Whether wg_branch_kernel takes a shape with a halo of hpad pixels: Cin
// 64, each MMA warpgroup's 64 pixels in one image row (W % 64 == 0), the
// halo box at most 256 a side, the shared memory within a block's.
bool wb_shape_ok(int w, int cin, int hpad) {
  const int cols = w < WG_BM ? w : WG_BM;
  return cin == WB_KB && w % 64 == 0 && hpad >= 0 && cols + 2 * hpad <= 256 &&
         WG_BM / cols + 2 * hpad <= 256 && wb_smem_bytes(w, hpad) <= WG_SMEM_MAX;
}

// The accumulator buffer is column-major, a column WB_EP words apart: the
// epilogue thread of a column reads 4 rows a 16-byte load, and neither
// those loads nor the MMA threads' stores meet a bank conflict.

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// wk (branches*Cout, 9*64) int8 -> wbulk: the B tile of K stage kt (branch
// kt / 9, tap kt % 9) and column block nb at (kt * (Cout / WB_BN) + nb) *
// WB_BN * WB_KB, its WB_BN rows of 64 bytes in the swizzle TMA would write:
// 16-byte chunk c of row r at chunk c ^ ((r / 2) % 4). One thread a chunk.
__global__ void branch_weights_kernel(const int8_t* __restrict__ wk,
                                      int8_t* __restrict__ wbulk, int cout, long chunks) {
  constexpr int CPR = WB_KB / 16;  // chunks a row
  const int nbs = cout / WB_BN;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < chunks;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % CPR);
    const long row = i / CPR;
    const int rr = static_cast<int>(row % WB_BN);
    const long tile = row / WB_BN;
    const int nb = static_cast<int>(tile % nbs);
    const int kt = static_cast<int>(tile / nbs);
    const long src = (static_cast<long>(kt / 9) * cout + nb * WB_BN + rr) * 9 * WB_KB +
                     (kt % 9) * WB_KB + c * 16;
    *reinterpret_cast<uint4*>(wbulk + row * WB_KB + (c ^ ((rr >> 1) & 3)) * 16) =
        *reinterpret_cast<const uint4*>(wk + src);
  }
}

void launch_branch_weights(const int8_t* wk, int8_t* wbulk, int branches, int cout,
                           cudaStream_t st) {
  const long chunks = static_cast<long>(branches) * cout * 9 * WB_KB / 16;
  const long blocks = (chunks + EW_THREADS - 1) / EW_THREADS;
  branch_weights_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), EW_THREADS, 0,
                          st>>>(wk, wbulk, cout, chunks);
}

// tx: the input x (N, H, W, 64) int8, box (64, cols + 2 hpad, rows + 2
// hpad, 1) with 64-byte swizzle. `a`: n, h, w, cout, branches, bdil, hpad,
// xs, ws / bias (sb_stride apart a branch), wbulk; EPI_BSTATS st_sum /
// st_sq, EPI_BSUM mean / rsig and out.
template <int EPI, typename TO>
__global__ void __launch_bounds__(WB_THREADS, 1)
    wg_branch_kernel(const __grid_constant__ CUtensorMap tx, const ConvArgs a) {
  constexpr int NA = WB_BN / 2, B_BYTES = WB_BN * WB_KB, STAGES = WB_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int hstride = wb_halo_stride(a.w, a.hpad);
  uint8_t* halo = smem;  // two buffers
  uint8_t* sb = smem + 2 * hstride;
  int* ebuf = reinterpret_cast<int*>(sb + STAGES * B_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(ebuf + WB_BN * WB_EP);
  uint64_t* empty = full + STAGES;
  uint64_t* hfull = empty + STAGES;  // a halo buffer loaded / done with
  uint64_t* hempty = hfull + 2;
  uint64_t* efull = hempty + 2;      // the accumulator buffer written / read
  uint64_t* eempty = efull + 1;

  const int Cout = a.cout, KT = a.branches * 9;
  const int mtiles = static_cast<int>(static_cast<long>(a.n) * a.h * a.w / WG_BM);
  const int tiles = mtiles * (Cout / WB_BN);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per MMA warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&hfull[b], 1);
      mbar_init(&hempty[b], 2);
    }
    mbar_init(efull, 256);  // every MMA thread
    mbar_init(eempty, 128);  // every epilogue thread
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage use u (over all tiles of this block) is ring slot u % STAGES in
  // its phase u / STAGES; tile it of the block uses halo buffer it % 2 in
  // its phase it / 2; e, the block's branch-tiles, the accumulator
  // buffer's phases.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      // tile it's halo into buffer it % 2, once tile it - 2 is done with it
      const auto load_halo = [&](int tile, int it) {
        const WgTile tc = wg_tile(a, tile, mtiles, WB_BN, 3, 0);
        const int hb = it & 1;
        if (it >= 2) mbar_wait(&hempty[hb], ((it >> 1) - 1) & 1);
        mbar_expect_tx(&hfull[hb], wb_halo_box_bytes(a.w, a.hpad));
        tma_load_4d(halo + hb * hstride, &tx, &hfull[hb], 0, tc.x0 - a.hpad, tc.y0 - a.hpad,
                    tc.img);
      };
      if (blockIdx.x < tiles) load_halo(blockIdx.x, 0);
      // the stage at which the next tile's halo is asked for: the ring's
      // depth into this tile, so the MMA warpgroups are done with the
      // previous tile and its buffer, and a few branches ahead of its use
      const int hk = KT > STAGES + 1 ? STAGES + 1 : KT - 1;
      for (int tile = blockIdx.x, u = 0, it = 0; tile < tiles; tile += gridDim.x, ++it) {
        const WgTile tc = wg_tile(a, tile, mtiles, WB_BN, 3, 0);
        for (int kt = 0; kt < KT; ++kt, ++u) {
          if (kt == hk && tile + gridDim.x < tiles) load_halo(tile + gridDim.x, it + 1);
          const int s = u % STAGES;
          if (u >= STAGES) mbar_wait(&empty[s], ((u / STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], B_BYTES);
          bulk_load(sb + s * B_BYTES,
                    a.wbulk + (static_cast<long>(kt) * (Cout / WB_BN) + tc.n0 / WB_BN) * B_BYTES,
                    B_BYTES, &full[s]);
        }
      }
    }
    return;
  }

  if (wg == 3) {
    // the epilogue: thread t is column t of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
    float fv[EPI == EPI_BSUM ? WG_BM : 1];  // the tile's branch sum, one a row
    for (int tile = blockIdx.x, e = 0; tile < tiles; tile += gridDim.x) {
      const WgTile tc = wg_tile(a, tile, mtiles, WB_BN, 3, 0);
      const float xs = a.xs[tc.img];
      if constexpr (EPI == EPI_BSUM) {
#pragma unroll
        for (int r = 0; r < WG_BM; ++r) fv[r] = 0.f;
      }
      for (int br = 0; br < a.branches; ++br, ++e) {
        const long sbo = static_cast<long>(br) * a.sb_stride + tc.n0 + t;
        const float scale = __fmul_rn(xs, a.ws[sbo]), b = a.bias[sbo];
        const long so = (static_cast<long>(br) * a.n + tc.img) * Cout + tc.n0 + t;
        const float mu = EPI == EPI_BSUM ? a.mean[so] : 0.f;
        const float rs = EPI == EPI_BSUM ? a.rsig[so] : 0.f;
        mbar_wait(efull, e & 1);
        float sm = 0.f, sq = 0.f;
        const int4* col = reinterpret_cast<const int4*>(ebuf + t * WB_EP);
#pragma unroll
        for (int r4 = 0; r4 < WG_BM / 4; ++r4) {
          const int4 v4 = col[r4];
          const int v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = __fadd_rn(__fmul_rn(static_cast<float>(v[i]), scale), b);
            if constexpr (EPI == EPI_BSTATS) {
              sm = __fadd_rn(sm, x);
              sq = __fadd_rn(sq, __fmul_rn(x, x));
            } else {
              const int r = 4 * r4 + i;
              fv[r] = __fadd_rn(fv[r], fmaxf(__fmul_rn(__fsub_rn(x, mu), rs), 0.f));
            }
          }
        }
        mbar_arrive(eempty);
        if constexpr (EPI == EPI_BSTATS) {
          atomicAdd(a.st_sum + so, sm);
          atomicAdd(a.st_sq + so, sq);
        }
      }
      if constexpr (EPI == EPI_BSUM) {
        TO* const out = static_cast<TO*>(a.out) + tc.m0 * Cout + tc.n0 + t;
#pragma unroll
        for (int r = 0; r < WG_BM; ++r) store1(out + static_cast<long>(r) * Cout, fv[r]);
      }
    }
    return;
  }

  // the MMA warpgroups: rows cw*64 .. cw*64+63 of the tile, one image row
  // from (prow, pcol) of the tile; its halo rows hold hcols pixels
  asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n");
  const int cw = wg - 1;
  const int cols = a.w < WG_BM ? a.w : WG_BM, hcols = cols + 2 * a.hpad;
  const int prow = cw * 64 / cols, pcol = cw * 64 % cols;
  // Accumulator i of thread t: n8 block j = i / 4, row 16 * (t / 32) +
  // (t % 32) / 4 + 8 * ((i / 2) % 2), column 8 * j + 2 * (t % 4) + i % 2.
  const int g = (t & 31) >> 2, q = t & 3;
  const int r0 = cw * 64 + (t >> 5) * 16 + g;  // and r0 + 8
  int acc[NA];
  for (int tile = blockIdx.x, u = 0, it = 0, e = 0; tile < tiles; tile += gridDim.x, ++it) {
    const uint8_t* const hb = halo + (it & 1) * hstride;
    mbar_wait(&hfull[it & 1], (it >> 1) & 1);
    for (int br = 0; br < a.branches; ++br, ++e) {
      const int dil = branch_dil(a, br);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0;
      for (int k = 0; k < 9; ++k, ++u) {
        const int s = u % STAGES;
        mbar_wait(&full[s], (u / STAGES) & 1);
        const int hy = prow + (k / 3 - 1) * dil + a.hpad, hx = pcol + (k % 3 - 1) * dil + a.hpad;
        const uint64_t da = sw_desc<WB_KB>(hb + (hy * hcols + hx) * WB_KB);
        const uint64_t db = sw_desc<WB_KB>(sb + s * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WB_KB / 32; ++kk) wg_mma<WB_BN>(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        // the previous stage's products are done: release it (each stage
        // use once: here, or the branch's last below)
        wgmma_wait<1>();
        if (k > 0 && t == 0) mbar_arrive(&empty[(u - 1) % STAGES]);
      }
      wgmma_wait<0>();
      if (t == 0) {
        mbar_arrive(&empty[(u - 1) % STAGES]);
        if (br == a.branches - 1) mbar_arrive(&hempty[it & 1]);  // done with the halo
      }
#pragma unroll
      for (int i = 0; i < NA; ++i) reg_fence(acc[i]);
      // hand the branch's accumulators to the epilogue, once it has read
      // the previous branch's
      if (e > 0) mbar_wait(eempty, (e - 1) & 1);
#pragma unroll
      for (int j = 0; j < WB_BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int* const p = ebuf + (8 * j + 2 * q) * WB_EP + r0 + 8 * h;
          p[0] = acc[4 * j + 2 * h];
          p[WB_EP] = acc[4 * j + 2 * h + 1];
        }
      mbar_arrive(efull);
    }
  }
}

// K6's passes on x (N, H, W, 64) int8 (see wg_branch_kernel): one block per
// SM. `a` as the kernel takes it; the shape meets wb_shape_ok and every
// bdil is at most a.hpad. Returns the launch's error, or
// cudaErrorInvalidValue where the arguments or the descriptor cannot be
// taken.
template <int EPI, typename TO>
cudaError_t launch_wg_branches(const int8_t* x, const ConvArgs& a, cudaStream_t st) {
  static_assert(EPI == EPI_BSTATS || EPI == EPI_BSUM, "K6's passes");
  bool ok = a.branches >= 1 && a.branches <= 4 && a.wbulk != nullptr && a.cout % WB_BN == 0 &&
            (static_cast<long>(a.n) * a.h * a.w) % WG_BM == 0 && a.h * a.w % WG_BM == 0 &&
            wb_shape_ok(a.w, a.cin, a.hpad) &&
            (a.w <= WG_BM ? WG_BM % a.w == 0 : a.w % WG_BM == 0);
  for (int b = 0; b < a.branches; ++b) ok = ok && a.bdil[b] >= 1 && a.bdil[b] <= a.hpad;
  EncodeTiledFn enc = encode_tiled();
  if (!ok || enc == nullptr) return cudaErrorInvalidValue;
  const cuuint32_t cols = static_cast<cuuint32_t>(a.w < WG_BM ? a.w : WG_BM);
  const cuuint32_t hp2 = static_cast<cuuint32_t>(2 * a.hpad);
  const cuuint64_t c = WB_KB, w = a.w, h = a.h;
  const cuuint64_t xdim[4] = {c, w, h, static_cast<cuuint64_t>(a.n)};
  const cuuint64_t xstride[3] = {c, w * c, h * w * c};
  const cuuint32_t xbox[4] = {WB_KB, cols + hp2, WG_BM / cols + hp2, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap tx;
  if (enc(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x), xdim, xstride, xbox,
          ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kern = wg_branch_kernel<EPI, TO>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  // SMs of each device, asked once (K6's calls are short: host time counts)
  static int sms_of[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return cudaErrorInvalidValue;
  if (sms_of[dev] == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int sms = sms_of[dev];
  const long tiles = static_cast<long>(a.n) * a.h * a.w / WG_BM * (a.cout / WB_BN);
  kern<<<static_cast<unsigned>(tiles < sms ? tiles : sms), WB_THREADS,
         wb_smem_bytes(a.w, a.hpad), st>>>(tx, a);
  return cudaGetLastError();
}

}  // namespace
