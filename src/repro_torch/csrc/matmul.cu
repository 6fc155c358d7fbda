// Blocked GEMM for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N].
//
// Replaces the TPU kernel repro/kernels/matmul.py:matmul (_matmul_kernel):
// the same (m, n) output blocks and the same walk over k, with the
// accumulator resident across k and written once at the end.  On the TPU
// the k walk is the sequential third grid axis; Hopper blocks run in no
// order, so here it is a loop inside the block.
//
// Block geometry: (block_m, block_n, block_k) come from the Covenant tiler
// against the h100 covenant (kernels/tiling.py gemm_blocks); block_m x
// block_n sets the launch grid.
//
// Bound on the H100: at the prefill and train shapes (2048..4096 x
// 1024..151936 x 1024..3072) the work is 2*M*N*K operations against
// (M*K + K*N)*in_bytes + M*N*4 bytes, far above the 295 operations per byte
// where the bf16 tensor cores, and not memory, bound it; decode (M = 4) is
// bound by reading B.
//
// bf16 -> f32 runs on the tensor cores (gemm_wgmma_kernel):
// * one consumer warpgroup per 64-row slab of the block (at most four), each
//   issuing wgmma.mma_async m64nNk16 with both operands in shared memory and
//   its (64, N) f32 accumulator in registers across the whole k walk.  A is
//   [M, K] row-major (K-major); B is [K, N] row-major, which wgmma reads
//   MN-major through its transpose bit, so no transposed copy is made;
// * one producer warp keeps TMA loads (cp.async.bulk.tensor) in flight into
//   a ring of stages, each a k slab of A (64 x 64 boxes, 128-byte swizzle)
//   and of B (boxes 16, 32 or 64 columns wide, the widest swizzle that
//   divides N), with an mbarrier per stage for arrival and one for release;
//   gemm_stages in tiling.py sizes the ring from the tiler's blocks;
// * TMA fills a box past the matrix with zeros, and the epilogue masks its
//   stores, so ragged M, N and K need no padding: only K and N must be
//   multiples of 8 (TMA's 16-byte row stride).  A block of M < 64 rows runs
//   the 64-row instruction on zero rows; such decode GEMMs are bound by
//   streaming B, which the blocks' TMA boxes do in 16-byte-aligned rows.
// The grid walks M fastest, so the blocks in flight share B's columns (read
// from memory once) and A, small beside B at these shapes, stays in L2.
//
// f32 -> f32 and s8 -> s32 stay on the SIMT lanes (matmul_kernel), with a
// register micro-tile per thread (tm x tn outputs, tm + tn shared-memory
// reads per tm*tn FMAs): f32 in true IEEE f32 (no TF32) and s8 exact, which
// no tensor-core type gives.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kMaxStages = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed; traps (a launch
// failure the wrapper reports) rather than hang if it never does, as after a
// TMA load the hardware refused
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma that owns it
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B,
// 3 = 32 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// D[64, N] += A[64, 16] B[16, N], bf16 -> f32; A K-major, B MN-major
// (imm-trans-b = 1).  One specialisation per instruction N the kernel is
// built for (tiling.WGMMA_N).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24],
                                             uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48],
                                             uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(float (&d)[96],
                                             uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128],
                                             uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
  }
};

// W: the width in columns of one B box and swizzle atom (64, 32 or 16 bf16,
// 128-, 64- or 32-byte rows): the widest that divides N
template <int N>
__host__ __device__ constexpr int b_box_cols() {
  return N % 64 == 0 ? 64 : (N % 32 == 0 ? 32 : 16);
}

// BN: the instruction N (>= block_n); NC: consumer warpgroups, one per
// 64-row slab (rows_a = 64 * NC >= block_m).  Warps 0..4*NC-1 consume, warp
// 4*NC produces.
template <int BN, int NC>
__global__ void __launch_bounds__(NC * 128 + 32)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  float* __restrict__ c, int m, int n, int k, int bm, int bn,
                  int stage_k, int stages) {
  constexpr int W = b_box_cols<BN>();
  constexpr int kRowsA = 64 * NC;
  constexpr uint64_t kSwizzleB = W == 64 ? 1 : (W == 32 ? 2 : 3);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_bytes = static_cast<uint32_t>(stage_k) * kRowsA * 2;
  const uint32_t stage_bytes = a_bytes + static_cast<uint32_t>(stage_k) * BN * 2;
  const uint32_t full = ring + stages * stage_bytes;  // stages x 8 bytes
  const uint32_t empty = full + 8 * stages;           // stages x 8 bytes

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * bm;
  const int n0 = blockIdx.y * bn;
  const int ktiles = (k + stage_k - 1) / stage_k;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // producer: one thread issues every stage's boxes
    if (lane != 0) return;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % stages;
      if (kt >= stages) mbar_wait(empty + 8 * s, ((kt / stages) + 1) & 1);
      const uint32_t bar = full + 8 * s;
      const uint32_t a_dst = ring + s * stage_bytes;
      const uint32_t b_dst = a_dst + a_bytes;
      const int k0 = kt * stage_k;
      mbar_expect_tx(bar, stage_bytes);
      for (int kb = 0; kb < stage_k / 64; ++kb)
        tma_load_2d(a_dst + kb * kRowsA * 128, &map_a, bar, k0 + kb * 64, m0);
#pragma unroll
      for (int cb = 0; cb < BN / W; ++cb)
        tma_load_2d(b_dst + cb * stage_k * W * 2, &map_b, bar, n0 + cb * W, k0);
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the block
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int ksteps = stage_k / 16;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % stages;
    mbar_wait(full + 8 * s, (kt / stages) & 1);
    const uint32_t a_base = ring + s * stage_bytes + wg * 64 * 128;
    const uint32_t b_base = ring + s * stage_bytes + a_bytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    fence_operands(acc);
    for (int kk = 0; kk < ksteps; ++kk) {
      // A: a 128-byte swizzled box per 64 k, 8-row groups 1024 bytes apart;
      // a k16 step moves 32 bytes along the row
      const uint64_t da = make_desc(a_base + (kk >> 2) * kRowsA * 128 +
                                        (kk & 3) * 32, 16, 1024, 1);
      // B: 16 k rows of W columns each; column boxes stage_k rows apart
      const uint64_t db = make_desc(b_base + kk * 16 * W * 2,
                                    stage_k * W * 2, 8 * W * 2, kSwizzleB);
      Wgmma<BN>::mma(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * s);
  }

  // epilogue: thread (warp w, lane) holds rows 16 w + lane / 4 (+ 8) and
  // columns 8 j + 2 (lane % 4) (+ 1) of its warpgroup's slab
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cc = j * 8 + col;
    if (cc >= bn || n0 + cc >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= bm || m0 + r >= m) continue;
      *reinterpret_cast<float2*>(c + static_cast<size_t>(m0 + r) * n + n0 + cc) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime
// (cudaGetDriverEntryPoint), so the library needs no link against libcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 2D bf16 tensor map over a row-major [rows, cols] matrix, boxes of
// box_rows x box_cols, swizzled by box_cols * 2 bytes
bool encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
               int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : (box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// built only where the block's accumulators, 64 NC x BN f32, fit the
// covenant's RF node of 64 KB (tiling.gemm_fits), as the tiler's blocks do:
// larger ones leave a thread too few registers for its share
template <int BN, int NC>
int launch_wgmma(const void* a, const void* b, void* c, int m, int n, int k,
                 int bm, int bn, int stage_k, int stages, cudaStream_t stream) {
  if constexpr (NC * BN > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr int W = b_box_cols<BN>();
    CUtensorMap map_a, map_b;
    if (!encode_2d(&map_a, a, m, k, 64 * NC, 64) ||
        !encode_2d(&map_b, b, k, n, stage_k, W))
      return static_cast<int>(cudaErrorInvalidValue);
    const int stage_bytes = stage_k * (64 * NC + BN) * 2;
    const int smem = stages * stage_bytes + 1024 + 16 * stages;
    auto kernel = gemm_wgmma_kernel<BN, NC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((m + bm - 1) / bm, (n + bn - 1) / bn);
    kernel<<<grid, NC * 128 + 32, smem, stream>>>(
        map_a, map_b, static_cast<float*>(c), m, n, k, bm, bn, stage_k, stages);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int BN>
int launch_nc(const void* a, const void* b, void* c, int m, int n, int k,
              int bm, int bn, int stage_k, int stages, cudaStream_t s) {
  switch ((bm + 63) / 64) {
    case 1: return launch_wgmma<BN, 1>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
    case 2: return launch_wgmma<BN, 2>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
    case 3: return launch_wgmma<BN, 3>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
    case 4: return launch_wgmma<BN, 4>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the smallest instruction N the kernel is built for that covers block_n
int launch_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                int bm, int bn, int stage_k, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 1 || bm < 1 || bn < 1 || n % 8 != 0 ||
      k % 8 != 0 || stage_k < 64 || stage_k > 256 || stage_k % 64 != 0 ||
      stages < 2 || stages > kMaxStages ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c) % 8 != 0 || (n + bn - 1) / bn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn <= 16) return launch_nc<16>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
  if (bn <= 32) return launch_nc<32>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
  if (bn <= 48) return launch_nc<48>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
  if (bn <= 64) return launch_nc<64>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
  if (bn <= 96) return launch_nc<96>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
  if (bn <= 128) return launch_nc<128>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
  if (bn <= 192) return launch_nc<192>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
  if (bn <= 256) return launch_nc<256>(a, b, c, m, n, k, bm, bn, stage_k, stages, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// f32 and s8: SIMT lanes
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ int32_t to_acc(int8_t x) { return static_cast<int32_t>(x); }

// T: input type; Acc: accumulator and output type; MaxTm x MaxTn:
// compile-time bounds of the per-thread micro-tile (tm x tn at run time).
template <typename T, typename Acc, int MaxTm, int MaxTn>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              Acc* __restrict__ c, int n_cols, int k_dim,
              int bm, int bn, int bk, int tm, int tn, int txc, int tyc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // pad each shared row by 4 bytes so rows fall on different banks
  const int pad = 4 / static_cast<int>(sizeof(T));
  const int lda = bk + pad;
  const int ldb = bn + pad;
  T* as = reinterpret_cast<T*>(smem_raw);
  T* bs = as + bm * lda;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tx = tid % txc;
  const int ty = tid / txc;
  const bool active = ty < tyc;
  const int m0 = blockIdx.y * bm;
  const int n0 = blockIdx.x * bn;

  Acc acc[MaxTm][MaxTn];
#pragma unroll
  for (int i = 0; i < MaxTm; ++i)
#pragma unroll
    for (int j = 0; j < MaxTn; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < k_dim; k0 += bk) {
    for (int idx = tid; idx < bm * bk; idx += nthreads) {
      const int r = idx / bk;
      const int kk = idx - r * bk;
      as[r * lda + kk] = a[static_cast<size_t>(m0 + r) * k_dim + k0 + kk];
    }
    for (int idx = tid; idx < bk * bn; idx += nthreads) {
      const int kk = idx / bn;
      const int cc = idx - kk * bn;
      bs[kk * ldb + cc] = b[static_cast<size_t>(k0 + kk) * n_cols + n0 + cc];
    }
    __syncthreads();
    if (active) {
      for (int kk = 0; kk < bk; ++kk) {
        Acc av[MaxTm];
        Acc bv[MaxTn];
#pragma unroll
        for (int i = 0; i < MaxTm; ++i) {
          const int r = ty + i * tyc;
          av[i] = (i < tm && r < bm) ? to_acc(as[r * lda + kk]) : Acc(0);
        }
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) {
          const int cc = tx + j * txc;
          bv[j] = (j < tn && cc < bn) ? to_acc(bs[kk * ldb + cc]) : Acc(0);
        }
#pragma unroll
        for (int i = 0; i < MaxTm; ++i)
#pragma unroll
          for (int j = 0; j < MaxTn; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < MaxTm; ++i) {
    const int r = ty + i * tyc;
    if (i >= tm || r >= bm) continue;
#pragma unroll
    for (int j = 0; j < MaxTn; ++j) {
      const int cc = tx + j * txc;
      if (j < tn && cc < bn)
        c[static_cast<size_t>(m0 + r) * n_cols + n0 + cc] = acc[i][j];
    }
  }
}

template <typename T, typename Acc, int MaxTm, int MaxTn>
int launch_tile(const void* a, const void* b, void* c, int m, int n, int k,
                int bm, int bn, int bk, int tm, int tn, int txc, int tyc,
                int smem_bytes, cudaStream_t stream) {
  auto kernel = matmul_kernel<T, Acc, MaxTm, MaxTn>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n / bn, m / bm);
  kernel<<<grid, txc * tyc, smem_bytes, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<Acc*>(c),
      n, k, bm, bn, bk, tm, tn, txc, tyc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc, int MaxTm>
int launch_tm(const void* a, const void* b, void* c, int m, int n, int k,
              int bm, int bn, int bk, int tm, int tn, int txc, int tyc,
              int smem_bytes, cudaStream_t s) {
  if (tn <= 4)
    return launch_tile<T, Acc, MaxTm, 4>(a, b, c, m, n, k, bm, bn, bk, tm, tn,
                                         txc, tyc, smem_bytes, s);
  if (tn <= 8)
    return launch_tile<T, Acc, MaxTm, 8>(a, b, c, m, n, k, bm, bn, bk, tm, tn,
                                         txc, tyc, smem_bytes, s);
  return launch_tile<T, Acc, MaxTm, 16>(a, b, c, m, n, k, bm, bn, bk, tm, tn,
                                        txc, tyc, smem_bytes, s);
}

template <typename T, typename Acc>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           int bm, int bn, int bk, int tm, int tn, int txc, int tyc,
           int smem_bytes, void* stream) {
  if (tm < 1 || tm > 8 || tn < 1 || tn > 16 || txc < 1 || tyc < 1 ||
      txc * tyc > kThreads || m % bm != 0 || n % bn != 0 || k % bk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm <= 1)
    return launch_tm<T, Acc, 1>(a, b, c, m, n, k, bm, bn, bk, tm, tn, txc, tyc,
                                smem_bytes, s);
  if (tm <= 2)
    return launch_tm<T, Acc, 2>(a, b, c, m, n, k, bm, bn, bk, tm, tn, txc, tyc,
                                smem_bytes, s);
  if (tm <= 4)
    return launch_tm<T, Acc, 4>(a, b, c, m, n, k, bm, bn, bk, tm, tn, txc, tyc,
                                smem_bytes, s);
  return launch_tm<T, Acc, 8>(a, b, c, m, n, k, bm, bn, bk, tm, tn, txc, tyc,
                              smem_bytes, s);
}

}  // namespace

#define MATMUL_ENTRY(NAME, T, ACC)                                             \
  extern "C" int NAME(const void* a, const void* b, void* c, int m, int n,    \
                      int k, int bm, int bn, int bk, int tm, int tn, int txc,  \
                      int tyc, int smem_bytes, void* stream) {                 \
    return launch<T, ACC>(a, b, c, m, n, k, bm, bn, bk, tm, tn, txc, tyc,      \
                          smem_bytes, stream);                                 \
  }

MATMUL_ENTRY(covenant_matmul_f32, float, float)
MATMUL_ENTRY(covenant_matmul_i8, int8_t, int32_t)

extern "C" int covenant_matmul_bf16(const void* a, const void* b, void* c,
                                    int m, int n, int k, int bm, int bn,
                                    int stage_k, int stages, void* stream) {
  return launch_bf16(a, b, c, m, n, k, bm, bn, stage_k, stages, stream);
}

extern "C" const char* covenant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
