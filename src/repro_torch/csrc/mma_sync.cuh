// Helpers shared by the kernels that stage bf16 tiles with cp.async and
// multiply them with mma.sync on Hopper's tensor cores (flash_attention.cu,
// flash_attention_bwd.cu, ssd_scan.cu) or stream tiles through a cp.async
// ring (flash_decode.cu).  kernels/_build.py hashes this header with each source
// that builds, so an edited header rebuilds every library.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): a warp's 16 x 8 f32
// accumulator c[0..3] holds rows lane / 4 (c[0], c[1]) and lane / 4 + 8
// (c[2], c[3]), columns 2 (lane % 4) and + 1.  The A operand (16 x 16) is
// four registers of two bf16 each in the same row pattern, k columns
// 2 (lane % 4) (+1) in a[0], a[1] and + 8 in a[2], a[3].  So the C
// fragments of two neighbouring 8-column tiles, rounded to bf16 and packed
// in pairs, are the A fragment of a 16-deep k step (a_from_c).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;                 // bf16 elements of padding a row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared; zeros where `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes from global to shared; zero where `valid` is false
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment of k step kp from the C fragments c of a 16-row tile:
// columns 16 kp .. 16 kp + 15 are its 8-column tiles 2 kp and 2 kp + 1.
template <int NT>
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4],
                                         const float (&c)[NT][4], int kp) {
  a[0] = pack_bf16(c[2 * kp][0], c[2 * kp][1]);
  a[1] = pack_bf16(c[2 * kp][2], c[2 * kp][3]);
  a[2] = pack_bf16(c[2 * kp + 1][0], c[2 * kp + 1][1]);
  a[3] = pack_bf16(c[2 * kp + 1][2], c[2 * kp + 1][3]);
}

// The same, split into two bf16 parts hi + lo with hi + lo = c to about
// 2^-17 relative: lo is what rounding c to bf16 left out, rounded in turn.
template <int NT>
__device__ __forceinline__ void a_split2_from_c(uint32_t (&hi)[4],
                                                uint32_t (&lo)[4],
                                                const float (&c)[NT][4],
                                                int kp) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 2 * kp + (r >> 1);
    const int e = 2 * (r & 1);
    const float x0 = c[j][e], x1 = c[j][e + 1];
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi[r] = *reinterpret_cast<uint32_t*>(&h);
    lo[r] = pack_bf16(x0 - hf.x, x1 - hf.y);
  }
}

// The same, split into three bf16 parts hi + mid + lo with hi + mid + lo
// = c to about 2^-25 relative, an f32's precision: mid is what rounding c
// to bf16 left out, rounded in turn, and lo what that left out (each
// remainder is exact in f32).
template <int NT>
__device__ __forceinline__ void a_split3_from_c(uint32_t (&hi)[4],
                                                uint32_t (&mid)[4],
                                                uint32_t (&lo)[4],
                                                const float (&c)[NT][4],
                                                int kp) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 2 * kp + (r >> 1);
    const int e = 2 * (r & 1);
    const float x0 = c[j][e], x1 = c[j][e + 1];
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const float r0 = x0 - hf.x, r1 = x1 - hf.y;
    __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(m);
    hi[r] = *reinterpret_cast<uint32_t*>(&h);
    mid[r] = *reinterpret_cast<uint32_t*>(&m);
    lo[r] = pack_bf16(r0 - mf.x, r1 - mf.y);
  }
}

}  // namespace
