// Flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/flash_attention.py:
// flash_attention_bwd (_fa_bwd_dq_kernel and _fa_bwd_dkv_kernel): the
// flash-recompute backward.  From q, k, v, dout, the forward's per-row
// log-sum-exp `lse` and delta = rowsum(dout * out), each kv block
// recomputes P = exp(s * scale - lse) under the causal / window / edge masks,
// dP = dout v^T and dS = P (dP - delta) scale, and accumulates
//   dq += dS k        (dq pass, one block per (q block, batch*q head)),
//   dv += P^T dout, dk += dS^T q
//                     (dkv pass, one block per (kv block, batch*kv head)).
// P is selected with the mask, never multiplied by it: a fully masked row
// has lse = -1e30, where exp(s - lse) overflows and inf * 0 would be NaN.
//
// On the TPU the sequential last grid axis walks the other operand's blocks
// with the f32 accumulator in VMEM scratch; Hopper blocks run in no order,
// so each walk is a loop inside one block and the accumulators live in
// registers.  The dkv pass walks the q blocks of every q head that reads
// its kv head (grouped-query attention, q head h reads kv head h / group),
// so dk and dv come out summed over the group with no repeated k/v and no
// atomics, and the result is the same on every run; the reference has no
// GQA at kernel level.  Ragged q and kv edges are masked here, so nothing
// is padded, and blocks that the causal or window mask hides completely are
// skipped.  All accumulation is f32; dq, dk and dv are written in the input
// type.
//
// Bound on the H100: five GEMM-shaped products (S, dP, dq, dk, dv), that is
// 10*B*Hq*Sq*Sk*D operations (halved by a causal mask), against reading
// q, k, v, out, dout and lse once and writing dq, dk, dv once; at the qwen3
// training shape (B=4, Hq=16, Hkv=8, S=512, D=128) the bf16 tensor cores
// bound it.
//
// bf16 runs on the tensor cores (fa_bwd_dq_mma_kernel, fa_bwd_dkv_mma_kernel),
// FA2-style, mma.sync m16n8k16 bf16 -> f32.  Each warp owns 16 rows of its
// block (q rows in the dq pass, kv rows in the dkv pass) and keeps its
// accumulator in f32 registers.  The dkv pass computes S^T = K Q^T and
// dP^T = V dO^T, so that P^T and dS^T come out in the C fragments of the
// warp's own kv rows and feed dV += P^T dO and dK += dS^T Q from registers,
// as the forward feeds P V (mma_sync.cuh): no P or dS tile goes through
// shared memory.  It walks its q tiles twice, for dV and then for dK, so a
// warp holds one 16 x D accumulator at a time (at D128 the pair, 128
// registers a thread, left ptxas spilling at the 255 a thread may hold); the
// second walk recomputes S^T, one product more.  The walked operand (K and V
// in the dq pass; Q, dO, lse and delta in the dkv pass) is staged in bf16 by
// cp.async in 16-byte vectors, double-buffered, rows padded by 8 for
// ldmatrix; Q and dO are read as B operands by ldmatrix (plain for S^T and
// dP^T, transposed for dV and dK) rather than held, and a warp takes the
// walked tile 32 columns at a time (tiling.flash_bwd_mma_regs).  The dq
// pass's prologue computes delta of its rows from dout and out and writes
// it to memory; the dkv pass, a later launch, reads it there.
//
// Exactness.  The plain version rounds its f32 results to bf16 as this
// kernel does, and at qwen3's training shape (unit-normal inputs) dv
// reaches 8, where one bf16 ulp is 0.031, past the bf16 bound of 2e-2: an
// output there must round to the same bf16 value as the plain version's.
// So the operands and the sums are kept close to exact, in three steps:
// - P and dS enter the products as three bf16 parts hi + mid + lo, an
//   f32's 24 bits (mma_sync.cuh, a_split3_from_c), six products more than
//   one rounding; with two parts (2^-17) a tenth of a percent more outputs
//   rounded to another bf16 value than with an exact operand
//   (launch/attn_probes.py simulate).
// - Each 16-deep k step's three products go into a fragment from zero and
//   are added to the accumulator in f32 (mma_split3_rows): the tensor
//   cores' accumulation does not round to nearest, and along the whole
//   chain its error grew with the chain's length.
// - The dV walk adds those chunks with a compensated add (add_compensated):
//   64 round-to-nearest adds still moved a dv near 5 by two f32 ulps,
//   which once put it on the other side of a bf16 rounding midpoint than
//   the plain version's and float64's (chip_smoke.py's D64 case, 0.031).
//   The dK walk adds plainly.  At paligemma's group 8 (8 q heads over one
//   kv head of 256) it adds 256 chunks and dk reaches 4 as often as dv,
//   but plain adds put dk on the other side of a rounding midpoint about
//   as often as the plain f32 version's own sums do (launch/attn_probes.py
//   simulate: 0.006 and 0.005 expected a check), so the gate's residual
//   risk is the plain version's either way; and on the H100 a compensated
//   dK walk cost 13 % at D128 (qwen3's train shape, 0.332 -> 0.376 ms) and
//   left the D256 dkv pass at 255 registers with 280 bytes spilled.  dq
//   sums one head's kv walk and seldom reaches 4; its pass adds plainly.
// Measured on the H100 (launch/attn_probes.py bwd): over seeded draws at
// D128 and D64 no output of 2 or more rounds to another bf16 value than
// float64 arithmetic gives.  Block sizes come from
// tiling.attention_bwd_mma_blocks; head dims 16, 32, 64, 128, 160 (zamba2's
// shared block) and 256 (paligemma's, gemma3's) and block_q, block_kv of 64
// and 128 are built, each pair whose tiles fit one block's shared memory
// (bwd_mma_fits: at 160 all but (128, 128), at 256 only (64, 64)).  Above
// D128 a walk holds half the head dim's accumulator (kWalkCols: at D160,
// with dV's compensation, the whole one is 120 registers a thread, and
// ptxas spilled 612 bytes; at D256 a walk's half is D128's whole), so each
// pass walks once per half and recomputes its S and dP; a (64, 64) block's
// tiles take 130 KB at D160 and 199 KB at D256, so one block holds an SM.
//
// f32 stays on the SIMT lanes (fa_bwd_dq_kernel, fa_bwd_dkv_kernel), in
// IEEE f32 (no TF32): the f32 tiles in padded shared memory, every product
// with a register micro-tile per thread, delta a plain reduction in the
// wrapper, as the reference computes it outside its kernels; block
// geometry from tiling.attention_bwd_blocks.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: SIMT lanes
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kMaxTm = 4;
constexpr int kMaxTn = 8;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

struct BwdParams {
  int sq, sk, d, group;
  int bq, bkv;
  int causal, has_window, window, q_offset;
  float scale;
  // thread micro-tiles: s_* over the (bq, bkv) P / dS tiles, o_* over the
  // accumulator, (bq, d) in the dq pass and (bkv, d) in the dkv pass;
  // tm x tn outputs per thread, txc x tyc threads
  int s_tm, s_tn, s_txc, s_tyc;
  int o_tm, o_tn, o_txc, o_tyc;
};

// q row `qi` (0-based in its head) sees kv position `kpos`
__device__ __forceinline__ bool visible(const BwdParams& p, int qi, int kpos) {
  const int qpos = qi + p.q_offset;
  bool ok = qi < p.sq && kpos < p.sk;
  if (p.causal) ok = ok && (kpos <= qpos);
  if (p.has_window) ok = ok && (kpos > qpos - p.window);
  return ok;
}

// Shared-memory layout of both passes, all f32 (tiling.flash_bwd_smem_bytes).
struct Smem {
  float *qs, *dos, *ks, *vs, *ps, *dss, *lse_s, *delta_s;
  int ldq, ldk, lds;
  __device__ Smem(float* base, const BwdParams& p) {
    ldq = p.d + 1;
    ldk = p.d + 1;
    lds = p.bkv + 1;
    qs = base;                    // (bq, d+1)
    dos = qs + p.bq * ldq;        // (bq, d+1)
    ks = dos + p.bq * ldq;        // (bkv, d+1)
    vs = ks + p.bkv * ldk;        // (bkv, d+1)
    ps = vs + p.bkv * ldk;        // (bq, bkv+1): P
    dss = ps + p.bq * lds;        // (bq, bkv+1): dS
    lse_s = dss + p.bq * lds;     // (bq,)
    delta_s = lse_s + p.bq;       // (bq,)
  }
};

// Stage rows [r0, r0 + rows) of one (seq, d) head into a (rows, d+1) tile,
// zero past `limit`.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int r0,
                                      int rows, int limit, int d) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] =
        (r0 + r < limit) ? load_f(src + static_cast<size_t>(r0 + r) * d + c) : 0.f;
  }
}

// Stage q, dout, lse and delta for the q block at q0 of head `h`.
template <typename T>
__device__ __forceinline__ void stage_q(const Smem& sm, const BwdParams& p,
                                        const T* q, const T* dout,
                                        const float* lse, const float* delta,
                                        int h, int q0) {
  const size_t off = static_cast<size_t>(h) * p.sq * p.d;
  stage(sm.qs, sm.ldq, q + off, q0, p.bq, p.sq, p.d);
  stage(sm.dos, sm.ldq, dout + off, q0, p.bq, p.sq, p.d);
  for (int r = threadIdx.x; r < p.bq; r += blockDim.x) {
    const bool in = q0 + r < p.sq;
    const size_t row = static_cast<size_t>(h) * p.sq + q0 + r;
    sm.lse_s[r] = in ? lse[row] : 0.f;
    sm.delta_s[r] = in ? delta[row] : 0.f;
  }
}

// P and dS of the staged (q block at q0, kv block at j0) pair into sm.ps and
// sm.dss.  Each thread owns the same (row, col) cells in both passes over d,
// so it reads back its own P without a barrier.
__device__ __forceinline__ void scores(const Smem& sm, const BwdParams& p,
                                       int q0, int j0) {
  const int tid = threadIdx.x;
  const int stx = tid % p.s_txc;
  const int sty = tid / p.s_txc;
  if (sty >= p.s_tyc) return;
  float acc[kMaxTm][kMaxTn];
  // pass 1: S = q k^T, then P
#pragma unroll
  for (int i = 0; i < kMaxTm; ++i)
#pragma unroll
    for (int j = 0; j < kMaxTn; ++j) acc[i][j] = 0.f;
  for (int dd = 0; dd < p.d; ++dd) {
    float a[kMaxTm];
    float b[kMaxTn];
#pragma unroll
    for (int i = 0; i < kMaxTm; ++i) {
      const int r = sty + i * p.s_tyc;
      a[i] = (i < p.s_tm && r < p.bq) ? sm.qs[r * sm.ldq + dd] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMaxTn; ++j) {
      const int c = stx + j * p.s_txc;
      b[j] = (j < p.s_tn && c < p.bkv) ? sm.ks[c * sm.ldk + dd] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxTm; ++i)
#pragma unroll
      for (int j = 0; j < kMaxTn; ++j) acc[i][j] += a[i] * b[j];
  }
#pragma unroll
  for (int i = 0; i < kMaxTm; ++i) {
    const int r = sty + i * p.s_tyc;
    if (i >= p.s_tm || r >= p.bq) continue;
#pragma unroll
    for (int j = 0; j < kMaxTn; ++j) {
      const int c = stx + j * p.s_txc;
      if (j >= p.s_tn || c >= p.bkv) continue;
      sm.ps[r * sm.lds + c] = visible(p, q0 + r, j0 + c)
                                  ? expf(acc[i][j] * p.scale - sm.lse_s[r])
                                  : 0.f;
    }
  }
  // pass 2: dP = dout v^T, then dS = P (dP - delta) scale
#pragma unroll
  for (int i = 0; i < kMaxTm; ++i)
#pragma unroll
    for (int j = 0; j < kMaxTn; ++j) acc[i][j] = 0.f;
  for (int dd = 0; dd < p.d; ++dd) {
    float a[kMaxTm];
    float b[kMaxTn];
#pragma unroll
    for (int i = 0; i < kMaxTm; ++i) {
      const int r = sty + i * p.s_tyc;
      a[i] = (i < p.s_tm && r < p.bq) ? sm.dos[r * sm.ldq + dd] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMaxTn; ++j) {
      const int c = stx + j * p.s_txc;
      b[j] = (j < p.s_tn && c < p.bkv) ? sm.vs[c * sm.ldk + dd] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxTm; ++i)
#pragma unroll
      for (int j = 0; j < kMaxTn; ++j) acc[i][j] += a[i] * b[j];
  }
#pragma unroll
  for (int i = 0; i < kMaxTm; ++i) {
    const int r = sty + i * p.s_tyc;
    if (i >= p.s_tm || r >= p.bq) continue;
#pragma unroll
    for (int j = 0; j < kMaxTn; ++j) {
      const int c = stx + j * p.s_txc;
      if (j >= p.s_tn || c >= p.bkv) continue;
      const float pr = sm.ps[r * sm.lds + c];
      sm.dss[r * sm.lds + c] = pr * (acc[i][j] - sm.delta_s[r]) * p.scale;
    }
  }
}

// acc (rows, d) += A^T B for an (n, rows) tile A when kTransA, else A B for
// a (rows, n) tile A; B is an (n, d) tile.  Leading dimensions lda, ldb.
template <bool kTransA>
__device__ __forceinline__ void accumulate(float (&acc)[kMaxTm][kMaxTn],
                                           const BwdParams& p, const float* A,
                                           int lda, const float* B, int ldb,
                                           int n, int rows) {
  const int tid = threadIdx.x;
  const int otx = tid % p.o_txc;
  const int oty = tid / p.o_txc;
  if (oty >= p.o_tyc) return;
  for (int c = 0; c < n; ++c) {
    float a[kMaxTm];
    float b[kMaxTn];
#pragma unroll
    for (int i = 0; i < kMaxTm; ++i) {
      const int r = oty + i * p.o_tyc;
      const bool in = i < p.o_tm && r < rows;
      a[i] = in ? (kTransA ? A[c * lda + r] : A[r * lda + c]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMaxTn; ++j) {
      const int dd = otx + j * p.o_txc;
      b[j] = (j < p.o_tn && dd < p.d) ? B[c * ldb + dd] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxTm; ++i)
#pragma unroll
      for (int j = 0; j < kMaxTn; ++j) acc[i][j] += a[i] * b[j];
  }
}

template <typename T>
__device__ __forceinline__ void store_acc(const float (&acc)[kMaxTm][kMaxTn],
                                          const BwdParams& p, T* dst, int r0,
                                          int rows, int limit) {
  const int tid = threadIdx.x;
  const int otx = tid % p.o_txc;
  const int oty = tid / p.o_txc;
  if (oty >= p.o_tyc) return;
#pragma unroll
  for (int i = 0; i < kMaxTm; ++i) {
    const int r = oty + i * p.o_tyc;
    if (i >= p.o_tm || r >= rows || r0 + r >= limit) continue;
#pragma unroll
    for (int j = 0; j < kMaxTn; ++j) {
      const int dd = otx + j * p.o_txc;
      if (j < p.o_tn && dd < p.d)
        store_f(dst + static_cast<size_t>(r0 + r) * p.d + dd, acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kMaxTm][kMaxTn]) {
#pragma unroll
  for (int i = 0; i < kMaxTm; ++i)
#pragma unroll
    for (int j = 0; j < kMaxTn; ++j) acc[i][j] = 0.f;
}

// dq pass: grid (q blocks, batch * q heads)
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, p);
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * p.bq;
  const int kvh = h / p.group;
  const T* kg = k + static_cast<size_t>(kvh) * p.sk * p.d;
  const T* vg = v + static_cast<size_t>(kvh) * p.sk * p.d;

  stage_q(sm, p, q, dout, lse, delta, h, q0);

  // the kv range any row of this q block can see
  const int q_last = min(q0 + p.bq, p.sq) - 1;
  int kv_hi = p.sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + p.q_offset + 1);
  int kv_lo = 0;
  if (p.has_window) kv_lo = max(kv_lo, q0 + p.q_offset - p.window + 1);

  float acc[kMaxTm][kMaxTn];
  zero(acc);
  const int j_begin = kv_lo < kv_hi ? (kv_lo / p.bkv) * p.bkv : kv_hi;
  for (int j0 = j_begin; j0 < kv_hi; j0 += p.bkv) {
    __syncthreads();  // the previous step is done with ks, vs and dss
    stage(sm.ks, sm.ldk, kg, j0, p.bkv, p.sk, p.d);
    stage(sm.vs, sm.ldk, vg, j0, p.bkv, p.sk, p.d);
    __syncthreads();
    scores(sm, p, q0, j0);
    __syncthreads();
    accumulate<false>(acc, p, sm.dss, sm.lds, sm.ks, sm.ldk, p.bkv, p.bq);
  }
  store_acc(acc, p, dq + static_cast<size_t>(h) * p.sq * p.d, q0, p.bq, p.sq);
}

// dkv pass: grid (kv blocks, batch * kv heads); walks every q head of the
// group and every q block that can see this kv block
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, p);
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * p.bkv;
  const size_t kv_off = static_cast<size_t>(kvh) * p.sk * p.d;

  stage(sm.ks, sm.ldk, k + kv_off, k0, p.bkv, p.sk, p.d);
  stage(sm.vs, sm.ldk, v + kv_off, k0, p.bkv, p.sk, p.d);

  // the q rows that can see some kv position of this block
  const int k_last = min(k0 + p.bkv, p.sk) - 1;
  int q_lo = 0;
  if (p.causal) q_lo = max(q_lo, k0 - p.q_offset);
  int q_hi = p.sq;
  if (p.has_window) q_hi = min(q_hi, k_last + p.window - p.q_offset);
  const int i_begin = q_lo < q_hi ? (q_lo / p.bq) * p.bq : q_hi;

  float dk_acc[kMaxTm][kMaxTn];
  float dv_acc[kMaxTm][kMaxTn];
  zero(dk_acc);
  zero(dv_acc);
  for (int g = 0; g < p.group; ++g) {
    const int h = kvh * p.group + g;
    for (int i0 = i_begin; i0 < q_hi; i0 += p.bq) {
      __syncthreads();  // the previous step is done with qs, dos, ps and dss
      stage_q(sm, p, q, dout, lse, delta, h, i0);
      __syncthreads();
      scores(sm, p, i0, k0);
      __syncthreads();
      accumulate<true>(dv_acc, p, sm.ps, sm.lds, sm.dos, sm.ldq, p.bq, p.bkv);
      accumulate<true>(dk_acc, p, sm.dss, sm.lds, sm.qs, sm.ldq, p.bq, p.bkv);
    }
  }
  store_acc(dk_acc, p, dk + kv_off, k0, p.bkv, p.sk);
  store_acc(dv_acc, p, dv + kv_off, k0, p.bkv, p.sk);
}

bool valid(const BwdParams& p, int rows) {
  return p.s_tm >= 1 && p.s_tm <= kMaxTm && p.s_tn >= 1 && p.s_tn <= kMaxTn &&
         p.o_tm >= 1 && p.o_tm <= kMaxTm && p.o_tn >= 1 && p.o_tn <= kMaxTn &&
         p.s_txc * p.s_tyc <= kThreads && p.o_txc * p.o_tyc <= kThreads &&
         p.s_tm * p.s_tyc >= p.bq && p.s_tn * p.s_txc >= p.bkv &&
         p.o_tm * p.o_tyc >= rows && p.o_tn * p.o_txc >= p.d &&
         p.bq >= 1 && p.bkv >= 1 && p.group >= 1;
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh,
              const BwdParams& p, int smem_bytes, void* stream) {
  if (!valid(p, p.bq) || bh % p.group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fa_bwd_dq_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.sq + p.bq - 1) / p.bq, bh);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bkv_rows, const BwdParams& p, int smem_bytes,
               void* stream) {
  if (!valid(p, p.bkv)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fa_bwd_dkv_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.sk + p.bkv - 1) / p.bkv, bkv_rows);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kSlice = 32;  // columns of the walked tile a warp holds at once
// columns of the accumulator (dQ, dV or dK) one walk of a pass holds: the
// whole head dim up to 128; above it, half, and the pass walks once per
// half (at D160 one 16 x 160 accumulator with its compensation is 120
// registers a thread, and ptxas spilled at the 255 a thread may hold)
template <int D>
constexpr int kWalkCols = D > 128 ? D / 2 : D;

struct BwdMmaParams {
  int sq, sk, group;
  int causal, has_window, window, q_offset;
  float scale;
};

__device__ __forceinline__ bool visible_mma(const BwdMmaParams& p, int qi,
                                            int kpos) {
  const int qpos = qi + p.q_offset;
  bool ok = qi < p.sq && kpos < p.sk;
  if (p.causal) ok = ok && (kpos <= qpos);
  if (p.has_window) ok = ok && (kpos > qpos - p.window);
  return ok;
}

// cp.async rows [r0, r0 + rows) of a (seq, D) bf16 head into a tile of row
// stride D + kPad; zeros past `limit`.  All NT threads of the block take part.
template <int D, int NT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int rows, int limit) {
  constexpr int CH = D / 8;
  constexpr int LD = D + kPad;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bool in = r0 + r < limit;
    cp_async16(smem_u32(dst + r * LD + c * 8),
               src + (in ? static_cast<size_t>(r0 + r) * D + c * 8 : 0), in);
  }
}

// sum of the products of 8 bf16 pairs, in f32
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    s += fx.x * fy.x + fx.y * fy.y;
  }
  return s;
}

// (s0, s1) += (x0, x1), gathering what each f32 add rounds away in cmp, a
// bf16 pair.  The accumulator soon outgrows each chunk it adds, and then
// Fast2Sum's x - (t - s) is that part exactly (at the first chunks, where
// it may not be, the sum is still small).  The rounded-away parts of a sum
// stay a few of its ulps, which bf16's 8 bits hold to a fraction of an
// ulp, in half the registers of an f32 pair.
__device__ __forceinline__ void add_compensated(float& s0, float& s1,
                                                uint32_t& cmp, float x0,
                                                float x1) {
  const float t0 = s0 + x0, t1 = s1 + x1;
  const float e0 = x0 - (t0 - s0), e1 = x1 - (t1 - s1);
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&cmp));
  cmp = pack_bf16(c.x + e0, c.y + e1);
  s0 = t0;
  s1 = t1;
}

// the sum the pair (acc, cmp) holds, element e of 8-column tile j
__device__ __forceinline__ float compensated(const float (&acc)[4],
                                             uint32_t cmp0, uint32_t cmp1,
                                             int e) {
  const uint32_t c = e < 2 ? cmp0 : cmp1;
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&c));
  return acc[e] + ((e & 1) ? f.y : f.x);
}

// acc (16 x DW) += A (16 x 16) B (16 x DW): A is k step kp of the C
// fragments c, entering as three bf16 parts hi + mid + lo; B is DW columns
// of the 16 rows at `rows` of a tile of row stride D + kPad, read
// transposed.  The three
// products go into a fragment from zero, smallest part first, which an f32
// add then adds to acc: the tensor cores' accumulation does not round to
// nearest, and carried along a chain of hundreds of products into acc its
// error would grow with the chain.  With kComp the add is compensated (cmp,
// two bf16 pairs a tile), since even round-to-nearest f32 adds of 64 chunks
// move a sum near 5 by about two of its ulps.
template <int D, int DW, int NT, bool kComp>
__device__ __forceinline__ void mma_split3_rows(float (&acc)[DW / 8][4],
                                                uint32_t (&cmp)[DW / 8][2],
                                                const float (&c)[NT][4],
                                                int kp,
                                                const __nv_bfloat16* rows,
                                                int lane) {
  constexpr int LD = D + kPad;
  uint32_t a[3][4];
  a_split3_from_c(a[0], a[1], a[2], c, kp);
#pragma unroll
  for (int dd = 0; dd < DW / 16; ++dd) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, smem_u32(rows + (((lane >> 3) & 1) * 8 + (lane & 7)) *
                                             LD +
                                  dd * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int part = 2; part >= 0; --part)
        mma_bf16(t, a[part], b[2 * half], b[2 * half + 1]);
      float (&f)[4] = acc[2 * dd + half];
      if constexpr (kComp) {
        add_compensated(f[0], f[1], cmp[2 * dd + half][0], t[0], t[1]);
        add_compensated(f[2], f[3], cmp[2 * dd + half][1], t[2], t[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] += t[e];
      }
    }
  }
}

// c (16 x 32) = A B^T over D: A the warp's 16 rows at `a` (its lane's
// ldmatrix address in the first k step), B the 32 rows at `rows`, both in
// tiles of row stride D + kPad and read without transpose
template <int D, int NT>
__device__ __forceinline__ void slice_product(float (&c)[NT][4],
                                              const __nv_bfloat16* a,
                                              const __nv_bfloat16* rows,
                                              int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_u32(a + kk * 16));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_u32(rows + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                         LD +
                              kk * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16(c[2 * np], af, b[0], b[1]);
      mma_bf16(c[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// dq pass: grid (q blocks, batch * q heads).  NW warps own 16 q rows each
// and walk the kv tiles of BKV rows the block can see, 32 kv rows at a time:
// S = Q K^T and dP = dO V^T into C fragments, then P, dS, and dQ += dS K
// with dS as the A operand and K read transposed.  The prologue writes
// delta = rowsum(dout * out) of the block's rows.
template <int D, int NW, int BKV>
__global__ void
fa_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ out,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, BwdMmaParams p) {
  constexpr int BQ = NW * 16;
  constexpr int NTH = NW * 32;
  constexpr int LD = D + kPad;
  constexpr int CH = D / 8;       // 16-byte vectors a row
  constexpr int DW = kWalkCols<D>;  // dQ columns a walk accumulates
  constexpr int DT = DW / 8;      // 8-column tiles of them
  constexpr int NT = kSlice / 8;  // 8-column tiles of a slice of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LD
  __nv_bfloat16* dos = qs + BQ * LD;                 // BQ x LD
  __nv_bfloat16* ks = dos + BQ * LD;                 // 2 x BKV x LD
  __nv_bfloat16* vs = ks + 2 * BKV * LD;             // 2 x BKV x LD
  float* delta_s = reinterpret_cast<float*>(vs + 2 * BKV * LD);  // BQ

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t qoff = static_cast<size_t>(h) * p.sq * D;
  const size_t kvoff = static_cast<size_t>(h / p.group) * p.sk * D;

  // the kv range any row of this q block can see
  const int q_last = min(q0 + BQ, p.sq) - 1;
  int kv_hi = p.sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + p.q_offset + 1);
  int kv_lo = 0;
  if (p.has_window) kv_lo = max(kv_lo, q0 + p.q_offset - p.window + 1);
  const int j_begin = kv_lo < kv_hi ? (kv_lo / BKV) * BKV : kv_hi;
  const int steps = kv_hi > j_begin ? (kv_hi - j_begin + BKV - 1) / BKV : 0;

  stage_rows<D, NTH>(qs, q + qoff, q0, BQ, p.sq);
  stage_rows<D, NTH>(dos, dout + qoff, q0, BQ, p.sq);
  auto load_kv = [&](int j0, int buf) {
    stage_rows<D, NTH>(ks + buf * BKV * LD, k + kvoff, j0, BKV, p.sk);
    stage_rows<D, NTH>(vs + buf * BKV * LD, v + kvoff, j0, BKV, p.sk);
  };
  if (steps > 0) load_kv(j_begin, 0);
  cp_async_commit();

  // delta of the warp's 16 rows, one 16-byte vector of a row a lane
  if constexpr (32 % CH == 0) {
    // CH lanes a row, 32 / CH rows a pass
    constexpr int RPP = 32 / CH;
    const int c = lane % CH;
#pragma unroll
    for (int pass = 0; pass < CH / 2; ++pass) {
      const int r = warp * 16 + pass * RPP + lane / CH;
      const int qi = q0 + r;
      float s = 0.f;
      if (qi < p.sq) {
        const size_t at = qoff + static_cast<size_t>(qi) * D + c * 8;
        s = dot8(*reinterpret_cast<const uint4*>(dout + at),
                 *reinterpret_cast<const uint4*>(out + at));
      }
#pragma unroll
      for (int off = CH / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (c == 0) {
        delta_s[r] = s;
        if (qi < p.sq) delta[static_cast<size_t>(h) * p.sq + qi] = s;
      }
    }
  } else {
    // a row's CH vectors do not divide the warp (D160: 20): the warp
    // takes one row at a time, lanes past CH idle
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qi = q0 + r;
      float s = 0.f;
      if (qi < p.sq && lane < CH) {
        const size_t at = qoff + static_cast<size_t>(qi) * D + lane * 8;
        s = dot8(*reinterpret_cast<const uint4*>(dout + at),
                 *reinterpret_cast<const uint4*>(out + at));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        delta_s[r] = s;
        if (qi < p.sq) delta[static_cast<size_t>(h) * p.sq + qi] = s;
      }
    }
  }
  __syncwarp();

  // this lane's two rows of every C fragment: lane / 4 and lane / 4 + 8
  const int row_a = warp * 16 + (lane >> 2);
  const int qi[2] = {q0 + row_a, q0 + row_a + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lse_r[hh] = qi[hh] < p.sq ? lse[static_cast<size_t>(h) * p.sq + qi[hh]]
                              : 0.f;
    delta_r[hh] = delta_s[row_a + 8 * hh];
  }

#pragma unroll 1
  for (int h0 = 0; h0 < D; h0 += DW) {
    if (h0 > 0) {  // walk the kv tiles again for the next columns
      if (steps > 0) load_kv(j_begin, 0);
      cp_async_commit();
    }
    float acc[DT][4];
    uint32_t none[DT][2];  // uncompensated: dq seldom reaches 4 (header)
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int it = 0; it < steps; ++it) {
      const int j0 = j_begin + it * BKV;
      const int buf = it & 1;
      if (it + 1 < steps) load_kv(j0 + BKV, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this step's k and v (and q, dout) have landed
      __syncthreads();
      const __nv_bfloat16* kb = ks + buf * BKV * LD;
      const __nv_bfloat16* vb = vs + buf * BKV * LD;

#pragma unroll 1
      for (int c0 = 0; c0 < BKV; c0 += kSlice) {
        // S = Q K^T and dP = dO V^T over this slice's 32 kv rows
        const int a_at = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
        float s[NT][4], dp[NT][4];
        slice_product<D, NT>(s, qs + a_at, kb + c0 * LD, lane);
        slice_product<D, NT>(dp, dos + a_at, vb + c0 * LD, lane);
        // P selected by the mask, then dS = P (dP - delta) scale, into dp
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            const int kpos = j0 + c0 + j * 8 + 2 * (lane & 3) + (e & 1);
            const float pe = visible_mma(p, qi[hh], kpos)
                ? exp2f((s[j][e] * p.scale - lse_r[hh]) * kLog2e) : 0.f;
            dp[j][e] = pe * (dp[j][e] - delta_r[hh]) * p.scale;
          }
        // dQ += dS K: dS's C fragments are the A operand, K rows are B's k
        // rows
#pragma unroll
        for (int kp = 0; kp < kSlice / 16; ++kp)
          mma_split3_rows<D, DW, NT, false>(
              acc, none, dp, kp, kb + (c0 + kp * 16) * LD + h0, lane);
      }
      __syncthreads();  // every warp is done with buf before it is reloaded
    }
    cp_async_wait<0>();

    __nv_bfloat16* dqg = dq + qoff + h0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (qi[hh] >= p.sq) continue;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            dqg + static_cast<size_t>(qi[hh]) * D + j * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }
}

// dkv pass: grid (kv blocks, batch * kv heads).  NW warps own 16 kv rows
// each and walk the q tiles of BQ rows, of every q head of the group, that
// can see the block, 32 q rows at a time, twice: first for dV (S^T = K Q^T,
// P^T, dV += P^T dO), then for dK (S^T again, dP^T = V dO^T, dS^T,
// dK += dS^T Q), with P^T and dS^T as A operands and dO, Q read
// transposed.  So a warp holds one 16 x D accumulator at a time: at D128
// the pair would take 128 registers a thread beside the tiles, and ptxas
// spilled it at the 255 a thread may hold.
template <int D, int NW, int BQ>
__global__ void
fa_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, BwdMmaParams p) {
  constexpr int BKV = NW * 16;
  constexpr int NTH = NW * 32;
  constexpr int LD = D + kPad;
  constexpr int DW = kWalkCols<D>;  // dV or dK columns a walk accumulates
  constexpr int DT = DW / 8;
  constexpr int NT = kSlice / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BKV x LD
  __nv_bfloat16* vs = ks + BKV * LD;                 // BKV x LD
  __nv_bfloat16* qs = vs + BKV * LD;                 // 2 x BQ x LD
  __nv_bfloat16* dos = qs + 2 * BQ * LD;             // 2 x BQ x LD
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // 2 x BQ
  float* dl_s = lse_s + 2 * BQ;                                // 2 x BQ

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BKV;
  const size_t kvoff = static_cast<size_t>(kvh) * p.sk * D;

  // the q rows that can see some kv position of this block
  const int k_last = min(k0 + BKV, p.sk) - 1;
  int q_lo = 0;
  if (p.causal) q_lo = max(q_lo, k0 - p.q_offset);
  int q_hi = p.sq;
  if (p.has_window) q_hi = min(q_hi, k_last + p.window - p.q_offset);
  const int i_begin = q_lo < q_hi ? (q_lo / BQ) * BQ : q_hi;
  const int nq = q_hi > i_begin ? (q_hi - i_begin + BQ - 1) / BQ : 0;
  const int steps = p.group * nq;   // (q head of the group, q tile) pairs

  stage_rows<D, NTH>(ks, k + kvoff, k0, BKV, p.sk);
  stage_rows<D, NTH>(vs, v + kvoff, k0, BKV, p.sk);
  auto load_q = [&](int t, int buf) {
    const int hq = kvh * p.group + t / nq;
    const int i0 = i_begin + (t % nq) * BQ;
    const size_t off = static_cast<size_t>(hq) * p.sq * D;
    stage_rows<D, NTH>(qs + buf * BQ * LD, q + off, i0, BQ, p.sq);
    stage_rows<D, NTH>(dos + buf * BQ * LD, dout + off, i0, BQ, p.sq);
    for (int r = tid; r < BQ; r += NTH) {
      const bool in = i0 + r < p.sq;
      const size_t row = in ? static_cast<size_t>(hq) * p.sq + i0 + r : 0;
      cp_async4(smem_u32(lse_s + buf * BQ + r), lse + row, in);
      cp_async4(smem_u32(dl_s + buf * BQ + r), delta + row, in);
    }
  };

  // this lane's two kv rows of every C fragment
  const int row_a = warp * 16 + (lane >> 2);
  const int kpos[2] = {k0 + row_a, k0 + row_a + 8};
  const int a_at = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int phase = 0; phase < 2; ++phase) {   // 0: dV, 1: dK
#pragma unroll 1
    for (int h0 = 0; h0 < D; h0 += DW) {      // the columns of this walk
      // dv reaches 8 at qwen3's training shape, where one bf16 ulp (0.031)
      // is past the bf16 bound: its walk compensates its adds, dK's does not
      float acc[DT][4];
      uint32_t cmp[DT][2];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        cmp[j][0] = cmp[j][1] = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      }
      if (steps > 0) load_q(0, 0);
      cp_async_commit();

      for (int t = 0; t < steps; ++t) {
        const int i0 = i_begin + (t % nq) * BQ;
        const int buf = t & 1;
        if (t + 1 < steps) load_q(t + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();  // this step's q, dout, lse, delta (and k, v)
        __syncthreads();
        const __nv_bfloat16* qb = qs + buf * BQ * LD;
        const __nv_bfloat16* db = dos + buf * BQ * LD;
        const float* lb = lse_s + buf * BQ;
        const float* eb = dl_s + buf * BQ;

#pragma unroll 1
        for (int c0 = 0; c0 < BQ; c0 += kSlice) {
          // S^T over this slice's 32 q rows, then P^T selected by the mask;
          // lse and delta are per q column
          float s[NT][4];
          slice_product<D, NT>(s, ks + a_at, qb + c0 * LD, lane);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = c0 + j * 8 + 2 * (lane & 3) + (e & 1);
              s[j][e] = visible_mma(p, i0 + col, kpos[e >> 1])
                  ? exp2f((s[j][e] * p.scale - lb[col]) * kLog2e) : 0.f;
            }
          if (phase == 0) {
            // dV += P^T dO: P^T's C fragments are the A operand, dO rows
            // B's k rows
#pragma unroll
            for (int kp = 0; kp < kSlice / 16; ++kp)
              mma_split3_rows<D, DW, NT, true>(
                  acc, cmp, s, kp, db + (c0 + kp * 16) * LD + h0, lane);
          } else {
            // dP^T, then dS^T = P^T (dP^T - delta) scale, and dK += dS^T Q
            float dp[NT][4];
            slice_product<D, NT>(dp, vs + a_at, db + c0 * LD, lane);
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = c0 + j * 8 + 2 * (lane & 3) + (e & 1);
                dp[j][e] = s[j][e] * (dp[j][e] - eb[col]) * p.scale;
              }
#pragma unroll
            for (int kp = 0; kp < kSlice / 16; ++kp)
              mma_split3_rows<D, DW, NT, false>(
                  acc, cmp, dp, kp, qb + (c0 + kp * 16) * LD + h0, lane);
          }
        }
        __syncthreads();  // every warp is done with buf before it is reloaded
      }
      cp_async_wait<0>();
      __syncthreads();  // the next walk restages buffer 0

      __nv_bfloat16* out = phase == 0 ? dv : dk;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (kpos[hh] >= p.sk) continue;
        const size_t at = kvoff + static_cast<size_t>(kpos[hh]) * D + h0 +
                          2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < DT; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + at + j * 8) =
              phase == 0
                  ? __floats2bfloat162_rn(
                        compensated(acc[j], cmp[j][0], cmp[j][1], 2 * hh),
                        compensated(acc[j], cmp[j][0], cmp[j][1], 2 * hh + 1))
                  : __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
    }
  }
}

// The two passes carry no __launch_bounds__: given a block size, ptxas
// trades a few spilled registers for more resident blocks, which shared
// memory does not allow anyway (tiling.attention_bwd_mma_blocks); given a
// minimum of one block an SM as well, it raised D128 to 255 registers and
// spilled.  Without, each takes what it needs, at most 181 at D128.

// shared memory of the two passes (tiling.flash_bwd_mma_smem_bytes)
template <int D, int BQ, int BKV>
constexpr int dq_mma_smem() {
  return (2 * BQ + 4 * BKV) * (D + kPad) * 2 + 4 * BQ;
}

template <int D, int BQ, int BKV>
constexpr int dkv_mma_smem() {
  return (2 * BKV + 4 * BQ) * (D + kPad) * 2 + 16 * BQ;
}

// the dynamic shared memory one block may take on the H100 (227 KB)
constexpr int kMaxSmemBlock = 232448;

// a (BQ, BKV) pair is built at head dim D only where both passes' tiles
// fit one block: an unfit pair compiles, but its launch would fail at
// cudaFuncSetAttribute
template <int D, int BQ, int BKV>
constexpr bool bwd_mma_fits() {
  return dq_mma_smem<D, BQ, BKV>() <= kMaxSmemBlock &&
         dkv_mma_smem<D, BQ, BKV>() <= kMaxSmemBlock;
}

// both passes, dq (which writes delta) first, on one stream
template <int D, int BQ, int BKV>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, int bh,
                   int bkv_rows, const BwdMmaParams& p, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int dq_smem = dq_mma_smem<D, BQ, BKV>();
  auto dq_kernel = fa_bwd_dq_mma_kernel<D, BQ / 16, BKV>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3((p.sq + BQ - 1) / BQ, bh), BQ / 16 * 32, dq_smem,
              stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(out),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf*>(dq), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int dkv_smem = dkv_mma_smem<D, BQ, BKV>();
  auto dkv_kernel = fa_bwd_dkv_mma_kernel<D, BKV / 16, BQ>;
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<dim3((p.sk + BKV - 1) / BKV, bkv_rows), BKV / 16 * 32,
               dkv_smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf*>(dk), static_cast<bf*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_mma_blocks(const void* q, const void* k, const void* v,
                          const void* out, const void* dout, const void* lse,
                          void* delta, void* dq, void* dk, void* dv, int bh,
                          int bkv_rows, int bq, int bkv,
                          const BwdMmaParams& p, cudaStream_t s) {
#define BWD_MMA_CASE(BQ, BKV)                                                  \
  if constexpr (bwd_mma_fits<D, BQ, BKV>())                                    \
    if (bq == BQ && bkv == BKV)                                                \
      return launch_bwd_mma<D, BQ, BKV>(q, k, v, out, dout, lse, delta, dq,    \
                                        dk, dv, bh, bkv_rows, p, s);
  BWD_MMA_CASE(64, 64)
  BWD_MMA_CASE(64, 128)
  BWD_MMA_CASE(128, 64)
  BWD_MMA_CASE(128, 128)
#undef BWD_MMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define BWD_ARGS                                                               \
  int sq, int sk, int d, int group, int bq, int bkv, int causal,               \
      int has_window, int window, int q_offset, float scale, int s_tm,         \
      int s_tn, int s_txc, int s_tyc, int o_tm, int o_tn, int o_txc,           \
      int o_tyc, int smem_bytes, void* stream

#define BWD_PARAMS                                                             \
  BwdParams p{sq,         sk,     d,        group, bq,   bkv,  causal,         \
              has_window, window, q_offset, scale, s_tm, s_tn, s_txc,          \
              s_tyc,      o_tm,   o_tn,     o_txc, o_tyc};

// dq for `bh` q heads; q, dout, dq (bh, sq, d); k, v (bh / group, sk, d);
// lse, delta (bh, sq) f32
#define DQ_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* dout, const void* lse, const void* delta,    \
                      void* dq, int bh, BWD_ARGS) {                            \
    BWD_PARAMS                                                                 \
    return launch_dq<T>(q, k, v, dout, lse, delta, dq, bh, p, smem_bytes,      \
                        stream);                                               \
  }

// dk, dv for `bkv_rows` kv heads; shapes as above, dk, dv like k, v
#define DKV_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* dout, const void* lse, const void* delta,    \
                      void* dk, void* dv, int bkv_rows, BWD_ARGS) {            \
    BWD_PARAMS                                                                 \
    return launch_dkv<T>(q, k, v, dout, lse, delta, dk, dv, bkv_rows, p,       \
                         smem_bytes, stream);                                  \
  }

DQ_ENTRY(covenant_flash_attention_bwd_dq_f32, float)
DKV_ENTRY(covenant_flash_attention_bwd_dkv_f32, float)

// bf16 on the tensor cores: the dq pass (which writes delta, (bh, sq) f32)
// and then the dkv pass.  q, out, dout, dq (bh, sq, d); k, v, dk, dv
// (bkv_rows, sk, d), bh = bkv_rows * group; lse (bh, sq) f32
extern "C" int covenant_flash_attention_bwd_mma(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int bh, int bkv_rows, int sq, int sk, int d, int group, int bq,
    int bkv, int causal, int has_window, int window, int q_offset,
    float scale, void* stream) {
  const void* aligned[] = {q, k, v, out, dout, dq, dk, dv};
  for (const void* ptr : aligned)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  if (group < 1 || bh != bkv_rows * group)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdMmaParams p{sq, sk, group, causal, has_window, window, q_offset,
                       scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_MMA_D(D)                                                           \
  if (d == D)                                                                  \
    return launch_bwd_mma_blocks<D>(q, k, v, out, dout, lse, delta, dq, dk,    \
                                    dv, bh, bkv_rows, bq, bkv, p, s);
  BWD_MMA_D(16)
  BWD_MMA_D(32)
  BWD_MMA_D(64)
  BWD_MMA_D(128)
  BWD_MMA_D(160)
  BWD_MMA_D(256)
#undef BWD_MMA_D
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* covenant_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
