// Flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/flash_attention.py:
// flash_attention_bwd (_fa_bwd_dq_kernel and _fa_bwd_dkv_kernel): the
// flash-recompute backward.  From q, k, v, dout, the forward's per-row
// log-sum-exp `lse` and delta = rowsum(dout * out) (a plain reduction in the
// wrapper, as the reference computes it outside its kernels), each kv block
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
// atomics; the reference has no GQA at kernel level.  Ragged q and kv edges
// are masked here, so nothing is padded, and blocks that the causal or
// window mask hides completely are skipped.  All accumulation is f32; f32
// inputs stay IEEE f32 (no TF32); dq, dk and dv are written in the input
// type.
//
// Block geometry (block_q, block_kv) comes from the Covenant tiler
// (kernels/tiling.py attention_bwd_blocks), bounded so that the f32 q, dout,
// k, v tiles and the two (block_q, block_kv) tiles (P and dS) fit shared
// memory and the dk and dv accumulators fit the register budget.
//
// Bound on the H100: five GEMM-shaped products (S, dP, dq, dk, dv), that is
// 10*B*Hq*Sq*Sk*D operations (halved by a causal mask), against reading
// q, k, v, out, dout and lse once and writing dq, dk, dv once; at the qwen3
// training shape (B=4, Hq=16, Hkv=8, S=512, D=128) the tensor cores bound
// it.  This first version computes every product on the SIMT lanes in f32
// with a register micro-tile per thread, and the dq and dkv passes each
// recompute S and dP; wgmma, and one pass with atomics for dq, is later
// work.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTm = 4;
constexpr int kMaxTn = 8;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

DQ_ENTRY(covenant_flash_attention_bwd_dq_bf16, __nv_bfloat16)
DQ_ENTRY(covenant_flash_attention_bwd_dq_f32, float)
DKV_ENTRY(covenant_flash_attention_bwd_dkv_bf16, __nv_bfloat16)
DKV_ENTRY(covenant_flash_attention_bwd_dkv_f32, float)

extern "C" const char* covenant_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
