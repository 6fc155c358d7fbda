// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_fa_kernel): online softmax over kv blocks with a running max, a running
// sum and an f32 accumulator; the masks for causal, a sliding `window`, the
// `q_offset` of q row 0 in kv positions and the true `seq_k`; and the same
// `l == 0` guard, so a fully masked row comes out as zeros.
//
// The same templates, given an `lse` pointer, also replace
// flash_attention_fwd_lse (_fa_fwd_lse_kernel): they write each row's f32
// log-sum-exp m + log(l) (l == 0 read as 1, so a fully masked row has
// lse = -1e30), the residual of the backward in flash_attention_bwd.cu.
//
// One thread block per (q block, batch*head).  On the TPU the kv walk is the
// sequential third grid axis and the running state lives in VMEM scratch
// between grid steps; Hopper blocks run in no order, so here the kv walk is
// a loop inside the block and the state stays in the block.  Grouped-query
// attention indexes the kv head as head / group instead of repeating k and
// v.  Ragged q and kv edges are masked here, so nothing is padded.  Blocks
// that the causal or window mask hides completely are skipped: they would
// change nothing.
//
// Bound on the H100: 4*B*Hq*Sq*Sk*D operations (halved by a causal mask)
// against reading q, k, v once and writing o once; at zamba2's prefill
// shape (B=4, H=32, S=2048, D=160) that is far above the bf16 tensor cores'
// 295 operations per byte, so the tensor cores bound it, and at qwen3's
// (S=512, D=128) the operations and the bytes are within a factor of two.
//
// bf16 runs on the tensor cores (fa_mma_kernel), FA2-style: 2, 4 or 8 warps
// each own 16 q rows of the block; up to head dim 160 the q fragments are
// loaded once by ldmatrix and held in registers, and at 256 they stay in
// shared memory and are loaded for each k step, as FA2 does there: the
// 16 x 256 f32 O accumulator alone takes 128 registers a thread, and held q
// fragments would add 64 more; S = Q K^T runs as mma.sync m16n8k16 bf16
// -> f32 and is scaled in f32 after the product, as the reference does; the
// row max and sum reduce over the 4 lanes that share a row; P is rounded to
// bf16 in registers and fed as the A operand of P V, with V read by
// ldmatrix.trans; the O accumulator stays in f32 registers.  K and V tiles
// are staged in bf16 by cp.async in 16-byte vectors, double-buffered, each
// row padded by 8 elements so ldmatrix's 8 row reads fall on distinct banks.
// Rounding P to bf16 adds at most 2^-9 of each term of P V: with unit-normal
// v, about 0.01 of extra error, inside the bf16 bound of 2e-2.  Measured on
// the H100 against the plain version (chip_smoke.py, unit-normal q, k, v):
// worst 1.56e-2 at D128 and at D160, one bf16 ulp of an output in [2, 4),
// where the SIMT kernel with f32 P gave 3.9e-3 and 7.8e-3.  Block sizes
// come from the tiler (tiling.attention_mma_blocks); head dims 16, 32, 64,
// 128, 160 and 256 and block_q 32, 64 and 128 are built with block_kv 32,
// 64 and 128 where the tiles fit one block's shared memory (at 256 block_kv
// 32 and 64), so the reference's own bf16 case (D32, blocks (32, 64)) and
// gemma3's head dim run here.  The cp.async, ldmatrix and mma.sync helpers are in
// mma_sync.cuh, shared with the backward.  wgmma for attention is later
// work.
//
// f32 stays on the SIMT lanes (fa_fwd_kernel), in true f32: q, k, v and the
// logits in f32 shared memory, both products with a register micro-tile
// per thread, block sizes from tiling.attention_blocks.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
// the largest head dim whose q fragments the bf16 kernel holds in registers
constexpr int kHoldQMaxD = 160;
// shared memory one block may take (the H100's opt-in maximum)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

struct FaParams {
  int sq, sk, d, group;
  int bq, bkv;
  int causal, has_window, window, q_offset;
  float scale;
  // thread micro-tiles: s_* over the (bq, bkv) logits, o_* over the (bq, d)
  // accumulator; tm x tn outputs per thread, txc x tyc threads
  int s_tm, s_tn, s_txc, s_tyc;
  int o_tm, o_tn, o_txc, o_tyc;
};

__device__ __forceinline__ bool visible(const FaParams& p, int qpos, int kpos) {
  bool ok = kpos < p.sk;
  if (p.causal) ok = ok && (kpos <= qpos);
  if (p.has_window) ok = ok && (kpos > qpos - p.window);
  return ok;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int MaxTm, int MaxTn>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, FaParams p) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = p.d + 1;
  const int ldk = p.d + 1;
  const int ldv = p.d;
  const int lds = p.bkv + 1;
  float* qs = smem;                 // (bq, d+1)
  float* ks = qs + p.bq * ldq;      // (bkv, d+1)
  float* vs = ks + p.bkv * ldk;     // (bkv, d)
  float* ss = vs + p.bkv * ldv;     // (bq, bkv+1): logits, then probabilities
  float* m_s = ss + p.bq * lds;     // (bq,) running max
  float* l_s = m_s + p.bq;          // (bq,) running sum
  float* a_s = l_s + p.bq;          // (bq,) this step's rescale factor

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nthreads >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * p.bq;
  const int kvh = bh / p.group;
  const T* qg = q + static_cast<size_t>(bh) * p.sq * p.d;
  const T* kg = k + static_cast<size_t>(kvh) * p.sk * p.d;
  const T* vg = v + static_cast<size_t>(kvh) * p.sk * p.d;
  T* og = o + static_cast<size_t>(bh) * p.sq * p.d;

  for (int i = tid; i < p.bq * p.d; i += nthreads) {
    const int r = i / p.d;
    const int c = i - r * p.d;
    qs[r * ldq + c] =
        (q0 + r < p.sq) ? load_f(qg + static_cast<size_t>(q0 + r) * p.d + c) : 0.f;
  }
  for (int r = tid; r < p.bq; r += nthreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // the kv range any row of this q block can see
  const int q_last = min(q0 + p.bq, p.sq) - 1;
  int kv_hi = p.sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + p.q_offset + 1);
  int kv_lo = 0;
  if (p.has_window) kv_lo = max(kv_lo, q0 + p.q_offset - p.window + 1);

  const int stx = tid % p.s_txc;
  const int sty = tid / p.s_txc;
  const bool s_active = sty < p.s_tyc;
  const int otx = tid % p.o_txc;
  const int oty = tid / p.o_txc;
  const bool o_active = oty < p.o_tyc;

  float acc[MaxTm][MaxTn];
#pragma unroll
  for (int i = 0; i < MaxTm; ++i)
#pragma unroll
    for (int j = 0; j < MaxTn; ++j) acc[i][j] = 0.f;

  const int j_begin = kv_lo < kv_hi ? (kv_lo / p.bkv) * p.bkv : kv_hi;
  for (int j0 = j_begin; j0 < kv_hi; j0 += p.bkv) {
    __syncthreads();  // the previous step is done with ks, vs and ss
    for (int i = tid; i < p.bkv * p.d; i += nthreads) {
      const int r = i / p.d;
      const int c = i - r * p.d;
      const bool in = j0 + r < p.sk;
      const size_t off = static_cast<size_t>(j0 + r) * p.d + c;
      ks[r * ldk + c] = in ? load_f(kg + off) : 0.f;
      vs[r * ldv + c] = in ? load_f(vg + off) : 0.f;
    }
    __syncthreads();

    // logits of this kv block, masked
    if (s_active) {
      float s[MaxTm][MaxTn];
#pragma unroll
      for (int i = 0; i < MaxTm; ++i)
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) s[i][j] = 0.f;
      for (int dd = 0; dd < p.d; ++dd) {
        float qa[MaxTm];
        float kb[MaxTn];
#pragma unroll
        for (int i = 0; i < MaxTm; ++i) {
          const int r = sty + i * p.s_tyc;
          qa[i] = (i < p.s_tm && r < p.bq) ? qs[r * ldq + dd] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) {
          const int c = stx + j * p.s_txc;
          kb[j] = (j < p.s_tn && c < p.bkv) ? ks[c * ldk + dd] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < MaxTm; ++i)
#pragma unroll
          for (int j = 0; j < MaxTn; ++j) s[i][j] += qa[i] * kb[j];
      }
#pragma unroll
      for (int i = 0; i < MaxTm; ++i) {
        const int r = sty + i * p.s_tyc;
        if (i >= p.s_tm || r >= p.bq) continue;
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) {
          const int c = stx + j * p.s_txc;
          if (j >= p.s_tn || c >= p.bkv) continue;
          ss[r * lds + c] = visible(p, q0 + r + p.q_offset, j0 + c)
                                ? s[i][j] * p.scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < p.bq; r += nwarps) {
      float mx = kNegInf;
      for (int c = lane; c < p.bkv; c += 32) mx = fmaxf(mx, ss[r * lds + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const int qpos = q0 + r + p.q_offset;
      float sum = 0.f;
      for (int c = lane; c < p.bkv; c += 32) {
        const float e = visible(p, qpos, j0 + c) ? expf(ss[r * lds + c] - m_new) : 0.f;
        ss[r * lds + c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
    if (o_active) {
#pragma unroll
      for (int i = 0; i < MaxTm; ++i) {
        const int r = oty + i * p.o_tyc;
        const float alpha = (i < p.o_tm && r < p.bq) ? a_s[r] : 1.f;
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) acc[i][j] *= alpha;
      }
      for (int c = 0; c < p.bkv; ++c) {
        float pa[MaxTm];
        float vb[MaxTn];
#pragma unroll
        for (int i = 0; i < MaxTm; ++i) {
          const int r = oty + i * p.o_tyc;
          pa[i] = (i < p.o_tm && r < p.bq) ? ss[r * lds + c] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) {
          const int dd = otx + j * p.o_txc;
          vb[j] = (j < p.o_tn && dd < p.d) ? vs[c * ldv + dd] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < MaxTm; ++i)
#pragma unroll
          for (int j = 0; j < MaxTn; ++j) acc[i][j] += pa[i] * vb[j];
      }
    }
  }
  __syncthreads();

  if (lse != nullptr) {
    for (int r = tid; r < p.bq && q0 + r < p.sq; r += nthreads) {
      const float l = l_s[r];
      lse[static_cast<size_t>(bh) * p.sq + q0 + r] =
          m_s[r] + logf(l == 0.f ? 1.f : l);
    }
  }
  if (!o_active) return;
#pragma unroll
  for (int i = 0; i < MaxTm; ++i) {
    const int r = oty + i * p.o_tyc;
    if (i >= p.o_tm || r >= p.bq || q0 + r >= p.sq) continue;
    const float l = l_s[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int j = 0; j < MaxTn; ++j) {
      const int dd = otx + j * p.o_txc;
      if (j < p.o_tn && dd < p.d)
        store_f(og + static_cast<size_t>(q0 + r) * p.d + dd, acc[i][j] * inv);
    }
  }
}

template <typename T, int MaxTm, int MaxTn>
int launch_tile(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, const FaParams& p, int smem_bytes,
                cudaStream_t stream) {
  auto kernel = fa_fwd_kernel<T, MaxTm, MaxTn>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.sq + p.bq - 1) / p.bq, bh);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MaxTm>
int launch_tm(const void* q, const void* k, const void* v, void* o, float* lse,
              int bh, const FaParams& p, int max_tn, int smem_bytes,
              cudaStream_t s) {
  if (max_tn <= 4)
    return launch_tile<T, MaxTm, 4>(q, k, v, o, lse, bh, p, smem_bytes, s);
  return launch_tile<T, MaxTm, 8>(q, k, v, o, lse, bh, p, smem_bytes, s);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, const FaParams& p, int smem_bytes, void* stream) {
  const int max_tm = max(p.s_tm, p.o_tm);
  const int max_tn = max(p.s_tn, p.o_tn);
  if (max_tm < 1 || max_tm > 8 || max_tn < 1 || max_tn > 8 ||
      p.s_txc * p.s_tyc > kThreads || p.o_txc * p.o_tyc > kThreads ||
      p.bq < 1 || p.bkv < 1 || p.group < 1 || bh % p.group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_tm <= 1) return launch_tm<T, 1>(q, k, v, o, lse, bh, p, max_tn, smem_bytes, s);
  if (max_tm <= 2) return launch_tm<T, 2>(q, k, v, o, lse, bh, p, max_tn, smem_bytes, s);
  if (max_tm <= 4) return launch_tm<T, 4>(q, k, v, o, lse, bh, p, max_tn, smem_bytes, s);
  return launch_tm<T, 8>(q, k, v, o, lse, bh, p, max_tn, smem_bytes, s);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

struct FaMmaParams {
  int sq, sk, group;
  int causal, has_window, window, q_offset;
  float scale;
};

__device__ __forceinline__ bool visible_mma(const FaMmaParams& p, int qpos,
                                            int kpos) {
  bool ok = kpos < p.sk;
  if (p.causal) ok = ok && (kpos <= qpos);
  if (p.has_window) ok = ok && (kpos > qpos - p.window);
  return ok;
}

// D: head dim; BKV: kv rows a step; NW: warps, 16 q rows each.  Lane l of
// warp w holds rows 16 w + l / 4 and 16 w + l / 4 + 8 of the block, columns
// 8 j + 2 (l % 4) and + 1 of each 8-column tile j (the mma C layout).  The
// launch bounds name a minimum of one block an SM: with the thread count
// alone ptxas held D64 x BKV32 and D32 x BKV64 at 2 and 4 warps to 96
// registers and spilled; with it, none of the instantiations spills.
template <int D, int BKV, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
fa_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
              FaMmaParams p) {
  constexpr int BQ = NW * 16;
  constexpr int LD = D + kPad;
  constexpr int CH = D / 8;       // 16-byte vectors a row
  constexpr int KT = D / 16;      // k steps of Q K^T
  constexpr int NT = BKV / 8;     // 8-column tiles of S
  constexpr int DT = D / 8;       // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LD
  __nv_bfloat16* ks = qs + BQ * LD;                  // 2 x BKV x LD
  __nv_bfloat16* vs = ks + 2 * BKV * LD;             // 2 x BKV x LD

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = bh / p.group;
  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * p.sq * D;
  const __nv_bfloat16* kg = k + static_cast<size_t>(kvh) * p.sk * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(kvh) * p.sk * D;
  __nv_bfloat16* og = o + static_cast<size_t>(bh) * p.sq * D;

  // the kv range any row of this q block can see
  const int q_last = min(q0 + BQ, p.sq) - 1;
  int kv_hi = p.sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + p.q_offset + 1);
  int kv_lo = 0;
  if (p.has_window) kv_lo = max(kv_lo, q0 + p.q_offset - p.window + 1);
  const int j_begin = kv_lo < kv_hi ? (kv_lo / BKV) * BKV : kv_hi;
  const int steps = (kv_hi - j_begin + BKV - 1) / BKV;

  for (int i = tid; i < BQ * CH; i += NW * 32) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bool in = q0 + r < p.sq;
    cp_async16(smem_u32(qs + r * LD + c * 8),
               qg + (in ? static_cast<size_t>(q0 + r) * D + c * 8 : 0), in);
  }
  auto load_kv = [&](int j0, int buf) {
    for (int i = tid; i < BKV * CH; i += NW * 32) {
      const int r = i / CH;
      const int c = i - r * CH;
      const bool in = j0 + r < p.sk;
      const size_t off = in ? static_cast<size_t>(j0 + r) * D + c * 8 : 0;
      const int at = (buf * BKV + r) * LD + c * 8;
      cp_async16(smem_u32(ks + at), kg + off, in);
      cp_async16(smem_u32(vs + at), vg + off, in);
    }
  };
  if (steps > 0) load_kv(j_begin, 0);
  cp_async_commit();

  // q fragments: A operand (16 x 16) of each k step, loaded once and held
  // up to kHoldQMaxD, else loaded from shared memory at each k step
  constexpr bool kHoldQ = D <= kHoldQMaxD;
  const uint32_t q_at = smem_u32(qs + (warp * 16 + (lane & 15)) * LD +
                                 (lane >> 4) * 8);
  uint32_t qa[kHoldQ ? KT : 1][4];
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) ldmatrix_x4(qa[kk], q_at + kk * 32);
  }

  float oacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int qpos[2] = {row0 + p.q_offset, row0 + 8 + p.q_offset};

  for (int it = 0; it < steps; ++it) {
    const int j0 = j_begin + it * BKV;
    const int buf = it & 1;
    if (it + 1 < steps) load_kv(j0 + BKV, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's k and v have landed
    __syncthreads();
    const __nv_bfloat16* kb = ks + buf * BKV * LD;
    const __nv_bfloat16* vb = vs + buf * BKV * LD;

    // S = Q K^T: K rows are B's columns, read without transpose
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      if constexpr (kHoldQ) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
      } else {
        ldmatrix_x4(a, q_at + kk * 32);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(kb + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                                kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale in f32, mask, online softmax over the 4 lanes of each row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const float x = visible_mma(p, qpos[e >> 1], kpos) ? s[j][e] * p.scale
                                                           : kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = exp2f((m_r[h] - m_new) * kLog2e);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const float pe = visible_mma(p, qpos[e >> 1], kpos)
                             ? exp2f((s[j][e] - m_r[e >> 1]) * kLog2e) : 0.f;
        s[j][e] = pe;
        sum[e >> 1] += pe;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = l_r[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      oacc[j][0] *= alpha[0];
      oacc[j][1] *= alpha[0];
      oacc[j][2] *= alpha[1];
      oacc[j][3] *= alpha[1];
    }

    // O += P V: P's C fragments, rounded to bf16, are the A fragments; V
    // rows are B's k rows, read with transpose
#pragma unroll
    for (int kp = 0; kp < BKV / 16; ++kp) {
      uint32_t pa[4];
      a_from_c(pa, s, kp);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(vb + (kp * 16 + ((lane >> 3) & 1) * 8 +
                                            (lane & 7)) * LD +
                                      dp * 16 + (lane >> 4) * 8));
        mma_bf16(oacc[2 * dp], pa, b[0], b[1]);
        mma_bf16(oacc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is reloaded
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / (l_r[h] == 0.f ? 1.f : l_r[h]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + static_cast<size_t>(r) * D + j * 8 +
                                         2 * (lane & 3)) =
          __floats2bfloat162_rn(oacc[j][2 * h] * inv[h],
                                oacc[j][2 * h + 1] * inv[h]);
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<size_t>(bh) * p.sq + r] =
          m_r[h] + logf(l_r[h] == 0.f ? 1.f : l_r[h]);
  }
}

template <int D, int BKV, int NW>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, const FaMmaParams& p, cudaStream_t stream) {
  constexpr int smem = (NW * 16 + 4 * BKV) * (D + kPad) * 2;
  if constexpr (smem > kMaxSmem) {
    // not built: the tiles pass one block's shared memory
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    auto kernel = fa_mma_kernel<D, BKV, NW>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((p.sq + NW * 16 - 1) / (NW * 16), bh);
    kernel<<<grid, NW * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lse, p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D, int BKV>
int launch_mma_bq(const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int bq, const FaMmaParams& p,
                  cudaStream_t s) {
  if (bq == 32) return launch_mma<D, BKV, 2>(q, k, v, o, lse, bh, p, s);
  if (bq == 64) return launch_mma<D, BKV, 4>(q, k, v, o, lse, bh, p, s);
  if (bq == 128) return launch_mma<D, BKV, 8>(q, k, v, o, lse, bh, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_mma_bkv(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int bq, int bkv, const FaMmaParams& p,
                   cudaStream_t s) {
  if (bkv == 32) return launch_mma_bq<D, 32>(q, k, v, o, lse, bh, bq, p, s);
  if (bkv == 64) return launch_mma_bq<D, 64>(q, k, v, o, lse, bh, bq, p, s);
  if (bkv == 128) return launch_mma_bq<D, 128>(q, k, v, o, lse, bh, bq, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int d, int bq, int bkv,
                const FaMmaParams& p, void* stream) {
  if (p.group < 1 || bh % p.group != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 16) return launch_mma_bkv<16>(q, k, v, o, lse, bh, bq, bkv, p, s);
  if (d == 32) return launch_mma_bkv<32>(q, k, v, o, lse, bh, bq, bkv, p, s);
  if (d == 64) return launch_mma_bkv<64>(q, k, v, o, lse, bh, bq, bkv, p, s);
  if (d == 128) return launch_mma_bkv<128>(q, k, v, o, lse, bh, bq, bkv, p, s);
  if (d == 160) return launch_mma_bkv<160>(q, k, v, o, lse, bh, bq, bkv, p, s);
  if (d == 256) return launch_mma_bkv<256>(q, k, v, o, lse, bh, bq, bkv, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define FA_PARAMS                                                              \
  FaParams p{sq,   sk,         d,      group,    bq,    bkv,  causal,          \
             has_window, window, q_offset, scale, s_tm, s_tn, s_txc,           \
             s_tyc, o_tm,      o_tn,   o_txc,    o_tyc};

#define FA_ARGS                                                                \
  int bh, int sq, int sk, int d, int group, int bq, int bkv, int causal,       \
      int has_window, int window, int q_offset, float scale, int s_tm,         \
      int s_tn, int s_txc, int s_tyc, int o_tm, int o_tn, int o_txc,           \
      int o_tyc, int smem_bytes, void* stream

#define FA_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,   \
                      FA_ARGS) {                                               \
    FA_PARAMS                                                                  \
    return launch<T>(q, k, v, o, nullptr, bh, p, smem_bytes, stream);          \
  }

// the same, writing the (bh, sq) f32 log-sum-exp to `lse`
#define FA_LSE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,   \
                      void* lse, FA_ARGS) {                                    \
    FA_PARAMS                                                                  \
    return launch<T>(q, k, v, o, static_cast<float*>(lse), bh, p, smem_bytes,  \
                     stream);                                                  \
  }

FA_ENTRY(covenant_flash_attention_f32, float)
FA_LSE_ENTRY(covenant_flash_attention_fwd_lse_f32, float)

// bf16 on the tensor cores; `lse` may be null (the forward without it)
extern "C" int covenant_flash_attention_mma(
    const void* q, const void* k, const void* v, void* o, void* lse, int bh,
    int sq, int sk, int d, int group, int bq, int bkv, int causal,
    int has_window, int window, int q_offset, float scale, void* stream) {
  FaMmaParams p{sq, sk, group, causal, has_window, window, q_offset, scale};
  return launch_bf16(q, k, v, o, static_cast<float*>(lse), bh, d, bq, bkv, p,
                     stream);
}

extern "C" const char* covenant_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
