// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_fa_kernel): online softmax over kv blocks with a running max, a running
// sum and an f32 accumulator; the masks for causal, a sliding `window`, the
// `q_offset` of q row 0 in kv positions and the true `seq_k`; and the same
// `l == 0` guard, so a fully masked row comes out as zeros.
//
// The same template, given an `lse` pointer, also replaces
// flash_attention_fwd_lse (_fa_fwd_lse_kernel): it writes each row's f32
// log-sum-exp m + log(l) (l == 0 read as 1, so a fully masked row has
// lse = -1e30), the residual of the backward in flash_attention_bwd.cu.
// The entry points covenant_flash_attention_fwd_lse_{bf16,f32} take it.
//
// One thread block per (q block, batch*head).  On the TPU the kv walk is the
// sequential third grid axis and the running state lives in VMEM scratch
// between grid steps; Hopper blocks run in no order, so here the kv walk is
// a loop inside the block and the state stays in the block (row stats in
// shared memory, the accumulator in registers).  Grouped-query attention
// indexes the kv head as head / group instead of repeating k and v.  Ragged
// q and kv edges are masked here, so nothing is padded.  Blocks that the
// causal or window mask hides completely are skipped: they would change
// nothing.
//
// Block geometry (block_q, block_kv) comes from the Covenant tiler
// (kernels/tiling.py attention_blocks), bounded so that the f32 q, k, v
// tiles and the (block_q, block_kv) logits fit shared memory.
//
// Bound on the H100: 4*B*Hq*Sq*Sk*D operations (halved by a causal mask)
// against reading q, k, v once and writing o once; at the qwen3 prefill
// shape (B=4, Hq=16, Hkv=8, S=512, D=128) that is far above the bf16
// tensor cores' 295 operations per byte, so the tensor cores bound it.  This
// first version computes both products on the SIMT lanes in f32 with a
// register micro-tile per thread; wgmma for QK^T and PV is later work.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

FA_ENTRY(covenant_flash_attention_bf16, __nv_bfloat16)
FA_ENTRY(covenant_flash_attention_f32, float)
FA_LSE_ENTRY(covenant_flash_attention_fwd_lse_bf16, __nv_bfloat16)
FA_LSE_ENTRY(covenant_flash_attention_fwd_lse_f32, float)

extern "C" const char* covenant_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
