// One-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_decode
// (_decode_kernel): the Hg query heads that share one kv head attend
// together to that head's cache, each row masked to its own kv_len, with an
// online softmax in f32 and the `l == 0` guard.
//
// On the TPU one grid row per (batch, kv head) walks the kv blocks in
// order.  At the qwen3 decode shape (batch 4 x 8 kv heads) that is 32 rows
// for 132 SMs, so here the kv walk is split: the first kernel gives each
// (kv split, row) pair its own block, which writes its partial max, sum and
// unnormalised accumulator; the second kernel combines the splits by their
// log-sum-exp weights.  Inside a block, each warp takes every
// (warps)-th key; a key's Hg dot products are warp reductions, and the
// warps' partial states are merged through shared memory.  Each block reads
// its own kv_len, and splits past it do no work.
//
// Bound on the H100: reading the kv_len valid rows of k and v once
// (2 * rows * kv_len * D * bytes) dominates; 4 * Hg * D operations per key
// are far below the 295 per byte where compute would bound it.  So the split
// count is what matters: enough blocks in flight to draw on the whole
// memory system (kernels/tiling.py decode_block_kv).
//
// C interface: the entry point launches both kernels on the given stream and
// returns cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxHg = 8;     // q heads per kv head
constexpr int kMaxDpl = 8;    // head_dim / 32 per lane: head_dim <= 256
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (n_split, rows); block kWarps * 32 threads.
// part_m, part_l: (rows, n_split, hg); part_acc: (rows, n_split, hg, d).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int s, int d, int hg,
                    int block_kv, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dpl = (d + 31) / 32;

  const int len = min(kv_len[row], s);
  const int start = split * block_kv;
  const int end = min(start + block_kv, len);

  float qr[kMaxHg][kMaxDpl];
  float acc[kMaxHg][kMaxDpl];
  float m[kMaxHg];
  float l[kMaxHg];
#pragma unroll
  for (int h = 0; h < kMaxHg; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) {
      const int dd = lane * dpl + i;
      qr[h][i] = (h < hg && i < dpl && dd < d)
                     ? load_f(q + (static_cast<size_t>(row) * hg + h) * d + dd)
                     : 0.f;
      acc[h][i] = 0.f;
    }
  }

  const T* kr = k + static_cast<size_t>(row) * s * d;
  const T* vr = v + static_cast<size_t>(row) * s * d;
  for (int j = start + warp; j < end; j += kWarps) {
    float kv[kMaxDpl];
    float vv[kMaxDpl];
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) {
      const int dd = lane * dpl + i;
      const bool in = i < dpl && dd < d;
      kv[i] = in ? load_f(kr + static_cast<size_t>(j) * d + dd) : 0.f;
      vv[i] = in ? load_f(vr + static_cast<size_t>(j) * d + dd) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < kMaxHg; ++h) {
      if (h >= hg) break;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDpl; ++i) part += qr[h][i] * kv[i];
      const float sc = warp_sum(part) * scale;
      const float m_new = fmaxf(m[h], sc);
      const float alpha = expf(m[h] - m_new);
      const float pe = expf(sc - m_new);
      l[h] = l[h] * alpha + pe;
#pragma unroll
      for (int i = 0; i < kMaxDpl; ++i) acc[h][i] = acc[h][i] * alpha + pe * vv[i];
      m[h] = m_new;
    }
  }

  // merge the warps' states through shared memory
  float* wm = smem;                  // (kWarps, hg)
  float* wl = wm + kWarps * hg;      // (kWarps, hg)
  float* wacc = wl + kWarps * hg;    // (kWarps, hg, d)
#pragma unroll
  for (int h = 0; h < kMaxHg; ++h) {
    if (h >= hg) break;
    if (lane == 0) {
      wm[warp * hg + h] = m[h];
      wl[warp * hg + h] = l[h];
    }
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) {
      const int dd = lane * dpl + i;
      if (i < dpl && dd < d) wacc[(warp * hg + h) * d + dd] = acc[h][i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < hg * d; idx += blockDim.x) {
    const int h = idx / d;
    const int dd = idx - h * d;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * hg + h]);
    float sum = 0.f;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(wm[w * hg + h] - mx);
      sum += wl[w * hg + h] * wt;
      a += wacc[(w * hg + h) * d + dd] * wt;
    }
    const size_t pidx = (static_cast<size_t>(row) * n_split + split) * hg + h;
    part_acc[pidx * d + dd] = a;
    if (dd == 0) {
      part_m[pidx] = mx;
      part_l[pidx] = sum;
    }
  }
}

// grid (rows,); combines the splits of one row: out = sum_s acc_s e^(m_s-M)
// / sum_s l_s e^(m_s-M), zero where the total sum is zero.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int n_split, int hg,
                                      int d) {
  const int row = blockIdx.x;
  for (int idx = threadIdx.x; idx < hg * d; idx += blockDim.x) {
    const int h = idx / d;
    const int dd = idx - h * d;
    const size_t base = static_cast<size_t>(row) * n_split * hg + h;
    float mx = kNegInf;
    for (int sp = 0; sp < n_split; ++sp) mx = fmaxf(mx, part_m[base + sp * hg]);
    float sum = 0.f;
    float a = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t pidx = base + static_cast<size_t>(sp) * hg;
      const float wt = expf(part_m[pidx] - mx);
      sum += part_l[pidx] * wt;
      a += part_acc[pidx * d + dd] * wt;
    }
    store_f(out + (static_cast<size_t>(row) * hg + h) * d + dd,
            a / (sum == 0.f ? 1.f : sum));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* part_m, float* part_l, float* part_acc, int rows,
           int s, int d, int hg, int block_kv, float scale, void* stream) {
  if (hg < 1 || hg > kMaxHg || d < 1 || d > 32 * kMaxDpl || block_kv < 1 ||
      rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_split = (s + block_kv - 1) / block_kv;
  const int smem_bytes =
      static_cast<int>(sizeof(float)) * kWarps * hg * (d + 2);
  auto split_kernel = decode_split_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_kernel<<<dim3(n_split, rows), kWarps * 32, smem_bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, part_m, part_l, part_acc, s, d, hg,
      block_kv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<rows, 256, 0, st>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_split, hg, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DECODE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* kv_len, void* out, void* part_m,             \
                      void* part_l, void* part_acc, int rows, int s, int d,    \
                      int hg, int block_kv, float scale, void* stream) {       \
    return launch<T>(q, k, v, static_cast<const int*>(kv_len), out,            \
                     static_cast<float*>(part_m), static_cast<float*>(part_l), \
                     static_cast<float*>(part_acc), rows, s, d, hg, block_kv,  \
                     scale, stream);                                           \
  }

DECODE_ENTRY(covenant_flash_decode_bf16, __nv_bfloat16)
DECODE_ENTRY(covenant_flash_decode_f32, float)

extern "C" const char* covenant_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
