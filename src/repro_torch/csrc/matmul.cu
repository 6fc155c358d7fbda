// Blocked GEMM for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N].
//
// Replaces the TPU kernel repro/kernels/matmul.py:matmul (_matmul_kernel):
// the same (m, n) output blocks and the same walk over k blocks, with the
// accumulator resident across k and written once at the end.  On the TPU
// the k walk is the sequential third grid axis; Hopper blocks run in no
// order, so here it is a loop inside the block.
//
// Block geometry: (block_m, block_n, block_k) come from the Covenant tiler
// against the h100 covenant (kernels/tiling.py).  block_m x block_n sets the
// launch grid, block_m x block_k and block_k x block_n the shared-memory
// tiles each k step stages, in the input type.
//
// Bound on the H100: at the qwen3 prefill shapes (2048 x 1024..151936 x
// 1024..3072) the work is 2*M*N*K operations against (M*K + K*N)*in_bytes +
// M*N*4 bytes, far above the 295 operations per byte where the bf16 tensor
// cores, and not memory, bound it; decode (M = 4) is bound by reading B.
// This first version computes on the SIMT lanes with a register micro-tile
// per thread (tm x tn outputs, tm + tn shared-memory reads per tm*tn FMAs),
// which keeps f32 in true IEEE f32 and i8 -> i32 exact; it does not reach
// the tensor-core bound.  wgmma, TMA and pipelined stages are later work.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
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

MATMUL_ENTRY(covenant_matmul_bf16, __nv_bfloat16, float)
MATMUL_ENTRY(covenant_matmul_f32, float, float)
MATMUL_ENTRY(covenant_matmul_i8, int8_t, int32_t)

extern "C" const char* covenant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
