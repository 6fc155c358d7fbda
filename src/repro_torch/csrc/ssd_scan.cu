// Mamba2 SSD (state-space duality) chunk-local stage, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_chunk_scan
// (_ssd_chunk_kernel).  For each (batch*head, chunk) of length L it computes
//   cum      = inclusive cumsum of dt * A over the chunk (the log decay);
//   Y_intra  = (C B^T ⊙ Γ) (dt ⊙ X),  Γ[i,j] = exp(cum_i - cum_j) for j <= i,
//              0 above the diagonal;
//   S_c      = (B ⊙ exp(cum_L - cum))^T (dt ⊙ X), the chunk's end state (N, P);
//   dsum     = cum_L, the chunk's total log decay.
// The inter-chunk recurrence and Y_inter run as torch ops outside, as the
// reference runs them as jnp outside its Pallas kernel.
//
// On the TPU one grid cell holds the whole chunk in VMEM: at L = 512 the
// (L, L) Γ and C B^T are 1 MB each in f32, against the 227 KB of shared
// memory one Hopper block may use.  So the chunk's rows are split into row
// blocks of `bl` rows (kernels/tiling.py ssd_blocks, sized by the Covenant
// tiler through the equivalent C B^T GEMM): a block of ssd_intra_kernel
// holds its C rows, walks the column blocks of `bc` columns at or below its
// last row (Γ is lower triangular, so the rest would add zeros), and keeps
// its (bl, P) Y_intra rows in registers.  Each block rescans the chunk's
// cumsum itself (L floats, cheap) instead of sharing it.  The end state is a
// reduction over all L rows, so it has its own kernel, ssd_state_kernel: one
// block per (batch*head, chunk) walks the L rows and sums in registers, so
// the result is deterministic (no atomics).  The masked entries of Γ are
// never computed: above the diagonal the exp is not taken, so nothing can
// overflow.
//
// Groups: head row `bh` reads the B and C rows of group `bh / rep`
// (rep = heads per group), as the attention kernels read kv head
// `h / group`, instead of the reference's repeat of B and C to every head.
//
// Bound on the H100: at the mamba2-2.7b prefill (BH = 320, L = 512, N = 128,
// P = 64) the two products are about 2 * BH * S * (L/2) * (N + P) + 2 *
// BH * S * N * P operations, against reading x, B and C once and writing
// y and the states once in f32; the bytes bound it (PERF.md).  This first
// version computes both products on the SIMT lanes in f32 with a register
// micro-tile per thread; wgmma and TMA are later work.
//
// C interface: the entry point launches both kernels on the given stream and
// returns cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // the opt-in shared memory of one block

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

struct SsdParams {
  int s;       // sequence length, a multiple of chunk
  int chunk;   // L
  int n, p;    // state size, head dim
  int rep;     // heads per B/C row: head row bh reads B/C row bh / rep
  int bl, bc;  // row block, column block of ssd_intra_kernel
  // thread micro-tiles: tm x tn outputs per thread, txc x tyc threads;
  // s_* over the (bl, bc) scores, o_* over the (bl, p) output, h_* over the
  // (n, p) state
  int s_tm, s_tn, s_txc, s_tyc;
  int o_tm, o_tn, o_txc, o_tyc;
  int h_tm, h_tn, h_txc, h_tyc;
};

// Inclusive cumsum of dtc[t] * a over t < len into cum[0, len), by the whole
// block: each thread sums a contiguous segment, the segment totals are
// scanned across the warps (part: 32 floats), and each thread adds its
// segment's offset.  Ends with a barrier.
__device__ void chunk_cumsum(const float* __restrict__ dtc, float a, int len,
                             float* cum, float* part) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int per = (len + nthreads - 1) / nthreads;
  const int lo = min(tid * per, len);
  const int hi = min(lo + per, len);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    run += dtc[t] * a;
    cum[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float t = part[w];
      part[w] = acc;
      acc += t;
    }
  }
  __syncthreads();
  const float offset = part[warp] + excl;
  for (int t = lo; t < hi; ++t) cum[t] += offset;
  __syncthreads();
}

// grid (BH, chunks, row blocks).  y: (BH, S, P) f32, rows of this block.
template <typename T, int MaxTm, int MaxTn>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ B,
                 const T* __restrict__ C, float* __restrict__ y, SsdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = p.n + 1;
  const int lds = p.bc + 1;
  float* cum = smem;                // (chunk,) the chunk's cumsum
  float* part = cum + p.chunk;      // (32,) scan partials
  float* cs = part + 32;            // (bl, n+1) C rows of this block
  float* bs = cs + p.bl * ldn;      // (bc, n+1) B rows of a column block
  float* xs = bs + p.bc * ldn;      // (bc, p) dt * x of a column block
  float* ss = xs + p.bc * p.p;      // (bl, bc+1) C B^T ⊙ Γ tile

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int bh = blockIdx.x;
  const size_t t0 = static_cast<size_t>(blockIdx.y) * p.chunk;
  const int r0 = blockIdx.z * p.bl;
  const int rows = min(p.bl, p.chunk - r0);
  const int r_end = r0 + rows;  // columns any row here can see: [0, r_end)
  const float a = A[bh];
  const float* dtc = dt + static_cast<size_t>(bh) * p.s + t0;
  const T* xc = x + (static_cast<size_t>(bh) * p.s + t0) * p.p;
  const size_t g_off = (static_cast<size_t>(bh / p.rep) * p.s + t0) * p.n;
  const T* bg = B + g_off;
  const T* cg = C + g_off;

  chunk_cumsum(dtc, a, r_end, cum, part);
  for (int i = tid; i < p.bl * p.n; i += nthreads) {
    const int r = i / p.n;
    const int k = i - r * p.n;
    cs[r * ldn + k] =
        r < rows ? load_f(cg + static_cast<size_t>(r0 + r) * p.n + k) : 0.f;
  }

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

  for (int j0 = 0; j0 < r_end; j0 += p.bc) {
    const int cols = min(p.bc, r_end - j0);
    __syncthreads();  // the previous step is done with bs, xs and ss
    for (int i = tid; i < p.bc * p.n; i += nthreads) {
      const int c = i / p.n;
      const int k = i - c * p.n;
      bs[c * ldn + k] =
          c < cols ? load_f(bg + static_cast<size_t>(j0 + c) * p.n + k) : 0.f;
    }
    for (int i = tid; i < p.bc * p.p; i += nthreads) {
      const int c = i / p.p;
      const int d = i - c * p.p;
      xs[c * p.p + d] =
          c < cols
              ? load_f(xc + static_cast<size_t>(j0 + c) * p.p + d) * dtc[j0 + c]
              : 0.f;
    }
    __syncthreads();

    // (C B^T ⊙ Γ) for this column block; Γ's zeros are not computed
    if (s_active) {
      float s[MaxTm][MaxTn];
#pragma unroll
      for (int i = 0; i < MaxTm; ++i)
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) s[i][j] = 0.f;
      for (int k = 0; k < p.n; ++k) {
        float ca[MaxTm];
        float bb[MaxTn];
#pragma unroll
        for (int i = 0; i < MaxTm; ++i) {
          const int r = sty + i * p.s_tyc;
          ca[i] = (i < p.s_tm && r < p.bl) ? cs[r * ldn + k] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) {
          const int c = stx + j * p.s_txc;
          bb[j] = (j < p.s_tn && c < p.bc) ? bs[c * ldn + k] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < MaxTm; ++i)
#pragma unroll
          for (int j = 0; j < MaxTn; ++j) s[i][j] += ca[i] * bb[j];
      }
#pragma unroll
      for (int i = 0; i < MaxTm; ++i) {
        const int r = sty + i * p.s_tyc;
        if (i >= p.s_tm || r >= p.bl) continue;
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) {
          const int c = stx + j * p.s_txc;
          if (j >= p.s_tn || c >= p.bc) continue;
          float v = 0.f;
          if (r < rows && c < cols && j0 + c <= r0 + r)
            v = s[i][j] * expf(cum[r0 + r] - cum[j0 + c]);
          ss[r * lds + c] = v;
        }
      }
    }
    __syncthreads();

    // Y_intra += (C B^T ⊙ Γ) (dt ⊙ X)
    if (o_active) {
      for (int c = 0; c < cols; ++c) {
        float sa[MaxTm];
        float xb[MaxTn];
#pragma unroll
        for (int i = 0; i < MaxTm; ++i) {
          const int r = oty + i * p.o_tyc;
          sa[i] = (i < p.o_tm && r < p.bl) ? ss[r * lds + c] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) {
          const int d = otx + j * p.o_txc;
          xb[j] = (j < p.o_tn && d < p.p) ? xs[c * p.p + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < MaxTm; ++i)
#pragma unroll
          for (int j = 0; j < MaxTn; ++j) acc[i][j] += sa[i] * xb[j];
      }
    }
  }

  if (!o_active) return;
  float* yc = y + (static_cast<size_t>(bh) * p.s + t0 + r0) * p.p;
#pragma unroll
  for (int i = 0; i < MaxTm; ++i) {
    const int r = oty + i * p.o_tyc;
    if (i >= p.o_tm || r >= rows) continue;
#pragma unroll
    for (int j = 0; j < MaxTn; ++j) {
      const int d = otx + j * p.o_txc;
      if (j < p.o_tn && d < p.p) yc[static_cast<size_t>(r) * p.p + d] = acc[i][j];
    }
  }
}

// grid (BH, chunks).  states: (BH * chunks, N, P) f32; dsums: (BH * chunks,).
template <typename T, int MaxTm, int MaxTn>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ B,
                 float* __restrict__ states, float* __restrict__ dsums,
                 SsdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = p.n + 1;
  float* cum = smem;                // (chunk,)
  float* part = cum + p.chunk;      // (32,)
  float* bs = part + 32;            // (bc, n+1) B ⊙ exp(cum_L - cum)
  float* xs = bs + p.bc * ldn;      // (bc, p) dt * x

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int bh = blockIdx.x;
  const int ck = blockIdx.y;
  const int nck = gridDim.y;
  const size_t t0 = static_cast<size_t>(ck) * p.chunk;
  const float a = A[bh];
  const float* dtc = dt + static_cast<size_t>(bh) * p.s + t0;
  const T* xc = x + (static_cast<size_t>(bh) * p.s + t0) * p.p;
  const T* bg = B + (static_cast<size_t>(bh / p.rep) * p.s + t0) * p.n;

  chunk_cumsum(dtc, a, p.chunk, cum, part);
  const float last = cum[p.chunk - 1];
  const size_t cell = static_cast<size_t>(bh) * nck + ck;
  if (tid == 0) dsums[cell] = last;

  const int htx = tid % p.h_txc;
  const int hty = tid / p.h_txc;
  const bool h_active = hty < p.h_tyc;
  float acc[MaxTm][MaxTn];
#pragma unroll
  for (int i = 0; i < MaxTm; ++i)
#pragma unroll
    for (int j = 0; j < MaxTn; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < p.chunk; j0 += p.bc) {
    const int cols = min(p.bc, p.chunk - j0);
    __syncthreads();
    for (int i = tid; i < p.bc * p.n; i += nthreads) {
      const int c = i / p.n;
      const int k = i - c * p.n;
      bs[c * ldn + k] =
          c < cols ? load_f(bg + static_cast<size_t>(j0 + c) * p.n + k) *
                         expf(last - cum[j0 + c])
                   : 0.f;
    }
    for (int i = tid; i < p.bc * p.p; i += nthreads) {
      const int c = i / p.p;
      const int d = i - c * p.p;
      xs[c * p.p + d] =
          c < cols
              ? load_f(xc + static_cast<size_t>(j0 + c) * p.p + d) * dtc[j0 + c]
              : 0.f;
    }
    __syncthreads();
    if (h_active) {
      for (int c = 0; c < cols; ++c) {
        float ba[MaxTm];
        float xb[MaxTn];
#pragma unroll
        for (int i = 0; i < MaxTm; ++i) {
          const int k = hty + i * p.h_tyc;
          ba[i] = (i < p.h_tm && k < p.n) ? bs[c * ldn + k] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < MaxTn; ++j) {
          const int d = htx + j * p.h_txc;
          xb[j] = (j < p.h_tn && d < p.p) ? xs[c * p.p + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < MaxTm; ++i)
#pragma unroll
          for (int j = 0; j < MaxTn; ++j) acc[i][j] += ba[i] * xb[j];
      }
    }
  }

  if (!h_active) return;
  float* st = states + cell * p.n * p.p;
#pragma unroll
  for (int i = 0; i < MaxTm; ++i) {
    const int k = hty + i * p.h_tyc;
    if (i >= p.h_tm || k >= p.n) continue;
#pragma unroll
    for (int j = 0; j < MaxTn; ++j) {
      const int d = htx + j * p.h_txc;
      if (j < p.h_tn && d < p.p) st[static_cast<size_t>(k) * p.p + d] = acc[i][j];
    }
  }
}

// shared memory of each kernel, in the layouts above (kernels/tiling.py
// ssd_smem_bytes mirrors the intra kernel's)
int intra_smem(const SsdParams& p) {
  return 4 * (p.chunk + 32 + p.bl * (p.n + 1) + p.bc * (p.n + 1) +
              p.bc * p.p + p.bl * (p.bc + 1));
}

int state_smem(const SsdParams& p) {
  return 4 * (p.chunk + 32 + p.bc * (p.n + 1) + p.bc * p.p);
}

template <typename T, int MaxTm, int MaxTn>
int launch_tile(const void* x, const float* dt, const float* A, const void* B,
                const void* C, float* y, float* states, float* dsums, int bh,
                const SsdParams& p, cudaStream_t st) {
  const int nck = p.s / p.chunk;
  const int row_blocks = (p.chunk + p.bl - 1) / p.bl;
  const int y_smem = intra_smem(p);
  const int h_smem = state_smem(p);
  auto intra = ssd_intra_kernel<T, MaxTm, MaxTn>;
  auto state = ssd_state_kernel<T, MaxTm, MaxTn>;
  cudaError_t err = cudaFuncSetAttribute(
      intra, cudaFuncAttributeMaxDynamicSharedMemorySize, y_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      state, cudaFuncAttributeMaxDynamicSharedMemorySize, h_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  intra<<<dim3(bh, nck, row_blocks), kThreads, y_smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), y, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  state<<<dim3(bh, nck), kThreads, h_smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), states,
      dsums, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MaxTm>
int launch_tm(const void* x, const float* dt, const float* A, const void* B,
              const void* C, float* y, float* states, float* dsums, int bh,
              const SsdParams& p, int max_tn, cudaStream_t st) {
  if (max_tn <= 4)
    return launch_tile<T, MaxTm, 4>(x, dt, A, B, C, y, states, dsums, bh, p, st);
  return launch_tile<T, MaxTm, 8>(x, dt, A, B, C, y, states, dsums, bh, p, st);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* states, void* dsums, int bh,
           const SsdParams& p, void* stream) {
  const int max_tm = max(p.s_tm, max(p.o_tm, p.h_tm));
  const int max_tn = max(p.s_tn, max(p.o_tn, p.h_tn));
  if (max_tm < 1 || max_tm > 8 || max_tn < 1 || max_tn > 8 ||
      p.s_txc * p.s_tyc > kThreads || p.o_txc * p.o_tyc > kThreads ||
      p.h_txc * p.h_tyc > kThreads || p.chunk < 1 || p.s % p.chunk != 0 ||
      p.bl < 1 || p.bc < 1 || p.rep < 1 || bh % p.rep != 0 || p.n < 1 ||
      p.p < 1 || p.s_tm * p.s_tyc < p.bl || p.s_tn * p.s_txc < p.bc ||
      p.o_tm * p.o_tyc < p.bl || p.o_tn * p.o_txc < p.p ||
      p.h_tm * p.h_tyc < p.n || p.h_tn * p.h_txc < p.p ||
      intra_smem(p) > kSmemLimit || p.s / p.chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  float* df = static_cast<float*>(dsums);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_tm <= 1) return launch_tm<T, 1>(x, dtf, af, B, C, yf, sf, df, bh, p, max_tn, st);
  if (max_tm <= 2) return launch_tm<T, 2>(x, dtf, af, B, C, yf, sf, df, bh, p, max_tn, st);
  if (max_tm <= 4) return launch_tm<T, 4>(x, dtf, af, B, C, yf, sf, df, bh, p, max_tn, st);
  return launch_tm<T, 8>(x, dtf, af, B, C, yf, sf, df, bh, p, max_tn, st);
}

}  // namespace

// x: (bh, s, p) T; dt: (bh, s) f32; A: (bh,) f32; B, C: (bh / rep, s, n) T;
// y: (bh, s, p) f32; states: (bh * s / chunk, n, p) f32; dsums: (bh * s /
// chunk,) f32.
#define SSD_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* x, const void* dt, const void* A,           \
                      const void* B, const void* C, void* y, void* states,     \
                      void* dsums, int bh, int s, int chunk, int n, int p,     \
                      int rep, int bl, int bc, int s_tm, int s_tn, int s_txc,  \
                      int s_tyc, int o_tm, int o_tn, int o_txc, int o_tyc,     \
                      int h_tm, int h_tn, int h_txc, int h_tyc,                \
                      void* stream) {                                          \
    SsdParams prm{s,     chunk, n,     p,     rep,   bl,    bc,    s_tm,       \
                  s_tn,  s_txc, s_tyc, o_tm,  o_tn,  o_txc, o_tyc, h_tm,       \
                  h_tn,  h_txc, h_tyc};                                        \
    return launch<T>(x, dt, A, B, C, y, states, dsums, bh, prm, stream);       \
  }

SSD_ENTRY(covenant_ssd_scan_bf16, __nv_bfloat16)
SSD_ENTRY(covenant_ssd_scan_f32, float)

extern "C" const char* covenant_ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
