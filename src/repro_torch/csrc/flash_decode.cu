// One-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_decode
// (_decode_kernel): the Hg query heads that share one kv head attend
// together to that head's cache, each row masked to its own kv_len, with an
// online softmax in f32 and the `l == 0` guard (kv_len 0 gives zeros).
//
// Bound on the H100: reading the kv_len valid rows of k and v once
// (2 * rows * kv_len * D * bytes); 4 * Hg * D operations a key are far
// below the 295 a byte where the tensor cores would bound it, and one kv
// head has 1 or 2 query rows, under the 16 an mma needs.  So the kernel
// stays on the SIMT lanes and its design is about the memory system.
//
// On the TPU one grid row per (batch, kv head) walks the kv blocks in order.
// At the qwen3 decode shape (batch 4 x 8 kv heads) that is 32 rows for 132 SMs,
// so here each row's kv walk is split (block_kv keys a split,
// tiling.decode_block_kv) and each (split, row) pair is a block.  Inside a
// block each warp streams its own tiles of keys, every fourth tile of the
// split, through a ring of 3 stages in shared memory filled by cp.async in
// 16-byte vectors, so two tiles are in flight while it computes on a third.  A
// tile holds 32 / L keys, one for each group of L lanes; the L lanes of a group
// take the key's 16-byte chunks in turn (4 lanes, or 8 or 16 where the query
// and accumulator registers of 4 would pass 32 a thread, fewer for a row of
// fewer chunks), and a score is their partial dot products summed over a
// log2(L)-step shuffle tree.  The online softmax runs once a tile: the tile's
// max over the warp, one rescale of the accumulator, one exp a key.  Scores are
// kept in log2 units (q is scaled by scale * log2(e) once), so each exp is one
// exp2.
//
// The split combine is fused into the same launch and is deterministic: each
// block writes its partial max, sum and unnormalised accumulator, and the last
// block of the row to arrive (an arrival counter, reset by that block for the
// next launch) reads the partials and sums them in an order fixed by the split
// index, and writes the output.  Which block arrives last changes from run to
// run; what it computes does not.  A row whose keys fit one split writes its
// output directly, and splits past a row's kv_len exit at once.  Row r of the
// (rows, ...) inputs reads kv_len[r / kv_heads]: one length per batch entry,
// its kv heads consecutive.
//
// C interface: the entry point launches one kernel on the given stream and
// returns cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kStages = 3;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = __bfloat1622float2(x[i]);
    f[2 * i] = y.x;
    f[2 * i + 1] = y.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4],
                                       const float*) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// lanes a key: the fewest of 4, 8, 16 that hold the Hg queries and
// accumulators in at most 32 floats each a lane, cut to the largest power
// of two that divides the row's 16-byte chunks (1 or 2 for a short row);
// the kernel is built where a lane then holds at most 96 of each
// (flash_attention.py mirrors the rule).  At 32 the qwen3 shape (Hg 2,
// D128) takes 8 lanes a key and about 100 registers a thread, so four
// blocks share an SM and its whole grid is resident at once.
static_assert(kWarps >= 4, "the combine takes a warp a head, and HG <= 4");

template <typename T, int D, int HG>
struct Shape {
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int CH = D / EPC;                             // a row
  static constexpr int LR = HG * D <= 32 * 4 ? 4 : HG * D <= 32 * 8 ? 8 : 16;
  static constexpr int P2 = CH & -CH;
  static constexpr int L = LR < P2 ? LR : P2;
  static constexpr bool ok = D % EPC == 0 && HG * D <= 96 * L;
  static constexpr int CPL = ok ? CH / L : 1;   // chunks a lane
  static constexpr int E = CPL * EPC;           // elements a lane
  static constexpr int TK = 32 / L;             // keys a warp tile
  static constexpr int TILE = TK * D;           // elements of a k (v) tile
};

// bytes before the warps' states: the ring, or the combine's copy of a
// row's partials where that is larger, rounded to 16
template <typename T, int D, int HG>
__host__ __device__ constexpr int ring_bytes(int n_split) {
  const int ring = kWarps * kStages * 2 * Shape<T, D, HG>::TILE *
                   static_cast<int>(sizeof(T));
  const int parts = n_split * HG * (D + 2) * 4;
  return ((ring > parts ? ring : parts) + 15) / 16 * 16;
}

// grid (n_split, rows); block kWarps * 32 threads.
// part: (rows, n_split, HG, D + 2) f32, the accumulator then max and sum.
template <typename T, int D, int HG>
__global__ void
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              int kv_heads, T* __restrict__ out, float* __restrict__ part,
              int* __restrict__ counters, int s, int block_kv, float qscale) {
  using S = Shape<T, D, HG>;
  constexpr int EPC = S::EPC, CH = S::CH, L = S::L, CPL = S::CPL, E = S::E;
  constexpr int TK = S::TK, TILE = S::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  // the ring (kWarps x kStages x 2 x TILE), which the combine reuses for
  // the row's partials, then the warps' states and the split weights
  T* ring_all = reinterpret_cast<T*>(smem_raw);
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* wm = reinterpret_cast<float*>(
      smem_raw + ring_bytes<T, D, HG>(n_split));
  float* wl = wm + kWarps * HG;                   // (kWarps, HG)
  float* wacc = wl + kWarps * HG;                 // (kWarps, HG, D)
  float* cw = wacc + kWarps * HG * D;             // (n_split, HG) weights
  float* cs = cw + n_split * HG;                  // (HG,) max, then 1 / sum
  __shared__ int last_block;

  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane / L;   // the group's key slot in a tile
  const int c = lane % L;   // the lane's first chunk of a row
  T* og = out + static_cast<size_t>(row) * HG * D;

  const int len = min(max(kv_len[row / kv_heads], 0), s);
  const int nv = (len + block_kv - 1) / block_kv;   // splits with keys
  if (split >= nv) {
    if (split == 0)  // kv_len 0: zeros, the l == 0 guard
      for (int i = tid; i < HG * D; i += kWarps * 32) store_f(og + i, 0.f);
    return;
  }
  const int start = split * block_kv;
  const int end = min(start + block_kv, len);
  const int ntiles = (end - start + TK - 1) / TK;
  const int my_tiles = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps
                                     : 0;

  const T* kr = k + static_cast<size_t>(row) * s * D;
  const T* vr = v + static_cast<size_t>(row) * s * D;
  T* ring = ring_all + warp * kStages * 2 * TILE;
  auto load_tile = [&](int n, int slot) {
    const int j0 = start + (warp + n * kWarps) * TK;
    T* kd = ring + slot * 2 * TILE;
    T* vd = kd + TILE;
    for (int i = lane; i < TK * CH; i += 32) {
      const int r = i / CH;
      const bool in = j0 + r < end;
      const size_t off =
          in ? static_cast<size_t>(j0 + r) * D + (i - r * CH) * EPC : 0;
      cp_async16(smem_u32(kd + i * EPC), kr + off, in);
      cp_async16(smem_u32(vd + i * EPC), vr + off, in);
    }
  };
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < my_tiles) load_tile(n, n);
    cp_async_commit();
  }

  // the lane's chunks c, c + L, ... of each query, scaled to log2 units
  float qf[HG][E];
  float acc[HG][E];
  float m[HG], l[HG];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      float f[EPC];
      unpack(*reinterpret_cast<const uint4*>(
                 q + (static_cast<size_t>(row) * HG + h) * D +
                 (c + i * L) * EPC),
             f, q);
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        qf[h][i * EPC + e] = f[e] * qscale;
        acc[h][i * EPC + e] = 0.f;
      }
    }
  }

  for (int n = 0; n < my_tiles; ++n) {
    if (n + kStages - 1 < my_tiles)
      load_tile(n + kStages - 1, (n + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile n has landed
    __syncwarp();
    const T* kt = ring + (n % kStages) * 2 * TILE + g * D;
    const T* vt = kt + TILE;
    const bool valid = start + (warp + n * kWarps) * TK + g < end;

    // two partial sums a score, so two FMA chains run at once
    float sc[HG], sc2[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) sc[h] = sc2[h] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      float f[EPC];
      unpack(*reinterpret_cast<const uint4*>(kt + (c + i * L) * EPC), f, kt);
#pragma unroll
      for (int h = 0; h < HG; ++h)
#pragma unroll
        for (int e = 0; e < EPC; e += 2) {
          sc[h] += qf[h][i * EPC + e] * f[e];
          sc2[h] += qf[h][i * EPC + e + 1] * f[e + 1];
        }
    }
#pragma unroll
    for (int h = 0; h < HG; ++h) sc[h] += sc2[h];
    float pe[HG], alpha[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) {
#pragma unroll
      for (int off = 1; off < L; off <<= 1)
        sc[h] += __shfl_xor_sync(0xffffffffu, sc[h], off);
      const float x = valid ? sc[h] : kNegInf;
      float mx = x;
#pragma unroll
      for (int off = L; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = exp2f(m[h] - m_new);
      pe[h] = valid ? exp2f(x - m_new) : 0.f;
      m[h] = m_new;
      l[h] = l[h] * alpha[h] + pe[h];
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      float f[EPC];
      unpack(*reinterpret_cast<const uint4*>(vt + (c + i * L) * EPC), f, vt);
#pragma unroll
      for (int h = 0; h < HG; ++h)
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          acc[h][i * EPC + e] = acc[h][i * EPC + e] * alpha[h] + pe[h] * f[e];
    }
    __syncwarp();  // every lane is done with the slot before it is reloaded
  }
  cp_async_wait<0>();

  // the warp's state: sums over its groups (m is the same in every lane)
#pragma unroll
  for (int h = 0; h < HG; ++h) {
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], off);
    }
    if (lane == 0) {
      wm[warp * HG + h] = m[h];
      wl[warp * HG + h] = l[h];
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          wacc[(warp * HG + h) * D + (c + i * L) * EPC + e] =
              acc[h][i * EPC + e];
    }
  }
  __syncthreads();

  // the block's state, the warps merged in order
  float* pg =
      part + (static_cast<size_t>(row) * n_split + split) * HG * (D + 2);
  for (int i = tid; i < HG * D; i += kWarps * 32) {
    const int h = i / D;
    const int d = i - h * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * HG + h]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(wm[w * HG + h] - mx);
      sum += wl[w * HG + h] * wt;
      a += wacc[(w * HG + h) * D + d] * wt;
    }
    if (nv == 1) {
      store_f(og + i, a / (sum == 0.f ? 1.f : sum));
    } else {
      pg[h * (D + 2) + d] = a;
      if (d == 0) {
        pg[h * (D + 2) + D] = mx;
        pg[h * (D + 2) + D + 1] = sum;
      }
    }
  }
  if (nv == 1) return;
  // the last block of the row to arrive combines the splits in order.  The
  // barrier orders the block's partial writes before thread 0's release
  // (the gpu-scope atomic), and its acquire before the last block's reads
  __syncthreads();
  if (tid == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(counters + row) : "memory");
    last_block = old == nv - 1;
    if (last_block) counters[row] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_block) return;
  // the row's partials into shared memory (the free ring) in one round of
  // 8-byte loads, the row's max and the splits' weights from there, then
  // each output element sums its splits' accumulators, in a fixed order
  const float2* pr = reinterpret_cast<const float2*>(
      part + static_cast<size_t>(row) * n_split * HG * (D + 2));
  for (int i = tid; i < nv * HG * (D + 2) / 2; i += kWarps * 32)
    reinterpret_cast<float2*>(stage)[i] = __ldcg(pr + i);
  __syncthreads();
  // warp h < HG: the row's max and sum for head h, its lanes taking the
  // splits in turn and two shuffle trees fixed in order
  if (warp < HG) {
    const int h = warp;
    float mx = kNegInf;
    for (int sp = lane; sp < nv; sp += 32)
      mx = fmaxf(mx, stage[(sp * HG + h) * (D + 2) + D]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int sp = lane; sp < nv; sp += 32) {
      const float* ps = stage + (sp * HG + h) * (D + 2);
      const float wt = exp2f(ps[D] - mx);
      cw[sp * HG + h] = wt;
      sum += ps[D + 1] * wt;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) cs[h] = 1.f / (sum == 0.f ? 1.f : sum);
  }
  __syncthreads();
  // four partial sums an element, so four chains of smem reads run at once
  for (int i = tid; i < HG * D; i += kWarps * 32) {
    const int h = i / D;
    const int d = i - h * D;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    int sp = 0;
    for (; sp + 4 <= nv; sp += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] += cw[(sp + u) * HG + h] *
                stage[((sp + u) * HG + h) * (D + 2) + d];
    for (; sp < nv; ++sp)
      a[0] += cw[sp * HG + h] * stage[(sp * HG + h) * (D + 2) + d];
    store_f(og + i, ((a[0] + a[1]) + (a[2] + a[3])) * cs[h]);
  }
}

template <typename T, int D, int HG>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           int kv_heads, void* out, float* part, int* counters, int rows,
           int s, int block_kv, float qscale, cudaStream_t stream) {
  using S = Shape<T, D, HG>;
  if constexpr (!S::ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    // the ring (or the partials), the warps' states, the split weights
    const int n_split = (s + block_kv - 1) / block_kv;
    const int smem = ring_bytes<T, D, HG>(n_split) +
                     (kWarps * HG * (D + 2) + (n_split + 1) * HG) * 4;
    auto kernel = decode_kernel<T, D, HG>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_split, rows), kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), kv_len, kv_heads, static_cast<T*>(out),
        part, counters, s, block_kv, qscale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int launch_hg(const void* q, const void* k, const void* v, const int* kv_len,
              int kv_heads, void* out, float* part, int* counters, int rows,
              int s, int hg, int block_kv, float qscale, cudaStream_t st) {
  if (hg == 1)
    return launch<T, D, 1>(q, k, v, kv_len, kv_heads, out, part, counters,
                           rows, s, block_kv, qscale, st);
  if (hg == 2)
    return launch<T, D, 2>(q, k, v, kv_len, kv_heads, out, part, counters,
                           rows, s, block_kv, qscale, st);
  if (hg == 4)
    return launch<T, D, 4>(q, k, v, kv_len, kv_heads, out, part, counters,
                           rows, s, block_kv, qscale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* kv_len,
             int kv_heads, void* out, float* part, int* counters, int rows,
             int s, int d, int hg, int block_kv, float scale, void* stream) {
  if (rows < 1 || s < 1 || block_kv < 1 || kv_heads < 1 ||
      rows % kv_heads != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float qscale = scale * kLog2e;
#define DECODE_D(D)                                                            \
  if (d == D)                                                                  \
    return launch_hg<T, D>(q, k, v, kv_len, kv_heads, out, part, counters,     \
                           rows, s, hg, block_kv, qscale, st);
  DECODE_D(8)
  DECODE_D(16)
  DECODE_D(32)
  DECODE_D(64)
  DECODE_D(128)
  DECODE_D(160)
#undef DECODE_D
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out (rows, hg, d); k, v (rows, s, d); kv_len (rows / kv_heads,) int32;
// part: (rows, ceil(s / block_kv), hg, d + 2) f32 scratch; counters: (rows,)
// int32, zero before the launch and zero again after it
#define DECODE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* kv_len, int kv_heads, void* out,             \
                      void* part, void* counters, int rows, int s, int d,      \
                      int hg, int block_kv, float scale, void* stream) {       \
    return launch_d<T>(q, k, v, static_cast<const int*>(kv_len), kv_heads,    \
                       out, static_cast<float*>(part),                         \
                       static_cast<int*>(counters), rows, s, d, hg, block_kv,  \
                       scale, stream);                                         \
  }

DECODE_ENTRY(covenant_flash_decode_bf16, __nv_bfloat16)
DECODE_ENTRY(covenant_flash_decode_f32, float)

extern "C" const char* covenant_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
