// One-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_decode
// (_decode_kernel): the Hg query heads that share one kv head attend
// together to that head's cache, each row masked to its own kv_len, with an
// online softmax in f32 and the `l == 0` guard (kv_len 0 gives zeros).
//
// Bound on the H100: reading the kv_len valid rows of k and v once
// (2 * rows * kv_len * D * bytes); 4 * Hg * D operations a key stay below
// the 295 a byte where the tensor cores would bound it for every group the
// reference's configs use (at most 12 heads, 24 operations a byte), so the
// kernel stays on the SIMT lanes and its design is about the memory system.
//
// On the TPU one grid row per (batch, kv head) walks the kv blocks in order.
// At the qwen3 decode shape (batch 4 x 8 kv heads) that is 32 rows for 132 SMs,
// so here each row's kv walk is split (block_kv keys a split,
// tiling.decode_block_kv) and each (split, row) pair is a block.  Its four
// warps share one ring of 3 stages in shared memory, filled by all of them
// with cp.async in 16-byte vectors, so each key and value is read from device
// memory once for its kv head whatever the group, and two stages are in
// flight while the warps compute on a third.  The group's Hg heads go to
// HGG = min(4, the largest power of two <= Hg) head groups of warps, HPW
// = ceil(Hg / HGG) heads a warp (head hgi + j * HGG); the 4 / HGG warps of a
// head group take the stage's keys in turn, a round of 32 / L keys each.  A
// key's 16-byte chunks go to L lanes (the fewest of 4, 8, 16, 32 that hold a
// warp's queries and accumulators in at most 32 floats each a lane, no more
// than the row has chunks; a lane takes chunks c, c + L, ... and the last
// round may leave some lanes idle), and a score is their partial dot
// products summed over a log2(L)-step shuffle tree.  So the registers a
// thread holds stay bounded for every group from 1 to 16 and every head
// dim.  The online softmax runs once a round: the round's max over the warp,
// one rescale of the accumulator, one exp a key.  Scores are kept in log2
// units (q is scaled by scale * log2(e) once), so each exp is one exp2.
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
constexpr int kStageKeys = 16;  // a stage holds at least this many keys
constexpr int kCombineSplits = 32;  // split weights the combine holds at once
constexpr int kMaxGroup = 16;
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

// head groups of warps for a group of hg heads: min(4, the largest power of
// two <= hg); each warp holds ceil(hg / head_groups(hg)) of them
__host__ __device__ constexpr int head_groups(int hg) {
  return hg >= 4 ? 4 : hg >= 2 ? 2 : 1;
}

__host__ __device__ constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// D: head dim; HPW: heads a warp holds.  L lanes a key: the fewest of 4, 8,
// 16, 32 whose chunks a lane (CPL of them) hold HPW heads' queries in at
// most 32 floats, cut to the row's chunks rounded up to a power of two.  At
// the qwen3 shape (Hg 2, D128: one head a warp) that is 4 lanes a key and
// about 100 registers a thread.
template <typename T, int D, int HPW>
struct Shape {
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int CH = D / EPC;                             // a row
  static constexpr int cpl(int l) { return (CH + l - 1) / l; }
  static constexpr int LQ = HPW * cpl(4) * EPC <= 32    ? 4
                            : HPW * cpl(8) * EPC <= 32  ? 8
                            : HPW * cpl(16) * EPC <= 32 ? 16
                                                        : 32;
  static constexpr int L = LQ < pow2_ceil(CH) ? LQ : pow2_ceil(CH);
  static constexpr int CPL = cpl(L);           // chunks a lane, at most
  static constexpr int E = CPL * EPC;          // elements a lane, a head
  static constexpr int TK = 32 / L;            // keys a warp's round
  static_assert(D % EPC == 0 && HPW * E <= 32, "decode shape");
};

// shared memory: the ring (kStages x k and v of `sk` keys), the warps'
// states ((kgn, hg) max and sum, (kgn, hg, D) accumulators), the row's
// (hg,) max and 1 / sum and the combine's (kCombineSplits, hg) weights
template <typename T, int D>
__host__ __device__ constexpr int ring_bytes(int sk) {
  return kStages * 2 * sk * D * static_cast<int>(sizeof(T));
}

// grid (n_split, rows); block kWarps * 32 threads.
// part: (rows, n_split, hg, D + 2) f32, the accumulator then max and sum.
template <typename T, int D, int HPW>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              int kv_heads, T* __restrict__ out, float* __restrict__ part,
              int* __restrict__ counters, int s, int hg, int block_kv,
              float qscale) {
  using S = Shape<T, D, HPW>;
  constexpr int EPC = S::EPC, CH = S::CH, L = S::L, CPL = S::CPL, E = S::E;
  constexpr int TK = S::TK;
  const int hgg = head_groups(hg);
  const int kgn = kWarps / hgg;         // key groups: warps of a head group
  const int bt = kgn * TK;              // keys of a round of every warp
  const int sk = bt > kStageKeys ? bt : kStageKeys;   // keys a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* wm = reinterpret_cast<float*>(smem_raw + ring_bytes<T, D>(sk));
  float* wl = wm + kgn * hg;                      // (kgn, hg)
  float* wacc = wl + kgn * hg;                    // (kgn, hg, D)
  float* cm = wacc + kgn * hg * D;                // (hg,) the row's max
  float* cs = cm + hg;                            // (hg,) 1 / the row's sum
  float* cw = cs + hg;                            // (kCombineSplits, hg)
  __shared__ int last_block;

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kg = warp / hgg;  // the warp's key group
  const int hgi = warp % hgg; // its head group: heads hgi, hgi + hgg, ...
  const int g = lane / L;     // the lanes' key slot in a round
  const int c = lane % L;     // the lane's first chunk of a row
  T* og = out + static_cast<size_t>(row) * hg * D;

  const int len = min(max(kv_len[row / kv_heads], 0), s);
  const int nv = (len + block_kv - 1) / block_kv;   // splits with keys
  if (split >= nv) {
    if (split == 0)  // kv_len 0: zeros, the l == 0 guard
      for (int i = tid; i < hg * D; i += kWarps * 32) store_f(og + i, 0.f);
    return;
  }
  const int start = split * block_kv;
  const int end = min(start + block_kv, len);
  const int nstages = (end - start + sk - 1) / sk;

  const T* kr = k + static_cast<size_t>(row) * s * D;
  const T* vr = v + static_cast<size_t>(row) * s * D;
  auto load_stage = [&](int n, int slot) {
    const int j0 = start + n * sk;
    T* kd = ring + slot * 2 * sk * D;
    T* vd = kd + sk * D;
    for (int i = tid; i < sk * CH; i += kWarps * 32) {
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
    if (n < nstages) load_stage(n, n);
    cp_async_commit();
  }

  // the lane's chunks c, c + L, ... of each of its heads' queries, scaled
  // to log2 units; zeros past the row's chunks or the group's heads
  float qf[HPW][E];
  float acc[HPW][E];
  float m[HPW], l[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int h = hgi + j * hgg;
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int ch = c + i * L;
      float f[EPC];
      if (h < hg && ch < CH) {
        unpack(*reinterpret_cast<const uint4*>(
                   q + (static_cast<size_t>(row) * hg + h) * D + ch * EPC),
               f, q);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        qf[j][i * EPC + e] = f[e] * qscale;
        acc[j][i * EPC + e] = 0.f;
      }
    }
  }

  for (int n = 0; n < nstages; ++n) {
    cp_async_wait<kStages - 2>();  // stage n has landed, for every thread
    __syncthreads();               // and every warp is done with stage n - 1
    if (n + kStages - 1 < nstages)
      load_stage(n + kStages - 1, (n + kStages - 1) % kStages);
    cp_async_commit();
    const T* ks = ring + (n % kStages) * 2 * sk * D;
    const T* vs = ks + sk * D;
    const int j0 = start + n * sk;
    for (int r0 = kg * TK; r0 < sk && j0 + r0 < end; r0 += bt) {
      const T* kt = ks + (r0 + g) * D;
      const T* vt = vs + (r0 + g) * D;
      const bool valid = j0 + r0 + g < end;

      // two partial sums a score, so two FMA chains run at once
      float sc[HPW], sc2[HPW];
#pragma unroll
      for (int j = 0; j < HPW; ++j) sc[j] = sc2[j] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        if (CH % L != 0 && c + i * L >= CH) continue;
        float f[EPC];
        unpack(*reinterpret_cast<const uint4*>(kt + (c + i * L) * EPC), f,
               kt);
#pragma unroll
        for (int j = 0; j < HPW; ++j)
#pragma unroll
          for (int e = 0; e < EPC; e += 2) {
            sc[j] += qf[j][i * EPC + e] * f[e];
            sc2[j] += qf[j][i * EPC + e + 1] * f[e + 1];
          }
      }
      float pe[HPW], alpha[HPW];
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        sc[j] += sc2[j];
#pragma unroll
        for (int off = 1; off < L; off <<= 1)
          sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], off);
        const float x = valid ? sc[j] : kNegInf;
        float mx = x;
#pragma unroll
        for (int off = L; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[j], mx);
        alpha[j] = exp2f(m[j] - m_new);
        pe[j] = valid ? exp2f(x - m_new) : 0.f;
        m[j] = m_new;
        l[j] = l[j] * alpha[j] + pe[j];
      }
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        if (CH % L != 0 && c + i * L >= CH) continue;
        float f[EPC];
        unpack(*reinterpret_cast<const uint4*>(vt + (c + i * L) * EPC), f,
               vt);
#pragma unroll
        for (int j = 0; j < HPW; ++j)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            acc[j][i * EPC + e] =
                acc[j][i * EPC + e] * alpha[j] + pe[j] * f[e];
      }
    }
  }
  cp_async_wait<0>();

  // the warp's state: sums over its key slots (m is the same in every lane)
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int h = hgi + j * hgg;
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], off);
    }
    if (h >= hg) continue;
    if (lane == 0) {
      wm[kg * hg + h] = m[j];
      wl[kg * hg + h] = l[j];
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int ch = c + i * L;
        if (ch >= CH) continue;
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          wacc[(kg * hg + h) * D + ch * EPC + e] = acc[j][i * EPC + e];
      }
    }
  }
  __syncthreads();

  // the block's state, the key groups merged in order
  float* pg =
      part + (static_cast<size_t>(row) * n_split + split) * hg * (D + 2);
  for (int i = tid; i < hg * D; i += kWarps * 32) {
    const int h = i / D;
    const int d = i - h * D;
    float mx = kNegInf;
    for (int w = 0; w < kgn; ++w) mx = fmaxf(mx, wm[w * hg + h]);
    float sum = 0.f, a = 0.f;
    for (int w = 0; w < kgn; ++w) {
      const float wt = exp2f(wm[w * hg + h] - mx);
      sum += wl[w * hg + h] * wt;
      a += wacc[(w * hg + h) * D + d] * wt;
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
  // the row's partials are read from L2 (__ldcg: another block wrote them).
  // Each head's max and sum by one warp, its lanes taking the splits in turn
  // and two shuffle trees fixed in order
  const float* pr = part + static_cast<size_t>(row) * n_split * hg * (D + 2);
  for (int h = warp; h < hg; h += kWarps) {
    float mx = kNegInf;
    for (int sp = lane; sp < nv; sp += 32)
      mx = fmaxf(mx, __ldcg(pr + (sp * hg + h) * (D + 2) + D));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int sp = lane; sp < nv; sp += 32) {
      const float* ps = pr + (sp * hg + h) * (D + 2);
      sum += __ldcg(ps + D + 1) * exp2f(__ldcg(ps + D) - mx);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      cm[h] = mx;
      cs[h] = 1.f / (sum == 0.f ? 1.f : sum);
    }
  }
  // then each output element sums its splits' accumulators in split order,
  // kCombineSplits splits' weights at a time; a thread takes its elements
  // four at a time, each in four partial sums (the splits in turn, by four),
  // so sixteen chains of loads run at once
  const int per_thread = (hg * D + kWarps * 32 - 1) / (kWarps * 32);
  for (int i0 = 0; i0 < per_thread; i0 += 4) {
    float sums[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) sums[t][u] = 0.f;
    for (int sp0 = 0; sp0 < nv; sp0 += kCombineSplits) {
      const int n_sp = min(kCombineSplits, nv - sp0);
      __syncthreads();  // cm is written; the previous weights are read
      for (int i = tid; i < n_sp * hg; i += kWarps * 32) {
        const int sp = i / hg;
        const int h = i - sp * hg;
        cw[i] = exp2f(__ldcg(pr + ((sp0 + sp) * hg + h) * (D + 2) + D) -
                      cm[h]);
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = (i0 + t) * kWarps * 32 + tid;
        if (i >= hg * D) continue;
        const int h = i / D;
        const float* pd = pr + (sp0 * hg + h) * (D + 2) + (i - h * D);
        const float* wt = cw + h;
        int sp = 0;
        for (; sp + 4 <= n_sp; sp += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            sums[t][u] += wt[(sp + u) * hg] *
                          __ldcg(pd + static_cast<size_t>(sp + u) * hg *
                                          (D + 2));
        for (; sp < n_sp; ++sp)
          sums[t][0] +=
              wt[sp * hg] * __ldcg(pd + static_cast<size_t>(sp) * hg * (D + 2));
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = (i0 + t) * kWarps * 32 + tid;
      if (i >= hg * D) continue;
      store_f(og + i, ((sums[t][0] + sums[t][1]) + (sums[t][2] + sums[t][3])) *
                          cs[i / D]);
    }
  }
}

template <typename T, int D, int HPW>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           int kv_heads, void* out, float* part, int* counters, int rows,
           int s, int hg, int block_kv, float qscale, cudaStream_t stream) {
  const int n_split = (s + block_kv - 1) / block_kv;
  const int kgn = kWarps / head_groups(hg);
  const int bt = kgn * Shape<T, D, HPW>::TK;
  const int sk = bt > kStageKeys ? bt : kStageKeys;
  const int smem = ring_bytes<T, D>(sk) +
                   (kgn * hg * (D + 2) + (2 + kCombineSplits) * hg) * 4;
  auto kernel = decode_kernel<T, D, HPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_split, rows), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, kv_heads, static_cast<T*>(out), part,
      counters, s, hg, block_kv, qscale);
  return static_cast<int>(cudaGetLastError());
}

// heads a warp: ceil(hg / head_groups(hg)), 1 to 4 for groups 1 to 16
template <typename T, int D>
int launch_hg(const void* q, const void* k, const void* v, const int* kv_len,
              int kv_heads, void* out, float* part, int* counters, int rows,
              int s, int hg, int block_kv, float qscale, cudaStream_t st) {
  if (hg < 1 || hg > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  const int hpw = (hg + head_groups(hg) - 1) / head_groups(hg);
#define DECODE_HPW(N)                                                          \
  if (hpw == N)                                                                \
    return launch<T, D, N>(q, k, v, kv_len, kv_heads, out, part, counters,    \
                           rows, s, hg, block_kv, qscale, st);
  DECODE_HPW(1)
  DECODE_HPW(2)
  DECODE_HPW(3)
  DECODE_HPW(4)
#undef DECODE_HPW
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
  DECODE_D(256)
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
