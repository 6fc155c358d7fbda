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
// Bound on the H100: at the mamba2-2.7b prefill (BH = 320, S = 2048, L =
// 512, N = 128, P = 64) the products are about 75 GFLOP, 0.08 ms of the
// bf16 tensor cores, against 0.09 ms to read x, B, C once and write y and
// the states once: the bytes bound it, so the products have to run on the
// tensor cores and every tile has to be read once per block.
//
// Design: the flash forward's pattern without the softmax, mma.sync
// m16n8k16 bf16 -> f32 (mma_sync.cuh).
// - ssd_intra_kernel: one block per (head row, chunk, row block of BL = 64
//   or 128 rows, P slab of 64), 16 rows a warp.  The block stages its C
//   rows once, then walks the column blocks of BC = 32 or 64 columns at or
//   below its last row (Γ is lower triangular) with the B and X tiles
//   double-buffered by cp.async, rows padded by 8 bf16 so that ldmatrix has
//   no bank conflicts.  S = C B^T goes into f32 fragments and never to
//   shared memory; each fragment is scaled in registers by Γ[r,c] dt[c] =
//   exp(cum_r - cum_c) dt_c, selected by the mask only where a tile crosses
//   the warp's diagonal (tiles below need none, tiles above are skipped),
//   turned into A operands (a_from_c) and multiplied by X read through
//   ldmatrix.trans.  Row blocks are launched longest walk first (the grid's
//   slowest index counts them down).
// - ssd_state_kernel: one block per (head row, chunk, slab of 128 state
//   rows, P slab), 16 state rows a warp: S_c = (B w)^T X over the chunk,
//   w = exp(cum_L - cum) dt, the A operand read from the B tile through
//   ldmatrix.trans and scaled in registers.  One block sums the whole chunk,
//   so the state is deterministic without atomics; it also writes dsum.
// Every block scans the chunk's dt * A itself with one warp (chunk_cumsum),
// in the same order in both kernels whatever the block size.
//
// Rounding.  dt is folded into the score column, and into B's rows for the
// state, never into X: bf16 x, B and C are exact bf16 operands, and the
// scaled scores S' (and B w) are rounded to bf16 once from f32.  So each
// term of Y_intra and of the state carries one bf16 rounding, at most 2^-8
// of it (bf16 keeps 8 significant bits), two thirds of chip_smoke.py's
// bound of 3 * 2^-9 of the terms' absolute sum, whatever the signs.  f32 x,
// B and C (zamba2's prefill, whose conv runs in f32) enter as two bf16
// parts hi + lo (2^-16; covenant_ssd_split writes them first), and every
// product takes the three part pairs but lo * lo.  launch/ssd_probes.py
// simulate chose the two parts on the CPU: at zamba2's shape one part
// gives 1.76 of check_ssd's bound and 0.149 against ssd_ref (gate 2e-3),
// two parts 0.0046 of the bound and 2.4e-4, three 4.5e-5 and 7.6e-5.
//
// Groups: head row `bh` reads the B and C rows of group `bh / rep`
// (rep = heads per group) instead of the reference's repeat of B and C to
// every head.  N and P are multiples of 8 here (the wrapper pads them with
// zeros); N is zero-padded to a multiple of 16 in shared memory and P to
// the slab's 64 columns, both exact.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSmemLimit = 232448;  // the opt-in shared memory of one block
constexpr int kSlabP = 64;          // y and state columns a block computes
constexpr int kLdX = kSlabP + kPad; // row stride of an X tile
constexpr int kSlabN = 128;         // state rows a state block computes
constexpr int kStateBc = 64;        // chunk positions a state step takes

struct SsdParams {
  int s;         // sequence length, a multiple of chunk
  int chunk;     // L
  int n, p;      // state size, head dim: multiples of 8
  int np;        // n rounded up to 16: the k extent of C B^T
  int rep;       // heads per B/C row: head row bh reads B/C row bh / rep
  int p_slabs;   // ceil(p / kSlabP)
  int row_blocks;
  int n_slabs;   // ceil(np / kSlabN)
};

// Inclusive cumsum of dts[t] * a over t < len into cum[0, len), by warp 0:
// each lane sums a contiguous segment, the segment totals are scanned
// across the lanes, and each lane adds its offset.  The order of the adds
// depends on len only, so every block of a chunk gets the same values.
// Ends with a block barrier.
__device__ void chunk_cumsum(const float* dts, float a, int len, float* cum) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (len + 31) / 32;
    const int lo = min(lane * per, len);
    const int hi = min(lo + per, len);
    float run = 0.f;
    for (int t = lo; t < hi; ++t) {
      run += dts[t] * a;
      cum[t] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    float offset = __shfl_up_sync(0xffffffffu, incl, 1);  // lanes before
    if (lane == 0) offset = 0.f;
    for (int t = lo; t < hi; ++t) cum[t] += offset;
  }
  __syncthreads();
}

// cp.async rows [row0, row0 + rows) of a (limit, src_ld) bf16 matrix, its
// 16-byte vectors [0, nvec) of which those below `valid_cols` are read, into
// a tile of row stride `ld`; zeros elsewhere.  All `nth` threads take part.
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src,
                                      int src_ld, int row0, int rows,
                                      int limit, int nvec, int valid_cols,
                                      int nth) {
  for (int i = threadIdx.x; i < rows * nvec; i += nth) {
    const int r = i / nvec;
    const int c = i - r * nvec;
    const bool in = row0 + r < limit && c * 8 < valid_cols;
    cp_async16(smem_u32(dst + r * ld + c * 8),
               src + (in ? static_cast<size_t>(row0 + r) * src_ld + c * 8 : 0),
               in);
  }
}

// f32 offset of the intra kernel's bf16 tiles: the chunk's cum and dt,
// each 4-aligned
__host__ __device__ __forceinline__ int scan_floats(int chunk) {
  return 2 * ((chunk + 3) & ~3);
}

// the same for the state kernel: cum, then dt turned into w for every
// position its steps of kStateBc read (0 past the chunk's end)
__host__ __device__ __forceinline__ int state_scan_floats(int chunk) {
  return ((chunk + 3) & ~3) + (chunk + kStateBc - 1) / kStateBc * kStateBc;
}

// shared memory of the intra kernel (tiling.ssd_mma_smem_bytes mirrors it):
// cum and dt, the C rows and two buffers of the B and X tiles, NPART parts
// each, rows padded by 8 bf16
__host__ __device__ __forceinline__ int intra_smem(int bl, int bc, int np,
                                                   int chunk, int parts) {
  return 4 * scan_floats(chunk) +
         2 * parts * (bl * (np + kPad) + 2 * bc * (np + kPad) + 2 * bc * kLdX);
}

__host__ __device__ __forceinline__ int state_smem(int np, int chunk,
                                                   int parts) {
  const int nw = np < kSlabN ? np : kSlabN;
  return 4 * state_scan_floats(chunk) +
         2 * parts * (2 * kStateBc * (nw + kPad) + 2 * kStateBc * kLdX);
}

// grid (BH, chunks, row blocks * P slabs), NW warps.  xs/bs/cs[part]:
// x (BH, S, P), B and C (BH / rep, S, N) as bf16 parts; y (BH, S, P) f32.
template <int NW, int BC, int NPART>
__global__ void __launch_bounds__(NW * 32)
ssd_intra_kernel(const bf16* __restrict__ xh, const bf16* __restrict__ xl,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const bf16* __restrict__ bh_, const bf16* __restrict__ bl_,
                 const bf16* __restrict__ ch, const bf16* __restrict__ cl,
                 float* __restrict__ y, SsdParams p) {
  constexpr int BL = NW * 16;
  constexpr int NTH = NW * 32;
  constexpr int NT = BC / 8;           // 8-column tiles of a score tile
  constexpr int PT = kSlabP / 8;       // 8-column tiles of the y slab
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldn = p.np + kPad;
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* dts = cum + scan_floats(p.chunk) / 2;
  bf16* cs = reinterpret_cast<bf16*>(cum + scan_floats(p.chunk));
  bf16* bs = cs + NPART * BL * ldn;             // [buf][part] BC x ldn
  bf16* xs = bs + 2 * NPART * BC * ldn;         // [buf][part] BC x kLdX

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const size_t t0 = static_cast<size_t>(blockIdx.y) * p.chunk;
  const int rb = p.row_blocks - 1 - static_cast<int>(blockIdx.z) / p.p_slabs;
  const int p0 = (blockIdx.z % p.p_slabs) * kSlabP;
  const int pw = min(kSlabP, p.p - p0);
  const int r0 = rb * BL;
  const int r_end = min(r0 + BL, p.chunk);   // columns any row here sees
  const int steps = (r_end + BC - 1) / BC;
  const size_t g_off = (static_cast<size_t>(bh / p.rep) * p.s + t0) * p.n;
  const size_t x_off = (static_cast<size_t>(bh) * p.s + t0) * p.p + p0;
  const bf16* xpart[2] = {xh + x_off, NPART > 1 ? xl + x_off : nullptr};
  const bf16* bpart[2] = {bh_ + g_off, NPART > 1 ? bl_ + g_off : nullptr};

#pragma unroll
  for (int part = 0; part < NPART; ++part)
    stage(cs + part * BL * ldn, ldn, (part ? cl : ch) + g_off, p.n, r0, BL,
          p.chunk, p.np / 8, p.n, NTH);
  auto load_bx = [&](int j0, int buf) {
#pragma unroll
    for (int part = 0; part < NPART; ++part) {
      stage(bs + (buf * NPART + part) * BC * ldn, ldn, bpart[part], p.n, j0,
            BC, p.chunk, p.np / 8, p.n, NTH);
      stage(xs + (buf * NPART + part) * BC * kLdX, kLdX, xpart[part], p.p,
            j0, BC, p.chunk, kSlabP / 8, pw, NTH);
    }
  };
  load_bx(0, 0);
  cp_async_commit();

  const float* dtc = dt + static_cast<size_t>(bh) * p.s + t0;
  for (int t = tid; t < p.chunk; t += NTH) dts[t] = dtc[t];
  __syncthreads();
  chunk_cumsum(dts, A[bh], p.chunk, cum);

  // this lane's rows of every C fragment: g and g + 8 of the warp's 16
  const int wr0 = r0 + warp * 16;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  const int row[2] = {wr0 + g, wr0 + g + 8};
  const float cum_r[2] = {row[0] < p.chunk ? cum[row[0]] : 0.f,
                          row[1] < p.chunk ? cum[row[1]] : 0.f};

  float yacc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int j0 = it * BC;
    const int buf = it & 1;
    if (it + 1 < steps) load_bx(j0 + BC, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's B and X (and C) have landed
    __syncthreads();
    // the columns of this tile the warp's rows can see: [j0, j0 + cols)
    const int cols = min(BC, wr0 + 16 - j0);
    if (cols > 0 && wr0 < p.chunk) {
      const bf16* bb = bs + buf * NPART * BC * ldn;
      const bf16* xb = xs + buf * NPART * BC * kLdX;

      // S = C B^T over the 16-column pairs the warp can see
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      for (int kk = 0; kk < p.np / 16; ++kk) {
        uint32_t a[NPART][4];
#pragma unroll
        for (int part = 0; part < NPART; ++part)
          ldmatrix_x4(a[part], smem_u32(cs + part * BL * ldn +
                                        (warp * 16 + (lane & 15)) * ldn +
                                        kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (np * 16 >= cols) continue;
          uint32_t b[NPART][4];
#pragma unroll
          for (int part = 0; part < NPART; ++part)
            ldmatrix_x4(b[part],
                        smem_u32(bb + part * BC * ldn +
                                 (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ldn +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
          if constexpr (NPART > 1) {  // the small pairs first
            mma_bf16(s[2 * np], a[1], b[0][0], b[0][1]);
            mma_bf16(s[2 * np + 1], a[1], b[0][2], b[0][3]);
            mma_bf16(s[2 * np], a[0], b[1][0], b[1][1]);
            mma_bf16(s[2 * np + 1], a[0], b[1][2], b[1][3]);
          }
          mma_bf16(s[2 * np], a[0], b[0][0], b[0][1]);
          mma_bf16(s[2 * np + 1], a[0], b[0][2], b[0][3]);
        }
      }

      // S' = S Γ dt in f32; the mask only where the tile crosses the
      // warp's diagonal or its rows pass the chunk's end
      const bool masked = j0 + BC > wr0 + 1 || wr0 + 16 > p.chunk;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j0 + j * 8 + t2 + (e & 1);
          const int r = row[e >> 1];
          if (!masked || (c <= r && r < p.chunk))
            s[j][e] *= exp2f((cum_r[e >> 1] - cum[c]) * kLog2e) * dts[c];
          else
            s[j][e] = 0.f;
        }

      // Y += S' X: S' as A operands, X rows as B's k rows, transposed
#pragma unroll
      for (int kp = 0; kp < BC / 16; ++kp) {
        if (kp * 16 >= cols) continue;
        uint32_t sa[NPART][4];
        if constexpr (NPART > 1)
          a_split2_from_c(sa[0], sa[NPART - 1], s, kp);
        else
          a_from_c(sa[0], s, kp);
#pragma unroll
        for (int dp = 0; dp < PT / 2; ++dp) {
          if (dp * 16 >= pw) continue;
          uint32_t b[NPART][4];
#pragma unroll
          for (int part = 0; part < NPART; ++part)
            ldmatrix_x4_trans(
                b[part], smem_u32(xb + part * BC * kLdX +
                                  (kp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                      kLdX +
                                  dp * 16 + (lane >> 4) * 8));
          if constexpr (NPART > 1) {
            mma_bf16(yacc[2 * dp], sa[1], b[0][0], b[0][1]);
            mma_bf16(yacc[2 * dp + 1], sa[1], b[0][2], b[0][3]);
            mma_bf16(yacc[2 * dp], sa[0], b[1][0], b[1][1]);
            mma_bf16(yacc[2 * dp + 1], sa[0], b[1][2], b[1][3]);
          }
          mma_bf16(yacc[2 * dp], sa[0], b[0][0], b[0][1]);
          mma_bf16(yacc[2 * dp + 1], sa[0], b[0][2], b[0][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is reloaded
  }
  cp_async_wait<0>();

  float* yc = y + x_off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row[h];
    if (r >= r_end) continue;
#pragma unroll
    for (int j = 0; j < PT; ++j)
      if (j * 8 < pw)
        *reinterpret_cast<float2*>(yc + static_cast<size_t>(r) * p.p + j * 8 +
                                   t2) =
            make_float2(yacc[j][2 * h], yacc[j][2 * h + 1]);
  }
}

// grid (BH, chunks, state-row slabs * P slabs), min(np, 128) / 16 warps.
// states: (BH * chunks, N, P) f32; dsums: (BH * chunks,) f32.
template <int NPART>
__global__ void __launch_bounds__(kSlabN / 16 * 32)
ssd_state_kernel(const bf16* __restrict__ xh, const bf16* __restrict__ xl,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const bf16* __restrict__ bh_, const bf16* __restrict__ bl_,
                 float* __restrict__ states, float* __restrict__ dsums,
                 SsdParams p) {
  constexpr int PT = kSlabP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = min(p.np, kSlabN);     // state rows of a slab
  const int ldb = nw + kPad;
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* ws = cum + ((p.chunk + 3) & ~3);
  bf16* bs = reinterpret_cast<bf16*>(cum + state_scan_floats(p.chunk));
  bf16* xs = bs + 2 * NPART * kStateBc * ldb;

  const int nth = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int ck = blockIdx.y;
  const int n0 = (blockIdx.z / p.p_slabs) * kSlabN;
  const int p0 = (blockIdx.z % p.p_slabs) * kSlabP;
  const int pw = min(kSlabP, p.p - p0);
  const size_t t0 = static_cast<size_t>(ck) * p.chunk;
  const size_t g_off = (static_cast<size_t>(bh / p.rep) * p.s + t0) * p.n + n0;
  const size_t x_off = (static_cast<size_t>(bh) * p.s + t0) * p.p + p0;
  const bf16* xpart[2] = {xh + x_off, NPART > 1 ? xl + x_off : nullptr};
  const bf16* bpart[2] = {bh_ + g_off, NPART > 1 ? bl_ + g_off : nullptr};
  const int steps = (p.chunk + kStateBc - 1) / kStateBc;

  auto load_bx = [&](int c0, int buf) {
#pragma unroll
    for (int part = 0; part < NPART; ++part) {
      stage(bs + (buf * NPART + part) * kStateBc * ldb, ldb, bpart[part], p.n,
            c0, kStateBc, p.chunk, nw / 8, p.n - n0, nth);
      stage(xs + (buf * NPART + part) * kStateBc * kLdX, kLdX, xpart[part],
            p.p, c0, kStateBc, p.chunk, kSlabP / 8, pw, nth);
    }
  };
  load_bx(0, 0);
  cp_async_commit();

  const float* dtc = dt + static_cast<size_t>(bh) * p.s + t0;
  for (int t = tid; t < p.chunk; t += nth) ws[t] = dtc[t];
  __syncthreads();
  chunk_cumsum(ws, A[bh], p.chunk, cum);
  const float last = cum[p.chunk - 1];
  // w = exp(cum_L - cum) dt, 0 past the chunk's end
  for (int t = tid; t < steps * kStateBc; t += nth)
    ws[t] = t < p.chunk ? exp2f((last - cum[t]) * kLog2e) * ws[t] : 0.f;
  if (blockIdx.z == 0 && tid == 0)
    dsums[static_cast<size_t>(bh) * gridDim.y + ck] = last;
  __syncthreads();

  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  const bool active = n0 + warp * 16 < p.np;
  float acc[PT][4];
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int c0 = it * kStateBc;
    const int buf = it & 1;
    if (it + 1 < steps) load_bx(c0 + kStateBc, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const bf16* bb = bs + buf * NPART * kStateBc * ldb;
      const bf16* xb = xs + buf * NPART * kStateBc * kLdX;
#pragma unroll
      for (int kp = 0; kp < kStateBc / 16; ++kp) {
        // A = (B w)^T: the B tile's 16 positions x the warp's 16 state
        // rows, read transposed; w scales each position in f32, and the
        // product is rounded to bf16 parts once
        uint32_t raw[NPART][4], a[NPART][4];
#pragma unroll
        for (int part = 0; part < NPART; ++part)
          ldmatrix_x4_trans(
              raw[part],
              smem_u32(bb + part * kStateBc * ldb +
                       (kp * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * ldb +
                       warp * 16 + ((lane >> 3) & 1) * 8));
        const float* wk = ws + c0 + kp * 16 + t2;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float w0 = wk[(r >> 1) * 8], w1 = wk[(r >> 1) * 8 + 1];
          float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw[0][r]));
          if constexpr (NPART > 1) {
            const float2 lo = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw[1][r]));
            v.x += lo.x;
            v.y += lo.y;
          }
          v.x *= w0;
          v.y *= w1;
          __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
          a[0][r] = *reinterpret_cast<uint32_t*>(&h);
          if constexpr (NPART > 1) {
            const float2 hf = __bfloat1622float2(h);
            a[NPART - 1][r] = pack_bf16(v.x - hf.x, v.y - hf.y);
          }
        }
#pragma unroll
        for (int dp = 0; dp < PT / 2; ++dp) {
          if (dp * 16 >= pw) continue;
          uint32_t b[NPART][4];
#pragma unroll
          for (int part = 0; part < NPART; ++part)
            ldmatrix_x4_trans(
                b[part], smem_u32(xb + part * kStateBc * kLdX +
                                  (kp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                      kLdX +
                                  dp * 16 + (lane >> 4) * 8));
          if constexpr (NPART > 1) {
            mma_bf16(acc[2 * dp], a[1], b[0][0], b[0][1]);
            mma_bf16(acc[2 * dp + 1], a[1], b[0][2], b[0][3]);
            mma_bf16(acc[2 * dp], a[0], b[1][0], b[1][1]);
            mma_bf16(acc[2 * dp + 1], a[0], b[1][2], b[1][3]);
          }
          mma_bf16(acc[2 * dp], a[0], b[0][0], b[0][1]);
          mma_bf16(acc[2 * dp + 1], a[0], b[0][2], b[0][3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if (!active) return;
  float* st = states +
              (static_cast<size_t>(bh) * gridDim.y + ck) * p.n * p.p + p0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + warp * 16 + g + 8 * h;
    if (n >= p.n) continue;
#pragma unroll
    for (int j = 0; j < PT; ++j)
      if (j * 8 < pw)
        *reinterpret_cast<float2*>(st + static_cast<size_t>(n) * p.p + j * 8 +
                                   t2) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// f32 -> two bf16 parts: hi = rn(x), lo = rn(x - hi)
__global__ void split_kernel(const float* __restrict__ in, bf16* __restrict__ hi,
                             bf16* __restrict__ lo, size_t count) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < count; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float v = in[i];
    const bf16 h = __float2bfloat16_rn(v);
    hi[i] = h;
    lo[i] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

template <int NW, int BC, int NPART>
int launch_intra(const void* const* ptrs, float* y, int nbh,
                 const SsdParams& p, cudaStream_t st) {
  const int smem = intra_smem(NW * 16, BC, p.np, p.chunk, NPART);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_intra_kernel<NW, BC, NPART>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nbh, p.s / p.chunk, p.row_blocks * p.p_slabs);
  kernel<<<grid, NW * 32, smem, st>>>(
      static_cast<const bf16*>(ptrs[0]), static_cast<const bf16*>(ptrs[1]),
      static_cast<const float*>(ptrs[2]), static_cast<const float*>(ptrs[3]),
      static_cast<const bf16*>(ptrs[4]), static_cast<const bf16*>(ptrs[5]),
      static_cast<const bf16*>(ptrs[6]), static_cast<const bf16*>(ptrs[7]), y,
      p);
  return static_cast<int>(cudaGetLastError());
}

template <int NPART>
int launch_state(const void* const* ptrs, float* states, float* dsums,
                 int nbh, const SsdParams& p, cudaStream_t st) {
  const int smem = state_smem(p.np, p.chunk, NPART);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_state_kernel<NPART>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nbh, p.s / p.chunk, p.n_slabs * p.p_slabs);
  const int warps = min(p.np, kSlabN) / 16;
  kernel<<<grid, warps * 32, smem, st>>>(
      static_cast<const bf16*>(ptrs[0]), static_cast<const bf16*>(ptrs[1]),
      static_cast<const float*>(ptrs[2]), static_cast<const float*>(ptrs[3]),
      static_cast<const bf16*>(ptrs[4]), static_cast<const bf16*>(ptrs[5]),
      states, dsums, p);
  return static_cast<int>(cudaGetLastError());
}

template <int NPART>
int launch_parts(const void* const* ptrs, float* y, float* states,
                 float* dsums, int nbh, int bl, int bc, const SsdParams& p,
                 cudaStream_t st) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (bl == 64 && bc == 32) err = launch_intra<4, 32, NPART>(ptrs, y, nbh, p, st);
  if (bl == 64 && bc == 64) err = launch_intra<4, 64, NPART>(ptrs, y, nbh, p, st);
  if (bl == 128 && bc == 32) err = launch_intra<8, 32, NPART>(ptrs, y, nbh, p, st);
  if (bl == 128 && bc == 64) err = launch_intra<8, 64, NPART>(ptrs, y, nbh, p, st);
  if (err != 0) return err;
  return launch_state<NPART>(ptrs, states, dsums, nbh, p, st);
}

}  // namespace

// Both kernels on one stream.  x_hi, x_lo: (bh, s, p); dt: (bh, s) f32; A:
// (bh,) f32; B_hi, B_lo, C_hi, C_lo: (bh / rep, s, n); all bf16, 16-byte
// aligned, n and p multiples of 8.  The lo parts are null for bf16 inputs
// (one part) and given for f32 ones (two parts, from covenant_ssd_split).
// y: (bh, s, p) f32; states: (bh * s / chunk, n, p) f32; dsums: (bh * s /
// chunk,) f32.  bl is 64 or 128 rows, bc 32 or 64 columns.
extern "C" int covenant_ssd_scan_mma(const void* x_hi, const void* x_lo,
                                     const void* dt, const void* A,
                                     const void* b_hi, const void* b_lo,
                                     const void* c_hi, const void* c_lo,
                                     void* y, void* states, void* dsums,
                                     int bh, int s, int chunk, int n, int p,
                                     int rep, int bl, int bc, void* stream) {
  const int parts = x_lo != nullptr ? 2 : 1;
  const void* ptrs[8] = {x_hi, x_lo, dt, A, b_hi, b_lo, c_hi, c_lo};
  for (int i = 0; i < 8; ++i)
    if ((ptrs[i] == nullptr && (parts == 2 || (i != 1 && i != 5 && i != 7))) ||
        reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  if (chunk < 1 || s % chunk != 0 || n < 8 || n % 8 != 0 || p < 8 ||
      p % 8 != 0 || rep < 1 || bh % rep != 0 || s / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdParams prm{};
  prm.s = s;
  prm.chunk = chunk;
  prm.n = n;
  prm.p = p;
  prm.np = (n + 15) / 16 * 16;
  prm.rep = rep;
  prm.p_slabs = (p + kSlabP - 1) / kSlabP;
  prm.row_blocks = (chunk + bl - 1) / bl;
  prm.n_slabs = (prm.np + kSlabN - 1) / kSlabN;
  if (prm.row_blocks * prm.p_slabs > 65535 || prm.n_slabs * prm.p_slabs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  float* df = static_cast<float*>(dsums);
  if (parts == 2) return launch_parts<2>(ptrs, yf, sf, df, bh, bl, bc, prm, st);
  return launch_parts<1>(ptrs, yf, sf, df, bh, bl, bc, prm, st);
}

// f32 `in` (count values) as two bf16 parts `hi` + `lo`
extern "C" int covenant_ssd_split(const void* in, void* hi, void* lo,
                                  long long count, void* stream) {
  if (count <= 0) return 0;
  const long long blocks = (count + 255) / 256;
  split_kernel<<<static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16),
                 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<bf16*>(hi),
      static_cast<bf16*>(lo), static_cast<size_t>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* covenant_ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
