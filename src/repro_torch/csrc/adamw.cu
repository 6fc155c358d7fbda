// AdamW with global-norm clipping over every leaf of a parameter tree, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's optimizer (repro/optim/adamw.py)
// is jnp that XLA fuses.  Run eagerly, optim/adamw.py's update launches about
// twenty elementwise kernels a slice of every leaf, each reading and
// writing f32 temporaries, and its global norm three more; this source does
// both in two passes over the leaves.
//
// Bound on the H100: the bytes.  The update reads g, p, m and v and writes
// p, m and v: 22 bytes a bf16 parameter with f32 moments; the norm reads g
// once more (2 bytes).  A few dozen SIMT instructions an element stay far
// below the card's instruction rate, so the design is about the memory system:
// one pass, 16-byte vectors, every intermediate in registers.
//
// - The launch's leaves are rows of a table (struct Leaf, packed by
//   kernels/adamw.py): pointers, element count, the index of the leaf's
//   first chunk of `chunk` elements, and flags (bf16 gradient, bf16 param,
//   decayed).  One block takes one chunk, finds its leaf by a binary search
//   over the first-chunk indices, and walks the chunk in 8-element vectors
//   (one 16-byte load of bf16, two of f32), with a scalar loop for the tail
//   and for a leaf whose pointers are not 16-byte aligned.  Offsets are 64
//   bits: command-r-plus-104b's tied embedding is one leaf of 3.1 B
//   elements.
// - sq_chunk_kernel sums a chunk's squares in f32 (8 running sums a thread,
//   a fixed shuffle tree over the block) into one partial a chunk;
//   sq_leaf_kernel adds each leaf's partials, one block a leaf, in a fixed
//   order.  No atomics: a run repeats bit for bit.
// - update_kernel does AdamW's whole element step in registers.  Every
//   operation is an IEEE-rounded intrinsic (__fmul_rn, __fadd_rn,
//   __fsub_rn, __fdiv_rn, __fsqrt_rn) in the order of the eager
//   expressions, and the constants come in as the f32 that PyTorch rounds
//   a Python scalar to, so with the same norm the result is the eager
//   path's bit for bit; nvcc's default --fmad=true cannot contract them.
//   The clip scale, the bias corrections and the learning rate are read
//   from device memory, so the step never waits for the host.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements of one vector step: 16 bytes of bf16

enum : long long { kGradBf16 = 1, kParamBf16 = 2, kDecay = 4 };

// one row of the leaf table: 10 int64s, as kernels/adamw.py packs them
struct Leaf {
  const void* g;
  const void* p;
  const float* m;
  const float* v;
  void* p_out;
  float* m_out;
  float* v_out;
  long long n;       // elements
  long long chunk0;  // index of its first chunk in the launch
  long long flags;
};
static_assert(sizeof(Leaf) == 80, "the table packs 10 int64s a leaf");

struct Consts {  // Python floats as f32, as PyTorch rounds them
  float b1, omb1, b2, omb2, eps, wd;
};

struct Scalars {  // 0-d device tensors of the step
  float scale, b1c, b2c, lr;
};

// the leaf whose chunks hold chunk c: the last with chunk0 <= c
__device__ __forceinline__ int leaf_of(const Leaf* __restrict__ leaves,
                                       int n_leaves, long long c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (leaves[mid].chunk0 <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: what `.to(T)` then `.to(float32)` gives
template <typename T> __device__ __forceinline__ float rounded(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// the block's sum of one float a thread, in a fixed order; valid in thread 0
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_down_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = 0.f;
  if (warp == 0) {
    x = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// ---------------------------------------------------------------------------
// sums of squares
// ---------------------------------------------------------------------------

template <typename G>
__device__ float chunk_sq(const G* __restrict__ g, long long len) {
  float acc[kVec] = {};
  const long long nvec = aligned16(g) ? len / kVec : 0;
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    float x[kVec];
    load8(g + i * kVec, x);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = __fmaf_rn(x[j], x[j], acc[j]);
  }
  for (long long i = nvec * kVec + threadIdx.x; i < len; i += kThreads) {
    const float x = to_f32(g[i]);
    acc[0] = __fmaf_rn(x, x, acc[0]);
  }
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
         ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

__global__ void __launch_bounds__(kThreads)
sq_chunk_kernel(const Leaf* __restrict__ leaves, int n_leaves, long long chunk,
                float* __restrict__ partials) {
  const long long c = blockIdx.x;
  const Leaf& leaf = leaves[leaf_of(leaves, n_leaves, c)];
  const long long start = (c - leaf.chunk0) * chunk;
  const long long len = min(chunk, leaf.n - start);
  const float t = leaf.flags & kGradBf16
                      ? chunk_sq(static_cast<const bf16*>(leaf.g) + start, len)
                      : chunk_sq(static_cast<const float*>(leaf.g) + start, len);
  const float s = block_sum(t);
  if (threadIdx.x == 0) partials[c] = s;
}

__global__ void __launch_bounds__(kThreads)
sq_leaf_kernel(const Leaf* __restrict__ leaves, int n_leaves,
               long long n_chunks, const float* __restrict__ partials,
               float* __restrict__ sums) {
  const int l = blockIdx.x;
  const long long c0 = leaves[l].chunk0;
  const long long c1 = l + 1 < n_leaves ? leaves[l + 1].chunk0 : n_chunks;
  float acc = 0.f;
  for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) acc += partials[c];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) sums[l] = s;
}

// ---------------------------------------------------------------------------
// the update
// ---------------------------------------------------------------------------

// one element's step, as optim/adamw.py's eager expressions round it:
//   gf = f32(G(g * scale)); m = b1*m + (1-b1)*gf; v = b2*v + (1-b2)*gf^2;
//   delta = (m / b1c) / (sqrt(v / b2c) + eps) [+ wd * p]; p - lr * delta
template <typename G>
__device__ __forceinline__ float step(float g, float& m, float& v, float p,
                                      bool decay, const Consts& k,
                                      const Scalars& s) {
  const float gf = rounded<G>(__fmul_rn(g, s.scale));
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(k.omb1, gf));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(k.omb2, __fmul_rn(gf, gf)));
  float delta = __fdiv_rn(__fdiv_rn(m, s.b1c),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), k.eps));
  if (decay) delta = __fadd_rn(delta, __fmul_rn(k.wd, p));
  return __fsub_rn(p, __fmul_rn(s.lr, delta));
}

template <typename G, typename P>
__device__ void update_chunk(const Leaf& leaf, long long start, long long len,
                             const Consts& k, const Scalars& s) {
  const G* __restrict__ g = static_cast<const G*>(leaf.g) + start;
  const P* __restrict__ p = static_cast<const P*>(leaf.p) + start;
  const float* m = leaf.m + start;
  const float* v = leaf.v + start;
  P* __restrict__ p_out = static_cast<P*>(leaf.p_out) + start;
  float* m_out = leaf.m_out + start;
  float* v_out = leaf.v_out + start;
  const bool decay = leaf.flags & kDecay;
  const bool vec = aligned16(g) && aligned16(p) && aligned16(m) &&
                   aligned16(v) && aligned16(p_out) && aligned16(m_out) &&
                   aligned16(v_out);
  const long long nvec = vec ? len / kVec : 0;
  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    const long long o = i * kVec;
    float gx[kVec], px[kVec], mx[kVec], vx[kVec];
    load8(g + o, gx);
    load8(p + o, px);
    load8(m + o, mx);
    load8(v + o, vx);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      px[j] = step<G>(gx[j], mx[j], vx[j], px[j], decay, k, s);
    store8(p_out + o, px);
    store8(m_out + o, mx);
    store8(v_out + o, vx);
  }
  for (long long i = nvec * kVec + threadIdx.x; i < len; i += kThreads) {
    float mi = m[i], vi = v[i];
    const float pi = step<G>(to_f32(g[i]), mi, vi, to_f32(p[i]), decay, k, s);
    p_out[i] = from_f32<P>(pi);
    m_out[i] = mi;
    v_out[i] = vi;
  }
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const Leaf* __restrict__ leaves, int n_leaves, long long chunk,
              Consts k, const float* scale, const float* b1c,
              const float* b2c, const float* lr) {
  const long long c = blockIdx.x;
  const Leaf leaf = leaves[leaf_of(leaves, n_leaves, c)];
  const long long start = (c - leaf.chunk0) * chunk;
  const long long len = min(chunk, leaf.n - start);
  const Scalars s{*scale, *b1c, *b2c, *lr};
  switch (leaf.flags & (kGradBf16 | kParamBf16)) {
    case 0: update_chunk<float, float>(leaf, start, len, k, s); break;
    case kGradBf16: update_chunk<bf16, float>(leaf, start, len, k, s); break;
    case kParamBf16: update_chunk<float, bf16>(leaf, start, len, k, s); break;
    default: update_chunk<bf16, bf16>(leaf, start, len, k, s); break;
  }
}

bool launchable(const void* leaves, int n_leaves, long long n_chunks,
                long long chunk) {
  return leaves != nullptr && n_leaves >= 1 && n_leaves <= 0x7fffffff &&
         n_chunks >= n_leaves && n_chunks <= 0x7fffffff && chunk >= kVec &&
         chunk % kVec == 0;
}

}  // namespace

// The sum of squares of each leaf's gradient.  leaves: (n_leaves,) rows of
// the table in device memory, each leaf at least one element, chunk0 the
// running count of chunks of `chunk` elements; partials: (n_chunks,) f32
// scratch; sums: (n_leaves,) f32.
extern "C" int covenant_adamw_sq_sums(const void* leaves, int n_leaves,
                                      long long n_chunks, long long chunk,
                                      void* partials, void* sums,
                                      void* stream) {
  if (!launchable(leaves, n_leaves, n_chunks, chunk) || partials == nullptr ||
      sums == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Leaf* table = static_cast<const Leaf*>(leaves);
  float* part = static_cast<float*>(partials);
  sq_chunk_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0, st>>>(
      table, n_leaves, chunk, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sq_leaf_kernel<<<static_cast<unsigned>(n_leaves), kThreads, 0, st>>>(
      table, n_leaves, n_chunks, part, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

// One AdamW step of every leaf of the table.  b1, 1 - b1, b2, 1 - b2, eps
// and weight_decay as f32; scale (the clip's), b1c and b2c (the bias
// corrections) and lr: 0-d f32 device tensors.  m_out and v_out may be m
// and v (in place); p_out is never p.
extern "C" int covenant_adamw_update(const void* leaves, int n_leaves,
                                     long long n_chunks, long long chunk,
                                     float b1, float omb1, float b2,
                                     float omb2, float eps, float wd,
                                     const void* scale, const void* b1c,
                                     const void* b2c, const void* lr,
                                     void* stream) {
  if (!launchable(leaves, n_leaves, n_chunks, chunk) || scale == nullptr ||
      b1c == nullptr || b2c == nullptr || lr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{b1, omb1, b2, omb2, eps, wd};
  update_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves, chunk, k,
      static_cast<const float*>(scale), static_cast<const float*>(b1c),
      static_cast<const float*>(b2c), static_cast<const float*>(lr));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* covenant_adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
