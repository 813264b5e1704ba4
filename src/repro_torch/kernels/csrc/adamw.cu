// AdamW over a whole parameter tree in two launches (kernels of the port's
// own).
//
// Replace no Pallas kernel. The JAX package's optimizer is jnp,
// src/repro/training/optimizer.py::adamw_update (:41), which XLA fuses inside
// the jitted train step (src/repro/training/train_loop.py:67). As plain
// PyTorch ops (kernels/ref.py::adamw_norm, ::adamw_update) it is about 20
// float32 passes over every leaf. Here a step is two launches:
//   adamw_norm_kernel    the float32 sum of squares of every gradient element
//                        over all leaves, then its square root. Each block
//                        writes its tile's sum to a fixed slot; the last
//                        block to finish (an integer counter, no float
//                        atomics) adds the slots in a fixed order. Every run,
//                        eager or replayed in a graph, gives the same bits.
//   adamw_update_kernel  reads g, p, m and v once and writes p, m and v once,
//                        in the plain version's order of operations, each
//                        rounded as the plain version's own kernels round it
//                        (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: nvcc
//                        contracts none of them into an FMA), so that given
//                        the same scale, bias corrections and lr its p, m and
//                        v equal the plain version's bit for bit.
//
// What bounds it on an H100: bytes. A bf16 parameter costs 2 bytes of g in
// the norm pass and 22 in the update (g and p read, p written, float32 m and
// v read and written) against ~17 float32 operations; at 3.35 TB/s
// stablelm-1.6b's 1.64e9 parameters take at least 11.8 ms. The design:
//   * the leaves (hundreds, from 1 to 2e8 elements, bf16 and float32) travel
//     by value in the launch's parameters (a Pack of up to 640 leaves, ~28 KB
//     of the 32,764 bytes a kernel may take), the multi-tensor-apply pattern:
//     a CUDA graph records them with the launch, and a replay reads nothing
//     from host memory. The scale, bias corrections and lr are read from
//     device memory, so a replay sees this step's values;
//   * each leaf is cut into tiles of 8,192 elements; block b takes the pack's
//     tile b, finds its leaf by a binary search over the leaves' first tiles
//     (an array of its own, every thread reading the same words) and walks
//     the tile in vectors of 8 elements a thread (16-byte loads and stores),
//     neighbouring threads on neighbouring vectors, with 64-bit element
//     offsets; a leaf's last vector may be short and goes element by element;
//   * the leaves come grouped by dtype, bf16 first, so one comparison with
//     the pack's first float32 leaf picks the block's element type.
#include <limits.h>

#include "common.cuh"

namespace {

using repro::Elem;

constexpr int kThreads = 256;
constexpr int kVec = 8;                          // elements a thread takes at once
constexpr int kSteps = 4;                        // vectors a thread takes in a tile
constexpr int kTile = kThreads * kVec * kSteps;  // 8,192 elements a block
constexpr int kMaxLeaves = 640;                  // leaves a launch takes
constexpr int kParamLimit = 32764;               // bytes of kernel parameters (CUDA 12.1+)

// The launch's leaves as arrays, so that a block's search for its leaf reads
// only `tile0` (a few KB of the constant bank), not the pointers.
struct Pack {
  int n_leaves;
  int first_f32;  // leaves [first_f32, n_leaves) are float32, the rest bf16
  int tile0_all;  // the pack's first tile (its first leaf's)
  int tiles;      // the pack's tiles: the launch's blocks
  int tile0[kMaxLeaves];  // each leaf's first tile, counted over the whole plan
  long long n[kMaxLeaves];  // elements
  const void* g[kMaxLeaves];
  void* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
};

// One leaf of a pack, in registers.
struct Leaf {
  const void* g;
  void* p;
  float* m;
  float* v;
  long long n;
  long long tile0;
};

// The plain version's Python floats, each as float32 (c1 = 1 - b1, c2 = 1 - b2
// computed in double first, as Python does).
struct Consts {
  float b1, c1, b2, c2, eps, wd;
};

struct Scalars {
  float scale, bc1, bc2, lr;
};

static_assert(sizeof(Pack) == 16 + kMaxLeaves * 44,
              "the wrapper's PACK_HEADER_BYTES and LEAF_BYTES");
static_assert(sizeof(Pack) + 4 * sizeof(float*) + sizeof(Consts) <= kParamLimit,
              "the update kernel's parameters exceed the limit");
static_assert(sizeof(Pack) + 3 * sizeof(float*) + sizeof(unsigned) <= kParamLimit,
              "the norm kernel's parameters exceed the limit");

// The leaf that holds plan-wide tile t: the last one whose first tile is <= t.
__device__ __forceinline__ int find_leaf(const Pack& pk, int t) {
  int lo = 0, hi = pk.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pk.tile0[mid] <= t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ Leaf leaf_of(const Pack& pk, int i) {
  return {pk.g[i], pk.p[i], pk.m[i], pk.v[i], pk.n[i], pk.tile0[i]};
}

// 8 elements from p + e, widened to float32: a read-only pass (ld.global.nc)
// or a coherent one for the arrays the update writes back.
template <bool BF16, bool READ_ONLY>
__device__ __forceinline__ void load8(const typename Elem<BF16>::T* p, long long e, float* x) {
  const uint4* q = reinterpret_cast<const uint4*>(p + e);
  constexpr int kWords = BF16 ? 1 : 2;  // 16-byte words in 8 elements
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    Elem<BF16>::unpack(READ_ONLY ? __ldg(q + w) : q[w], x + w * Elem<BF16>::kVec);
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// 8 float32 values stored at p + e, rounded to nearest even for bf16.
template <bool BF16>
__device__ __forceinline__ void store8(typename Elem<BF16>::T* p, long long e, const float* x) {
  uint4* q = reinterpret_cast<uint4*>(p + e);
  if constexpr (BF16) {
    *q = make_uint4(bf16_pair(x[0], x[1]), bf16_pair(x[2], x[3]), bf16_pair(x[4], x[5]),
                    bf16_pair(x[6], x[7]));
  } else {
    q[0] = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
    q[1] = make_uint4(__float_as_uint(x[4]), __float_as_uint(x[5]), __float_as_uint(x[6]),
                      __float_as_uint(x[7]));
  }
}

// The block's sum of x in a fixed order (each warp by xor shuffles, then the
// 8 warps' sums by warp 0); valid in thread 0. `red` holds kThreads / 32.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = kThreads / 64; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// This thread's share of the sum of squares of g over a tile from e0.
template <bool BF16>
__device__ __forceinline__ float tile_sumsq(const void* g_, long long e0, long long n) {
  const typename Elem<BF16>::T* g = static_cast<const typename Elem<BF16>::T*>(g_);
  float acc = 0.f;
  if (e0 + kTile <= n) {  // a whole tile: every load in flight at once, the same order of sums
    float x[kSteps][kVec];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      load8<BF16, true>(g, e0 + (long long)(s * kThreads + threadIdx.x) * kVec, x[s]);
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int u = 0; u < kVec; ++u) acc = fmaf(x[s][u], x[s][u], acc);
    return acc;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long e = e0 + (long long)(s * kThreads + threadIdx.x) * kVec;
    if (e + kVec <= n) {
      float x[kVec];
      load8<BF16, true>(g, e, x);
#pragma unroll
      for (int u = 0; u < kVec; ++u) acc = fmaf(x[u], x[u], acc);
    } else {
      for (long long k = e; k < n; ++k) {
        const float x = Elem<BF16>::load(g, k);
        acc = fmaf(x, x, acc);
      }
    }
  }
  return acc;
}

// Phase (a). `done` counts finished blocks over every launch of the plan (it
// is zeroed before the first); the block that brings it to total_tiles is the
// last launch's last block, and only it reads the slots.
__global__ void __launch_bounds__(kThreads)
    adamw_norm_kernel(const __grid_constant__ Pack pk, float* partials, unsigned* done,
                      unsigned total_tiles, float* gnorm) {
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  const int t = pk.tile0_all + blockIdx.x;
  const int i = find_leaf(pk, t);
  const Leaf L = leaf_of(pk, i);
  const long long e0 = (t - L.tile0) * kTile;
  const float mine = i < pk.first_f32 ? tile_sumsq<true>(L.g, e0, L.n)
                                      : tile_sumsq<false>(L.g, e0, L.n);
  const float tile = block_sum(mine, red);
  if (threadIdx.x == 0) {
    partials[t] = tile;
    __threadfence();
    last = atomicAdd(done, 1u) == total_tiles - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc = 0.f;
  for (unsigned j = threadIdx.x; j < total_tiles; j += kThreads) acc += __ldcg(partials + j);
  const float sum = block_sum(acc, red);
  if (threadIdx.x == 0) *gnorm = __fsqrt_rn(sum);
}

// One element, as kernels/ref.py::adamw_update computes it in float32:
//   g32 = g * scale;  m = b1 m + (1 - b1) g32;  v = b2 v + (1 - b2) g32^2
//   delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd p;  p = p - lr delta
__device__ __forceinline__ void adamw_elem(float g, float& p, float& m, float& v,
                                           const Scalars& s, const Consts& c) {
  const float g32 = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(c.c1, g32));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(c.c2, __fmul_rn(g32, g32)));
  const float mhat = __fdiv_rn(m, s.bc1);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), c.eps);
  const float delta = __fadd_rn(__fdiv_rn(mhat, den), __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
}

template <bool BF16>
__device__ __forceinline__ void tile_update(const Leaf L, long long e0, const Scalars& s,
                                            const Consts& c) {
  using T = typename Elem<BF16>::T;
  const T* __restrict__ g = static_cast<const T*>(L.g);
  T* __restrict__ p = static_cast<T*>(L.p);
  float* __restrict__ m = L.m;
  float* __restrict__ v = L.v;
  const long long n = L.n;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const long long e = e0 + (long long)(st * kThreads + threadIdx.x) * kVec;
    if (e + kVec <= n) {
      float gv[kVec], pv[kVec], mv[kVec], vv[kVec];
      load8<BF16, true>(g, e, gv);
      load8<BF16, false>(p, e, pv);
      load8<false, false>(m, e, mv);
      load8<false, false>(v, e, vv);
#pragma unroll
      for (int u = 0; u < kVec; ++u) adamw_elem(gv[u], pv[u], mv[u], vv[u], s, c);
      store8<BF16>(p, e, pv);
      store8<false>(m, e, mv);
      store8<false>(v, e, vv);
    } else {
      for (long long k = e; k < n; ++k) {
        float pk = Elem<BF16>::load(p, k), mk = m[k], vk = v[k];
        adamw_elem(Elem<BF16>::load(g, k), pk, mk, vk, s, c);
        Elem<BF16>::store(p, k, pk);
        m[k] = mk;
        v[k] = vk;
      }
    }
  }
}

// Phase (b): p, m and v of the pack's tiles updated in place.
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(const __grid_constant__ Pack pk, const float* scale, const float* bc1,
                        const float* bc2, const float* lr, const Consts c) {
  const Scalars s = {__ldg(scale), __ldg(bc1), __ldg(bc2), __ldg(lr)};
  const int t = pk.tile0_all + blockIdx.x;
  const int i = find_leaf(pk, t);
  const Leaf L = leaf_of(pk, i);
  const long long e0 = (t - L.tile0) * kTile;
  if (i < pk.first_f32) {
    tile_update<true>(L, e0, s, c);
  } else {
    tile_update<false>(L, e0, s, c);
  }
}

bool aligned(long long addr) { return addr != 0 && addr % 16 == 0; }

}  // namespace

extern "C" {

// kind 0: the norm pass over the pack's gradients into partials[tile0 ..
// tile0 + tiles) of a plan of total_tiles tiles, `done` the plan's counter
// (zeroed here when tile0 is 0), sqrt of the plan's sum written to *gnorm by
// the last block; kind 1: the update of the pack's leaves, reading *scale,
// *bc1, *bc2 and *lr. The pack: n_leaves (1..640) leaves, `ptrs` 4 per leaf
// (g, p, m, v; kind 0 reads g only), `numels` (each > 0) and `tile0s` (each
// leaf's first plan-wide tile: tile0 for the first, then the previous one's
// plus ceil(numel / 8192)); leaves [first_f32, n_leaves) float32, the others
// bf16 (g and p of one dtype; m, v float32), every array 16-byte aligned.
// Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_adamw(int kind, int n_leaves, int first_f32, long long tile0, long long tiles,
                long long total_tiles, const long long* ptrs, const long long* numels,
                const long long* tile0s, float* partials, unsigned* done, float* gnorm,
                const float* scale, const float* bc1, const float* bc2, const float* lr, float b1,
                float c1, float b2, float c2, float eps, float wd, void* stream) {
  if ((kind != 0 && kind != 1) || n_leaves < 1 || n_leaves > kMaxLeaves || first_f32 < 0 ||
      first_f32 > n_leaves || tile0 < 0 || tiles < 1 || total_tiles < tile0 + tiles ||
      total_tiles > INT_MAX || !ptrs || !numels || !tile0s)
    return REPRO_BAD_ARGUMENT;
  if (kind == 0 ? (!partials || !done || !gnorm) : (!scale || !bc1 || !bc2 || !lr))
    return REPRO_BAD_ARGUMENT;
  Pack pk = {};
  pk.n_leaves = n_leaves;
  pk.first_f32 = first_f32;
  pk.tile0_all = (int)tile0;
  pk.tiles = (int)tiles;
  long long next = tile0;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* q = ptrs + 4 * i;
    if (numels[i] <= 0 || tile0s[i] != next || !aligned(q[0]) ||
        (kind == 1 && (!aligned(q[1]) || !aligned(q[2]) || !aligned(q[3]))))
      return REPRO_BAD_ARGUMENT;
    pk.tile0[i] = (int)next;
    pk.n[i] = numels[i];
    pk.g[i] = reinterpret_cast<const void*>(q[0]);
    pk.p[i] = reinterpret_cast<void*>(q[1]);
    pk.m[i] = reinterpret_cast<float*>(q[2]);
    pk.v[i] = reinterpret_cast<float*>(q[3]);
    next += (numels[i] + kTile - 1) / kTile;
  }
  if (next != tile0 + tiles) return REPRO_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (tile0 == 0) {
      const cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned), s);
      if (err != cudaSuccess) return (int)err;
    }
    adamw_norm_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(pk, partials, done,
                                                            (unsigned)total_tiles, gnorm);
  } else {
    adamw_update_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(pk, scale, bc1, bc2, lr,
                                                              Consts{b1, c1, b2, c2, eps, wd});
  }
  return (int)cudaGetLastError();
}

// Bytes of the update kernel's parameters (the build report).
int repro_adamw_param_bytes() {
  return (int)(sizeof(Pack) + 4 * sizeof(float*) + sizeof(Consts));
}

const char* repro_adamw_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
