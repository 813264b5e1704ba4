// Shared helpers for the port's hand-written Hopper kernels.
//
// Element access is templated on the storage type: float32, or bfloat16
// kept as raw 16-bit words (widening a bf16 word to f32 is a shift; the
// store rounds to nearest even, as torch's own .to(torch.bfloat16) does).
// All arithmetic inside the kernels is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;  // the TPU kernels' finite mask value

template <bool BF16>
struct Elem;

template <>
struct Elem<false> {
  using T = float;
  static constexpr int kVec = 4;  // elements per 16-byte vector
  __device__ __forceinline__ static float load(const T* p, long i) { return p[i]; }
  __device__ __forceinline__ static void store(T* p, long i, float x) { p[i] = x; }
  __device__ __forceinline__ static void unpack(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};

template <>
struct Elem<true> {
  using T = uint16_t;
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float widen(uint32_t h) { return __uint_as_float(h << 16); }
  __device__ __forceinline__ static float load(const T* p, long i) { return widen(p[i]); }
  __device__ __forceinline__ static void store(T* p, long i, float x) {
    p[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* o) {
    // little-endian: the low half of each 32-bit word is the earlier element
    o[0] = widen(r.x & 0xffffu);
    o[1] = __uint_as_float(r.x & 0xffff0000u);
    o[2] = widen(r.y & 0xffffu);
    o[3] = __uint_as_float(r.y & 0xffff0000u);
    o[4] = widen(r.z & 0xffffu);
    o[5] = __uint_as_float(r.z & 0xffff0000u);
    o[6] = widen(r.w & 0xffffu);
    o[7] = __uint_as_float(r.w & 0xffff0000u);
  }
};

// Copy `n_rows` rows of D contiguous elements (one contiguous run of
// n_rows*D elements starting at `src`, 16-byte aligned) into shared memory
// as float32 with row stride `dst_stride`, then zero rows n_rows..tile_rows-1
// so that no stale value ever meets a zero softmax weight (0 * NaN = NaN).
// All threads of the block take part; loads are 16-byte vectors, neighbouring
// threads on neighbouring addresses.
template <typename E, int D>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const typename E::T* __restrict__ src,
                                          int n_rows, int tile_rows) {
  constexpr int V = E::kVec;
  static_assert(D % V == 0, "a 16-byte vector must not straddle two rows");
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  const int nvec = n_rows * (D / V);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float vals[V];
    E::unpack(__ldg(src4 + i), vals);
    const int e = i * V;
    float* o = dst + (e / D) * dst_stride + (e % D);
#pragma unroll
    for (int u = 0; u < V; ++u) o[u] = vals[u];
  }
  for (int e = n_rows * D + threadIdx.x; e < tile_rows * D; e += blockDim.x) {
    dst[(e / D) * dst_stride + (e % D)] = 0.f;
  }
}

}  // namespace repro

// Status codes the C entry points return besides cudaError_t values.
#define REPRO_BAD_ARGUMENT (-1)
