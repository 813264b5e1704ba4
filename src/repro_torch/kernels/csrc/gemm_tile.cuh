// The tile body shared by the port's GEMM kernels: K1 (batched_gemm.cu)
// and K2 (grouped_gemm.cu).
//
// One CTA of 256 threads computes one 64 x 64 output tile. A loop over K
// stages a 64 x 16 tile of x (stored transposed) and a 16 x 64 tile of w
// through shared memory as float32; each thread keeps a 4 x 4 micro-tile of
// float32 sums in registers, on rows ty + 16*i and columns tx + 16*j, so a
// warp's reads of the w tile hit 16 consecutive banks and its reads of the
// x tile are broadcasts. Loads are scalar and masked: rows at or past
// `row_end`, columns at or past N and depth at or past K read as 0, so no
// shape needs padding, no stride needs 16-byte alignment (an N = 1 row of w
// is 4 bytes), and no load reads past a row. Arithmetic is float32 FMA on
// the CUDA cores (no TF32); bf16 inputs are widened on load and the sum is
// rounded once, on the store.
//
// The sum order of one output element is fixed (k ascending within a
// stage, stages in order) and depends only on the operands of its own
// problem, so a problem's output is bit-identical whatever the others hold.
#pragma once

#include "common.cuh"

namespace repro {
namespace gemm {

constexpr int kBM = 64;        // output rows per CTA
constexpr int kBN = 64;        // output columns per CTA
constexpr int kBK = 16;        // depth of one shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTM = kBM / 16;  // micro-tile rows per thread
constexpr int kTN = kBN / 16;  // micro-tile columns per thread

// out[r, c] = sum_k x[r, k] * w[k, c] for row0 <= r < min(row0 + kBM,
// row_end) and col0 <= c < min(col0 + kBN, N). x is row-major with K
// columns, w row-major (K, N), out row-major with N columns; all three
// point at their problem's first element.
template <typename E>
__device__ __forceinline__ void tile(const typename E::T* __restrict__ x,
                                     const typename E::T* __restrict__ w,
                                     typename E::T* __restrict__ out, int row0,
                                     int row_end, int col0, int N, int K) {
  __shared__ float xs[kBK][kBM + 1];  // xs[k][row]; +1 spreads the stores
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kBM * kBK / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / kBK;  // 16 neighbouring threads read one row's run of k
      const int kk = e % kBK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      xs[kk][r] = (gr < row_end && gk < K) ? E::load(x, (long)gr * K + gk) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kBK * kBN / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int kk = e / kBN;  // 64 neighbouring threads read one row of w
      const int c = e % kBN;
      const int gk = k0 + kk;
      const int gc = col0 + c;
      ws[kk][c] = (gk < K && gc < N) ? E::load(w, (long)gk * N + gc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
      float b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= row_end) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) E::store(out, (long)r * N + c, acc[i][j]);
    }
  }
}

}  // namespace gemm
}  // namespace repro
