// The space-time super-kernel: R independent GEMMs in one launch (K1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/batched_gemm.py::
// batched_gemm (pallas_call at :91, body _gemm_kernel at :31). Computes
// out[r] = x[r] @ w[r] for x (R, M, K) and w (R, K, N), each problem with
// its own weights (one tenant each): float32 accumulation, output in the
// input dtype. The problem index R rides on the grid (or the tile list) as
// it does in the Pallas kernel, so R small problems fill the card together
// where one alone would leave most of its 132 SMs idle (the paper's point).
// Ragged M, N and K are masked in the kernels; the Pallas version copy-pads
// every dim to a block multiple instead.
//
// Three kernels, one chosen by the wrapper before the launch (never as a
// fallback): `wgmma` for bf16 whose rows TMA can stride, `simt` for
// everything else, all float32 included (its 2e-4 tolerance rules out TF32),
// and `cuda_core`, the first version, launched only when asked for.
//
// * wgmma (bf16, K > 0, K % 8 == 0, N % 8 == 0). The reference computes
//   jnp.dot(bf16, bf16, preferred_element_type=f32): a bf16 tensor-core
//   product with float32 accumulation. What bounds it: operations at
//   prefill-sized M, bytes of w at decode-sized M. The mainloop is K2's
//   (gemm_sm90.cuh): a persistent grid, a producer warp keeping a 4-stage TMA
//   ring, consumer warpgroups on m64n128k16. K1's row tiles are regular, so
//   the kernel computes them from the tile index (no table is built or
//   uploaded): problem r's row tile i stores rows r*M + bm*i .. min(that + bm,
//   (r+1)*M) - 1, bm = 128 (two consumer warpgroups), or 64 (one) where M <=
//   64 so decode-sized problems still spread over the SMs. x is one 2-D map
//   over (R*M, K): a row tile that runs past its problem reads the next
//   problem's x rows into accumulator rows that are never stored; w is a 3-D
//   map over (R, K, N), so a K or N tail reads zeros.
// * simt (float32, and bf16 the wgmma kernel does not take). What bounds it:
//   operations, 2*M*N*K over 67 TFLOP/s outside the tensor cores (Table 1's
//   conv2_2 and square shapes), or bytes for the N = 1 matvec. One CTA of
//   128 threads per 64 x 64 output tile and K split s ways (s from K alone,
//   see the wrapper) across a cluster of s CTAs, so run 1's median dispatch
//   (8, 256, 1152, 128) is 256 CTAs where 64 x 64 tiles alone give 64. Each
//   thread keeps an 8 x 4 float32 micro-tile: per 4-deep k step it reads 8
//   16-byte x vectors (x stays row-major in shared memory, 4 k values per
//   read) and 4 w vectors for 128 FMAs. A 3-stage ring of 64 x 16 x and
//   16 x 64 w stages is filled by 16-byte cp.async (zero-filled past M, N and
//   the CTA's K range) where K and N are multiples of 4 floats, by masked
//   scalar loads otherwise (and for bf16). After the K loop each CTA leaves
//   its partial tile in shared memory; after cluster.sync() rank q sums rows
//   64q/s .. 64(q+1)/s - 1 of the s partials in rank order through
//   distributed shared memory and stores them, and a second cluster.sync()
//   keeps every partial alive until it has been read. No atomics, no
//   workspace.
// * cuda_core: gemm_tile.cuh's 64 x 64 tile, 4 x 4 micro-tiles fed by
//   scalar shared loads, synchronous masked loads (the first version, kept so
//   its time can be compared).
//
// Every output element's sum runs over k in an order fixed by K alone, and
// reads only its own problem's operands, so a problem's output is
// bit-identical whatever the other problems hold.
#include <cooperative_groups.h>

#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

using repro::Elem;
namespace cg = cooperative_groups;
namespace gemm = repro::gemm;
namespace gemm_sm90 = repro::gemm_sm90;
namespace sm90 = repro::sm90;

enum Variant { kCudaCore = 0, kWgmma = 1, kSimt = 2 };

// ---------------------------------------------------------------- cuda_core
template <bool BF16>
__global__ void __launch_bounds__(gemm::kThreads)
batched_gemm_kernel(const typename Elem<BF16>::T* __restrict__ x,
                    const typename Elem<BF16>::T* __restrict__ w,
                    typename Elem<BF16>::T* __restrict__ out, int M, int N,
                    int K) {
  const long r = blockIdx.z;
  gemm::tile<Elem<BF16>>(x + r * M * K, w + r * K * N, out + r * M * N,
                         blockIdx.y * gemm::kBM, M, blockIdx.x * gemm::kBN, N, K);
}

template <bool BF16>
int launch_cuda_core(const void* x, const void* w, void* out, int R, int M, int N, int K,
                     cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  const dim3 grid((N + gemm::kBN - 1) / gemm::kBN, (M + gemm::kBM - 1) / gemm::kBM, R);
  batched_gemm_kernel<BF16><<<grid, gemm::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma
struct BatchedTiles {
  int M;       // rows per problem
  int per;     // row tiles per problem
  int bm;      // rows per tile
  __device__ __forceinline__ gemm_sm90::Tile operator()(int rt) const {
    const int r = rt / per;
    const int row0 = r * M + (rt % per) * bm;
    const int end = (r + 1) * M;
    return {row0, row0 + bm < end ? row0 + bm : end, r};
  }
};

int launch_wgmma(const void* x, const void* w, void* out, int R, int M, int N, int K,
                 int tile_rows, cudaStream_t stream) {
  if (tile_rows != 64 && tile_rows != 128) return REPRO_BAD_ARGUMENT;
  const int per = (M + tile_rows - 1) / tile_rows;
  const long n_row_tiles = (long)R * per;
  if (n_row_tiles > 0x7fffffffL / ((N + gemm_sm90::kBN - 1) / gemm_sm90::kBN))
    return REPRO_BAD_ARGUMENT;
  const BatchedTiles tiles{M, per, tile_rows};
  if (tile_rows == 64)
    return gemm_sm90::launch<1>(x, w, tiles, out, (int)n_row_tiles, (long)R * M, R, N, K, stream);
  return gemm_sm90::launch<2>(x, w, tiles, out, (int)n_row_tiles, (long)R * M, R, N, K, stream);
}

// ---------------------------------------------------------------- simt
namespace simt {
constexpr int kBM = 64;        // output rows per CTA
constexpr int kBN = 64;        // output columns per CTA
constexpr int kBK = 16;        // depth of one stage
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 8 row groups x 16 column groups
constexpr int kTM = 8;         // micro-tile rows per thread (consecutive)
constexpr int kTN = 4;         // micro-tile columns per thread (consecutive)
constexpr int kXS = kBM * kBK;  // floats of one x stage, xs[row][k]
constexpr int kWS = kBK * kBN;  // floats of one w stage, ws[k][col]
constexpr int kMaxSplits = 4;
static_assert(kBM * kBN <= kStages * (kXS + kWS), "the partial tile reuses the ring");
}  // namespace simt

// Fill one ring stage with x rows row0.., w columns col0.., depth k0..k0+15,
// zeros at or past M rows, N columns and k_end. VEC: 16-byte cp.async (K and
// N multiples of 4, float32); otherwise masked scalar loads widened to float.
template <typename E, bool VEC>
__device__ __forceinline__ void simt_load(float* xs, float* ws, const typename E::T* x,
                                          const typename E::T* w, int row0, int M, int col0,
                                          int N, int K, int k0, int k_end) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int l = 0; l < simt::kXS / 4 / simt::kThreads; ++l) {
      const int c = tid + l * simt::kThreads;
      const int r = c / (simt::kBK / 4);   // 4 neighbouring threads copy one row's 16 k
      const int kc = (c % (simt::kBK / 4)) * 4;
      const bool ok = row0 + r < M && k0 + kc < k_end;
      const float* src = ok ? x + (long)(row0 + r) * K + k0 + kc : x;
      sm90::cp_async16(xs + r * simt::kBK + kc, src, ok);
    }
#pragma unroll
    for (int l = 0; l < simt::kWS / 4 / simt::kThreads; ++l) {
      const int c = tid + l * simt::kThreads;
      const int kk = c / (simt::kBN / 4);  // 16 neighbouring threads copy one row of w
      const int nc = (c % (simt::kBN / 4)) * 4;
      const bool ok = k0 + kk < k_end && col0 + nc < N;
      const float* src = ok ? w + (long)(k0 + kk) * N + col0 + nc : w;
      sm90::cp_async16(ws + kk * simt::kBN + nc, src, ok);
    }
  } else {
#pragma unroll
    for (int l = 0; l < simt::kXS / simt::kThreads; ++l) {
      const int e = tid + l * simt::kThreads;
      const int r = e / simt::kBK;
      const int kk = e % simt::kBK;
      xs[e] = (row0 + r < M && k0 + kk < k_end) ? E::load(x, (long)(row0 + r) * K + k0 + kk)
                                                : 0.f;
    }
#pragma unroll
    for (int l = 0; l < simt::kWS / simt::kThreads; ++l) {
      const int e = tid + l * simt::kThreads;
      const int kk = e / simt::kBN;
      const int c = e % simt::kBN;
      ws[e] = (k0 + kk < k_end && col0 + c < N) ? E::load(w, (long)(k0 + kk) * N + col0 + c)
                                                : 0.f;
    }
  }
}

// Grid (column tiles * splits, row tiles, R), clusters of `splits` CTAs along
// x: rank q of a cluster sums k in [q * k_chunk, min((q + 1) * k_chunk, K)).
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(simt::kThreads)
batched_gemm_simt(const typename Elem<BF16>::T* __restrict__ x,
                  const typename Elem<BF16>::T* __restrict__ w,
                  typename Elem<BF16>::T* __restrict__ out, int M, int N, int K, int k_chunk) {
  using E = Elem<BF16>;
  __shared__ __align__(16) float ring[simt::kStages * (simt::kXS + simt::kWS)];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int col0 = (blockIdx.x / splits) * simt::kBN;
  const int row0 = blockIdx.y * simt::kBM;
  const long r = blockIdx.z;
  x += r * M * K;
  w += r * K * N;
  out += r * M * N;
  const int k_begin = min(rank * k_chunk, K);
  const int k_end = min(k_begin + k_chunk, K);
  const int n_steps = (k_end - k_begin + simt::kBK - 1) / simt::kBK;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4*tx .. 4*tx+3
  const int ty = tid / 16;  // rows 8*ty .. 8*ty+7
  float acc[simt::kTM][simt::kTN];
#pragma unroll
  for (int i = 0; i < simt::kTM; ++i)
#pragma unroll
    for (int j = 0; j < simt::kTN; ++j) acc[i][j] = 0.f;

  auto stage = [&](int s) { return ring + s * (simt::kXS + simt::kWS); };
#pragma unroll
  for (int s = 0; s < simt::kStages - 1; ++s) {
    if (s < n_steps)
      simt_load<E, VEC>(stage(s), stage(s) + simt::kXS, x, w, row0, M, col0, N, K,
                        k_begin + s * simt::kBK, k_end);
    sm90::cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    sm90::cp_async_wait<simt::kStages - 2>();  // this thread's copies of stage `it` landed
    __syncthreads();  // everyone's copies landed; everyone is done with stage it - 1
    const int next = it + simt::kStages - 1;
    if (next < n_steps) {
      float* st = stage(next % simt::kStages);
      simt_load<E, VEC>(st, st + simt::kXS, x, w, row0, M, col0, N, K,
                        k_begin + next * simt::kBK, k_end);
    }
    sm90::cp_async_commit();
    const float* xs = stage(it % simt::kStages);
    const float* ws = xs + simt::kXS;
#pragma unroll
    for (int k4 = 0; k4 < simt::kBK; k4 += 4) {
      float4 a[simt::kTM];
#pragma unroll
      for (int i = 0; i < simt::kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + (ty * simt::kTM + i) * simt::kBK + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(ws + (k4 + kk) * simt::kBN + 4 * tx);
#pragma unroll
        for (int i = 0; i < simt::kTM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, b.x, acc[i][0]);
          acc[i][1] = fmaf(av, b.y, acc[i][1]);
          acc[i][2] = fmaf(av, b.z, acc[i][2]);
          acc[i][3] = fmaf(av, b.w, acc[i][3]);
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds this CTA's partial tile now

  float* part = ring;  // [kBM][kBN]
#pragma unroll
  for (int i = 0; i < simt::kTM; ++i)
    *reinterpret_cast<float4*>(part + (ty * simt::kTM + i) * simt::kBN + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();  // every partial of the cluster is in place

  const int rows = simt::kBM / splits;  // this rank sums and stores rows rank*rows ..
  for (int e = tid; e < rows * (simt::kBN / 4); e += simt::kThreads) {
    const int rr = rank * rows + e / (simt::kBN / 4);
    const int cc = (e % (simt::kBN / 4)) * 4;
    const int gr = row0 + rr;
    const int gc = col0 + cc;
    if (gr >= M || gc >= N) continue;
    float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) +
                                                rr * simt::kBN + cc);
    for (int q = 1; q < splits; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) +
                                                        rr * simt::kBN + cc);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    if constexpr (VEC) {  // N % 4 == 0: gc < N means gc + 3 < N; float32 rows are 16-byte aligned
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + (long)gr * N + gc) = s;
    } else {
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gc + j < N) E::store(out, (long)gr * N + gc + j, v[j]);
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its partial
}

template <bool BF16, bool VEC>
int launch_simt_as(const void* x, const void* w, void* out, int R, int M, int N, int K, int splits,
                   cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  const int steps = (K + simt::kBK - 1) / simt::kBK;
  const int k_chunk = (steps + splits - 1) / splits * simt::kBK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + simt::kBN - 1) / simt::kBN) * splits, (M + simt::kBM - 1) / simt::kBM, R);
  cfg.blockDim = dim3(simt::kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, batched_gemm_simt<BF16, VEC>, static_cast<const T*>(x),
                                 static_cast<const T*>(w), static_cast<T*>(out), M, N, K,
                                 k_chunk);
}

int launch_simt(const void* x, const void* w, void* out, int R, int M, int N, int K, int dtype,
                int splits, cudaStream_t stream) {
  if (splits != 1 && splits != 2 && splits != simt::kMaxSplits) return REPRO_BAD_ARGUMENT;
  if ((M + simt::kBM - 1) / simt::kBM > 65535) return REPRO_BAD_ARGUMENT;
  // 16-byte copies need every row of x and w to start 16-byte aligned
  // (bases are checked by the wrapper): K and N multiples of 4 floats.
  const bool vec = dtype == 0 && K % 4 == 0 && N % 4 == 0;
  if (dtype == 0 && vec) return launch_simt_as<false, true>(x, w, out, R, M, N, K, splits, stream);
  if (dtype == 0) return launch_simt_as<false, false>(x, w, out, R, M, N, K, splits, stream);
  if (dtype == 1) return launch_simt_as<true, false>(x, w, out, R, M, N, K, splits, stream);
  return REPRO_BAD_ARGUMENT;
}

}  // namespace

extern "C" {

// x (R,M,K), w (R,K,N), out (R,M,N); all contiguous, on the current
// device, 16-byte aligned. dtype: 0 float32, 1 bfloat16. variant: 0
// cuda_core, 1 wgmma (bf16; tile_rows 64 or 128), 2 simt (k_splits 1, 2 or
// 4). Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_batched_gemm(const void* x, const void* w, void* out, int R, int M, int N, int K,
                       int dtype, int variant, int tile_rows, int k_splits, void* stream) {
  if (R <= 0 || M <= 0 || N <= 0 || K < 0 || R > 65535 ||
      (M + repro::gemm::kBM - 1) / repro::gemm::kBM > 65535 || (dtype != 0 && dtype != 1))
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma)
    return dtype == 1 ? launch_wgmma(x, w, out, R, M, N, K, tile_rows, st) : REPRO_BAD_ARGUMENT;
  if (variant == kSimt) return launch_simt(x, w, out, R, M, N, K, dtype, k_splits, st);
  if (variant != kCudaCore) return REPRO_BAD_ARGUMENT;
  if (dtype == 0) return launch_cuda_core<false>(x, w, out, R, M, N, K, st);
  return launch_cuda_core<true>(x, w, out, R, M, N, K, st);
}

// Dynamic shared memory of the wgmma kernel with 64-row (one consumer
// warpgroup) and 128-row tiles, in bytes.
int repro_batched_gemm_smem(int tile_rows) {
  return tile_rows == 64 ? gemm_sm90::Cfg<1>::kSmemBytes : gemm_sm90::Cfg<2>::kSmemBytes;
}

const char* repro_batched_gemm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
