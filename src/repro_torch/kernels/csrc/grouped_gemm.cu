// Grouped (variable-size batched) GEMM: the ragged super-kernel (K2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_gemm.py::
// grouped_gemm (pallas_call at :92, body _grouped_kernel at :35). Rows of
// x (T, K) are sorted by group and padded per group to a multiple of the
// row block bm; row block i is multiplied by w[block_groups[i]] of
// w (G, K, N): out[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[block_groups[i]].
// Float32 accumulation, output in the input dtype.
//
// bm is semantic, not a tiling knob: it says which rows share a weight.
// The CTA's 64-row tile (gemm_tile.cuh) never straddles two row blocks:
// a block of bm rows is ceil(bm / 64) tiles, the last one masked at the
// block's edge (for bm < 64, the only one), so any bm >= 1 works. Each
// CTA reads its group id from the device int32 table `block_groups` (the
// Pallas kernel scalar-prefetches it); the wrapper has checked
// 0 <= id < G on the host before upload, and an id out of range here
// writes NaN rather than read out of bounds. Rows of a zero-padded tail
// block read group 0 and produce zeros, as in the reference.
//
// What bounds it on an H100: at the ragged merge's stablelm-1.6b MLP
// shape (T ~ 1e3-1e4 padded rows, K 2048, N 5632) operations, by far; in
// bf16 the bound is the tensor cores' rate, which this float32 CUDA-core
// version does not use. Tensor cores (wgmma), TMA and a persistent
// schedule over the blocks are later work.
#include "gemm_tile.cuh"

namespace {

using repro::Elem;
namespace gemm = repro::gemm;

template <bool BF16>
__global__ void __launch_bounds__(gemm::kThreads)
grouped_gemm_kernel(const typename Elem<BF16>::T* __restrict__ x,
                    const typename Elem<BF16>::T* __restrict__ w,
                    const int32_t* __restrict__ block_groups,
                    typename Elem<BF16>::T* __restrict__ out, int G, int N,
                    int K, int bm, int tiles_per_block) {
  using E = Elem<BF16>;
  const int blk = blockIdx.y / tiles_per_block;
  const int row0 = blk * bm + (blockIdx.y % tiles_per_block) * gemm::kBM;
  const int block_end = (blk + 1) * bm;
  const int row_end = row0 + gemm::kBM < block_end ? row0 + gemm::kBM : block_end;
  const int col0 = blockIdx.x * gemm::kBN;
  const int g = block_groups[blk];
  if (g < 0 || g >= G) {
    for (int e = threadIdx.x; e < gemm::kBM * gemm::kBN; e += blockDim.x) {
      const int r = row0 + e / gemm::kBN;
      const int c = col0 + e % gemm::kBN;
      if (r < row_end && c < N) E::store(out, (long)r * N + c, __int_as_float(0x7fc00000));
    }
    return;
  }
  gemm::tile<E>(x, w + (long)g * K * N, out, row0, row_end, col0, N, K);
}

template <bool BF16>
int launch(const void* x, const void* w, const int32_t* block_groups, void* out,
           int T, int G, int N, int K, int bm, cudaStream_t stream) {
  using T_ = typename Elem<BF16>::T;
  const int tiles_per_block = (bm + gemm::kBM - 1) / gemm::kBM;
  const dim3 grid((N + gemm::kBN - 1) / gemm::kBN, (T / bm) * tiles_per_block);
  grouped_gemm_kernel<BF16><<<grid, gemm::kThreads, 0, stream>>>(
      static_cast<const T_*>(x), static_cast<const T_*>(w), block_groups,
      static_cast<T_*>(out), G, N, K, bm, tiles_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (T,K) with T % bm == 0, w (G,K,N), block_groups (T/bm,) int32,
// out (T,N); all contiguous, on the current device. dtype: 0 float32,
// 1 bfloat16. Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_grouped_gemm(const void* x, const void* w, const int32_t* block_groups,
                       void* out, int T, int G, int N, int K, int bm, int dtype,
                       void* stream) {
  if (T <= 0 || G <= 0 || N <= 0 || K < 0 || bm <= 0 || T % bm != 0 ||
      (long)(T / bm) * ((bm + repro::gemm::kBM - 1) / repro::gemm::kBM) > 65535)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<false>(x, w, block_groups, out, T, G, N, K, bm, st);
  if (dtype == 1) return launch<true>(x, w, block_groups, out, T, G, N, K, bm, st);
  return REPRO_BAD_ARGUMENT;
}

const char* repro_grouped_gemm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
