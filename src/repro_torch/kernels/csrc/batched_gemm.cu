// The space-time super-kernel: R independent GEMMs in one launch (K1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/batched_gemm.py::
// batched_gemm (pallas_call at :91, body _gemm_kernel at :31). Computes
// out[r] = x[r] @ w[r] for x (R, M, K) and w (R, K, N), each problem with
// its own weights (one tenant each): float32 accumulation, output in the
// input dtype.
//
// Grid (N tiles, M tiles, R): one CTA per 64 x 64 output tile of one
// problem, so the problem index R rides on the grid as it does in the
// Pallas kernel, and R small problems fill the card together where one
// alone would leave most of its 132 SMs idle (the paper's point). Nothing
// carries over between CTAs: the Pallas grid's sequential K axis becomes
// the loop over K inside the CTA (gemm_tile.cuh). Ragged M, N and K are
// masked in the kernel; the Pallas version copy-pads every dim to a block
// multiple instead.
//
// What bounds it on an H100: for the paper's conv2_2 (256, 128, 1152) and
// square (256, 256, 256) shapes in float32, operations (2*M*N*K over
// 67 TFLOP/s outside the tensor cores); for the N = 1 matvec (512, 1, 512),
// bytes (x is read once, ~2 flops per 4-byte element). This first version
// is simple and right: float32 FMA on the CUDA cores, shared-memory tiles
// without cp.async/TMA pipelining, and a 64-wide column tile that wastes
// 63/64 of its lanes at N = 1. Tensor cores (wgmma for bf16), TMA and a
// matvec path are later work.
#include "gemm_tile.cuh"

namespace {

using repro::Elem;
namespace gemm = repro::gemm;

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
int launch(const void* x, const void* w, void* out, int R, int M, int N, int K,
           cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  const dim3 grid((N + gemm::kBN - 1) / gemm::kBN, (M + gemm::kBM - 1) / gemm::kBM, R);
  batched_gemm_kernel<BF16><<<grid, gemm::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (R,M,K), w (R,K,N), out (R,M,N); all contiguous, on the current
// device. dtype: 0 float32, 1 bfloat16. Returns 0, a cudaError_t, or
// REPRO_BAD_ARGUMENT.
int repro_batched_gemm(const void* x, const void* w, void* out, int R, int M,
                       int N, int K, int dtype, void* stream) {
  if (R <= 0 || M <= 0 || N <= 0 || K < 0 || R > 65535 ||
      (M + repro::gemm::kBM - 1) / repro::gemm::kBM > 65535)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<false>(x, w, out, R, M, N, K, st);
  if (dtype == 1) return launch<true>(x, w, out, R, M, N, K, st);
  return REPRO_BAD_ARGUMENT;
}

const char* repro_batched_gemm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
