// Grouped (variable-size batched) GEMM: the ragged super-kernel (K2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_gemm.py::
// grouped_gemm (pallas_call at :92, body _grouped_kernel at :35). Rows of
// x (T, K) are sorted by group and padded per group to a multiple of the
// row block bm; row block i is multiplied by w[block_groups[i]] of
// w (G, K, N): out[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[block_groups[i]].
// Float32 accumulation, output rounded once to the input dtype.
//
// bm is semantic, not a tiling knob: it says which rows share a weight.
// The wrapper turns (block_groups, bm) into a host-built int32 tile table,
// one (row0, row_end, group) triple per row tile: a block of bm rows is
// ceil(bm / tile_rows) tiles, the last one ending at the block's edge, so no
// tile ever stores across two row blocks and any bm >= 1 works (for bm below
// the tile height the rows past the edge are computed and dropped). Group
// ids are checked on the host before upload; a tile whose id is out of range
// writes NaN rather than read out of bounds. Rows of a zero-padded tail block
// belong to group 0 and produce zeros, as in the reference.
//
// What bounds it on an H100: operations. At the ragged merge's
// stablelm-1.6b MLP shape (T ~ 1e3-1e4 padded rows, K 2048, N 5632) a
// 128 x 128 output tile does 64 flops per byte it loads, far above the
// card's balance. Two variants, chosen by the wrapper from dtype and shape
// before the launch (never as a fallback):
//
// * wgmma (bf16 with K % 8 == 0 and N % 8 == 0, K > 0: TMA needs 16-byte
//   global strides). The reference computes jnp.dot(bf16, bf16,
//   preferred_element_type=f32), which is exactly a bf16 tensor-core product
//   with float32 accumulation. The mainloop is gemm_sm90.cuh's, shared with
//   K1: a persistent grid of 128 x 128 tiles (two consumer warpgroups on
//   m64n128k16, a producer warp keeping a 4-stage TMA ring, w as a 3-D map
//   over (G, K, N)), walking the tile table's row tiles column panel by
//   column panel; masked stores clip each tile at its row block's end.
// * CUDA cores (everything else, all float32: its 2e-4 tolerance rules out
//   TF32). One CTA per 64 x 64 output tile (gemm_tile.cuh), float32 FMA,
//   masked scalar loads, so no stride needs alignment.
#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

using repro::Elem;
namespace gemm = repro::gemm;
namespace gemm_sm90 = repro::gemm_sm90;

// ---------------------------------------------------------------- CUDA cores
template <bool BF16>
__global__ void __launch_bounds__(gemm::kThreads)
grouped_gemm_kernel(const typename Elem<BF16>::T* __restrict__ x,
                    const typename Elem<BF16>::T* __restrict__ w,
                    const int32_t* __restrict__ tiles,
                    typename Elem<BF16>::T* __restrict__ out, int G, int N, int K) {
  using E = Elem<BF16>;
  const int32_t* tile = tiles + 3 * blockIdx.y;
  const int row0 = tile[0];
  const int row_end = tile[1];
  const int g = tile[2];
  const int col0 = blockIdx.x * gemm::kBN;
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
int launch_cuda_core(const void* x, const void* w, const int32_t* tiles, void* out,
                     int n_tiles, int G, int N, int K, cudaStream_t stream) {
  using T_ = typename Elem<BF16>::T;
  if (n_tiles > 65535) return REPRO_BAD_ARGUMENT;
  const dim3 grid((N + gemm::kBN - 1) / gemm::kBN, n_tiles);
  grouped_gemm_kernel<BF16><<<grid, gemm::kThreads, 0, stream>>>(
      static_cast<const T_*>(x), static_cast<const T_*>(w), tiles, static_cast<T_*>(out), G, N,
      K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma
// The mainloop is gemm_sm90.cuh's, shared with K1; K2's row tiles come from
// the uploaded table.
struct TableTiles {
  const int32_t* table;  // (n_tiles, 3) int32: row0, row_end, group
  __device__ __forceinline__ gemm_sm90::Tile operator()(int rt) const {
    return {table[3 * rt], table[3 * rt + 1], table[3 * rt + 2]};
  }
};

int launch_wgmma(const void* x, const void* w, const int32_t* tiles, void* out, int n_tiles,
                 int T, int G, int N, int K, cudaStream_t stream) {
  return gemm_sm90::launch<2>(x, w, TableTiles{tiles}, out, n_tiles, T, G, N, K, stream);
}

}  // namespace

extern "C" {

// x (T,K), w (G,K,N), out (T,N), all contiguous on the current device;
// tiles (n_tiles, 3) int32 (row0, row_end, group), rows of 64 (variant 0,
// CUDA cores) or 128 (variant 1, wgmma; bf16 only). dtype: 0 float32,
// 1 bfloat16. Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_grouped_gemm(const void* x, const void* w, const int32_t* tiles, void* out,
                       int n_tiles, int T, int G, int N, int K, int dtype, int variant,
                       void* stream) {
  if (n_tiles <= 0 || T <= 0 || G <= 0 || N <= 0 || K < 0) return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return dtype == 1 ? launch_wgmma(x, w, tiles, out, n_tiles, T, G, N, K, st)
                      : REPRO_BAD_ARGUMENT;
  if (variant != 0) return REPRO_BAD_ARGUMENT;
  if (dtype == 0) return launch_cuda_core<false>(x, w, tiles, out, n_tiles, G, N, K, st);
  if (dtype == 1) return launch_cuda_core<true>(x, w, tiles, out, n_tiles, G, N, K, st);
  return REPRO_BAD_ARGUMENT;
}

// Dynamic shared memory the wgmma variant asks for, in bytes.
int repro_grouped_gemm_smem(void) { return gemm_sm90::Cfg<2>::kSmemBytes; }

const char* repro_grouped_gemm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
