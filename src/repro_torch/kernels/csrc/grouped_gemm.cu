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
//   with float32 accumulation. A persistent grid (one CTA per SM) walks the
//   (row tile, column tile) list column panel by column panel, so CTAs that
//   run together share one group's w panel in L2. Each CTA computes 128 x 128
//   outputs with two consumer warpgroups (64 rows each, m64n128k16 over
//   64-deep K stages); a producer warp keeps a 4-stage ring of TMA loads in
//   flight: x as a 2-D map over (T, K), w as a 3-D map over (G, K, N), so
//   the group picks the outer coordinate and a K or N tail reads TMA's zeros
//   instead of the next group's rows. w (K, N) with N contiguous is the
//   MN-major B operand (the transpose bit). Consumers keep one stage's
//   products in flight while releasing the one before. The epilogue goes
//   from registers to bf16 to masked global stores (a TMA store could not
//   clip at a row block's end).
// * CUDA cores (everything else, all float32: its 2e-4 tolerance rules out
//   TF32). One CTA per 64 x 64 output tile (gemm_tile.cuh), float32 FMA,
//   masked scalar loads, so no stride needs alignment.
#include "gemm_tile.cuh"
#include "sm90.cuh"

namespace {

using repro::Elem;
namespace gemm = repro::gemm;
namespace sm90 = repro::sm90;

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
namespace tc {
constexpr int kBM = 128;                          // output rows per tile (the table's tile height)
constexpr int kBN = 128;                          // output columns per tile
constexpr int kBK = 64;                           // depth of one stage
constexpr int kStages = 4;
constexpr int kConsumers = 2;                     // warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kXBytes = kBM * kBK * 2;            // one TMA box {64, 128}
constexpr int kWBox = kBK * 64 * 2;               // one TMA box {64, 64, 1}
constexpr int kStageBytes = kXBytes + 2 * kWBox;  // x tile + two w boxes (128 columns)
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + sm90::kAtomBytes;
}  // namespace tc

__global__ void __launch_bounds__(tc::kThreads, 1)
grouped_gemm_wgmma(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map, const int32_t* __restrict__ tiles,
                   uint16_t* __restrict__ out, int n_row_tiles, int n_col_tiles, int G, int N,
                   int K) {
  extern __shared__ char smem_raw[];
  char* smem = sm90::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + tc::kStages * tc::kStageBytes);
  uint64_t* empty = full + tc::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < tc::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], tc::kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int n_tiles = n_row_tiles * n_col_tiles;
  const int k_steps = (K + tc::kBK - 1) / tc::kBK;
  const int warp = threadIdx.x / 32;

  if (warp == 4 * tc::kConsumers) {  // producer
    if (threadIdx.x % 32 == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int rt = t % n_row_tiles;
        const int n0 = (t / n_row_tiles) * tc::kBN;
        const int row0 = tiles[3 * rt];
        const int g = tiles[3 * rt + 2];
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % tc::kStages;
          if (it >= tc::kStages) sm90::mbar_wait(&empty[s], ((it / tc::kStages) - 1) & 1);
          char* st = smem + s * tc::kStageBytes;
          sm90::mbar_arrive_expect_tx(&full[s], tc::kStageBytes);
          sm90::tma_load_2d(st, &x_map, &full[s], ks * tc::kBK, row0);
          sm90::tma_load_3d(st + tc::kXBytes, &w_map, &full[s], n0, ks * tc::kBK, g);
          sm90::tma_load_3d(st + tc::kXBytes + tc::kWBox, &w_map, &full[s], n0 + 64,
                            ks * tc::kBK, g);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64*wg .. 64*wg+63 of each tile
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int rt = t % n_row_tiles;
    const int n0 = (t / n_row_tiles) * tc::kBN;
    const int row0 = tiles[3 * rt];
    const int row_end = tiles[3 * rt + 1];
    const int g = tiles[3 * rt + 2];
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int ks = 0; ks < k_steps; ++ks, ++it) {
      const int s = it % tc::kStages;
      sm90::mbar_wait(&full[s], (it / tc::kStages) & 1);
      const char* st = smem + s * tc::kStageBytes;
      const char* xa = st + wg * (tc::kXBytes / 2);
      const char* wb = st + tc::kXBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < tc::kBK / 16; ++kk)
        sm90::wgmma_m64n128k16_ss<1>(acc, sm90::desc_k_major(xa, kk),
                                     sm90::desc_mn_major(wb, kk, tc::kWBox), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous stage's products are done
      if (ks > 0 && tid == 0) sm90::mbar_arrive(&empty[prev]);
      prev = s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (k_steps > 0 && tid == 0) sm90::mbar_arrive(&empty[prev]);

    const bool bad = g < 0 || g >= G;
    const int r = row0 + wg * 64 + (tid / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      if (c >= N) continue;  // N % 8 == 0 and c is even: c < N means c + 1 < N
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= row_end) continue;
        const float lo = bad ? __int_as_float(0x7fc00000) : acc[4 * j + 2 * h];
        const float hi = bad ? __int_as_float(0x7fc00000) : acc[4 * j + 2 * h + 1];
        *reinterpret_cast<uint32_t*>(out + (long)rr * N + c) = sm90::pack_bf16x2(lo, hi);
      }
    }
  }
}

int launch_wgmma(const void* x, const void* w, const int32_t* tiles, void* out, int n_tiles,
                 int T, int G, int N, int K, cudaStream_t stream) {
  if (K <= 0 || K % 8 != 0 || N % 8 != 0) return REPRO_BAD_ARGUMENT;
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)T};
  const uint64_t x_strides[1] = {(uint64_t)K * 2};
  const uint32_t x_box[2] = {tc::kBK, tc::kBM};
  const uint64_t w_dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)G};
  const uint64_t w_strides[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t w_box[3] = {64, tc::kBK, 1};
  if (sm90::make_tensor_map(&x_map, x, 2, x_dims, x_strides, x_box) != 0 ||
      sm90::make_tensor_map(&w_map, w, 3, w_dims, w_strides, w_box) != 0)
    return REPRO_BAD_ARGUMENT;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = sm90::allow_dynamic_smem(grouped_gemm_wgmma, tc::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int n_col_tiles = (N + tc::kBN - 1) / tc::kBN;
  const long total = (long)n_tiles * n_col_tiles;
  const int grid = (int)(total < sms ? total : sms);
  grouped_gemm_wgmma<<<grid, tc::kThreads, tc::kSmemBytes, stream>>>(
      x_map, w_map, tiles, static_cast<uint16_t*>(out), n_tiles, n_col_tiles, G, N, K);
  return (int)cudaGetLastError();
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
int repro_grouped_gemm_smem(void) { return tc::kSmemBytes; }

const char* repro_grouped_gemm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
