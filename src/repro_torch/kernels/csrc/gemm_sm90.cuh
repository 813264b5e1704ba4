// The bf16 tensor-core GEMM mainloop shared by K1 (batched_gemm.cu) and K2
// (grouped_gemm.cu): wgmma fed by TMA through an mbarrier ring.
//
// A persistent grid (at most one CTA per SM) walks the (row tile, column
// tile) list column panel by column panel, so CTAs that run together share
// one w panel in L2. A row tile is whatever the caller's `Tiles` functor says
// row tile `rt` is: its first row, the row it stops storing at, and the
// group (problem) whose w it multiplies. K2 reads that from a host-built
// table; K1 computes it from the tile index. Each tile is kBM x 128 outputs,
// kBM = 64 per consumer warpgroup (m64n128k16 over 64-deep K stages); a
// producer warp keeps a 4-stage ring of TMA loads in flight: x as a 2-D map
// over (rows, K), w as a 3-D map over (G, K, N), so the group picks the outer
// coordinate and a K or N tail reads TMA's zeros instead of the next group's
// rows. w (K, N) with N contiguous is the MN-major B operand (the transpose
// bit). Consumers keep one stage's products in flight while releasing the
// one before. The epilogue goes from registers to bf16 to masked global
// stores, so a tile never stores at or past its `row_end` (a TMA store could
// not clip there), and a tile whose group is out of range writes NaN.
//
// Every x row of a tile is multiplied by the tile's w only, and every output
// element's sum runs over k in one fixed order, so rows a tile reads beyond
// its `row_end` (the next problem's, or TMA's zeros) never reach a stored
// value.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace repro {
namespace gemm_sm90 {

constexpr int kBN = 128;                // output columns per tile
constexpr int kBK = 64;                 // depth of one stage
constexpr int kStages = 4;
constexpr int kWBox = kBK * 64 * 2;     // one TMA box {64, 64, 1} of w

// Sizes of the kernel with CONSUMERS warpgroups (64 output rows each).
template <int CONSUMERS>
struct Cfg {
  static constexpr int kBM = 64 * CONSUMERS;                 // output rows per tile
  static constexpr int kThreads = 128 * CONSUMERS + 32;      // + one producer warp
  static constexpr int kXBytes = kBM * kBK * 2;              // one TMA box {64, kBM}
  static constexpr int kStageBytes = kXBytes + 2 * kWBox;    // x tile + two w boxes
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + sm90::kAtomBytes;
};

// Row tile rt: rows row0 .. row_end - 1 are stored, times w[group].
struct Tile {
  int row0;
  int row_end;
  int group;
};

template <int CONSUMERS, typename Tiles>
__global__ void __launch_bounds__(Cfg<CONSUMERS>::kThreads, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
           const Tiles tiles, uint16_t* __restrict__ out, int n_row_tiles, int n_col_tiles, int G,
           int N, int K) {
  using C = Cfg<CONSUMERS>;
  extern __shared__ char smem_raw[];
  char* smem = sm90::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * C::kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int n_tiles = n_row_tiles * n_col_tiles;
  const int k_steps = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;

  if (warp == 4 * CONSUMERS) {  // producer
    if (threadIdx.x % 32 == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tile = tiles(t % n_row_tiles);
        const int n0 = (t / n_row_tiles) * kBN;
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % kStages;
          if (it >= kStages) sm90::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          char* st = smem + s * C::kStageBytes;
          sm90::mbar_arrive_expect_tx(&full[s], C::kStageBytes);
          sm90::tma_load_2d(st, &x_map, &full[s], ks * kBK, tile.row0);
          sm90::tma_load_3d(st + C::kXBytes, &w_map, &full[s], n0, ks * kBK, tile.group);
          sm90::tma_load_3d(st + C::kXBytes + kWBox, &w_map, &full[s], n0 + 64, ks * kBK,
                            tile.group);
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
    const Tile tile = tiles(t % n_row_tiles);
    const int n0 = (t / n_row_tiles) * kBN;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int ks = 0; ks < k_steps; ++ks, ++it) {
      const int s = it % kStages;
      sm90::mbar_wait(&full[s], (it / kStages) & 1);
      const char* st = smem + s * C::kStageBytes;
      const char* xa = st + wg * (64 * kBK * 2);
      const char* wb = st + C::kXBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        sm90::wgmma_m64n128k16_ss<1>(acc, sm90::desc_k_major(xa, kk),
                                     sm90::desc_mn_major(wb, kk, kWBox), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous stage's products are done
      if (ks > 0 && tid == 0) sm90::mbar_arrive(&empty[prev]);
      prev = s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (k_steps > 0 && tid == 0) sm90::mbar_arrive(&empty[prev]);

    const bool bad = tile.group < 0 || tile.group >= G;
    const int r = tile.row0 + wg * 64 + (tid / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      if (c >= N) continue;  // N % 8 == 0 and c is even: c < N means c + 1 < N
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= tile.row_end) continue;
        const float lo = bad ? __int_as_float(0x7fc00000) : acc[4 * j + 2 * h];
        const float hi = bad ? __int_as_float(0x7fc00000) : acc[4 * j + 2 * h + 1];
        *reinterpret_cast<uint32_t*>(out + (long)rr * N + c) = sm90::pack_bf16x2(lo, hi);
      }
    }
  }
}

// Launch gemm_wgmma over n_row_tiles row tiles of x (x_rows, K) and every
// 128-wide column tile of w (G, K, N); out has N columns. bf16 only, K > 0,
// K and N multiples of 8 (TMA's 16-byte strides), bases 16-byte aligned.
// Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
template <int CONSUMERS, typename Tiles>
int launch(const void* x, const void* w, const Tiles& tiles, void* out, int n_row_tiles,
           long x_rows, int G, int N, int K, cudaStream_t stream) {
  using C = Cfg<CONSUMERS>;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || x_rows <= 0 || x_rows > 0x7fffffffL)
    return REPRO_BAD_ARGUMENT;
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)x_rows};
  const uint64_t x_strides[1] = {(uint64_t)K * 2};
  const uint32_t x_box[2] = {kBK, C::kBM};
  const uint64_t w_dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)G};
  const uint64_t w_strides[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t w_box[3] = {64, kBK, 1};
  if (sm90::make_tensor_map(&x_map, x, 2, x_dims, x_strides, x_box) != 0 ||
      sm90::make_tensor_map(&w_map, w, 3, w_dims, w_strides, w_box) != 0)
    return REPRO_BAD_ARGUMENT;
  auto kernel = gemm_wgmma<CONSUMERS, Tiles>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = sm90::allow_dynamic_smem(kernel, C::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int n_col_tiles = (N + kBN - 1) / kBN;
  const long total = (long)n_row_tiles * n_col_tiles;
  const int grid = (int)(total < sms ? total : sms);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      x_map, w_map, tiles, static_cast<uint16_t*>(out), n_row_tiles, n_col_tiles, G, N, K);
  return (int)cudaGetLastError();
}

}  // namespace gemm_sm90
}  // namespace repro
