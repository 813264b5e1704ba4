// RWKV-6 WKV state after T steps, with no outputs (K5-state).
//
// Replaces no Pallas kernel. The JAX package keeps a bf16 prefill's state
// from src/repro/models/rwkv.py::_wkv_final_state (:188, called at :153), a
// jnp lax.scan over the T steps that reads k, v and float32 w:
//   d_t = exp(-exp(w_t)),   S_t = diag(d_t) S_{t-1} + k_t^T v_t
// in float32, from the cached state. Before this kernel the port launched
// the whole K5 (wkv6_scan.cu) a second time for it and threw away its
// outputs; this pass reads k, v, w and the state only.
//
// What bounds it on an H100: per head and step it reads 2 x 64 bf16 values
// and 64 float32 w (512 bytes) and does 3 float32 operations per state
// element (12,288 for a 64 x 64 state), so the CUDA cores' 67 TFLOP/s
// bound it a little above the bytes. What it must not be bound by is the
// chain of T dependent steps. The design:
//   * time is parallel: the G = gridDim.x CTAs of a head (one thread-block
//     cluster, G <= 8) each roll a segment of L = ceil(T / G) steps, from
//     zero (segment 0 from s0), one FMA chain per state element,
//     s = fma(d, s, k * v), and keep the segment's decay product per row,
//     D_g[n] = prod_t d_t[n];
//   * the segments join in order through distributed shared memory,
//     S = S_0, then S = diag(D_g) S + S_g for g = 1 .. G-1: the same
//     recurrence regrouped, every factor a product of decays in [0, 1], so
//     nothing overflows. Each CTA combines a share of the state's elements
//     and writes them to s_out (which may be s0: only segment 0 reads s0,
//     before the cluster barrier that every write follows);
//   * 256 threads, each holding a 4 x 4 block of the 64 x 64 state in
//     registers: a step is 3 16-byte shared loads (4 decays, 4 k, 4 v),
//     16 FMUL and 16 FFMA;
//   * 64-step tiles. The rows of k, v and w of tile i + 1 arrive by 16-byte
//     cp.async into one raw stage while tile i is rolled (the inputs are
//     strided (B, H, T, X) views, read as they are). Each tile is widened
//     once per CTA into float32 k, v and decays (accurate expf, not
//     __expf), with rows past the segment and rows or columns past N or V
//     held at k = v = 0 and d = 1, so they decay nothing and add nothing;
//   * heads of N, V in 8..64 (multiples of 8) run as 64 x 64 with those
//     rows and columns held at zero; only the live (N, V) is written.
// No tensor cores: everything is float32 on the CUDA cores.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::Elem;
namespace cg = cooperative_groups;
namespace sm90 = repro::sm90;

constexpr int kD = 64;           // the kernel's head: state rows (N) and columns (V)
constexpr int kTile = 64;        // steps a tile
constexpr int kThreads = 256;    // 16 x 16 threads, each a 4 x 4 block of the state
constexpr int kQuarters = kThreads / kD;  // threads sharing a row when widening a tile
constexpr int kMaxSegments = 8;  // the portable cluster size

// Element strides (b, h, t) of k, v and w; the last dim is contiguous.
struct Strides {
  long long s[3][3];
};
enum { kK = 0, kVal = 1, kW = 2 };

// Dynamic shared memory, in bytes from the base: the raw stage (k, v of the
// model dtype, w float32; rows of 64 elements), the widened tile (decays, k,
// v float32) and each quarter's partial decay products. After the last tile
// the decay buffer holds the segment's state and the partials its D_g.
template <bool BF16>
struct Layout {
  static constexpr int kRawKV = kTile * kD * (int)sizeof(typename Elem<BF16>::T);
  static constexpr int kWork = kTile * kD * 4;
  static constexpr int kRawK = 0;
  static constexpr int kRawV = kRawK + kRawKV;
  static constexpr int kRawW = kRawV + kRawKV;
  static constexpr int kDec = kRawW + kWork;
  static constexpr int kKf = kDec + kWork;
  static constexpr int kVf = kKf + kWork;
  static constexpr int kPart = kVf + kWork;
  static constexpr int kSmem = kPart + kQuarters * kD * 4;
};

// Start the cp.async copies of rows t0 .. t0 + nt - 1 of one operand (X
// live elements a row, `vec` elements a 16-byte vector) into a raw buffer
// of 64-element rows. Every thread takes part.
template <typename T>
__device__ __forceinline__ void stage_rows(char* dst, const T* src, long long st, int t0, int nt,
                                           int X, int vec) {
  const int per_row = X / vec;
  for (int i = threadIdx.x; i < nt * per_row; i += kThreads) {
    const int row = i / per_row;
    const int c = (i - row * per_row) * vec;
    sm90::cp_async16(dst + (row * kD + c) * (int)sizeof(T), src + (t0 + row) * st + c, true);
  }
}

// Start one tile's copies (rows t0 .. t0 + nt - 1 of k, v and w) into the
// raw stage, as one cp.async group.
template <bool BF16>
__device__ __forceinline__ void stage_tile(char* smem, const typename Elem<BF16>::T* kp,
                                           const typename Elem<BF16>::T* vp, const float* wp,
                                           const Strides& st, int t0, int nt, int N, int V) {
  using L = Layout<BF16>;
  constexpr int vec = Elem<BF16>::kVec;
  stage_rows(smem + L::kRawK, kp, st.s[kK][2], t0, nt, N, vec);
  stage_rows(smem + L::kRawV, vp, st.s[kVal][2], t0, nt, V, vec);
  stage_rows(smem + L::kRawW, wp, st.s[kW][2], t0, nt, N, 4);
  sm90::cp_async_commit();
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
wkv6_state_segmented(const typename Elem<BF16>::T* __restrict__ k,
                     const typename Elem<BF16>::T* __restrict__ v,
                     const float* __restrict__ w, const float* s0, float* s_out, Strides st,
                     int H, int T, int N, int V) {
  using E = Elem<BF16>;
  using T_ = typename E::T;
  using L = Layout<BF16>;
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = gridDim.x;
  const int g = (int)cluster.block_rank();
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int seg = (T + G - 1) / G;
  const int t_begin = min(T, g * seg);
  const int t_end = min(T, t_begin + seg);
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4 rg .. 4 rg + 3
  const int cq = tid & 15;  // columns 4 cq .. 4 cq + 3

  const T_* kp = k + b * st.s[kK][0] + h * st.s[kK][1];
  const T_* vp = v + b * st.s[kVal][0] + h * st.s[kVal][1];
  const float* wp = w + b * st.s[kW][0] + h * st.s[kW][1];
  const T_* raw_k = reinterpret_cast<const T_*>(smem + L::kRawK);
  const T_* raw_v = reinterpret_cast<const T_*>(smem + L::kRawV);
  const float* raw_w = reinterpret_cast<const float*>(smem + L::kRawW);
  float* dec = reinterpret_cast<float*>(smem + L::kDec);
  float* kf = reinterpret_cast<float*>(smem + L::kKf);
  float* vf = reinterpret_cast<float*>(smem + L::kVf);
  float* part = reinterpret_cast<float*>(smem + L::kPart);

  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * rg + i;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g == 0 && s0 != nullptr && row < N && 4 * cq < V)
      x = *reinterpret_cast<const float4*>(s0 + ((long)bh * N + row) * V + 4 * cq);
    s[i][0] = x.x;
    s[i][1] = x.y;
    s[i][2] = x.z;
    s[i][3] = x.w;
  }
  float prod = 1.f;  // thread n < 64: D_g[n] over the tiles rolled so far

  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  if (n_tiles > 0)
    stage_tile<BF16>(smem, kp, vp, wp, st, t_begin, min(kTile, t_end - t_begin), N, V);
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = t_begin + i * kTile;
    const int nt = min(kTile, t_end - t0);
    sm90::cp_async_wait<0>();
    __syncthreads();  // the raw tile is in; the previous tile's widened copy is read
    {  // widen: thread (quarter q, row n) takes steps q, q + 4, ..., q + 60 of row n
      const int n = tid & (kD - 1);
      const int q = tid / kD;
      float p = 1.f;
#pragma unroll 4
      for (int j = 0; j < kTile / kQuarters; ++j) {
        const int t = q + kQuarters * j;
        const int e = t * kD + n;
        float d = 1.f, kk = 0.f, vv = 0.f;
        if (t < nt && n < N) {
          d = expf(-expf(raw_w[e]));
          kk = E::load(raw_k, e);
        }
        if (t < nt && n < V) vv = E::load(raw_v, e);
        dec[e] = d;
        kf[e] = kk;
        vf[e] = vv;
        p *= d;
      }
      part[q * kD + n] = p;
    }
    __syncthreads();  // the widened tile is in; the raw stage is free
    if (tid < kD) {
#pragma unroll
      for (int q = 0; q < kQuarters; ++q) prod *= part[q * kD + tid];
    }
    if (i + 1 < n_tiles)
      stage_tile<BF16>(smem, kp, vp, wp, st, t0 + kTile, min(kTile, t_end - t0 - kTile), N, V);
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      const float4 d4 = *reinterpret_cast<const float4*>(dec + t * kD + 4 * rg);
      const float4 k4 = *reinterpret_cast<const float4*>(kf + t * kD + 4 * rg);
      const float4 v4 = *reinterpret_cast<const float4*>(vf + t * kD + 4 * cq);
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
      const float kr[4] = {k4.x, k4.y, k4.z, k4.w};
      const float vc[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(dr[a], s[a][c], kr[a] * vc[c]);
    }
  }
  __syncthreads();  // every thread is done with the last tile

  // This segment's state and decay product, for the cluster to combine.
  float* seg_state = dec;  // 64 x 64
  float* seg_decay = part;  // 64
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(seg_state + (4 * rg + a) * kD + 4 * cq) =
        make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
  if (tid < kD) seg_decay[tid] = prod;
  sm90::cluster_arrive();  // release this segment's state to the cluster
  sm90::cluster_wait();    // every segment's state is in place

  // The ordered combine, 4 columns at a time, the cluster's CTAs sharing
  // the 1024 groups of the state.
  for (int u = g * kThreads + tid; u < kD * kD / 4; u += G * kThreads) {
    const int row = u / (kD / 4);
    const int col = 4 * (u % (kD / 4));
    float4 acc = *reinterpret_cast<const float4*>(cluster.map_shared_rank(seg_state, 0) +
                                                  row * kD + col);
    for (int r = 1; r < G; ++r) {
      const float d = cluster.map_shared_rank(seg_decay, r)[row];
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(seg_state, r) +
                                                        row * kD + col);
      acc.x = fmaf(d, acc.x, x.x);
      acc.y = fmaf(d, acc.y, x.y);
      acc.z = fmaf(d, acc.z, x.z);
      acc.w = fmaf(d, acc.w, x.w);
    }
    if (row < N && col < V)
      *reinterpret_cast<float4*>(s_out + ((long)bh * N + row) * V + col) = acc;
  }
  sm90::cluster_arrive();  // no CTA leaves while another may still read its shared memory
  sm90::cluster_wait();
}

// Launches the kernel over `segments` CTAs a head; with `clusters` given,
// launches nothing and writes how many clusters of `segments` fit on the
// card at once.
template <bool BF16>
int launch(const void* k, const void* v, const void* w, const float* s0, float* s_out, int B,
           int H, int T, int N, int V, int segments, const Strides& st, cudaStream_t stream,
           int* clusters) {
  using T_ = typename Elem<BF16>::T;
  auto kernel = wkv6_state_segmented<BF16>;
  const int smem = Layout<BF16>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(segments, B * H);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = segments;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T_*>(k), static_cast<const T_*>(v),
                           static_cast<const float*>(w), s0, s_out, st, H, T, N, V);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// k, w (B, H, T, N) and v (B, H, T, V), each given by its element strides
// (b, h, t) in `strides` (3 x 3, in the order k, v, w) with a contiguous
// last dim, 16-byte aligned with strides that are whole 16-byte vectors.
// w is float32; dtype 0: k, v float32, 1: bfloat16. s0 (B*H, N, V) float32
// or null (zero state); s_out (B*H, N, V) float32, the state after step T
// (may be s0); both 16-byte aligned. N, V multiples of 8 in 8..64;
// `segments` (1..8) CTAs a head, one cluster. Returns 0, a cudaError_t, or
// REPRO_BAD_ARGUMENT.
int repro_wkv6_state(const void* k, const void* v, const void* w, const float* s0,
                     float* s_out, int B, int H, int T, int N, int V, const long long* strides,
                     int dtype, int segments, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || (long)B * H > 65535 || N < 8 || N > kD || N % 8 != 0 ||
      V < 8 || V > kD || V % 8 != 0 || !strides || segments < 1 || segments > kMaxSegments ||
      (dtype != 0 && dtype != 1))
    return REPRO_BAD_ARGUMENT;
  Strides st;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) st.s[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<true>(k, v, w, s0, s_out, B, H, T, N, V, segments, st, s, nullptr);
  return launch<false>(k, v, w, s0, s_out, B, H, T, N, V, segments, st, s, nullptr);
}

// Dynamic shared memory of the kernel (bytes), for the build report.
int repro_wkv6_state_smem(int dtype) {
  return dtype ? Layout<true>::kSmem : Layout<false>::kSmem;
}

// How many clusters of `segments` CTAs fit on the current card at once
// (the build report; the wrapper's segment rule assumes its table of
// them), or -1 on an error.
int repro_wkv6_state_clusters(int dtype, int segments) {
  if (segments < 1 || segments > kMaxSegments) return -1;
  Strides st = {};
  int n = 0;
  const int err = dtype ? launch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, kD,
                                       kD, segments, st, nullptr, &n)
                        : launch<false>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, kD,
                                        kD, segments, st, nullptr, &n);
  return err == 0 ? n : -1;
}

const char* repro_wkv6_state_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
