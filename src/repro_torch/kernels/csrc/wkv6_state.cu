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
// That kernel (`segmented`) serves long sequences. The graphed prefill's
// pieces (T <= 512 by the wrapper's rule, wkv6_state.variant) take a second
// one, `row_blocks`, built on the recurrence's other independence: row n
// of a head's state evolves alone,
//   S_t[n, :] = d_t[n] S_{t-1}[n, :] + k_t[n] v_t[:],
// so a CTA owns 16 rows of one head (grid: ceil(N / 16) x B*H; 128 CTAs
// for rwkv6's 32 heads of 64, one wave on 132 SMs):
//   * it reads k and w at its rows, all of v, and only its own rows of the
//     state: no cluster, no combine, and s_out may be s0 with no ordering
//     at all (each thread reads its state elements at entry and writes the
//     same ones at the end);
//   * the state's load is issued at entry, before any input is waited on;
//     k, w (16 columns) and v (all V) arrive by 16-byte cp.async in 64-step
//     tiles, a ring of four, three tiles ahead of the one rolled, so a
//     piece of up to 192 steps is one round trip;
//   * a tile is rolled as one product, not step by step. Stepping, every
//     thread reads its v from shared memory at every step: the first
//     version of this kernel (four columns a thread, a multiply and an FMA
//     an element a step) ran at ~40 ns a step, bound by shared-memory
//     wavefronts, and lost to `segmented` at 512 steps (PERF.md). With m_t
//     the product of the decays after step t inside the tile and P the
//     tile's, S[n, :] <- P[n] S[n, :] + sum_t (k_t[n] m_t[n]) v_t[:]: the
//     m_t come from a suffix scan over each row's 64 steps by its 16
//     threads (a half-warp, shuffles), and the sum is a (16 x 64) (64 x 64)
//     product on the tensor cores (mma.sync, 3xTF32), the state held in the
//     accumulators from entry to exit.
// `segmented` has no tensor cores: everything there is float32 on the CUDA
// cores.
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
// of kRow-element rows. All kThr threads of the block take part.
template <int kRow, int kThr, typename T>
__device__ __forceinline__ void stage_rows(char* dst, const T* src, long long st, int t0, int nt,
                                           int X, int vec) {
  const int per_row = X / vec;
  for (int i = threadIdx.x; i < nt * per_row; i += kThr) {
    const int row = i / per_row;
    const int c = (i - row * per_row) * vec;
    sm90::cp_async16(dst + (row * kRow + c) * (int)sizeof(T), src + (t0 + row) * st + c, true);
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
  stage_rows<kD, kThreads>(smem + L::kRawK, kp, st.s[kK][2], t0, nt, N, vec);
  stage_rows<kD, kThreads>(smem + L::kRawV, vp, st.s[kVal][2], t0, nt, V, vec);
  stage_rows<kD, kThreads>(smem + L::kRawW, wp, st.s[kW][2], t0, nt, N, 4);
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

// ---------------------------------------------------------------- row_blocks

constexpr int kRows = 16;          // state rows a CTA: the m16 of one mma tile
constexpr int kRowThreads = 256;   // warp w takes the state's columns 8w .. 8w + 7
constexpr int kRowStages = 4;      // raw tiles in flight: three ahead of the one rolled
constexpr int kArow = kTile + 8;   // a row of k~: the A fragments' pair loads hit 32 banks

// Dynamic shared memory of the row-block kernel, in bytes from the base: a
// ring of kRowStages raw tiles, each k (16 columns a step of the model
// dtype) and w (16 float32) in rows padded to kKrow and kWrow elements, so
// that a row's 16 threads reading steps q, q + 16, ... of it hit distinct
// banks (two-way at most), and v (64 columns) in rows padded to kVrow, so
// that the B fragments' loads hit 32 banks; then k~ (kRows x kArow float32)
// and the tile's decay product per row.
template <bool BF16>
struct RowLayout {
  static constexpr int kElem = (int)sizeof(typename Elem<BF16>::T);
  static constexpr int kKrow = BF16 ? kRows + 8 : kRows + 4;
  static constexpr int kWrow = kRows + 4;
  static constexpr int kVrow = BF16 ? kD + 8 : kD + 4;
  static constexpr int kRawK = 0;
  static constexpr int kRawW = kRawK + kTile * kKrow * kElem;
  static constexpr int kRawV = kRawW + kTile * kWrow * 4;
  static constexpr int kStage = kRawV + kTile * kVrow * kElem;
  static constexpr int kKa = kRowStages * kStage;
  static constexpr int kP = kKa + kRows * kArow * 4;
  static constexpr int kSmem = kP + kRows * 4;
  static_assert(kStage % 16 == 0 && kKa % 16 == 0 && (kKrow * kElem) % 16 == 0 &&
                    (kVrow * kElem) % 16 == 0 && (kWrow * 4) % 16 == 0,
                "16-byte aligned stages and rows");
};

// A float32 operand split for 3xTF32: v = big + small, big v rounded to
// TF32 (half an ulp added to the bits, the low 13 cleared), small = v - big
// exact (the tensor core reads its top 19 bits).
struct Split {
  uint32_t big, small;
};
__device__ __forceinline__ Split split_tf32(float v) {
  const uint32_t b = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  return {b, __float_as_uint(v - __uint_as_float(b))};
}

// d (16 x 8) += a (16 x 8, TF32) b (8 x 8, TF32), float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start one tile's copies (steps t0 .. t0 + nt - 1) into a raw stage as one
// cp.async group: k and w at the block's 16 rows (rows past the head's
// `rows` zero-filled), v at all 64 columns (past V zero-filled), and every
// row of steps nt .. nt8 - 1 zero-filled (the last k-step of the products
// reads them).
template <bool BF16>
__device__ __forceinline__ void stage_row_tile(char* stage, const typename Elem<BF16>::T* kp,
                                               const float* wp,
                                               const typename Elem<BF16>::T* vp,
                                               const Strides& st, int t0, int nt, int rows,
                                               int V) {
  using E = Elem<BF16>;
  using L = RowLayout<BF16>;
  constexpr int kVec = E::kVec;
  constexpr int k_per = kRows / kVec, w_per = kRows / 4, v_per = kD / kVec;  // vectors a step
  const int nt8 = min(kTile, (nt + 7) & ~7);
  for (int i = threadIdx.x; i < nt8 * k_per; i += kRowThreads) {
    const int t = i / k_per, c = (i % k_per) * kVec;
    const bool ok = t < nt && c < rows;
    sm90::cp_async16(stage + L::kRawK + (t * L::kKrow + c) * L::kElem,
                     ok ? kp + (t0 + t) * st.s[kK][2] + c : kp, ok);
  }
  for (int i = threadIdx.x; i < nt8 * w_per; i += kRowThreads) {
    const int t = i / w_per, c = (i % w_per) * 4;
    const bool ok = t < nt && c < rows;
    sm90::cp_async16(stage + L::kRawW + (t * L::kWrow + c) * 4,
                     ok ? wp + (t0 + t) * st.s[kW][2] + c : wp, ok);
  }
  for (int i = threadIdx.x; i < nt8 * v_per; i += kRowThreads) {
    const int t = i / v_per, c = (i % v_per) * kVec;
    const bool ok = t < nt && c < V;
    sm90::cp_async16(stage + L::kRawV + (t * L::kVrow + c) * L::kElem,
                     ok ? vp + (t0 + t) * st.s[kVal][2] + c : vp, ok);
  }
  sm90::cp_async_commit();
}

// A tile of nt steps rolled as one product: with m_t[n] the product of the
// decays after step t inside the tile and P[n] the tile's,
//   S[n, :] <- P[n] S[n, :] + sum_t k~_t[n] v_t[:],   k~_t = k_t m_t,
// the same recurrence regrouped by tile, every factor in [0, 1]. The sum is
// a (16 x nt) (nt x 64) product on the tensor cores, 3xTF32: k~ split big +
// small against v (exact in TF32 from bf16: two passes; split too from
// float32: three), float32 sums. Fragments (g = lane / 4, t = lane % 4):
// A a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0
// (k t, col g), b1 (k t + 4, col g); the accumulator c0, c1 (row g, cols
// 2t, 2t + 1), c2, c3 (row g + 8). The sum over k is order-free, so k
// positions t and t + 4 of a k-step are its steps 2t and 2t + 1 (one pair
// load of k~). The state stays in the accumulators from entry to exit.
template <bool BF16>
__global__ void __launch_bounds__(kRowThreads)
wkv6_state_rows(const typename Elem<BF16>::T* __restrict__ k,
                const typename Elem<BF16>::T* __restrict__ v, const float* __restrict__ w,
                const float* s0, float* s_out, Strides st, int H, int T, int N, int V) {
  using E = Elem<BF16>;
  using T_ = typename E::T;
  using L = RowLayout<BF16>;
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int rows = min(kRows, N - n0);  // the block's rows inside the head (a multiple of 8)
  const bool cols = 8 * warp < V;       // the warp's columns are live (V a multiple of 8)
  const int col = 8 * warp + 2 * t4;
  const bool live0 = cols && g < rows, live1 = cols && g + 8 < rows;

  // The state first, into the accumulators: its load is in flight while the
  // inputs are staged.
  float* const out0 = s_out + ((long)bh * N + n0 + g) * V + col;
  float* const out1 = out0 + 8 * (long)V;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  float e[4] = {0.f, 0.f, 0.f, 0.f};  // the state is c + e: two chains of products
  if (s0 != nullptr) {
    const float* in0 = s0 + ((long)bh * N + n0 + g) * V + col;
    if (live0) {
      const float2 x = *reinterpret_cast<const float2*>(in0);
      c[0] = x.x;
      c[1] = x.y;
    }
    if (live1) {
      const float2 x = *reinterpret_cast<const float2*>(in0 + 8 * (long)V);
      c[2] = x.x;
      c[3] = x.y;
    }
  }

  const T_* kp = k + b * st.s[kK][0] + h * st.s[kK][1] + n0;
  const float* wp = w + b * st.s[kW][0] + h * st.s[kW][1] + n0;
  const T_* vp = v + b * st.s[kVal][0] + h * st.s[kVal][1];
  float* ka = reinterpret_cast<float*>(smem + L::kKa);  // [kRows][kArow]
  float* pv = reinterpret_cast<float*>(smem + L::kP);   // [kRows]

  const int n_tiles = (T + kTile - 1) / kTile;
#pragma unroll
  for (int p = 0; p < kRowStages - 1; ++p) {
    if (p < n_tiles)
      stage_row_tile<BF16>(smem + p * L::kStage, kp, wp, vp, st, p * kTile,
                           min(kTile, T - p * kTile), rows, V);
    else
      sm90::cp_async_commit();  // an empty group keeps one group a tile
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = i * kTile;
    const int nt = min(kTile, T - t0);
    const char* stage = smem + (i % kRowStages) * L::kStage;
    const T_* raw_k = reinterpret_cast<const T_*>(stage + L::kRawK);
    const float* raw_w = reinterpret_cast<const float*>(stage + L::kRawW);
    const T_* raw_v = reinterpret_cast<const T_*>(stage + L::kRawV);
    sm90::cp_async_wait<kRowStages - 2>();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1's products
    {  // k~ and P of row r by its 16 threads (a half-warp), thread q taking the
       // steps q + 16j of the four blocks j of 16 steps: each block's decays
       // (accurate expf; steps past nt decay nothing and add nothing) scanned
       // by shuffles for the product after each step inside the block, times
       // the products of the later blocks
      const int r = tid / 16, q = tid % 16;
      float d[4], kv[4], inc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = q + 16 * j;
        d[j] = 1.f;
        kv[j] = 0.f;
        if (t < nt) {
          d[j] = expf(-expf(raw_w[t * L::kWrow + r]));
          kv[j] = E::load(raw_k, t * L::kKrow + r);
        }
        inc[j] = d[j];
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = __shfl_down_sync(0xffffffffu, inc[j], off, 16);
          if (q + off < 16) inc[j] *= y;  // then the product over block j's steps from q on
        }
      }
      float after = 1.f;  // the product over the blocks after j
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        float m = __shfl_down_sync(0xffffffffu, inc[j], 1, 16);  // block j's steps after q
        if (q == 15) m = 1.f;
        ka[r * kArow + q + 16 * j] = kv[j] * (m * after);
        after *= __shfl_sync(0xffffffffu, inc[j], 0, 16);
      }
      if (q == 0) pv[r] = after;  // the tile's product
    }
    __syncthreads();  // k~ and P are in; tile i - 1's raw stage is free
    const int ahead = i + kRowStages - 1;
    if (ahead < n_tiles)
      stage_row_tile<BF16>(smem + (ahead % kRowStages) * L::kStage, kp, wp, vp, st,
                           ahead * kTile, min(kTile, T - ahead * kTile), rows, V);
    else
      sm90::cp_async_commit();
    if (cols) {
      const float p0 = pv[g], p1 = pv[g + 8];
      c[0] *= p0;
      c[1] *= p0;
      c[2] *= p1;
      c[3] *= p1;
      e[0] *= p0;
      e[1] *= p0;
      e[2] *= p1;
      e[3] *= p1;
      // k-step kk's product into acc: the even k-steps into c, the odd into e,
      // two independent chains of mma
      auto product = [&](float(&acc)[4], int kk) {
        const float2 lo = *reinterpret_cast<const float2*>(ka + g * kArow + 8 * kk + 2 * t4);
        const float2 hi =
            *reinterpret_cast<const float2*>(ka + (g + 8) * kArow + 8 * kk + 2 * t4);
        const Split s0_ = split_tf32(lo.x), s1_ = split_tf32(hi.x), s2_ = split_tf32(lo.y),
                    s3_ = split_tf32(hi.y);
        const uint32_t ab[4] = {s0_.big, s1_.big, s2_.big, s3_.big};
        const uint32_t as[4] = {s0_.small, s1_.small, s2_.small, s3_.small};
        const T_* vr = raw_v + (8 * kk + 2 * t4) * L::kVrow + 8 * warp + g;
        const float b0 = E::load(vr, 0), b1 = E::load(vr, L::kVrow);
        if constexpr (BF16) {  // v exact in TF32: k~_small v + k~_big v
          mma_tf32(acc, as, __float_as_uint(b0), __float_as_uint(b1));
          mma_tf32(acc, ab, __float_as_uint(b0), __float_as_uint(b1));
        } else {  // k~_small v_big + k~_big v_small + k~_big v_big
          const Split v0 = split_tf32(b0), v1 = split_tf32(b1);
          mma_tf32(acc, as, v0.big, v1.big);
          mma_tf32(acc, ab, v0.small, v1.small);
          mma_tf32(acc, ab, v0.big, v1.big);
        }
      };
      const int nk = (nt + 7) / 8;
      for (int kk = 0; kk < nk; kk += 2) {
        product(c, kk);
        if (kk + 1 < nk) product(e, kk + 1);
      }
    }
  }
  if (live0) *reinterpret_cast<float2*>(out0) = make_float2(c[0] + e[0], c[1] + e[1]);
  if (live1) *reinterpret_cast<float2*>(out1) = make_float2(c[2] + e[2], c[3] + e[3]);
}

template <bool BF16>
int launch_rows(const void* k, const void* v, const void* w, const float* s0, float* s_out,
                int B, int H, int T, int N, int V, const Strides& st, cudaStream_t stream) {
  using T_ = typename Elem<BF16>::T;
  auto kernel = wkv6_state_rows<BF16>;
  const int smem = RowLayout<BF16>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((N + kRows - 1) / kRows, B * H), kRowThreads, smem, stream>>>(
      static_cast<const T_*>(k), static_cast<const T_*>(v), static_cast<const float*>(w), s0,
      s_out, st, H, T, N, V);
  return (int)cudaGetLastError();
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
// (may be s0); both 16-byte aligned. N, V multiples of 8 in 8..64. variant
// 0 (segmented): `split` (1..8) CTAs a head, one cluster; 1 (row_blocks):
// `split` (16) state rows a CTA. Returns 0, a cudaError_t, or
// REPRO_BAD_ARGUMENT.
int repro_wkv6_state(const void* k, const void* v, const void* w, const float* s0,
                     float* s_out, int B, int H, int T, int N, int V, const long long* strides,
                     int dtype, int variant, int split, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || (long)B * H > 65535 || N < 8 || N > kD || N % 8 != 0 ||
      V < 8 || V > kD || V % 8 != 0 || !strides || (dtype != 0 && dtype != 1) ||
      (variant == 0 && (split < 1 || split > kMaxSegments)) ||
      (variant == 1 && split != kRows) || variant < 0 || variant > 1)
    return REPRO_BAD_ARGUMENT;
  Strides st;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) st.s[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return dtype ? launch_rows<true>(k, v, w, s0, s_out, B, H, T, N, V, st, s)
                 : launch_rows<false>(k, v, w, s0, s_out, B, H, T, N, V, st, s);
  if (dtype == 1)
    return launch<true>(k, v, w, s0, s_out, B, H, T, N, V, split, st, s, nullptr);
  return launch<false>(k, v, w, s0, s_out, B, H, T, N, V, split, st, s, nullptr);
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
