// Gradient of causal / sliding-window GQA flash attention (K4 backward).
//
// The training counterpart of src/repro/kernels/flash_attention.py::
// flash_attention (pallas_call at :150): the JAX package differentiates
// that kernel (on its CPU, the jnp oracle it routes to) under
// jax.value_and_grad; here the gradient is a kernel of its own, launched
// from the backward of ops.flash_attention's autograd route. Queries and
// keys are both at positions 0..S-1 (training: Sq == Skv, q_offset 0); a
// key at p is visible to a query at x iff p <= x when causal and x - p <
// window when window > 0. With P the softmax of S = scale Q K^T over the
// visible keys, O the forward's output and dO its gradient:
//   delta = rowsum(dO o O),  dV = P^T dO,  dS = P o (dO V^T - delta),
//   dQ = scale dS K,  dK = scale dS^T Q   (GQA: summed over the group).
//
// What bounds it on an H100: operations, ~5 products of 2 S^2 D flops a
// (batch, head), half that when causal; the floor is the bf16 tensor-core
// rate. Two variants, picked by the wrapper from dtype and head dim before
// the launch (never as a fallback), each three kernels launched in order on
// the caller's stream; dK/dV take one block per (b, kv head, key tile) that
// loops over every query head of the group and every query tile that can
// see its keys, so GQA's sum stays inside the block: no atomics, the same
// bits every run.
//
// * wgmma (bf16, D = 64, 128, 256). The forward saved each row's
//   log-sum-exp (flash_attention.cu's `lse`), so P = exp(scale S - lse) is
//   had without a row pass.
//   (a) delta: rowsum(dO o O) in float32, D / 8 lanes a row (bytes-bound).
//   (b) dk_dv: one block per (b, kv head, 64 keys) holds K and V in shared
//       memory; a producer warp streams the group's Q and dO tiles (and
//       their rows' lse, delta) through a 2-stage TMA + mbarrier ring. For
//       each tile the consumer warpgroup computes S^T = K Q^T and dP^T =
//       V dO^T (m64n64k16, both operands K-major from shared memory), P^T
//       and dS^T = P^T o (dP^T - delta) on the accumulator fragments, then
//       dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 as
//       the register A operand and dO, Q MN-major through the transpose bit
//       (the two product shapes of the forward, sm90.cuh). At D = 256 the
//       dK and dV accumulators of one warpgroup would need 256 floats a
//       thread, so two warpgroups each own 128 of the head dim's columns
//       and both compute S^T and dP^T.
//   (c) dq: one block per (b, q head, 64 query rows) holds Q and dO and
//       streams the K/V tiles its rows can see: S = Q K^T, dP = dO V^T, dS,
//       then dQ += dS K (dS in bf16, K MN-major). Query tiles are launched
//       latest first and key tiles earliest first, so the longest causal
//       blocks start first.
//   P and dS are rounded to bf16 as the forward rounds P (the Pallas
//   kernel's own rounding of P to the value dtype); every sum is float32.
// * cuda_core (float32, and bf16 at D = 32 and 112, whose rows are not
//   whole 128-byte swizzle rows): the first version, kept as the prior.
//   Float32 arithmetic on the CUDA cores (bf16 inputs are widened), so its
//   floor is the card's 67 TFLOP/s float32 rate:
//   (a) rows: one block per (b, q head, ROWS query rows) recomputes each
//       row's log-sum-exp over its visible keys and delta = rowsum(dO o O);
//   (b) dk_dv: one block per (b, kv head, ROWS keys) holds its keys' k, v
//       and the dk, dv sums in registers;
//   (c) dq: one block per (b, q head, ROWS query rows) loops over the key
//       tiles its rows can see.
//   A row (query or key) is held by TPK neighbouring threads, each owning
//   DPT = D / TPK of its dims (d = m * TPK + lane); a dot product over D is
//   finished by log2(TPK) xor shuffles. Tiles of the other side are staged
//   as float32 in static shared memory (two tiles of ROWS x D, 32 KB) by
//   16-byte vector loads; rows past S are zeros.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::Elem;
using repro::kNegInf;
namespace sm90 = repro::sm90;

constexpr int kThreads = 256;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

template <int D>
struct Cfg {
  static constexpr int TPK = D <= 32 ? 2 : D <= 64 ? 4 : D <= 128 ? 8 : 16;  // threads a row
  static constexpr int DPT = D / TPK;            // dims a thread: 16, 16, 14, 16, 16
  static constexpr int ROWS = kThreads / TPK;    // rows a block: 128, 64, 32, 32, 16
  static_assert(D % TPK == 0, "a thread owns whole dims");
};

template <int TPK>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPK; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

// Keys [begin, end) some query of rows [q0, q1) can see.
__device__ __forceinline__ void key_range(int q0, int q1, int S, int causal, int window,
                                          int* begin, int* end) {
  *end = causal ? min(S, q1) : S;
  *begin = window > 0 ? max(0, q0 - window + 1) : 0;
}

// Queries [begin, end) that can see some key of [k0, k1).
__device__ __forceinline__ void query_range(int k0, int k1, int S, int causal, int window,
                                            int* begin, int* end) {
  *begin = causal ? k0 : 0;
  *end = window > 0 ? min(S, k1 - 1 + window) : S;
}

// ------------------------------------------------------------------ (a) rows
template <bool BF16, int D>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const typename Elem<BF16>::T* __restrict__ q,
            const typename Elem<BF16>::T* __restrict__ k,
            const typename Elem<BF16>::T* __restrict__ o,
            const typename Elem<BF16>::T* __restrict__ dout,
            float* __restrict__ lse, float* __restrict__ delta,
            int Hq, int Hkv, int S, int causal, int window, float scale) {
  using E = Elem<BF16>;
  using C = Cfg<D>;
  __shared__ float k_s[C::ROWS * D];
  const int tid = threadIdx.x;
  const int row = tid / C::TPK;
  const int lane = tid % C::TPK;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int G = Hq / Hkv;
  const long q_base = (long)bh * S * D;
  const long kv_base = ((long)b * Hkv + (bh % Hq) / G) * (long)S * D;
  const int q0 = blockIdx.x * C::ROWS;
  const int qi = q0 + row;
  const bool valid = qi < S;

  float qr[C::DPT];
  float dl = 0.f;
#pragma unroll
  for (int m = 0; m < C::DPT; ++m) {
    const long at = q_base + (long)qi * D + m * C::TPK + lane;
    qr[m] = valid ? E::load(q, at) : 0.f;
    dl += valid ? E::load(dout, at) * E::load(o, at) : 0.f;
  }
  dl = row_sum<C::TPK>(dl);

  float mx = kNegInf, l = 0.f;
  int kb, ke;
  key_range(q0, min(S, q0 + C::ROWS), S, causal, window, &kb, &ke);
  kb = (kb / C::ROWS) * C::ROWS;
  for (int j0 = kb; j0 < ke; j0 += C::ROWS) {
    const int n = min(C::ROWS, S - j0);
    repro::load_tile<E, D>(k_s, D, k + kv_base + (long)j0 * D, n, C::ROWS);
    __syncthreads();
    const int t_end = min(C::ROWS, ke - j0);
    for (int t = 0; t < t_end; ++t) {
      float part = 0.f;
#pragma unroll
      for (int m = 0; m < C::DPT; ++m) part = fmaf(qr[m], k_s[t * D + m * C::TPK + lane], part);
      const float s = row_sum<C::TPK>(part) * scale;
      if (visible(qi, j0 + t, causal, window)) {
        if (s > mx) {
          l = l * expf(mx - s) + 1.f;
          mx = s;
        } else {
          l += expf(s - mx);
        }
      }
    }
    __syncthreads();
  }
  if (valid && lane == 0) {
    // a row with no visible key gets +inf, so every p = exp(s - lse) is 0
    lse[(long)bh * S + qi] = l > 0.f ? mx + logf(l) : inf();
    delta[(long)bh * S + qi] = dl;
  }
}

// ------------------------------------------------------------------ (b) dk, dv
template <bool BF16, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const typename Elem<BF16>::T* __restrict__ q,
            const typename Elem<BF16>::T* __restrict__ k,
            const typename Elem<BF16>::T* __restrict__ v,
            const typename Elem<BF16>::T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            typename Elem<BF16>::T* __restrict__ dk, typename Elem<BF16>::T* __restrict__ dv,
            int Hq, int Hkv, int S, int causal, int window, float scale) {
  using E = Elem<BF16>;
  using C = Cfg<D>;
  __shared__ float q_s[C::ROWS * D];
  __shared__ float do_s[C::ROWS * D];
  __shared__ float lse_s[C::ROWS];
  __shared__ float delta_s[C::ROWS];
  const int tid = threadIdx.x;
  const int row = tid / C::TPK;
  const int lane = tid % C::TPK;
  const int bhk = blockIdx.y;  // b * Hkv + kv head
  const int b = bhk / Hkv;
  const int hk = bhk % Hkv;
  const int G = Hq / Hkv;
  const long kv_base = (long)bhk * S * D;
  const int k0 = blockIdx.x * C::ROWS;
  const int kj = k0 + row;
  const bool valid = kj < S;

  float kr[C::DPT], vr[C::DPT], dkr[C::DPT], dvr[C::DPT];
#pragma unroll
  for (int m = 0; m < C::DPT; ++m) {
    const long at = kv_base + (long)kj * D + m * C::TPK + lane;
    kr[m] = valid ? E::load(k, at) : 0.f;
    vr[m] = valid ? E::load(v, at) : 0.f;
    dkr[m] = 0.f;
    dvr[m] = 0.f;
  }
  int qb, qe;
  query_range(k0, min(S, k0 + C::ROWS), S, causal, window, &qb, &qe);
  qb = (qb / C::ROWS) * C::ROWS;
  for (int g = 0; g < G; ++g) {
    const long bh = (long)b * Hq + hk * G + g;
    const long q_base = bh * S * D;
    for (int i0 = qb; i0 < qe; i0 += C::ROWS) {
      const int n = min(C::ROWS, S - i0);
      repro::load_tile<E, D>(q_s, D, q + q_base + (long)i0 * D, n, C::ROWS);
      repro::load_tile<E, D>(do_s, D, dout + q_base + (long)i0 * D, n, C::ROWS);
      for (int t = tid; t < C::ROWS; t += kThreads) {
        lse_s[t] = t < n ? lse[bh * S + i0 + t] : inf();
        delta_s[t] = t < n ? delta[bh * S + i0 + t] : 0.f;
      }
      __syncthreads();
      const int t_end = min(C::ROWS, qe - i0);
      for (int t = 0; t < t_end; ++t) {
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int m = 0; m < C::DPT; ++m) {
          sp = fmaf(q_s[t * D + m * C::TPK + lane], kr[m], sp);
          dpp = fmaf(do_s[t * D + m * C::TPK + lane], vr[m], dpp);
        }
        const float s = row_sum<C::TPK>(sp) * scale;
        const float dp = row_sum<C::TPK>(dpp);
        const bool vis = valid && visible(i0 + t, kj, causal, window);
        const float p = vis ? expf(s - lse_s[t]) : 0.f;
        const float ds = p * (dp - delta_s[t]);
#pragma unroll
        for (int m = 0; m < C::DPT; ++m) {
          dvr[m] = fmaf(p, do_s[t * D + m * C::TPK + lane], dvr[m]);
          dkr[m] = fmaf(ds, q_s[t * D + m * C::TPK + lane], dkr[m]);
        }
      }
      __syncthreads();
    }
  }
  if (valid) {
#pragma unroll
    for (int m = 0; m < C::DPT; ++m) {
      const long at = kv_base + (long)kj * D + m * C::TPK + lane;
      E::store(dk, at, dkr[m] * scale);
      E::store(dv, at, dvr[m]);
    }
  }
}

// ------------------------------------------------------------------ (c) dq
template <bool BF16, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const typename Elem<BF16>::T* __restrict__ q,
          const typename Elem<BF16>::T* __restrict__ k,
          const typename Elem<BF16>::T* __restrict__ v,
          const typename Elem<BF16>::T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          typename Elem<BF16>::T* __restrict__ dq,
          int Hq, int Hkv, int S, int causal, int window, float scale) {
  using E = Elem<BF16>;
  using C = Cfg<D>;
  __shared__ float k_s[C::ROWS * D];
  __shared__ float v_s[C::ROWS * D];
  const int tid = threadIdx.x;
  const int row = tid / C::TPK;
  const int lane = tid % C::TPK;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int G = Hq / Hkv;
  const long q_base = (long)bh * S * D;
  const long kv_base = ((long)b * Hkv + (bh % Hq) / G) * (long)S * D;
  const int q0 = blockIdx.x * C::ROWS;
  const int qi = q0 + row;
  const bool valid = qi < S;

  float qr[C::DPT], dor[C::DPT], dqr[C::DPT];
#pragma unroll
  for (int m = 0; m < C::DPT; ++m) {
    const long at = q_base + (long)qi * D + m * C::TPK + lane;
    qr[m] = valid ? E::load(q, at) : 0.f;
    dor[m] = valid ? E::load(dout, at) : 0.f;
    dqr[m] = 0.f;
  }
  const float lse_i = valid ? lse[(long)bh * S + qi] : inf();
  const float delta_i = valid ? delta[(long)bh * S + qi] : 0.f;
  int kb, ke;
  key_range(q0, min(S, q0 + C::ROWS), S, causal, window, &kb, &ke);
  kb = (kb / C::ROWS) * C::ROWS;
  for (int j0 = kb; j0 < ke; j0 += C::ROWS) {
    const int n = min(C::ROWS, S - j0);
    repro::load_tile<E, D>(k_s, D, k + kv_base + (long)j0 * D, n, C::ROWS);
    repro::load_tile<E, D>(v_s, D, v + kv_base + (long)j0 * D, n, C::ROWS);
    __syncthreads();
    const int t_end = min(C::ROWS, ke - j0);
    for (int t = 0; t < t_end; ++t) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int m = 0; m < C::DPT; ++m) {
        sp = fmaf(qr[m], k_s[t * D + m * C::TPK + lane], sp);
        dpp = fmaf(dor[m], v_s[t * D + m * C::TPK + lane], dpp);
      }
      const float s = row_sum<C::TPK>(sp) * scale;
      const float dp = row_sum<C::TPK>(dpp);
      const bool vis = valid && visible(qi, j0 + t, causal, window);
      const float p = vis ? expf(s - lse_i) : 0.f;
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int m = 0; m < C::DPT; ++m) dqr[m] = fmaf(ds, k_s[t * D + m * C::TPK + lane], dqr[m]);
    }
    __syncthreads();
  }
  if (valid) {
#pragma unroll
    for (int m = 0; m < C::DPT; ++m)
      E::store(dq, q_base + (long)qi * D + m * C::TPK + lane, dqr[m] * scale);
  }
}

template <bool BF16, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int B, int Hq, int Hkv,
           int S, int causal, int window, float scale, cudaStream_t st) {
  using T = typename Elem<BF16>::T;
  using C = Cfg<D>;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* do_ = static_cast<const T*>(dout);
  const dim3 q_grid((S + C::ROWS - 1) / C::ROWS, B * Hq);
  const dim3 k_grid((S + C::ROWS - 1) / C::ROWS, B * Hkv);
  rows_kernel<BF16, D><<<q_grid, kThreads, 0, st>>>(q_, k_, o_, do_, lse, delta, Hq, Hkv, S,
                                                    causal, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<BF16, D><<<k_grid, kThreads, 0, st>>>(q_, k_, v_, do_, lse, delta,
                                                    static_cast<T*>(dk), static_cast<T*>(dv),
                                                    Hq, Hkv, S, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_kernel<BF16, D><<<q_grid, kThreads, 0, st>>>(q_, k_, v_, do_, lse, delta,
                                                  static_cast<T*>(dq), Hq, Hkv, S, causal,
                                                  window, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------- wgmma
namespace tc {
constexpr int kTile = 64;    // keys of a dk_dv block, query rows of a dq block; the streamed tiles
constexpr int kStages = 2;
constexpr int kBox = sm90::kBox;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct KV {  // dk_dv
  static constexpr int kWG = D == 256 ? 2 : 1;            // consumer warpgroups
  static constexpr int kDH = D / kWG;                     // dK, dV columns a warpgroup owns
  static constexpr int kThreads = 128 * kWG + 32;         // + the producer warp
  static constexpr int kTileB = (D / 64) * kBox;          // a 64-row tile across the head dim
  static constexpr int kStage = 2 * kTileB;               // Q then dO
  static constexpr int kStats = 2 * kTile;                // a stage's lse (log2 units), delta
  static constexpr int kBytes = 2 * kTileB + kStages * kStage + kStages * kStats * 4 +
                                (1 + 2 * kStages) * 8 + sm90::kAtomBytes;
};

template <int D>
struct QQ {  // dq
  static constexpr int kThreads = 128 + 32;
  static constexpr int kTileB = (D / 64) * kBox;
  static constexpr int kStage = 2 * kTileB;               // K then V
  static constexpr int kBytes = 2 * kTileB + kStages * kStage + (1 + 2 * kStages) * 8 +
                                sm90::kAtomBytes;
};

// The bf16 A fragments of a 64 x 64 accumulator's four k16 slices.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = sm90::pack_bf16x2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// This thread's rows r and r + 8 (those below rows_left) of a 64 x N
// accumulator, times `mul`, into bf16 rows of pitch D starting at base.
template <int N>
__device__ __forceinline__ void store_rows(uint16_t* base, int D, int r, int lane, int rows_left,
                                           const float (&acc)[N / 2], float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= rows_left) continue;
    uint16_t* row = base + (long)(r + 8 * h) * D;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * (lane % 4)) =
          sm90::pack_bf16x2(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}
}  // namespace tc

// (a) delta = rowsum(dO o O), float32; D / 8 lanes a row, one 16-byte vector each.
template <int D>
__global__ void __launch_bounds__(256)
delta_kernel(const uint16_t* __restrict__ o, const uint16_t* __restrict__ dout,
             float* __restrict__ delta, long rows) {
  constexpr int L = D / 8;
  const long g = (long)blockIdx.x * 256 + threadIdx.x;
  const long row = g / L;
  float acc = 0.f;
  if (row < rows) {
    float a[8], b[8];
    Elem<true>::unpack(__ldg(reinterpret_cast<const uint4*>(o + g * 8)), a);
    Elem<true>::unpack(__ldg(reinterpret_cast<const uint4*>(dout + g * 8)), b);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], b[e], acc);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && g % L == 0) delta[row] = acc;
}

// (b) dK, dV: block (b * Hkv + kv head, key tile).
template <int D>
__global__ void __launch_bounds__(tc::KV<D>::kThreads)
dkdv_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
           const float* __restrict__ lse, const float* __restrict__ delta,
           uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int Hq, int Hkv, int S,
           int causal, int window, float scale_log2, float scale) {
  using L = tc::KV<D>;
  extern __shared__ char smem_raw[];
  char* k_s = sm90::align_atom(smem_raw);
  char* v_s = k_s + L::kTileB;
  char* ring = v_s + L::kTileB;  // stage s: Q at ring + s * kStage, dO right after
  float* stats = reinterpret_cast<float*>(ring + tc::kStages * L::kStage);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + tc::kStages * L::kStats);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + tc::kStages;
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < tc::kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // the producer warp's lanes (each writes stats)
      sm90::mbar_init(&empty[s], L::kWG);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int bhk = blockIdx.x;
  const int G = Hq / Hkv;
  const int bh0 = (bhk / Hkv) * Hq + (bhk % Hkv) * G;  // the group's first query head
  const int k0 = blockIdx.y * tc::kTile;
  int qb, qe;  // queries that can see some key of the tile
  query_range(k0, min(S, k0 + tc::kTile), S, causal, window, &qb, &qe);
  const int n_qt = qe > qb ? (qe - qb + tc::kTile - 1) / tc::kTile : 0;
  const int n = G * n_qt;

  if (threadIdx.x / 32 == 4 * L::kWG) {  // producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kTileB);
      for (int i = 0; i < D / 64; ++i) {
        sm90::tma_load_3d(k_s + i * tc::kBox, &k_map, kv_full, 64 * i, k0, bhk);
        sm90::tma_load_3d(v_s + i * tc::kBox, &v_map, kv_full, 64 * i, k0, bhk);
      }
    }
    for (int t = 0; t < n; ++t) {
      const int s = t % tc::kStages;
      const long bh = bh0 + t / n_qt;
      const int i0 = qb + (t % n_qt) * tc::kTile;
      if (t >= tc::kStages) sm90::mbar_wait(&empty[s], ((t / tc::kStages) - 1) & 1);
      float* st = stats + s * L::kStats;
      for (int e = lane; e < tc::kTile; e += 32) {
        const int qi = i0 + e;  // rows past S: p = 0 (their dO rows read as zeros)
        st[e] = qi < S ? lse[bh * S + qi] * tc::kLog2e : inf();
        st[tc::kTile + e] = qi < S ? delta[bh * S + qi] : 0.f;
      }
      if (lane == 0) {
        char* q_s = ring + s * L::kStage;
        sm90::mbar_arrive_expect_tx(&full[s], L::kStage);
        for (int i = 0; i < D / 64; ++i) {
          sm90::tma_load_3d(q_s + i * tc::kBox, &q_map, &full[s], 64 * i, i0, (int)bh);
          sm90::tma_load_3d(q_s + L::kTileB + i * tc::kBox, &do_map, &full[s], 64 * i, i0, (int)bh);
        }
      } else {
        sm90::mbar_arrive(&full[s]);  // releases this lane's stats
      }
    }
    return;
  }

  // consumer warpgroup wg: this thread holds key rows r and r + 8 of the tile
  // and, of dK and dV, head-dim columns wg * kDH ..
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r = (tid / 32) * 16 + lane / 4;
  const int col0 = wg * (L::kDH / 64) * tc::kBox;  // byte offset of this warpgroup's columns
  float dka[L::kDH / 2], dva[L::kDH / 2];
#pragma unroll
  for (int i = 0; i < L::kDH / 2; ++i) dka[i] = dva[i] = 0.f;
  sm90::mbar_wait(kv_full, 0);

  for (int t = 0; t < n; ++t) {
    const int s = t % tc::kStages;
    const int i0 = qb + (t % n_qt) * tc::kTile;
    const char* q_s = ring + s * L::kStage;
    const char* do_s = q_s + L::kTileB;
    const float* st = stats + s * L::kStats;
    sm90::mbar_wait(&full[s], (t / tc::kStages) & 1);

    float sc[32], dp[32];  // S^T, dP^T: keys r, r + 8 x this thread's 16 queries
    sm90::wgmma_fence();
    sm90::wgmma_abt<D>(sc, k_s, q_s);
    sm90::wgmma_abt<D>(dp, v_s, do_s);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    const bool whole = (!causal || i0 >= k0 + tc::kTile - 1) &&
                       (window <= 0 || i0 + tc::kTile - 1 - k0 < window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);  // query i0 + c
      const int kv = k0 + r + 8 * ((i / 2) % 2);
      const bool vis = whole || visible(i0 + c, kv, causal, window);
      const float p = vis ? exp2f(fmaf(sc[i], scale_log2, -st[c])) : 0.f;
      dp[i] = p * (dp[i] - st[tc::kTile + c]);
      sc[i] = p;
    }
    uint32_t pa[4][4], da[4][4];
    tc::pack_a(pa, sc);
    tc::pack_a(da, dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_acc_mn<L::kDH>(dva, pa[kk], do_s + col0, kk);
      sm90::wgmma_acc_mn<L::kDH>(dka, da[kk], q_s + col0, kk);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    if (tid == 0) sm90::mbar_arrive(&empty[s]);
  }

  const long at = ((long)bhk * S + k0) * D + wg * L::kDH;
  tc::store_rows<L::kDH>(dk + at, D, r, lane, S - k0, dka, scale);
  tc::store_rows<L::kDH>(dv + at, D, r, lane, S - k0, dva, 1.f);
}

// (c) dQ: block (b * Hq + q head, query tile), latest tile first.
template <int D>
__global__ void __launch_bounds__(tc::QQ<D>::kThreads)
dq_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
         const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
         const float* __restrict__ lse, const float* __restrict__ delta,
         uint16_t* __restrict__ dq, int Hq, int Hkv, int S, int causal, int window,
         float scale_log2, float scale) {
  using L = tc::QQ<D>;
  extern __shared__ char smem_raw[];
  char* q_s = sm90::align_atom(smem_raw);
  char* do_s = q_s + L::kTileB;
  char* ring = do_s + L::kTileB;  // stage s: K at ring + s * kStage, V right after
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + tc::kStages * L::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + tc::kStages;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < tc::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int bh = blockIdx.x;
  const int bkv = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * tc::kTile;
  const int q1 = min(S, q0 + tc::kTile);
  int kb, ke;
  key_range(q0, q1, S, causal, window, &kb, &ke);
  kb = kb / tc::kTile * tc::kTile;
  const int n = ke > kb ? (ke - kb + tc::kTile - 1) / tc::kTile : 0;

  if (threadIdx.x / 32 == 4) {  // producer
    if (threadIdx.x % 32 == 0) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * L::kTileB);
      for (int i = 0; i < D / 64; ++i) {
        sm90::tma_load_3d(q_s + i * tc::kBox, &q_map, q_full, 64 * i, q0, bh);
        sm90::tma_load_3d(do_s + i * tc::kBox, &do_map, q_full, 64 * i, q0, bh);
      }
      for (int t = 0; t < n; ++t) {
        const int s = t % tc::kStages;
        if (t >= tc::kStages) sm90::mbar_wait(&empty[s], ((t / tc::kStages) - 1) & 1);
        char* k_s = ring + s * L::kStage;
        const int j0 = kb + t * tc::kTile;
        sm90::mbar_arrive_expect_tx(&full[s], L::kStage);
        for (int i = 0; i < D / 64; ++i) {
          sm90::tma_load_3d(k_s + i * tc::kBox, &k_map, &full[s], 64 * i, j0, bkv);
          sm90::tma_load_3d(k_s + L::kTileB + i * tc::kBox, &v_map, &full[s], 64 * i, j0, bkv);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r = (tid / 32) * 16 + lane / 4;
  float l2[2], dl[2];  // rows r, r + 8: lse in log2 units, delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r + 8 * h;
    l2[h] = qi < S ? lse[(long)bh * S + qi] * tc::kLog2e : inf();
    dl[h] = qi < S ? delta[(long)bh * S + qi] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  sm90::mbar_wait(q_full, 0);

  for (int t = 0; t < n; ++t) {
    const int s = t % tc::kStages;
    const int j0 = kb + t * tc::kTile;
    const char* k_s = ring + s * L::kStage;
    const char* v_s = k_s + L::kTileB;
    sm90::mbar_wait(&full[s], (t / tc::kStages) & 1);

    float sc[32], dp[32];  // S, dP: rows r, r + 8 x this thread's 16 keys
    sm90::wgmma_fence();
    sm90::wgmma_abt<D>(sc, q_s, k_s);
    sm90::wgmma_abt<D>(dp, do_s, v_s);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    const bool whole = j0 + tc::kTile <= S && (!causal || j0 + tc::kTile - 1 <= q0) &&
                       (window <= 0 || q1 - 1 - j0 < window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kv = j0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      const int h = (i / 2) % 2;
      const bool vis = whole || (kv < S && visible(q0 + r + 8 * h, kv, causal, window));
      const float p = vis ? exp2f(fmaf(sc[i], scale_log2, -l2[h])) : 0.f;
      dp[i] = p * (dp[i] - dl[h]);
    }
    uint32_t da[4][4];
    tc::pack_a(da, dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::wgmma_acc_mn<D>(dqa, da[kk], k_s, kk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dqa);
    if (tid == 0) sm90::mbar_arrive(&empty[s]);
  }
  tc::store_rows<D>(dq + ((long)bh * S + q0) * D, D, r, lane, S - q0, dqa, scale);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 void* dq, void* dk, void* dv, const float* lse, float* delta, int B, int Hq,
                 int Hkv, int S, int causal, int window, float scale, cudaStream_t st) {
  CUtensorMap q_map, k_map, v_map, do_map;
  const uint32_t box[3] = {64, 64, 1};
  const uint64_t q_dims[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)B * Hq};
  const uint64_t kv_dims[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)B * Hkv};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)S * D * 2};
  if (sm90::make_tensor_map(&q_map, q, 3, q_dims, strides, box) != 0 ||
      sm90::make_tensor_map(&do_map, dout, 3, q_dims, strides, box) != 0 ||
      sm90::make_tensor_map(&k_map, k, 3, kv_dims, strides, box) != 0 ||
      sm90::make_tensor_map(&v_map, v, 3, kv_dims, strides, box) != 0)
    return REPRO_BAD_ARGUMENT;
  const long rows = (long)B * Hq * S;
  delta_kernel<D><<<(unsigned)((rows * (D / 8) + 255) / 256), 256, 0, st>>>(
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout), delta, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (S + tc::kTile - 1) / tc::kTile;
  const float scale_log2 = scale * tc::kLog2e;
  e = sm90::allow_dynamic_smem(dkdv_wgmma<D>, tc::KV<D>::kBytes);
  if (e != cudaSuccess) return (int)e;
  dkdv_wgmma<D><<<dim3(B * Hkv, tiles), tc::KV<D>::kThreads, tc::KV<D>::kBytes, st>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), Hq, Hkv, S, causal, window, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = sm90::allow_dynamic_smem(dq_wgmma<D>, tc::QQ<D>::kBytes);
  if (e != cudaSuccess) return (int)e;
  dq_wgmma<D><<<dim3(B * Hq, tiles), tc::QQ<D>::kThreads, tc::QQ<D>::kBytes, st>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<uint16_t*>(dq), Hq, Hkv, S, causal,
      window, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, do, dq (B,Hq,S,D); k, v, dk, dv (B,Hkv,S,D); lse, delta (B,Hq,S)
// float32; all contiguous, on the current device, 16-byte aligned. variant
// 1 (wgmma; bf16, D = 64, 128, 256): lse is the forward's log-sum-exp of
// each row, delta scratch. variant 0 (CUDA cores): both scratch. dtype: 0
// float32, 1 bfloat16. Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, void* dq, void* dk, void* dv, void* lse,
                              void* delta, int B, int Hq, int Hkv, int S, int D, int causal,
                              int window, int dtype, int variant, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_ = static_cast<float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  if (variant == 1) {
#define REPRO_BWD_TC(DIM)                                                                      \
  if (dtype == 1 && D == DIM)                                                                  \
    return launch_wgmma<DIM>(q, k, v, o, dout, dq, dk, dv, lse_, delta_, B, Hq, Hkv, S, causal, \
                             window, scale, st);
    REPRO_BWD_TC(64)
    REPRO_BWD_TC(128)
    REPRO_BWD_TC(256)
#undef REPRO_BWD_TC
    return REPRO_BAD_ARGUMENT;
  }
  if (variant != 0) return REPRO_BAD_ARGUMENT;
#define REPRO_BWD(BF16, DIM)                                                                   \
  if (dtype == (BF16 ? 1 : 0) && D == DIM)                                                     \
    return launch<BF16, DIM>(q, k, v, o, dout, dq, dk, dv, lse_, delta_, B, Hq, Hkv, S,        \
                             causal, window, scale, st);
  REPRO_BWD(false, 32)
  REPRO_BWD(false, 64)
  REPRO_BWD(false, 112)
  REPRO_BWD(false, 128)
  REPRO_BWD(false, 256)
  REPRO_BWD(true, 32)
  REPRO_BWD(true, 64)
  REPRO_BWD(true, 112)
  REPRO_BWD(true, 128)
  REPRO_BWD(true, 256)
#undef REPRO_BWD
  return REPRO_BAD_ARGUMENT;
}

// Dynamic shared memory of the wgmma variant's dk_dv and dq kernels at head
// dim D, in bytes (0 for a head dim it does not take).
int repro_flash_attention_bwd_smem(int D, int which) {
  if (D == 64) return which ? tc::QQ<64>::kBytes : tc::KV<64>::kBytes;
  if (D == 128) return which ? tc::QQ<128>::kBytes : tc::KV<128>::kBytes;
  if (D == 256) return which ? tc::QQ<256>::kBytes : tc::KV<256>::kBytes;
  return 0;
}

const char* repro_flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
