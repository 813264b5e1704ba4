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
// (batch, head), half that when causal. This first version runs them on the
// CUDA cores in float32 (bf16 inputs are widened), so its floor is the
// card's 67 TFLOP/s float32 rate, not the tensor cores'; a wgmma version
// with row statistics saved by the forward is later work. Three kernels,
// launched in order on the caller's stream:
//   (a) rows: one block per (b, q head, ROWS query rows) recomputes each
//       row's log-sum-exp over its visible keys (the forward returns no row
//       statistics) and delta = rowsum(dO o O), both float32;
//   (b) dk_dv: one block per (b, kv head, ROWS keys) holds its keys' k, v
//       and the dk, dv sums in registers and loops over every query head of
//       the group and every query tile that can see the keys, so GQA's sum
//       stays inside the block: no atomics, the same bits every run;
//   (c) dq: one block per (b, q head, ROWS query rows) loops over the key
//       tiles its rows can see.
// A row (query or key) is held by TPK neighbouring threads, each owning
// DPT = D / TPK of its dims (d = m * TPK + lane); a dot product over D is
// finished by log2(TPK) xor shuffles. Tiles of the other side are staged
// as float32 in static shared memory (two tiles of ROWS x D, 32 KB) by
// 16-byte vector loads; rows past S are zeros.
#include "common.cuh"

namespace {

using repro::Elem;
using repro::kNegInf;

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

}  // namespace

extern "C" {

// q, o, do, dq (B,Hq,S,D); k, v, dk, dv (B,Hkv,S,D); lse, delta (B,Hq,S)
// float32 scratch; all contiguous, on the current device, 16-byte aligned.
// dtype: 0 float32, 1 bfloat16. Returns 0, a cudaError_t, or
// REPRO_BAD_ARGUMENT.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, void* dq, void* dk, void* dv, void* lse,
                              void* delta, int B, int Hq, int Hkv, int S, int D, int causal,
                              int window, int dtype, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_ = static_cast<float*>(lse);
  float* delta_ = static_cast<float*>(delta);
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

const char* repro_flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
