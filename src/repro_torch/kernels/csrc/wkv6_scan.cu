// RWKV-6 WKV recurrence over a whole sequence (K5).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6_scan.py::wkv6_scan
// (pallas_call at :84, body _wkv6_kernel at :30). Per head, with an f32
// (N, V) state S and data-dependent decay d_t = exp(-exp(w_t)):
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(d_t) S_{t-1} + k_t^T v_t
// Unlike the TPU kernel, it starts from a given state (zero if none) and
// writes the state after step T, so a serving prefill, a chunked prefill's
// continuation and the state a decode step needs all come from one pass.
// It stops at T exactly: a padded step would decay the state it returns.
//
// What bounds it on an H100: neither bytes nor operations, but the chain
// of dependent steps. A step-by-step scan (the `sequential` kernel below,
// kept as the prior) makes T dependent steps per head, each a few FMAs and
// a shuffle sum, and gives a prompt of 32 heads 64 blocks: ~25x its bound.
//
// The `chunked` kernel cuts the chain 16-fold. Over a chunk of C = 16 steps
// from the state S0 entering it (rows t, s = 0..15):
//   P_t = prod_{j<t} d_j,  Q_s = prod_{s<j<16} d_j      (running products)
//   A[t,s] = sum_n r_tn k_sn prod_{s<j<t} d_jn  (s < t),  A[t,t] = sum_n r_tn u_n k_tn
//   o_t = (r_t . P_t) S0 + sum_{s<=t} A[t,s] v_s
//   S_16 = diag(P_16) S0 + sum_s (k_s . Q_s)^T v_s
// Every factor is a product of decays in (0, 1]: nothing is divided and no
// exponential of a cumulative sum is taken, so nothing overflows for any w
// (the usual chunked form divides by the cumulative decay, which overflows
// float32 within a chunk at RWKV-6's strongest decays); a product only
// underflows to 0 where its true value is below float32's range. All of it
// is float32 on the CUDA cores. A[., s] is built by multiplying one more
// decay per step of t, so a chunk's dependent chain is 16 short steps.
// What bounds it then is shared-memory traffic and instruction issue: every
// term of a chunk is a 64-channel sum spread over lanes and reduced by
// shuffles, with 8 warps an SM to hide latency. The design:
//   * one block of 256 threads per (b, h, 16 value columns): 128 blocks for
//     a prompt of 32 heads, each of a head's four blocks building the
//     head's A, P and Q itself;
//   * two roles, software-pipelined over the chunks with one barrier a
//     chunk: iteration i widens chunk i's decays, warps 0-3 build chunk
//     i - 1's A (each half-warp two rows of it, on time relative to its
//     first row so that no entry above the diagonal is computed) and, on
//     warps 2-3, P and Q, while warps 4-7 form chunk i - 2's outputs and
//     state, each lane holding 4 rows x 2 columns of the state in registers;
//   * a 4-stage ring of the raw r, k, w tiles (16 x 64) and the v slice
//     (16 x 16), each filled by one TMA load of a 4-D tensor map two
//     chunks ahead; r and k are read from the ring as stored;
//   * rows past T are read as zeros, and their decay is set to 1, so they
//     add nothing and decay nothing. Chunk boundaries fall at multiples of
//     16 from the start of each call.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::Elem;
namespace sm90 = repro::sm90;

constexpr int kN = 64;  // key dim (state rows) per head
constexpr int kV = 64;  // value dim (state columns) per head

// Element strides (b, h, t) of r, k, v, w and out; the last dim is contiguous.
struct Strides {
  long long s[5][3];
};
enum { kR = 0, kK = 1, kVal = 2, kW = 3, kOut = 4 };

// ------------------------------------------------------------ sequential
// The first K5 (the prior): one block per (head, 32 value columns); each
// column's 64 state rows split over 4 neighbouring lanes, in registers; a
// step is 2 x 16 FMAs per lane and a 2-step shuffle sum, over chunks of 64
// steps staged in shared memory.
namespace seq {
constexpr int kVS = 32;             // value columns per block
constexpr int kG = 4;               // lanes sharing one column
constexpr int kRows = kN / kG;      // state rows per lane
constexpr int kThreads = kVS * kG;  // 128
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;          // timesteps staged at once

constexpr size_t smem_floats() {
  return 3 * kChunk * kN      // r, k, decay
         + 2 * kChunk * kVS   // v slice, outputs
         + kChunk + kN;       // bonus sum per step, u
}

// Stage `nt` rows of W elements (row stride sT) as float32 into dst[t][W],
// decay-transformed if DECAY. Every thread of the block takes part.
template <typename E, int W, bool DECAY>
__device__ __forceinline__ void stage(float* dst, const typename E::T* __restrict__ src,
                                      long long sT, int nt) {
  constexpr int VEC = E::kVec;
  constexpr int VPR = W / VEC;
  static_assert(W % VEC == 0, "rows are whole 16-byte vectors");
  for (int i = threadIdx.x; i < nt * VPR; i += kThreads) {
    const int t = i / VPR;
    const int c = (i % VPR) * VEC;
    float vals[VEC];
    E::unpack(__ldg(reinterpret_cast<const uint4*>(src + t * sT + c)), vals);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      dst[t * W + c + e] = DECAY ? expf(-expf(vals[e])) : vals[e];
  }
}
}  // namespace seq

template <bool BF16, bool WF32>
__global__ void __launch_bounds__(seq::kThreads)
wkv6_sequential(const typename Elem<BF16>::T* __restrict__ r,
                const typename Elem<BF16>::T* __restrict__ k,
                const typename Elem<BF16>::T* __restrict__ v,
                const typename Elem<BF16 && !WF32>::T* __restrict__ w,
                const float* __restrict__ u, const float* s0, float* s_out,
                typename Elem<BF16>::T* __restrict__ out, Strides st, int H, int T,
                int u_rows) {
  using namespace seq;
  using E = Elem<BF16>;
  using EW = Elem<BF16 && !WF32>;
  extern __shared__ float smem[];
  float* r_s = smem;                   // [kChunk][kN]
  float* k_s = r_s + kChunk * kN;      // [kChunk][kN]
  float* d_s = k_s + kChunk * kN;      // [kChunk][kN] decay
  float* v_s = d_s + kChunk * kN;      // [kChunk][kVS]
  float* o_s = v_s + kChunk * kVS;     // [kChunk][kVS]
  float* b_s = o_s + kChunk * kVS;     // [kChunk] sum_n r u k
  float* u_s = b_s + kChunk;           // [kN]

  constexpr int kSlices = kV / kVS;
  const int bh = blockIdx.x / kSlices;
  const int v0 = (blockIdx.x % kSlices) * kVS;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane % kG;                    // this lane's state rows: kG * j + g
  const int col = warp * (32 / kG) + lane / kG;  // value column within the slice

  auto base = [&](int which) { return b * st.s[which][0] + h * st.s[which][1]; };
  const typename E::T* r_h = r + base(kR);
  const typename E::T* k_h = k + base(kK);
  const typename E::T* v_h = v + base(kVal) + v0;
  const typename EW::T* w_h = w + base(kW);
  typename E::T* o_h = out + base(kOut) + v0;

  if (tid < kN) u_s[tid] = u[(long long)(bh % u_rows) * kN + tid];
  const long long state_base = (long long)bh * kN * kV + v0 + col;
  float S[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    S[j] = s0 ? s0[state_base + (long long)(kG * j + g) * kV] : 0.f;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int nt = min(kChunk, T - t0);
    __syncthreads();  // the previous chunk's readers are done
    stage<E, kN, false>(r_s, r_h + t0 * st.s[kR][2], st.s[kR][2], nt);
    stage<E, kN, false>(k_s, k_h + t0 * st.s[kK][2], st.s[kK][2], nt);
    stage<EW, kN, true>(d_s, w_h + t0 * st.s[kW][2], st.s[kW][2], nt);
    stage<E, kVS, false>(v_s, v_h + t0 * st.s[kVal][2], st.s[kVal][2], nt);
    __syncthreads();
    for (int t = warp; t < nt; t += kWarps) {  // bonus term: one warp per step
      float p = r_s[t * kN + lane] * u_s[lane] * k_s[t * kN + lane] +
                r_s[t * kN + lane + 32] * u_s[lane + 32] * k_s[t * kN + lane + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) b_s[t] = p;
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float* rt = r_s + t * kN;
      const float* kt = k_s + t * kN;
      const float* dt = d_s + t * kN;
      const float vv = v_s[t * kVS + col];
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; j += 2) {
        const int n0 = kG * j + g;
        const int n1 = n0 + kG;
        acc0 = fmaf(rt[n0], S[j], acc0);
        acc1 = fmaf(rt[n1], S[j + 1], acc1);
        S[j] = fmaf(dt[n0], S[j], kt[n0] * vv);
        S[j + 1] = fmaf(dt[n1], S[j + 1], kt[n1] * vv);
      }
      float acc = acc0 + acc1;
#pragma unroll
      for (int off = 1; off < kG; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) o_s[t * kVS + col] = fmaf(vv, b_s[t], acc);
    }
    __syncthreads();
    for (int i = tid; i < nt * kVS; i += kThreads) {
      const int t = i / kVS;
      E::store(o_h, (long long)(t0 + t) * st.s[kOut][2] + i % kVS, o_s[i]);
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) s_out[state_base + (long long)(kG * j + g) * kV] = S[j];
}

// ------------------------------------------------------------ chunked
namespace chk {
constexpr int kC = 16;         // timesteps per chunk
constexpr int kVS = 16;        // value columns per block
constexpr int kThreads = 256;  // warps 0-3 build A (2-3 also P, Q); warps 4-7 outputs, state
constexpr int kRoleThreads = 128;  // threads of each role
constexpr int kStages = 4;     // ring of raw chunk tiles: chunk c's is read until iteration c + 1
constexpr int kAhead = kStages - 2;  // chunks loaded ahead of the one widened
static_assert(kC * kN == 4 * kThreads && kC * kVS == kThreads, "one widening pass");
static_assert(kRoleThreads / 32 * 4 == kC && kRoleThreads / 32 * 4 == kVS, "4 rows or columns a warp");
static_assert(kC * kC == kThreads, "one pass zeroes A^T");

// Bytes of one ring stage (raw r, k, w, v tiles as stored), and the layout
// of the float32 work tiles after the ring: the decays X twice, v three
// times, and the chunk terms H (r.P, k.Q, A^T, P_16) twice, so that one
// barrier a chunk separates every writer from its readers (see the loop).
template <bool BF16, bool WF32>
struct Layout {
  static constexpr int kRK = kC * kN * sizeof(typename Elem<BF16>::T);          // r or k
  static constexpr int kWB = kC * kN * sizeof(typename Elem<BF16 && !WF32>::T);  // w
  static constexpr int kVB = kC * kVS * sizeof(typename Elem<BF16>::T);         // v slice
  static constexpr int kStage = 2 * kRK + kWB + kVB;
  static constexpr int kX = kC * kN;                    // decay [kC][kN]
  static constexpr int kVf = kC * kVS;                  // v [kC][kVS]
  static constexpr int kH = 2 * kC * kN + kC * kC + kN;  // r.P, k.Q [kC][kN]; A^T [kC][kC]; P_16
  static constexpr int kWorkFloats = 2 * kX + 3 * kVf + 2 * kH + kN;  // + u
  static constexpr int kSmem = 128 + kStages * kStage + 4 * kWorkFloats;  // + alignment slack
  static_assert(kRK % 128 == 0 && kWB % 128 == 0 && kVB % 128 == 0, "128-byte aligned tiles");
};

// One halving step of reduce_scatter: v[0..2W) -> v[0..W), exchanged with
// the lane W / R away; the lane with that bit set keeps the upper half.
template <int W, int R, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool upper = lane & (W / R);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W / R);
  }
}
template <int W, int R, int N>
__device__ __forceinline__ void halve_down(float (&v)[N], int lane) {
  if constexpr (W >= R) {
    halve<W, R>(v, lane);
    halve_down<W / 2, R>(v, lane);
  }
}

// Sum v over aligned groups of LANES lanes: afterwards lane g of a group
// holds, in v[0..R), the group's sums of v[R g .. R g + R), R = N / LANES.
// Every index is a constant, so v stays in registers.
template <int LANES, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  halve_down<N / 2, N / LANES>(v, lane);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

// Four elements from shared memory (8- or 16-byte aligned), widened to float.
template <typename E>
__device__ __forceinline__ float4 lds4(const typename E::T* p) {
  if constexpr (sizeof(typename E::T) == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    return make_float4(E::widen(x.x & 0xffffu), __uint_as_float(x.x & 0xffff0000u),
                       E::widen(x.y & 0xffffu), __uint_as_float(x.y & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
}

// Rows s = s0 + m (m = 0, 1; s0 = 4 wa + 2 hh) of A^T on half-warp hh of warp
// wa (0-3), lane g over channels 4g .. 4g + 3: A[t][s] = sum_n r_tn k_sn
// prod_{s<j<t} d_jn for t > s and sum_n r_tn u_n k_tn at t = s. Time runs
// from the half-warp's first row, t = s0 + tau, so every comparison of t
// with s is one of tau with m, made at compile time. Entries t < s0 are
// never written: At starts zero.
template <typename E>
__device__ __forceinline__ void build_a(const typename E::T* rr, const typename E::T* kr,
                                        const float* df, const float* us, float* At, int wa,
                                        int lane) {
  const int g = lane % 16;
  const int s0 = 4 * wa + 2 * (lane / 16);
  const float4 u4 = ld4(us + 4 * g);
  float kd[2][4];  // kd[m]: k_s . prod_{s<j<t} d_j for s = s0 + m
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float4 k4 = lds4<E>(kr + (s0 + m) * kN + 4 * g);
    kd[m][0] = k4.x;
    kd[m][1] = k4.y;
    kd[m][2] = k4.z;
    kd[m][3] = k4.w;
  }
  float a[2 * kC] = {};  // a[2 tau + m]: this lane's share of A[s0 + tau][s0 + m]
#pragma unroll
  for (int tau = 0; tau < kC; ++tau) {
    if (s0 + tau >= kC) break;
    const float4 r4 = lds4<E>(rr + (s0 + tau) * kN + 4 * g);
    const float4 d4 = ld4(df + (s0 + tau) * kN + 4 * g);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (tau < m) continue;  // above the diagonal: 0
      if (tau == m) {
        a[2 * tau + m] = fmaf(r4.x * u4.x, kd[m][0], fmaf(r4.y * u4.y, kd[m][1],
                         fmaf(r4.z * u4.z, kd[m][2], r4.w * u4.w * kd[m][3])));
      } else {
        a[2 * tau + m] = fmaf(r4.x, kd[m][0], fmaf(r4.y, kd[m][1],
                         fmaf(r4.z, kd[m][2], r4.w * kd[m][3])));
        kd[m][0] *= d4.x;  // d_t joins for the rows after t
        kd[m][1] *= d4.y;
        kd[m][2] *= d4.z;
        kd[m][3] *= d4.w;
      }
    }
  }
  reduce_scatter<16>(a, lane);  // lane g: a[m] = A[s0 + g][s0 + m]
  if (s0 + g < kC) {
#pragma unroll
    for (int m = 0; m < 2; ++m) At[(s0 + m) * kC + s0 + g] = a[m];
  }
}

// P and Q chains of channel n: r.P forward and P_16, k.Q backward, every
// load first.
template <typename E>
__device__ __forceinline__ void build_pq(const typename E::T* rr, const typename E::T* kr,
                                         const float* df, float* rP, float* kQ, float* Pc,
                                         int n) {
  float rv[kC], kv[kC], dv[kC];
#pragma unroll
  for (int t = 0; t < kC; ++t) {
    rv[t] = E::load(rr, t * kN + n);
    kv[t] = E::load(kr, t * kN + n);
    dv[t] = df[t * kN + n];
  }
  float p = 1.f, q = 1.f;
#pragma unroll
  for (int t = 0; t < kC; ++t) {
    rP[t * kN + n] = rv[t] * p;
    p *= dv[t];
    kQ[(kC - 1 - t) * kN + n] = kv[kC - 1 - t] * q;
    q *= dv[kC - 1 - t];
  }
  Pc[n] = p;
}
}  // namespace chk

// r, k, w, v come through tensor maps over (64, T, H, B) (innermost first),
// box (64, 16, 1, 1), v's (16, 16, 1, 1) at this block's value columns.
template <bool BF16, bool WF32>
__global__ void __launch_bounds__(chk::kThreads)
wkv6_chunked(const __grid_constant__ CUtensorMap r_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap v_map,
             const float* __restrict__ u, const float* s0, float* s_out,
             typename Elem<BF16>::T* __restrict__ out, Strides st, int H, int T,
             int u_rows) {
  using namespace chk;
  using E = Elem<BF16>;
  using EW = Elem<BF16 && !WF32>;
  using L = Layout<BF16, WF32>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring0 = smem_raw + (128 - sm90::smem_addr(smem_raw) % 128) % 128;  // TMA: 128-B
  float* work = reinterpret_cast<float*>(ring0 + kStages * L::kStage);
  auto X = [&](int c) { return work + (c % 2) * L::kX; };                     // df
  auto Vf = [&](int c) { return work + 2 * L::kX + (c % 3) * L::kVf; };       // v
  auto Hc = [&](int c) { return work + 2 * L::kX + 3 * L::kVf + (c % 2) * L::kH; };  // rP, kQ, At, Pc
  float* us = work + 2 * L::kX + 3 * L::kVf + 2 * L::kH;

  constexpr int kSlices = kV / kVS;
  const int bh = blockIdx.x / kSlices;
  const int v0 = (blockIdx.x % kSlices) * kVS;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const bool head_role = warp < 4;  // warps 0-3: A, P, Q; warps 4-7: outputs, state
  // Output and state role: warp wo holds value columns 4 wo .. 4 wo + 3, lane
  // (hh, g) the pair of columns 4 wo + 2 hh + jj and state rows 4g .. 4g + 3.
  const int wo = warp - 4;
  const int g = lane % 16;
  const int col = 4 * wo + 2 * (lane / 16);

  typename E::T* o_h = out + b * st.s[kOut][0] + h * st.s[kOut][1] + v0;

  __shared__ uint64_t full[kStages];  // a ring stage's four tiles have landed
  auto ring = [&](int c) { return ring0 + (c % kStages) * L::kStage; };
  // Chunk c's tiles into its ring stage: four TMA loads from one thread;
  // rows at or past T read zeros.
  auto load_chunk = [&](int c) {
    if (tid != kRoleThreads) return;
    uint64_t* bar = &full[c % kStages];
    unsigned char* p = ring(c);
    sm90::mbar_arrive_expect_tx(bar, L::kStage);
    sm90::tma_load_4d(p, &r_map, bar, 0, c * kC, h, b);
    sm90::tma_load_4d(p + L::kRK, &k_map, bar, 0, c * kC, h, b);
    sm90::tma_load_4d(p + 2 * L::kRK, &w_map, bar, 0, c * kC, h, b);
    sm90::tma_load_4d(p + 2 * L::kRK + L::kWB, &v_map, bar, v0, c * kC, h, b);
  };

  const int n_chunks = (T + kC - 1) / kC;
  if (tid < kStages) sm90::mbar_init(&full[tid], 1);
  sm90::mbar_fence_init();
  __syncthreads();
  for (int c = 0; c < kAhead && c < n_chunks; ++c) load_chunk(c);
  if (tid < kN) us[tid] = u[(long long)(bh % u_rows) * kN + tid];
  for (int c = 0; c < 2; ++c) Hc(c)[2 * kC * kN + tid] = 0.f;  // A^T: entries never written
  // S[i][jj]: state row 4g + i of value column col + jj (output role only)
  const long long state_base = (long long)bh * kN * kV + (long long)(4 * g) * kV + v0 + col;
  float S[4][2] = {};
  if (!head_role && s0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) S[i][jj] = s0[state_base + i * kV + jj];
  }

  // Iteration it widens chunk it, builds the terms of chunk it - 1 and
  // forms the outputs and state of chunk it - 2, all between one barrier
  // and the next: each reads only what an earlier iteration wrote.
  for (int it = 0; it < n_chunks + 2; ++it) {
    __syncthreads();  // iteration it - 1 is done everywhere
    if (it + kAhead < n_chunks) load_chunk(it + kAhead);  // into chunk it - 2's stage

    if (it < n_chunks) {  // chunk it's decays (4 a thread; 1 past T) and v (1 a thread)
      sm90::mbar_wait(&full[it % kStages], (it / kStages) & 1);
      const unsigned char* p = ring(it);
      float* x = X(it);
      const int e = 4 * tid;  // row e / kN
      const float4 w4 = lds4<EW>(reinterpret_cast<const typename EW::T*>(p + 2 * L::kRK) + e);
      const float v1 =
          E::load(reinterpret_cast<const typename E::T*>(p + 2 * L::kRK + L::kWB), tid);
      const bool live = it * kC + e / kN < T;
      const float4 d4 = make_float4(live ? expf(-expf(w4.x)) : 1.f, live ? expf(-expf(w4.y)) : 1.f,
                                    live ? expf(-expf(w4.z)) : 1.f, live ? expf(-expf(w4.w)) : 1.f);
      st4(x + e, d4);
      Vf(it)[tid] = v1;
    }

    const int ch = it - 1;  // chunk whose terms are built now
    if (ch >= 0 && ch < n_chunks) {
      const float* x = X(ch);  // decay; r and k from chunk ch's ring stage
      const auto* rr = reinterpret_cast<const typename E::T*>(ring(ch));
      const auto* kr = reinterpret_cast<const typename E::T*>(ring(ch) + L::kRK);
      float* hc = Hc(ch);
      if (head_role) {  // warps 2-3, whose rows of A are fewer, also run P and Q
        build_a<E>(rr, kr, x, us, hc + 2 * kC * kN, warp, lane);
        if (tid >= kRoleThreads - kN)
          build_pq<E>(rr, kr, x, hc, hc + kC * kN, hc + 2 * kC * kN + kC * kC,
                      tid - (kRoleThreads - kN));
      }
    }

    const int co = it - 2;  // chunk whose outputs and state are formed now
    if (co >= 0 && !head_role) {
      // o_t = (r_t . P_t) S0 + sum_s A[t,s] v_s; S = diag(P_16) S0 + sum_s (k_s . Q_s)^T v_s
      const float* hc = Hc(co);
      const float* rP = hc;
      const float* kQ = hc + kC * kN;
      const float* At = hc + 2 * kC * kN;
      const float* Pc = At + kC * kC;
      const float* vf = Vf(co);
      float part[2 * kC];  // part[2t + jj]: row t, column col + jj, over this lane's rows
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float4 p4 = ld4(rP + t * kN + 4 * g);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          part[2 * t + jj] = fmaf(p4.x, S[0][jj], fmaf(p4.y, S[1][jj],
                             fmaf(p4.z, S[2][jj], p4.w * S[3][jj])));
      }
      const float4 pc = ld4(Pc + 4 * g);
      const float pcs[4] = {pc.x, pc.y, pc.z, pc.w};
      float o[2] = {0.f, 0.f};  // row t = g
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) S[i][jj] *= pcs[i];
#pragma unroll
      for (int s = 0; s < kC; ++s) {
        const float4 q4 = ld4(kQ + s * kN + 4 * g);
        const float2 v2 = ld2(vf + s * kVS + col);
        const float at = At[s * kC + g];
        const float qs[4] = {q4.x, q4.y, q4.z, q4.w};
        const float vs[2] = {v2.x, v2.y};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          o[jj] = fmaf(at, vs[jj], o[jj]);
#pragma unroll
          for (int i = 0; i < 4; ++i) S[i][jj] = fmaf(qs[i], vs[jj], S[i][jj]);
        }
      }
      reduce_scatter<16>(part, lane);  // lane g: part[0..1] = row g, columns col, col + 1
      if (co * kC + g < T) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          E::store(o_h, (long long)(co * kC + g) * st.s[kOut][2] + col + jj, o[jj] + part[jj]);
      }
    }
  }
  if (!head_role) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) s_out[state_base + i * kV + jj] = S[i][jj];
  }
}

enum Variant { kSequential = 0, kChunked = 1 };

// A tensor map over one (B, H, T, X) input given by its element strides
// (b, h, t), read as (X, T, H, B) innermost first, box (box0, kC, 1, 1). A
// dimension of size 1 gets a packed stride (its own is never used).
template <typename TT>
int rows_map(CUtensorMap* map, const void* base, int B, int H, int T, const long long* s,
             int box0) {
  sm90::EncodeTiledFn encode = sm90::encode_tiled_fn();
  if (encode == nullptr) return -1;
  const uint64_t es = sizeof(TT);
  const uint64_t st = s[2] * es;
  const uint64_t sh = H > 1 ? s[1] * es : st * T;
  const uint64_t sb = B > 1 ? s[0] * es : sh * H;
  cuuint64_t dims[4] = {64, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t strides[3] = {st, sh, sb};
  cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)chk::kC, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = encode(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                      4, const_cast<void*>(base), dims, strides, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1;
}

template <bool BF16, bool WF32>
int launch(int variant, const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, float* s_out, void* out, int B, int H, int T,
           int u_rows, const Strides& st, cudaStream_t stream) {
  using T_ = typename Elem<BF16>::T;
  using TW = typename Elem<BF16 && !WF32>::T;
  T_* o = static_cast<T_*>(out);
  cudaError_t err;
  if (variant == kSequential) {
    auto kernel = wkv6_sequential<BF16, WF32>;
    const int smem = (int)(seq::smem_floats() * sizeof(float));
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B * H * (kV / seq::kVS), seq::kThreads, smem, stream>>>(
        static_cast<const T_*>(r), static_cast<const T_*>(k), static_cast<const T_*>(v),
        static_cast<const TW*>(w), u, s0, s_out, o, st, H, T, u_rows);
    return (int)cudaGetLastError();
  }
  CUtensorMap r_map, k_map, w_map, v_map;
  if (rows_map<T_>(&r_map, r, B, H, T, st.s[kR], kN) != 0 ||
      rows_map<T_>(&k_map, k, B, H, T, st.s[kK], kN) != 0 ||
      rows_map<TW>(&w_map, w, B, H, T, st.s[kW], kN) != 0 ||
      rows_map<T_>(&v_map, v, B, H, T, st.s[kVal], chk::kVS) != 0)
    return REPRO_BAD_ARGUMENT;
  auto kernel = wkv6_chunked<BF16, WF32>;
  const int smem = chk::Layout<BF16, WF32>::kSmem;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H * (kV / chk::kVS), chk::kThreads, smem, stream>>>(
      r_map, k_map, w_map, v_map, u, s0, s_out, o, st, H, T, u_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, w (B, H, T, N) and v, out (B, H, T, V), each given by its element
// strides (b, h, t) in `strides` (5 x 3, in the order r, k, v, w, out) with
// a contiguous last dim; the four inputs 16-byte aligned with strides that
// are whole 16-byte vectors. u (u_rows, N) float32, row bh % u_rows for
// head bh = b * H + h. s0 (B*H, N, V) float32 or null (zero state); s_out
// (B*H, N, V) float32, the state after step T (may be s0). dtype: 0 float32,
// 1 bfloat16 (r, k, v, out); w_f32: w is float32 (else r's dtype). variant:
// 0 sequential, 1 chunked. N = V = 64. Returns 0, a cudaError_t, or
// REPRO_BAD_ARGUMENT (also where the chunked kernel's tensor maps cannot be
// made).
int repro_wkv6_scan(const void* r, const void* k, const void* v, const void* w,
                    const float* u, const float* s0, float* s_out, void* out,
                    int B, int H, int T, int N, int V, int u_rows,
                    const long long* strides, int dtype, int w_f32, int variant,
                    void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || N != kN || V != kV || u_rows <= 0 ||
      (B * H) % u_rows != 0 || !strides || (variant != kSequential && variant != kChunked))
    return REPRO_BAD_ARGUMENT;
  Strides st;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) st.s[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && w_f32 == 1)
    return launch<false, false>(variant, r, k, v, w, u, s0, s_out, out, B, H, T, u_rows, st, s);
  if (dtype == 1 && w_f32 == 0)
    return launch<true, false>(variant, r, k, v, w, u, s0, s_out, out, B, H, T, u_rows, st, s);
  if (dtype == 1 && w_f32 == 1)
    return launch<true, true>(variant, r, k, v, w, u, s0, s_out, out, B, H, T, u_rows, st, s);
  return REPRO_BAD_ARGUMENT;
}

// Dynamic shared memory of the chunked kernel (bytes), for the build report.
int repro_wkv6_scan_smem(int dtype, int w_f32) {
  if (dtype == 0) return chk::Layout<false, false>::kSmem;
  return w_f32 ? chk::Layout<true, true>::kSmem : chk::Layout<true, false>::kSmem;
}

const char* repro_wkv6_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
