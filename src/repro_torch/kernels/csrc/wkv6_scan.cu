// RWKV-6 WKV recurrence over a whole sequence (K5).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6_scan.py::wkv6_scan
// (pallas_call at :84, body _wkv6_kernel at :30). Per head, with an f32
// (N, V) state S and data-dependent decay w_t:
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(exp(-exp(w_t))) S_{t-1} + k_t^T v_t
// Unlike the TPU kernel, it starts from a given state (zero if none) and
// writes the state after step T, so a serving prefill, a chunked prefill's
// continuation and the state a decode step needs all come from one pass.
// It stops at T exactly: a padded step would decay the state it returns.
//
// What bounds it on an H100: neither bytes nor operations, but the time
// loop. The T steps of one head are sequential and each does ~5 N V flops
// (a 64 x 64 state), so a prompt is a long chain of small steps. The design
// keeps that chain short and entirely on chip:
//   * one block per (head, slice of kVS value columns): a prompt of 32
//     heads gives 64 blocks;
//   * each column's 64 state rows are split over kG neighbouring lanes
//     (rows n = kG * j + g for lane g), held in registers for the whole
//     sequence; a step is 2 * 16 FMAs per lane and a 2-step shuffle sum;
//   * the sum over n of r u k (the bonus term, the same for every column)
//     and decay = exp(-exp(w)) are computed once per timestep per block
//     while a chunk of kChunk timesteps is staged in shared memory (16-byte
//     vector loads, f32); outputs are staged and written per chunk.
// Inputs may be strided views (a (B, T, H, N) projection read as (B, H, T,
// N)), so no transposed copies are made. The chunked tensor-core form
// (intra-chunk products on wgmma) and overlapping a chunk's loads with the
// previous chunk's steps are later work.
#include "common.cuh"

namespace {

using repro::Elem;

constexpr int kN = 64;              // key dim (state rows) per head
constexpr int kV = 64;              // value dim (state columns) per head
constexpr int kVS = 32;             // value columns per block
constexpr int kG = 4;               // lanes sharing one column
constexpr int kRows = kN / kG;      // state rows per lane
constexpr int kThreads = kVS * kG;  // 128
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;          // timesteps staged at once

// Element strides (b, h, t) of r, k, v, w and out; the last dim is contiguous.
struct Strides {
  long long s[5][3];
};
enum { kR = 0, kK = 1, kVal = 2, kW = 3, kOut = 4 };

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

template <bool BF16, bool WF32>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const typename Elem<BF16>::T* __restrict__ r,
            const typename Elem<BF16>::T* __restrict__ k,
            const typename Elem<BF16>::T* __restrict__ v,
            const typename Elem<BF16 && !WF32>::T* __restrict__ w,
            const float* __restrict__ u, const float* s0, float* s_out,
            typename Elem<BF16>::T* __restrict__ out, Strides st, int H, int T,
            int u_rows) {
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

template <bool BF16, bool WF32>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           const float* s0, float* s_out, void* out, int B, int H, int T, int u_rows,
           const Strides& st, cudaStream_t stream) {
  using T_ = typename Elem<BF16>::T;
  using TW = typename Elem<BF16 && !WF32>::T;
  constexpr size_t smem = smem_floats() * sizeof(float);
  auto kernel = wkv6_kernel<BF16, WF32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H * (kV / kVS), kThreads, smem, stream>>>(
      static_cast<const T_*>(r), static_cast<const T_*>(k), static_cast<const T_*>(v),
      static_cast<const TW*>(w), u, s0, s_out, static_cast<T_*>(out), st, H, T, u_rows);
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
// 1 bfloat16 (r, k, v, out); w_f32: w is float32 (else r's dtype).
// N = V = 64. Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_wkv6_scan(const void* r, const void* k, const void* v, const void* w,
                    const float* u, const float* s0, float* s_out, void* out,
                    int B, int H, int T, int N, int V, int u_rows,
                    const long long* strides, int dtype, int w_f32, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || N != kN || V != kV || u_rows <= 0 ||
      (B * H) % u_rows != 0 || !strides)
    return REPRO_BAD_ARGUMENT;
  Strides st;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) st.s[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && w_f32 == 1)
    return launch<false, false>(r, k, v, w, u, s0, s_out, out, B, H, T, u_rows, st, s);
  if (dtype == 1 && w_f32 == 0)
    return launch<true, false>(r, k, v, w, u, s0, s_out, out, B, H, T, u_rows, st, s);
  if (dtype == 1 && w_f32 == 1)
    return launch<true, true>(r, k, v, w, u, s0, s_out, out, B, H, T, u_rows, st, s);
  return REPRO_BAD_ARGUMENT;
}

const char* repro_wkv6_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
