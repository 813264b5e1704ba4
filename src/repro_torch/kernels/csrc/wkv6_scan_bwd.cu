// Gradient of the RWKV-6 WKV recurrence (K5 backward).
//
// The training counterpart of src/repro/kernels/wkv6_scan.py::wkv6_scan
// (pallas_call at :84): the JAX package differentiates that scan from a
// zero state under jax.value_and_grad; here the gradient is a kernel of its
// own, launched from the backward of ops.wkv6_scan's autograd route. Per
// head, with d_t = exp(-exp(w_t)), S_t the (N, V) state after step t (S_0
// before the first step is zero), G_t = dL/dS_t (zero after the last step:
// training keeps no state) and G_{t-1} = diag(d_t) G_t + r_t^T do_t:
//   dr_t[i] = sum_j (S_{t-1}[i,j] + u_i k_t[i] v_t[j]) do_t[j]
//   dk_t[i] = sum_j G_t[i,j] v_t[j] + u_i r_t[i] (v_t . do_t)
//   dv_t[j] = sum_i G_t[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) do_t[j]
//   dw_t[i] = -exp(w_t[i]) d_t[i] sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   = sum_t r_t[i] k_t[i] (v_t . do_t)
//
// The reverse pass needs S_{t-1}, which cannot be had by dividing S_t by
// d_t: d_t underflows to 0 under strong decay (w >~ 4.5). So the kernel
// first runs the recurrence forward from zero and stores a float32
// checkpoint of the state at every chunk boundary (CH = 16 steps), then
// walks the chunks backwards: it recomputes a chunk's 16 states from its
// checkpoint into shared memory, runs the chunk's 16 steps of G backwards
// (G stays in registers from chunk to chunk) into shared memory beside
// them, and then forms every output of the chunk from the two, all in
// parallel. All arithmetic is float32 on the CUDA cores.
//
// Heads are N = V = 64 (smaller heads come zero-padded by the wrapper).
// One block of 256 threads per (b*h, 16 value columns): a chunk's states
// and their gradients for one 16-column slice are 2 x 16 x 64 x 16 floats
// (rows padded to 17 against bank conflicts: 139 KB of dynamic shared
// memory), and 4 blocks a head. dv and du's row sums stay inside a block;
// dr, dk and dw sum over all V columns, so each block writes its slice's
// float32 partial and a second kernel sums the 4 partials in slice order
// (no atomics: the same bits every run), casting to the inputs' dtypes,
// and sums du over the batch rows that share u's row.
//
// What bounds it on an H100: the chain of dependent steps and shared-memory
// traffic, not bytes or operations (~14 N V flops a step per head, counted
// from the formulas in chip_smoke.py). Steps past T read as r = k = v = do
// = 0 and d = 1: they add nothing and decay nothing.
#include "common.cuh"

namespace {

using repro::Elem;

constexpr int kN = 64;                 // key dim (state rows)
constexpr int kV = 64;                 // value dim (state columns)
constexpr int kVS = 16;                // value columns per block
constexpr int kSlices = kV / kVS;      // 4
constexpr int kCH = 16;                // steps per chunk
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kN * kVS / kThreads;  // 4 state elements a thread
constexpr int kPitch = kVS + 1;        // a state row in shared memory, padded

struct Smem {
  static constexpr int kState = kCH * kN * kPitch;   // one chunk of states (or gradients)
  static constexpr int kFloats = 2 * kState          // S_{t-1}, G_t
                                 + 4 * kCH * kN      // r, k, d, exp(w)
                                 + 2 * kCH * kVS     // v, do slices
                                 + 2 * kCH           // v.do (slice), sum_i r u k
                                 + kN;               // u
  static constexpr int kBytes = kFloats * 4;
};

// Stage chunk rows [t0, t0 + kCH) of one head: r, k, d = exp(-exp(w)), e =
// exp(w) (N wide) and the slice's v, do columns; rows past T as zeros (d = 1).
template <bool BF16, bool WBF16>
__device__ __forceinline__ void stage(float* r_s, float* k_s, float* d_s, float* e_s, float* v_s,
                                      float* do_s, const typename Elem<BF16>::T* r,
                                      const typename Elem<BF16>::T* k,
                                      const typename Elem<BF16>::T* v,
                                      const typename Elem<WBF16>::T* w,
                                      const typename Elem<BF16>::T* dout, long base_n,
                                      long base_v, int t0, int T, int c0) {
  using E = Elem<BF16>;
  using EW = Elem<WBF16>;
  for (int e = threadIdx.x; e < kCH * kN; e += kThreads) {
    const int t = t0 + e / kN;
    const long at = base_n + (long)t * kN + e % kN;
    const bool live = t < T;
    r_s[e] = live ? E::load(r, at) : 0.f;
    k_s[e] = live ? E::load(k, at) : 0.f;
    const float ew = live ? expf(EW::load(w, at)) : 0.f;
    e_s[e] = ew;
    d_s[e] = expf(-ew);
  }
  for (int e = threadIdx.x; e < kCH * kVS; e += kThreads) {
    const int t = t0 + e / kVS;
    const long at = base_v + (long)t * kV + c0 + e % kVS;
    const bool live = t < T;
    v_s[e] = live ? E::load(v, at) : 0.f;
    do_s[e] = live ? E::load(dout, at) : 0.f;
  }
}

template <bool BF16, bool WBF16>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_chunked(const typename Elem<BF16>::T* __restrict__ r,
                 const typename Elem<BF16>::T* __restrict__ k,
                 const typename Elem<BF16>::T* __restrict__ v,
                 const typename Elem<WBF16>::T* __restrict__ w,
                 const float* __restrict__ u, const typename Elem<BF16>::T* __restrict__ dout,
                 typename Elem<BF16>::T* __restrict__ dv, float* __restrict__ ckpt,
                 float* __restrict__ part, float* __restrict__ du_part, int BH, int T,
                 int u_rows) {
  using E = Elem<BF16>;
  extern __shared__ float smem[];
  float* S_s = smem;                        // [kCH][kN][kPitch]  S_{t-1}
  float* G_s = S_s + Smem::kState;          // [kCH][kN][kPitch]  G_t
  float* r_s = G_s + Smem::kState;          // [kCH][kN]
  float* k_s = r_s + kCH * kN;
  float* d_s = k_s + kCH * kN;
  float* e_s = d_s + kCH * kN;
  float* v_s = e_s + kCH * kN;              // [kCH][kVS]
  float* do_s = v_s + kCH * kVS;
  float* vdo_s = do_s + kCH * kVS;          // [kCH]
  float* ruk_s = vdo_s + kCH;               // [kCH]
  float* u_s = ruk_s + kCH;                 // [kN]

  const int tid = threadIdx.x;
  const int slice = blockIdx.x;
  const int bh = blockIdx.y;
  const int c0 = slice * kVS;
  const int jj = tid % kVS;                 // this thread's column in the slice
  const int i0 = tid / kVS;                 // and rows i0 + 16 m
  const long base_n = (long)bh * T * kN;
  const long base_v = (long)bh * T * kV;
  const int n_chunks = (T + kCH - 1) / kCH;
  float* my_ckpt = ckpt + (long)bh * n_chunks * kN * kV;
  if (tid < kN) u_s[tid] = u[(long)(bh % u_rows) * kN + tid];

  // forward from zero: the state entering each chunk
  float st[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) st[m] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m)
      my_ckpt[((long)c * kN + i0 + 16 * m) * kV + c0 + jj] = st[m];
    stage<BF16, WBF16>(r_s, k_s, d_s, e_s, v_s, do_s, r, k, v, w, dout, base_n, base_v,
                       c * kCH, T, c0);
    __syncthreads();
    for (int t = 0; t < kCH; ++t) {
      const float vt = v_s[t * kVS + jj];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int i = i0 + 16 * m;
        st[m] = fmaf(d_s[t * kN + i], st[m], k_s[t * kN + i] * vt);
      }
    }
    __syncthreads();
  }

  // backward over the chunks
  float g[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) g[m] = 0.f;
  float du_acc = 0.f;  // thread tid < kN: row tid's sum over this slice's columns
  const int n_live_last = T - (n_chunks - 1) * kCH;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kCH;
    stage<BF16, WBF16>(r_s, k_s, d_s, e_s, v_s, do_s, r, k, v, w, dout, base_n, base_v, t0,
                       T, c0);
    __syncthreads();
    if (tid < kCH) {  // v.do over the slice's columns
      float a = 0.f;
      for (int j = 0; j < kVS; ++j) a = fmaf(v_s[tid * kVS + j], do_s[tid * kVS + j], a);
      vdo_s[tid] = a;
    } else if (tid < 2 * kCH) {  // sum_i r u k over every row
      const int t = tid - kCH;
      float a = 0.f;
      for (int i = 0; i < kN; ++i) a = fmaf(r_s[t * kN + i] * u_s[i], k_s[t * kN + i], a);
      ruk_s[t] = a;
    }
    // this chunk's states S_{t-1}, recomputed from its checkpoint
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m)
      st[m] = my_ckpt[((long)c * kN + i0 + 16 * m) * kV + c0 + jj];
    for (int t = 0; t < kCH; ++t) {
      const float vt = v_s[t * kVS + jj];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int i = i0 + 16 * m;
        S_s[(t * kN + i) * kPitch + jj] = st[m];
        st[m] = fmaf(d_s[t * kN + i], st[m], k_s[t * kN + i] * vt);
      }
    }
    // G_t for each step, walking the chunk backwards
    for (int t = kCH - 1; t >= 0; --t) {
      const float dot = do_s[t * kVS + jj];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int i = i0 + 16 * m;
        G_s[(t * kN + i) * kPitch + jj] = g[m];
        g[m] = fmaf(d_s[t * kN + i], g[m], r_s[t * kN + i] * dot);
      }
    }
    __syncthreads();
    const int n_live = c == n_chunks - 1 ? n_live_last : kCH;
    {  // dv: one (t, column) a thread
      const int t = tid / kVS;
      const int j = tid % kVS;
      float a = 0.f;
      for (int i = 0; i < kN; ++i) a = fmaf(G_s[(t * kN + i) * kPitch + j], k_s[t * kN + i], a);
      a = fmaf(ruk_s[t], do_s[t * kVS + j], a);
      if (t < n_live) E::store(dv, base_v + (long)(t0 + t) * kV + c0 + j, a);
    }
    // dr, dk, dw partials over the slice: four (t, row) a thread
#pragma unroll
    for (int q = 0; q < kCH * kN / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int t = e / kN;
      const int i = e % kN;
      const float* Srow = S_s + (t * kN + i) * kPitch;
      const float* Grow = G_s + (t * kN + i) * kPitch;
      float sdo = 0.f, gv = 0.f, gs = 0.f;
#pragma unroll
      for (int j = 0; j < kVS; ++j) {
        sdo = fmaf(Srow[j], do_s[t * kVS + j], sdo);
        gv = fmaf(Grow[j], v_s[t * kVS + j], gv);
        gs = fmaf(Grow[j], Srow[j], gs);
      }
      const float ui = u_s[i];
      const float vdo = vdo_s[t];
      if (t < n_live) {
        const long at = ((long)slice * BH + bh) * T * kN + (long)(t0 + t) * kN + i;
        const long plane = (long)kSlices * BH * T * kN;
        part[at] = fmaf(ui * k_s[t * kN + i], vdo, sdo);                 // dr
        part[plane + at] = fmaf(ui * r_s[t * kN + i], vdo, gv);          // dk
        part[2 * plane + at] = -e_s[t * kN + i] * d_s[t * kN + i] * gs;  // dw
      }
    }
    if (tid < kN) {
      for (int t = 0; t < n_live; ++t)
        du_acc = fmaf(r_s[t * kN + tid] * k_s[t * kN + tid], vdo_s[t], du_acc);
    }
    __syncthreads();
  }
  if (tid < kN) du_part[((long)bh * kSlices + slice) * kN + tid] = du_acc;
}

// dr, dk, dw: the sum of the slices' partials, in slice order, cast to the
// inputs' dtypes; du: summed over the slices and the batch rows sharing u's row.
template <bool BF16, bool WBF16>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_reduce(const float* __restrict__ part, const float* __restrict__ du_part,
                typename Elem<BF16>::T* __restrict__ dr, typename Elem<BF16>::T* __restrict__ dk,
                typename Elem<WBF16>::T* __restrict__ dw, float* __restrict__ du, long n,
                int BH, int u_rows) {
  const long e = (long)blockIdx.x * kThreads + threadIdx.x;
  if (e < n) {
    float s[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const float* p = part + (long)x * kSlices * n + e;
      float a = p[0];
#pragma unroll
      for (int sl = 1; sl < kSlices; ++sl) a += p[(long)sl * n];
      s[x] = a;
    }
    Elem<BF16>::store(dr, e, s[0]);
    Elem<BF16>::store(dk, e, s[1]);
    Elem<WBF16>::store(dw, e, s[2]);
  }
  if (e < (long)u_rows * kN) {
    const int row = (int)(e / kN);
    const int i = (int)(e % kN);
    float a = 0.f;
    for (int bh = row; bh < BH; bh += u_rows)
      for (int sl = 0; sl < kSlices; ++sl) a += du_part[((long)bh * kSlices + sl) * kN + i];
    du[e] = a;
  }
}

template <bool BF16, bool WBF16>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           const void* dout, void* dr, void* dk, void* dv, void* dw, float* du, float* ckpt,
           float* part, float* du_part, int BH, int T, int u_rows, cudaStream_t st) {
  using T_ = typename Elem<BF16>::T;
  using TW = typename Elem<WBF16>::T;
  auto kernel = wkv6_bwd_chunked<BF16, WBF16>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Smem::kBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(kSlices, BH), kThreads, Smem::kBytes, st>>>(
      static_cast<const T_*>(r), static_cast<const T_*>(k), static_cast<const T_*>(v),
      static_cast<const TW*>(w), u, static_cast<const T_*>(dout), static_cast<T_*>(dv), ckpt,
      part, du_part, BH, T, u_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long n = (long)BH * T * kN;
  const long work = n > (long)u_rows * kN ? n : (long)u_rows * kN;
  wkv6_bwd_reduce<BF16, WBF16><<<(unsigned)((work + kThreads - 1) / kThreads), kThreads, 0,
                                  st>>>(part, du_part, static_cast<T_*>(dr),
                                        static_cast<T_*>(dk), static_cast<TW*>(dw), du, n, BH,
                                        u_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, w, dr, dk, dw (BH, T, 64); v, do, dv (BH, T, 64); u, du (u_rows,
// 64) float32, row bh of the heads taking u's row bh % u_rows; scratch:
// ckpt (BH, ceil(T/16), 64, 64), part (3, 4, BH, T, 64) and du_part (BH,
// 4, 64), float32. All contiguous, on the current device. dtype: 0
// float32, 1 bfloat16 (r, k, v, do and their gradients); w_f32: w and dw
// are float32 (else of dtype). Returns 0, a cudaError_t, or
// REPRO_BAD_ARGUMENT.
int repro_wkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* dout, void* dr, void* dk, void* dv, void* dw,
                        void* du, void* ckpt, void* part, void* du_part, int BH, int T,
                        int u_rows, int dtype, int w_f32, void* stream) {
  if (BH <= 0 || BH > 65535 || T <= 0 || u_rows <= 0 || BH % u_rows != 0)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* u_ = static_cast<const float*>(u);
  float* du_ = static_cast<float*>(du);
  float* ck = static_cast<float*>(ckpt);
  float* pa = static_cast<float*>(part);
  float* dp = static_cast<float*>(du_part);
  if (dtype == 0 && w_f32)
    return launch<false, false>(r, k, v, w, u_, dout, dr, dk, dv, dw, du_, ck, pa, dp, BH, T,
                                u_rows, st);
  if (dtype == 1 && !w_f32)
    return launch<true, true>(r, k, v, w, u_, dout, dr, dk, dv, dw, du_, ck, pa, dp, BH, T,
                              u_rows, st);
  if (dtype == 1 && w_f32)
    return launch<true, false>(r, k, v, w, u_, dout, dr, dk, dv, dw, du_, ck, pa, dp, BH, T,
                               u_rows, st);
  return REPRO_BAD_ARGUMENT;
}

// Dynamic shared memory of the chunked backward kernel, in bytes.
int repro_wkv6_scan_bwd_smem() { return Smem::kBytes; }

const char* repro_wkv6_scan_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
