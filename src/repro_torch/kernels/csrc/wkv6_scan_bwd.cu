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
// d_t: d_t underflows to 0 under strong decay (w >~ 4.5). So it starts from
// float32 states at every chunk boundary (CH = 16 steps), recomputes a
// chunk's 16 states from its boundary state, and walks the chunk's steps
// of G backwards (G carried from chunk to chunk). All arithmetic is float32
// on the CUDA cores; nothing divides by a decay. Heads are N = V = 64
// (smaller heads come zero-padded by the wrapper); a head's 64 value
// columns are four 16-column slices, one block each. dv and the row sums
// stay inside a block; dr, dk, dw and du sum over all V columns, i.e. over
// the four slices. Steps past T read as r = k = v = do = 0: they add
// nothing to G or to any output, and their own outputs are not written.
//
// What bounds it on an H100: the chain of dependent steps and instruction
// issue, not bytes or operations (~14 N V flops a step per head, counted
// from the formulas in chip_smoke.py). Two variants, picked by the wrapper:
//
// * cluster: the forward (wkv6_scan.cu's chunked kernel) saved the state
//   entering each chunk, so no forward re-run. The four slice blocks of a
//   head form a thread-block cluster (rank = slice). Thread (i, c) of 256
//   holds state row i, columns 4c .. 4c + 3 of its slice: a chunk's 16
//   states S_{t-1} of those 4 elements stay in its registers (recomputed
//   from the saved state, 4 FMAs a step), and so does G. A chunk's row
//   terms d, -exp(w) d, r and k are widened into shared memory once (not
//   by each of a row's 4 lanes, twice). Walking the chunk backwards, each
//   step's dr, dk, dw partials over the thread's 4 columns are summed over
//   the row's 4 lanes (a 3-shuffle reduce-scatter: lanes 0-2 each end with
//   one of the three) and dv's over the warp's 8 rows (4 shuffles), then
//   over the 8 warps in shared memory. Rank q then sums a quarter of the
//   chunk's 3 x 16 x 64 dr, dk, dw partials of all four slices in rank
//   (slice) order through distributed shared memory and stores them. The
//   partials are double buffered, so one cluster barrier a chunk suffices,
//   and its arrive and wait are split around the dv stores. du's slice
//   partials are summed the same way at the end. r, k, w and the slice's
//   v, do of each chunk come by TMA into a 3-stage ring, two chunks ahead,
//   the next chunk's saved state by a register prefetch. ~70 KB of shared
//   memory (bf16) and at most 128 registers a thread, so two blocks fit an
//   SM. A second kernel sums du over the heads that share u's row.
// * chunked (the first version, kept as the prior): the block first runs the
//   recurrence forward from zero to write its own float32 checkpoint of the
//   state at every chunk boundary, then walks the chunks backwards: it
//   recomputes a chunk's 16 states from its checkpoint into shared memory,
//   runs the chunk's 16 steps of G backwards into shared memory beside them,
//   and then forms every output of the chunk from the two, all in parallel.
//   One block of 256 threads per (b*h, 16 value columns): a chunk's states
//   and their gradients for one slice are 2 x 16 x 64 x 16 floats (rows
//   padded to 17 against bank conflicts: 139 KB of dynamic shared memory).
//   dr, dk and dw go out as each slice's float32 partials and a second
//   kernel sums the 4 partials in slice order (no atomics: the same bits
//   every run), casting to the inputs' dtypes, and sums du over the batch
//   rows that share u's row.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::Elem;
namespace cg = cooperative_groups;
namespace sm90 = repro::sm90;

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


// ------------------------------------------------------------------ cluster
namespace cl {
constexpr int kStages = 3;  // a chunk's stage is refilled two chunks later
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == kN * 4 && kVS == 16, "thread (row i, 4 of the slice's 16 columns)");

template <bool BF16, bool WBF16>
struct Layout {
  static constexpr int kRK = kCH * kN * sizeof(typename Elem<BF16>::T);    // r or k tile
  static constexpr int kWB = kCH * kN * sizeof(typename Elem<WBF16>::T);   // w tile
  static constexpr int kVB = kCH * kVS * sizeof(typename Elem<BF16>::T);   // v or do slice
  static constexpr int kStage = 2 * kRK + kWB + 2 * kVB;
  static constexpr int kPart = 3 * kCH * kN;  // dr, dk, dw partials [3][kCH][kN]
  // after the ring: part[2] (double buffered), dv partials [kCH][kWarps][kVS],
  // ruk [kCH], v.do [kCH], du [kN], u [kN], and the chunk's d, -exp(w) d, r,
  // k [kCH][kN] in float32
  static constexpr int kFloats = 2 * kPart + kCH * kWarps * kVS + 2 * kCH + 2 * kN + 4 * kCH * kN;
  static constexpr int kSmem = 128 + kStages * kStage + 4 * kFloats;  // + alignment slack
  static_assert(kRK % 128 == 0 && kWB % 128 == 0 && kVB % 128 == 0, "128-byte aligned tiles");
};
}  // namespace cl

// One cluster of 4 blocks per head (rank = value slice). r, k, w, v and do
// come through 3-D tensor maps over (X, T, BH), boxes (X or 16, 16, 1).
template <bool BF16, bool WBF16>
__cluster_dims__(kSlices, 1, 1) __global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_cluster(const __grid_constant__ CUtensorMap r_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map, const float* __restrict__ u,
                 const float* __restrict__ ckpt, typename Elem<BF16>::T* __restrict__ dr,
                 typename Elem<BF16>::T* __restrict__ dk, typename Elem<BF16>::T* __restrict__ dv,
                 typename Elem<WBF16>::T* __restrict__ dw, float* __restrict__ du_part, int T,
                 int u_rows) {
  using E = Elem<BF16>;
  using EW = Elem<WBF16>;
  using L = cl::Layout<BF16, WBF16>;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring0 = smem_raw + (128 - sm90::smem_addr(smem_raw) % 128) % 128;  // TMA: 128-B
  float* part = reinterpret_cast<float*>(ring0 + cl::kStages * L::kStage);
  float* dvp = part + 2 * L::kPart;
  float* ruk = dvp + kCH * cl::kWarps * kVS;
  float* vdo = ruk + kCH;
  float* du_s = vdo + kCH;
  float* u_s = du_s + kN;
  float* d_s = u_s + kN;        // [kCH][kN] d_t
  float* ed_s = d_s + kCH * kN;  // -exp(w_t) d_t
  float* r_s = ed_s + kCH * kN;
  float* k_s = r_s + kCH * kN;
  __shared__ uint64_t full[cl::kStages];

  const int slice = (int)cluster.block_rank();
  const int bh = blockIdx.x / kSlices;
  const int v0 = slice * kVS;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i = tid / 4;   // state row
  const int q = tid % 4;   // columns 4q .. 4q + 3 of the slice
  const int n_chunks = (T + kCH - 1) / kCH;

  auto ring = [&](int it) { return ring0 + (it % cl::kStages) * L::kStage; };
  // The it-th chunk walked (c = n_chunks - 1 - it) into its ring stage.
  auto load = [&](int it) {
    if (tid != 0) return;
    const int t0 = (n_chunks - 1 - it) * kCH;
    uint64_t* bar = &full[it % cl::kStages];
    unsigned char* p = ring(it);
    sm90::mbar_arrive_expect_tx(bar, L::kStage);
    sm90::tma_load_3d(p, &r_map, bar, 0, t0, bh);
    sm90::tma_load_3d(p + L::kRK, &k_map, bar, 0, t0, bh);
    sm90::tma_load_3d(p + 2 * L::kRK, &w_map, bar, 0, t0, bh);
    sm90::tma_load_3d(p + 2 * L::kRK + L::kWB, &v_map, bar, v0, t0, bh);
    sm90::tma_load_3d(p + 2 * L::kRK + L::kWB + L::kVB, &do_map, bar, v0, t0, bh);
  };
  if (tid < cl::kStages) sm90::mbar_init(&full[tid], 1);
  sm90::mbar_fence_init();
  if (tid < kN) u_s[tid] = u[(long)(bh % u_rows) * kN + tid];
  __syncthreads();
  for (int it = 0; it < cl::kStages - 1 && it < n_chunks; ++it) load(it);

  const float ui = u_s[i];
  const float* peer[kSlices];  // every slice's partials, in rank order
#pragma unroll
  for (int r = 0; r < kSlices; ++r) peer[r] = cluster.map_shared_rank(part, r);
  const float* ck = ckpt + (long)bh * n_chunks * kN * kV + (long)i * kV + v0 + 4 * q;
  float4 s_next = *reinterpret_cast<const float4*>(ck + (long)(n_chunks - 1) * kN * kV);
  float G[4] = {0.f, 0.f, 0.f, 0.f};  // dL/dS_t at row i, this thread's columns
  float du_acc = 0.f;                 // lane q == 3: row i's du over this slice's v.do

  for (int it = 0; it < n_chunks; ++it) {
    const int c = n_chunks - 1 - it;
    const int t0 = c * kCH;
    __syncthreads();  // iteration it - 1 is done with its ring stage, dvp, ruk and vdo
    if (it + cl::kStages - 1 < n_chunks) load(it + cl::kStages - 1);
    const float4 s_cur = s_next;
    if (c > 0) s_next = *reinterpret_cast<const float4*>(ck + (long)(c - 1) * kN * kV);
    sm90::mbar_wait(&full[it % cl::kStages], (it / cl::kStages) & 1);
    const unsigned char* p = ring(it);
    const auto* rr = reinterpret_cast<const typename E::T*>(p);
    const auto* kr = reinterpret_cast<const typename E::T*>(p + L::kRK);
    const auto* wr = reinterpret_cast<const typename EW::T*>(p + 2 * L::kRK);
    const auto* vr = reinterpret_cast<const typename E::T*>(p + 2 * L::kRK + L::kWB);
    const auto* dor = reinterpret_cast<const typename E::T*>(p + 2 * L::kRK + L::kWB + L::kVB);

#pragma unroll
    for (int m = 0; m < kCH * kN / kThreads; ++m) {  // the chunk's row terms, once
      const int e = m * kThreads + tid;
      const float ew = expf(EW::load(wr, e));
      const float d = expf(-ew);
      d_s[e] = d;
      ed_s[e] = -ew * d;
      r_s[e] = E::load(rr, e);
      k_s[e] = E::load(kr, e);
    }
    {  // half-warp per step: v.do over the slice's columns, sum_n r u k over the rows
      const int t = 2 * warp + lane / 16;
      const int j = lane % 16;
      float a = E::load(vr, t * kVS + j) * E::load(dor, t * kVS + j);
      float b = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = j + 16 * m;
        b = fmaf(E::load(rr, t * kN + n) * u_s[n], E::load(kr, t * kN + n), b);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      if (j == 0) {
        vdo[t] = a;
        ruk[t] = b;
      }
    }

    __syncthreads();  // the row terms, vdo, ruk

    // this chunk's states S_{t0 + t - 1}, from the one saved at its start
    float Sv[kCH][4];
    {
      float sc[4] = {s_cur.x, s_cur.y, s_cur.z, s_cur.w};
#pragma unroll
      for (int t = 0; t < kCH; ++t) {
        const float d = d_s[t * kN + i];
        const float kt = k_s[t * kN + i];
        const float4 v4 = repro::lds4<E>(vr + t * kVS + 4 * q);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Sv[t][e] = sc[e];
          sc[e] = fmaf(d, sc[e], kt * vv[e]);
        }
      }
    }
    float* pb = part + (it % 2) * L::kPart;
#pragma unroll
    for (int t = kCH - 1; t >= 0; --t) {
      const float d = d_s[t * kN + i];
      const float ed = ed_s[t * kN + i];
      const float rt = r_s[t * kN + i];
      const float kt = k_s[t * kN + i];
      const float4 v4 = repro::lds4<E>(vr + t * kVS + 4 * q);
      const float4 o4 = repro::lds4<E>(dor + t * kVS + 4 * q);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      const float oo[4] = {o4.x, o4.y, o4.z, o4.w};
      float x[4] = {0.f, 0.f, 0.f, 0.f};  // S.do, G.v, G.S over this thread's columns
      float y[4];                         // G k, a column each
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[0] = fmaf(Sv[t][e], oo[e], x[0]);
        x[1] = fmaf(G[e], vv[e], x[1]);
        x[2] = fmaf(G[e], Sv[t][e], x[2]);
        y[e] = G[e] * kt;
        G[e] = fmaf(d, G[e], rt * oo[e]);  // G_{t-1}
      }
      repro::reduce_scatter<4>(x, lane);  // lane q: x[0] = the row's sum of x[q]
      repro::halve<2, 8>(y, lane);        // over the warp's 8 rows (lane bits 2-4):
      repro::halve<1, 4>(y, lane);        // y[0] is column 4q + (lane / 4) % 4
      y[0] += __shfl_xor_sync(0xffffffffu, y[0], 16);
      if (lane < 16) dvp[(t * cl::kWarps + warp) * kVS + 4 * q + lane / 4] = y[0];
      const float vd = vdo[t];
      // lane q: 0 dr, 1 dk (each with the slice's share of the bonus term), 2 dw
      const float val = q == 2 ? ed * x[0] : fmaf(ui * (q == 0 ? kt : rt), vd, x[0]);
      if (q < 3) pb[(q * kCH + t) * kN + i] = val;
      du_acc = fmaf(rt * kt, vd, du_acc);  // kept by lane q == 3
    }
    __syncthreads();        // this block's dv partials
    sm90::cluster_arrive();  // release this slice's partials to the other ranks

    {  // dv: one (step, column) a thread, the warps in order
      const int t = tid / kVS;
      const int j = tid % kVS;
      float a = ruk[t] * E::load(dor, t * kVS + j);
#pragma unroll
      for (int w = 0; w < cl::kWarps; ++w) a += dvp[(t * cl::kWarps + w) * kVS + j];
      if (t0 + t < T) E::store(dv, ((long)bh * T + t0 + t) * kV + v0 + j, a);
    }
    sm90::cluster_wait();  // every slice's partials are in place
    // dr, dk, dw: this rank's quarter of the chunk's sums, slices added in order
    constexpr int kMine = L::kPart / kSlices / kThreads;  // 3 a thread
    float a[kMine];
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int e = (it % 2) * L::kPart + slice * (L::kPart / kSlices) + m * kThreads + tid;
      a[m] = 0.f;
#pragma unroll
      for (int r = 0; r < kSlices; ++r) a[m] += peer[r][e];
    }
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int e = slice * (L::kPart / kSlices) + m * kThreads + tid;
      const int kind = e / (kCH * kN);
      const int t = (e / kN) % kCH;
      if (t0 + t >= T) continue;
      const long at = ((long)bh * T + t0 + t) * kN + e % kN;
      if (kind == 0) E::store(dr, at, a[m]);
      else if (kind == 1) E::store(dk, at, a[m]);
      else EW::store(dw, at, a[m]);
    }
  }
  if (q == 3) du_s[i] = du_acc;
  cluster.sync();
  if (tid < kN / kSlices) {
    const int n = slice * (kN / kSlices) + tid;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kSlices; ++r) a += cluster.map_shared_rank(du_s, r)[n];
    du_part[(long)bh * kN + n] = a;
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

// du: the heads' sums, over the heads that share u's row, in head order.
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_du(const float* __restrict__ du_part, float* __restrict__ du, int BH, int u_rows) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= u_rows * kN) return;
  float a = 0.f;
  for (int bh = e / kN; bh < BH; bh += u_rows) a += du_part[(long)bh * kN + e % kN];
  du[e] = a;
}

// A tensor map over a contiguous (BH, T, X) input, read as (X, T, BH)
// innermost first, box (box0, 16, 1), no swizzle; rows past T read zeros.
template <typename TT>
int tile_map(CUtensorMap* map, const void* base, int BH, int T, int X, int box0) {
  sm90::EncodeTiledFn encode = sm90::encode_tiled_fn();
  if (encode == nullptr) return -1;
  const uint64_t es = sizeof(TT);
  cuuint64_t dims[3] = {(cuuint64_t)X, (cuuint64_t)T, (cuuint64_t)BH};
  cuuint64_t strides[2] = {X * es, (cuuint64_t)T * X * es};
  cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)kCH, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = encode(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                      3, const_cast<void*>(base), dims, strides, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1;
}

template <bool BF16, bool WBF16>
int launch_cluster(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const void* dout, void* dr, void* dk, void* dv, void* dw, float* du,
                   const float* ckpt, float* du_part, int BH, int T, int u_rows, cudaStream_t st) {
  using T_ = typename Elem<BF16>::T;
  using TW = typename Elem<WBF16>::T;
  CUtensorMap r_map, k_map, w_map, v_map, do_map;
  if (tile_map<T_>(&r_map, r, BH, T, kN, kN) != 0 || tile_map<T_>(&k_map, k, BH, T, kN, kN) != 0 ||
      tile_map<TW>(&w_map, w, BH, T, kN, kN) != 0 || tile_map<T_>(&v_map, v, BH, T, kV, kVS) != 0 ||
      tile_map<T_>(&do_map, dout, BH, T, kV, kVS) != 0)
    return REPRO_BAD_ARGUMENT;
  auto kernel = wkv6_bwd_cluster<BF16, WBF16>;
  const int smem = cl::Layout<BF16, WBF16>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<BH * kSlices, kThreads, smem, st>>>(
      r_map, k_map, w_map, v_map, do_map, u, ckpt, static_cast<T_*>(dr), static_cast<T_*>(dk),
      static_cast<T_*>(dv), static_cast<TW*>(dw), du_part, T, u_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_du<<<(u_rows * kN + kThreads - 1) / kThreads, kThreads, 0, st>>>(du_part, du, BH,
                                                                            u_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, w, dr, dk, dw (BH, T, 64); v, do, dv (BH, T, 64); u, du (u_rows,
// 64) float32, row bh of the heads taking u's row bh % u_rows; ckpt (BH,
// ceil(T/16), 64, 64) float32. variant 1 (cluster): ckpt holds the
// forward's state entering each chunk; du_part (BH, 64) float32 scratch;
// part unused. variant 0 (chunked): ckpt, part (3, 4, BH, T, 64) and
// du_part (BH, 4, 64) float32 scratch. All contiguous, on the current
// device, 16-byte aligned. dtype: 0 float32, 1 bfloat16 (r, k, v, do and
// their gradients); w_f32: w and dw are float32 (else of dtype). Returns 0,
// a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_wkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* dout, void* dr, void* dk, void* dv, void* dw,
                        void* du, void* ckpt, void* part, void* du_part, int BH, int T,
                        int u_rows, int dtype, int w_f32, int variant, void* stream) {
  if (BH <= 0 || BH > 65535 || T <= 0 || u_rows <= 0 || BH % u_rows != 0 ||
      (variant != 0 && variant != 1))
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* u_ = static_cast<const float*>(u);
  float* du_ = static_cast<float*>(du);
  float* ck = static_cast<float*>(ckpt);
  float* pa = static_cast<float*>(part);
  float* dp = static_cast<float*>(du_part);
  if (variant == 1) {
    if (dtype == 0 && w_f32)
      return launch_cluster<false, false>(r, k, v, w, u_, dout, dr, dk, dv, dw, du_, ck, dp, BH,
                                          T, u_rows, st);
    if (dtype == 1 && !w_f32)
      return launch_cluster<true, true>(r, k, v, w, u_, dout, dr, dk, dv, dw, du_, ck, dp, BH, T,
                                        u_rows, st);
    if (dtype == 1 && w_f32)
      return launch_cluster<true, false>(r, k, v, w, u_, dout, dr, dk, dv, dw, du_, ck, dp, BH,
                                         T, u_rows, st);
    return REPRO_BAD_ARGUMENT;
  }
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

// Dynamic shared memory of the backward kernel, in bytes: variant 0 chunked,
// 1 cluster (bf16 inputs, bf16 w).
int repro_wkv6_scan_bwd_smem(int variant) {
  return variant ? cl::Layout<true, true>::kSmem : Smem::kBytes;
}

const char* repro_wkv6_scan_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
