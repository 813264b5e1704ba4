// Mamba2's decode mixer in one launch a layer (SSD-step, a kernel of the
// port's own).
//
// Replaces no Pallas kernel. The JAX package's decode step is jnp,
// src/repro/models/ssm.py::mamba2_decode (:257), which XLA fuses inside the
// jitted decode program; this kernel is its part from the projections' outputs
// to out_proj's input. As plain PyTorch (kernels/ref.py::ssd_step) that is
// about 40 elementwise launches a layer, which move the float32 state
// (R, B, H, P, N) about 8 times. Per sequence and head:
//   three depthwise causal conv steps over windows of W = 4 (x's P channels,
//   the shared B and C), each silu'd and rounded to the model dtype;
//   dt = softplus(dt_raw + dt_bias), decay = exp(dt * -exp(A_log));
//   S = decay S + (dt x) B^T (float32, in place);  y = S C + D x;
//   out = rmsnorm_head(y * silu(z)) * norm, rounded to the model dtype once.
//
// What bounds it on an H100: bytes. The state is read once and written once:
// 2 R B H P N 4 bytes, 58.7 MB for zamba2's merged step (R 4, B 4; 17.5 us at
// 3.35 TB/s), 4.4 us for one tenant's (R 1), against ~5 float32 operations an
// element. Everything else is a few hundred bytes a block. The first kernel
// (`fused`, 2.7x the bound at one tenant) lost its time to two things: each
// thread owned 16 consecutive floats of a row, so each 16-byte load or store
// instruction of a warp touched 32 pieces 64 bytes apart, a quarter of each,
// and three memory round trips (the conv inputs, a fence and an atomic)
// stood in series in front of the state's read. The design (`coalesced`):
//   * one block per (sequence, head), 288 threads. Warps 0-7 own the state,
//     as 16-byte vectors: thread t the vectors t, t + 256, t + 512, t + 768
//     of the head's (P, N) tile (rows t / 16 + 16 q, columns 4 (t % 16) ..
//     + 3), so each load or store instruction of a warp moves 512 contiguous
//     bytes. Each state thread issues every load it needs at entry: its conv
//     or gate inputs, D and its rows' norm weights, then its four state
//     vectors, with an evict-first hint (the next read of a state is a whole
//     decode pass later), so a block's 16 KB are in flight with the few
//     hundred bytes the x conv step, silu(z) and dt need;
//   * then the x conv step, silu(z), dt and the decay into shared memory, one
//     barrier, the state update and S C in registers, y's sum over a row's 16
//     threads by shuffles (a fixed tree), the per-head norm's sum over the P
//     rows in a fixed order (each warp's 8 rows, then the 8 warps in order),
//     y stored;
//   * each block shifts its head's x windows itself, right after reading them
//     (no other block reads those channels). The B and C windows are every
//     head's, and warp 8 is their only reader in a block: it computes their
//     conv steps, hands B and C to the state warps at a barrier it does not
//     wait at, then arrives on the sequence's counter (a fence, then an
//     atomicAdd) and waits for the answer; in the last block of the sequence
//     to arrive it shifts them, after every head's block has read them. No
//     state warp waits for that round trip;
//   * the counters are never zeroed by a memset: the last block of a sequence
//     resets its counter to 0 (after the H arrivals, so no increment is
//     lost), and the wrapper keeps one set a state tensor, zeroed when it is
//     made (kernels/ssd.py step_arrivals), so every launch, eager or
//     replayed in a CUDA graph, finds them at 0 and leaves them at 0. Two
//     launches that share a set update the same state, which no caller runs
//     at once (a cache is stepped by one launch after another on one
//     stream), so no two launches that may overlap share a counter;
//   * the state update rounds as the plain version does (two products, then a
//     sum: no FMA contraction), so the new state equals the plain version's
//     given the same conv outputs and dt.
#include "common.cuh"

namespace {

using repro::Elem;

constexpr int kP = 64;                    // channels a head
constexpr int kN = 64;                    // state size
constexpr int kW = 4;                     // conv window
constexpr int kStateThreads = 256;        // warps 0-7: the state
constexpr int kThreads = kStateThreads + 32;  // warp 8: the shared B and C windows
constexpr int kVecs = kP * kN / 4 / kStateThreads;  // 16-byte vectors of the state a thread: 4
constexpr int kRowVecs = kN / 4;                    // vectors a state row: 16
constexpr int kBCWarp = kStateThreads / 32;         // 8

struct Args {
  const void* z;         // (R, B, d_inner)   model dtype
  const void* xs;        // (R, B, d_inner)
  const void* Bm;        // (R, B, N)
  const void* Cm;        // (R, B, N)
  const void* dt;        // (R, B, H)
  const void* wx;        // (R, W, d_inner)
  const void* bx;        // (R, d_inner)
  const void* wB;        // (R, W, N)
  const void* bB;        // (R, N)
  const void* wC;        // (R, W, N)
  const void* bC;        // (R, N)
  const float* A_log;    // (R, H)
  const float* D;        // (R, H)
  const float* dt_bias;  // (R, H)
  const void* norm;      // (R, d_inner)
  void* conv_x;          // (R, B, W-1, d_inner)
  void* conv_B;          // (R, B, W-1, N)
  void* conv_C;          // (R, B, W-1, N)
  float* ssm;            // (R, B, H, P, N)
  void* y;               // (R, B, d_inner)
  unsigned* arrivals;    // (R B,)
  int B, H;
  float eps;
};

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float softplus(float x) {  // torch's, beta 1, threshold 20
  return x > 20.f ? x : log1pf(expf(x));
}

// A conv step's inputs for channel c of a (W-1, C) window at `win` (row
// stride C): the window, the W weights, the bias and the new input, loaded
// at once.
struct ConvIn {
  float old[kW - 1], w[kW], bias, x;
};

template <bool BF16>
__device__ __forceinline__ ConvIn conv_load(const typename Elem<BF16>::T* win, int C, int c,
                                            const typename Elem<BF16>::T* w,
                                            const typename Elem<BF16>::T* bias,
                                            const typename Elem<BF16>::T* x, long xi) {
  ConvIn in;
#pragma unroll
  for (int k = 0; k < kW - 1; ++k) in.old[k] = Elem<BF16>::load(win, (long)k * C + c);
#pragma unroll
  for (int k = 0; k < kW; ++k) in.w[k] = Elem<BF16>::load(w, (long)k * C + c);
  in.bias = Elem<BF16>::load(bias, c);
  in.x = Elem<BF16>::load(x, xi);
  return in;
}

// A named barrier of `count` threads (a multiple of 32): warp 8 hands B and
// C to the state warps at barrier 1 of all kThreads; the state warps alone
// meet at barrier 2.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Arrive at named barrier `id` of `count` threads without waiting for it.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <bool BF16>
__device__ __forceinline__ float round_to(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// sum_w window[w] w[w] + b over the window and the new input, in float32 as
// the plain version (products rounded, summed in order), silu'd and rounded
// to the model dtype.
template <bool BF16>
__device__ __forceinline__ float conv_out(const ConvIn& in) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kW - 1; ++k) acc = __fadd_rn(acc, __fmul_rn(in.old[k], in.w[k]));
  acc = __fadd_rn(acc, __fmul_rn(in.x, in.w[kW - 1]));
  return round_to<BF16>(silu(__fadd_rn(acc, in.bias)));
}

// The window shifted by one step: rows 1.. W-2 up, the new input last.
template <bool BF16>
__device__ __forceinline__ void shift(typename Elem<BF16>::T* win, int C, int c,
                                      const ConvIn& in) {
#pragma unroll
  for (int k = 0; k < kW - 2; ++k) Elem<BF16>::store(win, (long)k * C + c, in.old[k + 1]);
  Elem<BF16>::store(win, (long)(kW - 2) * C + c, in.x);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) ssd_step_kernel(const Args a) {
  using T = typename Elem<BF16>::T;
  __shared__ __align__(16) float B_s[kN], C_s[kN];
  __shared__ float xh_s[kP], sz_s[kP], red[kStateThreads / 32];
  __shared__ float dt_s, decay_s;

  const int H = a.H, d_inner = H * kP;
  const int h = blockIdx.x % H;
  const int rb = blockIdx.x / H;  // the sequence: tenant r = rb / B, slot rb % B
  const int r = rb / a.B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (warp == kBCWarp) {
    // (1') the B and C conv steps (channels lane and lane + 32 of each); this
    // warp is the block's only reader of the shared windows
    const T* const wB = static_cast<const T*>(a.wB) + (long)r * kW * kN;
    const T* const wC = static_cast<const T*>(a.wC) + (long)r * kW * kN;
    T* const winB = static_cast<T*>(a.conv_B) + (long)rb * (kW - 1) * kN;
    T* const winC = static_cast<T*>(a.conv_C) + (long)rb * (kW - 1) * kN;
    ConvIn in[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool isB = i < 2;
      const int c = lane + 32 * (i & 1);
      in[i] = conv_load<BF16>(isB ? winB : winC, kN, c, isB ? wB : wC,
                              static_cast<const T*>(isB ? a.bB : a.bC) + (long)r * kN,
                              static_cast<const T*>(isB ? a.Bm : a.Cm), (long)rb * kN + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) (i < 2 ? B_s : C_s)[lane + 32 * (i & 1)] = conv_out<BF16>(in[i]);
    named_arrive(1, kThreads);  // (A): B_s and C_s to the state warps, which it does not wait for
    // every read of the windows by this block is done: arrive on the
    // sequence's counter, and in its last block to arrive shift the windows
    unsigned arrived = 0u;
    if (lane == 0) {
      __threadfence();
      arrived = atomicAdd(a.arrivals + rb, 1u);
    }
    if (__shfl_sync(0xffffffffu, arrived, 0) == (unsigned)H - 1) {
      __threadfence();
#pragma unroll
      for (int i = 0; i < 4; ++i) shift<BF16>(i < 2 ? winB : winC, kN, lane + 32 * (i & 1), in[i]);
      if (lane == 0) a.arrivals[rb] = 0u;  // after all H arrivals: the next launch finds 0
    }
    return;
  }

  // (0) every load a state thread needs, issued first: its conv or gate
  // inputs, D, the norm weights of its rows, then its four 16-byte vectors
  // of the state, vector q*256 + t of the head's (P, N) tile: row
  // p_q = 16 q + t / 16, columns 4 (t % 16) .. + 3 (each load instruction
  // of a warp reads 512 contiguous bytes)
  const int g = tid >> 6, k = tid & 63;
  const int row0 = tid / kRowVecs, n0 = (tid % kRowVecs) * 4;
  constexpr int kRowStep = kStateThreads / kRowVecs;  // 16 rows between a thread's vectors
  ConvIn xin;
  float zv = 0.f, raw = 0.f, bias = 0.f, alog = 0.f;
  T* const winx = static_cast<T*>(a.conv_x) + (long)rb * (kW - 1) * d_inner;
  if (g == 0) {  // x's channel h P + k
    const int c = h * kP + k;
    xin = conv_load<BF16>(winx, d_inner, c, static_cast<const T*>(a.wx) + (long)r * kW * d_inner,
                          static_cast<const T*>(a.bx) + (long)r * d_inner,
                          static_cast<const T*>(a.xs), (long)rb * d_inner + c);
  } else if (g == 1) {  // z's channel h P + k; dt's inputs
    zv = Elem<BF16>::load(static_cast<const T*>(a.z), (long)rb * d_inner + h * kP + k);
    if (k == 0) {
      raw = Elem<BF16>::load(static_cast<const T*>(a.dt), (long)rb * H + h);
      bias = __ldg(a.dt_bias + (long)r * H + h);
      alog = __ldg(a.A_log + (long)r * H + h);
    }
  }
  const float Dh = __ldg(a.D + (long)r * H + h);
  const bool row_lead = n0 == 0;  // the thread that finishes its rows
  float nv[kVecs];
#pragma unroll
  for (int q = 0; q < kVecs; ++q)
    nv[q] = row_lead ? Elem<BF16>::load(static_cast<const T*>(a.norm),
                                        (long)r * d_inner + h * kP + row0 + kRowStep * q)
                     : 0.f;
  float4* const st = reinterpret_cast<float4*>(a.ssm + ((long long)rb * H + h) * kP * kN) + tid;
  float4 s[kVecs];
#pragma unroll
  for (int q = 0; q < kVecs; ++q) s[q] = __ldcs(st + kStateThreads * q);  // evict first

  // (1) the x conv step (each block shifts its head's x windows: no other
  // block reads them), silu(z) in the model dtype, dt and the decay
  if (g == 0) {
    xh_s[k] = conv_out<BF16>(xin);
    shift<BF16>(winx, d_inner, h * kP + k, xin);
  } else if (g == 1) {
    sz_s[k] = round_to<BF16>(silu(zv));
    if (k == 0) {
      const float d = softplus(__fadd_rn(raw, bias));
      dt_s = d;
      decay_s = expf(__fmul_rn(d, -expf(alog)));
    }
  }
  named_sync(1, kThreads);  // (A)

  // (2) the state update in place, and each row's part of S C, summed over
  // the row's 16 threads by shuffles
  const float4 Bv = *reinterpret_cast<const float4*>(B_s + n0);
  const float4 Cv = *reinterpret_cast<const float4*>(C_s + n0);
  const float dt = dt_s, decay = decay_s;
  float sq = 0.f;
  float gv[kVecs];
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    const int p = row0 + kRowStep * q;
    const float xp = xh_s[p];
    const float coef = __fmul_rn(dt, xp);
    float4 v = s[q];
    v.x = __fadd_rn(__fmul_rn(decay, v.x), __fmul_rn(coef, Bv.x));
    v.y = __fadd_rn(__fmul_rn(decay, v.y), __fmul_rn(coef, Bv.y));
    v.z = __fadd_rn(__fmul_rn(decay, v.z), __fmul_rn(coef, Bv.z));
    v.w = __fadd_rn(__fmul_rn(decay, v.w), __fmul_rn(coef, Bv.w));
    __stcs(st + kStateThreads * q, v);
    float part = fmaf(v.x, Cv.x, 0.f);
    part = fmaf(v.y, Cv.y, part);
    part = fmaf(v.z, Cv.z, part);
    part = fmaf(v.w, Cv.w, part);
#pragma unroll
    for (int o = 1; o < kRowVecs; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    gv[q] = __fmul_rn(__fadd_rn(part, __fmul_rn(Dh, xp)), sz_s[p]);
    if (row_lead) sq = __fadd_rn(sq, __fmul_rn(gv[q], gv[q]));
  }

  // (3) the per-head RMS norm over the P rows: each warp's 8 rows (its row
  // leads' sums, in q order, then lanes 0 and 16), then the 8 warps in order
  sq += __shfl_xor_sync(0xffffffffu, sq, kRowVecs);
  if (lane == 0) red[warp] = sq;
  named_sync(2, kStateThreads);
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kStateThreads / 32; ++w) total += red[w];
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(total, (float)kP), a.eps));
  if (row_lead) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
      Elem<BF16>::store(static_cast<T*>(a.y), (long)rb * d_inner + h * kP + row0 + kRowStep * q,
                        __fmul_rn(__fmul_rn(gv[q], inv), nv[q]));
  }
}

bool aligned(const void* p) { return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The decode mixer of R tenants x B slots (H heads of P = 64, N = 64, conv
// window W = 4): z, xs (R, B, H P), Bm, Cm (R, B, N), dt (R, B, H); the
// tenant-stacked conv weights (R, W, C) and biases (R, C), A_log, D, dt_bias
// (R, H) float32 and norm (R, H P); the caches conv_x (R, B, W-1, H P),
// conv_B, conv_C (R, B, W-1, N) and ssm (R, B, H, P, N) float32, updated in
// place; y (R, B, H P). Everything but A_log, D, dt_bias and ssm in the model
// dtype: float32 (dtype 0) or bf16 (dtype 1); every array contiguous, ssm
// 16-byte aligned; `arrivals` R B unsigned ints, 0 at the launch and left at
// 0 by it (kept by the caller with the state; nothing here zeroes them).
// Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_ssd_step(const void* z, const void* xs, const void* Bm, const void* Cm,
                   const void* dt, const void* wx, const void* bx, const void* wB, const void* bB,
                   const void* wC, const void* bC, const float* A_log, const float* D,
                   const float* dt_bias, const void* norm, void* conv_x, void* conv_B,
                   void* conv_C, float* ssm, void* y, unsigned* arrivals, int R, int B, int H,
                   int P, int N, int W, int dtype, float eps, void* stream) {
  if (R < 1 || B < 1 || H < 1 || P != kP || N != kN || W != kW || (dtype != 0 && dtype != 1) ||
      (long long)R * B * H > 0x7fffffffLL || !(eps > 0.f))
    return REPRO_BAD_ARGUMENT;
  const void* ptrs[] = {z, xs, Bm, Cm, dt, wx, bx, wB, bB, wC, bC, A_log, D, dt_bias, norm,
                        conv_x, conv_B, conv_C, y, arrivals};
  for (const void* q : ptrs)  // element-aligned; the state is read in 16-byte vectors
    if (!q || reinterpret_cast<uintptr_t>(q) % (dtype ? 2 : 4)) return REPRO_BAD_ARGUMENT;
  if (!aligned(ssm) || reinterpret_cast<uintptr_t>(A_log) % 4 ||
      reinterpret_cast<uintptr_t>(D) % 4 || reinterpret_cast<uintptr_t>(dt_bias) % 4 ||
      reinterpret_cast<uintptr_t>(arrivals) % 4)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = {z, xs, Bm, Cm, dt, wx, bx, wB, bB, wC, bC, A_log, D, dt_bias, norm,
                  conv_x, conv_B, conv_C, ssm, y, arrivals, B, H, eps};
  const int grid = R * B * H;
  if (dtype == 1) {
    ssd_step_kernel<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    ssd_step_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* repro_ssd_step_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
