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
// element. The design:
//   * one block per (sequence, head), 256 threads: thread t owns the state's
//     row p = t / 4 and 16 of its N = 64 columns (four 16-byte loads and
//     stores, a warp on 2 KB in a row), so the state moves once each way and
//     everything else is a few hundred bytes a block;
//   * the block computes its head's P conv channels, the B and C convs (every
//     head reads the same windows), dt and silu(z) into shared memory, then the
//     state update and S C in registers, y's sum over the row's 4 threads by
//     shuffles, and the per-head norm's sum over the P rows in a fixed order;
//   * each block shifts its head's x windows itself. The B and C windows are
//     every head's: the last block of a sequence to arrive (an integer counter
//     a sequence, zeroed here before the launch and reset by that block, as
//     adamw.cu's norm finds its last block) shifts them after every block has
//     read them, so each launch, eager or replayed in a CUDA graph, gives the
//     same bits;
//   * the state update rounds as the plain version does (two products, then a
//     sum: no FMA contraction), so the new state equals the plain version's
//     given the same conv outputs and dt.
#include "common.cuh"

namespace {

using repro::Elem;

constexpr int kThreads = 256;
constexpr int kP = 64;                    // channels a head
constexpr int kN = 64;                    // state size
constexpr int kW = 4;                     // conv window
constexpr int kCols = kN / (kThreads / kP);  // state columns a thread: 16

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

// One conv step of channel c of a (W-1, C) window at `win` (row stride C):
// sum_w window[w] w[w] + b over the window and the new input, in float32 as
// the plain version (products rounded, summed in order), silu'd and rounded
// to the model dtype. The window's values are returned in `old` for the
// shift.
template <bool BF16>
__device__ __forceinline__ float conv_step(const typename Elem<BF16>::T* win, int C, int c,
                                           float x_new, const typename Elem<BF16>::T* w,
                                           const typename Elem<BF16>::T* bias, float* old) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kW - 1; ++k) {
    old[k] = Elem<BF16>::load(win, (long)k * C + c);
    acc = __fadd_rn(acc, __fmul_rn(old[k], Elem<BF16>::load(w, (long)k * C + c)));
  }
  acc = __fadd_rn(acc, __fmul_rn(x_new, Elem<BF16>::load(w, (long)(kW - 1) * C + c)));
  const float out = silu(__fadd_rn(acc, Elem<BF16>::load(bias, c)));
  return BF16 ? __bfloat162float(__float2bfloat16_rn(out)) : out;
}

template <bool BF16>
__device__ __forceinline__ void shift(typename Elem<BF16>::T* win, int C, int c, const float* old,
                                      float x_new) {
#pragma unroll
  for (int k = 0; k < kW - 2; ++k) Elem<BF16>::store(win, (long)k * C + c, old[k + 1]);
  Elem<BF16>::store(win, (long)(kW - 2) * C + c, x_new);
}

template <bool BF16>
__device__ __forceinline__ float round_to(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) ssd_step_kernel(const Args a) {
  using T = typename Elem<BF16>::T;
  __shared__ float xh_s[kP], sz_s[kP], B_s[kN], C_s[kN], red[kThreads / 32];
  __shared__ float dt_s, decay_s;
  __shared__ bool last;

  const int H = a.H, d_inner = H * kP;
  const int h = blockIdx.x % H;
  const int rb = blockIdx.x / H;  // the sequence: tenant r = rb / B, slot rb % B
  const int r = rb / a.B;
  const int tid = threadIdx.x;

  // (1) the conv steps, dt and silu(z); thread groups of 64
  float old[kW - 1];
  float x_new = 0.f;
  const int g = tid >> 6, k = tid & 63;
  if (g == 0) {  // x's channel h P + k
    const int c = h * kP + k;
    x_new = Elem<BF16>::load(static_cast<const T*>(a.xs), (long)rb * d_inner + c);
    xh_s[k] = conv_step<BF16>(static_cast<const T*>(a.conv_x) + (long)rb * (kW - 1) * d_inner,
                              d_inner, c, x_new,
                              static_cast<const T*>(a.wx) + (long)r * kW * d_inner,
                              static_cast<const T*>(a.bx) + (long)r * d_inner, old);
  } else if (g == 1 || g == 2) {  // B's and C's channel k
    const bool isB = g == 1;
    x_new = Elem<BF16>::load(static_cast<const T*>(isB ? a.Bm : a.Cm), (long)rb * kN + k);
    const float v = conv_step<BF16>(
        static_cast<const T*>(isB ? a.conv_B : a.conv_C) + (long)rb * (kW - 1) * kN, kN, k,
        x_new, static_cast<const T*>(isB ? a.wB : a.wC) + (long)r * kW * kN,
        static_cast<const T*>(isB ? a.bB : a.bC) + (long)r * kN, old);
    (isB ? B_s : C_s)[k] = v;
  } else {  // silu(z) in the model dtype; dt and the decay
    const float zv = Elem<BF16>::load(static_cast<const T*>(a.z), (long)rb * d_inner + h * kP + k);
    sz_s[k] = round_to<BF16>(silu(zv));
    if (k == 0) {
      const float raw = Elem<BF16>::load(static_cast<const T*>(a.dt), (long)rb * H + h);
      const float d = softplus(__fadd_rn(raw, __ldg(a.dt_bias + (long)r * H + h)));
      dt_s = d;
      decay_s = expf(__fmul_rn(d, -expf(__ldg(a.A_log + (long)r * H + h))));
    }
  }
  __syncthreads();
  if (tid == 0) {  // every read of the shared B and C windows by this block is done
    __threadfence();
    last = atomicAdd(a.arrivals + rb, 1u) == (unsigned)H - 1;
  }
  __syncthreads();
  if (g == 0) {
    shift<BF16>(static_cast<T*>(a.conv_x) + (long)rb * (kW - 1) * d_inner, d_inner, h * kP + k,
                old, x_new);
  } else if (last && (g == 1 || g == 2)) {
    __threadfence();
    shift<BF16>(static_cast<T*>(g == 1 ? a.conv_B : a.conv_C) + (long)rb * (kW - 1) * kN, kN, k,
                old, x_new);
    if (tid == 64) a.arrivals[rb] = 0u;  // for the next launch
  }

  // (2) the state row p, columns [n0, n0 + 16): updated in place, and its part of S C
  const int p = tid >> 2, n0 = (tid & 3) * kCols;
  const float xp = xh_s[p];
  const float coef = __fmul_rn(dt_s, xp);
  const float decay = decay_s;
  float4* st = reinterpret_cast<float4*>(a.ssm + (((long long)rb * H + h) * kP + p) * kN + n0);
  float part = 0.f;
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) {
    float4 v = st[q];
    const int n = n0 + 4 * q;
    v.x = __fadd_rn(__fmul_rn(decay, v.x), __fmul_rn(coef, B_s[n]));
    v.y = __fadd_rn(__fmul_rn(decay, v.y), __fmul_rn(coef, B_s[n + 1]));
    v.z = __fadd_rn(__fmul_rn(decay, v.z), __fmul_rn(coef, B_s[n + 2]));
    v.w = __fadd_rn(__fmul_rn(decay, v.w), __fmul_rn(coef, B_s[n + 3]));
    st[q] = v;
    part = fmaf(v.x, C_s[n], part);
    part = fmaf(v.y, C_s[n + 1], part);
    part = fmaf(v.z, C_s[n + 2], part);
    part = fmaf(v.w, C_s[n + 3], part);
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  const float yv = __fadd_rn(part, __fmul_rn(__ldg(a.D + (long)r * H + h), xp));
  const float gv = __fmul_rn(yv, sz_s[p]);

  // (3) the per-head RMS norm over the P rows (each row once, from its first thread)
  float sq = (tid & 3) == 0 ? __fmul_rn(gv, gv) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((tid & 31) == 0) red[tid >> 5] = sq;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(total, (float)kP), a.eps));
  if ((tid & 3) == 0) {
    const int c = h * kP + p;
    const float nv = Elem<BF16>::load(static_cast<const T*>(a.norm), (long)r * d_inner + c);
    Elem<BF16>::store(static_cast<T*>(a.y), (long)rb * d_inner + c,
                      __fmul_rn(__fmul_rn(gv, inv), nv));
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
// 16-byte aligned; `arrivals` R B unsigned ints of scratch, zeroed here.
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
  const cudaError_t err = cudaMemsetAsync(arrivals, 0, sizeof(unsigned) * R * B, s);
  if (err != cudaSuccess) return (int)err;
  const Args a = {z, xs, Bm, Cm, dt, wx, bx, wB, bB, wC, bC, A_log, D, dt_bias, norm,
                  conv_x, conv_B, conv_C, ssm, y, arrivals, B, H, eps};
  if (dtype == 1) {
    ssd_step_kernel<true><<<R * B * H, kThreads, 0, s>>>(a);
  } else {
    ssd_step_kernel<false><<<R * B * H, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* repro_ssd_step_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
