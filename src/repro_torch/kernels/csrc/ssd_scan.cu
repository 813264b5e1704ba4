// Mamba2's chunked SSD scan for a prefill (SSD-scan, a kernel of the port's
// own).
//
// Replaces no Pallas kernel. The JAX package's scan is jnp,
// src/repro/models/ssm.py::ssd_scan (:93), which XLA fuses inside the jitted
// prefill programs (src/repro/serving/engine.py:103-124). As plain PyTorch
// (kernels/ref.py::ssd_scan) it materialises float32 (B, nc, L, L, H)
// tensors of relative decays (59 MB a layer at zamba2's 512-token piece) and
// passes over them about a dozen times, with a Python loop over the chunks.
//
// Per head, with a float32 state S (P x N), a_t = A dt_t and xbar_t = dt_t x_t:
//   S_t = exp(a_t) S_{t-1} + xbar_t B_t^T,     y_t = S_t C_t.
// In chunks of kL = 64 steps, cum_l the prefix sum of a within the chunk and
// S_0 the state entering it (the reference's chunked form at its own chunk):
//   y_l   = sum_{m<=l} (C_l . B_m) exp(cum_l - cum_m) xbar_m  +  exp(cum_l) S_0 C_l
//   S_out = exp(cum_last) S_0 + sum_m exp(cum_last - cum_m) xbar_m B_m^T.
// The chunked form equals the recurrence up to rounding.
//
// What bounds it on an H100: xh, y, dt, B, C and the state in and out are
// ~18.7 MB at zamba2's 512-token piece (5.6 us at 3.35 TB/s); the
// recurrence's 4 P N float32 operations a head and step are ~0.94 GFLOP there
// (14 us at 67 TFLOP/s): operations. The chunked form does about 5x those to
// put most of them in products over the chunk. The design:
//   * one block per (sequence, head, slice of kPS = 32 of the P channels):
//     zamba2's one-sequence prefill is 224 blocks of its 112 heads, enough to
//     fill the 132 SMs; a loop over the chunks inside the block carries the
//     block's 32 x N slice of the state in shared memory, so nothing crosses
//     blocks;
//   * a chunk's B, C (kL x N) and xbar (kL x kPS) are staged in shared memory
//     as float32 (16-byte loads, rows past S read as zero: S is not padded in
//     memory); warp 0 forms the prefix sum of a by shuffles and the
//     exponentials the chunk needs (exp(cum), exp(last - cum), exp(last));
//   * the masked decay matrix M = (C B^T) o exp(cum_l - cum_m) (kL x kL) is
//     formed in shared memory and never reaches device memory: no (L, L, H)
//     tensor exists;
//   * y = M xbar + exp(cum) o (C S_0^T), then S_out as above, all float32
//     FMAs on CUDA cores (the float32 operands stay float32; C B^T is formed
//     from the model-dtype values widened exactly), each thread a 4 x 4, 4 x 2
//     or 2 x 4 register tile over rows 16 apart, so that a warp's 16-byte
//     shared-memory reads fall on distinct banks;
//   * only the chunk's valid rows are computed: a 1-token piece costs one row.
#include "common.cuh"

namespace {

using repro::Elem;

constexpr int kThreads = 256;
constexpr int kL = 64;         // steps a chunk: the wrapper's ``CHUNK``
constexpr int kN = 64;         // state size N (zamba2's)
constexpr int kPS = 32;        // channels of P a block takes
constexpr int kNS = kN + 4;    // row stride of B, C and the state in shared memory
constexpr int kMS = kL + 1;    // row stride of M
constexpr int kSmemFloats = 2 * kL * kNS + kL * kPS + kL * kMS + kPS * kNS + 4 * kL;
constexpr int kSmemBytes = kSmemFloats * 4;

struct Args {
  const void* xh;      // (B, S, H, P) model dtype
  const float* dt;     // (B, S, H)
  const float* A;      // (H,)
  const void* Bm;      // (B, S, N) model dtype
  const void* Cm;      // (B, S, N) model dtype
  const float* s0;     // (B, H, P, N) or null: zero
  void* y;             // (B, S, H, P) model dtype
  float* s_out;        // (B, H, P, N)
  int S, H, P;
};

// Rows [c0, c0 + kL) of a (S, W)-row matrix at `src` (W elements a row, row
// stride `stride` elements) into dst (row stride `dst_stride`) as float32;
// rows past S are zero.
template <bool BF16, int W>
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           const typename Elem<BF16>::T* __restrict__ src,
                                           long long stride, int c0, int S) {
  constexpr int V = Elem<BF16>::kVec;
  constexpr int kRowVecs = W / V;
  for (int i = threadIdx.x; i < kL * kRowVecs; i += kThreads) {
    const int row = i / kRowVecs, col = (i % kRowVecs) * V;
    float v[V];
    if (c0 + row < S) {
      Elem<BF16>::unpack(__ldg(reinterpret_cast<const uint4*>(src + (c0 + row) * stride + col)),
                         v);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = 0.f;
    }
    float* o = dst + row * dst_stride + col;
#pragma unroll
    for (int u = 0; u < V; u += 4) *reinterpret_cast<float4*>(o + u) = make_float4(
        v[u], v[u + 1], v[u + 2], v[u + 3]);
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Args a) {
  using T = typename Elem<BF16>::T;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // [kL][kNS]
  float* Bs = Cs + kL * kNS;         // [kL][kNS]
  float* Xs = Bs + kL * kNS;         // [kL][kPS]  xbar
  float* Ms = Xs + kL * kPS;         // [kL][kMS]
  float* Ss = Ms + kL * kMS;         // [kPS][kNS] the state slice
  float* cum = Ss + kPS * kNS;       // [kL]
  float* ec = cum + kL;              // [kL] exp(cum)
  float* ew = ec + kL;               // [kL] exp(last - cum)
  float* misc = ew + kL;             // [0]: exp(last)

  const int nps = a.P / kPS;
  const int ps = blockIdx.x % nps;
  const int h = (blockIdx.x / nps) % a.H;
  const int b = blockIdx.x / (nps * a.H);
  const int p0 = ps * kPS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15;
  const int S = a.S, H = a.H, P = a.P;
  const float Ah = __ldg(a.A + h);

  const T* xh = static_cast<const T*>(a.xh);
  const T* Bg = static_cast<const T*>(a.Bm) + (long long)b * S * kN;
  const T* Cg = static_cast<const T*>(a.Cm) + (long long)b * S * kN;
  const float* dtg = a.dt + (long long)b * S * H + h;
  T* y = static_cast<T*>(a.y);
  const long long state0 = (((long long)b * H + h) * P + p0) * kN;  // the slice's first element

  for (int i = tid; i < kPS * kN / 4; i += kThreads) {
    const int row = i / (kN / 4), col = (i % (kN / 4)) * 4;
    const float4 v = a.s0 ? __ldg(reinterpret_cast<const float4*>(a.s0 + state0) + i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(Ss + row * kNS + col) = v;
  }

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int valid = min(kL, S - c0);
    __syncthreads();  // the last chunk's readers are done with the staging buffers
    stage_rows<BF16, kN>(Cs, kNS, Cg, kN, c0, S);
    stage_rows<BF16, kN>(Bs, kNS, Bg, kN, c0, S);
    {  // xbar = x dt, the block's kPS channels of head h
      constexpr int V = Elem<BF16>::kVec;
      constexpr int kRowVecs = kPS / V;
      for (int i = tid; i < kL * kRowVecs; i += kThreads) {
        const int row = i / kRowVecs, col = (i % kRowVecs) * V;
        float v[V];
        if (row < valid) {
          const long long s = c0 + row;
          Elem<BF16>::unpack(
              __ldg(reinterpret_cast<const uint4*>(xh + (((long long)b * S + s) * H + h) * P +
                                                   p0 + col)),
              v);
          const float d = __ldg(dtg + s * H);
#pragma unroll
          for (int u = 0; u < V; ++u) v[u] = __fmul_rn(v[u], d);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) v[u] = 0.f;
        }
        float* o = Xs + row * kPS + col;
#pragma unroll
        for (int u = 0; u < V; u += 4)
          *reinterpret_cast<float4*>(o + u) = make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
      }
    }
    if (warp == 0) {  // the prefix sum of a = A dt (zero past S) and its exponentials
      float a0 = lane < valid ? __fmul_rn(__ldg(dtg + (long long)(c0 + lane) * H), Ah) : 0.f;
      float a1 = lane + 32 < valid ? __fmul_rn(__ldg(dtg + (long long)(c0 + lane + 32) * H), Ah)
                                   : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t0 = __shfl_up_sync(0xffffffffu, a0, o);
        const float t1 = __shfl_up_sync(0xffffffffu, a1, o);
        if (lane >= o) {
          a0 += t0;
          a1 += t1;
        }
      }
      a1 += __shfl_sync(0xffffffffu, a0, 31);
      const float last = __shfl_sync(0xffffffffu, a1, 31);
      cum[lane] = a0;
      cum[lane + 32] = a1;
      ec[lane] = expf(a0);
      ec[lane + 32] = expf(a1);
      ew[lane] = expf(last - a0);
      ew[lane + 32] = expf(last - a1);
      if (lane == 0) misc[0] = expf(last);
    }
    __syncthreads();

    // M[l][m] = (C_l . B_m) exp(cum_l - cum_m) for m <= l < valid, else 0;
    // rows l = ty + 16 i, columns m = tx + 16 j
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (ty < valid) {
#pragma unroll 4
        for (int n = 0; n < kN; n += 4) {
          float4 bv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * kNS + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (ty + 16 * i >= valid) continue;
            const float4 cv = *reinterpret_cast<const float4*>(Cs + (ty + 16 * i) * kNS + n);
#pragma unroll
            for (int j = 0; j <= i; ++j) acc[i][j] = dot4(cv, bv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = tx + 16 * j;
          Ms[l * kMS + m] = (m <= l && l < valid) ? acc[i][j] * expf(cum[l] - cum[m]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y_l = sum_m M[l][m] xbar_m + exp(cum_l) (C_l . S_0[p]); rows l = ty + 16 i,
    // channels p = tx + 16 j of the slice
    {
      float yi[4][2], yc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) yi[i][j] = yc[i][j] = 0.f;
      if (ty < valid) {
        for (int m = 0; m < valid; ++m) {
          float xb[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) xb[j] = Xs[m * kPS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float mm = Ms[(ty + 16 * i) * kMS + m];
#pragma unroll
            for (int j = 0; j < 2; ++j) yi[i][j] = fmaf(mm, xb[j], yi[i][j]);
          }
        }
#pragma unroll 4
        for (int n = 0; n < kN; n += 4) {
          float4 sv[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            sv[j] = *reinterpret_cast<const float4*>(Ss + (tx + 16 * j) * kNS + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 cv = *reinterpret_cast<const float4*>(Cs + (ty + 16 * i) * kNS + n);
#pragma unroll
            for (int j = 0; j < 2; ++j) yc[i][j] = dot4(cv, sv[j], yc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty + 16 * i;
        if (l >= valid) continue;
        const long long row = (((long long)b * S + c0 + l) * H + h) * P + p0;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          Elem<BF16>::store(y, row + tx + 16 * j, __fadd_rn(yi[i][j], __fmul_rn(ec[l], yc[i][j])));
      }
    }
    __syncthreads();  // every read of S_0 is done

    // S_out[p][n] = exp(last) S_0[p][n] + sum_m (exp(last - cum_m) xbar_m[p]) B_m[n];
    // p = ty + 16 i, n = tx + 16 k
    {
      float acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
      for (int m = 0; m < valid; ++m) {
        const float w = ew[m];
        float t[2], bv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) t[i] = __fmul_rn(w, Xs[m * kPS + ty + 16 * i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = Bs[m * kNS + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(t[i], bv[k], acc[i][k]);
      }
      const float dc = misc[0];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float* s = Ss + (ty + 16 * i) * kNS + tx + 16 * k;
          *s = __fadd_rn(__fmul_rn(dc, *s), acc[i][k]);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < kPS * kN / 4; i += kThreads) {
    const int row = i / (kN / 4), col = (i % (kN / 4)) * 4;
    reinterpret_cast<float4*>(a.s_out + state0)[i] =
        *reinterpret_cast<const float4*>(Ss + row * kNS + col);
  }
}

bool aligned(const void* p) { return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool BF16>
int launch(const Args& a, int blocks, cudaStream_t s) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  ssd_scan_kernel<BF16><<<blocks, kThreads, kSmemBytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, S, H, P) and the final state s_out (B, H, P, N) float32 of the SSD
// scan of xh (B, S, H, P), dt (B, S, H) float32 (post-softplus), A (H,)
// float32, Bm and Cm (B, S, N), from s0 (B, H, P, N) float32 or null (zero).
// xh, Bm, Cm and y float32 (dtype 0) or bf16 (dtype 1); every array
// contiguous and 16-byte aligned (s0 may be s_out). Takes P a multiple of 32,
// N = 64 and chunk = 64. Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_ssd_scan(const void* xh, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* s0, void* y, float* s_out, int B, int S, int H,
                   int P, int N, int chunk, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < kPS || P % kPS || N != kN || chunk != kL ||
      (dtype != 0 && dtype != 1) || (long long)B * H * (P / kPS) > 0x7fffffffLL)
    return REPRO_BAD_ARGUMENT;
  if (!aligned(xh) || !aligned(dt) || !aligned(A) || !aligned(Bm) || !aligned(Cm) ||
      !aligned(y) || !aligned(s_out) || (s0 && !aligned(s0)))
    return REPRO_BAD_ARGUMENT;
  const Args a = {xh, dt, A, Bm, Cm, s0, y, s_out, S, H, P};
  const int blocks = B * H * (P / kPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<true>(a, blocks, s) : launch<false>(a, blocks, s);
}

// Dynamic shared memory a block takes (the build report).
int repro_ssd_scan_smem() { return kSmemBytes; }

const char* repro_ssd_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
