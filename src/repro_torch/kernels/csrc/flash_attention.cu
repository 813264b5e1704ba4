// Causal / sliding-window GQA flash attention (K4).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (pallas_call at :150, body _flash_kernel at :29).
// q (B,Hq,Sq,D) against k/v (B,Hkv,Skv,D); query row i sits at absolute
// position i + q_offset (the TPU kernel fixes q_offset = Skv - Sq; here it
// is a runtime argument, so chunked prefill runs this kernel too). A key at
// position p is visible to a query at position x iff p < Skv, p <= x when
// causal, and x - p < window when window > 0. Online softmax with float32
// accumulation; a row with no visible key yields 0.
//
// What bounds it on an H100: operations. Prefill does ~4*D flops per
// (query, visible key) pair against 2*D elements of K/V per key, so at
// hundreds of queries per block the work is far above the card's
// flops-per-byte balance; the floor is the bf16 tensor-core rate. This
// first version runs on the CUDA cores in float32 (no wgmma), so its
// distance to that floor is expected and recorded, not hidden. What the
// design does do:
//   * a block owns 64 query rows of one head; K/V tiles are fetched once
//     per block with 16-byte vector loads into shared memory and reused by
//     all 64 rows (GQA: kv head = h / q_per_kv);
//   * the tile loop visits only keys some row of the block can see: up to
//     the last row's position when causal, from the first row's window
//     start when windowed, so causal prefill does ~half the square;
//   * four threads share one query row, each holding a strided quarter of
//     q and of the accumulator in registers, so D = 128 fits without
//     spilling; a partial dot product is finished with two shuffles.
// Tensor-core (wgmma) tiles, TMA and warp specialisation are later work.
#include "common.cuh"

namespace {

using repro::Elem;
using repro::kNegInf;

constexpr int kRows = 64;  // query rows per block
constexpr int kQuad = 4;   // threads per query row
constexpr int kThreads = kRows * kQuad;

template <bool BF16, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const typename Elem<BF16>::T* __restrict__ q,
             const typename Elem<BF16>::T* __restrict__ k,
             const typename Elem<BF16>::T* __restrict__ v,
             typename Elem<BF16>::T* __restrict__ out,
             int Hq, int Hkv, int Sq, int Skv, int causal, int window,
             int q_offset, float scale) {
  using E = Elem<BF16>;
  constexpr int DQ = D / kQuad;  // q / accumulator elements per thread
  static_assert(BK <= 64, "visibility bits live in one 64-bit word");
  __shared__ float k_s[BK * D];
  __shared__ float v_s[BK * D];

  const int tid = threadIdx.x;
  const int row = tid / kQuad;
  const int j = tid % kQuad;  // this thread owns dims d = i*kQuad + j
  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int G = Hq / Hkv;
  const long q_base = (long)bh * Sq * D;
  const long kv_base = ((long)b * Hkv + h / G) * (long)Skv * D;
  const int q0 = blockIdx.x * kRows;
  const int qi = q0 + row;
  const bool valid = qi < Sq;
  const int qpos = qi + q_offset;

  float qr[DQ];
  float acc[DQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    qr[i] = valid ? E::load(q, q_base + (long)qi * D + i * kQuad + j) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // keys any row of this block can see
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(Sq, q0 + kRows) - 1 + q_offset;
  const int kv_end = causal ? min(Skv, qpos_hi + 1) : Skv;
  int kv_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  for (int j0 = kv_begin; j0 < kv_end; j0 += BK) {
    const int n = min(BK, Skv - j0);
    repro::load_tile<E, D>(k_s, D, k + kv_base + (long)j0 * D, n, BK);
    repro::load_tile<E, D>(v_s, D, v + kv_base + (long)j0 * D, n, BK);
    __syncthreads();

    float s[BK];
    unsigned long long vis_bits = 0ull;
    float mx = kNegInf;
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DQ; ++i) part = fmaf(qr[i], k_s[t * D + i * kQuad + j], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kv = j0 + t;
      const bool vis = kv < Skv && (!causal || qpos >= kv) &&
                       (window <= 0 || qpos - kv < window);
      s[t] = vis ? part * scale : kNegInf;
      if (vis) vis_bits |= 1ull << t;
      mx = fmaxf(mx, s[t]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      const float p = ((vis_bits >> t) & 1ull) ? expf(s[t] - m_new) : 0.f;
      s[t] = p;
      sum += p;
    }
    l = l * alpha + sum;
#pragma unroll
    for (int i = 0; i < DQ; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int t = 0; t < BK; ++t) a = fmaf(s[t], v_s[t * D + i * kQuad + j], a);
      acc[i] = a;
    }
    m = m_new;
    __syncthreads();
  }

  if (valid) {
#pragma unroll
    for (int i = 0; i < DQ; ++i)
      E::store(out, q_base + (long)qi * D + i * kQuad + j, l > 0.f ? acc[i] / l : 0.f);
  }
}

template <bool BF16, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Skv, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  constexpr int BK = D >= 128 ? 32 : 64;  // keeps s[BK] + q + acc in registers
  dim3 grid((Sq + kRows - 1) / kRows, B * Hq);
  flash_kernel<BF16, D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Skv,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D), out (B,Hq,Sq,D); all contiguous, on
// the current device, 16-byte aligned. dtype: 0 float32, 1 bfloat16.
// Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                          int D, int causal, int window, int q_offset,
                          int dtype, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hkv != 0 ||
      B * Hq > 65535)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<false, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
  if (dtype == 0 && D == 128)
    return launch<false, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
  if (dtype == 1 && D == 64)
    return launch<true, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
  if (dtype == 1 && D == 128)
    return launch<true, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
  return REPRO_BAD_ARGUMENT;
}

const char* repro_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
