// One-token GQA decode attention against a KV cache (K3).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (pallas_call at :113, body _decode_kernel at :28).
// Computes, for every sequence b and query head h, softmax over the first
// lengths[b] cached keys of kv head h / q_per_kv, applied to the values;
// float32 accumulation, output in the input dtype, 0 for a length-0 row.
//
// What bounds it on an H100: bytes. Each (b, kv head) streams 2*len*D
// elements of K and V once and does ~4*q_per_kv flops per element, far
// below the ~295 flops/byte at which bf16 tensor cores would become the
// limit. So the design is about reading each live cache row exactly once
// and nothing else:
//   * one block per (b, kv head): the q_per_kv query heads that share a KV
//     head ride along, so K/V are read once per group, never per query head;
//   * the block walks only the live prefix [0, lengths[b]) in tiles of 64
//     keys (work follows the data: a short sequence costs a short loop),
//     each tile fetched with 16-byte vector loads into shared memory;
//   * an online softmax (running max, denominator and float32 accumulator
//     per query head) keeps everything else on chip.
// At the serving shape (R*B = 16 sequences x 32 kv heads) that is 512
// blocks over 132 SMs. Split-KV across blocks and TMA/cp.async pipelining
// are later work.
#include "common.cuh"

namespace {

using repro::Elem;
using repro::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // keys per shared-memory tile (2 per lane in the softmax)
constexpr int kMaxG = 8;   // query heads per KV head

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kMaxG * D + kTile * (D + 1) + kTile * D + kMaxG * kTile + 3 * kMaxG);
}

template <bool BF16, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const typename Elem<BF16>::T* __restrict__ q,
              const typename Elem<BF16>::T* __restrict__ k,
              const typename Elem<BF16>::T* __restrict__ v,
              const int32_t* __restrict__ lengths,
              typename Elem<BF16>::T* __restrict__ out,
              int Hq, int Hkv, int S, float scale) {
  using E = Elem<BF16>;
  constexpr int KP = D + 1;  // padded K row: lanes reading one column of
                             // consecutive keys hit distinct banks
  constexpr int kOwn = kMaxG * D / kThreads;  // accumulator slots per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kMaxG][D]
  float* k_s = q_s + kMaxG * D;       // [kTile][KP]
  float* v_s = k_s + kTile * KP;      // [kTile][D]
  float* p_s = v_s + kTile * D;       // [kMaxG][kTile] scores, then weights
  float* m_s = p_s + kMaxG * kTile;   // running max per query head
  float* l_s = m_s + kMaxG;           // running denominator
  float* a_s = l_s + kMaxG;           // this tile's rescale factor

  const int G = Hq / Hkv;
  const int bh = blockIdx.x;  // b * Hkv + hkv
  const int b = bh / Hkv;
  const int hkv = bh % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int L = lengths[b];
  L = L < 0 ? 0 : (L > S ? S : L);
  const long q_base = ((long)b * Hq + (long)hkv * G) * D;  // G heads, contiguous
  const long kv_base = (long)bh * S * D;

  for (int i = tid; i < G * D; i += kThreads) q_s[i] = E::load(q, q_base + i);
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < L; j0 += kTile) {
    const int n = min(kTile, L - j0);
    repro::load_tile<E, D>(k_s, KP, k + kv_base + (long)j0 * D, n, kTile);
    repro::load_tile<E, D>(v_s, D, v + kv_base + (long)j0 * D, n, kTile);
    __syncthreads();

    // scores s[g][t] = (q_g . k_t) * scale for the n live keys
    for (int idx = tid; idx < G * kTile; idx += kThreads) {
      const int g = idx / kTile;
      const int t = idx % kTile;
      if (t < n) {
        const float* qq = q_s + g * D;
        const float* kk = k_s + t * KP;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qq[d], kk[d], dot);
        p_s[g * kTile + t] = dot * scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, two keys per lane
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * kTile;
      const bool live0 = lane < n;
      const bool live1 = lane + 32 < n;
      const float s0 = live0 ? pg[lane] : kNegInf;
      const float s1 = live1 ? pg[lane + 32] : kNegInf;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = live0 ? expf(s0 - m_new) : 0.f;
      const float p1 = live1 ? expf(s1 - m_new) : 0.f;
      if (live0) pg[lane] = p0;
      if (live1) pg[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc[g][d] * alpha_g + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * D) {
        const int g = e / D;
        const int d = e % D;
        const float* pg = p_s + g * kTile;
        float a = acc[i] * a_s[g];
        for (int t = 0; t < n; ++t) a = fmaf(pg[t], v_s[t * D + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) {
      const float l = l_s[e / D];
      E::store(out, q_base + e, l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <bool BF16, int D>
int launch(const void* q, const void* k, const void* v, const int32_t* lengths,
           void* out, int B, int Hq, int Hkv, int S, float scale,
           cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = decode_kernel<BF16, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), Hq, Hkv, S,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Hq,D), k/v (B,Hkv,S,D), lengths (B,) int32, out (B,Hq,D); all
// contiguous, on the current device, 16-byte aligned. dtype: 0 float32,
// 1 bfloat16. Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const int32_t* lengths, void* out, int B, int Hq,
                           int Hkv, int S, int D, int dtype, float scale,
                           void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<false, 64>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, st);
  if (dtype == 0 && D == 128) return launch<false, 128>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, st);
  if (dtype == 1 && D == 64) return launch<true, 64>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, st);
  if (dtype == 1 && D == 128) return launch<true, 128>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, st);
  return REPRO_BAD_ARGUMENT;
}

const char* repro_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
