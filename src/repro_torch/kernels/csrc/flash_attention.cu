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
// flops-per-byte balance; the floor is the bf16 tensor-core rate. Both
// variants share the schedule: a block owns 64 query rows of one head
// (GQA: kv head = h / q_per_kv), fetches each 64-key K/V tile once for
// all 64 rows, and visits only keys some row of the block can see (up to
// the last row's position when causal, from the first row's window start
// when windowed), so causal prefill does ~half the square. The wrapper
// picks the variant from dtype and head dim before the launch, never as
// a fallback:
//
// * wgmma (bf16, D = 64, 128 or 256). One consumer warpgroup and one producer
//   warp. The producer loads the Q tile once, then K/V tiles through a
//   2-stage mbarrier ring, all by TMA over 3-D maps (B*H, S, D), so rows
//   past Sq or Skv read zeros (no stale NaN meets a zero weight).
//   S = Q K^T is m64n64k16 with Q and K (K-major) from shared memory; the
//   online softmax runs on the float32 accumulator fragments, row max and
//   sum by quad shuffles, with element masks only on tiles that cross the
//   diagonal, the window edge or Skv. P is rounded to bf16 in registers and
//   is the register A operand of O += P V (m64nDk16, V MN-major through the
//   transpose bit; at D = 256 two m64n128k16 halves, boxes 0-1 and 2-3 of V,
//   into the two halves of a 128-float accumulator): the accumulator of one
//   product is the A fragment of the next (sm90.cuh). At D = 256 a stage of
//   K and V is 64 KB and Q 32 KB: ~161 KB of shared memory with 2 stages.
//   That rounding of P to the value dtype is the Pallas kernel's own
//   (flash_attention.py:70). Query tiles are launched latest first, so the
//   longest causal rows start first.
// * CUDA cores (float32, and bf16 at D = 112, whose 224-byte rows are not
//   whole 128-byte swizzle rows). Four threads share one query row, each
//   holding a strided quarter of q and of the accumulator in registers;
//   K/V tiles are widened to float32 in (static) shared memory by 16-byte
//   vector loads, BK keys at a time, BK shrinking as D grows (64 keys at
//   D = 64, 32 at 112 and 128, 16 at 256) so the two tiles stay within 48 KB
//   and s[BK] + q + acc within registers; a partial dot product is finished
//   with two shuffles.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::Elem;
using repro::kNegInf;
namespace sm90 = repro::sm90;

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
  // keys per tile: 2 * BK * D floats of static shared memory (<= 48 KB) and
  // s[BK] + q + acc (BK + D / 2 floats) in registers
  constexpr int BK = D > 128 ? 16 : (D > 64 ? 32 : 64);
  dim3 grid((Sq + kRows - 1) / kRows, B * Hq);
  flash_kernel<BF16, D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Skv,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------- wgmma
namespace tc {
constexpr int kRows = 64;            // query rows per block (one warpgroup)
constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kStages = 2;
constexpr int kThreads = 128 + 32;   // consumer warpgroup + producer warp
constexpr int kBox = 64 * 64 * 2;    // one TMA box {64, 64, 1} of bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kBoxes = D / 64;           // boxes across the head dim
  static constexpr int kTile = kBoxes * kBox;     // Q, K or V tile
  static constexpr int kStage = 2 * kTile;        // K then V
  static constexpr int kBytes = kTile + kStages * kStage + (1 + 2 * kStages) * 8 +
                                sm90::kAtomBytes;
};

// O (64 x D) += P (k16 slice kk, registers) V (slice kk of the tile at v_s).
// D = 256 is two m64n128k16 products, V's boxes 0-1 into o[0..63] and boxes
// 2-3 into o[64..127]: the accumulator of n128 covers columns 8j + ... in
// d[4j + ...], so the two halves are laid out as one n256 accumulator.
template <int D>
__device__ __forceinline__ void mma_sv(float (&o)[D / 2], const uint32_t (&a)[4], const char* v_s,
                                       int kk) {
  if constexpr (D == 64) {
    sm90::wgmma_m64n64k16_rs<1>(o, a, sm90::desc_mn_major(v_s, kk, kBox), 1);
  } else {
#pragma unroll
    for (int h = 0; h < D / 128; ++h)
      sm90::wgmma_m64n128k16_rs<1>(*reinterpret_cast<float(*)[64]>(o + 64 * h), a,
                                   sm90::desc_mn_major(v_s + 2 * h * kBox, kk, kBox), 1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map, uint16_t* __restrict__ out, int Hq,
            int Hkv, int Sq, int Skv, int causal, int window, int q_offset, float scale_log2) {
  using S = tc::Smem<D>;
  extern __shared__ char smem_raw[];
  char* q_s = sm90::align_atom(smem_raw);
  char* kv_s = q_s + S::kTile;  // stage s: K at kv_s + s * kStage, V right after
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + tc::kStages * S::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + tc::kStages;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < tc::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int bh = blockIdx.y;  // b * Hq + h
  const int bkv = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tc::kRows;
  // keys any row of this block can see
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(Sq, q0 + tc::kRows) - 1 + q_offset;
  const int kv_end = causal ? min(Skv, qpos_hi + 1) : Skv;
  const int kv_begin = (window > 0 ? max(0, qpos_lo - window + 1) : 0) / tc::kKeys * tc::kKeys;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + tc::kKeys - 1) / tc::kKeys : 0;

  if (threadIdx.x / 32 == 4) {  // producer
    if (threadIdx.x % 32 == 0) {
      sm90::mbar_arrive_expect_tx(q_full, S::kTile);
      for (int i = 0; i < S::kBoxes; ++i)
        sm90::tma_load_3d(q_s + i * tc::kBox, &q_map, q_full, 64 * i, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % tc::kStages;
        if (t >= tc::kStages) sm90::mbar_wait(&empty[s], ((t / tc::kStages) - 1) & 1);
        char* k_s = kv_s + s * S::kStage;
        const int j0 = kv_begin + t * tc::kKeys;
        sm90::mbar_arrive_expect_tx(&full[s], S::kStage);
        for (int i = 0; i < S::kBoxes; ++i) {
          sm90::tma_load_3d(k_s + i * tc::kBox, &k_map, &full[s], 64 * i, j0, bkv);
          sm90::tma_load_3d(k_s + S::kTile + i * tc::kBox, &v_map, &full[s], 64 * i, j0, bkv);
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread holds rows r and r + 8 of the tile
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r = (tid / 32) * 16 + lane / 4;
  const int qpos[2] = {q0 + r + q_offset, q0 + r + 8 + q_offset};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {repro::kNegInf, repro::kNegInf};
  float l[2] = {0.f, 0.f};
  sm90::mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % tc::kStages;
    const int j0 = kv_begin + t * tc::kKeys;
    const char* k_s = kv_s + s * S::kStage;
    const char* v_s = k_s + S::kTile;
    sm90::mbar_wait(&full[s], (t / tc::kStages) & 1);

    float sc[32];  // S = Q K^T: rows r, r + 8 x this thread's 16 keys
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = (kk / 4) * tc::kBox;
      sm90::wgmma_m64n64k16_ss<0>(sc, sm90::desc_k_major(q_s + box, kk % 4),
                                  sm90::desc_k_major(k_s + box, kk % 4), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    const bool whole = j0 + tc::kKeys <= Skv && (!causal || j0 + tc::kKeys - 1 <= qpos_lo) &&
                       (window <= 0 || qpos_hi - j0 < window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kv = j0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int qp = qpos[(i / 2) % 2];
        const bool vis = kv < Skv && (!causal || kv <= qp) && (window <= 0 || qp - kv < window);
        if (!vis) sc[i] = repro::kNegInf;
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = repro::kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      const float m_new = fmaxf(m[h], tc::quad_max(mx));
      alpha[h] = exp2f((m[h] - m_new) * scale_log2);
      // every key of this row so far is masked: p = 0 (masked scores sit at
      // kNegInf, so any visible one makes m_new larger)
      const bool dead = m_new == repro::kNegInf;
      const float ms = m_new * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = dead ? 0.f : exp2f(fmaf(x, scale_log2, -ms));
          sum += x;
        }
      }
      l[h] = l[h] * alpha[h] + sum;
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    uint32_t pa[4][4];  // P in bf16: the A fragments of the four k16 slices
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = sm90::pack_bf16x2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::mma_sv<D>(o, pa[kk], v_s, kk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    if (tid == 0) sm90::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = tc::quad_sum(l[h]);
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    const int qi = q0 + r + 8 * h;
    if (qi >= Sq) continue;
    uint16_t* row = out + ((long)bh * Sq + qi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * (lane % 4)) =
          sm90::pack_bf16x2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
                 int Sq, int Skv, int causal, int window, int q_offset, float scale,
                 cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  const uint32_t box[3] = {64, 64, 1};
  const uint64_t q_dims[3] = {(uint64_t)D, (uint64_t)Sq, (uint64_t)B * Hq};
  const uint64_t q_strides[2] = {(uint64_t)D * 2, (uint64_t)Sq * D * 2};
  const uint64_t kv_dims[3] = {(uint64_t)D, (uint64_t)Skv, (uint64_t)B * Hkv};
  const uint64_t kv_strides[2] = {(uint64_t)D * 2, (uint64_t)Skv * D * 2};
  if (sm90::make_tensor_map(&q_map, q, 3, q_dims, q_strides, box) != 0 ||
      sm90::make_tensor_map(&k_map, k, 3, kv_dims, kv_strides, box) != 0 ||
      sm90::make_tensor_map(&v_map, v, 3, kv_dims, kv_strides, box) != 0)
    return REPRO_BAD_ARGUMENT;
  const cudaError_t e = sm90::allow_dynamic_smem(flash_wgmma<D>, tc::Smem<D>::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + tc::kRows - 1) / tc::kRows, B * Hq);
  flash_wgmma<D><<<grid, tc::kThreads, tc::Smem<D>::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<uint16_t*>(out), Hq, Hkv, Sq, Skv, causal, window,
      q_offset, scale * tc::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D), out (B,Hq,Sq,D); all contiguous, on
// the current device, 16-byte aligned. dtype: 0 float32, 1 bfloat16.
// variant: 0 CUDA cores, 1 wgmma (bf16 only). Returns 0, a cudaError_t, or
// REPRO_BAD_ARGUMENT.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                          int D, int causal, int window, int q_offset,
                          int dtype, int variant, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hkv != 0 ||
      B * Hq > 65535)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype == 1 && D == 64)
      return launch_wgmma<64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
    if (dtype == 1 && D == 128)
      return launch_wgmma<128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
    if (dtype == 1 && D == 256)
      return launch_wgmma<256>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
    return REPRO_BAD_ARGUMENT;
  }
  if (variant != 0) return REPRO_BAD_ARGUMENT;
#define REPRO_CUDA_CORE(BF16, DIM)                                                                \
  if (dtype == (BF16 ? 1 : 0) && D == DIM)                                                        \
    return launch<BF16, DIM>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
  REPRO_CUDA_CORE(false, 64)
  REPRO_CUDA_CORE(false, 112)
  REPRO_CUDA_CORE(false, 128)
  REPRO_CUDA_CORE(false, 256)
  REPRO_CUDA_CORE(true, 64)
  REPRO_CUDA_CORE(true, 112)
  REPRO_CUDA_CORE(true, 128)
  REPRO_CUDA_CORE(true, 256)
#undef REPRO_CUDA_CORE
  return REPRO_BAD_ARGUMENT;
}

// Dynamic shared memory the wgmma variant asks for at head dim D, in bytes
// (0 for a head dim it does not take).
int repro_flash_attention_smem(int D) {
  return D == 64    ? tc::Smem<64>::kBytes
         : D == 128 ? tc::Smem<128>::kBytes
         : D == 256 ? tc::Smem<256>::kBytes
                    : 0;
}

const char* repro_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
