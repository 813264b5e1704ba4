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
//   M     = (C B^T) o exp(cum_l - cum_m), zero above the diagonal   (kL x kL)
//   y     = M xbar + exp(cum) o (C S_0^T)
//   S_out = exp(cum_last) S_0 + (exp(cum_last - cum) o xbar)^T B.
// The chunked form equals the recurrence up to rounding.
//
// What bounds it on an H100: xh, y, dt, B, C and the state in and out are
// ~18.7 MB at zamba2's 512-token piece (5.6 us at 3.35 TB/s); the
// recurrence's 4 P N operations a head and step are ~0.94 GFLOP there (14 us
// at the CUDA cores' 67 TFLOP/s; 3.8 us as two-pass TF32 products on the
// tensor cores, 5.7 us as 3xTF32). The chunked
// form does about 5x those, as four products a chunk, and one block walks a
// head's chunks in series: a kernel is bounded by where those products run
// and by the instructions and latency each chunk puts on its chain. Two
// kernels, one grid (a block of 256 threads per (sequence, head, kPS = 32
// channels): zamba2's one-sequence prefill is 224 blocks, one wave at two
// blocks an SM):
//
// `cuda_core` (the first, kept as the prior; picked by no rule): all four
// products as float32 FMAs on CUDA cores from float32 copies in shared
// memory, four barriers a chunk, each chunk's loads at its top. Its inner
// loops are shared-memory bound and every load latency sits on the chain.
//
// `mma` (the main path): every product on the tensor cores through mma.sync
// with float32 accumulators, the next chunk staged while the current one
// computes, one block-wide barrier a chunk.
//   * Precision. B and C in bf16 (every served model): the Gram C B^T is one
//     bf16 m16n8k16 product (exact products, float32 sums). Every product
//     with a float32 operand (the decay-weighted M, the carried state, the
//     weighted xbar of the state update; B and C and x too in a float32
//     model) is split 3xTF32: v = big + small with big = v rounded to TF32
//     (to nearest, ties away, as cvt.rna rounds; by adding half an ulp to the
//     bits and clearing the low 13, three instructions for the split where
//     two cvt.rna take eight) and small = v - big (exact; the tensor core
//     reads its top 19 bits), and a b = a_small b_big + a_big b_small +
//     a_big b_big on m16n8k8 (a_small b_small dropped, at most 2^-22 of
//     |a b|), within the float32 check. A bf16 operand is exact in TF32 and has no
//     small part, so in a bf16 model a product with one takes two passes:
//     C S_0^T, the state update against B, and M xbar taken as (M o dt) x.
//     No single-pass TF32 product (it keeps ~11 bits: off the float32 check
//     by 3-4x, tests/test_torch_kernels_ssd.py). The exponentials of M are
//     ex2.approx (__expf), ~2e-6 relative where an entry is above e^-20.
//   * Fragments (g = lane / 4, t = lane % 4). m16n8k8 TF32: A a0 (row g, k
//     t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, col g),
//     b1 (k t + 4, g); the accumulator c0, c1 (row g, cols 2t, 2t + 1), c2, c3
//     (row g + 8, the same cols). The sum over k is order-free, so every TF32
//     product here takes k position t as reduction index k0 + 2t and t + 4
//     as k0 + 2t + 1 ("pair order"). Then the Gram's accumulator tile over
//     columns m0..m0+7 is, as it stands, the A fragment of M's k slice m0
//     (a0 = c0, a1 = c2, a2 = c1, a3 = c3): M never leaves registers. In pair
//     order a bf16 m16n8k16 A fragment of C (words a0..a3 = rows g, g + 8 at
//     cols 2t, 2t + 8) holds the TF32 A fragments of k slices 2kk (a0, a1)
//     and 2kk + 1 (a2, a3) as the widened low and high halves: C S_0^T reuses
//     the Gram's C fragments. Operands in shared memory are read in pair
//     order as one word (a bf16 pair) or one float2, or as two scalars of
//     rows 2t and 2t + 1, at row strides that put a warp's reads on distinct
//     banks (bf16; a float32 model's B loads of the state update conflict
//     two-way).
//   * Warps. Warps 0-3 ("y warps") take a strip of kTile rows each, all kPS
//     channels: its Gram tiles at and below the diagonal, two 8-column tiles
//     at a time so that their chains interleave, each turned into M o dt in
//     registers and applied to x at once; then y = y_i + exp(cum) y_c.
//     Warps 4-7 ("state warps") first form y_c = C S_0^T of strip w - 4 and
//     hand it to that strip's y warp through shared memory (named barrier 1 +
//     strip: bar.arrive here, bar.sync there, so neither waits on the other
//     before it has to), then update a 16 x 32 tile of the state, kept in
//     registers across chunks. The strip of rows 48-63 does four column
//     pairs where the first does one: the y warps are the chain (warps of
//     the two blocks on an SM share its four sub-partitions). Only the
//     chunk's valid rows are computed: a strip past S is skipped and the
//     state update stops at the last valid 8 steps; a 1- to 16-token piece is
//     one strip.
//   * Staging. Chunk c + 1's B, C, x and dt are copied by cp.async into the
//     other half of a two-chunk ring while chunk c computes; rows past S are
//     zero-filled, S is not padded in memory. During chunk c, warp 4
//     (kScanWarp) forms chunk c + 1's prefix sums of a by shuffles into the
//     other half of Cum, which every warp reads after the next barrier; each
//     warp forms the exponentials it needs itself. The state
//     tiles go to shared memory each chunk, double-buffered, for the next
//     chunk's C S_0^T. So one block-wide barrier a chunk, at its top: the
//     chunk's copies landed, the last chunk's state written, the buffers the
//     next copies overwrite read. No scratch, no atomics: two launches give
//     the same bits.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::Elem;

constexpr int kL = 64;         // steps a chunk: the wrapper's ``CHUNK``
constexpr int kN = 64;         // state size N (zamba2's)
constexpr int kPS = 32;        // channels of P a block takes: the wrapper's ``P_SLICE``

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

// ---------------------------------------------------------------- cuda_core
namespace cuda_core {

constexpr int kThreads = 256;
constexpr int kNS = kN + 4;    // row stride of B, C and the state in shared memory
constexpr int kMS = kL + 1;    // row stride of M
constexpr int kSmemFloats = 2 * kL * kNS + kL * kPS + kL * kMS + kPS * kNS + 4 * kL;
constexpr int kSmemBytes = kSmemFloats * 4;

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

}  // namespace cuda_core

// ---------------------------------------------------------------- mma
namespace mma {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 16;      // rows of a warp's strip of the chunk (m16)
constexpr int kRowS = 72;      // floats a row of the state tile in shared memory (N + 8)
constexpr int kYcFloats = 4 * 4 * 32;  // a strip's y_c: 4 channel tiles of 4 floats a lane
constexpr int kSmemBf16 = 74752;   // Layout<true>::kBytes: three blocks an SM by shared memory
constexpr int kSmemF32 = 115712;   // Layout<false>::kBytes: two blocks an SM, to the byte

// One block's shared memory: a two-chunk ring of the raw inputs (C, B, x,
// dt; rows past S zero), the state tile written at the end of each chunk
// (double-buffered), and each strip's y_c from its state warp.
template <bool BF16>
struct Layout {
  static constexpr int kE = BF16 ? 2 : 4;                  // bytes an element
  static constexpr int kRowBC = BF16 ? kN + 8 : kN + 4;    // elements a row of B and C
  static constexpr int kRowX = BF16 ? kPS + 8 : kPS + 4;   // elements a row of x
  static constexpr int kBC = kL * kRowBC * kE;             // bytes of a chunk of B (or C)
  static constexpr int kX = kL * kRowX * kE;
  static constexpr int kStage = 2 * kBC + kX + kL * 4;     // C, B, x, dt of one chunk
  static constexpr int kS = kPS * kRowS * 4;
  static constexpr int kYc = kL / kTile * kYcFloats * 4;   // every strip's y_c
  static constexpr int kCum = 2 * kL * 4;                  // the prefix sums of a, two chunks
  static constexpr int kBytes = 2 * kStage + 2 * kS + kYc + kCum;
};
static_assert(Layout<true>::kBytes == kSmemBf16 && Layout<false>::kBytes == kSmemF32,
              "the wrapper's scan_smem_bytes mirrors these");
static_assert(Layout<true>::kStage % 16 == 0 && Layout<false>::kStage % 16 == 0 &&
                  Layout<true>::kX % 16 == 0 && Layout<false>::kX % 16 == 0,
              "every staged row and buffer starts 16-byte aligned");

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(repro::sm90::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(repro::sm90::smem_addr(p)));
}

// d (16 x 8) += a (16 x 16, bf16) b (16 x 8, bf16), float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8) += a (16 x 8, TF32) b (8 x 8, TF32), float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A float32 operand split for 3xTF32: v = big + small. big is v rounded to
// TF32 as cvt.rna rounds a finite value (to nearest, ties away from zero:
// half an ulp added to the magnitude's bits, the low 13 bits cleared), in
// three instructions where cvt.rna takes four (and eight for the pair);
// small = v - big is exact, and the tensor core reads it as TF32 (its low
// 13 bits ignored).
struct Split {
  uint32_t big, small;
};
__device__ __forceinline__ Split split(float v) {
  const uint32_t b = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  return {b, __float_as_uint(v - __uint_as_float(b))};
}
template <int K>
__device__ __forceinline__ void split(const float (&v)[K], uint32_t (&big)[K],
                                      uint32_t (&small)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const Split s = split(v[i]);
    big[i] = s.big;
    small[i] = s.small;
  }
}

// d += a b in 3xTF32: a_small b_big + a_big b_small + a_big b_big.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], Split b0, Split b1) {
  mma_tf32(d, as, b0.big, b1.big);
  mma_tf32(d, ab, b0.small, b1.small);
  mma_tf32(d, ab, b0.big, b1.big);
}
// d += a b with a exact in TF32 (a widened bf16): a b_small + a b_big.
__device__ __forceinline__ void mma2_a(float (&d)[4], const uint32_t (&a)[4], Split b0,
                                       Split b1) {
  mma_tf32(d, a, b0.small, b1.small);
  mma_tf32(d, a, b0.big, b1.big);
}
// d += a b with b exact in TF32: a_small b + a_big b.
__device__ __forceinline__ void mma2_b(float (&d)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], float b0, float b1) {
  mma_tf32(d, as, __float_as_uint(b0), __float_as_uint(b1));
  mma_tf32(d, ab, __float_as_uint(b0), __float_as_uint(b1));
}

// Elements i and i + 1 (i even) of a row in shared memory, as float32.
template <bool BF16>
__device__ __forceinline__ float2 ld_pair(const typename Elem<BF16>::T* p) {
  if constexpr (BF16) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float2*>(p);
  }
}
template <bool BF16>
__device__ __forceinline__ float ld1(const typename Elem<BF16>::T* p) {
  return Elem<BF16>::load(p, 0);
}

// Step i (0..63) of a per-step value that lane j holds as lo (step j) and
// hi (step j + 32); `upper` (i >= 32) is the same in every lane.
__device__ __forceinline__ float step_value(float lo, float hi, bool upper, int i) {
  return __shfl_sync(0xffffffffu, upper ? hi : lo, i & 31);
}

// The warp that forms each chunk's prefix sums of a (a state warp: the one
// whose strip's y_c is lightest to wait for).
constexpr int kScanWarp = 4;

// cum[i] = sum_{j<=i} A dt_{c0+j} over a chunk (a zero past S), by one warp
// (lane j holding steps j and j + 32), read from dt in device memory.
__device__ __forceinline__ void prefix_sum(float* cum, const float* dtg, float Ah, int c0, int S,
                                           int H, int lane) {
  float lo = c0 + lane < S ? __fmul_rn(__ldg(dtg + (long long)(c0 + lane) * H), Ah) : 0.f;
  float hi =
      c0 + lane + 32 < S ? __fmul_rn(__ldg(dtg + (long long)(c0 + lane + 32) * H), Ah) : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, lo, o);
    const float u1 = __shfl_up_sync(0xffffffffu, hi, o);
    if (lane >= o) {
      lo += u0;
      hi += u1;
    }
  }
  hi += __shfl_sync(0xffffffffu, lo, 31);
  cum[lane] = lo;
  cum[lane + 32] = hi;
}

// Copy one chunk (rows c0.. of B, C, x and dt) into a stage of the ring, as
// cp.async groups of this thread; rows past S are zero-filled.
template <bool BF16>
__device__ __forceinline__ void stage_chunk(uint8_t* st, const typename Elem<BF16>::T* Cg,
                                            const typename Elem<BF16>::T* Bg,
                                            const typename Elem<BF16>::T* xg,
                                            const float* dtg, int c0, int S, int H, int P) {
  using T = typename Elem<BF16>::T;
  using Lay = Layout<BF16>;
  constexpr int kRowBC = Lay::kRowBC;
  constexpr int kV = 16 / Lay::kE;           // elements a 16-byte copy
  constexpr int kRowVecs = kN / kV;          // copies a row of B or C
  constexpr int kXVecs = kPS / kV;           // copies a row of x
  T* Cs = reinterpret_cast<T*>(st);
  T* Bs = reinterpret_cast<T*>(st + Lay::kBC);
  T* Xs = reinterpret_cast<T*>(st + 2 * Lay::kBC);
  float* Ds = reinterpret_cast<float*>(st + 2 * Lay::kBC + Lay::kX);
  for (int i = threadIdx.x; i < kL * kRowVecs; i += kThreads) {
    const int row = i / kRowVecs, col = (i % kRowVecs) * kV;
    const bool ok = c0 + row < S;
    const long long src = (ok ? (long long)(c0 + row) * kN : 0) + col;
    repro::sm90::cp_async16(Cs + row * kRowBC + col, Cg + src, ok);
    repro::sm90::cp_async16(Bs + row * kRowBC + col, Bg + src, ok);
  }
  for (int i = threadIdx.x; i < kL * kXVecs; i += kThreads) {
    const int row = i / kXVecs, col = (i % kXVecs) * kV;
    const bool ok = c0 + row < S;
    repro::sm90::cp_async16(Xs + row * Lay::kRowX + col,
                            xg + (ok ? (long long)(c0 + row) * H * P : 0) + col, ok);
  }
  for (int i = threadIdx.x; i < kL; i += kThreads) {
    const bool ok = c0 + i < S;
    cp_async4(Ds + i, dtg + (ok ? (long long)(c0 + i) * H : 0), ok);
  }
}

// A strip's C (rows l0 .. l0 + 15) as bf16 m16n8k16 A fragments of its four
// k16 slices.
template <bool BF16>
__device__ __forceinline__ void load_c_fragments(uint32_t (&cf)[4][4],
                                                 const typename Elem<BF16>::T* Cs, int l0,
                                                 int lane) {
  if constexpr (BF16) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(cf[kk], Cs + (l0 + (lane & 15)) * Layout<BF16>::kRowBC + 16 * kk +
                              8 * (lane >> 4));
  }
}

// y_c = C S^T for a strip (rows l0 .., all kPS channels: yc[q] channels 8q
// ..), S the state tile in shared memory (kPS x N, rows of kRowS).
template <bool BF16>
__device__ __forceinline__ void carried_product(float (&yc)[4][4], const uint32_t (&cf)[4][4],
                                                const typename Elem<BF16>::T* Cs,
                                                const float* Sprev, int l0, int g, int t) {
  constexpr int kRowBC = Layout<BF16>::kRowBC;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t ab[4], as[4];
    if constexpr (BF16) {  // exact in TF32: k slice k of the bf16 fragments, in pair order
      const uint32_t w0 = cf[k >> 1][2 * (k & 1)], w1 = cf[k >> 1][2 * (k & 1) + 1];
      ab[0] = w0 << 16;
      ab[1] = w1 << 16;
      ab[2] = w0 & 0xffff0000u;
      ab[3] = w1 & 0xffff0000u;
    } else {
      const float2 c_lo = ld_pair<BF16>(Cs + (l0 + g) * kRowBC + 8 * k + 2 * t);
      const float2 c_hi = ld_pair<BF16>(Cs + (l0 + g + 8) * kRowBC + 8 * k + 2 * t);
      const float av[4] = {c_lo.x, c_hi.x, c_lo.y, c_hi.y};
      split(av, ab, as);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 sv =
          *reinterpret_cast<const float2*>(Sprev + (8 * q + g) * kRowS + 8 * k + 2 * t);
      if constexpr (BF16) {
        mma2_a(yc[q], ab, split(sv.x), split(sv.y));
      } else {
        mma3(yc[q], ab, as, split(sv.x), split(sv.y));
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(const Args a) {
  using T = typename Elem<BF16>::T;
  using Lay = Layout<BF16>;
  constexpr int kRowBC = Lay::kRowBC, kRowX = Lay::kRowX;
  extern __shared__ __align__(16) uint8_t ssd_smem[];
  uint8_t* smem = ssd_smem;
  float* Sbuf = reinterpret_cast<float*>(smem + 2 * Lay::kStage);  // [2][kPS][kRowS]
  float* Ycs = Sbuf + 2 * kPS * kRowS;                              // [strip][kYcFloats]
  float* Cum = Ycs + kL / kTile * kYcFloats;                        // [2][kL]

  const int nps = a.P / kPS;
  const int ps = blockIdx.x % nps;
  const int h = (blockIdx.x / nps) % a.H;
  const int b = blockIdx.x / (nps * a.H);
  const int p0 = ps * kPS;
  const int S = a.S, H = a.H, P = a.P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warps 0-3 ("y warps"): M and y of the strip of kTile rows `warp`, all
  // kPS channels; warps 4-7 ("state warps"): y_c = C S^T of strip warp - 4,
  // handed to its y warp through shared memory, then the state tile of rows
  // (channels) sr0 .. sr0 + 15 and columns sn0 .. sn0 + 31
  const bool y_warp = warp < 4;
  const int strip = warp & 3;
  const int sr0 = 16 * (warp & 1), sn0 = 32 * ((warp >> 1) & 1);
  const float Ah = __ldg(a.A + h);

  const T* Cg = static_cast<const T*>(a.Cm) + (long long)b * S * kN;
  const T* Bg = static_cast<const T*>(a.Bm) + (long long)b * S * kN;
  const T* xg = static_cast<const T*>(a.xh) + ((long long)b * S * H + h) * P + p0;
  const float* dtg = a.dt + (long long)b * S * H + h;
  T* y = static_cast<T*>(a.y);
  const long long state0 = (((long long)b * H + h) * P + p0) * kN;  // the slice's first element

  const int nchunks = (S + kL - 1) / kL;
  stage_chunk<BF16>(smem, Cg, Bg, xg, dtg, 0, S, H, P);
  repro::sm90::cp_async_commit();
  if (warp == kScanWarp) prefix_sum(Cum, dtg, Ah, 0, S, H, lane);

  // A state warp's tile: sa[j] holds rows sr0 + g (+ 8), columns sn0 + 8j +
  // 2t (+ 1), as an accumulator; the state entering chunk 0 also goes to
  // Sbuf[1], which chunk 0's C S_0^T reads.
  float sa[4][4];
  if (!y_warp) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = sr0 + g + 8 * hf, col = sn0 + 8 * j + 2 * t;
        const float2 v =
            a.s0 ? __ldg(reinterpret_cast<const float2*>(a.s0 + state0 + r * kN + col))
                 : make_float2(0.f, 0.f);
        sa[j][2 * hf] = v.x;
        sa[j][2 * hf + 1] = v.y;
        *reinterpret_cast<float2*>(Sbuf + kPS * kRowS + r * kRowS + col) = v;
      }
    }
  }

  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * kL, valid = min(kL, S - c0), buf = c & 1;
    repro::sm90::cp_async_wait<0>();
    __syncthreads();  // chunk c landed; the last chunk's state is written and its stage read
    if (c + 1 < nchunks)
      stage_chunk<BF16>(smem + (buf ^ 1) * Lay::kStage, Cg, Bg, xg, dtg, c0 + kL, S, H, P);
    repro::sm90::cp_async_commit();

    const uint8_t* st = smem + buf * Lay::kStage;
    const T* Cs = reinterpret_cast<const T*>(st);
    const T* Bs = reinterpret_cast<const T*>(st + Lay::kBC);
    const T* Xs = reinterpret_cast<const T*>(st + 2 * Lay::kBC);
    const float* Ds = reinterpret_cast<const float*>(st + 2 * Lay::kBC + Lay::kX);
    const int l0 = kTile * strip;
    // the strip's rows are below S, and a state enters the chunk: its y_c
    // goes from the state warp to the y warp (named barrier 1 + strip)
    const bool strip_live = l0 < valid, carried = c > 0 || a.s0;

    // the prefix sums of a = A dt over the chunk, which the scan warp wrote
    // during the last chunk; it now writes the next chunk's
    const float* cum = Cum + buf * kL;
    const float last = cum[kL - 1];
    if (warp == kScanWarp && c + 1 < nchunks)
      prefix_sum(Cum + (buf ^ 1) * kL, dtg, Ah, c0 + kL, S, H, lane);

    if (y_warp) {
      if (!strip_live) continue;
      const float cl0 = cum[l0 + g], cl1 = cum[l0 + g + 8];
      uint32_t cf[4][4];
      load_c_fragments<BF16>(cf, Cs, l0, lane);
      // y_i = M xbar = (M o dt) x over pairs of 8-column tiles at and below
      // the diagonal, two tiles at a time so that their chains interleave;
      // a tile past S reads zero rows
      float yi[4][4] = {};
      const int pmax = min(strip, (valid - 1) >> 4);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (pp > pmax) break;
        float gt[2][4] = {};  // G = C B^T over columns 16 pp + 8 u ..
        if constexpr (BF16) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t bf[4];  // b0, b1 of tile 2 pp, then of tile 2 pp + 1
            ldmatrix_x4(bf, Bs + (16 * pp + (lane & 7) + 8 * (lane >> 4)) * kRowBC + 16 * kk +
                                8 * ((lane >> 3) & 1));
            mma_bf16(gt[0], cf[kk], bf[0], bf[1]);
            mma_bf16(gt[1], cf[kk], bf[2], bf[3]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float2 c_lo = ld_pair<BF16>(Cs + (l0 + g) * kRowBC + 8 * k + 2 * t);
            const float2 c_hi = ld_pair<BF16>(Cs + (l0 + g + 8) * kRowBC + 8 * k + 2 * t);
            const float av[4] = {c_lo.x, c_hi.x, c_lo.y, c_hi.y};
            uint32_t ab[4], as[4];
            split(av, ab, as);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float2 bv = ld_pair<BF16>(Bs + (16 * pp + 8 * u + g) * kRowBC + 8 * k + 2 * t);
              mma3(gt[u], ab, as, split(bv.x), split(bv.y));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          // M dt = G o exp(cum_l - cum_m) dt_m at and below the diagonal, as
          // the A fragment of k slice m0 in pair order
          const int m = 16 * pp + 8 * u + 2 * t, l = l0 + g;
          const float cm0 = cum[m], cm1 = cum[m + 1], dt0 = Ds[m], dt1 = Ds[m + 1];
          const float mv[4] = {
              m <= l ? gt[u][0] * __expf(cl0 - cm0) * dt0 : 0.f,
              m <= l + 8 ? gt[u][2] * __expf(cl1 - cm0) * dt0 : 0.f,
              m + 1 <= l ? gt[u][1] * __expf(cl0 - cm1) * dt1 : 0.f,
              m + 1 <= l + 8 ? gt[u][3] * __expf(cl1 - cm1) * dt1 : 0.f};
          uint32_t mb[4], ms[4];
          split(mv, mb, ms);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float x0 = ld1<BF16>(Xs + m * kRowX + 8 * q + g);
            const float x1 = ld1<BF16>(Xs + (m + 1) * kRowX + 8 * q + g);
            if constexpr (BF16) {
              mma2_b(yi[q], mb, ms, x0, x1);
            } else {
              mma3(yi[q], mb, ms, split(x0), split(x1));
            }
          }
        }
      }
      // y = y_i + exp(cum_l) y_c, y_c from the state warp; rows below S
      float yc[4][4] = {};
      if (carried) {
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + strip) : "memory");
        const float* from = Ycs + strip * kYcFloats;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(from + (q * 32 + lane) * 4);
          yc[q][0] = v.x;
          yc[q][1] = v.y;
          yc[q][2] = v.z;
          yc[q][3] = v.w;
        }
      }
      const float e0 = expf(cl0), e1 = expf(cl1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = l0 + g + 8 * hf;
        if (row >= valid) continue;
        const float e = hf ? e1 : e0;
        T* out = y + (((long long)b * S + c0 + row) * H + h) * P + p0 + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v0 = __fadd_rn(yi[q][2 * hf], __fmul_rn(e, yc[q][2 * hf]));
          const float v1 = __fadd_rn(yi[q][2 * hf + 1], __fmul_rn(e, yc[q][2 * hf + 1]));
          if constexpr (BF16) {
            const uint32_t w = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v0)) |
                               ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v1)) << 16);
            *reinterpret_cast<uint32_t*>(out + 8 * q) = w;
          } else {
            *reinterpret_cast<float2*>(out + 8 * q) = make_float2(v0, v1);
          }
        }
      }
    } else {
      // y_c = C S_0^T of strip `strip` for its y warp, first: the y warp
      // waits for it only after its own products
      if (strip_live && carried) {
        uint32_t cf[4][4];
        load_c_fragments<BF16>(cf, Cs, l0, lane);
        float yc[4][4] = {};
        carried_product<BF16>(yc, cf, Cs, Sbuf + (buf ^ 1) * kPS * kRowS, l0, g, t);
        float* to = Ycs + strip * kYcFloats;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float4*>(to + (q * 32 + lane) * 4) =
              make_float4(yc[q][0], yc[q][1], yc[q][2], yc[q][3]);
        asm volatile("bar.arrive %0, 64;\n" ::"r"(1 + strip) : "memory");
      }
      // S_out = exp(last) S_0 + (exp(last - cum) o xbar)^T B over the valid
      // 8-step slices, in pair order: k position t is step 8k + 2t
      const float dl = expf(last);
      const float ew_lo = expf(last - cum[lane]), ew_hi = expf(last - cum[lane + 32]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[j][e] = __fmul_rn(dl, sa[j][e]);
      const int kmax = (valid - 1) >> 3;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k > kmax) break;
        const int m = 8 * k + 2 * t, r = sr0 + g;
        const float w0 = step_value(ew_lo, ew_hi, k >= 4, m);
        const float w1 = step_value(ew_lo, ew_hi, k >= 4, m + 1);
        const float dt0 = Ds[m], dt1 = Ds[m + 1];
        const float xv[4] = {
            __fmul_rn(w0, __fmul_rn(ld1<BF16>(Xs + m * kRowX + r), dt0)),
            __fmul_rn(w0, __fmul_rn(ld1<BF16>(Xs + m * kRowX + r + 8), dt0)),
            __fmul_rn(w1, __fmul_rn(ld1<BF16>(Xs + (m + 1) * kRowX + r), dt1)),
            __fmul_rn(w1, __fmul_rn(ld1<BF16>(Xs + (m + 1) * kRowX + r + 8), dt1))};
        uint32_t xb[4], xs[4];
        split(xv, xb, xs);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = sn0 + 8 * j + g;
          const float b0 = ld1<BF16>(Bs + m * kRowBC + n), b1 = ld1<BF16>(Bs + (m + 1) * kRowBC + n);
          if constexpr (BF16) {
            mma2_b(sa[j], xb, xs, b0, b1);
          } else {
            mma3(sa[j], xb, xs, split(b0), split(b1));
          }
        }
      }
      float* Snext = Sbuf + buf * kPS * kRowS;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(Snext + (sr0 + g + 8 * hf) * kRowS + sn0 + 8 * j + 2 * t) =
              make_float2(sa[j][2 * hf], sa[j][2 * hf + 1]);
    }
  }
  if (!y_warp) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(a.s_out + state0 + (sr0 + g + 8 * hf) * kN + sn0 + 8 * j +
                                   2 * t) = make_float2(sa[j][2 * hf], sa[j][2 * hf + 1]);
  }
}

}  // namespace mma

bool aligned(const void* p) { return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

using KernelFn = void (*)(Args);

// The kernel of `variant` (0 cuda_core, 1 mma) and `dtype` (0 float32, 1
// bf16) and its dynamic shared memory, the kernel's limit raised to that at
// its first use. Returns 0 or a cudaError_t.
int prepare(int variant, int dtype, KernelFn* fn, int* smem) {
  static bool sized[2][2] = {};
  if (variant == 0) {
    *fn = dtype ? cuda_core::ssd_scan_kernel<true> : cuda_core::ssd_scan_kernel<false>;
    *smem = cuda_core::kSmemBytes;
  } else {
    *fn = dtype ? mma::ssd_scan_kernel<true> : mma::ssd_scan_kernel<false>;
    *smem = dtype ? mma::kSmemBf16 : mma::kSmemF32;
  }
  if (!sized[variant][dtype]) {
    const cudaError_t err =
        cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return (int)err;
    sized[variant][dtype] = true;
  }
  return 0;
}

}  // namespace

extern "C" {

// y (B, S, H, P) and the final state s_out (B, H, P, N) float32 of the SSD
// scan of xh (B, S, H, P), dt (B, S, H) float32 (post-softplus), A (H,)
// float32, Bm and Cm (B, S, N), from s0 (B, H, P, N) float32 or null (zero).
// xh, Bm, Cm and y float32 (dtype 0) or bf16 (dtype 1); every array
// contiguous and 16-byte aligned (s0 may be s_out). Takes P a multiple of 32,
// N = 64 and chunk = 64. variant: 0 cuda_core, 1 mma. Returns 0, a
// cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_ssd_scan(const void* xh, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* s0, void* y, float* s_out, int B, int S, int H,
                   int P, int N, int chunk, int dtype, int variant, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < kPS || P % kPS || N != kN || chunk != kL ||
      (dtype != 0 && dtype != 1) || (variant != 0 && variant != 1) ||
      (long long)B * H * (P / kPS) > 0x7fffffffLL)
    return REPRO_BAD_ARGUMENT;
  if (!aligned(xh) || !aligned(dt) || !aligned(A) || !aligned(Bm) || !aligned(Cm) ||
      !aligned(y) || !aligned(s_out) || (s0 && !aligned(s0)))
    return REPRO_BAD_ARGUMENT;
  const Args a = {xh, dt, A, Bm, Cm, s0, y, s_out, S, H, P};
  static_assert(cuda_core::kThreads == 256 && mma::kThreads == 256, "both take 256 threads");
  KernelFn fn;
  int smem;
  const int err = prepare(variant, dtype, &fn, &smem);
  if (err) return err;
  fn<<<B * H * (P / kPS), 256, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block takes (the build report): variant 0
// cuda_core, 1 mma; dtype 0 float32, 1 bf16.
int repro_ssd_scan_smem(int variant, int dtype) {
  if (variant == 0) return cuda_core::kSmemBytes;
  return dtype == 1 ? mma::kSmemBf16 : mma::kSmemF32;
}

// Blocks of `variant` and `dtype` that fit on one SM at once (the one-wave
// rule's check on the card), or minus a cudaError_t.
int repro_ssd_scan_blocks_per_sm(int variant, int dtype) {
  if ((variant != 0 && variant != 1) || (dtype != 0 && dtype != 1)) return REPRO_BAD_ARGUMENT;
  KernelFn fn;
  int smem, n = 0;
  int err = prepare(variant, dtype, &fn, &smem);
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, 256, smem);
  return err ? -err : n;
}

const char* repro_ssd_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
