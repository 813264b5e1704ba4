// One-token GQA decode attention against a KV cache (K3).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (pallas_call at :113, body _decode_kernel at :28).
// Computes, for every sequence b and query head h, softmax over the first
// lengths[b] cached keys of kv head h / q_per_kv (lengths clamped to [0, S]),
// applied to the values; float32 scores, weights and accumulator (the mma
// kernel rounds the weights to bf16 for P.V, as the Pallas kernel does),
// output in the input dtype, 0 for a length-0 row.
//
// What bounds it on an H100: bytes. Each (b, kv head) streams 2*len*D
// elements of K and V once and does ~4*q_per_kv flops per element, far
// below the ~295 flops/byte at which bf16 tensor cores would become the
// limit. Every kernel reads each live cache row exactly once and nothing
// else; the q_per_kv query heads that share a KV head ride along, so K/V
// are read once per group, never per query head. At serving's shapes the
// bytes are few (paligemma-3b's one tenant: ~2.4 MB, under a microsecond at
// the card's rate), so what a kernel pays is latency: CTAs to fill the card
// and instructions per key. Three kernels, one chosen by the wrapper before
// the launch (never as a fallback):
//
// * mma (bf16, D = 64, 112, 128, 256; the wrapper's choice at D = 256 and
//   at D = 128 from 5 query heads a kv head). The tensor cores' mma.sync
//   m16n8k16 (bf16 in, float32 accumulators) in the swap-AB form: a kv
//   head's up to 8 query heads are the n = 8 columns, zero-padded, so
//   scores^T (16 keys x 8 heads) = K_tile (16 keys x D) Q^T, with Q^T's
//   fragments loaded once into registers from global memory, and
//   out^T (D x 8 heads) += V^T P^T through ldmatrix (.trans for V). Each of
//   the four warps takes 16 keys of every 64-key tile and keeps its own
//   online softmax (log2 units) on the accumulator fragments: a lane holds
//   keys g, g + 8 and heads 2c, 2c + 1 (g = lane / 4, c = lane % 4), so a
//   head's max over 16 keys is 3 xor-shuffles and its sum stays a per-lane
//   partial until the end. P, rounded to bf16 (the Pallas kernel's own
//   p.astype(v.dtype), decode_attention.py:60), goes from the accumulator
//   layout (keys x heads) to the B operand (heads x keys) by movmatrix.trans
//   in registers. K/V tiles arrive by one 1-D bulk copy per live row into
//   rows padded to 2 D + 16 bytes, so the eight rows an ldmatrix reads lie in
//   eight bank groups; a dead key's V is masked in its fragment, never used.
//   The grid is (splits, B*Hkv) in clusters of `splits` (up to 16, a
//   non-portable size) chosen on the host from B*Hkv and S (mma_splits) to
//   fill the card: 16 for paligemma's 4 and 16 sequences, where split_kv's
//   splits(S) = 4 ran 16 or 64 CTAs on 132 SMs. Warps merge through shared
//   memory in warp order and ranks through distributed shared memory in
//   rank order, as split_kv below: one launch, no workspace, no atomics,
//   bitwise repeatable. 154 registers at D = 256, against split_kv's 255.
// * split_kv (every other shape, float32 included). The Pallas grid's
//   sequential key axis is spread over the CTAs of a thread-block cluster:
//   grid (splits, B*Hkv), clusters of `splits` CTAs along x, splits fixed on
//   the host from S alone (never from lengths, which stay on the card). Each
//   CTA reads lengths[b] itself and walks its own 64-key-aligned share of the
//   live prefix [0, L): ceil(ceil(L/64) / splits) tiles per rank, so no CTA
//   walks more than ~L/splits keys and a short sequence leaves ranks empty.
//   A 64-key tile of K (and of V) is one contiguous run of 64*D elements
//   ((b*Hkv + h)*S*D onward), fetched by one thread as a 1-D bulk copy into a
//   1-3 stage ring on mbarriers (one stage only for float32 at D = 256, whose
//   64-key K and V tiles take 128 KB), kept in the input dtype (not widened),
//   and only the live rows are copied (the mbarrier expects exactly those
//   bytes); rows at or past L are never read. Every thread works: a key is
//   LPK lanes (8 to 32, chosen so that q and the accumulator of every query
//   head fit in 32 registers where 32 lanes allow it; 64 at G = 8, D = 256),
//   each holding one slice of its values; the lanes' partial dot products
//   meet by xor-shuffles, and each lane keeps the P.V sums of its own
//   columns. Head dims 64, 128 and 256 split evenly over the lanes; D = 32
//   takes the layout of 64 columns and D = 112 that of 128, and the lanes
//   whose slice lies past the row hold zeros and load nothing (Cfg::kDP). Every group of LPK lanes
//   runs its own online softmax over the keys it sees (up to 4 at a time);
//   groups merge by shuffles, warps through shared memory in warp order,
//   and after cluster.sync() the cluster's ranks share the G*D outputs and
//   each combines the s partials (m, l, acc) in rank order through
//   distributed shared memory; a second cluster.sync() keeps every partial
//   alive until it has been read. One launch, no workspace, no atomics:
//   bitwise repeatable.
// * single_pass (the first version, launched only when asked for; D = 64
//   and 128 only): one block of 128 threads per (b, kv head) walking the
//   whole live prefix in 64-key tiles, each tile loaded synchronously and
//   widened to float32, then scores, softmax and P.V in turn.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::Elem;
using repro::kNegInf;
namespace cg = cooperative_groups;
namespace sm90 = repro::sm90;

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
int launch_single(const void* q, const void* k, const void* v, const int32_t* lengths,
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


// ---------------------------------------------------------------- split_kv
namespace split {
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // keys per tile
constexpr int kWarpKeys = kTile / kWarps;  // keys of each tile that one warp takes
constexpr int kMaxSplits = 8;              // the portable cluster size
constexpr int kMaxRing = 200 * 1024;       // the K/V ring's most bytes (227 KB a block)

// The layout of the kernel for dtype BF16, head dim D and up to G query heads
// per KV head. Lanes are laid out for kDP, the power-of-two width at or above
// D (64, 128 or 256): at D = 32 a row is laid out as 64 columns, at D = 112
// as 128, and the
// lanes whose slice starts at or past D hold nothing (every slice lies wholly
// inside the row or wholly past it), so each live slice stays a whole 8-byte
// or 16-byte-multiple vector at an aligned address.
template <bool BF16, int D, int G>
struct Cfg {
  using T = typename Elem<BF16>::T;
  static constexpr int kDP = D <= 64 ? 64 : (D <= 128 ? 128 : 256);
  static constexpr bool kPadded = kDP != D;
  // lanes per key: as few as 8 (4 keys per warp step), as many as it takes
  // to keep G*kDP/kLPK (q and accumulator values per lane) at 32 or fewer,
  // up to the whole warp (64 values per lane at G = 8, D = 256)
  static constexpr int kLPK = G * kDP / 32 < 8 ? 8 : (G * kDP / 32 > 32 ? 32 : G * kDP / 32);
  static constexpr int kKPS = 32 / kLPK;            // keys per warp step
  static constexpr int kVals = kDP / kLPK;          // values of a row per lane
  static constexpr int kSteps = kWarpKeys / kKPS;   // warp steps per tile
  static constexpr int kChunk = kSteps < 4 ? kSteps : 4;  // steps per softmax update
  static constexpr int kTileElems = kTile * D;
  static constexpr int kTileBytes = kTileElems * (int)sizeof(T);
  // 3 stages of small tiles, 2 where two stages of K and V fit in kMaxRing,
  // else 1 (float32 at D = 256: one 64-key tile of K and V is 128 KB)
  static constexpr int kStages =
      2 * kTileBytes <= 16384 ? 3 : (4 * kTileBytes <= kMaxRing ? 2 : 1);
  static constexpr int kSmemBytes = kStages * 2 * kTileBytes;  // the K/V ring
  // After the key loop the ring holds each warp's partial, then the CTA's:
  // acc[G][D], m[G], l[G] in float32.
  static constexpr int kPart = G * (D + 2);
  static_assert((kWarps + 1) * kPart * 4 <= kSmemBytes, "partials reuse the ring");
  static_assert(kVals * sizeof(T) % 8 == 0, "a lane's slice is 8-byte vectors");
  static_assert(D % kVals == 0, "a slice lies wholly inside the row or wholly past it");
  static_assert(kTileBytes % 16 == 0, "bulk copies move 16-byte multiples");
};

// N values of a row slice at p (8-byte aligned; 16 if a multiple of 16
// bytes), widened to float32.
template <typename E, int N>
__device__ __forceinline__ void load_slice(const typename E::T* p, float (&o)[N]) {
  constexpr int kBytes = N * (int)sizeof(typename E::T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c)
      E::unpack(reinterpret_cast<const uint4*>(p)[c], o + c * E::kVec);
  } else {
    static_assert(kBytes == 8, "slices are 8 bytes or 16-byte multiples");
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    float t[E::kVec];
    E::unpack(make_uint4(r.x, r.y, 0u, 0u), t);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = t[i];
  }
}

// Grid (splits, B*Hkv), clusters of `splits` CTAs along x.
template <bool BF16, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_split(const typename Elem<BF16>::T* __restrict__ q,
             const typename Elem<BF16>::T* __restrict__ k,
             const typename Elem<BF16>::T* __restrict__ v, const int32_t* __restrict__ lengths,
             typename Elem<BF16>::T* __restrict__ out, int Hq, int Hkv, int S, float scale) {
  using C = Cfg<BF16, D, G>;
  using E = Elem<BF16>;
  using T = typename E::T;
  extern __shared__ __align__(128) char ring_raw[];
  __shared__ uint64_t full[C::kStages];
  T* ring = reinterpret_cast<T*>(ring_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;  // b * Hkv + hkv
  const int b = bh / Hkv;
  const int hkv = bh % Hkv;
  const int groups = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kg = lane / C::kLPK;  // which of the warp step's keys this lane works on
  const int col = (lane % C::kLPK) * C::kVals;  // first of this lane's columns
  const bool owns = !C::kPadded || col < D;      // false: a lane past the row, holding zeros

  // this rank's share of the live prefix: whole 64-key tiles, in rank order
  int L = lengths[b];
  L = L < 0 ? 0 : (L > S ? S : L);
  const int per = ((L + kTile - 1) / kTile + splits - 1) / splits;
  const int key0 = min(rank * per * kTile, L);
  const int key_end = min(key0 + per * kTile, L);
  const int n_tiles = (key_end - key0 + kTile - 1) / kTile;
  const long kv_base = (long)bh * S * D;
  const long q_base = ((long)b * Hq + (long)hkv * groups) * D;  // the group's heads, contiguous

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // tile t of this rank (its live rows only) into ring stage t % kStages
  auto fetch = [&](int t) {
    const int j0 = key0 + t * kTile;
    const uint32_t bytes = (uint32_t)(min(kTile, key_end - j0) * D * (int)sizeof(T));
    T* st = ring + (t % C::kStages) * 2 * C::kTileElems;
    uint64_t* bar = &full[t % C::kStages];
    sm90::mbar_arrive_expect_tx(bar, 2 * bytes);
    sm90::bulk_load(st, k + kv_base + (long)j0 * D, bytes, bar);
    sm90::bulk_load(st + C::kTileElems, v + kv_base + (long)j0 * D, bytes, bar);
  };
  if (tid == 0)
    for (int t = 0; t < C::kStages && t < n_tiles; ++t) fetch(t);

  float qv[G][C::kVals];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < groups && owns) {
      load_slice<E>(q + q_base + g * D + col, qv[g]);
    } else {
#pragma unroll
      for (int i = 0; i < C::kVals; ++i) qv[g][i] = 0.f;
    }
  }
  float m[G], l[G], acc[G][C::kVals];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < C::kVals; ++i) acc[g][i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % C::kStages;
    sm90::mbar_wait(&full[stage], (t / C::kStages) & 1);
    const T* ks = ring + stage * 2 * C::kTileElems;
    const T* vs = ks + C::kTileElems;
    const int n = min(kTile, key_end - (key0 + t * kTile));  // live keys of the tile
#pragma unroll
    for (int c0 = 0; c0 < C::kSteps; c0 += C::kChunk) {
      float p[C::kChunk][G];
      bool live[C::kChunk];
      int key[C::kChunk];
#pragma unroll
      for (int u = 0; u < C::kChunk; ++u) {
        key[u] = warp * kWarpKeys + (c0 + u) * C::kKPS + kg;
        live[u] = key[u] < n;  // a row past the live ones holds stale data: never used
        float kv[C::kVals];
        if (owns) {
          load_slice<E>(ks + key[u] * D + col, kv);
        } else {
#pragma unroll
          for (int i = 0; i < C::kVals; ++i) kv[i] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < C::kVals; ++i) d = fmaf(qv[g][i], kv[i], d);
#pragma unroll
          for (int off = C::kLPK / 2; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          p[u][g] = live[u] ? d * scale : kNegInf;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {  // online softmax over the chunk's keys
        float mx = p[0][g];
#pragma unroll
        for (int u = 1; u < C::kChunk; ++u) mx = fmaxf(mx, p[u][g]);
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < C::kVals; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int u = 0; u < C::kChunk; ++u) {
          p[u][g] = live[u] ? expf(p[u][g] - m_new) : 0.f;
          l[g] += p[u][g];
        }
        m[g] = m_new;
      }
#pragma unroll
      for (int u = 0; u < C::kChunk; ++u) {
        if (!live[u] || !owns) continue;
        float vv[C::kVals];
        load_slice<E>(vs + key[u] * D + col, vv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < C::kVals; ++i) acc[g][i] = fmaf(p[u][g], vv[i], acc[g][i]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && t + C::kStages < n_tiles) fetch(t + C::kStages);
  }

  // merge the warp's key groups (lanes kLPK, 2 kLPK, ... apart)
#pragma unroll
  for (int off = C::kLPK; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn);
      const float c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int i = 0; i < C::kVals; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  // the ring is idle (every copy started was waited for): warps' partials
  float* part = reinterpret_cast<float*>(ring_raw);
  float* wp = part + warp * C::kPart;
  if (kg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (owns) {
#pragma unroll
        for (int i = 0; i < C::kVals; ++i) wp[g * D + col + i] = acc[g][i];
      }
      if (col == 0) {
        wp[G * D + g] = m[g];
        wp[G * D + G + g] = l[g];
      }
    }
  }
  __syncthreads();
  float* cta = part + kWarps * C::kPart;  // this CTA's partial, merged in warp order
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    float mx = part[G * D + g];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, part[w * C::kPart + G * D + g]);
    float a = 0.f, ll = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(part[w * C::kPart + G * D + g] - mx);
      a += part[w * C::kPart + e] * f;
      ll += part[w * C::kPart + G * D + G + g] * f;
    }
    cta[e] = a;
    if (e % D == 0) {
      cta[G * D + g] = mx;
      cta[G * D + G + g] = ll;
    }
  }
  cluster.sync();  // every rank's partial is in place

  // ranks share the group's outputs; each combines the partials in rank order
  const int total = groups * D;
  const int share = (total + splits - 1) / splits;
  const int e_end = min((rank + 1) * share, total);
  for (int e = rank * share + tid; e < e_end; e += kThreads) {
    const int g = e / D;
    float mx = kNegInf;
    for (int r = 0; r < splits; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(cta, r)[G * D + g]);
    float a = 0.f, ll = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* pr = cluster.map_shared_rank(cta, r);
      const float f = expf(pr[G * D + g] - mx);
      a += pr[e] * f;
      ll += pr[G * D + G + g] * f;
    }
    E::store(out, q_base + e, ll > 0.f ? a / ll : 0.f);
  }
  cluster.sync();  // no CTA leaves while another may still read its partial
}
}  // namespace split

// ---------------------------------------------------------------- mma
// bf16 only: the tensor cores' mma.sync takes no float32 inputs (and TF32 is
// not the reference's precision).
namespace mma {
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;         // keys per tile: 16 per warp, one m16 block each
constexpr int kHeads = 8;         // n of m16n8k16: the group's query heads, zero-padded
constexpr int kMaxSplits = 16;    // the largest (non-portable) cluster
constexpr int kMaxRing = 72 * 1024;  // two stages up to here: three CTAs a multiprocessor
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static_assert(D % 16 == 0, "whole k16 slices of a row");
  static constexpr int kRow = 2 * D + 16;          // a key's row in shared memory, padded
  static constexpr int kTileBytes = kTile * kRow;  // one tile of K (or of V)
  static constexpr int kStages = 4 * kTileBytes <= kMaxRing ? 2 : 1;
  static constexpr int kRing = kStages * 2 * kTileBytes;
  static constexpr int kSlices = D / 16;           // k16 slices of Q K^T, m16 blocks of O^T
  // After the key loop the ring holds each warp's partial, then the CTA's:
  // o[kHeads][D], m[kHeads], l[kHeads] in float32.
  static constexpr int kPart = kHeads * D + 2 * kHeads;
  static constexpr int kSmemBytes = kRing;
  static_assert((kWarps + 1) * kPart * 4 <= kRing, "partials reuse the ring");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}
// The transpose of an 8 x 8 bf16 matrix held as mma fragments: lane t's
// word (row t / 4, columns 2 (t % 4), +1) in, the same of the transpose out.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// d (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The low (high) half of a bf16 pair kept where its key is live.
__device__ __forceinline__ uint32_t live_halves(bool lo, bool hi) {
  return (lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u);
}

// Grid (splits, B*Hkv), clusters of `splits` CTAs along x. Warp w takes keys
// 16w..16w+15 of every tile; lane t holds (g, c) = (t / 4, t % 4) of the
// m16n8 fragments: keys g and g + 8 of the warp's 16, query heads 2c and
// 2c + 1 (scores) and head dims g, g + 8 of each 16 (outputs).
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
           const uint16_t* __restrict__ v, const int32_t* __restrict__ lengths,
           uint16_t* __restrict__ out, int Hq, int Hkv, int S, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) char ring[];
  __shared__ uint64_t full[C::kStages];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;  // b * Hkv + hkv
  const int b = bh / Hkv;
  const int hkv = bh % Hkv;
  const int groups = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;

  // this rank's share of the live prefix: whole 64-key tiles, in rank order
  // (split_kv's arithmetic; key_ranges mirrors it)
  int L = lengths[b];
  L = L < 0 ? 0 : (L > S ? S : L);
  const int per = ((L + kTile - 1) / kTile + splits - 1) / splits;
  const int key0 = min(rank * per * kTile, L);
  const int key_end = min(key0 + per * kTile, L);
  const int n_tiles = (key_end - key0 + kTile - 1) / kTile;
  const long kv_base = (long)bh * S * D;
  const long q_base = ((long)b * Hq + (long)hkv * groups) * D;  // the group's heads, contiguous

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // tile t of this rank into stage t % kStages, by warp 0: one bulk copy per
  // live row of K and of V into a padded row (kRow bytes apart, so the eight
  // rows an ldmatrix reads fall in eight different bank groups); rows at or
  // past the rank's end are neither read nor waited for
  auto fetch = [&](int t) {
    const int j0 = key0 + t * kTile;
    const int n = min(kTile, key_end - j0);
    char* st = ring + (t % C::kStages) * 2 * C::kTileBytes;
    uint64_t* bar = &full[t % C::kStages];
    if (lane == 0) sm90::mbar_arrive_expect_tx(bar, (uint32_t)(2 * n * D * 2));
    __syncwarp();
    for (int r = lane; r < n; r += 32) {
      const long row = kv_base + (long)(j0 + r) * D;
      sm90::bulk_load(st + r * C::kRow, k + row, 2 * D, bar);
      sm90::bulk_load(st + C::kTileBytes + r * C::kRow, v + row, 2 * D, bar);
    }
  };
  if (warp == 0)
    for (int t = 0; t < C::kStages && t < n_tiles; ++t) fetch(t);

  // Q^T as the B operand of S^T = K Q^T: slice kk holds head g's dims
  // 16 kk + 2c, +1 and 16 kk + 8 + 2c, +1; heads past the group are zero
  uint32_t qb[C::kSlices][2];
#pragma unroll
  for (int kk = 0; kk < C::kSlices; ++kk) {
    const uint16_t* qr = q + q_base + (long)g * D + 16 * kk + 2 * c;
    qb[kk][0] = g < groups ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
    qb[kk][1] = g < groups ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
  }
  float o[C::kSlices][4];  // O^T: dims 16 mb + g (+8) x heads 2c, 2c + 1
#pragma unroll
  for (int mb = 0; mb < C::kSlices; ++mb) o[mb][0] = o[mb][1] = o[mb][2] = o[mb][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // heads 2c, 2c + 1: running max, log2 units
  float l[2] = {0.f, 0.f};          // this lane's share of the running sums

  const int kb = warp * 16;  // the warp's first key of a tile
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % C::kStages;
    sm90::mbar_wait(&full[stage], (t / C::kStages) & 1);
    const char* ks = ring + stage * 2 * C::kTileBytes;
    const char* vs = ks + C::kTileBytes;
    const int n = min(kTile, key_end - (key0 + t * kTile));  // live keys of the tile
    if (kb < n) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f};  // S^T: keys g, g + 8 x heads 2c, 2c + 1
      const char* ka = ks + (kb + lane % 16) * C::kRow + (lane / 16) * 16;
#pragma unroll
      for (int kk = 0; kk < C::kSlices; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, ka + 32 * kk);
        mma_bf16(sc, a, qb[kk][0], qb[kk][1]);
      }
      // a row past the live ones holds stale bytes: selected away, never used
      const bool live0 = kb + g < n;
      const bool live1 = kb + g + 8 < n;
      const float x[4] = {live0 ? sc[0] * scale_log2 : kNegInf, live0 ? sc[1] * scale_log2 : kNegInf,
                          live1 ? sc[2] * scale_log2 : kNegInf, live1 ? sc[3] * scale_log2 : kNegInf};
      float mx[2] = {fmaxf(x[0], x[2]), fmaxf(x[1], x[3])};
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {  // over the 8 lanes of a column: 16 keys
        mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
        mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
      }
      float alpha[2], p[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // key kb is live: m_new is a real score
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        p[h] = live0 ? exp2f(x[h] - m_new) : 0.f;
        p[h + 2] = live1 ? exp2f(x[h + 2] - m_new) : 0.f;
        l[h] = l[h] * alpha[h] + p[h] + p[h + 2];
        m[h] = m_new;
      }
#pragma unroll
      for (int mb = 0; mb < C::kSlices; ++mb) {
        o[mb][0] *= alpha[0];
        o[mb][1] *= alpha[1];
        o[mb][2] *= alpha[0];
        o[mb][3] *= alpha[1];
      }
      // P^T as the B operand of O^T += V^T P^T: P rounded to bf16 (the Pallas
      // kernel's own p.astype(v.dtype), decode_attention.py:60), each 8 x 8
      // block (keys x heads) transposed in registers to (heads x keys)
      const uint32_t pb0 = transpose8x8(sm90::pack_bf16x2(p[0], p[1]));
      const uint32_t pb1 = transpose8x8(sm90::pack_bf16x2(p[2], p[3]));
      // V^T through ldmatrix.trans: lane t names key kb + t % 8 (+8 for
      // t >= 16), dims 8 ((t / 8) % 2) of each 16; a lane's words hold keys
      // kb + 2c, +1 (a[0], a[1]) and kb + 8 + 2c, +1 (a[2], a[3]). A dead
      // key's value is zeroed, so no stale NaN meets its zero weight.
      const uint32_t keep0 = kb + 16 <= n ? ~0u : live_halves(kb + 2 * c < n, kb + 2 * c + 1 < n);
      const uint32_t keep1 =
          kb + 16 <= n ? ~0u : live_halves(kb + 8 + 2 * c < n, kb + 9 + 2 * c < n);
      const char* va = vs + (kb + lane % 8 + 8 * (lane / 16)) * C::kRow + ((lane / 8) % 2) * 16;
#pragma unroll
      for (int mb = 0; mb < C::kSlices; ++mb) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, va + 32 * mb);
        a[0] &= keep0;
        a[1] &= keep0;
        a[2] &= keep1;
        a[3] &= keep1;
        mma_bf16(o[mb], a, pb0, pb1);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (warp == 0 && t + C::kStages < n_tiles) fetch(t + C::kStages);
  }

  // the warp's sums over its 8 lanes of a column, then its partial into the
  // idle ring (every copy started was waited for)
#pragma unroll
  for (int off = 4; off < 32; off *= 2) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  float* part = reinterpret_cast<float*>(ring);
  float* wp = part + warp * C::kPart;
#pragma unroll
  for (int mb = 0; mb < C::kSlices; ++mb) {
    const int d = 16 * mb + g;
    wp[(2 * c) * D + d] = o[mb][0];
    wp[(2 * c + 1) * D + d] = o[mb][1];
    wp[(2 * c) * D + d + 8] = o[mb][2];
    wp[(2 * c + 1) * D + d + 8] = o[mb][3];
  }
  if (g == 0) {
    wp[kHeads * D + 2 * c] = m[0];
    wp[kHeads * D + 2 * c + 1] = m[1];
    wp[kHeads * D + kHeads + 2 * c] = l[0];
    wp[kHeads * D + kHeads + 2 * c + 1] = l[1];
  }
  __syncthreads();
  float* cta = part + kWarps * C::kPart;  // this CTA's partial, merged in warp order
  for (int e = tid; e < groups * D; e += kThreads) {
    const int h = e / D;
    float mx = part[kHeads * D + h];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, part[w * C::kPart + kHeads * D + h]);
    float a = 0.f, ll = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(part[w * C::kPart + kHeads * D + h] - mx);
      a += part[w * C::kPart + e] * f;
      ll += part[w * C::kPart + kHeads * D + kHeads + h] * f;
    }
    cta[e] = a;
    if (e % D == 0) {
      cta[kHeads * D + h] = mx;
      cta[kHeads * D + kHeads + h] = ll;
    }
  }
  cluster.sync();  // every rank's partial is in place

  // ranks share the group's outputs; each combines the partials in rank order
  const int total = groups * D;
  const int share = (total + splits - 1) / splits;
  const int e_end = min((rank + 1) * share, total);
  for (int e = rank * share + tid; e < e_end; e += kThreads) {
    const int h = e / D;
    float mx = kNegInf;
    for (int r = 0; r < splits; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(cta, r)[kHeads * D + h]);
    float a = 0.f, ll = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* pr = cluster.map_shared_rank(cta, r);
      const float f = exp2f(pr[kHeads * D + h] - mx);
      a += pr[e] * f;
      ll += pr[kHeads * D + kHeads + h] * f;
    }
    out[q_base + e] = __bfloat16_as_ushort(__float2bfloat16_rn(ll > 0.f ? a / ll : 0.f));
  }
  cluster.sync();  // no CTA leaves while another may still read its partial
}
}  // namespace mma

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const int32_t* lengths, void* out,
               int B, int Hq, int Hkv, int S, int splits, float scale, cudaStream_t stream,
               int* clusters) {
  using C = mma::Cfg<D>;
  auto kernel = mma::decode_mma<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err == cudaSuccess && splits > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(splits, B * Hkv);
  cfg.blockDim = dim3(mma::kThreads);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr)  // how many clusters fit on the card at once; nothing launched
    return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint16_t*>(q),
                                 static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v),
                                 lengths, static_cast<uint16_t*>(out), Hq, Hkv, S,
                                 scale * mma::kLog2e);
}

int dispatch_mma(const void* q, const void* k, const void* v, const int32_t* lengths, void* out,
                 int B, int Hq, int Hkv, int S, int D, int dtype, int splits, float scale,
                 cudaStream_t st, int* clusters) {
  if (dtype != 1 || splits < 1 || splits > mma::kMaxSplits || (long)B * Hkv > 65535 ||
      Hq / Hkv > mma::kHeads)
    return REPRO_BAD_ARGUMENT;
  switch (D) {
    case 64: return launch_mma<64>(q, k, v, lengths, out, B, Hq, Hkv, S, splits, scale, st, clusters);
    case 112: return launch_mma<112>(q, k, v, lengths, out, B, Hq, Hkv, S, splits, scale, st, clusters);
    case 128: return launch_mma<128>(q, k, v, lengths, out, B, Hq, Hkv, S, splits, scale, st, clusters);
    case 256: return launch_mma<256>(q, k, v, lengths, out, B, Hq, Hkv, S, splits, scale, st, clusters);
    default: return REPRO_BAD_ARGUMENT;
  }
}

int mma_smem(int D) {
  switch (D) {
    case 64: return mma::Cfg<64>::kSmemBytes;
    case 112: return mma::Cfg<112>::kSmemBytes;
    case 128: return mma::Cfg<128>::kSmemBytes;
    case 256: return mma::Cfg<256>::kSmemBytes;
    default: return 0;
  }
}

template <bool BF16, int D, int G>
cudaError_t split_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int splits,
                         int rows, cudaStream_t stream) {
  using C = split::Cfg<BF16, D, G>;
  cudaError_t err = cudaFuncSetAttribute(split::decode_split<BF16, D, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemBytes);
  *cfg = {};
  cfg->gridDim = dim3(splits, rows);
  cfg->blockDim = dim3(split::kThreads);
  cfg->dynamicSmemBytes = C::kSmemBytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <bool BF16, int D, int G>
int launch_split_as(const void* q, const void* k, const void* v, const int32_t* lengths,
                    void* out, int B, int Hq, int Hkv, int S, int splits, float scale,
                    cudaStream_t stream, int* clusters) {
  using T = typename Elem<BF16>::T;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = split_config<BF16, D, G>(&cfg, &attr, splits, B * Hkv, stream);
  if (err != cudaSuccess) return (int)err;
  if (clusters != nullptr)  // how many clusters fit on the card at once; nothing launched
    return (int)cudaOccupancyMaxActiveClusters(clusters, split::decode_split<BF16, D, G>, &cfg);
  return (int)cudaLaunchKernelEx(&cfg, split::decode_split<BF16, D, G>, static_cast<const T*>(q),
                                 static_cast<const T*>(k), static_cast<const T*>(v), lengths,
                                 static_cast<T*>(out), Hq, Hkv, S, scale);
}

template <bool BF16, int D>
int launch_split(const void* q, const void* k, const void* v, const int32_t* lengths, void* out,
                 int B, int Hq, int Hkv, int S, int splits, float scale, cudaStream_t stream,
                 int* clusters) {
  const int groups = Hq / Hkv;
  if (groups <= 1)
    return launch_split_as<BF16, D, 1>(q, k, v, lengths, out, B, Hq, Hkv, S, splits, scale,
                                       stream, clusters);
  if (groups <= 2)
    return launch_split_as<BF16, D, 2>(q, k, v, lengths, out, B, Hq, Hkv, S, splits, scale,
                                       stream, clusters);
  if (groups <= 4)
    return launch_split_as<BF16, D, 4>(q, k, v, lengths, out, B, Hq, Hkv, S, splits, scale,
                                       stream, clusters);
  return launch_split_as<BF16, D, 8>(q, k, v, lengths, out, B, Hq, Hkv, S, splits, scale,
                                     stream, clusters);
}

int dispatch_split(const void* q, const void* k, const void* v, const int32_t* lengths, void* out,
                   int B, int Hq, int Hkv, int S, int D, int dtype, int splits, float scale,
                   cudaStream_t st, int* clusters) {
  if (splits < 1 || splits > split::kMaxSplits || (long)B * Hkv > 65535) return REPRO_BAD_ARGUMENT;
#define REPRO_SPLIT(BF16, DIM)                                                                  \
  if (dtype == (BF16 ? 1 : 0) && D == DIM)                                                      \
    return launch_split<BF16, DIM>(q, k, v, lengths, out, B, Hq, Hkv, S, splits, scale, st,     \
                                   clusters);
  REPRO_SPLIT(false, 32)
  REPRO_SPLIT(false, 64)
  REPRO_SPLIT(false, 112)
  REPRO_SPLIT(false, 128)
  REPRO_SPLIT(false, 256)
  REPRO_SPLIT(true, 32)
  REPRO_SPLIT(true, 64)
  REPRO_SPLIT(true, 112)
  REPRO_SPLIT(true, 128)
  REPRO_SPLIT(true, 256)
#undef REPRO_SPLIT
  return REPRO_BAD_ARGUMENT;
}

template <bool BF16>
int split_smem(int D) {
  switch (D) {
    case 32: return split::Cfg<BF16, 32, 1>::kSmemBytes;
    case 64: return split::Cfg<BF16, 64, 1>::kSmemBytes;
    case 112: return split::Cfg<BF16, 112, 1>::kSmemBytes;
    case 128: return split::Cfg<BF16, 128, 1>::kSmemBytes;
    case 256: return split::Cfg<BF16, 256, 1>::kSmemBytes;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// q (B,Hq,D), k/v (B,Hkv,S,D), lengths (B,) int32, out (B,Hq,D); all
// contiguous, on the current device, 16-byte aligned. dtype: 0 float32,
// 1 bfloat16. variant: 0 single_pass, 1 split_kv over `splits` (1..8) CTAs
// per (b, kv head), 2 mma (bf16, D 64, 112, 128 or 256) over `splits`
// (1..16) CTAs. Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const int32_t* lengths, void* out, int B, int Hq,
                           int Hkv, int S, int D, int dtype, int variant, int splits,
                           float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return dispatch_split(q, k, v, lengths, out, B, Hq, Hkv, S, D, dtype, splits, scale, st,
                          nullptr);
  if (variant == 2)
    return dispatch_mma(q, k, v, lengths, out, B, Hq, Hkv, S, D, dtype, splits, scale, st,
                        nullptr);
  if (variant != 0) return REPRO_BAD_ARGUMENT;
  if (dtype == 0 && D == 64) return launch_single<false, 64>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, st);
  if (dtype == 0 && D == 128) return launch_single<false, 128>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, st);
  if (dtype == 1 && D == 64) return launch_single<true, 64>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, st);
  if (dtype == 1 && D == 128) return launch_single<true, 128>(q, k, v, lengths, out, B, Hq, Hkv, S, scale, st);
  return REPRO_BAD_ARGUMENT;
}

// How many clusters of the split_kv kernel for (D, dtype, q_per_kv, splits)
// fit on the current card at once (cudaOccupancyMaxActiveClusters), or -1.
int repro_decode_attention_clusters(int D, int dtype, int q_per_kv, int splits) {
  int n = 0;
  if (q_per_kv < 1 || q_per_kv > kMaxG) return -1;
  const int err = dispatch_split(nullptr, nullptr, nullptr, nullptr, nullptr, 1, q_per_kv, 1,
                                 1, D, dtype, splits, 1.f, 0, &n);
  return err == 0 ? n : -1;
}

// Dynamic shared memory of the split_kv kernel (its K/V ring), in bytes (0
// for a head dim it does not take).
int repro_decode_attention_smem(int D, int dtype) {
  return dtype == 1 ? split_smem<true>(D) : split_smem<false>(D);
}

// The same two for the mma kernel (bf16): clusters of `splits` resident at
// once for (D, q_per_kv), or -1; its ring of padded rows in bytes, or 0.
int repro_decode_attention_mma_clusters(int D, int q_per_kv, int splits) {
  int n = 0;
  if (q_per_kv < 1 || q_per_kv > mma::kHeads) return -1;
  const int err = dispatch_mma(nullptr, nullptr, nullptr, nullptr, nullptr, 1, q_per_kv, 1, 1, D,
                               1, splits, 1.f, 0, &n);
  return err == 0 ? n : -1;
}
int repro_decode_attention_mma_smem(int D) { return mma_smem(D); }

const char* repro_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
