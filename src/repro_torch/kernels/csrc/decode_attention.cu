// One-token GQA decode attention against a KV cache (K3).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (pallas_call at :113, body _decode_kernel at :28).
// Computes, for every sequence b and query head h, softmax over the first
// lengths[b] cached keys of kv head h / q_per_kv (lengths clamped to [0, S]),
// applied to the values; float32 scores, weights and accumulator, output in
// the input dtype, 0 for a length-0 row.
//
// What bounds it on an H100: bytes. Each (b, kv head) streams 2*len*D
// elements of K and V once and does ~4*q_per_kv flops per element, far
// below the ~295 flops/byte at which bf16 tensor cores would become the
// limit. Both kernels read each live cache row exactly once and nothing
// else; the q_per_kv query heads that share a KV head ride along, so K/V
// are read once per group, never per query head. Two kernels, one chosen by
// the wrapper before the launch (never as a fallback):
//
// * split_kv (the wrapper's choice for every shape). The Pallas grid's
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
//   columns. Head dims 64, 128 and 256 split evenly over the lanes; D = 112
//   takes the layout of 128 columns, and the lanes whose slice lies past the
//   row hold zeros and load nothing (Cfg::kDP). Every group of LPK lanes
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
// D (64, 128 or 256): at D = 112 a row is laid out as 128 columns and the
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
  REPRO_SPLIT(false, 64)
  REPRO_SPLIT(false, 112)
  REPRO_SPLIT(false, 128)
  REPRO_SPLIT(false, 256)
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
// per (b, kv head). Returns 0, a cudaError_t, or REPRO_BAD_ARGUMENT.
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

const char* repro_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
