// Flash-decode attention on Hopper (sm_90a), bound through a plain C
// interface (ctypes, see kernels/build.py and kernels/decode_attention.py).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention_pallas: one query
// token per row, q (B,H,hd), against a cache k, v (B,S,K,hd); fp32 softmax;
// p is cast to v's dtype before PV. A linear cache holds position kpos at
// slot kpos, and key kpos is valid iff lo <= kpos <= pos (lo = pos - window
// + 1 with a window, else 0). pos is one for the batch (pos_stride 0) or
// one a row (pos_stride 1: the slot arena's step, the TPU kernel vmapped
// over its scalar-prefetch pos). With ``rows``, query row b reads cache row
// rows[b] (a slot arena read in place), else row b. A ring cache (the
// sliding-window decode cache) holds the position of slot s in
// slot_pos[s] (-1: empty), and slot s is valid iff lo <= slot_pos[s] <= pos;
// with ``rows`` every cache row is a ring of its own, slot_pos (N,S), and
// query row b reads ring row rows[b]'s slot positions (a windowed slot
// arena: the TPU kernel vmapped over rows, each with its slot_pos).
//
// pos is read from the device (one int32, the TPU kernel's scalar-prefetch
// pos_ref), so that one launch, captured in a CUDA graph, serves every
// position: the launch depends on shapes alone and each block computes lo
// and its share of the keys from pos.
//
// What bounds it: bytes. Each valid key's K and V rows are read once and
// used for rep = H/K query heads, about rep flops per byte.
//
// One launch, no scratch. One thread-block cluster per (batch, kv head)
// splits the keys in 64-key tiles (32 at float32). The launch plan
// (kernels/decode_attention.py ``decode_launch_plan``) gives the most tiles
// the live keys can span, ``span``: all S slots' tiles for a linear cache
// without a window and for a ring, ceil(window / tile) + 1 with a window;
// and ``cluster`` blocks (at most 8, the portable cluster size: on the
// H100 clusters of 12 and 16 blocks cost more than they saved), as many as
// an even split of ``span`` tiles needs. On the device the live tiles are
// those of [lo, pos] (the ring's S slots): from lo's tile to pos's, n of
// them, per = ceil(n / cluster) consecutive tiles a block
// (``decode_split_plan`` mirrors this); blocks past the last live tile
// load nothing and publish an empty partial (m = kNegInf, l = 0, acc = 0).
// Tiles come through a ring
// of 16-byte cp.async copies into shared memory, in the cache's dtype, the
// next tiles' bytes in flight while one is computed; invalid slots are
// zero-filled, not read. The blocks end holding (m, l, acc) for each head
// and merge through distributed shared memory: after a cluster barrier,
// block r combines a slice of the group's rep * hd outputs from every
// block's state and writes out; a second barrier keeps each block's shared
// memory alive until all have read it.
//
// The math inside a tile, by one fixed rule, the dtype:
//   * bfloat16: mma.sync tensor cores. Each warp owns 16 keys of every tile:
//     it copies their K and V rows itself (lane i one row, so all 32 lanes
//     issue), keeps NS - 1 tiles in flight (a ring of NS = 3 stages, 2 at
//     hd > 128), and never waits on the other warps until the merge.
//     S = q K^T for the group's heads padded to 16 rows (m16n8k16; ldmatrix
//     from rows at a stride of 16 bytes past a multiple of 128, which is
//     conflict-free), softmax on the accumulator fragment in the log2
//     domain, p rounded to bf16 as the A fragment of PV (V by
//     ldmatrix.trans). The block's four warp states are merged in shared
//     memory before the cluster merge. The first version, on CUDA cores
//     like the float32 kernel, spent most of a tile issuing instructions:
//     per-key dot products over hd read q from shared memory for every key.
//   * float32: CUDA cores (mma.sync would round q and K to TF32, outside
//     float32's 1e-5). Each thread scores one key for a share of the heads
//     (K rows at the same conflict-free stride), then each warp takes
//     heads h = warp + 4i: the tile's max and sum over its 32 lanes and PV
//     with each lane owning DPL contiguous head dims; a two-stage ring.
//
// An invalid key's p is 0, never exp(kNegInf - kNegInf): a warp or block
// whose keys are all invalid keeps l = 0 and acc = 0, and the merges weight
// it by exp(kNegInf - max), 0 beside any block with a valid key.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // kernels/decode_attention.py MAX_CLUSTER
constexpr int kMaxGroup = 32;    // query heads per kv head
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// keys per tile: 128 bytes of keys' worth per row; kernels/decode_attention.py TILE
template <typename T> constexpr int kTile = 128 / (int)sizeof(T);

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// N values of T from 16-byte-aligned shared memory, as floats
template <typename T, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float (&out)[N]) {
  constexpr int bytes = N * (int)sizeof(T);
  if constexpr (bytes >= 16) {
#pragma unroll
    for (int c = 0; c < bytes / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < 16 / (int)sizeof(T); ++e) out[c * (16 / sizeof(T)) + e] = to_f32(t[e]);
    }
  } else if constexpr (bytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(t[e]);
  } else {
    static_assert(bytes == 4, "4, 8 or a multiple of 16 bytes");
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f32(t[e]);
  }
}

__device__ __forceinline__ float lane_of(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// bytes between two K (or V) rows of a tile in shared memory
__host__ __device__ __forceinline__ int row_stride(int hd, int elem) {
  return (hd * elem + 127) / 128 * 128 + 16;
}

// This block's tiles [t_begin, t_end) of the live keys: [lo, pos]'s tiles
// (a ring's span tiles) split evenly over the cluster's csize blocks; the
// first tile's keys start at 0 (absolute tile indices).
struct Split {
  int pos, lo, t_begin, t_end;
};

template <int TK>
__device__ __forceinline__ Split block_split(const int* pos_ptr, bool ring, int window, int span,
                                             int rank, int csize) {
  // pos_ptr points at this row's position
  Split sp;
  sp.pos = __ldg(pos_ptr);
  sp.lo = window > 0 ? max(0, sp.pos - window + 1) : 0;
  int t0 = 0, n = span;
  if (!ring) {
    t0 = sp.lo / TK;
    n = min(max(sp.pos, 0) / TK - t0 + 1, span);
  }
  const int per = (n + csize - 1) / csize;
  sp.t_begin = t0 + rank * per;
  sp.t_end = min(t0 + n, sp.t_begin + per);
  return sp;
}

// Cluster (blocks of the split above) per (batch b, kv head g) = blockIdx.y. HPW:
// heads per warp (rep <= 4 * HPW); DPL: head dims per lane (hd <= 32 * DPL).
// Shared memory: the K/V ring (2 stages of K then V, kTile rows each), then
// q (rep x hd floats), the scores (rep x kTile), acc (rep x hd) and (m, l)
// (rep x 2) of the merge.
template <typename T, int HPW, int DPL>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, const int* __restrict__ slot_pos,
              const int* __restrict__ pos_ptr, const int* __restrict__ rows, int pos_stride,
              int S, int K, int hd, int rep, int window, int span, float scale) {
  constexpr int TK = kTile<T>;
  constexpr int NHG = kThreads / TK;                  // head groups in the score pass
  constexpr int HPA = (4 * HPW + NHG - 1) / NHG;      // heads per thread there
  constexpr int VEC = 16 / (int)sizeof(T);            // elements per 16-byte copy
  constexpr int KPL = TK / 32;                        // keys per lane in the softmax
  extern __shared__ __align__(16) unsigned char smem[];
  const int rstride = row_stride(hd, (int)sizeof(T));
  const int stage_bytes = 2 * TK * rstride;
  float* qs = reinterpret_cast<float*>(smem + 2 * stage_bytes);
  float* sc = qs + rep * hd;
  float* accs = sc + rep * TK;
  float* mls = accs + rep * hd;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)gridDim.x;  // one cluster spans x
  const int bg = blockIdx.y, b = bg / K, g = bg - b * K;
  const long long cb = rows != nullptr ? __ldg(rows + b) : b;  // the cache row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Split sp = block_split<TK>(pos_ptr + b * pos_stride, slot_pos != nullptr, window, span,
                                   rank, csize);
  const int pos = sp.pos, lo = sp.lo, t_begin = sp.t_begin, t_end = sp.t_end;
  // this query row's ring: cache row cb's slot positions with ``rows``
  const int* ring_pos = slot_pos == nullptr ? nullptr : slot_pos + (rows != nullptr ? cb * S : 0);

  // whether slot ``s`` holds a key this query attends to
  auto valid = [&](int s) {
    if (s >= S) return false;
    const int kp = ring_pos != nullptr ? ring_pos[s] : s;
    return kp >= lo && kp <= pos;
  };

  // this thread's copies of a tile: 16-byte chunk c of row j of K (which 0)
  // or V (1), stepping kThreads copies at a time
  const int cpr = hd / VEC;  // copies per row
  const int step_j = kThreads / cpr, step_c = kThreads - step_j * cpr;
  const int first_j = tid / cpr, first_c = tid - first_j * cpr;
  auto issue = [&](int t, int stage) {
    const int k0 = t * TK;
    unsigned char* dst = smem + stage * stage_bytes;
    int which = 0, j = first_j, c = first_c;
    while (j >= TK) {
      j -= TK;
      ++which;
    }
    for (int i = tid; i < 2 * TK * cpr; i += kThreads) {
      const int s = k0 + j;
      const bool ok = valid(s);
      const T* src = (which ? v : k) +
                     ((cb * S + (ok ? s : 0)) * K + g) * hd + c * VEC;
      const uint32_t d = static_cast<uint32_t>(
          __cvta_generic_to_shared(dst + which * TK * rstride + j * rstride + c * 16));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                   "r"(ok ? 16 : 0)
                   : "memory");
      c += step_c;
      j += step_j;
      if (c >= cpr) {
        c -= cpr;
        ++j;
      }
      while (j >= TK) {
        j -= TK;
        ++which;
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  const T* qg = q + static_cast<long long>(bg) * rep * hd;
  for (int i = tid; i < rep * hd; i += kThreads) qs[i] = to_f32(qg[i]);

  float m[HPW], l[HPW], acc[HPW][DPL];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.0f;
  }
  const bool has_dims = lane * DPL < hd;

  if (t_begin < t_end) issue(t_begin, 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      issue(t + 1, stage ^ 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // tile t (and q) visible to every thread
    const unsigned char* kt = smem + stage * stage_bytes;
    const unsigned char* vt = kt + TK * rstride;
    const int k0 = t * TK;

    {  // scores: thread (key j, head group hg)
      const int j = tid % TK, hg = tid / TK;
      const bool ok = valid(k0 + j);
      float s[HPA], s2[HPA];
#pragma unroll
      for (int i = 0; i < HPA; ++i) s[i] = s2[i] = 0.0f;
      if (ok) {
        const unsigned char* kr = kt + j * rstride;
        for (int d = 0; d < hd; d += VEC) {
          float kf[VEC];
          load_vals<T, VEC>(kr + d * sizeof(T), kf);
#pragma unroll
          for (int i = 0; i < HPA; ++i) {
            const int h = hg + NHG * i;
            if (h < rep) {
              const float4* qr = reinterpret_cast<const float4*>(qs + h * hd + d);
#pragma unroll
              for (int e = 0; e < VEC / 4; ++e) {
                const float4 qv = qr[e];
                s[i] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1];
                s2[i] += qv.z * kf[4 * e + 2] + qv.w * kf[4 * e + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < HPA; ++i) s[i] += s2[i];
#pragma unroll
      for (int i = 0; i < HPA; ++i) {
        const int h = hg + NHG * i;
        if (h < rep) sc[h * TK + j] = ok ? s[i] * scale : kNegInf;
      }
    }
    __syncthreads();

    // softmax per head: warp takes heads warp + 4i; p replaces the scores
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int h = warp + 4 * i;
      if (h < rep) {
        float x[KPL], mt = kNegInf;
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          x[kk] = sc[h * TK + lane + 32 * kk];
          mt = fmaxf(mt, x[kk]);
        }
        const float mn = fmaxf(m[i], warp_max(mt));
        const float corr = expf(m[i] - mn);
        float ps = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          const float p = x[kk] > kNegInf ? expf(x[kk] - mn) : 0.0f;
          ps += p;
          sc[h * TK + lane + 32 * kk] = round_to<T>(p);
        }
        l[i] = l[i] * corr + warp_sum(ps);
        m[i] = mn;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] *= corr;
      }
    }
    __syncwarp();
    if (has_dims) {
      for (int j = 0; j < TK; j += 4) {
        float4 pj[HPW];
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          const int h = warp + 4 * i;
          pj[i] = h < rep ? *reinterpret_cast<const float4*>(sc + h * TK + j)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float vf[DPL];
          load_vals<T, DPL>(vt + (j + jj) * rstride + lane * DPL * sizeof(T), vf);
#pragma unroll
          for (int i = 0; i < HPW; ++i) {
            const float p = lane_of(pj[i], jj);
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[i][e] += p * vf[e];
          }
        }
      }
    }
    __syncthreads();  // the stage and the scores are reused
  }

  // publish this block's (m, l, acc), then merge a slice of the outputs
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = warp + 4 * i;
    if (h < rep) {
      if (lane == 0) {
        mls[2 * h] = m[i];
        mls[2 * h + 1] = l[i];
      }
      if (has_dims) {
#pragma unroll
        for (int e = 0; e < DPL; ++e) accs[h * hd + lane * DPL + e] = acc[i][e];
      }
    }
  }
  cluster.sync();
  T* og = out + static_cast<long long>(bg) * rep * hd;
  for (int idx = rank * kThreads + tid; idx < rep * hd; idx += csize * kThreads) {
    const int h = idx / hd;
    float mx = kNegInf;
    for (int r = 0; r < csize; ++r) mx = fmaxf(mx, cluster.map_shared_rank(mls, r)[2 * h]);
    float lsum = 0.0f, a = 0.0f;
    for (int r = 0; r < csize; ++r) {
      const float* rml = cluster.map_shared_rank(mls, r);
      const float w = expf(rml[2 * h] - mx);
      lsum += rml[2 * h + 1] * w;
      a += cluster.map_shared_rank(accs, r)[idx] * w;
    }
    og[idx] = from_f32<T>(a / fmaxf(lsum, 1e-20f));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---- bfloat16: mma.sync tensor cores (helpers in mma_sync.cuh) -------------

// bfloat16. MT: 16-row m tiles of the group's heads (rep <= 16 * MT); D:
// the padded head dim's bound (hdp <= D). Each warp takes 16 keys of every
// tile (two 8-key n blocks) and keeps its own (m, l, acc) for the group's
// rows; thread (lane) holds rows lane/4 and lane/4 + 8 of each m tile.
// Shared memory: the K/V ring (2 stages of K then V, 64 rows each, at
// rstride), q (16 MT rows at rstride), later reused for the warps'
// (m, l, acc) of the merge.
template <int MT, int D, int NS>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ slot_pos, const int* __restrict__ pos_ptr,
                  const int* __restrict__ rows, int pos_stride, int S, int K, int hd, int rep,
                  int window, int span, float scale_log2) {
  constexpr int TK = kTile<__nv_bfloat16>;   // 64 keys: 16 a warp
  constexpr int NB = D / 8;                  // n blocks of the PV product at most
  extern __shared__ __align__(16) unsigned char smem[];
  const int hdp = (hd + 15) / 16 * 16;       // QK depth, 16 a k step
  const int rstride = row_stride(hdp, 2);
  const int stage_bytes = 2 * TK * rstride;
  unsigned char* qs = smem + NS * stage_bytes;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)gridDim.x;  // one cluster spans x
  const int bg = blockIdx.y, b = bg / K, g = bg - b * K;
  const long long cb = rows != nullptr ? __ldg(rows + b) : b;  // the cache row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Split sp = block_split<TK>(pos_ptr + b * pos_stride, slot_pos != nullptr, window, span,
                                   rank, csize);
  const int pos = sp.pos, lo = sp.lo, t_begin = sp.t_begin, t_end = sp.t_end;
  // this query row's ring: cache row cb's slot positions with ``rows``
  const int* ring_pos = slot_pos == nullptr ? nullptr : slot_pos + (rows != nullptr ? cb * S : 0);

  auto valid = [&](int s) {
    if (s >= S) return false;
    const int kp = ring_pos != nullptr ? ring_pos[s] : s;
    return kp >= lo && kp <= pos;
  };

  // a warp's copies of its 16 keys of tile t: lane i copies row i & 15 of K
  // (i < 16) or V, chunk by chunk; chunks past hd and invalid slots are
  // zero-filled (hd 120 -> 128)
  const int cpr = hdp / 8;  // 16-byte chunks per row
  const int which = lane >> 4, j = lane & 15;
  const __nv_bfloat16* kv = which ? v : k;
  auto issue = [&](int t) {
    if (t < t_end) {
      const int s = t * TK + warp * 16 + j;
      const bool ok = valid(s);
      const __nv_bfloat16* src = kv + ((cb * S + (ok ? s : 0)) * K + g) * hd;
      const uint32_t dst = smem_u32(smem + (t - t_begin) % NS * stage_bytes) +
                           (which * TK + warp * 16 + j) * rstride;
      for (int c = 0; c < cpr; ++c) {
        const bool in = ok && c * 8 < hd;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst + c * 16),
                     "l"(src + (in ? c * 8 : 0)), "r"(in ? 16 : 0)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  // NS - 1 tiles in flight ahead of the one computed (empty groups past the
  // block's last tile keep the count)
  for (int i = 0; i < NS - 1; ++i) issue(t_begin + i);
  // q rows of the group's heads, zero past rep and past hd
  const __nv_bfloat16* qg = q + static_cast<long long>(bg) * rep * hd;
  for (int i = tid; i < 16 * MT * hdp; i += kThreads) {
    const int r = i / hdp, d = i - r * hdp;
    reinterpret_cast<__nv_bfloat16*>(qs + r * rstride)[d] =
        r < rep && d < hd ? qg[r * hd + d] : __float2bfloat16_rn(0.0f);
  }

  float m[MT][2], l[MT][2], o[MT][NB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kNegInf;
      l[mt][h] = 0.0f;
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nb][e] = 0.0f;

  // ldmatrix row addresses: lane gives row (lane & 7) of matrix lane >> 3
  const int lrow = lane & 7, lmat = lane >> 3;
  __syncthreads();  // q visible to every warp; from here on a warp reads only its own keys
  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % NS;
    asm volatile("cp.async.wait_group %0;" ::"n"(NS - 2) : "memory");
    __syncwarp();  // tile t's rows visible to the warp
    const uint32_t kt = smem_u32(smem + stage * stage_bytes) + warp * 16 * rstride;
    const uint32_t vt = kt + TK * rstride;
    const int k0 = t * TK + warp * 16;

    // S (16 MT rows x this warp's 16 keys) = q K^T
    float sc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      if (ks * 16 < hdp) {
        // K: matrices (keys 0-7, k lo), (0-7, k hi), (8-15, lo), (8-15, hi)
        uint32_t kb[4];
        ldsm_x4(kt + ((lmat >> 1) * 8 + lrow) * rstride + (ks * 16 + (lmat & 1) * 8) * 2, kb);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // q: matrices (rows 0-7, k lo), (8-15, lo), (0-7, hi), (8-15, hi)
          uint32_t qa[4];
          ldsm_x4(smem_u32(qs) + (mt * 16 + (lmat & 1) * 8 + lrow) * rstride +
                      (ks * 16 + (lmat >> 1) * 8) * 2,
                  qa);
          mma_bf16(sc[mt][0], qa, kb[0], kb[1]);
          mma_bf16(sc[mt][1], qa, kb[2], kb[3]);
        }
      }
    }

    // online softmax over the warp's 16 keys: thread's keys 2(lane%4) + e of
    // n block n, its rows lane/4 (e < 2) and lane/4 + 8 (e >= 2)
    bool ok[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) ok[n][e] = valid(k0 + 8 * n + 2 * (lane & 3) + e);
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[mt][h];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[mt][n][2 * h + e];
            x = ok[n][e] ? x * scale_log2 : kNegInf;
            mx = fmaxf(mx, x);
          }
        mx = quad_max(mx);
        const float corr = exp2f(m[mt][h] - mx);
        m[mt][h] = mx;
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[mt][n][2 * h + e];
            x = ok[n][e] ? exp2f(x - mx) : 0.0f;
            sum += x;
          }
        l[mt][h] = l[mt][h] * corr + sum;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          o[mt][nb][2 * h] *= corr;
          o[mt][nb][2 * h + 1] *= corr;
        }
      }
      // p as the A fragment of the PV product (k = the warp's 16 keys)
      pa[mt][0] = pack_bf16(sc[mt][0][0], sc[mt][0][1]);
      pa[mt][1] = pack_bf16(sc[mt][0][2], sc[mt][0][3]);
      pa[mt][2] = pack_bf16(sc[mt][1][0], sc[mt][1][1]);
      pa[mt][3] = pack_bf16(sc[mt][1][2], sc[mt][1][3]);
    }

    // O += P V: V matrices (keys 0-7, dims n), (8-15, n), (0-7, n+8), (8-15, n+8)
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      if (nb * 8 < hdp) {
        uint32_t vb[4];
        ldsm_x4_t(vt + ((lmat & 1) * 8 + lrow) * rstride + (nb * 8 + (lmat >> 1) * 8) * 2, vb);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][nb], pa[mt], vb[0], vb[1]);
          mma_bf16(o[mt][nb + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
    __syncwarp();  // the warp is done with this stage before it is refilled
    issue(t + NS - 1);
  }

  // publish each warp's (m, l, acc) rows < rep in the ring's place
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  float* accs = reinterpret_cast<float*>(smem);        // [warp][rep][hd]
  float* mls = accs + kWarps * rep * hd;                // [warp][rep][2]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + h * 8 + (lane >> 2);
      const float lsum = quad_sum(l[mt][h]);
      if (r < rep) {
        if ((lane & 3) == 0) {
          mls[(warp * rep + r) * 2] = m[mt][h];
          mls[(warp * rep + r) * 2 + 1] = lsum;
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = nb * 8 + 2 * (lane & 3) + e;
            if (d < hd) accs[(warp * rep + r) * hd + d] = o[mt][nb][2 * h + e];
          }
      }
    }
  __syncthreads();
  // the block's four warps merged here, so that the cluster merges one
  // partial state per block
  float* cacc = mls + kWarps * rep * 2;  // [rep][hd]
  float* cml = cacc + rep * hd;          // [rep][2]
  for (int idx = tid; idx < rep * hd; idx += kThreads) {
    const int h = idx / hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mls[(w * rep + h) * 2]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(mls[(w * rep + h) * 2] - mx);
      lsum += mls[(w * rep + h) * 2 + 1] * wt;
      a += accs[w * rep * hd + idx] * wt;
    }
    cacc[idx] = a;
    if (idx - h * hd == 0) {
      cml[2 * h] = mx;
      cml[2 * h + 1] = lsum;
    }
  }
  cluster.sync();
  __nv_bfloat16* og = out + static_cast<long long>(bg) * rep * hd;
  for (int idx = rank * kThreads + tid; idx < rep * hd; idx += csize * kThreads) {
    const int h = idx / hd;
    float mx = kNegInf;
    for (int r = 0; r < csize; ++r) mx = fmaxf(mx, cluster.map_shared_rank(cml, r)[2 * h]);
    float lsum = 0.0f, a = 0.0f;
    for (int r = 0; r < csize; ++r) {
      const float* rml = cluster.map_shared_rank(cml, r);
      const float wt = exp2f(rml[2 * h] - mx);
      lsum += rml[2 * h + 1] * wt;
      a += cluster.map_shared_rank(cacc, r)[idx] * wt;
    }
    og[idx] = __float2bfloat16_rn(a / fmaxf(lsum, 1e-20f));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int HPW, int DPL>
int launch_f32(const void* q, const void* k, const void* v, void* out, const int* slot_pos,
               const int* pos, const int* rows, int pos_stride, int B, int S, int H, int K,
               int hd, int window, int span, int cluster, float scale, cudaStream_t st) {
  constexpr int TK = kTile<float>;
  const int rep = H / K;
  const size_t smem = 2 * 2 * (size_t)TK * row_stride(hd, 4) +
                      sizeof(float) * ((size_t)2 * rep * hd + (size_t)rep * TK + 2 * rep);
  return cluster_launch(decode_kernel<float, HPW, DPL>, dim3(cluster, B * K), kThreads, smem,
                        st, static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(out), slot_pos, pos, rows,
                        pos_stride, S, K, hd, rep, window, span, scale);
}

template <int MT, int D, int NS>
int launch_bf16(const void* q, const void* k, const void* v, void* out, const int* slot_pos,
                const int* pos, const int* rows, int pos_stride, int B, int S, int H, int K,
                int hd, int window, int span, int cluster, float scale, cudaStream_t st) {
  constexpr int TK = kTile<__nv_bfloat16>;
  const int rep = H / K;
  const size_t rs = row_stride((hd + 15) / 16 * 16, 2);
  const size_t tiles_and_q = NS * 2 * TK * rs + 16 * MT * rs;
  const size_t merge = sizeof(float) * (kWarps + 1) * rep * ((size_t)hd + 2);
  return cluster_launch(decode_mma_kernel<MT, D, NS>, dim3(cluster, B * K), kThreads,
                        tiles_and_q > merge ? tiles_and_q : merge, st,
                        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                        static_cast<const __nv_bfloat16*>(v),
                        static_cast<__nv_bfloat16*>(out), slot_pos, pos, rows, pos_stride, S, K,
                        hd, rep, window, span, scale * kLog2e);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, const int* slot_pos,
             const int* pos, const int* rows, int pos_stride, int B, int S, int H, int K,
             int hd, int window, int span, int cluster, float scale, cudaStream_t st) {
  constexpr int TK = kTile<T>;
  // the plan must span every key a position can attend to: the S slots'
  // tiles (a ring, or no window), or a window's ceil(window / TK) + 1
  const int all = (S + TK - 1) / TK;
  const int want = slot_pos != nullptr || window <= 0 ? all : min(all, (window + TK - 1) / TK + 1);
  if (span != want || cluster < 1 || cluster > kMaxCluster || cluster > span)
    return (int)cudaErrorInvalidValue;
  const int rep = H / K;
#define DECODE_ARGS \
  q, k, v, out, slot_pos, pos, rows, pos_stride, B, S, H, K, hd, window, span, cluster, scale, st
  if constexpr (sizeof(T) == 2) {
    const int hdp = (hd + 15) / 16 * 16;
    if (rep <= 16) {
      if (hdp <= 64) return launch_bf16<1, 64, 3>(DECODE_ARGS);
      if (hdp <= 128) return launch_bf16<1, 128, 3>(DECODE_ARGS);
      return launch_bf16<1, 256, 2>(DECODE_ARGS);
    }
    if (hdp <= 64) return launch_bf16<2, 64, 3>(DECODE_ARGS);
    if (hdp <= 128) return launch_bf16<2, 128, 3>(DECODE_ARGS);
    return launch_bf16<2, 256, 2>(DECODE_ARGS);
  } else {
#define DECODE_DIMS(HPW)                                 \
  if (hd <= 64) return launch_f32<HPW, 2>(DECODE_ARGS);  \
  if (hd <= 128) return launch_f32<HPW, 4>(DECODE_ARGS); \
  return launch_f32<HPW, 8>(DECODE_ARGS)
    if (rep <= 4) { DECODE_DIMS(1); }
    if (rep <= 8) { DECODE_DIMS(2); }
    DECODE_DIMS(8);
#undef DECODE_DIMS
  }
#undef DECODE_ARGS
}

}  // namespace

extern "C" {

// q, out: (B,H,hd); k, v: (B,S,K,hd); all contiguous, k and v 16-byte
// aligned; dtype 0 = float32 or 1 = bfloat16; H % K == 0 with H / K <= 32;
// hd a multiple of 8, at most 256. slot_pos: null for a linear cache, else
// the (S,) int32 slot positions of a ring, or with rows (N,S), one ring a
// cache row. pos: int32 on the device, the query's position, one for the
// batch (pos_stride 0) or one a row (pos_stride 1; the caller keeps a
// linear cache's in [0, S)). rows: null (query row b reads k, v row b) or
// (B,) int32 cache rows, each in k's rows; a ring without rows takes one
// position. window 0 for none. The
// plan (span, cluster) is kernels/decode_attention.py
// ``decode_launch_plan``'s, in tiles of 64 keys (bfloat16) or 32 (float32).
int decode_attention(const void* q, const void* k, const void* v, void* out, const void* slot_pos,
                     const void* pos, const void* rows, int B, int S, int H, int K, int hd,
                     int window, int span, int cluster, int pos_stride, float scale, int dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || H / K > kMaxGroup || hd <= 0 || hd % 8 != 0 || hd > 256 ||
      S <= 0 || window < 0 || pos == nullptr || (pos_stride != 0 && pos_stride != 1) ||
      (slot_pos != nullptr && rows == nullptr && pos_stride != 0))
    return (int)cudaErrorInvalidValue;
  const int* sp = static_cast<const int*>(slot_pos);
  const int* pp = static_cast<const int*>(pos);
  const int* rp = static_cast<const int*>(rows);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, sp, pp, rp, pos_stride, B, S, H, K, hd, window, span,
                           cluster, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, sp, pp, rp, pos_stride, B, S, H, K, hd, window,
                                   span, cluster, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
