// Block-table flash-decode attention over a paged KV pool on Hopper
// (sm_90a), bound through a plain C interface (ctypes, see
// kernels/build.py and kernels/paged_decode_attention.py).
//
// Replaces the four Pallas TPU kernels of
// src/repro/kernels/paged_decode_attention.py:
//   ragged_paged_decode_attention_pallas       (ragged, bf16 pages)
//   ragged_paged_decode_attention_int8_pallas  (ragged, int8 pages)
//   paged_decode_attention_pallas              (per-row pos, bf16 pages)
//   paged_decode_attention_int8_pallas         (per-row pos, int8 pages)
// One decode query per row, q (R,H,hd), against a pool (P, ps, K, hd)
// through a block table (R, nb); key kpos of row r is valid iff
// kpos <= pos[r] and, with a window, kpos > pos[r] - window. Table entries
// are clamped into [0, P). Int8 pages carry float32 scales (P, ps, K, 1),
// one per (position, kv head). A ragged row with phase 0 writes zeros and
// reads no page.
//
// What bounds it: bytes. Each live key's K and V rows are read once and
// serve rep = H/K query heads: about 2*rep flops per byte in bf16 and
// 4*rep in int8, far below the card's ridge.
//
// Two templates; the C entry point picks one by (phase given, int8 pages,
// q's dtype):
//   * paged_split_kernel, for bf16 q with bf16 pages and a phase (the
//     ragged bf16 step) or with int8 pages and no phase (the signature int8
//     step);
//   * paged_kernel, for the other forms (ragged int8, per-row-pos bf16)
//     and for float32 q, where mma.sync would round q to bf16 or TF32,
//     outside float32's 1e-5.
// Both walk a row's keys [lo, hi]: lo the window's first key, hi = min(pos,
// nb * ps - 1). The TPU kernel's ragged index map stops at the same page,
// and the per-row-pos forms stop there too: the pages past pos hold only
// masked keys, whose weights are exact zeros. The TPU kernels' block_k
// sub-page tile has no counterpart: the walk is the same for every block_k
// the wrappers accept.
//
// paged_split_kernel: one launch, one thread-block cluster per (kv head,
// row) splitting the row's keys. kernels/paged_decode_attention.py
// ``paged_split_plan`` sizes the cluster on the host from shapes alone: the
// keys a row can reach (nb * ps, at most the window) in 64-key tiles, at
// most 8 blocks (the portable cluster size), the fewest tiles a block that
// keep it there. It never reads pos, which lives on the device (reading it
// would synchronise, and would bar capturing the step in a CUDA graph).
// Each block finds its own range on the device: the row's tiles counted
// from lo, split evenly over the cluster's blocks by rank. A block whose
// range is empty still reaches both cluster barriers, holding (-inf, 0, 0).
// A row at phase 0 ends its whole cluster before any page is read (every
// block reads the same phase[r]) and writes exact zeros.
//   Four warps a block, each owning 16 keys of every tile. Lane i reads
// the table entry of its warp's key i % 16 (clamped into [0, P)) and
// resolves the key's pool row; the warp then copies its 32 rows (16 K, 16
// V) into a ring of shared-memory stages with cp.async, 8 elements a copy
// (16 bytes bf16, 8 int8), consecutive lanes on consecutive bytes of a row
// (a key's rows are K * hd elements from the next key's), and for int8
// pages each key's two scales beside them; keys past the range
// are zero-filled, not read. Up to ``stages`` (at most 3) of a block's
// tiles are in flight before the first is computed; a warp reads only the
// rows it copied, so it waits for no other warp until the merge.
//   The products run on mma.sync m16n8k16, transposed so that the group's
// heads (rep <= 8) are the 8 columns and no operand row is padding: S^T
// (16 keys x 8 heads) = K q^T, with q's fragments loaded once from global
// memory into registers; softmax down the columns in the log2 domain;
// O^T (16 dims x 8 heads) += V^T P, V by ldmatrix.trans, P moved from
// the S^T accumulator into the B operand by movmatrix. Head dims are
// padded to 64 or 128 (zeros past hd), so that the copy layout and the
// loops are fixed at compile time. The four warps' (m, l, acc) merge in
// shared memory, then the cluster's blocks through distributed shared
// memory behind two cluster barriers, as in decode_attention.cu.
//   bf16 pages: p is rounded to bf16 as PV's operand, as the Pallas kernel
// casts it. int8 pages: each lane widens one of its warp's 32 rows to
// bf16 in the warp's scratch, exactly (two logic ops and a bf16x2 add a
// pair of values), so S = q . k is exact products summed in float32, then
// times the key's k scale. PV keeps the float32 form's w = p * v_scale: it
// goes in as two bf16 operands, hi = bf16(w) and lo = bf16(w - hi)
// (|w - hi - lo| <= 2^-16 |w|), two products into the same float32
// accumulators.
//
// paged_kernel: one block per (kv head, row), sixteen warps (eight for
// wide head groups, see Warps). The warps take 32-key groups of the walk
// in turn. A lane owns one key of its group: it resolves the key's page
// through the table, reads the key's K and V rows with 16-byte loads, 64
// elements of each in flight at once (int8 rows dequantized by their
// scales), forms the group's rep scores against q, which the block keeps
// in shared memory in float32, and stages the V row in the warp's shared
// tile (odd row stride: conflict-free). The warp then runs the online
// softmax with float32 m, l and acc (acc split over lanes by head
// dimension) and the PV sum reads the staged rows. p is rounded to the
// pages' dtype before PV for bf16/float32 pages, as the TPU kernel casts
// it; int8 pages stay in float32. Last, the warps' (m, l, acc) are merged
// through shared memory and acc / max(l, 1e-20) is written in q's dtype.
//
// What the versions taught, at the serve path's shape (R 16, H 32, K 8,
// hd 64, rows' positions spread over 640 keys, 12 rows live; chip_smoke.py
// phase 11; an H100 SXM): paged_kernel's first version, with four warps
// and each V row read inside the PV loop, took 90 us; staging V cut it to
// 68, keeping all of a row's loads in flight to 64, sixteen warps to 39,
// and the head group in registers sized at compile time (REP) with
// 16-byte reads of q to 25. It is bound by issued instructions and
// latency, not bytes: a block per (row, kv head) gives 128 blocks, and the
// longest row's warps walk its keys alone, per-key dot products on CUDA
// cores. paged_split_kernel splits that walk over a cluster and moves the
// products to tensor cores: 14.4 us (bf16 pages) and 19.3 (int8) with a
// lane a row and the heads as padded A rows; 11.7 and 15.2 with the
// products transposed; 9.0 and 11.3 with the copies coalesced (and 80
// registers, six blocks an SM: the 640 blocks in one wave); about 8 and
// 10 with the copy layout fixed at compile time and the page offsets
// stepped a tile at a time instead of divided; 7.7 and 9.9 with the last
// cluster barrier relaxed (it only keeps shared memory alive) and the
// int8 widening by bf16x2 adds instead of float adds. Reading the table entries before
// pos (an even split cannot) and pushing the blocks' states into one
// block's shared memory behind a single barrier were both slower here.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

// Warps per block: sixteen where a lane's accumulators (REP x HDV floats)
// fit the 128 registers a 512-thread block leaves it, else eight.
template <int REP, int HDV> struct Warps {
  static constexpr int value = REP * HDV <= 8 ? 16 : 8;
};
constexpr int kMaxRep = 8;  // query heads per kv head; MAX_GROUP in the wrapper
// Head dims up to 128 (MAX_HEAD_DIM in the wrapper): the widest of the
// port's dense decoders. Past it the staged V rows and the warps' partial
// accumulators outgrow the 227 KB of shared memory a block may take.
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p as the PV product takes it: rounded to bf16/float32 pages' dtype, kept
// in float32 for int8 pages.
template <typename E> __device__ __forceinline__ float round_p(float x) {
  return to_f32(from_f32<E>(x));
}
template <> __device__ __forceinline__ float round_p<int8_t>(float x) { return x; }

// Eight consecutive elements of a row, loaded raw from an address aligned
// to 8 elements (one 16-byte load for bf16, 8 bytes for int8), then widened
// to float32. Loading a row's chunks first and widening after keeps all of
// a lane's loads in flight at once.
template <typename E> struct Chunk8;
template <> struct Chunk8<__nv_bfloat16> { uint4 r; };
template <> struct Chunk8<float> { float4 a, b; };
template <> struct Chunk8<int8_t> { uint2 r; };

__device__ __forceinline__ Chunk8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ Chunk8<float> load8(const float* p) {
  return {reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
}
__device__ __forceinline__ Chunk8<int8_t> load8(const int8_t* p) {
  return {*reinterpret_cast<const uint2*>(p)};
}
__device__ __forceinline__ void widen(const Chunk8<__nv_bfloat16>& c, float* out) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&c.r);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void widen(const Chunk8<float>& c, float* out) {
  out[0] = c.a.x; out[1] = c.a.y; out[2] = c.a.z; out[3] = c.a.w;
  out[4] = c.b.x; out[5] = c.b.y; out[6] = c.b.z; out[7] = c.b.w;
}
__device__ __forceinline__ void widen(const Chunk8<int8_t>& c, float* out) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&c.r);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(v[i]);
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

// T: q and out; E: pages (T, or int8_t with scales); REP >= rep query heads
// per kv head held in registers; HDV head dims per lane. Block (kv head g,
// row r).
template <typename T, typename E, bool kInt8, int REP, int HDV>
__global__ void __launch_bounds__(Warps<REP, HDV>::value * 32)
paged_kernel(const T* __restrict__ q, const E* __restrict__ kp, const E* __restrict__ vp,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ bt, const int* __restrict__ pos,
             const int* __restrict__ phase, T* __restrict__ out, int K, int hd, int rep, int P,
             int ps, int nb, int window, float scale) {
  constexpr int kWarps = Warps<REP, HDV>::value;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // rep x hd
  float* wm = qs + rep * hd;                 // kWarps x REP
  float* wl = wm + kWarps * REP;             // kWarps x REP
  float* wacc = wl + kWarps * REP;           // kWarps x rep x hd
  float* vst = wacc + kWarps * rep * hd;     // kWarps x 32 x (hd + 1)
  const int g = blockIdx.x, r = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long qoff = ((long long)r * K * rep + (long long)g * rep) * hd;

  if (phase != nullptr && phase[r] == 0) {
    for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) out[qoff + i] = from_f32<T>(0.0f);
    return;
  }
  const int p_r = pos[r];
  const int hi = min(p_r, nb * ps - 1);  // the row's last key
  const int lo = window > 0 ? max(0, p_r - window + 1) : 0;
  for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) qs[i] = to_f32(q[qoff + i]);
  __syncthreads();

  float m[REP], l[REP], acc[REP][HDV];
#pragma unroll
  for (int h = 0; h < REP; ++h) {
    m[h] = kNegInf;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < HDV; ++e) acc[h][e] = 0.0f;
  }
  const int* btr = bt + (long long)r * nb;

  float* vw = vst + warp * 32 * (hd + 1);  // this warp's 32 staged V rows
  for (int base = lo + warp * 32; base <= hi; base += kWarps * 32) {
    const int kpos = base + lane;
    const bool valid = kpos <= hi;
    float s[REP];
#pragma unroll
    for (int h = 0; h < REP; ++h) s[h] = 0.0f;
    float* vrow_s = vw + lane * (hd + 1);  // odd stride: conflict-free both ways
    if (valid) {
      const int page = min(max(btr[kpos / ps], 0), P - 1);
      const long long row = ((long long)(page * ps + kpos % ps) * K + g);
      const E* krow = kp + row * hd;
      const E* vrow = vp + row * hd;
      const float vsc = kInt8 ? vs[row] : 1.0f;
      for (int d0 = 0; d0 < hd; d0 += 64) {  // 64 elements of K and V in flight
        Chunk8<E> kc[8], vc[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (d0 + 8 * c < hd) {
            kc[c] = load8(krow + d0 + 8 * c);
            vc[c] = load8(vrow + d0 + 8 * c);
          }
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int d = d0 + 8 * c;
          if (d < hd) {
            float kx[8], vx[8];
            widen(kc[c], kx);
            widen(vc[c], vx);
#pragma unroll
            for (int i = 0; i < 8; ++i) vrow_s[d + i] = vx[i] * vsc;
#pragma unroll
            for (int h = 0; h < REP; ++h) {
              if (h < rep) {
                const float4* qh = reinterpret_cast<const float4*>(qs + h * hd + d);
                const float4 qa = qh[0], qb = qh[1];
                s[h] += qa.x * kx[0];
                s[h] += qa.y * kx[1];
                s[h] += qa.z * kx[2];
                s[h] += qa.w * kx[3];
                s[h] += qb.x * kx[4];
                s[h] += qb.y * kx[5];
                s[h] += qb.z * kx[6];
                s[h] += qb.w * kx[7];
              }
            }
          }
        }
      }
      if (kInt8) {
        const float ksc = ks[row];
#pragma unroll
        for (int h = 0; h < REP; ++h) s[h] *= ksc;
      }
    } else {
      for (int d = 0; d < hd; ++d) vrow_s[d] = 0.0f;
    }
    __syncwarp();
    float pv[REP];
#pragma unroll
    for (int h = 0; h < REP; ++h) {
      pv[h] = 0.0f;
      if (h < rep) {
        const float sh = valid ? s[h] * scale : kNegInf;
        const float m_new = fmaxf(m[h], warp_max(sh));
        const float corr = expf(m[h] - m_new);
        const float p = valid ? expf(sh - m_new) : 0.0f;
        l[h] = l[h] * corr + warp_sum(p);
        m[h] = m_new;
        pv[h] = round_p<E>(p);
#pragma unroll
        for (int e = 0; e < HDV; ++e) acc[h][e] *= corr;
      }
    }
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      float pj[REP];
#pragma unroll
      for (int h = 0; h < REP; ++h)
        if (h < rep) pj[h] = __shfl_sync(0xffffffffu, pv[h], j);
      const float* vj = vw + j * (hd + 1);
#pragma unroll
      for (int e = 0; e < HDV; ++e) {
        const int d = lane + 32 * e;
        if (d < hd) {
          const float vx = vj[d];
#pragma unroll
          for (int h = 0; h < REP; ++h)
            if (h < rep) acc[h][e] += pj[h] * vx;
        }
      }
    }
    __syncwarp();  // the next group overwrites the staged rows
  }

  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < REP; ++h) {
      wm[warp * REP + h] = m[h];
      wl[warp * REP + h] = l[h];
    }
  }
#pragma unroll
  for (int h = 0; h < REP; ++h) {
    if (h < rep) {
#pragma unroll
      for (int e = 0; e < HDV; ++e) {
        const int d = lane + 32 * e;
        if (d < hd) wacc[(warp * rep + h) * hd + d] = acc[h][e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) {
    const int h = i / hd, d = i - h * hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * REP + h]);
    float lsum = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w * REP + h] - mx);
      lsum += wl[w * REP + h] * c;
      a += wacc[(w * rep + h) * hd + d] * c;
    }
    out[qoff + i] = from_f32<T>(a / fmaxf(lsum, 1e-20f));
  }
}

template <typename T, typename E, bool kInt8, int REP, int HDV>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const int* bt, const int* pos, const int* phase, void* out, int R, int H, int K,
           int hd, int P, int ps, int nb, int window, float scale, cudaStream_t st) {
  const int rep = H / K;
  constexpr int kWarps = Warps<REP, HDV>::value;
  const size_t smem =
      sizeof(float) * ((size_t)rep * hd + 2 * kWarps * kMaxRep + (size_t)kWarps * rep * hd +
                       (size_t)kWarps * 32 * (hd + 1));
  auto kernel = paged_kernel<T, E, kInt8, REP, HDV>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(K, R), kWarps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), bt, pos, phase,
      static_cast<T*>(out), K, hd, rep, P, ps, nb, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename E, bool kInt8>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const int* bt, const int* pos, const int* phase, void* out, int R, int H, int K,
             int hd, int P, int ps, int nb, int window, float scale, cudaStream_t st) {
#define PAGED_LAUNCH(REP, HDV)                                                              \
  return launch<T, E, kInt8, REP, HDV>(q, k, v, ks, vs, bt, pos, phase, out, R, H, K, hd, P, \
                                       ps, nb, window, scale, st)
  const int rep = H / K;
  if (rep <= 4) {
    if (hd <= 64) PAGED_LAUNCH(4, 2);
    PAGED_LAUNCH(4, 4);
  }
  if (hd <= 64) PAGED_LAUNCH(8, 2);
  PAGED_LAUNCH(8, 4);
#undef PAGED_LAUNCH
}

// ---- paged_split_kernel: split-K cluster launch on mma.sync (bf16 q) ----------

constexpr int kSplitThreads = 128;               // four warps, 16 keys of a tile each
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kTileKeys = 64;                    // TILE in the wrapper
constexpr int kMaxCluster = 8;                   // MAX_CLUSTER in the wrapper
constexpr int kMaxStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
// Blocks an SM holds at once at head dims up to D, by registers (at most
// 80 a thread at D 64, 128 at D 128): 640 blocks at the serve shape (R 16,
// K 8, clusters of 5) stay resident in one wave.
template <int D> constexpr int kSplitBlocksPerSm = D <= 64 ? 6 : 4;

// The split kernel's head dims: hd padded to D = 64 or 128 (zeros past hd).
__host__ __device__ constexpr int split_dims(int hd) { return hd <= 64 ? 64 : 128; }
// bytes between two bf16 rows of D elements that ldmatrix reads: 16 past a
// multiple of 128, so that its eight row addresses hit distinct banks
__host__ __device__ constexpr int bf16_stride(int D) { return 2 * D + 16; }
// bytes between two int8 rows as copied: 8 past a multiple of 16, so that
// 16 lanes reading 8 bytes each of their own rows hit distinct banks
__host__ __device__ constexpr int int8_stride(int D) { return D + 8; }

// A stage of the ring: the tile's 64 K rows, its 64 V rows, and for int8
// pages their 64 k scales and 64 v scales (float32).
__host__ __device__ constexpr int stage_bytes(bool int8, int D) {
  return int8 ? 2 * kTileKeys * int8_stride(D) + 2 * kTileKeys * 4
              : 2 * kTileKeys * bf16_stride(D);
}

// Dynamic shared memory of a launch: the ring (and for int8 pages the
// warps' bf16 scratch of 16 K and 16 V rows each), later reused for the
// merge's (m, l, acc) of the four warps and of the block. The wrapper's
// ``paged_split_plan`` computes the same number.
__host__ __device__ __forceinline__ int split_smem_bytes(bool int8, int hd, int rep, int stages) {
  const int D = split_dims(hd);
  const int loop = stages * stage_bytes(int8, D) + (int8 ? kSplitWarps * 32 * bf16_stride(D) : 0);
  const int merge = 4 * (kSplitWarps + 1) * rep * (hd + 2);
  return loop > merge ? loop : merge;
}

// Four int8 values (one 32-bit word) as four bf16 values, exactly: byte
// b = m - 128 s (m its low 7 bits, s its sign bit); the bf16 0x4300 | m is
// 128 + m and 0xC300 | (b & 0x80) is -128 - 128 s, and their sum, b, is
// exact: two logic ops and one bf16x2 add a pair.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t p) {  // p: 0x00 b1 00 b0
  const uint32_t x = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t o = (p & 0x00800080u) | 0xC300C300u;
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                   *reinterpret_cast<const __nv_bfloat162*>(&o));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t w) {
  return make_uint2(int8x2_to_bf16x2(__byte_perm(w, 0u, 0x4140u)),
                    int8x2_to_bf16x2(__byte_perm(w, 0u, 0x4342u)));
}

// max over the 8 lanes that share lane % 4 (the rows of an accumulator column)
__device__ __forceinline__ float col_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

__device__ __forceinline__ float col_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// Cluster (kv head g = blockIdx.y, row r = blockIdx.z) of gridDim.x blocks;
// kInt8: int8 pages with scales, else bf16 pages; D: split_dims(hd); NS:
// stages of the ring. The products run transposed, with the heads (rep <=
// 8) as the 8 columns: S^T (16 keys x 8 heads) = K q^T, O^T (16 dims x 8
// heads) += V^T P, so no row of an operand is padding. A thread holds rows
// lane/4 and lane/4 + 8 (keys, or dims) of columns 2(lane%4) and
// 2(lane%4) + 1 (heads).
template <bool kInt8, int D, int NS>
__global__ void __launch_bounds__(kSplitThreads, kSplitBlocksPerSm<D>)
paged_split_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpages,
                   const void* __restrict__ vpages, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ bt,
                   const int* __restrict__ pos, const int* __restrict__ phase,
                   __nv_bfloat16* __restrict__ out, int K, int hd, int rep, int P, int ps, int nb,
                   int window, float scale_log2) {
  using E = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  constexpr int CB = 8 * (int)sizeof(E);  // bytes of one copy: 8 elements
  constexpr int MD = D / 16;              // k steps of S^T and m tiles of O^T at most
  extern __shared__ __align__(16) unsigned char sbuf[];  // paged_kernel's is float
  constexpr int CPR = D / 8;              // copies a row
  constexpr int RPI = 32 / CPR;           // rows a warp's copy instruction covers
  constexpr int rs = bf16_stride(D);
  constexpr int rse = kInt8 ? int8_stride(D) : rs;
  constexpr int sbytes = stage_bytes(kInt8, D);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)gridDim.x;  // one cluster spans x
  const int g = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const long long qoff = ((long long)r * K + g) * rep * hd;

  // the row's phase and position and q's B fragments (column gq: head gq,
  // rows: dims 2tq (+1) and + 8 of each k step; heads past rep and dims
  // past hd zero), all in flight at once
  const int ph = phase != nullptr ? phase[r] : 1;
  const int p_r = pos[r];
  uint32_t qb[MD][2];
#pragma unroll
  for (int kk = 0; kk < MD; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = kk * 16 + h * 8 + 2 * tq;
      qb[kk][h] = gq < rep && d < hd
                      ? *reinterpret_cast<const uint32_t*>(q + qoff + (long long)gq * hd + d)
                      : 0u;
    }
  if (ph == 0) {  // the whole cluster leaves; no page is read
    for (int i = rank * kSplitThreads + tid; i < rep * hd; i += csize * kSplitThreads)
      out[qoff + i] = __float2bfloat16_rn(0.0f);
    return;
  }
  // this block's keys: tiles [t_begin, t_end) of the row's keys [lo, hi] from lo
  const int hi = min(p_r, nb * ps - 1);
  const int lo = window > 0 ? max(0, p_r - window + 1) : 0;
  const int ntiles = hi >= lo ? (hi - lo + kTileKeys) / kTileKeys : 0;
  const int per = (ntiles + csize - 1) / csize;
  const int t_begin = min(ntiles, rank * per), t_end = min(ntiles, t_begin + per);

  // a warp's copies of its 16 keys of tile t: the 32 rows (K rows of keys
  // 0-15, then V rows) in CPR chunks of 8 elements each; copy instruction
  // i takes rows RPI i + lane / CPR, chunk lane % CPR, so that consecutive
  // lanes copy consecutive bytes of a row, and instruction i + CPR / 2
  // copies the V rows of the same keys; lane i also copies the scale of
  // row i for int8 pages. Lane i reads the table entry of key i % 16 and
  // resolves its row; the others take it by shuffle.
  const int which = lane >> 4, jl = lane & 15;
  const E* kp = static_cast<const E*>(kpages);
  const E* vp = static_cast<const E*>(vpages);
  const int* btr = bt + (long long)r * nb;
  const int row0 = lane / CPR, chunk = lane % CPR;
  const bool chunk_in = chunk * 8 < hd;
  // key jl of the next tile to read, tn, as (table column pg, offset off),
  // stepped a tile at a time (one division for the whole walk)
  const int key0 = lo + warp * 16 + jl;  // key jl of tile t: key0 + 64 t
  int tn = t_begin, pg = (key0 + tn * kTileKeys) / ps, off = key0 + tn * kTileKeys - pg * ps;
  const int dpg = kTileKeys / ps, doff = kTileKeys - dpg * ps;
  // (table entry, offset) of key jl of tile tn, offset -1 where the block
  // has no such key; read ahead of the copies that need it
  auto fetch = [&]() {
    const bool ok = tn < t_end && key0 + tn * kTileKeys <= hi;
    const int2 f = make_int2(ok ? btr[pg] : 0, ok ? off : -1);
    ++tn;
    pg += dpg;
    off += doff;
    if (off >= ps) {
      off -= ps;
      ++pg;
    }
    return f;
  };
  auto issue = [&](int t, int2 f) {  // f: tile t's fetch()
    if (t < t_end) {
      // key jl's row of the pool, (page * ps + offset) * K + g, or -1 past the range
      const int myrow = f.y >= 0 ? (min(max(f.x, 0), P - 1) * ps + f.y) * K + g : -1;
      unsigned char* st = sbuf + (t - t_begin) % NS * sbytes;
      const uint32_t dst = smem_u32(st) + (warp * 16 + row0) * rse + chunk * CB;
#pragma unroll
      for (int i = 0; i < CPR / 2; ++i) {
        const int rr = __shfl_sync(0xffffffffu, myrow, row0 + RPI * i);
        const bool in = rr >= 0 && chunk_in;
        const long long off = in ? (long long)rr * hd + chunk * 8 : 0;
        cp_async<CB>(dst + RPI * i * rse, kp + off, in ? CB : 0);
        cp_async<CB>(dst + (kTileKeys + RPI * i) * rse, vp + off, in ? CB : 0);
      }
      if constexpr (kInt8)
        cp_async<4>(smem_u32(st + 2 * kTileKeys * rse + (which * kTileKeys + warp * 16 + jl) * 4),
                    (which ? vs : ks) + (myrow >= 0 ? myrow : 0), myrow >= 0 ? 4 : 0);
    }
    cp_async_commit();
  };
  // NS tiles in flight, their table entries read together first (empty
  // groups past the block's last tile keep the count)
  {
    int2 f[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) f[i] = fetch();
#pragma unroll
    for (int i = 0; i < NS; ++i) issue(t_begin + i, f[i]);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, o[MD][4];
#pragma unroll
  for (int md = 0; md < MD; ++md)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[md][e] = 0.0f;

  // ldmatrix row addresses: lane gives row (lane & 7) of matrix lane >> 3
  const int lrow = lane & 7, lmat = lane >> 3;
  unsigned char* scratch = sbuf + NS * sbytes + warp * 32 * rs;  // int8: 16 K, 16 V rows
  for (int t = t_begin; t < t_end; ++t) {
    const int2 next = fetch();  // tile t + NS's, read now, used after this tile
    unsigned char* st = sbuf + (t - t_begin) % NS * sbytes;
    cp_async_wait<NS - 1>();
    __syncwarp();  // the warp's rows of tile t visible to the warp
    uint32_t kt, vt;
    if constexpr (kInt8) {
      // lane i widens row i of the warp's 32 into the scratch
      const unsigned char* srow = st + (which * kTileKeys + warp * 16 + jl) * rse;
      unsigned char* wrow = scratch + (which * 16 + jl) * rs;
#pragma unroll
      for (int c = 0; c < CPR; ++c) {
        const uint2 w = *reinterpret_cast<const uint2*>(srow + c * 8);
        const uint2 a = int8x4_to_bf16x4(w.x), b = int8x4_to_bf16x4(w.y);
        *reinterpret_cast<uint4*>(wrow + c * 16) = make_uint4(a.x, a.y, b.x, b.y);
      }
      __syncwarp();
      kt = smem_u32(scratch);
      vt = kt + 16 * rs;
    } else {
      kt = smem_u32(st) + warp * 16 * rs;
      vt = kt + kTileKeys * rs;
    }

    // S^T (the warp's 16 keys x 8 heads) = K q^T, even and odd k steps in
    // two accumulators; K matrices (keys 0-7, k lo), (8-15, lo), (0-7, hi),
    // (8-15, hi)
    float s2[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < MD; ++kk) {
      uint32_t ka[4];
      ldsm_x4(kt + ((lmat & 1) * 8 + lrow) * rs + (kk * 16 + (lmat >> 1) * 8) * 2, ka);
      mma_bf16(s2[kk & 1], ka, qb[kk][0], qb[kk][1]);
    }

    // online softmax of heads 2tq + e over the warp's 16 keys: the thread
    // holds keys gq (x[e]) and gq + 8 (x[2 + e])
    const int kw = lo + t * kTileKeys + warp * 16;  // the warp's first key
    const bool ok0 = kw + gq <= hi, ok1 = kw + gq + 8 <= hi;
    const float* kscale = reinterpret_cast<const float*>(st + 2 * kTileKeys * rse) + warp * 16;
    float f0 = scale_log2, f1 = scale_log2;
    if constexpr (kInt8) {
      f0 *= kscale[gq];
      f1 *= kscale[gq + 8];
    }
    float x[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[e] = ok0 ? (s2[0][e] + s2[1][e]) * f0 : kNegInf;
      x[2 + e] = ok1 ? (s2[0][2 + e] + s2[1][2 + e]) * f1 : kNegInf;
    }
    float corr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mx = col_max(fmaxf(m[e], fmaxf(x[e], x[2 + e])));
      corr[e] = exp2f(m[e] - mx);
      m[e] = mx;
      x[e] = ok0 ? exp2f(x[e] - mx) : 0.0f;
      x[2 + e] = ok1 ? exp2f(x[2 + e] - mx) : 0.0f;
      l[e] = l[e] * corr[e] + x[e] + x[2 + e];
    }
#pragma unroll
    for (int md = 0; md < MD; ++md) {
      o[md][0] *= corr[0];
      o[md][1] *= corr[1];
      o[md][2] *= corr[0];
      o[md][3] *= corr[1];
    }
    // P as the B operand of PV (k = the warp's 16 keys, n = heads): the
    // thread's (key, heads 2tq, +1) pairs, transposed to (keys 2tq, +1, head gq)
    uint32_t pb[2], pl[2] = {0u, 0u};
    if constexpr (kInt8) {
      const float* vscale = kscale + kTileKeys;
      const float v0 = vscale[gq], v1 = vscale[gq + 8];
      const float w[4] = {x[0] * v0, x[1] * v0, x[2] * v1, x[3] * v1};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(w[2 * i], w[2 * i + 1]);
        pb[i] = movmatrix_t(*reinterpret_cast<const uint32_t*>(&h));
        pl[i] = movmatrix_t(
            pack_bf16(w[2 * i] - __low2float(h), w[2 * i + 1] - __high2float(h)));
      }
    } else {
      pb[0] = movmatrix_t(pack_bf16(x[0], x[1]));
      pb[1] = movmatrix_t(pack_bf16(x[2], x[3]));
    }

    // O^T += V^T P: V by ldmatrix.trans, matrices (keys 0-7, dims lo),
    // (0-7, hi), (8-15, lo), (8-15, hi) of each 16 dims
#pragma unroll
    for (int md = 0; md < MD; ++md) {
      uint32_t va[4];
      ldsm_x4_t(vt + ((lmat >> 1) * 8 + lrow) * rs + (md * 16 + (lmat & 1) * 8) * 2, va);
      mma_bf16(o[md], va, pb[0], pb[1]);
      if constexpr (kInt8) mma_bf16(o[md], va, pl[0], pl[1]);
    }
    __syncwarp();  // the warp is done with this stage (and its scratch) before refilling
    issue(t + NS, next);
  }

  // publish each warp's (m, l, acc) of heads < rep in the ring's place
  cp_async_wait<0>();
  __syncthreads();
  float* accs = reinterpret_cast<float*>(sbuf);     // [warp][rep][hd]
  float* mls = accs + kSplitWarps * rep * hd;       // [warp][rep][2]
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int h = 2 * tq + e;
    const float lsum = col_sum(l[e]);
    if (h < rep) {
      if (gq == 0) {
        mls[(warp * rep + h) * 2] = m[e];
        mls[(warp * rep + h) * 2 + 1] = lsum;
      }
#pragma unroll
      for (int md = 0; md < MD; ++md)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int d = md * 16 + gq + 8 * i;
          if (d < hd) accs[(warp * rep + h) * hd + d] = o[md][2 * i + e];
        }
    }
  }
  __syncthreads();
  // the block's four warps merged here, so that the cluster merges one
  // partial state per block
  float* cacc = mls + kSplitWarps * rep * 2;  // [rep][hd]
  float* cml = cacc + rep * hd;               // [rep][2]
  for (int idx = tid; idx < rep * hd; idx += kSplitThreads) {
    const int h = idx / hd;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mw = fmaxf(mw, mls[(w * rep + h) * 2]);
    float ls = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = exp2f(mls[(w * rep + h) * 2] - mw);
      ls += mls[(w * rep + h) * 2 + 1] * wt;
      a += accs[w * rep * hd + idx] * wt;
    }
    cacc[idx] = a;
    if (idx - h * hd == 0) {
      cml[2 * h] = mw;
      cml[2 * h + 1] = ls;
    }
  }
  cluster.sync();
  // every block's (m, l, acc) of an output read at once from distributed
  // shared memory (ranks past the cluster hold (-inf, 0, 0))
  for (int idx = rank * kSplitThreads + tid; idx < rep * hd; idx += csize * kSplitThreads) {
    const int h = idx / hd;
    float mb[kMaxCluster], lb[kMaxCluster], ab[kMaxCluster];
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b) {
      mb[b] = kNegInf;
      lb[b] = ab[b] = 0.0f;
      if (b < csize) {
        const float* bml = cluster.map_shared_rank(cml, b);
        mb[b] = bml[2 * h];
        lb[b] = bml[2 * h + 1];
        ab[b] = cluster.map_shared_rank(cacc, b)[idx];
      }
    }
    float mc = kNegInf;
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b) mc = fmaxf(mc, mb[b]);
    float ls = 0.0f, a = 0.0f;
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b) {
      const float wt = exp2f(mb[b] - mc);
      ls += lb[b] * wt;
      a += ab[b] * wt;
    }
    out[qoff + idx] = __float2bfloat16_rn(a / fmaxf(ls, 1e-20f));
  }
  // no block leaves while another reads its shared memory (the reads are
  // done: no ordering needed)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" :::
                   "memory");
}

template <bool kInt8, int D, int NS>
int launch_split(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const int* bt, const int* pos, const int* phase, void* out, int R, int K, int hd,
                 int rep, int P, int ps, int nb, int window, int cluster, int smem, float scale,
                 cudaStream_t st) {
  return cluster_launch(paged_split_kernel<kInt8, D, NS>, dim3(cluster, K, R), kSplitThreads,
                        (size_t)smem, st, static_cast<const __nv_bfloat16*>(q), k, v,
                        static_cast<const float*>(ks), static_cast<const float*>(vs), bt, pos,
                        phase, static_cast<__nv_bfloat16*>(out), K, hd, rep, P, ps, nb, window,
                        scale * kLog2e);
}

// The plan (kernels/paged_decode_attention.py ``paged_split_plan``) must be
// the one the shapes give: 64-key tiles, the cluster covering the keys a
// row can reach with none of its blocks idle at the longest row, the ring's
// depth and the shared memory that goes with them.
template <bool kInt8>
int dispatch_split(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const int* bt, const int* pos, const int* phase, void* out, int R, int H,
                   int K, int hd, int P, int ps, int nb, int window, int tile, int cluster,
                   int per_block, int stages, int smem, float scale, cudaStream_t st) {
  const int rep = H / K;
  const long long reach = window > 0 && window < (long long)nb * ps ? window : (long long)nb * ps;
  const long long tiles = (reach + kTileKeys - 1) / kTileKeys;
  if (tile != kTileKeys || cluster < 1 || cluster > kMaxCluster || per_block < 1 ||
      (long long)(cluster - 1) * per_block >= tiles || tiles > (long long)cluster * per_block ||
      stages != (per_block < kMaxStages ? per_block : kMaxStages) ||
      smem != split_smem_bytes(kInt8, hd, rep, stages) || R > 65535 ||
      (long long)P * ps * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
#define SPLIT_ARGS \
  q, k, v, ks, vs, bt, pos, phase, out, R, K, hd, rep, P, ps, nb, window, cluster, smem, scale, st
#define SPLIT_STAGES(D)                                                  \
  if (stages == 1) return launch_split<kInt8, D, 1>(SPLIT_ARGS);         \
  if (stages == 2) return launch_split<kInt8, D, 2>(SPLIT_ARGS);         \
  return launch_split<kInt8, D, 3>(SPLIT_ARGS)
  if (hd <= 64) {
    SPLIT_STAGES(64);
  }
  SPLIT_STAGES(128);
#undef SPLIT_STAGES
#undef SPLIT_ARGS
}

}  // namespace

extern "C" {

// q, out: (R,H,hd) contiguous, dtype 0 = float32 or 1 = bfloat16. k, v:
// (P,ps,K,hd) contiguous of q's dtype, or int8 with int8 = 1 and ks, vs
// float32 (P,ps,K,1). bt: (R,nb) int32; pos, phase: (R,) int32, phase null
// for the per-row-pos forms. H % K == 0, H/K <= 8; hd a multiple of 8, at
// most 128 (kMaxHeadDim); window 0 for none. (tile, cluster, per_block,
// stages, smem) is kernels/paged_decode_attention.py ``paged_split_plan``'s
// for these shapes: paged_split_kernel runs on it (bf16 q with bf16 pages
// and a phase, or with int8 pages and none) and refuses any other plan;
// paged_kernel, which runs the other forms, does not read it.
int paged_decode_attention(const void* q, const void* k, const void* v, const void* ks,
                           const void* vs, const void* bt, const void* pos, const void* phase,
                           void* out, int R, int H, int K, int hd, int P, int ps, int nb,
                           int window, int tile, int cluster, int per_block, int stages, int smem,
                           float scale, int dtype, int int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || H / K > kMaxRep || hd <= 0 || hd % 8 != 0 || hd > kMaxHeadDim ||
      P <= 0 || ps <= 0 || nb <= 0 || window < 0 || (int8 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* b = static_cast<const int*>(bt);
  const int* p = static_cast<const int*>(pos);
  const int* ph = static_cast<const int*>(phase);
  if (dtype == 1 && (int8 ? ph == nullptr : ph != nullptr)) {
#define SPLIT_ARGS                                                                              \
  q, k, v, ks, vs, b, p, ph, out, R, H, K, hd, P, ps, nb, window, tile, cluster, per_block, \
      stages, smem, scale, st
    return int8 ? dispatch_split<true>(SPLIT_ARGS) : dispatch_split<false>(SPLIT_ARGS);
#undef SPLIT_ARGS
  }
#define PAGED_ARGS q, k, v, ks, vs, b, p, ph, out, R, H, K, hd, P, ps, nb, window, scale, st
  if (dtype == 0)
    return int8 ? dispatch<float, int8_t, true>(PAGED_ARGS)
                : dispatch<float, float, false>(PAGED_ARGS);
  if (dtype == 1)
    return int8 ? dispatch<__nv_bfloat16, int8_t, true>(PAGED_ARGS)
                : dispatch<__nv_bfloat16, __nv_bfloat16, false>(PAGED_ARGS);
#undef PAGED_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
