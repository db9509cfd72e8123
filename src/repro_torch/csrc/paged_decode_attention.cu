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
// Design: one block per (kv head, row), sixteen warps (eight for wide head
// groups, see Warps). The row's walk covers the keys [lo, pos] (lo the
// window's first key), cut at the table's end; the TPU kernel's ragged
// index map stops at the same page, and the per-row-pos forms (B9, B10)
// stop there too: the pages past pos hold only masked keys, whose weights
// are exact zeros, so the output is the one a walk over all nb pages gives.
// The warps take 32-key groups of the walk in turn. The TPU kernels'
// block_k sub-page tile has no counterpart: the walk is the same for every
// block_k the wrappers accept. A lane owns one key of its group: it
// resolves the key's page through the table, reads the key's K and V rows
// with 16-byte loads, 64
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
// What the first versions taught, at the serve path's shape (R 16, H 32,
// K 8, hd 64, rows' positions spread over 640 keys; chip_smoke.py phase
// 10): with four warps and each V row read inside the PV loop the kernel
// took 90 us; staging V cut it to 68, keeping all of a row's loads in
// flight to 64, sixteen warps to 39, and the head group in registers
// sized at compile time (REP) with 16-byte reads of q to 25. It is bound
// by issued instructions and latency, not bytes: a block per (row, kv
// head) gives 128 blocks, and the longest row's warps walk its keys alone.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

extern "C" {

// q, out: (R,H,hd) contiguous, dtype 0 = float32 or 1 = bfloat16. k, v:
// (P,ps,K,hd) contiguous of q's dtype, or int8 with int8 = 1 and ks, vs
// float32 (P,ps,K,1). bt: (R,nb) int32; pos, phase: (R,) int32, phase null
// for the per-row-pos forms. H % K == 0, H/K <= 8; hd a multiple of 8, at
// most 128 (kMaxHeadDim); window 0 for none.
int paged_decode_attention(const void* q, const void* k, const void* v, const void* ks,
                           const void* vs, const void* bt, const void* pos, const void* phase,
                           void* out, int R, int H, int K, int hd, int P, int ps, int nb,
                           int window, float scale, int dtype, int int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || H / K > kMaxRep || hd <= 0 || hd % 8 != 0 || hd > kMaxHeadDim ||
      P <= 0 || ps <= 0 || nb <= 0 || window < 0 || (int8 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* b = static_cast<const int*>(bt);
  const int* p = static_cast<const int*>(pos);
  const int* ph = static_cast<const int*>(phase);
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
