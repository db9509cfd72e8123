// Guidance-combine kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes, see kernels/build.py and kernels/cfg_combine.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cfg_combine.py:
//   cfg_combine           <- cfg_combine_pallas           (Eq. 1, u + s*(c - u))
//   cfg_combine_rowscale  <- cfg_combine_rowscale_pallas  (Eq. 1, one s per row)
//   apg_combine           <- apg_combine_pallas           (APG, arXiv 2410.02416)
//
// What bounds B1 and B3 at the main paths' shapes: latency, not bytes. A
// combine does 3 flops per element against 12 bytes of traffic, so bytes
// would bound it at any size, but an SD latent (1 x 64 x 64 x 4 float32)
// moves 192 KB (0.06 us at 3.35 TB/s) and the decode logits (4 x 128256
// float32) 6 MB (1.8 us), against about 2 us that a launch and one trip to
// L2 cost. So the design spends as little as it can between the launch and
// the stores: one wave of blocks with no grid-stride loop, each thread
// issuing its two independent 16-byte loads of u and of c (and their rows'
// scales) before any arithmetic, 32-bit vector indices, the vector or
// scalar path chosen by the wrapper for the whole launch, and the ragged
// tail masked in the last block only. Blocks are of 64 threads while that
// needs no more blocks than the 132 SMs, else of 128: on an H100, at the SD
// latent 32 blocks of 64 threads measured faster than 128 blocks of 32
// threads with one vector each, and two vectors a thread faster than one or
// four at every main-path shape (timed while the design was chosen;
// chip_smoke.py times the plan itself). Read-only non-allocating loads and
// streaming stores measured no faster, so the accesses are plain. B3 finds
// each vector's row by a multiply and a shift (a divisor's magic number
// from the host), not a 64-bit divide. The launch plan is combine_plan in
// kernels/cfg_combine.py; launch_combine checks it. Eq. 1 keeps one
// rounding per operation, so both stay bit-exact against their plain
// PyTorch versions.
//
// B2 (APG) reduces over whole rows; its note is at apg_kernel.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;          // APG's block
constexpr int kMaxCombineThreads = 128;
constexpr int kVecs = 2;               // B1/B3 accesses a thread
constexpr float kEps = 1e-12f;        // guards zero-norm rows, as in the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Eq. 1 with one rounding per operation (no contraction into an FMA), so the
// result is bit-exact against the plain PyTorch u + s * (c - u).
__device__ __forceinline__ float eq1(float u, float c, float s) {
  return __fadd_rn(u, __fmul_rn(s, __fsub_rn(c, u)));
}

// W elements of T: one 16-byte vector (W = 16 / sizeof(T), moved as one
// uint4) or one element.
template <typename T, int W>
struct Pack {
  static_assert(W == 1 || W * sizeof(T) == 16, "an access is 16 bytes or one element");
  using Raw = std::conditional_t<W == 1, T, uint4>;
  Raw raw;
  __device__ __forceinline__ float get(int k) const {
    if constexpr (W == 1) return to_f32(raw);
    else return to_f32(reinterpret_cast<const T*>(&raw)[k]);
  }
  __device__ __forceinline__ void set(int k, float v) {
    if constexpr (W == 1) raw = from_f32<T>(v);
    else reinterpret_cast<T*>(&raw)[k] = from_f32<T>(v);
  }
};

// q = a / d for a < 2^31 as (a * m) >> sh, with m and sh from magic_for(d).
struct Divider {
  unsigned long long m;
  int sh;
};

Divider magic_for(unsigned long long d) {
  int s = 0;
  while ((1ull << s) < d) ++s;
  return {((1ull << (31 + s)) + d - 1) / d, 31 + s};
}

// B1 and B3: the block b's threads take accesses b * T * kVecs + v * T + t,
// v < kVecs. Every block but the last holds whole accesses only (the plan
// guarantees it), so only the last one checks bounds; the one partial vector
// of a vector path whose n is not a multiple of W is finished element by
// element there. ROWSCALE reads the access's row's scale; on the vector path
// the wrapper guarantees feat % W == 0, so no vector straddles two rows.
// I is the index type: uint32 unless the launch has 2^31 accesses or more.
template <typename T, bool ROWSCALE, int W, typename I>
__global__ void __launch_bounds__(kMaxCombineThreads)
combine_kernel(const T* __restrict__ u, const T* __restrict__ c, T* __restrict__ out,
               const float* __restrict__ scales, float scale, long long n, I full,
               I feat_acc, Divider rows) {
  using P = Pack<T, W>;
  using R = typename P::Raw;
  const R* pu = reinterpret_cast<const R*>(u);
  const R* pc = reinterpret_cast<const R*>(c);
  R* po = reinterpret_cast<R*>(out);
  const I first = (I)blockIdx.x * (I)(blockDim.x * kVecs) + threadIdx.x;
  const bool last = blockIdx.x == gridDim.x - 1;
  P ru[kVecs], rc[kVecs];
  float s[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const I a = first + (I)(v * blockDim.x);
    if (!last || a < full) {
      ru[v].raw = pu[a];
      rc[v].raw = pc[a];
      if constexpr (ROWSCALE) {
        if constexpr (sizeof(I) == 4)
          s[v] = scales[(unsigned)(((unsigned long long)a * rows.m) >> rows.sh)];
        else
          s[v] = scales[a / feat_acc];
      } else {
        s[v] = scale;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const I a = first + (I)(v * blockDim.x);
    if (!last || a < full) {
      P o;
#pragma unroll
      for (int k = 0; k < W; ++k) o.set(k, eq1(ru[v].get(k), rc[v].get(k), s[v]));
      po[a] = o.raw;
    } else if constexpr (W > 1 && !ROWSCALE) {
      // the partial vector past the last whole one, element by element
      if (a == full) {
        for (long long i = (long long)full * W; i < n; ++i)
          out[i] = from_f32<T>(eq1(to_f32(u[i]), to_f32(c[i]), scale));
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sums a value over the block; every thread gets the total. red holds one
// float per warp.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.0f;
  t = warp_sum(t);
  __syncthreads();  // red is reused by the next call
  return t;
}

// B2. One block per batch row. Pass 1 reads u and c (or diff) once and
// reduces |d|^2, |c|^2 and d.c in fp32; the threshold clamp then enters as
// one scalar factor k on d, and d_par = (k d.c / |c|) * c / |c|. Pass 2
// re-reads the row, which at 64 KB per row is served from L2, and writes
// c + (s - 1) * ((k d - d_par) + eta * d_par), with s the row's own scale
// when a (rows,) scale vector is given. A row with d == 0 gives
// c + (s - 1) * 0 == c exactly; an all-zero row stays finite through kEps.
// Known weakness: with B <= 4 rows only B of the 132 SMs are busy.
template <typename T>
__global__ void apg_kernel(const T* __restrict__ u, const T* __restrict__ c,
                           const float* __restrict__ diff, const float* __restrict__ scales,
                           T* __restrict__ out, long long feat, float scale_m1, float eta,
                           float threshold) {
  __shared__ float red[32];
  const long long base = blockIdx.x * feat;
  if (scales) scale_m1 = scales[blockIdx.x] - 1.0f;
  float dd = 0.0f, cc = 0.0f, dc = 0.0f;
  for (long long j = threadIdx.x; j < feat; j += blockDim.x) {
    const float cj = to_f32(c[base + j]);
    const float dj = diff ? diff[base + j] : __fsub_rn(cj, to_f32(u[base + j]));
    dd += dj * dj;
    cc += cj * cj;
    dc += dj * cj;
  }
  dd = block_sum(dd, red);
  cc = block_sum(cc, red);
  dc = block_sum(dc, red);
  const float k = threshold > 0.0f ? fminf(1.0f, threshold / fmaxf(sqrtf(dd), kEps)) : 1.0f;
  const float cn = fmaxf(sqrtf(cc), kEps);
  const float p = k * dc / cn;  // d_par = p * (c / cn)
  for (long long j = threadIdx.x; j < feat; j += blockDim.x) {
    const float cj = to_f32(c[base + j]);
    const float dj = k * (diff ? diff[base + j] : __fsub_rn(cj, to_f32(u[base + j])));
    const float dpar = p * (cj / cn);
    out[base + j] = from_f32<T>(cj + scale_m1 * ((dj - dpar) + eta * dpar));
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, bool ROWSCALE, int W, typename I>
void run_combine(const void* u, const void* c, void* out, const float* scales, float scale,
                 long long n, long long full, long long feat_acc, int threads, unsigned grid,
                 cudaStream_t st) {
  combine_kernel<T, ROWSCALE, W, I><<<grid, threads, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(c), static_cast<T*>(out), scales, scale, n,
      (I)full, (I)feat_acc, magic_for((unsigned long long)feat_acc));
}

template <typename T, bool ROWSCALE>
void run_dtype(const void* u, const void* c, void* out, const float* scales, float scale,
               long long n, long long full, long long feat_acc, int width, bool wide,
               int threads, unsigned grid, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (width == V)
    run_combine<T, ROWSCALE, V, unsigned>(u, c, out, scales, scale, n, full, feat_acc, threads,
                                          grid, st);
  else if (wide)
    run_combine<T, ROWSCALE, 1, unsigned long long>(u, c, out, scales, scale, n, full, feat_acc,
                                                    threads, grid, st);
  else
    run_combine<T, ROWSCALE, 1, unsigned>(u, c, out, scales, scale, n, full, feat_acc, threads,
                                          grid, st);
}

// Checks the plan (kernels/cfg_combine.py::combine_plan) and launches: width
// elements an access (16 bytes, or 1: the scalar path), threads a block,
// vecs accesses a thread, blocks. Every block but the last must hold whole
// accesses only, and the blocks must cover them all.
template <bool ROWSCALE>
int launch_combine(const void* u, const void* c, void* out, const void* scales, float scale,
                   long long n, long long feat, int dtype, int width, int threads, int vecs,
                   long long blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  const int V = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || (width != 1 && width != V)) return (int)cudaErrorInvalidValue;
  const long long per = (long long)threads * vecs;
  const long long full = n / width;
  const long long accesses = (n + width - 1) / width;
  const bool wide = accesses >= (1LL << 31);
  const bool ok =
      (width == 1 || (aligned16(u) && aligned16(c) && aligned16(out) && !wide)) &&
      (threads == 64 || threads == kMaxCombineThreads) && vecs == kVecs && blocks >= 1 &&
      blocks <= 0x7fffffffLL &&
      blocks * per >= accesses && (blocks - 1) * per <= full &&
      (!ROWSCALE || (feat > 0 && n % feat == 0 && feat % width == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long feat_acc = ROWSCALE ? feat / width : 1;
  const float* sc = static_cast<const float*>(scales);
  if (dtype == 0)
    run_dtype<float, ROWSCALE>(u, c, out, sc, scale, n, full, feat_acc, width, wide, threads,
                               (unsigned)blocks, st);
  else
    run_dtype<__nv_bfloat16, ROWSCALE>(u, c, out, sc, scale, n, full, feat_acc, width, wide,
                                       threads, (unsigned)blocks, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, c and out share it). width, threads,
// vecs and blocks: the launch plan.
int cfg_combine(const void* u, const void* c, void* out, long long n, float scale, int dtype,
                int width, int threads, int vecs, long long blocks, void* stream) {
  return launch_combine<false>(u, c, out, nullptr, scale, n, 0, dtype, width, threads, vecs,
                               blocks, stream);
}

// scales: float32, one per row of feat elements.
int cfg_combine_rowscale(const void* u, const void* c, void* out, const void* scales,
                         long long rows, long long feat, int dtype, int width, int threads,
                         int vecs, long long blocks, void* stream) {
  return launch_combine<true>(u, c, out, scales, 0.0f, rows * feat, feat, dtype, width, threads,
                              vecs, blocks, stream);
}

// diff: float32 (rows, feat) replacing c - u, or null. scales: float32
// (rows,), one guidance scale per row, or null for the one scale whose
// s - 1 is scale_m1.
int apg_combine(const void* u, const void* c, const void* diff, const void* scales, void* out,
                long long rows, long long feat, float scale_m1, float eta, float threshold,
                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* df = static_cast<const float*>(diff);
  const float* sc = static_cast<const float*>(scales);
  if (rows <= 0) return (int)cudaGetLastError();
  if (dtype == 0) {
    apg_kernel<float><<<(unsigned)rows, kThreads, 0, st>>>(
        static_cast<const float*>(u), static_cast<const float*>(c), df, sc,
        static_cast<float*>(out), feat, scale_m1, eta, threshold);
  } else if (dtype == 1) {
    apg_kernel<__nv_bfloat16><<<(unsigned)rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(c), df, sc,
        static_cast<__nv_bfloat16*>(out), feat, scale_m1, eta, threshold);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
