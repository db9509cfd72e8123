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
// What bounds B2 (APG): bytes, and one reduction over each whole row before
// its first output. It moves Eq. 1's 12 bytes an element (about a dozen
// flops), but at the main paths' shapes (4 or 16 rows of 128256 float32
// logits; one 16384-element SD latent) the rows are few and long: one block
// a row would leave most of the 132 SMs idle and walk its row twice. So
// the design holds the row on chip: one thread-block cluster of up to 8
// blocks a row, each block a contiguous slice held in registers, the
// partial sums merged through distributed shared memory; HBM is read once
// and written once. Its note is at apg_cluster_kernel.
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

constexpr int kMaxCombineThreads = 128;
constexpr int kApgMaxCluster = 8;     // kernels/cfg_combine.py APG_MAX_CLUSTER
constexpr int kApgMaxThreads = 512;   // APG_MAX_THREADS
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

// diff's W float32 elements of an access of W elements of T (one float, or
// W / 4 16-byte vectors)
template <int W>
struct DiffPack {
  static constexpr int N = W == 1 ? 1 : W / 4;
  using Raw = std::conditional_t<W == 1, float, float4>;
  Raw raw[N];
  __device__ __forceinline__ float get(int k) const {
    if constexpr (W == 1) return raw[0];
    else return reinterpret_cast<const float*>(raw)[k];
  }
};

template <typename T, int W>
__device__ __forceinline__ void load_at(Pack<T, W>& p, const T* base, int j) {
  p.raw = reinterpret_cast<const typename Pack<T, W>::Raw*>(base)[j];
}

template <int W>
__device__ __forceinline__ void load_at(DiffPack<W>& p, const float* base, int j) {
  const auto* q = reinterpret_cast<const typename DiffPack<W>::Raw*>(base) + j * DiffPack<W>::N;
#pragma unroll
  for (int i = 0; i < DiffPack<W>::N; ++i) p.raw[i] = q[i];
}

// The accesses a thread may hold in registers (kernels/cfg_combine.py
// apg_max_held): 8, or 4 for bf16 vectors (the same 32 elements), which the
// compiler keeps as float32 from the sums to the stores: at 8 they spilled.
constexpr int apg_max_held(bool bf16, bool vec) { return bf16 && vec ? 4 : 8; }

template <typename T, bool DIFF, int W>
struct ApgAccess {
  using C = Pack<T, W>;
  using S = std::conditional_t<DIFF, DiffPack<W>, Pack<T, W>>;
  using SElem = std::conditional_t<DIFF, float, T>;
  // element k of d: diff's, or c - u rounded once
  __device__ __forceinline__ static float d(const C& c, const S& s, int k) {
    if constexpr (DIFF) return s.get(k);
    else return __fsub_rn(c.get(k), s.get(k));
  }
  // adds this access's |d|^2, |c|^2 and d.c
  __device__ __forceinline__ static void sums(const C& c, const S& s, float& dd, float& cc,
                                              float& dc) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float ck = c.get(k), dk = d(c, s, k);
      dd = fmaf(dk, dk, dd);
      cc = fmaf(ck, ck, cc);
      dc = fmaf(dk, ck, dc);
    }
  }
  // c + a d + b c, rounded to T once
  __device__ __forceinline__ static C output(const C& c, const S& s, float a, float b) {
    C o;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float ck = c.get(k);
      o.set(k, fmaf(a, d(c, s, k), fmaf(b, ck, ck)));
    }
    return o;
  }
};

// B2, APG, replacing apg_combine_pallas (and, with diff or a (rows,) scale
// vector, what apg_combine_ref computes). Per row, in float32: d = c - u (or
// diff), the sums |d|^2, |c|^2 and d.c; the threshold clamp is one factor k
// on d, and d_par = p c / |c| with p = k d.c / |c|, so
//   out = c + (s - 1) ((k d - d_par) + eta d_par) = c + a d + b c,
//   a = (s - 1) k,  b = (s - 1) (eta - 1) p / |c|,
// two FMAs an element, rounded to T once at the store (the folding and the
// sums' order round otherwise than the plain version, within 1e-5 of it).
// A row with u == c has d = 0 and d.c = 0, so b = 0 and out = c bit for
// bit; an all-zero row stays finite through kEps.
//
// One launch, grid (cluster, rows over y and z): the cluster's blocks split
// the row's accesses (W elements: 16 bytes, or one element where the
// wrapper found a pointer or the row length off 16 bytes) into contiguous
// slices of ``slice``. Each thread issues the loads of c and of u (or diff)
// of its H held accesses (v * threads + t of the slice) before any
// arithmetic and keeps them in registers, so the row comes from HBM once
// and its outputs are written from the registers: no second pass and no
// round trip through shared memory. 512 threads x 8 accesses x 8 blocks
// hold 32768 accesses a row (131072 float32 elements, at 128 registers a
// thread: one block an SM). A longer row (qwen3-14b's 151936 or
// recurrentgemma-9b's 256000 logits), or a launch the plan cuts to
// clusters of 4 to stay in one wave (an H100 runs 15 clusters of 8 such
// blocks at once: 16 rows took a second wave), takes the re-read route of
// the same template: the accesses past the held ones are read for the sums
// and read again, from L2, for the outputs. Each block reduces its sums
// over its warps;
// warp 0's lane r then stores them into rank r's shared memory, and after
// one cluster barrier every warp sums the cluster's partials from its own
// shared memory in rank order, so every block of a row has the same k, |c|
// and p bit for bit, and no remote access follows the barrier (a barrier
// arrived on at entry and waited on before the stores makes sure every
// block runs; the loads hide it). What bounds it on an H100: the bytes a
// block moves through one SM (at (4, 128256) float32, 192 KB: 32 of the
// 132 SMs work; halving the cluster doubles a block's bytes and adds about
// their time again) and a cluster launch's fixed cost (at the SD latent
// about 1.5 us above B1 on the same bytes). Measured on an H100 while the
// design was chosen (chip_smoke.py --apg-kernels on each version): reading
// the partials through distributed shared memory after the barrier, with
// a closing barrier, was 0.3 us slower at the SD latent and the decode
// logits; each warp storing its own sums, with no block reduction, 0.1 us
// slower at the SD latent. chip_smoke.py --apg-plans times the plan's
// other choices. The plan is apg_plan in kernels/cfg_combine.py;
// apg_combine below checks it.
template <typename T, bool DIFF, int W, int H>
__global__ void __launch_bounds__(kApgMaxThreads, 1)
apg_cluster_kernel(const T* __restrict__ u, const T* __restrict__ c,
                   const float* __restrict__ diff, const float* __restrict__ scales,
                   T* __restrict__ out, long long feat, long long rows, long long acc_row,
                   int slice, float scale_m1, float eta, float threshold) {
  using A = ApgAccess<T, DIFF, W>;
  extern __shared__ float red[];   // [3][warps] of the warps' sums, then [rank][3] the cluster's
  const long long row = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  if (row >= rows) return;         // the whole cluster: it shares the row
  cg::cluster_group cluster = cg::this_cluster();
  // a block's shared memory takes remote stores only once it runs: the wait
  // of this arrival comes after the loads, so it costs nothing
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int rank = (int)blockIdx.x, nb = (int)gridDim.x;   // one cluster spans x
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const float s_m1 = scales ? scales[row] - 1.0f : scale_m1;
  const int n = (int)max(0LL, min((long long)slice, acc_row - (long long)rank * slice));
  const long long e0 = row * feat + (long long)rank * slice * W;
  const T* cb = c + e0;
  T* ob = out + e0;
  const typename A::SElem* sb;
  if constexpr (DIFF) sb = diff + e0;
  else sb = u + e0;

  typename A::C hc[H];
  typename A::S hs[H];
#pragma unroll
  for (int v = 0; v < H; ++v) {
    const int j = v * nt + t;
    if (j < n) {
      load_at(hc[v], cb, j);
      load_at(hs[v], sb, j);
    }
  }
  float dd = 0.0f, cc = 0.0f, dc = 0.0f;
  for (int j = H * nt + t; j < n; j += nt) {   // the re-read route's first read
    typename A::C x;
    typename A::S y;
    load_at(x, cb, j);
    load_at(y, sb, j);
    A::sums(x, y, dd, cc, dc);
  }
#pragma unroll
  for (int v = 0; v < H; ++v)
    if (v * nt + t < n) A::sums(hc[v], hs[v], dd, cc, dc);

  dd = warp_sum(dd);
  cc = warp_sum(cc);
  dc = warp_sum(dc);
  float* part = red + 3 * nw;
  if (lane == 0) {
    red[warp] = dd;
    red[nw + warp] = cc;
    red[2 * nw + warp] = dc;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");   // every block runs
  if (warp == 0) {
    dd = warp_sum(lane < nw ? red[lane] : 0.0f);
    cc = warp_sum(lane < nw ? red[nw + lane] : 0.0f);
    dc = warp_sum(lane < nw ? red[2 * nw + lane] : 0.0f);
    if (lane < nb) {   // the block's sums into every block of the cluster, lane r rank r's
      float* dst = cluster.map_shared_rank(part, lane) + 3 * rank;
      dst[0] = dd;
      dst[1] = cc;
      dst[2] = dc;
    }
  }
  cluster.sync();      // every block's sums have arrived; no remote access follows
  float pdd = 0.0f, pcc = 0.0f, pdc = 0.0f;
  if (lane < nb) {
    pdd = part[3 * lane];
    pcc = part[3 * lane + 1];
    pdc = part[3 * lane + 2];
  }
  dd = cc = dc = 0.0f;
#pragma unroll
  for (int r = 0; r < kApgMaxCluster; ++r) {   // rank order, the same in every block
    const float x = __shfl_sync(0xffffffffu, pdd, r), y = __shfl_sync(0xffffffffu, pcc, r),
                z = __shfl_sync(0xffffffffu, pdc, r);
    if (r < nb) {
      dd += x;
      cc += y;
      dc += z;
    }
  }

  const float k = threshold > 0.0f ? fminf(1.0f, threshold / fmaxf(sqrtf(dd), kEps)) : 1.0f;
  const float cn = fmaxf(sqrtf(cc), kEps);
  const float p = k * dc / cn;
  const float a = s_m1 * k, b = s_m1 * ((eta - 1.0f) * (p / cn));
  using R = typename A::C::Raw;
#pragma unroll
  for (int v = 0; v < H; ++v) {
    const int j = v * nt + t;
    if (j < n) reinterpret_cast<R*>(ob)[j] = A::output(hc[v], hs[v], a, b).raw;
  }
  for (int j = H * nt + t; j < n; j += nt) {   // the re-read route's second read, from L2
    typename A::C x;
    typename A::S y;
    load_at(x, cb, j);
    load_at(y, sb, j);
    reinterpret_cast<R*>(ob)[j] = A::output(x, y, a, b).raw;
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

// B2's launch: the C entry's checked plan, as one struct
struct ApgArgs {
  const void *u, *c, *diff;
  const float* scales;
  void* out;
  long long rows, feat, acc_row;
  int slice;
  float scale_m1, eta, threshold;
  int cluster, threads, smem;
  cudaStream_t st;
};

// rows over grid y and z (at most 65535 each); one cluster spans x
template <typename T, bool DIFF, int W, int H>
int launch_apg(const ApgArgs& g) {
  const long long ry = g.rows < 65535 ? g.rows : 65535;
  return cluster_launch(apg_cluster_kernel<T, DIFF, W, H>,
                        dim3((unsigned)g.cluster, (unsigned)ry, (unsigned)((g.rows + ry - 1) / ry)),
                        g.threads, (size_t)g.smem, g.st, static_cast<const T*>(g.u),
                        static_cast<const T*>(g.c), static_cast<const float*>(g.diff), g.scales,
                        static_cast<T*>(g.out), g.feat, g.rows, g.acc_row, g.slice, g.scale_m1,
                        g.eta, g.threshold);
}

template <typename T, bool DIFF, int W>
int launch_apg_held(const ApgArgs& g, int held) {
  if (held == 4) return launch_apg<T, DIFF, W, 4>(g);
  if constexpr (apg_max_held(sizeof(T) == 2, W > 1) == 8) return launch_apg<T, DIFF, W, 8>(g);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_apg_dtype(const ApgArgs& g, int width, int held) {
  constexpr int V = 16 / sizeof(T);
  if (g.diff)
    return width == 1 ? launch_apg_held<T, true, 1>(g, held) : launch_apg_held<T, true, V>(g, held);
  return width == 1 ? launch_apg_held<T, false, 1>(g, held) : launch_apg_held<T, false, V>(g, held);
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
// s - 1 is scale_m1. width, cluster, threads, held, reread and smem: the
// launch plan (kernels/cfg_combine.py::apg_plan). width elements an access
// (16 bytes: every pointer 16-byte aligned and feat a multiple of it; or
// 1), cluster blocks a row each taking a slice of ceil(accesses / cluster)
// accesses and none empty, threads a block (whole warps, at most 512), held
// accesses a thread in registers (4 or 8, 4 for bf16 vectors), reread 1
// iff threads * held < slice, smem the bytes of the sums.
int apg_combine(const void* u, const void* c, const void* diff, const void* scales, void* out,
                long long rows, long long feat, float scale_m1, float eta, float threshold,
                int dtype, int width, int cluster, int threads, int held, int reread, int smem,
                void* stream) {
  if (rows <= 0 || feat <= 0) return (int)cudaGetLastError();
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8;
  if (width != 1 && width != V) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kApgMaxCluster) return (int)cudaErrorInvalidValue;
  const long long acc_row = feat / width;
  const long long slice = (acc_row + cluster - 1) / cluster;
  const long long ry = rows < 65535 ? rows : 65535;
  const bool ok =
      (width == 1 || (feat % V == 0 && aligned16(u) && aligned16(c) && aligned16(out) &&
                      (!diff || aligned16(diff)))) &&
      (cluster - 1) * slice < acc_row && slice < (1LL << 31) && threads >= 32 &&
      threads <= kApgMaxThreads && threads % 32 == 0 &&
      (held == 4 || held == 8) && held <= apg_max_held(dtype == 1, width > 1) &&
      reread == ((long long)threads * held < slice ? 1 : 0) &&
      smem == 4 * (3 * (threads / 32) + 3 * kApgMaxCluster) && (rows + ry - 1) / ry <= 65535;
  if (!ok) return (int)cudaErrorInvalidValue;
  const ApgArgs g{u, c, diff, static_cast<const float*>(scales), out, rows, feat, acc_row,
                  (int)slice, scale_m1, eta, threshold, cluster, threads, smem,
                  static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? launch_apg_dtype<float>(g, width, held)
                    : launch_apg_dtype<__nv_bfloat16>(g, width, held);
}

const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
