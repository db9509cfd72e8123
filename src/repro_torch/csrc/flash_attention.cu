// Flash attention for prefill on Hopper (sm_90a), bound through a plain C
// interface (ctypes, see kernels/build.py and kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas: GQA attention
// of q (B,S,H,hd) over k, v (B,S,K,hd), causal and/or sliding-window masked,
// softmax by the online (flash) recurrence with fp32 m, l and acc; p is cast
// to v's dtype before the PV product, as the TPU kernel does per tile.
//
// Two kernels, chosen by one fixed rule: the input dtype. bfloat16 takes
// the tensor-core kernel, float32 the CUDA-core kernel (TF32 tensor cores
// would not keep float32's scores within 1e-5). Nothing else picks a route.
//
// bfloat16: warpgroup tensor cores. At S = 512 and hd = 64 the work is
// ~80 flops per byte moved, so on tensor cores the bound is bytes.
//   * Rows. One block per (batch, kv head, q tile): one consumer warpgroup
//     of 64 query rows and one producer warp. A tile's rows are (position,
//     head) rows of one kv head's group, bq = 64/rep positions x rep heads
//     (rep = H/K: 4, 5 or 8 on the dense decoders), so the group's heads
//     share every K/V tile and KV is never replicated; rows past bq * rep
//     (rep 5: 12 x 5 = 60 of 64) are computed and never stored. Why not
//     two consumer warpgroups (128 rows) per block, which would read each
//     K/V byte half as often: on the H100 at the main shape (B 4, S 512,
//     H 32, K 8, hd 64) such blocks were slower, held to one per SM by
//     registers. 64-row blocks fit 3 per SM at hd 64 (2 at hd 128), their
//     softmax, TMA waits and tensor-core work interleave, and the K/V
//     re-reads hit L2.
//   * Copies. The producer warp keeps TMA loads in flight: the q tile once,
//     then 64-key K and V tiles into a ring of kStages stages (3 at hd <=
//     64, where three blocks of 57 KB still fit an SM; 2 above), each
//     completing on a ``full`` mbarrier; the consumers release a stage on
//     its ``empty`` mbarrier. The tensor maps (4-D over (B, S, heads, hd),
//     128-byte swizzle, built on the host and passed as __grid_constant__
//     parameters) zero-fill reads past S and past hd: hd is padded to a
//     multiple of 64 in shared memory only (hd 120 -> 128), and nothing is
//     padded in device memory. Any S.
//   * QK^T. wgmma m64n64k16, q and K both K-major from the swizzled tiles,
//     fp32 accumulators: 64 keys of scores per row in registers.
//   * Softmax. In registers on the accumulator fragment: row max and sum
//     over the quad that shares a row, p = 2^(s*c - m*c) by one FFMA and
//     one SFU ex2 a score; masks only on the tiles at the causal diagonal,
//     a window's edge or S's end.
//   * PV. p rounded to bf16 in registers is the register A operand of a
//     second wgmma (the accumulator layout is the A fragment's); V comes
//     from shared memory MN-major (transposed B), one 64-column chunk of
//     hd per instruction.
//   * Overlap. QK^T of tile t+1 and PV of tile t are issued together as two
//     commit groups; the softmax of tile t+1 runs once the first retires,
//     while PV of tile t is still on the tensor cores, and the old state is
//     rescaled after the second. The last tile's PV is peeled off the loop:
//     with the QK^T issue under a branch, ptxas serialized every wgmma.
//   * Skipping work. Key tiles no row of the block can see (past the causal
//     diagonal, before q0 - window + 1) are never loaded.
//   Masked keys score -1e30, as in the TPU kernel; a row that has seen no
//   key yet keeps a zero state until the first tile holding one it can see.
//
// float32: CUDA cores, the first version. One block per (batch, kv head,
// q tile) of bq = 32/rep positions x rep heads, four rows per warp, 32-key
// K/V tiles widened in shared memory (K with an odd row stride: the 32
// lanes, one key each, hit 32 banks); p broadcast by warp shuffles for PV.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---- float32: CUDA cores -------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per K/V tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// p in v's dtype, back in fp32 for the sum
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

// HDV: head dims per lane, hd <= 32 * HDV.
template <typename T, int HDV>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int S, int H, int K, int hd, int rep, int bq, int causal,
             int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // kRows x hd
  float* ks = qs + kRows * hd;         // kKeys x (hd + 1)
  float* vs = ks + kKeys * (hd + 1);   // kKeys x hd
  const int g = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, S - q0);
  const int rows = nq * rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kstride = hd + 1;

  // q rows: row r is position q0 + r / rep of head g * rep + r % rep; the
  // rep heads of one position are adjacent in memory
  for (int i = threadIdx.x; i < kRows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    float x = 0.0f;
    if (r < rows) {
      const long long qi = q0 + r / rep, h = (long long)g * rep + r % rep;
      x = to_f32(q[((b * (long long)S + qi) * H + h) * hd + d]);
    }
    qs[i] = x;
  }

  // the keys any row of this tile can see
  const int last_q = q0 + nq - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? last_q + 1 : S;

  const int r0 = warp * kRowsPerWarp;
  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][HDV];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = q0 + (r0 + i) / rep;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < HDV; ++e) acc[i][e] = 0.0f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < kKeys * hd; i += blockDim.x) {
      const int j = i / hd, d = i - j * hd;
      const int kp = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kp < kv_hi) {
        const long long idx = ((b * (long long)S + kp) * K + g) * hd + d;
        kx = to_f32(k[idx]);
        vx = to_f32(v[idx]);
      }
      ks[j * kstride + d] = kx;
      vs[j * hd + d] = vx;
    }
    __syncthreads();
    if (r0 >= rows) continue;  // this warp has no live row in the tile

    // scores: lane owns key k0 + lane
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.0f;
    const float* kr = ks + lane * kstride;
    const float* qr = qs + r0 * hd;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] += qr[i * hd + d] * kd;
    }
    const int kp = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool ok = kp < kv_hi;
      if (causal) ok = ok && kp <= qpos[i];
      if (window > 0) ok = ok && kp > qpos[i] - window;
      const float si = ok ? s[i] * scale : kNegInf;
      const float mn = fmaxf(m[i], warp_max(si));
      const float pi = expf(si - mn);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + warp_sum(pi);
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < HDV; ++e) acc[i][e] *= corr;
      p[i] = round_to<T>(pi);
    }
    // PV: lane owns head dims lane + 32 e
    for (int j = 0; j < kKeys; ++j) {
      const float* vr = vs + j * hd;
      float pj[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pj[i] = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
      for (int e = 0; e < HDV; ++e) {
        const int d = lane + 32 * e;
        if (d < hd) {
          const float vd = vr[d];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) acc[i][e] += pj[i] * vd;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    if (r >= rows) break;
    const long long qi = q0 + r / rep, h = (long long)g * rep + r % rep;
    T* o = out + ((b * (long long)S + qi) * H + h) * hd;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int e = 0; e < HDV; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) o[d] = from_f32<T>(acc[i][e] * inv_l);
    }
  }
}

template <typename T, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int K,
           int hd, int causal, int window, float scale, cudaStream_t st) {
  const int rep = H / K;
  const int bq = kRows / rep;
  const size_t smem = sizeof(float) * ((size_t)kRows * hd + (size_t)kKeys * (hd + 1) +
                                       (size_t)kKeys * hd);
  auto kernel = flash_kernel<T, HDV>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + bq - 1) / bq, K, B);
  kernel<<<grid, kWarps * 32, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), S, H,
                                          K, hd, rep, bq, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int K,
             int hd, int causal, int window, float scale, cudaStream_t st) {
  if (hd <= 32) return launch<T, 1>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
  if (hd <= 64) return launch<T, 2>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
  if (hd <= 128) return launch<T, 4>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
  return launch<T, 8>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
}


// ---- bfloat16: warpgroup tensor cores ------------------------------------------

constexpr int kTileKeys = 64;              // keys per K/V tile
// K/V ring depth: three stages where three blocks of them fit an SM (hd <= 64)
template <int NC> constexpr int kStages = NC == 1 ? 3 : 2;
constexpr int kChunkBytes = 64 * 128;      // 64 rows x one 128-byte swizzle row
constexpr int kWgThreads = 128 + 32;     // one consumer warpgroup, then one producer warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completes on ``bar``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose 8-row
// groups are 1024 bytes apart (the TMA's SWIZZLE_128B layout of 128-byte
// rows). Every operand here spans one 128-byte row (K-major: 16 of its
// 64 columns; MN-major: all 64), so only the 8-row group stride matters;
// both offsets hold it.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t group = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (group << 16) | (group << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC32(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define REGS32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, fp32) (+)= A (64 x 16) . B (64 x 16)^T, both bf16 K-major in
// shared memory; d is overwritten when ``accumulate`` is 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragment in registers) . B (16 x 64),
// B bf16 in shared memory with its 64 columns contiguous (MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x by the SFU's approximation (relative error ~2^-22), as flash kernels
// do: the scores are float32, p is rounded to bf16 after
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool key_ok(int kp, int qp, int S, int causal, int window) {
  return kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// NC: 64-column chunks of the padded head dim. Block (q tile, kv head g,
// batch b): one consumer warpgroup (64 query rows), then one producer warp.
// Shared memory, from a 1024-byte boundary: the q tile (NC chunks of 64
// rows), kStages K/V stages (NC chunks of 64 keys each, K then V), then the
// barriers. Registers cap the blocks per SM: 3 at hd <= 64, 2 to 192, 1 past.
template <int NC>
__global__ void __launch_bounds__(kWgThreads, NC == 1 ? 3 : NC <= 3 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                   int S, int H, int hd, int rep, int bq, int causal, int window,
                   float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + NC * kChunkBytes;
  const uint32_t stage_bytes = 2 * NC * kChunkBytes;
  const uint32_t bars = kv_s + kStages<NC> * stage_bytes;  // full[], empty[], q
  const uint32_t qbar = bars + 8 * 2 * kStages<NC>;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the long causal tiles start first
  const int g = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq;
  const int rows = bq * rep;
  const int qlast = min(q0 + bq, S) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = kv_lo & ~(kTileKeys - 1);
  const int kv_hi = causal ? qlast + 1 : S;
  const int nt = (kv_hi - kt0 + kTileKeys - 1) / kTileKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages<NC>; ++s) {
      mbar_init(bars + 8 * s, 1);               // full: the producer's arrival + bytes
      mbar_init(bars + 8 * (kStages<NC> + s), 4);   // empty: one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(qbar, NC * rows * 128);
      for (int c = 0; c < NC; ++c)
        tma_load_4d(q_s + c * kChunkBytes, &qmap, qbar, c * 64, g * rep, q0, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % kStages<NC>;
        if (t >= kStages<NC>) mbar_wait(bars + 8 * (kStages<NC> + s), ((t / kStages<NC>) - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t ks = kv_s + s * stage_bytes, vs = ks + NC * kChunkBytes;
        const int k0 = kt0 + t * kTileKeys;
        mbar_expect_tx(full, stage_bytes);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(ks + c * kChunkBytes, &kmap, full, c * 64, g, k0, b);
          tma_load_4d(vs + c * kChunkBytes, &vmap, full, c * 64, g, k0, b);
        }
      }
    }
    return;
  }

  // consumers: this thread holds the accumulator rows ra and rb = ra + 8
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
  const int pa = q0 + ra / rep, pb = q0 + rb / rep;

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  // running max (raw scores) and partial sums of this thread's two rows
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
  const uint64_t qdesc = sw128_desc(q_s);

  // scores of tile t: S = q K_t^T into sc (overwritten)
  float sc[32];
  auto issue_qk = [&](int t) {
    const uint64_t kdesc = sw128_desc(kv_s + (t % kStages<NC>) * stage_bytes);
#pragma unroll
    for (int kk = 0; kk < NC * 4; ++kk) {
      const uint32_t off = (kk >> 2) * kChunkBytes + (kk & 3) * 32;
      wgmma_ss(sc, qdesc + (off >> 4), kdesc + (off >> 4), kk > 0);
    }
    wgmma_commit();
  };
  // online softmax of tile t's scores in sc: masks (only on the tiles at
  // the causal diagonal, a window's edge or S's end), the new running max,
  // p = 2^(s*c - m*c) in place of the scores (one FFMA and one EX2 each),
  // the sums; -> the factors that rescale the rows' old state
  auto softmax = [&](int t, float& corr_a, float& corr_b) {
    const int k0 = kt0 + t * kTileKeys;
    const bool edge = k0 + kTileKeys > S || (causal && k0 + kTileKeys - 1 > q0) ||
                      (window > 0 && k0 < qlast - window + 1);
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (edge) {
          const int kp = k0 + 8 * j + 2 * (lane & 3) + e;
          if (!key_ok(kp, pa, S, causal, window)) sc[4 * j + e] = kNegInf;
          if (!key_ok(kp, pb, S, causal, window)) sc[4 * j + 2 + e] = kNegInf;
        }
        mx_a = fmaxf(mx_a, sc[4 * j + e]);
        mx_b = fmaxf(mx_b, sc[4 * j + 2 + e]);
      }
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    corr_a = ex2((m_a - mx_a) * scale_log2);
    corr_b = ex2((m_b - mx_b) * scale_log2);
    m_a = mx_a;
    m_b = mx_b;
    // a row that has seen no key yet keeps a zero state (the TPU kernel's
    // -1e30 bookkeeping gives it weights the first visible key wipes)
    const float ma = m_a == kNegInf ? 0.0f : m_a * scale_log2;
    const float mb = m_b == kNegInf ? 0.0f : m_b * scale_log2;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool row_a = (i & 2) == 0;
      sc[i] = ex2(fmaf(sc[i], scale_log2, row_a ? -ma : -mb));
      if (row_a) sum_a += sc[i]; else sum_b += sc[i];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
  };
  // p rounded to bf16 as the A fragments of the PV product, 16 keys each:
  // the accumulator's own layout
  uint32_t pf[4][4];
  auto pack = [&]() {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[kc][i] = pack_bf16(sc[8 * kc + 2 * i], sc[8 * kc + 2 * i + 1]);
  };

  // Pipelined: QK^T of tile t+1 and PV of tile t go to the tensor cores
  // together, and the softmax of tile t+1 runs while PV of tile t does.
  auto issue_pv = [&](int t) {
    const uint64_t vdesc = sw128_desc(kv_s + (t % kStages<NC>) * stage_bytes + NC * kChunkBytes);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_rs(o[c], pf[kc], vdesc + ((c * kChunkBytes + kc * 16 * 128) >> 4));
    wgmma_commit();
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages<NC> + t % kStages<NC>));
  };
  mbar_wait(qbar, 0);
  mbar_wait(bars, 0);
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  fence_regs(sc);
  wgmma_fence();
  issue_qk(0);
  wgmma_wait0();
  fence_regs(sc);
  float corr_a, corr_b;
  softmax(0, corr_a, corr_b);
  pack();
  for (int t = 0; t + 1 < nt; ++t) {
    mbar_wait(bars + 8 * ((t + 1) % kStages<NC>), ((t + 1) / kStages<NC>) & 1);
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    fence_regs(sc);
    wgmma_fence();
    issue_qk(t + 1);
    issue_pv(t);
    wgmma_wait1();
    fence_regs(sc);
    softmax(t + 1, corr_a, corr_b);
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    release(t);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= corr_a;
        o[c][4 * j + 1] *= corr_a;
        o[c][4 * j + 2] *= corr_b;
        o[c][4 * j + 3] *= corr_b;
      }
    pack();
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(o[c]);
  wgmma_fence();
  issue_pv(nt - 1);
  wgmma_wait0();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(o[c]);
  release(nt - 1);

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.0f / fmaxf(l_a, 1e-20f), inv_b = 1.0f / fmaxf(l_b, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra, qp = half ? pb : pa;
    if (r >= rows || qp >= S) continue;
    const float inv = half ? inv_b : inv_a;
    __nv_bfloat16* orow = out + ((static_cast<long long>(b) * S + qp) * H + g * rep + r % rep) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + 8 * j + 2 * (lane & 3);
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              o[c][4 * j + 2 * half] * inv, o[c][4 * j + 2 * half + 1] * inv);
      }
  }
}

#undef ACC32
#undef REGS32

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so that the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (B, S, heads, hd) as a 4-D map of boxes (64 columns,
// box_heads, box_rows, 1), 128-byte swizzled; reads past an edge fill zeros.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int heads,
                int hd, int box_heads, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                 int K, int hd, int causal, int window, float scale, int bq, cudaStream_t st) {
  const int rep = H / K;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap;
  if (!tensor_map(encode, &qmap, q, B, S, H, hd, rep, bq) ||
      !tensor_map(encode, &kmap, k, B, S, K, hd, 1, kTileKeys) ||
      !tensor_map(encode, &vmap, v, B, S, K, hd, 1, kTileKeys))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)NC * kChunkBytes + (size_t)kStages<NC> * 2 * NC * kChunkBytes +
                      8 * (2 * kStages<NC> + 1);
  auto kernel = flash_wgmma_kernel<NC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + bq - 1) / bq, K, B);
  kernel<<<grid, kWgThreads, smem, st>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), S,
                                         H, hd, rep, bq, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                   int K, int hd, int causal, int window, float scale, int bq, cudaStream_t st) {
  const int rep = H / K;
  if (bq < 1 || bq * rep > 64) return (int)cudaErrorInvalidValue;
#define WG_LAUNCH(NC) \
  return launch_wgmma<NC>(q, k, v, out, B, S, H, K, hd, causal, window, scale, bq, st)
  if (hd <= 64) WG_LAUNCH(1);
  if (hd <= 128) WG_LAUNCH(2);
  if (hd <= 192) WG_LAUNCH(3);
  WG_LAUNCH(4);
#undef WG_LAUNCH
}

}  // namespace

extern "C" {

// q, out: (B,S,H,hd); k, v: (B,S,K,hd); all contiguous and 16-byte aligned,
// dtype 0 = float32 or 1 = bfloat16. H % K == 0 with H / K <= 32; hd a
// multiple of 8, at most 256. window <= 0 means no window. scale multiplies
// q.k. bq: the bfloat16 kernel's positions per tile, from
// kernels/flash_attention.py ``flash_tile_plan``; the float32 kernel
// ignores it.
int flash_attention(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                    int K, int hd, int causal, int window, float scale, int dtype, int bq,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || H / K > kRows || hd <= 0 || hd % 8 != 0 || hd > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_wgmma(q, k, v, out, B, S, H, K, hd, causal, window, scale, bq, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
