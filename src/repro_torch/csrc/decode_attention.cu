// Flash-decode attention on Hopper (sm_90a), bound through a plain C
// interface (ctypes, see kernels/build.py and kernels/decode_attention.py).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention_pallas: one query
// token per row, q (B,H,hd), against a linear cache k, v (B,S,K,hd); key
// kpos is valid iff kpos <= pos (one pos for the batch) and, with a window,
// kpos > pos - window. fp32 softmax; p is cast to v's dtype before PV.
//
// What bounds it: bytes. Each valid key's K and V rows are read once and
// used for rep = H/K query heads, about rep flops per byte.
//
// Design: split-K. The TPU kernel sweeps the cache in one sequential grid
// axis; here B*K = 32 blocks would leave 100 of 132 SMs idle, so the valid
// key range [lo, pos] is cut into chunks of kChunk keys, one block per
// (chunk, batch, kv head). Only chunks that hold a valid key are launched,
// and inside them only valid keys are read. A block loads its chunk's K/V
// once into shared memory (K with an odd row stride: conflict-free), then
// each warp takes one query head of the group: a lane owns two keys for the
// scores, then a slice of head dims for the PV sum. It writes the chunk's
// (m, l, acc) for each head to the scratch buffer; a second kernel combines
// the chunks per (batch, head), acc * exp(m - M) summed over chunks, and
// divides by l. Any capacity S: the launch covers the chunks of [lo, pos],
// not the cache.
//
// Every entry point launches on the caller's stream, allocates nothing
// (the scratch buffer is the caller's), does not synchronise and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kChunk = 64;  // keys per block; kernels/decode_attention.py CHUNK
constexpr int kCombineThreads = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// Block (chunk c, batch b * K + kv head g). ml holds (m, l) and acc holds hd
// floats per (b, head, chunk), heads of a group adjacent.
template <typename T, int HDV>
__global__ void __launch_bounds__(kWarps * 32)
partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               float* __restrict__ ml, float* __restrict__ accs, int S, int K, int hd, int rep,
               int pos, int lo, int first_chunk, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // rep x hd
  float* ks = qs + rep * hd;            // kChunk x (hd + 1)
  float* vs = ks + kChunk * (hd + 1);   // kChunk x hd
  const int c = blockIdx.x, nchunks = gridDim.x;
  const int bg = blockIdx.y, b = bg / K, g = bg - b * K;
  const int k0 = (first_chunk + c) * kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kstride = hd + 1;

  // q (B,H,hd): the group's heads g * rep + r are rows bg * rep + r
  const T* qg = q + (long long)bg * rep * hd;
  for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) qs[i] = to_f32(qg[i]);
  for (int i = threadIdx.x; i < kChunk * hd; i += blockDim.x) {
    const int j = i / hd, d = i - j * hd;
    const int kp = k0 + j;
    float kx = 0.0f, vx = 0.0f;
    if (kp >= lo && kp <= pos) {
      const long long idx = ((b * (long long)S + kp) * K + g) * hd + d;
      kx = to_f32(k[idx]);
      vx = to_f32(v[idx]);
    }
    ks[j * kstride + d] = kx;
    vs[j * hd + d] = vx;
  }
  __syncthreads();

  const int kp0 = k0 + lane, kp1 = k0 + 32 + lane;
  const bool ok0 = kp0 >= lo && kp0 <= pos, ok1 = kp1 >= lo && kp1 <= pos;
  for (int r = warp; r < rep; r += kWarps) {
    const float* qr = qs + r * hd;
    const float* k0r = ks + lane * kstride;
    const float* k1r = ks + (lane + 32) * kstride;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float qd = qr[d];
      s0 += qd * k0r[d];
      s1 += qd * k1r[d];
    }
    s0 = ok0 ? s0 * scale : kNegInf;
    s1 = ok1 ? s1 * scale : kNegInf;
    // every launched chunk holds a valid key, so m is finite
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = expf(s0 - m), p1 = expf(s1 - m);
    const float l = warp_sum(p0 + p1);
    const float pv0 = round_to<T>(p0), pv1 = round_to<T>(p1);
    float acc[HDV];
#pragma unroll
    for (int e = 0; e < HDV; ++e) acc[e] = 0.0f;
    for (int j = 0; j < 32; ++j) {
      const float pa = __shfl_sync(0xffffffffu, pv0, j);
      const float pb = __shfl_sync(0xffffffffu, pv1, j);
      const float* va = vs + j * hd;
      const float* vb = vs + (j + 32) * hd;
#pragma unroll
      for (int e = 0; e < HDV; ++e) {
        const int d = lane + 32 * e;
        if (d < hd) acc[e] += pa * va[d] + pb * vb[d];
      }
    }
    const long long row = (long long)bg * rep + r;
    const long long slot = row * nchunks + c;
    if (lane == 0) {
      ml[2 * slot] = m;
      ml[2 * slot + 1] = l;
    }
#pragma unroll
    for (int e = 0; e < HDV; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) accs[slot * hd + d] = acc[e];
    }
  }
}

// One block per (b, head) row of q: combines its chunks.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ ml, const float* __restrict__ accs, T* __restrict__ out,
               int nchunks, int hd) {
  const long long row = blockIdx.x;
  const float* mlr = ml + 2 * row * nchunks;
  float mx = kNegInf;
  for (int c = 0; c < nchunks; ++c) mx = fmaxf(mx, mlr[2 * c]);
  float l = 0.0f;
  for (int c = 0; c < nchunks; ++c) l += mlr[2 * c + 1] * expf(mlr[2 * c] - mx);
  const float inv_l = 1.0f / fmaxf(l, 1e-20f);
  const float* ar = accs + row * nchunks * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.0f;
    for (int c = 0; c < nchunks; ++c) a += ar[(long long)c * hd + d] * expf(mlr[2 * c] - mx);
    out[row * hd + d] = from_f32<T>(a * inv_l);
  }
}

template <typename T, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, float* scratch, int B, int S,
           int H, int K, int hd, int pos, int lo, int first_chunk, int nchunks, float scale,
           cudaStream_t st) {
  const int rep = H / K;
  const size_t smem =
      sizeof(float) * ((size_t)rep * hd + (size_t)kChunk * (hd + 1) + (size_t)kChunk * hd);
  auto kernel = partial_kernel<T, HDV>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  float* ml = scratch;
  float* accs = scratch + 2LL * B * H * nchunks;
  kernel<<<dim3(nchunks, B * K), kWarps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ml, accs, S,
      K, hd, rep, pos, lo, first_chunk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<B * H, kCombineThreads, 0, st>>>(ml, accs, static_cast<T*>(out), nchunks,
                                                       hd);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, float* scratch, int B,
             int S, int H, int K, int hd, int pos, int lo, int first_chunk, int nchunks,
             float scale, cudaStream_t st) {
#define DECODE_LAUNCH(HDV)                                                                    \
  return launch<T, HDV>(q, k, v, out, scratch, B, S, H, K, hd, pos, lo, first_chunk, nchunks, \
                        scale, st)
  if (hd <= 32) DECODE_LAUNCH(1);
  if (hd <= 64) DECODE_LAUNCH(2);
  if (hd <= 128) DECODE_LAUNCH(4);
  DECODE_LAUNCH(8);
#undef DECODE_LAUNCH
}

}  // namespace

extern "C" {

// q, out: (B,H,hd); k, v: (B,S,K,hd); all contiguous, dtype 0 = float32 or
// 1 = bfloat16; H % K == 0; hd a multiple of 8, at most 256. Valid keys are
// [lo, pos], 0 <= lo <= pos < S; they lie in chunks first_chunk ..
// first_chunk + nchunks - 1 of kChunk keys. scratch: float32,
// B * H * nchunks * (hd + 2) elements.
int decode_attention(const void* q, const void* k, const void* v, void* out, void* scratch,
                     int B, int S, int H, int K, int hd, int pos, int lo, int first_chunk,
                     int nchunks, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || hd <= 0 || hd % 8 != 0 || hd > 256 || pos < 0 || pos >= S ||
      lo < 0 || lo > pos || first_chunk != lo / kChunk ||
      nchunks != pos / kChunk - first_chunk + 1)
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, sc, B, S, H, K, hd, pos, lo, first_chunk, nchunks,
                           scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, sc, B, S, H, K, hd, pos, lo, first_chunk,
                                   nchunks, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
