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
// One template, paged_split_kernel, runs all four forms: q's dtype and
// whether the pages are int8 are template arguments, and the phase a
// run-time one (null for the per-row-pos forms: every row is live). It
// walks a row's keys [lo, hi]: lo the window's first key, hi = min(pos,
// nb * ps - 1). The TPU kernel's ragged index map stops at the same page,
// and the per-row-pos forms stop there too: the pages past pos hold only
// masked keys, whose weights are exact zeros. The TPU kernels' block_k
// sub-page tile has no counterpart: the walk is the same for every block_k
// the wrappers accept.
//
// The launch: one thread-block cluster per (kv head, row) splitting the
// row's keys. kernels/paged_decode_attention.py ``paged_split_plan`` sizes
// the cluster on the host from shapes alone: the keys a row can reach (nb *
// ps, at most the window) in tiles of 64 keys (32 with a float32 q), at
// most 8 blocks (the portable cluster size), the fewest tiles a block that
// keep it there. It never reads pos, which lives on the device (reading it
// would synchronise, and would bar capturing the step in a CUDA graph).
// Each block finds its own range on the device: the row's tiles counted
// from lo, split evenly over the cluster's blocks by rank. A block whose
// range is empty still reaches both cluster barriers, holding (-inf, 0, 0).
// A row at phase 0 ends its whole cluster before any page is read (every
// block reads the same phase[r]) and writes exact zeros.
//   Four warps a block; warp w copies keys [w KPW, (w + 1) KPW) of every
// tile (KPW = 16, or 8 with a float32 q). Lane i reads the table entry of
// its warp's key i % KPW (clamped into [0, P)) and resolves the key's pool
// row; the warp then copies its keys' K and V rows into a ring of
// shared-memory stages with cp.async, 16 bytes a copy (8 bf16 or 4 float32
// elements; 8 int8 elements in 8 bytes), consecutive lanes on consecutive
// bytes of a row (a key's rows are K * hd elements from the next key's),
// and for int8 pages each key's two scales beside them; keys past the
// range are zero-filled, not read. Head dims are padded to D = 64 or 128
// (zeros past hd), so that the copy layout and the loops are fixed at
// compile time. Up to ``stages`` (at most 3) of a block's tiles are in
// flight before the first is computed.
//
// The products, by q's dtype:
//   * bf16: mma.sync m16n8k16. A warp computes on the 16 keys it copied, so
// it waits for no other warp until the merge. The products are transposed
// so that the group's heads (rep <= 8) are the 8 columns and no operand row
// is padding: S^T (16 keys x 8 heads) = K q^T, with q's fragments loaded
// once from global memory into registers; softmax down the columns in the
// log2 domain; O^T (16 dims x 8 heads) += V^T P, V by ldmatrix.trans, P
// moved from the S^T accumulator into the B operand by movmatrix. The four
// warps' (m, l, acc) merge in shared memory. bf16 pages: p is rounded to
// bf16 as PV's operand, as the Pallas kernel casts it. int8 pages: each
// lane widens one of its warp's 32 rows to bf16 in the warp's scratch,
// exactly (two logic ops and a bf16x2 add a pair of values), so S = q . k
// is exact products summed in float32, then times the key's k scale. PV
// keeps the float32 form's w = p * v_scale: it goes in as two bf16
// operands, hi = bf16(w) and lo = bf16(w - hi) (|w - hi - lo| <= 2^-16
// |w|), two products into the same float32 accumulators.
//   * float32: CUDA cores, as decode_attention.cu's float32 kernel
// (mma.sync would round q to bf16 or TF32, outside float32's 1e-5). q sits
// in shared memory. Thread (warp w, lane j) scores key j of the 32-key tile
// for heads w and w + 4, and warp w then takes the same two heads for the
// tile's max and sum (a key a lane, so the scores never leave registers)
// and PV, each lane owning D/32 consecutive head dims and taking the keys'
// weights by shuffle. Every warp reads every warp's rows: the block meets
// at a barrier before and after each tile. Its warps hold distinct heads,
// so the block's state needs no warp merge. int8 pages: values widened to
// float32 exactly, S = (q . k) times the key's k scale, PV of p * v_scale
// in float32: the float32 form of the reference's int8 oracle.
// The blocks of a cluster then merge through distributed shared memory
// behind two cluster barriers, as in decode_attention.cu, and write
// acc / max(l, 1e-20) in q's dtype.
//
// What the versions taught, at the serve path's shape (R 16, H 32, K 8,
// hd 64, rows' positions spread over 640 keys, 12 rows live; chip_smoke.py
// phase 11; an H100 SXM). The first design, one block per (kv head, row)
// of sixteen warps taking 32-key groups of the walk with per-key dot
// products on CUDA cores, went from 90 us (four warps, V read inside the
// PV loop) to 25 (V staged in shared memory, 64 elements of a row's loads
// in flight, sixteen warps, the head group in registers): bound by issued
// instructions and latency, not bytes, as its 128 blocks left the longest
// row's warps to walk its keys alone. Splitting that walk over a cluster
// and moving the products to tensor cores gave 14.4 us (bf16 pages) and
// 19.3 (int8) with a lane a row and the heads as padded A rows; 11.7 and
// 15.2 with the products transposed; 9.0 and 11.3 with the copies
// coalesced (and 80 registers, six blocks an SM: the 640 blocks in one
// wave); about 8 and 10 with the copy layout fixed at compile time and the
// page offsets stepped a tile at a time instead of divided; 7.7 and 9.9
// with the last cluster barrier relaxed (it only keeps shared memory
// alive) and the int8 widening by bf16x2 adds instead of float adds.
// Reading the table entries before pos (an even split cannot) and pushing
// the blocks' states into one block's shared memory behind a single
// barrier were both slower here.
//
// The shard form (kShard; the C entry paged_decode_attention_shard) is the
// same walk over one rank's share of a pool split by pages: the table holds
// this rank's local page ids, and an entry outside [0, P) is a page another
// rank owns. Its keys are neither read (the copies zero-fill them) nor
// attended (their scores are masked like keys past pos): the mask reads the
// key's table entry again, from L1, where the softmax needs it. It writes o
// in float32 and each (row, head)'s natural log-sum-exp of the attended
// scores, (m + log2 l) ln 2 from the cluster merge's (m, l); a live row with
// no local key gets o = 0 and lse = -inf, a row at phase 0 exact zeros and
// -inf. The ranks' (o, lse) merge into the whole pool's attention
// (dist/exchange.py merge_partials). The whole-pool instantiations are the
// ones above, unchanged.
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

constexpr int kMaxRep = 8;  // query heads per kv head; MAX_GROUP in the wrapper
// Head dims up to 128 (MAX_HEAD_DIM in the wrapper): the widest of the
// port's dense decoders, and the widest padded head dim D instantiated.
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;
constexpr int kSplitThreads = 128;               // four warps
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kMaxCluster = 8;                   // MAX_CLUSTER in the wrapper
constexpr int kMaxStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Blocks an SM holds at once at head dims up to D, by registers (at most
// 80 a thread at D 64, 128 at D 128): 640 blocks at the serve shape (R 16,
// K 8, clusters of 5) stay resident in one wave.
template <int D> constexpr int kSplitBlocksPerSm = D <= 64 ? 6 : 4;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Keys a tile: 64 with a bf16 q (16 a warp, one mma.sync k step each), 32
// with a float32 q (a key a lane); TILE in the wrapper.
__host__ __device__ constexpr int split_tile(bool f32) { return f32 ? 32 : 64; }
// The head dims: hd padded to D = 64 or 128 (zeros past hd).
__host__ __device__ constexpr int split_dims(int hd) { return hd <= 64 ? 64 : 128; }
// Bytes between two K (or V) rows of D elements of esize bytes in a stage.
// bf16 and float32: 16 past a multiple of 128, so that ldmatrix's eight row
// addresses, or eight lanes reading 16 bytes each of their own rows, hit
// distinct banks. int8: 8 past a multiple of 16, so that 16 lanes reading
// 8 bytes each of their own rows hit distinct banks.
__host__ __device__ constexpr int row_bytes(int esize, int D) {
  return esize * D + (esize == 1 ? 8 : 16);
}

// A stage of the ring: the tile's K rows, its V rows, and for int8 pages
// their k scales and v scales (float32).
__host__ __device__ constexpr int stage_bytes(bool f32, bool int8, int D) {
  return 2 * split_tile(f32) * (row_bytes(int8 ? 1 : f32 ? 4 : 2, D) + (int8 ? 4 : 0));
}

// Dynamic shared memory of a launch: the ring, then q in float32 (float32
// q) or the warps' bf16 scratch of 16 K and 16 V rows each (int8 pages,
// bf16 q); all later reused for the merge's (m, l, acc) of the four warps
// and of the block. The wrapper's ``paged_split_plan`` computes the same
// number.
__host__ __device__ __forceinline__ int split_smem_bytes(bool f32, bool int8, int hd, int rep,
                                                         int stages) {
  const int D = split_dims(hd);
  const int extra = f32 ? 4 * rep * hd : int8 ? kSplitWarps * 32 * row_bytes(2, D) : 0;
  const int loop = stages * stage_bytes(f32, int8, D) + extra;
  const int merge = 4 * (kSplitWarps + 1) * rep * (hd + 2);
  return loop > merge ? loop : merge;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
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

// N consecutive values of E (float or int8) from shared memory aligned to
// their size, as float32 (exact)
template <typename E, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float (&out)[N]) {
  constexpr int bytes = N * (int)sizeof(E);
  using W = typename std::conditional<
      bytes >= 16, uint4,
      typename std::conditional<bytes == 8, uint2,
                                typename std::conditional<bytes == 4, uint32_t,
                                                          uint16_t>::type>::type>::type;
  static_assert(bytes % (int)sizeof(W) == 0, "whole words");
  W w[bytes / sizeof(W)];
#pragma unroll
  for (int c = 0; c < bytes / (int)sizeof(W); ++c) w[c] = reinterpret_cast<const W*>(p)[c];
  const E* e = reinterpret_cast<const E*>(w);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = static_cast<float>(e[i]);
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
// T: q and out (bf16: mma.sync products; float: CUDA cores); kInt8: int8
// pages with scales, else pages of T; D: split_dims(hd); NS: stages of the
// ring. A thread keeps (m, l) of two heads: columns 2(lane%4) and
// 2(lane%4) + 1 of the transposed products (bf16), whose accumulators hold
// rows lane/4 and lane/4 + 8 (keys, or dims); or heads warp and warp + 4
// (float32), with acc over dims lane D/32 + e. kShard: the shard form, out
// float32 and lse (R, K rep) float32; else out of T and lse unused.
template <typename T, bool kInt8, bool kShard, int D, int NS>
__global__ void __launch_bounds__(kSplitThreads, kSplitBlocksPerSm<D>)
paged_split_kernel(const T* __restrict__ q, const void* __restrict__ kpages,
                   const void* __restrict__ vpages, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ bt,
                   const int* __restrict__ pos, const int* __restrict__ phase,
                   void* __restrict__ out_, float* __restrict__ lse, int K, int hd, int rep,
                   int P, int ps, int nb, int window, float scale_log2) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  using E = typename std::conditional<kInt8, int8_t, T>::type;
  using O = typename std::conditional<kShard, float, T>::type;
  O* __restrict__ out = static_cast<O*>(out_);
  constexpr int TK = split_tile(kF32);
  constexpr int KPW = TK / kSplitWarps;   // keys of a tile a warp copies
  constexpr int CB = kInt8 ? 8 : 16;      // bytes of one copy
  constexpr int EPC = CB / (int)sizeof(E);  // elements of one copy
  constexpr int CPR = D / EPC;            // copies a row
  constexpr int RPI = 32 / CPR;           // rows a warp's copy instruction covers
  constexpr int MD = D / 16;              // bf16: k steps of S^T and m tiles of O^T
  constexpr int DPL = D / 32;             // float32: head dims a lane owns in PV
  constexpr int rs = row_bytes(2, D);     // bf16 rows
  constexpr int rse = row_bytes((int)sizeof(E), D);
  constexpr int sbytes = stage_bytes(kF32, kInt8, D);
  static_assert(KPW % RPI == 0, "a warp's rows in whole copy instructions");
  extern __shared__ __align__(16) unsigned char sbuf[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)gridDim.x;  // one cluster spans x
  const int g = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const long long qoff = ((long long)r * K + g) * rep * hd;

  // the row's phase and position and, for bf16, q's B fragments (column
  // gq: head gq, rows: dims 2tq (+1) and + 8 of each k step; heads past rep
  // and dims past hd zero), all in flight at once
  const int ph = phase != nullptr ? phase[r] : 1;
  const int p_r = pos[r];
  uint32_t qb[MD][2];
  if constexpr (!kF32) {
#pragma unroll
    for (int kk = 0; kk < MD; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = kk * 16 + h * 8 + 2 * tq;
        qb[kk][h] = gq < rep && d < hd
                        ? *reinterpret_cast<const uint32_t*>(q + qoff + (long long)gq * hd + d)
                        : 0u;
      }
  }
  if (ph == 0) {  // the whole cluster leaves; no page is read
    for (int i = rank * kSplitThreads + tid; i < rep * hd; i += csize * kSplitThreads)
      out[qoff + i] = from_f32<O>(0.0f);
    if constexpr (kShard)
      for (int i = rank * kSplitThreads + tid; i < rep; i += csize * kSplitThreads)
        lse[((long long)r * K + g) * rep + i] = neg_inf();
    return;
  }
  // this block's keys: tiles [t_begin, t_end) of the row's keys [lo, hi] from lo
  const int hi = min(p_r, nb * ps - 1);
  const int lo = window > 0 ? max(0, p_r - window + 1) : 0;
  const int ntiles = hi >= lo ? (hi - lo + TK) / TK : 0;
  const int* btr = bt + (long long)r * nb;
  // the shard form: whether key kp (lo <= kp <= hi) lies on a page of this rank
  auto local_key = [&](int kp) {
    if constexpr (kShard) {
      const int e = btr[kp / ps];
      return e >= 0 && e < P;
    } else {
      return true;
    }
  };
  const int per = (ntiles + csize - 1) / csize;
  const int t_begin = min(ntiles, rank * per), t_end = min(ntiles, t_begin + per);

  // a warp's copies of its KPW keys of tile t: the K rows, then the V rows,
  // in CPR copies of EPC elements each; copy instruction i takes rows RPI i
  // + lane / CPR, chunk lane % CPR, so that consecutive lanes copy
  // consecutive bytes of a row, for the K and the V rows of the same keys;
  // lane i < 2 KPW also copies the k (i < KPW) or v scale of key i % KPW
  // for int8 pages. Lane i reads the table entry of key i % KPW and
  // resolves its row; the others take it by shuffle.
  const int which = lane / KPW, jl = lane % KPW;
  const E* kp = static_cast<const E*>(kpages);
  const E* vp = static_cast<const E*>(vpages);
  const int row0 = lane / CPR, chunk = lane % CPR;
  const bool chunk_in = chunk * EPC < hd;
  // key jl of the next tile to read, tn, as (table column pg, offset off),
  // stepped a tile at a time (one division for the whole walk)
  const int key0 = lo + warp * KPW + jl;  // key jl of tile t: key0 + TK t
  int tn = t_begin, pg = (key0 + tn * TK) / ps, off = key0 + tn * TK - pg * ps;
  const int dpg = TK / ps, doff = TK - dpg * ps;
  // (table entry, offset) of key jl of tile tn, offset -1 where the block
  // has no such key; read ahead of the copies that need it
  auto fetch = [&]() {
    const bool ok = tn < t_end && key0 + tn * TK <= hi;
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
      const bool mine = f.y >= 0 && (!kShard || (f.x >= 0 && f.x < P));
      const int myrow = mine ? (min(max(f.x, 0), P - 1) * ps + f.y) * K + g : -1;
      unsigned char* st = sbuf + (t - t_begin) % NS * sbytes;
      const uint32_t dst = smem_u32(st) + (warp * KPW + row0) * rse + chunk * CB;
#pragma unroll
      for (int i = 0; i < KPW / RPI; ++i) {
        const int rr = __shfl_sync(0xffffffffu, myrow, row0 + RPI * i);
        const bool in = rr >= 0 && chunk_in;
        const long long off = in ? (long long)rr * hd + chunk * EPC : 0;
        cp_async<CB>(dst + RPI * i * rse, kp + off, in ? CB : 0);
        cp_async<CB>(dst + (TK + RPI * i) * rse, vp + off, in ? CB : 0);
      }
      if constexpr (kInt8) {
        if (which < 2)
          cp_async<4>(smem_u32(st + 2 * TK * rse + (which * TK + warp * KPW + jl) * 4),
                      (which ? vs : ks) + (myrow >= 0 ? myrow : 0), myrow >= 0 ? 4 : 0);
      }
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
  float* qs = reinterpret_cast<float*>(sbuf + NS * sbytes);  // float32: rep x hd
  if constexpr (kF32)
    for (int i = tid; i < rep * hd; i += kSplitThreads) qs[i] = q[qoff + i];

  constexpr int OA = kF32 ? 2 : MD, OB = kF32 ? DPL : 4;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, o[OA][OB];
#pragma unroll
  for (int a = 0; a < OA; ++a)
#pragma unroll
    for (int e = 0; e < OB; ++e) o[a][e] = 0.0f;

  // ldmatrix row addresses: lane gives row (lane & 7) of matrix lane >> 3
  const int lrow = lane & 7, lmat = lane >> 3;
  unsigned char* scratch = sbuf + NS * sbytes + warp * 32 * rs;  // int8, bf16 q: 16 K, 16 V rows
  for (int t = t_begin; t < t_end; ++t) {
    const int2 next = fetch();  // tile t + NS's, read now, used after this tile
    unsigned char* st = sbuf + (t - t_begin) % NS * sbytes;
    const float* kscale = reinterpret_cast<const float*>(st + 2 * TK * rse);  // then v scales
    cp_async_wait<NS - 1>();
    if constexpr (kF32) {
      __syncthreads();  // every warp's rows of tile t, and q, visible to the block
      // key j = lane's scores for heads warp and warp + 4, two partial sums each
      const bool ok = lo + t * TK + lane <= hi && local_key(lo + t * TK + lane);
      const unsigned char* kr = st + lane * rse;
      float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      for (int d = 0; d < hd; d += 8) {
        float kf[8];
        load_vals<E, 8>(kr + d * (int)sizeof(E), kf);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int h = warp + kSplitWarps * i;
          if (h < rep) {
            const float4* qh = reinterpret_cast<const float4*>(qs + h * hd + d);
            const float4 qa = qh[0], qc = qh[1];
            s[i][0] += qa.x * kf[0] + qa.y * kf[1] + qc.x * kf[4] + qc.y * kf[5];
            s[i][1] += qa.z * kf[2] + qa.w * kf[3] + qc.z * kf[6] + qc.w * kf[7];
          }
        }
      }
      const float f = kInt8 ? scale_log2 * kscale[lane] : scale_log2;
      float w[2] = {0.0f, 0.0f};  // the weights PV takes: p, or p * v_scale for int8
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (warp + kSplitWarps * i < rep) {  // the same for the whole warp
          const float x = ok ? (s[i][0] + s[i][1]) * f : kNegInf;
          const float mx = fmaxf(m[i], warp_max(x));
          const float corr = exp2f(m[i] - mx);
          const float p = ok ? exp2f(x - mx) : 0.0f;
          m[i] = mx;
          l[i] = l[i] * corr + p;  // lane j's share; summed over the warp at the end
          w[i] = kInt8 ? p * kscale[TK + lane] : p;
#pragma unroll
          for (int e = 0; e < DPL; ++e) o[i][e] *= corr;
        }
      }
      // PV: lane owns dims lane DPL + e; key j's weight from lane j
      const unsigned char* vt = st + TK * rse + lane * DPL * (int)sizeof(E);
#pragma unroll 4
      for (int j = 0; j < TK; ++j) {
        float vf[DPL];
        load_vals<E, DPL>(vt + j * rse, vf);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float pj = __shfl_sync(0xffffffffu, w[i], j);
#pragma unroll
          for (int e = 0; e < DPL; ++e) o[i][e] += pj * vf[e];
        }
      }
      __syncthreads();  // the block is done with this stage before it is refilled
    } else {
      __syncwarp();  // the warp's rows of tile t visible to the warp
      uint32_t kt, vt;
      if constexpr (kInt8) {
        // lane i widens row i of the warp's 32 into the scratch
        const unsigned char* srow = st + (which * TK + warp * KPW + jl) * rse;
        unsigned char* wrow = scratch + (which * KPW + jl) * rs;
#pragma unroll
        for (int c = 0; c < CPR; ++c) {
          const uint2 w = *reinterpret_cast<const uint2*>(srow + c * 8);
          const uint2 a = int8x4_to_bf16x4(w.x), b = int8x4_to_bf16x4(w.y);
          *reinterpret_cast<uint4*>(wrow + c * 16) = make_uint4(a.x, a.y, b.x, b.y);
        }
        __syncwarp();
        kt = smem_u32(scratch);
        vt = kt + KPW * rs;
      } else {
        kt = smem_u32(st) + warp * KPW * rs;
        vt = kt + TK * rs;
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
      const int kw = lo + t * TK + warp * KPW;  // the warp's first key
      const bool ok0 = kw + gq <= hi && local_key(kw + gq);
      const bool ok1 = kw + gq + 8 <= hi && local_key(kw + gq + 8);
      const float* wscale = kscale + warp * KPW;
      float f0 = scale_log2, f1 = scale_log2;
      if constexpr (kInt8) {
        f0 *= wscale[gq];
        f1 *= wscale[gq + 8];
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
        const float* vscale = wscale + TK;
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
    }
    issue(t + NS, next);
  }

  // the block's (m, l, acc) in the ring's place: [rep][hd] and [rep][2],
  // past the four warps' own for bf16
  cp_async_wait<0>();
  __syncthreads();
  float* accs = reinterpret_cast<float*>(sbuf);     // bf16: [warp][rep][hd]
  float* mls = accs + kSplitWarps * rep * hd;       // bf16: [warp][rep][2]
  float* cacc = mls + kSplitWarps * rep * 2;        // [rep][hd]
  float* cml = cacc + rep * hd;                     // [rep][2]
  if constexpr (kF32) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = warp + kSplitWarps * i;
      const float lsum = warp_sum(l[i]);
      if (h < rep) {
        if (lane == 0) {
          cml[2 * h] = m[i];
          cml[2 * h + 1] = lsum;
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane * DPL + e;
          if (d < hd) cacc[h * hd + d] = o[i][e];
        }
      }
    }
  } else {
    // each warp's (m, l, acc) of heads < rep, then the four merged, so that
    // the cluster merges one partial state per block
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
    out[qoff + idx] = from_f32<O>(a / fmaxf(ls, 1e-20f));
    if constexpr (kShard)
      if (idx == h * hd)
        lse[((long long)r * K + g) * rep + h] = ls > 0.0f ? (mc + log2f(ls)) * kLn2 : neg_inf();
  }
  // no block leaves while another reads its shared memory (the reads are
  // done: no ordering needed)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" :::
                   "memory");
}

template <typename T, bool kInt8, bool kShard, int D, int NS>
int launch_split(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const int* bt, const int* pos, const int* phase, void* out, float* lse, int R,
                 int K, int hd, int rep, int P, int ps, int nb, int window, int cluster, int smem,
                 float scale, cudaStream_t st) {
  return cluster_launch(paged_split_kernel<T, kInt8, kShard, D, NS>, dim3(cluster, K, R),
                        kSplitThreads, (size_t)smem, st, static_cast<const T*>(q), k, v,
                        static_cast<const float*>(ks), static_cast<const float*>(vs), bt, pos,
                        phase, out, lse, K, hd, rep, P, ps, nb, window, scale * kLog2e);
}

// The plan (kernels/paged_decode_attention.py ``paged_split_plan``) must be
// the one the shapes give: tiles of split_tile keys, the cluster covering
// the keys a row can reach with none of its blocks idle at the longest row,
// the ring's depth and the shared memory that goes with them.
template <typename T, bool kInt8, bool kShard>
int dispatch_split(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const int* bt, const int* pos, const int* phase, void* out, float* lse,
                   int R, int H, int K, int hd, int P, int ps, int nb, int window, int tile,
                   int cluster, int per_block, int stages, int smem, float scale,
                   cudaStream_t st) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int rep = H / K;
  const long long reach = window > 0 && window < (long long)nb * ps ? window : (long long)nb * ps;
  const long long tiles = (reach + split_tile(kF32) - 1) / split_tile(kF32);
  if (tile != split_tile(kF32) || cluster < 1 || cluster > kMaxCluster || per_block < 1 ||
      (long long)(cluster - 1) * per_block >= tiles || tiles > (long long)cluster * per_block ||
      stages != (per_block < kMaxStages ? per_block : kMaxStages) ||
      smem != split_smem_bytes(kF32, kInt8, hd, rep, stages) || R > 65535 ||
      (long long)P * ps * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
#define SPLIT_ARGS                                                                        \
  q, k, v, ks, vs, bt, pos, phase, out, lse, R, K, hd, rep, P, ps, nb, window, cluster, smem, \
      scale, st
#define SPLIT_STAGES(D)                                                     \
  if (stages == 1) return launch_split<T, kInt8, kShard, D, 1>(SPLIT_ARGS); \
  if (stages == 2) return launch_split<T, kInt8, kShard, D, 2>(SPLIT_ARGS); \
  return launch_split<T, kInt8, kShard, D, 3>(SPLIT_ARGS)
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
// for these shapes and q's dtype; paged_split_kernel refuses any other.
// With shard = 1: the shard form, out (R,H,hd) float32 whatever q's dtype,
// lse (R,H) float32, table entries outside [0, P) another rank's pages.
static int paged_entry(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* bt, const void* pos, const void* phase,
                       void* out, float* lse, int R, int H, int K, int hd, int P, int ps, int nb,
                       int window, int tile, int cluster, int per_block, int stages, int smem,
                       float scale, int dtype, int int8, int shard, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || H / K > kMaxRep || hd <= 0 || hd % 8 != 0 || hd > kMaxHeadDim ||
      P <= 0 || ps <= 0 || nb <= 0 || window < 0 || (int8 && (ks == nullptr || vs == nullptr)) ||
      (shard && lse == nullptr))
    return (int)cudaErrorInvalidValue;
#define SPLIT_ARGS                                                                             \
  q, k, v, ks, vs, static_cast<const int*>(bt), static_cast<const int*>(pos),                  \
      static_cast<const int*>(phase), out, lse, R, H, K, hd, P, ps, nb, window, tile, cluster, \
      per_block, stages, smem, scale, st
#define SPLIT_PICK(T)                                                        \
  if (shard)                                                                 \
    return int8 ? dispatch_split<T, true, true>(SPLIT_ARGS)                  \
                : dispatch_split<T, false, true>(SPLIT_ARGS);                \
  return int8 ? dispatch_split<T, true, false>(SPLIT_ARGS)                   \
              : dispatch_split<T, false, false>(SPLIT_ARGS)
  if (dtype == 0) {
    SPLIT_PICK(float);
  }
  if (dtype == 1) {
    SPLIT_PICK(__nv_bfloat16);
  }
#undef SPLIT_PICK
#undef SPLIT_ARGS
  return (int)cudaErrorInvalidValue;
}

int paged_decode_attention(const void* q, const void* k, const void* v, const void* ks,
                           const void* vs, const void* bt, const void* pos, const void* phase,
                           void* out, int R, int H, int K, int hd, int P, int ps, int nb,
                           int window, int tile, int cluster, int per_block, int stages, int smem,
                           float scale, int dtype, int int8, void* stream) {
  return paged_entry(q, k, v, ks, vs, bt, pos, phase, out, nullptr, R, H, K, hd, P, ps, nb,
                     window, tile, cluster, per_block, stages, smem, scale, dtype, int8, 0,
                     stream);
}

int paged_decode_attention_shard(const void* q, const void* k, const void* v, const void* ks,
                                 const void* vs, const void* bt, const void* pos,
                                 const void* phase, void* out, void* lse, int R, int H, int K,
                                 int hd, int P, int ps, int nb, int window, int tile, int cluster,
                                 int per_block, int stages, int smem, float scale, int dtype,
                                 int int8, void* stream) {
  return paged_entry(q, k, v, ks, vs, bt, pos, phase, out, static_cast<float*>(lse), R, H, K,
                     hd, P, ps, nb, window, tile, cluster, per_block, stages, smem, scale, dtype,
                     int8, 1, stream);
}

}  // extern "C"
