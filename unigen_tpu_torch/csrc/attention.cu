// Masked GQA softmax attention for Hopper (sm_90a), two entry points.
//
// chunk_attention_launch replaces the TPU kernel
//   unigen_tpu/ops/chunk_attention.py:chunk_attention (body _kernel):
//   every query of batch row b sees exactly the keys with kvalid[b, s] set;
//   logits get an additive bias of 0 or -1e30.
// flash_attention_launch replaces the TPU kernel
//   unigen_tpu/ops/flash_attention.py:flash_attention (body _attn_kernel):
//   visibility comes from the int32 bitfield meta[b, pos] (pad = 1,
//   bidir_q = 2, bidir_k = 4, segment id << 3) and the positions:
//     visible = ~pad[q] & ~pad[k] & (k <= q | bidir_q[q] | bidir_k[k])
//               & seg[q] == seg[k]
//   masked logits are set to -FLT_MAX (finfo(float32).min).
//
// Neither mask uses -inf: a fully masked row then has equal logits and gets
// uniform weights over all keys, as the JAX softmax gives, where -inf would
// give NaN in an online softmax.
//
// Layout: q [B, Lq, H, Dh], k and v [B, S, KVH, Dh], out like q; float32 or
// bfloat16; query head h reads kv head h / (H / KVH). Dh is one of 16, 32,
// 64, 80 and 128; 80 serves SigLIP-SO400M's head dim of 72, zero-padded by
// the caller (zeros add nothing to q.k, and the padded output dims are
// dropped), at 11% more work where padding to 128 would cost 78%.
//
// Design. Keys stream through shared memory tile by tile with an online
// softmax (running max and sum per row, fp32); logits never leave the SM.
// The G = H / KVH query heads that share a K/V head fold into the rows of the
// flattened (query position, head-in-group) index, as the TPU kernel folds
// them into M.
//  * bfloat16, many rows (attention_bf16_kernel; the t2i chunk step and every
//    flash shape): a block owns one (batch row, kv head) and 64 rows, four
//    warps of 16 rows each. Q.K^T and P.V are mma.sync m16n8k16 bf16 products
//    with fp32 accumulation. K and V tiles of kTileKeys (32) keys travel
//    through a ring of kStages (2) stages filled by 16-byte cp.async copies
//    (rows past S zero-filled through src-size), so the next tile's loads are
//    in flight while this tile is multiplied, with one __syncthreads per
//    tile; the per-key mask words ride in a two-deep ring of their own,
//    loaded a tile ahead. The Q tile stays in shared memory and its A
//    fragments are read again by ldmatrix on every key tile: that and the
//    32-key tile keep a thread at 128 registers and a block at 52 KB, so four
//    blocks (16 warps) share an SM. K's and V's B fragments come from
//    ldmatrix.x4 (V's transposed). The softmax runs in base 2: logits are scaled by scale * log2(e) and the mask values (-1e30
//    added, -FLT_MAX set) are applied after that scaling, so masked logits
//    are exactly what they were in base e; the probabilities go from the
//    Q.K^T accumulators straight into the A fragments of P.V (rounded to
//    bf16, as the TPU kernel casts P).
//  * bfloat16, few rows (chunk_split_bf16_kernel; the decode step, Lq * G <=
//    16): the rows are one m16 tile and the keys are split: a block owns one
//    (batch row, kv head, range of keys), grid (nsplit, KVH, B), and its four
//    warps take the range's 16-key rounds in turn, each through its own
//    two-stage cp.async ring, so no warp repeats another's products. The
//    warps' (m, l, o) merge in shared memory, and the block writes an
//    unnormalised fp32 partial (o_part [B, KVH, nsplit, 16, Dh], m_part and
//    l_part [B, KVH, nsplit, 16]) to scratch that the wrapper allocates.
//    chunk_combine_kernel then weights the partials by exp(m_i - max m) and
//    rounds once. Both kernels are queued by the one entry point. A split
//    whose keys are all masked has m = -1e30 (finite) and weight 0 beside any
//    split with a visible key; a row with no visible key anywhere gets equal
//    weights over all S keys, as the unsplit kernel gives.
//  * float32 (tests and the tiny model): the same tiling on the fp32 CUDA
//    cores, 8 warps of 8 rows, 32 keys per tile, loaded synchronously, so
//    fp32 inputs keep full fp32 products; it takes a key range too and then
//    writes the same partials, so both types split by the same rule.
//
// Bounds on this card. The t2i chunk step (q [8,258,12,128], S = 406) is
// ~5 GFLOP against ~16 MB moved: bound by operations on the bf16 tensor
// cores (~5 us). The decode step (q [8,1,12,128], S = 915) reads 7.5 MB of K
// and V for 0.02 GFLOP: bound by bytes (~2.3 us), and before the split it
// ran on 16 blocks of the card's 132 SMs. What the design does about them:
// the split fills the card at the decode step, and the rings keep loads in
// flight under the products. The products are mma.sync, which reaches only
// part of the card's tensor-core rate. This source deliberately uses no
// wgmma, no TMA and no thread block clusters: neither the decode step (bytes)
// nor the loop's former stalls (synchronous loads) called for them, and they
// wait until a benchmark shows the t2i step to be device-bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Per-row key mask of the t2i chunk step: bias 0 or -1e30.
struct RowMask {
  const unsigned char* kvalid;  // [B, S]
  int S;
  __device__ int row_info(int, int) const { return 0; }
  __device__ int key_info(int b, int kpos) const { return kvalid[(size_t)b * S + kpos]; }
  __device__ float logit(float s, int, int, int, int kinfo) const {
    return s + (kinfo ? 0.0f : -1e30f);
  }
};

// Omni mask from the packed bitfield and the positions.
struct MetaMask {
  const int* meta;  // [B, L]
  int L;
  __device__ int row_info(int b, int qpos) const { return meta[(size_t)b * L + qpos]; }
  __device__ int key_info(int b, int kpos) const { return meta[(size_t)b * L + kpos]; }
  __device__ float logit(float s, int qpos, int mq, int kpos, int mk) const {
    bool vis = (kpos <= qpos) || (mq & 2) || (mk & 4);
    vis = vis && !(mq & 1) && !(mk & 1) && ((mq >> 3) == (mk >> 3));
    return vis ? s : -FLT_MAX;
  }
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async rings
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block
constexpr int kTileKeys = 32;             // keys per stage of the ring
constexpr int kStages = 2;                // stages of the K/V ring
constexpr int kMinBlocks = 4;             // blocks per SM: 128 registers a thread
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error 2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c += a . b, a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lane i gives the (16-byte aligned) address of row
// i % 8 of matrix i / 8. Plain: thread (g, t) gets elements (g, 2t), (g, 2t+1)
// of each matrix, which for a [key][dim] tile are K's B fragments.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// Transposed: V's B fragments from a [key][dim] tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes global -> shared without passing through registers; only the
// first src_bytes (16 or 0) are read, the rest of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's newest groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// `rows` rows of DH bf16 into dst[i][LD]: row i from src + i * src_stride
// while i < valid (>= 1), zeros after, by the calling group of nthreads threads.
template <int DH>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                size_t src_stride, int rows, int valid,
                                                int tid, int nthreads) {
  constexpr int LD = DH + 8, CH = DH / 8;
  for (int i = tid; i < rows * CH; i += nthreads) {
    const int j = i / CH, c = i % CH;
    const bool ok = j < valid;
    // a masked copy still names an address inside the array
    cp_async16(dst + j * LD + c * 8, src + (size_t)(ok ? j : 0) * src_stride + c * 8,
               ok ? 16 : 0);
  }
}

// One tile of KEYS keys (a multiple of 16) against this warp's 16 rows:
// logits from K's ldmatrix fragments, base-2 online softmax, P.V.
// kinfo(n, e, j) is the mask word of key k0 + j, j = 8n + 2t + e, the thread's
// e-th key of column tile n; keys at or past k_end count as absent.
// qfrag(kk, a) gives the rows' A fragment of dims 16 kk .. 16 kk + 15.
template <int DH, int KEYS, typename Mask, typename KeyInfo, typename QFrag>
__device__ __forceinline__ void attend_tile(QFrag qfrag,
                                            const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                            KeyInfo kinfo, int k0, int k_end, float scale2,
                                            const Mask& mask, const int (&qpos)[2],
                                            const int (&qinfo)[2], float (&m)[2], float (&l)[2],
                                            float (&o)[DH / 8][4], int lane) {
  constexpr int LD = DH + 8, KS = DH / 16, NT = KEYS / 8, ON = DH / 8;
  const int t = lane & 3;
  // logits: s[n] holds rows (g, g + 8) x keys (8n + 2t, 8n + 2t + 1). One
  // ldmatrix.x4 brings both B halves of two 8-key column tiles: matrix i of
  // lane / 8 = i holds keys 8 * (i / 2) .. and dims 8 * (i % 2) ..
  const int krow = (lane & 7) + 8 * (lane >> 4), kcol = 8 * ((lane >> 3) & 1);
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t qa[4];
    qfrag(kk, qa);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + (16 * np + krow) * LD + 16 * kk + kcol);
      mma_bf16(s[2 * np], qa, kb[0], kb[1]);
      mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1, j = 8 * n + 2 * t + (e & 1), kp = k0 + j;
      // scaled first, masked after: the mask values stay exactly -1e30 / -FLT_MAX
      const float x = kp < k_end
                          ? mask.logit(s[n][e] * scale2, qpos[hf], qinfo[hf], kp, kinfo(n, e & 1, j))
                          : -INFINITY;
      s[n][e] = x;
      mx[hf] = fmaxf(mx[hf], x);
    }
  float corr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 2));
    const float m_new = fmaxf(m[hf], mx[hf]);  // finite: key k0 is in range
    corr[hf] = ex2(m[hf] - m_new);              // 0 on the first tile (m = -inf)
    m[hf] = m_new;
    l[hf] *= corr[hf];
  }
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[n][e] - m[e >> 1]);  // 0 for absent keys
      s[n][e] = p;
      l[e >> 1] += p;
    }

  // P.V over 16 keys per step; V's B fragments via ldmatrix.trans: matrix
  // i of lane (i = lane / 8) holds keys 8 * (i % 2) .. and dims 8 * (i / 2) ..
  const int vrow = (lane & 7) + 8 * ((lane >> 3) & 1), vcol = 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < DH / 16; ++dn) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, vs + (16 * kk + vrow) * LD + 16 * dn + vcol);
      mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
    }
  }
}

template <int DH, typename Mask>
__global__ void __launch_bounds__(kMmaWarps * 32, kMinBlocks)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int Lq, int S, int H, int KVH, float scale2, Mask mask) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = DH + 8;    // bf16 row stride in shared memory (16-byte pad)
  constexpr int ON = DH / 8;    // 8-wide column tiles of the output
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kStageElems = 2 * kTileKeys * LD;  // a stage: K tile, then V tile
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_u4);      // [kStages][2][kTileKeys][LD]
  int* kinfo = reinterpret_cast<int*>(ring + kStages * kStageElems);    // [2][kTileKeys]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(kinfo + 2 * kTileKeys);  // [kMmaRows][LD]

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int rows_total = Lq * G;
  const int row0 = blockIdx.x * kMmaRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and thread-in-group
  const int ntiles = (S + kTileKeys - 1) / kTileKeys;
  const size_t kv_stride = (size_t)KVH * DH;
  const __nv_bfloat16* kbase = k + ((size_t)b * S * KVH + kvh) * DH;
  const __nv_bfloat16* vbase = v + ((size_t)b * S * KVH + kvh) * DH;

  auto fetch_tile = [&](int tile) {
    __nv_bfloat16* st = ring + (tile % kStages) * kStageElems;
    const int k0 = tile * kTileKeys;
    load_rows_async<DH>(st, kbase + (size_t)k0 * kv_stride, kv_stride, kTileKeys, S - k0, tid,
                        kThreads);
    load_rows_async<DH>(st + kTileKeys * LD, vbase + (size_t)k0 * kv_stride, kv_stride,
                        kTileKeys, S - k0, tid, kThreads);
  };
  auto key_info = [&](int tile) {
    const int kp = tile * kTileKeys + tid;
    return (tid < kTileKeys && kp < S) ? mask.key_info(b, kp) : 0;
  };

  // Group 0: the Q tile, one row per (position, head-in-group) of this kv head.
  for (int i = tid; i < kMmaRows * (DH / 8); i += kThreads) {
    const int r = i / (DH / 8), c = i % (DH / 8);
    const int f = row0 + r;
    const bool ok = f < rows_total;
    const int fc = ok ? f : 0;
    cp_async16(qs + r * LD + c * 8,
               q + (((size_t)b * Lq + fc / G) * H + kvh * G + fc % G) * DH + c * 8, ok ? 16 : 0);
  }
  cp_async_commit();
  // Groups 1 .. kStages - 1: the first tiles (a group may be empty).
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) {
    if (tile < ntiles) fetch_tile(tile);
    cp_async_commit();
  }
  if (tid < kTileKeys) kinfo[tid] = key_info(0);
  cp_async_wait<kStages - 1>();  // Q has landed
  __syncthreads();

  // This warp's 16 rows: the thread holds rows wr + g and wr + g + 8.
  const int wr = warp * 16;
  const bool active = row0 + wr < rows_total;  // a warp past the last row only loads
  // A fragments by ldmatrix, read again on every key tile: matrix i of
  // lane / 8 = i holds rows 8 * (i % 2) .. and dims 8 * (i / 2) ..
  const __nv_bfloat16* qrow =
      qs + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
  auto qfrag = [qrow](int kk, uint32_t (&a)[4]) { ldsm_x4(a, qrow + 16 * kk); };
  int qpos[2], qinfo[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int f = min(row0 + wr + g + 8 * hf, rows_total - 1);
    qpos[hf] = f / G;
    qinfo[hf] = mask.row_info(b, qpos[hf]);
  }

  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of the tile have landed
    __syncthreads();               // everyone's have, and tile - 1 is consumed
    if (tile + kStages - 1 < ntiles) fetch_tile(tile + kStages - 1);
    cp_async_commit();
    const int next_info = tile + 1 < ntiles ? key_info(tile + 1) : 0;  // used after the products
    if (active) {
      const __nv_bfloat16* st = ring + (tile % kStages) * kStageElems;
      const int* words = kinfo + (tile & 1) * kTileKeys;
      attend_tile<DH, kTileKeys>(qfrag, st, st + kTileKeys * LD,
                                 [words](int, int, int j) { return words[j]; },
                                 tile * kTileKeys, S, scale2, mask, qpos, qinfo, m, l, o, lane);
    }
    // tile - 1's words were last read before this iteration's barrier
    if (tid < kTileKeys) kinfo[((tile + 1) & 1) * kTileKeys + tid] = next_info;
  }

  if (!active) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(kFull, l[hf], 1);
    l[hf] += __shfl_xor_sync(kFull, l[hf], 2);
    const int f = row0 + wr + g + 8 * hf;
    if (f >= rows_total) continue;
    const int qp = f / G, h = kvh * G + f % G;
    __nv_bfloat16* dst = out + (((size_t)b * Lq + qp) * H + h) * DH + 2 * t;
    const float inv = 1.f / l[hf];
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * hf] * inv, o[n][2 * hf + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, few rows: split over the keys (the decode step)
// ---------------------------------------------------------------------------

constexpr int kSplitRows = 16;    // Lq * G at most: one m16 tile
constexpr int kSplitWarps = 4;
constexpr int kSplitKeys = 16;    // keys per warp and round
constexpr int kSplitStages = 2;   // stages of each warp's ring

template <int DH>
__global__ void __launch_bounds__(kSplitWarps * 32)
chunk_split_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, float* __restrict__ o_part,
                        float* __restrict__ m_part, float* __restrict__ l_part, int Lq, int S,
                        int H, int KVH, int keys_per_split, float scale2, RowMask mask) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = DH + 8, KS = DH / 16, ON = DH / 8;
  constexpr int kStageElems = 2 * kSplitKeys * LD;        // K round, then V round
  constexpr int kWarpElems = kSplitStages * kStageElems;  // one warp's ring
  // the merge buffers reuse the rings once every warp has left its loop
  static_assert(sizeof(__nv_bfloat16) * kSplitWarps * kWarpElems >=
                    sizeof(float) * kSplitWarps * kSplitRows * (DH + 2),
                "the rings hold the merge buffers");
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_u4);

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y, split = blockIdx.x;
  const int rows_total = Lq * G;  // <= kSplitRows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k_begin = split * keys_per_split;
  const int k_end = min(S, k_begin + keys_per_split);  // > k_begin: the launch sizes the grid so
  const int rounds = (k_end - k_begin + kSplitKeys - 1) / kSplitKeys;
  // this warp takes rounds warp, warp + kSplitWarps, ...
  const int my_rounds = rounds > warp ? (rounds - warp + kSplitWarps - 1) / kSplitWarps : 0;
  const size_t kv_stride = (size_t)KVH * DH;
  const __nv_bfloat16* kbase = k + ((size_t)b * S * KVH + kvh) * DH;
  const __nv_bfloat16* vbase = v + ((size_t)b * S * KVH + kvh) * DH;
  __nv_bfloat16* my_ring = ring + warp * kWarpElems;

  auto fetch_round = [&](int i) {  // this warp's i-th round
    __nv_bfloat16* st = my_ring + (i % kSplitStages) * kStageElems;
    const int k0 = k_begin + (warp + i * kSplitWarps) * kSplitKeys;
    load_rows_async<DH>(st, kbase + (size_t)k0 * kv_stride, kv_stride, kSplitKeys, k_end - k0,
                        lane, 32);
    load_rows_async<DH>(st + kSplitKeys * LD, vbase + (size_t)k0 * kv_stride, kv_stride,
                        kSplitKeys, k_end - k0, lane, 32);
  };
#pragma unroll
  for (int i = 0; i < kSplitStages; ++i) {
    if (i < my_rounds) fetch_round(i);
    cp_async_commit();
  }

  // Q's A fragments straight from global memory: rows g and g + 8 of the tile,
  // zeros past the last real row.
  uint32_t qa[KS][4];
  int qpos[2];
  const int qinfo[2] = {0, 0};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int f = g + 8 * hf;
    const bool ok = f < rows_total;
    const int fc = ok ? f : 0;
    qpos[hf] = fc / G;
    const __nv_bfloat16* qr =
        q + (((size_t)b * Lq + fc / G) * H + kvh * G + fc % G) * DH + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][hf] = ok ? *reinterpret_cast<const uint32_t*>(qr + kk * 16) : 0u;
      qa[kk][hf + 2] = ok ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8) : 0u;
    }
  }

  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  auto qfrag = [&qa](int kk, uint32_t (&a)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
  };
  for (int i = 0; i < my_rounds; ++i) {
    const int k0 = k_begin + (warp + i * kSplitWarps) * kSplitKeys;
    // the thread's four mask bytes, keys 2t, 2t + 1, 8 + 2t, 9 + 2t of the
    // round, asked for before the wait so that they travel with the copies
    int kin[kSplitKeys / 8][2];
#pragma unroll
    for (int n = 0; n < kSplitKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * n + 2 * t + e;
        kin[n][e] = kp < k_end ? mask.key_info(b, kp) : 0;
      }
    cp_async_wait<kSplitStages - 1>();
    __syncwarp();  // every lane's copies of round i have landed
    const __nv_bfloat16* st = my_ring + (i % kSplitStages) * kStageElems;
    attend_tile<DH, kSplitKeys>(qfrag, st, st + kSplitKeys * LD,
                                [&kin](int n, int e, int) { return kin[n][e]; }, k0, k_end,
                                scale2, mask, qpos, qinfo, m, l, o, lane);
    __syncwarp();  // the stage is consumed
    if (i + kSplitStages < my_rounds) fetch_round(i + kSplitStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // Merge the warps' (m, l, o): a warp with no round holds (-inf, 0, 0) and
  // gets weight 0, and warp 0 always has a round with a key below S.
  float* o_s = reinterpret_cast<float*>(smem_u4);           // [kSplitWarps][kSplitRows][DH]
  float* m_s = o_s + kSplitWarps * kSplitRows * DH;          // [kSplitWarps][kSplitRows]
  float* l_s = m_s + kSplitWarps * kSplitRows;               // [kSplitWarps][kSplitRows]
  __syncthreads();  // every warp is done with its ring
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(kFull, l[hf], 1);
    l[hf] += __shfl_xor_sync(kFull, l[hf], 2);
    const int r = warp * kSplitRows + g + 8 * hf;
    if (t == 0) {
      m_s[r] = m[hf];
      l_s[r] = l[hf];
    }
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<float2*>(o_s + r * DH + 8 * n + 2 * t) =
          make_float2(o[n][2 * hf], o[n][2 * hf + 1]);
  }
  __syncthreads();
  const size_t part0 = (((size_t)b * KVH + kvh) * gridDim.x + split) * kSplitRows;
  for (int i = tid; i < rows_total * DH; i += kSplitWarps * 32) {
    const int r = i / DH, d = i % DH;
    float mm = m_s[r];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w) mm = fmaxf(mm, m_s[w * kSplitRows + r]);
    float acc = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = ex2(m_s[w * kSplitRows + r] - mm);
      acc += wt * o_s[(w * kSplitRows + r) * DH + d];
      den += wt * l_s[w * kSplitRows + r];
    }
    o_part[(part0 + r) * DH + d] = acc;
    if (d == 0) {
      m_part[part0 + r] = mm;
      l_part[part0 + r] = den;
    }
  }
}

// out = sum_i w_i o_i / sum_i w_i l_i with w_i = exp(m_i - max m) over the
// splits' partials; BASE2 says whether the m_i are base-2 logits (the bf16
// kernel) or natural ones (the fp32 kernel). Grid (rows, KVH, B).
template <typename T, bool BASE2>
__global__ void chunk_combine_kernel(const float* __restrict__ o_part,
                                     const float* __restrict__ m_part,
                                     const float* __restrict__ l_part, T* __restrict__ out,
                                     int nsplit, int Lq, int H, int KVH, int DH) {
  const int G = H / KVH;
  const int f = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const size_t part0 = ((size_t)b * KVH + kvh) * nsplit * kSplitRows + f;
  float mm = -INFINITY;
  for (int i = 0; i < nsplit; ++i) mm = fmaxf(mm, m_part[part0 + (size_t)i * kSplitRows]);
  T* dst = out + (((size_t)b * Lq + f / G) * H + kvh * G + f % G) * DH;
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float acc = 0.f, den = 0.f;
    for (int i = 0; i < nsplit; ++i) {
      const size_t p = part0 + (size_t)i * kSplitRows;
      const float x = m_part[p] - mm;  // finite - finite: every split has a key below S
      const float wt = BASE2 ? exp2f(x) : expf(x);
      acc += wt * o_part[p * DH + d];
      den += wt * l_part[p];
    }
    const float y = acc / den;
    if constexpr (sizeof(T) == 2) dst[d] = __float2bfloat16_rn(y);
    else dst[d] = y;
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                      // keys per tile: one per lane

// SPLIT: the block owns the keys [blockIdx.x * keys_per_split, + keys_per_split)
// of all (at most kSplitRows) rows and writes the split kernel's partials in
// place of out, with natural-base m.
template <int DH, typename Mask, bool SPLIT>
__global__ void __launch_bounds__(kWarps * 32)
attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ o_part, float* __restrict__ m_part,
                      float* __restrict__ l_part, int Lq, int S, int H, int KVH,
                      int keys_per_split, float scale, Mask mask) {
  constexpr int QS = DH + 4;             // padded fp32 row stride of q and k tiles
  constexpr int NO = (DH + 31) / 32;     // output dims per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][QS]
  float* ks = qs + kRows * QS;                   // [kKeys][QS]
  float* vs = ks + kKeys * QS;                   // [kKeys][DH]

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int rows_total = Lq * G;
  const int row0 = SPLIT ? 0 : blockIdx.x * kRows;
  const int k_begin = SPLIT ? blockIdx.x * keys_per_split : 0;
  const int k_end = SPLIT ? min(S, k_begin + keys_per_split) : S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kRows * DH; i += blockDim.x) {
    const int r = i / DH, d = i % DH;
    const int f = row0 + r;
    float val = 0.f;
    if (f < rows_total) {
      const int qp = f / G, h = kvh * G + f % G;
      val = q[(((size_t)b * Lq + qp) * H + h) * DH + d];
    }
    qs[r * QS + d] = val;
  }

  int qpos[kRowsPerWarp], qinfo[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][NO];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int f = min(row0 + warp * kRowsPerWarp + rr, rows_total - 1);
    qpos[rr] = f / G;
    qinfo[rr] = mask.row_info(b, qpos[rr]);
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[rr][i] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and the q tile written)
    for (int i = tid; i < kKeys * DH; i += blockDim.x) {
      const int j = i / DH, d = i % DH;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < k_end) {
        const size_t off = (((size_t)b * S + kp) * KVH + kvh) * DH + d;
        kv = k[off];
        vv = v[off];
      }
      ks[j * QS + d] = kv;
      vs[j * DH + d] = vv;
    }
    __syncthreads();

    const int kp = k0 + lane;
    const bool in_range = kp < k_end;
    const int kinfo = in_range ? mask.key_info(b, kp) : 0;

    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * QS);
    const float4* qrow = reinterpret_cast<const float4*>(qs + warp * kRowsPerWarp * QS);
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qq = qrow[rr * (QS / 4) + d4];
        s[rr] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const float x = in_range ? mask.logit(s[rr] * scale, qpos[rr], qinfo[rr], kp, kinfo)
                               : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(x));
      const float corr = expf(m[rr] - m_new);  // 0 on the first tile (m = -inf)
      const float p = expf(x - m_new);          // 0 for keys past the end
      l[rr] = l[rr] * corr + p;
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < NO; ++i) o[rr][i] *= corr;
      s[rr] = p;
    }

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vv[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < DH ? vs[j * DH + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pj = __shfl_sync(kFull, s[rr], j);
#pragma unroll
        for (int i = 0; i < NO; ++i) o[rr][i] += pj * vv[i];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const float denom = warp_sum(l[rr]);
    const int f = row0 + warp * kRowsPerWarp + rr;
    if (f >= rows_total) continue;
    if constexpr (SPLIT) {
      const size_t part =
          (((size_t)b * KVH + kvh) * gridDim.x + blockIdx.x) * kSplitRows + f;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int d = lane + 32 * i;
        if (d < DH) o_part[part * DH + d] = o[rr][i];
      }
      if (lane == 0) {
        m_part[part] = m[rr];
        l_part[part] = denom;
      }
    } else {
      const int qp = f / G, h = kvh * G + f % G;
      float* dst = out + (((size_t)b * Lq + qp) * H + h) * DH;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int d = lane + 32 * i;
        if (d < DH) dst[d] = o[rr][i] / denom;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int kSplitGranule = 64;  // a split's keys come in multiples of this

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// 16-byte vector loads and copies of q, k, v rows
bool misaligned16(const void* q, const void* k, const void* v, const void* out) {
  return (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16) != 0;
}

template <int DH>
constexpr size_t fp32_smem() {
  return sizeof(float) * ((size_t)(kRows + kKeys) * (DH + 4) + (size_t)kKeys * DH);
}

template <int DH, typename Mask>
int launch_dh_typed(int dtype, const void* q, const void* k, const void* v, void* out, int B,
                    int Lq, int S, int H, int KVH, float scale, Mask mask,
                    cudaStream_t stream) {
  const int G = H / KVH;
  if (dtype == 1) {
    if (misaligned16(q, k, v, out)) return (int)cudaErrorMisalignedAddress;
    const size_t smem =
        sizeof(__nv_bfloat16) * ((size_t)kStages * 2 * kTileKeys + kMmaRows) * (DH + 8) +
        sizeof(int) * 2 * kTileKeys;
    auto kern = attention_bf16_kernel<DH, Mask>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Lq * G + kMmaRows - 1) / kMmaRows, KVH, B);
    kern<<<grid, kMmaWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Lq, S, H, KVH,
        scale * kLog2e, mask);
    return (int)cudaGetLastError();
  }
  auto kern = attention_fp32_kernel<DH, Mask, false>;
  cudaError_t err = allow_smem(kern, fp32_smem<DH>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq * G + kRows - 1) / kRows, KVH, B);
  kern<<<grid, kWarps * 32, fp32_smem<DH>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), nullptr, nullptr, nullptr, Lq, S, H, KVH, 0, scale, mask);
  return (int)cudaGetLastError();
}

// The split route of chunk attention: partials per key range, then the
// combine, both on `stream`. nsplit is the wrapper's wish; a split takes a
// multiple of kSplitGranule keys, and the grid has as many splits as then
// hold a key, so none is empty. scratch holds B * KVH * nsplit * kSplitRows *
// (DH + 2) floats.
template <int DH>
int launch_split_dh(int dtype, const void* q, const void* k, const void* v, void* out,
                    float* scratch, int B, int Lq, int S, int H, int KVH, int nsplit,
                    float scale, RowMask mask, cudaStream_t stream) {
  const int G = H / KVH;
  const int per = kSplitGranule * ((S + kSplitGranule * nsplit - 1) / (kSplitGranule * nsplit));
  const int ns = (S + per - 1) / per;
  float* o_part = scratch;
  float* m_part = o_part + (size_t)B * KVH * ns * kSplitRows * DH;
  float* l_part = m_part + (size_t)B * KVH * ns * kSplitRows;
  const dim3 grid(ns, KVH, B), combine_grid(Lq * G, KVH, B);
  const int combine_threads = DH < 128 ? (DH + 31) / 32 * 32 : 128;
  if (dtype == 1) {
    if (misaligned16(q, k, v, out)) return (int)cudaErrorMisalignedAddress;
    const size_t smem = sizeof(__nv_bfloat16) * (size_t)kSplitWarps * kSplitStages * 2 *
                        kSplitKeys * (DH + 8);
    auto kern = chunk_split_bf16_kernel<DH>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kSplitWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), o_part, m_part, l_part, Lq, S, H, KVH, per,
        scale * kLog2e, mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chunk_combine_kernel<__nv_bfloat16, true><<<combine_grid, combine_threads, 0, stream>>>(
        o_part, m_part, l_part, static_cast<__nv_bfloat16*>(out), ns, Lq, H, KVH, DH);
    return (int)cudaGetLastError();
  }
  auto kern = attention_fp32_kernel<DH, RowMask, true>;
  cudaError_t err = allow_smem(kern, fp32_smem<DH>());
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kWarps * 32, fp32_smem<DH>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      nullptr, o_part, m_part, l_part, Lq, S, H, KVH, per, scale, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_combine_kernel<float, false><<<combine_grid, combine_threads, 0, stream>>>(
      o_part, m_part, l_part, static_cast<float*>(out), ns, Lq, H, KVH, DH);
  return (int)cudaGetLastError();
}

// ops/flash_attention.py KERNEL_HEAD_DIMS lists the cases of both switches
template <typename Mask>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, int B, int Lq,
           int S, int H, int KVH, int Dh, float scale, Mask mask, cudaStream_t stream) {
  if (H % KVH != 0 || Lq <= 0 || S <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 16: return launch_dh_typed<16>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    case 32: return launch_dh_typed<32>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    case 64: return launch_dh_typed<64>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    case 80: return launch_dh_typed<80>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    case 128: return launch_dh_typed<128>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_split(int dtype, const void* q, const void* k, const void* v, void* out,
                 float* scratch, int B, int Lq, int S, int H, int KVH, int Dh, int nsplit,
                 float scale, RowMask mask, cudaStream_t stream) {
  if (H % KVH != 0 || Lq <= 0 || S <= 0 || (dtype != 0 && dtype != 1) || scratch == nullptr ||
      Lq * (H / KVH) > kSplitRows)
    return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 16: return launch_split_dh<16>(dtype, q, k, v, out, scratch, B, Lq, S, H, KVH, nsplit, scale, mask, stream);
    case 32: return launch_split_dh<32>(dtype, q, k, v, out, scratch, B, Lq, S, H, KVH, nsplit, scale, mask, stream);
    case 64: return launch_split_dh<64>(dtype, q, k, v, out, scratch, B, Lq, S, H, KVH, nsplit, scale, mask, stream);
    case 80: return launch_split_dh<80>(dtype, q, k, v, out, scratch, B, Lq, S, H, KVH, nsplit, scale, mask, stream);
    case 128: return launch_split_dh<128>(dtype, q, k, v, out, scratch, B, Lq, S, H, KVH, nsplit, scale, mask, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// nsplit <= 1: one block walks all S keys of its rows. nsplit > 1 (needs
// Lq * H / KVH <= 16 and scratch): the keys are split over blocks and combined.
extern "C" int chunk_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* kvalid, void* out, void* scratch, int B,
                                      int Lq, int S, int H, int KVH, int Dh, int nsplit,
                                      float scale, void* stream) {
  RowMask mask{static_cast<const unsigned char*>(kvalid), S};
  if (nsplit > 1)
    return launch_split(dtype, q, k, v, out, static_cast<float*>(scratch), B, Lq, S, H, KVH, Dh,
                        nsplit, scale, mask, static_cast<cudaStream_t>(stream));
  return launch(dtype, q, k, v, out, B, Lq, S, H, KVH, Dh, scale, mask,
                static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* meta, void* out, int B, int L, int H,
                                      int KVH, int Dh, float scale, void* stream) {
  MetaMask mask{static_cast<const int*>(meta), L};
  return launch(dtype, q, k, v, out, B, L, L, H, KVH, Dh, scale, mask,
                static_cast<cudaStream_t>(stream));
}
