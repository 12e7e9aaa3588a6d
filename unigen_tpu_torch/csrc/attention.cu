// Masked GQA softmax attention for Hopper (sm_90a), two entry points.
//
// chunk_attention_launch replaces the TPU kernel
//   unigen_tpu/ops/chunk_attention.py:chunk_attention (body _kernel):
//   every query of batch row b sees exactly the keys with kvalid[b, s] set;
//   logits get an additive bias of 0 or -1e30. An optional per-row causal
//   offset q_start[b] also hides from query j the keys s > q_start[b] + j:
//   JAX's default mask of a cached chunk of several queries (the serving
//   engine's speculative verify step and its shared-prefix suffix), which
//   the JAX package leaves to XLA. A query row's last visible key rides in
//   the row word the omni mask already carries (row_info).
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
// wait until a benchmark shows the t2i step to be device-bound. The
// speculative verify step (q [32, k+1, 12, 128], S = 896, with q_start)
// reads the serving decode step's 29 MB of K and V for k + 1 times its
// products: bound by bytes too (~9 us); its 6 (k + 1) rows a (batch row, kv
// head) exceed the split route's 16, so it runs unsplit on 64 blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
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

// Per-row key mask of the chunk step: bias 0 or -1e30. With q_start, query
// j of row b also sees only the keys s <= q_start[b] + j (JAX's default mask
// of a cached chunk); without it a row's last visible key is INT_MAX, so the
// bias, and every logit, is what the key mask alone gives.
struct RowMask {
  const unsigned char* kvalid;  // [B, S]
  const int* q_start;           // [B] or nullptr
  int S;
  __device__ int row_info(int b, int qpos) const {
    return q_start ? q_start[b] + qpos : INT_MAX;
  }
  __device__ int key_info(int b, int kpos) const { return kvalid[(size_t)b * S + kpos]; }
  __device__ float logit(float s, int, int last, int kpos, int kinfo) const {
    return s + ((kinfo && kpos <= last) ? 0.0f : -1e30f);
  }
};

// The omni mask of query position qpos (word mq) and key position kpos (mk).
__device__ __forceinline__ bool meta_visible(int qpos, int mq, int kpos, int mk) {
  return ((kpos <= qpos) || (mq & 2) || (mk & 4)) && !((mq | mk) & 1) &&
         ((mq >> 3) == (mk >> 3));
}

// Omni mask from the packed bitfield and the positions.
struct MetaMask {
  const int* meta;  // [B, L]
  int L;
  __device__ int row_info(int b, int qpos) const { return meta[(size_t)b * L + qpos]; }
  __device__ int key_info(int b, int kpos) const { return meta[(size_t)b * L + kpos]; }
  __device__ float logit(float s, int qpos, int mq, int kpos, int mk) const {
    return meta_visible(qpos, mq, kpos, mk) ? s : -FLT_MAX;
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
constexpr float kLn2 = 0.6931471805599453f;

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
                      float* __restrict__ lse, int Lq, int S, int H, int KVH, float scale2,
                      Mask mask) {
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
    // m is in base 2; a row with no visible key has m = -FLT_MAX
    if (lse != nullptr && t == 0)
      lse[((size_t)b * H + h) * Lq + qp] =
          m[hf] == -FLT_MAX ? -FLT_MAX : (m[hf] + log2f(l[hf])) * kLn2;
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
  int qpos[2], qinfo[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int f = g + 8 * hf;
    const bool ok = f < rows_total;
    const int fc = ok ? f : 0;
    qpos[hf] = fc / G;
    qinfo[hf] = mask.row_info(b, qpos[hf]);
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
                      float* __restrict__ lse, float* __restrict__ o_part,
                      float* __restrict__ m_part, float* __restrict__ l_part, int Lq, int S,
                      int H, int KVH,
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
      if (lse != nullptr && lane == 0)
        lse[((size_t)b * H + h) * Lq + qp] = m[rr] == -FLT_MAX ? -FLT_MAX : m[rr] + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// backward of flash attention: dQ, dK, dV (flash_attention_backward_launch)
// ---------------------------------------------------------------------------
//
// Replaces the backward that the JAX package leaves to XLA
// (unigen_tpu/ops/flash_attention.py:_flash_bwd, the vjp of the dense
// _xla_reference). With P_ij = exp(s_ij - lse_i) on visible pairs and 0
// elsewhere (s the scaled logits, lse the forward's row log-sum-exp),
// dP_ij = dO_i . v_j and D_i = sum_j P_ij dP_ij (= dO_i . O_i):
//   dV_j = sum_i P_ij dO_i,        dS_ij = P_ij (dP_ij - D_i),
//   dQ_i = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i.
// A row with no visible key (only a pad row has none: a non-pad row sees
// itself) has uniform weights 1/L over all L keys in the forward, and the
// mask blocks its gradient to the logits: it adds dO_i / L to every dV_j of
// its batch row and KV head, and nothing to dQ or dK. That weight cannot
// come from its lse (-FLT_MAX + ln L rounds to -FLT_MAX), so the pad rows
// are summed apart (flash_bwd_pad_kernel) and get P = 0 in the tile loops.
//
// Three kernels, queued in order on one stream by the one entry point:
//  * flash_bwd_pad_kernel: the pad rows' dO summed a (batch row, KV head);
//  * flash_bwd_dq_*_kernel: a block owns (batch row, KV head, 64 rows) and
//    walks the key tiles twice: first for D, summed in fp32 from the same P
//    and dP that dS uses (so each row's dS sums to zero but for rounding)
//    and written out, then for dQ. D from dO . O would read O rounded to
//    bf16, and with dS rounded to bf16 too that cost dQ and dK up to 1.5x
//    the tolerance of their gate at head dims 16-32;
//  * flash_bwd_dkv_*_kernel: a block owns (batch row, KV head, key tile)
//    and walks the query rows of its whole group (the G = H / KVH heads
//    folded into rows as the forward folds them), so GQA's sums over the
//    group stay inside one block. Where that grid is under one wave (bf16;
//    SFT's mmu call [4, 796] has 104 blocks of 4 warps), the caller cuts the
//    walk into row ranges (`splits`), each block writes fp32 sums, and
//    flash_bwd_dkv_combine_kernel adds them in range order.
// No atomics: every sum runs in a fixed order, so two runs give the same
// bits. Each block first lists the tiles that the bits leave some visible
// pair in (tile_list): a key tile wholly past a query tile's last position
// with no bidirectional bit on either side, disjoint segment ranges, or an
// all-pad tile are skipped; the causal halves of the t2i, lm and DPO rows
// are most of the masked pairs.
//
// bfloat16: mma.sync m16n8k16 with fp32 accumulation, fragments by
// ldmatrix, the walked tiles through a two-stage cp.async ring, as in
// attention_bf16_kernel. P enters dV's product rounded to bf16 (as the plain
// version's weights do); dS enters dQ's and dK's as two bf16 parts, hi =
// bf16(dS) and lo = bf16(dS - hi), two products each (split_bf16), so that
// dS keeps ~16 bits. dK/dV: four warps of 16 keys, 32 query rows a tile; a warp
// computes S^T and dP^T for its keys (K and V as A, Q and dO as B), then
// dV += P^T dO and dK += dS^T Q (Q and dO transposed by ldmatrix.trans), its
// 16 x Dh dK and dV in registers. dQ: four warps of 16 rows, 32 keys a
// tile, as the forward, with dQ += dS K (K by ldmatrix.trans). float32: the
// CUDA cores, tiles of 32 rows x 32 keys, P and dS through shared memory.
//
// Bounds on this card. PT2's step ([16,835,12,128], 2 KV heads) does 8 h dh
// operations a visible pair (the four products): ~18 GFLOP on its ~45% of
// visible pairs, 0.02 ms at the bf16 peak, against ~0.04 ms for its bytes;
// tile skipping leaves ~1.3x the visible pairs, and S and dP computed three
// times (D's pass, dQ's, dK/dV's) with dS's two parts make it 11 products
// where the bound counts 4. mma.sync reaches only part of the tensor-core
// rate (no wgmma, TMA or clusters).

// The non-pad positions of a range of one batch row: whether it has one,
// whether one carries bidir_bit (2 for queries, 4 for keys), and the range of
// their segment ids.
struct Span {
  bool any, bidir;
  int seg_lo, seg_hi;
};

__device__ Span span_of(const int* meta_row, int p0, int p1, int bidir_bit) {
  Span s{false, false, INT_MAX, INT_MIN};
#pragma unroll 4
  for (int p = p0; p <= p1; ++p) {
    const int m = meta_row[p];
    if (m & 1) continue;
    s.any = true;
    s.bidir = s.bidir || (m & bidir_bit);
    s.seg_lo = min(s.seg_lo, m >> 3);
    s.seg_hi = max(s.seg_hi, m >> 3);
  }
  return s;
}

// Whether a query span whose last position is q1 may see a key span whose
// first position is k0: a visible pair needs a non-pad query and key of one
// segment, and k <= q unless a bidirectional bit is set.
__device__ __forceinline__ bool spans_meet(const Span& q, int q1, const Span& k, int k0) {
  return q.any && k.any && q.seg_lo <= k.seg_hi && k.seg_lo <= q.seg_hi &&
         (k0 <= q1 || q.bidir || k.bidir);
}

// list[0 .. returned count) = the tiles i < ntiles, in order, for which
// visit(i) holds. list holds ntiles ints of shared memory and count one;
// every thread of the block calls it.
template <typename Visit>
__device__ int tile_list(int ntiles, Visit visit, int* list, int* count) {
  for (int i = threadIdx.x; i < ntiles; i += blockDim.x) list[i] = visit(i) ? 1 : 0;
  __syncthreads();
  if (threadIdx.x < 32) {
    // compacted in place by one warp: a chunk's flags are all read before
    // the ballot, and its writes land below the chunk's end
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int i = base + lane;
      const bool f = i < ntiles && list[i];
      const unsigned m = __ballot_sync(kFull, f);
      if (f) list[n + __popc(m & ((1u << lane) - 1))] = i;
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// The words of one query row: position, mask word, lse (times lse_scale:
// base 2 for the bf16 kernels) and D (0 while dsum is null: the dQ kernel
// sums it). A row past the last is a pad row, never visible.
struct RowWords {
  int pos, info;
  float lse, del;
};

__device__ __forceinline__ RowWords row_words(int f, int rows_total, int G, int b, int kvh,
                                              int H, int L, const int* mrow, const float* lse,
                                              const float* dsum, float lse_scale) {
  RowWords w{0, 1, 0.f, 0.f};
  if (f < rows_total) {
    const int p = f / G;
    const size_t at = ((size_t)b * H + kvh * G + f % G) * L + p;
    w = RowWords{p, mrow[p], lse[at] * lse_scale, dsum ? dsum[at] : 0.f};
  }
  return w;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kPrepWarps = 8;

// pad_dout[b, kvh, d] = (1 / L) x the sum of dout[b, p, h, d] over the pad
// positions p and the G heads h of KV head kvh: what the pad rows add to
// every dV_j. Grid (KVH, B); warp w takes the 32-position chunks w, w + 8,
// ... and finds a chunk's pad positions by one ballot; lane i owns dims i,
// i + 32, ...; the warps' sums are added in warp order.
template <typename T>
__global__ void __launch_bounds__(kPrepWarps * 32)
flash_bwd_pad_kernel(const T* __restrict__ dout, const int* __restrict__ meta,
                     float* __restrict__ pad_dout, int L, int H, int KVH, int DH) {
  __shared__ float part[kPrepWarps][128];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = 32 * warp; base < L; base += 32 * kPrepWarps) {
    const int p = base + lane;
    unsigned pads = __ballot_sync(kFull, p < L && (meta[(size_t)b * L + p] & 1));
    while (pads) {
      const int pp = base + __ffs(pads) - 1;
      pads &= pads - 1;
      const T* row = dout + (((size_t)b * L + pp) * H + kvh * G) * DH;
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = lane + 32 * i;
          if (d < DH) acc[i] += to_float(row[(size_t)j * DH + d]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < DH) part[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  if (threadIdx.x < DH) {
    float s = 0.f;
    for (int w = 0; w < kPrepWarps; ++w) s += part[w][threadIdx.x];
    pad_dout[((size_t)b * KVH + kvh) * DH + threadIdx.x] = s / L;
  }
}

// x0, x1 as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi); a product
// with hi plus one with lo keeps ~16 bits of x where one with bf16(x) keeps 8.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 r = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - r.x, x1 - r.y);
}

constexpr int kBwdWarps = 4;
constexpr int kBwdKeys = 16 * kBwdWarps;   // keys a dK/dV block: 16 a warp
constexpr int kBwdRows = 32;               // query rows a tile of the dK/dV loop
constexpr int kBwdQRows = 16 * kBwdWarps;  // query rows a dQ block: 16 a warp
constexpr int kBwdTileKeys = 32;           // keys a tile of the dQ loop
constexpr int kBwdMinBlocks = 2;           // blocks an SM: up to 255 registers a thread

// With R = gridDim.z / B > 1 the listed row tiles are cut into R ranges of
// about equal count, blockIdx.z = b R + r takes range r, and the block
// writes its unscaled fp32 sums to part[r] ([R][2][B, L, KVH, DH]: dK, then
// dV) for flash_bwd_dkv_combine_kernel; with R = 1 it writes dk and dv.
template <int DH>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ dsum, const int* __restrict__ meta,
                          const float* __restrict__ pad_dout, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int B,
                          int L, int H, int KVH, float scale, float scale2) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = DH + 8, KS = DH / 16, ON = DH / 8, NT = kBwdRows / 8;
  constexpr int kThreads = kBwdWarps * 32;
  constexpr int kStageElems = 2 * kBwdRows * LD;  // a stage: the Q tile, then the dO tile
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [kBwdKeys][LD]
  __nv_bfloat16* vs = ks + kBwdKeys * LD;                          // [kBwdKeys][LD]
  __nv_bfloat16* ring = vs + kBwdKeys * LD;                        // [kStages][2][kBwdRows][LD]
  RowWords* words = reinterpret_cast<RowWords*>(ring + kStages * kStageElems);  // [2][kBwdRows]
  int* count = reinterpret_cast<int*>(words + 2 * kBwdRows);
  int* list = count + 4;  // [ntiles]

  const int G = H / KVH;
  const int R = gridDim.z / B, b = blockIdx.z / R, r = blockIdx.z % R;
  const int kvh = blockIdx.y, k0 = blockIdx.x * kBwdKeys;
  const int rows_total = L * G;
  const int ntiles = (rows_total + kBwdRows - 1) / kBwdRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t kv_stride = (size_t)KVH * DH;
  const int* mrow = meta + (size_t)b * L;
  const __nv_bfloat16* qb = q + (size_t)b * L * H * DH;
  const __nv_bfloat16* ob = dout + (size_t)b * L * H * DH;

  // group 0: this block's K and V rows, in flight while the tiles are listed
  const size_t kv0 = (((size_t)b * L + k0) * KVH + kvh) * DH;
  load_rows_async<DH>(ks, k + kv0, kv_stride, kBwdKeys, L - k0, tid, kThreads);
  load_rows_async<DH>(vs, v + kv0, kv_stride, kBwdKeys, L - k0, tid, kThreads);
  cp_async_commit();

  const Span kspan = span_of(mrow, k0, min(k0 + kBwdKeys, L) - 1, 4);
  const int listed = tile_list(
      ntiles,
      [&](int i) {
        const int p0 = i * kBwdRows / G, p1 = (min((i + 1) * kBwdRows, rows_total) - 1) / G;
        return spans_meet(span_of(mrow, p0, p1, 2), p1, kspan, k0);
      },
      list, count);
  const int first = (int)((long long)r * listed / R);      // this block's range of the list
  const int n = (int)((long long)(r + 1) * listed / R) - first;

  auto fetch = [&](int i) {  // the range's i-th tile's Q and dO rows into stage i % kStages
    __nv_bfloat16* st = ring + (i % kStages) * kStageElems;
    const int f0 = list[first + i] * kBwdRows;
    for (int c = tid; c < kBwdRows * (DH / 8); c += kThreads) {
      const int r = c / (DH / 8), ch = c % (DH / 8), f = f0 + r;
      const bool ok = f < rows_total;
      const int fc = ok ? f : 0;
      const size_t off = ((size_t)(fc / G) * H + kvh * G + fc % G) * DH + ch * 8;
      cp_async16(st + r * LD + ch * 8, qb + off, ok ? 16 : 0);
      cp_async16(st + (kBwdRows + r) * LD + ch * 8, ob + off, ok ? 16 : 0);
    }
  };
  auto words_of = [&](int i) {  // thread j < kBwdRows: row j of the range's i-th tile
    return row_words(list[first + i] * kBwdRows + tid, rows_total, G, b, kvh, H, L, mrow, lse, dsum,
                     kLog2e);
  };
  if (n > 0) fetch(0);
  cp_async_commit();
  if (n > 0 && tid < kBwdRows) words[tid] = words_of(0);

  // the thread's keys k0 + 16 warp + g and + 8: the rows of its accumulators
  int kpos[2], kinfo[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    kpos[hf] = k0 + 16 * warp + g + 8 * hf;
    kinfo[hf] = kpos[hf] < L ? mrow[kpos[hf]] : 1;
  }
  float dk_acc[ON][4], dv_acc[ON][4];
#pragma unroll
  for (int n8 = 0; n8 < ON; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n8][e] = dv_acc[n8][e] = 0.f;
  // ldmatrix lanes: A of the warp's 16 keys (matrix i: keys 8 (i % 2), dims
  // 8 (i / 2)); B from a [row][dim] tile (matrix i: rows 8 (i / 2), dims
  // 8 (i % 2)); B transposed (matrix i: rows 8 (i % 2), dims 8 (i / 2))
  const int arow = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 8 * ((lane >> 3) & 1);
  const int trow = (lane & 7) + 8 * ((lane >> 3) & 1), tcol = 8 * (lane >> 4);

  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();  // K, V and tile i have landed (this thread's copies)
    __syncthreads();     // everyone's have, and tile i - 1 is consumed
    if (i + 1 < n) fetch(i + 1);
    cp_async_commit();
    RowWords next{0, 1, 0.f, 0.f};
    if (i + 1 < n && tid < kBwdRows) next = words_of(i + 1);  // stored after the products
    const __nv_bfloat16* qs = ring + (i % kStages) * kStageElems;
    const __nv_bfloat16* os = qs + kBwdRows * LD;
    const RowWords* w = words + (i & 1) * kBwdRows;

    // S^T = K Q^T and dP^T = V dO^T: [16 keys] x [32 rows] a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ks + arow * LD + 16 * kk + acol);
      ldsm_x4(va, vs + arow * LD + 16 * kk + acol);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, qs + (16 * np + brow) * LD + 16 * kk + bcol);
        ldsm_x4(bo, os + (16 * np + brow) * LD + 16 * kk + bcol);
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * np], va, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], va, bo[2], bo[3]);
      }
    }
    // element e of column tile nt: key g + 8 (e >> 1), row 8 nt + 2 t + (e & 1)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const RowWords row = w[8 * nt + 2 * t + (e & 1)];
        const float p = meta_visible(row.pos, row.info, kpos[hf], kinfo[hf])
                            ? ex2(s[nt][e] * scale2 - row.lse)
                            : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - row.del);
      }
    // dV += P^T dO and dK += dS^T Q (dS as hi + lo) over the tile's rows, 16 a step
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      uint32_t dh[4], dl[4];
      split_bf16(dp[2 * kk][0], dp[2 * kk][1], dh[0], dl[0]);
      split_bf16(dp[2 * kk][2], dp[2 * kk][3], dh[1], dl[1]);
      split_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1], dh[2], dl[2]);
      split_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3], dh[3], dl[3]);
#pragma unroll
      for (int dn = 0; dn < DH / 16; ++dn) {
        uint32_t ot[4], qt[4];
        ldsm_x4_trans(ot, os + (16 * kk + trow) * LD + 16 * dn + tcol);
        mma_bf16(dv_acc[2 * dn], pa, ot[0], ot[1]);
        mma_bf16(dv_acc[2 * dn + 1], pa, ot[2], ot[3]);
        ldsm_x4_trans(qt, qs + (16 * kk + trow) * LD + 16 * dn + tcol);
        mma_bf16(dk_acc[2 * dn], dh, qt[0], qt[1]);
        mma_bf16(dk_acc[2 * dn], dl, qt[0], qt[1]);
        mma_bf16(dk_acc[2 * dn + 1], dh, qt[2], qt[3]);
        mma_bf16(dk_acc[2 * dn + 1], dl, qt[2], qt[3]);
      }
    }
    // slot (i + 1) & 1 was last read in iteration i - 1, before this barrier
    if (tid < kBwdRows) words[((i + 1) & 1) * kBwdRows + tid] = next;
  }
  cp_async_wait<0>();  // with no listed tile, K and V were never waited for

  const float* pad = pad_dout + ((size_t)b * KVH + kvh) * DH;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (kpos[hf] >= L) continue;
    const size_t at = (((size_t)b * L + kpos[hf]) * KVH + kvh) * DH + 2 * t;
    if (R > 1) {
      float* pk = part + (size_t)r * 2 * B * L * KVH * DH + at;
      float* pv = pk + (size_t)B * L * KVH * DH;
#pragma unroll
      for (int n8 = 0; n8 < ON; ++n8) {
        *reinterpret_cast<float2*>(pk + 8 * n8) = make_float2(dk_acc[n8][2 * hf],
                                                             dk_acc[n8][2 * hf + 1]);
        *reinterpret_cast<float2*>(pv + 8 * n8) = make_float2(dv_acc[n8][2 * hf],
                                                             dv_acc[n8][2 * hf + 1]);
      }
      continue;
    }
#pragma unroll
    for (int n8 = 0; n8 < ON; ++n8) {
      const int d = 8 * n8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * n8) = __floats2bfloat162_rn(
          dk_acc[n8][2 * hf] * scale, dk_acc[n8][2 * hf + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * n8) = __floats2bfloat162_rn(
          dv_acc[n8][2 * hf] + pad[d], dv_acc[n8][2 * hf + 1] + pad[d + 1]);
    }
  }
}

// dk = scale x the R ranges' dK sums, dv = their dV sums + the pad rows'
// share, each summed in range order: one thread an element of [B, L, KVH, DH].
__global__ void flash_bwd_dkv_combine_kernel(const float* __restrict__ part,
                                             const float* __restrict__ pad_dout,
                                             __nv_bfloat16* __restrict__ dk,
                                             __nv_bfloat16* __restrict__ dv, int R, int L,
                                             int KVH, int DH, size_t elems, float scale) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  float a = 0.f, c = 0.f;
  for (int r = 0; r < R; ++r) {
    a += part[(size_t)r * 2 * elems + e];
    c += part[((size_t)r * 2 + 1) * elems + e];
  }
  const size_t row = e / DH;  // (b, key, kvh)
  const size_t b = row / ((size_t)L * KVH);
  const int kvh = (int)(row % KVH), d = (int)(e % DH);
  dk[e] = __float2bfloat16_rn(a * scale);
  dv[e] = __float2bfloat16_rn(c + pad_dout[(b * KVH + kvh) * DH + d]);
}

// Walks the listed key tiles twice: pass 1 sums D_i = sum_j P_ij dP_ij for
// the block's rows (written to dsum for the dK/dV kernel), pass 2 adds dQ.
template <int DH>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dsum, const int* __restrict__ meta,
                         __nv_bfloat16* __restrict__ dq, int L, int H, int KVH, float scale,
                         float scale2) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = DH + 8, KS = DH / 16, ON = DH / 8, NT = kBwdTileKeys / 8;
  constexpr int kThreads = kBwdWarps * 32;
  constexpr int kStageElems = 2 * kBwdTileKeys * LD;  // a stage: the K tile, then the V tile
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [kBwdQRows][LD]
  __nv_bfloat16* os = qs + kBwdQRows * LD;                         // [kBwdQRows][LD] dO
  __nv_bfloat16* ring = os + kBwdQRows * LD;                       // [kStages][2][32][LD]
  int* kwords = reinterpret_cast<int*>(ring + kStages * kStageElems);  // [2][kBwdTileKeys]
  int* count = kwords + 2 * kBwdTileKeys;
  int* list = count + 4;  // [ntiles]

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y, row0 = blockIdx.x * kBwdQRows;
  const int rows_total = L * G;
  const int ntiles = (L + kBwdTileKeys - 1) / kBwdTileKeys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t kv_stride = (size_t)KVH * DH;
  const int* mrow = meta + (size_t)b * L;
  const __nv_bfloat16* kbase = k + ((size_t)b * L * KVH + kvh) * DH;
  const __nv_bfloat16* vbase = v + ((size_t)b * L * KVH + kvh) * DH;

  // group 0: the block's Q and dO rows, in flight while the tiles are listed
  for (int c = tid; c < kBwdQRows * (DH / 8); c += kThreads) {
    const int r = c / (DH / 8), ch = c % (DH / 8), f = row0 + r;
    const bool ok = f < rows_total;
    const int fc = ok ? f : 0;
    const size_t off = (((size_t)b * L + fc / G) * H + kvh * G + fc % G) * DH + ch * 8;
    cp_async16(qs + r * LD + ch * 8, q + off, ok ? 16 : 0);
    cp_async16(os + r * LD + ch * 8, dout + off, ok ? 16 : 0);
  }
  cp_async_commit();

  const int p1 = (min(row0 + kBwdQRows, rows_total) - 1) / G;
  const Span qspan = span_of(mrow, row0 / G, p1, 2);
  const int n = tile_list(
      ntiles,
      [&](int j) {
        const int j0 = j * kBwdTileKeys;
        return spans_meet(qspan, p1, span_of(mrow, j0, min(j0 + kBwdTileKeys, L) - 1, 4), j0);
      },
      list, count);
  const int steps = 2 * n;  // step i: pass i / n over the listed tile i % n

  auto fetch = [&](int i) {  // step i's K and V rows into stage i % kStages
    __nv_bfloat16* st = ring + (i % kStages) * kStageElems;
    const int j0 = list[i % n] * kBwdTileKeys;
    load_rows_async<DH>(st, kbase + (size_t)j0 * kv_stride, kv_stride, kBwdTileKeys, L - j0,
                        tid, kThreads);
    load_rows_async<DH>(st + kBwdTileKeys * LD, vbase + (size_t)j0 * kv_stride, kv_stride,
                        kBwdTileKeys, L - j0, tid, kThreads);
  };
  auto key_word = [&](int i) {  // thread j < kBwdTileKeys: key j of step i's tile
    const int kp = list[i % n] * kBwdTileKeys + tid;
    return (tid < kBwdTileKeys && kp < L) ? mrow[kp] : 1;
  };
  if (n > 0) fetch(0);
  cp_async_commit();
  if (n > 0 && tid < kBwdTileKeys) kwords[tid] = key_word(0);

  // This warp's 16 rows: the thread holds rows wr + g and wr + g + 8.
  const int wr = warp * 16;
  const bool active = row0 + wr < rows_total;  // a warp past the last row only loads
  RowWords rw[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    rw[hf] = row_words(row0 + wr + g + 8 * hf, rows_total, G, b, kvh, H, L, mrow, lse, nullptr,
                       kLog2e);
  const int alane = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  const __nv_bfloat16* qrow = qs + (wr + alane) * LD + acol;
  const __nv_bfloat16* orow = os + (wr + alane) * LD + acol;
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 8 * ((lane >> 3) & 1);
  const int trow = (lane & 7) + 8 * ((lane >> 3) & 1), tcol = 8 * (lane >> 4);
  float dq_acc[ON][4], dpart[2] = {0.f, 0.f};
#pragma unroll
  for (int n8 = 0; n8 < ON; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n8][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<0>();  // Q, dO and step i's tile have landed (this thread's copies)
    __syncthreads();     // everyone's have, and step i - 1's tile is consumed
    if (i + 1 < steps) fetch(i + 1);
    cp_async_commit();
    const int next = i + 1 < steps ? key_word(i + 1) : 1;  // stored after the products
    if (i == n) {  // pass 1 is done: D of the thread's two rows is its quad's sum
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float d = dpart[hf];
        d += __shfl_xor_sync(kFull, d, 1);
        d += __shfl_xor_sync(kFull, d, 2);
        rw[hf].del = d;
        const int f = row0 + wr + g + 8 * hf;
        if (t == 0 && f < rows_total)
          dsum[((size_t)b * H + kvh * G + f % G) * L + f / G] = d;
      }
    }
    if (active) {
      const __nv_bfloat16* kt = ring + (i % kStages) * kStageElems;
      const __nv_bfloat16* vt = kt + kBwdTileKeys * LD;
      const int* kw = kwords + (i & 1) * kBwdTileKeys;
      const int j0 = list[i % n] * kBwdTileKeys;
      // S = Q K^T and dP = dO V^T: [16 rows] x [32 keys] a warp
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], oa[4];
        ldsm_x4(qa, qrow + 16 * kk);
        ldsm_x4(oa, orow + 16 * kk);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, kt + (16 * np + brow) * LD + 16 * kk + bcol);
          ldsm_x4(vb, vt + (16 * np + brow) * LD + 16 * kk + bcol);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
        }
      }
      // element e of column tile nt: row g + 8 (e >> 1), key j0 + 8 nt + 2 t + (e & 1)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, j = 8 * nt + 2 * t + (e & 1);
          const float p = meta_visible(rw[hf].pos, rw[hf].info, j0 + j, kw[j])
                              ? ex2(s[nt][e] * scale2 - rw[hf].lse)
                              : 0.f;
          if (i < n) dpart[hf] += p * dp[nt][e];
          dp[nt][e] = p * (dp[nt][e] - rw[hf].del);
        }
      // pass 2: dQ += dS K (dS as hi + lo) over the tile's keys, 16 a step
      if (i >= n) {
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          uint32_t dh[4], dl[4];
          split_bf16(dp[2 * kk][0], dp[2 * kk][1], dh[0], dl[0]);
          split_bf16(dp[2 * kk][2], dp[2 * kk][3], dh[1], dl[1]);
          split_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1], dh[2], dl[2]);
          split_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3], dh[3], dl[3]);
#pragma unroll
          for (int dn = 0; dn < DH / 16; ++dn) {
            uint32_t kb[4];
            ldsm_x4_trans(kb, kt + (16 * kk + trow) * LD + 16 * dn + tcol);
            mma_bf16(dq_acc[2 * dn], dh, kb[0], kb[1]);
            mma_bf16(dq_acc[2 * dn], dl, kb[0], kb[1]);
            mma_bf16(dq_acc[2 * dn + 1], dh, kb[2], kb[3]);
            mma_bf16(dq_acc[2 * dn + 1], dl, kb[2], kb[3]);
          }
        }
      }
    }
    // slot (i + 1) & 1 was last read in step i - 1, before this barrier
    if (tid < kBwdTileKeys) kwords[((i + 1) & 1) * kBwdTileKeys + tid] = next;
  }
  cp_async_wait<0>();  // with no listed tile, Q and dO were never waited for
  if (n == 0) {        // no visible key in any row: D = 0
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int f = row0 + wr + g + 8 * hf;
      if (t == 0 && f < rows_total) dsum[((size_t)b * H + kvh * G + f % G) * L + f / G] = 0.f;
    }
  }

  if (!active) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int f = row0 + wr + g + 8 * hf;
    if (f >= rows_total) continue;
    __nv_bfloat16* dst =
        dq + (((size_t)b * L + f / G) * H + kvh * G + f % G) * DH + 2 * t;
#pragma unroll
    for (int n8 = 0; n8 < ON; ++n8)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n8) = __floats2bfloat162_rn(
          dq_acc[n8][2 * hf] * scale, dq_acc[n8][2 * hf + 1] * scale);
  }
}

// float32: tiles of 32 rows x 32 keys on the CUDA cores.
constexpr int kF32Threads = 256;
constexpr int kF32Tile = 32;

// P and dS of a tile of kF32Tile rows (qs, os [row][DH + 1], words rw) by
// kF32Tile keys from j0 (ks, vs [key][DH + 1], mask words kw) into ps and
// dss [row][kF32Tile + 1]; lanes run over the keys.
template <int DH>
__device__ __forceinline__ void f32_pair_tile(const float* qs, const float* os, const float* ks,
                                              const float* vs, const RowWords* rw, int j0,
                                              const int* kw, float scale, float* ps,
                                              float* dss) {
  constexpr int LF = DH + 1, PL = kF32Tile + 1;
  for (int i = threadIdx.x; i < kF32Tile * kF32Tile; i += kF32Threads) {
    const int r = i / kF32Tile, j = i % kF32Tile;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      s += qs[r * LF + d] * ks[j * LF + d];
      dp += os[r * LF + d] * vs[j * LF + d];
    }
    const RowWords w = rw[r];
    const float p = meta_visible(w.pos, w.info, j0 + j, kw[j]) ? expf(s * scale - w.lse) : 0.f;
    ps[r * PL + j] = p;
    dss[r * PL + j] = p * (dp - w.del);
  }
}

// kF32Tile query rows from flattened row f0 (zeros past the last) into
// qs and os [row][DH + 1], and their words into rw (D 0 while dsum is null).
template <int DH>
__device__ __forceinline__ void f32_rows(const float* q, const float* dout, const float* lse,
                                         const float* dsum, const int* mrow, int f0,
                                         int rows_total, int G, int b, int kvh, int H, int L,
                                         float* qs, float* os, RowWords* rw) {
  constexpr int LF = DH + 1;
  for (int c = threadIdx.x; c < kF32Tile * DH; c += kF32Threads) {
    const int r = c / DH, d = c % DH, f = f0 + r;
    const bool ok = f < rows_total;
    const size_t off = ok ? (((size_t)b * L + f / G) * H + kvh * G + f % G) * DH + d : 0;
    qs[r * LF + d] = ok ? q[off] : 0.f;
    os[r * LF + d] = ok ? dout[off] : 0.f;
  }
  if (threadIdx.x < kF32Tile)
    rw[threadIdx.x] = row_words(f0 + threadIdx.x, rows_total, G, b, kvh, H, L, mrow, lse, dsum,
                                1.f);
}

// kF32Tile keys from j0 (zeros past L) into ks and vs [key][DH + 1], their
// mask words into kw.
template <int DH>
__device__ __forceinline__ void f32_keys(const float* k, const float* v, const int* mrow, int j0,
                                         int b, int kvh, int KVH, int L, float* ks, float* vs,
                                         int* kw) {
  constexpr int LF = DH + 1;
  for (int c = threadIdx.x; c < kF32Tile * DH; c += kF32Threads) {
    const int j = c / DH, d = c % DH, kp = j0 + j;
    const bool ok = kp < L;
    const size_t off = ok ? (((size_t)b * L + kp) * KVH + kvh) * DH + d : 0;
    ks[j * LF + d] = ok ? k[off] : 0.f;
    vs[j * LF + d] = ok ? v[off] : 0.f;
  }
  const int j = threadIdx.x;
  if (j < kF32Tile) kw[j] = j0 + j < L ? mrow[j0 + j] : 1;
}

template <int DH>
constexpr size_t f32_bwd_smem() {
  return sizeof(float) * (4 * kF32Tile * (DH + 1) + 2 * kF32Tile * (kF32Tile + 1)) +
         sizeof(RowWords) * kF32Tile + sizeof(int) * (kF32Tile + 4);
}

// SLOT: 0 = dK/dV (a block owns kF32Tile keys and walks the row tiles), 1 =
// dQ (a block owns kF32Tile rows and walks the key tiles twice: D, written
// to dsum, then dQ). Thread i owns the outputs i, i + 256, ... of the
// block's [kF32Tile][DH].
template <int DH, int SLOT>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dsum,
                      const int* __restrict__ meta, const float* __restrict__ pad_dout,
                      float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                      int L, int H, int KVH, float scale) {
  constexpr int LF = DH + 1, PL = kF32Tile + 1, NE = kF32Tile * DH / kF32Threads;
  static_assert(NE * kF32Threads == kF32Tile * DH, "a whole number of outputs a thread");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kF32Tile][LF]
  float* vs = ks + kF32Tile * LF;
  float* qs = vs + kF32Tile * LF;
  float* os = qs + kF32Tile * LF;
  float* ps = os + kF32Tile * LF;               // [kF32Tile][PL]
  float* dss = ps + kF32Tile * PL;
  RowWords* rw = reinterpret_cast<RowWords*>(dss + kF32Tile * PL);  // [kF32Tile]
  int* kw = reinterpret_cast<int*>(rw + kF32Tile);                  // [kF32Tile]
  int* count = kw + kF32Tile;
  int* list = count + 4;

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y, own0 = blockIdx.x * kF32Tile;
  const int rows_total = L * G;
  const int* mrow = meta + (size_t)b * L;
  float acc[NE][2];
#pragma unroll
  for (int u = 0; u < NE; ++u) acc[u][0] = acc[u][1] = 0.f;

  if (SLOT == 0) {
    f32_keys<DH>(k, v, mrow, own0, b, kvh, KVH, L, ks, vs, kw);
    const Span kspan = span_of(mrow, own0, min(own0 + kF32Tile, L) - 1, 4);
    const int n = tile_list(
        (rows_total + kF32Tile - 1) / kF32Tile,
        [&](int i) {
          const int p0 = i * kF32Tile / G, p1 = (min((i + 1) * kF32Tile, rows_total) - 1) / G;
          return spans_meet(span_of(mrow, p0, p1, 2), p1, kspan, own0);
        },
        list, count);
    for (int i = 0; i < n; ++i) {
      f32_rows<DH>(q, dout, lse, dsum, mrow, list[i] * kF32Tile, rows_total, G, b, kvh, H, L,
                   qs, os, rw);
      __syncthreads();
      f32_pair_tile<DH>(qs, os, ks, vs, rw, own0, kw, scale, ps, dss);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < NE; ++u) {
        const int e = threadIdx.x + kF32Threads * u, j = e / DH, d = e % DH;
        float a = 0.f, c = 0.f;
        for (int r = 0; r < kF32Tile; ++r) {
          a += dss[r * PL + j] * qs[r * LF + d];
          c += ps[r * PL + j] * os[r * LF + d];
        }
        acc[u][0] += a;  // dK
        acc[u][1] += c;  // dV
      }
      __syncthreads();
    }
    const float* pad = pad_dout + ((size_t)b * KVH + kvh) * DH;
#pragma unroll
    for (int u = 0; u < NE; ++u) {
      const int e = threadIdx.x + kF32Threads * u, j = e / DH, d = e % DH, kp = own0 + j;
      if (kp >= L) continue;
      const size_t off = (((size_t)b * L + kp) * KVH + kvh) * DH + d;
      dk[off] = acc[u][0] * scale;
      dv[off] = acc[u][1] + pad[d];
    }
  } else {
    f32_rows<DH>(q, dout, lse, nullptr, mrow, own0, rows_total, G, b, kvh, H, L, qs, os, rw);
    const int p1 = (min(own0 + kF32Tile, rows_total) - 1) / G;
    const Span qspan = span_of(mrow, own0 / G, p1, 2);
    const int n = tile_list(
        (L + kF32Tile - 1) / kF32Tile,
        [&](int j) {
          const int j0 = j * kF32Tile;
          return spans_meet(qspan, p1, span_of(mrow, j0, min(j0 + kF32Tile, L) - 1, 4), j0);
        },
        list, count);
    float d_row = 0.f;  // thread r < kF32Tile: D of row own0 + r, summed in pass 0
    for (int pass = 0; pass < 2; ++pass) {
      for (int i = 0; i < n; ++i) {
        const int j0 = list[i] * kF32Tile;
        f32_keys<DH>(k, v, mrow, j0, b, kvh, KVH, L, ks, vs, kw);
        __syncthreads();
        f32_pair_tile<DH>(qs, os, ks, vs, rw, j0, kw, scale, ps, dss);  // pass 0: dss = P dP
        __syncthreads();
        if (pass == 0) {
          if (threadIdx.x < kF32Tile)
            for (int j = 0; j < kF32Tile; ++j) d_row += dss[threadIdx.x * PL + j];
        } else {
#pragma unroll
          for (int u = 0; u < NE; ++u) {
            const int e = threadIdx.x + kF32Threads * u, r = e / DH, d = e % DH;
            float a = 0.f;
            for (int j = 0; j < kF32Tile; ++j) a += dss[r * PL + j] * ks[j * LF + d];
            acc[u][0] += a;
          }
        }
        __syncthreads();
      }
      if (pass == 0 && threadIdx.x < kF32Tile) {
        const int f = own0 + threadIdx.x;
        rw[threadIdx.x].del = d_row;
        if (f < rows_total) dsum[((size_t)b * H + kvh * G + f % G) * L + f / G] = d_row;
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < NE; ++u) {
      const int e = threadIdx.x + kF32Threads * u, r = e / DH, d = e % DH, f = own0 + r;
      if (f >= rows_total) continue;
      dq[(((size_t)b * L + f / G) * H + kvh * G + f % G) * DH + d] = acc[u][0] * scale;
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
int launch_dh_typed(int dtype, const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int Lq, int S, int H, int KVH, float scale, Mask mask,
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
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Lq, S, H,
        KVH, scale * kLog2e, mask);
    return (int)cudaGetLastError();
  }
  auto kern = attention_fp32_kernel<DH, Mask, false>;
  cudaError_t err = allow_smem(kern, fp32_smem<DH>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq * G + kRows - 1) / kRows, KVH, B);
  kern<<<grid, kWarps * 32, fp32_smem<DH>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, nullptr, nullptr, nullptr, Lq, S, H, KVH, 0, scale, mask);
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
      nullptr, nullptr, o_part, m_part, l_part, Lq, S, H, KVH, per, scale, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_combine_kernel<float, false><<<combine_grid, combine_threads, 0, stream>>>(
      o_part, m_part, l_part, static_cast<float*>(out), ns, Lq, H, KVH, DH);
  return (int)cudaGetLastError();
}

// ops/flash_attention.py KERNEL_HEAD_DIMS lists the cases of both switches
template <typename Mask>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Lq, int S, int H, int KVH, int Dh, float scale, Mask mask,
           cudaStream_t stream) {
  if (H % KVH != 0 || Lq <= 0 || S <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 16: return launch_dh_typed<16>(dtype, q, k, v, out, lse, B, Lq, S, H, KVH, scale, mask, stream);
    case 32: return launch_dh_typed<32>(dtype, q, k, v, out, lse, B, Lq, S, H, KVH, scale, mask, stream);
    case 64: return launch_dh_typed<64>(dtype, q, k, v, out, lse, B, Lq, S, H, KVH, scale, mask, stream);
    case 80: return launch_dh_typed<80>(dtype, q, k, v, out, lse, B, Lq, S, H, KVH, scale, mask, stream);
    case 128: return launch_dh_typed<128>(dtype, q, k, v, out, lse, B, Lq, S, H, KVH, scale, mask, stream);
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

// The backward's launches on `stream`: the pad rows' sums, dQ (which writes
// D), then dK/dV (which reads it), with `splits` (bf16 only) > 1 the dK/dV
// walk cut into that many row ranges and their sums combined. scratch holds
// 2 x splits x B * L * KVH * DH floats of those sums when splits > 1, then B
// * H * L of D, then B * KVH * DH of the pad rows' dO sums.
template <int DH>
int launch_bwd_dh(int dtype, const void* q, const void* k, const void* v, const int* meta,
                  const void* dout, const float* lse, float* scratch, void* dq, void* dk,
                  void* dv, int B, int L, int H, int KVH, int splits, float scale,
                  cudaStream_t stream) {
  const int G = H / KVH;
  const size_t kv_elems = (size_t)B * L * KVH * DH;
  float* part = scratch;
  float* dsum = scratch + (splits > 1 ? 2 * splits * kv_elems : 0);
  float* pad = dsum + (size_t)B * H * L;
  const dim3 pad_grid(KVH, B);
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (misaligned16(q, k, v, dout) || misaligned16(dq, dk, dv, dq))
      return (int)cudaErrorMisalignedAddress;
    flash_bwd_pad_kernel<T><<<pad_grid, kPrepWarps * 32, 0, stream>>>(
        static_cast<const T*>(dout), meta, pad, L, H, KVH, DH);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t key_tiles = (L + kBwdTileKeys - 1) / kBwdTileKeys;
    const size_t q_smem = sizeof(T) * (2 * kBwdQRows + kStages * 2 * kBwdTileKeys) * (DH + 8) +
                          sizeof(int) * (2 * kBwdTileKeys + 4 + key_tiles);
    auto qk = flash_bwd_dq_bf16_kernel<DH>;
    if ((err = allow_smem(qk, q_smem)) != cudaSuccess) return (int)err;
    qk<<<dim3((L * G + kBwdQRows - 1) / kBwdQRows, KVH, B), kBwdWarps * 32, q_smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, dsum, meta, static_cast<T*>(dq), L, H, KVH, scale,
        scale * kLog2e);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t row_tiles = (L * G + kBwdRows - 1) / kBwdRows;
    const size_t kv_smem = sizeof(T) * (2 * kBwdKeys + kStages * 2 * kBwdRows) * (DH + 8) +
                           sizeof(RowWords) * 2 * kBwdRows + sizeof(int) * (4 + row_tiles);
    auto kv = flash_bwd_dkv_bf16_kernel<DH>;
    if ((err = allow_smem(kv, kv_smem)) != cudaSuccess) return (int)err;
    kv<<<dim3((L + kBwdKeys - 1) / kBwdKeys, KVH, B * splits), kBwdWarps * 32, kv_smem,
         stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, dsum, meta, pad, static_cast<T*>(dk),
        static_cast<T*>(dv), part, B, L, H, KVH, scale, scale * kLog2e);
    if (splits == 1) return (int)cudaGetLastError();
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    flash_bwd_dkv_combine_kernel<<<(unsigned)((kv_elems + 255) / 256), 256, 0, stream>>>(
        part, pad, static_cast<T*>(dk), static_cast<T*>(dv), splits, L, KVH, DH, kv_elems, scale);
    return (int)cudaGetLastError();
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  using T = float;
  flash_bwd_pad_kernel<T><<<pad_grid, kPrepWarps * 32, 0, stream>>>(
      static_cast<const T*>(dout), meta, pad, L, H, KVH, DH);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int row_tiles = (L * G + kF32Tile - 1) / kF32Tile, key_tiles = (L + kF32Tile - 1) / kF32Tile;
  const size_t kv_smem = f32_bwd_smem<DH>() + sizeof(int) * row_tiles;
  const size_t q_smem = f32_bwd_smem<DH>() + sizeof(int) * key_tiles;
  auto kv = flash_bwd_fp32_kernel<DH, 0>;
  auto qk = flash_bwd_fp32_kernel<DH, 1>;
  if ((err = allow_smem(kv, kv_smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(qk, q_smem)) != cudaSuccess) return (int)err;
  qk<<<dim3(row_tiles, KVH, B), kF32Threads, q_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dsum, meta, pad, static_cast<T*>(dq), nullptr, nullptr,
      L, H, KVH, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kv<<<dim3(key_tiles, KVH, B), kF32Threads, kv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dsum, meta, pad, nullptr, static_cast<T*>(dk),
      static_cast<T*>(dv), L, H, KVH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// nsplit <= 1: one block walks all S keys of its rows. nsplit > 1 (needs
// Lq * H / KVH <= 16 and scratch): the keys are split over blocks and combined.
// q_start (nullable, [B] int32): query j of row b sees keys s <= q_start[b] + j only.
extern "C" int chunk_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* kvalid, const void* q_start, void* out,
                                      void* scratch, int B, int Lq, int S, int H, int KVH,
                                      int Dh, int nsplit, float scale, void* stream) {
  RowMask mask{static_cast<const unsigned char*>(kvalid), static_cast<const int*>(q_start), S};
  if (nsplit > 1)
    return launch_split(dtype, q, k, v, out, static_cast<float*>(scratch), B, Lq, S, H, KVH, Dh,
                        nsplit, scale, mask, static_cast<cudaStream_t>(stream));
  return launch(dtype, q, k, v, out, nullptr, B, Lq, S, H, KVH, Dh, scale, mask,
                static_cast<cudaStream_t>(stream));
}

// lse (nullable, [B, H, L] float32): each row's natural-base log-sum-exp of its
// scaled, masked logits, -FLT_MAX for a row with no visible key (a pad row).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* meta, void* out, void* lse, int B, int L,
                                      int H, int KVH, int Dh, float scale, void* stream) {
  MetaMask mask{static_cast<const int*>(meta), L};
  return launch(dtype, q, k, v, out, static_cast<float*>(lse), B, L, L, H, KVH, Dh, scale, mask,
                static_cast<cudaStream_t>(stream));
}

// dq, dk and dv of flash_attention_launch's attention for the gradient dout
// of its output: lse as that launch wrote it (not null), q [B, L, H, Dh], k
// and v [B, L, KVH, Dh], one dtype for all; dq like q, dk and dv like k.
// splits: row ranges of the dK/dV walk (bf16; 1 for float32). scratch holds
// B * H * L + B * KVH * Dh floats, and 2 * splits * B * L * KVH * Dh more
// when splits > 1. Dh as the forward's.
extern "C" int flash_attention_backward_launch(int dtype, const void* q, const void* k,
                                               const void* v, const void* meta, const void* dout,
                                               const void* lse, void* scratch, void* dq,
                                               void* dk, void* dv, int B, int L, int H, int KVH,
                                               int Dh, int splits, float scale, void* stream) {
  if (H % KVH != 0 || B <= 0 || L <= 0 || (dtype != 0 && dtype != 1) || lse == nullptr ||
      scratch == nullptr || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(meta);
  const float* ls = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return launch_bwd_dh<16>(dtype, q, k, v, m, dout, ls, sc, dq, dk, dv, B, L, H, KVH, splits, scale, st);
    case 32: return launch_bwd_dh<32>(dtype, q, k, v, m, dout, ls, sc, dq, dk, dv, B, L, H, KVH, splits, scale, st);
    case 64: return launch_bwd_dh<64>(dtype, q, k, v, m, dout, ls, sc, dq, dk, dv, B, L, H, KVH, splits, scale, st);
    case 80: return launch_bwd_dh<80>(dtype, q, k, v, m, dout, ls, sc, dq, dk, dv, B, L, H, KVH, splits, scale, st);
    case 128: return launch_bwd_dh<128>(dtype, q, k, v, m, dout, ls, sc, dq, dk, dv, B, L, H, KVH, splits, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
