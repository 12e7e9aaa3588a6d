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
// Design. A block owns one (batch row, kv head) and 64 rows of the flattened
// (query position, head-in-group) index, so the G = H / KVH query heads that
// share a K/V head fold into the rows, as the TPU kernel folds them into M.
// Keys stream through shared memory tile by tile with an online softmax
// (running max and sum per row, fp32); logits never leave the SM.
//  * bfloat16 (the model's path): four warps of 16 query rows each run
//    Q.K^T and P.V as mma.sync m16n8k16 bf16 products with fp32
//    accumulation. Q stays in registers as A fragments for the whole key
//    loop; a tile of 64 keys and their values sits in shared memory; the
//    probabilities go from the Q.K^T accumulators straight into the A
//    fragments of P.V (rounded to bf16, as the TPU kernel casts P), and V's
//    B fragments come from ldmatrix.trans.
//  * float32 (tests and the tiny model): the same tiling on the fp32 CUDA
//    cores, 8 warps of 8 rows, 32 keys per tile, so fp32 inputs keep full
//    fp32 products.
//
// Bound on this card: at the t2i chunk shape (q [8,258,12,128], S = 406) the
// work is ~5 GFLOP against ~16 MB moved: compute-bound on the bf16 tensor
// cores (~5 us). mma.sync reaches only part of the wgmma rate, and the tiles
// are loaded synchronously (no cp.async/TMA pipeline), so the kernel stays
// above that bound; wgmma with a TMA ring is the next step.
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
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaKeys = 64;              // keys per tile

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
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

// Four transposed 8x8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

template <int DH, typename Mask>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int Lq, int S, int H, int KVH, float scale, Mask mask) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = DH + 8;    // bf16 row stride in shared memory (16-byte pad)
  constexpr int CH = DH / 8;    // 16-byte chunks per row
  constexpr int KS = DH / 16;   // k-steps of Q.K^T
  constexpr int NT = kMmaKeys / 8;  // 8-key column tiles of the logits
  constexpr int ON = DH / 8;        // 8-wide column tiles of the output
  constexpr int kThreads = kMmaWarps * 32;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [kMmaRows][LD]
  __nv_bfloat16* ks = qs + kMmaRows * LD;                          // [kMmaKeys][LD]
  __nv_bfloat16* vs = ks + kMmaKeys * LD;                          // [kMmaKeys][LD]
  int* kinfo = reinterpret_cast<int*>(vs + kMmaKeys * LD);         // [kMmaKeys]

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int rows_total = Lq * G;
  const int row0 = blockIdx.x * kMmaRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and thread-in-group

  for (int i = tid; i < kMmaRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const int f = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (f < rows_total) {
      const int qp = f / G, h = kvh * G + f % G;
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * Lq + qp) * H + h) * DH + c * 8);
    }
    *reinterpret_cast<uint4*>(qs + r * LD + c * 8) = val;
  }
  __syncthreads();

  // This warp's 16 rows: the thread holds rows wr + g and wr + g + 8.
  const int wr = warp * 16;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* q0 = qs + (wr + g) * LD + kk * 16 + 2 * t;
    const __nv_bfloat16* q1 = q0 + 8 * LD;
    qa[kk][0] = lds32(q0);
    qa[kk][1] = lds32(q1);
    qa[kk][2] = lds32(q0 + 8);
    qa[kk][3] = lds32(q1 + 8);
  }
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

  for (int k0 = 0; k0 < S; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kMmaKeys * CH; i += kThreads) {
      const int j = i / CH, c = i % CH;
      const int kp = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kp < S) {
        const size_t off = (((size_t)b * S + kp) * KVH + kvh) * DH + c * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + j * LD + c * 8) = kv;
      *reinterpret_cast<uint4*>(vs + j * LD + c * 8) = vv;
    }
    if (tid < kMmaKeys) kinfo[tid] = k0 + tid < S ? mask.key_info(b, k0 + tid) : 0;
    __syncthreads();

    // logits: s[n] holds rows (g, g + 8) x keys (8n + 2t, 8n + 2t + 1)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kr = ks + (8 * n + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], qa[kk], lds32(kr), lds32(kr + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, j = 8 * n + 2 * t + (e & 1), kp = k0 + j;
        const float x = kp < S ? mask.logit(s[n][e] * scale, qpos[hf], qinfo[hf], kp, kinfo[j])
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
      corr[hf] = expf(m[hf] - m_new);              // 0 on the first tile (m = -inf)
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
        const float p = expf(s[n][e] - m[e >> 1]);  // 0 for keys past S
        s[n][e] = p;
        l[e >> 1] += p;
      }

    // P.V over 16 keys per step; V's B fragments via ldmatrix.trans: matrix
    // i of lane (i = lane / 8) holds keys 8 * (i % 2) .. and dims 8 * (i / 2) ..
    const int vrow = (lane & 7) + 8 * ((lane >> 3) & 1), vcol = 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
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
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                      // keys per tile: one per lane

template <int DH, typename Mask>
__global__ void __launch_bounds__(kWarps * 32)
attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int Lq, int S, int H, int KVH, float scale, Mask mask) {
  constexpr int QS = DH + 4;             // padded fp32 row stride of q and k tiles
  constexpr int NO = (DH + 31) / 32;     // output dims per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][QS]
  float* ks = qs + kRows * QS;                   // [kKeys][QS]
  float* vs = ks + kKeys * QS;                   // [kKeys][DH]

  const int G = H / KVH;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int rows_total = Lq * G;
  const int row0 = blockIdx.x * kRows;
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

  for (int k0 = 0; k0 < S; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and the q tile written)
    for (int i = tid; i < kKeys * DH; i += blockDim.x) {
      const int j = i / DH, d = i % DH;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < S) {
        const size_t off = (((size_t)b * S + kp) * KVH + kvh) * DH + d;
        kv = k[off];
        vv = v[off];
      }
      ks[j * QS + d] = kv;
      vs[j * DH + d] = vv;
    }
    __syncthreads();

    const int kp = k0 + lane;
    const bool in_range = kp < S;
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
      const float p = expf(x - m_new);          // 0 for keys past S
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
    if (f < rows_total) {
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

template <int DH, typename Mask>
int launch_dh_typed(int dtype, const void* q, const void* k, const void* v, void* out, int B,
                    int Lq, int S, int H, int KVH, float scale, Mask mask,
                    cudaStream_t stream) {
  const int G = H / KVH;
  if (dtype == 1) {
    // 16-byte vector loads of q, k, v rows
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
      return (int)cudaErrorMisalignedAddress;
    constexpr int LD = DH + 8;
    const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kMmaRows + 2 * kMmaKeys) * LD +
                        sizeof(int) * kMmaKeys;
    auto kern = attention_bf16_kernel<DH, Mask>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Lq * G + kMmaRows - 1) / kMmaRows, KVH, B);
    kern<<<grid, kMmaWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Lq, S, H, KVH,
        scale, mask);
    return (int)cudaGetLastError();
  }
  constexpr int QS = DH + 4;
  const size_t smem = sizeof(float) * ((size_t)(kRows + kKeys) * QS + (size_t)kKeys * DH);
  auto kern = attention_fp32_kernel<DH, Mask>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq * G + kRows - 1) / kRows, KVH, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Lq, S, H, KVH, scale, mask);
  return (int)cudaGetLastError();
}

template <typename Mask>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, int B, int Lq,
           int S, int H, int KVH, int Dh, float scale, Mask mask, cudaStream_t stream) {
  if (H % KVH != 0 || Lq <= 0 || S <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // ops/flash_attention.py KERNEL_HEAD_DIMS lists these cases
  switch (Dh) {
    case 16: return launch_dh_typed<16>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    case 32: return launch_dh_typed<32>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    case 64: return launch_dh_typed<64>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    case 80: return launch_dh_typed<80>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    case 128: return launch_dh_typed<128>(dtype, q, k, v, out, B, Lq, S, H, KVH, scale, mask, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int chunk_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* kvalid, void* out, int B, int Lq, int S,
                                      int H, int KVH, int Dh, float scale, void* stream) {
  RowMask mask{static_cast<const unsigned char*>(kvalid), S};
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
