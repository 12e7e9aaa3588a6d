// Fused GroupNorm-affine + swish + 3x3 SAME convolution for Hopper (sm_90a),
// and the GroupNorm statistics that feed it.
//
// conv3x3_gn_swish_launch replaces the TPU kernel
// unigen_tpu/ops/fused_conv.py:conv3x3_gn_swish (body _kernel, called from
// _fused_forward):
//   out = conv3x3(swish(x * A[b, c] + B[b, c])) + bias      (NHWC, HWIO)
// Without the affine (ab == nullptr) it is a plain conv3x3 (the upsample conv).
// The affine and swish run in fp32 and are rounded to x's type once before the
// convolution, as the TPU kernel casts them; the SAME padding is zero AFTER
// the activation; the convolution accumulates in fp32 and adds the bias once.
// gn_affine_launch replaces the XLA pre-pass beside it
// (unigen_tpu/ops/fused_conv.py:_gn_affine): GroupNorm over groups of C / G
// channels, population variance, folded with the GN scale and bias into
//   A = scale * rsqrt(var + eps),  B = bias - mean * scale * rsqrt(var + eps)
// as ab [B, 2, C] fp32.
//
// Bound on this card. The hot decoder shape [4, 256, 256, 128] -> 128 is
// 77 GFLOP against ~134 MB: compute-bound (~78 us on the bf16 tensor cores).
// The statistics read x once (67 MB, ~20 us at 3.35 TB/s): memory-bound.
//
// Design.
// * Statistics: two kernels from one C call. The partial pass gives each block
//   a range of pixels of one image; a thread owns 8 channels and walks its
//   pixels with Welford updates (count, mean, M2) in fp32, its 16-byte loads
//   eight pixels ahead. The block merges its threads' channel states with Chan's
//   formula, then the channels of each group, in a fixed order, and writes
//   one (count, mean, M2) per (image, range, group). The finish pass merges
//   the ranges (a warp a group, lanes over ranges, then a fixed shuffle tree)
//   and folds the affine. Sums of squares minus a squared
//   mean are never formed: at 262,144 values a group with a large mean
//   against its spread would cancel.
// * Convolution. A block owns an 8 x 16 pixel tile of one image and 128
//   output channels (bf16; 64 in fp32). Input channels stream through shared
//   memory 16 at a time (8 in fp32); the 3x3 convolution is an implicit GEMM
//   (M = pixels, N = output channels, K = 9 taps x channels) over shifted
//   windows of the tile plus its one-pixel halo. The activated input is
//   never written to device memory.
//  * bfloat16 (the decoder's path): 8 warps; each owns 2 image rows (2 x 16
//    pixels) x 64 channels and runs mma.sync m16n8k16 bf16 products with
//    fp32 accumulators. A fragments are read from the activated halo tile,
//    B fragments from the HWIO weights through ldmatrix.trans. Operands
//    arrive by 16-byte cp.async.cg copies (out-of-image pixels and channels
//    past C zero-filled by a source size of 0) into rings in dynamic shared
//    memory: the [9][16][128] weight slice of a chunk double-buffered (2 x
//    39 KB), the raw [10][18][16] halo tile and its 16 (A, B) pairs
//    triple-buffered (3 x 8.6 KB), 102 KB in all, so two blocks share an SM.
//    In the step of chunk i the block starts the copies of chunk i + 1's
//    weights and chunk i + 2's halo, applies affine + swish in place, once
//    per staged element, to chunk i + 1's halo (three runs of 4 channels a
//    thread, their indices computed once), then runs chunk i's products; the
//    copies are in flight over both, and there is one __syncthreads a chunk.
//    Out-of-image pixels stay as staged (zero) and channels past C are
//    written 0: the padding is zero after the activation, and
//    swish(0 * A + B) != 0. Where C % 8 != 0, Cout % 8 != 0 or a pointer is
//    not 16-byte aligned, the same body stages operands with plain loads.
//    The epilogue adds the bias in fp32 and stores bf16 pairs.
//  * float32 (tests and the tiny model): the same tiles on the fp32 CUDA
//    cores, 64 output channels per block, 8 channels per step, plain loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16;               // pixel tile
constexpr int HH = TH + 2, HW = TW + 2;      // with the one-pixel halo

__device__ __forceinline__ float swish_f(float a) { return a * (1.f / (1.f + expf(-a))); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// GroupNorm statistics
// ---------------------------------------------------------------------------

constexpr int kGnThreads = 256;

constexpr int kGnAhead = 8;                  // pixels a thread has in flight

// 8 channels of one pixel as loaded (those at or past `valid` read as 0),
// kept raw until used: 4 registers in bf16, 8 in fp32
struct Raw8f { float4 lo, hi; };

__device__ __forceinline__ uint4 raw8(const __nv_bfloat16* p, int valid, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 pair(2 * e < valid ? p[2 * e] : __float2bfloat16(0.f),
                              2 * e + 1 < valid ? p[2 * e + 1] : __float2bfloat16(0.f));
    w[e] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ Raw8f raw8(const float* p, int valid, bool vec) {
  if (vec) return {reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = e < valid ? p[e] : 0.f;
  return {make_float4(f[0], f[1], f[2], f[3]), make_float4(f[4], f[5], f[6], f[7])};
}

__device__ __forceinline__ void unpack8(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(h[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack8(const Raw8f& r, float* f) {
  f[0] = r.lo.x; f[1] = r.lo.y; f[2] = r.lo.z; f[3] = r.lo.w;
  f[4] = r.hi.x; f[5] = r.hi.y; f[6] = r.hi.z; f[7] = r.hi.w;
}

// One Welford step of 8 channels: count n (already incremented), 1 / n.
__device__ __forceinline__ void welford8(const float* v, float inv, float* mean, float* q) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float d = v[e] - mean[e];
    mean[e] += d * inv;
    q[e] += d * (v[e] - mean[e]);
  }
}

// Chan's merge of (nb, mb, qb) into (n, m, q): count, mean, sum of squared
// deviations.
__device__ __forceinline__ void chan_merge(float& n, float& m, float& q, float nb, float mb,
                                           float qb) {
  if (nb == 0.f) return;
  const float nn = n + nb, d = mb - m, wb = nb / nn;
  m += d * wb;
  q += qb + d * d * n * wb;
  n = nn;
}

// grid (nsplit, B); part [B, nsplit, G, 3] = (count, mean, M2) of each group
// over this block's range of pixels.
template <typename T>
__global__ void __launch_bounds__(kGnThreads)
gn_partial_kernel(const T* __restrict__ x, float* __restrict__ part, int HWn, int C, int G,
                  int vec_c) {
  __shared__ float s_mean[kGnThreads * 8], s_q[kGnThreads * 8], s_n[kGnThreads];
  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.y, tid = threadIdx.x;
  const int nchunk = (C + 7) / 8, rows = kGnThreads / nchunk;
  const int j = tid % nchunk, r = tid / nchunk;
  const int per = (HWn + nsplit - 1) / nsplit;
  const int p0 = split * per, p1 = min(p0 + per, HWn);
  const int valid = min(8, C - 8 * j);
  const bool vec = vec_c && valid == 8;

  float n = 0.f, mean[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) mean[e] = q[e] = 0.f;
  if (r < rows) {
    const T* base = x + (size_t)b * HWn * C + 8 * j;
    int p = p0 + r;
    for (; p < p1; p += kGnAhead * rows) {   // the loads of up to 8 pixels, then their updates
      decltype(raw8(base, 0, false)) raw[kGnAhead];
#pragma unroll
      for (int u = 0; u < kGnAhead; ++u)
        if (p + u * rows < p1) raw[u] = raw8(base + (size_t)(p + u * rows) * C, valid, vec);
#pragma unroll
      for (int u = 0; u < kGnAhead; ++u) {
        if (p + u * rows < p1) {
          float v[8];
          unpack8(raw[u], v);
          n += 1.f;
          welford8(v, 1.f / n, mean, q);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e < valid) {
        s_mean[r * C + 8 * j + e] = mean[e];
        s_q[r * C + 8 * j + e] = q[e];
      }
    }
    if (j == 0) s_n[r] = n;
  }
  __syncthreads();
  // each channel over the thread rows, in order; the result goes to row 0
  for (int c = tid; c < C; c += kGnThreads) {
    float cn = 0.f, cm = 0.f, cq = 0.f;
    for (int rr = 0; rr < rows; ++rr) chan_merge(cn, cm, cq, s_n[rr], s_mean[rr * C + c],
                                                 s_q[rr * C + c]);
    s_mean[c] = cm;
    s_q[c] = cq;
  }
  __syncthreads();
  float count = 0.f;
  for (int rr = 0; rr < rows; ++rr) count += s_n[rr];
  const int cg = C / G;
  for (int g = tid; g < G; g += kGnThreads) {
    float gn = 0.f, gm = 0.f, gq = 0.f;
    for (int i = 0; i < cg; ++i) chan_merge(gn, gm, gq, count, s_mean[g * cg + i],
                                            s_q[g * cg + i]);
    float* o = part + (((size_t)b * nsplit + split) * G + g) * 3;
    o[0] = gn;
    o[1] = gm;
    o[2] = gq;
  }
}

// grid (B, groups / 8): merges the ranges of each group and folds the affine.
// A warp takes a group: lane l merges ranges l, l + 32, ... in order, then the
// lanes merge as a fixed tree, so no lane waits on a chain of nsplit loads.
template <typename P>
__global__ void __launch_bounds__(kGnThreads)
gn_finish_kernel(const float* __restrict__ part, const P* __restrict__ scale,
                 const P* __restrict__ bias, float* __restrict__ ab, int C, int G, int nsplit,
                 float eps) {
  constexpr int kWarps = kGnThreads / 32;
  __shared__ float s_mean[kWarps], s_inv[kWarps];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g0 = blockIdx.y * kWarps, g = g0 + warp;
  if (g < G) {
    float n = 0.f, m = 0.f, q = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float* p = part + (((size_t)b * nsplit + s) * G + g) * 3;
      chan_merge(n, m, q, p[0], p[1], p[2]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, n, off);
      const float mb = __shfl_down_sync(0xffffffffu, m, off);
      const float qb = __shfl_down_sync(0xffffffffu, q, off);
      chan_merge(n, m, q, nb, mb, qb);
    }
    if (lane == 0) {
      s_mean[warp] = m;
      s_inv[warp] = rsqrtf(q / n + eps);
    }
  }
  __syncthreads();
  const int cg = C / G, c_end = min(G, g0 + kWarps) * cg;
  for (int c = g0 * cg + tid; c < c_end; c += kGnThreads) {
    const int w = c / cg - g0;
    const float sc = to_f(scale[c]), inv = s_inv[w];
    ab[(size_t)b * 2 * C + c] = sc * inv;
    ab[((size_t)b * 2 + 1) * C + c] = to_f(bias[c]) - s_mean[w] * sc * inv;
  }
}

template <typename T, typename P>
int launch_gn(const void* x, const void* scale, const void* bias, float* ab, float* part, int B,
              int HWn, int C, int G, int nsplit, float eps, cudaStream_t s) {
  const int vec_c = C % 8 == 0 && (uintptr_t)x % 16 == 0;
  gn_partial_kernel<T><<<dim3(nsplit, B), kGnThreads, 0, s>>>(static_cast<const T*>(x), part,
                                                               HWn, C, G, vec_c);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 grid(B, (G + kGnThreads / 32 - 1) / (kGnThreads / 32));
  gn_finish_kernel<P><<<grid, kGnThreads, 0, s>>>(part, static_cast<const P*>(scale),
                                                   static_cast<const P*>(bias), ab, C, G, nsplit,
                                                   eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 convolution: tensor cores (mma.sync m16n8k16), cp.async rings
// ---------------------------------------------------------------------------

constexpr int kBfThreads = 256;
constexpr int kBfCo = 128;                   // output channels per block
constexpr int kBfCk = 16;                    // input channels per chunk
constexpr int XP = kBfCk + 8;                // bf16 stride of one halo pixel (pad)
constexpr int WP = kBfCo + 8;                // bf16 stride of one weight row (pad)
constexpr int kXStages = 3;                  // halo tiles: raw, being activated, in use
constexpr int kWStages = 2;                  // weight slices: arriving, in use
constexpr int kXStage = HH * HW * XP;        // bf16 elements
constexpr int kWStage = 9 * kBfCk * WP;      // bf16 elements
constexpr int kAbStage = 2 * kBfCk;          // floats: A then B of the chunk
constexpr int kActRuns = 3;                  // runs of 4 channels a thread activates a chunk
static_assert(kActRuns * kBfThreads >= HH * HW * (kBfCk / 4), "activation runs");
constexpr int kBfSmem = (kWStages * kWStage + kXStages * kXStage) * 2 +
                        kXStages * kAbStage * 4;   // 104,640 bytes

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// swish in fp32 with the fast exponential and division: the result is
// rounded to bf16, far coarser than their error
__device__ __forceinline__ float swish_fast(float a) {
  return __fdividef(a, 1.f + __expf(-a));
}

template <bool GN>
__global__ void __launch_bounds__(kBfThreads, 2)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ab,
                    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int H, int W, int C, int Cout, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* const wring = reinterpret_cast<__nv_bfloat16*>(smem);   // [stage][tap][c][co]
  __nv_bfloat16* const xring = wring + kWStages * kWStage;              // [stage][yy][xx][c]
  float* const abring = reinterpret_cast<float*>(xring + kXStages * kXStage);

  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * kBfCo;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wy = 2 * (warp & 3);        // this warp's first image row in the tile
  const int wn = 64 * (warp >> 2);      // and its first output channel in the block
  const int nchunks = (C + kBfCk - 1) / kBfCk;

  // the raw halo tile (and the chunk's A, B) of chunk k into halo stage k % 3
  auto stage_x = [&](int k) {
    const int c0 = k * kBfCk;
    __nv_bfloat16* xs = xring + (k % kXStages) * kXStage;
    for (int i = tid; i < HH * HW * (kBfCk / 8); i += kBfThreads) {
      const int part = i % (kBfCk / 8), pix = i / (kBfCk / 8);
      const int xx = pix % HW, yy = pix / HW;
      const int gy = ty0 + yy - 1, gx = tx0 + xx - 1, gc = c0 + 8 * part;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C;
      const __nv_bfloat16* src = in ? x + (((size_t)b * H + gy) * W + gx) * C + gc : x;
      __nv_bfloat16* dst = xs + pix * XP + 8 * part;
      if (vec) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = in && gc + e < C ? src[e] : __float2bfloat16(0.f);
      }
    }
    if (GN && tid < kAbStage / 4) {     // 4 floats a thread: A, then B
      const int half = tid / (kBfCk / 4), c = c0 + 4 * (tid % (kBfCk / 4));
      const float* src = c < C ? ab + ((size_t)b * 2 + half) * C + c : ab;
      float* dst = abring + (k % kXStages) * kAbStage + half * kBfCk + c - c0;
      if (vec) {
        cp_async16(dst, src, c < C ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = c + e < C ? src[e] : 0.f;
      }
    }
  };
  // weights [3, 3, chunk k, co0 .. co0 + 128) into weight stage k % 2
  auto stage_w = [&](int k) {
    const int c0 = k * kBfCk;
    __nv_bfloat16* ws = wring + (k % kWStages) * kWStage;
    for (int i = tid; i < 9 * kBfCk * (kBfCo / 8); i += kBfThreads) {
      const int part = i % (kBfCo / 8), rest = i / (kBfCo / 8);
      const int c = rest % kBfCk, tap = rest / kBfCk;
      const int gc = c0 + c, gco = co0 + 8 * part;
      const bool in = gc < C && gco < Cout;
      const __nv_bfloat16* src = in ? w + ((size_t)tap * C + gc) * Cout + gco : w;
      __nv_bfloat16* dst = ws + (tap * kBfCk + c) * WP + 8 * part;
      if (vec) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = in && gco + e < Cout ? src[e] : __float2bfloat16(0.f);
      }
    }
  };
  // This thread's runs of 4 channels in a halo tile, the same in every
  // chunk: (offset in the stage << 3) | (run << 1), or -1 where the run is
  // outside the image or the tile. The staging left those at zero, which is
  // the padding after the activation, so they are not touched.
  int act[kActRuns];
#pragma unroll
  for (int j = 0; j < kActRuns; ++j) {
    const int i = tid + j * kBfThreads;
    const int run = i % (kBfCk / 4), pix = i / (kBfCk / 4);
    const int gy = ty0 + pix / HW - 1, gx = tx0 + pix % HW - 1;
    const bool in = i < HH * HW * (kBfCk / 4) && gy >= 0 && gy < H && gx >= 0 && gx < W;
    act[j] = in ? ((pix * XP + 4 * run) << 3) | (run << 1) : -1;
  }
  // affine + swish in place on this thread's runs of chunk k's halo tile,
  // once per element, 0 past C
  auto activate = [&](int k) {
#pragma unroll
    for (int j = 0; j < kActRuns; ++j) {
      const int code = act[j];
      if (code < 0) continue;
      const int run = (code >> 1) & 3, c = k * kBfCk + 4 * run;
      uint2* p = reinterpret_cast<uint2*>(xring + (k % kXStages) * kXStage + (code >> 3));
      const float* a = abring + (k % kXStages) * kAbStage + 4 * run;
      const uint2 raw = *p;
      const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint2 v;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 f = __bfloat1622float2(r[e]);
        o[e] = __floats2bfloat162_rn(
            c + 2 * e < C ? swish_fast(f.x * a[2 * e] + a[kBfCk + 2 * e]) : 0.f,
            c + 2 * e + 1 < C ? swish_fast(f.y * a[2 * e + 1] + a[kBfCk + 2 * e + 1]) : 0.f);
      }
      *p = v;
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  stage_x(0);
  stage_w(0);
  if (nchunks > 1) stage_x(1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (GN) activate(0);

  // B fragments via ldmatrix.trans: matrix i of lane (i = lane / 8) holds
  // channels 8 * (i % 2) .. and output channels 8 * (i / 2) ..
  const int brow = (lane & 7) + 8 * ((lane >> 3) & 1), bcol = 8 * (lane >> 4);
#pragma unroll 1
  for (int k = 0; k < nchunks; ++k) {
    // chunk k's weights and chunk k + 1's halo have landed (this thread's
    // copies; the barrier makes everyone's visible), chunk k's halo is
    // activated, and every read of the stages refilled below is done
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < nchunks) stage_w(k + 1);
    if (k + 2 < nchunks) stage_x(k + 2);
    cp_async_commit();
    // chunk k + 1's halo, read after the next barrier
    if (GN && k + 1 < nchunks) activate(k + 1);

    const __nv_bfloat16* xs = xring + (k % kXStages) * kXStage;
    const __nv_bfloat16* ws = wring + (k % kWStages) * kWStage;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // m-tile = image row wy + mt of the tile; its rows g and g + 8 are
        // pixels x = g and x = g + 8 of that row
        const __nv_bfloat16* p0 = xs + ((wy + mt + dy) * HW + g + dx) * XP + 2 * t;
        const __nv_bfloat16* p1 = p0 + 8 * XP;
        a[mt][0] = lds32(p0);
        a[mt][1] = lds32(p1);
        a[mt][2] = lds32(p0 + 8);
        a[mt][3] = lds32(p1 + 8);
      }
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, ws + (tap * kBfCk + brow) * WP + wn + 16 * dn + bcol);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * dn], a[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * dn + 1], a[mt], bf[2], bf[3]);
        }
      }
    }
  }

  // bias in fp32, one rounding, bf16 pairs (32-bit stores) where Cout is even
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int gy = ty0 + wy + mt;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gx = tx0 + g + 8 * hf;
      if (gy >= H || gx >= W) continue;
      __nv_bfloat16* dst = out + (((size_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int gco = co0 + wn + 8 * nt + 2 * t;
        if (gco >= Cout) continue;
        const float v0 = acc[mt][nt][2 * hf] + __bfloat162float(bias[gco]);
        if (gco + 1 < Cout) {
          const float v1 = acc[mt][nt][2 * hf + 1] + __bfloat162float(bias[gco + 1]);
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst + gco) = __floats2bfloat162_rn(v0, v1);
            continue;
          }
          dst[gco + 1] = __float2bfloat16(v1);
        }
        dst[gco] = __float2bfloat16(v0);
      }
    }
  }
}

template <bool GN>
int launch_conv_bf16(const void* x, const float* ab, const void* w, const void* bias, void* out,
                     int B, int H, int W, int C, int Cout, cudaStream_t s) {
  using bf = __nv_bfloat16;
  auto kern = conv3x3_bf16_kernel<GN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBfSmem);
  if (attr != cudaSuccess) return (int)attr;
  // 16-byte copies where every pixel's channel run, weight row and (A, B) row
  // starts on 16 bytes
  const int vec = C % 8 == 0 && Cout % 8 == 0 &&
                  ((uintptr_t)x | (uintptr_t)w | (uintptr_t)ab) % 16 == 0;
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid(tiles, (Cout + kBfCo - 1) / kBfCo, B);
  kern<<<grid, kBfThreads, kBfSmem, s>>>(static_cast<const bf*>(x), ab, static_cast<const bf*>(w),
                                         static_cast<const bf*>(bias), static_cast<bf*>(out), H,
                                         W, C, Cout, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 convolution: CUDA cores
// ---------------------------------------------------------------------------

constexpr int TCO = 64, CK = 8;
constexpr int kThreads = 256;

template <bool GN>
__global__ void __launch_bounds__(kThreads)
conv3x3_fp32_kernel(const float* __restrict__ x, const float* __restrict__ ab,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    float* __restrict__ out, int H, int W, int C, int Cout) {
  __shared__ float xs[CK][HH][HW];
  __shared__ __align__(16) float ws[9][CK][TCO];

  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cog = tid & 7;   // output channels co0 + 8 * cog .. + 8
  const int pg = tid >> 3;   // pixels pg + 32 * i of the tile, i < 4

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();
    for (int i = tid; i < CK * HH * HW; i += kThreads) {
      const int c = i % CK;
      const int rest = i / CK;
      const int xx = rest % HW, yy = rest / HW;
      const int gy = ty0 + yy - 1, gx = tx0 + xx - 1, gc = c0 + c;
      float val = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C) {
        val = x[(((size_t)b * H + gy) * W + gx) * C + gc];
        if (GN) val = swish_f(val * ab[(size_t)b * 2 * C + gc] + ab[((size_t)b * 2 + 1) * C + gc]);
      }
      xs[c][yy][xx] = val;
    }
    for (int i = tid; i < 9 * CK * TCO; i += kThreads) {
      const int co = i % TCO;
      const int rest = i / TCO;
      const int c = rest % CK, tap = rest / CK;
      const int gc = c0 + c, gco = co0 + co;
      ws[tap][c][co] = (gc < C && gco < Cout) ? w[((size_t)tap * C + gc) * Cout + gco] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float4 w0 = *reinterpret_cast<const float4*>(&ws[tap][c][cog * 8]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ws[tap][c][cog * 8 + 4]);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = pg + 32 * i;
          const float xv = xs[c][p / TW + dy][p % TW + dx];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += xv * wv[j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pg + 32 * i;
    const int gy = ty0 + p / TW, gx = tx0 + p % TW;
    if (gy >= H || gx >= W) continue;
    float* dst = out + (((size_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gco = co0 + cog * 8 + j;
      if (gco < Cout) dst[gco] = acc[i][j] + bias[gco];
    }
  }
}

}  // namespace

// x [B, H, W, C] in x_dtype (0 fp32, 1 bf16); scale, bias [C] in p_dtype;
// ab [B, 2, C] fp32; scratch [B, nsplit, G, 3] fp32. One call queues the
// partial pass over nsplit pixel ranges of each image and the finish pass.
extern "C" int gn_affine_launch(int x_dtype, const void* x, int p_dtype, const void* scale,
                                const void* bias, void* ab, void* scratch, int B, int HWn, int C,
                                int G, int nsplit, float eps, void* stream) {
  if (B <= 0 || B > 65535 || HWn <= 0 || C <= 0 || C > 8 * kGnThreads || G <= 0 || C % G ||
      nsplit <= 0 || nsplit > HWn || (x_dtype != 0 && x_dtype != 1) ||
      (p_dtype != 0 && p_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* abf = static_cast<float*>(ab);
  float* part = static_cast<float*>(scratch);
  using bf = __nv_bfloat16;
  auto launch = x_dtype == 1 ? (p_dtype == 1 ? &launch_gn<bf, bf> : &launch_gn<bf, float>)
                             : (p_dtype == 1 ? &launch_gn<float, bf> : &launch_gn<float, float>);
  return launch(x, scale, bias, abf, part, B, HWn, C, G, nsplit, eps, s);
}

extern "C" int conv3x3_gn_swish_launch(int dtype, const void* x, const void* ab, const void* w,
                                       const void* bias, void* out, int B, int H, int W, int C,
                                       int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const float* abf = static_cast<const float*>(ab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ab ? launch_conv_bf16<true>(x, abf, w, bias, out, B, H, W, C, Cout, s)
              : launch_conv_bf16<false>(x, abf, w, bias, out, B, H, W, C, Cout, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid(tiles, (Cout + TCO - 1) / TCO, B);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bfp = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  if (ab)
    conv3x3_fp32_kernel<true><<<grid, kThreads, 0, s>>>(xf, abf, wf, bfp, of, H, W, C, Cout);
  else
    conv3x3_fp32_kernel<false><<<grid, kThreads, 0, s>>>(xf, abf, wf, bfp, of, H, W, C, Cout);
  return (int)cudaGetLastError();
}
