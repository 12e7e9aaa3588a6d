// Fused GroupNorm-affine + swish + 3x3 SAME convolution for Hopper (sm_90a).
//
// Replaces the TPU kernel unigen_tpu/ops/fused_conv.py:conv3x3_gn_swish
// (body _kernel, called from _fused_forward):
//   out = conv3x3(swish(x * A[b, c] + B[b, c])) + bias      (NHWC, HWIO)
// where A, B fold the GroupNorm statistics and affine into one per-(batch,
// channel) pair, computed in fp32 by a pre-pass (ops/fused_conv.py:gn_affine).
// Without the affine (ab == nullptr) it is a plain conv3x3 (the upsample conv).
// The affine and swish run in fp32 and are rounded to x's type before the
// convolution, as the TPU kernel casts them; the SAME padding is zero AFTER
// the activation; the convolution accumulates in fp32 and adds the bias once.
//
// Design. A block owns an 8 x 16 pixel tile of one image and a slice of the
// output channels. Input channels stream through shared memory a chunk at a
// time: the block loads the tile plus a one-pixel halo, applies affine +
// swish (zero outside the image) and loads the matching [3, 3, chunk, Cout]
// slice of the weights. The 3x3 convolution is then an implicit GEMM
// (M = pixels, N = output channels, K = 9 taps x channels) over shifted
// windows of the halo tile. The activated input is never written to device
// memory: x is read about 1.4 times (the halo) and the output written once.
//  * bfloat16 (the decoder's path): 8 warps, 128 output channels per block;
//    each warp owns 2 image rows (2 x 16 pixels) x 64 channels and runs
//    mma.sync m16n8k16 bf16 products with fp32 accumulators, 16 channels
//    per step. A fragments are read straight from the activated halo tile;
//    B fragments come from the HWIO weights through ldmatrix.trans.
//  * float32 (tests and the tiny model): the same tiles on the fp32 CUDA
//    cores, 64 output channels per block, 8 channels per step.
//
// Bound on this card: the hot decoder shape [4, 256, 256, 128] -> 128 is
// 77 GFLOP against ~134 MB, compute-bound (~78 us on the bf16 tensor cores).
// mma.sync reaches only part of the wgmma rate and the loads are not
// pipelined (no cp.async/TMA ring), so the kernel stays above that bound;
// a wgmma implicit GEMM over the same tiles is the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16;               // pixel tile
constexpr int HH = TH + 2, HW = TW + 2;      // with the one-pixel halo

__device__ __forceinline__ float swish_f(float a) { return a * (1.f / (1.f + expf(-a))); }

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kBfThreads = 256;
constexpr int kBfCo = 128;                   // output channels per block
constexpr int kBfCk = 16;                    // input channels per step
constexpr int XP = kBfCk + 8;                // bf16 stride of one halo pixel (pad)
constexpr int WP = kBfCo + 8;                // bf16 stride of one weight row (pad)

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

template <bool GN>
__global__ void __launch_bounds__(kBfThreads)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ab,
                    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int H, int W, int C, int Cout) {
  __shared__ __align__(16) __nv_bfloat16 xs[HH * HW * XP];    // [yy][xx][c]
  __shared__ __align__(16) __nv_bfloat16 ws[9 * kBfCk * WP];  // [tap][c][co]

  const int tiles_w = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * kBfCo;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wy = 2 * (warp & 3);        // this warp's first image row in the tile
  const int wn = 64 * (warp >> 2);      // and its first output channel in the block
  const bool vec_c = (C % 8) == 0, vec_co = (Cout % 8) == 0;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kBfCk) {
    __syncthreads();
    // activated halo tile, 8 channels per item
    for (int i = tid; i < HH * HW * (kBfCk / 8); i += kBfThreads) {
      const int part = i % (kBfCk / 8), pix = i / (kBfCk / 8);
      const int xx = pix % HW, yy = pix / HW;
      const int gy = ty0 + yy - 1, gx = tx0 + xx - 1, gc = c0 + 8 * part;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const __nv_bfloat16* src = x + (((size_t)b * H + gy) * W + gx) * C + gc;
        if (vec_c && gc < C) {
          const uint4 raw = *reinterpret_cast<const uint4*>(src);
          const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(r[e]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (gc + e < C) f[e] = __bfloat162float(src[e]);
        }
        if (GN) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (gc + e < C)
              f[e] = swish_f(f[e] * ab[(size_t)b * 2 * C + gc + e] +
                             ab[((size_t)b * 2 + 1) * C + gc + e]);
        }
      }
      __nv_bfloat16* dst = xs + pix * XP + 8 * part;
#pragma unroll
      for (int e = 0; e < 8; e += 2)
        *reinterpret_cast<__nv_bfloat162*>(dst + e) = __floats2bfloat162_rn(f[e], f[e + 1]);
    }
    // weights [3, 3, chunk, co0 .. co0 + 128), 8 output channels per item
    for (int i = tid; i < 9 * kBfCk * (kBfCo / 8); i += kBfThreads) {
      const int part = i % (kBfCo / 8), rest = i / (kBfCo / 8);
      const int c = rest % kBfCk, tap = rest / kBfCk;
      const int gc = c0 + c, gco = co0 + 8 * part;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gc < C) {
        const __nv_bfloat16* src = w + ((size_t)tap * C + gc) * Cout + gco;
        if (vec_co && gco < Cout) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (gco + e < Cout) v[e] = src[e];
        }
      }
      *reinterpret_cast<uint4*>(ws + (tap * kBfCk + c) * WP + 8 * part) = val;
    }
    __syncthreads();

    // B fragments via ldmatrix.trans: matrix i of lane (i = lane / 8) holds
    // channels 8 * (i % 2) .. and output channels 8 * (i / 2) ..
    const int brow = (lane & 7) + 8 * ((lane >> 3) & 1), bcol = 8 * (lane >> 4);
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
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gco = co0 + wn + 8 * nt + 2 * t + e;
          if (gco < Cout)
            dst[gco] = __float2bfloat16(acc[mt][nt][2 * hf + e] + __bfloat162float(bias[gco]));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
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

extern "C" int conv3x3_gn_swish_launch(int dtype, const void* x, const void* ab, const void* w,
                                       const void* bias, void* out, int B, int H, int W, int C,
                                       int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const float* abf = static_cast<const float*>(ab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (dtype == 1) {
    // 16-byte vector loads of x and w rows
    if (((uintptr_t)x | (uintptr_t)w) % 16) return (int)cudaErrorMisalignedAddress;
    using bf = __nv_bfloat16;
    dim3 grid(tiles, (Cout + kBfCo - 1) / kBfCo, B);
    const bf* xb = static_cast<const bf*>(x);
    const bf* wb = static_cast<const bf*>(w);
    const bf* bb = static_cast<const bf*>(bias);
    bf* ob = static_cast<bf*>(out);
    if (ab)
      conv3x3_bf16_kernel<true><<<grid, kBfThreads, 0, s>>>(xb, abf, wb, bb, ob, H, W, C, Cout);
    else
      conv3x3_bf16_kernel<false><<<grid, kBfThreads, 0, s>>>(xb, abf, wb, bb, ob, H, W, C, Cout);
    return (int)cudaGetLastError();
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
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
