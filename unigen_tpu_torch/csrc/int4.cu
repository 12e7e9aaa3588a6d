// W4A8 dense layers for Hopper (sm_90a): int8 activations times int4-packed
// weights, group scales folded in fp32, and the per-token activation
// quantization that feeds them.
//
// w4a8_dense_launch replaces the TPU kernel
//   unigen_tpu/ops/int4.py:w4a8_matmul (body _w4a8_kernel):
//     p[t, c] = sum over groups g, in order, of
//               float(sum_{k in group g} x[t, k] * w4[k, c]) * scale4[g, c]
//   x [T, K] int8; packed [K/2, N] int8 where, inside each group of `group`
//   rows, byte j holds row j in its low nibble and row j + group/2 in its
//   high nibble (lo = (int8)(b << 4) >> 4, hi = b >> 4, arithmetic);
//   scale4 [K/group, N] fp32. The layout is taken as it is: no relayout at
//   load time. It applies JAX's epilogue
//   (unigen_tpu/ops/int4.py:dense_int4_prequant) in its store:
//     y[t, c] = p[t, c] * act_scale[t] + float(bias[c]), c < n,
//   rounded once to the output type (fp32 or bf16), into out [T, n]: only
//   the blocks that hold one of the first n columns run, and no fp32 [T, N]
//   product exists. With act_scale 1 and a zero bias of n = N in fp32 it is
//   the product itself (ops/int4.py:w4a8_matmul).
// quantize_activations_launch replaces unigen_tpu/ops/quantization.py:
//   quantize_activations (an XLA fusion there, not a Pallas kernel):
//     act_scale[t] = max(max_k |x[t, k]| / 127, 1e-8),
//     x_int8[t, k] = clip(round_half_even(x[t, k] / act_scale[t]), -127, 127).
//
// Exactness. A group's products are summed exactly in int32 (|sum| <=
// group * 127 * 7, below 2^24, so its fp32 conversion is exact too), and the
// fold acc = acc + part * scale uses __fmul_rn / __fadd_rn (no fused
// multiply-add) group by group; the epilogue is __fmul_rn, __fadd_rn, then a
// round-to-nearest-even cast; the quantization divides with __fdiv_rn (IEEE,
// no reciprocal) and rounds with rintf. Every entry point equals its plain
// PyTorch version (ops/int4.py, ops/quantization.py) bit for bit.
//
// Bound on this card. At decode (T = 8) the product reads K*N/2 bytes of
// weights for 2*T*K*N operations: memory-bound (gate 1536 -> 8960: 6.9 MB,
// ~2 us at 3.35 TB/s; the 160k-wide head: 123 MB, ~37 us). At the prefill
// (T ~ 6,300) it is bound by the int8 tensor-core rate (gate: 174 G ops,
// ~88 us at 1,979 TOP/s). The quantization is bound by its bytes: it reads x
// once (twice from L1/L2) and writes a quarter (bf16: half) of that back.
//
// Design.
// * T <= 16 (decode, the head): a block of 4 warps owns 64 output columns
//   and one m16 row tile. It walks the groups in order, in chunks of 64
//   packed rows (64 low-nibble and 64 high-nibble k values; a group with
//   fewer rows is zero-filled, which adds nothing). Each chunk's packed tile
//   is read with 8-byte loads one chunk ahead into registers, unpacked to
//   int8 (four rows' nibbles per 32-bit word, sign-extended with per-byte
//   SIMD) and stored k-contiguous in shared memory, so that mma.sync
//   m16n8k32 s8 x s8 -> s32 takes its B fragments with 32-bit loads.
//   Activations follow the same (low half, high half) order of k. Only the
//   packed bytes cross the memory bus.
//   Split over groups (when the caller passes a scratch buffer): a layer with
//   few 64-column tiles (q/o/down: 24, gate/up: 140) gives too few blocks to
//   keep enough bytes in flight, so each block takes one (column tile,
//   group) pair and writes its group's scaled part, __fmul_rn(float(part),
//   scale), to scratch [G, T, n]; a second small kernel from the same C call
//   adds the parts in group order with __fadd_rn from 0 and applies the
//   epilogue. That is the same sequence of roundings as the fold inside the
//   block, so both ways give the same bits.
// * T > 16 (the prefill): a 128 x 128 block tile of 8 warps (2 x 4, each
//   64 rows x 32 columns: every A fragment feeds 4 products, every B
//   fragment 4). A 3-stage ring of 16-byte cp.async.cg copies carries the
//   raw packed tile (64 packed rows x 128 columns) and the activation tile
//   (128 rows x 128 k) of the next chunks while chunk c is multiplied; rows
//   past T and columns past N are zero-filled by the copy's src-size. The
//   packed stage is unpacked once per block into one of two k-contiguous
//   tiles: chunk c+1's unpacking runs beside chunk c's products, so a chunk
//   costs one barrier. The tiles' 16-byte k runs are rotated by column
//   block, so that the unpacking stores and the ldmatrix reads of both A and
//   B fragments are free of bank conflicts. Shapes that 16-byte copies
//   cannot cover (K, group/2 or N not multiples of 16) take the same body
//   with plain loads. No wgmma, no TMA. Measured on an H100 (PERF.md) this
//   body is about 8x its operation bound at the prefill gate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// c += a . b: a 16x32 (row), b 32x8 (col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 matrices of 16-bit cells (here: pairs of int8); lane i gives the
// 16-byte aligned address of row i % 8 of matrix i / 8. For a [row][k] int8
// tile at rows r0 + (lane & 15), bytes k0 + 16 * (lane >> 4) the result is
// the A fragment of mma m16n8k32 s8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// Sign-extends the 4-bit value held in the low nibble of each byte.
__device__ __forceinline__ uint32_t sext4(uint32_t nib) {
  return __vsub4(nib ^ 0x08080808u, 0x08080808u);
}

// Byte E (0..7) of four 8-byte values gathered into one word, value r in byte r.
template <int E>
__device__ __forceinline__ uint32_t gather(const uint2* v) {
  constexpr unsigned sel = (E & 3) | (((E & 3) + 4) << 4);
  uint32_t a = __byte_perm(E < 4 ? v[0].x : v[0].y, E < 4 ? v[1].x : v[1].y, sel);
  uint32_t b = __byte_perm(E < 4 ? v[2].x : v[2].y, E < 4 ? v[3].x : v[3].y, sel);
  return __byte_perm(a, b, 0x5410);
}

// What the final store does with a folded fp32 sum v at (t, col).
struct Epilogue {
  const float* act_scale;  // [T]
  const void* bias;        // [n], fp32 or bf16
  void* out;               // [T, n] row-major
  int n;                   // stored columns (the row stride of out)
  int bias_bf16, out_bf16;
  int pairs;               // n even and out 8-byte aligned: (col, col+1) in one store

  __device__ __forceinline__ float apply(float v, int t, int col) const {
    const float b = bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col])
                              : static_cast<const float*>(bias)[col];
    return __fadd_rn(__fmul_rn(v, act_scale[t]), b);
  }
  // v0 at (t, col), v1 at (t, col + 1); col is even, t < T
  __device__ __forceinline__ void store2(int t, int col, float v0, float v1) const {
    if (col >= n) return;
    const size_t i = (size_t)t * n + col;
    const bool both = col + 1 < n;
    const float y0 = apply(v0, t, col), y1 = both ? apply(v1, t, col + 1) : 0.f;
    if (out_bf16) {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + i;
      if (both && pairs) {
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
      } else {
        o[0] = __float2bfloat16_rn(y0);
        if (both) o[1] = __float2bfloat16_rn(y1);
      }
    } else {
      float* o = static_cast<float*>(out) + i;
      if (both && pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
      } else {
        o[0] = y0;
        if (both) o[1] = y1;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// T <= 16: one m16 row tile, 64 columns a block, optionally split over groups
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;       // 4 warps
constexpr int kBN = 64;             // output columns per block, 16 per warp
constexpr int kRows = 64;           // packed rows per chunk
constexpr int kKW = 2 * kRows / 4;  // 32-bit words of k per row of a chunk (lo, then hi)
constexpr int kLD = kKW + 4;        // padded shared-memory stride in words

template <int E>
__device__ __forceinline__ void store_col(uint32_t* ws, const uint2* v, int cc, int rq) {
  const uint32_t b = gather<E>(v);
  uint32_t* dst = ws + (8 * cc + E) * kLD;
  dst[rq] = sext4(b & 0x0F0F0F0Fu);               // rows 4rq..4rq+3 of the low half
  dst[kKW / 2 + rq] = sext4((b >> 4) & 0x0F0F0F0Fu);  // the same rows of the high half
}

// SPLIT: block (column tile, group blockIdx.y) writes its group's scaled part
// to part = scratch [G, T, epi.n]; otherwise the block walks all groups and
// stores through the epilogue.
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
w4a8_decode_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ part, Epilogue epi,
                   int T, int K, int N, int group, int x_words, int w_vec) {
  constexpr int BT = 16;                      // rows of T per block
  constexpr int XW = BT * kKW / kThreads;     // activation words each thread stages
  __shared__ uint32_t xs[BT * kLD];           // [BT][k words]
  __shared__ uint32_t ws[kBN * kLD];          // [column][k words]

  const int half = group / 2;
  const int cpg = (half + kRows - 1) / kRows;  // chunks per group
  const int c_begin = SPLIT ? blockIdx.y * cpg : 0;
  const int n_chunks = SPLIT ? c_begin + cpg : (K / group) * cpg;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rq = tid >> 3, cc = tid & 7;       // packed rows 4rq.., columns 8cc.. of a chunk

  uint2 wreg[4];
  uint32_t xreg[XW];

  auto load = [&](int c) {
    const int g = c / cpg, j0 = (c % cpg) * kRows;
    const int col = n0 + 8 * cc;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + 4 * rq + r;
      uint2 v = make_uint2(0u, 0u);
      if (j < half) {
        const uint8_t* src = w + (size_t)(g * half + j) * N + col;
        if (w_vec) {
          if (col < N) v = __ldg(reinterpret_cast<const uint2*>(src));
        } else {
          for (int e = 0; e < 8; ++e)
            if (col + e < N) {
              const uint32_t byte = src[e];
              if (e < 4) v.x |= byte << (8 * e); else v.y |= byte << (8 * (e - 4));
            }
        }
      }
      wreg[r] = v;
    }
#pragma unroll
    for (int i = 0; i < XW; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kKW, kw = idx % kKW;
      const int hi = kw / (kKW / 2);                // 0: low half of the group, 1: high
      const int jj = j0 + 4 * (kw % (kKW / 2));
      uint32_t val = 0u;
      if (row < T && jj < half) {
        const int8_t* src = x + (size_t)row * K + (size_t)g * group + hi * half + jj;
        if (x_words) {
          val = __ldg(reinterpret_cast<const uint32_t*>(src));
        } else {
          for (int e = 0; e < 4; ++e)
            if (jj + e < half) val |= (uint32_t)(uint8_t)src[e] << (8 * e);
        }
      }
      xreg[i] = val;
    }
  };

  int acc[2][4];
  float facc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nt][e] = 0;
      facc[nt][e] = 0.f;
    }

  load(c_begin);
  for (int c = c_begin; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's fragments are read
    store_col<0>(ws, wreg, cc, rq);
    store_col<1>(ws, wreg, cc, rq);
    store_col<2>(ws, wreg, cc, rq);
    store_col<3>(ws, wreg, cc, rq);
    store_col<4>(ws, wreg, cc, rq);
    store_col<5>(ws, wreg, cc, rq);
    store_col<6>(ws, wreg, cc, rq);
    store_col<7>(ws, wreg, cc, rq);
#pragma unroll
    for (int i = 0; i < XW; ++i) {
      const int idx = tid + i * kThreads;
      xs[(idx / kKW) * kLD + idx % kKW] = xreg[i];
    }
    __syncthreads();
    if (c + 1 < n_chunks) load(c + 1);  // in flight during this chunk's products

#pragma unroll
    for (int s = 0; s < kKW / 8; ++s) {  // k32 steps
      const uint32_t* ap = xs + gid * kLD + 8 * s + tig;
      const uint32_t a[4] = {ap[0], ap[8 * kLD], ap[4], ap[8 * kLD + 4]};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t* bp = ws + (16 * warp + 8 * nt + gid) * kLD + 8 * s + tig;
        mma_s8(acc[nt], a, bp[0], bp[4]);
      }
    }

    if ((c + 1) % cpg == 0) {  // the group is complete: fold its scale, in group order
      const int g = c / cpg;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + 16 * warp + 8 * nt + 2 * tig;
        const float s0 = col < N ? scale[(size_t)g * N + col] : 0.f;
        const float s1 = col + 1 < N ? scale[(size_t)g * N + col + 1] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float scaled = __fmul_rn((float)acc[nt][e], (e & 1) ? s1 : s0);
          if (SPLIT) {
            const int t = gid + 8 * (e >> 1), cl = col + (e & 1);
            if (t < T && cl < epi.n) part[((size_t)g * T + t) * epi.n + cl] = scaled;
          } else {
            facc[nt][e] = __fadd_rn(facc[nt][e], scaled);
          }
          acc[nt][e] = 0;
        }
      }
    }
  }
  if constexpr (!SPLIT) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = gid + 8 * h;
        if (t < T)
          epi.store2(t, n0 + 16 * warp + 8 * nt + 2 * tig, facc[nt][2 * h],
                     facc[nt][2 * h + 1]);
      }
  }
}

// out[t, c] = epilogue(sum over g, in order, of part[g, t, c], from 0), c < n.
__global__ void w4a8_fold_kernel(const float* __restrict__ part, Epilogue epi, int T, int G) {
  const int half_n = (epi.n + 1) / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T * half_n) return;
  const int t = i / half_n, col = 2 * (i % half_n);
  const bool both = col + 1 < epi.n;
  float a0 = 0.f, a1 = 0.f;
  for (int g = 0; g < G; ++g) {
    const float* p = part + ((size_t)g * T + t) * epi.n + col;
    a0 = __fadd_rn(a0, p[0]);
    if (both) a1 = __fadd_rn(a1, p[1]);
  }
  epi.store2(t, col, a0, a1);
}

// ---------------------------------------------------------------------------
// T > 16: 128 x 128 block tile, 8 warps, cp.async ring, one barrier a chunk
// ---------------------------------------------------------------------------

constexpr int kPM = 128, kPN = 128;       // block tile
constexpr int kPThreads = 2 * kPM;        // 8 warps: 2 along T x 4 along N
constexpr int kPK = 2 * kRows;            // k values (bytes) per chunk: 64 low + 64 high
constexpr int kPLD = kPK + 16;            // 144-byte rows of every shared tile
constexpr int kPStages = 3;               // chunk c multiplied, c+1 unpacked, c+2 in flight
constexpr int kPX = kPM * kPLD;           // activation stage, bytes
constexpr int kPW = kRows * kPLD;         // raw packed stage: 64 rows x 128 columns (+ pad)
constexpr int kPU = kPN * kPLD;           // unpacked tile, two of them
constexpr int kPSmem = kPStages * (kPX + kPW) + 2 * kPU;  // 119,808 bytes

// Word of k run kw (0..31) of column col in an unpacked tile: the runs of
// column block col / 8 are rotated by 4 * (col / 8 % 8) words, so that a
// warp's unpacking stores (8 column blocks x 4 runs) touch 32 distinct banks
// and an ldmatrix phase (8 columns, one 16-byte run each) all 32.
__device__ __forceinline__ int wsu_word(int col, int kw) {
  return col * (kPLD / 4) + ((kw + 4 * ((col >> 3) & 7)) & 31);
}

template <bool VEC>
__global__ void __launch_bounds__(kPThreads, 1)
w4a8_prefill_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                    const float* __restrict__ scale, Epilogue epi, int T, int K, int N,
                    int group) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs0 = smem;                                  // [stage][kPM][kPLD]
  uint8_t* wr0 = smem + kPStages * kPX;                 // [stage][kRows][kPLD]
  uint8_t* wu0 = smem + kPStages * (kPX + kPW);         // [2][kPN][kPLD], k-contiguous

  const int half = group / 2;
  const int cpg = (half + kRows - 1) / kRows;  // chunks per group
  const int n_chunks = (K / group) * cpg;
  const int n0 = blockIdx.x * kPN, m0 = blockIdx.y * kPM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;      // this warp's 64 rows and 32 columns

  // chunk c -> stage st: activations (128 rows x 8 runs of 16 bytes, low half
  // first) and packed rows (64 rows x 8 runs of 16 columns)
  auto load = [&](int c, int st) {
    const int g = c / cpg, j0 = (c % cpg) * kRows;
    uint8_t* xs = xs0 + st * kPX;
    uint8_t* wr = wr0 + st * kPW;
#pragma unroll
    for (int i = 0; i < kPM * 8 / kPThreads; ++i) {
      const int idx = tid + i * kPThreads;
      const int row = idx >> 3, run = idx & 7;
      const int hi = run >> 2, jj = j0 + 16 * (run & 3);
      const int t = m0 + row;
      const int8_t* src = x + (size_t)t * K + (size_t)g * group + hi * half + jj;
      uint8_t* dst = xs + row * kPLD + 16 * run;
      if (VEC) {
        const bool ok = t < T && jj < half;
        cp_async16(dst, ok ? src : x, ok ? 16 : 0);
      } else {
        for (int e = 0; e < 16; ++e)
          dst[e] = (t < T && jj + e < half) ? static_cast<uint8_t>(src[e]) : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows * 8 / kPThreads; ++i) {
      const int idx = tid + i * kPThreads;
      const int r = idx >> 3, run = idx & 7;
      const int j = j0 + r, col = n0 + 16 * run;
      const uint8_t* src = w + (size_t)(g * half + j) * N + col;
      uint8_t* dst = wr + r * kPLD + 16 * run;
      if (VEC) {
        const bool ok = j < half && col < N;
        cp_async16(dst, ok ? src : w, ok ? 16 : 0);
      } else {
        for (int e = 0; e < 16; ++e) dst[e] = (j < half && col + e < N) ? src[e] : 0;
      }
    }
  };

  // the raw packed stage of chunk c -> unpacked tile c % 2; thread u takes
  // packed rows 4uq..4uq+3 and columns 8uc..8uc+7
  auto unpack = [&](int c) {
    const uint8_t* wr = wr0 + (c % kPStages) * kPW;
    uint32_t* wu = reinterpret_cast<uint32_t*>(wu0 + (c & 1) * kPU);
    for (int u = tid; u < 256; u += kPThreads) {
      const int uc = 8 * ((u >> 5) & 1) + (u & 7), uq = 4 * (u >> 6) + ((u & 31) >> 3);
      const uint8_t* src = wr + 4 * uq * kPLD + 8 * uc;
      uint2 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = *reinterpret_cast<const uint2*>(src + r * kPLD);
#define UNPACK_COL(E)                                                     \
      {                                                                   \
        const uint32_t b = gather<E>(v);                                  \
        const int col = 8 * uc + E;                                       \
        wu[wsu_word(col, uq)] = sext4(b & 0x0F0F0F0Fu);                   \
        wu[wsu_word(col, 16 + uq)] = sext4((b >> 4) & 0x0F0F0F0Fu);       \
      }
      UNPACK_COL(0) UNPACK_COL(1) UNPACK_COL(2) UNPACK_COL(3)
      UNPACK_COL(4) UNPACK_COL(5) UNPACK_COL(6) UNPACK_COL(7)
#undef UNPACK_COL
    }
  };

  int acc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = 0;
        facc[mt][nt][e] = 0.f;
      }

#pragma unroll
  for (int st = 0; st < kPStages - 1; ++st) {
    if (st < n_chunks) load(st, st);
    cp_async_commit();
  }
  cp_async_wait<kPStages - 2>();  // chunk 0
  __syncthreads();
  unpack(0);

  float sc[4][2];  // this group's scales of this thread's columns
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kPStages - 3>();  // this thread's copies of chunk c + 1 have landed
    __syncthreads();                // everyone's; tile c % 2 is unpacked; chunk c-1 is done
    if (c + kPStages - 1 < n_chunks) load(c + kPStages - 1, (c + kPStages - 1) % kPStages);
    cp_async_commit();
    if (c % cpg == 0) {
      const int g = c / cpg;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + 32 * wn + 8 * nt + 2 * tig;
        sc[nt][0] = col < N ? __ldg(scale + (size_t)g * N + col) : 0.f;
        sc[nt][1] = col + 1 < N ? __ldg(scale + (size_t)g * N + col + 1) : 0.f;
      }
    }
    if (c + 1 < n_chunks) unpack(c + 1);  // into the other tile, beside this chunk's products

    const uint8_t* xs = xs0 + (c % kPStages) * kPX;
    const uint32_t* wu = reinterpret_cast<const uint32_t*>(wu0 + (c & 1) * kPU);
#pragma unroll
    for (int s = 0; s < kPK / 32; ++s) {  // k32 steps
      // B fragments of two n8 tiles per ldmatrix.x4: matrix m holds columns
      // 8 * (2np + m / 2).. and k bytes 32s + 16 * (m % 2)..
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int m = lane >> 3;
        const int col = 32 * wn + 8 * (2 * np + (m >> 1)) + (lane & 7);
        uint32_t r[4];
        ldsm_x4(r, wu + wsu_word(col, 8 * s + 4 * (m & 1)));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, xs + (64 * wm + 16 * mt + (lane & 15)) * kPLD + 32 * s + 16 * (lane >> 4));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }

    if ((c + 1) % cpg == 0) {  // the group is complete: fold its scale, in group order
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[mt][nt][e] = __fadd_rn(facc[mt][nt][e],
                                        __fmul_rn((float)acc[mt][nt][e], sc[nt][e & 1]));
            acc[mt][nt][e] = 0;
          }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + 64 * wm + 16 * mt + gid + 8 * h;
      if (t >= T) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        epi.store2(t, n0 + 32 * wn + 8 * nt + 2 * tig, facc[mt][nt][2 * h],
                   facc[mt][nt][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// per-token activation quantization: one block a row
// ---------------------------------------------------------------------------

constexpr int kQThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive values: two 16-byte loads (fp32) or one (bf16)
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t quant(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(r)));
}

// vec: K % 8 == 0, x 16-byte and q 8-byte aligned
template <typename In>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const In* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                int K, int vec) {
  __shared__ float red[kQThreads / 32];
  const In* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = q + (size_t)blockIdx.x * K;
  const int tid = threadIdx.x;
  float m = 0.f;
  if (vec) {
    for (int i = 8 * tid; i < K; i += 8 * kQThreads) {
      float v[8];
      load8(xr + i, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
    }
  } else {
    for (int i = tid; i < K; i += kQThreads) m = fmaxf(m, fabsf(to_float(xr[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < kQThreads / 32; ++i) m = fmaxf(m, red[i]);
  const float s = fmaxf(__fdiv_rn(m, 127.f), 1e-8f);
  if (tid == 0) scale[blockIdx.x] = s;
  if (vec) {
    for (int i = 8 * tid; i < K; i += 8 * kQThreads) {
      float v[8];
      load8(xr + i, v);
      uint2 o;
      o.x = quant(v[0], s) | quant(v[1], s) << 8 | quant(v[2], s) << 16 | quant(v[3], s) << 24;
      o.y = quant(v[4], s) | quant(v[5], s) << 8 | quant(v[6], s) << 16 | quant(v[7], s) << 24;
      *reinterpret_cast<uint2*>(qr + i) = o;
    }
  } else {
    for (int i = tid; i < K; i += kQThreads)
      qr[i] = static_cast<int8_t>(quant(to_float(xr[i]), s));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <bool SPLIT>
int launch_decode(const void* x, const void* w, const void* scale, float* part,
                  const Epilogue& epi, int T, int K, int N, int group, cudaStream_t stream) {
  // word loads of activations where every (row, half-group) run starts on 4 bytes;
  // 8-byte loads of packed rows where every row starts on 8 bytes
  const int x_words = K % 4 == 0 && (group / 2) % 4 == 0 && (uintptr_t)x % 4 == 0;
  const int w_vec = N % 8 == 0 && (uintptr_t)w % 8 == 0;
  dim3 grid((epi.n + kBN - 1) / kBN, SPLIT ? K / group : 1);  // tiles holding a stored column
  w4a8_decode_kernel<SPLIT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), part, epi, T, K, N, group, x_words, w_vec);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_prefill(const void* x, const void* w, const void* scale, const Epilogue& epi, int T,
                   int K, int N, int group, cudaStream_t stream) {
  auto kern = w4a8_prefill_kernel<VEC>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kPSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((epi.n + kPN - 1) / kPN, (T + kPM - 1) / kPM);
  kern<<<grid, kPThreads, kPSmem, stream>>>(static_cast<const int8_t*>(x),
                                            static_cast<const uint8_t*>(w),
                                            static_cast<const float*>(scale), epi, T, K, N,
                                            group);
  return (int)cudaGetLastError();
}

// The product through the route the shapes and `scratch` pick, stored by epi.
int launch_product(const void* x, const void* packed, const void* scale, const Epilogue& epi,
                   void* scratch, int T, int K, int N, int group, cudaStream_t s) {
  if (T < 1 || N < 1 || K < 1 || group < 2 || group % 2 || K % group || epi.n < 1 ||
      epi.n > N)
    return (int)cudaErrorInvalidValue;
  if (scratch != nullptr) {
    if (T > 16 || K / group > 65535) return (int)cudaErrorInvalidValue;
    float* part = static_cast<float*>(scratch);
    const int rc = launch_decode<true>(x, packed, scale, part, epi, T, K, N, group, s);
    if (rc != 0) return rc;
    const int total = T * ((epi.n + 1) / 2);
    w4a8_fold_kernel<<<(total + 255) / 256, 256, 0, s>>>(part, epi, T, K / group);
    return (int)cudaGetLastError();
  }
  if (T <= 16) return launch_decode<false>(x, packed, scale, nullptr, epi, T, K, N, group, s);
  if ((T + kPM - 1) / kPM > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte copies where every activation run and packed row starts on 16 bytes
  const bool vec = K % 16 == 0 && (group / 2) % 16 == 0 && N % 16 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)packed % 16 == 0;
  return vec ? launch_prefill<true>(x, packed, scale, epi, T, K, N, group, s)
             : launch_prefill<false>(x, packed, scale, epi, T, K, N, group, s);
}

}  // namespace

// out [T, n] in out_dtype (0 fp32, 1 bf16) = product * act_scale[t] + bias[c];
// act_scale [T] fp32; bias [n] in bias_dtype; scratch: null, or [K / group, T, n]
// fp32 for the split over groups (T <= 16).
extern "C" int w4a8_dense_launch(const void* x, const void* packed, const void* scale,
                                 const void* act_scale, const void* bias, int bias_dtype,
                                 void* out, int out_dtype, void* scratch, int T, int K, int N,
                                 int n, int group, void* stream) {
  if ((bias_dtype != 0 && bias_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Epilogue epi{static_cast<const float*>(act_scale), bias, out, n, bias_dtype, out_dtype,
                     n % 2 == 0 && (uintptr_t)out % 8 == 0};
  return launch_product(x, packed, scale, epi, scratch, T, K, N, group,
                        static_cast<cudaStream_t>(stream));
}

// x [T, K] in dtype (0 fp32, 1 bf16) -> x_int8 [T, K], act_scale [T] fp32.
extern "C" int quantize_activations_launch(int dtype, const void* x, void* x_int8,
                                           void* act_scale, int T, int K, void* stream) {
  if (T < 1 || K < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int vec = K % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)x_int8 % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(x_int8);
  float* sc = static_cast<float*>(act_scale);
  if (dtype == 1)
    quantize_kernel<__nv_bfloat16><<<T, kQThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), q, sc, K, vec);
  else
    quantize_kernel<float><<<T, kQThreads, 0, s>>>(static_cast<const float*>(x), q, sc, K, vec);
  return (int)cudaGetLastError();
}
