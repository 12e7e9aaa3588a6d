// W4A8 matrix product for Hopper (sm_90a): int8 activations times int4-packed
// weights, group scales folded in fp32.
//
// w4a8_matmul_launch replaces the TPU kernel
//   unigen_tpu/ops/int4.py:w4a8_matmul (body _w4a8_kernel):
//     out[t, n] = sum over groups g, in order, of
//                 float(sum_{k in group g} x[t, k] * w4[k, n]) * scale4[g, n]
//   x [T, K] int8; packed [K/2, N] int8 where, inside each group of `group`
//   rows, byte j holds row j in its low nibble and row j + group/2 in its
//   high nibble (lo = (int8)(b << 4) >> 4, hi = b >> 4, arithmetic);
//   scale4 [K/group, N] fp32; out [T, N] fp32. The layout is taken as it is:
//   no relayout at load time.
//
// Exactness. A group's products are summed exactly in int32 (|sum| <=
// group * 127 * 7, below 2^24, so its fp32 conversion is exact too), and the
// fold acc = acc + part * scale uses __fmul_rn / __fadd_rn (no fused
// multiply-add) group by group: the result equals the plain PyTorch version
// (ops/int4.py:w4a8_matmul_plain) and the JAX kernel bit for bit.
//
// Bound on this card. At decode (T = 8) the product reads K*N/2 bytes of
// weights for 2*T*K*N operations: memory-bound (gate 1536 -> 8960: 6.9 MB,
// ~2 us at 3.35 TB/s; the 160k-wide head: 123 MB, ~37 us). At the prefill
// (T ~ 6,300) it is bound by the int8 tensor-core rate (gate: 174 G ops,
// ~88 us at 1,979 TOP/s), and its fp32 output is as large again in bytes.
//
// Design (simple and right first). A block of 4 warps owns 64 output columns
// and 16 (T <= 16) or 64 rows. It walks the groups in order, in chunks of 64
// packed rows (64 low-nibble and 64 high-nibble k values; a group with fewer
// rows is zero-filled, which adds nothing). Each chunk's packed tile is read
// from device memory with 8-byte loads, unpacked to int8 in registers (four
// rows' nibbles per 32-bit word, sign-extended with per-byte SIMD) and stored
// k-contiguous in shared memory, so that mma.sync m16n8k32 s8 x s8 -> s32
// takes its B fragments with 32-bit loads. Activations follow the same
// (low half, high half) order of k. The next chunk's loads go into registers
// before the current chunk's products, which hides part of the memory
// latency. For decode this keeps only the packed bytes on the device
// memory bus (the unpacked weights live in shared memory only); for the
// prefill mma.sync reaches part of the int8 rate, and wgmma with a TMA ring
// and a fused epilogue (activation scale, bias, cast) are the next steps.
//
// Split over groups (T <= 16, when the caller passes a scratch buffer). At
// decode a layer with few 64-column tiles (q/o/down: 24, gate/up: 144) gives
// one or two blocks per SM, each walking every group with one chunk in
// flight: far too few bytes in flight to approach the memory rate. Then
// each block takes one (column tile, group) pair and writes its group's
// scaled part, __fmul_rn(float(part), scale), to scratch [G, T, N]; a
// second small kernel adds the parts in group order with __fadd_rn from 0.
// That is the same sequence of roundings as the fold inside the block, so
// both ways give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 4 warps
constexpr int kBN = 64;             // output columns per block, 16 per warp
constexpr int kRows = 64;           // packed rows per chunk
constexpr int kKW = 2 * kRows / 4;  // 32-bit words of k per row of a chunk (lo, then hi)
constexpr int kLD = kKW + 4;        // padded shared-memory stride in words

// c += a . b: a 16x32 (row), b 32x8 (col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int E>
__device__ __forceinline__ void store_col(uint32_t* ws, const uint2* v, int cc, int rq) {
  const uint32_t b = gather<E>(v);
  uint32_t* dst = ws + (8 * cc + E) * kLD;
  dst[rq] = sext4(b & 0x0F0F0F0Fu);               // rows 4rq..4rq+3 of the low half
  dst[kKW / 2 + rq] = sext4((b >> 4) & 0x0F0F0F0Fu);  // the same rows of the high half
}

// SPLIT: block (column tile, group blockIdx.y) writes its group's scaled part
// to out = scratch [G, T, N]; otherwise the block walks all groups and
// writes out [T, N].
template <int MT, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ out, int T, int K, int N,
            int group, int x_words, int w_vec) {
  constexpr int BT = 16 * MT;                 // rows of T per block
  constexpr int XW = BT * kKW / kThreads;     // activation words each thread stages
  __shared__ uint32_t xs[BT * kLD];           // [BT][k words]
  __shared__ uint32_t ws[kBN * kLD];          // [column][k words]

  const int half = group / 2;
  const int cpg = (half + kRows - 1) / kRows;  // chunks per group
  const int c_begin = SPLIT ? blockIdx.y * cpg : 0;
  const int n_chunks = SPLIT ? c_begin + cpg : (K / group) * cpg;
  const int n0 = blockIdx.x * kBN, t0 = SPLIT ? 0 : blockIdx.y * BT;
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
      const int part = kw / (kKW / 2);              // 0: low half of the group, 1: high
      const int jj = j0 + 4 * (kw % (kKW / 2));
      const int t = t0 + row;
      uint32_t val = 0u;
      if (t < T && jj < half) {
        const int8_t* src = x + (size_t)t * K + (size_t)g * group + part * half + jj;
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

  int acc[MT][2][4];
  float facc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = 0;
        facc[mt][nt][e] = 0.f;
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
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t* bp = ws + (16 * warp + 8 * nt + gid) * kLD + 8 * s + tig;
        b[nt][0] = bp[0];
        b[nt][1] = bp[4];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* ap = xs + (16 * mt + gid) * kLD + 8 * s + tig;
        uint32_t a[4] = {ap[0], ap[8 * kLD], ap[4], ap[8 * kLD + 4]};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
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
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float scaled = __fmul_rn((float)acc[mt][nt][e], (e & 1) ? s1 : s0);
            if (SPLIT) {
              const int t = 16 * mt + gid + 8 * (e >> 1), cl = col + (e & 1);
              if (t < T && cl < N) out[((size_t)g * T + t) * N + cl] = scaled;
            } else {
              facc[mt][nt][e] = __fadd_rn(facc[mt][nt][e], scaled);
            }
            acc[mt][nt][e] = 0;
          }
      }
    }
  }
  if (SPLIT) return;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 16 * mt + gid + 8 * (e >> 1);
        const int col = n0 + 16 * warp + 8 * nt + 2 * tig + (e & 1);
        if (t < T && col < N) out[(size_t)t * N + col] = facc[mt][nt][e];
      }
}

// out[i] = sum over g, in order, of part[g, i] (i over T * N), from 0.
__global__ void w4a8_fold_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int total, int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc = __fadd_rn(acc, part[(size_t)g * total + i]);
  out[i] = acc;
}

template <int MT, bool SPLIT>
int launch_typed(const void* x, const void* w, const void* scale, void* out, int T, int K,
                 int N, int group, int x_words, int w_vec, cudaStream_t stream) {
  constexpr int BT = 16 * MT;
  dim3 grid((N + kBN - 1) / kBN, SPLIT ? K / group : (T + BT - 1) / BT);
  w4a8_kernel<MT, SPLIT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), T, K, N, group, x_words,
      w_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: null, or [K / group, T, N] fp32 for the split over groups (T <= 16).
extern "C" int w4a8_matmul_launch(const void* x, const void* packed, const void* scale,
                                  void* out, void* scratch, int T, int K, int N, int group,
                                  void* stream) {
  if (T < 1 || N < 1 || K < 1 || group < 2 || group % 2 || K % group)
    return (int)cudaErrorInvalidValue;
  if (scratch != nullptr && (T > 16 || K / group > 65535)) return (int)cudaErrorInvalidValue;
  // word loads of activations where every (row, half-group) run starts on 4 bytes;
  // 8-byte loads of packed rows where every row starts on 8 bytes
  const int x_words = K % 4 == 0 && (group / 2) % 4 == 0 && (uintptr_t)x % 4 == 0;
  const int w_vec = N % 8 == 0 && (uintptr_t)packed % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    const int rc =
        launch_typed<1, true>(x, packed, scale, scratch, T, K, N, group, x_words, w_vec, s);
    if (rc != 0) return rc;
    const int total = T * N;
    w4a8_fold_kernel<<<(total + 255) / 256, 256, 0, s>>>(static_cast<const float*>(scratch),
                                                         static_cast<float*>(out), total,
                                                         K / group);
    return (int)cudaGetLastError();
  }
  if (T <= 16)
    return launch_typed<1, false>(x, packed, scale, out, T, K, N, group, x_words, w_vec, s);
  if ((T + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
  return launch_typed<4, false>(x, packed, scale, out, T, K, N, group, x_words, w_vec, s);
}
