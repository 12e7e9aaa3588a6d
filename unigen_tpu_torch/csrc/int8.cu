// The W8A8 dense layer's epilogue for Hopper (sm_90a).
//
// w8a8_epilogue_launch replaces the XLA fusion that ends the JAX package's
//   unigen_tpu/ops/quantization.py:dense_int8_prequant (not a Pallas kernel):
//     y[m, c] = float(acc[m, c]) * act_scale[m] * scale[c] (+ float(bias[c])),
//   rounded once to the output type (fp32 or bf16), for c < n. acc is the
//   int32 product of torch._int_mm, [M, ld] row-major with ld >= n: the
//   weight's rows are padded to a multiple of 8 at quantization, and the
//   columns past n are read by no one.
//
// Exactness. int32 -> fp32 rounds to nearest even (as torch's and XLA's
// casts), then __fmul_rn by act_scale, __fmul_rn by scale and __fadd_rn of
// the bias, in JAX's left-to-right order and with no fused multiply-add, then
// a round-to-nearest-even cast. The result equals
// ops/quantization.py:w8a8_epilogue_plain bit for bit.
//
// Bound on this card: its bytes. It reads acc once (4 bytes a value) and
// writes 2 (bf16) or 4 (fp32) bytes a value; at the t2i gate/up ([2064,
// 8960], bf16 out) that is 111 MB, ~33 us at 3.35 TB/s, where plain torch
// makes four or five fp32 passes over the same [M, n].
//
// Design. One thread takes 4 neighbouring columns of one row; a block of 256
// threads covers 1,024 columns of a row, the grid (ceil(n / 1024), rows),
// walking rows past 65,535 in steps of the grid. Where ld and n are multiples
// of 4 and every pointer is aligned, a thread reads its 4 sums and 4 scales
// with one 16-byte load each and writes its 4 outputs with one 8-byte (bf16)
// or 16-byte (fp32) store; otherwise (the vocabulary's odd n) value by value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // columns a thread
constexpr int kMaxRowsGrid = 65535;

// BIAS: 0 none, 1 fp32, 2 bf16
template <int BIAS>
__device__ __forceinline__ float apply(int32_t a, float act, float sc, const void* bias, int c) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(a), act), sc);
  if (BIAS == 1) y = __fadd_rn(y, static_cast<const float*>(bias)[c]);
  if (BIAS == 2) y = __fadd_rn(y, __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[c]));
  return y;
}

__device__ __forceinline__ void store1(float* o, float y) { *o = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float y) { *o = __float2bfloat16_rn(y); }

__device__ __forceinline__ void store4(float* o, const float* y) {
  *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float* y) {
  const __nv_bfloat162 lo =
      __halves2bfloat162(__float2bfloat16_rn(y[0]), __float2bfloat16_rn(y[1]));
  const __nv_bfloat162 hi =
      __halves2bfloat162(__float2bfloat16_rn(y[2]), __float2bfloat16_rn(y[3]));
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = w;
}

template <typename Out, int BIAS, bool VEC>
__global__ void __launch_bounds__(kThreads)
w8a8_epilogue_kernel(const int32_t* __restrict__ acc, const float* __restrict__ act_scale,
                     const float* __restrict__ scale, const void* __restrict__ bias,
                     Out* __restrict__ out, int M, int n, int ld) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (c0 >= n) return;
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const int32_t* a = acc + (size_t)m * ld;
    Out* o = out + (size_t)m * n;
    const float act = act_scale[m];
    if (VEC && c0 + kCols <= n) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(a + c0));
      const float4 s = __ldg(reinterpret_cast<const float4*>(scale + c0));
      float y[kCols];
      y[0] = apply<BIAS>(v.x, act, s.x, bias, c0);
      y[1] = apply<BIAS>(v.y, act, s.y, bias, c0 + 1);
      y[2] = apply<BIAS>(v.z, act, s.z, bias, c0 + 2);
      y[3] = apply<BIAS>(v.w, act, s.w, bias, c0 + 3);
      store4(o + c0, y);
    } else {
      const int end = min(c0 + kCols, n);
      for (int c = c0; c < end; ++c) store1(o + c, apply<BIAS>(a[c], act, scale[c], bias, c));
    }
  }
}

template <typename Out, int BIAS>
int launch(const void* acc, const void* act_scale, const void* scale, const void* bias,
           void* out, int M, int n, int ld, bool vec, cudaStream_t s) {
  const dim3 grid((n + kThreads * kCols - 1) / (kThreads * kCols),
                  M < kMaxRowsGrid ? M : kMaxRowsGrid);
  const int32_t* a = static_cast<const int32_t*>(acc);
  const float* act = static_cast<const float*>(act_scale);
  const float* sc = static_cast<const float*>(scale);
  Out* o = static_cast<Out*>(out);
  if (vec)
    w8a8_epilogue_kernel<Out, BIAS, true><<<grid, kThreads, 0, s>>>(a, act, sc, bias, o, M, n,
                                                                      ld);
  else
    w8a8_epilogue_kernel<Out, BIAS, false><<<grid, kThreads, 0, s>>>(a, act, sc, bias, o, M, n,
                                                                       ld);
  return (int)cudaGetLastError();
}

template <typename Out>
int launch_out(const void* acc, const void* act_scale, const void* scale, const void* bias,
               int bias_dtype, void* out, int M, int n, int ld, bool vec, cudaStream_t s) {
  if (bias == nullptr) return launch<Out, 0>(acc, act_scale, scale, bias, out, M, n, ld, vec, s);
  if (bias_dtype == 0) return launch<Out, 1>(acc, act_scale, scale, bias, out, M, n, ld, vec, s);
  return launch<Out, 2>(acc, act_scale, scale, bias, out, M, n, ld, vec, s);
}

}  // namespace

// out [M, n] in out_dtype (0 fp32, 1 bf16) = float(acc[m, c]) * act_scale[m] * scale[c]
// (+ bias[c]); acc [M, ld] int32 row-major, ld >= n; act_scale [M] and scale [n] fp32;
// bias null or [n] in bias_dtype (0 fp32, 1 bf16).
extern "C" int w8a8_epilogue_launch(const void* acc, const void* act_scale, const void* scale,
                                    const void* bias, int bias_dtype, void* out, int out_dtype,
                                    int M, int n, int ld, void* stream) {
  if (M < 1 || n < 1 || ld < n || (out_dtype != 0 && out_dtype != 1) ||
      (bias != nullptr && bias_dtype != 0 && bias_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t out_vec = out_dtype == 1 ? 8 : 16;
  const bool vec = ld % kCols == 0 && n % kCols == 0 && (uintptr_t)acc % 16 == 0 &&
                   (uintptr_t)scale % 16 == 0 && (uintptr_t)out % out_vec == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return launch_out<__nv_bfloat16>(acc, act_scale, scale, bias, bias_dtype, out, M, n, ld, vec,
                                     s);
  return launch_out<float>(acc, act_scale, scale, bias, bias_dtype, out, M, n, ld, vec, s);
}
