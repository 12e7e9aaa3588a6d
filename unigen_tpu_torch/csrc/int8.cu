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
// The same launch ends the row-parallel W4A8 layer under tensor parallelism
// (ops/int4.py:dense_int4_row): there acc is the fp32 sum over the model
// ranks of kernel 4's partial products and there is no weight scale,
//     y[m, c] = acc[m, c] * act_scale[m] (+ float(bias[c])),
//   kernel 4's own epilogue (unigen_tpu/ops/int4.py:dense_int4_prequant),
//   run once after the sum.
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

// BIAS: 0 none, 1 fp32, 2 bf16. An int32 sum is scaled by act and sc; an fp32
// one (the W4A8 partials) by act alone.
template <int BIAS>
__device__ __forceinline__ float add_bias(float y, const void* bias, int c) {
  if (BIAS == 1) y = __fadd_rn(y, static_cast<const float*>(bias)[c]);
  if (BIAS == 2) y = __fadd_rn(y, __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[c]));
  return y;
}
template <int BIAS>
__device__ __forceinline__ float apply(int32_t a, float act, float sc, const void* bias, int c) {
  return add_bias<BIAS>(__fmul_rn(__fmul_rn(__int2float_rn(a), act), sc), bias, c);
}
template <int BIAS>
__device__ __forceinline__ float apply(float a, float act, float, const void* bias, int c) {
  return add_bias<BIAS>(__fmul_rn(a, act), bias, c);
}

// 4 sums and 4 scales (none for an fp32 sum), one 16-byte load each
__device__ __forceinline__ void load4(const int32_t* a, const float* sc, int32_t* v, float* s) {
  const int4 x = __ldg(reinterpret_cast<const int4*>(a));
  const float4 y = __ldg(reinterpret_cast<const float4*>(sc));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  s[0] = y.x; s[1] = y.y; s[2] = y.z; s[3] = y.w;
}
__device__ __forceinline__ void load4(const float* a, const float*, float* v, float* s) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(a));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  s[0] = s[1] = s[2] = s[3] = 1.f;
}
__device__ __forceinline__ float scale_at(const int32_t*, const float* sc, int c) { return sc[c]; }
__device__ __forceinline__ float scale_at(const float*, const float*, int) { return 1.f; }

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

template <typename Acc, typename Out, int BIAS, bool VEC>
__global__ void __launch_bounds__(kThreads)
w8a8_epilogue_kernel(const Acc* __restrict__ acc, const float* __restrict__ act_scale,
                     const float* __restrict__ scale, const void* __restrict__ bias,
                     Out* __restrict__ out, int M, int n, int ld) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (c0 >= n) return;
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const Acc* a = acc + (size_t)m * ld;
    Out* o = out + (size_t)m * n;
    const float act = act_scale[m];
    if (VEC && c0 + kCols <= n) {
      Acc v[kCols];
      float s[kCols];
      load4(a + c0, scale + c0, v, s);
      float y[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) y[i] = apply<BIAS>(v[i], act, s[i], bias, c0 + i);
      store4(o + c0, y);
    } else {
      const int end = min(c0 + kCols, n);
      for (int c = c0; c < end; ++c)
        store1(o + c, apply<BIAS>(a[c], act, scale_at(a, scale, c), bias, c));
    }
  }
}

template <typename Acc, typename Out, int BIAS>
int launch(const void* acc, const void* act_scale, const void* scale, const void* bias,
           void* out, int M, int n, int ld, bool vec, cudaStream_t s) {
  const dim3 grid((n + kThreads * kCols - 1) / (kThreads * kCols),
                  M < kMaxRowsGrid ? M : kMaxRowsGrid);
  const Acc* a = static_cast<const Acc*>(acc);
  const float* act = static_cast<const float*>(act_scale);
  const float* sc = static_cast<const float*>(scale);
  Out* o = static_cast<Out*>(out);
  if (vec)
    w8a8_epilogue_kernel<Acc, Out, BIAS, true><<<grid, kThreads, 0, s>>>(a, act, sc, bias, o, M,
                                                                           n, ld);
  else
    w8a8_epilogue_kernel<Acc, Out, BIAS, false><<<grid, kThreads, 0, s>>>(a, act, sc, bias, o,
                                                                            M, n, ld);
  return (int)cudaGetLastError();
}

template <typename Acc, typename Out>
int launch_out(const void* acc, const void* act_scale, const void* scale, const void* bias,
               int bias_dtype, void* out, int M, int n, int ld, bool vec, cudaStream_t s) {
  if (bias == nullptr)
    return launch<Acc, Out, 0>(acc, act_scale, scale, bias, out, M, n, ld, vec, s);
  if (bias_dtype == 0)
    return launch<Acc, Out, 1>(acc, act_scale, scale, bias, out, M, n, ld, vec, s);
  return launch<Acc, Out, 2>(acc, act_scale, scale, bias, out, M, n, ld, vec, s);
}

template <typename Acc>
int launch_acc(const void* acc, const void* act_scale, const void* scale, const void* bias,
               int bias_dtype, void* out, int out_dtype, int M, int n, int ld, bool vec,
               cudaStream_t s) {
  if (out_dtype == 1)
    return launch_out<Acc, __nv_bfloat16>(acc, act_scale, scale, bias, bias_dtype, out, M, n,
                                          ld, vec, s);
  return launch_out<Acc, float>(acc, act_scale, scale, bias, bias_dtype, out, M, n, ld, vec, s);
}

}  // namespace

// out [M, n] in out_dtype (0 fp32, 1 bf16) = float(acc[m, c]) * act_scale[m] * scale[c]
// (+ bias[c]) for an int32 acc (acc_dtype 0), acc[m, c] * act_scale[m] (+ bias[c]) for an
// fp32 one (acc_dtype 1, scale null); acc [M, ld] row-major, ld >= n; act_scale [M] and
// scale [n] fp32; bias null or [n] in bias_dtype (0 fp32, 1 bf16).
extern "C" int w8a8_epilogue_launch(const void* acc, int acc_dtype, const void* act_scale,
                                    const void* scale, const void* bias, int bias_dtype,
                                    void* out, int out_dtype, int M, int n, int ld,
                                    void* stream) {
  if (M < 1 || n < 1 || ld < n || (out_dtype != 0 && out_dtype != 1) ||
      (bias != nullptr && bias_dtype != 0 && bias_dtype != 1) ||
      (acc_dtype == 0) != (scale != nullptr) || (acc_dtype != 0 && acc_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t out_vec = out_dtype == 1 ? 8 : 16;
  const bool vec = ld % kCols == 0 && n % kCols == 0 && (uintptr_t)acc % 16 == 0 &&
                   (uintptr_t)scale % 16 == 0 && (uintptr_t)out % out_vec == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_dtype == 1)
    return launch_acc<float>(acc, act_scale, scale, bias, bias_dtype, out, out_dtype, M, n, ld,
                             vec, s);
  return launch_acc<int32_t>(acc, act_scale, scale, bias, bias_dtype, out, out_dtype, M, n, ld,
                             vec, s);
}
