// Per-row symmetric int8 quantization for Hopper (sm_90a): x (M, K) float32
// or bf16 -> q (M, K) int8 and scale (M,) float32, with
// scale = max(absmax, 1e-8) * f32(1/127) and
// q = clip(round_half_even(x / scale), +-127).  The reciprocal multiply is
// what the reference's kernel computes as XLA compiles it (a division by a
// constant becomes a multiply by its reciprocal).  With a static scale (one
// float32 on the device: calibrated w8a8) every row takes it as its scale,
// with no absmax: the reference's static branch (repro/kernels/ops.py,
// gemm_w8a8), there plain jnp.
//
// Replaces the Pallas TPU kernel repro/kernels/quant.py::_quant_kernel
// (entry quantize_rows, and the activation half of make_w8a8_gemm).  The TPU
// kernel holds a (block_m, K) tile in VMEM and pads ragged M to the block
// grid; here one block of threads owns one row, so ragged M needs no
// padding and no row is ever computed that the caller does not want.
//
// What bounds it on the H100: bytes (read K floats, write K codes), a few KB
// per row at the serving shapes; with M = 8 a launch is a few microseconds of
// launch latency, not bandwidth.  What the design does about it: coalesced
// loads; on the w8a8 path at M <= 16 (decode) the int8 GeMM runs this
// arithmetic in its own prologue (gemm_int8.cu) and this launch goes away.
// Above 16 rows it stays: each of the GeMM's N / 128 column blocks would
// quantize the same rows again.
//
// Bit-exact with the plain version: the absmax is exact whatever the order,
// 1/127 folds to the correctly rounded float, the division x / scale is IEEE
// (nvcc's default -prec-div=true, no fast math), and
// rintf rounds half to even as torch.round and jnp.round do (roundf would
// round half away from zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block (one row)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(NT) quant_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
    const float* __restrict__ static_scale, int K, long long sxm) {
  __shared__ float warp_max[NT / 32];
  const int row = blockIdx.x;
  const T* xr = x + row * sxm;
  int8_t* qr = q + (long long)row * K;

  float s;
  if (static_scale != nullptr) {
    s = __ldg(static_scale);
  } else {
    float amax = 0.f;
    for (int k = threadIdx.x; k < K; k += NT) amax = fmaxf(amax, fabsf(to_f(xr[k])));
    for (int off = 16; off > 0; off /= 2)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
    __syncthreads();
    amax = warp_max[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) amax = fmaxf(amax, warp_max[w]);
    s = fmaxf(amax, 1e-8f) * (1.f / 127.f);
  }
  for (int k = threadIdx.x; k < K; k += NT) {
    const float v = rintf(to_f(xr[k]) / s);
    qr[k] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
  if (threadIdx.x == 0) scale[row] = s;
}

}  // namespace

// x (M, K) with row stride sxm (elements; unit column stride), dtype_code
// 0 = float32, 1 = bfloat16; q (M, K) int8 contiguous; scale (M,) float32;
// static_scale null (per-row scales) or one float32 every row takes.
// Returns the launch's cudaError_t (0 = success).
extern "C" int quantize_rows_launch(const void* x, void* q, void* scale,
                                    const void* static_scale, int M, int K,
                                    long long sxm, int dtype_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* tq = static_cast<int8_t*>(q);
  float* ts = static_cast<float*>(scale);
  const float* ss = static_cast<const float*>(static_scale);
  if (dtype_code == 0)
    quant_rows_kernel<float><<<M, NT, 0, st>>>(static_cast<const float*>(x), tq, ts, ss, K,
                                               sxm);
  else if (dtype_code == 1)
    quant_rows_kernel<__nv_bfloat16><<<M, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), tq, ts, ss, K, sxm);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
