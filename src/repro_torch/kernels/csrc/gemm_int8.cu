// int8 GeMM for Hopper (sm_90a) on the tensor cores with an int32
// accumulator.  One kernel, three kinds of A:
//   - int8 codes with row scales: the dequant GeMM C = (float(A @ B) * sa) * sb,
//     written in f32 or bf16 (K3);
//   - int8 codes without scales: C = A @ B written as int32 (K1's int mode);
//   - float rows (f32 or bf16), quantized to int8 inside the kernel, then as
//     K3: the w8a8 GeMM, one launch where the reference runs two kernels.
//
// Replaces the Pallas TPU kernels repro/kernels/gemm.py::_dequant_gemm_kernel
// (built by make_dequant_gemm), the int8 x int8 -> int32 mode of _gemm_kernel
// (make_gemm on int8 operands), and, on the w8a8 path, their composition with
// repro/kernels/quant.py::_quant_kernel in make_w8a8_gemm (the paper's
// P_A = P_B = 8, P_C = 32 datapath with the deployment scales).  The TPU
// kernels' sequential K grid axis with a VMEM accumulator becomes a K loop
// inside the block with the int32 accumulator in registers.
//
// What bounds it on the H100: at decode (M = slots <= 8) every launch reads
// all of B once and does 2 * M int8 operations per weight byte, far below
// the ~590 op/byte ridge of 1979 TOP/s int8 over 3.35 TB/s, so the bound is
// B's bytes (the tied head, 1152 x 262144 int8, is 302 MB per step); the
// 182 projections of a step are small enough that a launch's latency, not
// bandwidth, sets their pace.
//
// What the design does about it: the body, the stage layout, the launch
// plan and the split-K fix-up are K1's (gemm_mma.cuh, kernels/gemm.py), on
// s8 mma.sync m16n8k32: weights K-major (QuantTensor.q is the .t() view of
// an (N, K) store), two stages in flight, the weight rows on the mma's
// 16-row side at M <= 16, and split K summed by the tile's last block inside
// the launch, so one GeMM is one launch and allocates only its output.  The
// dequant epilogue runs once, on the summed int32 value, rounded once.
//
// The fused row quantization (the w8a8 modes).  A block first fixes its
// rows' scales while its first two stages' copies are in flight: dynamic,
// it reads its rows whole (an L2-resident re-read of at most ROWS x K
// floats) for the absmax, s = max(absmax, 1e-8) * f32(1/127) as in quant.cu;
// static, it reads the one calibrated scale from the device.  Each stage
// copies the floats of its K range into a staging buffer of its own
// (cp.async, beside B's copies), and once they land the block writes their
// codes, clip(rint(x / s), +-127), into the stage's A tile before its
// product, with the next stage's copies in flight.  Every split of a tile
// computes the same rows' scales, so the block that sums the splits applies
// its own.  Codes, integer sums and the epilogue's order are fixed, so the
// result equals the plain composition bit for bit: x / s is an IEEE
// division (nvcc's default -prec-div=true, no fast math) and rintf rounds
// half to even as torch.round does.

#include "gemm_mma.cuh"

namespace {

using namespace gemm_body;

enum Mode { CODES = 0, DYNAMIC = 1, STATIC = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// |x| of 16 bytes of X, the largest (exact: no rounding anywhere).
__device__ __forceinline__ float absmax16(uint4 v, float) {
  return fmaxf(fmaxf(fabsf(__uint_as_float(v.x)), fabsf(__uint_as_float(v.y))),
               fmaxf(fabsf(__uint_as_float(v.z)), fabsf(__uint_as_float(v.w))));
}
__device__ __forceinline__ float absmax16(uint4 v, bf16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)   // bf16 -> f32 is a 16-bit shift
    m = fmaxf(m, fmaxf(fabsf(__uint_as_float(w[i] << 16)),
                       fabsf(__uint_as_float(w[i] & 0xffff0000u))));
  return m;
}

// The float staging of one stage of A: ROWS rows of 128 values, each row
// padded by one 16-byte chunk (one buffer per stage in flight).
template <typename X, int ROWS>
struct XStage {
  static constexpr int CE = 16 / sizeof(X);
  static constexpr int LD = K_BYTES + CE;
  static constexpr size_t BYTES = (size_t)ROWS * LD * sizeof(X);
};

// srow[r] = the scale of row m0 + r, max(absmax, 1e-8) * f32(1/127) over the
// row's whole K (quant.cu's arithmetic).  The live rows share the NT
// threads, each thread's 16-byte loads issued 8 at a time (predicated, so a
// thread with fewer than 8 has them all in flight at once); each thread's
// maximum merges by an integer atomicMax, exact since non-negative floats
// order as their bit patterns.
template <typename X, int ROWS>
__device__ __forceinline__ void row_scales(const X* x, const Args& p, int m0, float* srow,
                                           unsigned* smax) {
  constexpr int CE = 16 / sizeof(X), LOADS = 8;
  const int rows = min(ROWS, p.M - m0), tid = threadIdx.x;
  if (tid < ROWS) smax[tid] = 0u;
  __syncthreads();
  const int tpr = NT / rows, r = tid / tpr, lane = tid % tpr;
  if (r < rows) {
    const X* xr = x + (m0 + r) * p.sam;
    const int chunks = p.K / CE;
    float amax = 0.f;
    for (int c0 = lane; c0 < chunks; c0 += LOADS * tpr) {
      uint4 v[LOADS];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int c = c0 + i * tpr;
        v[i] = c < chunks ? __ldg(reinterpret_cast<const uint4*>(xr + c * CE))
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i) amax = fmaxf(amax, absmax16(v[i], X()));
    }
    for (int k = chunks * CE + lane; k < p.K; k += tpr) amax = fmaxf(amax, fabsf(to_f(xr[k])));
    atomicMax(smax + r, __float_as_uint(amax));
  }
  __syncthreads();
  if (tid < ROWS)
    srow[tid] = tid < rows ? fmaxf(__uint_as_float(smax[tid]), 1e-8f) * (1.f / 127.f) : 1.f;
}

// Copy the floats of the stage starting at K index k0 into the staging
// buffer (no commit); rows past M and K past K are zero-filled.
template <typename X, int ROWS>
__device__ __forceinline__ void issue_x(X* xs, const Args& p, int m0, int k0) {
  using XS = XStage<X, ROWS>;
  constexpr int CE = XS::CE, KC = K_BYTES / CE;
  const X* x = static_cast<const X*>(p.a);
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * KC; e += NT) {
    const int r = e / KC, kc = (e % KC) * CE;
    const int m = m0 + r, k = k0 + kc;
    const int valid = (m < p.M) ? max(0, min(CE, p.K - k)) : 0;
    const X* src = valid ? x + m * p.sam + k : x;
    cp_async16(xs + r * XS::LD + kc, src, valid * (int)sizeof(X));
  }
}

__device__ __forceinline__ void load4(const float* s, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* s, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(s);
  v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// Write the codes of the staged floats into the stage's A tile, 4 a thread
// at a time: clip(rint(x / s_row), +-127).  Zero-filled floats give code 0;
// the tile's rows past M (`rows` live) are written as zeros without the
// division, whose slow path a zero dividend would take.  A warp covers one
// row (32 x 4 values), so the branch does not diverge.
template <typename X, class S>
__device__ __forceinline__ void quantize_stage(int8_t* as, const X* xs, const float* srow,
                                               int rows) {
  using XS = XStage<X, S::ROWS>;
  constexpr int PER_ROW = K_BYTES / 4;
#pragma unroll
  for (int e = threadIdx.x; e < S::ROWS * PER_ROW; e += NT) {
    const int r = e / PER_ROW, kc = (e % PER_ROW) * 4;
    if (r >= rows) {
      *reinterpret_cast<unsigned*>(as + r * S::LDA + kc) = 0u;
      continue;
    }
    const float s = srow[r];
    float v[4];
    load4(xs + r * XS::LD + kc, v);
    unsigned w = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = static_cast<int>(fminf(fmaxf(rintf(v[i] / s), -127.f), 127.f));
      w |= static_cast<unsigned>(q & 0xff) << (8 * i);
    }
    *reinterpret_cast<unsigned*>(as + r * S::LDA + kc) = w;
  }
}

// One output tile over the split's K stages, two stages in flight (a slot
// each): stage t + 1's copies run during stage t's quantization and
// product, and stage t + 2's start once stage t's slot is free.
template <typename X, class Body, int MODE>
__global__ void __launch_bounds__(NT, 2) s8_kernel(const Args p) {
  using S = typename Body::S;
  using XS = XStage<X, Body::ROWS>;
  constexpr int ROWS = Body::ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);
  X* xs = reinterpret_cast<X*>(smem_raw + 2 * S::ELEMS);   // float A only: 2 buffers
  __shared__ float srow[ROWS];
  __shared__ unsigned smax[ROWS];
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * BN;
  const int k_steps = (p.K + S::BK - 1) / S::BK;
  const int ks0 = blockIdx.z * p.kps;
  const int n_local = max(0, min(k_steps, ks0 + p.kps) - ks0);

  // Stage t into slot t & 1; every call commits one group, empty or not,
  // so group t always holds stage t.
  auto issue = [&](int t) {
    if (t < n_local) {
      int8_t* slot = smem + (t & 1) * S::ELEMS;
      const int k0 = (ks0 + t) * S::BK;
      if constexpr (MODE == CODES) issue_a<int8_t, S>(slot, p, m0, k0);
      else issue_x<X, ROWS>(xs + (t & 1) * (XS::BYTES / sizeof(X)), p, m0, k0);
      issue_b<int8_t, S>(slot, p, n0, k0);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  if constexpr (MODE == DYNAMIC) row_scales<X, ROWS>(static_cast<const X*>(p.a), p, m0, srow, smax);
  if constexpr (MODE == STATIC) {
    if (threadIdx.x < ROWS) srow[threadIdx.x] = __ldg(p.sa);
  }

  Body body;
  body.zero();
  for (int t = 0; t < n_local; ++t) {
    int8_t* slot = smem + (t & 1) * S::ELEMS;
    cp_async_wait<1>();         // stage t landed; stage t + 1 may be in flight
    __syncthreads();            // ... for every thread (and the scales are written)
    if constexpr (MODE != CODES) {
      quantize_stage<X, S>(slot, xs + (t & 1) * (XS::BYTES / sizeof(X)), srow,
                           min(ROWS, p.M - m0));
      __syncthreads();
    }
    body.step(slot);
    __syncthreads();            // every thread is done with slot t & 1
    issue(t + 2);
  }
  cp_async_wait<0>();
  if constexpr (MODE == CODES) {
    if (p.out_code == 2) {
      finish<int>(body, p, m0, n0);
    } else {
      finish<int>(body, p, m0, n0, [&](long long off, int m, int n, int v) {
        store(p.c, p.out_code, off, ((float)v * __ldg(p.sa + m)) * __ldg(p.sb + n));
      });
    }
  } else {
    finish<int>(body, p, m0, n0, [&](long long off, int m, int n, int v) {
      store(p.c, p.out_code, off, ((float)v * srow[m - m0]) * __ldg(p.sb + n));
    });
  }
}

template <typename X, int MODE>
int launch_mode(const Args& p, bool swap, cudaStream_t st) {
  return with_imma_body(swap, p.M, [&](auto tag) {
    using Body = typename decltype(tag)::type;
    constexpr size_t extra = MODE == CODES ? 0 : 2 * XStage<X, Body::ROWS>::BYTES;
    return launch<int8_t, 2, Body, s8_kernel<X, Body, MODE>, extra>(p, st);
  });
}

}  // namespace

// a: (M, K), unit K stride, row stride sam, every row 16-byte aligned:
// int8 codes (a_code 2) or float rows to quantize in the kernel (a_code 0 =
// float32, 1 = bfloat16).  b: (K, N) int8, K-major: (k, n) at b[n * sbn + k],
// every column 16-byte aligned.  sa: with codes, the row scales (M,)
// float32, or null for the int mode (out_code 2: int32 C, sb unused); with
// float rows, null for per-row scales computed in the kernel (dynamic) or
// the static scale (one float32, read on the device).  sb: the column scales
// (N,) float32.  C (M, N) contiguous, out_code 0 = float32, 1 = bfloat16, 2 =
// int32.  swap, kps and splits come from the launch plan
// (kernels/gemm.py::gemm_plan at 1-byte elements); with splits > 1, `ws`
// holds (splits, M, N) int32 and `counters` one zeroed int per output tile.
// Returns the launch's cudaError_t (0 = success).
extern "C" int gemm_int8_launch(const void* a, const void* b, const void* sa,
                                const void* sb, void* c, void* ws, int* counters, int M,
                                int N, int K, long long sam, long long sbn, int a_code,
                                int out_code, int swap, int kps, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args p{a, b, c, ws, counters, M, N, K, sam, 1, sbn, kps, splits, out_code,
               static_cast<const float*>(sa), static_cast<const float*>(sb)};
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (a_code == 2) {
    if (out_code < 0 || out_code > 2 || (out_code == 2) != (sa == nullptr)) return invalid;
    return launch_mode<int8_t, CODES>(p, swap != 0, st);
  }
  if (out_code != 0 && out_code != 1) return invalid;
  if (a_code == 0)
    return sa ? launch_mode<float, STATIC>(p, swap != 0, st)
              : launch_mode<float, DYNAMIC>(p, swap != 0, st);
  if (a_code == 1)
    return sa ? launch_mode<bf16, STATIC>(p, swap != 0, st)
              : launch_mode<bf16, DYNAMIC>(p, swap != 0, st);
  return invalid;
}
