// int8 x int8 GeMM for Hopper (sm_90a) with an int32 accumulator, in two
// modes: the fused dequant epilogue C = (float(A @ B) * sa) * sb, written in
// f32 or bf16, and the plain int mode C = A @ B written as int32.
//
// Replaces the Pallas TPU kernels repro/kernels/gemm.py::_dequant_gemm_kernel
// (built by make_dequant_gemm) and the int8 x int8 -> int32 mode of
// _gemm_kernel (make_gemm on int8 operands): the paper's P_A = P_B = 8,
// P_C = 32 datapath.  As in gemm.cu, the TPU's sequential K grid axis with a
// VMEM accumulator becomes a K loop inside the block with the int32
// accumulator in registers; each block owns one (BM x BN) output tile.
//
// What bounds it on the H100: at decode (M = slots <= 8) every launch reads
// all of B once and does 2 * M int8 operations per weight byte, far below
// the ~590 op/byte ridge of 1979 TOP/s int8 over 3.35 TB/s, so the bound is
// B's bytes: half of the bf16 GeMM's (the tied head, 1152 x 262144 int8, is
// 302 MB per step).
//
// What this simple design does about it: weights are stored K-contiguous
// (QuantTensor.q is an (N, K) tensor read through a .t() view), so B's tile
// streams through shared memory as 16-byte loads along K, and the next
// tile's loads are in flight, staged in registers, while the current tile is
// multiplied.  Both tiles sit in shared memory K-major with rows padded to
// 80 bytes, so one 16-byte shared load gives 4 words of 4 K-values each to
// __dp4a, conflict-free.  Operands that are not K-contiguous and 16-byte
// aligned (off the serving path) take a byte-load path with the same inner
// loop.  Small-M launches use a 16-row tile; launches with too few output
// tiles split K into an int32 workspace that a second pass sums in split
// order and then scales.  Integer sums are exact and the epilogue's order is
// fixed, so the result equals the plain version bit for bit.  A later PR
// moves this to s8 wgmma fed by TMA and fuses the activation quantization
// (quant.cu) into the prologue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN = 128;   // output columns per block
constexpr int BK = 64;    // K bytes per shared-memory tile
constexpr int BKP = 80;   // padded row: 16-byte aligned, conflict-free 16-byte reads
constexpr int NT = 256;   // threads per block: 16 x 16
constexpr int KV = BK / 16;   // 16-byte vectors per tile row

template <typename O> struct Out;
template <> struct Out<int> {
  static __device__ __forceinline__ int get(int acc, float, float) { return acc; }
};
template <> struct Out<float> {
  static __device__ __forceinline__ float get(int acc, float sa, float sb) {
    return ((float)acc * sa) * sb;
  }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 get(int acc, float sa, float sb) {
    return __float2bfloat16_rn(((float)acc * sa) * sb);
  }
};

// One (BM x BN) tile of C over K steps [z * kps, (z + 1) * kps).  Thread
// (ty, tx) owns rows ty * TM + i and columns tx + 16 * j.  VEC: A and B are
// K-contiguous and 16-byte aligned, K % 16 == 0.
template <typename O, int BM, bool VEC>
__global__ void __launch_bounds__(NT) gemm_s8_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const float* __restrict__ sa, const float* __restrict__ sb,
    O* __restrict__ c, int* __restrict__ ws, int M, int N, int K,
    long long sam, long long sak, long long sbk, long long sbn, int kps) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int A_VECS = BM * KV;           // <= NT: at most one per thread
  constexpr int B_PER = BN * KV / NT;       // 16-byte vectors of B per thread
  __shared__ __align__(16) int8_t As[BM * BKP];
  __shared__ __align__(16) int8_t Bs[BN * BKP];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_steps = (K + BK - 1) / BK;
  const int ks0 = blockIdx.z * kps;
  const int ks1 = min(k_steps, ks0 + kps);

  int4 ra = make_int4(0, 0, 0, 0), rb[B_PER];
  auto load_vec = [&](int ks) {
    const int k0 = ks * BK;
    if (tid < A_VECS) {
      const int m = m0 + tid / KV, k = k0 + (tid % KV) * 16;
      ra = (m < M && k < K) ? *reinterpret_cast<const int4*>(a + m * sam + k)
                            : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      const int n = n0 + e / KV, k = k0 + (e % KV) * 16;
      rb[i] = (n < N && k < K) ? *reinterpret_cast<const int4*>(b + n * sbn + k)
                               : make_int4(0, 0, 0, 0);
    }
  };
  auto store_vec = [&]() {
    if (tid < A_VECS)
      *reinterpret_cast<int4*>(As + (tid / KV) * BKP + (tid % KV) * 16) = ra;
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      *reinterpret_cast<int4*>(Bs + (e / KV) * BKP + (e % KV) * 16) = rb[i];
    }
  };
  // Byte loads straight into shared memory, walked along whichever operand
  // axis is contiguous so neighbouring threads read neighbouring bytes.
  auto load_bytes = [&](int ks) {
    const int k0 = ks * BK;
    for (int e = tid; e < BM * BK; e += NT) {
      const int mm = sak == 1 ? e / BK : e % BM, kk = sak == 1 ? e % BK : e / BM;
      const int m = m0 + mm, k = k0 + kk;
      As[mm * BKP + kk] = (m < M && k < K) ? a[m * sam + k * sak] : 0;
    }
    for (int e = tid; e < BN * BK; e += NT) {
      const int nn = sbk == 1 ? e / BK : e % BN, kk = sbk == 1 ? e % BK : e / BN;
      const int n = n0 + nn, k = k0 + kk;
      Bs[nn * BKP + kk] = (n < N && k < K) ? b[k * sbk + n * sbn] : 0;
    }
  };

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  if constexpr (VEC) {
    if (ks0 < ks1) load_vec(ks0);
  }
  for (int ks = ks0; ks < ks1; ++ks) {
    if constexpr (VEC) {
      store_vec();
      __syncthreads();
      if (ks + 1 < ks1) load_vec(ks + 1);   // in flight during the dot products below
    } else {
      load_bytes(ks);
      __syncthreads();
    }
#pragma unroll
    for (int v = 0; v < KV; ++v) {
      int4 av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const int4*>(As + (ty * TM + i) * BKP + v * 16);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = *reinterpret_cast<const int4*>(Bs + (tx + 16 * j) * BKP + v * 16);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          int s = acc[i][j];
          s = __dp4a(av[i].x, bv[j].x, s);
          s = __dp4a(av[i].y, bv[j].y, s);
          s = __dp4a(av[i].z, bv[j].z, s);
          acc[i][j] = __dp4a(av[i].w, bv[j].w, s);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (ws != nullptr) {
        ws[((long long)blockIdx.z * M + m) * N + n] = acc[i][j];
      } else if constexpr (std::is_same<O, int>::value) {   // int mode: no scales
        c[(long long)m * N + n] = Out<O>::get(acc[i][j], 0.f, 0.f);
      } else {
        c[(long long)m * N + n] = Out<O>::get(acc[i][j], sa[m], sb[n]);
      }
    }
  }
}

// Split-K second pass: sum the int32 partials in split order, then scale.
template <typename O>
__global__ void splitk_reduce_s8(const int* __restrict__ ws,
                                 const float* __restrict__ sa,
                                 const float* __restrict__ sb, O* __restrict__ c,
                                 int M, int N, int splits) {
  const long long mn = (long long)M * N;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= mn) return;
  int s = 0;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  if constexpr (std::is_same<O, int>::value) {
    c[i] = Out<O>::get(s, 0.f, 0.f);
  } else {
    c[i] = Out<O>::get(s, sa[i / N], sb[i % N]);
  }
}

template <typename O, int BM>
void launch_tile(bool vec, dim3 grid, cudaStream_t st, const int8_t* a,
                 const int8_t* b, const float* sa, const float* sb, O* c, int* ws,
                 int M, int N, int K, long long sam, long long sak, long long sbk,
                 long long sbn, int kps) {
  if (vec)
    gemm_s8_kernel<O, BM, true><<<grid, NT, 0, st>>>(a, b, sa, sb, c, ws, M, N, K,
                                                     sam, sak, sbk, sbn, kps);
  else
    gemm_s8_kernel<O, BM, false><<<grid, NT, 0, st>>>(a, b, sa, sb, c, ws, M, N, K,
                                                      sam, sak, sbk, sbn, kps);
}

template <typename O>
int launch_typed(const void* a, const void* b, const float* sa, const float* sb,
                 void* c, void* ws, int M, int N, int K, long long sam,
                 long long sak, long long sbk, long long sbn, int splits,
                 cudaStream_t st) {
  const int k_steps = (K + BK - 1) / BK;
  const int kps = (k_steps + splits - 1) / splits;
  int* part = splits > 1 ? static_cast<int*>(ws) : nullptr;
  const int8_t* ta = static_cast<const int8_t*>(a);
  const int8_t* tb = static_cast<const int8_t*>(b);
  O* tc = static_cast<O*>(c);
  const bool vec = sak == 1 && sbk == 1 && K % 16 == 0 && sam % 16 == 0 &&
                   sbn % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    launch_tile<O, 16>(vec, grid, st, ta, tb, sa, sb, tc, part, M, N, K, sam, sak,
                       sbk, sbn, kps);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    launch_tile<O, 64>(vec, grid, st, ta, tb, sa, sb, tc, part, M, N, K, sam, sak,
                       sbk, sbn, kps);
  }
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long mn = (long long)M * N;
    splitk_reduce_s8<O><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
        part, sa, sb, tc, M, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) and b (K, N) int8 with element strides (sam, sak) and (sbk, sbn).
// out_code: 0 = float32, 1 = bfloat16 (both with the dequant epilogue; sa
// (M,) and sb (N,) float32), 2 = int32 (int mode; sa and sb unused).  C is
// (M, N) contiguous.  `ws` is a (splits, M, N) int32 workspace, unused when
// splits == 1.  Returns the launch's cudaError_t (0 = success).
extern "C" int gemm_int8_launch(const void* a, const void* b, const void* sa,
                                const void* sb, void* c, void* ws, int M, int N,
                                int K, long long sam, long long sak,
                                long long sbk, long long sbn, int out_code,
                                int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(sa);
  const float* fb = static_cast<const float*>(sb);
  if (out_code == 0)
    return launch_typed<float>(a, b, fa, fb, c, ws, M, N, K, sam, sak, sbk, sbn, splits, st);
  if (out_code == 1)
    return launch_typed<__nv_bfloat16>(a, b, fa, fb, c, ws, M, N, K, sam, sak, sbk, sbn,
                                       splits, st);
  if (out_code == 2)
    return launch_typed<int>(a, b, nullptr, nullptr, c, ws, M, N, K, sam, sak, sbk, sbn,
                             splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
