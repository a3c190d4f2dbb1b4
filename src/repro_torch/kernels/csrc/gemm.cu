// Output-stationary tiled GeMM for Hopper (sm_90a): C = A @ B, f32 accumulate.
//
// Replaces the Pallas TPU kernel repro/kernels/gemm.py::_gemm_kernel (built
// by make_gemm).  The TPU kernel walks a (M/TM, N/TN, K/TK) grid with K
// innermost and carries a VMEM accumulator across the sequential K steps.
// Here blocks run in parallel and in no order, so the K walk is a loop
// inside the block and the accumulator lives in registers; a block owns one
// (BM x BN) output tile for its whole K range.
//
// What bounds it on the H100: at decode (M = slots <= 8) every launch reads
// all of B once and does 2*M FLOPs per weight element, far below the
// ~295 FLOP/byte ridge, so the bound is B's bytes over 3.35 TB/s (the tied
// head, 1152 x 262144 bf16, is 604 MB per step).  Prefill chunks (M = 64)
// are still under the ridge.
//
// What this simple design does about it: B streams through shared memory
// once per block in (BK x BN) tiles read by coalesced loads, along whichever
// of B's axes is contiguous (the tied head is a transposed view with row
// stride 1, read in place, never copied), and the next tile's loads are in
// flight, staged in registers, while the current tile is multiplied.
// Small-M launches use a 16-row tile so no block computes 48 dead rows, and
// launches with too few output tiles to fill the 132 SMs split K across
// blocks into a float32 workspace that a second pass reduces in a fixed
// order (deterministic).  Ragged edges are
// masked in the kernel, so nothing is padded on the host.  The f32 path is
// plain FMA, never TF32.  A later PR replaces the scalar shared-memory
// tiles with a TMA-fed multistage pipeline and wgmma (bf16) with the
// accumulator in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 128;   // output columns per block
constexpr int BK = 32;    // K depth per shared-memory tile
constexpr int NT = 256;   // threads per block: 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename O> __device__ __forceinline__ O from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One (BM x BN) tile of C over K steps [z * kps, (z + 1) * kps).  Thread
// (ty, tx) owns rows ty * TM + i and columns tx + 16 * j, so neighbouring
// threads read neighbouring shared-memory words and write neighbouring
// columns of C.  The next K step's tiles are loaded into registers while
// the current one is multiplied, so global loads overlap the FMAs.
template <typename T, typename O, int BM>
__global__ void __launch_bounds__(NT) gemm_kernel(
    const T* __restrict__ a, const T* __restrict__ b, O* __restrict__ c,
    float* __restrict__ ws, int M, int N, int K,
    long long sam, long long sak, long long sbk, long long sbn, int kps) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int A_PER = BM * BK / NT;   // A elements each thread stages
  constexpr int B_PER = BK * BN / NT;   // B elements each thread stages
  __shared__ float As[BK][BM + 1];   // +1: conflict-free transposing stores
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_steps = (K + BK - 1) / BK;
  const int ks0 = blockIdx.z * kps;
  const int ks1 = min(k_steps, ks0 + kps);
  const bool a_k_contig = (sak == 1);
  const bool b_n_contig = (sbn == 1);

  // Staging coordinates: element i of this thread is tile entry
  // tid + i * NT, walked along whichever operand axis is contiguous.
  int a_mm[A_PER], a_kk[A_PER], b_kk[B_PER], b_nn[B_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int e = tid + i * NT;
    a_mm[i] = a_k_contig ? e / BK : e % BM;
    a_kk[i] = a_k_contig ? e % BK : e / BM;
  }
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int e = tid + i * NT;
    b_kk[i] = b_n_contig ? e / BN : e % BK;
    b_nn[i] = b_n_contig ? e % BN : e / BK;
  }
  float ra[A_PER], rb[B_PER];
  auto load = [&](int ks) {
    const int k0 = ks * BK;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int m = m0 + a_mm[i], k = k0 + a_kk[i];
      ra[i] = (m < M && k < K) ? to_f(a[m * sam + k * sak]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int k = k0 + b_kk[i], n = n0 + b_nn[i];
      rb[i] = (k < K && n < N) ? to_f(b[k * sbk + n * sbn]) : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (ks0 < ks1) load(ks0);
  for (int ks = ks0; ks < ks1; ++ks) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[a_kk[i]][a_mm[i]] = ra[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) Bs[b_kk[i]][b_nn[i]] = rb[i];
    __syncthreads();
    if (ks + 1 < ks1) load(ks + 1);   // in flight during the FMAs below
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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
      } else {
        c[(long long)m * N + n] = from_f<O>(acc[i][j]);
      }
    }
  }
}

// Split-K second pass: sum the partial tiles in split order, cast, store.
template <typename O>
__global__ void splitk_reduce(const float* __restrict__ ws, O* __restrict__ c,
                              long long mn, int splits) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  c[i] = from_f<O>(s);
}

template <typename T, typename O>
int launch_typed(const void* a, const void* b, void* c, void* ws, int M, int N,
                 int K, long long sam, long long sak, long long sbk,
                 long long sbn, int splits, cudaStream_t stream) {
  const int k_steps = (K + BK - 1) / BK;
  const int kps = (k_steps + splits - 1) / splits;
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  O* tc = static_cast<O*>(c);
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, splits);
    gemm_kernel<T, O, 16><<<grid, NT, 0, stream>>>(ta, tb, tc, part, M, N, K,
                                                   sam, sak, sbk, sbn, kps);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, splits);
    gemm_kernel<T, O, 64><<<grid, NT, 0, stream>>>(ta, tb, tc, part, M, N, K,
                                                   sam, sak, sbk, sbn, kps);
  }
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long mn = (long long)M * N;
    splitk_reduce<O><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(part, tc, mn, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  A and B share one dtype; C is
// written in out_code's dtype.  `ws` is a (splits, M, N) float32 workspace,
// unused when splits == 1.  Returns the launch's cudaError_t (0 = success).
extern "C" int gemm_launch(const void* a, const void* b, void* c, void* ws,
                           int M, int N, int K, long long sam, long long sak,
                           long long sbk, long long sbn, int in_code,
                           int out_code, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_code == 0 && out_code == 0)
    return launch_typed<float, float>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, splits, st);
  if (in_code == 0 && out_code == 1)
    return launch_typed<float, __nv_bfloat16>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, splits, st);
  if (in_code == 1 && out_code == 0)
    return launch_typed<__nv_bfloat16, float>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, splits, st);
  if (in_code == 1 && out_code == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
