// Depth-D pipelined GeMM for Hopper (sm_90a): C = A @ B with a ring of
// `depth` shared-memory stages per operand, filled by cp.async.
//
// Replaces the Pallas TPU kernel
// repro/kernels/gemm_pipelined.py::_pipelined_kernel (built by
// make_pipelined_gemm), the paper's D_stream knob (Sec. 3.3, Fig. 5): the
// input streamers pre-fetch `depth` tiles ahead of the compute array.  The
// TPU kernel keeps a VMEM ring of `depth` (tm x tk) and (tk x tn) tiles per
// operand, started by manual DMAs before the K loop and re-armed for tile
// k + depth as soon as tile k is consumed.  Here the DMA engine is cp.async
// (16-byte cp.async.cg copies, one commit group per K tile) and the ring is
// in shared memory; the structure is the reference's: `depth` tiles in
// flight before the loop, then wait for the oldest (wait_group depth - 1),
// multiply it, and re-arm its slot for tile k + depth.  Blocks own one
// (BM x BN) output tile for their whole K range, accumulator in registers,
// as in K1 (csrc/gemm.cu).
//
// What bounds it on the H100: at decode (M = 8) every launch reads all of B
// once and does 2 * M operations per weight element, so B's bytes over
// 3.35 TB/s bound it; prefill chunks (M = 64) are still under the ridge.
// What the design does about it: B tiles arrive by asynchronous copies that
// bypass the registers, `depth` of them in flight per block, so the loads of
// tiles k+1 .. k+depth-1 overlap the FMAs of tile k; launches with too few
// output tiles to fill the 132 SMs split K (K1's rule, kernels/gemm.py) into
// a workspace reduced in a fixed order.  The product is SIMT FMA (f32, never
// TF32) or integer multiply-add (int8 -> int32, exact); a later PR moves it
// onto wgmma.
//
// Edges: rows past M and columns past N or K are zero-filled by the copy
// itself (cp.async with src-size < 16), so nothing is padded on the host.
// Every 16-byte chunk's source must be 16-byte aligned: the wrapper checks
// the base pointers and leading strides and re-lays an operand that is not
// (never on the model's path, whose widths are multiples of 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN = 128;   // output columns per block
constexpr int BK = 32;    // K depth per stage, in elements
constexpr int NT = 256;   // threads per block: 16 x 16

template <typename T>
using acc_t = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int to_acc(int8_t x) { return static_cast<int>(x); }

__device__ __forceinline__ float mac(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mac(int a, int b, int c) { return a * b + c; }

// out_code: 0 = float32, 1 = bfloat16, 2 = int32.
__device__ __forceinline__ void store(void* c, int out_code, long long i, float v) {
  if (out_code == 0) static_cast<float*>(c)[i] = v;
  else static_cast<__nv_bfloat16*>(c)[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(void* c, int, long long i, int v) {
  static_cast<int*>(c)[i] = v;
}

// 16-byte asynchronous copy global -> shared; bytes past src_bytes are
// zero-filled (src_bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory layout of one stage, in elements of T.  Rows are padded by
// one 16-byte chunk so every row start stays 16-byte aligned and the
// column reads of the K-major B tile spread over banks.
template <typename T, int BM, bool KMAJOR>
struct Stage {
  static constexpr int CE = 16 / sizeof(T);     // elements per 16-byte chunk
  static constexpr int LDA = BK + CE;            // A: [BM][LDA], K contiguous
  static constexpr int LDB = KMAJOR ? BK + CE : BN + CE;  // B: [BN][LDB] or [BK][LDB]
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = KMAJOR ? BN * LDB : BK * LDB;
  static constexpr int ELEMS = A_ELEMS + B_ELEMS;
};

// One (BM x BN) tile of C over K steps [z * kps, (z + 1) * kps).  A is
// (M, K) with K contiguous (row stride sam); B is (K, N) with N contiguous
// (row stride sbk) or, KMAJOR, with K contiguous (the (N, K) store of a
// .t() view, column stride sbn).  Thread (ty, tx) owns rows ty * TM + i and
// columns tx + 16 * j.
template <typename T, int BM, int DEPTH, bool KMAJOR>
__global__ void __launch_bounds__(NT) pipelined_kernel(
    const T* __restrict__ a, const T* __restrict__ b, void* __restrict__ c,
    acc_t<T>* __restrict__ ws, int M, int N, int K, long long sam,
    long long sbk, long long sbn, int kps, int out_code) {
  using S = Stage<T, BM, KMAJOR>;
  using A = acc_t<T>;
  constexpr int CE = S::CE;
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_steps = (K + BK - 1) / BK;
  const int ks0 = blockIdx.z * kps;
  const int n_local = max(0, min(k_steps, ks0 + kps) - ks0);

  // Issue the copies of K tile `ks` into ring slot `slot` (no commit).
  auto issue = [&](int slot, int ks) {
    T* as = smem + slot * S::ELEMS;
    T* bs = as + S::A_ELEMS;
    const int k0 = ks * BK;
    for (int e = tid; e < BM * (BK / CE); e += NT) {
      const int r = e / (BK / CE), kc = (e % (BK / CE)) * CE;
      const int m = m0 + r, k = k0 + kc;
      const int valid = (m < M) ? max(0, min(CE, K - k)) : 0;
      const T* src = valid ? a + m * sam + k : a;
      cp_async16(as + r * S::LDA + kc, src, valid * (int)sizeof(T));
    }
    if (KMAJOR) {
      for (int e = tid; e < BN * (BK / CE); e += NT) {
        const int r = e / (BK / CE), kc = (e % (BK / CE)) * CE;
        const int n = n0 + r, k = k0 + kc;
        const int valid = (n < N) ? max(0, min(CE, K - k)) : 0;
        const T* src = valid ? b + n * sbn + k : b;
        cp_async16(bs + r * S::LDB + kc, src, valid * (int)sizeof(T));
      }
    } else {
      for (int e = tid; e < BK * (BN / CE); e += NT) {
        const int r = e / (BN / CE), nc = (e % (BN / CE)) * CE;
        const int k = k0 + r, n = n0 + nc;
        const int valid = (k < K) ? max(0, min(CE, N - n)) : 0;
        const T* src = valid ? b + k * sbk + n : b;
        cp_async16(bs + r * S::LDB + nc, src, valid * (int)sizeof(T));
      }
    }
  };

  A acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = A(0);

  // Warm-up: `depth` tiles in flight before any compute.  Every step
  // commits one group, empty or not, so group t always holds tile t.
#pragma unroll
  for (int s = 0; s < DEPTH; ++s) {
    if (s < n_local) issue(s, ks0 + s);
    cp_async_commit();
  }
  for (int t = 0; t < n_local; ++t) {
    const int slot = t % DEPTH;
    cp_async_wait<DEPTH - 1>();   // tile t landed; t+1 .. t+DEPTH-1 in flight
    __syncthreads();
    const T* as = smem + slot * S::ELEMS;
    const T* bs = as + S::A_ELEMS;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      A av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = to_acc(as[(ty * TM + i) * S::LDA + kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = to_acc(KMAJOR ? bs[(tx + 16 * j) * S::LDB + kk] : bs[kk * S::LDB + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();              // every thread is done with this slot
    if (t + DEPTH < n_local) issue(slot, ks0 + t + DEPTH);   // re-arm it
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (ws != nullptr) ws[((long long)blockIdx.z * M + m) * N + n] = acc[i][j];
      else store(c, out_code, (long long)m * N + n, acc[i][j]);
    }
  }
}

// Split-K second pass: sum the partial tiles in split order, store.
template <typename A>
__global__ void splitk_reduce(const A* __restrict__ ws, void* __restrict__ c,
                              long long mn, int splits, int out_code) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= mn) return;
  A s = A(0);
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  store(c, out_code, i, s);
}

template <typename T, int BM, int DEPTH, bool KMAJOR>
int launch_cfg(const void* a, const void* b, void* c, void* ws, int M, int N, int K,
               long long sam, long long sbk, long long sbn, int splits,
               int out_code, cudaStream_t stream) {
  using A = acc_t<T>;
  const int k_steps = (K + BK - 1) / BK;
  const int kps = (k_steps + splits - 1) / splits;
  const size_t smem = (size_t)DEPTH * Stage<T, BM, KMAJOR>::ELEMS * sizeof(T);
  auto kern = pipelined_kernel<T, BM, DEPTH, KMAJOR>;
  // Raise the dynamic shared-memory cap once per instantiation, never per
  // launch: launches may be captured into a CUDA graph.
  static bool raised = false;
  if (smem > 48 * 1024 && !raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  A* part = splits > 1 ? static_cast<A*>(ws) : nullptr;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b), c,
                                   part, M, N, K, sam, sbk, sbn, kps, out_code);
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long mn = (long long)M * N;
    splitk_reduce<A><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        part, c, mn, splits, out_code);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, int DEPTH>
int launch_layout(const void* a, const void* b, void* c, void* ws, int M, int N, int K,
                  long long sam, long long sbk, long long sbn, int splits,
                  int out_code, cudaStream_t st) {
  if (sbk == 1)
    return launch_cfg<T, BM, DEPTH, true>(a, b, c, ws, M, N, K, sam, sbk, sbn, splits,
                                          out_code, st);
  return launch_cfg<T, BM, DEPTH, false>(a, b, c, ws, M, N, K, sam, sbk, sbn, splits,
                                         out_code, st);
}

template <typename T, int BM>
int launch_depth(const void* a, const void* b, void* c, void* ws, int M, int N, int K,
                 long long sam, long long sbk, long long sbn, int depth, int splits,
                 int out_code, cudaStream_t st) {
  switch (depth) {
    case 2: return launch_layout<T, BM, 2>(a, b, c, ws, M, N, K, sam, sbk, sbn, splits, out_code, st);
    case 3: return launch_layout<T, BM, 3>(a, b, c, ws, M, N, K, sam, sbk, sbn, splits, out_code, st);
    case 4: return launch_layout<T, BM, 4>(a, b, c, ws, M, N, K, sam, sbk, sbn, splits, out_code, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_typed(const void* a, const void* b, void* c, void* ws, int M, int N, int K,
                 long long sam, long long sbk, long long sbn, int depth, int splits,
                 int out_code, cudaStream_t st) {
  if (M <= 16)
    return launch_depth<T, 16>(a, b, c, ws, M, N, K, sam, sbk, sbn, depth, splits, out_code, st);
  return launch_depth<T, 64>(a, b, c, ws, M, N, K, sam, sbk, sbn, depth, splits, out_code, st);
}

}  // namespace

// in_code: 0 = float32, 1 = bfloat16, 2 = int8 (A and B share it); out_code:
// 0 = float32 or 1 = bfloat16 for float inputs, 2 = int32 for int8.  A is
// (M, K) with unit K stride and row stride sam; B is (K, N) with strides
// (sbk, sbn), one of them 1.  Every row of both starts 16-byte aligned.
// `ws` is a (splits, M, N) float32 (int32 for int8) workspace, unused when
// splits == 1.  depth in {2, 3, 4}.  Returns the launch's cudaError_t.
extern "C" int gemm_pipelined_launch(const void* a, const void* b, void* c, void* ws,
                                     int M, int N, int K, long long sam, long long sbk,
                                     long long sbn, int in_code, int out_code, int depth,
                                     int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_code == 0 && out_code <= 1)
    return launch_typed<float>(a, b, c, ws, M, N, K, sam, sbk, sbn, depth, splits, out_code, st);
  if (in_code == 1 && out_code <= 1)
    return launch_typed<__nv_bfloat16>(a, b, c, ws, M, N, K, sam, sbk, sbn, depth, splits,
                                       out_code, st);
  if (in_code == 2 && out_code == 2)
    return launch_typed<int8_t>(a, b, c, ws, M, N, K, sam, sbk, sbn, depth, splits, out_code, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
