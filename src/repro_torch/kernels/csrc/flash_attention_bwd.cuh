// Flash attention backward for Hopper (sm_90a): the gradients dq, dk, dv of
// full-sequence attention with causal and sliding-window masks and GQA,
// recomputing the probabilities from the forward's log-sum-exp, nothing of
// the (Sq, Skv) score matrix in device memory and no atomics.
//
// Replaces no TPU kernel of its own.  The reference trains by differentiating
// straight through its Pallas kernel repro/kernels/flash_attention.py::
// _flash_kernel under jax.checkpoint (repro/models/attention.py:103-109), so
// XLA derives the backward from the kernel's body.  A CUDA kernel has no
// such derivative: this is the hand-written backward of csrc/
// flash_attention.cu (K5), run by the autograd Function of
// kernels/flash_attention.py.
//
// FA2's split, in three launches on one stream:
//   1. delta_kernel: Delta = rowsum(dO * O) per (b, q head, row), f32.
//   2. dkdv_kernel: one block per (b, kv head, tile of BKV keys).  It walks
//      the G q heads of its kv head and, for each, the query tiles that can
//      see its keys (causal: rows >= the tile's first key; window: rows <
//      its last key + window), so the GQA / MQA sum over the G heads stays
//      inside the block.  Per query tile: S = Q K^T, dP = dO V^T, P =
//      exp(S * scale - lse) where the forward's mask is live (0 elsewhere),
//      dS = P * (dP - Delta); dV += P^T dO, dK += dS^T Q.
//   3. dq_kernel: one block per (b, q head, tile of BQ rows), walking the
//      kv tiles the rows can see (the forward's tile range): dQ += dS K.
//   Every sum runs in a fixed order (heads, then tiles, then the product's
//   own order), so two runs give the same bits.
//
// The masks are the forward's exactly: kpos < Skv, qpos >= kpos when causal,
// qpos - kpos < window, positions from 0 for q and k; ragged tiles are
// zero-filled and masked.  A row with no live key (possible only when Sq >
// Skv under a window) has no defined lse and gets no gradient.
//
// What bounds it on the H100: operations, five products of 2 * Sq *
// Skv_visible * D per q head (S and dP recomputed, dV, dK, dQ; S and dP are
// computed twice, once per kernel), far above the ~295 FLOP/byte ridge.
//
// bf16 inputs (training's working type) run the five products on the
// tensor cores through WMMA (16 x 16 x 16 bf16 fragments, f32 accumulate;
// they lower to mma.sync m16n8k16) with every operand staged in shared
// memory: BQ = 64 query rows, BKV = 32 keys, 8 warps.  S and dP go to
// shared memory in f32, P and dS back in bf16 (P rounded as the forward
// rounds p before PV).  The running sums stay in registers as WMMA
// accumulator fragments: dK and dV (BKV x D each) are 2 D / 16 tiles of
// 16 x 16, D / 64 a warp each; dQ (BQ x D) D / 4 tiles, D / 32 a warp: at
// D = 256 that is 64 f32 a thread in either kernel, so D is not split and
// the sums never leave the registers until the end.  What does not fit
// registers at D = 256 is the staging of q, dO, K and V, so every tile sits
// in dynamic shared memory (about 128 KB at D = 256, above the 48 KB
// default: cudaFuncSetAttribute raises the cap once per kernel), one block
// an SM.  This is the simple design: no double buffering, no ldmatrix
// swizzle, operands re-read from shared memory by every fragment load.
//
// f32 inputs run the same walk on a SIMT body (BQ = 32 to fit shared
// memory at D = 256; each thread owns fixed elements of the sums, f32 FMA,
// never TF32), so the card can be held against the CPU in f32.
//
// This header holds both bodies; flash_attention_bwd.cu instantiates the
// bf16 one and flash_attention_bwd_f32.cu the f32 one, so their 9 kernels
// each compile in two nvcc processes at once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;          // threads a block: 8 warps
constexpr int NW = NT / 32;
constexpr int BKV = 32;          // keys a tile

template <typename T> struct Tile {
  static constexpr int BQ = sizeof(T) == 2 ? 64 : 32;   // query rows a tile
  static constexpr int VEC = 16 / (int)sizeof(T);       // elements a 16-byte copy
  static constexpr int PP = BKV + VEC;                  // pitch of P, dS (BQ x BKV)
  static constexpr int SP = BKV + 4;                    // pitch of S, dP (f32)
};

template <typename T, int D> struct Layout {
  static constexpr int BQ = Tile<T>::BQ, P = D + Tile<T>::VEC, PP = Tile<T>::PP,
                       SP = Tile<T>::SP;
  // q, dO (BQ x P), K, V (BKV x P), P, dS (BQ x PP) in T; S, dP (BQ x SP),
  // lse, Delta (BQ) in f32.  Every part starts 32-byte aligned.
  static constexpr size_t SMEM =
      sizeof(T) * (2 * (size_t)BQ * P + 2 * (size_t)BKV * P + 2 * (size_t)BQ * PP) +
      sizeof(float) * (2 * (size_t)BQ * SP + 2 * (size_t)BQ);
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// ROWS rows of D elements from global rows r0 .. r0 + ROWS - 1 (row r at
// base + r * rstride) into a tile of pitch D + VEC; rows >= lim read as 0.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* base, long long rstride, int r0,
                                          int lim) {
  constexpr int VEC = Tile<T>::VEC, CH = D / VEC, P = D + VEC;
  for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < lim)
      val = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * rstride + c * VEC);
    *reinterpret_cast<uint4*>(dst + r * P + c * VEC) = val;
  }
}

// The five products on one block's shared-memory tiles, by element type.
//   abt:   C (BQ x BKV, f32, pitch SP) = A (BQ x D) B^T, B (BKV x D)
//   atb:   acc (BKV x D) += A^T B, A (BQ x BKV, pitch PP), B (BQ x D)
//   ab:    acc (BQ x D) += A B, A (BQ x BKV, pitch PP), B (BKV x D)
//   store: acc * scale into a dense ROWS x D f32 tile
template <typename T, int D> struct Mm;

template <int D> struct Mm<bf16, D> {
  static constexpr int BQ = Tile<bf16>::BQ, P = D + 8, PP = Tile<bf16>::PP,
                       SP = Tile<bf16>::SP, NC = D / 16;
  static constexpr int NKV = 2 * NC / NW;        // BKV x D tiles a warp
  static constexpr int NQ = (BQ / 16) * NC / NW; // BQ x D tiles a warp
  using Frag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
  template <int N> struct Acc { Frag f[N]; };

  template <int N> __device__ static void zero(Acc<N>& a) {
#pragma unroll
    for (int j = 0; j < N; ++j) nvcuda::wmma::fill_fragment(a.f[j], 0.f);
  }
  __device__ static void abt(float* C, const bf16* A, const bf16* B) {
    using namespace nvcuda::wmma;
    const int w = threadIdx.x / 32, tm = w >> 1, tn = w & 1;   // 4 x 2 tiles, one a warp
    Frag c;
    fill_fragment(c, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      fragment<matrix_a, 16, 16, 16, bf16, row_major> a;
      fragment<matrix_b, 16, 16, 16, bf16, col_major> b;
      load_matrix_sync(a, A + tm * 16 * P + kk * 16, P);
      load_matrix_sync(b, B + tn * 16 * P + kk * 16, P);
      mma_sync(c, a, b, c);
    }
    store_matrix_sync(C + tm * 16 * SP + tn * 16, c, SP, mem_row_major);
  }
  __device__ static void atb(Acc<NKV>& acc, const bf16* A, const bf16* B) {
    using namespace nvcuda::wmma;
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < NKV; ++j) {
      const int t = w + NW * j, rb = t / NC, cb = t % NC;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        fragment<matrix_a, 16, 16, 16, bf16, col_major> a;   // A^T: (key, row)
        fragment<matrix_b, 16, 16, 16, bf16, row_major> b;
        load_matrix_sync(a, A + kk * 16 * PP + rb * 16, PP);
        load_matrix_sync(b, B + kk * 16 * P + cb * 16, P);
        mma_sync(acc.f[j], a, b, acc.f[j]);
      }
    }
  }
  __device__ static void ab(Acc<NQ>& acc, const bf16* A, const bf16* B) {
    using namespace nvcuda::wmma;
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int t = w + NW * j, rb = t / NC, cb = t % NC;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        fragment<matrix_a, 16, 16, 16, bf16, row_major> a;
        fragment<matrix_b, 16, 16, 16, bf16, row_major> b;
        load_matrix_sync(a, A + rb * 16 * PP + kk * 16, PP);
        load_matrix_sync(b, B + kk * 16 * P + cb * 16, P);
        mma_sync(acc.f[j], a, b, acc.f[j]);
      }
    }
  }
  template <int N> __device__ static void store(Acc<N>& acc, float* C, float scale) {
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int t = w + NW * j, rb = t / NC, cb = t % NC;
#pragma unroll
      for (int e = 0; e < acc.f[j].num_elements; ++e) acc.f[j].x[e] *= scale;
      nvcuda::wmma::store_matrix_sync(C + rb * 16 * D + cb * 16, acc.f[j], D,
                                      nvcuda::wmma::mem_row_major);
    }
  }
};

template <int D> struct Mm<float, D> {
  static constexpr int BQ = Tile<float>::BQ, P = D + 4, PP = Tile<float>::PP,
                       SP = Tile<float>::SP;
  static constexpr int NKV = BKV * D / NT;   // elements of a BKV x D sum a thread
  static constexpr int NQ = BQ * D / NT;     // of a BQ x D sum
  template <int N> struct Acc { float f[N]; };

  template <int N> __device__ static void zero(Acc<N>& a) {
#pragma unroll
    for (int j = 0; j < N; ++j) a.f[j] = 0.f;
  }
  __device__ static void abt(float* C, const float* A, const float* B) {
    for (int e = threadIdx.x; e < BQ * BKV; e += NT) {
      const int r = e / BKV, c = e % BKV;
      const float* a = A + r * P;
      const float* b = B + c * P;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
      C[r * SP + c] = s;
    }
  }
  // Thread tid owns elements tid + NT * j of the row-major sum.
  __device__ static void atb(Acc<NKV>& acc, const float* A, const float* B) {
#pragma unroll
    for (int j = 0; j < NKV; ++j) {
      const int e = threadIdx.x + NT * j, m = e / D, d = e % D;
      float s = acc.f[j];
      for (int r = 0; r < BQ; ++r) s = fmaf(A[r * PP + m], B[r * P + d], s);
      acc.f[j] = s;
    }
  }
  __device__ static void ab(Acc<NQ>& acc, const float* A, const float* B) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int e = threadIdx.x + NT * j, m = e / D, d = e % D;
      float s = acc.f[j];
      for (int c = 0; c < BKV; ++c) s = fmaf(A[m * PP + c], B[c * P + d], s);
      acc.f[j] = s;
    }
  }
  template <int N> __device__ static void store(Acc<N>& acc, float* C, float scale) {
#pragma unroll
    for (int j = 0; j < N; ++j) C[threadIdx.x + NT * j] = acc.f[j] * scale;
  }
};

// The block's shared-memory tiles, carved in Layout's order.
template <typename T, int D> struct Smem {
  using L = Layout<T, D>;
  T *q, *dout, *k, *v, *p, *ds;
  float *s, *dp, *lse, *delta;
  __device__ explicit Smem(unsigned char* base) {
    q = reinterpret_cast<T*>(base);
    dout = q + L::BQ * L::P;
    k = dout + L::BQ * L::P;
    v = k + BKV * L::P;
    p = v + BKV * L::P;
    ds = p + L::BQ * L::PP;
    s = reinterpret_cast<float*>(ds + L::BQ * L::PP);
    dp = s + L::BQ * L::SP;
    lse = dp + L::BQ * L::SP;
    delta = lse + L::BQ;
  }
};

// P and dS of one (query tile, key tile) pair from S and dP in shared
// memory, under the forward's masks.
template <typename T, int D>
__device__ __forceinline__ void probs(const Smem<T, D>& sm, int q0, int k0, int Sq, int Skv,
                                      int causal, int window, float scale) {
  using L = Layout<T, D>;
  for (int e = threadIdx.x; e < L::BQ * BKV; e += NT) {
    const int r = e / BKV, c = e % BKV, qpos = q0 + r, kpos = k0 + c;
    bool live = qpos < Sq && kpos < Skv;
    if (causal) live = live && qpos >= kpos;
    if (window > 0) live = live && (qpos - kpos) < window;
    const float p = live ? expf(sm.s[r * L::SP + c] * scale - sm.lse[r]) : 0.f;
    const float ds = p * (sm.dp[r * L::SP + c] - sm.delta[r]);
    sm.p[r * L::PP + c] = from_f<T>(p);
    sm.ds[r * L::PP + c] = from_f<T>(ds);
  }
}

// Grid ceil(rows / NW) blocks of NT threads, a warp a row of (B, Sq, Hq):
// delta (B, Hq, Sq) = sum over D of dout * out, in f32, lanes then shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(NT) delta_kernel(const T* __restrict__ out,
                                                   const T* __restrict__ dout,
                                                   float* __restrict__ delta, int rows,
                                                   int Sq, int Hq) {
  const int row = blockIdx.x * NW + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long off = (long long)row * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(dout[off + d]), to_f(out[off + d]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const int h = row % Hq, s = (row / Hq) % Sq, b = row / (Hq * Sq);
    delta[((long long)b * Hq + h) * Sq + s] = acc;
  }
}

// Grid (ceil(Skv / BKV), B * Hkv).  q, dout (B, Sq, Hq, D), k, v, dk, dv
// (B, Skv, Hkv, D), lse, delta (B, Hq, Sq).
template <typename T, int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
    int Hq, int Hkv, int causal, int window, float scale) {
  using L = Layout<T, D>;
  using MM = Mm<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T, D> sm(smem);
  const int k0 = blockIdx.x * BKV;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, G = Hq / Hkv;
  const long long q_row = (long long)Hq * D, kv_row = (long long)Hkv * D;
  const long long kv_off = (long long)b * Skv * kv_row + (long long)hk * D;
  load_tile<T, D, BKV>(sm.k, k + kv_off, kv_row, k0, Skv);
  load_tile<T, D, BKV>(sm.v, v + kv_off, kv_row, k0, Skv);

  // Query rows that see any key of this tile.
  int q_lo = causal ? k0 : 0, q_hi = Sq;
  if (window > 0) q_hi = min(Sq, k0 + BKV - 1 + window);
  q_lo = (q_lo / L::BQ) * L::BQ;

  typename MM::template Acc<MM::NKV> adk, adv;
  MM::zero(adk);
  MM::zero(adv);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long q_off = (long long)b * Sq * q_row + (long long)h * D;
    const float* lse_h = lse + ((long long)b * Hq + h) * Sq;
    const float* delta_h = delta + ((long long)b * Hq + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += L::BQ) {
      __syncthreads();   // the previous tile's products are done with q, dO, P, dS
      load_tile<T, D, L::BQ>(sm.q, q + q_off, q_row, q0, Sq);
      load_tile<T, D, L::BQ>(sm.dout, dout + q_off, q_row, q0, Sq);
      for (int r = threadIdx.x; r < L::BQ; r += NT) {
        const bool ok = q0 + r < Sq;
        sm.lse[r] = ok ? lse_h[q0 + r] : 0.f;
        sm.delta[r] = ok ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();
      MM::abt(sm.s, sm.q, sm.k);
      MM::abt(sm.dp, sm.dout, sm.v);
      __syncthreads();
      probs<T, D>(sm, q0, k0, Sq, Skv, causal, window, scale);
      __syncthreads();
      MM::atb(adv, sm.p, sm.dout);
      MM::atb(adk, sm.ds, sm.q);
    }
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);   // 2 x BKV x D f32 over q and dO
  MM::store(adk, stage, scale);
  MM::store(adv, stage + BKV * D, 1.f);
  __syncthreads();
  for (int e = threadIdx.x; e < BKV * D; e += NT) {
    const int r = e / D, d = e % D, key = k0 + r;
    if (key >= Skv) continue;
    const long long o = kv_off + (long long)key * kv_row + d;
    dk[o] = from_f<T>(stage[e]);
    dv[o] = from_f<T>(stage[BKV * D + e]);
  }
}

// Grid (ceil(Sq / BQ), B * Hq).
template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
    int causal, int window, float scale) {
  using L = Layout<T, D>;
  using MM = Mm<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T, D> sm(smem);
  const int q0 = blockIdx.x * L::BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  const long long q_row = (long long)Hq * D, kv_row = (long long)Hkv * D;
  const long long q_off = (long long)b * Sq * q_row + (long long)h * D;
  const long long kv_off = (long long)b * Skv * kv_row + (long long)hk * D;
  load_tile<T, D, L::BQ>(sm.q, q + q_off, q_row, q0, Sq);
  load_tile<T, D, L::BQ>(sm.dout, dout + q_off, q_row, q0, Sq);
  const float* lse_h = lse + ((long long)b * Hq + h) * Sq;
  const float* delta_h = delta + ((long long)b * Hq + h) * Sq;
  for (int r = threadIdx.x; r < L::BQ; r += NT) {
    const bool ok = q0 + r < Sq;
    sm.lse[r] = ok ? lse_h[q0 + r] : 0.f;
    sm.delta[r] = ok ? delta_h[q0 + r] : 0.f;
  }

  // kv tiles any row of this block can see (the forward's range).
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, min(q0 + L::BQ, Sq));
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = (lo / BKV) * BKV;

  typename MM::template Acc<MM::NQ> adq;
  MM::zero(adq);
  for (int k0 = lo; k0 < hi; k0 += BKV) {
    __syncthreads();   // the previous tile's products are done with K, V, dS
    load_tile<T, D, BKV>(sm.k, k + kv_off, kv_row, k0, Skv);
    load_tile<T, D, BKV>(sm.v, v + kv_off, kv_row, k0, Skv);
    __syncthreads();
    MM::abt(sm.s, sm.q, sm.k);
    MM::abt(sm.dp, sm.dout, sm.v);
    __syncthreads();
    probs<T, D>(sm, q0, k0, Sq, Skv, causal, window, scale);
    __syncthreads();
    MM::ab(adq, sm.ds, sm.k);
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);   // BQ x D f32 over q and dO
  MM::store(adq, stage, scale);
  __syncthreads();
  for (int e = threadIdx.x; e < L::BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    if (q0 + r >= Sq) continue;
    dq[q_off + (long long)(q0 + r) * q_row + d] = from_f<T>(stage[e]);
  }
}

// Raise a kernel's dynamic shared-memory cap once, never per launch.
template <typename K> int raise_smem(K kern, size_t smem, bool& raised) {
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  return 0;
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
           int Hq, int Hkv, int causal, int window, float scale, cudaStream_t st) {
  using L = Layout<T, D>;
  static bool raised_kv = false, raised_q = false;
  int err = raise_smem(dkdv_kernel<T, D>, L::SMEM, raised_kv);
  if (!err) err = raise_smem(dq_kernel<T, D>, L::SMEM, raised_q);
  if (err) return err;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int rows = B * Sq * Hq;
  delta_kernel<T, D><<<(rows + NW - 1) / NW, NT, 0, st>>>(static_cast<const T*>(out), dot, dl,
                                                          rows, Sq, Hq);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dkdv_kernel<T, D><<<dim3((Skv + BKV - 1) / BKV, B * Hkv), NT, L::SMEM, st>>>(
      qt, kt, vt, dot, lt, dl, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, Hkv,
      causal, window, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dq_kernel<T, D><<<dim3((Sq + L::BQ - 1) / L::BQ, B * Hq), NT, L::SMEM, st>>>(
      qt, kt, vt, dot, lt, dl, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// launch_bwd<T, D> for D in {64, 128, 256}; cudaErrorInvalidValue otherwise.
template <typename T>
int launch_bwd_d(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                 int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                 float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_bwd<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq,
                               Hkv, causal, window, scale, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                Hkv, causal, window, scale, st);
    case 256:
      return launch_bwd<T, 256>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                Hkv, causal, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
