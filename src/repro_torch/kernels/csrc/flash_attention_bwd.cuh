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
// What bounds it on the H100: operations, five products of 2 * Sq *
// Skv_visible * D per q head (S and dP, dV, dK, dQ; S and dP are computed
// twice, once per kernel, so seven are run), far above the ~295 FLOP/byte
// ridge.
//
// The function, in both bodies: Delta = rowsum(dO * O); per (query row,
// key) pair live under the forward's masks (kpos < Skv, qpos >= kpos when
// causal, qpos - kpos < window; keys at positions from 0, query row r at
// q_offset + r, as csrc/flash_attention.cu places them; ragged tiles
// zero-filled),
// P = exp(S * scale - lse) (0 elsewhere, so a row with no live key gets no
// gradient), dS = P (dP - Delta); dV = P^T dO with P rounded to bf16, dK =
// scale dS^T Q and dQ = scale dS K with dS rounded to bf16.  Three launches
// on one stream: delta_kernel, then the dK / dV kernel, then the dQ kernel.
// Under a q offset some key tiles see no query of this call (causal: the
// keys past q_offset + Sq - 1; a sequence-parallel rank's chunk sees only
// the keys up to its own last position): their walk is empty and both
// bodies write their dK / dV rows as zeros, since the wrapper allocates dK /
// dV uninitialised.
//
// bf16 (training's working type): warp-specialised wgmma kernels, 64-row
// tiles, 384 threads: warpgroup 0 is the producer (one warp issues TMA
// loads; setmaxnreg drops it to 40 registers), warpgroups 1 and 2 consume
// (raised to 232).
//   dkdv_wgmma, one block per (key tile of 64, q head): K and V of the tile
//     stay resident; the producer streams the q and dO tiles of each query
//     tile that sees the keys, with their lse and Delta rows, through a
//     two-stage ring (TMA into 128-byte swizzled boxes, full / empty
//     mbarriers), so loads overlap the products.  Warpgroup 1 computes S^T
//     = K Q^T on wgmma, forms P^T in registers and runs dV += P^T dO with
//     P^T as wgmma's register A operand (the f32 accumulator packs pairwise
//     into the next product's A fragment: S never goes to shared memory);
//     warpgroup 2 computes dP^T = V dO^T, takes P^T in f32 through two 16
//     KB exchange buffers used in turn (named barriers, so warpgroup 1 may
//     run a unit ahead), forms dS^T and runs dK += dS^T Q the same way.  The
//     same q / dO tiles serve both products: K-major for S^T and dP^T,
//     MN-major (the descriptor's transpose bit) for dV and dK.  The register
//     budget at D = 256 decides the split: dV and dK of a 64-key tile are
//     64 x 256 f32 each, 128 registers a thread for one warpgroup, so each
//     consumer owns one of them; S^T or dP^T (32), the bf16 A fragments
//     (16) and the rest fit 232.  Shared memory at D = 256: K, V 64 KB, two
//     stages of q and dO 128 KB, the exchange 32 KB: 226 KB of 227.
//   GQA inside a cluster: a kv head's G q heads run as G / H blocks of one
//     thread-block cluster of C = G / H blocks (cudaLaunchKernelEx with the
//     cluster dimension, a runtime value), each block walking H heads in
//     order.  The rule (kernels/flash_attention.py::bwd_plan): C is the
//     largest divisor of G that is at most 8, the portable cluster size; so
//     G <= 8 runs one head a block, G = 16 runs 8 blocks of 2, a prime G > 8
//     one block of G.  After the walk each block writes its f32 dK / dV to
//     its own shared memory, the cluster syncs, and block r sums chunk r of
//     the elements over ranks 0 .. C - 1 in that order through distributed
//     shared memory and writes bf16: a fixed order, no global scratch, no
//     atomics.  At gemma3-1b's training shape (B 4, S 1024, 4 / 1, D 256)
//     that is 16 x 4 x 4 = 256 blocks where one block a kv head gave 128.
//   dq_wgmma, one block per (query tile of 64, q head): q, dO, their lse
//     and Delta rows stay resident; the producer streams K and V tiles
//     through the two-stage ring.  Warpgroup 1 computes S = Q K^T and P,
//     warpgroup 2 dP = dO V^T; they trade P and dP in f32 through shared
//     memory, both form the same dS, and each runs dQ += dS K on its half of
//     D's columns from registers.  Each block owns its rows of dQ outright,
//     so it stays deterministic with no cross-block sum.
//   Causal balance: blocks are launched heaviest first.  The tile index is
//     the slowest grid dimension, and bwd_plan reverses it where the last
//     tile has more work than the first (causal dQ: the last query tile
//     sees every key tile; dK / dV: key tile 0 sees every query tile, so no
//     reversal).  Reversal was chosen over pairing tile i with n - 1 - i in
//     one block because the blocks are already two waves or more on 132
//     SMs at the training shape, so a greedy heaviest-first order finishes
//     the light tiles in the tail, and the blocks keep one tile's
//     resident state each.
//   P is exp2 of S * scale * log2(e) - lse * log2(e) on ex2.approx (the
//     producer stages lse pre-scaled); a tile pair whose every entry is live
//     skips the masks.  A unit's two products run one after the other: with
//     two stages at D = 256, issuing the next unit's scores ahead of this
//     unit's accumulation would hold its stage a unit longer and starve the
//     ring.
//   Every sum runs in a fixed order (the products' own, then heads, then
//     ranks), so two runs give the same bits.
//
// f32 inputs run a SIMT body (FA2's walk: BQ = 32 query rows, BKV = 32
// keys, 256 threads; each thread owns fixed elements of the sums, f32 FMA,
// never TF32), so the card can be held against the CPU in f32.
//
// This header holds both bodies; flash_attention_bwd.cu instantiates the
// bf16 one and flash_attention_bwd_f32.cu the f32 one, so they compile in
// two nvcc processes at once.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;          // threads a block of the SIMT body and delta_kernel: 8 warps
constexpr int NW = NT / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// f32: the SIMT body
// ---------------------------------------------------------------------------

constexpr int BKV = 32;          // keys a tile

template <typename T> struct Tile {
  static constexpr int BQ = 32;                         // query rows a tile
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
                                      int causal, int window, int q_offset, float scale) {
  using L = Layout<T, D>;
  for (int e = threadIdx.x; e < L::BQ * BKV; e += NT) {
    const int r = e / BKV, c = e % BKV, qpos = q_offset + q0 + r, kpos = k0 + c;
    bool live = q0 + r < Sq && kpos < Skv;
    if (causal) live = live && qpos >= kpos;
    if (window > 0) live = live && (qpos - kpos) < window;
    const float p = live ? expf(sm.s[r * L::SP + c] * scale - sm.lse[r]) : 0.f;
    const float ds = p * (sm.dp[r * L::SP + c] - sm.delta[r]);
    sm.p[r * L::PP + c] = from_f<T>(p);
    sm.ds[r * L::PP + c] = from_f<T>(ds);
  }
}

// Grid (ceil(Skv / BKV), B * Hkv).  q, dout (B, Sq, Hq, D), k, v, dk, dv
// (B, Skv, Hkv, D), lse, delta (B, Hq, Sq).
template <typename T, int D>
__global__ void __launch_bounds__(NT) dkdv_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
    int Hq, int Hkv, int causal, int window, int q_offset, float scale) {
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

  // Query rows that see any key of this tile (row r at q_offset + r); none
  // leaves the accumulators at zero.
  int q_lo = causal ? max(0, k0 - q_offset) : 0, q_hi = Sq;
  if (window > 0) q_hi = min(Sq, k0 + BKV - 1 + window - q_offset);
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
      probs<T, D>(sm, q0, k0, Sq, Skv, causal, window, q_offset, scale);
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
__global__ void __launch_bounds__(NT) dq_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
    int causal, int window, int q_offset, float scale) {
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
  if (causal) hi = min(hi, q_offset + min(q0 + L::BQ, Sq));
  if (window > 0) lo = max(0, q_offset + q0 - window + 1);
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
    probs<T, D>(sm, q0, k0, Sq, Skv, causal, window, q_offset, scale);
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

template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
           int Hq, int Hkv, int causal, int window, int q_offset, float scale, cudaStream_t st) {
  using L = Layout<T, D>;
  static bool raised_kv = false, raised_q = false;
  int err = raise_smem(dkdv_simt<T, D>, L::SMEM, raised_kv);
  if (!err) err = raise_smem(dq_simt<T, D>, L::SMEM, raised_q);
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
  dkdv_simt<T, D><<<dim3((Skv + BKV - 1) / BKV, B * Hkv), NT, L::SMEM, st>>>(
      qt, kt, vt, dot, lt, dl, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, Hkv,
      causal, window, q_offset, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dq_simt<T, D><<<dim3((Sq + L::BQ - 1) / L::BQ, B * Hq), NT, L::SMEM, st>>>(
      qt, kt, vt, dot, lt, dl, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, causal, window, q_offset,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// launch_simt<T, D> for D in {64, 128, 256}; cudaErrorInvalidValue otherwise.
template <typename T>
int launch_simt_d(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                 int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                 int q_offset, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_simt<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq,
                               Hkv, causal, window, q_offset, scale, st);
    case 128:
      return launch_simt<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                Hkv, causal, window, q_offset, scale, st);
    case 256:
      return launch_simt<T, 256>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                Hkv, causal, window, q_offset, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, warp specialisation, clusters
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int T = 64;              // query rows and keys a tile
constexpr int STAGES = 2;          // depth of the ring of streamed tiles
constexpr int THREADS = 384;       // the producer warpgroup and two consumers
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
// Named barriers of the consumers: dkdv_wgmma's READY and FREE alternate by
// unit (two ids each), dq_wgmma uses the first of each.
enum { BAR_READY = 1, BAR_FREE = 3, BAR_DONE = 5 };

// The first tile's first row and the tile count of a walk.
struct Span {
  int lo, n;
};

// Query tiles with a live entry for the key tile at k0, by their first rows
// (row r at q_offset + r; the same rule as kernels/flash_attention.py::
// q_tiles_of_key_tile).  Empty where no row sees the tile.
__device__ __forceinline__ Span q_span(int k0, int Sq, int Skv, int causal, int window,
                                       int q_offset) {
  const int kmax = min(k0 + T - 1, Skv - 1);
  const int lo = causal ? max(0, k0 - q_offset) : 0;
  int hi = Sq;
  if (window > 0) hi = min(hi, kmax + window - q_offset);
  return {lo, lo < hi ? (hi - lo + T - 1) / T : 0};
}

// Key tiles with a live entry for the query tile at q0
// (kernels/flash_attention.py::key_tiles_of_q_tile).
__device__ __forceinline__ Span k_span(int q0, int Sq, int Skv, int causal, int window,
                                       int q_offset) {
  int hi = Skv;
  if (causal) hi = min(hi, q_offset + min(q0 + T, Sq));
  const int lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  if (lo >= hi) return {0, 0};
  const int first = lo / T * T;
  return {first, (hi - first + T - 1) / T};
}

// Query row `row` (at q_offset + row) sees key kpos.
__device__ __forceinline__ bool live(int row, int kpos, int Sq, int Skv, int causal, int window,
                                     int q_offset) {
  const int qpos = q_offset + row;
  return row < Sq && kpos < Skv && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

// Every pair of the query tile at row q0 and the key tile at k0 is live:
// the tiles skip the masks.
__device__ __forceinline__ bool all_live(int q0, int k0, int Sq, int Skv, int causal,
                                         int window, int q_offset) {
  const int qpos = q_offset + q0;
  return q0 + T <= Sq && k0 + T <= Skv && (!causal || qpos >= k0 + T - 1) &&
         (window <= 0 || qpos + T - 1 - k0 < window);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Row and column of element i of a thread's m64nN accumulator (t: the
// thread's index in its warpgroup).
__device__ __forceinline__ int acc_row(int i, int t) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// The 64 x 64 product of K-major tiles a (rows) and b (columns) over D.
template <int D> __device__ __forceinline__ void scores(float (&x)[32], uint32_t a, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(x, desc_k(a, kk), desc_k(b, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(x);
}

// acc (64 x N) += x (64 x 64, rounded to bf16) times the MN-major tile at b.
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[N / 2], const float (&x)[32], uint32_t b) {
  uint32_t frag[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) frag[j] = pack_bf16(x[2 * j], x[2 * j + 1]);
  fence_regs(frag);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) wgmma_rs<N>(acc, &frag[4 * kk], desc_mn(b, kk));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(frag);
}

// 1024-byte aligned start of the dynamic shared memory (the swizzle's atom).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

template <int D> struct KvLayout {   // byte offsets of dkdv_wgmma's shared memory
  static constexpr int TILE = T * D * 2;                  // one 64-row bf16 tile: D / 64 boxes
  static constexpr int K = 0, V = TILE, STAGE = 2 * TILE; // stage s: q, then dO
  static constexpr int XBUF = STAGE + 2 * STAGES * TILE;  // P^T in f32, [element][thread], x 2
  static constexpr int ROWS = XBUF + 2 * T * T * 4;       // lse[STAGES][T], delta[STAGES][T]
  static constexpr int BARS = ROWS + 2 * STAGES * T * 4;  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
  static constexpr int PITCH = D + 8;                     // f32 partials of dK, dV after the walk
  static_assert(2 * T * PITCH * 4 <= XBUF, "the partials fit over the tiles");
};

// Grid (C, B * Hkv, key tiles), clusters of (C, 1, 1): block (r, b * Hkv +
// hk, z) walks q heads hk G + r H .. + H - 1 (H = heads_per_block) over the
// query tiles that see key tile z (reversed with kv_reverse), then the
// cluster sums its C partials.  dk, dv (B, Skv, Hkv, D); lse, delta (B, Hq,
// Sq).
template <int D>
__global__ void __launch_bounds__(THREADS, 1) dkdv_wgmma(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
    int q_offset, float scale, int heads_per_block, int kv_reverse) {
  using L = KvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(sm);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  float* rows = reinterpret_cast<float*>(sm + L::ROWS);
  float* xbuf = reinterpret_cast<float*>(sm + L::XBUF);

  const int C = gridDim.x, rank = blockIdx.x;
  const float scale2 = scale * LOG2E;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int k0 = (kv_reverse ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * T;
  // n = 0 (no query row sees the tile) writes zeros: the cluster's sum of
  // untouched accumulators.
  const Span sp = q_span(k0, Sq, Skv, causal, window, q_offset);
  const int n = heads_per_block * sp.n;                          // (head, query tile), heads outer
  const int h0 = hk * (Hq / Hkv) + rank * heads_per_block;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);        // the TMA's expect_tx, then each lane's lse / delta
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {   // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(kv_full, 2 * L::TILE);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sm + L::K + c * BOX_BYTES, &k_map, kv_full, c * 64, hk, k0, b);
          tma_load(sm + L::V + c * BOX_BYTES, &v_map, kv_full, c * 64, hk, k0, b);
        }
      }
      for (int u = 0; u < n; ++u) {
        const int s = u % STAGES, h = h0 + u / sp.n, a = sp.lo + (u % sp.n) * T;
        mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
        if (tid == 0) {
          unsigned char* st = sm + L::STAGE + s * 2 * L::TILE;
          mbar_expect_tx(&full[s], 2 * L::TILE);
          for (int c = 0; c < D / 64; ++c) {
            tma_load(st + c * BOX_BYTES, &q_map, &full[s], c * 64, h, a, b);
            tma_load(st + L::TILE + c * BOX_BYTES, &do_map, &full[s], c * 64, h, a, b);
          }
        }
        const long long off = ((long long)b * Hq + h) * Sq;
        for (int r = tid; r < T; r += 32) {
          const bool ok = a + r < Sq;
          rows[s * T + r] = ok ? lse[off + a + r] * LOG2E : 0.f;
          rows[(STAGES + s) * T + r] = ok ? delta[off + a + r] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    cluster_sync();   // the partials are written
    cluster_sync();   // every block has read them
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int t = tid % 128;
  const bool is_dv = tid < 256;   // warpgroup 1: S^T, P^T, dV; warpgroup 2: dP^T, dS^T, dK
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(kv_full, 0);
  for (int u = 0; u < n; ++u) {
    const int s = u % STAGES, a = sp.lo + (u % sp.n) * T;
    mbar_wait(&full[s], (u / STAGES) & 1);
    const uint32_t qt = sbase + L::STAGE + s * 2 * L::TILE, dot = qt + L::TILE;
    float x[32];
    scores<D>(x, sbase + (is_dv ? L::K : L::V), is_dv ? qt : dot);
    // P^T goes through two buffers, so warpgroup 1 runs up to a unit ahead.
    float* xb = xbuf + (u & 1) * T * T;
    if (is_dv) {
      const float* lse_s = rows + s * T;   // lse * log2(e)
      if (all_live(a, k0, Sq, Skv, causal, window, q_offset)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = ex2(fmaf(x[i], scale2, -lse_s[acc_col(i, t)]));
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = acc_col(i, t);
          x[i] = live(a + c, k0 + acc_row(i, t), Sq, Skv, causal, window, q_offset)
                     ? ex2(fmaf(x[i], scale2, -lse_s[c])) : 0.f;
        }
      }
      if (u >= 2) bar_sync(BAR_FREE + (u & 1), CONSUMERS);   // unit u - 2's P^T is read
#pragma unroll
      for (int i = 0; i < 32; ++i) xb[i * 128 + t] = x[i];
      bar_arrive(BAR_READY + (u & 1), CONSUMERS);
      accumulate<D>(acc, x, dot);                     // dV += P^T dO
    } else {
      const float* delta_s = rows + (STAGES + s) * T;
      bar_sync(BAR_READY + (u & 1), CONSUMERS);
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = xb[i * 128 + t] * (x[i] - delta_s[acc_col(i, t)]);
      if (u + 2 < n) bar_arrive(BAR_FREE + (u & 1), CONSUMERS);
      accumulate<D>(acc, x, qt);                      // dK += dS^T Q
    }
    mbar_arrive(&empty[s]);
  }

  // The cluster's sum: each block's partials over its own tiles, then block
  // `rank` adds chunk `rank` of them over ranks 0 .. C - 1 in order.
  bar_sync(BAR_DONE, CONSUMERS);   // both consumers are done with every tile
  float* part = reinterpret_cast<float*>(sm);
  {
    float* mine = part + (is_dv ? T * L::PITCH : 0);
    const float mul = is_dv ? 1.f : scale;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2)
      *reinterpret_cast<float2*>(mine + acc_row(i, t) * L::PITCH + acc_col(i, t)) =
          make_float2(acc[i] * mul, acc[i + 1] * mul);
  }
  cluster_sync();
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  constexpr int QUADS = 2 * T * D / 4;   // float4s of dK, then dV
  const long long kv_row = (long long)Hkv * D;
  for (int e = rank * QUADS / C + tid - 128; e < (rank + 1) * QUADS / C; e += CONSUMERS) {
    const int which = e / (T * D / 4), r = e / (D / 4) % T, c = e % (D / 4) * 4;
    if (k0 + r >= Skv) continue;
    float* src = part + which * T * L::PITCH + r * L::PITCH + c;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int from = 0; from < C; ++from) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, from));
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    bf16* dst = (which ? dv : dk) + ((long long)b * Skv + k0 + r) * kv_row + (long long)hk * D + c;
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
  }
  cluster_sync();
}

template <int D> struct QLayout {   // byte offsets of dq_wgmma's shared memory
  static constexpr int TILE = T * D * 2;
  static constexpr int Q = 0, DO = TILE, STAGE = 2 * TILE;  // stage s: K, then V
  static constexpr int XP = STAGE + 2 * STAGES * TILE;      // P, then dP, in f32
  static constexpr int ROWS = XP + 2 * T * T * 4;           // lse[T], delta[T]
  static constexpr int BARS = ROWS + 2 * T * 4;             // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// Grid (B * Hq, query tiles): block (b * Hq + h, y) takes query tile y
// (reversed with q_reverse) of head h over the key tiles it sees.  dq (B,
// Sq, Hq, D).
template <int D>
__global__ void __launch_bounds__(THREADS, 1) dq_wgmma(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    int Sq, int Skv, int Hq, int Hkv, int causal, int window, int q_offset, float scale,
    int q_reverse) {
  using L = QLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(sm);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  float* rows = reinterpret_cast<float*>(sm + L::ROWS);
  float* xbuf = reinterpret_cast<float*>(sm + L::XP);

  const int q0 = (q_reverse ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * T;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hkv);
  const Span sp = k_span(q0, Sq, Skv, causal, window, q_offset);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1 + 32);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {   // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(q_full, 2 * L::TILE);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sm + L::Q + c * BOX_BYTES, &q_map, q_full, c * 64, h, q0, b);
          tma_load(sm + L::DO + c * BOX_BYTES, &do_map, q_full, c * 64, h, q0, b);
        }
      }
      const long long off = ((long long)b * Hq + h) * Sq;
      for (int r = tid; r < T; r += 32) {
        const bool ok = q0 + r < Sq;
        rows[r] = ok ? lse[off + q0 + r] : 0.f;
        rows[T + r] = ok ? delta[off + q0 + r] : 0.f;
      }
      mbar_arrive(q_full);
      if (tid == 0) {
        for (int u = 0; u < sp.n; ++u) {
          const int s = u % STAGES, c0 = sp.lo + u * T;
          unsigned char* st = sm + L::STAGE + s * 2 * L::TILE;
          mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * L::TILE);
          for (int c = 0; c < D / 64; ++c) {
            tma_load(st + c * BOX_BYTES, &k_map, &full[s], c * 64, hk, c0, b);
            tma_load(st + L::TILE + c * BOX_BYTES, &v_map, &full[s], c * 64, hk, c0, b);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int t = tid % 128, half = tid / 128 - 1;
  const bool is_s = half == 0;    // warpgroup 1: S, P; warpgroup 2: dP; both: dS, dQ's half
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);
  const int r0 = acc_row(0, t);
  const float lse0 = rows[r0] * LOG2E, lse1 = rows[r0 + 8] * LOG2E;
  const float dl0 = rows[T + r0], dl1 = rows[T + r0 + 8], scale2 = scale * LOG2E;
  float* mine = xbuf + (is_s ? 0 : T * T);
  const float* theirs = xbuf + (is_s ? T * T : 0);
  // dQ's half of D's columns: box (half D / 2) / 64, then (half D / 2) % 64 bf16 into it.
  const uint32_t col = (half * D / 2) / 64 * BOX_BYTES + (half * D / 2) % 64 * 2;
  for (int u = 0; u < sp.n; ++u) {
    const int s = u % STAGES, c0 = sp.lo + u * T;
    mbar_wait(&full[s], (u / STAGES) & 1);
    const uint32_t kt = sbase + L::STAGE + s * 2 * L::TILE, vt = kt + L::TILE;
    float x[32];
    scores<D>(x, sbase + (is_s ? L::Q : L::DO), is_s ? kt : vt);
    if (is_s) {
      if (all_live(q0, c0, Sq, Skv, causal, window, q_offset)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = ex2(fmaf(x[i], scale2, -((i >> 1) & 1 ? lse1 : lse0)));
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          x[i] = live(q0 + acc_row(i, t), c0 + acc_col(i, t), Sq, Skv, causal, window, q_offset)
                     ? ex2(fmaf(x[i], scale2, -((i >> 1) & 1 ? lse1 : lse0))) : 0.f;
      }
    }
    if (u > 0) bar_sync(BAR_FREE, CONSUMERS);   // both have read the last P and dP
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * 128 + t] = x[i];
    bar_sync(BAR_READY, CONSUMERS);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float o = theirs[i * 128 + t], p = is_s ? x[i] : o, dp = is_s ? o : x[i];
      x[i] = p * (dp - ((i >> 1) & 1 ? dl1 : dl0));
    }
    accumulate<D / 2>(acc, x, kt + col);   // dQ[:, half] += dS K[:, half]
    mbar_arrive(&empty[s]);
  }
  const long long q_row = (long long)Hq * D;
#pragma unroll
  for (int i = 0; i < D / 4; i += 2) {
    const int r = q0 + acc_row(i, t);
    if (r < Sq)
      *reinterpret_cast<uint32_t*>(dq + ((long long)b * Sq + r) * q_row + (long long)h * D +
                                   half * D / 2 + acc_col(i, t)) =
          pack_bf16(acc[i] * scale, acc[i + 1] * scale);
  }
}

// The tensor maps of q, k, v and dout, encoded on every launch (the
// pointers change from call to call).
inline int encode_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                       const void* dout, int B, int Sq, int Skv, int Hq, int Hkv, int D) {
  int err;
  if ((err = encode_rows(&m[0], q, B, Sq, Hq, D)) ||
      (err = encode_rows(&m[1], k, B, Skv, Hkv, D)) ||
      (err = encode_rows(&m[2], v, B, Skv, Hkv, D)))
    return err;
  return encode_rows(&m[3], dout, B, Sq, Hq, D);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
           int Hq, int Hkv, int causal, int window, int q_offset, float scale, int cluster,
           int heads_per_block, int kv_reverse, int q_reverse, cudaStream_t st) {
  if (cluster < 1 || cluster > 8 || heads_per_block < 1 || cluster * heads_per_block * Hkv != Hq)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool raised_kv = false, raised_q = false;
  int err = raise_smem(dkdv_wgmma<D>, KvLayout<D>::BYTES, raised_kv);
  if (!err) err = raise_smem(dq_wgmma<D>, QLayout<D>::BYTES, raised_q);
  if (err) return err;
  CUtensorMap m[4];
  if ((err = encode_maps(m, q, k, v, dout, B, Sq, Skv, Hq, Hkv, D))) return err;
  const float* lt = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int rows = B * Sq * Hq;
  delta_kernel<bf16, D><<<(rows + NW - 1) / NW, NT, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), dl, rows, Sq, Hq);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B * Hkv, (Skv + T - 1) / T);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = KvLayout<D>::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, dkdv_wgmma<D>, m[0], m[1], m[2], m[3], lt,
                                            static_cast<const float*>(dl), static_cast<bf16*>(dk),
                                            static_cast<bf16*>(dv), Sq, Skv, Hq, Hkv, causal,
                                            window, q_offset, scale, heads_per_block,
                                            kv_reverse));
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dq_wgmma<D><<<dim3(B * Hq, (Sq + T - 1) / T), THREADS, QLayout<D>::BYTES, st>>>(
      m[0], m[1], m[2], m[3], lt, dl, static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv, causal, window,
      q_offset, scale, q_reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace
