// Paged flash-decode for Hopper (sm_90a): attention for Sq query positions
// per slot, read straight from the paged KV pool through the block tables.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::_decode_kernel
// (entry flash_decode_attention) and its stage-2 merge _combine_splits.  On
// the TPU the block tables arrive by scalar prefetch, the grid walks one
// slot's table columns in order, and a (rows, D) f32 accumulator sits in
// VMEM per (slot, kv head).  Here every block loads its own table entries
// from device memory, walks its split's columns in a loop, and keeps the
// online-softmax state (m, l, acc) in registers; splits > 1 write partials
// that a second kernel merges exactly as _combine_splits does.
//
// What bounds it on the H100: bytes.  Each live pool block is read once per
// (slot, kv head, row tile) and the arithmetic is ~2 * rows FLOPs per K/V
// element, far below the ridge.  The TPU kernel's accumulator for a gemma3
// prefill chunk (G * Sq = 4 * 64 rows x D = 256 x 4 B = 256 KB) would not fit
// the 227 KB of shared memory a block may use, so the packed query rows are
// tiled, RT rows per block, and the grid runs over the tiles.
//
// What this simple design does about it: each column step copies one pool
// block (bs x D) of K and V into shared memory with coalesced loads, and the
// next block's loads are in flight, staged in registers, while the current
// one is processed; the
// walk stops at the slot's last live column and, for sliding-window layers,
// starts at the first column the window can see, so no dead block is read.
// A later PR feeds the split kernel with cp.async/TMA multi-stage copies of
// several blocks ahead and picks the split count from the live lengths.
//
// int8 pools (the reference's quantized branch, flash_decode.py:113-132):
// the pools hold int8 codes and a float32 scale per (block, position, kv
// head); each K/V element is dequantized as it is loaded, code * scale in
// f32, before it reaches shared memory, so the math below is the float
// branch's.  That halves the pool bytes a bf16 pool moves (8192 B of codes
// plus 128 B of scales per block of 16 x 256 against 16384 B).
//
// Numerics follow the reference: the masked score is the finite sentinel
// NEG_INF = -2e38 (never -inf: a masked score against m = NEG_INF gives
// exp(0) = 1 and a later live key wipes it through alpha = exp(-2e38 - m)
// = 0, where -inf would give NaN), and l is floored at 1e-30.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int KV_PER = 16;       // K (and V) elements per thread per pool block
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename O> __device__ __forceinline__ O from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Grid (B * Hkv, splits, row tiles of RT rows).  Packed row r = g * Sq + t
// holds query head h * G + g at position index[b] + t.  Thread tid owns
// output column d = tid % D of rows tid / D + RSTEP * i.  A decode step
// (G * Sq = 4 rows) runs RT = 4, a prefill chunk RT = 16.  P is the pool's
// element type: T, or int8_t with the scale pools k_scale / v_scale.
template <typename T, typename P, int D, int RT>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ index, T* __restrict__ out,
    float* __restrict__ acc_ws, float* __restrict__ m_ws,
    float* __restrict__ l_ws, int Sq, int Hkv, int G, int bs, int max_blocks,
    int cols_per_split, int splits, int window, float scale) {
  constexpr int RSTEP = NT / D;
  static_assert(RT % RSTEP == 0, "row tile must cover whole thread rows");
  constexpr int RPT = RT / RSTEP;
  extern __shared__ float smem[];
  float* q_s = smem;                    // RT x D, pre-scaled
  float* k_s = q_s + RT * D;            // bs x (D + 1): conflict-free dot reads
  float* v_s = k_s + bs * (D + 1);      // bs x D
  float* p_s = v_s + bs * D;            // RT x bs scores, then probabilities
  float* alpha_s = p_s + RT * bs;       // RT
  float* m_s = alpha_s + RT;            // RT
  float* l_s = m_s + RT;                // RT

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int s = blockIdx.y;
  const int r0 = blockIdx.z * RT;
  const int rows = G * Sq;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int idx = index[b];
  const int seq_cap = max_blocks * bs;
  // Each score is a D-long dot product split over tps neighbouring lanes
  // (a power of two, so a group never straddles a warp) when the tile has
  // fewer scores than threads; partial sums meet by warp shuffles.
  const int n_scores = RT * bs;
  int tps = 1;
  while (tps < 32 && tps * 2 * n_scores <= NT) tps *= 2;
  const int n_groups = NT / tps, grp = tid / tps, lane_g = tid % tps;
  const int score_iters = (n_scores + n_groups - 1) / n_groups;

  for (int e = tid; e < RT * D; e += NT) {
    const int r = e / D, d = e % D, row = r0 + r;
    float val = 0.f;
    if (row < rows) {
      const int g = row / Sq, t = row % Sq;
      val = to_f(q[(((long long)b * Sq + t) * Hq + h * G + g) * D + d]) * scale;
    }
    q_s[e] = val;
  }

  const int d_own = tid % D, r_own = tid / D;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;   // row tid's state, for tid < RT

  // This split's table columns, clipped to the columns a query can see:
  // none past the last query position, none wholly before the window.
  int c_begin = s * cols_per_split;
  int c_end = min(c_begin + cols_per_split, max_blocks);
  c_end = min(c_end, (idx + Sq - 1) / bs + 1);
  if (window > 0 && idx - window + 1 > 0) c_begin = max(c_begin, (idx - window + 1) / bs);
  __syncthreads();

  // The next column's K/V (at most KV_PER elements each per thread: the
  // wrapper caps block_size * D at KV_PER * NT) and table entry are loaded
  // into registers while the current column is processed.
  float rk[KV_PER], rv[KV_PER];
  auto load_col = [&](int col) {
    const long long blk = tables[(long long)b * max_blocks + col];
#pragma unroll
    for (int i = 0; i < KV_PER; ++i) {
      const int e = tid + i * NT;
      if (e < bs * D) {
        const int p = e / D, d = e % D;
        const long long row = (blk * bs + p) * Hkv + h;
        rk[i] = to_f(k_pool[row * D + d]);
        rv[i] = to_f(v_pool[row * D + d]);
        if constexpr (std::is_same<P, int8_t>::value) {   // dequantize in registers
          rk[i] *= k_scale[row];
          rv[i] *= v_scale[row];
        }
      }
    }
  };
  if (c_begin < c_end) load_col(c_begin);

  for (int col = c_begin; col < c_end; ++col) {
#pragma unroll
    for (int i = 0; i < KV_PER; ++i) {
      const int e = tid + i * NT;
      if (e < bs * D) {
        const int p = e / D, d = e % D;
        k_s[p * (D + 1) + d] = rk[i];
        v_s[p * D + d] = rv[i];
      }
    }
    __syncthreads();
    if (col + 1 < c_end) load_col(col + 1);   // in flight during the math below
    for (int it = 0; it < score_iters; ++it) {   // same trip count on every lane
      const int e = grp + it * n_groups;
      const bool act = e < n_scores;
      const int r = act ? e / bs : 0, p = act ? e % bs : 0;
      float sc = 0.f;
      if (act) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + p * (D + 1);
#pragma unroll 8
        for (int d = lane_g; d < D; d += tps) sc = fmaf(qr[d], kr[d], sc);
      }
      for (int off = tps / 2; off > 0; off /= 2)
        sc += __shfl_xor_sync(0xffffffffu, sc, off);
      if (act && lane_g == 0) {
        const int qpos = idx + (r0 + r) % Sq;
        const int kpos = col * bs + p;
        bool live = kpos <= qpos && kpos < seq_cap;
        if (window > 0) live = live && (qpos - kpos) < window;
        p_s[e] = live ? sc : NEG_INF;
      }
    }
    __syncthreads();
    if (tid < RT) {
      float* pr = p_s + tid * bs;
      float m_new = m_run;
      for (int p = 0; p < bs; ++p) m_new = fmaxf(m_new, pr[p]);
      float sum = 0.f;
      for (int p = 0; p < bs; ++p) {
        const float e = expf(pr[p] - m_new);
        pr[p] = e;
        sum += e;
      }
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r_own + RSTEP * i;
      const float* pr = p_s + r * bs;
      float pv = 0.f;
      for (int p = 0; p < bs; ++p) pv = fmaf(pr[p], v_s[p * D + d_own], pv);
      acc[i] = acc[i] * alpha_s[r] + pv;
    }
    __syncthreads();   // k_s / v_s / p_s are overwritten by the next column
  }

  if (tid < RT) {
    m_s[tid] = m_run;
    l_s[tid] = l_run;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r_own + RSTEP * i, row = r0 + r;
    if (row >= rows) continue;
    if (splits == 1) {
      const int g = row / Sq, t = row % Sq;
      out[(((long long)b * Sq + t) * Hq + h * G + g) * D + d_own] =
          from_f<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    } else {
      const long long base = (((long long)b * Hkv + h) * splits + s) * rows + row;
      acc_ws[base * D + d_own] = acc[i];
      if (d_own == 0) {
        m_ws[base] = m_s[r];
        l_ws[base] = l_s[r];
      }
    }
  }
}

// Stage 2 (_combine_splits): grid (B * Hkv, rows), D threads.
template <typename T, int D>
__global__ void decode_combine_kernel(const float* __restrict__ acc_ws,
                                      const float* __restrict__ m_ws,
                                      const float* __restrict__ l_ws,
                                      T* __restrict__ out, int Sq, int Hkv,
                                      int G, int splits) {
  const int bh = blockIdx.x, row = blockIdx.y, d = threadIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int rows = G * Sq;
  const long long base = (long long)bh * splits * rows + row;
  float m_g = NEG_INF;
  for (int s = 0; s < splits; ++s) m_g = fmaxf(m_g, m_ws[base + (long long)s * rows]);
  float l_g = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long i = base + (long long)s * rows;
    const float alpha = expf(m_ws[i] - m_g);
    l_g += l_ws[i] * alpha;
    a += acc_ws[i * D + d] * alpha;
  }
  const int g = row / Sq, t = row % Sq;
  out[(((long long)b * Sq + t) * (Hkv * G) + h * G + g) * D + d] =
      from_f<T>(a / fmaxf(l_g, 1e-30f));
}

template <typename T, typename P, int D, int RT>
int launch_rt(const void* q, const void* k_pool, const void* v_pool,
              const float* k_scale, const float* v_scale, const int* tables,
              const int* index, void* out, float* acc_ws, float* m_ws, float* l_ws,
              int B, int Sq, int Hkv, int G, int bs, int max_blocks, int splits,
              int window, float scale, cudaStream_t stream) {
  const int rows = G * Sq;
  const int cols_per_split = (max_blocks + splits - 1) / splits;
  const size_t smem = sizeof(float) *
      ((size_t)RT * D + (size_t)bs * (D + 1) + (size_t)bs * D + (size_t)RT * bs + 3 * RT);
  auto kern = decode_split_kernel<T, P, D, RT>;
  // Raise the dynamic shared-memory cap once per instantiation (and again
  // only for a larger block size), never per launch: launches may be
  // captured into a CUDA graph.
  static size_t smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_cap = smem;
  }
  dim3 grid(B * Hkv, splits, (rows + RT - 1) / RT);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables, index, static_cast<T*>(out),
      acc_ws, m_ws, l_ws, Sq, Hkv, G, bs, max_blocks, cols_per_split, splits,
      window, scale);
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_combine_kernel<T, D><<<dim3(B * Hkv, rows), D, 0, stream>>>(
        acc_ws, m_ws, l_ws, static_cast<T*>(out), Sq, Hkv, G, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, int D>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const float* k_scale, const float* v_scale, const int* tables,
                 const int* index, void* out, float* acc_ws, float* m_ws, float* l_ws,
                 int B, int Sq, int Hkv, int G, int bs, int max_blocks, int splits,
                 int window, float scale, cudaStream_t stream) {
  if (G * Sq <= 4)
    return launch_rt<T, P, D, 4>(q, k_pool, v_pool, k_scale, v_scale, tables, index, out,
                                 acc_ws, m_ws, l_ws, B, Sq, Hkv, G, bs, max_blocks, splits,
                                 window, scale, stream);
  return launch_rt<T, P, D, 16>(q, k_pool, v_pool, k_scale, v_scale, tables, index, out,
                                acc_ws, m_ws, l_ws, B, Sq, Hkv, G, bs, max_blocks, splits,
                                window, scale, stream);
}

template <typename T, typename P>
int launch_d(const void* q, const void* k_pool, const void* v_pool,
             const float* k_scale, const float* v_scale, const int* tables,
             const int* index, void* out, float* acc_ws, float* m_ws, float* l_ws,
             int B, int Sq, int Hkv, int G, int D, int bs, int max_blocks,
             int splits, int window, float scale, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_typed<T, P, 64>(q, k_pool, v_pool, k_scale, v_scale, tables, index, out,
                                    acc_ws, m_ws, l_ws, B, Sq, Hkv, G, bs, max_blocks,
                                    splits, window, scale, st);
    case 128:
      return launch_typed<T, P, 128>(q, k_pool, v_pool, k_scale, v_scale, tables, index, out,
                                     acc_ws, m_ws, l_ws, B, Sq, Hkv, G, bs, max_blocks,
                                     splits, window, scale, st);
    case 256:
      return launch_typed<T, P, 256>(q, k_pool, v_pool, k_scale, v_scale, tables, index, out,
                                     acc_ws, m_ws, l_ws, B, Sq, Hkv, G, bs, max_blocks,
                                     splits, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out (B, Sq, Hkv * G, D) in dtype_code's dtype (0 = float32, 1 =
// bfloat16); k_pool, v_pool (nb, bs, Hkv, D) in q's dtype (pool_code 0) or
// int8 (pool_code 1) with k_scale, v_scale (nb, bs, Hkv) float32; tables
// (B, max_blocks) and index (B,) int32.  acc_ws (B, Hkv, splits, G * Sq, D),
// m_ws and l_ws (B, Hkv, splits, G * Sq) float32 are used only when
// splits > 1.  window <= 0 means no sliding window.  Returns the cudaError_t.
extern "C" int flash_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* index, void* out, void* acc_ws,
                                   void* m_ws, void* l_ws, int B, int Sq,
                                   int Hkv, int G, int D, int bs, int max_blocks,
                                   int splits, int window, float scale,
                                   int dtype_code, int pool_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* t = static_cast<const int*>(tables);
  const int* ix = static_cast<const int*>(index);
  float* a = static_cast<float*>(acc_ws);
  float* m = static_cast<float*>(m_ws);
  float* l = static_cast<float*>(l_ws);
  if (dtype_code == 0 && pool_code == 0)
    return launch_d<float, float>(q, k_pool, v_pool, ks, vs, t, ix, out, a, m, l, B, Sq, Hkv,
                                  G, D, bs, max_blocks, splits, window, scale, st);
  if (dtype_code == 1 && pool_code == 0)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, ks, vs, t, ix, out, a, m,
                                                  l, B, Sq, Hkv, G, D, bs, max_blocks, splits,
                                                  window, scale, st);
  if (dtype_code == 0 && pool_code == 1)
    return launch_d<float, int8_t>(q, k_pool, v_pool, ks, vs, t, ix, out, a, m, l, B, Sq, Hkv,
                                   G, D, bs, max_blocks, splits, window, scale, st);
  if (dtype_code == 1 && pool_code == 1)
    return launch_d<__nv_bfloat16, int8_t>(q, k_pool, v_pool, ks, vs, t, ix, out, a, m, l, B,
                                           Sq, Hkv, G, D, bs, max_blocks, splits, window,
                                           scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
