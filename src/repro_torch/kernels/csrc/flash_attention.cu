// Flash attention for Hopper (sm_90a): full-sequence attention with causal
// and sliding-window masks and GQA, online softmax, nothing of the (Sq, Skv)
// score matrix in device memory.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// _flash_kernel (entry flash_attention).  On the TPU the grid walks
// (b, q head, q tile of 512 rows, kv tile of 512 keys) with the kv axis
// innermost and sequential, carrying (m, l, acc) for a 512 x D tile in VMEM
// from one kv step to the next.  Here one block owns (b, q head, BQ query
// rows) and walks the kv tiles in a loop, with the online-softmax state in
// registers; the kv head is h / (Hq / Hkv).
//
// What bounds it on the H100: operations.  Causal attention over S keys does
// ~2 * S^2 * D multiply-adds per (b, q head) (half of the full square), far
// above the ~295 FLOP/byte ridge at S = 1024; the bytes are q, k, v and out,
// read or written once.  What this simple design does about it: q rows (BQ
// = 32) are staged once per block, pre-scaled, in shared memory; every K/V
// tile of BK = 32 keys is staged once per block and serves all BQ rows, so
// device-memory traffic is (Sq / BQ) passes over K/V per q head; tiles that
// lie wholly above the causal diagonal or wholly before the window are never
// read.  The products are SIMT FMA in f32 (never TF32): at head_dim 256 a
// 32-row f32 accumulator is 32 registers per thread at 256 threads, so it
// stays in registers without spilling.  A later PR moves QK^T and PV onto
// wgmma with TMA-fed K/V stages.
//
// Numerics follow the reference kernel (flash_attention.py:41-71): q is
// scaled by D^-0.5 in f32 before the dot; the masks are kpos < Skv, qpos >=
// kpos when causal, qpos - kpos < window, positions from 0 for q and k; the
// masked score is the finite sentinel NEG_INF = -2e38 (a row whose first
// tile is wholly masked gets p = exp(0) = 1 there and the next tile's alpha
// = exp(-2e38 - m) = 0 wipes it; -inf would give NaN); p is rounded to v's
// dtype before PV while l sums the unrounded p; out = acc / max(l, 1e-30)
// in q's dtype.  Skipping a wholly masked tile is exact: one met first
// would be wiped by alpha = 0, one met later adds p = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int BQ = 32;           // query rows per block
constexpr int BK = 32;           // keys per K/V tile
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p rounded to v's dtype and back (p.astype(v.dtype) in the reference).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Grid (ceil(Sq / BQ), B * Hq).  q, out (B, Sq, Hq, D) and k, v (B, Skv,
// Hkv, D), all contiguous.  window <= 0 means none.  Scores: thread tid
// computes key c = tid % BK for rows (tid / BK) * 4 .. + 3.  PV: thread tid
// owns output column d = tid % D of rows tid / D + RSTEP * i.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Skv, int Hq, int Hkv, int causal,
    int window, float scale) {
  constexpr int RSTEP = NT / D;
  constexpr int RPT = BQ / RSTEP;       // output rows per thread
  constexpr int SROWS = BQ * BK / NT;   // score rows per thread
  static_assert(BQ % RSTEP == 0 && (BQ * BK) % NT == 0, "tile shape");
  extern __shared__ float smem[];
  float* q_s = smem;                    // BQ x D, pre-scaled
  float* k_s = q_s + BQ * D;            // BK x (D + 1): conflict-free dot reads
  float* v_s = k_s + BK * (D + 1);      // BK x D
  float* p_s = v_s + BK * D;            // BQ x BK scores, then probabilities
  float* alpha_s = p_s + BQ * BK;       // BQ
  float* l_s = alpha_s + BQ;            // BQ

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D, row = q0 + r;
    q_s[e] = row < Sq ? to_f(q[(((long long)b * Sq + row) * Hq + h) * D + d]) * scale : 0.f;
  }

  // kv tiles any row of this block can see.
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, min(q0 + BQ, Sq));
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = (lo / BK) * BK;

  const int d_own = tid % D, r_own = tid / D;
  const int c_own = tid % BK, sr0 = (tid / BK) * SROWS;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;   // row tid's state, for tid < BQ

  for (int kt = lo; kt < hi; kt += BK) {
    __syncthreads();   // q_s written / previous tile fully consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D, key = kt + c;
      float kv = 0.f, vv = 0.f;
      if (key < Skv) {
        const long long off = (((long long)b * Skv + key) * Hkv + hk) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      k_s[c * (D + 1) + d] = kv;
      v_s[c * D + d] = vv;
    }
    __syncthreads();
    {
      float sc[SROWS];
#pragma unroll
      for (int i = 0; i < SROWS; ++i) sc[i] = 0.f;
      const float* kr = k_s + c_own * (D + 1);
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int i = 0; i < SROWS; ++i) sc[i] = fmaf(q_s[(sr0 + i) * D + d], kd, sc[i]);
      }
      const int kpos = kt + c_own;
#pragma unroll
      for (int i = 0; i < SROWS; ++i) {
        const int qpos = q0 + sr0 + i;
        bool live = kpos < Skv;
        if (causal) live = live && qpos >= kpos;
        if (window > 0) live = live && (qpos - kpos) < window;
        p_s[(sr0 + i) * BK + c_own] = live ? sc[i] : NEG_INF;
      }
    }
    __syncthreads();
    if (tid < BQ) {
      float* pr = p_s + tid * BK;
      float m_new = m_run;
      for (int c = 0; c < BK; ++c) m_new = fmaxf(m_new, pr[c]);
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        const float p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = round_to<T>(p);
      }
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();
    float pv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) pv[i] = 0.f;
    for (int c = 0; c < BK; ++c) {
      const float vv = v_s[c * D + d_own];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = fmaf(p_s[(r_own + RSTEP * i) * BK + c], vv, pv[i]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = acc[i] * alpha_s[r_own + RSTEP * i] + pv[i];
  }

  if (tid < BQ) l_s[tid] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r_own + RSTEP * i, row = q0 + r;
    if (row >= Sq) continue;
    out[(((long long)b * Sq + row) * Hq + h) * D + d_own] =
        from_f<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                 int Skv, int Hq, int Hkv, int causal, int window, float scale,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D + (size_t)BQ * BK + 2 * BQ);
  auto kern = flash_kernel<T, D>;
  // Raise the dynamic shared-memory cap once per instantiation, never per
  // launch: launches may be captured into a CUDA graph.
  static bool raised = false;
  if (smem > 48 * 1024 && !raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv,
                                   Hq, Hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
             int Hq, int Hkv, int D, int causal, int window, float scale, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_typed<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, scale, st);
    case 128:
      return launch_typed<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, scale, st);
    case 256:
      return launch_typed<T, 256>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); all contiguous, in
// dtype_code's dtype (0 = float32, 1 = bfloat16).  Hq a multiple of Hkv; D in
// {64, 128, 256}; window <= 0 means no sliding window.  Returns the launch's
// cudaError_t (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                                      int D, int causal, int window, float scale,
                                      int dtype_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_d<float>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, scale, st);
  if (dtype_code == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window,
                                   scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
