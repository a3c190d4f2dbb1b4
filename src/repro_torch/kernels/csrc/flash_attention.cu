// Flash attention for Hopper (sm_90a): full-sequence attention with causal
// and sliding-window masks and GQA, online softmax, nothing of the (Sq, Skv)
// score matrix in device memory.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// _flash_kernel (entry flash_attention).  On the TPU the grid walks
// (b, q head, q tile of 512 rows, kv tile of 512 keys) with the kv axis
// innermost and sequential, carrying (m, l, acc) for a 512 x D tile in VMEM
// from one kv step to the next.  Here one block owns (b, q head, a tile of
// query rows) and walks the kv tiles in a loop, with the online-softmax
// state in registers; the kv head is h / (Hq / Hkv).  One block per q head:
// the G q heads of a kv head each read its K/V tiles (through L2).
//
// What bounds it on the H100: operations.  Causal attention over S keys does
// ~2 * S^2 * D multiply-adds per (b, q head) (half of the full square), far
// above the ~295 FLOP/byte ridge at S = 1024; the bytes are q, k, v and out,
// read or written once.  Tiles that lie wholly above the causal diagonal or
// wholly before the window are never read, in both bodies below.
//
// bf16 inputs (the forward's working type) run on the tensor cores
// (mma_kernel): a block owns BQ = 64 query rows and runs two warp groups of
// 4 warps, 16 rows a warp; the groups take alternate K/V tiles of BK keys
// (64, or 32 at D = 256 to keep the accumulator in registers), each double-
// buffered by 16-byte cp.async into XOR-swizzled shared memory and read by
// ldmatrix, and merge their (m, l, acc) at the end, so the longest (causal)
// rows run as two half-length chains and an SM holds 8 warps.  QK^T and PV
// are mma.sync m16n8k16 bf16 -> f32.  S and the output accumulator live in
// registers (at D = 256 the accumulator is 128 f32 per thread); the online
// softmax runs on the mma fragments, each row's max and sum reduced over
// its 4 lanes by shuffles, and p goes from the S fragments straight into
// PV's A operand.  The last query tiles (the longest causal rows) are
// scheduled first.
//
// f32 inputs keep the SIMT body (simt::flash_kernel): q rows (BQ = 32) are
// staged once per block, pre-scaled, in shared memory; every K/V tile of BK
// = 32 keys is staged once per block and serves all BQ rows; the products
// are f32 FMA (never TF32), so it matches the plain version within 1e-5.
//
// Numerics follow the reference kernel (flash_attention.py:41-71): the masks
// are kpos < Skv, qpos >= kpos when causal, qpos - kpos < window, positions
// from 0 for q and k; the masked score is the finite sentinel NEG_INF =
// -2e38 (a row whose first tile is wholly masked gets p = exp(0) = 1 there
// and the next tile's alpha = exp(-2e38 - m) = 0 wipes it; -inf would give
// NaN); p is rounded to v's dtype before PV while l sums the unrounded p;
// out = acc / max(l, 1e-30) in q's dtype.  Skipping a wholly masked tile is
// exact: one met first would be wiped by alpha = 0, one met later adds
// p = 0.  The f32 body scales q by D^-0.5 in f32 before the dot, as the
// reference does; the bf16 body scales the f32 scores after the product
// instead (the product of two bf16 values is exact in f32, so QK^T on the
// tensor cores is the reference's f32 dot up to summation order, while
// rounding bf16(q * scale) would change q whenever the scale is not a power
// of two).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace mma {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;          // 2 warp groups of 4 warps
constexpr int BQ = 64;           // query rows per block, 16 per warp of a group

template <int D> struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;   // keys per K/V tile
  // q, then per warp group K and V double-buffered
  static constexpr size_t SMEM = sizeof(bf16) * ((size_t)BQ * D + 8 * (size_t)BK * D);
};

// Element offset of 16-byte chunk c of row r in a tile of D bf16 per row,
// XOR-swizzled so that the 8 rows one ldmatrix reads lie in 8 bank groups.
template <int D> __device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, or 16 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// ldmatrix from a shared-memory byte address (as smem_u32 gives it).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Barrier of one warp group (4 warps): named barrier 1 or 2 (immediate ids,
// so that the block reserves 3 hardware barriers, not all 16).
__device__ __forceinline__ void group_sync(int grp) {
  if (grp == 0)
    asm volatile("bar.sync 1, %0;\n" ::"n"(NT / 2));
  else
    asm volatile("bar.sync 2, %0;\n" ::"n"(NT / 2));
}
// Two f32 rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Grid (ceil(Sq / BQ), B * Hq), NT threads.  q, out (B, Sq, Hq, D) and k, v
// (B, Skv, Hkv, D), contiguous, 16-byte aligned.  Warp w owns query rows
// q0 + 16 w .. + 15; lane (g = lane / 4, t = lane % 4) holds, in every
// m16n8 fragment, rows g and g + 8 at columns 2t and 2t + 1.
// One block per SM may take every register (the D = 256 accumulator needs
// ~250); with the thread bound alone ptxas held D = 64 to 128 and spilled.
template <int D>
__global__ void __launch_bounds__(NT, 1) mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
    float scale) {
  constexpr int BK = Tile<D>::BK;
  constexpr int CH = D / 8;               // 16-byte chunks per row
  constexpr int GT = NT / 2;              // threads per warp group
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);   // BQ x D
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp / 4, gtid = tid % GT;   // warp group, thread in group
  bf16* k_s = q_s + BQ * D + grp * 4 * BK * D;  // this group's 2 x BK x D
  bf16* v_s = k_s + 2 * BK * D;                 // and 2 x BK x D

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // the longest rows first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int g = lane >> 2, t4 = lane & 3;
  const long long q_row = (long long)Hq * D, kv_row = (long long)Hkv * D;
  const bf16* qg = q + (long long)b * Sq * q_row + (long long)h * D;
  const bf16* kg = k + (long long)b * Skv * kv_row + (long long)hk * D;
  const bf16* vg = v + (long long)b * Skv * kv_row + (long long)hk * D;

  // kv tiles any row of this block can see; group grp takes tiles grp,
  // grp + 2, ...
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, min(q0 + BQ, Sq));
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = (lo / BK) * BK;
  const int n_tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  const int my_tiles = n_tiles > grp ? (n_tiles - grp + 1) / 2 : 0;

  for (int e = tid; e < BQ * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    const bool ok = q0 + r < Sq;
    cp_async16(q_s + swz<D>(r, c), qg + (ok ? (q0 + r) * q_row : 0) + c * 8, ok);
  }
  auto load_kv = [&](int i, int buf) {   // this group's i-th tile
    const int kt = lo + (2 * i + grp) * BK;
    bf16* ks = k_s + buf * BK * D;
    bf16* vs = v_s + buf * BK * D;
    for (int e = gtid; e < BK * CH; e += GT) {
      const int r = e / CH, c = e % CH, key = kt + r;
      const bool ok = key < Skv;
      const long long off = (ok ? key * kv_row : 0) + c * 8;
      cp_async16(ks + swz<D>(r, c), kg + off, ok);
      cp_async16(vs + swz<D>(r, c), vg + off, ok);
    }
  };
  if (my_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // q (copied by both groups) and each group's first tile

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};   // rows g, g + 8
  const int wq = warp % 4;                // the group's warp: rows 16 wq .. + 15
  const int row0 = q0 + wq * 16 + g;
  // ldmatrix addresses.  Every row a lane addresses has r & 7 = lane & 7,
  // and chunk 8m + j (j < 8) of such a row sits at chunk 8m + (j ^ (lane &
  // 7)): so a lane's address is its row base, plus 128 m bytes (an
  // immediate once the loops unroll), plus one of four swizzled offsets
  // per operand, kept in registers.
  constexpr unsigned ROWB = D * 2, TILEB = BK * D * 2;
  unsigned xo_a[4], xo_k[4];   // Q and V: chunk 2j + (lane >> 4); K: 2j + bit 3 of lane
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xo_a[j] = ((2 * j + (lane >> 4)) ^ (lane & 7)) << 4;
    xo_k[j] = ((2 * j + ((lane >> 3) & 1)) ^ (lane & 7)) << 4;
  }
  const unsigned q_base = smem_u32(q_s) + (wq * 16 + (lane & 15)) * ROWB;
  const unsigned k_base = smem_u32(k_s) + (((lane >> 4) << 3) + (lane & 7)) * ROWB;
  const unsigned v_base = smem_u32(v_s) + (((lane >> 3) & 1) * 8 + (lane & 7)) * ROWB;

  for (int i = 0; i < my_tiles; ++i) {
    const int kt = lo + (2 * i + grp) * BK, buf = i & 1;
    if (i + 1 < my_tiles) load_kv(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    group_sync(grp);   // tile i landed for the whole group
    const unsigned kb = k_base + buf * TILEB, vb = v_base + buf * TILEB;
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4];
      ldsm_x4(a, q_base + (kk >> 2) * 128 + xo_a[kk & 3]);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        unsigned bb[4];
        ldsm_x4(bb, kb + np * 16 * ROWB + (kk >> 2) * 128 + xo_k[kk & 3]);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // scale, mask, online softmax on the fragments
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row0 + (e >> 1) * 8;
        const int kpos = kt + n * 8 + 2 * t4 + (e & 1);
        bool live = kpos < Skv;
        if (causal) live = live && qpos >= kpos;
        if (window > 0) live = live && (qpos - kpos) < window;
        s[n][e] = live ? s[n][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float m_new = fmaxf(m_r[x], mx[x]);
      alpha[x] = expf(m_r[x] - m_new);
      m_r[x] = m_new;
      l_r[x] *= alpha[x];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[n][e];   // this lane's part of the row sum, unrounded p
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += bf16(p) . v: the S fragments of keys 16j .. 16j + 15 are PV's A.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const unsigned a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned bb[4];
        ldsm_x4_t(bb, vb + j * 16 * ROWB + (dp >> 2) * 128 + xo_a[dp & 3]);
        mma_bf16(o[2 * dp], a, bb[0], bb[1]);
        mma_bf16(o[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    group_sync(grp);   // buffer buf is refilled two tiles on
  }
  cp_async_wait<0>();

  // Merge the two groups' states (the online-softmax merge, exact up to
  // rounding): group 1 leaves o, m, l in shared memory (its K/V buffers and
  // the q tile, both done with), group 0 merges and writes out.
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 1);
    l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 2);
  }
  __syncthreads();   // every group is done with q and its buffers
  float* o1 = reinterpret_cast<float*>(q_s + BQ * D + 4 * BK * D);   // group 1's buffers
  float* ml1 = reinterpret_cast<float*>(q_s);                         // m, l of group 1
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o1[(n * 4 + e) * GT + gtid] = o[n][e];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      ml1[x * GT + gtid] = m_r[x];
      ml1[(2 + x) * GT + gtid] = l_r[x];
    }
  }
  __syncthreads();
  if (grp == 1) return;
  float a0[2], a1[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float m1 = ml1[x * GT + gtid], l1 = ml1[(2 + x) * GT + gtid];
    const float m = fmaxf(m_r[x], m1);
    a0[x] = expf(m_r[x] - m);
    a1[x] = expf(m1 - m);
    l_r[x] = fmaxf(l_r[x] * a0[x] + l1 * a1[x], 1e-30f);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = row0 + 8 * x;
    if (row >= Sq) continue;
    bf16* orow = out + ((long long)b * Sq + row) * q_row + (long long)h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float y0 = o[n][2 * x] * a0[x] + o1[(n * 4 + 2 * x) * GT + gtid] * a1[x];
      const float y1 = o[n][2 * x + 1] * a0[x] + o1[(n * 4 + 2 * x + 1) * GT + gtid] * a1[x];
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(y0 / l_r[x], y1 / l_r[x]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  auto kern = mma_kernel<D>;
  constexpr size_t smem = Tile<D>::SMEM;
  // Raise the dynamic shared-memory cap once, never per launch: launches
  // may be captured into a CUDA graph.
  static bool raised = false;
  if (smem > 48 * 1024 && !raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, NT, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq,
                                   Skv, Hq, Hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

// ---------------------------------------------------------------------------
// f32: SIMT FMA
// ---------------------------------------------------------------------------

namespace simt {

constexpr int NT = 256;          // threads per block
constexpr int BQ = 32;           // query rows per block
constexpr int BK = 32;           // keys per K/V tile

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

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D + (size_t)BQ * BK + 2 * BQ);
  auto kern = flash_kernel<float, D>;
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
  kern<<<grid, NT, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                   static_cast<const float*>(v), static_cast<float*>(out), Sq,
                                   Skv, Hq, Hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

int launch_d(int dtype_code, const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window, float scale,
             cudaStream_t st) {
#define FLASH_CASE(DIM)                                                                   \
  case DIM:                                                                               \
    return dtype_code == 1                                                                \
               ? mma::launch<DIM>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window,     \
                                  scale, st)                                              \
               : simt::launch<DIM>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window,    \
                                   scale, st);
  switch (D) {
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// q, out (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); all contiguous and 16-byte
// aligned, in dtype_code's dtype (0 = float32, 1 = bfloat16).  Hq a multiple
// of Hkv; D in {64, 128, 256}; window <= 0 means no sliding window.  Returns
// the launch's cudaError_t (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                                      int D, int causal, int window, float scale,
                                      int dtype_code, void* stream) {
  if (dtype_code != 0 && dtype_code != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_d(dtype_code, q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, scale,
                  static_cast<cudaStream_t>(stream));
}
