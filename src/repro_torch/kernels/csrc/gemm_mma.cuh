// The body shared by the GeMMs K1 (gemm.cu), K6 (gemm_pipelined.cu) and the
// int8 GeMM K3 (gemm_int8.cu) on Hopper (sm_90a): the shared-memory stage
// layout and its 16-byte copies, the per-stage products (tensor cores for
// bf16 and for int8, exact SIMT FMA for f32), and the epilogue with its
// in-kernel split-K fix-up.  K1 and K6 differ only in how they keep stages
// in flight (K1: two, double-buffered; K6: a ring of `depth`); K3 keeps two
// and may produce A's int8 codes itself (the fused row quantization).
//
// Tiles.  A block owns one output tile of BN = 128 columns of C and a row
// tile of A, and walks its K range in stages of 128 bytes of K (64 bf16, 32
// f32, 128 int8).  Each stage holds A's rows [ROWS][K] (K contiguous) and
// B's tile in its own layout: [BN][K] when B is K-major (the tied head, a
// .t() view of the (N, K) table) or [K][BN] when B is (K, N) row-major (the
// projection weights).  Every row is padded by one 16-byte chunk, so the 8
// rows one ldmatrix reads start in 8 different bank groups (row strides of
// 144 and 272 bytes) for both B layouts and the copies stay 16-byte aligned.
//
// bf16 products: mma.sync.m16n8k16 (bf16 x bf16 -> f32) fed by ldmatrix.
// At M <= 64 every GeMM on the model's path does at most 64 operations per
// weight byte, far below the card's ~295, so the tensor cores' rate is not
// the limit and wgmma's 64-row tiles would only add dead rows; mma.sync
// keeps the warp-level tile small enough for M = 1 and 8.  The limits are
// the bytes in flight per SM and one launch's latency.
//   - M <= 16 ("swap"): the block computes C^T = B^T A^T, so the weight's
//     rows fill the mma's 16-row side (8 warps x 16 = 128 columns of C) and
//     the tokens its 8-column side (one 8-column tile for M <= 8, two for
//     M <= 16): no row is dead at M = 8.  K-major weights load with plain
//     ldmatrix, (K, N) weights with ldmatrix.trans.
//   - M > 16: 64 rows of A by 128 columns, 8 warps of 32 x 32.
//   - Each mma starts from zero and its 16-product sum is added to the f32
//     accumulator with an ordinary (round-to-nearest) add, so the running
//     sum never passes through the tensor core's own accumulation; the
//     kernels then hold the f32 plain version's bars.
// int8 products: mma.sync.m16n8k32 (s8 x s8 -> s32) fed by plain ldmatrix,
// with B K-major.  An s8 fragment holds 4 codes per register where the bf16
// one holds 2 values, so a 32-deep s8 step reads the same 16-byte rows at
// the same byte offsets as a 16-deep bf16 step, and the bf16 bodies' address
// patterns carry over with K counted in bytes.  int32 sums are exact in any
// order, so the mma accumulates in place.  The same two tiles: weights on
// the 16-row side at M <= 16, 64 x 128 above.
// f32 operands keep the SIMT exact-FMA body (never TF32); int8 operands
// with an N-contiguous B an exact int32 multiply-add.
//
// Split-K in one launch.  When the output tiles alone cannot fill the card,
// the launch plan (kernels/gemm.py::gemm_plan) splits K into `splits`
// ranges of `kps` stages, blockIdx.z picking the range.  Each split writes
// its partial tile to a workspace laid out (splits, M, N), fences, and
// bumps the tile's arrival counter; the last block to arrive sums the
// partials in split order 0..S-1 (deterministic, whatever the arrival
// order), writes C, and resets the counter to 0, so the launch can be
// captured into a CUDA graph and replayed.  The workspace and counters are
// allocated once per device by the wrapper and shared by K1, K6 and K3 (the
// int8 GeMM reads the workspace as int32); every launch goes on PyTorch's
// current stream, which orders their uses.  The fix-up hands each summed
// value to the kernel's epilogue once, so K3 scales after the split sum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gemm_body {

constexpr int BN = 128;        // output columns per block
constexpr int K_BYTES = 128;   // K depth of one stage, in bytes
constexpr int NT = 256;        // threads per block: 8 warps

using bf16 = __nv_bfloat16;

template <typename T>
using acc_t = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;

// Everything a launch needs; the kernels take it by value.
struct Args {
  const void* a;       // (M, K), K contiguous, row stride sam
  const void* b;       // (K, N): strides (sbk, 1), or (1, sbn) when K-major
  void* c;             // (M, N) contiguous, in out_code's type
  void* ws;            // split-K workspace, (splits, M, N) f32 or int32
  int* counters;       // one arrival counter per output tile, all 0
  int M, N, K;
  long long sam, sbk, sbn;
  int kps, splits;     // stages per split, number of splits
  int out_code;        // 0 = float32, 1 = bfloat16, 2 = int32
  const float* sa;     // int8 GeMM only: row scales (M,) or the static scale, else null
  const float* sb;     // int8 GeMM only: column scales (N,)
};

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int to_acc(int8_t x) { return static_cast<int>(x); }

__device__ __forceinline__ float mac(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mac(int a, int b, int c) { return a * b + c; }

__device__ __forceinline__ void store(void* c, int out_code, long long i, float v) {
  if (out_code == 0) static_cast<float*>(c)[i] = v;
  else static_cast<bf16*>(c)[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(void* c, int, long long i, int v) {
  static_cast<int*>(c)[i] = v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; bytes past src_bytes are
// zero-filled (src_bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x2(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// acc += (16x32 A fragment) x (32x8 B fragment), s8 codes, exact int32.
__device__ __forceinline__ void imma(int* acc, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += (16x16 A fragment) x (16x8 B fragment), the product summed from
// zero by the tensor core and added to acc in f32.
__device__ __forceinline__ void mma_add(float* acc, const unsigned* a, unsigned b0,
                                        unsigned b1) {
  float d0, d1, d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  acc[0] += d0;
  acc[1] += d1;
  acc[2] += d2;
  acc[3] += d3;
}

// Shared-memory layout of one stage, in elements of T.
template <typename T, int R, bool KM>
struct Stage {
  static constexpr int ROWS = R;
  static constexpr bool KMAJOR = KM;
  static constexpr int CE = 16 / sizeof(T);          // elements per 16-byte chunk
  static constexpr int BK = K_BYTES / sizeof(T);     // K per stage
  static constexpr int LDA = BK + CE;                // A: [ROWS][LDA]
  static constexpr int LDB = KMAJOR ? BK + CE : BN + CE;  // B: [BN][LDB] or [BK][LDB]
  static constexpr int A_ELEMS = ROWS * LDA;
  static constexpr int B_ELEMS = KMAJOR ? BN * LDB : BK * LDB;
  static constexpr int ELEMS = A_ELEMS + B_ELEMS;
};

// Issue the copies of A's part of the stage starting at K index k0 into
// `as` (no commit).  Rows past M and K past K are zero-filled by the copies
// themselves.
template <typename T, class S>
__device__ __forceinline__ void issue_a(T* as, const Args& p, int m0, int k0) {
  constexpr int CE = S::CE, KC = S::BK / CE, ROWS = S::ROWS;
  const T* a = static_cast<const T*>(p.a);
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * KC; e += NT) {
    const int r = e / KC, kc = (e % KC) * CE;
    const int m = m0 + r, k = k0 + kc;
    const int valid = (m < p.M) ? max(0, min(CE, p.K - k)) : 0;
    const T* src = valid ? a + m * p.sam + k : a;
    cp_async16(as + r * S::LDA + kc, src, valid * (int)sizeof(T));
  }
}

// The same for B's part of the stage (columns past N zero-filled).
template <typename T, class S>
__device__ __forceinline__ void issue_b(T* as, const Args& p, int n0, int k0) {
  constexpr int CE = S::CE, KC = S::BK / CE;
  const T* b = static_cast<const T*>(p.b);
  T* bs = as + S::A_ELEMS;
  const int tid = threadIdx.x;
  if constexpr (S::KMAJOR) {
#pragma unroll
    for (int e = tid; e < BN * KC; e += NT) {
      const int r = e / KC, kc = (e % KC) * CE;
      const int n = n0 + r, k = k0 + kc;
      const int valid = (n < p.N) ? max(0, min(CE, p.K - k)) : 0;
      const T* src = valid ? b + n * p.sbn + k : b;
      cp_async16(bs + r * S::LDB + kc, src, valid * (int)sizeof(T));
    }
  } else {
    constexpr int NC = BN / CE;
#pragma unroll
    for (int e = tid; e < S::BK * NC; e += NT) {
      const int r = e / NC, nc = (e % NC) * CE;
      const int k = k0 + r, n = n0 + nc;
      const int valid = (k < p.K) ? max(0, min(CE, p.N - n)) : 0;
      const T* src = valid ? b + k * p.sbk + n : b;
      cp_async16(bs + r * S::LDB + nc, src, valid * (int)sizeof(T));
    }
  }
}

// Both parts of the stage starting at K index k0 (no commit).
template <typename T, class S>
__device__ __forceinline__ void issue_stage(T* as, const Args& p, int m0, int n0, int k0) {
  issue_a<T, S>(as, p, m0, k0);
  issue_b<T, S>(as, p, n0, k0);
}

// f32 / int8: thread (ty, tx) of a 16 x 16 grid owns rows ty * TM + i and
// columns tx + 16 * j; plain FMA (f32) or integer multiply-add.
template <typename T, int BM, bool KMAJOR>
struct SimtBody {
  using S = Stage<T, BM, KMAJOR>;
  using A = acc_t<T>;
  static constexpr int ROWS = BM, TM = BM / 16, TN = BN / 16;
  A acc[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = A(0);
  }

  __device__ __forceinline__ void step(const T* as) {
    const T* bs = as + S::A_ELEMS;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
    for (int kk = 0; kk < S::BK; ++kk) {
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
  }

  template <class F>
  __device__ __forceinline__ void each(int m0, int n0, F f) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) f(m0 + ty * TM + i, n0 + tx + 16 * j, acc[i][j]);
  }
};

// bf16, M <= 16: C^T = B^T A^T.  Warp w owns columns n0 + 16 w .. + 15 of
// C (the mma's 16 rows) for all TC * 8 token rows (the mma's columns).
template <int TC, bool KMAJOR>
struct MmaSwapBody {
  using S = Stage<bf16, 8 * TC, KMAJOR>;
  static constexpr int ROWS = 8 * TC;
  float acc[TC][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < TC; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  }

  __device__ __forceinline__ void step(const bf16* as) {
    const bf16* bs = as + S::A_ELEMS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < S::BK; kk += 16) {
      unsigned w[4], x[2 * TC];
      // Weight fragment (mma A, rows = columns of C, 16 x 16): matrices
      // (rows 0-7, k 0-7), (8-15, k 0-7), (0-7, k 8-15), (8-15, k 8-15).
      if (KMAJOR)
        ldsm_x4(w, bs + (16 * warp + (lane & 15)) * S::LDB + kk + (lane >> 4) * 8);
      else
        ldsm_x4_t(w, bs + (kk + (j >> 1) * 8 + r) * S::LDB + 16 * warp + (j & 1) * 8);
      // Token fragment (mma B, k x tokens): tokens are A's rows, K contiguous.
      if constexpr (TC == 1)
        ldsm_x2(x, as + r * S::LDA + kk + (j & 1) * 8);
      else
        ldsm_x4(x, as + ((j >> 1) * 8 + r) * S::LDA + kk + (j & 1) * 8);
#pragma unroll
      for (int t = 0; t < TC; ++t) mma_add(acc[t], w, x[2 * t], x[2 * t + 1]);
    }
  }

  template <class F>
  __device__ __forceinline__ void each(int m0, int n0, F f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n = n0 + 16 * warp + (lane >> 2);
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      const int m = m0 + 8 * t + 2 * (lane & 3);
      f(m, n, acc[t][0]);
      f(m + 1, n, acc[t][1]);
      f(m, n + 8, acc[t][2]);
      f(m + 1, n + 8, acc[t][3]);
    }
  }
};

// bf16, M > 16: 64 rows of A x 128 columns; warp (wm, wn) of 2 x 4 owns
// rows 32 wm .. + 31 and columns 32 wn .. + 31: 2 x 4 mma tiles.
template <bool KMAJOR>
struct MmaBody {
  using S = Stage<bf16, 64, KMAJOR>;
  static constexpr int ROWS = 64;
  float acc[2][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
  }

  __device__ __forceinline__ void step(const bf16* as) {
    const bf16* bs = as + S::A_ELEMS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3, j = lane >> 3, r = lane & 7;
#pragma unroll 1   // unrolled, the fragments of 4 steps do not fit 128 registers
    for (int kk = 0; kk < S::BK; kk += 16) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], as + (32 * wm + 16 * i + (lane & 15)) * S::LDA + kk + (lane >> 4) * 8);
      // Weight fragments (mma B, k x columns), two 8-column tiles per
      // ldmatrix: (tile 0, k 0-7), (tile 0, k 8-15), (tile 1, k 0-7), (tile 1, k 8-15).
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        unsigned v[4];
        const int col = 32 * wn + 16 * q + (j >> 1) * 8;
        if (KMAJOR)
          ldsm_x4(v, bs + (col + r) * S::LDB + kk + (j & 1) * 8);
        else
          ldsm_x4_t(v, bs + (kk + (j & 1) * 8 + r) * S::LDB + col);
        b[2 * q][0] = v[0];
        b[2 * q][1] = v[1];
        b[2 * q + 1][0] = v[2];
        b[2 * q + 1][1] = v[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_add(acc[i][t], a[i], b[t][0], b[t][1]);
    }
  }

  template <class F>
  __device__ __forceinline__ void each(int m0, int n0, F f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int m = m0 + 32 * wm + 16 * i + (lane >> 2);
        const int n = n0 + 32 * wn + 8 * t + 2 * (lane & 3);
        f(m, n, acc[i][t][0]);
        f(m, n + 1, acc[i][t][1]);
        f(m + 8, n, acc[i][t][2]);
        f(m + 8, n + 1, acc[i][t][3]);
      }
  }
};

// int8, M <= 16: C^T = B^T A^T on s8 mma.sync, as MmaSwapBody, B K-major.
// Warp w owns columns n0 + 16 w .. + 15 of C for all TC * 8 token rows.
template <int TC>
struct ImmaSwapBody {
  using S = Stage<int8_t, 8 * TC, true>;
  static constexpr int ROWS = 8 * TC;
  int acc[TC][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < TC; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0;
  }

  __device__ __forceinline__ void step(const int8_t* as) {
    const int8_t* bs = as + S::A_ELEMS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < S::BK; kk += 32) {
      unsigned w[4], x[2 * TC];
      // Weight fragment (mma A, 16 columns of C x 32 codes): matrices
      // (rows 0-7, bytes 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31).
      ldsm_x4(w, bs + (16 * warp + (lane & 15)) * S::LDB + kk + (lane >> 4) * 16);
      // Token fragment (mma B, 32 codes x 8 tokens): tokens are A's rows.
      if constexpr (TC == 1)
        ldsm_x2(x, as + r * S::LDA + kk + (j & 1) * 16);
      else
        ldsm_x4(x, as + ((j >> 1) * 8 + r) * S::LDA + kk + (j & 1) * 16);
#pragma unroll
      for (int t = 0; t < TC; ++t) imma(acc[t], w, x[2 * t], x[2 * t + 1]);
    }
  }

  template <class F>
  __device__ __forceinline__ void each(int m0, int n0, F f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n = n0 + 16 * warp + (lane >> 2);
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      const int m = m0 + 8 * t + 2 * (lane & 3);
      f(m, n, acc[t][0]);
      f(m + 1, n, acc[t][1]);
      f(m, n + 8, acc[t][2]);
      f(m + 1, n + 8, acc[t][3]);
    }
  }
};

// int8, M > 16: 64 rows of A x 128 columns on s8 mma.sync, as MmaBody, B
// K-major; warp (wm, wn) of 2 x 4 owns rows 32 wm .. + 31, columns 32 wn .. + 31.
struct ImmaBody {
  using S = Stage<int8_t, 64, true>;
  static constexpr int ROWS = 64;
  int acc[2][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = 0;
  }

  __device__ __forceinline__ void step(const int8_t* as) {
    const int8_t* bs = as + S::A_ELEMS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3, j = lane >> 3, r = lane & 7;
#pragma unroll 1
    for (int kk = 0; kk < S::BK; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], as + (32 * wm + 16 * i + (lane & 15)) * S::LDA + kk + (lane >> 4) * 16);
      // Weight fragments (mma B), two 8-column tiles per ldmatrix: (tile 0,
      // bytes 0-15), (tile 0, 16-31), (tile 1, 0-15), (tile 1, 16-31).
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        unsigned v[4];
        const int col = 32 * wn + 16 * q + (j >> 1) * 8;
        ldsm_x4(v, bs + (col + r) * S::LDB + kk + (j & 1) * 16);
        b[2 * q][0] = v[0];
        b[2 * q][1] = v[1];
        b[2 * q + 1][0] = v[2];
        b[2 * q + 1][1] = v[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) imma(acc[i][t], a[i], b[t][0], b[t][1]);
    }
  }

  template <class F>
  __device__ __forceinline__ void each(int m0, int n0, F f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int m = m0 + 32 * wm + 16 * i + (lane >> 2);
        const int n = n0 + 32 * wn + 8 * t + 2 * (lane & 3);
        f(m, n, acc[i][t][0]);
        f(m, n + 1, acc[i][t][1]);
        f(m + 8, n, acc[i][t][2]);
        f(m + 8, n + 1, acc[i][t][3]);
      }
  }
};

// The epilogue K1 and K6 write with: C[off] = v in out_code's type.
struct StoreC {
  const Args& p;
  template <typename A>
  __device__ __forceinline__ void operator()(long long off, int, int, A v) const {
    store(p.c, p.out_code, off, v);
  }
};

// Write the block's tile through `out(offset, m, n, sum)`: straight from
// the registers with one split, else the split-K fix-up described at the
// top of this file, which hands `out` the summed value once.
template <typename A, class Body, class Out>
__device__ __forceinline__ void finish(const Body& body, const Args& p, int m0, int n0,
                                       const Out& out) {
  if (p.splits == 1) {
    body.each(m0, n0, [&](int m, int n, A v) {
      if (m < p.M && n < p.N) out((long long)m * p.N + n, m, n, v);
    });
    return;
  }
  A* ws = static_cast<A*>(p.ws);
  const long long mn = (long long)p.M * p.N;
  A* part = ws + blockIdx.z * mn;
  body.each(m0, n0, [&](int m, int n, A v) {
    if (m < p.M && n < p.N) part[(long long)m * p.N + n] = v;
  });
  // The block's partials are published by one fence after the barrier
  // (the pattern of cooperative groups' grid sync): the barrier orders the
  // block's stores before thread 0's fence and its arrival.
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) {
    int* count = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
    __threadfence();
    last = atomicAdd(count, 1) == p.splits - 1;
    if (last) {
      *count = 0;               // every split has arrived: re-arm for the next launch
      __threadfence();          // and every split's partials are visible to this block
    }
  }
  __syncthreads();
  if (!last) return;
  // Each thread sums groups of 4 adjacent columns (one 16-byte load per
  // split when N % 4 == 0).  Its (group, split) pairs are walked group by
  // group in split order, LOADS at a time: the loads of a batch are all in
  // flight together, then added in order to the running sum, which is
  // stored after a group's last split.  Every array index is a constant
  // after unrolling, so nothing goes to local memory.
  using V = typename std::conditional<std::is_same<A, int>::value, int4, float4>::type;
  constexpr int LOADS = 8;
  const int tid = threadIdx.x;
  const int groups = min(Body::ROWS, p.M - m0) * (BN / 4);
  const int pairs = tid < groups ? ((groups - 1 - tid) / NT + 1) * p.splits : 0;
  const bool vec = p.N % 4 == 0;
  V s = {};
  for (int q0 = 0; q0 < pairs; q0 += LOADS) {
    V v[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int q = q0 + i, g = tid + (q / p.splits) * NT;
      const int m = m0 + g / (BN / 4), n = n0 + 4 * (g % (BN / 4));
      const A* src = ws + (q % p.splits) * mn + (long long)m * p.N + n;
      const int valid = q < pairs ? min(4, p.N - n) : 0;
      if (vec && valid > 0) {
        v[i] = __ldcg(reinterpret_cast<const V*>(src));
      } else {
        v[i].x = valid > 0 ? __ldcg(src) : A(0);
        v[i].y = valid > 1 ? __ldcg(src + 1) : A(0);
        v[i].z = valid > 2 ? __ldcg(src + 2) : A(0);
        v[i].w = valid > 3 ? __ldcg(src + 3) : A(0);
      }
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int q = q0 + i, z = q % p.splits, g = tid + (q / p.splits) * NT;
      if (q >= pairs) break;
      if (z == 0) s = V{};
      s.x += v[i].x, s.y += v[i].y, s.z += v[i].z, s.w += v[i].w;   // split order
      if (z == p.splits - 1) {
        const int m = m0 + g / (BN / 4), n = n0 + 4 * (g % (BN / 4));
        const long long off = (long long)m * p.N + n;
        if (n < p.N) out(off, m, n, s.x);
        if (n + 1 < p.N) out(off + 1, m, n + 1, s.y);
        if (n + 2 < p.N) out(off + 2, m, n + 2, s.z);
        if (n + 3 < p.N) out(off + 3, m, n + 3, s.w);
      }
    }
  }
}

template <typename A, class Body>
__device__ __forceinline__ void finish(const Body& body, const Args& p, int m0, int n0) {
  finish<A>(body, p, m0, n0, StoreC{p});
}

template <class B>
struct Tag {
  using type = B;
};

// The int8 tensor-core body for the plan's swap flag and M (B K-major).
template <class F>
int with_imma_body(bool swap, int M, F&& f) {
  if (swap && M <= 8) return f(Tag<ImmaSwapBody<1>>{});
  if (swap) return f(Tag<ImmaSwapBody<2>>{});
  return f(Tag<ImmaBody>{});
}

// Calls f(Tag<Body>{}) with the body for operand type T, the plan's swap
// flag (the 16-row tile in the SIMT bodies), M and B's layout; returns its
// result.
template <typename T, class F>
int with_body(bool swap, int M, bool kmajor, F&& f) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (swap && M <= 8)
      return kmajor ? f(Tag<MmaSwapBody<1, true>>{}) : f(Tag<MmaSwapBody<1, false>>{});
    if (swap)
      return kmajor ? f(Tag<MmaSwapBody<2, true>>{}) : f(Tag<MmaSwapBody<2, false>>{});
    return kmajor ? f(Tag<MmaBody<true>>{}) : f(Tag<MmaBody<false>>{});
  } else if constexpr (std::is_same<T, int8_t>::value) {
    if (kmajor) return with_imma_body(swap, M, f);
    return swap ? f(Tag<SimtBody<T, 16, false>>{}) : f(Tag<SimtBody<T, 64, false>>{});
  } else {
    if (swap)
      return kmajor ? f(Tag<SimtBody<T, 16, true>>{}) : f(Tag<SimtBody<T, 16, false>>{});
    return kmajor ? f(Tag<SimtBody<T, 64, true>>{}) : f(Tag<SimtBody<T, 64, false>>{});
  }
}

// Launch KERN over the tile grid with DEPTH stages of Body's layout, and
// EXTRA bytes after them, in dynamic shared memory.  The cap above 48 KB
// is raised once per kernel,
// never per launch: launches may be captured into a graph.  KERN is a
// template argument so that `raised` is one flag per kernel: the kernels
// live in each source's anonymous namespace, which gives this instance
// internal linkage too (gemm.cu and gemm_pipelined.cu build into two
// libraries in one process, and an instance with external linkage would
// share its static between them).
template <typename T, int DEPTH, class Body, void (*KERN)(Args), size_t EXTRA = 0>
int launch(const Args& p, cudaStream_t stream) {
  using S = typename Body::S;
  const size_t smem = (size_t)DEPTH * S::ELEMS * sizeof(T) + EXTRA;
  static bool raised = false;
  if (smem > 48 * 1024 && !raised) {
    cudaError_t err =
        cudaFuncSetAttribute(KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  dim3 grid((p.N + BN - 1) / BN, (p.M + Body::ROWS - 1) / Body::ROWS, p.splits);
  KERN<<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm_body
