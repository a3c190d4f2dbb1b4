// Paged flash-decode for Hopper (sm_90a): attention for Sq query positions
// per slot, read straight from the paged KV pool through the block tables.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::_decode_kernel
// (entry flash_decode_attention) and its stage-2 merge _combine_splits.  On
// the TPU the block tables arrive by scalar prefetch, the grid walks one
// slot's table columns in order, and a (rows, D) f32 accumulator sits in
// VMEM per (slot, kv head).  Here a block owns one (slot, kv head, split,
// tile of RT packed query rows): it loads its split's table entries into
// shared memory once, walks the split's keys in chunks, and keeps the
// online-softmax state in registers; splits > 1 write partials (acc, m, l)
// that a second kernel merges as _combine_splits does.
//
// What bounds it on the H100: bytes and latency.  Each live pool row is read
// once per (slot, kv head, row tile) and the arithmetic is ~4 * rows FLOPs
// per K/V element, far below the ridge.  A decode step of gemma3-1b is 8
// slots x 1 kv head x 4 packed rows: one block per (slot, kv head) would
// leave 124 of 132 SMs idle, and one block walking ~70 columns serially is
// latency-bound.  The design:
//   - The wrapper picks the split count from the table extent and the SM
//     count (flash_decode.py::decode_splits), about two blocks per SM.  Split
//     s owns columns [s * max_blocks / splits, (s + 1) * max_blocks /
//     splits), clipped to the keys a query can see (none past the last query
//     position, none wholly before the window); a split left empty exits
//     before it loads q and writes the empty partial (0, NEG_INF, 0).
//   - Keys move in chunks of KC (a stage of ~32 KB of K and V: 32 keys of a
//     bf16 row of D = 256, 64 of an int8 row), copied raw with 16-byte
//     cp.async into a ring of STAGES buffers, so that STAGES - 1 chunks are
//     in flight while one is consumed.  int8 codes and their f32 scales are
//     copied as they are and dequantized, code * scale in f32, as they leave
//     shared memory: that is the product the plain versions take.
//   - Scores: a warp owns packed query rows, each lane holds D / 32 elements
//     of the row (pre-scaled q, f32 registers) and reads the same slice of 32
//     keys (16-byte shared-memory reads at D = 256 bf16); a reduce-scatter by
//     shuffles (31 per 32 keys) leaves lane L with key L's score.  The
//     warp's max and sum over the chunk are shuffles too: no thread-serial
//     loop over keys remains.
//   - PV: every thread owns 2 output columns of RT / RG rows and reads the
//     probabilities 4 keys at a time.
//   - Two __syncthreads per chunk: one after the chunk lands (the previous
//     chunk's PV is then done, so its buffer and the probabilities may be
//     overwritten), one between the softmax and PV.
// Both products stay f32 (the reference computes q.k and p.v in f32 with p
// never rounded); at 4 packed rows per kv head the tensor cores would pad to
// 16 for nothing.
//
// Numerics follow the reference: masked scores never contribute (p = 0), l
// sums the f32 p, the combine weights a split by exp(m_s - m_g) and skips a
// split whose m is the sentinel NEG_INF = -2e38 (its weight is 0 unless
// every split is empty, and then the l floor of 1e-30 gives a finite 0), and
// out = acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int KG = 32;   // keys per score group: one per lane after the reduction
constexpr int CPT = 2;   // output columns per thread in PV

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename O> __device__ __forceinline__ O from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 32-bit words of packed elements to float, exactly (bf16 is the top half
// of an f32; int8 is sign-extended).
template <int N>
__device__ __forceinline__ void unpack(const uint32_t* w, float (&dst)[N], float) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = __uint_as_float(w[i]);
}
template <int N>
__device__ __forceinline__ void unpack(const uint32_t* w, float (&dst)[N], __nv_bfloat16) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    dst[i] = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
}
template <int N>
__device__ __forceinline__ void unpack(const uint32_t* w, float (&dst)[N], int8_t) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    dst[i] = static_cast<float>(static_cast<int32_t>(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

// N consecutive elements of type P from shared memory (aligned to their
// size) as float, in the widest loads their bytes allow.
template <typename P, int N>
__device__ __forceinline__ void load_f(const P* src, float (&dst)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(P));
  uint32_t w[BYTES >= 4 ? BYTES / 4 : 1];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[i];
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = reinterpret_cast<const uint2*>(src)[0];
    w[0] = u.x;
    w[1] = u.y;
  } else if constexpr (BYTES == 4) {
    w[0] = reinterpret_cast<const uint32_t*>(src)[0];
  } else {
    static_assert(BYTES == 2, "two bytes at least");
    w[0] = reinterpret_cast<const uint16_t*>(src)[0];
  }
  unpack(w, dst, P());
}

// One halving step of the reduce-scatter below: lanes with bit O set keep
// the upper O values (plus the partner's), the others the lower O.
template <int O>
__device__ __forceinline__ void halve(float (&v)[32], bool up) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float keep = up ? v[i + O] : v[i];
    const float send = up ? v[i] : v[i + O];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// v[i] on lane L holds lane L's part of the score of key i (i < 32).  After
// five halving steps (16 + 8 + 4 + 2 + 1 shuffles) lane L returns the sum
// over all lanes of key L's parts.
__device__ __forceinline__ float reduce_scatter(float (&v)[KG], int lane) {
  halve<16>(v, lane & 16);
  halve<8>(v, lane & 8);
  halve<4>(v, lane & 4);
  halve<2>(v, lane & 2);
  halve<1>(v, lane & 1);
  return v[0];
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Keys per chunk and ring depth for a pool of element P at head dim D: a
// stage holds ~32 KB of K and V (at least one score group), three stages
// where that fits in ~100 KB (two blocks per SM), else two.
template <typename P, int D> struct Ring {
  static constexpr int ROW = D * static_cast<int>(sizeof(P));   // bytes per key row
  static constexpr int KC = 16384 / ROW < KG ? KG : 16384 / ROW;
  static constexpr int KV_BYTES = KC * ROW;                     // K (or V) of one chunk
  static constexpr bool Q8 = std::is_same<P, int8_t>::value;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + (Q8 ? 2 * KC * 4 : 0);
  static constexpr int STAGES = 2 * KV_BYTES <= 32768 ? 3 : 2;
};

__host__ __device__ constexpr int threads_for(int RT) { return RT <= 4 ? 128 : 256; }

template <typename P, int D, int RT>
size_t smem_bytes(int cols_per_split) {
  using R = Ring<P, D>;
  return (size_t)R::STAGES * R::STAGE_BYTES + sizeof(float) * (RT * R::KC + 3 * RT) +
         sizeof(int) * (size_t)cols_per_split;
}

// Grid (B * Hkv, splits, row tiles of RT rows).  Packed row r = g * Sq + t
// holds query head h * G + g at position index[b] + t.  Warp w owns rows
// w * RPW .. + RPW - 1 of the tile for the scores and the softmax; in PV
// thread tid owns columns d0, d0 + 1 of rows rg + RG * i.  A decode step
// (G * Sq <= 4 rows) runs RT = 4 on 4 warps, a prefill chunk RT = 16 on 8.
// P is the pool's element type: T, or int8_t with the scale pools.
template <typename T, typename P, int D, int RT>
__global__ void __launch_bounds__(threads_for(RT)) decode_split_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ index, T* __restrict__ out,
    float* __restrict__ acc_ws, float* __restrict__ m_ws,
    float* __restrict__ l_ws, int Sq, int Hkv, int G, int bs, int max_blocks,
    int splits, int window, float scale) {
  using R = Ring<P, D>;
  constexpr int NT = threads_for(RT), NW = NT / 32;
  constexpr int RPW = RT / NW;            // rows per warp (scores, softmax)
  constexpr int EPL = D / 32;             // elements of a key row per lane
  constexpr int KC = R::KC, STAGES = R::STAGES;
  constexpr int PIECES = R::ROW / 16;     // 16-byte copies per key row
  constexpr int RG = NT / (D / CPT);      // row groups in PV
  constexpr int RPT = RT / RG;            // rows per thread in PV
  static_assert(RT % NW == 0 && RG >= 1 && RT % RG == 0 && KC % KG == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem + STAGES * R::STAGE_BYTES);   // RT x KC
  float* alpha_s = p_s + RT * KC;         // RT
  float* m_s = alpha_s + RT;              // RT
  float* l_s = m_s + RT;                  // RT
  int* tab_s = reinterpret_cast<int*>(l_s + RT);

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv, s = blockIdx.y;
  const int r0 = blockIdx.z * RT;
  const int rows = G * Sq, Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int idx = index[b];
  const long long part = ((long long)b * Hkv + h) * splits + s;

  // This split's keys, clipped: none past the last query position or the
  // table, none before the first query's window.
  const int c_begin = static_cast<int>((long long)s * max_blocks / splits);
  const int c_end = static_cast<int>((long long)(s + 1) * max_blocks / splits);
  int k_lo = c_begin * bs;
  const int k_hi = min(c_end * bs, min(idx + Sq, max_blocks * bs));
  if (window > 0) k_lo = max(k_lo, idx - window + 1);

  const int d0 = (tid % (D / CPT)) * CPT, rg = tid / (D / CPT);
  if (k_lo >= k_hi) {   // an empty split: the empty partial, or 0 / floor
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = r0 + rg + RG * i;
      if (row >= rows) continue;
      if (splits == 1) {
        const int g = row / Sq, t = row % Sq;
        T* o = out + (((long long)b * Sq + t) * Hq + h * G + g) * D + d0;
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[c] = from_f<T>(0.f);
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc_ws[(part * rows + row) * D + d0 + c] = 0.f;
        if (d0 == 0) {
          m_ws[part * rows + row] = NEG_INF;
          l_ws[part * rows + row] = 0.f;
        }
      }
    }
    return;
  }

  const int c0 = k_lo / bs, n_cols = (k_hi - 1) / bs - c0 + 1;
  for (int i = tid; i < n_cols; i += NT) tab_s[i] = tables[(long long)b * max_blocks + c0 + i];

  // q rows of this warp, pre-scaled, lane's slice of D.
  float qr[RPW][EPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = r0 + warp * RPW + i;
    if (row < rows) {
      const int g = row / Sq, t = row % Sq;
      const T* src = q + (((long long)b * Sq + t) * Hq + h * G + g) * D + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[i][e] = to_f(src[e]) * scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[i][e] = 0.f;
    }
  }
  __syncthreads();   // tab_s

  const int n_chunks = (k_hi - k_lo + KC - 1) / KC;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      unsigned char* st = smem + (c % STAGES) * R::STAGE_BYTES;
      const int k0 = k_lo + c * KC, n = min(KC, k_hi - k0);
      for (int e = tid; e < 2 * KC * PIECES; e += NT) {
        const int which = e / (KC * PIECES), rem = e % (KC * PIECES);
        const int j = rem / PIECES, w = rem % PIECES;
        if (j < n) {
          const int key = k0 + j;
          const long long row =
              ((long long)tab_s[key / bs - c0] * bs + key % bs) * Hkv + h;
          const unsigned char* src =
              reinterpret_cast<const unsigned char*>((which ? v_pool : k_pool) + row * D);
          cp_async16(st + which * R::KV_BYTES + j * R::ROW + w * 16, src + w * 16);
        }
      }
      if constexpr (R::Q8) {
        float* sc = reinterpret_cast<float*>(st + 2 * R::KV_BYTES);   // K then V scales
        for (int e = tid; e < 2 * KC; e += NT) {
          const int which = e / KC, j = e % KC;
          if (j < n) {
            const int key = k0 + j;
            const long long row =
                ((long long)tab_s[key / bs - c0] * bs + key % bs) * Hkv + h;
            cp_async4(sc + e, (which ? v_scale : k_scale) + row);
          }
        }
      }
    }
    cp_async_commit();   // an empty group past the last chunk keeps the count
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk c landed; chunk c - 1's PV is done everywhere
    issue(c + STAGES - 1);
    const unsigned char* st = smem + (c % STAGES) * R::STAGE_BYTES;
    const P* k_s = reinterpret_cast<const P*>(st);
    const P* v_s = reinterpret_cast<const P*>(st + R::KV_BYTES);
    const float* ks_s = reinterpret_cast<const float*>(st + 2 * R::KV_BYTES);
    const float* vs_s = ks_s + KC;
    const int k0 = k_lo + c * KC, n = min(KC, k_hi - k0);

    // Scores: lane holds key grp * 32 + lane of each owned row.
    float sc[RPW][KC / KG];
#pragma unroll
    for (int grp = 0; grp < KC / KG; ++grp) {
      float part_s[RPW][KG];
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        float kf[EPL];
        load_f<P, EPL>(k_s + (grp * KG + j) * D + lane * EPL, kf);
        if constexpr (R::Q8) {
          const float ksc = ks_s[grp * KG + j];
#pragma unroll
          for (int e = 0; e < EPL; ++e) kf[e] *= ksc;
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) a = fmaf(qr[i][e], kf[e], a);
          part_s[i][j] = a;
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) sc[i][grp] = reduce_scatter(part_s[i], lane);
    }

    // Online softmax of each owned row over the chunk, by the warp.
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int qpos = idx + (r0 + r) % Sq;
      unsigned live = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int grp = 0; grp < KC / KG; ++grp) {
        const int j = grp * KG + lane, kpos = k0 + j;
        bool ok = j < n && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        live |= static_cast<unsigned>(ok) << grp;
        if (ok) mx = fmaxf(mx, sc[i][grp]);
      }
      const float m_new = fmaxf(m_run[i], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int grp = 0; grp < KC / KG; ++grp) {
        const float p = (live >> grp) & 1u ? expf(sc[i][grp] - m_new) : 0.f;
        p_s[r * KC + grp * KG + lane] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();   // p_s, alpha_s

    // acc = acc * alpha + p . v over the chunk's loaded keys.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = alpha_s[rg + RG * i];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= a;
    }
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      float vv[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        load_f<P, CPT>(v_s + (j + u) * D + d0, vv[u]);
        if constexpr (R::Q8) {
          const float vsc = vs_s[j + u];
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) vv[u][cc] *= vsc;
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_s + (rg + RG * i) * KC + j);
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          float a = acc[i][cc];
          a = fmaf(p4.x, vv[0][cc], a);
          a = fmaf(p4.y, vv[1][cc], a);
          a = fmaf(p4.z, vv[2][cc], a);
          a = fmaf(p4.w, vv[3][cc], a);
          acc[i][cc] = a;
        }
      }
    }
    for (; j < n; ++j) {
      float vv[CPT];
      load_f<P, CPT>(v_s + j * D + d0, vv);
      if constexpr (R::Q8) {
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) vv[cc] *= vs_s[j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = p_s[(rg + RG * i) * KC + j];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (lane == 0) {
      m_s[warp * RPW + i] = m_run[i];
      l_s[warp * RPW + i] = l_run[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i, row = r0 + r;
    if (row >= rows) continue;
    if (splits == 1) {
      const int g = row / Sq, t = row % Sq;
      T* o = out + (((long long)b * Sq + t) * Hq + h * G + g) * D + d0;
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) o[cc] = from_f<T>(acc[i][cc] / l);
    } else {
      const long long base = part * rows + row;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc_ws[base * D + d0 + cc] = acc[i][cc];
      if (d0 == 0) {
        m_ws[base] = m_s[r];
        l_ws[base] = l_s[r];
      }
    }
  }
}

// Max (or sum) over a block of D threads; every thread gets the result.
template <int D, bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = MAX ? warp_max(x) : warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float y = red[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) y = MAX ? fmaxf(y, red[w]) : y + red[w];
  __syncthreads();   // red is reused
  return y;
}

// Stage 2 (_combine_splits): grid (B * Hkv, rows), D threads, `splits`
// floats of dynamic shared memory.  The threads read the splits' m and l
// in parallel, reduce them across the block, and keep each split's weight
// exp(m_s - m_g) in shared memory; then every thread sums its column of
// acc over the splits with a nonzero weight.  A split whose m is the
// sentinel (nothing visible to the row) gets weight 0 and its acc is not
// read: exp(NEG_INF - m_g) is 0 whenever any split is live, so skipping it
// is exact.  When every split is empty, l_g = 0 and the floor gives 0.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(
    const float* __restrict__ acc_ws, const float* __restrict__ m_ws,
    const float* __restrict__ l_ws, T* __restrict__ out, int Sq, int Hkv, int G,
    int splits) {
  extern __shared__ float w_s[];   // splits
  __shared__ float red[D / 32];
  const int bh = blockIdx.x, row = blockIdx.y, d = threadIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int rows = G * Sq;
  const long long base = (long long)bh * splits * rows + row;
  float m = NEG_INF;
  for (int s = d; s < splits; s += D) m = fmaxf(m, m_ws[base + (long long)s * rows]);
  const float m_g = block_reduce<D, true>(m, red);
  float l = 0.f;
  for (int s = d; s < splits; s += D) {
    const long long i = base + (long long)s * rows;
    const float ms = m_ws[i];
    const float w = ms > NEG_INF ? expf(ms - m_g) : 0.f;
    w_s[s] = w;
    l += l_ws[i] * w;
  }
  const float l_g = block_reduce<D, false>(l, red);   // its barrier publishes w_s
  float a = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float w = w_s[s];
    if (w != 0.f) a += acc_ws[(base + (long long)s * rows) * D + d] * w;
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
  const size_t smem = smem_bytes<P, D, RT>((max_blocks + splits - 1) / splits);
  auto kern = decode_split_kernel<T, P, D, RT>;
  // Raise the dynamic shared-memory cap once per instantiation (and again
  // only for a larger need), never per launch: launches may be captured
  // into a CUDA graph.
  static size_t smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_cap = smem;
  }
  dim3 grid(B * Hkv, splits, (rows + RT - 1) / RT);
  kern<<<grid, threads_for(RT), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables, index, static_cast<T*>(out),
      acc_ws, m_ws, l_ws, Sq, Hkv, G, bs, max_blocks, splits, window, scale);
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_combine_kernel<T, D><<<dim3(B * Hkv, rows), D, sizeof(float) * splits, stream>>>(
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
// (B, max_blocks) and index (B,) int32; every pointer 16-byte aligned.
// acc_ws (B, Hkv, splits, G * Sq, D), m_ws and l_ws (B, Hkv, splits, G *
// Sq) float32 are used only when splits > 1.  1 <= splits <= max_blocks and
// splits <= 12288 (the combine keeps one weight per split in 48 KB of shared
// memory); window <= 0 means no sliding window.  Returns the cudaError_t.
extern "C" int flash_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* index, void* out, void* acc_ws,
                                   void* m_ws, void* l_ws, int B, int Sq,
                                   int Hkv, int G, int D, int bs, int max_blocks,
                                   int splits, int window, float scale,
                                   int dtype_code, int pool_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > max_blocks || splits > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
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
