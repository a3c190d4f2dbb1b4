// Output-stationary tiled GeMM for Hopper (sm_90a): C = A @ B, f32 accumulate.
//
// Replaces the Pallas TPU kernel repro/kernels/gemm.py::_gemm_kernel (built
// by make_gemm).  The TPU kernel walks a (M/TM, N/TN, K/TK) grid with K
// innermost and carries a VMEM accumulator across the sequential K steps,
// its BlockSpecs double-buffering each operand's next tile behind the
// current one.  Here blocks run in parallel and in no order, so the K walk
// is a loop inside the block and the accumulator lives in registers; a
// block owns one output tile for its whole K range, with two shared-memory
// stages: the next stage's 16-byte cp.async copies are in flight while the
// current stage is multiplied.
//
// What bounds it on the H100: at decode (M = slots <= 8) every launch reads
// all of B once and does 2 * M operations per weight element, far below the
// ~295 FLOP/byte ridge, so the bound is B's bytes over 3.35 TB/s (the tied
// head, 1152 x 262144 bf16, is 604 MB per step); prefill chunks (M = 64)
// are still under the ridge.  What the design does about it: bf16 products
// run on the tensor cores (mma.sync, the weight rows on the mma's 16-row
// side when M <= 16), so the copies and not the product loop set the pace;
// launches with too few output tiles to fill the 132 SMs split K, and the
// last split of each tile sums the partials in a fixed order inside the
// same launch (one launch per GeMM).  The tiles, the bodies and the fix-up
// are in gemm_mma.cuh, shared with K6 (gemm_pipelined.cu); the f32 body is
// plain FMA, never TF32.
//
// Operands: A with K contiguous; B K-major (the tied head's .t() view,
// read in place) or N-contiguous.  Every row starts 16-byte aligned: the
// wrapper re-lays an operand that is not (never on the model's path).

#include "gemm_mma.cuh"

namespace {

using namespace gemm_body;

template <typename T, class Body>
__global__ void __launch_bounds__(NT, 2) gemm_kernel(const Args p) {
  using S = typename Body::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m0 = blockIdx.y * S::ROWS, n0 = blockIdx.x * BN;
  const int k_steps = (p.K + S::BK - 1) / S::BK;
  const int ks0 = blockIdx.z * p.kps;
  const int n_local = max(0, min(k_steps, ks0 + p.kps) - ks0);

  Body body;
  body.zero();
  if (n_local > 0) issue_stage<T, S>(smem, p, m0, n0, ks0 * S::BK);
  cp_async_commit();
  for (int t = 0; t < n_local; ++t) {
    if (t + 1 < n_local)        // the next stage, in flight during this product
      issue_stage<T, S>(smem + ((t + 1) & 1) * S::ELEMS, p, m0, n0, (ks0 + t + 1) * S::BK);
    cp_async_commit();
    cp_async_wait<1>();         // stage t has landed
    __syncthreads();
    body.step(smem + (t & 1) * S::ELEMS);
    __syncthreads();            // its slot is free for stage t + 2
  }
  cp_async_wait<0>();
  finish<acc_t<T>>(body, p, m0, n0);
}

template <typename T>
int launch_typed(const Args& p, bool swap, bool kmajor, cudaStream_t st) {
  return with_body<T>(swap, p.M, kmajor, [&](auto tag) {
    using Body = typename decltype(tag)::type;
    return launch<T, 2, Body, gemm_kernel<T, Body>>(p, st);
  });
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  A and B share one dtype; C is
// written in out_code's dtype.  A is (M, K) with unit K stride and row
// stride sam; B is (K, N) with strides (sbk, sbn), sbk == 1 when kmajor
// and sbn == 1 otherwise.  Every row of both starts 16-byte aligned.  swap,
// kmajor, kps and splits come from the launch plan
// (kernels/gemm.py::gemm_plan); with
// splits > 1, `ws` holds (splits, M, N) float32 and `counters` one zeroed
// int per output tile.  Returns the launch's cudaError_t (0 = success).
extern "C" int gemm_launch(const void* a, const void* b, void* c, void* ws, int* counters,
                           int M, int N, int K, long long sam, long long sbk, long long sbn,
                           int in_code, int out_code, int swap, int kmajor, int kps,
                           int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_code != 0 && out_code != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a, b, c, ws, counters, M, N, K, sam, sbk, sbn, kps, splits, out_code};
  if (in_code == 0) return launch_typed<float>(p, swap != 0, kmajor != 0, st);
  if (in_code == 1) return launch_typed<__nv_bfloat16>(p, swap != 0, kmajor != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
