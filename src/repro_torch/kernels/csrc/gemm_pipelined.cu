// Depth-D pipelined GeMM for Hopper (sm_90a): C = A @ B with a ring of
// `depth` shared-memory stages, filled by cp.async.
//
// Replaces the Pallas TPU kernel
// repro/kernels/gemm_pipelined.py::_pipelined_kernel (built by
// make_pipelined_gemm), the paper's D_stream knob (Sec. 3.3, Fig. 5): the
// input streamers pre-fetch `depth` tiles ahead of the compute array.  The
// TPU kernel keeps a VMEM ring of `depth` (tm x tk) and (tk x tn) tiles per
// operand, started by manual DMAs before the K loop and re-armed for tile
// k + depth as soon as tile k is consumed.  Here the DMA engine is cp.async
// (16-byte cp.async.cg copies, one commit group per K stage) and the ring is
// in shared memory; the structure is the reference's: `depth` stages in
// flight before the loop, then wait for the oldest (wait_group depth - 1),
// multiply it, and re-arm its slot for stage k + depth.  Blocks own one
// output tile for their whole K range, accumulator in registers.
//
// What bounds it on the H100: at decode (M = 8) every launch reads all of B
// once and does 2 * M operations per weight element, so B's bytes over
// 3.35 TB/s bound it; prefill chunks (M = 64) are still under the ridge.
// What the design does about it: B's stages arrive by asynchronous copies
// that bypass the registers, `depth` of them in flight per block, and the
// product of a stage runs on the tensor cores (bf16), so the ring and not
// the product sets the pace; launches with too few output tiles to fill the
// 132 SMs split K and fix the partials up inside the same launch.  The
// stage layout, the bodies (mma.sync for bf16, SIMT FMA for f32, never
// TF32, exact integer multiply-add for int8 -> int32) and the fix-up are
// gemm_mma.cuh's, shared with K1 (gemm.cu), which runs the same body behind
// two stages.
//
// Edges: rows past M and columns past N or K are zero-filled by the copy
// itself (cp.async with src-size < 16), so nothing is padded on the host.
// Every 16-byte chunk's source must be 16-byte aligned: the wrapper checks
// the base pointers and leading strides and re-lays an operand that is not
// (never on the model's path, whose widths are multiples of 128).

#include "gemm_mma.cuh"

namespace {

using namespace gemm_body;

template <typename T, int DEPTH, class Body>
__global__ void __launch_bounds__(NT, 2) pipelined_kernel(const Args p) {
  using S = typename Body::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int m0 = blockIdx.y * S::ROWS, n0 = blockIdx.x * BN;
  const int k_steps = (p.K + S::BK - 1) / S::BK;
  const int ks0 = blockIdx.z * p.kps;
  const int n_local = max(0, min(k_steps, ks0 + p.kps) - ks0);

  Body body;
  body.zero();
  // Warm-up: `depth` stages in flight before any compute.  Every step
  // commits one group, empty or not, so group t always holds stage t.
#pragma unroll
  for (int s = 0; s < DEPTH; ++s) {
    if (s < n_local) issue_stage<T, S>(smem + s * S::ELEMS, p, m0, n0, (ks0 + s) * S::BK);
    cp_async_commit();
  }
  for (int t = 0; t < n_local; ++t) {
    const int slot = t % DEPTH;
    cp_async_wait<DEPTH - 1>();   // stage t landed; t+1 .. t+DEPTH-1 in flight
    __syncthreads();
    body.step(smem + slot * S::ELEMS);
    __syncthreads();              // every thread is done with this slot
    if (t + DEPTH < n_local)      // re-arm it
      issue_stage<T, S>(smem + slot * S::ELEMS, p, m0, n0, (ks0 + t + DEPTH) * S::BK);
    cp_async_commit();
  }
  cp_async_wait<0>();
  finish<acc_t<T>>(body, p, m0, n0);
}

template <typename T>
int launch_typed(const Args& p, bool swap, bool kmajor, int depth, cudaStream_t st) {
  return with_body<T>(swap, p.M, kmajor, [&](auto tag) {
    using Body = typename decltype(tag)::type;
    switch (depth) {
      case 2: return launch<T, 2, Body, pipelined_kernel<T, 2, Body>>(p, st);
      case 3: return launch<T, 3, Body, pipelined_kernel<T, 3, Body>>(p, st);
      case 4: return launch<T, 4, Body, pipelined_kernel<T, 4, Body>>(p, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

}  // namespace

// in_code: 0 = float32, 1 = bfloat16, 2 = int8 (A and B share it); out_code:
// 0 = float32 or 1 = bfloat16 for float inputs, 2 = int32 for int8.  A is
// (M, K) with unit K stride and row stride sam; B is (K, N) with strides
// (sbk, sbn), sbk == 1 when kmajor and sbn == 1 otherwise.  Every row of
// both starts 16-byte aligned.  depth in {2, 3, 4}; swap, kmajor, kps and
// splits come from the launch plan (kernels/gemm.py::gemm_plan); with
// splits > 1, `ws` holds
// (splits, M, N) float32 (int32 for int8) and `counters` one zeroed int per
// output tile.  Returns the launch's cudaError_t.
extern "C" int gemm_pipelined_launch(const void* a, const void* b, void* c, void* ws,
                                     int* counters, int M, int N, int K, long long sam,
                                     long long sbk, long long sbn, int in_code, int out_code,
                                     int depth, int swap, int kmajor, int kps, int splits,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args p{a, b, c, ws, counters, M, N, K, sam, sbk, sbn, kps, splits, out_code};
  if (in_code == 0 && out_code <= 1)
    return launch_typed<float>(p, swap != 0, kmajor != 0, depth, st);
  if (in_code == 1 && out_code <= 1)
    return launch_typed<__nv_bfloat16>(p, swap != 0, kmajor != 0, depth, st);
  if (in_code == 2 && out_code == 2)
    return launch_typed<int8_t>(p, swap != 0, kmajor != 0, depth, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
