// The backward of flash attention (K5b) for f32 inputs, on the SIMT body
// (full f32, for the card-vs-CPU parity runs): the design is in
// flash_attention_bwd.cuh.

#include "flash_attention_bwd.cuh"

// q, out, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D); all
// contiguous and 16-byte aligned, in float32.  lse (B, Hq, Sq) f32 from the
// forward; delta (B, Hq, Sq) f32 scratch.  Hq a multiple of Hkv; D in {64,
// 128, 256}; window <= 0 means no sliding window.  Three launches on
// `stream`; returns the first failing launch's cudaError_t (0 = success).
extern "C" int flash_attention_bwd_f32_launch(const void* q, const void* k, const void* v,
                                              const void* out, const void* dout,
                                              const void* lse, void* delta, void* dq, void* dk,
                                              void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                                              int D, int causal, int window, float scale,
                                              void* stream) {
  return launch_bwd_d<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                             D, causal, window, scale, stream);
}
