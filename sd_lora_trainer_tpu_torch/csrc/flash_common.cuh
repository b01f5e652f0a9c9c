// Shared contract of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Contract (both kernels):
//   q, k, v, dO, o, dq, dk, dv: logical [B, H, L, d] with arbitrary element
//     strides for b, h and l and a contiguous last dim. Both kernels read
//     bf16 inputs through TMA (the Python wrappers round fp32 ones) and write
//     their outputs (o; dq, dk, dv) in `dtype`. Every stride is a multiple of
//     8 elements and every base pointer is 16-byte aligned (the Python wrapper
//     checks this).
//   lse, di: fp32 [B, H, L], contiguous; acc (backward): fp32
//     [B, H, L, round_up(d, 16)], contiguous and zeroed.
//   L is a multiple of 128, the rows both kernels tile at; d is a multiple of
//     8 with round_up(d, 16) in {48, 64, 80, 160} (SD head dims 40, 64, 80,
//     160); TMA reads columns d..round_up(d, 16)-1 as zeros.
//   Segment mask: with valid_len > 0, token i has segment id (i < valid_len).
//     A query attends a key only when both have the same id, so pad rows
//     attend only to pad keys and stay finite.
//   Products run on the tensor cores in bf16; accumulation and softmax are
//   fp32. The forward returns o and lse = log(sum_k exp(s_qk)),
//   s = sm_scale*q.k, which replaces the TPU kernel's separate row max m and
//   row sum l.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct FlashStrides {
  long long b, h, l;
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out_a;  // fwd: o; bwd: dk
  void* out_b;  // bwd: dv
  float* lse;   // written by fwd, read by the backward
  const float* di;
  FlashStrides sq, sk, sv, sdo, sa, sb;
  int batch, heads, len, head_dim;
  float sm_scale;
  int valid_len;
  int dtype;  // type of the outputs (fwd: o; bwd: dq, dk, dv). 0 = bf16, 1 = fp32
  void* out_c;  // bwd: dq
  FlashStrides sc;
  float* acc;  // bwd: the fp32 dq accumulator
};

#define FLASH_LOG2E 1.4426950408889634f
#define FLASH_LN2 0.6931471805599453f

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// True where the segment mask removes the (query, key) pair.
__device__ __forceinline__ bool seg_masked(int valid_len, bool q_real, int key) {
  return valid_len > 0 && (q_real != (key < valid_len));
}

// Dispatch a launcher template over the output type and padded head dim.
#define FLASH_DISPATCH(LAUNCH, args, stream)                                  \
  do {                                                                        \
    const int dp = ((args).head_dim + 15) / 16 * 16;                          \
    const bool bf = (args).dtype == 0;                                        \
    if ((args).head_dim % 8 != 0 || (args).len % 128 != 0) return (int)cudaErrorInvalidValue; \
    switch (dp) {                                                             \
      case 48: return bf ? LAUNCH<bf16, 48>(args, stream) : LAUNCH<float, 48>(args, stream);   \
      case 64: return bf ? LAUNCH<bf16, 64>(args, stream) : LAUNCH<float, 64>(args, stream);   \
      case 80: return bf ? LAUNCH<bf16, 80>(args, stream) : LAUNCH<float, 80>(args, stream);   \
      case 160: return bf ? LAUNCH<bf16, 160>(args, stream) : LAUNCH<float, 160>(args, stream); \
      default: return (int)cudaErrorInvalidValue;                             \
    }                                                                         \
  } while (0)
