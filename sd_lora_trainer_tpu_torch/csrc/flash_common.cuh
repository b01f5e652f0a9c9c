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
//     [B, H, L, round_up(d, 16)], contiguous, any contents; sem (backward):
//     int32 [B, H, L / 64], zeroed: one turn counter per 64-row q tile.
//   L is a multiple of 128, the rows both kernels tile at; d is a multiple of
//     8 from 8 to 256, and the kernels are instantiated for every padded head
//     dim DP = round_up(d, 16) from 16 to 256 (FLASH_HEAD_DIMS); TMA reads
//     columns d..DP-1 as zeros. A head dim that is not a multiple of 8 is
//     zero-padded to one by the Python wrappers (TMA needs 16-byte strides).
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
  int* sem;    // bwd: the turn counters of the dq adds
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

// Every padded head dim DP = round_up(d, 16) the kernels are built for.
#define FLASH_HEAD_DIMS(X, NAME)                                                              \
  X(NAME, 16) X(NAME, 32) X(NAME, 48) X(NAME, 64) X(NAME, 80) X(NAME, 96) X(NAME, 112)         \
  X(NAME, 128) X(NAME, 144) X(NAME, 160) X(NAME, 176) X(NAME, 192) X(NAME, 208) X(NAME, 224) \
  X(NAME, 240) X(NAME, 256)

// A kernel source builds as one translation unit per DP (nvcc -DFLASH_DP=<DP>,
// which defines NAME_dp<DP> for both output types: FLASH_DEFINE_DP) and one
// without FLASH_DP that defines the exported NAME, the dispatch over every DP
// (FLASH_DISPATCH). ops/kernels.py compiles the units in parallel and links
// them into one library per kernel.
#define FLASH_DEFINE_DP(NAME, LAUNCH, DP) FLASH_DEFINE_DP_(NAME, LAUNCH, DP)
#define FLASH_DEFINE_DP_(NAME, LAUNCH, DP)                                       \
  int NAME##_dp##DP(const FlashArgs* a, cudaStream_t stream) {                   \
    return a->dtype == 0 ? LAUNCH<bf16, DP>(*a, stream) : LAUNCH<float, DP>(*a, stream); \
  }

#define FLASH_DECLARE_DP(NAME, DP) int NAME##_dp##DP(const FlashArgs*, cudaStream_t);
#define FLASH_CASE_DP(NAME, DP) \
  case DP:                      \
    return NAME##_dp##DP(args, stream);

#define FLASH_DISPATCH(NAME)                                                          \
  FLASH_HEAD_DIMS(FLASH_DECLARE_DP, NAME)                                             \
  extern "C" int NAME(const FlashArgs* args, void* stream_ptr) {                      \
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);                \
    const int d = args->head_dim;                                                     \
    if (d < 8 || d > 256 || d % 8 != 0 || args->len % 128 != 0 || args->dtype < 0 || \
        args->dtype > 1)                                                              \
      return (int)cudaErrorInvalidValue;                                              \
    switch ((d + 15) / 16 * 16) {                                                     \
      FLASH_HEAD_DIMS(FLASH_CASE_DP, NAME)                                            \
      default:                                                                        \
        return (int)cudaErrorInvalidValue;                                            \
    }                                                                                 \
  }
