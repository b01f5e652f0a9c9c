// Shared contract and tile helpers of the three flash-attention kernels
// (flash_fwd.cu, flash_bwd_dkv.cu, flash_bwd_dq.cu).
//
// Contract (all three kernels):
//   q, k, v, dO, o, dq, dk, dv: logical [B, H, L, d] with arbitrary element
//     strides for b, h and l and a contiguous last dim; bf16 or fp32 (all of
//     one type). Every stride is a multiple of 8 elements and every base
//     pointer is 16-byte aligned (the Python wrapper checks this).
//   lse, di: fp32 [B, H, L], contiguous.
//   L is a multiple of 64; d is a multiple of 8 with round_up(d, 16) in
//     {48, 64, 80, 160} (SD head dims 40, 64, 80, 160).
//   Segment mask: with valid_len > 0, token i has segment id (i < valid_len).
//     A query attends a key only when both have the same id, so pad rows
//     attend only to pad keys and stay finite.
//   Products run on the tensor cores in bf16 (fp32 inputs are rounded to bf16
//   when staged into shared memory); accumulation and softmax are fp32.
//   The forward returns o and lse = log(sum_k exp(s_qk)), s = sm_scale*q.k,
//   which replaces the TPU kernel's separate row max m and row sum l.

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
  void* out_a;  // fwd: o; dkv: dk; dq: dq
  void* out_b;  // dkv: dv
  float* lse;   // written by fwd, read by the backward kernels
  const float* di;
  FlashStrides sq, sk, sv, sdo, sa, sb;
  int batch, heads, len, head_dim;
  float sm_scale;
  int valid_len;
  int dtype;  // 0 = bf16, 1 = fp32
};

#define FLASH_LOG2E 1.4426950408889634f
#define FLASH_LN2 0.6931471805599453f
#define FLASH_THREADS 128

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b over one m16n8k16 tile (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct Load8;

template <>
struct Load8<bf16> {
  static __device__ __forceinline__ uint4 load(const bf16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
};

template <>
struct Load8<float> {
  static __device__ __forceinline__ uint4 load(const float* p) {
    float4 a = reinterpret_cast<const float4*>(p)[0];
    float4 b = reinterpret_cast<const float4*>(p)[1];
    uint4 r;
    r.x = pack_bf16(a.x, a.y);
    r.y = pack_bf16(a.z, a.w);
    r.z = pack_bf16(b.x, b.y);
    r.w = pack_bf16(b.z, b.w);
    return r;
  }
};

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Stage ROWS rows of a [*, d] matrix (row stride sl elements) into a bf16
// shared tile [ROWS][DP + 8], zero-filling the columns d..DP-1.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const T* g, long long sl, int d) {
  constexpr int C8 = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * C8; idx += FLASH_THREADS) {
    const int r = idx / C8;
    const int c = (idx % C8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < d) val = Load8<T>::load(g + r * sl + c);
    *reinterpret_cast<uint4*>(s + r * (DP + 8) + c) = val;
  }
}

// A fragment of m16n8k16: rows row0..row0+15, columns k0..k0+15 of a
// row-major shared tile.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int srow, int row0, int k0,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p0 = s + (row0 + g) * srow + k0 + t * 2;
  const bf16* p1 = p0 + 8 * srow;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment with B[k][n] = S[n0 + n][k0 + k]: the tile's rows are the n
// index (a K^T operand read from row-major K).
__device__ __forceinline__ void load_b_rows(uint32_t b[2], const bf16* s, int srow, int n0, int k0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (n0 + g) * srow + k0 + t * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment with B[k][n] = S[k0 + k][n0 + n]: the tile's rows are the k
// index (a V operand read from row-major V).
__device__ __forceinline__ void load_b_cols(uint32_t b[2], const bf16* s, int srow, int k0, int n0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(s) + (k0 + t * 2) * srow + n0 + g;
  b[0] = uint32_t(p[0]) | (uint32_t(p[srow]) << 16);
  b[1] = uint32_t(p[8 * srow]) | (uint32_t(p[9 * srow]) << 16);
}

// A fragment over k = columns 16*kc..16*kc+15 taken from accumulator tiles
// (the C layout of n-tiles 2kc and 2kc+1 is the A layout of one k-chunk).
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// True where the segment mask removes the (query, key) pair.
__device__ __forceinline__ bool seg_masked(int valid_len, bool q_real, int key) {
  return valid_len > 0 && (q_real != (key < valid_len));
}

// Dispatch a launcher template over the element type and padded head dim.
#define FLASH_DISPATCH(LAUNCH, args, stream)                                  \
  do {                                                                        \
    const int dp = ((args).head_dim + 15) / 16 * 16;                          \
    const bool bf = (args).dtype == 0;                                        \
    if ((args).head_dim % 8 != 0 || (args).len % 64 != 0) return (int)cudaErrorInvalidValue; \
    switch (dp) {                                                             \
      case 48: return bf ? LAUNCH<bf16, 48>(args, stream) : LAUNCH<float, 48>(args, stream);   \
      case 64: return bf ? LAUNCH<bf16, 64>(args, stream) : LAUNCH<float, 64>(args, stream);   \
      case 80: return bf ? LAUNCH<bf16, 80>(args, stream) : LAUNCH<float, 80>(args, stream);   \
      case 160: return bf ? LAUNCH<bf16, 160>(args, stream) : LAUNCH<float, 160>(args, stream); \
      default: return (int)cudaErrorInvalidValue;                             \
    }                                                                         \
  } while (0)
