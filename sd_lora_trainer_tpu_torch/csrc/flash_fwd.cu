// K1 flash_fwd: non-causal segment-masked attention forward with the
// log-sum-exp residual.
//
// Replaces the Pallas TPU forward kernel that sd_lora_trainer_tpu reaches
// through ops/flash_attention.py::_named_flash (f/fwd -> the library's
// _flash_attention -> _flash_attention_impl, pl.pallas_call at library
// flash_attention.py:758). Contract: flash_common.cuh.
//
// Bound on the H100: at the SDXL shapes (L = 4096 and 1024, d = 64) the
// kernel does 4*L*d flops per q row against 4*d bytes of q and o, so it is
// bound by tensor-core operations, not bytes (about 1,000 flops per byte).
// Design: one block of 4 warps per (q tile of 64 rows, head, batch), with L on
// blockIdx.x. Each warp owns 16 q rows and walks the k tiles (64 keys) staged
// in shared memory, computing S = Q K^T and O += P V with mma.sync m16n8k16
// and an fp32 online softmax kept in registers. The S accumulator is reused in
// registers as the A operand of P V, so P never touches shared memory. Left
// for later: cp.async/TMA double buffering, wgmma and warp specialisation.

#include "flash_common.cuh"

template <typename T, int DP>
__global__ void __launch_bounds__(FLASH_THREADS) flash_fwd_kernel(FlashArgs args) {
  constexpr int BM = 64, BN = 64, SROW = DP + 8, NT = DP / 8, KT = DP / 16, ST = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * SROW;
  bf16* sV = sK + BN * SROW;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int L = args.len, d = args.head_dim, vl = args.valid_len;

  const T* q = static_cast<const T*>(args.q) + b * args.sq.b + h * args.sq.h +
               (long long)qt * BM * args.sq.l;
  const T* k = static_cast<const T*>(args.k) + b * args.sk.b + h * args.sk.h;
  const T* v = static_cast<const T*>(args.v) + b * args.sv.b + h * args.sv.h;
  load_tile<T, DP, BM>(sQ, q, args.sq.l, d);

  const float sl2 = args.sm_scale * FLASH_LOG2E;
  const int qa = qt * BM + warp * 16 + g, qb = qa + 8;
  const bool real[2] = {qa < vl, qb < vl};

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < L / BN; ++kt) {
    __syncthreads();
    load_tile<T, DP, BN>(sK, k + (long long)kt * BN * args.sk.l, args.sk.l, d);
    load_tile<T, DP, BN>(sV, v + (long long)kt * BN * args.sv.l, args.sv.l, d);
    __syncthreads();

    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      load_a(a, sQ, SROW, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        uint32_t bb[2];
        load_b_rows(bb, sK, SROW, j * 8, kk * 16, lane);
        mma_bf16(s[j], a, bb);
      }
    }

    // scale into the log2 domain, mask, and take the tile's row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BN + j * 8 + t * 2 + (e & 1);
        float x = s[j][e] * sl2;
        if (seg_masked(vl, real[e >> 1], key)) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      // a row with no unmasked key yet keeps o = l = 0: subtract 0, never -inf
      base[r] = mn == -INFINITY ? 0.f : mn;
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - base[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2];
        load_b_cols(bb, sV, SROW, kc * 16, n * 8, lane);
        mma_bf16(o[n], a, bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  T* out = static_cast<T*>(args.out_a) + b * args.sa.b + h * args.sa.h;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + t * 2;
    if (col < d) {
      store2(out + qa * args.sa.l + col, o[n][0] * inv0, o[n][1] * inv0);
      store2(out + qb * args.sa.l + col, o[n][2] * inv1, o[n][3] * inv1);
    }
  }
  if (t == 0) {
    float* lse = args.lse + ((long long)b * args.heads + h) * L;
    lse[qa] = (m[0] + log2f(l[0])) * FLASH_LN2;
    lse[qb] = (m[1] + log2f(l[1])) * FLASH_LN2;
  }
}

template <typename T, int DP>
static int launch_fwd(const FlashArgs& a, cudaStream_t stream) {
  constexpr int SROW = DP + 8;
  const size_t smem = size_t(3 * 64 * SROW) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.len / 64, a.heads, a.batch);
  flash_fwd_kernel<T, DP><<<grid, FLASH_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int flash_fwd(const FlashArgs* args, void* stream) {
  FLASH_DISPATCH(launch_fwd, *args, (cudaStream_t)stream);
}
