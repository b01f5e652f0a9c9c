// K3 flash_bwd_dq: dQ of segment-masked flash attention.
//
// Replaces the Pallas TPU kernel that sd_lora_trainer_tpu reaches through
// ops/flash_attention.py::_named_flash (bwd -> the library's
// _flash_attention_bwd_dq, pl.pallas_call at library flash_attention.py:1456).
// Contract: flash_common.cuh. From q, k, v, dO, lse and di = rowsum(o*dO):
//   P = exp(sm_scale*q.k - lse),  dS = P * (dO V^T - di),  dQ = sm_scale * dS K.
//
// Bound on the H100: 6*L*d flops per q row (S recomputed, dP, dQ) against a
// few hundred bytes per row, so tensor-core operations bound it.
// Design: one block of 4 warps per (q tile of 64 rows, head, batch), with L
// on blockIdx.x; Q and dO stay in shared memory while the block walks the k
// tiles. Each warp owns 16 q rows and keeps dQ in fp32 registers; the dS
// accumulator is reused in registers as the A operand of dS K. d = 160 takes
// 32-key tiles to bound the register count.

#include "flash_common.cuh"

template <typename T, int DP>
__global__ void __launch_bounds__(FLASH_THREADS) flash_bwd_dq_kernel(FlashArgs args) {
  constexpr int BM = 64, BN = DP > 96 ? 32 : 64;
  constexpr int SROW = DP + 8, NT = DP / 8, KT = DP / 16, ST = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BM * SROW;  // dO tile
  bf16* sK = sO + BM * SROW;
  bf16* sV = sK + BN * SROW;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int L = args.len, d = args.head_dim, vl = args.valid_len;

  const T* q = static_cast<const T*>(args.q) + b * args.sq.b + h * args.sq.h +
               (long long)qt * BM * args.sq.l;
  const T* dout = static_cast<const T*>(args.dout) + b * args.sdo.b + h * args.sdo.h +
                  (long long)qt * BM * args.sdo.l;
  const T* k = static_cast<const T*>(args.k) + b * args.sk.b + h * args.sk.h;
  const T* v = static_cast<const T*>(args.v) + b * args.sv.b + h * args.sv.h;
  load_tile<T, DP, BM>(sQ, q, args.sq.l, d);
  load_tile<T, DP, BM>(sO, dout, args.sdo.l, d);

  const float sl2 = args.sm_scale * FLASH_LOG2E;
  const int qa = qt * BM + warp * 16 + g, qb = qa + 8;
  const bool real[2] = {qa < vl, qb < vl};
  const long long row_base = ((long long)b * args.heads + h) * L;
  const float lse2[2] = {args.lse[row_base + qa] * FLASH_LOG2E,
                         args.lse[row_base + qb] * FLASH_LOG2E};
  const float dii[2] = {args.di[row_base + qa], args.di[row_base + qb]};

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int kt = 0; kt < L / BN; ++kt) {
    __syncthreads();
    load_tile<T, DP, BN>(sK, k + (long long)kt * BN * args.sk.l, args.sk.l, d);
    load_tile<T, DP, BN>(sV, v + (long long)kt * BN * args.sv.l, args.sv.l, d);
    __syncthreads();

    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ, SROW, warp * 16, kk * 16, lane);
      load_a(ao, sO, SROW, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        uint32_t bk[2], bv[2];
        load_b_rows(bk, sK, SROW, j * 8, kk * 16, lane);
        load_b_rows(bv, sV, SROW, j * 8, kk * 16, lane);
        mma_bf16(s[j], aq, bk);   // S = Q K^T
        mma_bf16(dp[j], ao, bv);  // dP = dO V^T
      }
    }
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BN + j * 8 + t * 2 + (e & 1);
        const int r = e >> 1;
        const float p = seg_masked(vl, real[r], key) ? 0.f : exp2f(s[j][e] * sl2 - lse2[r]);
        dp[j][e] = p * (dp[j][e] - dii[r]);  // dS
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bk[2];
        load_b_cols(bk, sK, SROW, kc * 16, n * 8, lane);
        mma_bf16(dq[n], a, bk);
      }
    }
  }

  T* out = static_cast<T*>(args.out_a) + b * args.sa.b + h * args.sa.h;
  const float sc = args.sm_scale;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + t * 2;
    if (col < d) {
      store2(out + qa * args.sa.l + col, dq[n][0] * sc, dq[n][1] * sc);
      store2(out + qb * args.sa.l + col, dq[n][2] * sc, dq[n][3] * sc);
    }
  }
}

template <typename T, int DP>
static int launch_dq(const FlashArgs& a, cudaStream_t stream) {
  constexpr int BN = DP > 96 ? 32 : 64, SROW = DP + 8;
  const size_t smem = size_t((2 * 64 + 2 * BN) * SROW) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.len / 64, a.heads, a.batch);
  flash_bwd_dq_kernel<T, DP><<<grid, FLASH_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq(const FlashArgs* args, void* stream) {
  FLASH_DISPATCH(launch_dq, *args, (cudaStream_t)stream);
}
