// K2 flash_bwd_dkv: dK and dV of segment-masked flash attention.
//
// Replaces the Pallas TPU kernel that sd_lora_trainer_tpu reaches through
// ops/flash_attention.py::_named_flash (bwd -> the library's
// _flash_attention_bwd_dkv, pl.pallas_call at library flash_attention.py:1121).
// Contract: flash_common.cuh. Inputs q, k, v, dO, lse and di = rowsum(o*dO);
// P = exp(sm_scale*q.k - lse) is recomputed, then
//   dV = P^T dO,  dS = P * (dO V^T - di),  dK = sm_scale * dS^T Q.
//
// Bound on the H100: 8*L*d flops per key row (P recomputed, dV, dP, dK)
// against a few hundred bytes per row, so tensor-core operations bound it.
// Design: one block of 4 warps per (k tile of 64 keys, head, batch), with L
// on blockIdx.x; K and V stay in shared memory while the block walks the q
// tiles. Each warp owns 16 keys and keeps its dK and dV rows in fp32
// registers, so no atomics are needed and the result is deterministic. The
// P^T and dS^T accumulators are reused in registers as A operands. d = 160
// takes 32-row q tiles to bound the register count.

#include "flash_common.cuh"

template <typename T, int DP>
__global__ void __launch_bounds__(FLASH_THREADS) flash_bwd_dkv_kernel(FlashArgs args) {
  constexpr int BN = 64, BM = DP > 96 ? 32 : 64;
  constexpr int SROW = DP + 8, NT = DP / 8, KT = DP / 16, MT = BM / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN * SROW;
  bf16* sQ = sV + BN * SROW;
  bf16* sO = sQ + BM * SROW;  // dO tile
  float* sLse = reinterpret_cast<float*>(sO + BM * SROW);
  float* sDi = sLse + BM;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int L = args.len, d = args.head_dim, vl = args.valid_len;

  const T* q = static_cast<const T*>(args.q) + b * args.sq.b + h * args.sq.h;
  const T* k = static_cast<const T*>(args.k) + b * args.sk.b + h * args.sk.h +
               (long long)kt * BN * args.sk.l;
  const T* v = static_cast<const T*>(args.v) + b * args.sv.b + h * args.sv.h +
               (long long)kt * BN * args.sv.l;
  const T* dout = static_cast<const T*>(args.dout) + b * args.sdo.b + h * args.sdo.h;
  const float* lse = args.lse + ((long long)b * args.heads + h) * L;
  const float* di = args.di + ((long long)b * args.heads + h) * L;
  load_tile<T, DP, BN>(sK, k, args.sk.l, d);
  load_tile<T, DP, BN>(sV, v, args.sv.l, d);

  const float sl2 = args.sm_scale * FLASH_LOG2E;
  const int ka = kt * BN + warp * 16 + g, kb = ka + 8;
  const bool kreal[2] = {ka < vl, kb < vl};

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int qt = 0; qt < L / BM; ++qt) {
    __syncthreads();
    load_tile<T, DP, BM>(sQ, q + (long long)qt * BM * args.sq.l, args.sq.l, d);
    load_tile<T, DP, BM>(sO, dout + (long long)qt * BM * args.sdo.l, args.sdo.l, d);
    for (int i = threadIdx.x; i < BM; i += FLASH_THREADS) {
      sLse[i] = lse[qt * BM + i] * FLASH_LOG2E;
      sDi[i] = di[qt * BM + i];
    }
    __syncthreads();

    // S^T = K Q^T over this warp's 16 keys, then P^T = exp(S^T - lse)
    float pt[MT][4], dpt[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      pt[j][0] = pt[j][1] = pt[j][2] = pt[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, sK, SROW, warp * 16, kk * 16, lane);
      load_a(av, sV, SROW, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        uint32_t bq[2], bo[2];
        load_b_rows(bq, sQ, SROW, j * 8, kk * 16, lane);
        load_b_rows(bo, sO, SROW, j * 8, kk * 16, lane);
        mma_bf16(pt[j], ak, bq);   // S^T
        mma_bf16(dpt[j], av, bo);  // dP^T = V dO^T
      }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + t * 2 + (e & 1);
        const bool masked = seg_masked(vl, kreal[e >> 1], qt * BM + qi);
        const float p = masked ? 0.f : exp2f(pt[j][e] * sl2 - sLse[qi]);
        pt[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sDi[qi]);  // dS^T
      }
    }

    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      uint32_t ap[4], as[4];
      acc_to_a(ap, pt[2 * kc], pt[2 * kc + 1]);
      acc_to_a(as, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bo[2], bq[2];
        load_b_cols(bo, sO, SROW, kc * 16, n * 8, lane);
        load_b_cols(bq, sQ, SROW, kc * 16, n * 8, lane);
        mma_bf16(dv[n], ap, bo);
        mma_bf16(dk[n], as, bq);
      }
    }
  }

  T* dk_out = static_cast<T*>(args.out_a) + b * args.sa.b + h * args.sa.h;
  T* dv_out = static_cast<T*>(args.out_b) + b * args.sb.b + h * args.sb.h;
  const float sc = args.sm_scale;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + t * 2;
    if (col < d) {
      store2(dk_out + ka * args.sa.l + col, dk[n][0] * sc, dk[n][1] * sc);
      store2(dk_out + kb * args.sa.l + col, dk[n][2] * sc, dk[n][3] * sc);
      store2(dv_out + ka * args.sb.l + col, dv[n][0], dv[n][1]);
      store2(dv_out + kb * args.sb.l + col, dv[n][2], dv[n][3]);
    }
  }
}

template <typename T, int DP>
static int launch_dkv(const FlashArgs& a, cudaStream_t stream) {
  constexpr int BM = DP > 96 ? 32 : 64, SROW = DP + 8;
  const size_t smem = size_t((2 * 64 + 2 * BM) * SROW) * sizeof(bf16) + 2 * BM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.len / 64, a.heads, a.batch);
  flash_bwd_dkv_kernel<T, DP><<<grid, FLASH_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv(const FlashArgs* args, void* stream) {
  FLASH_DISPATCH(launch_dkv, *args, (cudaStream_t)stream);
}
