// flash_bwd: dQ, dK and dV of segment-masked flash attention in one pass.
//
// Replaces the two Pallas TPU kernels that sd_lora_trainer_tpu reaches through
// ops/flash_attention.py::_named_flash: _flash_attention_bwd_dkv (:174) and
// _flash_attention_bwd_dq (:180) of jax.experimental.pallas.ops.tpu.
// Contract: flash_common.cuh, with bf16 inputs (the wrapper rounds fp32 ones)
// and outputs in `dtype`. From q, k, v, dO, lse and di = rowsum(o*dO):
//   P = exp(sm_scale*q.k - lse) (0 across segments),  dS = P * (dO V^T - di),
//   dV = P^T dO,  dK = sm_scale * dS^T Q,  dQ = sm_scale * dS K.
//
// Bound on the H100: 10*L^2*d flops per (batch, head) (S, dP, dV, dK, dQ)
// against 7 [L, d] tiles and 2 fp32 rows of bytes: tensor-core operations
// bound it from L = 256 up.
//
// Design (the FA3 backward on sm_90a):
// - One CTA per (key tile, head, batch) on a 1-d grid in bwd_block's order
//   (see the dQ turns below). A producer warpgroup (one thread loading, one
//   or two writing dQ, its registers given to the consumers with setmaxnreg
//   when there are two) loads K and V once by TMA and streams the Q, dO,
//   lse and di tiles of each 64-row q step through a 2-stage mbarrier ring,
//   so the loads of step i+1 overlap the products of step i (one stage
//   above DP = 208, where the dQ buffer takes the room).
// - Three tiers by padded head dim DP (BwdConfig), by what the dK and dV
//   accumulators (DP registers a thread for 64 keys) leave room for:
//   * DP <= 96: two consumer warpgroups of 64 keys each (128 a CTA), with K
//     and V as A fragments kept in registers for the whole CTA up to DP = 80
//     (read from shared memory at 96);
//   * 112 <= DP <= 160: one consumer warpgroup of 64 keys, no setmaxnreg
//     (255 registers; at 160 ptxas spills some);
//   * DP > 160, the column split: 64 keys' dK and dV would take 176-256
//     registers a thread, at or over the 255 limit. Two consumer warpgroups
//     share one 64-key tile: warpgroup 0 computes S^T = K Q^T and P^T,
//     warpgroup 1 dP^T = V dO^T and, from P^T, dS^T; each hands its result to
//     the other through shared memory as bf16, and each then owns a column
//     range of dK, dV and dQ (SPLIT_COLS, at most 128 columns, a multiple of
//     the chunk width) and runs dV += P^T dO, dK += dS^T Q and dQ = dS K on
//     its columns with both operands from shared memory.
// - The five products run on wgmma (bf16 in, fp32 accumulate). In the key
//   tiers, per consumer warpgroup and its 64 keys: S^T = K Q^T and
//   dP^T = V dO^T (K and V as register A fragments, or from shared memory);
//   dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers and dO, Q
//   read transposed through the descriptor; dS^T goes to shared memory as
//   bf16 and dQ_partial = dS K reads it transposed. Within a step the waits
//   are staggered: P is computed while dP^T runs, and dS while dV runs.
// - dQ_partial goes from registers into an fp32 buffer of the q tile in
//   shared memory (two warpgroups of one key tile: the first stores its
//   part, the second adds its own to it), laid out in the order of the
//   accumulator's registers (dq_acc_index); a writer thread of the
//   producer warpgroup adds the buffer into an fp32 accumulator of [B, H, L,
//   round_up(d, 16)] floats with one bulk add of the copy engine (resolved
//   in L2), and a second small kernel scales it and casts it into dq.
// - The adds into a q tile come in a fixed order, so dq has the same bits on
//   every launch, as the reference's dQ kernel gives by summing the key
//   blocks in order in scratch. The CTAs that reach a q tile (q_tile_live)
//   add in the order of their key tiles; the tile's turn counter (sem, zeroed by
//   the caller) counts the CTAs done. The dq writer (dq_writer) spins until
//   it reads the number of live CTAs before its own (live_before; the spin
//   holds the watchdog trap, which only a producer warp may), adds the
//   buffer (the first CTA stores it instead, so the accumulator needs no
//   zeroing), waits for the add to complete and releases the counter. The
//   consumers only wait for a free buffer (two where shared memory allows),
//   so a late turn stalls them only when the writer is a buffer behind.
//   CTAs of one head that start together take turns one after the other (a
//   turn passes from CTA to CTA in a few microseconds), so the grid's order
//   (bwd_block) runs over key tile 0 of `group` heads, then key tile 1 of
//   the same heads, and so on: blocks that start together take one key tile
//   each of other heads, and a first wave about a quarter of each head's
//   (group = 4 * SMs / key tiles, at most every head). With all key tiles of
//   a head on consecutive blocks, as a 3-d grid gives them, every wave paid
//   for a whole head's chain of turns (PERF.md, Findings).
// - Deadlock freedom rests on one assumption, as in FlashAttention-3's
//   deterministic backward: the hardware dispatches CTAs in the order of
//   their linear block index, so the CTAs a writer waits on (lower key
//   tiles of its head: lower blockIdx.x in bwd_block's order) are resident
//   or done.
// - q tiles where the segment mask removes every (query, key) pair of the CTA
//   are skipped by producer and consumers alike.

#include "flash_common.cuh"
#include "hopper_common.cuh"

struct BwdParams {
  float* dq_acc;  // fp32 [B, H, L, DP]; see dq_acc_index
  int* dq_sem;    // int32 [B, H, L / 64], zeroed by the caller: adders done per q tile
  void* dk;
  void* dv;
  FlashStrides sdk, sdv;
  const float* lse;
  const float* di;
  int heads, len, head_dim, valid_len;
  float sm_scale;
  int batch, group;  // bwd_block's order: `group` heads a run of blocks
};

// Shared memory of the backward for tiles of these sizes, with `stages`
// stages of the ring and `bufs` dQ buffers.
constexpr int bwd_smem_bytes(int kv, int qt, int ds, int dq, int bm, int stages, int bufs) {
  return 2 * kv + stages * (2 * qt + 2 * bm * 4) + ds + bufs * dq + (1 + 2 * stages + 2 * bufs) * 8;
}

template <int DP>
struct BwdConfig {
  static constexpr int CW = DP % 64 == 0 ? 64 : (DP % 32 == 0 ? 32 : 16);  // chunk width
  // DP > 160: two consumer warpgroups split the columns of one 64-key tile
  static constexpr bool SPLIT = DP > 160;
  // consumer warpgroups: two of 64 keys each up to DP = 96, one to 160, two
  // sharing 64 keys in the split
  static constexpr int NWG = DP > 96 && !SPLIT ? 1 : 2;
  static constexpr int BN = SPLIT ? 64 : 64 * NWG, BM = 64;
  // K and V as wgmma A fragments in registers (DP / 2 a thread)
  static constexpr bool KV_REGS = DP <= 80;
  // the split's columns of warpgroup 0 (warpgroup 1 has the rest): a multiple
  // of the chunk width, so every column piece starts on a chunk
  static constexpr int SPLIT_COLS = (DP / 2 + CW - 1) / CW * CW;
  // consumer warpgroups first, then the producer warpgroup
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int KV_BYTES = BN * DP * 2;  // one of the K, V tiles
  static constexpr int QT_BYTES = BM * DP * 2;  // one Q or dO tile
  // a [64][64] bf16 tile: dS^T of one warpgroup; in the split, P^T (the
  // first) and dS^T (the second)
  static constexpr int DS_BYTES = 64 * BM * 2;
  static constexpr int DQ_BYTES = BM * DP * 4;  // a q tile's fp32 dQ part
  static constexpr int SMEM_MAX = 232448 - 1024;  // - base alignment
  // a 2-stage ring and two dQ buffers where they fit (DP <= 160); one
  // buffer to DP = 208; above, one stage
  static constexpr int STAGES =
      bwd_smem_bytes(KV_BYTES, QT_BYTES, NWG * DS_BYTES, DQ_BYTES, BM, 2, 1) <= SMEM_MAX ? 2 : 1;
  static constexpr int DQ_BUFS =
      bwd_smem_bytes(KV_BYTES, QT_BYTES, NWG * DS_BYTES, DQ_BYTES, BM, STAGES, 2) <= SMEM_MAX
          ? 2
          : 1;
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KV_BYTES;
  static constexpr int OFF_Q = OFF_V + KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * QT_BYTES;
  static constexpr int OFF_DS = OFF_DO + STAGES * QT_BYTES;
  static constexpr int OFF_DQ = OFF_DS + NWG * DS_BYTES;
  static constexpr int OFF_LSE = OFF_DQ + DQ_BUFS * DQ_BYTES;
  static constexpr int OFF_DI = OFF_LSE + STAGES * BM * 4;
  static constexpr int OFF_BAR = OFF_DI + STAGES * BM * 4;
  static constexpr int SMEM = OFF_BAR + (1 + 2 * STAGES + 2 * DQ_BUFS) * 8;
  static_assert(SMEM == bwd_smem_bytes(KV_BYTES, QT_BYTES, NWG * DS_BYTES, DQ_BYTES, BM, STAGES,
                                       DQ_BUFS) && SMEM <= SMEM_MAX, "shared memory");
  static_assert(!SPLIT || (SPLIT_COLS <= 128 && DP - SPLIT_COLS > 0), "split columns");
  // named barrier of the key tiers' two warpgroups: warpgroup 0's dQ part is
  // in the buffer
  static constexpr int DQ_COMBINE = 4;
};

// The (key tile, head, batch) of this CTA: blockIdx.x runs over runs of
// `group` blocks, one key tile each of `group` consecutive (batch, head)
// pairs, all key tiles of those pairs before the next `group` (the last run
// of pairs may be shorter).
template <int DP>
__device__ __forceinline__ void bwd_block(const BwdParams& p, int* kt, int* h, int* b) {
  const int nkt = p.len / BwdConfig<DP>::BN, pairs = p.batch * p.heads;
  const int lin = blockIdx.x, first = lin / (p.group * nkt) * p.group;
  const int width = min(p.group, pairs - first), r = lin - first * nkt;
  const int bh = first + r % width;
  *kt = r / width;
  *h = bh % p.heads;
  *b = bh / p.heads;
}

// What the consumer warpgroups of one CTA share.
struct BwdCta {
  unsigned char* smem;  // 1024-byte aligned
  uint64_t* bar_kv;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* dq_full;   // a dQ buffer holds the q tile's part
  uint64_t* dq_empty;  // the dq writer has read it
  long long row_base;  // (b * heads + h) * L: the rows of lse, di and dq_acc
  int k0, nq, b, h;
};

// A q tile is live when some (query, key) pair of it and the key tile at k0
// shares a segment.
template <int BN, int BM>
__device__ __forceinline__ bool q_tile_live(int q0, int k0, int vl) {
  return vl == 0 || (k0 < vl && q0 < vl) || (k0 + BN > vl && q0 + BM > vl);
}

// The live key tiles of width BN before key tile kt for the q tile at q0,
// in closed form: q_tile_live holds for every key tile when the q tile has
// real and pad rows (or there is no mask), for those with a real key when it
// has real rows only, and for those with a pad key when it has pad rows only.
template <int BN, int BM>
__device__ __forceinline__ int live_before(int q0, int kt, int vl) {
  const bool real = q0 < vl, pad = q0 + BM > vl;
  if (vl == 0 || (real && pad)) return kt;
  if (real) return min(kt, (vl + BN - 1) / BN);
  return max(0, kt - vl / BN);
}

// acc, columns [N0, N0 + W) of a 64-row q tile in a consumer warpgroup's
// accumulator layout, into its dQ buffer (thread tid's view: buf + 4 tid) in
// the order of dq_acc_index, stored or (`add`) added to what is there: each
// warp writes 512 contiguous bytes a step.
template <int N0, int W>
__device__ __forceinline__ void put_dq(float* buf, const float* acc, bool add) {
  float4* dst = reinterpret_cast<float4*>(buf + N0 * 64);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    float4 v = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    if (add) {
      const float4 o = dst[j * 128];
      v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
    }
    dst[j * 128] = v;
  }
}

// One thread of warp 1 + `slot` of the producer warpgroup: the CTA's dQ
// part of each live q tile that dQ buffer `slot` takes (every DQ_BUFS-th),
// from the buffer into dq_acc in the tile's turn (see the header), in the
// consumers' order of q tiles. One writer a buffer, so that one tile's wait
// for its turn and for its add to complete overlaps the other's.
template <int DP>
__device__ __forceinline__ void dq_writer(const BwdParams& p, const BwdCta& cta, int kt,
                                          int slot) {
  using C = BwdConfig<DP>;
  constexpr int BN = C::BN, BM = C::BM, NB = C::DQ_BUFS;
  int* sem = p.dq_sem + cta.row_base / BM;
  float* acc = p.dq_acc + cta.row_base * DP;
  const unsigned char* buf = cta.smem + C::OFF_DQ + slot * C::DQ_BYTES;
  const int vl = p.valid_len;
  int it = 0;
  for (int qi = 0; qi < cta.nq; ++qi) {
    const int q0 = qi * BM;
    if (!q_tile_live<BN, BM>(q0, kt * BN, vl)) continue;
    if (it++ % NB != slot) continue;
    const int before = live_before<BN, BM>(q0, kt, vl);
    wait_counter(sem + qi, before);
    fence_proxy_async_global();
    mbar_wait<true>(&cta.dq_full[slot], ((it - 1) / NB) & 1);
    if (before == 0) {
      bulk_store(acc + (long long)q0 * DP, buf, C::DQ_BYTES);
    } else {
      bulk_add_f32(acc + (long long)q0 * DP, buf, C::DQ_BYTES);
    }
    bulk_wait_all();
    mbar_arrive(&cta.dq_empty[slot]);
    release_counter(sem + qi, 1);
  }
}

// Offset in a [64][64] bf16 tile of 128-byte rows (128B-swizzled, the
// layout TMA writes and wgmma reads) of the pair that bf16 A-fragment word i
// of k-step kc holds: f[4kc + i] = (row 16*warp + g + 8*(i%2), columns
// 16kc + 8*(i/2) + 2t, +1).
__device__ __forceinline__ uint32_t frag_tile_offset(int kc, int i, int warp, int g, int t) {
  const int r = 16 * warp + g + 8 * (i & 1), c = 16 * kc + 8 * (i >> 1) + 2 * t;
  return swizzle_offset(r * 128 + c * 2, 64);
}

// f[4kc + i] -> a [64][64] bf16 tile (frag_tile_offset), and back.
template <int BM>
__device__ __forceinline__ void store_frag_tile(unsigned char* tile, const uint32_t* f, int warp,
                                                int g, int t) {
#pragma unroll
  for (int kc = 0; kc < BM / 16; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(tile + frag_tile_offset(kc, i, warp, g, t)) = f[4 * kc + i];
  }
}

template <int BM>
__device__ __forceinline__ void load_frag_tile(const unsigned char* tile, uint32_t* f, int warp,
                                               int g, int t) {
#pragma unroll
  for (int kc = 0; kc < BM / 16; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[4 * kc + i] = *reinterpret_cast<const uint32_t*>(tile + frag_tile_offset(kc, i, warp, g, t));
  }
}

// In the accumulator layout of a [64 keys, BM q] tile (register 4j+e holds
// key row 16*warp + g + 8*(e/2), q column 8j + 2t + e%2):
// S^T -> P^T = exp(sm_scale * S^T - lse) in place, 0 where the segment mask
// removes the pair (kreal: the thread's two keys are real; `whole`: no pair
// of the tile is masked).
template <int BM>
__device__ __forceinline__ void probs_t(float* st, const float* lse, float sl2, bool whole,
                                        int vl, const bool* kreal, int q0, int t) {
  if (whole) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        st[4 * j + e] = exp2_approx(st[4 * j + e] * sl2 - lse[qc] * FLASH_LOG2E);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const bool masked = seg_masked(vl, kreal[e >> 1], q0 + qc);
        st[4 * j + e] = masked ? 0.f : exp2_approx(st[4 * j + e] * sl2 - lse[qc] * FLASH_LOG2E);
      }
    }
  }
}

// dP^T -> dS^T = P^T * (dP^T - di) in place, with P^T from its bf16 pairs pf
// (pf[i] holds registers 2i, 2i+1), so the fp32 P^T need not stay live.
template <int BM>
__device__ __forceinline__ void grad_scores_t(float* dpt, const uint32_t* pf, const float* di,
                                              int t) {
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = 8 * j + 2 * t + (e & 1);
      const uint32_t pair = pf[2 * j + (e >> 1)];
      const float pv = __uint_as_float((e & 1) ? (pair & 0xFFFF0000u) : (pair << 16));
      dpt[4 * j + e] = pv * (dpt[4 * j + e] - di[qc]);
    }
  }
}

// Consumers of the key tiers (DP <= 160): warpgroup w owns keys
// k0 + 64w .. k0 + 64w + 63 and all DP columns of their dK and dV.
template <typename T, int DP>
__device__ __forceinline__ void bwd_consumer_keys(const BwdCta& cta, const BwdParams& p) {
  using C = BwdConfig<DP>;
  constexpr int CW = C::CW, BN = C::BN, BM = C::BM, S = C::STAGES;
  unsigned char* smem = cta.smem;
  const float* s_lse = reinterpret_cast<const float*>(smem + C::OFF_LSE);
  const float* s_di = reinterpret_cast<const float*>(smem + C::OFF_DI);
  const int vl = p.valid_len, k0 = cta.k0;
  const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kw = 64 * w;
  const int key_a = k0 + kw + 16 * warp + g, key_b = key_a + 8;
  const bool kreal[2] = {key_a < vl, key_b < vl};
  const bool wg_real = k0 + kw + 64 <= vl, wg_pad = k0 + kw >= vl;
  const float sl2 = p.sm_scale * FLASH_LOG2E;
  const int d = p.head_dim;
  const uint32_t s_k = smem_u32(smem + C::OFF_K), s_v = smem_u32(smem + C::OFF_V);
  unsigned char* ds_tile = smem + C::OFF_DS + w * C::DS_BYTES;
  const uint32_t s_ds = smem_u32(ds_tile);
  constexpr uint32_t SBO = 8 * CW * 2;  // 8-row group stride of every chunked tile
  // dQ_partial columns [N0, N0 + W) into acc: dS (MN-major A) times K_w
  auto issue_dq = [&](auto n0c, auto wc, float* acc) {
    constexpr int N0 = decltype(n0c)::value, W = decltype(wc)::value;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = gmma_desc(s_ds + kk * 16 * 128, 64 * 128, 1024, 64);
      const uint64_t db = gmma_desc(s_k + (N0 / CW) * BN * CW * 2 + (kw + 16 * kk) * CW * 2,
                                    BN * CW * 2, SBO, CW);
      Wgmma<W>::template ss<1, 1>(acc, da, db, kk > 0);
    }
  };

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pf[BM / 4], df[BM / 4];  // bf16 P^T and dS^T as wgmma A fragments

  mbar_wait(cta.bar_kv, 0);
  // K_w and V_w as wgmma A fragments (k-step kk: columns 16kk..16kk+15),
  // read once from the swizzled tiles; from DP = 96 (dK and dV take DP
  // registers a thread) they stay in shared memory
  constexpr bool KV_REGS = C::KV_REGS;
  constexpr int KVF = KV_REGS ? DP / 4 : 1;
  uint32_t kf[KVF], vf[KVF];
  if constexpr (KV_REGS) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kw + 16 * warp + g + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * t;
        const uint32_t off =
            (c / CW) * BN * CW * 2 + swizzle_offset(r * CW * 2 + (c % CW) * 2, CW);
        kf[4 * kk + i] = *reinterpret_cast<const uint32_t*>(smem + C::OFF_K + off);
        vf[4 * kk + i] = *reinterpret_cast<const uint32_t*>(smem + C::OFF_V + off);
      }
    }
  }
  int it = 0;
  for (int qi = 0; qi < cta.nq; ++qi) {
    if (!q_tile_live<BN, BM>(qi * BM, k0, vl)) continue;
    const int s = it % S;
    mbar_wait(&cta.full[s], (it / S) & 1);
    const uint32_t s_q = smem_u32(smem + C::OFF_Q + s * C::QT_BYTES);
    const uint32_t s_do = smem_u32(smem + C::OFF_DO + s * C::QT_BYTES);
    const float* lse = s_lse + s * BM;
    const float* di = s_di + s * BM;

    // S^T = K_w Q^T and dP^T = V_w dO^T: [64 keys, 64 q], Q and dO K-major
    float st[BM / 2], dpt[BM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk * 16) / CW, within = (kk * 16) % CW * 2;
      const uint64_t db = gmma_desc(s_q + col * BM * CW * 2 + within, 16, SBO, CW);
      if constexpr (KV_REGS) {
        Wgmma<BM>::template rs<0>(st, kf + 4 * kk, db, kk > 0);
      } else {
        const uint64_t da =
            gmma_desc(s_k + col * BN * CW * 2 + kw * CW * 2 + within, 16, SBO, CW);
        Wgmma<BM>::template ss<0, 0>(st, da, db, kk > 0);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk * 16) / CW, within = (kk * 16) % CW * 2;
      const uint64_t db = gmma_desc(s_do + col * BM * CW * 2 + within, 16, SBO, CW);
      if constexpr (KV_REGS) {
        Wgmma<BM>::template rs<0>(dpt, vf + 4 * kk, db, kk > 0);
      } else {
        const uint64_t da =
            gmma_desc(s_v + col * BN * CW * 2 + kw * CW * 2 + within, 16, SBO, CW);
        Wgmma<BM>::template ss<0, 0>(dpt, da, db, kk > 0);
      }
    }
    wgmma_commit();

    // P^T and dS^T in the accumulator layout: register 4j+e holds key row
    // 16*warp + g + 8*(e/2), q column 8j + 2t + e%2. bf16 A fragments: k-step
    // kc (q columns 16kc..16kc+15) is n-tiles 2kc and 2kc+1.
    wgmma_wait<1>();  // S^T is done; dP^T may still run
    fence_regs<BM / 2>(st);
    const int q0 = qi * BM;
    probs_t<BM>(st, lse, sl2, vl == 0 || (wg_real && q0 + BM <= vl) || (wg_pad && q0 >= vl), vl,
                kreal, q0, t);
#pragma unroll
    for (int i = 0; i < BM / 4; ++i) pf[i] = pack_bf16(st[2 * i], st[2 * i + 1]);

    // dV += P^T dO (A from registers, B MN-major) runs while dS is computed
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      Pieces<0, DP>::run([&](auto n0c, auto wc) {
        constexpr int N0 = decltype(n0c)::value, W = decltype(wc)::value;
        const uint32_t off = (N0 / CW) * BM * CW * 2 + kc * 16 * CW * 2;
        Wgmma<W>::template rs<1>(dv + N0 / 2, pf + 4 * kc,
                                 gmma_desc(s_do + off, BM * CW * 2, SBO, CW), 1);
      });
    }
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done; dV may still run
    fence_regs<BM / 2>(dpt);
    grad_scores_t<BM>(dpt, pf, di, t);
#pragma unroll
    for (int i = 0; i < BM / 4; ++i) df[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);

    // dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      Pieces<0, DP>::run([&](auto n0c, auto wc) {
        constexpr int N0 = decltype(n0c)::value, W = decltype(wc)::value;
        const uint32_t off = (N0 / CW) * BM * CW * 2 + kc * 16 * CW * 2;
        Wgmma<W>::template rs<1>(dk + N0 / 2, df + 4 * kc,
                                 gmma_desc(s_q + off, BM * CW * 2, SBO, CW), 1);
      });
    }
    wgmma_commit();

    // dS^T -> shared memory as [64 keys][64 q] bf16, 128B-swizzled rows: the
    // MN-major A operand of dQ = dS K
    store_frag_tile<BM>(ds_tile, df, warp, g, t);
    fence_proxy_async();
    named_barrier(1 + w, 128);

    // dQ_partial = dS K_w, one column piece at a time, into the q tile's dQ
    // buffer: warpgroup 0 stores its part, warpgroup 1 then adds its own
    const int slot = it % C::DQ_BUFS;
    float* dq_buf = reinterpret_cast<float*>(smem + C::OFF_DQ + slot * C::DQ_BYTES) + tid * 4;
    if (w == 0) mbar_wait(&cta.dq_empty[slot], ((it / C::DQ_BUFS) & 1) ^ 1);
    Pieces<0, DP>::run([&](auto n0c, auto wc) {
      constexpr int N0 = decltype(n0c)::value, W = decltype(wc)::value;
      float acc[W / 2];
      wgmma_fence();
      issue_dq(n0c, wc, acc);
      wgmma_commit();
      if constexpr (C::NWG == 2 && N0 == 0) {
        if (w == 1) named_barrier(C::DQ_COMBINE, 256);  // warpgroup 0's part is in
      }
      wgmma_wait<0>();
      fence_regs<W / 2>(acc);
      put_dq<N0, W>(dq_buf, acc, w == 1);
    });
    if (C::NWG == 2 && w == 0) {
      named_barrier_arrive(C::DQ_COMBINE, 256);
    } else {
      fence_proxy_async();  // the buffer is read by the copy engine
      mbar_arrive(&cta.dq_full[slot]);
    }
    fence_regs<BM / 4>(pf);  // A fragments stay put until their wgmmas are done
    fence_regs<BM / 4>(df);
    mbar_arrive(&cta.empty[s]);  // every product reading this stage has completed
    ++it;
  }
  fence_regs<DP / 2>(dk);
  fence_regs<DP / 2>(dv);

  T* dk_out = static_cast<T*>(p.dk) + cta.b * p.sdk.b + cta.h * p.sdk.h;
  T* dv_out = static_cast<T*>(p.dv) + cta.b * p.sdv.b + cta.h * p.sdv.h;
  const float sc = p.sm_scale;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col < d) {
      store2(dk_out + key_a * p.sdk.l + col, dk[4 * j] * sc, dk[4 * j + 1] * sc);
      store2(dk_out + key_b * p.sdk.l + col, dk[4 * j + 2] * sc, dk[4 * j + 3] * sc);
      store2(dv_out + key_a * p.sdv.l + col, dv[4 * j], dv[4 * j + 1]);
      store2(dv_out + key_b * p.sdv.l + col, dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// Consumers of the split tier (DP > 160): both warpgroups work on keys
// k0 .. k0 + 63. ROLE 0 computes S^T and P^T, ROLE 1 dP^T and dS^T; the two
// hand P^T and dS^T over through shared memory, and ROLE r then owns
// columns [N0, N0 + NW) of dK, dV and dQ.
template <typename T, int DP, int ROLE>
__device__ __forceinline__ void bwd_consumer_split(const BwdCta& cta, const BwdParams& p) {
  using C = BwdConfig<DP>;
  constexpr int CW = C::CW, BN = C::BN, BM = C::BM, S = C::STAGES;
  constexpr int N0 = ROLE == 0 ? 0 : C::SPLIT_COLS;
  constexpr int NW = ROLE == 0 ? C::SPLIT_COLS : DP - C::SPLIT_COLS;
  unsigned char* smem = cta.smem;
  const float* s_lse = reinterpret_cast<const float*>(smem + C::OFF_LSE);
  const float* s_di = reinterpret_cast<const float*>(smem + C::OFF_DI);
  const int vl = p.valid_len, k0 = cta.k0;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;
  const bool kreal[2] = {key_a < vl, key_b < vl};
  const bool all_real = k0 + BN <= vl, all_pad = k0 >= vl;
  const float sl2 = p.sm_scale * FLASH_LOG2E;
  const uint32_t s_k = smem_u32(smem + C::OFF_K), s_v = smem_u32(smem + C::OFF_V);
  unsigned char* p_tile = smem + C::OFF_DS;  // P^T, bf16 [64 keys][64 q]
  unsigned char* ds_tile = p_tile + C::DS_BYTES;  // dS^T, the same layout
  const uint32_t s_p = smem_u32(p_tile), s_ds = smem_u32(ds_tile);
  constexpr uint32_t SBO = 8 * CW * 2;  // 8-row group stride of every chunked tile

  float dk[NW / 2], dv[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) dk[i] = dv[i] = 0.f;
  uint32_t f[BM / 4];  // bf16 P^T or dS^T pairs, in A-fragment order

  mbar_wait(cta.bar_kv, 0);
  int it = 0;
  for (int qi = 0; qi < cta.nq; ++qi) {
    const int q0 = qi * BM;
    if (!q_tile_live<BN, BM>(q0, k0, vl)) continue;
    const int s = it % S;
    mbar_wait(&cta.full[s], (it / S) & 1);
    const uint32_t s_q = smem_u32(smem + C::OFF_Q + s * C::QT_BYTES);
    const uint32_t s_do = smem_u32(smem + C::OFF_DO + s * C::QT_BYTES);

    // ROLE 0: S^T = K Q^T; ROLE 1: dP^T = V dO^T ([64 keys, 64 q], K-major).
    // Accumulator layout: register 4j+e holds key row 16*warp + g + 8*(e/2),
    // q column 8j + 2t + e%2.
    float acc[BM / 2];
    const uint32_t s_a = ROLE == 0 ? s_k : s_v, s_b = ROLE == 0 ? s_q : s_do;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk * 16) / CW, within = (kk * 16) % CW * 2;
      Wgmma<BM>::template ss<0, 0>(acc, gmma_desc(s_a + col * BN * CW * 2 + within, 16, SBO, CW),
                                   gmma_desc(s_b + col * BM * CW * 2 + within, 16, SBO, CW),
                                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BM / 2>(acc);
    if constexpr (ROLE == 0) {
      probs_t<BM>(acc, s_lse + s * BM, sl2,
                  vl == 0 || (all_real && q0 + BM <= vl) || (all_pad && q0 >= vl), vl, kreal, q0,
                  t);
#pragma unroll
      for (int i = 0; i < BM / 4; ++i) f[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
      store_frag_tile<BM>(p_tile, f, warp, g, t);
      fence_proxy_async();
      named_barrier(1, 256);  // P^T is in shared memory
    } else {
      named_barrier(1, 256);  // P^T is in shared memory
      load_frag_tile<BM>(p_tile, f, warp, g, t);
      grad_scores_t<BM>(acc, f, s_di + s * BM, t);
#pragma unroll
      for (int i = 0; i < BM / 4; ++i) f[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
      store_frag_tile<BM>(ds_tile, f, warp, g, t);
      fence_proxy_async();
    }

    // dV[:, N0 : N0 + NW] += P^T dO (P^T K-major from its tile, dO MN-major)
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      Pieces<N0, NW>::run([&](auto n0c, auto wc) {
        constexpr int PN = decltype(n0c)::value, W = decltype(wc)::value;
        const uint32_t off = (PN / CW) * BM * CW * 2 + kc * 16 * CW * 2;
        Wgmma<W>::template ss<0, 1>(dv + (PN - N0) / 2, gmma_desc(s_p + kc * 32, 16, 1024, 64),
                                    gmma_desc(s_do + off, BM * CW * 2, SBO, CW), 1);
      });
    }
    wgmma_commit();
    named_barrier(2, 256);  // dS^T is in shared memory

    // dK[:, N0 : N0 + NW] += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      Pieces<N0, NW>::run([&](auto n0c, auto wc) {
        constexpr int PN = decltype(n0c)::value, W = decltype(wc)::value;
        const uint32_t off = (PN / CW) * BM * CW * 2 + kc * 16 * CW * 2;
        Wgmma<W>::template ss<0, 1>(dk + (PN - N0) / 2, gmma_desc(s_ds + kc * 32, 16, 1024, 64),
                                    gmma_desc(s_q + off, BM * CW * 2, SBO, CW), 1);
      });
    }
    wgmma_commit();

    // dQ_partial[:, N0 : N0 + NW] = dS K (dS^T read MN-major, K MN-major),
    // one column piece at a time, into the q tile's dQ buffer (the two roles'
    // columns are disjoint)
    const int slot = it % C::DQ_BUFS;
    float* dq_buf = reinterpret_cast<float*>(smem + C::OFF_DQ + slot * C::DQ_BYTES) + tid * 4;
    mbar_wait(&cta.dq_empty[slot], ((it / C::DQ_BUFS) & 1) ^ 1);
    Pieces<N0, NW>::run([&](auto n0c, auto wc) {
      constexpr int PN = decltype(n0c)::value, W = decltype(wc)::value;
      float dq[W / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = gmma_desc(s_ds + kk * 16 * 128, 64 * 128, 1024, 64);
        const uint64_t db =
            gmma_desc(s_k + (PN / CW) * BN * CW * 2 + 16 * kk * CW * 2, BN * CW * 2, SBO, CW);
        Wgmma<W>::template ss<1, 1>(dq, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<W / 2>(dq);
      put_dq<PN, W>(dq_buf, dq, false);
    });
    fence_proxy_async();  // the buffer is read by the copy engine
    mbar_arrive(&cta.dq_full[slot]);
    fence_regs<BM / 4>(f);
    // every product reading this stage and both handover tiles has completed
    // in both warpgroups before either writes a tile again
    named_barrier(3, 256);
    mbar_arrive(&cta.empty[s]);
    ++it;
  }
  fence_regs<NW / 2>(dk);
  fence_regs<NW / 2>(dv);

  T* dk_out = static_cast<T*>(p.dk) + cta.b * p.sdk.b + cta.h * p.sdk.h;
  T* dv_out = static_cast<T*>(p.dv) + cta.b * p.sdv.b + cta.h * p.sdv.h;
  const float sc = p.sm_scale;
  const int d = p.head_dim;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = N0 + 8 * j + 2 * t;
    if (col < d) {
      store2(dk_out + key_a * p.sdk.l + col, dk[4 * j] * sc, dk[4 * j + 1] * sc);
      store2(dk_out + key_b * p.sdk.l + col, dk[4 * j + 2] * sc, dk[4 * j + 3] * sc);
      store2(dv_out + key_a * p.sdv.l + col, dv[4 * j], dv[4 * j + 1]);
      store2(dv_out + key_b * p.sdv.l + col, dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(BwdConfig<DP>::THREADS, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const BwdParams p) {
  using C = BwdConfig<DP>;
  constexpr int CW = C::CW, NC = DP / CW, BN = C::BN, BM = C::BM, S = C::STAGES;
  constexpr int NWG = C::NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + S;
  uint64_t* dq_full = empty + S;
  uint64_t* dq_empty = dq_full + C::DQ_BUFS;
  float* s_lse = reinterpret_cast<float*>(smem + C::OFF_LSE);
  float* s_di = reinterpret_cast<float*>(smem + C::OFF_DI);

  int kt, h, b;
  bwd_block<DP>(p, &kt, &h, &b);
  const int L = p.len, vl = p.valid_len, k0 = kt * BN;
  const long long row_base = ((long long)b * p.heads + h) * L;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    for (int s = 0; s < C::DQ_BUFS; ++s) {
      // the threads that write a dQ buffer last: the split's both roles, the
      // key tiers' last warpgroup
      mbar_init(&dq_full[s], C::SPLIT ? 256 : 128);
      mbar_init(&dq_empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int nq = L / BM;
  const BwdCta cta{smem, bar_kv, full, empty, dq_full, dq_empty, row_base, k0, nq, b, h};

  if (threadIdx.x >= 128 * NWG) {  // producer warpgroup: one thread loads, one a buffer writes dq
    if constexpr (NWG > 1) setmaxnreg_dec<24>();
    const int pw = (threadIdx.x - 128 * NWG) / 32;  // the producer's warp
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(smem + C::OFF_K + c * BN * CW * 2, &tm_k, bar_kv, c * CW, k0, h, b);
        tma_load_4d(smem + C::OFF_V + c * BN * CW * 2, &tm_v, bar_kv, c * CW, k0, h, b);
      }
      int it = 0;
      for (int qi = 0; qi < nq; ++qi) {
        if (!q_tile_live<BN, BM>(qi * BM, k0, vl)) continue;
        const int s = it % S;
        mbar_wait<true>(&empty[s], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::QT_BYTES + 2 * BM * 4);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(smem + C::OFF_Q + s * C::QT_BYTES + c * BM * CW * 2, &tm_q, &full[s], c * CW,
                      qi * BM, h, b);
          tma_load_4d(smem + C::OFF_DO + s * C::QT_BYTES + c * BM * CW * 2, &tm_do, &full[s],
                      c * CW, qi * BM, h, b);
        }
        bulk_load(s_lse + s * BM, p.lse + row_base + qi * BM, BM * 4, &full[s]);
        bulk_load(s_di + s * BM, p.di + row_base + qi * BM, BM * 4, &full[s]);
        ++it;
      }
      // the watchdog of the consumers (their waits do not trap): stay until
      // they have released every stage of the ring
      for (int j = it; j < it + S; ++j) mbar_wait<true>(&empty[j % S], ((j / S) & 1) ^ 1);
    } else if (threadIdx.x % 32 == 0 && pw >= 1 && pw <= C::DQ_BUFS) {
      dq_writer<DP>(p, cta, kt, pw - 1);
    }
    return;
  }

  if constexpr (NWG > 1) setmaxnreg_inc<240>();
  if constexpr (C::SPLIT) {
    if (threadIdx.x < 128) {
      bwd_consumer_split<T, DP, 0>(cta, p);
    } else {
      bwd_consumer_split<T, DP, 1>(cta, p);
    }
  } else {
    bwd_consumer_keys<T, DP>(cta, p);
  }
}

// Index of (row r, column c) of a 64-row q tile in its block of 64 * DP
// floats of dq_acc: the order in which a consumer warpgroup's wgmma
// accumulator holds the tile, 8 columns (one n8 tile, 512 floats) after
// another whatever the column pieces, so that each warp writes a piece into
// the dQ buffer with 16-byte stores on 512 contiguous bytes (put_dq).
__device__ __forceinline__ int dq_acc_index(int r, int c) {
  const int tid = (r >> 4) * 32 + (r & 7) * 4 + ((c & 7) >> 1);
  const int e = ((r >> 3) & 1) * 2 + (c & 1);
  return (c >> 3) * 512 + tid * 4 + e;
}

// dq = sm_scale * dq_acc in dq's dtype and strides; one thread per pair.
template <typename T, int DP>
__global__ void flash_bwd_dq_convert_kernel(const float* acc, T* dq, FlashStrides s, int heads,
                                            int len, int d, float scale, long long pairs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const long long row = i / (d / 2);  // (b * heads + h) * len + l
  const int col = (int)(i % (d / 2)) * 2;
  const int l = (int)(row % len);
  const int h = (int)((row / len) % heads);
  const long long b = row / ((long long)len * heads);
  const float* tile = acc + (row - (l & 63)) * DP;
  const float2 v = *reinterpret_cast<const float2*>(tile + dq_acc_index(l & 63, col));
  store2(dq + b * s.b + h * s.h + (long long)l * s.l + col, v.x * scale, v.y * scale);
}

template <typename T, int DP>
static int launch_bwd(const FlashArgs& a, cudaStream_t stream) {
  using C = BwdConfig<DP>;
  if (a.len % C::BN != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  const bool ok =
      make_bhld_map(&tq, a.q, a.batch, a.heads, a.len, a.head_dim, a.sq.b, a.sq.h, a.sq.l, C::CW,
                    C::BM) &&
      make_bhld_map(&tk, a.k, a.batch, a.heads, a.len, a.head_dim, a.sk.b, a.sk.h, a.sk.l, C::CW,
                    C::BN) &&
      make_bhld_map(&tv, a.v, a.batch, a.heads, a.len, a.head_dim, a.sv.b, a.sv.h, a.sv.l, C::CW,
                    C::BN) &&
      make_bhld_map(&tdo, a.dout, a.batch, a.heads, a.len, a.head_dim, a.sdo.b, a.sdo.h, a.sdo.l,
                    C::CW, C::BM);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (a.acc == nullptr || a.sem == nullptr) return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.dq_acc = a.acc;
  p.dq_sem = a.sem;
  p.dk = a.out_a;
  p.dv = a.out_b;
  p.sdk = a.sa;
  p.sdv = a.sb;
  p.lse = a.lse;
  p.di = a.di;
  p.heads = a.heads;
  p.len = a.len;
  p.head_dim = a.head_dim;
  p.valid_len = a.valid_len;
  p.sm_scale = a.sm_scale;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int nkt = a.len / C::BN;
  p.batch = a.batch;
  p.group = max(1, min(a.batch * a.heads, 4 * sms / nkt));
  const int smem = C::SMEM + 1024;  // + alignment of the base to 1024 bytes
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_kernel<T, DP><<<(unsigned)(nkt * a.heads * a.batch), C::THREADS, smem, stream>>>(
      tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)a.batch * a.heads * a.len * (a.head_dim / 2);
  flash_bwd_dq_convert_kernel<T, DP><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      a.acc, static_cast<T*>(a.out_c), a.sc, a.heads, a.len, a.head_dim, a.sm_scale, pairs);
  return (int)cudaGetLastError();
}

#ifdef FLASH_DP
FLASH_DEFINE_DP(flash_bwd, launch_bwd, FLASH_DP)
#else
FLASH_DISPATCH(flash_bwd)
#endif
