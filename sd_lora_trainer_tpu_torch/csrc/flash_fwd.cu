// flash_fwd: non-causal segment-masked attention forward with the
// log-sum-exp residual.
//
// Replaces the Pallas TPU forward kernel that sd_lora_trainer_tpu reaches
// through ops/flash_attention.py::_named_flash at
// sd_lora_trainer_tpu/ops/flash_attention.py:139,144 (f and fwd -> the
// library's _flash_attention -> _flash_attention_impl, pl.pallas_call at
// library flash_attention.py:758). Contract: flash_common.cuh, with bf16
// inputs (the wrapper rounds fp32 ones) and o in `dtype`:
//   o = softmax(sm_scale*q.k^T + segment mask) v,  lse = log(sum_k exp(s)).
//
// Bound on the H100: 4*L^2*d flops per (batch, head) (S = Q K^T and P V)
// against 4 [L, d] tiles (q, k, v in; o out) and 1 fp32 row (lse) of bytes:
// tensor-core operations bound it from L = 256 up. At d = 64 the softmax's
// exp2 of every (query, key) pair takes the special-function units as long
// as the two products take the tensor cores, so the design keeps both busy
// at once across warpgroups.
//
// Design (the FA3 forward on sm_90a):
// - One CTA per (q tile of 128 rows, head, batch), L on blockIdx.x: two
//   consumer warpgroups of 64 q rows each (wgmma's M) and a producer
//   warpgroup whose registers go to the consumers (setmaxnreg). Its one
//   working thread loads the Q tile once by TMA and streams the K and V
//   tiles of BN keys through a ring of STAGES stages, each with a full
//   barrier for K, one for V and an empty barrier the consumers release, so
//   loads run ahead of the products. It alone keeps the wait watchdog.
// - Three tiers by padded head dim DP (FwdConfig): DP <= 80, BN = 64 and two
//   CTAs per SM (104 registers a consumer thread), so four consumer
//   warpgroups share an SM and one's softmax runs while another's products
//   do; 96 <= DP <= 160, BN = 128 and one CTA per SM (O takes up to 80
//   registers a thread; 240 with setmaxnreg); DP > 160, BN = 64, two stages
//   and one CTA per SM: O alone takes DP/2 = 128 registers a thread at 256,
//   beside S's 32 and P's 16, and Q with two K/V stages of 128 keys would
//   need 320 KB of shared memory (192 KB with 64 keys).
// - Tiles are the chunked, swizzled tiles of hopper_common.cuh; TMA's zero
//   fill reads d = 40 as 48.
// - Per key tile and warpgroup: S = Q K^T on SS wgmma (Q and K K-major),
//   64 x BN fp32; the online softmax in registers in the log2 domain
//   (sm_scale*log2e folded in, off-segment pairs at -inf, row max and sum
//   over the 4 threads of a quad, exp2 on the SFU; a row with no live key
//   yet keeps base 0, so nothing is -inf - -inf); O rescaled by alpha; then
//   O += P V on RS wgmma: P packed to bf16 A fragments in accumulator order,
//   V read MN-major (transposed through the descriptor), in column pieces of
//   64/32/16 that cover every DP. FA3's intra-warpgroup overlap
//   and ping-pong schedules were slower here (PERF.md).
// - Key tiles where the segment mask removes every (query, key) pair of the
//   CTA are skipped by producer and consumers alike.
// - Epilogue: O / l in o's dtype and strides; one thread per row writes
//   lse = (m + log2 l) * ln2. No atomics: two launches give the same bits.

#include "flash_common.cuh"
#include "hopper_common.cuh"

struct FwdParams {
  void* o;
  FlashStrides so;
  float* lse;
  int heads, len, head_dim, valid_len;
  float sm_scale;
};

template <int DP>
struct FwdConfig {
  static constexpr int CW = DP % 64 == 0 ? 64 : (DP % 32 == 0 ? 32 : 16);  // chunk width
  static constexpr bool NARROW = DP <= 80, WIDE = DP > 160;
  static constexpr int BM = 128;  // q rows: 2 consumer warpgroups of 64
  static constexpr int BN = NARROW || WIDE ? 64 : 128;  // keys per step
  static constexpr int CTAS = NARROW ? 2 : 1;           // CTAs per SM
  static constexpr int STAGES = NARROW ? 3 : 2;
  static constexpr int THREADS = 384;  // 2 consumer warpgroups, then the producer
  // registers a thread gets at launch, and a consumer thread once the
  // producer warpgroup has given back all but 24 of its own (setmaxnreg)
  static constexpr int LAUNCH_REGS = 65536 / (THREADS * CTAS) / 8 * 8;
  static constexpr int CONSUMER_REGS = NARROW ? 104 : 240;
  static_assert(256 * CONSUMER_REGS + 128 * 24 <= THREADS * LAUNCH_REGS, "register budget");
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;  // one K or V stage
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + (1 + 3 * STAGES) * 8;
  // + 1024 bytes to align the base; an SM's 228 KB hold CTAS of them
  static_assert(CTAS * (SMEM + 1024) <= 232448, "shared memory");
};

template <typename T, int DP>
__global__ void __launch_bounds__(FwdConfig<DP>::THREADS, FwdConfig<DP>::CTAS)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const FwdParams p) {
  using C = FwdConfig<DP>;
  constexpr int CW = C::CW, NC = DP / CW, BM = C::BM, BN = C::BN, S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty = full_v + S;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = p.len, vl = p.valid_len, q0 = qt * BM;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // A key tile is live when some (query, key) pair of it and this q tile
  // shares a segment.
  const bool q_real = q0 < vl, q_pad = q0 + BM > vl;
  auto live = [&](int k0) { return vl == 0 || (q_real && k0 < vl) || (q_pad && k0 + BN > vl); };
  const int nk = L / BN;

  if (threadIdx.x >= 256) {  // producer warpgroup: one thread loads
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load_4d(smem + C::OFF_Q + c * BM * CW * 2, &tm_q, bar_q, c * CW, q0, h, b);
      int it = 0;
      for (int kt = 0; kt < nk; ++kt) {
        if (!live(kt * BN)) continue;
        const int s = it % S;
        mbar_wait<true>(&empty[s], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&full_k[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(smem + C::OFF_K + s * C::KV_BYTES + c * BN * CW * 2, &tm_k, &full_k[s],
                      c * CW, kt * BN, h, b);
        mbar_expect_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(smem + C::OFF_V + s * C::KV_BYTES + c * BN * CW * 2, &tm_v, &full_v[s],
                      c * CW, kt * BN, h, b);
        ++it;
      }
      // the watchdog of the consumers (their waits do not trap): stay until
      // they have released every stage of the ring
      for (int j = it; j < it + S; ++j) mbar_wait<true>(&empty[j % S], ((j / S) & 1) ^ 1);
    }
    return;
  }

  // consumers: warpgroup w owns q rows q0 + 64w .. q0 + 64w + 63
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int qw = q0 + 64 * w;
  const int row_a = qw + 16 * warp + g, row_b = row_a + 8;  // this thread's two rows
  const bool real[2] = {row_a < vl, row_b < vl};
  const bool wg_real = qw + 64 <= vl, wg_pad = qw >= vl;
  const float sl2 = p.sm_scale * FLASH_LOG2E;
  constexpr uint32_t SBO = 8 * CW * 2;  // 8-row group stride of every chunked tile
  const uint32_t s_q = smem_u32(smem + C::OFF_Q) + 64 * w * CW * 2;
  const uint32_t s_k = smem_u32(smem + C::OFF_K), s_v = smem_u32(smem + C::OFF_V);

  // accumulator layout (hopper_common.cuh): register 4j+e holds row
  // 16*warp + g + 8*(e/2) of the warpgroup's 64, column 8j + 2t + e%2
  float o[DP / 2], sacc[BN / 2];
  uint32_t pf[BN / 4];  // bf16 P as wgmma A fragments (k-step kc: pf[4kc..4kc+3])
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  // S = Q K^T for the key tile in stage s (Q and K K-major)
  auto issue_s = [&](int s) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk * 16) / CW, within = (kk * 16) % CW * 2;
      const uint64_t da = gmma_desc(s_q + col * BM * CW * 2 + within, 16, SBO, CW);
      const uint64_t db =
          gmma_desc(s_k + s * C::KV_BYTES + col * BN * CW * 2 + within, 16, SBO, CW);
      Wgmma<BN>::template ss<0, 0>(sacc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V for the key tile in stage s (P from registers, V MN-major)
  auto issue_pv = [&](int s) {
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      Pieces<0, DP>::run([&](auto n0c, auto wc) {
        constexpr int N0 = decltype(n0c)::value, W = decltype(wc)::value;
        const uint32_t off = s * C::KV_BYTES + (N0 / CW) * BN * CW * 2 + kc * 16 * CW * 2;
        Wgmma<W>::template rs<1>(o + N0 / 2, pf + 4 * kc,
                                 gmma_desc(s_v + off, BN * CW * 2, SBO, CW), 1);
      });
    }
    wgmma_commit();
  };
  // S of the key tile at k0 -> P (fp32, in place) in the log2 domain; folds
  // the tile into the running max m and sum l and gives O's rescale alpha
  auto softmax = [&](int k0, float* alpha) {
    float mx[2] = {-INFINITY, -INFINITY};
    if (vl == 0 || (wg_real && k0 + BN <= vl) || (wg_pad && k0 >= vl)) {  // no pair masked
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (seg_masked(vl, real[e >> 1], k0 + 8 * j + 2 * t + (e & 1)))
            sacc[4 * j + e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sacc[4 * j + e]);
        }
      }
    }
    float base[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * sl2);
      // a row with no live key yet keeps o = l = 0: subtract 0, never -inf
      base[r] = mn == -INFINITY ? 0.f : mn;
      alpha[r] = exp2_approx(m[r] - base[r]);
      m[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float x = exp2_approx(fmaf(sacc[i], sl2, -base[r]));
      sacc[i] = x;
      rs[r] += x;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
  };

  mbar_wait(bar_q, 0);
  int it = 0;
  for (int kt = 0; kt < nk; ++kt) {
    if (!live(kt * BN)) continue;
    const int s = it % S;
    const uint32_t ph = (it / S) & 1;
    mbar_wait(&full_k[s], ph);
    issue_s(s);
    wgmma_wait<0>();
    fence_regs<BN / 2>(sacc);
    float alpha[2];
    softmax(kt * BN, alpha);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) pf[i] = pack_bf16(sacc[2 * i], sacc[2 * i + 1]);
    mbar_wait(&full_v[s], ph);
    issue_pv(s);
    wgmma_wait<0>();
    fence_regs<DP / 2>(o);
    fence_regs<BN / 4>(pf);  // A fragments stay put until their wgmmas are done
    mbar_arrive(&empty[s]);
    ++it;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv_a = 1.f / l[0], inv_b = 1.f / l[1];
  T* out = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
  const int d = p.head_dim;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col < d) {
      store2(out + row_a * p.so.l + col, o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      store2(out + row_b * p.so.l + col, o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
  }
  if (t == 0) {
    float* lse = p.lse + ((long long)b * p.heads + h) * L;
    lse[row_a] = (m[0] + log2f(l[0])) * FLASH_LN2;
    lse[row_b] = (m[1] + log2f(l[1])) * FLASH_LN2;
  }
}

template <typename T, int DP>
static int launch_fwd(const FlashArgs& a, cudaStream_t stream) {
  using C = FwdConfig<DP>;
  if (a.len % C::BM != 0 || a.len % C::BN != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const bool ok =
      make_bhld_map(&tq, a.q, a.batch, a.heads, a.len, a.head_dim, a.sq.b, a.sq.h, a.sq.l, C::CW,
                    C::BM) &&
      make_bhld_map(&tk, a.k, a.batch, a.heads, a.len, a.head_dim, a.sk.b, a.sk.h, a.sk.l, C::CW,
                    C::BN) &&
      make_bhld_map(&tv, a.v, a.batch, a.heads, a.len, a.head_dim, a.sv.b, a.sv.h, a.sv.l, C::CW,
                    C::BN);
  if (!ok) return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.o = a.out_a;
  p.so = a.sa;
  p.lse = a.lse;
  p.heads = a.heads;
  p.len = a.len;
  p.head_dim = a.head_dim;
  p.valid_len = a.valid_len;
  p.sm_scale = a.sm_scale;
  const int smem = C::SMEM + 1024;  // + alignment of the base to 1024 bytes
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.len / C::BM, a.heads, a.batch);
  flash_fwd_kernel<T, DP><<<grid, C::THREADS, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

#ifdef FLASH_DP
FLASH_DEFINE_DP(flash_fwd, launch_fwd, FLASH_DP)
#else
FLASH_DISPATCH(flash_fwd)
#endif
