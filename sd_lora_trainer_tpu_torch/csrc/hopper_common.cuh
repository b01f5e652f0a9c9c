// Hopper (sm_90a) building blocks of the flash-attention kernels: TMA tensor
// maps and loads, mbarriers, wgmma descriptors and the wgmma instructions the
// kernels issue.
//
// Shared-memory tiles. A [ROWS, DP] bf16 tile is kept as DP / CW column chunks
// of [ROWS][CW] (chunk c at byte c * ROWS * CW * 2), each row CW * 2 bytes and
// swizzled by TMA with the swizzle of that width: CW = 64 -> 128B, 32 -> 64B,
// 16 -> 32B. One TMA box of (CW columns, ROWS rows) fills one chunk, and
// columns past the tensor's head dim arrive as zeros (TMA's out-of-bounds
// fill), so a head dim of 40 reads as 48 with no copy in device memory. Tiles
// start on 1024-byte boundaries, so the swizzle phase of row r is r % 8.
//
// wgmma reads such a chunked tile in two ways (CUTLASS's canonical GMMA
// layouts, cute/atom/mma_traits_sm90_gmma.hpp):
// - K-major (the reduction runs along the row): 8-row groups SBO = 8*CW*2
//   bytes apart; a k16 step is +32 bytes inside a chunk, or the next chunk.
// - MN-major (the reduction runs down the rows; the operand is transposed
//   through the descriptor): MN runs along the row in atoms of CW elements,
//   LBO = ROWS*CW*2 bytes between atoms (chunks); K runs down the rows, 8-row
//   groups SBO = 8*CW*2 bytes apart, a k16 step is +16 rows.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// ---------------------------------------------------------------------------
// Host: tensor maps through the driver entry point (no -lcuda)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

static CUtensorMapSwizzle swizzle_for_width(int cw) {
  return cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : (cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
}

// A bf16 [B, H, L, d] view (element strides sb, sh, sl; last dim contiguous)
// read in boxes of (cw columns, rows rows) of one (b, h). Coordinates are
// (column, row, head, batch); columns at or past d read as zero.
static bool make_bhld_map(CUtensorMap* map, const void* base, int batch, int heads, int len,
                          int d, long long sb, long long sh, long long sl, int cw, int rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)len, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for_width(cw),
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Device: shared addresses, mbarriers, TMA, bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of the given parity has completed. With WATCHDOG, a
// wait that lasts seconds is a fault of the kernel: it traps (a launch error)
// instead of hanging the card. Only a producer warp keeps the watchdog: a
// trap reachable from the consumers' code makes ptxas hold them to the
// launch's register budget (168 a thread at 384 threads) instead of
// setmaxnreg's.
template <bool WATCHDOG = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, spins = 0;
  do {
    if constexpr (WATCHDOG) {
      if (++spins == (1u << 28)) __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Contiguous bytes (a multiple of 16, 16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Contiguous bytes (a multiple of 16, 16-byte aligned) from shared memory to
// global memory by the copy engine: stored, or added into fp32 values there
// (each value one add, rounded as an fp32 add); in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// Wait until this thread's bulk stores and adds have completed, their writes
// to global memory included.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group 0;\n" ::
          : "memory");
}

// Order this thread's earlier accesses of global memory in the generic proxy
// (an acquire) before its later ones in the async proxy (a bulk add).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Make this thread's generic-proxy shared-memory writes visible to wgmma and
// the copy engine (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over `threads` threads (a multiple of 32) on hardware barrier `id`.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier `id` without waiting for it (the other side waits
// with named_barrier); the caller's earlier memory accesses are performed
// relative to the waiting threads once the barrier completes.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Device: counters in global memory shared by the CTAs of a grid
// ---------------------------------------------------------------------------

// Spin until *counter == value, with acquire semantics at GPU scope. A wait
// that lasts seconds traps (see mbar_wait): call it from a producer warp only.
__device__ __forceinline__ void wait_counter(const int* counter, int value) {
  uint32_t spins = 0;
  int now;
  do {
    if (++spins == (1u << 26)) __trap();
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(now) : "l"(counter) : "memory");
  } while (now != value);
}

// *counter += value, released at GPU scope: a fence, then a relaxed add, as
// CUTLASS's GenericBarrier does, so that the fence also releases the writes
// of the threads the caller synchronized with through a barrier before it.
// A thread that reads the new value with wait_counter sees them all.
__device__ __forceinline__ void release_counter(int* counter, int value) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "red.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(counter),
      "r"(value)
      : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// 2^x on the special-function unit (one instruction; exp2f adds range
// handling the softmax does not need: its arguments are <= ~0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of (row, 16-byte unit) XOR-swizzled as TMA does for rows of
// `cw` bf16 elements, relative to a 1024-byte aligned tile.
__device__ __forceinline__ uint32_t swizzle_offset(uint32_t off, int cw) {
  const uint32_t mask = cw == 64 ? 7u : (cw == 32 ? 3u : 1u);
  return off ^ (((off >> 7) & mask) << 4);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor; lbo and sbo in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int cw) {
  const uint64_t layout = cw == 64 ? 1 : (cw == 32 ? 2 : 3);  // 128B, 64B, 32B swizzle
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= layout << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers across the
// asynchronous wgmma and its wait.
template <int R>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D8(o)                                                                        \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),       \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, fp32 accumulate. D layout:
// warp w of the warpgroup holds rows 16w..16w+15; register 4j+e of lane
// (g = lane/4, t = lane%4) holds row 16w + g + 8*(e/2), column 8j + 2t + e%2
// (the m16n8 accumulator tile of PTX's warp-level mma, one per 8 columns).
// SS: A and B from shared memory. TA, TB: 1 = MN-major (transposed) operand.
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
  // RS: A from registers, per warp the m16n8k16 A fragment of its 16 rows:
  // a[0..3] = (row g, cols 2t..2t+1), (row g+8, same), (row g, cols
  // 2t+8..2t+9), (row g+8, same); two 8-column accumulator tiles 2k, 2k+1 of
  // the D layout, packed pairwise, are the A fragment of k-step k.
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : WG_D8(0), WG_D8(8)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : WG_D8(0), WG_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
  }
};

template <>
struct Wgmma<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : WG_D8(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : WG_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
  }
};

#undef WG_D8

// Calls f(integral_constant<N0>, integral_constant<W>) for the column pieces
// [N0, N0 + W) that cover [N0, N0 + REM): widths 64, 32 or 16, so each piece
// is one wgmma instruction and starts on a chunk boundary.
template <int N0, int REM>
struct Pieces {
  static constexpr int W = REM >= 64 ? 64 : (REM >= 32 ? 32 : 16);
  template <typename F>
  static __device__ __forceinline__ void run(F&& f) {
    f(std::integral_constant<int, N0>{}, std::integral_constant<int, W>{});
    Pieces<N0 + W, REM - W>::run(f);
  }
};

template <int N0>
struct Pieces<N0, 0> {
  template <typename F>
  static __device__ __forceinline__ void run(F&&) {}
};
