// Fused LayerNorm and GroupNorm (with an optional SiLU), forward and
// backward, for the port's norm layer (models/layers.py `layer_norm` and
// `group_norm`, through ops/norms.py).
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA, which
// fuses each into its neighbours. The port ran them as chains of stock ops
// in fp32 (a cast up, the statistics, the subtract, the scale, the affine,
// a cast down, and SiLU as one more pass), some eight passes over an fp32
// copy of the activation each way, 19-27% of a train step on the H100.
//
// Bound by bytes: a norm does a few operations an element, far below the
// card's ~295 operations a byte. So each kernel reads the activation in its
// own dtype (16 bytes a thread at a time), keeps the statistics and the
// affine in fp32 registers, and writes its output once, rounded once:
//   LayerNorm forward: one read and one write, 4 B an element in bf16 (and
//     8 B a row of fp32 mean and rstd, kept for the backward);
//   LayerNorm backward: x and dy read once, dx written once, 6 B;
//   GroupNorm forward: x read twice (statistics, then the normalisation,
//     the second mostly from L2) and the output written once, 6 B;
//   GroupNorm backward: x and dy read twice, dx written once, 10 B.
// LayerNorm keeps a row in a warp's registers, so the mean and the variance
// are taken in two passes over registers. A GroupNorm group spans a whole
// sample (up to a million elements a group in the VAE), and B x G is only
// 128 at the UNets' batch of 4 on 132 SMs, so the samples are cut into tiles
// of rows, a block a tile: each block reduces its tile to per-group partial
// (mean, M2), taken from sums shifted by the tile's first row, and a second
// kernel merges a group's partials with Chan's combination in a fixed order,
// which keeps the variance from the cancellation of an fp32 sum and sum of
// squares over a million elements. The backward's reductions (the per-group
// sums of g = dy·γ and g·x̂, and dγ and dβ when they are asked for) go the
// same way: per-tile partials, summed in a fixed order by a second kernel.
// No float atomics: every launch on the same inputs gives the same bits.
//
// Each entry point launches on the caller's stream and returns the first
// launch error (0 when none). The last kernel of a forward or a backward
// adds one to `counter` when it is given (one thread of block 0), so that a
// launch recorded into a CUDA graph is counted by each replay with no graph
// node of its own (ops/norms.py).
//
// The file compiles as two units (ops/kernels.py): NORM_UNIT 0 holds the
// LayerNorm kernels, 1 the GroupNorm kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirror of `NormArgs` in ops/kernels.py (field order matters).
struct NormArgs {
  const void* x;        // LayerNorm [rows, C]; GroupNorm [batch, rows, C]
  const void* dy;       // backward: the output's gradient, x's layout
  const void* weight;   // gamma [C]
  const void* bias;     // beta [C]
  void* out;            // forward: the output; backward: dx
  float* mean;          // LayerNorm [rows]; GroupNorm [batch, groups]
  float* rstd;          // 1 / sqrt(var + eps), mean's layout
  float* work;          // fp32 scratch: the partials of the reductions
  void* dweight;        // backward: d gamma [C], or null
  void* dbias;          // backward: d beta [C], or null
  unsigned long long* counter;  // launches, counted on the device; or null
  long long rows;       // LayerNorm: rows; GroupNorm: rows of a sample (H x W)
  int batch;            // GroupNorm: samples
  int channels;         // C
  int groups;           // GroupNorm: G, which divides C
  int vec;              // elements a thread loads at once: 16 bytes' worth, or 1
  int nv;               // LayerNorm: 16-byte vectors a lane holds of a row
  int blocks;           // LayerNorm: blocks of 8 warps, a row a warp at a time
  int cols;             // GroupNorm: threads across a row, C / vec
  int rpi;              // GroupNorm: rows a block reads at once
  int tile;             // GroupNorm: rows of a tile, a multiple of rpi
  int tiles;            // GroupNorm: tiles of a sample
  float eps;
  int dtype;            // x, dy, out: 0 bf16, 1 fp32
  int wdtype;           // weight, bias, dweight, dbias: 0 bf16, 1 fp32
  int silu;             // GroupNorm: out = silu(norm(x))
};

namespace {

constexpr int kLayerThreads = 256;  // 8 warps
constexpr int kGroupMaxThreads = 512;
// a GroupNorm thread loads this many of its rows before it uses any, so that
// as many 16-byte loads are in flight
constexpr int kRowsAtOnce = 4;
// a block a (sample, group) merges the tiles' partials
constexpr int kMergeThreads = 128;
constexpr int kMergeWarps = kMergeThreads / 32;

template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

// gamma, beta and their gradients in either dtype
__device__ __forceinline__ float param(const void* p, int i, int wdtype) {
  return wdtype == 0 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                     : static_cast<const float*>(p)[i];
}

// V of gamma's or beta's values from c0 on (16-byte aligned where V fills 16 bytes)
template <int V>
__device__ __forceinline__ void load_param(const void* p, int c0, int wdtype, float* v) {
  if (wdtype == 0)
    load<V>(static_cast<const __nv_bfloat16*>(p) + c0, v);
  else
    load<V>(static_cast<const float*>(p) + c0, v);
}

__device__ __forceinline__ void put_param(void* p, int i, float v, int wdtype) {
  if (wdtype == 0)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// a butterfly: every lane ends with the same sum (each pair adds the same
// two values, in either order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ void count_launch(const NormArgs& a) {
  if (a.counter != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(a.counter, 1ULL);
}

__device__ __forceinline__ float sigmoid(float y) { return 1.f / (1.f + __expf(-y)); }

// d beta and d gamma: each channel's partials, one pair (d gamma, d beta)
// a block of the backward's first pass, summed in the blocks' order
__global__ void norm_affine_grad(const NormArgs a, int parts) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int C = a.channels;
  if (c >= C) return;
  const float2* w = reinterpret_cast<const float2*>(a.work);
  float dw = 0.f, db = 0.f;
#pragma unroll 8
  for (int p = 0; p < parts; ++p) {
    const float2 v = w[(long long)p * C + c];
    dw += v.x;
    db += v.y;
  }
  if (a.dweight != nullptr) put_param(a.dweight, c, dw, a.wdtype);
  if (a.dbias != nullptr) put_param(a.dbias, c, db, a.wdtype);
}

int launch_affine_grad(const NormArgs* a, int parts, cudaStream_t s) {
  if (a->dweight == nullptr && a->dbias == nullptr) return 0;
  norm_affine_grad<<<(a->channels + 127) / 128, 128, 0, s>>>(*a, parts);
  return (int)cudaGetLastError();
}

}  // namespace

#if !defined(NORM_UNIT) || NORM_UNIT == 0

// ---------------------------------------------------------------------------
// LayerNorm over the last axis of [rows, C]: a warp a row, the row in
// registers (lane l holds the 16-byte vectors l, l + 32, ..., NV of them).
// ---------------------------------------------------------------------------

template <typename T, int NV>
__global__ void __launch_bounds__(kLayerThreads) layer_norm_fwd(const NormArgs a) {
  constexpr int V = kVec<T>;
  const int lane = threadIdx.x & 31;
  const int C = a.channels;
  const float inv_c = 1.f / C;
  const long long warps = (long long)gridDim.x * (kLayerThreads / 32);
  for (long long row = (long long)blockIdx.x * (kLayerThreads / 32) + (threadIdx.x >> 5);
       row < a.rows; row += warps) {
    const T* xr = static_cast<const T*>(a.x) + row * C;
    float v[NV][V];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (lane + 32 * k) * V;
      if (c0 < C) {
        load<V>(xr + c0, v[k]);
#pragma unroll
        for (int i = 0; i < V; ++i) s += v[k][i];
      }
    }
    const float mean = warp_sum(s) * inv_c;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((lane + 32 * k) * V < C) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = v[k][i] - mean;
          q += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_c + a.eps);
    T* yr = static_cast<T*>(a.out) + row * C;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (lane + 32 * k) * V;
      if (c0 < C) {
        float w[V], b[V];
        load_param<V>(a.weight, c0, a.wdtype, w);
        load_param<V>(a.bias, c0, a.wdtype, b);
#pragma unroll
        for (int i = 0; i < V; ++i) w[i] = fmaf((v[k][i] - mean) * rstd, w[i], b[i]);
        store<V>(yr + c0, w);
      }
    }
    if (lane == 0) {
      a.mean[row] = mean;
      a.rstd[row] = rstd;
    }
  }
  count_launch(a);
}

// dx = rstd (g - mean(g) - x̂ mean(g x̂)), g = dy γ. With AFFINE, each block
// also sums dy x̂ and dy over its rows per channel (its warps in order) into
// work[block][C] for norm_affine_grad.
template <typename T, int NV, bool AFFINE>
__global__ void __launch_bounds__(kLayerThreads) layer_norm_bwd(const NormArgs a) {
  constexpr int V = kVec<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = a.channels;
  const float inv_c = 1.f / C;
  const long long warps = (long long)gridDim.x * (kLayerThreads / 32);
  float acc_w[AFFINE ? NV : 1][V], acc_b[AFFINE ? NV : 1][V];
  if constexpr (AFFINE) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) acc_w[k][i] = acc_b[k][i] = 0.f;
  }
  for (long long row = (long long)blockIdx.x * (kLayerThreads / 32) + warp; row < a.rows;
       row += warps) {
    const T* xr = static_cast<const T*>(a.x) + row * C;
    const T* dr = static_cast<const T*>(a.dy) + row * C;
    const float mean = a.mean[row], rstd = a.rstd[row];
    float xh[NV][V], d[NV][V];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (lane + 32 * k) * V;
      if (c0 < C) {
        float w[V];
        load<V>(xr + c0, xh[k]);
        load<V>(dr + c0, d[k]);
        load_param<V>(a.weight, c0, a.wdtype, w);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          xh[k][i] = (xh[k][i] - mean) * rstd;
          const float g = d[k][i] * w[i];
          s1 += g;
          s2 += g * xh[k][i];
          if constexpr (AFFINE) {
            acc_w[k][i] += d[k][i] * xh[k][i];
            acc_b[k][i] += d[k][i];
          }
        }
      }
    }
    s1 = warp_sum(s1) * inv_c;
    s2 = warp_sum(s2) * inv_c;
    T* dxr = static_cast<T*>(a.out) + row * C;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (lane + 32 * k) * V;
      if (c0 < C) {
        float w[V];
        load_param<V>(a.weight, c0, a.wdtype, w);
#pragma unroll
        for (int i = 0; i < V; ++i) w[i] = rstd * (d[k][i] * w[i] - s1 - xh[k][i] * s2);
        store<V>(dxr + c0, w);
      }
    }
  }
  if constexpr (AFFINE) {
    extern __shared__ float red[];  // [C] pairs (dγ, dβ)
    for (int w = 0; w < kLayerThreads / 32; ++w) {
      if (warp == w) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int c0 = (lane + 32 * k) * V;
          if (c0 < C) {
#pragma unroll
            for (int i = 0; i < V; ++i) {
              const int c = c0 + i;
              red[2 * c] = (w == 0 ? 0.f : red[2 * c]) + acc_w[k][i];
              red[2 * c + 1] = (w == 0 ? 0.f : red[2 * c + 1]) + acc_b[k][i];
            }
          }
        }
      }
      __syncthreads();
    }
    float* part = a.work + (long long)blockIdx.x * 2 * C;
    for (int i = threadIdx.x; i < 2 * C; i += kLayerThreads) part[i] = red[i];
  }
  count_launch(a);
}

#define LN_VECTORS(X, T) X(T, 1) X(T, 2) X(T, 3) X(T, 4) X(T, 5) X(T, 6) X(T, 8) X(T, 10)

template <typename T>
int layer_forward(const NormArgs* a, cudaStream_t s) {
#define LN_FWD(T, N) \
  case N:            \
    layer_norm_fwd<T, N><<<a->blocks, kLayerThreads, 0, s>>>(*a); break;
  switch (a->nv) {
    LN_VECTORS(LN_FWD, T)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LN_FWD
  return (int)cudaGetLastError();
}

template <typename T>
int layer_backward(const NormArgs* a, cudaStream_t s) {
  const bool affine = a->dweight != nullptr || a->dbias != nullptr;
  const size_t smem = affine ? 2 * sizeof(float) * a->channels : 0;
#define LN_BWD(T, N)                                                         \
  case N:                                                                    \
    if (affine) {                                                            \
      if (smem > 48 * 1024)                                                  \
        cudaFuncSetAttribute(layer_norm_bwd<T, N, true>,                     \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                             (int)smem);                                     \
      layer_norm_bwd<T, N, true><<<a->blocks, kLayerThreads, smem, s>>>(*a); \
    } else {                                                                 \
      layer_norm_bwd<T, N, false><<<a->blocks, kLayerThreads, 0, s>>>(*a);   \
    }                                                                        \
    break;
  switch (a->nv) {
    LN_VECTORS(LN_BWD, T)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LN_BWD
  const int rc = (int)cudaGetLastError();
  return rc != 0 ? rc : launch_affine_grad(a, a->blocks, s);
}

static bool layer_args_ok(const NormArgs* a) {
  const int vec = a->dtype == 0 ? kVec<__nv_bfloat16> : kVec<float>;
  return a->dtype >= 0 && a->dtype <= 1 && a->wdtype >= 0 && a->wdtype <= 1 &&
         a->vec == vec && a->channels > 0 && a->channels % vec == 0 &&
         a->channels <= 32 * vec * a->nv && a->blocks > 0 && a->rows >= 0;
}

extern "C" int norm_layer_forward(const NormArgs* a, void* stream) {
  if (!layer_args_ok(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? layer_forward<__nv_bfloat16>(a, s) : layer_forward<float>(a, s);
}

extern "C" int norm_layer_backward(const NormArgs* a, void* stream) {
  if (!layer_args_ok(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? layer_backward<__nv_bfloat16>(a, s) : layer_backward<float>(a, s);
}

#endif  // NORM_UNIT 0

#if !defined(NORM_UNIT) || NORM_UNIT == 1

// ---------------------------------------------------------------------------
// GroupNorm over [batch, rows, C], G groups of C / G adjacent channels. Block
// (b, t) takes rows [t tile, (t + 1) tile) of sample b: thread (r, col) reads
// the 16-byte vector `col` of rows r, r + rpi, ... Channel statistics are
// summed down the rows, then over the block's rpi threads of a column in
// their order (shared memory), then over a group's channels.
// ---------------------------------------------------------------------------

struct Tile {
  int col, r0;
  long long lo, hi;  // the tile's rows in the sample
  long long base;    // the sample's first element
};

__device__ __forceinline__ Tile tile_of(const NormArgs& a) {
  Tile t;
  t.col = threadIdx.x % a.cols;
  t.r0 = threadIdx.x / a.cols;
  t.lo = (long long)blockIdx.y * a.tile;
  t.hi = min(a.rows, t.lo + a.tile);
  t.base = (long long)blockIdx.x * a.rows * a.channels;
  return t;
}

// Sum each thread's V pairs over the block's rows, thread rows in order:
// red[c] holds channel c's pair after the call (shared, 2 C floats a row of
// threads); the rows of threads other than the first are scratch.
template <int V>
__device__ __forceinline__ void sum_down_rows(const NormArgs& a, const Tile& t, const float* p1,
                                             const float* p2, float* red) {
  const int C = a.channels;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t.col * V + i;
    red[2 * (t.r0 * C + c)] = p1[i];
    red[2 * (t.r0 * C + c) + 1] = p2[i];
  }
  __syncthreads();
  if (t.r0 == 0) {
    for (int r = 1; r < a.rpi; ++r) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = t.col * V + i;
        red[2 * c] += red[2 * (r * C + c)];
        red[2 * c + 1] += red[2 * (r * C + c) + 1];
      }
    }
  }
  __syncthreads();
}

// n, mean, M2 of a set of values, merged with another's (Chan et al.)
__device__ __forceinline__ void chan_merge(float& n, float& m, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb, d = mb - m, f = nb / nn;
  m += d * f;
  m2 += m2b + d * d * n * f;
  n = nn;
}

// Pass 1 of the forward: each group's (mean, M2) over the tile, into
// work[b][t][g]. A channel's sums are shifted by its value in the tile's
// first row, a sample of its own values, so that the sum of squares does
// not cancel; the channels of a group merge exactly (equal counts).
template <typename T, int V>
__global__ void __launch_bounds__(kGroupMaxThreads) group_norm_stats(const NormArgs a) {
  extern __shared__ float red[];
  const Tile t = tile_of(a);
  const int C = a.channels, G = a.groups, cg = C / G;
  const T* x = static_cast<const T*>(a.x) + t.base + t.col * V;
  float k[V], s1[V], s2[V];
  load<V>(x + t.lo * C, k);
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  for (long long r = t.lo + t.r0; r < t.hi; r += kRowsAtOnce * a.rpi) {
    float v[kRowsAtOnce][V];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u)
      if (r + u * a.rpi < t.hi) load<V>(x + (r + u * a.rpi) * C, v[u]);
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (r + u * a.rpi < t.hi) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = v[u][i] - k[i];
          s1[i] += d;
          s2[i] = fmaf(d, d, s2[i]);
        }
      }
    }
  }
  sum_down_rows<V>(a, t, s1, s2, red);
  const float n = (float)(t.hi - t.lo);
  if (t.r0 == 0) {  // each channel's mean and M2 over the tile, in place
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t.col * V + i;
      const float a1 = red[2 * c], a2 = red[2 * c + 1];
      red[2 * c] = k[i] + a1 / n;
      red[2 * c + 1] = fmaxf(a2 - a1 * a1 / n, 0.f);
    }
  }
  __syncthreads();
  float2* out = reinterpret_cast<float2*>(a.work) +
                ((long long)blockIdx.x * a.tiles + blockIdx.y) * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float* ch = red + 2 * g * cg;
    float m = 0.f;
    for (int j = 0; j < cg; ++j) m += ch[2 * j];
    m /= cg;
    float m2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      const float d = ch[2 * j] - m;
      m2 += ch[2 * j + 1] + n * d * d;
    }
    out[g] = make_float2(m, m2);
  }
}

// Pass 2 of the forward: a block a (b, g) merges the group's tiles (thread i
// the tiles i, i + 128, ..., then a tree to each warp's lane 0, then the
// warps in order) into mean and rstd.
__global__ void __launch_bounds__(kMergeThreads) group_norm_merge(const NormArgs a) {
  __shared__ float red[3 * kMergeWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.groups, cg = a.channels / G, bg = blockIdx.x;
  const float2* part =
      reinterpret_cast<const float2*>(a.work) + (long long)(bg / G) * a.tiles * G + bg % G;
  float n = 0.f, m = 0.f, m2 = 0.f;
  for (int t = threadIdx.x; t < a.tiles; t += kMergeThreads) {
    const long long lo = (long long)t * a.tile;
    const float nt = (float)((min(a.rows, lo + a.tile) - lo) * cg);
    const float2 p = part[(long long)t * G];
    chan_merge(n, m, m2, nt, p.x, p.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, m, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    if (lane + off < 32) chan_merge(n, m, m2, nb, mb, m2b);
  }
  if (lane == 0) {
    red[3 * warp] = n;
    red[3 * warp + 1] = m;
    red[3 * warp + 2] = m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kMergeWarps; ++w)
      chan_merge(n, m, m2, red[3 * w], red[3 * w + 1], red[3 * w + 2]);
    a.mean[bg] = m;
    a.rstd[bg] = rsqrtf(m2 / n + a.eps);
  }
}

// each of a thread's V channels: its group's mean and rstd, gamma and beta
template <int V>
__device__ __forceinline__ void channel_params(const NormArgs& a, const Tile& t, float* mu,
                                               float* rs, float* w, float* be) {
  const int cg = a.channels / a.groups;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t.col * V + i;
    const int bg = blockIdx.x * a.groups + c / cg;
    mu[i] = a.mean[bg];
    rs[i] = a.rstd[bg];
    w[i] = param(a.weight, c, a.wdtype);
    be[i] = param(a.bias, c, a.wdtype);
  }
}

// Pass 3 of the forward: y = (x - mean) rstd γ + β, SiLU'd when SILU, in
// fp32, rounded once.
template <typename T, int V, bool SILU>
__global__ void __launch_bounds__(kGroupMaxThreads) group_norm_fwd(const NormArgs a) {
  const Tile t = tile_of(a);
  const int C = a.channels;
  float mu[V], sc[V], w[V], be[V];
  channel_params<V>(a, t, mu, sc, w, be);
#pragma unroll
  for (int i = 0; i < V; ++i) sc[i] *= w[i];
  const T* x = static_cast<const T*>(a.x) + t.base + t.col * V;
  T* y = static_cast<T*>(a.out) + t.base + t.col * V;
  for (long long r = t.lo + t.r0; r < t.hi; r += kRowsAtOnce * a.rpi) {
    float v[kRowsAtOnce][V];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u)
      if (r + u * a.rpi < t.hi) load<V>(x + (r + u * a.rpi) * C, v[u]);
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (r + u * a.rpi < t.hi) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float o = fmaf(v[u][i] - mu[i], sc[i], be[i]);
          v[u][i] = SILU ? o * sigmoid(o) : o;
        }
        store<V>(y + (r + u * a.rpi) * C, v[u]);
      }
    }
  }
  count_launch(a);
}

// the gradient at the norm's output: dy, or through the SiLU (recomputed
// from x̂) when SILU
template <bool SILU>
__device__ __forceinline__ float grad_at_norm(float dy, float xh, float w, float be) {
  if constexpr (SILU) {
    const float y = fmaf(xh, w, be), s = sigmoid(y);
    return dy * s * fmaf(y, 1.f - s, 1.f);
  } else {
    return dy;
  }
}

// Pass 1 of the backward: each channel's sums of dy' x̂ and dy' over the
// tile (dy' the gradient at the norm's output), into work[b][t][c].
template <typename T, int V, bool SILU>
__global__ void __launch_bounds__(kGroupMaxThreads) group_norm_bwd_sums(const NormArgs a) {
  extern __shared__ float red[];
  const Tile t = tile_of(a);
  const int C = a.channels;
  float mu[V], rs[V], w[V], be[V], sw[V], sb[V];
  channel_params<V>(a, t, mu, rs, w, be);
#pragma unroll
  for (int i = 0; i < V; ++i) sw[i] = sb[i] = 0.f;
  const T* x = static_cast<const T*>(a.x) + t.base + t.col * V;
  const T* dy = static_cast<const T*>(a.dy) + t.base + t.col * V;
  for (long long r = t.lo + t.r0; r < t.hi; r += kRowsAtOnce * a.rpi) {
    float v[kRowsAtOnce][V], d[kRowsAtOnce][V];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (r + u * a.rpi < t.hi) {
        load<V>(x + (r + u * a.rpi) * C, v[u]);
        load<V>(dy + (r + u * a.rpi) * C, d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (r + u * a.rpi < t.hi) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (v[u][i] - mu[i]) * rs[i];
          const float g = grad_at_norm<SILU>(d[u][i], xh, w[i], be[i]);
          sw[i] = fmaf(g, xh, sw[i]);
          sb[i] += g;
        }
      }
    }
  }
  sum_down_rows<V>(a, t, sw, sb, red);
  if (t.r0 == 0) {
    float2* out = reinterpret_cast<float2*>(a.work) +
                  ((long long)blockIdx.x * a.tiles + blockIdx.y) * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t.col * V + i;
      out[c] = make_float2(red[2 * c], red[2 * c + 1]);
    }
  }
}

// Pass 2 of the backward: a block a (b, g) sums γ_c times the group's
// channel sums over its tiles and channels (thread-strided, then a tree to
// each warp's lane 0, then the warps in order) into the means of g = dy' γ
// and of g x̂ over the group, kept after the partials.
__global__ void __launch_bounds__(kMergeThreads) group_norm_bwd_merge(const NormArgs a) {
  __shared__ float red[2 * kMergeWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = a.channels, G = a.groups, cg = C / G, bg = blockIdx.x, g = bg % G;
  const float2* part = reinterpret_cast<const float2*>(a.work) + (long long)(bg / G) * a.tiles * C;
  float sg = 0.f, sgx = 0.f;
#pragma unroll 4
  for (int j = threadIdx.x; j < a.tiles * cg; j += kMergeThreads) {
    const int c = g * cg + j % cg;
    const float2 p = part[(long long)(j / cg) * C + c];
    const float wc = param(a.weight, c, a.wdtype);
    sgx = fmaf(wc, p.x, sgx);
    sg = fmaf(wc, p.y, sg);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sg += __shfl_down_sync(0xffffffffu, sg, off);
    sgx += __shfl_down_sync(0xffffffffu, sgx, off);
  }
  if (lane == 0) {
    red[2 * warp] = sg;
    red[2 * warp + 1] = sgx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kMergeWarps; ++w) {
      sg += red[2 * w];
      sgx += red[2 * w + 1];
    }
    const float inv_n = 1.f / ((float)a.rows * cg);
    float2* coef = reinterpret_cast<float2*>(a.work) + (long long)a.batch * a.tiles * C;
    coef[bg] = make_float2(sg * inv_n, sgx * inv_n);
  }
}

// Pass 3 of the backward: dx = rstd (dy' γ - mean(g) - x̂ mean(g x̂)).
template <typename T, int V, bool SILU>
__global__ void __launch_bounds__(kGroupMaxThreads) group_norm_bwd(const NormArgs a) {
  const Tile t = tile_of(a);
  const int C = a.channels, cg = C / a.groups;
  float mu[V], rs[V], w[V], be[V], c1[V], c2[V];
  channel_params<V>(a, t, mu, rs, w, be);
  const float2* coef = reinterpret_cast<const float2*>(a.work) + (long long)a.batch * a.tiles * C;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float2 k = coef[blockIdx.x * a.groups + (t.col * V + i) / cg];
    c1[i] = k.x;
    c2[i] = k.y;
  }
  const T* x = static_cast<const T*>(a.x) + t.base + t.col * V;
  const T* dy = static_cast<const T*>(a.dy) + t.base + t.col * V;
  T* dx = static_cast<T*>(a.out) + t.base + t.col * V;
  for (long long r = t.lo + t.r0; r < t.hi; r += kRowsAtOnce * a.rpi) {
    float v[kRowsAtOnce][V], d[kRowsAtOnce][V];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (r + u * a.rpi < t.hi) {
        load<V>(x + (r + u * a.rpi) * C, v[u]);
        load<V>(dy + (r + u * a.rpi) * C, d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (r + u * a.rpi < t.hi) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (v[u][i] - mu[i]) * rs[i];
          const float g = grad_at_norm<SILU>(d[u][i], xh, w[i], be[i]) * w[i];
          v[u][i] = rs[i] * (g - c1[i] - xh * c2[i]);
        }
        store<V>(dx + (r + u * a.rpi) * C, v[u]);
      }
    }
  }
  count_launch(a);
}

static bool group_args_ok(const NormArgs* a) {
  const int vec = a->dtype == 0 ? kVec<__nv_bfloat16> : kVec<float>;
  return a->dtype >= 0 && a->dtype <= 1 && a->wdtype >= 0 && a->wdtype <= 1 &&
         (a->vec == vec || a->vec == 1) && a->channels > 0 && a->groups > 0 &&
         a->channels % a->groups == 0 && a->cols * a->vec == a->channels && a->rpi > 0 &&
         a->cols * a->rpi <= kGroupMaxThreads && a->tile > 0 && a->tile % a->rpi == 0 &&
         a->tiles > 0 && (long long)a->tiles * a->tile >= a->rows &&
         (long long)(a->tiles - 1) * a->tile < a->rows && a->batch > 0 && a->tiles <= 65535;
}

static size_t group_smem(const NormArgs* a) {
  return 2 * sizeof(float) * (size_t)a->rpi * a->channels;
}

template <typename K>
static void allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}


template <typename T, int V>
int group_forward(const NormArgs* a, cudaStream_t s) {
  const dim3 grid(a->batch, a->tiles), block(a->cols * a->rpi);
  const size_t smem = group_smem(a);
  allow_smem(group_norm_stats<T, V>, smem);
  group_norm_stats<T, V><<<grid, block, smem, s>>>(*a);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  group_norm_merge<<<a->batch * a->groups, kMergeThreads, 0, s>>>(*a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if (a->silu)
    group_norm_fwd<T, V, true><<<grid, block, 0, s>>>(*a);
  else
    group_norm_fwd<T, V, false><<<grid, block, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int group_backward(const NormArgs* a, cudaStream_t s) {
  const dim3 grid(a->batch, a->tiles), block(a->cols * a->rpi);
  const size_t smem = group_smem(a);
  if (a->silu) {
    allow_smem(group_norm_bwd_sums<T, V, true>, smem);
    group_norm_bwd_sums<T, V, true><<<grid, block, smem, s>>>(*a);
  } else {
    allow_smem(group_norm_bwd_sums<T, V, false>, smem);
    group_norm_bwd_sums<T, V, false><<<grid, block, smem, s>>>(*a);
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  group_norm_bwd_merge<<<a->batch * a->groups, kMergeThreads, 0, s>>>(*a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if (a->silu)
    group_norm_bwd<T, V, true><<<grid, block, 0, s>>>(*a);
  else
    group_norm_bwd<T, V, false><<<grid, block, 0, s>>>(*a);
  rc = (int)cudaGetLastError();
  return rc != 0 ? rc : launch_affine_grad(a, a->batch * a->tiles, s);
}

extern "C" int norm_group_forward(const NormArgs* a, void* stream) {
  if (!group_args_ok(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0)
    return a->vec == 1 ? group_forward<__nv_bfloat16, 1>(a, s)
                       : group_forward<__nv_bfloat16, kVec<__nv_bfloat16>>(a, s);
  return a->vec == 1 ? group_forward<float, 1>(a, s) : group_forward<float, kVec<float>>(a, s);
}

extern "C" int norm_group_backward(const NormArgs* a, void* stream) {
  if (!group_args_ok(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0)
    return a->vec == 1 ? group_backward<__nv_bfloat16, 1>(a, s)
                       : group_backward<__nv_bfloat16, kVec<__nv_bfloat16>>(a, s);
  return a->vec == 1 ? group_backward<float, 1>(a, s) : group_backward<float, kVec<float>>(a, s);
}

#endif  // NORM_UNIT 1
