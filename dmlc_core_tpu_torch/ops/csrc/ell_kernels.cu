// ELL gather/scatter kernels for the sparse learners, for Hopper (sm_90a).
//
// Built by ops/_build.py into a shared library with a plain C interface
// (loaded with ctypes). Every entry point launches on the stream it is
// given, allocates nothing (the Python wrapper allocates outputs, zeroes
// the dense gradients and checks device, dtype, shape and contiguity),
// and returns cudaGetLastError() so a refused launch is reported.
//
// Index semantics follow jnp.take's default mode, which the JAX models
// use: an index in [0, D) reads row idx, an index in [-D, -1] wraps to
// idx + D, anything else reads NaN in the forward pass and is dropped by
// the gradient's scatter. f16 values are upcast to f32 before the
// multiply (jnp promotes f16 * f32 to f32).
//
// The four kernels and the JAX sites they replace (no Pallas kernel
// exists there; these are the regions XLA fuses):
//   K1 ell_matvec_fwd  dmlc_core_tpu/ops/sparse.py:17 ell_matvec
//   K2 ell_matvec_bwd  jax.grad of ell_matvec w.r.t. w (a scatter-add)
//   K3 fm_pair_fwd     dmlc_core_tpu/models/fm.py:46-54 pair term
//   K4 fm_pair_bwd     jax.grad of the pair term w.r.t. v
// At the Criteo slice (B=2048, K=39, E=16, D=2^20) each moves at most
// ~11 MB, a few microseconds at the card's memory rate: they are bound
// by memory traffic, and in practice by launch latency, by the chain of
// dependent DRAM round trips a gather costs (index, then row), and by
// the atomics on hot rows (the 13 dense Criteo columns appear in every
// row). The forward gathers (K1, K3) issue all of a row's loads before
// using any, so a row costs two round trips, not one per entry.
//
// empty_launch launches a kernel that does nothing: its time is the
// floor any launch timed the same way pays, printed beside the bounds.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// jnp.take's index rule: the row read for idx, or -1 when it reads NaN.
__device__ __forceinline__ int64_t wrap_index(int32_t idx, int64_t D) {
  int64_t j = idx;
  if (j < 0) j += D;
  return (j >= 0 && j < D) ? j : -1;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

constexpr unsigned kFull = 0xffffffffu;

inline bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// Four consecutive entries of an ELL operand, as one 16-byte load (idx,
// f32 values) or one 8-byte load (f16 values); `p` is 16- (8-) aligned.
__device__ __forceinline__ void load4(const int32_t* p, int (&x)[4]) {
  const int4 t = *reinterpret_cast<const int4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const __half* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&t.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&t.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int u = 0; u < VEC; ++u) p[u] = x[u];
  }
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory: the copy
// needs no register, so any number can be in flight before the wait.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(BYTES) : "memory");
}

// Waits for every cp.async this thread issued.
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__global__ void empty_kernel() {}

// K1: out[b] = sum_k val[b,k] * w[idx[b,k]], replacing
// dmlc_core_tpu/ops/sparse.py:17 ell_matvec. Bound: reads idx and val
// once (B*K*(4+4) bytes) plus the w words the batch's distinct indices
// name, writes B floats: 0.255 us at the Criteo slice over 3.35 TB/s, far
// below any launch. What a launch then costs is latency: the index load
// and the dependent gather of w are two DRAM round trips that no design
// removes. Design: the batch is one flat run of B*K entries, and a warp
// takes 4 whole rows of it (a multiple of 4, so the tile starts 16-byte
// aligned for any K). A lane loads 4 entries of idx and of val with one
// 16-byte (f16: 8-byte) load each, twice per step of 256 entries (K=39:
// the whole tile), then issues its 8 gathers of w together and only then
// uses them. Each product is added to its row's partial (rows found by
// counting from one division per load), and 4 xor-shuffle sums finish the
// rows: no shared memory and no barrier.
constexpr int kMatvecThreads = 128;
constexpr int kMatvecRows = 4;  // rows per warp

template <typename V, bool VEC>
__global__ void __launch_bounds__(kMatvecThreads)
ell_matvec_fwd_kernel(const int32_t* __restrict__ idx,
                      const V* __restrict__ val,
                      const float* __restrict__ w, float* __restrict__ out,
                      int B, int K, int64_t D) {
  const int warp = blockIdx.x * (kMatvecThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kMatvecRows;
  if (row0 >= B) return;  // uniform across the warp
  const int n = min(kMatvecRows, B - row0) * K;  // entries of the tile
  const int64_t t0 = static_cast<int64_t>(row0) * K;
  float part[kMatvecRows] = {};
  for (int c0 = 0; c0 < n; c0 += 256) {
    // entries past the tile read index 0, value 0
    int ix[2][4];
    float x[2][4], wv[2][4];
    int64_t j[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = c0 + 128 * h + 4 * lane;
      if (VEC && e + 4 <= n) {
        load4(idx + t0 + e, ix[h]);
        load4(val + t0 + e, x[h]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ix[h][u] = e + u < n ? idx[t0 + e + u] : 0;
          x[h][u] = e + u < n ? to_f32(val[t0 + e + u]) : 0.f;
        }
      }
    }
    // the 8 gathers issue back to back (w[0] stands in for an invalid
    // index), and only then are the results used
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        j[h][u] = wrap_index(ix[h][u], D);
        wv[h][u] = D > 0 ? __ldg(w + (j[h][u] >= 0 ? j[h][u] : 0)) : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = c0 + 128 * h + 4 * lane;
      int r = e / K, m = e - r * K;  // row within the tile, slot in the row
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = e + u >= n       ? 0.f
                        : j[h][u] >= 0 ? x[h][u] * wv[h][u]
                                       : CUDART_NAN_F;
#pragma unroll
        for (int q = 0; q < kMatvecRows; ++q) part[q] += r == q ? p : 0.f;
        if (++m == K) {
          m = 0;
          ++r;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kMatvecRows; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part[q] += __shfl_xor_sync(kFull, part[q], o);
    if (lane == q && row0 + q < B) out[row0 + q] = part[q];
  }
}

// The vector loads where idx and val are aligned for them.
template <typename V>
void launch_ell_matvec_fwd(const int32_t* idx, const V* val, const float* w,
                           float* out, int B, int K, int64_t D,
                           cudaStream_t st) {
  constexpr int rows_per_block = kMatvecThreads / 32 * kMatvecRows;
  const dim3 grid((B + rows_per_block - 1) / rows_per_block);
  if (aligned(idx, 16) && aligned(val, 4 * sizeof(V)))
    ell_matvec_fwd_kernel<V, true><<<grid, kMatvecThreads, 0, st>>>(
        idx, val, w, out, B, K, D);
  else
    ell_matvec_fwd_kernel<V, false><<<grid, kMatvecThreads, 0, st>>>(
        idx, val, w, out, B, K, D);
}

// K2: gw[idx[b,k]] += g[b] * val[b,k] over a zeroed dense gw.
// Bound: reads idx, val and g once; the scatter touches at most B*K words
// of gw. Design: one thread per (b,k) with an f32 atomicAdd; duplicate
// and hot indices serialise in L2, and the sum order varies by run.
template <typename V>
__global__ void __launch_bounds__(kThreads)
ell_matvec_bwd_kernel(const int32_t* __restrict__ idx,
                      const V* __restrict__ val,
                      const float* __restrict__ g, float* __restrict__ gw,
                      int B, int K, int64_t D) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(B) * K) return;
  const int64_t j = wrap_index(idx[t], D);
  if (j < 0) return;
  atomicAdd(gw + j, g[t / K] * to_f32(val[t]));
}

// K3: with xv[b,k,e] = val[b,k] * v[idx[b,k], e],
//   s[b,e] = sum_k xv,  q[b,e] = sum_k xv^2,  pair[b] = 0.5 sum_e (s^2 - q).
// Replaces the pair term of dmlc_core_tpu/models/fm.py:46-54; s is saved for
// K4. Bound: reads idx, val once and the rows of v the batch's distinct
// indices name (E floats each), writes B*(E+1) floats: 1.225 us at the
// Criteo slice over 3.35 TB/s. What a launch costs is latency: each gather
// depends on an index load, and gathers issued one after another would chain
// ~K DRAM round trips per row. Design: a warp per row, and every gather of
// the row in flight at once. The warp loads a window of 64 of the row's
// indices and values once, coalesced with lanes over k, and wraps the
// indices in registers. A gathered row of v is read by a group of L lanes,
// VEC floats each (VEC=4: 16 bytes, where E*4 bytes is a multiple of 16;
// otherwise scalar lanes), so one warp-wide copy covers S = 32/L k-slots.
// Each lane fetches its slot's index and value from the lane that loaded
// them (__shfl_sync), then issues a fully unrolled run of G cp.async copies
// into its own slots of shared memory and waits once: G*S gathers are in
// flight before any is used (E=16: L=4, S=8, G=8 covers K <= 64 in one run,
// so all 39 gathers of a Criteo row fly together). cp.async needs no
// destination register; plain loads written the same way were issued by
// ptxas in waves of 1, 3 and 4 reusing their registers. Each lane
// accumulates s and q for its slot; xor-shuffles over the slots sum s, the
// first slot's lanes store it with vector stores, and a warp sum of
// sum(s^2) - sum(q) gives pair. Rows wider than 32 lanes (E > 32*VEC) take
// more passes over e. At B=2048 all rows fit on the card in one wave, so a
// warp keeps one row.
template <typename V, int VEC, int L>
__global__ void __launch_bounds__(kThreads)
fm_pair_fwd_kernel(const int32_t* __restrict__ idx,
                   const V* __restrict__ val,
                   const float* __restrict__ v, float* __restrict__ pair,
                   float* __restrict__ s, int B, int K, int E, int64_t D) {
  constexpr int S = 32 / L;                  // k-slots per warp-wide load
  constexpr int G = S >= 8 ? 64 / S : 8;     // loads in flight per run
  constexpr int RUNS = 64 / (G * S);         // runs per window of 64 k
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // uniform across the warp
  if (D == 0) {  // no row to gather: every entry reads NaN
    for (int e = lane; e < E; e += 32)
      s[static_cast<int64_t>(row) * E + e] = CUDART_NAN_F;
    if (lane == 0) pair[row] = CUDART_NAN_F;
    return;
  }
  // this lane's landing slots for the gathered rows of v
  __shared__ __align__(16) float stage[kWarpsPerBlock][G][32][VEC];
  float(*my)[32][VEC] = stage[threadIdx.x >> 5];
  const int slot = lane / L;
  const int C = E / VEC;  // VEC-float chunks in a row of v
  const int64_t base = static_cast<int64_t>(row) * K;
  float part = 0.f;
  for (int c0 = 0; c0 < C; c0 += L) {  // one pass when C <= L
    const int c = c0 + lane % L;
    const bool live = c < C;
    float sv[VEC] = {};
    float qv = 0.f;
    for (int k0 = 0; k0 < K; k0 += 64) {
      long long jr[2];
      float xr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 32 * h + lane;
        jr[h] = k < K ? wrap_index(idx[base + k], D) : 0;
        xr[h] = k < K ? to_f32(val[base + k]) : 0.f;
      }
#pragma unroll
      for (int run = 0; run < RUNS; ++run) {
        if (k0 + run * G * S >= K) break;  // uniform
        long long jg[G];
        float xg[G];
        unsigned use = 0, bad = 0;  // per load: add its products / NaN
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int kk = (run * G + g) * S;  // first k-slot of this load
          jg[g] = __shfl_sync(kFull, jr[kk / 32], kk % 32 + slot);
          xg[g] = __shfl_sync(kFull, xr[kk / 32], kk % 32 + slot);
          const bool in = live && k0 + kk + slot < K;
          use |= static_cast<unsigned>(in && jg[g] >= 0) << g;
          bad |= static_cast<unsigned>(in && jg[g] < 0) << g;
        }
        // every lane copies (row 0 stands in for a slot it skips) into its
        // own stage slots, so all G gathers are in flight before the wait
#pragma unroll
        for (int g = 0; g < G; ++g)
          copy_async<VEC * 4>(my[g][lane],
                              v + (use >> g & 1 ? jg[g] * E + c * VEC : 0));
        wait_async();
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            const float xv = use >> g & 1 ? xg[g] * my[g][lane][u]
                             : bad >> g & 1 ? CUDART_NAN_F : 0.f;
            sv[u] += xv;
            qv += xv * xv;
          }
        }
      }
    }
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) sv[u] += __shfl_xor_sync(kFull, sv[u], o);
    }
    part -= qv;
    if (slot == 0 && live) {
      store_row<VEC>(s + static_cast<int64_t>(row) * E + c * VEC, sv);
#pragma unroll
      for (int u = 0; u < VEC; ++u) part += sv[u] * sv[u];
    }
  }
  part = warp_sum(part);
  if (lane == 0) pair[row] = 0.5f * part;
}

// K3 with the smallest power of two L >= lanes (at most 32).
template <typename V, int VEC, int L = 1>
void launch_fm_pair_fwd_lanes(const int32_t* idx, const V* val,
                              const float* v, float* pair, float* s, int B,
                              int K, int E, int64_t D, int lanes,
                              cudaStream_t st) {
  if constexpr (L < 32) {
    if (lanes > L) {
      launch_fm_pair_fwd_lanes<V, VEC, 2 * L>(idx, val, v, pair, s, B, K, E,
                                              D, lanes, st);
      return;
    }
  }
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  fm_pair_fwd_kernel<V, VEC, L><<<grid, kThreads, 0, st>>>(
      idx, val, v, pair, s, B, K, E, D);
}

// 16-byte lanes where a row of v (and of s) is a whole number of them.
template <typename V>
void launch_fm_pair_fwd(const int32_t* idx, const V* val, const float* v,
                        float* pair, float* s, int B, int K, int E, int64_t D,
                        cudaStream_t st) {
  if (E % 4 == 0 && aligned(v, 16) && aligned(s, 16))
    launch_fm_pair_fwd_lanes<V, 4>(idx, val, v, pair, s, B, K, E, D, E / 4, st);
  else
    launch_fm_pair_fwd_lanes<V, 1>(idx, val, v, pair, s, B, K, E, D, E, st);
}

// K4: gv[idx[b,k], e] += g[b] * val[b,k] * (s[b,e] - val[b,k] * v[idx,e])
// over a zeroed dense gv (the derivative of the pair term).
// Bound: reads idx, val, g, s once and B*K gathered rows of v; the
// scatter touches at most B*K rows of gv. Design: one thread per
// (b,k,e), e fastest so a warp's gathers and atomics hit two whole
// E-float rows; f32 atomicAdd, so hot rows serialise and the sum order
// varies by run.
template <typename V>
__global__ void __launch_bounds__(kThreads)
fm_pair_bwd_kernel(const int32_t* __restrict__ idx,
                   const V* __restrict__ val,
                   const float* __restrict__ v, const float* __restrict__ s,
                   const float* __restrict__ g, float* __restrict__ gv,
                   int B, int K, int E, int64_t D) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(B) * K * E) return;
  const int64_t bk = t / E;
  const int e = static_cast<int>(t - bk * E);
  const int64_t b = bk / K;
  const int64_t j = wrap_index(idx[bk], D);
  if (j < 0) return;
  const float x = to_f32(val[bk]);
  const float vj = v[j * E + e];
  // x * vj rounded as s's own term was (no fused multiply-add), so a row
  // whose s is that one term gets the exact zero gradient
  atomicAdd(gv + j * E + e, g[b] * x * (s[b * E + e] - __fmul_rn(x, vj)));
}

inline unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// C interface. `val_f16` selects __half (1) or float (0) values; every
// pointer is a device pointer; `stream` is a cudaStream_t.
extern "C" {

int ell_matvec_fwd(const void* idx, const void* val, int val_f16,
                   const void* w, void* out, int B, int K, int64_t D,
                   void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_f16)
    launch_ell_matvec_fwd(ix, static_cast<const __half*>(val), wf, o, B, K, D,
                          st);
  else
    launch_ell_matvec_fwd(ix, static_cast<const float*>(val), wf, o, B, K, D,
                          st);
  return static_cast<int>(cudaGetLastError());
}

int ell_matvec_bwd(const void* idx, const void* val, int val_f16,
                   const void* g, void* gw, int B, int K, int64_t D,
                   void* stream) {
  const dim3 grid(blocks_for(static_cast<int64_t>(B) * K));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_f16)
    ell_matvec_bwd_kernel<__half><<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(idx), static_cast<const __half*>(val),
        static_cast<const float*>(g), static_cast<float*>(gw), B, K, D);
  else
    ell_matvec_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(idx), static_cast<const float*>(val),
        static_cast<const float*>(g), static_cast<float*>(gw), B, K, D);
  return static_cast<int>(cudaGetLastError());
}

int fm_pair_fwd(const void* idx, const void* val, int val_f16, const void* v,
                void* pair, void* s, int B, int K, int E, int64_t D,
                void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* vf = static_cast<const float*>(v);
  float* p = static_cast<float*>(pair);
  float* so = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_f16)
    launch_fm_pair_fwd(ix, static_cast<const __half*>(val), vf, p, so, B, K,
                       E, D, st);
  else
    launch_fm_pair_fwd(ix, static_cast<const float*>(val), vf, p, so, B, K, E,
                       D, st);
  return static_cast<int>(cudaGetLastError());
}

int fm_pair_bwd(const void* idx, const void* val, int val_f16, const void* v,
                const void* s, const void* g, void* gv, int B, int K, int E,
                int64_t D, void* stream) {
  const dim3 grid(blocks_for(static_cast<int64_t>(B) * K * E));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_f16)
    fm_pair_bwd_kernel<__half><<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(idx), static_cast<const __half*>(val),
        static_cast<const float*>(v), static_cast<const float*>(s),
        static_cast<const float*>(g), static_cast<float*>(gv), B, K, E, D);
  else
    fm_pair_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(idx), static_cast<const float*>(val),
        static_cast<const float*>(v), static_cast<const float*>(s),
        static_cast<const float*>(g), static_cast<float*>(gv), B, K, E, D);
  return static_cast<int>(cudaGetLastError());
}

int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
