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
// the adds on hot rows (the 13 dense Criteo columns appear in every
// row). The forward gathers (K1, K3) issue all of a row's loads before
// using any, so a row costs two round trips, not one per entry. The
// gradient scatters (K2, K4) fix their order of summation by the inputs
// alone, so the same inputs give the same bits on every launch: a tile of
// the batch sorts its entries by row and sums each row's entries in entry
// order (one partial per tile and row, not one add per entry), and the
// partials of a row that several tiles name are added exactly in 64-bit
// fixed point with integer atomics, then rounded to f32 once.
//
// empty_launch launches a kernel that does nothing: its time is the
// floor any launch timed the same way pays, printed beside the bounds.
// scatter_smem_bytes reports the dynamic shared memory of a K4 tile
// block, which the compiler's -Xptxas -v report does not show.

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

// The gradient scatters K2 and K4 share one design in two launches, and
// every bit they write is fixed by their inputs alone: no float is added
// in an order the hardware picks, so two runs on the same inputs give the
// same gradient.
//
// The tile launch. A block takes a tile of kTile consecutive entries of
// the flat [B, K] batch (not whole rows, so shared memory is bounded for
// any K), one entry a thread, and sorts the tile's keys (row j << 8 |
// entry) with a bitonic network (shuffles within a warp, shared memory
// across warps). Equal rows then lie in runs, in entry order, and a
// thread a run sums the run's contributions in that order into the
// tile's partial of row j, stored at slot t * kTile + r of the tile lists
// (t the tile, r the run). A row that several entries of a tile name (the
// 13 dense Criteo columns are in every row: a tile of 256 entries names
// each ~6.5 times) costs one partial per tile instead of one add per
// entry. Each partial also counts itself in its row's record (four int32
// at meta[4j]: the partials naming j, 1 + the largest biased exponent
// among them, the lowest slot naming j, the partials flushed) with
// integer atomics, whose results do not depend on their order.
//
// The flush launch, a thread a partial (K4: 16 lanes). A row named by
// one partial stores it. The partials of a row named by several tiles
// are added exactly, in 64-bit fixed point: each is scaled by 2^k, where
// k puts the row's largest partial times its partial count below 2^62
// (one rounding to an integer each, at 2^-62 of that bound, where an f32
// add rounds at 2^-24 of its result), and added with integer atomics
// into the accumulator of the row's lowest slot; an infinity or NaN sets
// a flag there instead. The last partial to flush the row (its record's
// count) converts the exact sum to f32 once, stores it, and zeroes the
// accumulator, the flags and the record, so the scratch (zeroed once by
// the wrapper) is clean for the next call with no memset. A NaN
// contribution makes its run's partial NaN, and the flags carry it to
// the same gradient entries an f32 add would (NaN, or +inf with -inf:
// NaN; else the infinity); invalid indices insert no key and add nothing.
// The order of summation thus comes from the inputs alone: within a tile
// the entry order, across tiles none is needed (integer adds commute).
//
// kTile = 256, so a block has 256 threads: at the Criteo slice (B*K =
// 79,872) 312 blocks of 256 fit on the 132 SMs in one wave. Tiles of 128
// and 512 are timed by ops/scatter_variants.py (PERF.md has the numbers).
constexpr int kTile = 256;
constexpr int kTileLog = 8;
static_assert(kTile == 1 << kTileLog, "tile size");
constexpr int kTileWarps = kTile / 32;
constexpr unsigned long long kNoKey = ~0ull;
// a record keeps kSlotBias - slot, so an atomicMax finds the lowest slot
// and a zeroed record names none (the wrappers keep B*K below 2^30)
constexpr int kSlotBias = 1 << 30;

// The scratch of a scatter: the tile lists the tile launch writes
// (rows[slot], parts[slot * E], runs[tile]), and the zeroed records
// (meta), fixed-point accumulators (acc) and flags the flush leaves
// zeroed. The records are interleaved so that neighbouring rows fall in
// different 128-byte lines: the integer atomics on one line serialise,
// and the hot rows are neighbours (the 13 dense Criteo columns are rows
// 0-12), so each hot row takes its 3 atomics a tile on a line of its own.
struct TileLists {
  long long* rows;
  float* parts;
  int* runs;
  int* meta;  // 4 int32 a row, at record(row)
  unsigned long long* acc;  // [slot][E]
  int* flags;  // [slot][E]
  long long rec_stride;  // ceil(D / 16)
};

__device__ __forceinline__ int* record(const TileLists& L, long long row) {
  return L.meta + 4 * ((row & 15) * L.rec_stride + (row >> 4));
}

// Sorts one key a thread across the block's kTile threads, ascending: a
// bitonic network, its stages within a warp by shuffles and the others
// through `buf`. Leaves the sorted keys in buf; ends with a barrier.
__device__ void sort_tile(unsigned long long key, unsigned long long* buf) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 2; k <= kTile; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        buf[tid] = key;
        __syncthreads();
        other = buf[tid ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(kFull, key, j);
      }
      // the lower of a pair keeps the smaller key where its run of k
      // ascends (bit k of tid clear), the larger where it descends
      const bool keep_min = ((tid & j) == 0) == ((tid & k) == 0);
      key = keep_min == (other < key) ? other : key;
    }
  }
  buf[tid] = key;
  __syncthreads();
}

// The runs of equal rows in a tile's sorted keys (kNoKey sorts last): run
// r covers the sorted positions [start[r], start[r + 1]). Returns the
// number of runs; ends with a barrier.
__device__ int tile_runs(const unsigned long long* sk, int* start, int* heads) {
  const int p = threadIdx.x, lane = p & 31;
  const unsigned long long key = sk[p];
  const bool head = key != kNoKey && (p == 0 || (sk[p - 1] >> kTileLog) != (key >> kTileLog));
  const unsigned ball = __ballot_sync(kFull, head);
  if (lane == 0) heads[p >> 5] = __popc(ball);
  const int valid = __syncthreads_count(key != kNoKey);
  int r = __popc(ball & ((1u << lane) - 1)), runs = 0;
  for (int w = 0; w < kTileWarps; ++w) {
    r += w < (p >> 5) ? heads[w] : 0;
    runs += heads[w];
  }
  if (head) start[r] = p;
  if (p == 0) start[runs] = valid;
  __syncthreads();
  return runs;
}

// 1 + the biased exponent of a finite nonzero x, so |x| < 2^(e - 127); 0
// for zero, the infinities and NaN.
__device__ __forceinline__ int expo_of(float x) {
  const int b = static_cast<int>((__float_as_uint(x) >> 23) & 0xff);
  return b == 0xff || x == 0.f ? 0 : b + 1;
}

// Counts the partial at `slot` in the record `m` of its row, with its
// exponent `ex` (expo_of).
__device__ __forceinline__ void note_partial(int* m, long long slot, int ex) {
  atomicAdd(m, 1);
  if (ex) atomicMax(m + 1, ex);
  atomicMax(m + 2, kSlotBias - static_cast<int>(slot));
}

// The flush of the partials of tile blockIdx.x into the dense `out`, G
// lanes a partial (K4: 16, K2: 1), lane c moving columns Wc to Wc + W - 1
// of every 16 (W = 16 / G; K2: column 0), so a partial's lanes touch
// contiguous words: at G = 16 one instruction adds a partial's 16
// columns into one 128-byte line of accumulators (ops/scatter_variants.py
// times G = 4 against it); block y takes partials y * kTile / G on.
template <int G>
__device__ void flush_tile(const TileLists& L, int E, float* out) {
  static_assert(16 % G == 0, "a partial's lanes cover 16 columns");
  constexpr int W = G == 1 ? 1 : 16 / G;  // columns a lane moves together
  const int r = blockIdx.y * (kTile / G) + threadIdx.x / G;
  if (r >= L.runs[blockIdx.x]) return;  // uniform across a partial's lanes
  const int lane = threadIdx.x % G;
  const long long slot = static_cast<long long>(blockIdx.x) * kTile + r;
  const long long row = L.rows[slot];
  int* m = record(L, row);
  const int4 rec = *reinterpret_cast<const int4*>(m);  // partials, exponent, lowest slot, flushed
  const float* part = L.parts + slot * E;
  float* dst = out + row * E;
  if (rec.x == 1) {  // one partial: it is the sum
    for (int e0 = W * lane; e0 < E; e0 += W * G)
      for (int e = e0; e < e0 + W && e < E; ++e) dst[e] = part[e];
    if (lane == 0) *reinterpret_cast<int4*>(m) = make_int4(0, 0, 0, 0);
    return;
  }
  // rec.x <= 2^lg partials, each |x| < 2^(rec.y - 127): |sum| * 2^k < 2^62;
  // k lies in [-66 - lg, 188], so 2^k is two exact float steps and 2^-k
  // one exact double
  const int lg = 32 - __clz(rec.x - 1);
  const int k = rec.y ? 189 - lg - rec.y : 0;
  const float up_a = __int_as_float((k / 2 + 127) << 23);
  const float up_b = __int_as_float((k - k / 2 + 127) << 23);
  const double down = __longlong_as_double(static_cast<long long>(1023 - k) << 52);
  const long long owner = (kSlotBias - rec.z) * static_cast<long long>(E);
  for (int e0 = W * lane; e0 < E; e0 += W * G) for (int e = e0; e < e0 + W && e < E; ++e) {
    const float x = part[e];
    const long long at = owner + e;
    if (isnan(x))
      atomicOr(L.flags + at, 1);
    else if (isinf(x))
      atomicOr(L.flags + at, x > 0.f ? 2 : 4);
    else if (x != 0.f)
      atomicAdd(L.acc + at, static_cast<unsigned long long>(__float2ll_rn(x * up_a * up_b)));
  }
  // the adds land before the count that lets the last partial read them
  __threadfence();
  int last;
  if constexpr (G == 1) {
    last = atomicAdd(m + 3, 1) == rec.x - 1;
  } else {
    const unsigned group = ((1u << G) - 1) << (threadIdx.x & (32 - G));  // this partial's lanes
    __syncwarp(group);
    last = lane == 0 && atomicAdd(m + 3, 1) == rec.x - 1;
    last = __shfl_sync(group, last, 0, G);
  }
  if (!last) return;
  __threadfence();
  for (int e0 = W * lane; e0 < E; e0 += W * G) for (int e = e0; e < e0 + W && e < E; ++e) {
    const long long at = owner + e;
    const long long q = static_cast<long long>(atomicExch(L.acc + at, 0ull));
    const int f = atomicExch(L.flags + at, 0);
    dst[e] = (f & 1) || f == 6 ? CUDART_NAN_F
             : f == 2          ? CUDART_INF_F
             : f == 4          ? -CUDART_INF_F
                               : static_cast<float>(__ll2double_rn(q) * down);
  }
  if (lane == 0) *reinterpret_cast<int4*>(m) = make_int4(0, 0, 0, 0);
}

// Batch rows of a tile's entries: entry i of the tile that starts at flat
// entry t0 lies in row row(i). One 64-bit division a thread, then a 32-bit
// one (rem0 + i < K + kTile).
struct TileRows {
  int64_t row0;
  int rem0, K;
  __device__ TileRows(int64_t t0, int k)
      : row0(t0 / k), rem0(static_cast<int>(t0 - t0 / k * k)), K(k) {}
  __device__ int rel(int i) const {  // row(i) - row0
    return static_cast<int>(static_cast<unsigned>(rem0 + i) / static_cast<unsigned>(K));
  }
  __device__ int64_t row(int i) const { return row0 + rel(i); }
};

// K2: gw[idx[b,k]] += g[b] * val[b,k] over a zeroed dense gw, the
// gradient of K1 w.r.t. w (jax.grad of dmlc_core_tpu/ops/sparse.py:17
// ell_matvec, a scatter-add). Bound: reads idx and val once, g once, and
// writes the dense gw (the wrapper's zero-fill included): 1.445 us at the
// Criteo slice over 3.35 TB/s, below the launch floor. What held the
// slice-1 kernel back: one thread and one f32 atomic per entry, 26.6 k of
// its 80 k atomics on the 13 hot words, which share one 128-byte line and
// serialise there; a later kernel summed tiles in shared memory first,
// still with f32 atomics in the hardware's order. Design: the two
// launches above with one value a partial. A thread loads its entry's
// idx, val and g[b]; the tile's sort gives each row's partial, and the 13
// hot words take 312 integer adds each.
template <typename V>
__global__ void __launch_bounds__(kTile)
ell_matvec_bwd_kernel(const int32_t* __restrict__ idx,
                      const V* __restrict__ val,
                      const float* __restrict__ g, int B, int K, int64_t D,
                      TileLists L) {
  __shared__ unsigned long long sk[kTile];
  __shared__ float term[kTile];
  __shared__ int start[kTile + 1];
  __shared__ int heads[kTileWarps];
  const int64_t n = static_cast<int64_t>(B) * K;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t t = t0 + threadIdx.x;
  const int64_t j = t < n ? wrap_index(idx[t], D) : -1;
  term[threadIdx.x] = t < n ? g[TileRows(t0, K).row(threadIdx.x)] * to_f32(val[t]) : 0.f;
  sort_tile(j >= 0 ? static_cast<unsigned long long>(j) << kTileLog | threadIdx.x : kNoKey, sk);
  const int runs = tile_runs(sk, start, heads);
  const int r = threadIdx.x;
  if (r < runs) {
    float sum = 0.f;
    for (int p = start[r]; p < start[r + 1]; ++p) sum += term[sk[p] & (kTile - 1)];
    const long long row = static_cast<long long>(sk[start[r]] >> kTileLog);
    const long long slot = t0 + r;
    L.rows[slot] = row;
    L.parts[slot] = sum;
    note_partial(record(L, row), slot, expo_of(sum));
  }
  if (r == 0) L.runs[blockIdx.x] = runs;
}

__global__ void __launch_bounds__(kTile)
ell_matvec_bwd_flush_kernel(TileLists L, float* __restrict__ gw) {
  flush_tile<1>(L, 1, gw);
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
// over a zeroed dense gv, the gradient of K3's pair term w.r.t. v (jax.grad
// of dmlc_core_tpu/models/fm.py:46-54). Bound: reads idx, val, g and s once
// and the rows of v the batch's distinct indices name, and writes the dense
// gv (the wrapper's 64 MiB zero-fill included): 21.257 us at the Criteo
// slice over 3.35 TB/s, most of it the zero-fill. What held the slice-1
// kernel back: one thread and one scalar f32 atomic per (b,k,e), 1.28 M
// atomics, of which 426 k land on the 13 hot rows (208 floats, 7 L2 lines)
// and serialise there; a later kernel summed tiles in shared memory with
// float atomics in the hardware's order. Design: the two launches above
// with E floats a partial, in chunks of kChunk columns on the grid's
// second dimension (a block loops over its chunks, keeping its sort), so
// shared memory is bounded for any E. A thread loads its entry's idx, val
// and g[b] and issues the gather of its row of v as cp.async copies into
// the entry's own row of a staging buffer (16 bytes each where E*4 is a
// multiple of 16, else 4); the block copies the few rows of s its tile
// spans (8 at K = 39) the same way, so each s word is read once per tile,
// not once per entry. The copies fly while the keys sort. Then lanes over
// (entry, column) turn each staged row into its terms g*x*(s - x*v) in
// place, and lanes over (run, column) sum each run's terms in entry order
// into its partial; the kChunk lanes of a run take the run's largest
// exponent with shuffles before one atomic. The flush moves E floats a
// partial (57 k partials at the Criteo slice).
constexpr int kChunk = 16;  // columns of gv a block sums at once
constexpr int kStride = kTile / kChunk;  // entries a pass of lanes covers
static_assert(kTile % kChunk == 0 && kChunk == 16, "a run's lanes are half a warp");

// An entry of K4's tile: its row relative to the tile's first, its value
// and g * value.
struct alignas(16) FmEntry {
  int row;
  float x, gx, pad;
};

// rows of s a tile spans
inline int fm_tile_rows(int K) {
  const int r = (kTile + K - 2) / K + 1;
  return r < kTile ? r : kTile;
}

// staged rows of v (then the terms), the entries, the rows of s
inline size_t fm_pair_bwd_smem(int K) {
  return kTile * kChunk * 4 + kTile * sizeof(FmEntry) +
         static_cast<size_t>(fm_tile_rows(K)) * kChunk * 4;
}

// COPY: bytes a cp.async moves (16 or 4).
template <typename V, int COPY>
__global__ void __launch_bounds__(kTile)
fm_pair_bwd_kernel(const int32_t* __restrict__ idx,
                   const V* __restrict__ val,
                   const float* __restrict__ v, const float* __restrict__ s,
                   const float* __restrict__ g, int B, int K, int E, int64_t D,
                   TileLists L) {
  constexpr int CW = COPY / 4;  // floats a copy moves
  extern __shared__ __align__(16) unsigned char smem[];
  float* vrow = reinterpret_cast<float*>(smem);                      // [kTile][kChunk]
  FmEntry* ent = reinterpret_cast<FmEntry*>(vrow + kTile * kChunk);  // [kTile]
  float* srow = reinterpret_cast<float*>(ent + kTile);  // [tile rows][kChunk]
  __shared__ unsigned long long sk[kTile];
  __shared__ int start[kTile + 1];
  __shared__ int heads[kTileWarps];
  const int64_t n = static_cast<int64_t>(B) * K;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const TileRows rows(t0, K);
  const int64_t t = t0 + threadIdx.x;
  const int64_t j = t < n ? wrap_index(idx[t], D) : -1;
  FmEntry me;
  me.row = rows.rel(threadIdx.x);
  me.x = t < n ? to_f32(val[t]) : 0.f;
  me.gx = t < n ? g[rows.row0 + me.row] * me.x : 0.f;
  me.pad = 0.f;
  ent[threadIdx.x] = me;
  // rows of s the tile's entries lie in
  const int live = n - t0 < kTile ? static_cast<int>(n - t0) : kTile;
  const int nrows = rows.rel(live - 1) + 1;
  // this entry's row of v and the tile's rows of s for chunk c0, copied
  // into shared memory: all in flight before any is used
  auto issue = [&](int c0) {
    const int ec = min(kChunk, E - c0);
    if (j >= 0) {
      const float* src = v + j * E + c0;
#pragma unroll
      for (int u = 0; u < kChunk; u += CW)
        if (u < ec) copy_async<COPY>(vrow + threadIdx.x * kChunk + u, src + u);
    }
    for (int u = threadIdx.x; u < nrows * (kChunk / CW); u += kTile) {
      const int r = u / (kChunk / CW), c = u % (kChunk / CW) * CW;
      if (c < ec) copy_async<COPY>(srow + r * kChunk + c, s + (rows.row0 + r) * E + c0 + c);
    }
  };
  int c0 = blockIdx.y * kChunk;
  issue(c0);  // in flight while the keys sort
  sort_tile(j >= 0 ? static_cast<unsigned long long>(j) << kTileLog | threadIdx.x : kNoKey, sk);
  const int runs = tile_runs(sk, start, heads);
  // lanes over (entry, column): this thread computes column e of entries
  // threadIdx.x / kChunk + q * kStride, and sums column e of runs
  const int e = threadIdx.x % kChunk;
  const int i0 = threadIdx.x / kChunk;
  const unsigned group = 0xffffu << (threadIdx.x & 16);  // a run's lanes
  bool notes = blockIdx.y == 0;  // this block counts the tile's partials
  for (;;) {
    const int ec = min(kChunk, E - c0);  // columns in this chunk
    wait_async();
    __syncthreads();  // the rows landed
    // x * v rounded as s's own term was (no fused multiply-add), so a row
    // whose s is that one term gets the exact zero gradient
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int i = i0 + q * kStride;
      const FmEntry en = ent[i];
      float* term = vrow + i * kChunk + e;
      *term = en.gx * (srow[en.row * kChunk + e] - __fmul_rn(en.x, *term));
    }
    __syncthreads();  // the terms are complete
    for (int w = threadIdx.x; w < runs * kChunk; w += kTile) {
      const int r = w / kChunk;
      const long long slot = t0 + r;
      float sum = 0.f;
      for (int p = start[r]; p < start[r + 1]; ++p)
        sum += vrow[(sk[p] & (kTile - 1)) * kChunk + e];
      if (e < ec) L.parts[slot * E + c0 + e] = sum;
      int ex = e < ec ? expo_of(sum) : 0;
#pragma unroll
      for (int o = kChunk / 2; o > 0; o >>= 1)
        ex = max(ex, __shfl_xor_sync(group, ex, o, kChunk));
      if (e == 0) {
        const long long row = static_cast<long long>(sk[start[r]] >> kTileLog);
        if (notes) {
          L.rows[slot] = row;
          note_partial(record(L, row), slot, ex);
        } else if (ex) {
          atomicMax(record(L, row) + 1, ex);
        }
      }
    }
    if (notes && threadIdx.x == 0) L.runs[blockIdx.x] = runs;
    notes = false;
    const int next = c0 + gridDim.y * kChunk;
    if (next >= E) break;
    __syncthreads();  // the sums have read the terms
    issue(next);
    c0 = next;
  }
}

constexpr int kFlushLanes = 16;  // K4's lanes a partial

__global__ void __launch_bounds__(kTile)
fm_pair_bwd_flush_kernel(TileLists L, int E, float* __restrict__ gv) {
  flush_tile<kFlushLanes>(L, E, gv);
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline unsigned tiles_for(int B, int K) {
  return static_cast<unsigned>((static_cast<int64_t>(B) * K + kTile - 1) / kTile);
}

template <typename V, int COPY>
cudaError_t launch_fm_pair_bwd_as(const int32_t* idx, const V* val,
                                  const float* v, const float* s,
                                  const float* g, float* gv, int B, int K,
                                  int E, int64_t D, const TileLists& L,
                                  cudaStream_t st) {
  auto kernel = fm_pair_bwd_kernel<V, COPY>;
  const size_t bytes = fm_pair_bwd_smem(K);
  cudaError_t rc = allow_smem(kernel, bytes);
  if (rc != cudaSuccess) return rc;
  const unsigned tiles = tiles_for(B, K);
  const int chunks = (E + kChunk - 1) / kChunk;  // a block loops past 65535
  kernel<<<dim3(tiles, chunks < 65535 ? chunks : 65535), kTile, bytes, st>>>(
      idx, val, v, s, g, B, K, E, D, L);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  fm_pair_bwd_flush_kernel<<<dim3(tiles, kFlushLanes), kTile, 0, st>>>(L, E, gv);
  return cudaGetLastError();
}

// 16-byte copies where rows of v and s are a whole number of them.
template <typename V>
cudaError_t launch_fm_pair_bwd(const int32_t* idx, const V* val,
                               const float* v, const float* s, const float* g,
                               float* gv, int B, int K, int E, int64_t D,
                               const TileLists& L, cudaStream_t st) {
  if (E % 4 == 0 && aligned(v, 16) && aligned(s, 16))
    return launch_fm_pair_bwd_as<V, 16>(idx, val, v, s, g, gv, B, K, E, D, L, st);
  return launch_fm_pair_bwd_as<V, 4>(idx, val, v, s, g, gv, B, K, E, D, L, st);
}

template <typename V>
cudaError_t launch_ell_matvec_bwd(const int32_t* idx, const V* val,
                                  const float* g, float* gw, int B, int K,
                                  int64_t D, const TileLists& L,
                                  cudaStream_t st) {
  const unsigned tiles = tiles_for(B, K);
  ell_matvec_bwd_kernel<V><<<tiles, kTile, 0, st>>>(idx, val, g, B, K, D, L);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  ell_matvec_bwd_flush_kernel<<<tiles, kTile, 0, st>>>(L, gw);
  return cudaGetLastError();
}

inline TileLists tile_lists(void* rows, void* parts, void* runs, void* meta,
                            void* acc, void* flags, int64_t D) {
  return {static_cast<long long*>(rows), static_cast<float*>(parts),
          static_cast<int*>(runs), static_cast<int*>(meta),
          static_cast<unsigned long long*>(acc), static_cast<int*>(flags),
          (D + 15) / 16};
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
                   void* rows, void* parts, void* runs, void* meta, void* acc,
                   void* flags, void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* gf = static_cast<const float*>(g);
  float* o = static_cast<float*>(gw);
  const TileLists L = tile_lists(rows, parts, runs, meta, acc, flags, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_f16)
    return static_cast<int>(launch_ell_matvec_bwd(
        ix, static_cast<const __half*>(val), gf, o, B, K, D, L, st));
  return static_cast<int>(launch_ell_matvec_bwd(
      ix, static_cast<const float*>(val), gf, o, B, K, D, L, st));
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
                int64_t D, void* rows, void* parts, void* runs, void* meta,
                void* acc, void* flags, void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* vf = static_cast<const float*>(v);
  const float* sf = static_cast<const float*>(s);
  const float* gf = static_cast<const float*>(g);
  float* o = static_cast<float*>(gv);
  const TileLists L = tile_lists(rows, parts, runs, meta, acc, flags, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_f16)
    return static_cast<int>(launch_fm_pair_bwd(
        ix, static_cast<const __half*>(val), vf, sf, gf, o, B, K, E, D, L, st));
  return static_cast<int>(launch_fm_pair_bwd(
      ix, static_cast<const float*>(val), vf, sf, gf, o, B, K, E, D, L, st));
}

// Dynamic shared memory of a K2 (fm = 0: none) or K4 (fm = 1) tile block
// at K, in bytes.
int scatter_smem_bytes(int fm, int K) {
  return static_cast<int>(fm ? fm_pair_bwd_smem(K) : 0);
}

int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
