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
// using any, so a row costs two round trips, not one per entry. The
// gradient scatters (K2, K4) sum each tile of the batch in shared memory
// first, so a row costs one global reduction per tile, not one per entry.
//
// empty_launch launches a kernel that does nothing: its time is the
// floor any launch timed the same way pays, printed beside the bounds.
// scatter_smem_bytes reports the dynamic shared memory of a K2 or K4
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

// Asks L2 to fetch the line holding `p` (no register, no wait).
__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
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

// The gradient scatters K2 and K4 share one design: tile-local
// aggregation in shared memory, with no grouping by destination. A block
// takes a tile of kTile consecutive entries of the flat [B, K] batch (not
// whole rows, so shared memory is bounded for any K), one entry a thread.
// Each valid entry wraps its index and inserts the row j it names into an
// open-addressing hash table in shared memory (64-bit keys, so any j < D;
// capacity 2*kTile, so the table never fills and a probe ends). The thread
// that claims a key with atomicCAS takes the next compact slot from a
// shared counter, so values need kTile slots, not one per table entry.
// After a barrier every entry adds its contribution into its slot with
// shared-memory f32 atomics, and after another every occupied slot is
// flushed once into the dense gradient with global reductions. A row that
// several entries of a tile name (the 13 dense Criteo columns are in every
// row: a tile of 256 entries names each ~6.5 times) costs one global
// reduction per tile instead of one per entry. A NaN contribution makes its
// slot NaN, and the flush carries it to the same gradient entries a
// per-entry atomic would; invalid indices insert nothing and add nothing.
//
// kTile = 256, so a block has 256 threads. These kernels are bound by the
// latency of a thread's chain (index load, gather, insert, barrier, shared
// atomics, barrier, flush), not by the global atomics a larger tile would
// save: at the Criteo slice (B*K = 79,872) 312 blocks of 256 fit on the
// 132 SMs in one wave, and tiles of 128 and of 512 were both slower
// (ops/scatter_variants.py times each choice; PERF.md has the numbers).
constexpr int kTile = 256;
constexpr int kTableCap = 2 * kTile;  // a power of two >= 2 * kTile
constexpr int kTableLog = 9;
static_assert(kTableCap == 1 << kTableLog, "table capacity");
constexpr unsigned long long kEmptyKey = ~0ull;

// A tile's hash table in shared memory: keys[pos] is the row claimed at
// table position pos, slot_at[pos] its compact slot, key_of[slot] the row
// of each slot, *count the slots claimed.
struct TileTable {
  unsigned long long* keys;  // [kTableCap]
  unsigned long long* key_of;  // [kTile]
  int* slot_at;  // [kTableCap]
  int* count;

  static constexpr __host__ __device__ size_t bytes() {
    return kTableCap * 8 + kTile * 8 + kTableCap * 4 + 16;
  }
  // Carves the table from `p` (8-byte aligned) and returns what follows.
  __device__ unsigned char* carve(unsigned char* p) {
    keys = reinterpret_cast<unsigned long long*>(p);
    key_of = keys + kTableCap;
    slot_at = reinterpret_cast<int*>(key_of + kTile);
    count = slot_at + kTableCap;
    return p + bytes();
  }
  // Empties the table; the block syncs before the first insert.
  __device__ void clear() {
    for (int h = threadIdx.x; h < kTableCap; h += kTile) keys[h] = kEmptyKey;
    if (threadIdx.x == 0) *count = 0;
  }
  // The table position of row j, claiming it (and a slot) if it is new;
  // `claimed` says whether this call did. The key is read before any CAS:
  // a tile names its hot rows many times.
  __device__ int insert(int64_t j, bool& claimed) {
    const unsigned long long key = static_cast<unsigned long long>(j);
    unsigned h = static_cast<unsigned>((key * 0x9E3779B97F4A7C15ull) >>
                                       (64 - kTableLog));
    const volatile unsigned long long* seen = keys;
    for (;;) {
      unsigned long long k = seen[h];
      if (k == kEmptyKey) {
        k = atomicCAS(keys + h, kEmptyKey, key);
        if (k == kEmptyKey) {
          const int slot = atomicAdd(count, 1);
          slot_at[h] = slot;
          key_of[slot] = key;
          claimed = true;
          return static_cast<int>(h);
        }
      }
      if (k == key) {
        claimed = false;
        return static_cast<int>(h);
      }
      h = (h + 1) & (kTableCap - 1);
    }
  }
};

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
// Criteo slice over 3.35 TB/s, below the launch floor. What held the slice-1
// kernel back: one thread and one f32 atomic per entry, and 26.6 k of its
// 80 k atomics land on the 13 hot words, which share one 128-byte line and
// serialise there. Design: the shared tile aggregation above, with one
// value per slot. A thread loads its entry's idx, val and g[b], inserts
// it, adds g*val into its slot after a barrier, and the block flushes each
// slot with one scalar global reduction: the 13 hot words take 312
// reductions each instead of 2048.
template <typename V>
__global__ void __launch_bounds__(kTile)
ell_matvec_bwd_kernel(const int32_t* __restrict__ idx,
                      const V* __restrict__ val,
                      const float* __restrict__ g, float* __restrict__ gw,
                      int B, int K, int64_t D) {
  extern __shared__ __align__(16) unsigned char smem[];
  TileTable tb;
  float* sum = reinterpret_cast<float*>(tb.carve(smem));  // [kTile]
  tb.clear();
  sum[threadIdx.x] = 0.f;
  const int64_t n = static_cast<int64_t>(B) * K;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t t = t0 + threadIdx.x;
  const int64_t j = t < n ? wrap_index(idx[t], D) : -1;
  const float c = t < n ? g[TileRows(t0, K).row(threadIdx.x)] * to_f32(val[t]) : 0.f;
  __syncthreads();  // the table is empty
  bool claimed;
  const int pos = j >= 0 ? tb.insert(j, claimed) : -1;
  __syncthreads();  // every slot is claimed
  if (pos >= 0) atomicAdd(sum + tb.slot_at[pos], c);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < *tb.count)
    atomicAdd(gw + tb.key_of[threadIdx.x], sum[threadIdx.x]);
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
// and serialise there. Design: the shared tile aggregation above, with
// kChunk floats per slot. Columns past kChunk are further chunks on the
// grid's second dimension (a block loops over its chunks, reusing its
// table), so shared memory is bounded for any E. A thread loads its entry's
// idx, val and g[b] and issues the gather of its row of v as cp.async
// copies into the entry's own row of a staging buffer (16 bytes each where
// E*4 is a multiple of 16, else 4); the block copies the few rows of s its
// tile spans (8 at K = 39) the same way, so each s word is read once per
// tile, not once per entry. Only then is the key inserted, so every copy
// is in flight while the table fills, and a thread that claims a slot asks
// L2 for the slot's row of gv. After the wait and a barrier, lanes over
// (entry, column) compute all their g*x*(s - x*v) terms, then add them into
// the slots (16 lanes cover one entry's 16 columns, so a warp's shared
// atomics touch two slot rows), and the flush adds each slot
// row with float4 reductions (red.global.add.v4.f32, the sm_90 float4
// atomicAdd) where gv is 16-byte aligned and E*4 is a multiple of 16, else
// with scalar ones: a unique row costs 4 vector reductions at E = 16
// instead of 16 scalar atomics, a hot row one set per tile instead of one
// per batch row.
constexpr int kChunk = 16;  // columns of gv a block aggregates at once
constexpr int kStride = kTile / kChunk;  // entries a pass of lanes covers
static_assert(kTile % kChunk == 0, "a thread keeps one column");

// An entry of K4's tile: its table position (-1: no contribution), its row
// relative to the tile's first, its value and g * value.
struct alignas(16) FmEntry {
  int pos, row;
  float x, gx;
};

// rows of s a tile spans
inline int fm_tile_rows(int K) {
  const int r = (kTile + K - 2) / K + 1;
  return r < kTile ? r : kTile;
}

// slot sums, gathered rows of v, the table, the entries, the rows of s
inline size_t fm_pair_bwd_smem(int K) {
  return 2 * kTile * kChunk * 4 + TileTable::bytes() + kTile * sizeof(FmEntry) +
         static_cast<size_t>(fm_tile_rows(K)) * kChunk * 4;
}

// COPY: bytes a cp.async moves (16 or 4); RED4: float4 flush.
template <typename V, int COPY, bool RED4>
__global__ void __launch_bounds__(kTile)
fm_pair_bwd_kernel(const int32_t* __restrict__ idx,
                   const V* __restrict__ val,
                   const float* __restrict__ v, const float* __restrict__ s,
                   const float* __restrict__ g, float* __restrict__ gv,
                   int B, int K, int E, int64_t D) {
  constexpr int CW = COPY / 4;  // floats a copy moves
  extern __shared__ __align__(16) unsigned char smem[];
  float* sum = reinterpret_cast<float*>(smem);  // [kTile][kChunk]
  float* vrow = sum + kTile * kChunk;           // [kTile][kChunk]
  TileTable tb;
  FmEntry* ent = reinterpret_cast<FmEntry*>(tb.carve(
      reinterpret_cast<unsigned char*>(vrow + kTile * kChunk)));  // [kTile]
  float* srow = reinterpret_cast<float*>(ent + kTile);  // [tile rows][kChunk]
  tb.clear();
  const int64_t n = static_cast<int64_t>(B) * K;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const TileRows rows(t0, K);
  const int64_t t = t0 + threadIdx.x;
  const int64_t j = t < n ? wrap_index(idx[t], D) : -1;
  FmEntry me;
  me.row = rows.rel(threadIdx.x);
  me.x = t < n ? to_f32(val[t]) : 0.f;
  me.gx = t < n ? g[rows.row0 + me.row] * me.x : 0.f;
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
  auto zero_sums = [&]() {
    for (int u = threadIdx.x; u < kTile * kChunk / 4; u += kTile)
      reinterpret_cast<float4*>(sum)[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  int c0 = blockIdx.y * kChunk;
  issue(c0);
  __syncthreads();  // the table is empty
  bool claimed = false;
  me.pos = j >= 0 ? tb.insert(j, claimed) : -1;
  ent[threadIdx.x] = me;
  zero_sums();
  // lanes over (entry, column): this thread adds column e of entries
  // threadIdx.x / kChunk + q * kStride
  const int e = threadIdx.x % kChunk;
  const int i0 = threadIdx.x / kChunk;
  for (;;) {
    const int ec = min(kChunk, E - c0);  // columns in this chunk
    // the slot's row of gv, fetched into L2 while the copies land, so the
    // flush's reductions find it there
    if (claimed)
      for (int c = 0; c < ec; c += 8) prefetch_l2(gv + j * E + c0 + c);
    wait_async();
    __syncthreads();  // slots claimed, rows landed, entries written, sums zeroed
    // every contribution first, then the atomics: the compiler cannot move
    // a shared load past an atomic on the same memory
    int at[kChunk];
    float add[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int i = i0 + q * kStride;
      const FmEntry en = ent[i];
      at[q] = en.pos >= 0 && e < ec ? tb.slot_at[en.pos] * kChunk + e : -1;
      // x * v rounded as s's own term was (no fused multiply-add), so a row
      // whose s is that one term gets the exact zero gradient
      add[q] = en.gx * (srow[en.row * kChunk + e] - __fmul_rn(en.x, vrow[i * kChunk + e]));
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (at[q] >= 0) atomicAdd(sum + at[q], add[q]);
    __syncthreads();  // sums complete; the staged rows are free
    const int next = c0 + gridDim.y * kChunk;
    if (next < E) issue(next);  // in flight during the flush
    const int slots = *tb.count;
    if constexpr (RED4) {
      for (int u = threadIdx.x; u < slots * (kChunk / 4); u += kTile) {
        const int slot = u / (kChunk / 4), c = 4 * (u % (kChunk / 4));
        if (c < ec)
          atomicAdd(reinterpret_cast<float4*>(gv + tb.key_of[slot] * E + c0 + c),
                    *reinterpret_cast<const float4*>(sum + slot * kChunk + c));
      }
    } else {
      for (int u = threadIdx.x; u < slots * kChunk; u += kTile) {
        const int slot = u / kChunk, c = u % kChunk;
        if (c < ec) atomicAdd(gv + tb.key_of[slot] * E + c0 + c, sum[u]);
      }
    }
    if (next >= E) break;
    __syncthreads();  // the flush has read the sums
    zero_sums();
    c0 = next;
  }
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

template <typename V, int COPY, bool RED4>
cudaError_t launch_fm_pair_bwd_as(const int32_t* idx, const V* val,
                                  const float* v, const float* s,
                                  const float* g, float* gv, int B, int K,
                                  int E, int64_t D, cudaStream_t st) {
  auto kernel = fm_pair_bwd_kernel<V, COPY, RED4>;
  const size_t bytes = fm_pair_bwd_smem(K);
  const cudaError_t rc = allow_smem(kernel, bytes);
  if (rc != cudaSuccess) return rc;
  const int chunks = (E + kChunk - 1) / kChunk;  // a block loops past 65535
  const dim3 grid(tiles_for(B, K), chunks < 65535 ? chunks : 65535);
  kernel<<<grid, kTile, bytes, st>>>(idx, val, v, s, g, gv, B, K, E, D);
  return cudaGetLastError();
}

// 16-byte copies where rows of v and s are a whole number of them, float4
// reductions where gv's rows are.
template <typename V>
cudaError_t launch_fm_pair_bwd(const int32_t* idx, const V* val,
                               const float* v, const float* s, const float* g,
                               float* gv, int B, int K, int E, int64_t D,
                               cudaStream_t st) {
  const bool copy16 = E % 4 == 0 && aligned(v, 16) && aligned(s, 16);
  const bool red4 = E % 4 == 0 && aligned(gv, 16);
  if (copy16 && red4)
    return launch_fm_pair_bwd_as<V, 16, true>(idx, val, v, s, g, gv, B, K, E, D, st);
  if (copy16)
    return launch_fm_pair_bwd_as<V, 16, false>(idx, val, v, s, g, gv, B, K, E, D, st);
  if (red4)
    return launch_fm_pair_bwd_as<V, 4, true>(idx, val, v, s, g, gv, B, K, E, D, st);
  return launch_fm_pair_bwd_as<V, 4, false>(idx, val, v, s, g, gv, B, K, E, D, st);
}

constexpr size_t kMatvecBwdSmem = TileTable::bytes() + kTile * 4;

template <typename V>
cudaError_t launch_ell_matvec_bwd(const int32_t* idx, const V* val,
                                  const float* g, float* gw, int B, int K,
                                  int64_t D, cudaStream_t st) {
  ell_matvec_bwd_kernel<V><<<tiles_for(B, K), kTile, kMatvecBwdSmem, st>>>(
      idx, val, g, gw, B, K, D);
  return cudaGetLastError();
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
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* gf = static_cast<const float*>(g);
  float* o = static_cast<float*>(gw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_f16)
    return static_cast<int>(launch_ell_matvec_bwd(
        ix, static_cast<const __half*>(val), gf, o, B, K, D, st));
  return static_cast<int>(launch_ell_matvec_bwd(
      ix, static_cast<const float*>(val), gf, o, B, K, D, st));
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
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* vf = static_cast<const float*>(v);
  const float* sf = static_cast<const float*>(s);
  const float* gf = static_cast<const float*>(g);
  float* o = static_cast<float*>(gv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (val_f16)
    return static_cast<int>(launch_fm_pair_bwd(
        ix, static_cast<const __half*>(val), vf, sf, gf, o, B, K, E, D, st));
  return static_cast<int>(launch_fm_pair_bwd(
      ix, static_cast<const float*>(val), vf, sf, gf, o, B, K, E, D, st));
}

// Dynamic shared memory of a K2 (fm = 0) or K4 (fm = 1) block at K, in
// bytes.
int scatter_smem_bytes(int fm, int K) {
  return static_cast<int>(fm ? fm_pair_bwd_smem(K) : kMatvecBwdSmem);
}

int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
