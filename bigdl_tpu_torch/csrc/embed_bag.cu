// COO embedding-bag / segment-sum (B3), for Hopper (sm_90a).
//
// Replaces the TPU kernel of bigdl_tpu/ops/pallas_embed.py: _bag_kernel, launched by the
// pl.pallas_call in _bag_fn._run_kernel.  For every non-zero k of an unsorted COO stream,
//
//   out[rows[k], :] += f32(values[k]) * f32(table[cols[k], :])
//
// accumulated in f32 and written once in the promoted type of (table, values): bf16 when
// both are bf16, f16 when both are f16, else f32 (PyTorch's promotion).  Empty rows come out as an exact 0; padding entries
// (row 0, col 0, value 0) add 0 * table[0]; duplicate (row, col) pairs each add.
//
// Order and rounding.  The TPU kernel walks the stream in nnz order on one core and adds
// each entry into a resident f32 accumulator; under the Pallas interpreter on the CPU the
// add and the product contract into one FMA.  Blocks on Hopper run in no order, and float
// atomics would make every run differ, so the stream is first grouped by row: `perm`, a
// STABLE order of the entries by row (entries of one row keep their nnz order), and
// `offsets`, the CSR bounds of each row in it (offsets[r] .. offsets[r + 1]).  Then one
// thread owns one (row, d), walks its row's entries in ascending k and does
// acc = __fmaf_rn(v, t, acc): the reference's terms, order and single rounding, so this
// kernel, its plain version (embedding_bag_coo_reference in ops/embed_bag.py) and the
// Pallas kernel in interpret mode agree bitwise.  Every (row, d) of the output is written
// exactly once.
//
// The grouping is a two-digit counting sort over the known key range, in three passes of
// integer work, deterministic (integer sums in shared memory only, which are exact), with
// no library call, no memset and no host read-back (so a CUDA graph can capture it).  A key
// k maps to the clamped domain [0, n_keys + 2): below 0 -> 0, k -> k + 1, n_keys and above
// -> n_keys + 1, so out-of-range keys sort to either end and fall outside every bound;
// offsets[r] is where domain value r + 1 starts.  The domain's coarse digit (d >> shift,
// at most 256 buckets) and fine digit (d & (2^shift - 1)) are sorted in turn, each by the
// same stable scheme: every warp takes a contiguous run of entries and counts its digits
// in its own row of shared-memory counters (equal digits of a warp found by one ballot a
// digit bit and counted by their lowest lane); the counters are scanned digit-major,
// warp-minor; each lane's place is its digit's counter plus the lanes below it with the
// same digit.  So nnz order holds across blocks, warps and lanes.
//   1. bag_hist: a block per chunk of the stream (whole tiles of 1024) counts its coarse
//      buckets and writes its row of a chunks x buckets matrix, every bucket of it.
//   2. bag_coarse: a block per chunk sums the matrix's columns (the chunks before it, and
//      all of them), scans the totals into bucket starts and places its chunk in bucket
//      order: (domain key, k) pairs, one 8-byte store each.
//   3. bag_fine: a block per coarse bucket splits the bucket's entries into four runs, one a
//      warp, counts their fine digits (in windows of 1024 when the bucket spans more),
//      scans them into offsets and places the entries into perm.  A bucket of any size
//      works, every entry on one key included.
//   4. bag_walk: the bag sum above.
// Indices are 32-bit where nnz < 2^31 (P = unsigned), else 64-bit.
//
// The weight gradient is this kernel with the roles of rows and cols swapped
// (d_table[c] += values[k] * g[rows[k]]): one more call, just as deterministic, and it
// writes every row of the dense (V, D) gradient, zeros included.
//
// What bounds it on an H100.  Bytes: at the census Wide&Deep forward (nnz 65,536 into
// N 8192 rows from a 100,000 x 1 f32 table) the useful traffic is rows, cols and values
// (786 KB), the gathered table rows (262 KB) and the output (33 KB), about 1.08 MB: 0.32 us
// at 3.35 TB/s, against 65,536 FMAs, nothing for the card.  That is below the fixed cost of
// one launch, let alone four, so the call is bound by launch latency and by each pass's
// chain of dependent loads: the passes keep their counting in shared memory and registers,
// a lane loads all its keys before it counts, and the walk loads a row's entries eight at
// a time (perm, then cols and values, then the table), so a row of up to eight entries
// costs three dependent loads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;                      // warps of a block of passes 1 and 2
constexpr int COARSE_THREADS = WARPS * 32;
constexpr int ITEMS = 4;                      // keys a lane holds in a tile
constexpr int TILE = COARSE_THREADS * ITEMS;  // 1024 entries; a chunk is whole tiles
constexpr int MAX_BUCKETS = 256;              // coarse buckets: 8 bits of the domain
constexpr int FINE_WARPS = 4;
constexpr int FINE_THREADS = FINE_WARPS * 32;
constexpr int FINE_WINDOW = 1024;             // fine digits a sweep of pass 3
constexpr int BATCH = 4;                      // loads a lane has in flight in pass 3
constexpr int WALK = 8;                       // entries of a row the walk loads at once
constexpr unsigned NONE = 0xffffffffu;        // a lane with no entry
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_BUCKETS == COARSE_THREADS, "a thread of passes 1 and 2 owns one bucket");

__device__ __forceinline__ unsigned domain_key(int key, unsigned n_keys) {
  return key < 0 ? 0u : (unsigned)key >= n_keys ? n_keys + 1u : (unsigned)key + 1u;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A coarse-ordered entry: its domain key and its index in the stream, one store.
template <typename P>
struct __align__(2 * sizeof(P)) Entry {
  unsigned d;
  P k;
};

// same[u]: the lanes whose digit f[u] equals this lane's, for digits below 2^bits or NONE:
// one ballot a bit and one for NONE, the N digits of a lane side by side so the ballots
// pipeline (the hardware's match.any costs more as the digits differ more).
template <int N>
__device__ __forceinline__ void peers(const unsigned (&f)[N], unsigned (&same)[N], int bits) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const bool none = f[u] == NONE;
    const unsigned nb = __ballot_sync(FULL, none);
    same[u] = none ? nb : ~nb;
  }
  for (int i = 0; i < bits; ++i) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const bool bit = (f[u] >> i) & 1u;
      const unsigned b = __ballot_sync(FULL, bit);
      same[u] &= bit ? b : ~b;
    }
  }
}

__device__ __forceinline__ int bits_below(unsigned n) {  // bit length of n - 1, n >= 1
  return 32 - __clz(n - 1);
}

// Adds each lane's digit to this warp's own row of counters (no other warp touches it);
// a lane with NONE adds nothing.  Equal digits (`same`, from peers) are counted once, by
// their lowest lane.
template <typename C>
__device__ __forceinline__ void warp_count(C* mine, unsigned f, unsigned same) {
  if (f != NONE && (threadIdx.x & 31) == __ffs(same) - 1) mine[f] += __popc(same);
  __syncwarp();
}

// This lane's place: its digit's counter plus the lanes below it with the same digit;
// then the counter moves past them.  Stable: lanes in order, calls in order.
template <typename C>
__device__ __forceinline__ C warp_place(C* mine, unsigned f, unsigned same) {
  C pos = 0;
  if (f != NONE) pos = mine[f] + __popc(same & lanes_below());
  __syncwarp();
  if (f != NONE && (threadIdx.x & 31) == __ffs(same) - 1) mine[f] += __popc(same);
  __syncwarp();
  return pos;
}

// Exclusive prefix of v over the block's threads in thread order; `sums` holds
// THREADS / 32 values of shared memory.  Every thread must call it.
template <typename P, int THREADS>
__device__ P block_exclusive_scan(P v, P* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  P x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const P y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    P s = lane < THREADS / 32 ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < THREADS / 32; o <<= 1) {
      const P y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < THREADS / 32) sums[lane] = s;
  }
  __syncthreads();
  const P r = x - v + (warp ? sums[warp - 1] : 0);
  __syncthreads();  // sums may be reused at once
  return r;
}

// Lane `lane` of warp `warp` in a tile holds entries tile + warp * 32 * ITEMS + 32 * it +
// lane: each warp a contiguous run of the tile, in order.
template <typename P>
__device__ __forceinline__ void load_tile(const int* __restrict__ keys, P first, P hi,
                                          unsigned n_keys, unsigned (&d)[ITEMS]) {
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const P i = first + 32 * it;
    d[it] = i < hi ? domain_key(__ldg(keys + i), n_keys) : NONE;
  }
}

__device__ __forceinline__ unsigned coarse(unsigned d, int shift) {
  return d == NONE ? NONE : d >> shift;
}

// Pass 1.  A block per chunk of `chunk` entries (whole tiles): its coarse bucket counts,
// written as the chunk's row of hist (chunks x buckets), every bucket of it.
template <typename P>
__global__ void __launch_bounds__(COARSE_THREADS)
    bag_hist(const int* __restrict__ keys, P nnz, unsigned n_keys, int shift, int buckets,
             P chunk, P* __restrict__ hist) {
  __shared__ unsigned wc[WARPS][MAX_BUCKETS];
  const int warp = threadIdx.x >> 5, b = threadIdx.x, cbits = bits_below(buckets);
  for (int w = 0; w < WARPS; ++w) wc[w][b] = 0;
  __syncthreads();
  const P lo = (P)blockIdx.x * chunk, hi = min(lo + chunk, nnz);
  for (P tile = lo; tile < hi; tile += TILE) {
    unsigned d[ITEMS], cb[ITEMS], same[ITEMS];
    load_tile(keys, tile + (P)warp * (32 * ITEMS) + (threadIdx.x & 31), hi, n_keys, d);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) cb[it] = coarse(d[it], shift);
    peers(cb, same, cbits);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) warp_count(wc[warp], cb[it], same[it]);
  }
  __syncthreads();
  if (b < buckets) {
    unsigned n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) n += wc[w][b];
    hist[(P)blockIdx.x * buckets + b] = n;
  }
}

// Pass 2.  A block per chunk.  Thread b sums column b of hist: the chunks before this one
// and all of them; a scan of the totals gives the bucket starts (block 0 writes them, and
// nnz after them, for pass 3).  Then tile by tile each warp places its run in bucket
// order, (domain key, k) entries: per-warp counters scanned across the warps,
// so nnz order holds across chunks, tiles, warps and lanes.
template <typename P>
__global__ void __launch_bounds__(COARSE_THREADS)
    bag_coarse(const int* __restrict__ keys, P nnz, unsigned n_keys, int shift, int buckets,
               P chunk, P chunks, const P* __restrict__ hist, P* __restrict__ bstart,
               Entry<P>* __restrict__ entries) {
  __shared__ unsigned wc[WARPS][MAX_BUCKETS];
  __shared__ P base[MAX_BUCKETS];
  __shared__ P sums[WARPS];
  const int warp = threadIdx.x >> 5, b = threadIdx.x, cbits = bits_below(buckets);
  const bool owner = b < buckets;
  const P lo = (P)blockIdx.x * chunk, hi = min(lo + chunk, nnz);
  const P lane_at = (P)warp * (32 * ITEMS) + (threadIdx.x & 31);
  unsigned d[ITEMS];
  load_tile(keys, lo + lane_at, hi, n_keys, d);  // in flight during the column sums
  P before = 0, total = 0;
  if (owner) {
    P c = 0;
    for (; c + 32 <= chunks; c += 32) {  // 32 loads in flight
      P v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) v[u] = hist[(c + u) * buckets + b];
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        before += c + u < blockIdx.x ? v[u] : 0;
        total += v[u];
      }
    }
    for (; c < chunks; ++c) {
      const P v = hist[c * buckets + b];
      before += c < blockIdx.x ? v : 0;
      total += v;
    }
  }
  const P start = block_exclusive_scan<P, COARSE_THREADS>(total, sums);
  if (owner) {
    base[b] = start + before;
    if (blockIdx.x == 0) bstart[b] = start;
  }
  if (blockIdx.x == 0 && b == 0) bstart[buckets] = nnz;

  for (P tile = lo; tile < hi; tile += TILE) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) wc[w][b] = 0;
    const P first = tile + lane_at;
    if (tile != lo) load_tile(keys, first, hi, n_keys, d);
    unsigned cb[ITEMS], same[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) cb[it] = coarse(d[it], shift);
    peers(cb, same, cbits);
    __syncthreads();  // counters zeroed, bases written
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) warp_count(wc[warp], cb[it], same[it]);
    __syncthreads();
    unsigned run = 0;  // bucket b's counters become exclusive prefixes over the warps
    if (owner) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned v = wc[w][b];
        wc[w][b] = run;
        run += v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const unsigned at = warp_place(wc[warp], cb[it], same[it]);
      if (cb[it] != NONE) entries[base[cb[it]] + at] = Entry<P>{d[it], first + 32 * it};
    }
    __syncthreads();
    if (owner) base[b] += run;
  }
}

// Pass 3.  A block per coarse bucket: its entries lie at bstart[b] .. bstart[b + 1] in
// entries, in nnz order within each domain key; warp w takes the w-th quarter of them.
// The fine digits are counted per warp and scanned (digit-major, warp-minor) in windows of
// FINE_WINDOW; each window writes the offsets of its domain values (offsets[d - 1] for
// d >= 1) and places its entries stably into perm.
template <typename P>
__global__ void __launch_bounds__(FINE_THREADS)
    bag_fine(const Entry<P>* __restrict__ entries, const P* __restrict__ bstart,
             unsigned domain, int shift, P* __restrict__ perm, P* __restrict__ offsets) {
  __shared__ P cnt[FINE_WARPS][FINE_WINDOW];
  __shared__ P sums[FINE_WARPS];
  constexpr int CPT = FINE_WINDOW / FINE_THREADS;  // digits a thread scans: 8
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned d0 = blockIdx.x << shift;
  const unsigned span = min(1u << shift, domain - d0);
  const unsigned mask = (1u << shift) - 1u;
  const P lo = bstart[blockIdx.x], hi = bstart[blockIdx.x + 1];
  const P seg = (hi - lo + FINE_WARPS - 1) / FINE_WARPS;
  const P wlo = min(lo + seg * warp, hi), whi = min(wlo + seg, hi);
  // the warp's first batch of entries, loaded once: most runs fit in it
  Entry<P> held[BATCH];
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const P i = wlo + 32 * u + lane;
    held[u] = i < whi ? entries[i] : Entry<P>{NONE, 0};
  }
  P before = lo;  // where the window's first entry goes
  for (unsigned w0 = 0; w0 < span; w0 += FINE_WINDOW) {
    const unsigned wn = min((unsigned)FINE_WINDOW, span - w0);
    const int fbits = bits_below(wn);
    // the batch at r: its entries' fine digits in this window (NONE outside) and indices
    auto batch = [&](P r, unsigned (&f)[BATCH], P (&src)[BATCH]) {
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const P i = r + 32 * u + lane;
        const Entry<P> e = r == wlo ? held[u] : i < whi ? entries[i] : Entry<P>{NONE, 0};
        const unsigned v = e.d == NONE ? NONE : (e.d & mask) - w0;  // wraps below w0
        f[u] = v < wn ? v : NONE;
        src[u] = e.k;
      }
    };
    for (unsigned f = threadIdx.x; f < wn; f += FINE_THREADS)
#pragma unroll
      for (int w = 0; w < FINE_WARPS; ++w) cnt[w][f] = 0;
    __syncthreads();
    for (P r = wlo; r < whi; r += 32 * BATCH) {
      unsigned f[BATCH], same[BATCH];
      P src[BATCH];
      batch(r, f, src);
      peers(f, same, fbits);
#pragma unroll
      for (int u = 0; u < BATCH; ++u) warp_count(cnt[warp], f[u], same[u]);
    }
    __syncthreads();
    P tot[CPT], own = 0;
    const unsigned f0 = threadIdx.x * CPT;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {  // digit f0 + u: exclusive prefixes over the warps
      P run = 0;
      if (f0 + u < wn) {
#pragma unroll
        for (int w = 0; w < FINE_WARPS; ++w) {
          const P v = cnt[w][f0 + u];
          cnt[w][f0 + u] = run;
          run += v;
        }
      }
      tot[u] = run;
      own += run;
    }
    P at = before + block_exclusive_scan<P, FINE_THREADS>(own, sums);
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      if (f0 + u < wn) {
        const unsigned d = d0 + w0 + f0 + u;
        if (d >= 1) offsets[d - 1] = at;
#pragma unroll
        for (int w = 0; w < FINE_WARPS; ++w) cnt[w][f0 + u] += at;
      }
      at += tot[u];
    }
    if (threadIdx.x == FINE_THREADS - 1) sums[0] = at;  // the window's end
    __syncthreads();
    for (P r = wlo; r < whi; r += 32 * BATCH) {
      unsigned f[BATCH], same[BATCH];
      P src[BATCH];
      batch(r, f, src);
      peers(f, same, fbits);
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const P pos = warp_place(cnt[warp], f[u], same[u]);
        if (f[u] != NONE) perm[pos] = src[u];
      }
    }
    before = sums[0];
    __syncthreads();
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

// Pass 4.  T table type, V values type, O output type, I index type of the output and
// table (unsigned or unsigned long long), P index type of perm and offsets.
template <typename T, typename V, typename O, typename I, typename P>
__global__ void bag_walk(const P* __restrict__ offsets, const P* __restrict__ perm,
                         const int* __restrict__ cols, const V* __restrict__ values,
                         const T* __restrict__ table, O* __restrict__ out, I D, I total) {
  const I stride = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const I row = D == 1 ? i : i / D;
    const I d = i - row * D;
    const P k1 = offsets[row + 1];
    float acc = 0.f;
    for (P k = offsets[row]; k < k1; k += WALK) {  // three dependent loads a group
      P p[WALK];
      float v[WALK], t[WALK];
#pragma unroll
      for (int j = 0; j < WALK; ++j) p[j] = k + j < k1 ? perm[k + j] : 0;
#pragma unroll
      for (int j = 0; j < WALK; ++j) {
        v[j] = k + j < k1 ? to_f32(values[p[j]]) : 0.f;
        t[j] = k + j < k1 ? to_f32(table[(I)cols[p[j]] * D + d]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < WALK; ++j)
        if (k + j < k1) acc = __fmaf_rn(v[j], t[j], acc);  // in k order
    }
    store(out + i, acc);
  }
}

template <typename T, typename V, typename O, typename I, typename P>
void run_walk(const void* offsets, const void* perm, const void* cols, const void* values,
              const void* table, void* out, long long D, long long total, cudaStream_t s) {
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 blocks an SM
  bag_walk<T, V, O, I, P><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const P*>(offsets), static_cast<const P*>(perm),
      static_cast<const int*>(cols), static_cast<const V*>(values),
      static_cast<const T*>(table), static_cast<O*>(out), (I)D, (I)total);
}

template <typename T, typename V, typename O, typename P>
cudaError_t launch_walk(const void* offsets, const void* perm, const void* cols,
                        const void* values, const void* table, void* out, long long n_rows,
                        long long n_table, long long D, cudaStream_t s) {
  const long long total = n_rows * D;
  const long long most = total > n_table * D ? total : n_table * D;
  if (most < 0x7fffffffLL)
    run_walk<T, V, O, unsigned, P>(offsets, perm, cols, values, table, out, D, total, s);
  else
    run_walk<T, V, O, unsigned long long, P>(offsets, perm, cols, values, table, out, D,
                                             total, s);
  return cudaGetLastError();
}

template <typename T, typename V, typename O>
cudaError_t walk(int wide, const void* offsets, const void* perm, const void* cols,
                 const void* values, const void* table, void* out, long long n_rows,
                 long long n_table, long long D, cudaStream_t s) {
  if (wide)
    return launch_walk<T, V, O, unsigned long long>(offsets, perm, cols, values, table, out,
                                                    n_rows, n_table, D, s);
  return launch_walk<T, V, O, unsigned>(offsets, perm, cols, values, table, out, n_rows,
                                        n_table, D, s);
}

// the walk for table type T and values type V: the output is T when both are one
// type, else f32
template <typename T, typename V>
cudaError_t walk_promoted(int wide, const void* offsets, const void* perm, const void* cols,
                          const void* values, const void* table, void* out, long long n_rows,
                          long long n_table, long long D, cudaStream_t s) {
  using O = typename std::conditional<std::is_same<T, V>::value, T, float>::type;
  return walk<T, V, O>(wide, offsets, perm, cols, values, table, out, n_rows, n_table, D, s);
}

// values dtype code: 0 f32, 1 bf16, 2 f16
template <typename T>
cudaError_t walk_values(int values_dtype, int wide, const void* offsets, const void* perm,
                        const void* cols, const void* values, const void* table, void* out,
                        long long n_rows, long long n_table, long long D, cudaStream_t s) {
  switch (values_dtype) {
    case 0: return walk_promoted<T, float>(wide, offsets, perm, cols, values, table, out,
                                           n_rows, n_table, D, s);
    case 1: return walk_promoted<T, __nv_bfloat16>(wide, offsets, perm, cols, values, table,
                                                   out, n_rows, n_table, D, s);
    default: return walk_promoted<T, __half>(wide, offsets, perm, cols, values, table, out,
                                             n_rows, n_table, D, s);
  }
}

long long align256(long long n) { return (n + 255) / 256 * 256; }

// The scratch regions of passes 1-3, in bytes, in this order: hist (chunks x buckets),
// bstart (buckets + 1), the coarse-ordered entries (nnz of 2 * es bytes); each starts on a
// 256-byte boundary.  ops/embed_bag.py's group_plan sizes the buffer the same way.
long long scratch_layout(long long nnz, long long buckets, long long chunks, int es,
                         long long at[3]) {
  const long long sizes[3] = {chunks * buckets * es, (buckets + 1) * es, nnz * 2 * es};
  long long n = 0;
  for (int r = 0; r < 3; ++r) {
    at[r] = n;
    n += align256(sizes[r]);
  }
  return n;
}

template <typename P>
cudaError_t group(const int* keys, long long nnz, long long n_keys, int shift, int buckets,
                  long long chunk, long long chunks, unsigned char* scratch, P* perm,
                  P* offsets, cudaStream_t s) {
  long long at[3];
  scratch_layout(nnz, buckets, chunks, sizeof(P), at);
  P* hist = reinterpret_cast<P*>(scratch + at[0]);
  P* bstart = reinterpret_cast<P*>(scratch + at[1]);
  Entry<P>* entries = reinterpret_cast<Entry<P>*>(scratch + at[2]);
  bag_hist<P><<<(unsigned)chunks, COARSE_THREADS, 0, s>>>(keys, (P)nnz, (unsigned)n_keys, shift,
                                                          buckets, (P)chunk, hist);
  bag_coarse<P><<<(unsigned)chunks, COARSE_THREADS, 0, s>>>(
      keys, (P)nnz, (unsigned)n_keys, shift, buckets, (P)chunk, (P)chunks, hist, bstart,
      entries);
  bag_fine<P><<<(unsigned)buckets, FINE_THREADS, 0, s>>>(entries, bstart,
                                                        (unsigned)(n_keys + 2), shift, perm,
                                                        offsets);
  return cudaGetLastError();
}

}  // namespace

// Passes 1-3: perm (nnz) and offsets (n_keys + 1), int32 (wide = 0) or int64 (wide = 1),
// from the int32 keys: a stable sort of the keys clamped to [-1, n_keys] and the CSR
// bounds of 0 .. n_keys in it (over those bounds, a stable sort of the raw keys).  shift, buckets, chunk and chunks are the plan of
// ops/embed_bag.py (group_plan); scratch holds scratch_bytes from it.  Launches three
// kernels on `stream` and returns cudaGetLastError() (0 on success); a plan that does not
// fit the shapes returns cudaErrorInvalidValue without launching.
extern "C" int bigdl_embed_bag_group(int wide, const void* keys, long long nnz,
                                     long long n_keys, int shift, int buckets, long long chunk,
                                     long long chunks, void* scratch, long long scratch_bytes,
                                     void* perm, void* offsets, void* stream) {
  long long at[3];
  const int es = wide ? 8 : 4;
  if (nnz < 0 || n_keys < 1 || n_keys > 0x80000000LL || (!wide && nnz >= 0x80000000LL) ||
      shift < 0 || shift > 24 || buckets < 1 || buckets > MAX_BUCKETS ||
      (long long)(buckets - 1) << shift > n_keys + 1 ||
      ((long long)buckets << shift) < n_keys + 2 || chunk < TILE || chunk % TILE ||
      chunks < 1 || chunks * chunk < nnz || (chunks - 1) * chunk >= (nnz > 0 ? nnz : 1) ||
      scratch_layout(nnz, buckets, chunks, es, at) > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(keys);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  if (wide)
    return (int)group<unsigned long long>(k, nnz, n_keys, shift, buckets, chunk, chunks, sc,
                                          static_cast<unsigned long long*>(perm),
                                          static_cast<unsigned long long*>(offsets), s);
  return (int)group<unsigned>(k, nnz, n_keys, shift, buckets, chunk, chunks, sc,
                              static_cast<unsigned*>(perm), static_cast<unsigned*>(offsets), s);
}

// Pass 4.  table_dtype, values_dtype: 0 f32, 1 bf16, 2 f16; the output is of their
// type when they are one, else f32.  offsets: n_rows + 1 CSR bounds into perm; perm: the stable row-sorted order of
// the nnz entries; both int32 (wide = 0) or int64 (wide = 1), from bigdl_embed_bag_group;
// cols: int32 (nnz,); values: (nnz,); table: (n_table, D) row-major; out: (n_rows, D)
// row-major.  Launches on `stream` and returns cudaGetLastError() (0 on success); a bad
// dtype or size returns cudaErrorInvalidValue without launching.
extern "C" int bigdl_embed_bag(int table_dtype, int values_dtype, int wide, const void* offsets,
                               const void* perm, const void* cols, const void* values,
                               const void* table, void* out, long long n_rows,
                               long long n_table, long long D, void* stream) {
  if (n_rows <= 0 || n_table < 0 || D <= 0 || table_dtype < 0 || table_dtype > 2 ||
      values_dtype < 0 || values_dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case 0: return (int)walk_values<float>(values_dtype, wide, offsets, perm, cols, values,
                                           table, out, n_rows, n_table, D, s);
    case 1: return (int)walk_values<__nv_bfloat16>(values_dtype, wide, offsets, perm, cols,
                                                   values, table, out, n_rows, n_table, D, s);
    default: return (int)walk_values<__half>(values_dtype, wide, offsets, perm, cols, values,
                                             table, out, n_rows, n_table, D, s);
  }
}
