// COO embedding-bag / segment-sum (B3), for Hopper (sm_90a).
//
// Replaces the TPU kernel of bigdl_tpu/ops/pallas_embed.py: _bag_kernel, launched by the
// pl.pallas_call in _bag_fn._run_kernel.  For every non-zero k of an unsorted COO stream,
//
//   out[rows[k], :] += f32(values[k]) * f32(table[cols[k], :])
//
// accumulated in f32 and written once in the promoted type of (table, values): bf16 when
// both are bf16, else f32.  Empty rows come out as an exact 0; padding entries
// (row 0, col 0, value 0) add 0 * table[0]; duplicate (row, col) pairs each add.
//
// Order and rounding.  The TPU kernel walks the stream in nnz order on one core and adds
// each entry into a resident f32 accumulator; under the Pallas interpreter on the CPU the
// add and the product contract into one FMA.  Blocks on Hopper run in no order, and float
// atomics would make every run differ, so the caller hands this kernel a row-sorted view
// instead: `perm`, a STABLE sort of `rows` (entries of one row keep their nnz order), and
// `offsets`, the CSR bounds of each row in it (offsets[r] .. offsets[r + 1]).  One thread
// owns one (row, d), walks its row's entries in ascending k and does
// acc = __fmaf_rn(v, t, acc): the reference's terms, order and single rounding, so this
// kernel, its plain version (embedding_bag_coo_reference in ops/embed_bag.py) and the
// Pallas kernel in interpret mode agree bitwise.  No atomics, no memset: every (row, d)
// of the output is written exactly once.  The sort and the offsets are index bookkeeping
// (library calls in the wrapper); every gather, product and sum is here.
//
// The weight gradient is this kernel with the roles of rows and cols swapped
// (d_table[c] += values[k] * g[rows[k]]): one more launch, just as deterministic, and it
// writes every row of the dense (V, D) gradient, zeros included.
//
// Mapping.  Threads walk the output in memory order, d innermost: for Wide&Deep's wide
// table (D = 1) neighbouring threads own neighbouring rows, so no lane idles; for D >= 32
// a warp spans 32 consecutive d of one row and its table reads coalesce.  Any D works,
// ragged edges included.  Index arithmetic is 32-bit unless n_rows * D or V * D reaches
// 2^31, then 64-bit.
//
// What bounds it on an H100.  Bytes: at the census Wide&Deep forward (nnz 65,536 into
// N 8192 rows from a 100,000 x 1 f32 table) the useful traffic is rows, cols and values
// (786 KB), the gathered table rows (262 KB) and the output (33 KB), about 1.08 MB: 0.32 us
// at 3.35 TB/s, against 65,536 FMAs, nothing for the card.  That is below the fixed cost of a
// launch, so at that shape the kernel is bound by latency: each thread walks its 8 entries
// through a chain of dependent loads (perm, then cols and values, then the table row).
// The loop is unrolled so that loads of neighbouring entries are in flight together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// T table type, V values type, O output type, I index type (unsigned or unsigned long long)
template <typename T, typename V, typename O, typename I>
__global__ void bag_kernel(const long long* __restrict__ offsets,
                           const long long* __restrict__ perm, const int* __restrict__ cols,
                           const V* __restrict__ values, const T* __restrict__ table,
                           O* __restrict__ out, I D, I total) {
  const I stride = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const I row = D == 1 ? i : i / D;
    const I d = i - row * D;
    const long long k1 = offsets[row + 1];
    float acc = 0.f;
#pragma unroll 4
    for (long long k = offsets[row]; k < k1; ++k) {
      const long long p = perm[k];
      const float t = to_f32(table[(I)cols[p] * D + d]);
      acc = __fmaf_rn(to_f32(values[p]), t, acc);
    }
    store(out + i, acc);
  }
}

template <typename T, typename V, typename O, typename I>
void run(const void* offsets, const void* perm, const void* cols, const void* values,
         const void* table, void* out, long long D, long long total, cudaStream_t s) {
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 blocks an SM
  bag_kernel<T, V, O, I><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const long long*>(offsets), static_cast<const long long*>(perm),
      static_cast<const int*>(cols), static_cast<const V*>(values),
      static_cast<const T*>(table), static_cast<O*>(out), (I)D, (I)total);
}

template <typename T, typename V, typename O>
cudaError_t launch(const void* offsets, const void* perm, const void* cols, const void* values,
                   const void* table, void* out, long long n_rows, long long n_table,
                   long long D, cudaStream_t s) {
  const long long total = n_rows * D;
  const long long most = total > n_table * D ? total : n_table * D;
  if (most < 0x7fffffffLL)
    run<T, V, O, unsigned>(offsets, perm, cols, values, table, out, D, total, s);
  else
    run<T, V, O, unsigned long long>(offsets, perm, cols, values, table, out, D, total, s);
  return cudaGetLastError();
}

}  // namespace

// table_dtype, values_dtype: 0 f32, 1 bf16; the output is bf16 when both are, else f32.
// offsets: n_rows + 1 int64 CSR bounds into perm; perm: the stable row-sorted order of the
// nnz entries (int64); cols: int32 (nnz,); values: (nnz,); table: (n_table, D) row-major;
// out: (n_rows, D) row-major.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); a bad dtype or size returns cudaErrorInvalidValue without launching.
extern "C" int bigdl_embed_bag(int table_dtype, int values_dtype, const void* offsets,
                               const void* perm, const void* cols, const void* values,
                               const void* table, void* out, long long n_rows,
                               long long n_table, long long D, void* stream) {
  if (n_rows <= 0 || n_table < 0 || D <= 0 || table_dtype < 0 || table_dtype > 1 ||
      values_dtype < 0 || values_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int code = table_dtype * 2 + values_dtype;
  switch (code) {
    case 0: return (int)launch<float, float, float>(offsets, perm, cols, values, table, out,
                                                    n_rows, n_table, D, s);
    case 1: return (int)launch<float, bf16, float>(offsets, perm, cols, values, table, out,
                                                   n_rows, n_table, D, s);
    case 2: return (int)launch<bf16, float, float>(offsets, perm, cols, values, table, out,
                                                   n_rows, n_table, D, s);
    case 3: return (int)launch<bf16, bf16, bf16>(offsets, perm, cols, values, table, out,
                                                 n_rows, n_table, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
