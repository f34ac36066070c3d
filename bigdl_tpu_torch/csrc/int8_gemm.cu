// int8 mixed-precision GEMM with the quantized epilogue fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas_int8_gemm.py::_kernel_bias /
// _kernel_nobias (math in _matmul_math, launched by the pl.pallas_call in
// _gemm_fn.run).  It computes, for any M, K, O:
//
//   y[m, o] = acc[m, o] * scale[o] (+ bias[o])          (f32 out, (M, O))
//   weight_only: acc = sum_k f32(x[m, k]) * f32(wq[o, k])  f32 accumulate,
//                x f32 or bf16
//   dynamic:     acc = f32(sum_k x[m, k] * wq[o, k])       int32 accumulate,
//                x already int8 (per-tensor dyn_quantize in the wrapper)
//
// The epilogue is __fmaf_rn(acc, scale, bias): one rounding, which is what XLA
// on the CPU gives the reference (it contracts acc*scale+bias into one FMA).
// In dynamic mode the int32 sum is exact, so the kernel is bitwise-equal to
// the plain version int8_matmul_reference (float64 product + round-to-odd FMA
// emulation).  Build without --use_fast_math: it would break that parity.
//
// What bounds it on an H100 at ResNet-50's shapes.  weight_only runs f32 FMAs
// on the CUDA cores (peak 67 TFLOP/s, ridge about 20 flop/byte at 3.35 TB/s).
// At batch 32 the 3x3 convs and the late-stage 1x1 GEMMs (K >= 256) sit well
// above that ridge and are bound by operations; the K=64 1x1 convs of stage 1
// (M=100,352, K=64, O=64: about 16 flop/byte on the f32 input) sit at or below
// it and are bound by bytes.  dynamic mode issues __dp4a (4 int8 products per
// instruction) against an int8 peak of 1,979 TOP/s on the tensor cores, so its
// bound is the bytes: the f32 output (4 bytes per result) dominates.
//
// Design: one block computes a 64x64 output tile with 256 threads, 4x4 results
// per thread held in registers; K is walked in shared-memory tiles (16 f32
// values, or 64 int8 values packed as 16 words, per row).  Tiles are loaded
// with bounds checks and zero fill, so ragged M, K and O need no padding by
// the caller (the stem's K=147, the FC's O=1000).  This is the simple correct
// kernel; cp.async/TMA pipelining and s8 wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <bool HAS_BIAS>
__device__ __forceinline__ void store_tile(float (&acc)[TM][TN], const float* __restrict__ scale,
                                           const float* __restrict__ bias, float* __restrict__ y,
                                           int row0, int col0, int M, int O) {
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= O) continue;
      const float v = HAS_BIAS ? __fmaf_rn(acc[i][j], scale[c], bias[c])
                               : __fmul_rn(acc[i][j], scale[c]);
      y[(size_t)r * O + c] = v;
    }
  }
}

// weight_only: f32 or bf16 activations against the int8 panel, f32 accumulate.
template <typename XT, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
    gemm_weight_only(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     float* __restrict__ y, int M, int K, int O) {
  constexpr int BK = 16;
  __shared__ float xs[BK][BM + 4];  // k-major, so a thread's 4 rows are adjacent
  __shared__ float ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < M && gk < K) ? load_f32(x + (size_t)gr * K + gk) : 0.f;
    }
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int c = e / BK, kk = e % BK;
      const int gc = col0 + c, gk = k0 + kk;
      ws[kk][c] = (gc < O && gk < K) ? (float)wq[(size_t)gc * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  store_tile<HAS_BIAS>(acc, scale, bias, y, row0, col0, M, O);
}

// Four int8 values of row `row` starting at column k, packed little-endian into
// one word, zero past K.  `aligned` says every row starts on a 4-byte boundary
// (K % 4 == 0 and an aligned base), so a full group is one 32-bit load.
__device__ __forceinline__ int load_s8x4(const int8_t* __restrict__ p, int row, int k, int K,
                                         bool aligned) {
  const int8_t* q = p + (size_t)row * K + k;
  if (aligned && k + 3 < K) return *reinterpret_cast<const int*>(q);
  int v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (k + b < K) v |= (int)(uint8_t)q[b] << (8 * b);
  return v;
}

// dynamic: int8 x int8, int32 accumulate with __dp4a.
template <bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
    gemm_dynamic(const int8_t* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ y, int M, int K, int O, bool aligned) {
  constexpr int BKW = 16;  // packed words per row per tile = 64 int8 values
  __shared__ int xs[BKW][BM + 4];
  __shared__ int ws[BKW][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += 4 * BKW) {
    for (int e = tid; e < BM * BKW; e += THREADS) {
      const int r = e / BKW, w = e % BKW;
      const int gr = row0 + r;
      xs[w][r] = gr < M ? load_s8x4(x, gr, k0 + 4 * w, K, aligned) : 0;
    }
    for (int e = tid; e < BN * BKW; e += THREADS) {
      const int c = e / BKW, w = e % BKW;
      const int gc = col0 + c;
      ws[w][c] = gc < O ? load_s8x4(wq, gc, k0 + 4 * w, K, aligned) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < BKW; ++w) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[w][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[w][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float accf[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accf[i][j] = __int2float_rn(acc[i][j]);
  store_tile<HAS_BIAS>(accf, scale, bias, y, row0, col0, M, O);
}

}  // namespace

// mode: 0 weight_only, 1 dynamic.  x_dtype: 0 f32, 1 bf16, 2 int8.
// Launches on `stream` and returns cudaGetLastError() (0 on success); an
// unsupported mode/dtype pair returns cudaErrorInvalidValue without launching.
extern "C" int bigdl_int8_gemm(int mode, int x_dtype, int has_bias, const void* x, const void* wq,
                               const void* scale, const void* bias, void* y, int M, int K, int O,
                               void* stream) {
  if (M <= 0 || K <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (O + BN - 1) / BN);
  const dim3 block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  if (mode == 0 && x_dtype == 0) {
    const float* xp = static_cast<const float*>(x);
    if (has_bias)
      gemm_weight_only<float, true><<<grid, block, 0, s>>>(xp, w, sc, b, out, M, K, O);
    else
      gemm_weight_only<float, false><<<grid, block, 0, s>>>(xp, w, sc, b, out, M, K, O);
  } else if (mode == 0 && x_dtype == 1) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    if (has_bias)
      gemm_weight_only<__nv_bfloat16, true><<<grid, block, 0, s>>>(xp, w, sc, b, out, M, K, O);
    else
      gemm_weight_only<__nv_bfloat16, false><<<grid, block, 0, s>>>(xp, w, sc, b, out, M, K, O);
  } else if (mode == 1 && x_dtype == 2) {
    const int8_t* xp = static_cast<const int8_t*>(x);
    const bool aligned = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) & 3) == 0) &&
                         ((reinterpret_cast<uintptr_t>(wq) & 3) == 0);
    if (has_bias)
      gemm_dynamic<true><<<grid, block, 0, s>>>(xp, w, sc, b, out, M, K, O, aligned);
    else
      gemm_dynamic<false><<<grid, block, 0, s>>>(xp, w, sc, b, out, M, K, O, aligned);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
