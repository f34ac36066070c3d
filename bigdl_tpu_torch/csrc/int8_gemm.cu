// int8 mixed-precision GEMM with the quantized epilogue fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel bigdl_tpu/ops/pallas_int8_gemm.py::_kernel_bias /
// _kernel_nobias (math in _matmul_math, launched by the pl.pallas_call in
// _gemm_fn.run).  It computes, for any M, K, O:
//
//   y[m, o] = acc[m, o] * scale[o] (+ bias[o])          (f32 out, (M, O))
//   weight_only: acc = sum_k f32(x[m, k]) * f32(wq[o, k])  f32 accumulate,
//                x f32, bf16 or f16
//   dynamic:     acc = f32(sum_k x[m, k] * wq[o, k])       int32 accumulate,
//                x already int8 (per-tensor dyn_quantize in the wrapper)
//
// The epilogue is __fmaf_rn(acc, scale, bias): one rounding, which is what XLA
// on the CPU gives the reference (it contracts acc*scale+bias into one FMA).
// In dynamic mode the int32 sum is exact in any order, so every variant is
// bitwise-equal to the plain version int8_matmul_reference (float64 product +
// round-to-odd FMA emulation).  Build without --use_fast_math: it would break
// that parity.
//
// What bounds it on an H100 at ResNet-50's shapes.  Both modes' products
// belong on the tensor cores.  dynamic mode's are int8 (1,979 TOP/s), where
// every ResNet-50 shape is bound by its bytes: the f32 output (4 bytes per
// result) is most of them, and the operands are re-read from L2 once per
// output tile that needs them.  weight_only's are exact in bf16 (989 TFLOP/s):
// an int8 weight is a bf16 value, and an f32 activation is the exact sum of
// three bf16 terms (below), each of whose products with a weight is exact in
// f32.  Three bf16 passes then bound the large-K shapes, the f32 bytes the
// others; on the CUDA cores' f32 FMAs (67 TFLOP/s) the large-K shapes would be
// bound three times higher.  f16 x needs one pass: an int8 weight is an f16
// value too, and the product of an f16 value and an int8 one is exact in f32.
//
// Design of the two tensor-core variants (gemm_dynamic_wgmma,
// gemm_weight_only_wgmma): one block computes a BM x BN output tile (128x128,
// 128x64 or 64x64; one consumer warpgroup per 64 rows), the host choosing the
// largest tile that still gives the card's 132 SMs a tile each (weight_only
// takes 128x128 once it covers 70% of them).  A producer warp streams K with
// TMA (cp.async.bulk.tensor) into a ring of up to 4 stages guarded by
// mbarriers.  TMA's out-of-bounds zero fill masks ragged M, O and K
// (the FC's M=32 and O=1000, K=64 against a 128-byte box), so the caller pads
// nothing.  The epilogue stages the tile through shared memory (reusing the
// ring) and writes f32 rows with 16-byte stores.  The tensor maps are encoded
// on the host per launch with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__.
//
// dynamic: 128-byte slices of x and wq per stage (128-byte swizzle); the
// consumers run wgmma.mma_async.m64nBNk32.s32.s8.s8 straight from shared
// memory (both operands K-major, as x (M, K) and wq (O, K) already are), the
// int32 sums in registers, one wgmma group in flight while the next stage lands.
//
// weight_only: 64 values of K per stage: x's 64 f32 (two 128-byte-swizzled
// boxes) or 64 bf16 (one), and wq's 64 int8 (plain 64-byte rows).  The
// consumers first upcast the stage's int8 tile once into a bf16 K-major tile
// in the 128-byte swizzle (two such tiles alternate, so one warpgroup's writes
// never meet another's wgmma reads), fence it into the async proxy, and meet
// at a named barrier.  Each thread then reads its A fragments of x from the
// swizzled tile and, for f32, splits every value in registers into three bf16
// terms: hi = x with the low 16 bits of its pattern cleared, r = x - hi,
// mid = r truncated the same way, lo = r - mid truncated the same way.  Every
// step is exact in f32, and lo is exact in bf16 for |x| >= 2^-110 (below that
// the three are off by less than 2^-133, bf16's least subnormal); truncation,
// unlike rounding, cannot carry hi past bf16's largest value near f32's, and
// it is an integer mask, not work for the SM's slow conversion unit, as is the
// int8 upcast (a byte in the mantissa of 2^23, less 2^23).  ops/int8_gemm.py's
// split_bf16x3 is the same arithmetic.  wgmma.m64nBNk16.f32.bf16.bf16 with A
// from registers then runs the three passes (one for bf16 x) against the one
// bf16 weight tile, splitting slice k16+1 while the tensor cores multiply
// slice k16.  The tensor cores' f32 accumulation is not an IEEE add per
// product, so each stage's 12 (or 4) products go into a fresh accumulator that
// is then added into the tile's running sum with IEEE adds, which bounds the
// tensor cores' share of the error to one stage's partial sum.  f16 x takes
// the same path with the weight tile upcast to f16 (the byte added to 1024 +
// 128 in an f16 pattern, less 1152: exact, an f16 subtract, no conversion
// unit) and one wgmma.m64nBNk16.f32.f16.f16 pass a slice.  (Were every
// k16 add truncated, one accumulator over K=4608 would reach the kernel
// check's limit, while the stage sums stay under a tenth of it:
// tests/test_torch_int8_gemm.py emulates both.)
//
// TMA needs 16-byte global row strides and bases.  wq's int8 rows need K % 16
// == 0 (x's f32 or bf16 rows need less), so a K that is not a multiple of 16
// (ResNet-50's stem, K=147; the quantized recurrent cells' projections of
// [x_t, h], K=228) or an unaligned view goes to the mma variants
// (gemm_weight_only_mma, gemm_dynamic_mma).  The C entry point chooses by
// stride and alignment alone and reports its choice.  Their products run on
// the tensor cores too, through warp-level mma.sync (m16n8k16 bf16 or f16,
// m16n8k32 s8), with the wgmma variants' arithmetic: f32 x split into three
// bf16 terms in registers, the int8 panel upcast by the mantissa trick, each
// 64-wide K stage into a fresh accumulator added into the tile's sum with IEEE
// adds in K order; dynamic's int32 sums are exact in any order.  Loads: the
// 1-D bulk copy (cp.async.bulk: the TMA unit without a tensor map, which
// wants only 16-byte aligned spans) of each operand's rows as they lie in
// device memory, one copy for a tile whose rows hold all of K (they are one
// contiguous span), else one a row; fragments are read from those raw rows
// at any alignment and zeroed past K to the next k16 (k32 for dynamic), which
// adds exactly; the panel is repacked (or upcast) into a padded tile for
// ldmatrix.  No operand is copied or padded in device memory.  Per-thread
// cp.async or loads of the same rows measured 2-3x slower on an H100: L1
// serves their misses one after another (PERF.md §6).  What bounds them:
// the cells' GEMMs (M=128) are latency, so a 16x32 tile (128 blocks at
// O=512) takes four groups of four warps, one 64-wide stage each, and group
// 0 adds the stage sums in K order.  The stem (M=401408, O=64) is bound by
// its bytes: 64x64 tiles, as many blocks as the SMs hold, each staging the
// 64x147 panel once and walking M tiles.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is reached at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// dynamic: s8 wgmma fed by TMA.

constexpr int BK8 = 128;      // int8 values of a row per stage: one 128-byte swizzle row
constexpr int MAX_STAGES = 4;
constexpr int SMEM_PER_BLOCK = 113 * 1024;  // so that two blocks share an SM

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.  A wait
// that never ends (a broken pipeline) traps, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t spins = 0;
  do {
    if (++spins == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2D TMA tile (box {BK8, rows} at column k, row `row`) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle
// (8-row atoms of 1024 bytes, so the stride byte offset is 1024; the leading
// byte offset is unused for this layout).  The tile must be 1024-byte aligned.
// Adding 2 (32 bytes >> 4) steps one k32 slice along the row.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[0..31] += A(64x32, smem desc a) * B(64x32, smem desc b)^T, int8 -> int32
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d[0..63] += A(64x32, smem desc a) * B(128x32, smem desc b)^T, int8 -> int32
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tile(int (&d)[N / 2], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_tile<64>(int (&d)[32], uint64_t a, uint64_t b) {
  wgmma_m64n64k32(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(int (&d)[64], uint64_t a, uint64_t b) {
  wgmma_m64n128k32(d, a, b);
}

// Keeps the compiler from moving reads or writes of registers that a wgmma
// uses (accumulators, A fragments) across its asynchronous window.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Bytes of dynamic shared memory a block of this shape asks for.
__host__ __device__ constexpr int wgmma_stage_bytes(int nwg, int bn) {
  return (64 * nwg + bn) * BK8;
}
__host__ __device__ constexpr int wgmma_staging_bytes(int nwg, int bn) {
  return 64 * nwg * (bn + 8) * 4;
}
__host__ __device__ inline int wgmma_area(int nwg, int bn, int stages) {
  const int ring = stages * wgmma_stage_bytes(nwg, bn);
  const int staging = wgmma_staging_bytes(nwg, bn);
  return ring > staging ? ring : staging;
}
__host__ __device__ inline int wgmma_smem_bytes(int nwg, int bn, int stages) {
  return 1024 + wgmma_area(nwg, bn, stages) + 2 * MAX_STAGES * 8;
}

__device__ __forceinline__ void put2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float4 get4(const int* p) {
  const int4 a = *reinterpret_cast<const int4*>(p);
  return make_float4(__int2float_rn(a.x), __int2float_rn(a.y), __int2float_rn(a.z),
                     __int2float_rn(a.w));
}
__device__ __forceinline__ float4 get4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Epilogue of both wgmma kernels, run by the NWG*128 consumer threads once
// every consumer is done with the ring, which becomes the staging tile.  The
// accumulator layout of m64nBN: thread (warp w, lane l) of warpgroup wg holds
// rows 64wg + 16w + l/4 (+8) and columns 8j + 2(l%4) (+1).  The tile goes
// through shared memory, then each thread writes four neighbouring columns of
// rows across the block, y = f32(acc) * scale (+ bias), with 16-byte stores.
template <int NWG, int BN, bool HAS_BIAS, typename AT>
__device__ __forceinline__ void store_wgmma_tile(const AT (&acc)[BN / 2], uint8_t* smem,
                                                 const float* __restrict__ scale,
                                                 const float* __restrict__ bias,
                                                 float* __restrict__ y, int M, int O, int m0,
                                                 int n0, int vec) {
  constexpr int BM = 64 * NWG;
  constexpr int PITCH = BN + 8;  // staging row pitch (32-bit): conflict-free 8-byte stores
  constexpr int CONSUMERS = NWG * 128;
  consumers_sync(CONSUMERS);
  AT* st = reinterpret_cast<AT*>(smem);
  {
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int r = 64 * wg + 16 * (t / 32) + (t % 32) / 4;
    const int c = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      put2(&st[r * PITCH + 8 * j + c], acc[4 * j], acc[4 * j + 1]);
      put2(&st[(r + 8) * PITCH + 8 * j + c], acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  consumers_sync(CONSUMERS);
  constexpr int TPR = BN / 4;
  const int c = (threadIdx.x % TPR) * 4;
  const int gc = n0 + c;
  if (gc >= O) return;
  float sc[4], bi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sc[e] = gc + e < O ? scale[gc + e] : 0.f;
    bi[e] = HAS_BIAS && gc + e < O ? bias[gc + e] : 0.f;
  }
  const bool full_vec = vec && gc + 3 < O;
  for (int r = threadIdx.x / TPR; r < BM; r += CONSUMERS / TPR) {
    const int gr = m0 + r;
    if (gr >= M) break;
    const float4 a = get4(&st[r * PITCH + c]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = HAS_BIAS ? __fmaf_rn(av[e], sc[e], bi[e]) : __fmul_rn(av[e], sc[e]);
    float* out = y + static_cast<size_t>(gr) * O + gc;
    if (full_vec) {
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gc + e < O) out[e] = v[e];
    }
  }
}

// Block: NWG consumer warpgroups (warps 0 .. 4*NWG-1, 64 output rows each),
// then one producer warp.  Grid: one block per output tile, the O tile
// fastest, so neighbouring blocks share an x tile in L2.
template <int NWG, int BN, bool HAS_BIAS>
__global__ void __launch_bounds__(NWG * 128 + 32)
    gemm_dynamic_wgmma(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w, const float* __restrict__ scale,
                       const float* __restrict__ bias, float* __restrict__ y, int M, int K, int O,
                       int stages, int tiles_o, int vec) {
  constexpr int BM = 64 * NWG;
  constexpr int A_BYTES = BM * BK8;
  constexpr int STAGE_BYTES = wgmma_stage_bytes(NWG, BN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + wgmma_area(NWG, BN, stages));
  uint64_t* empty = full + MAX_STAGES;
  const int n0 = (blockIdx.x % tiles_o) * BN;
  const int m0 = (blockIdx.x / tiles_o) * BM;
  const int ktiles = (K + BK8 - 1) / BK8;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer: one thread keeps the ring full
    if (threadIdx.x % 32 == 0) {
      int s = 0, phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);  // out-of-bounds fill counts in full
        uint8_t* a = smem + s * STAGE_BYTES;
        tma_load(a, &map_x, &full[s], kt * BK8, m0);
        tma_load(a + A_BYTES, &map_w, &full[s], kt * BK8, n0);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows 64*wg .. 64*wg+63 of the tile
  const int wg = warp / 4;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint64_t desc_a = sw128_desc(smem + wg * 64 * BK8);
  const uint64_t desc_b = sw128_desc(smem + A_BYTES);
  int s = 0, phase = 0, prev = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&full[s], phase);
    const uint64_t off = static_cast<uint64_t>(s * STAGE_BYTES) >> 4;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK8 / 32; ++kk)
      wgmma_tile<BN>(acc, desc_a + off + 2 * kk, desc_b + off + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's products are done: hand its buffers back
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  store_wgmma_tile<NWG, BN, HAS_BIAS>(acc, smem, scale, bias, y, M, O, m0, n0, vec);
}

// ---------------------------------------------------------------------------
// weight_only: bf16 wgmma over the exact three-way split of f32 activations.

constexpr int WO_BK = 64;  // K values per stage: one 128-byte row of bf16 weights

// d[0..31] (+)= A(64x16, registers a[0..3]) * B(64x16, smem desc b)^T, A and B
// both bf16 or both f16 (TY), f32 accumulate; scale_d == 0 overwrites d
#define WGMMA_RS_M64N64K16(TY)                                                               \
  asm volatile(                                                                             \
      "{\n"                                                                                 \
      ".reg .pred p;\n"                                                                     \
      "setp.ne.b32 p, %37, 0;\n"                                                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"              \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"                                            \
      "}\n"                                                                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
        "+f"(d[31])                                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

// d[0..63] (+)= A(64x16, registers a[0..3]) * B(128x16, smem desc b)^T, as above
#define WGMMA_RS_M64N128K16(TY)                                                              \
  asm volatile(                                                                             \
      "{\n"                                                                                 \
      ".reg .pred p;\n"                                                                     \
      "setp.ne.b32 p, %69, 0;\n"                                                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"              \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"    \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"    \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"                                            \
      "}\n"                                                                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),       \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

// one k16 slice of 16-bit A (registers) and B (smem desc) into d; F16 picks f16
// operands over bf16
template <int N, bool F16>
__device__ __forceinline__ void wgmma_16bit(float (&d)[N / 2], const uint32_t* a, uint64_t b,
                                            int scale_d) {
  if constexpr (N == 64) {
    if constexpr (F16) WGMMA_RS_M64N64K16("f16");
    else WGMMA_RS_M64N64K16("bf16");
  } else {
    static_assert(N == 128, "the tiles are 64 or 128 columns wide");
    if constexpr (F16) WGMMA_RS_M64N128K16("f16");
    else WGMMA_RS_M64N128K16("bf16");
  }
}

// The high halves of two f32 patterns as a bf16x2 (x0 in the low half):
// each value truncated to bf16, exact where it has 8 significant bits.
__device__ __forceinline__ uint32_t high_halves(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

// Two neighbouring f32 values (x0 in the low half, x1 in the high) as three
// bf16x2 terms whose sum is exact (see the head of the file; split_bf16x3 in
// ops/int8_gemm.py is the same arithmetic).  An infinite x is its own hi.
// Only integer and f32 adds: the SM's conversion unit, far slower, is not used.
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const float h0 = __uint_as_float(__float_as_uint(v.x) & 0xffff0000u);
  const float h1 = __uint_as_float(__float_as_uint(v.y) & 0xffff0000u);
  const float r0 = v.x == h0 ? 0.f : __fsub_rn(v.x, h0);
  const float r1 = v.y == h1 ? 0.f : __fsub_rn(v.y, h1);
  const float m0 = __uint_as_float(__float_as_uint(r0) & 0xffff0000u);
  const float m1 = __uint_as_float(__float_as_uint(r1) & 0xffff0000u);
  hi = high_halves(v.x, v.y);
  mid = high_halves(r0, r1);
  lo = high_halves(__fsub_rn(r0, m0), __fsub_rn(r1, m1));
}

// Four int8 values (one word) as two bf16x2, exactly, without the conversion
// unit: each byte with its sign bit flipped (v + 128) becomes the mantissa of
// 2^23, so the f32 2^23 + 128 + v less 2^23 + 128 is v, and v's f32 pattern's
// high half is its bf16.
__device__ __forceinline__ uint2 bf16x4_of_s8(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float MAGIC = 8388736.0f;  // 2^23 + 128
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 | k)), MAGIC);
  return make_uint2(high_halves(f[0], f[1]), high_halves(f[2], f[3]));
}

// Four int8 values (one word) as two f16x2, exactly, without the conversion
// unit: each byte with its sign bit flipped (v + 128) becomes the low byte of
// the mantissa of the f16 1024 (pattern 0x64), and 1024 + 128 + v less 1152
// (0x6480) is v, an f16 subtract of two exact values.
__device__ __forceinline__ uint2 f16x4_of_s8(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t lo, hi;
  asm("sub.rn.f16x2 %0, %1, %2;\n"
      : "=r"(lo)
      : "r"(__byte_perm(u, 0x64u, 0x4140)), "r"(0x64806480u));
  asm("sub.rn.f16x2 %0, %1, %2;\n"
      : "=r"(hi)
      : "r"(__byte_perm(u, 0x64u, 0x4342)), "r"(0x64806480u));
  return make_uint2(lo, hi);
}

// Byte offset of element `col` (of `bytes` bytes each) of row `row` in a tile
// of 128-byte rows in the 128-byte swizzle (16-byte chunks XORed with row % 8;
// the tile is 1024-byte aligned, as TMA and wgmma lay it out).
__device__ __forceinline__ int sw128_offset(int row, int col, int bytes) {
  const int b = col * bytes;
  return row * 128 + ((((b >> 4) ^ row) & 7) << 4) + (b & 15);
}

// Bytes of one stage (x then wq's int8), of one bf16 weight tile, and of the
// block's dynamic shared memory.
template <typename XT>
__host__ __device__ constexpr int wo_stage_bytes(int nwg, int bn) {
  return (64 * nwg * static_cast<int>(sizeof(XT)) + bn) * WO_BK;
}
__host__ __device__ constexpr int wo_wbf_bytes(int bn) { return bn * WO_BK * 2; }
template <typename XT>
__host__ __device__ inline int wo_area(int nwg, int bn, int stages) {
  const int ring = stages * wo_stage_bytes<XT>(nwg, bn) + 2 * wo_wbf_bytes(bn);
  const int staging = wgmma_staging_bytes(nwg, bn);
  return ring > staging ? ring : staging;
}
template <typename XT>
__host__ __device__ inline int wo_smem_bytes(int nwg, int bn, int stages) {
  return 1024 + wo_area<XT>(nwg, bn, stages) + 2 * MAX_STAGES * 8;
}

// A fragments of k16 slice kk of a stage's x tile (BM rows): registers
// (ra, c), (ra + 8, c), (ra, c + 8), (ra + 8, c + 8), c = 16 kk + t2, two
// values each; f32 x split into the hi, mid and lo passes, bf16 or f16 x as
// it is.
template <bool F32, int PASSES, int BM>
__device__ __forceinline__ void load_fragments(const uint8_t* xs, int kk, int ra, int t2,
                                               uint32_t* f) {
  const int rows[4] = {ra, ra + 8, ra, ra + 8};
  if constexpr (F32) {
    const uint8_t* box = xs + (kk >> 1) * BM * 128;  // 32 f32 values a row
    const int c = (kk & 1) * 16 + t2;
    const int cols[4] = {c, c, c + 8, c + 8};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(box + sw128_offset(rows[j], cols[j], 4));
      split3(v, f[j], f[4 + j], f[8 + j]);
    }
  } else {
    const int c = kk * 16 + t2;
    const int cols[4] = {c, c, c + 8, c + 8};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = *reinterpret_cast<const uint32_t*>(xs + sw128_offset(rows[j], cols[j], 2));
  }
}

// Block: NWG consumer warpgroups (64 output rows each), then one producer
// warp; grid as in gemm_dynamic_wgmma.  Per stage the consumers (1) upcast
// wq's int8 tile into the bf16 tile kt % 2, fence it and meet, (2) for each
// k16 slice run the passes into the stage's fresh accumulator while they
// read and split the next slice's A fragments, (3) hand the ring slot back,
// wait, and add the accumulator into the running sum.  Two alternatives
// measured slower on an H100 a batch-32 ResNet-50 forward (PERF.md): the
// next stage's upcast and first split moved under this stage's last slices,
// and A from shared memory, the three terms written as tiles while the stage
// before runs, one commit a stage.
template <typename XT, int NWG, int BN, bool HAS_BIAS>
__global__ void __launch_bounds__(NWG * 128 + 32)
    gemm_weight_only_wgmma(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           float* __restrict__ y, int M, int K, int O, int stages, int tiles_o,
                           int vec) {
  constexpr bool F32 = sizeof(XT) == 4;
  constexpr bool F16 = std::is_same<XT, __half>::value;
  constexpr int PASSES = F32 ? 3 : 1;
  constexpr int BM = 64 * NWG;
  constexpr int X_BYTES = BM * WO_BK * static_cast<int>(sizeof(XT));
  constexpr int STAGE_BYTES = wo_stage_bytes<XT>(NWG, BN);
  constexpr int WBF_BYTES = wo_wbf_bytes(BN);
  constexpr int CONSUMERS = NWG * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* wbf0 = smem + stages * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + wo_area<XT>(NWG, BN, stages));
  uint64_t* empty = full + MAX_STAGES;
  const int n0 = (blockIdx.x % tiles_o) * BN;
  const int m0 = (blockIdx.x / tiles_o) * BM;
  const int ktiles = (K + WO_BK - 1) / WO_BK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer: one thread keeps the ring full
    if (threadIdx.x % 32 == 0) {
      int s = 0, phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);  // out-of-bounds fill counts in full
        uint8_t* a = smem + s * STAGE_BYTES;
        tma_load(a, &map_x, &full[s], kt * WO_BK, m0);  // f32: two 32-value boxes
        if (F32) tma_load(a + BM * 128, &map_x, &full[s], kt * WO_BK + 32, m0);
        tma_load(a + X_BYTES, &map_w, &full[s], kt * WO_BK, n0);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: thread (warp w, lane l) of warpgroup wg holds A's rows ra, rb
  // and columns 2(l%4) (+1), (+8) of each k16 slice
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int ra = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int t2 = 2 * (lane % 4);
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
  // A fragments of two k16 slices, [pass][register]: one slice is split
  // while the tensor cores multiply the other
  uint32_t a0[PASSES * 4], a1[PASSES * 4];
  int s = 0, phase = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&full[s], phase);
    const uint8_t* xs = smem + s * STAGE_BYTES;
    const uint8_t* w8 = xs + X_BYTES;
    uint8_t* wbf = wbf0 + (kt & 1) * WBF_BYTES;
    // wq's int8 rows (64 bytes) -> bf16 (f16 for f16 x) rows (128 bytes,
    // swizzled); every warpgroup is past the wgmmas that last read this tile
    // (two stages ago)
    for (int i = threadIdx.x; i < BN * 8; i += CONSUMERS) {
      const int r = i >> 3, c = i & 7;
      const uint2 v = *reinterpret_cast<const uint2*>(w8 + r * WO_BK + c * 8);
      const uint2 lo = F16 ? f16x4_of_s8(v.x) : bf16x4_of_s8(v.x);
      const uint2 hi = F16 ? f16x4_of_s8(v.y) : bf16x4_of_s8(v.y);
      *reinterpret_cast<uint4*>(wbf + sw128_offset(r, 8 * c, 2)) =
          make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    // the bf16 tile into the async proxy, whole before any warpgroup reads it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync(CONSUMERS);
    const uint64_t desc_b = sw128_desc(wbf);
    load_fragments<F32, PASSES, BM>(xs, 0, ra, t2, a0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t* cur = kk % 2 == 0 ? a0 : a1;
      // hi, mid, lo of slice kk into the stage's fresh accumulator
      fence_acc(a0);
      fence_acc(a1);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
        wgmma_16bit<BN, F16>(acc, cur + 4 * p, desc_b + 2 * kk, kk + p > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (kk < 3) {
        // slice kk-1's products are done: its registers take slice kk+1
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(a0);
        fence_acc(a1);
        load_fragments<F32, PASSES, BM>(xs, kk + 1, ra, t2, kk % 2 == 0 ? a1 : a0);
      }
    }
    // this warpgroup is done reading the stage's x: hand the slot back
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    fence_acc(a0);
    fence_acc(a1);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }

  store_wgmma_tile<NWG, BN, HAS_BIAS>(sum, smem, scale, bias, y, M, O, m0, n0, vec);
}

// ---------------------------------------------------------------------------
// The mma variants: every case TMA cannot describe (module head), on the
// tensor cores through warp-level mma.sync.

constexpr int MMA_THREADS = 128;  // four warps a K group, 16 output rows each
constexpr int MMA_SMEM_CAP = 113 * 1024;      // so that two blocks always share an SM

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row pitches (bytes).  x's rows and wq's rows land as they lie in device
// memory, each row's 16-byte aligned span of nb bytes (its first byte `off`
// = its address % 16 bytes in; at most nb + 30 bytes) in a raw row of
// raw_pitch(nb) bytes.  Fragment reads up to the next k16 or k32 may run
// past a row's span into the next row or region of shared memory; what
// they read there is masked.  The panel then goes to a padded tile of kp
// values a row for ldmatrix, whose eight 16-byte row reads meet no bank
// twice at an odd multiple of 16 bytes: pitch_b16 for weight_only's 16-bit
// upcast, pitch_s8 for dynamic's int8.
__host__ __device__ constexpr int raw_pitch(int nb) { return round_up(nb + 30, 16); }
__host__ __device__ constexpr int pitch_b16(int kp) { return kp * 2 + 16; }
__host__ __device__ constexpr int pitch_s8(int kp) { return round_up(kp, 32) + 16; }

// Shared bytes of a block whose K chunks hold kn values at most: x's raw
// rows, wq's raw rows and the padded panel, then one mbarrier.
template <typename XT>
__host__ __device__ constexpr int wo_mma_smem(int bm, int bn, int kn) {
  return bm * raw_pitch(kn * static_cast<int>(sizeof(XT))) + bn * raw_pitch(kn) +
         bn * pitch_b16(round_up(kn, 16)) + 8;
}
__host__ __device__ constexpr int dyn_mma_smem(int bm, int bn, int kn) {
  return (bm + bn) * raw_pitch(kn) + bn * pitch_s8(round_up(kn, 32)) + 8;
}

// One operand's rows: bytes [c0, c0 + nb) of rows r0 .. r0 + R - 1 (those
// below `rows`) of a row-major matrix of `ld` bytes a row.
struct Rows {
  const uint8_t* src;
  size_t ld;
  int r0, R, rows;
  size_t c0;
  int nb;
};

__device__ __forceinline__ const uint8_t* row_start(const Rows& t, int r) {
  return t.src + static_cast<size_t>(t.r0 + r) * t.ld + t.c0;
}

// Where row r of t landed in its raw rows.  A chunk that is all of K
// (`whole`) makes a tile's rows one contiguous span: one copy, row r at
// ld * r bytes past the first row's first byte.  Otherwise each row is a
// span of its own, `pitch` bytes a raw row.
__device__ __forceinline__ const uint8_t* raw_row(const uint8_t* raw, int pitch, const Rows& t,
                                                  int r, bool whole) {
  return whole ? raw + (reinterpret_cast<uintptr_t>(row_start(t, 0)) & 15) +
                     static_cast<size_t>(r) * t.ld
               : raw + r * pitch + (reinterpret_cast<uintptr_t>(row_start(t, r)) & 15);
}

// One bulk copy (cp.async.bulk: the TMA unit, no tensor map) of the 16-byte
// aligned span of bytes [s, s + n) to dst, completing on bar.
__device__ __forceinline__ void bulk_copy(uint8_t* dst, const uint8_t* s, size_t n, uint64_t* bar) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(s) & ~static_cast<uintptr_t>(15);
  const uint32_t bytes = static_cast<uint32_t>(
      ((reinterpret_cast<uintptr_t>(s) + n + 15) & ~static_cast<uintptr_t>(15)) - lo);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(lo), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t span_of(const uint8_t* s, size_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  return static_cast<uint32_t>(((a + n + 15) & ~static_cast<uintptr_t>(15)) -
                               (a & ~static_cast<uintptr_t>(15)));
}

// Warp 0 copies a's and b's rows (those below `rows`; b may have none) into their raw rows
// (raw_a, raw_b), all completing on `bar`, whose phase lane 0 first arms
// with their bytes: one copy an operand when `whole`, else one a row.  The
// TMA unit takes a bulk copy in some 70-120 cycles, so one a row costs a
// 64-row tile thousands; per-thread cp.async or loads of the same rows wait
// on L1's misses one after another (PERF.md §6).
__device__ __forceinline__ void copy_rows(uint8_t* raw_a, int pitch_a, const Rows& a,
                                          uint8_t* raw_b, int pitch_b, const Rows& b, bool whole,
                                          uint64_t* bar) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int na = min(a.R, a.rows - a.r0), nb = min(b.R, b.rows - b.r0);  // rows to copy
  uint32_t bytes = 0;
  if (whole) {
    if (lane == 0)
      bytes = span_of(row_start(a, 0), static_cast<size_t>(na) * a.ld) +
              (nb > 0 ? span_of(row_start(b, 0), static_cast<size_t>(nb) * b.ld) : 0u);
  } else {
    for (int r = lane; r < na; r += 32) bytes += span_of(row_start(a, r), a.nb);
    for (int r = lane; r < nb; r += 32) bytes += span_of(row_start(b, r), b.nb);
    bytes = __reduce_add_sync(0xffffffffu, bytes);
  }
  if (lane == 0) mbar_expect_tx(bar, bytes);
  __syncwarp();
  // shared memory the generic proxy read before is rewritten by the async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (whole) {
    if (lane == 0) {
      bulk_copy(raw_a, row_start(a, 0), static_cast<size_t>(na) * a.ld, bar);
      if (nb > 0) bulk_copy(raw_b, row_start(b, 0), static_cast<size_t>(nb) * b.ld, bar);
    }
    return;
  }
  for (int r = lane; r < na; r += 32) bulk_copy(raw_a + r * pitch_a, row_start(a, r), a.nb, bar);
  for (int r = lane; r < nb; r += 32) bulk_copy(raw_b + r * pitch_b, row_start(b, r), b.nb, bar);
}

// The 4 bytes at p (any alignment) of a shared raw row.
__device__ __forceinline__ uint32_t raw_word(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
  return __funnelshift_r(w[0], w[1], 8 * static_cast<uint32_t>(a & 3));
}

// The bytes of v below byte n (all of them from n = 4 on, none at n <= 0).
__device__ __forceinline__ uint32_t bytes_below(uint32_t v, int n) {
  return n >= 4 ? v : n <= 0 ? 0u : v & ((1u << (8 * n)) - 1u);
}

// wq's raw rows (row n's first byte off_n in) to the padded panel: 8 values
// a thread a step, zero from value kn (to kp) and in rows past O, as int8
// (dynamic) or upcast to bf16 or f16 (weight_only, UP16 with F16).
template <int BN, bool UP16, bool F16>
__device__ __forceinline__ void panel_from_raw(uint8_t* panel, int pitch, const uint8_t* raw,
                                               int raw_pitch_w, const Rows& w, bool whole, int kn,
                                               int kp) {
  // thread i takes row i % BN of 8-value group i / BN: independent jobs,
  // consecutive threads on consecutive panel rows (an odd multiple of 16
  // bytes apart: no bank met twice by a quarter warp's 16-byte stores)
#pragma unroll 4
  for (int i = threadIdx.x; i < BN * (kp / 8); i += blockDim.x) {
    const int r = i % BN, c = i / BN;
    uint32_t lo = 0, hi = 0;
    if (w.r0 + r < w.rows) {
      const uint8_t* p = raw_row(raw, raw_pitch_w, w, r, whole) + 8 * c;
      lo = bytes_below(raw_word(p), kn - 8 * c);
      hi = bytes_below(raw_word(p + 4), kn - 8 * c - 4);
    }
    if constexpr (UP16) {
      const uint2 a = F16 ? f16x4_of_s8(lo) : bf16x4_of_s8(lo);
      const uint2 b = F16 ? f16x4_of_s8(hi) : bf16x4_of_s8(hi);
      *reinterpret_cast<uint4*>(panel + r * pitch + 16 * c) = make_uint4(a.x, a.y, b.x, b.y);
    } else {
      *reinterpret_cast<uint2*>(panel + r * pitch + 8 * c) = make_uint2(lo, hi);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const uint8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const uint8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// B fragments (b0, b1) of NF n8 fragments from n row nb (K-major rows: wq's
// layout), 32 bytes from byte kb: one ldmatrix.x4 for two fragments (lanes
// 0-7 and 8-15 address the first's two halves, 16-31 the second's), x2 for
// an odd last one.
template <int NF>
__device__ __forceinline__ void load_b(uint32_t (&b)[NF][2], const uint8_t* tile, int pitch,
                                       int nb, int kb) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int f = 0; f + 1 < NF; f += 2) {
    uint32_t t[4];
    ldsm_x4(t, tile + (nb + 8 * f + (lane & 7) + 8 * (lane >> 4)) * pitch + kb +
                   16 * ((lane >> 3) & 1));
    b[f][0] = t[0];
    b[f][1] = t[1];
    b[f + 1][0] = t[2];
    b[f + 1][1] = t[3];
  }
  if constexpr (NF % 2 == 1) {
    uint32_t t[2];
    ldsm_x2(t, tile + (nb + 8 * (NF - 1) + (lane & 7)) * pitch + kb + 16 * ((lane >> 3) & 1));
    b[NF - 1][0] = t[0];
    b[NF - 1][1] = t[1];
  }
}

// d += A(16x16) * B(16x8), bf16 or f16 (F16) operands, f32 accumulate
template <bool F16>
__device__ __forceinline__ void mma_16bit(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  if constexpr (F16)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A(16x32) * B(32x8), int8 operands, int32 accumulate (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The scale (and bias) of a warp's NF n8 fragments' columns from col0:
// thread (lane l) holds columns 2(l%4) (+1) of each, read once a block.
template <int NF, bool HAS_BIAS>
__device__ __forceinline__ void load_scale_bias(float (&sc)[NF][2], float (&bi)[NF][2],
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias, int O, int col0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + 8 * f + 2 * (lane & 3) + e;
      sc[f][e] = c < O ? scale[c] : 0.f;
      bi[f][e] = HAS_BIAS && c < O ? bias[c] : 0.f;
    }
}

// y = acc * scale (+ bias) for a warp's 16 x 8 NF results: thread (lane l)
// holds rows row0 + l/4 (+8) and columns 2(l%4) (+1) of each n8 fragment.
template <int NF, bool HAS_BIAS, typename AT>
__device__ __forceinline__ void store_mma_tile(const AT (&acc)[NF][4], const float (&sc)[NF][2],
                                               const float (&bi)[NF][2], float* __restrict__ y,
                                               int M, int O, int row0, int col0, int vec) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int c = col0 + 8 * f + 2 * (lane & 3);
    if (c >= O) continue;
    const bool two = c + 1 < O;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + (lane >> 2) + 8 * h;
      if (r >= M) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a;
        if constexpr (std::is_same<AT, int>::value) a = __int2float_rn(acc[f][2 * h + e]);
        else a = acc[f][2 * h + e];
        v[e] = HAS_BIAS ? __fmaf_rn(a, sc[f][e], bi[f][e]) : __fmul_rn(a, sc[f][e]);
      }
      float* out = y + static_cast<size_t>(r) * O + c;
      if (vec && two) {
        *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
      } else {
        out[0] = v[0];
        if (two) out[1] = v[1];
      }
    }
  }
}

// A fragment values of a raw x row (`row`: its first value) at k + 2t
// (+1) and k + 8 + 2t (+1) for weight_only, zero from value kn on: f32 as
// two float2, 16-bit as two packed pairs.
__device__ __forceinline__ void f32_pairs(const uint8_t* row, int k, int t2, int kn, float2& lo,
                                          float2& hi) {
  const float* p = reinterpret_cast<const float*>(row);
  lo = make_float2(p[k + t2], p[k + t2 + 1]);
  hi = make_float2(p[k + t2 + 8], p[k + t2 + 9]);
  if (k + 16 > kn) {
    lo.x = k + t2 < kn ? lo.x : 0.f;
    lo.y = k + t2 + 1 < kn ? lo.y : 0.f;
    hi.x = k + t2 + 8 < kn ? hi.x : 0.f;
    hi.y = k + t2 + 9 < kn ? hi.y : 0.f;
  }
}
__device__ __forceinline__ void b16_pairs(const uint8_t* row, int k, int t2, int kn, uint32_t& lo,
                                          uint32_t& hi) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(row);
  uint32_t e[4] = {p[k + t2], p[k + t2 + 1], p[k + t2 + 8], p[k + t2 + 9]};
  if (k + 16 > kn) {
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = k + t2 + (i & 1) + 8 * (i >> 1) < kn ? e[i] : 0u;
  }
  lo = e[0] | e[1] << 16;
  hi = e[2] | e[3] << 16;
}

// The stage sums of K groups 1 .. KS-1 pass to group 0 through xbuf: their
// warps' accumulators, 128 threads a group.
template <int NF, typename AT>
__device__ __forceinline__ void put_partial(AT* xbuf, const AT (&acc)[NF][4]) {
  const int g = threadIdx.x / MMA_THREADS, t = threadIdx.x % MMA_THREADS;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) xbuf[((g - 1) * NF * 4 + f * 4 + e) * MMA_THREADS + t] = acc[f][e];
}
template <int NF, typename AT>
__device__ __forceinline__ AT get_partial(const AT* xbuf, int g, int f, int e) {
  return xbuf[((g - 1) * NF * 4 + f * 4 + e) * MMA_THREADS + threadIdx.x % MMA_THREADS];
}

// weight_only: a BM x BN tile a block of KS groups of four warps, WM of
// them along M (16 rows each) and 4 / WM along N.  Per K chunk (kc values;
// at the cells' and the stem's K, all of K): warp 0 bulk-copies x's and
// wq's rows into raw rows, one wait on the mbarrier; the panel goes from its
// raw rows to a padded tile upcast to bf16 (f16 for f16 x) by the mantissa
// trick, zero past K to the next k16; then every k16 slice: A from x's raw
// rows, zero past K (f32: split into hi, mid and lo in registers), B from
// the panel (ldmatrix), the passes on the tensor cores into the 64-wide
// stage's fresh accumulator, which is added into the tile's sum with IEEE
// adds, in K order.  The KS groups take one stage each of every round of KS
// stages and group 0 adds their sums (KS 4 at the cells' 16x32 tiles: a warp
// of one n8 fragment alone would wait on each stage's chain of dependent
// mma.sync in turn).  With a whole-K panel a block stages the panel once and
// walks M tiles (mma_grid).
template <typename XT, int BM, int BN, int WM, int KS, bool HAS_BIAS>
__global__ void __launch_bounds__(MMA_THREADS * KS)
    gemm_weight_only_mma(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         float* __restrict__ y, int M, int K, int O, int kc, int tiles_o,
                         int vec) {
  constexpr int WN = 4 / WM;
  constexpr int NF = BN / WN / 8;  // n8 fragments a warp
  static_assert(BM == 16 * WM && NF >= 1, "a warp holds 16 rows and 8 columns or more");
  constexpr bool F32 = sizeof(XT) == 4;
  constexpr bool F16 = std::is_same<XT, __half>::value;
  constexpr int PASSES = F32 ? 3 : 1;
  constexpr int XB = sizeof(XT);
  extern __shared__ __align__(16) uint8_t smem_mma[];
  const int kmax = min(kc, K);  // values of a K chunk at most
  const bool whole = kc >= K;   // one chunk: a tile's rows are one span
  const int px = raw_pitch(kmax * XB), pw = raw_pitch(kmax), pb = pitch_b16(round_up(kmax, 16));
  uint8_t* rx = smem_mma;
  uint8_t* rw = rx + BM * px;
  uint8_t* wb = rw + BN * pw;
  float* xbuf = reinterpret_cast<float*>(wb + BN * pb);
  uint64_t* bar = reinterpret_cast<uint64_t*>(xbuf + (KS - 1) * NF * 4 * MMA_THREADS);
  const int n0 = (blockIdx.x % tiles_o) * BN;
  const int mt0 = blockIdx.x / tiles_o, tiles_m = (M + BM - 1) / BM;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int group = threadIdx.x / MMA_THREADS;  // the K group
  const int ra = (warp % WM) * 16 + lane / 4;  // the thread's rows ra, ra + 8 of the tile
  const int na = (warp / WM) * (BN / WN);      // the warp's columns
  const int t2 = 2 * (lane & 3);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float sc[NF][2], bi[NF][2];
  load_scale_bias<NF, HAS_BIAS>(sc, bi, scale, bias, O, n0 + na);
  __syncthreads();

  int phase = 0;
  for (int mt = mt0; mt < tiles_m; mt += gridDim.x / tiles_o) {
    const int m0 = mt * BM;
    float sum[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[f][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kc, phase ^= 1) {
      const int kn = min(kc, K - k0), kp = round_up(kn, 16);
      const bool panel = !whole || mt == mt0;  // a whole-K panel is staged once a block
      if (mt > mt0 || k0 > 0) __syncthreads();  // every warp is done with the last tiles
      const Rows xr = {reinterpret_cast<const uint8_t*>(x), static_cast<size_t>(K) * XB, m0, BM, M,
                       static_cast<size_t>(k0) * XB, kn * XB};
      const Rows wr = {reinterpret_cast<const uint8_t*>(wq), static_cast<size_t>(K), n0,
                       panel ? BN : 0, O, static_cast<size_t>(k0), kn};
      copy_rows(rx, px, xr, rw, pw, wr, whole, bar);
      mbar_wait(bar, phase);
      if (panel) {
        panel_from_raw<BN, true, F16>(wb, pb, rw, pw, wr, whole, kn, kp);
        __syncthreads();
      }
      const uint8_t* row0 = raw_row(rx, px, xr, ra, whole);
      const uint8_t* row1 = raw_row(rx, px, xr, ra + 8, whole);
      // a round of KS stages: group g takes stage s0 + 64 g
      for (int s0 = 0; s0 < kp; s0 += 64 * KS) {
        float acc[NF][4];
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 64; kk += 16) {
          const int k = s0 + 64 * group + kk;
          if (k >= kp) break;
          uint32_t a[PASSES][4];
          if constexpr (F32) {
            float2 v[4];
            f32_pairs(row0, k, t2, kn, v[0], v[2]);
            f32_pairs(row1, k, t2, kn, v[1], v[3]);
#pragma unroll
            for (int j = 0; j < 4; ++j) split3(v[j], a[0][j], a[1][j], a[2][j]);
          } else {
            b16_pairs(row0, k, t2, kn, a[0][0], a[0][2]);
            b16_pairs(row1, k, t2, kn, a[0][1], a[0][3]);
          }
          uint32_t b[NF][2];
          load_b<NF>(b, wb, pb, na, 2 * k);
#pragma unroll
          for (int p = 0; p < PASSES; ++p)
#pragma unroll
            for (int f = 0; f < NF; ++f) mma_16bit<F16>(acc[f], a[p], b[f]);
        }
        if constexpr (KS > 1) {
          if (group > 0) put_partial<NF>(xbuf, acc);
          __syncthreads();
        }
        if (group == 0) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float v = __fadd_rn(sum[f][e], acc[f][e]);
              for (int g = 1; g < KS && s0 + 64 * g < kp; ++g)
                v = __fadd_rn(v, get_partial<NF>(xbuf, g, f, e));
              sum[f][e] = v;
            }
        }
        if constexpr (KS > 1) __syncthreads();
      }
    }
    if (group == 0)
      store_mma_tile<NF, HAS_BIAS>(sum, sc, bi, y, M, O, m0 + ra - lane / 4, n0 + na, vec);
  }
}

// dynamic: the same blocks and copies, int8 x from its raw rows (4 bytes a
// register, zero past K to the next k32), wq's panel from its raw rows to a
// padded int8 tile (ldmatrix), mma.m16n8k32 into int32 sums.
template <int BM, int BN, int WM, int KS, bool HAS_BIAS>
__global__ void __launch_bounds__(MMA_THREADS * KS)
    gemm_dynamic_mma(const int8_t* __restrict__ x, const int8_t* __restrict__ wq,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     float* __restrict__ y, int M, int K, int O, int kc, int tiles_o, int vec) {
  constexpr int WN = 4 / WM;
  constexpr int NF = BN / WN / 8;
  static_assert(BM == 16 * WM && NF >= 1, "a warp holds 16 rows and 8 columns or more");
  extern __shared__ __align__(16) uint8_t smem_mma[];
  const int kmax = min(kc, K);
  const bool whole = kc >= K;
  const int pr = raw_pitch(kmax), p8 = pitch_s8(round_up(kmax, 32));
  uint8_t* rx = smem_mma;
  uint8_t* rw = rx + BM * pr;
  uint8_t* w8 = rw + BN * pr;
  int* xbuf = reinterpret_cast<int*>(w8 + BN * p8);
  uint64_t* bar = reinterpret_cast<uint64_t*>(xbuf + (KS - 1) * NF * 4 * MMA_THREADS);
  const int n0 = (blockIdx.x % tiles_o) * BN;
  const int mt0 = blockIdx.x / tiles_o, tiles_m = (M + BM - 1) / BM;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int group = threadIdx.x / MMA_THREADS;  // the K group: k32 slices group, + KS, ...
  const int ra = (warp % WM) * 16 + lane / 4;
  const int na = (warp / WM) * (BN / WN);
  const int t4 = 4 * (lane & 3);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float sc[NF][2], bi[NF][2];
  load_scale_bias<NF, HAS_BIAS>(sc, bi, scale, bias, O, n0 + na);
  __syncthreads();

  int phase = 0;
  for (int mt = mt0; mt < tiles_m; mt += gridDim.x / tiles_o) {
    const int m0 = mt * BM;
    int acc[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = 0;
    for (int k0 = 0; k0 < K; k0 += kc, phase ^= 1) {
      const int kn = min(kc, K - k0), kp = round_up(kn, 32);
      const bool panel = !whole || mt == mt0;
      if (mt > mt0 || k0 > 0) __syncthreads();
      const Rows xr = {reinterpret_cast<const uint8_t*>(x), static_cast<size_t>(K), m0, BM, M,
                       static_cast<size_t>(k0), kn};
      const Rows wr = {reinterpret_cast<const uint8_t*>(wq), static_cast<size_t>(K), n0,
                       panel ? BN : 0, O, static_cast<size_t>(k0), kn};
      copy_rows(rx, pr, xr, rw, pr, wr, whole, bar);
      mbar_wait(bar, phase);
      if (panel) {
        panel_from_raw<BN, false, false>(w8, p8, rw, pr, wr, whole, kn, kp);
        __syncthreads();
      }
      const uint8_t* row0 = raw_row(rx, pr, xr, ra, whole);
      const uint8_t* row1 = raw_row(rx, pr, xr, ra + 8, whole);
#pragma unroll 2
      for (int k = 32 * group; k < kp; k += 32 * KS) {
        uint32_t a[4] = {raw_word(row0 + k + t4), raw_word(row1 + k + t4),
                         raw_word(row0 + k + t4 + 16), raw_word(row1 + k + t4 + 16)};
        if (k + 32 > kn) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = bytes_below(a[j], kn - (k + t4 + 16 * (j >> 1)));
        }
        uint32_t b[NF][2];
        load_b<NF>(b, w8, p8, na, k);
#pragma unroll
        for (int f = 0; f < NF; ++f) mma_s8(acc[f], a, b[f]);
      }
    }
    if constexpr (KS > 1) {  // int32 sums: exact in any order
      if (group > 0) put_partial<NF>(xbuf, acc);
      __syncthreads();
      if (group == 0)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            for (int g = 1; g < KS; ++g) acc[f][e] += get_partial<NF>(xbuf, g, f, e);
    }
    if (group == 0)
      store_mma_tile<NF, HAS_BIAS>(acc, sc, bi, y, M, O, m0 + ra - lane / 4, n0 + na, vec);
  }
}

}  // namespace

namespace {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is driver API; the runtime hands out its entry point,
// so the library needs no -lcuda.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (rows, K) row-major matrix of `elem`-byte values cut in boxes of
// box_rows x box_k values, zeros out of bounds.
bool encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int rows,
               int K, int box_k, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// int8 rows in 128-byte boxes, 128-byte swizzle (dynamic mode's x and wq)
bool encode_s8(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  return encode_2d(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, K, BK8, box_rows,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Can TMA describe x (M, K) and wq (O, K)?  16-byte row strides and bases;
// wq's int8 rows make that K % 16 == 0 in both modes.
bool tma_ok(const void* x, const void* wq, int K) {
  return K % 16 == 0 && aligned16(x) && aligned16(wq);
}

// cudaFuncSetAttribute is per function and device: done once for each device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned long long& sized) {
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (sized & bit) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) sized |= bit;
  return e;
}

int vec_ok(const float* y, const float* sc, const float* b, int O) {
  return O % 4 == 0 && aligned16(y) && aligned16(sc) && (b == nullptr || aligned16(b));
}

template <int NWG, int BN, bool HAS_BIAS>
int launch_wgmma(const void* x, const void* wq, const float* sc, const float* b, float* y, int M,
                 int K, int O, cudaStream_t s, int* info) {
  constexpr int BM = 64 * NWG;
  const int ktiles = (K + BK8 - 1) / BK8;
  // as deep a ring as K needs and two blocks an SM allow
  int stages = 1;
  while (stages < MAX_STAGES && stages < ktiles &&
         wgmma_smem_bytes(NWG, BN, stages + 1) <= SMEM_PER_BLOCK)
    ++stages;
  const int smem = wgmma_smem_bytes(NWG, BN, stages);
  CUtensorMap map_x, map_w;
  if (!encode_s8(&map_x, x, M, K, BM) || !encode_s8(&map_w, wq, O, K, BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = gemm_dynamic_wgmma<NWG, BN, HAS_BIAS>;
  static unsigned long long sized = 0;
  const cudaError_t e = allow_smem(kernel, SMEM_PER_BLOCK, sized);
  if (e != cudaSuccess) return (int)e;
  const int tiles_o = (O + BN - 1) / BN;
  const int tiles = tiles_o * ((M + BM - 1) / BM);
  kernel<<<tiles, NWG * 128 + 32, smem, s>>>(map_x, map_w, sc, b, y, M, K, O, stages, tiles_o,
                                             vec_ok(y, sc, b, O));
  info[0] = 2;
  info[1] = BM;
  info[2] = BN;
  info[3] = stages;
  info[4] = tiles;
  return (int)cudaGetLastError();
}

// weight_only's shared memory: a block of two warpgroups holds one SM by its
// registers (two f32 accumulators a thread), so it may take most of the SM's
// shared memory; a one-warpgroup block keeps to two blocks an SM
constexpr int WO_SMEM_TWO_WG = 200 * 1024;

template <typename XT, int NWG, int BN, bool HAS_BIAS>
int launch_weight_only(const void* x, const void* wq, const float* sc, const float* b, float* y,
                       int M, int K, int O, cudaStream_t s, int* info) {
  constexpr int BM = 64 * NWG;
  constexpr int CAP = NWG == 2 ? WO_SMEM_TWO_WG : SMEM_PER_BLOCK;
  constexpr bool F32 = sizeof(XT) == 4;
  const int ktiles = (K + WO_BK - 1) / WO_BK;
  int stages = 1;
  while (stages < MAX_STAGES && stages < ktiles &&
         wo_smem_bytes<XT>(NWG, BN, stages + 1) <= CAP)
    ++stages;
  const int smem = wo_smem_bytes<XT>(NWG, BN, stages);
  CUtensorMap map_x, map_w;
  constexpr CUtensorMapDataType X16 = std::is_same<XT, __half>::value
                                          ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const bool ok =
      F32 ? encode_2d(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, 32, BM,
                      CU_TENSOR_MAP_SWIZZLE_128B)
          : encode_2d(&map_x, x, X16, 2, M, K, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok || !encode_2d(&map_w, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, K, WO_BK, BN,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kernel = gemm_weight_only_wgmma<XT, NWG, BN, HAS_BIAS>;
  static unsigned long long sized = 0;
  const cudaError_t e = allow_smem(kernel, CAP, sized);
  if (e != cudaSuccess) return (int)e;
  const int tiles_o = (O + BN - 1) / BN;
  const int tiles = tiles_o * ((M + BM - 1) / BM);
  kernel<<<tiles, NWG * 128 + 32, smem, s>>>(map_x, map_w, sc, b, y, M, K, O, stages, tiles_o,
                                             vec_ok(y, sc, b, O));
  info[0] = 3;
  info[1] = BM;
  info[2] = BN;
  info[3] = stages;
  info[4] = tiles;
  return (int)cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// The tile of a wgmma variant: the largest of 128x128 (0), 128x64 (1) and
// 64x64 (2) (rows x columns) that still gives every SM a block, never wider
// than O or taller than M needs; 64x64 when none does.
int tile_choice(int M, int O) {
  const long tiles_m128 = (M + 127) / 128;
  if (M > 64) {
    if (O > 64 && tiles_m128 * ((O + 127) / 128) >= sm_count()) return 0;
    if (tiles_m128 * ((O + 63) / 64) >= sm_count()) return 1;
  }
  return 2;
}

template <bool HAS_BIAS>
int dispatch_wgmma(const void* x, const void* wq, const float* sc, const float* b, float* y,
                   int M, int K, int O, cudaStream_t s, int* info) {
  switch (tile_choice(M, O)) {
    case 0: return launch_wgmma<2, 128, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
    case 1: return launch_wgmma<2, 64, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
    default: return launch_wgmma<1, 64, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
  }
}

// weight_only's tile: 128x128 whenever its blocks cover at least 70% of the
// SMs (a thread's split of x and its share of the weight upcast cost the same
// for 64 columns as for 128, so 64-column tiles leave the tensor cores
// waiting), else tile_choice's.
int wo_tile_choice(int M, int O) {
  const long tiles = ((M + 127) / 128) * ((O + 127) / 128);
  if (M > 64 && O > 64 && 10 * tiles >= 7 * sm_count()) return 0;
  return tile_choice(M, O);
}

template <typename XT, bool HAS_BIAS>
int dispatch_weight_only(const void* x, const void* wq, const float* sc, const float* b,
                         float* y, int M, int K, int O, cudaStream_t s, int* info) {
  switch (wo_tile_choice(M, O)) {
    case 0: return launch_weight_only<XT, 2, 128, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
    case 1: return launch_weight_only<XT, 2, 64, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
    default: return launch_weight_only<XT, 1, 64, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
  }
}

// The tile of an mma variant: 64x64 (four warps of 16 rows by 64 columns)
// when its blocks give every SM one (the stem), else 16x32 (four K groups of
// four warps of 16 rows by 8), the most blocks (the cells' M=128: 128, 64
// and 32 blocks at O 512, 256 and 128).
bool mma_large_tile(int M, int O) {
  return static_cast<long>((M + 63) / 64) * ((O + 63) / 64) >= sm_count();
}

// The K chunk: all of K up to 512 values, less by 64s until the block's
// shared memory fits MMA_SMEM_CAP (the stem's K=147 and the cells' 228 fit
// whole: one wave of copies, one wait, then every product).
template <typename SmemFn>
int mma_chunk(int K, SmemFn smem) {
  int kc = K < 512 ? round_up(K, 64) : 512;
  while (kc > 64 && smem(kc < K ? kc : K) > MMA_SMEM_CAP) kc -= 64;
  return kc;
}

int vec2_ok(const float* y, int O) {
  return O % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7) == 0;
}

// The grid of an mma variant: every tile, or, when one K chunk holds all
// of K and the tiles outnumber what the SMs hold at once (ResNet-50's stem:
// 6272), that many blocks (a multiple of tiles_o), each walking its
// column's M tiles against a panel it stages once.  (cached_smem, per_sm):
// the caller's cache of the blocks an SM holds.
template <typename Kernel>
int mma_grid(Kernel kernel, int threads, int smem, bool whole, int tiles_o, int tiles_m,
             int& cached_smem, int& per_sm) {
  if (!whole) return tiles_o * tiles_m;
  if (smem != cached_smem) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess ||
        n < 1)
      n = 1;
    per_sm = n;
    cached_smem = smem;
  }
  const long rows = static_cast<long>(per_sm) * sm_count() / tiles_o;
  return tiles_o * static_cast<int>(rows < 1 ? 1 : rows < tiles_m ? rows : tiles_m);
}

// Shared bytes that K groups 1 .. KS-1 pass their stage sums through.
__host__ __device__ constexpr int partial_bytes(int ks, int nf) {
  return (ks - 1) * nf * 4 * MMA_THREADS * 4;
}

template <typename XT, int BM, int BN, int WM, int KS, bool HAS_BIAS>
int launch_weight_only_mma(const void* x, const void* wq, const float* sc, const float* b, float* y,
                           int M, int K, int O, cudaStream_t s, int* info) {
  constexpr int NF = BN / (4 / WM) / 8;
  const auto smem_of = [](int kn) {
    return wo_mma_smem<XT>(BM, BN, kn) + partial_bytes(KS, NF);
  };
  const int kc = mma_chunk(K, smem_of);
  const int smem = smem_of(kc < K ? kc : K);
  auto kernel = gemm_weight_only_mma<XT, BM, BN, WM, KS, HAS_BIAS>;
  static unsigned long long sized = 0;
  const cudaError_t e = allow_smem(kernel, MMA_SMEM_CAP, sized);
  if (e != cudaSuccess) return (int)e;
  const int tiles_o = (O + BN - 1) / BN;
  static int cached_smem = -1, per_sm = 1;
  const int blocks =
      mma_grid(kernel, MMA_THREADS * KS, smem, kc >= K, tiles_o, (M + BM - 1) / BM, cached_smem,
               per_sm);
  kernel<<<blocks, MMA_THREADS * KS, smem, s>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(wq), sc, b, y, M, K, O, kc, tiles_o,
      vec2_ok(y, O));
  info[0] = 0;
  info[1] = BM;
  info[2] = BN;
  info[3] = (K + kc - 1) / kc;
  info[4] = blocks;
  return (int)cudaGetLastError();
}

template <int BM, int BN, int WM, int KS, bool HAS_BIAS>
int launch_dynamic_mma(const void* x, const void* wq, const float* sc, const float* b, float* y,
                       int M, int K, int O, cudaStream_t s, int* info) {
  constexpr int NF = BN / (4 / WM) / 8;
  const auto smem_of = [](int kn) { return dyn_mma_smem(BM, BN, kn) + partial_bytes(KS, NF); };
  const int kc = mma_chunk(K, smem_of);
  const int smem = smem_of(kc < K ? kc : K);
  auto kernel = gemm_dynamic_mma<BM, BN, WM, KS, HAS_BIAS>;
  static unsigned long long sized = 0;
  const cudaError_t e = allow_smem(kernel, MMA_SMEM_CAP, sized);
  if (e != cudaSuccess) return (int)e;
  const int tiles_o = (O + BN - 1) / BN;
  static int cached_smem = -1, per_sm = 1;
  const int blocks =
      mma_grid(kernel, MMA_THREADS * KS, smem, kc >= K, tiles_o, (M + BM - 1) / BM, cached_smem,
               per_sm);
  kernel<<<blocks, MMA_THREADS * KS, smem, s>>>(static_cast<const int8_t*>(x),
                                           static_cast<const int8_t*>(wq), sc, b, y, M, K, O, kc,
                                           tiles_o, vec2_ok(y, O));
  info[0] = 1;
  info[1] = BM;
  info[2] = BN;
  info[3] = (K + kc - 1) / kc;
  info[4] = blocks;
  return (int)cudaGetLastError();
}

template <typename XT, bool HAS_BIAS>
int dispatch_weight_only_mma(const void* x, const void* wq, const float* sc, const float* b,
                             float* y, int M, int K, int O, cudaStream_t s, int* info) {
  if (mma_large_tile(M, O))
    return launch_weight_only_mma<XT, 64, 64, 4, 1, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
  return launch_weight_only_mma<XT, 16, 32, 1, 4, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
}

template <bool HAS_BIAS>
int dispatch_dynamic_mma(const void* x, const void* wq, const float* sc, const float* b, float* y,
                         int M, int K, int O, cudaStream_t s, int* info) {
  if (mma_large_tile(M, O))
    return launch_dynamic_mma<64, 64, 4, 1, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
  return launch_dynamic_mma<16, 32, 1, 4, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
}

// weight_only on x of type XT: the wgmma variant where TMA can describe the
// operands, the mma one otherwise
template <typename XT, bool HAS_BIAS>
int weight_only(const void* x, const void* wq, const float* sc, const float* b, float* y, int M,
                int K, int O, cudaStream_t s, int* info) {
  if (tma_ok(x, wq, K))
    return dispatch_weight_only<XT, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
  return dispatch_weight_only_mma<XT, HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
}

template <bool HAS_BIAS>
int dynamic(const void* x, const void* wq, const float* sc, const float* b, float* y, int M, int K,
            int O, cudaStream_t s, int* info) {
  if (tma_ok(x, wq, K)) return dispatch_wgmma<HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
  return dispatch_dynamic_mma<HAS_BIAS>(x, wq, sc, b, y, M, K, O, s, info);
}

}  // namespace

// mode: 0 weight_only, 1 dynamic.  x_dtype: 0 f32, 1 bf16, 2 int8, 3 f16.
// Launches on `stream` and returns cudaGetLastError() (0 on success); an
// unsupported mode/dtype pair returns cudaErrorInvalidValue without launching.
// info (5 ints) receives the variant that ran: {0 mma weight_only | 1 mma
// dynamic | 2 wgmma dynamic | 3 wgmma weight_only, tile rows, tile columns,
// stages (mma: the K chunks taken through shared memory one after another),
// blocks}.  Either mode takes its wgmma variant whenever TMA can describe the
// operands (K a multiple of 16, 16-byte-aligned bases), its mma one
// otherwise.
extern "C" int bigdl_int8_gemm(int mode, int x_dtype, int has_bias, const void* x, const void* wq,
                               const void* scale, const void* bias, void* y, int M, int K, int O,
                               void* stream, int* info) {
  if (M <= 0 || K <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  if (mode == 1 && x_dtype == 2)
    return has_bias ? dynamic<true>(x, wq, sc, b, out, M, K, O, s, info)
                    : dynamic<false>(x, wq, sc, b, out, M, K, O, s, info);
  if (mode == 0 && x_dtype == 0)
    return has_bias ? weight_only<float, true>(x, wq, sc, b, out, M, K, O, s, info)
                    : weight_only<float, false>(x, wq, sc, b, out, M, K, O, s, info);
  if (mode == 0 && x_dtype == 1)
    return has_bias ? weight_only<__nv_bfloat16, true>(x, wq, sc, b, out, M, K, O, s, info)
                    : weight_only<__nv_bfloat16, false>(x, wq, sc, b, out, M, K, O, s, info);
  if (mode == 0 && x_dtype == 3)
    return has_bias ? weight_only<__half, true>(x, wq, sc, b, out, M, K, O, s, info)
                    : weight_only<__half, false>(x, wq, sc, b, out, M, K, O, s, info);
  return (int)cudaErrorInvalidValue;
}
