// Max-pool input gradient, first-match (B1), for Hopper (sm_90a).
//
// Replaces the TPU kernel of bigdl_tpu/ops/pallas_pool.py: _bwd_kernel, launched by the
// pl.pallas_call in maxpool_bwd_nhwc.  Each output window o sends g[o] to the FIRST
// position, in row-major (dh, dw) order over the window's real (unpadded) positions, whose
// value equals y[o] (compared in f32).  Windows that overlap add up into gi in the dtype
// of x, one (dh, dw) offset after another: for an input position p the contributions of
// the windows covering it are added in (dh, dw) order, where dh, dw is p's offset inside
// each window.  That is the reference's order exactly, so the plain version
// (maxpool_bwd_reference in ops/maxpool.py) and both variants here agree bitwise.
//
// What bounds it on an H100.  Its least time is set by bytes: it reads x, y and g once and
// writes gi once, about one comparison per covered position, far below the card's ridge.
// At ResNet-50's stem at batch 256 (x 256x112x112x64, 3x3/2 pad 1) that is 2.06 GB in
// f32, 0.61 ms at 3.35 TB/s, and half in bf16.  Per-element work (index arithmetic,
// offset compares, the ordered adds of one 2- or 4-byte element a thread) held the first,
// two-pass form to several times that, as slow in bf16 as in f32.
//
// Variant tiled_nhwc (maxpool_bwd_tiled), for channels-innermost tensors whose channel rows split
// into 16-byte vectors (C * element size a multiple of 16, every stride but the channels' a
// multiple of the vector, 16-byte-aligned bases, 32-bit offsets) and windows of fewer than 255
// positions.  One launch, no global scratch: a block owns an 8x16 (rows x columns) spatial tile of
// gi for a slice of up to 16 channel vectors (a power of two) of one image, and each thread works
// on whole 16-byte vectors (8 bf16 or f16, or 4 f32 channels), so the index arithmetic is paid once
// a vector.  The block (1) stages into shared memory, with 16-byte loads (eight in flight a thread,
// each thread's first window vectors of y and g asked for before them), the x rows under every
// window that covers the tile (a halo window on each side, recomputed by the neighbouring block),
// (2) finds each such window's first match per channel once, into shared memory as a byte (255
// where nothing matches, as for a NaN maximum), beside the window's g vector, then (3) writes each
// gi vector of its tile once, adding the covering windows' g in (dh, dw) order and rounding to x's
// dtype after each add: four channels' bytes are compared at once (__vcmpeq4) and turned into masks
// of g, and bf16 (f16) sums are kept as pairs added with add.rn.bf16x2 (add.rn.f16x2), which rounds
// as the f32 add followed by the round to bf16 (f16) does. Shared-memory pitches follow the
// launch's capacity, so task indices split by shifts and precomputed divisors.  At the stem the
// 8x16 tile measured fastest of 8x8, 16x8, 8x16 and 16x16 on an H100 (probes/b1_tiles.py).
//
// Variant two_pass (first_match + scatter_first): every other geometry (NCHW, ragged C,
// unaligned views, 64-bit offsets, windows of 255 positions or more).  No atomics, no
// memset, each output written once.
//   1. One thread per window o: scans the window's real offsets in row-major order and
//      stores the first whose x equals y[o] as a small integer (dh*kw + dw; uint8 when
//      kh*kw < 255, else int32; the sentinel "none" only where y[o] matches nothing).
//   2. One thread per element of gi: visits the windows that cover its position, dh
//      ascending (oh descending) then dw ascending, and adds g[o] where the window's
//      first match is its own offset, else 0, rounding to x's dtype after each add.
// For the 3x3 windows of stride 2 or more that ResNet's stem pools with, both passes are
// unrolled at compile time; both stride over their elements with a grid sized to the
// card.  Each tensor comes with its own four strides (n, c, h, w), so both layouts and any
// view work.  Ragged C, any H and W, ceil mode, lo/hi padding and strides larger or
// smaller than the window need no gate: the window ranges are clipped per thread.  Index
// arithmetic is 32-bit, with divisions by precomputed multipliers, whenever the launch's
// indices and offsets fit.
//
// The C entry points choose the variant by layout, alignment and window size alone and
// report it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a divisor with its precomputed multiplier: n / d as one 32x32 high multiply and a
// shift, exact for n < 2^31 (the form of CUTLASS's FastDivmod)
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv make_div(long long d) {
  FastDiv f{(unsigned)d, 0u, 0u};
  if (d > 1) {
    int p = 31;
    while ((1LL << (p - 31)) < d) ++p;  // 31 + ceil(log2 d)
    f.mul = (unsigned)(((1ULL << p) + (unsigned long long)d - 1) / (unsigned long long)d);
    f.shr = (unsigned)(p - 32);
  }
  return f;
}

// I is the index type: 32 bits (with the fast divisions) when every index and offset of
// the launch is below 2^31, else 64 bits
__device__ __forceinline__ unsigned div_by(unsigned n, const FastDiv& f) {
  return f.d == 1 ? n : (__umulhi(n, f.mul) >> f.shr);
}
__device__ __forceinline__ unsigned long long div_by(unsigned long long n, const FastDiv& f) {
  return n / f.d;
}

struct Geom {
  long long N, C, H, W, OH, OW;
  int kh, kw, sh, sw, ph, pw;
  long long xs[4], ys[4], gs[4], gis[4];  // strides (n, c, h, w) of x, y, g, gi
  FastDiv C_, H_, W_, OH_, OW_;
  int channels_last;                      // thread order: c innermost, else w
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
// one add rounded to T, as PyTorch adds two tensors of T
__device__ __forceinline__ float add_in(float acc, float v, float*) { return acc + v; }
__device__ __forceinline__ float add_in(float acc, float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(acc + v));
}
__device__ __forceinline__ float add_in(float acc, float v, __half*) {
  return __half2float(__float2half_rn(acc + v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

// linear index -> (n, c, h, w) of an (N, C, H, W) grid walked in memory order
template <typename I>
__device__ __forceinline__ void decompose(I i, const FastDiv& C, const FastDiv& H,
                                          const FastDiv& W, bool channels_last, I& n, I& c,
                                          I& h, I& w) {
  I t, u;
  if (channels_last) {
    t = div_by(i, C); c = i - t * C.d;
    u = div_by(t, W); w = t - u * W.d;
    n = div_by(u, H); h = u - n * H.d;
  } else {
    t = div_by(i, W); w = i - t * W.d;
    u = div_by(t, H); h = t - u * H.d;
    n = div_by(u, C); c = u - n * C.d;
  }
}

// pass 1: the first-match offset of every window; Idx is the offset type.  KH, KW > 0
// fix the window at compile time: its loads are then issued together, not one after the
// other's compare.
template <typename T, typename I, typename Idx, int KH, int KW>
__device__ __forceinline__ void first_match_one(const T* __restrict__ x,
                                                const T* __restrict__ y,
                                                Idx* __restrict__ idx, const Geom& q, I i) {
  I n, c, oh, ow;
  decompose<I>(i, q.C_, q.OH_, q.OW_, q.channels_last, n, c, oh, ow);
  const T* xb = x + (n * (I)q.xs[0] + c * (I)q.xs[1]);
  const float yv = to_f32(y[n * (I)q.ys[0] + c * (I)q.ys[1] + oh * (I)q.ys[2] +
                            ow * (I)q.ys[3]]);
  const int h0 = (int)oh * q.sh - q.ph, w0 = (int)ow * q.sw - q.pw;
  const int dh0 = max(0, -h0), dh1 = min(q.kh, (int)q.H - h0);
  const int dw0 = max(0, -w0), dw1 = min(q.kw, (int)q.W - w0);
  Idx found = (Idx)-1;
  if constexpr (KH > 0) {
    bool hit[KH * KW];
#pragma unroll
    for (int dh = 0; dh < KH; ++dh) {
#pragma unroll
      for (int dw = 0; dw < KW; ++dw) {
        const bool real = dh >= dh0 && dh < dh1 && dw >= dw0 && dw < dw1;
        hit[dh * KW + dw] =
            real && to_f32(xb[(I)(h0 + dh) * (I)q.xs[2] + (I)(w0 + dw) * (I)q.xs[3]]) == yv;
      }
    }
#pragma unroll
    for (int o = KH * KW - 1; o >= 0; --o) {
      if (hit[o]) found = (Idx)o;
    }
  } else {
    for (int dh = dh0; dh < dh1; ++dh) {
      const T* xr = xb + (I)(h0 + dh) * (I)q.xs[2];
      for (int dw = dw0; dw < dw1; ++dw) {
        if (to_f32(xr[(I)(w0 + dw) * (I)q.xs[3]]) == yv) {
          found = (Idx)(dh * q.kw + dw);
          dh = dh1;  // leave both loops
          break;
        }
      }
    }
  }
  idx[i] = found;
}

// the kernels stride over their elements with a grid sized to the card: one thread an
// element, each block living for one element, spent more time being scheduled than working
template <typename T, typename I, typename Idx, int KH, int KW>
__global__ void __launch_bounds__(256)
    first_match(const T* __restrict__ x, const T* __restrict__ y, Idx* __restrict__ idx,
                Geom q, I total) {
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (I)gridDim.x * blockDim.x)
    first_match_one<T, I, Idx, KH, KW>(x, y, idx, q, i);
}

// pass 2: every element of gi from the windows that cover it.  WH, WW > 0 bound the
// windows that cover a position along each axis (ceil(k/s)) at compile time: the offset
// and gradient loads of all of them are then issued together, and only the adds run in
// order; the sum is the same.
template <typename T, typename I, typename Idx, int WH, int WW>
__device__ __forceinline__ void scatter_first_one(const T* __restrict__ g,
                                                  const Idx* __restrict__ idx,
                                                  T* __restrict__ gi, const Geom& q, I i) {
  I n, c, h, w;
  decompose<I>(i, q.C_, q.H_, q.W_, q.channels_last, n, c, h, w);
  const T* gb = g + (n * (I)q.gs[0] + c * (I)q.gs[1]);
  // offsets of window (oh, ow) of this (n, c), in the order pass 1 wrote them
  const I OH = (I)q.OH, OW = (I)q.OW, C = (I)q.C;
  const Idx* ib = idx + (q.channels_last ? n * OH * OW * C + c : (n * C + c) * OH * OW);
  const I i_oh = q.channels_last ? OW * C : OW;
  const I i_ow = q.channels_last ? C : (I)1;

  // padded coordinates of this position; window o covers it at offset p - o*s
  const int hp = (int)h + q.ph, wp = (int)w + q.pw;
  const int oh_hi = min(hp / q.sh, (int)q.OH - 1);
  const int oh_lo = hp - q.kh + 1 <= 0 ? 0 : (hp - q.kh + 1 + q.sh - 1) / q.sh;
  const int ow_hi = min(wp / q.sw, (int)q.OW - 1);
  const int ow_lo = wp - q.kw + 1 <= 0 ? 0 : (wp - q.kw + 1 + q.sw - 1) / q.sw;

  float acc = 0.0f;
  if constexpr (WH > 0) {
    // window (oh_hi - a, ow_hi - b): a, b ascending is dh, dw ascending
    bool mine[WH * WW];
#pragma unroll
    for (int a = 0; a < WH; ++a) {
#pragma unroll
      for (int b = 0; b < WW; ++b) {
        const int oh = oh_hi - a, ow = ow_hi - b;
        const int off = (hp - oh * q.sh) * q.kw + (wp - ow * q.sw);
        mine[a * WW + b] = oh >= oh_lo && ow >= ow_lo &&
                           (int)ib[(I)oh * i_oh + (I)ow * i_ow] == off;
      }
    }
    float gv[WH * WW];
#pragma unroll
    for (int a = 0; a < WH; ++a) {
#pragma unroll
      for (int b = 0; b < WW; ++b) {
        gv[a * WW + b] = mine[a * WW + b]
                             ? to_f32(gb[(I)(oh_hi - a) * (I)q.gs[2] + (I)(ow_hi - b) * (I)q.gs[3]])
                             : 0.0f;
      }
    }
    // adding 0 for a window that does not cover the position leaves acc as it is
#pragma unroll
    for (int o = 0; o < WH * WW; ++o) acc = add_in(acc, gv[o], (T*)nullptr);
  } else {
    for (int oh = oh_hi; oh >= oh_lo; --oh) {      // dh ascending
      const int dh = hp - oh * q.sh;
      for (int ow = ow_hi; ow >= ow_lo; --ow) {    // dw ascending
        const int dw = wp - ow * q.sw;
        const bool mine = (int)ib[(I)oh * i_oh + (I)ow * i_ow] == dh * q.kw + dw;
        const float gv = mine ? to_f32(gb[(I)oh * (I)q.gs[2] + (I)ow * (I)q.gs[3]]) : 0.0f;
        acc = add_in(acc, gv, (T*)nullptr);
      }
    }
  }
  store(gi + (n * (I)q.gis[0] + c * (I)q.gis[1] + h * (I)q.gis[2] + w * (I)q.gis[3]), acc);
}

template <typename T, typename I, typename Idx, int WH, int WW>
__global__ void __launch_bounds__(256)
    scatter_first(const T* __restrict__ g, const Idx* __restrict__ idx, T* __restrict__ gi,
                  Geom q, I total) {
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (I)gridDim.x * blockDim.x)
    scatter_first_one<T, I, Idx, WH, WW>(g, idx, gi, q, i);
}

// blocks of a grid-stride launch over `total` elements: enough to fill every SM several
// times over, no more (0 blocks, so a failed launch, if the card cannot be asked)
unsigned grid_for(long long total, int threads) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (total + threads - 1) / threads, most = 16LL * sms;
  return (unsigned)(need < most ? need : most);
}

template <typename T, typename I, typename Idx, int KH, int KW, int WH, int WW>
cudaError_t launch_passes(const void* x, const void* y, const void* g, void* gi, void* idx,
                          const Geom& q, cudaStream_t s) {
  const int threads = 256;
  const long long windows = q.N * q.C * q.OH * q.OW, elems = q.N * q.C * q.H * q.W;
  first_match<T, I, Idx, KH, KW><<<grid_for(windows, threads), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<Idx*>(idx), q,
      (I)windows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_first<T, I, Idx, WH, WW><<<grid_for(elems, threads), threads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const Idx*>(idx), static_cast<T*>(gi), q,
      (I)elems);
  return cudaGetLastError();
}

// the compile-time shape: ResNet's stem window (3x3 at stride 2, so at most 2x2 windows
// cover a position); any other window runs the loops
template <typename T, typename I>
cudaError_t launch_typed(const void* x, const void* y, const void* g, void* gi, void* idx,
                         const Geom& q, cudaStream_t s) {
  using U8 = unsigned char;
  if (q.kh * q.kw >= 255) return launch_passes<T, I, int, 0, 0, 0, 0>(x, y, g, gi, idx, q, s);
  if (q.kh == 3 && q.kw == 3 && q.sh >= 2 && q.sw >= 2)
    return launch_passes<T, I, U8, 3, 3, 2, 2>(x, y, g, gi, idx, q, s);
  return launch_passes<T, I, U8, 0, 0, 0, 0>(x, y, g, gi, idx, q, s);
}

// one past the largest element offset of a tensor of `sizes` with `strides`
long long span(const long long* sizes, const long long* strides) {
  long long last = 0;
  for (int k = 0; k < 4; ++k) last += (sizes[k] - 1) * strides[k];
  return last + 1;
}


// ---------------------------------------------------------------------------
// tiled_nhwc

constexpr int TILE_H = 8, TILE_W = 16;  // gi positions per tile: rows, columns
constexpr int TILE_THREADS = 256;
constexpr int TILE_VECS = 16;    // channel vectors per block at most
constexpr int TILE_SMEM_MAX = 99 * 1024;  // two blocks an SM at the most

struct TileGeom {
  int N, H, W, OH, OW, kh, kw, sh, sw, ph, pw;
  int xs[3], ys[3], gs[3], gis[3];  // element strides (n, h, w); channels are innermost
  int tiles_h, tiles_w;
  int nvec;                         // 16-byte vectors a channel row
  int lvb;                          // log2 of the vectors a block (a power of two)
  int nwh, nww, xh, xw;             // capacity: covering windows and x positions a side
  FastDiv xw_, nww_, sh_, sw_;
};

// the windows that can cover `t` positions in a row along an axis
__host__ __device__ inline int cover(int t, int k, int s) { return (t + k - 2) / s + 1; }

// x's dtype as f32 values of one 16-byte vector
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4], float*) {
  f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8], __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8], __half*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = p.x;  // the low half is the first channel
    f[2 * i + 1] = p.y;
  }
}

// two bf16 adds, each rounded to nearest even once: what rounding the f32 sum of two
// bf16 values to bf16 gives (that f32 sum cannot land on a bf16 halfway point unless it
// is exact), so the reference's f32-add-then-round order agrees bitwise
__device__ __forceinline__ uint32_t add_pair(uint32_t a, uint32_t b, __nv_bfloat16*) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// f16 the same way: two f16 values' f32 sum rounded to f16 is their f16 sum rounded
// once (f32's 24 bits are at least 2 * 11 + 2, so the double rounding is innocuous)
__device__ __forceinline__ uint32_t add_pair(uint32_t a, uint32_t b, __half*) {
  uint32_t r;
  asm("add.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

template <typename T>
__host__ __device__ constexpr int vec_of() { return 16 / static_cast<int>(sizeof(T)); }

// Shared memory of a block: x positions, then the windows' g vectors, then their
// first-match bytes (one a channel).
template <typename T>
__host__ __device__ inline int tile_smem(const TileGeom& q) {
  const int windows = (q.nwh * q.nww) << q.lvb;
  return (((q.xh * q.xw) << q.lvb) + windows) * 16 + windows * vec_of<T>();
}

// The gi vector of one position from the covering windows a_hi..a_lo x b_hi..b_lo (dh,
// dw ascending): each window's g where its first match (a byte a channel, 4 to a word)
// is this position's offset in it.  f32: 4 channels.
__device__ __forceinline__ uint4 gather_gi(const uint4* gsm, const uint32_t* first,
                                           const TileGeom& q, int hp, int wp, int a_lo,
                                           int a_hi, int b_lo, int b_hi, int oh_lo, int ow_lo,
                                           int v, float*) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int oh = a_hi; oh >= a_lo; --oh) {
    const int dh = hp - oh * q.sh;
    for (int ow = b_hi; ow >= b_lo; --ow) {
      const uint32_t off = dh * q.kw + wp - ow * q.sw;
      const int wi = (((oh - oh_lo) * q.nww + (ow - ow_lo)) << q.lvb) + v;
      const uint32_t hit = __vcmpeq4(first[wi], off * 0x01010101u);  // 0xff a matching byte
      const uint4 gv = gsm[wi];
      const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] += __uint_as_float(gw[e] & __byte_perm(hit, 0, e * 0x1111));
    }
  }
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]), __float_as_uint(acc[2]),
                    __float_as_uint(acc[3]));
}
// bf16 and f16: 8 channels, two first-match words, the sums kept as pairs of T
template <typename T>
__device__ __forceinline__ uint4 gather_pairs(const uint4* gsm, const uint32_t* first,
                                              const TileGeom& q, int hp, int wp, int a_lo,
                                              int a_hi, int b_lo, int b_hi, int oh_lo,
                                              int ow_lo, int v) {
  uint32_t acc[4] = {0u, 0u, 0u, 0u};
  for (int oh = a_hi; oh >= a_lo; --oh) {
    const int dh = hp - oh * q.sh;
    for (int ow = b_hi; ow >= b_lo; --ow) {
      const uint32_t off = (dh * q.kw + wp - ow * q.sw) * 0x01010101u;
      const int wi = (((oh - oh_lo) * q.nww + (ow - ow_lo)) << q.lvb) + v;
      const uint2 f = reinterpret_cast<const uint2*>(first)[wi];
      const uint32_t h0 = __vcmpeq4(f.x, off), h1 = __vcmpeq4(f.y, off);
      const uint4 gv = gsm[wi];
      // channel pairs (0,1), (2,3) from h0's bytes, (4,5), (6,7) from h1's
      acc[0] = add_pair(acc[0], gv.x & __byte_perm(h0, 0, 0x1100), (T*)nullptr);
      acc[1] = add_pair(acc[1], gv.y & __byte_perm(h0, 0, 0x3322), (T*)nullptr);
      acc[2] = add_pair(acc[2], gv.z & __byte_perm(h1, 0, 0x1100), (T*)nullptr);
      acc[3] = add_pair(acc[3], gv.w & __byte_perm(h1, 0, 0x3322), (T*)nullptr);
    }
  }
  return make_uint4(acc[0], acc[1], acc[2], acc[3]);
}
__device__ __forceinline__ uint4 gather_gi(const uint4* gsm, const uint32_t* first,
                                           const TileGeom& q, int hp, int wp, int a_lo,
                                           int a_hi, int b_lo, int b_hi, int oh_lo, int ow_lo,
                                           int v, __nv_bfloat16*) {
  return gather_pairs<__nv_bfloat16>(gsm, first, q, hp, wp, a_lo, a_hi, b_lo, b_hi, oh_lo,
                                     ow_lo, v);
}
__device__ __forceinline__ uint4 gather_gi(const uint4* gsm, const uint32_t* first,
                                           const TileGeom& q, int hp, int wp, int a_lo,
                                           int a_hi, int b_lo, int b_hi, int oh_lo, int ow_lo,
                                           int v, __half*) {
  return gather_pairs<__half>(gsm, first, q, hp, wp, a_lo, a_hi, b_lo, b_hi, oh_lo, ow_lo,
                              v);
}

// Block (blockIdx.x = (n, tile row, tile column), blockIdx.y = channel slice) as the
// head of the file describes; 32-bit offsets.  Shared memory is laid out by the
// launch's capacity (q.xh x q.xw positions, q.nwh x q.nww windows, 2^lvb vectors each),
// so every task index is a shared-memory index and splits into (row, column, vector)
// with shifts and precomputed divisions.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS, 4)
    maxpool_bwd_tiled(const T* __restrict__ x, const T* __restrict__ y,
                      const T* __restrict__ g, T* __restrict__ gi, TileGeom q) {
  constexpr int VEC = vec_of<T>();
  constexpr int WORDS = VEC / 4;  // 32-bit words of first-match bytes a vector
  extern __shared__ uint4 smem[];
  const int vmask = (1 << q.lvb) - 1;
  uint4* xsm = smem;
  uint4* gsm = xsm + ((q.xh * q.xw) << q.lvb);
  uint32_t* first = reinterpret_cast<uint32_t*>(gsm + ((q.nwh * q.nww) << q.lvb));

  int b = blockIdx.x;
  const int tw = b % q.tiles_w;
  b /= q.tiles_w;
  const int th = b % q.tiles_h;
  const int n = b / q.tiles_h;
  const int v0 = blockIdx.y << q.lvb;
  const int vb = min(1 << q.lvb, q.nvec - v0);  // vectors in this slice
  const int h0 = th * TILE_H, w0 = tw * TILE_W;
  const int h1 = min(h0 + TILE_H, q.H), w1 = min(w0 + TILE_W, q.W);
  // the windows that cover the tile, and the x rows and columns under them
  const int oh_lo = h0 + q.ph - q.kh + 1 <= 0 ? 0 : (h0 + q.ph - q.kh + q.sh) / q.sh;
  const int oh_hi = min(q.OH - 1, (h1 - 1 + q.ph) / q.sh);
  const int ow_lo = w0 + q.pw - q.kw + 1 <= 0 ? 0 : (w0 + q.pw - q.kw + q.sw) / q.sw;
  const int ow_hi = min(q.OW - 1, (w1 - 1 + q.pw) / q.sw);
  const int nwh = oh_hi - oh_lo + 1, nww = ow_hi - ow_lo + 1;
  const int hx0 = oh_lo * q.sh - q.ph, wx0 = ow_lo * q.sw - q.pw;
  const T* xb = x + n * q.xs[0] + v0 * VEC;
  const int ntask = (q.nwh * q.nww) << q.lvb;

  // the first window task of this thread: its y and g vectors are asked for before the
  // x tile, so that both round trips overlap
  uint4 y0 = make_uint4(0, 0, 0, 0), g0 = y0;
  {
    const int v = threadIdx.x & vmask, wi = threadIdx.x >> q.lvb;
    const int wr = div_by((unsigned)wi, q.nww_), wc = wi - wr * q.nww;
    const int oh = oh_lo + wr, ow = ow_lo + wc, c = (v0 + v) * VEC;
    if (threadIdx.x < ntask && v < vb && wr < nwh && wc < nww) {
      y0 = *reinterpret_cast<const uint4*>(y + n * q.ys[0] + oh * q.ys[1] + ow * q.ys[2] + c);
      g0 = *reinterpret_cast<const uint4*>(g + n * q.gs[0] + oh * q.gs[1] + ow * q.gs[2] + c);
    }
  }

  // (1) x under the windows, real positions only; LOADS loads in flight a thread
  constexpr int LOADS = 8;
  const int xtask = (q.xh * q.xw) << q.lvb;
  for (int base = threadIdx.x; base < xtask; base += LOADS * TILE_THREADS) {
    uint4 val[LOADS];
    bool real[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = base + j * TILE_THREADS;
      const int v = i & vmask, p = i >> q.lvb;
      const int r = div_by((unsigned)p, q.xw_), col = p - r * q.xw;
      const int hh = hx0 + r, ww = wx0 + col;
      real[j] = i < xtask && v < vb && hh >= 0 && hh < q.H && ww >= 0 && ww < q.W &&
                r < (nwh - 1) * q.sh + q.kh && col < (nww - 1) * q.sw + q.kw;
      if (real[j])
        val[j] = *reinterpret_cast<const uint4*>(xb + hh * q.xs[1] + ww * q.xs[2] + v * VEC);
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j)
      if (real[j]) xsm[base + j * TILE_THREADS] = val[j];
  }
  __syncthreads();

  // (2) each covering window's g vector and first match a channel
  for (int i = threadIdx.x; i < ntask; i += TILE_THREADS) {
    const int v = i & vmask, wi = i >> q.lvb;
    const int wr = div_by((unsigned)wi, q.nww_), wc = wi - wr * q.nww;
    if (v >= vb || wr >= nwh || wc >= nww) continue;
    const int oh = oh_lo + wr, ow = ow_lo + wc;
    const int c = (v0 + v) * VEC;
    const bool first_task = i == threadIdx.x;
    float yf[VEC];
    unpack(first_task ? y0
                      : *reinterpret_cast<const uint4*>(y + n * q.ys[0] + oh * q.ys[1] +
                                                        ow * q.ys[2] + c),
           yf, (T*)nullptr);
    gsm[i] = first_task ? g0
                        : *reinterpret_cast<const uint4*>(g + n * q.gs[0] + oh * q.gs[1] +
                                                          ow * q.gs[2] + c);
    const int hs = oh * q.sh - q.ph, ws = ow * q.sw - q.pw;  // the window's origin
    const int dh0 = max(0, -hs), dh1 = min(q.kh, q.H - hs);
    const int dw0 = max(0, -ws), dw1 = min(q.kw, q.W - ws);
    int found[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) found[e] = 255;
    // backwards, so the last hit written is the first in row-major order
    for (int dh = dh1 - 1; dh >= dh0; --dh) {
      const uint4* xr = xsm + (((wr * q.sh + dh) * q.xw + wc * q.sw) << q.lvb) + v;
      for (int dw = dw1 - 1; dw >= dw0; --dw) {
        float xf[VEC];
        unpack(xr[dw << q.lvb], xf, (T*)nullptr);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (xf[e] == yf[e]) found[e] = dh * q.kw + dw;
      }
    }
#pragma unroll
    for (int k = 0; k < WORDS; ++k)
      first[i * WORDS + k] = found[4 * k] | (found[4 * k + 1] << 8) | (found[4 * k + 2] << 16) |
                             (static_cast<uint32_t>(found[4 * k + 3]) << 24);
  }
  __syncthreads();

  // (3) each gi vector of the tile, the covering windows in (dh, dw) order
  for (int i = threadIdx.x; i < (TILE_H * TILE_W) << q.lvb; i += TILE_THREADS) {
    const int v = i & vmask, p = i >> q.lvb;
    const int h = h0 + p / TILE_W, w = w0 + p % TILE_W;
    if (v >= vb || h >= h1 || w >= w1) continue;
    const int hp = h + q.ph, wp = w + q.pw;
    const int a_hi = min((int)div_by((unsigned)hp, q.sh_), q.OH - 1);
    const int a_lo = hp - q.kh + 1 <= 0 ? 0 : (int)div_by((unsigned)(hp - q.kh + q.sh), q.sh_);
    const int b_hi = min((int)div_by((unsigned)wp, q.sw_), q.OW - 1);
    const int b_lo = wp - q.kw + 1 <= 0 ? 0 : (int)div_by((unsigned)(wp - q.kw + q.sw), q.sw_);
    *reinterpret_cast<uint4*>(gi + n * q.gis[0] + h * q.gis[1] + w * q.gis[2] + (v0 + v) * VEC) =
        gather_gi(gsm, first, q, hp, wp, a_lo, a_hi, b_lo, b_hi, oh_lo, ow_lo, v, (T*)nullptr);
  }
}

// The tiled variant's geometry for q, or false where it does not apply.
template <typename T>
bool plan_tiled(const void* x, const void* y, const void* g, const void* gi, const Geom& q,
                TileGeom* t) {
  constexpr int VEC = vec_of<T>();
  const void* bases[4] = {x, y, g, gi};
  const long long* strides[4] = {q.xs, q.ys, q.gs, q.gis};
  if (q.C % VEC != 0 || q.kh * q.kw >= 255) return false;
  for (int k = 0; k < 4; ++k) {
    if ((reinterpret_cast<uintptr_t>(bases[k]) & 15) != 0 || strides[k][1] != 1) return false;
    for (int d = 0; d < 4; ++d)
      if (d != 1 && (strides[k][d] % VEC != 0 || strides[k][d] < 0)) return false;
  }
  const long long xsz[4] = {q.N, q.C, q.H, q.W}, ysz[4] = {q.N, q.C, q.OH, q.OW};
  const long long spans[4] = {span(xsz, q.xs), span(ysz, q.ys), span(ysz, q.gs),
                              span(xsz, q.gis)};
  for (long long v : spans)
    if (v >= 0x7fffffffLL) return false;
  t->N = (int)q.N; t->H = (int)q.H; t->W = (int)q.W; t->OH = (int)q.OH; t->OW = (int)q.OW;
  t->kh = q.kh; t->kw = q.kw; t->sh = q.sh; t->sw = q.sw; t->ph = q.ph; t->pw = q.pw;
  for (int k = 0; k < 3; ++k) {
    const int d = k == 0 ? 0 : k + 1;  // n, h, w
    t->xs[k] = (int)q.xs[d]; t->ys[k] = (int)q.ys[d];
    t->gs[k] = (int)q.gs[d]; t->gis[k] = (int)q.gis[d];
  }
  t->tiles_h = (int)((q.H + TILE_H - 1) / TILE_H);
  t->tiles_w = (int)((q.W + TILE_W - 1) / TILE_W);
  t->nvec = (int)(q.C / VEC);
  t->lvb = 0;
  while ((2 << t->lvb) <= t->nvec && (2 << t->lvb) <= TILE_VECS) ++t->lvb;
  t->nwh = cover(TILE_H, q.kh, q.sh);
  t->nww = cover(TILE_W, q.kw, q.sw);
  t->xh = (t->nwh - 1) * q.sh + q.kh;
  t->xw = (t->nww - 1) * q.sw + q.kw;
  t->xw_ = make_div(t->xw); t->nww_ = make_div(t->nww);
  t->sh_ = make_div(q.sh); t->sw_ = make_div(q.sw);
  // a window wide against its stride covers a tile with many windows: fewer
  // channel vectors a block then keep the tile in shared memory
  while (t->lvb > 0 && tile_smem<T>(*t) > TILE_SMEM_MAX) --t->lvb;
  return (long long)q.N * t->tiles_h * t->tiles_w < 0x7fffffffLL &&
         tile_smem<T>(*t) <= TILE_SMEM_MAX;
}

template <typename T>
cudaError_t launch_tiled(const void* x, const void* y, const void* g, void* gi,
                         const TileGeom& t, cudaStream_t s, int* info) {
  auto kernel = maxpool_bwd_tiled<T>;
  const int smem = tile_smem<T>(t);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM_MAX);
    if (e != cudaSuccess) return e;
  }
  const int vb = 1 << t.lvb;
  const dim3 grid(t.N * t.tiles_h * t.tiles_w, (t.nvec + vb - 1) / vb);
  kernel<<<grid, TILE_THREADS, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(y),
                                          static_cast<const T*>(g), static_cast<T*>(gi), t);
  info[0] = 1;
  info[1] = TILE_H * TILE_W;
  info[2] = vb;
  info[3] = (int)(grid.x * grid.y);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_two_pass(const void* x, const void* y, const void* g, void* gi, void* idx,
                            const Geom& q, cudaStream_t s, int* info) {
  if (idx == nullptr) return cudaErrorInvalidValue;
  const long long elems = q.N * q.C * q.H * q.W, windows = q.N * q.C * q.OH * q.OW;
  const long long xsz[4] = {q.N, q.C, q.H, q.W}, ysz[4] = {q.N, q.C, q.OH, q.OW};
  long long most = elems > windows ? elems : windows;
  const long long spans[4] = {span(xsz, q.xs), span(ysz, q.ys), span(ysz, q.gs),
                              span(xsz, q.gis)};
  for (long long v : spans) most = v > most ? v : most;
  info[0] = 0;
  info[1] = 0;
  info[2] = 0;
  info[3] = (int)grid_for(elems, 256);
  if (most < 0x7fffffffLL) return launch_typed<T, unsigned>(x, y, g, gi, idx, q, s);
  return launch_typed<T, unsigned long long>(x, y, g, gi, idx, q, s);
}

// dims and strides as the entry points take them; false for a bad geometry
bool parse(const long long* dims, const long long* strides, int channels_last, Geom* q) {
  q->N = dims[0]; q->C = dims[1]; q->H = dims[2]; q->W = dims[3]; q->OH = dims[4];
  q->OW = dims[5];
  q->kh = (int)dims[6]; q->kw = (int)dims[7]; q->sh = (int)dims[8]; q->sw = (int)dims[9];
  q->ph = (int)dims[10]; q->pw = (int)dims[11];
  if (q->N <= 0 || q->C <= 0 || q->H <= 0 || q->W <= 0 || q->OH <= 0 || q->OW <= 0 ||
      q->kh <= 0 || q->kw <= 0 || q->sh <= 0 || q->sw <= 0 || q->ph < 0 || q->pw < 0 ||
      q->H + q->ph >= 0x40000000LL || q->W + q->pw >= 0x40000000LL)
    return false;
  for (int k = 0; k < 4; ++k) {
    q->xs[k] = strides[k];
    q->ys[k] = strides[4 + k];
    q->gs[k] = strides[8 + k];
    q->gis[k] = strides[12 + k];
  }
  q->C_ = make_div(q->C); q->H_ = make_div(q->H); q->W_ = make_div(q->W);
  q->OH_ = make_div(q->OH); q->OW_ = make_div(q->OW);
  q->channels_last = channels_last;
  return true;
}

bool tiled_applies(int dtype, const void* x, const void* y, const void* g, const void* gi,
                   const Geom& q, TileGeom* t) {
  return dtype == 0   ? plan_tiled<float>(x, y, g, gi, q, t)
         : dtype == 1 ? plan_tiled<__nv_bfloat16>(x, y, g, gi, q, t)
                      : plan_tiled<__half>(x, y, g, gi, q, t);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16 (x, y, g, gi all of it).  dims: N, C, H, W, OH, OW, kh, kw,
// sh, sw, ph, pw (ph, pw the lo padding).  strides: 16 element strides, (n, c, h, w) of x, y, g and
// gi in that order.  Returns the variant these tensors take: 1 tiled_nhwc, 0 two_pass (it
// needs the idx scratch below), -1 a bad dtype or geometry.
extern "C" int bigdl_maxpool_bwd_variant(int dtype, const void* x, const void* y, const void* g,
                                         const void* gi, const long long* dims,
                                         const long long* strides, int channels_last) {
  Geom q;
  TileGeom t;
  if (dtype < 0 || dtype > 2 || !parse(dims, strides, channels_last, &q)) return -1;
  return tiled_applies(dtype, x, y, g, gi, q, &t) ? 1 : 0;
}

// Arguments as above; idx: scratch of N*C*OH*OW offsets, uint8 when kh*kw < 255, else
// int32, for the two_pass variant (null for tiled_nhwc; the caller allocates it).
// Launches on `stream` and returns cudaGetLastError() (0 on success); a bad dtype or
// geometry, or a null idx where two_pass runs, returns cudaErrorInvalidValue without
// launching.  info (4 ints) receives {variant (0 two_pass, 1 tiled_nhwc), gi positions a
// tile (0 for two_pass), channel vectors a block (0 for two_pass), blocks of the last
// launch}.
extern "C" int bigdl_maxpool_bwd(int dtype, const void* x, const void* y, const void* g,
                                 void* gi, void* idx, const long long* dims,
                                 const long long* strides, int channels_last, void* stream,
                                 int* info) {
  Geom q;
  TileGeom t;
  if (dtype < 0 || dtype > 2 || !parse(dims, strides, channels_last, &q))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled_applies(dtype, x, y, g, gi, q, &t))
    return (int)(dtype == 0   ? launch_tiled<float>(x, y, g, gi, t, s, info)
                 : dtype == 1 ? launch_tiled<__nv_bfloat16>(x, y, g, gi, t, s, info)
                              : launch_tiled<__half>(x, y, g, gi, t, s, info));
  return (int)(dtype == 0   ? launch_two_pass<float>(x, y, g, gi, idx, q, s, info)
               : dtype == 1 ? launch_two_pass<__nv_bfloat16>(x, y, g, gi, idx, q, s, info)
                            : launch_two_pass<__half>(x, y, g, gi, idx, q, s, info));
}
