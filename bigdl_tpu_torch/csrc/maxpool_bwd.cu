// Max-pool input gradient, first-match (B1), for Hopper (sm_90a).
//
// Replaces the TPU kernel of bigdl_tpu/ops/pallas_pool.py: _bwd_kernel, launched by the
// pl.pallas_call in maxpool_bwd_nhwc.  Each output window o sends g[o] to the FIRST
// position, in row-major (dh, dw) order over the window's real (unpadded) positions, whose
// value equals y[o] (compared in f32).  Windows that overlap add up into gi in the dtype
// of x, one (dh, dw) offset after another: for an input position p the contributions of
// the windows covering it are added in (dh, dw) order, where dh, dw is p's offset inside
// each window.  That is the reference's order exactly, so the plain version
// (maxpool_bwd_reference in ops/maxpool.py) and this kernel agree bitwise.
//
// Design: two passes, no atomics, no memset, each output written once.
//   1. One thread per window o: scans the window's real offsets in row-major order and
//      stores the first whose x equals y[o] as a small integer (dh*kw + dw; uint8 when
//      kh*kw < 255, else int32; the sentinel "none" only where y[o] matches nothing, as
//      for a NaN maximum).  Each window reads its kh*kw values of x once.
//   2. One thread per element of gi: visits the windows that cover its position, dh
//      ascending (oh descending) then dw ascending, and adds g[o] where the window's
//      first match is its own offset, else 0, rounding to x's dtype after each add.
// For the 3x3 windows of stride 2 or more that ResNet's stem pools with, both passes are
// unrolled at compile time, so that a thread's loads are in flight together; both stride
// over their elements with a grid sized to the card.
// Threads walk memory order: with channels innermost (NHWC, channels_last) neighbouring
// threads read neighbouring channels of x, y, g and the offsets, so loads coalesce; in
// NCHW, W is innermost.  Each tensor comes with its own four strides (n, c, h, w), so
// both layouts and any view work.  Ragged C, any H and W, ceil mode, lo/hi padding and
// strides larger or smaller than the window need no gate: the window ranges are clipped
// per thread.  A one-pass form (each element of gi scanning every covering window for an
// earlier match) was slower on an H100: kh*kw - 1 compares per covering window.  Index
// arithmetic is 32-bit, with divisions by precomputed multipliers, whenever the launch's
// indices and offsets fit.
//
// What bounds it on an H100.  Its least time is set by bytes: it reads x, y and g once and
// writes gi once (plus one byte a window for the offsets), about one comparison per
// covered position, far below the card's ridge.  At ResNet-50's stem at batch 256 (x
// 256x112x112x64, 3x3/2 pad 1) that is 2.06 GB in f32, 0.61 ms at 3.35 TB/s, and half in
// bf16.  It runs several times slower, and as slowly in bf16 as in f32: the per-element
// work of pass 2 (index arithmetic, up to four offset compares, the ordered adds), not the
// bytes, sets its time.  Packing several channels into one thread is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// one add rounded to T, as PyTorch adds two tensors of T
__device__ __forceinline__ float add_in(float acc, float v, float*) { return acc + v; }
__device__ __forceinline__ float add_in(float acc, float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(acc + v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* g, void* gi, void* idx,
                   const Geom& q, cudaStream_t s) {
  const long long elems = q.N * q.C * q.H * q.W, windows = q.N * q.C * q.OH * q.OW;
  const long long xsz[4] = {q.N, q.C, q.H, q.W}, ysz[4] = {q.N, q.C, q.OH, q.OW};
  long long most = elems > windows ? elems : windows;
  const long long spans[4] = {span(xsz, q.xs), span(ysz, q.ys), span(ysz, q.gs),
                              span(xsz, q.gis)};
  for (long long v : spans) most = v > most ? v : most;
  if (most < 0x7fffffffLL) return launch_typed<T, unsigned>(x, y, g, gi, idx, q, s);
  return launch_typed<T, unsigned long long>(x, y, g, gi, idx, q, s);
}

}  // namespace

// dtype: 0 f32, 1 bf16 (x, y, g, gi all of it).  dims: N, C, H, W, OH, OW, kh, kw, sh, sw,
// ph, pw (ph, pw the lo padding).  strides: 16 element strides, (n, c, h, w) of x, y, g and
// gi in that order.  idx: scratch of N*C*OH*OW offsets, uint8 when kh*kw < 255, else int32
// (the caller allocates it).  Launches both passes on `stream` and returns
// cudaGetLastError() (0 on success); a bad dtype or geometry returns cudaErrorInvalidValue
// without launching.
extern "C" int bigdl_maxpool_bwd(int dtype, const void* x, const void* y, const void* g,
                                 void* gi, void* idx, const long long* dims,
                                 const long long* strides, int channels_last, void* stream) {
  Geom q;
  q.N = dims[0]; q.C = dims[1]; q.H = dims[2]; q.W = dims[3]; q.OH = dims[4]; q.OW = dims[5];
  q.kh = (int)dims[6]; q.kw = (int)dims[7]; q.sh = (int)dims[8]; q.sw = (int)dims[9];
  q.ph = (int)dims[10]; q.pw = (int)dims[11];
  if (q.N <= 0 || q.C <= 0 || q.H <= 0 || q.W <= 0 || q.OH <= 0 || q.OW <= 0 || q.kh <= 0 ||
      q.kw <= 0 || q.sh <= 0 || q.sw <= 0 || q.ph < 0 || q.pw < 0 || q.H + q.ph >= 0x40000000LL ||
      q.W + q.pw >= 0x40000000LL)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) {
    q.xs[k] = strides[k];
    q.ys[k] = strides[4 + k];
    q.gs[k] = strides[8 + k];
    q.gis[k] = strides[12 + k];
  }
  q.C_ = make_div(q.C); q.H_ = make_div(q.H); q.W_ = make_div(q.W);
  q.OH_ = make_div(q.OH); q.OW_ = make_div(q.OW);
  q.channels_last = channels_last;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, y, g, gi, idx, q, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, y, g, gi, idx, q, s);
  return (int)cudaErrorInvalidValue;
}
