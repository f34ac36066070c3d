// Fused LSTM cell, forward (B2f) and elementwise backward (B2b), for Hopper (sm_90a).
//
// Replaces the TPU kernels of bigdl_tpu/ops/pallas_lstm.py: _fwd_kernel, launched
// by the pl.pallas_call in _pallas_cell, and _bwd_kernel, launched by the one in
// _pallas_cell_bwd.  Gate order is i|f|g|o, four contiguous blocks of H columns.
//
//   forward:  z = f32(zx) + h @ W_t                     (f32 accumulate; z is (N, 4H))
//             i, f, g, o = sig(z_i), sig(z_f + forget_bias), tanh(z_g), sig(z_o)
//             c' = f * c + i * g;  h' = o * tanh(c')    (h', c' in zx's type; z kept in f32)
//   backward: the gates recomputed from the f32 z, then with tc = tanh(c'),
//             dct = dc + dh * o * (1 - tc^2)
//             dz = [dct*g*i*(1-i) | dct*c*f*(1-f) | dct*i*(1-g^2) | dh*tc*o*(1-o)]  (f32)
//             dc_prev = dct * f                                                    (c's type)
//
// The two products around the backward (dh_prev = dz @ W_t^T, dW_t = h^T @ dz) stay
// outside, in torch.matmul, as the reference leaves them to XLA.  Math is f32 with
// expf/tanhf; build without --use_fast_math.
//
// What bounds it on an H100.  At PTB-medium's shape (N=20, H=650, f32) the forward
// moves 7.38 MB and does 67.6 MFLOP (9 flop/byte, below the f32 ridge of 20): it is
// bound by bytes, and the W_t panel (H x 4H = 6.76 MB f32) is 92% of them.  Inside a
// sequence every step reads the same W_t, so after the first step a launch finds it in
// the 50 MB L2 and runs faster than the HBM bound.  The backward is elementwise, 0.62 MB
// at that shape, and bound by bytes too.
//
// Design.  Forward: a block owns J=16 hidden units and BN=32 batch rows, and computes
// the four columns j, H+j, 2H+j, 3H+j of each, so the gates, c' and h' are finished in
// registers with no exchange between blocks and no atomics.  The K=H loop walks shared-
// memory tiles of h (BN x BK) and W_t (BK x 4 x J) with f32 FMAs on the CUDA cores.
// Tiles load with bounds checks and zero fill, so ragged H (650) and any N need no
// padding by the caller; the TPU version's 128-lane gate padding does not exist here.
// Backward: one thread per (n, j).  Both are the simple correct kernels; a persistent
// kernel that keeps W_t in shared memory across the 35 steps is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int J = 16;         // hidden units per block (threadIdx.x)
constexpr int BN = 32;        // batch rows per block
constexpr int BK = 32;        // depth of one shared-memory tile
constexpr int TY = 16;        // threadIdx.y extent
constexpr int RPT = BN / TY;  // rows per thread
constexpr int THREADS = J * TY;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lstm_cell_fwd(const T* __restrict__ zx, const T* __restrict__ h, const T* __restrict__ c,
                  const T* __restrict__ w_t, T* __restrict__ h_out, T* __restrict__ c_out,
                  float* __restrict__ z_out, int N, int H, float forget_bias) {
  __shared__ float hs[BN][BK + 1];
  __shared__ float ws[BK][4][J];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * J + tx;
  const int j0 = blockIdx.x * J, n0 = blockIdx.y * BN;
  const long H4 = 4L * H;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BK * 4 * J) / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int jj = e % J, g = (e / J) % 4, kk = e / (4 * J);
      const int k = k0 + kk, j = j0 + jj;
      ws[kk][g][jj] = (k < H && j < H) ? to_f32(w_t[k * H4 + (long)g * H + j]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < (BN * BK) / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int kk = e % BK, r = e / BK;
      const int k = k0 + kk, n = n0 + r;
      hs[r][kk] = (k < H && n < N) ? to_f32(h[(long)n * H + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = ws[kk][g][tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float hv = hs[ty + i * TY][kk];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = fmaf(hv, w[g], acc[i][g]);
      }
    }
    __syncthreads();
  }

  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = n0 + ty + i * TY;
    if (n >= N) continue;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const long at = n * H4 + (long)g * H + j;
      z[g] = to_f32(zx[at]) + acc[i][g];
      z_out[at] = z[g];
    }
    const float ig = sigmoid(z[0]);
    const float fg = sigmoid(z[1] + forget_bias);
    const float gg = tanhf(z[2]);
    const float og = sigmoid(z[3]);
    const long at = (long)n * H + j;
    const float c_new = fg * to_f32(c[at]) + ig * gg;
    store(&c_out[at], c_new);
    store(&h_out[at], og * tanhf(c_new));
  }
}

template <typename T>
__global__ void lstm_cell_bwd(const float* __restrict__ z, const T* __restrict__ c,
                              const T* __restrict__ dh, const T* __restrict__ dc,
                              float* __restrict__ dz, T* __restrict__ dc_prev, int N, int H,
                              float forget_bias) {
  const long total = (long)N * H;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const long n = e / H, j = e % H;
    const long row = n * 4L * H;
    const float ig = sigmoid(z[row + j]);
    const float fg = sigmoid(z[row + H + j] + forget_bias);
    const float gg = tanhf(z[row + 2L * H + j]);
    const float og = sigmoid(z[row + 3L * H + j]);
    const float cv = to_f32(c[e]), dhv = to_f32(dh[e]);
    const float tc = tanhf(fg * cv + ig * gg);
    const float dct = to_f32(dc[e]) + dhv * og * (1.0f - tc * tc);
    dz[row + j] = dct * gg * ig * (1.0f - ig);
    dz[row + H + j] = dct * cv * fg * (1.0f - fg);
    dz[row + 2L * H + j] = dct * ig * (1.0f - gg * gg);
    dz[row + 3L * H + j] = dhv * tc * og * (1.0f - og);
    store(&dc_prev[e], dct * fg);
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16 (zx, h, c, w_t, h_out, c_out); z_out is f32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); a bad dtype or size returns
// cudaErrorInvalidValue without launching.
extern "C" int bigdl_lstm_cell_fwd(int dtype, const void* zx, const void* h, const void* c,
                                   const void* w_t, void* h_out, void* c_out, void* z_out, int N,
                                   int H, float forget_bias, void* stream) {
  if (N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((H + J - 1) / J, (N + BN - 1) / BN);
  const dim3 block(J, TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* z = static_cast<float*>(z_out);
  if (dtype == 0) {
    lstm_cell_fwd<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(zx), static_cast<const float*>(h), static_cast<const float*>(c),
        static_cast<const float*>(w_t), static_cast<float*>(h_out), static_cast<float*>(c_out), z,
        N, H, forget_bias);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    lstm_cell_fwd<B><<<grid, block, 0, s>>>(
        static_cast<const B*>(zx), static_cast<const B*>(h), static_cast<const B*>(c),
        static_cast<const B*>(w_t), static_cast<B*>(h_out), static_cast<B*>(c_out), z, N, H,
        forget_bias);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 f32, 1 bf16 (c, dh, dc, dc_prev); z and dz are f32.
extern "C" int bigdl_lstm_cell_bwd(int dtype, const void* z, const void* c, const void* dh,
                                   const void* dc, void* dz, void* dc_prev, int N, int H,
                                   float forget_bias, void* stream) {
  if (N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long total = (long)N * H;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 65535 ? (total + threads - 1) / threads
                                                                   : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zp = static_cast<const float*>(z);
  float* dzp = static_cast<float*>(dz);
  if (dtype == 0) {
    lstm_cell_bwd<float><<<blocks, threads, 0, s>>>(
        zp, static_cast<const float*>(c), static_cast<const float*>(dh),
        static_cast<const float*>(dc), dzp, static_cast<float*>(dc_prev), N, H, forget_bias);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    lstm_cell_bwd<B><<<blocks, threads, 0, s>>>(
        zp, static_cast<const B*>(c), static_cast<const B*>(dh), static_cast<const B*>(dc), dzp,
        static_cast<B*>(dc_prev), N, H, forget_bias);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
