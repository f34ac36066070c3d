// Fused LSTM cell, forward (B2f) and elementwise backward (B2b), for Hopper (sm_90a).
//
// Replaces the TPU kernels of bigdl_tpu/ops/pallas_lstm.py: _fwd_kernel, launched
// by the pl.pallas_call in _pallas_cell, and _bwd_kernel, launched by the one in
// _pallas_cell_bwd.  Gate order is i|f|g|o, four contiguous blocks of H columns.
//
//   forward:  z = f32(zx) + h @ W_t                     (f32 accumulate; z is (N, 4H))
//             i, f, g, o = sig(z_i), sig(z_f + forget_bias), tanh(z_g), sig(z_o)
//             c' = f * c + i * g;  h' = o * tanh(c')    (h', c' in zx's type; z kept in f32)
//
// zx, h, c, W_t (and dh, dc) come in f32, bf16 or f16, all four alike; a 16-bit value is
// widened to f32 as it is read and every result rounded once to its type as it is
// written (__float2bfloat16, __float2half_rn), so both 16-bit forms compute what the
// f32 form computes on the widened inputs.
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
// the 50 MB L2 and is bound by how fast the SMs can pull it from there and by latency,
// not by HBM: the work has to be spread over every SM, with the copies overlapped.  The
// backward is elementwise, 0.62 MB at that shape: 0.19 us at 3.35 TB/s, below the fixed
// cost of any launch, so the least time it can take is that of an empty kernel of its grid
// (bigdl_lstm_cell_bwd_empty measures it).
//
// Design, forward.  A thread-block cluster of S=8 CTAs owns J=16 hidden units (the four
// gate columns j, H+j, 2H+j, 3H+j of each: 64 columns of z) and up to 32 batch rows; each
// CTA of the cluster reduces one K slice of h @ W_t (K=H cut in eight slices of a
// multiple of 8 rows).  At PTB-medium that is 41 column groups x 8 = 328 CTAs, 2-3 on
// each of the 132 SMs (41 x 4 = 164 CTAs would put two on 32 SMs and one on the rest).
// A CTA streams its slice in chunks of 32 rows of W_t (32 x 64) and of h (rows x 32)
// with cp.async into a ring of 3 stages: 16-byte copies where the row strides allow it,
// 8 or 4 bytes otherwise (H=650 f32 gate blocks start on 8-byte boundaries), plain loads
// for bf16 or f16 at an odd H; out-of-range rows and columns are zero-filled, so ragged H and N
// need no padding.  The block is 64 x ceil(rows / 4) threads, so the batch tile is sized
// to N (N=20: 320 threads, 20 rows).  A thread sums a quarter of each chunk's k for 4
// columns x 4 rows: per 4 k, four 4-wide loads of W_t and four of h (a broadcast) feed
// 64 FMAs; the quarters are added by warp shuffles in a fixed order.  Each CTA then
// pushes its partial z into the shared memory of the CTA that finishes the unit
// (distributed shared memory, st.shared::cluster), and after one cluster barrier each
// CTA sums the eight partials of its 2 hidden units in rank order 0..7 (deterministic,
// no atomics) and finishes the gates, c', h' and z.  What bounds it now: the start, when
// all 328 CTAs pull their first chunks from L2 at once (the slowest wait several µs),
// and the cluster barrier, which waits for the slowest CTA of the cluster.  A persistent
// kernel that keeps W_t on chip across the 35 steps is later work.
//
// Design, backward.  A 2-D grid of batch rows by runs of 128 hidden units (PTB-medium:
// 6 x 20 = 120 blocks, one an SM), so every block lands on an SM of its own and no thread
// divides; a thread issues its seven loads (four z gates, c, dh, dc) before its first
// expf.  What is left above an empty kernel of the same grid is one dependent chain:
// the parameters, the loads, the gates, tanh(c'), the stores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int S = 8;             // CTAs of a cluster, one K slice each
constexpr int J = 16;            // hidden units per cluster
constexpr int COLS = 4 * J;      // z columns per cluster (gate-major)
constexpr int NT = 32;           // batch rows per cluster, at most
constexpr int BK = 32;           // K rows per chunk
constexpr int STAGES = 3;
constexpr int RPT = 4;           // batch rows a thread
constexpr int MAX_THREADS = COLS * NT / RPT;  // COLS columns x NT / RPT row groups
constexpr int UNITS = J / S;     // hidden units each CTA finishes
static_assert(UNITS == 2, "the partials are pushed as float2, one per finishing CTA");
// the ring: STAGES x (W_t chunk BK x COLS + h chunk NT x BK); 36 KB in f32
template <typename T>
__host__ __device__ constexpr int ring_bytes() {
  return STAGES * (BK * COLS + NT * BK) * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
// four neighbouring values from shared memory, one 16- (f32) or 8-byte (bf16, f16) load
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&q.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&q.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// CW bytes from global to shared, or zeros when !valid: cp.async for CW >= 4
// (the 16-byte form bypasses L1), a plain load for CW = 2 (one bf16 or f16).
template <int CW>
__device__ __forceinline__ void copy(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (CW == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (CW == 8 || CW == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(CW),
                 "r"(valid ? CW : 0)
                 : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : 0;
  }
}

template <typename T, int CW>
__global__ void __cluster_dims__(S, 1, 1) __launch_bounds__(MAX_THREADS)
    lstm_cell_fwd(const T* __restrict__ zx, const T* __restrict__ h, const T* __restrict__ c,
                  const T* __restrict__ w_t, T* __restrict__ h_out, T* __restrict__ c_out,
                  float* __restrict__ z_out, int N, int H, float forget_bias) {
  constexpr int E = CW / sizeof(T);  // elements a copy
  __shared__ __align__(16) unsigned char ring[ring_bytes<T>()];
  auto ws = reinterpret_cast<T(*)[BK][COLS]>(ring);                       // [STAGES]
  auto hs = reinterpret_cast<T(*)[NT][BK]>(ring + STAGES * BK * COLS * sizeof(T));
  // recv[src][row][gate][unit]: the partial sums the cluster's CTAs push here for
  // the UNITS hidden units this CTA finishes
  __shared__ __align__(16) float recv[S][NT][4][UNITS];
  cg::cluster_group cluster = cg::this_cluster();
  // first half of a cluster barrier: this CTA has started (its shared memory may
  // be written by the others once they have waited on it)
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int j0 = (blockIdx.x / S) * J;
  const int n0 = blockIdx.y * NT;
  const int rows = min(NT, N - n0);
  // RPT rows a thread, groups of COLS threads: the batch tile sized to N (the
  // block is sized to the widest tile; a narrower one leaves threads idle)
  const int groups = (rows + RPT - 1) / RPT;
  const int threads = blockDim.x;
  const long H4 = 4L * H;
  // this CTA's K slice: a multiple of 8 rows, so chunk starts stay aligned
  const int ks = ((H + S - 1) / S + 7) / 8 * 8;
  const int k_lo = min(H, rank * ks), k_hi = min(H, k_lo + ks);
  const int chunks = (k_hi - k_lo + BK - 1) / BK;

  auto load = [&](int chunk, int st) {
    const int kb = k_lo + chunk * BK;
    for (int u = tid; u < BK * 4 * (J / E); u += threads) {  // W_t rows kb.., 4 gates
      const int kk = u / (4 * (J / E)), g = (u / (J / E)) % 4, v = u % (J / E);
      const int k = kb + kk, j = j0 + v * E;
      const bool ok = k < k_hi && j < H;
      copy<CW>(&ws[st][kk][g * J + v * E], ok ? w_t + k * H4 + (long)g * H + j : w_t, ok);
    }
    for (int u = tid; u < RPT * groups * (BK / E); u += threads) {  // h rows, K kb..
      const int r = u / (BK / E), v = u % (BK / E);
      const int n = n0 + r, k = kb + v * E;
      const bool ok = r < rows && k < k_hi;
      copy<CW>(&hs[st][r][v * E], ok ? h + (long)n * H + k : h, ok);
    }
  };

  // the (row, unit) pair this thread finishes, if any (rows * UNITS <= 64
  // threads): its zx and c are loaded now, under the K loop's latency
  const int fr = tid / UNITS, fjj = rank * UNITS + tid % UNITS;
  const int fn = n0 + fr, fj = j0 + fjj;
  const bool finisher = tid < rows * UNITS && fj < H;
  float fzx[4], fc = 0.0f;
#pragma unroll
  for (int g = 0; g < 4; ++g) fzx[g] = finisher ? to_f32(zx[fn * H4 + (long)g * H + fj]) : 0.0f;
  if (finisher) fc = to_f32(c[(long)fn * H + fj]);

  // A warp: 8 column quads x 4 K groups, for rows r0 .. r0+RPT-1; two warps
  // cover the 64 columns.  Thread (quad cq, K group kg) sums k = 8kg .. 8kg+7
  // of every chunk for columns 4cq .. 4cq+3: per 4 k one 4-wide load of W_t per
  // k and of h per row give 64 FMAs.
  const int lane = tid % 32, warp = tid / 32;
  const int kg = lane / 8, cq = lane % 8 + 8 * (warp % 2), r0 = (warp / 2) * RPT;
  const int col4 = 4 * cq;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < chunks) load(st, st);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int ch = 0; ch < chunks; ++ch) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // chunk ch landed; everyone is done with chunk ch-1's stage
    if (ch + STAGES - 1 < chunks) load(ch + STAGES - 1, (ch + STAGES - 1) % STAGES);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int st = ch % STAGES;
#pragma unroll
    for (int kk = 8 * kg; kk < 8 * kg + 8; kk += 4) {
      float w[4][4], hv[RPT][4];  // h: one address per K group, a broadcast
#pragma unroll
      for (int q = 0; q < 4; ++q) load4(&ws[st][kk + q][col4], w[q]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) load4(&hs[st][r0 + i][kk], hv[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(hv[i][q], w[q][c], acc[i][c]);
    }
  }
  // the four K groups' sums, (kg0 + kg1) + (kg2 + kg3) in every lane alike
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 8);
      acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 16);
    }
  // push each partial to the CTA that finishes its hidden unit, once every
  // CTA of the cluster has started: K group kg pushes row r0 + kg
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  {
    float mine[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mine[c] = acc[0][c];
#pragma unroll
      for (int i = 1; i < RPT; ++i)
        if (kg == i) mine[c] = acc[i][c];
    }
    // columns col4 .. col4+3: one gate, units jj .. jj+3, UNITS (2) a CTA
    const int r = r0 + kg, g = col4 / J, jj = col4 % J;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < 4; c += UNITS)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(&recv[rank][r][g][0],
                                                           (jj + c) / UNITS)) =
            make_float2(mine[c], mine[c + 1]);
    }
  }
  cluster.sync();  // every partial has landed

  // finish: the partials summed in rank order, then the gates
  if (finisher) {
    const int ul = fjj % UNITS;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float a = 0.0f;
#pragma unroll
      for (int q = 0; q < S; ++q) a += recv[q][fr][g][ul];
      z[g] = fzx[g] + a;
      z_out[fn * H4 + (long)g * H + fj] = z[g];
    }
    const float ig = sigmoid(z[0]);
    const float fg = sigmoid(z[1] + forget_bias);
    const float gg = tanhf(z[2]);
    const float og = sigmoid(z[3]);
    const long at = (long)fn * H + fj;
    const float c_new = fg * fc + ig * gg;
    store(&c_out[at], c_new);
    store(&h_out[at], og * tanhf(c_new));
  }
}

// Backward (B2b): a 2-D grid, batch row (blockIdx.y, striding past the grid's y limit)
// by runs of BWD_THREADS hidden units (blockIdx.x), one a thread, so no thread divides
// and every index within a row is 32-bit.  All seven loads of a unit are issued,
// read-only, before the first transcendental.  Two units a thread with 8-byte loads of
// the z gate blocks is slower on an H100 (the longer per-thread chain costs more than the
// wider loads save), and so is any other block size of 32 to 256 threads.
constexpr int BWD_THREADS = 128;

__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float load_ro(const __half* p) { return __half2float(__ldg(p)); }

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    lstm_cell_bwd(const float* __restrict__ z, const T* __restrict__ c,
                  const T* __restrict__ dh, const T* __restrict__ dc, float* __restrict__ dz,
                  T* __restrict__ dc_prev, int N, int H, float forget_bias) {
  const int j = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (j >= H) return;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const size_t zrow = (size_t)n * (4 * (size_t)H), row = (size_t)n * H;
    const float* zr = z + zrow + j;
    const float zi = __ldg(zr), zf = __ldg(zr + H), zg = __ldg(zr + 2 * H),
                zo = __ldg(zr + 3 * H);
    const float cv = load_ro(c + row + j), dhv = load_ro(dh + row + j),
                dcv = load_ro(dc + row + j);
    const float ig = sigmoid(zi);
    const float fg = sigmoid(zf + forget_bias);
    const float gg = tanhf(zg);
    const float og = sigmoid(zo);
    const float tc = tanhf(fg * cv + ig * gg);
    const float dct = dcv + dhv * og * (1.0f - tc * tc);
    float* dzr = dz + zrow + j;
    dzr[0] = dct * gg * ig * (1.0f - ig);
    dzr[H] = dct * cv * fg * (1.0f - fg);
    dzr[2 * H] = dct * ig * (1.0f - gg * gg);
    dzr[3 * H] = dhv * tc * og * (1.0f - og);
    store(&dc_prev[row + j], dct * fg);
  }
}

// B2b's grid with nothing in it: what a launch of that shape costs on its own.
__global__ void __launch_bounds__(BWD_THREADS) lstm_cell_bwd_empty() {}

}  // namespace

namespace {

// The widest copy (16, 8, 4 bytes; 2 = plain 16-bit loads) that every row start
// of h and every gate block of W_t allows: H * sizeof(T) and the bases.
int copy_width(int H, int es, const void* h, const void* w_t) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w_t);
  for (int cw = 16; cw >= 4; cw /= 2)
    if ((H * es) % cw == 0 && a % cw == 0) return cw;
  return 2;
}

template <typename T, int CW>
int launch_fwd(const void* zx, const void* h, const void* c, const void* w_t, void* h_out,
               void* c_out, float* z, int N, int H, float forget_bias, cudaStream_t s) {
  const dim3 grid(((H + J - 1) / J) * S, (N + NT - 1) / NT);
  const int rows = N < NT ? N : NT;  // the first (widest) batch tile
  lstm_cell_fwd<T, CW><<<grid, COLS * ((rows + RPT - 1) / RPT), 0, s>>>(
      static_cast<const T*>(zx), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(w_t), static_cast<T*>(h_out), static_cast<T*>(c_out), z, N, H,
      forget_bias);
  return (int)cudaGetLastError();
}

// a 16-bit type's forward at the copy width cw (16, 8, 4; 2 = plain loads)
template <typename B>
int launch_fwd16(int cw, const void* zx, const void* h, const void* c, const void* w_t,
                 void* h_out, void* c_out, float* z, int N, int H, float forget_bias,
                 cudaStream_t s) {
  switch (cw) {
    case 16: return launch_fwd<B, 16>(zx, h, c, w_t, h_out, c_out, z, N, H, forget_bias, s);
    case 8: return launch_fwd<B, 8>(zx, h, c, w_t, h_out, c_out, z, N, H, forget_bias, s);
    case 4: return launch_fwd<B, 4>(zx, h, c, w_t, h_out, c_out, z, N, H, forget_bias, s);
    default: return launch_fwd<B, 2>(zx, h, c, w_t, h_out, c_out, z, N, H, forget_bias, s);
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16 (zx, h, c, w_t, h_out, c_out); z_out is f32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); a bad dtype or size returns
// cudaErrorInvalidValue without launching.  info (4 ints) receives the launch's shape:
// {CTAs, cluster size, copy width in bytes (2: plain loads), batch rows a cluster}.
extern "C" int bigdl_lstm_cell_fwd(int dtype, const void* zx, const void* h, const void* c,
                                   const void* w_t, void* h_out, void* c_out, void* z_out, int N,
                                   int H, float forget_bias, void* stream, int* info) {
  if (N <= 0 || H <= 0 || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* z = static_cast<float*>(z_out);
  const int cw = copy_width(H, dtype == 0 ? 4 : 2, h, w_t);
  info[0] = ((H + J - 1) / J) * S * ((N + NT - 1) / NT);
  info[1] = S;
  info[2] = cw;
  info[3] = NT;
  if (dtype == 0) {
    switch (cw) {
      case 16: return launch_fwd<float, 16>(zx, h, c, w_t, h_out, c_out, z, N, H, forget_bias, s);
      case 8: return launch_fwd<float, 8>(zx, h, c, w_t, h_out, c_out, z, N, H, forget_bias, s);
      case 4: return launch_fwd<float, 4>(zx, h, c, w_t, h_out, c_out, z, N, H, forget_bias, s);
      default: return (int)cudaErrorInvalidValue;  // an f32 base off a 4-byte boundary
    }
  }
  return dtype == 1 ? launch_fwd16<__nv_bfloat16>(cw, zx, h, c, w_t, h_out, c_out, z, N, H,
                                                  forget_bias, s)
                    : launch_fwd16<__half>(cw, zx, h, c, w_t, h_out, c_out, z, N, H,
                                           forget_bias, s);
}

namespace {

// the backward's grid: runs of BWD_THREADS units x batch rows (at most 65,535, the y
// limit; the kernel strides past it); info (2 ints) receives {blocks, threads a block}
dim3 bwd_grid(int N, int H, int* info) {
  const dim3 grid((H + BWD_THREADS - 1) / BWD_THREADS, N < 65535 ? N : 65535);
  info[0] = (int)(grid.x * grid.y);
  info[1] = BWD_THREADS;
  return grid;
}

template <typename T>
void launch_bwd(dim3 grid, const void* z, const void* c, const void* dh, const void* dc,
                void* dz, void* dc_prev, int N, int H, float forget_bias, cudaStream_t s) {
  lstm_cell_bwd<T><<<grid, BWD_THREADS, 0, s>>>(
      static_cast<const float*>(z), static_cast<const T*>(c), static_cast<const T*>(dh),
      static_cast<const T*>(dc), static_cast<float*>(dz), static_cast<T*>(dc_prev), N, H,
      forget_bias);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16 (c, dh, dc, dc_prev); z and dz are f32.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); a bad dtype or size returns
// cudaErrorInvalidValue without launching.  info (2 ints) receives the launch's shape:
// {blocks, threads a block}.
extern "C" int bigdl_lstm_cell_bwd(int dtype, const void* z, const void* c, const void* dh,
                                   const void* dc, void* dz, void* dc_prev, int N, int H,
                                   float forget_bias, void* stream, int* info) {
  if (N <= 0 || H <= 0 || H > (1 << 28) || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = bwd_grid(N, H, info);
  if (dtype == 0)
    launch_bwd<float>(grid, z, c, dh, dc, dz, dc_prev, N, H, forget_bias, s);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(grid, z, c, dh, dc, dz, dc_prev, N, H, forget_bias, s);
  else
    launch_bwd<__half>(grid, z, c, dh, dc, dz, dc_prev, N, H, forget_bias, s);
  return (int)cudaGetLastError();
}

// An empty kernel launched with the grid and block bigdl_lstm_cell_bwd would launch for the
// same arguments (its launch floor); writes nothing.  Same arguments and info.
extern "C" int bigdl_lstm_cell_bwd_empty(int dtype, const void* z, const void* c,
                                         const void* dh, const void* dc, void* dz,
                                         void* dc_prev, int N, int H, float forget_bias,
                                         void* stream, int* info) {
  (void)z, (void)c, (void)dh, (void)dc, (void)dz, (void)dc_prev, (void)forget_bias;
  if (N <= 0 || H <= 0 || H > (1 << 28) || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  lstm_cell_bwd_empty<<<bwd_grid(N, H, info), BWD_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
