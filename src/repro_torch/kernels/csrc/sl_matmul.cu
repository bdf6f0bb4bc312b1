// sl_matmul: y = x @ (scale * B @ A  (+)  V) for one SLTrain linear.
//
// Replaces the Pallas TPU kernel repro/kernels/sl_matmul.py::sl_matmul
// (pallas_call at sl_matmul.py:77, body _kernel at :33).
//
// Shapes: x (M, K), B (K, r), A (r, N), all of one dtype T (bf16 or f32);
// V in tile-CSR form: v_t f32, rows_t / cols_t int32, each
// (nkt, nnt, cap) with nkt = ceil(K/128), nnt = ceil(N/128); entries are
// local to their 128x128 tile, padding slots sit at (0, 0) with v = 0.
// Output y (M, N) in T.
//
// Rounding points, as in the TPU kernel: each W tile is built in f32
// (low-rank product times scale, plus the sparse values), rounded once
// to T, then multiplied by x with f32 accumulation; the sum over K tiles
// is taken in f32 in ascending tile order and rounded to T at the end.
//
// What bounds it on the H100: densifying a tile costs 128*128*r
// multiply-adds, while the product itself costs M*128*128. At decode
// (M = a few slots) the densify work is all there is: about 1.24 TFLOP per
// llama_1b decode step against 2*M*K*N for the product, so the kernel is
// bound by operations, not bytes (it reads only the factors and the
// tile-CSR arrays; W never reaches device memory). At training (M = 2048
// tokens) the product dominates: 2*M*K*N against 2*K*N*r for the densify.
// This first version runs both on the CUDA cores in f32 (register-tiled
// 128x128x32 steps from shared memory); moving them to the tensor cores
// (wgmma on bf16 operands with f32 accumulation) is the next step.
//
// Design against the pitfalls of the translation:
// * The TPU grid walked K sequentially into one accumulator. Here every
//   (k-tile, n-tile[, row block]) is its own block, writing an f32 partial
//   (nkt, M, N); a second kernel sums the partials over k-tiles in order.
//   That fills the card at decode (688 blocks for 2048 -> 5461) and keeps
//   the result deterministic (no float atomics in device memory).
// * Padding slots of different tiles and real entries may share local
//   (0, 0). The sparse values go into the shared-memory tile with
//   atomicAdd, so no update is lost; adding 0 leaves a value unchanged.
// * K and N need not be multiples of 128 (llama_1b d_ff = 5461): every
//   load of x, B and A is bounds-checked and scalar, so nothing is padded
//   or copied and no misaligned vector load can happen.
// * Up to 32 rows (a decode batch, a short prefill) one block covers all
//   of x's rows (sl_tile_kernel, RPT * 2 rows), so each tile is densified
//   once per call. Above that (prefill buckets, training's 2048 tokens and
//   the backward's dx call on the transposed factors) one block per tile
//   densifies it once and loops over 128-row blocks of x
//   (sl_tile_loop_kernel); re-densifying per row block would cost
//   M/128 times the densify work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;        // W tile edge (support.TILE)
constexpr int RK = 32;           // rank chunk staged in shared memory
constexpr int BST = TILE + 1;    // padded row stride of the B chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Densify the (kt, nt) W tile into Wt (f32, [TILE][TILE]): scale * B·A in
// f32 plus the tile's sparse values, rounded once to T. Bs and As are the
// rank-chunk staging buffers. Ends with a __syncthreads().
template <typename T>
__device__ __forceinline__ void densify_tile(
    const T* __restrict__ B, const T* __restrict__ A,
    const float* __restrict__ v_t, const int* __restrict__ rows_t,
    const int* __restrict__ cols_t, float* Wt, float* Bs, float* As, int kt,
    int nt, int nnt, int K, int N, int r, int cap, float scale) {
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // -- low-rank tile: scale * B[k0:k0+128, :] @ A[:, n0:n0+128] in f32 --
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < r; r0 += RK) {
    for (int e = tid; e < RK * TILE; e += THREADS) {
      const int kk = e % RK, i = e / RK;
      const int gr = k0 + i, gc = r0 + kk;
      Bs[kk * BST + i] =
          (gr < K && gc < r) ? to_f(B[(size_t)gr * r + gc]) : 0.f;
    }
    for (int e = tid; e < RK * TILE; e += THREADS) {
      const int j = e % TILE, kk = e / TILE;
      const int gr = r0 + kk, gc = n0 + j;
      As[kk * TILE + j] =
          (gr < r && gc < N) ? to_f(A[(size_t)gr * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < RK; ++kk) {
      float b[8], a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = Bs[kk * BST + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = As[kk * TILE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(b[i], a[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Wt[(ty + 16 * i) * TILE + tx + 16 * j] = acc[i][j] * scale;
  __syncthreads();

  // -- sparse values of this tile (shared atomics: padding slots and a
  //    real entry may all sit at local (0, 0)) --
  const size_t tbase = ((size_t)kt * nnt + nt) * (size_t)cap;
  for (int e = tid; e < cap; e += THREADS) {
    atomicAdd(&Wt[rows_t[tbase + e] * TILE + cols_t[tbase + e]],
              v_t[tbase + e]);
  }
  __syncthreads();

  // -- round the tile to T once --
  for (int e = tid; e < TILE * TILE; e += THREADS) Wt[e] = round_to<T>(Wt[e]);
  __syncthreads();
}

// One (k-tile, n-tile, row block) for small M: densify the W tile in
// shared memory, multiply the row block of x by it, write the f32
// partial. RPT = rows of x per thread; a block covers 2 * RPT rows.
template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS, 2)
sl_tile_kernel(const T* __restrict__ x, const T* __restrict__ B,
               const T* __restrict__ A, const float* __restrict__ v_t,
               const int* __restrict__ rows_t, const int* __restrict__ cols_t,
               float* __restrict__ partial, int M, int K, int N, int r,
               int cap, float scale) {
  extern __shared__ float smem[];
  float* Wt = smem;                       // [TILE][TILE]
  float* Bs = Wt + TILE * TILE;           // [RK][BST]  (B chunk, transposed)
  float* As = Bs + RK * BST;              // [RK][TILE]
  float* xs = As + RK * TILE;             // [2 * RPT][TILE]

  const int nt = blockIdx.x, kt = blockIdx.y;
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int m0 = blockIdx.z * (2 * RPT);
  const int tid = threadIdx.x;

  densify_tile<T>(B, A, v_t, rows_t, cols_t, Wt, Bs, As, kt, nt, gridDim.x,
                  K, N, r, cap, scale);

  // -- stage the row block of x --
  const int rows = min(2 * RPT, M - m0);
  for (int e = tid; e < rows * TILE; e += THREADS) {
    const int m = e / TILE, kk = e % TILE;
    xs[m * TILE + kk] =
        (k0 + kk < K) ? to_f(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
  }
  __syncthreads();

  // -- partial[kt, m0 + m, n0 + c] = sum_kk x[m, kk] * W[kk, c] (f32) --
  const int c = tid % TILE, rg = tid / TILE;
  float o[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) o[i] = 0.f;
  for (int kk = 0; kk < TILE; ++kk) {
    const float w = Wt[kk * TILE + c];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = rg + 2 * i;
      if (m < rows) o[i] = fmaf(xs[m * TILE + kk], w, o[i]);
    }
  }
  if (n0 + c < N) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = rg + 2 * i;
      if (m < rows)
        partial[((size_t)kt * M + m0 + m) * N + n0 + c] = o[i];
    }
  }
}

// One (k-tile, n-tile) for large M: densify the W tile once, then walk x
// in blocks of 128 rows, each a register-tiled 128x128 product (8x8
// outputs a thread) with x staged transposed, RK columns at a time, in
// the densify's B buffer. Every output sums kk = 0..127 in order with
// fmaf, as sl_tile_kernel does, so both variants give the same bits.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
sl_tile_loop_kernel(const T* __restrict__ x, const T* __restrict__ B,
                    const T* __restrict__ A, const float* __restrict__ v_t,
                    const int* __restrict__ rows_t,
                    const int* __restrict__ cols_t,
                    float* __restrict__ partial, int M, int K, int N, int r,
                    int cap, float scale) {
  extern __shared__ float smem[];
  float* Wt = smem;                       // [TILE][TILE]
  float* Bs = Wt + TILE * TILE;           // [RK][BST]  (B, then x, chunks)
  float* As = Bs + RK * BST;              // [RK][TILE]

  const int nt = blockIdx.x, kt = blockIdx.y;
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  densify_tile<T>(B, A, v_t, rows_t, cols_t, Wt, Bs, As, kt, nt, gridDim.x,
                  K, N, r, cap, scale);

  for (int m0 = 0; m0 < M; m0 += TILE) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < TILE; c0 += RK) {
      // xs[kk][i] = x[m0 + i, k0 + c0 + kk]
      for (int e = tid; e < RK * TILE; e += THREADS) {
        const int kk = e % RK, i = e / RK;
        const int gr = m0 + i, gc = k0 + c0 + kk;
        Bs[kk * BST + i] =
            (gr < M && gc < K) ? to_f(x[(size_t)gr * K + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < RK; ++kk) {
        float b[8], a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) b[i] = Bs[kk * BST + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          a[j] = Wt[(c0 + kk) * TILE + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(b[i], a[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) partial[((size_t)kt * M + m) * N + n] = acc[i][j];
      }
    }
  }
}

// y[m, n] = T(sum over k-tiles, in order, of partial[kt, m, n]).
template <typename T>
__global__ void sl_reduce_kernel(const float* __restrict__ partial,
                                 T* __restrict__ y, int nkt, size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int kt = 0; kt < nkt; ++kt) s += partial[(size_t)kt * mn + i];
  y[i] = from_f<T>(s);
}

template <typename T, int RPT>
cudaError_t launch_rpt(const void* x, const void* B, const void* A,
                       const float* v_t, const int* rows_t,
                       const int* cols_t, float* partial, int M, int K,
                       int N, int r, int nkt, int nnt, int cap, float scale,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (TILE * TILE + RK * BST + RK * TILE + 2 * RPT * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      sl_tile_kernel<T, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nnt, nkt, (M + 2 * RPT - 1) / (2 * RPT));
  sl_tile_kernel<T, RPT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(B),
      static_cast<const T*>(A), v_t, rows_t, cols_t, partial, M, K, N, r,
      cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_loop(const void* x, const void* B, const void* A,
                        const float* v_t, const int* rows_t,
                        const int* cols_t, float* partial, int M, int K,
                        int N, int r, int nkt, int nnt, int cap, float scale,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * (TILE * TILE + RK * BST + RK * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      sl_tile_loop_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nnt, nkt, 1);
  sl_tile_loop_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(B),
      static_cast<const T*>(A), v_t, rows_t, cols_t, partial, M, K, N, r,
      cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* B, const void* A,
                   const float* v_t, const int* rows_t, const int* cols_t,
                   float* partial, void* y, int M, int K, int N, int r,
                   int nkt, int nnt, int cap, float scale,
                   cudaStream_t stream) {
  cudaError_t err;
  if (M <= 8)
    err = launch_rpt<T, 4>(x, B, A, v_t, rows_t, cols_t, partial, M, K, N, r,
                           nkt, nnt, cap, scale, stream);
  else if (M <= 32)
    err = launch_rpt<T, 16>(x, B, A, v_t, rows_t, cols_t, partial, M, K, N,
                            r, nkt, nnt, cap, scale, stream);
  else
    err = launch_loop<T>(x, B, A, v_t, rows_t, cols_t, partial, M, K, N, r,
                         nkt, nnt, cap, scale, stream);
  if (err != cudaSuccess) return err;
  const size_t mn = (size_t)M * N;
  const int threads = 256;
  sl_reduce_kernel<T><<<(unsigned)((mn + threads - 1) / threads), threads, 0,
                        stream>>>(partial, static_cast<T*>(y), nkt, mn);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bf16.
// partial: caller-allocated f32 scratch of nkt * M * N elements.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int sl_matmul_launch(const void* x, const void* B, const void* A,
                                const float* v_t, const int* rows_t,
                                const int* cols_t, float* partial, void* y,
                                int M, int K, int N, int r, int nkt, int nnt,
                                int cap, float scale, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, B, A, v_t, rows_t, cols_t, partial,
                                      y, M, K, N, r, nkt, nnt, cap, scale, s);
  return (int)launch<float>(x, B, A, v_t, rows_t, cols_t, partial, y, M, K,
                            N, r, nkt, nnt, cap, scale, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
