// sparse_decode: the sparse term of SLTrain's factored decode.
//
//   sparse_matmul        y = x @ S            (S as f32 tile-CSR)
//   quant_sparse_matmul  y = x @ dequant(S)   (S as int8 codes, int16
//                                              tile-local indices and a
//                                              per-output-channel scale)
//
// Replace the Pallas TPU kernels repro/kernels/sparse_decode.py::
// sparse_matmul (pallas_call at sparse_decode.py:66, body _kernel at :33)
// and ::quant_sparse_matmul (pallas_call at :125, body _qkernel at :80).
//
// Shapes: x (M, K) in T (bf16 or f32), y (M, N) in T. S in tile-CSR form,
// each array (nkt, nnt, cap) with nkt = ceil(K/128), nnt = ceil(N/128):
// sparse_matmul reads v_t f32 and rows_t / cols_t int32; quant_sparse_
// matmul reads qv_t int8, rows_q / cols_q int16 and qscale f32 (nnt, 128).
// Entries are local to their 128x128 tile; padding slots sit at (0, 0)
// with a value (or code) of 0.
//
// Rounding points, as in the TPU kernels: every product and sum is f32 and
// y is rounded to T once. A dequantized value is code * qscale[column], one
// f32 multiply: the TPU kernel builds the tile of codes (each cell holds
// one code, plus exact zeros from padding) and multiplies its columns by
// the scale row, which gives the same bits as multiplying each code by its
// column's scale as it is scattered.
//
// What bounds it on the H100: at decode (M = a few slots) the work is
// 2 * M * nnz operations on 12 bytes (f32 value, two int32 indices) or 5
// bytes (int8 code, two int16 indices) per slot, so the kernel is bound by
// bytes: at llama_1b's 2048 -> 5461 (cap 688, 473,344 slots) 5.68 MB or
// 2.37 MB plus scales, 1.7 or 0.7 us at 3.35 TB/s. Each decode step
// launches it 168 times, so at these sizes launch overhead dominates.
//
// Design (a first version: right and deterministic, not yet fast):
// * The TPU grid walks the k-tiles sequentially into one accumulator. Here
//   one block owns one (n-tile, row block of x) and loops over the
//   k-tiles in order, each thread keeping its outputs' f32 sums in
//   registers: one fmaf chain over k = 0..K-1 per output, so the result is
//   the same bits on every run (the serving tests compare greedy tokens).
// * Each k-tile of S is scattered into a 128x128 f32 tile in shared memory
//   (64 KB) and contracted with the staged row block of x. Real entries are
//   unique; padding slots all land on (0, 0), possibly on a real entry, so
//   the scatter uses shared atomicAdd, and adding 0 changes nothing. After
//   the contraction each thread writes 0 back at its slots, so the tile is
//   all zero again without clearing all 16K cells per k-tile.
// * K and N need not be multiples of 128 (llama_1b d_ff = 5461): x's loads
//   are bounds-checked and y's stores masked, so nothing is padded or
//   copied. Up to 8 rows one block covers all of x (RPT = 4); above that
//   blocks of 32 rows (RPT = 16) cover the prefill's 32, 64, 128 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;        // S tile edge (support.TILE)
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

// The value of slot e (global slot index) in column c of n-tile nt.
struct F32Values {
  const float* __restrict__ v;
  __device__ __forceinline__ float operator()(size_t e, int, int) const {
    return v[e];
  }
};

struct Int8Values {
  const int8_t* __restrict__ q;
  const float* __restrict__ scale;     // (nnt, TILE)
  __device__ __forceinline__ float operator()(size_t e, int nt,
                                              int c) const {
    return __fmul_rn(static_cast<float>(q[e]), scale[nt * TILE + c]);
  }
};

// One (n-tile, row block of x): y[m0 + m, n0 + c] = sum over k of
// x[m0 + m, k] * S[k, n0 + c]. RPT = rows of x per thread; a block covers
// 2 * RPT rows, thread t owns column t % 128 and rows t / 128 + 2i.
template <typename T, typename I, typename Values, int RPT>
__global__ void __launch_bounds__(THREADS)
sparse_decode_kernel(const T* __restrict__ x, Values values,
                     const I* __restrict__ rows_t,
                     const I* __restrict__ cols_t, T* __restrict__ y, int M,
                     int K, int N, int nkt, int nnt, int cap) {
  extern __shared__ float smem[];
  float* St = smem;                       // [TILE][TILE] k-tile of S
  float* xs = St + TILE * TILE;           // [2 * RPT][TILE] rows of x

  const int nt = blockIdx.x;
  const int n0 = nt * TILE;
  const int m0 = blockIdx.y * (2 * RPT);
  const int tid = threadIdx.x;
  const int nrows = min(2 * RPT, M - m0);
  const int c = tid % TILE, rg = tid / TILE;

  float4* St4 = reinterpret_cast<float4*>(St);
  for (int e = tid; e < TILE * TILE / 4; e += THREADS)
    St4[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  float o[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) o[i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TILE;
    for (int e = tid; e < nrows * TILE; e += THREADS) {
      const int m = e / TILE, kk = e % TILE;
      xs[m * TILE + kk] =
          (k0 + kk < K) ? to_f(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();            // the tile is zero, x's rows are staged

    const size_t tbase = ((size_t)kt * nnt + nt) * (size_t)cap;
    for (int e = tid; e < cap; e += THREADS) {
      const int cc = cols_t[tbase + e];
      atomicAdd(&St[(int)rows_t[tbase + e] * TILE + cc],
                values(tbase + e, nt, cc));
    }
    __syncthreads();

    for (int kk = 0; kk < TILE; ++kk) {
      const float w = St[kk * TILE + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int m = rg + 2 * i;
        if (m < nrows) o[i] = fmaf(xs[m * TILE + kk], w, o[i]);
      }
    }
    __syncthreads();            // every thread is done reading the tile

    for (int e = tid; e < cap; e += THREADS)
      St[(int)rows_t[tbase + e] * TILE + cols_t[tbase + e]] = 0.f;
    // the next iteration's first barrier orders these stores before its
    // scatter
  }

  if (n0 + c < N) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = rg + 2 * i;
      if (m < nrows) y[(size_t)(m0 + m) * N + n0 + c] = from_f<T>(o[i]);
    }
  }
}

template <typename T, typename I, typename Values, int RPT>
cudaError_t launch_rpt(const void* x, Values values, const I* rows_t,
                       const I* cols_t, void* y, int M, int K, int N,
                       int nkt, int nnt, int cap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (TILE * TILE + 2 * RPT * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_decode_kernel<T, I, Values, RPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nnt, (M + 2 * RPT - 1) / (2 * RPT), 1);
  sparse_decode_kernel<T, I, Values, RPT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), values, rows_t, cols_t, static_cast<T*>(y),
      M, K, N, nkt, nnt, cap);
  return cudaGetLastError();
}

template <typename T, typename I, typename Values>
cudaError_t launch(const void* x, Values values, const I* rows_t,
                   const I* cols_t, void* y, int M, int K, int N, int nkt,
                   int nnt, int cap, cudaStream_t stream) {
  if (M <= 8)
    return launch_rpt<T, I, Values, 4>(x, values, rows_t, cols_t, y, M, K,
                                       N, nkt, nnt, cap, stream);
  return launch_rpt<T, I, Values, 16>(x, values, rows_t, cols_t, y, M, K, N,
                                      nkt, nnt, cap, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bf16.
// Each returns the cudaError_t of its launch (0 = success).
extern "C" int sparse_matmul_launch(const void* x, const float* v_t,
                                    const int* rows_t, const int* cols_t,
                                    void* y, int M, int K, int N, int nkt,
                                    int nnt, int cap, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const F32Values values{v_t};
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, values, rows_t, cols_t, y, M, K, N,
                                      nkt, nnt, cap, s);
  return (int)launch<float>(x, values, rows_t, cols_t, y, M, K, N, nkt, nnt,
                            cap, s);
}

extern "C" int quant_sparse_matmul_launch(
    const void* x, const int8_t* qv_t, const int16_t* rows_q,
    const int16_t* cols_q, const float* qscale, void* y, int M, int K, int N,
    int nkt, int nnt, int cap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Int8Values values{qv_t, qscale};
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, values, rows_q, cols_q, y, M, K, N,
                                      nkt, nnt, cap, s);
  return (int)launch<float>(x, values, rows_q, cols_q, y, M, K, N, nkt, nnt,
                            cap, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
