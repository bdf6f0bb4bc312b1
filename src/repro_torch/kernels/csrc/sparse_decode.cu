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
// What bounds them on the H100: at decode (M = a few slots) the work is
// 2 * M * nnz operations on 12 bytes (f32 value, two int32 indices) or 5
// bytes (int8 code, two int16 indices) per slot, so the kernels are bound
// by bytes: at llama_1b's 2048 -> 5461 (cap 688, 473,344 slots) 5.68 MB or
// 2.37 MB plus scales, 1.7 or 0.7 us at 3.35 TB/s. Each decode step
// launches one of them 168 times. What a launch really waits on is one
// block's chain of k-tiles: each k-tile is a dependent HBM load of its
// slots, a scatter, a contraction and a clean-up, each behind a barrier.
//
// The kernel scatters each k-tile of S into a 128x128 f32 tile in shared
// memory (64 KB) and contracts it with the staged rows of x. Real entries
// are unique; padding slots all land on (0, 0), possibly on a real entry,
// so the scatter uses shared atomicAdd, and adding 0 changes nothing.
// After the contraction each thread writes 0 back at its slots, so the
// tile is all zero again without clearing all 16K cells per k-tile. K and
// N need not be multiples of 128 (llama_1b d_ff = 5461): x's loads are
// bounds-checked and y's stores masked, so nothing is padded or copied. Up
// to 4 rows (the engine's decode batch) or 8 rows one block covers all of
// x; above that blocks of 32 rows cover the prefill's 32, 64, 128 rows.
//
// Both kernels run sparse_split_kernel, one template over the source of
// the values and the index type (F32Values with int32 indices for
// sparse_matmul, Int8Values with int16 indices for quant_sparse_matmul).
// It fills the card by splitting K: the grid is (n-tiles, row blocks,
// splits), and block z walks the k-tiles [z * nkt / splits, (z + 1) * nkt
// / splits) of its n-tile. The wrapper's plan (kernels/sparse_decode.py::
// plan) picks the fewest splits that put about two blocks on every SM, at
// most one per k-tile: 301 blocks of 2-3 k-tiles at decode 2048 -> 5461
// instead of 43 blocks of 16; one split where the row blocks already fill
// the grid. Inside a block:
// * a block fetches its next k-tile's slots and x's rows into registers
//   while it contracts the current one, so only the first k-tile waits on
//   HBM, and skips the padding slots' zero values in the scatter (~200 of
//   them a tile contend for cell (0, 0));
// * the contraction is bound by shared-memory loads, not by its fmafs:
//   each thread takes one column and half of the tile's 128 k for all R
//   rows of the block (4 up to 4 rows, 8, or 32), reading S once per k
//   and x as float4 broadcasts: 64 + 16 R loads a k-tile instead of the
//   first version's (1 + R / 2) * 128.
// Numerics of the split sum: each thread keeps one f32 fmaf chain per
// output over its half of each k-tile, k-tiles in order; the two halves
// are added, first half first. Each split writes that sum to an f32
// partial (splits, M, N) in wrapper-allocated scratch; the last block of
// an (n-tile, row block) to finish -- found through an int32 counter in
// scratch, after __threadfence -- adds the partials in split order, 0
// first, rounds once to T, and resets the counter to 0 for the next
// launch. No float atomics touch device memory, so a rerun gives the same
// bits; only the order of the k sum differs from the reference's. With
// one split the block writes y from its sum directly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "once_per_device.cuh"

namespace {

constexpr int TILE = 128;        // S tile edge (support.TILE)
constexpr int THREADS = 256;
constexpr int PREF = 4;          // slots a thread holds in registers

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

// ---------------------------------------------------------------------------
// the values of S: slot e (global slot index) in column c of n-tile nt
// ---------------------------------------------------------------------------

// sparse_matmul: f32 values as they are
struct F32Values {
  const float* __restrict__ v;
  __device__ __forceinline__ float operator()(size_t e, int, int) const {
    return v[e];
  }
};

// quant_sparse_matmul: the int8 code times its column's scale, one f32
// multiply
struct Int8Values {
  const int8_t* __restrict__ q;
  const float* __restrict__ scale;     // (nnt, TILE)
  __device__ __forceinline__ float operator()(size_t e, int nt,
                                              int c) const {
    return __fmul_rn(static_cast<float>(q[e]), scale[nt * TILE + c]);
  }
};

// ---------------------------------------------------------------------------
// split K, ordered sum of the partials
// ---------------------------------------------------------------------------

// One (n-tile, row block, split): block z sums the k-tiles [kt0, kt1) of
// its n-tile for R rows of x. Thread t owns column c = t % 128 and half
// h = t / 128 of each k-tile's 128 rows of S, for all R rows of x: one
// f32 fmaf chain per (row, column, half) over the k-tiles in order, the
// two halves added (h = 0 first) at the end. With gridDim.z > 1 the block
// writes that sum to partial[z], and the last block of the (n-tile, row
// block) adds partial[0..splits) in order into y.
template <typename T, typename I, typename Values, int R>
__global__ void __launch_bounds__(THREADS)
sparse_split_kernel(const T* __restrict__ x, Values values,
                    const I* __restrict__ rows_t,
                    const I* __restrict__ cols_t, T* __restrict__ y,
                    float* __restrict__ partial, int* __restrict__ counter,
                    int M, int K, int N, int nkt, int nnt, int cap) {
  constexpr int XR = R * TILE / THREADS;  // x values a thread stages
  constexpr int HALF = TILE / 2;
  extern __shared__ float smem[];
  float* St = smem;                       // [TILE][TILE] k-tile of S
  float* xs = St + TILE * TILE;           // [R][TILE] rows of x, zero-padded
  __shared__ int is_last;

  const int nt = blockIdx.x;
  const int n0 = nt * TILE;
  const int m0 = blockIdx.y * R;
  const int splits = gridDim.z, z = blockIdx.z;
  const int kt0 = (int)((long long)z * nkt / splits);
  const int kt1 = (int)((long long)(z + 1) * nkt / splits);
  const int tid = threadIdx.x;
  const int nrows = min(R, M - m0);
  const int c = tid % TILE, h = tid / TILE;

  // a k-tile's operands, in registers: its first PREF * THREADS slots (the
  // cell each one lands on, -1 past cap, and its value) and x's rows
  int cell[PREF];
  float val[PREF], xr[XR];
  auto fetch = [&](int kt) {
    const size_t tb = ((size_t)kt * nnt + nt) * (size_t)cap;
#pragma unroll
    for (int i = 0; i < PREF; ++i) {
      const int e = tid + i * THREADS;
      cell[i] = -1;
      val[i] = 0.f;
      if (e < cap) {
        const int cc = cols_t[tb + e];
        cell[i] = (int)rows_t[tb + e] * TILE + cc;
        val[i] = values(tb + e, nt, cc);
      }
    }
#pragma unroll
    for (int i = 0; i < XR; ++i) {
      const int e = tid + i * THREADS, m = e / TILE;
      const int k = kt * TILE + e % TILE;
      xr[i] = m < nrows && k < K ? to_f(x[(size_t)(m0 + m) * K + k]) : 0.f;
    }
  };
  if (kt0 < kt1) fetch(kt0);   // in flight while the tile is zeroed

  float4* St4 = reinterpret_cast<float4*>(St);
  for (int e = tid; e < TILE * TILE / 4; e += THREADS)
    St4[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  float o[R];
#pragma unroll
  for (int m = 0; m < R; ++m) o[m] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
#pragma unroll
    for (int i = 0; i < XR; ++i) xs[tid + i * THREADS] = xr[i];
    __syncthreads();            // the tile is zero, x's rows are staged

    const size_t tb = ((size_t)kt * nnt + nt) * (size_t)cap;
    int mine[PREF];
#pragma unroll
    for (int i = 0; i < PREF; ++i) {
      mine[i] = cell[i];
      if (val[i] != 0.f) atomicAdd(&St[cell[i]], val[i]);
    }
    for (int e = PREF * THREADS + tid; e < cap; e += THREADS) {
      const int cc = cols_t[tb + e];
      const float v = values(tb + e, nt, cc);
      if (v != 0.f) atomicAdd(&St[(int)rows_t[tb + e] * TILE + cc], v);
    }
    if (kt + 1 < kt1) fetch(kt + 1);   // in flight during the contraction
    __syncthreads();

    // o[m] += x[m, k] * S[k, c] for this half's 64 k in order, x read as
    // float4 broadcasts (every lane of a warp reads the same address)
    const float* Sh = St + h * HALF * TILE + c;
    const float* xh = xs + h * HALF;
    for (int k4 = 0; k4 < HALF; k4 += 4) {
      const float w0 = Sh[(k4 + 0) * TILE], w1 = Sh[(k4 + 1) * TILE];
      const float w2 = Sh[(k4 + 2) * TILE], w3 = Sh[(k4 + 3) * TILE];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xh + m * TILE + k4);
        o[m] = fmaf(xv.x, w0, o[m]);
        o[m] = fmaf(xv.y, w1, o[m]);
        o[m] = fmaf(xv.z, w2, o[m]);
        o[m] = fmaf(xv.w, w3, o[m]);
      }
    }
    __syncthreads();            // every thread is done reading the tile

#pragma unroll
    for (int i = 0; i < PREF; ++i)
      if (mine[i] >= 0) St[mine[i]] = 0.f;
    for (int e = PREF * THREADS + tid; e < cap; e += THREADS)
      St[(int)rows_t[tb + e] * TILE + cols_t[tb + e]] = 0.f;
    // the next iteration's first barrier orders these stores before its
    // scatter
  }

  // the second half's sums join the first's through shared memory
  float* red = xs;              // [R][TILE]; x is no longer needed
  __syncthreads();
  if (h == 1) {
#pragma unroll
    for (int m = 0; m < R; ++m) red[m * TILE + c] = o[m];
  }
  __syncthreads();
  const bool col_ok = h == 0 && n0 + c < N;
  if (col_ok) {
#pragma unroll
    for (int m = 0; m < R; ++m) o[m] += red[m * TILE + c];
  }

  if (splits == 1) {
    if (col_ok) {
#pragma unroll
      for (int m = 0; m < R; ++m)
        if (m < nrows) y[(size_t)(m0 + m) * N + n0 + c] = from_f<T>(o[m]);
    }
    return;
  }

  if (col_ok) {
    float* pz = partial + (size_t)z * M * N;
#pragma unroll
    for (int m = 0; m < R; ++m)
      if (m < nrows) pz[(size_t)(m0 + m) * N + n0 + c] = o[m];
  }
  __threadfence();              // the partial is visible before the count
  __syncthreads();
  if (tid == 0) {
    int* cnt = counter + blockIdx.y * nnt + nt;
    is_last = atomicAdd(cnt, 1) == splits - 1;
    if (is_last) *cnt = 0;      // every split has counted: reset for the
  }                             // next launch
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (col_ok) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (m >= nrows) continue;
      const size_t at = (size_t)(m0 + m) * N + n0 + c;
      float s = __ldcg(partial + at);
      for (int zz = 1; zz < splits; ++zz)
        s += __ldcg(partial + (size_t)zz * M * N + at);
      y[at] = from_f<T>(s);
    }
  }
}

template <typename T, typename I, typename Values, int R>
cudaError_t launch_split(const void* x, Values values, const I* rows_t,
                         const I* cols_t, void* y, float* partial,
                         int* counter, int M, int K, int N, int nkt, int nnt,
                         int cap, int splits, cudaStream_t stream) {
  static OncePerDevice smem_attr;
  constexpr size_t smem = sizeof(float) * (TILE * TILE + R * TILE);
  cudaError_t err = smem_attr([] {
    return cudaFuncSetAttribute(sparse_split_kernel<T, I, Values, R>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  });
  if (err != cudaSuccess) return err;
  const dim3 grid(nnt, (M + R - 1) / R, splits);
  sparse_split_kernel<T, I, Values, R><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), values, rows_t, cols_t, static_cast<T*>(y),
      partial, counter, M, K, N, nkt, nnt, cap);
  return cudaGetLastError();
}

template <typename T, typename I, typename Values>
cudaError_t launch_split_rows(const void* x, Values values, const I* rows_t,
                              const I* cols_t, void* y, float* partial,
                              int* counter, int M, int K, int N, int nkt,
                              int nnt, int cap, int rows_per_block,
                              int splits, cudaStream_t stream) {
  if (splits < 1 || splits > (nkt > 0 ? nkt : 1) ||
      (splits > 1 && (partial == nullptr || counter == nullptr)))
    return cudaErrorInvalidValue;
  if (rows_per_block == 4)
    return launch_split<T, I, Values, 4>(x, values, rows_t, cols_t, y,
                                         partial, counter, M, K, N, nkt,
                                         nnt, cap, splits, stream);
  if (rows_per_block == 8)
    return launch_split<T, I, Values, 8>(x, values, rows_t, cols_t, y,
                                         partial, counter, M, K, N, nkt,
                                         nnt, cap, splits, stream);
  if (rows_per_block == 32)
    return launch_split<T, I, Values, 32>(x, values, rows_t, cols_t, y,
                                          partial, counter, M, K, N, nkt,
                                          nnt, cap, splits, stream);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bf16
template <typename I, typename Values>
cudaError_t launch_dtype(int dtype, const void* x, Values values,
                         const I* rows_t, const I* cols_t, void* y,
                         float* partial, int* counter, int M, int K, int N,
                         int nkt, int nnt, int cap, int rows_per_block,
                         int splits, cudaStream_t stream) {
  if (dtype == 1)
    return launch_split_rows<__nv_bfloat16>(x, values, rows_t, cols_t, y,
                                            partial, counter, M, K, N, nkt,
                                            nnt, cap, rows_per_block, splits,
                                            stream);
  return launch_split_rows<float>(x, values, rows_t, cols_t, y, partial,
                                  counter, M, K, N, nkt, nnt, cap,
                                  rows_per_block, splits, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bf16.
// Each returns the cudaError_t of its launch (0 = success).
//
// rows_per_block 4, 8 or 32 and splits (1 .. nkt) come from the wrapper's
// plan; with splits > 1, partial is f32 (splits, M, N) scratch and counter
// holds nnt * ceil(M / rows_per_block) int32 zeros, which the kernel
// leaves at zero.
extern "C" int sparse_matmul_launch(const void* x, const float* v_t,
                                    const int* rows_t, const int* cols_t,
                                    void* y, float* partial, int* counter,
                                    int M, int K, int N, int nkt, int nnt,
                                    int cap, int rows_per_block, int splits,
                                    int dtype, void* stream) {
  return (int)launch_dtype(dtype, x, F32Values{v_t}, rows_t, cols_t, y,
                           partial, counter, M, K, N, nkt, nnt, cap,
                           rows_per_block, splits,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int quant_sparse_matmul_launch(
    const void* x, const int8_t* qv_t, const int16_t* rows_q,
    const int16_t* cols_q, const float* qscale, void* y, float* partial,
    int* counter, int M, int K, int N, int nkt, int nnt, int cap,
    int rows_per_block, int splits, int dtype, void* stream) {
  return (int)launch_dtype(dtype, x, Int8Values{qv_t, qscale}, rows_q,
                           cols_q, y, partial, counter, M, K, N, nkt, nnt,
                           cap, rows_per_block, splits,
                           static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
