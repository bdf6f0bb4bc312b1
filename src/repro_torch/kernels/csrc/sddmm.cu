// sddmm: dv tiles = (x^T dy) sampled at the SLTrain support, the dV half
// of the fused linear's backward.
//
// Replaces the Pallas TPU kernel repro/kernels/sddmm.py::sddmm
// (pallas_call at sddmm.py:57, body _kernel at :23).
//
// Shapes: x (M, K) and dy (M, N), both of one dtype T (bf16 or f32; the
// wrapper casts dy to x's dtype first); rows_t / cols_t int32, each
// (nkt, nnt, cap) with nkt = ceil(K/128), nnt = ceil(N/128), entries local
// to their 128x128 tile. Output dv_t f32 (nkt, nnt, cap):
//   dv_t[kt, nt, e] = sum_m x[m, kt*128 + rows_t[kt,nt,e]]
//                         * dy[m, nt*128 + cols_t[kt,nt,e]].
// Padding slots sit at local (0, 0) and get G there, as on the TPU; the
// backward drops them through perm.
//
// Rounding points, as in the TPU kernel: products of T values in f32
// (exact for bf16), sums over tokens in f32. Each slot's sum runs in
// ascending m in one thread's register, so the result is deterministic.
//
// Design. The TPU forms each whole 128x128 G tile on the MXU and gathers
// it with one-hot matmuls, because it cannot gather in VMEM. Hopper can
// index shared memory, so this kernel samples: it computes only the
// support's entries, about delta = 3% of the tile's arithmetic, and G
// never exists, not even per tile. One thread block per (k-tile, n-tile)
// (688 blocks for 2048 -> 5461) walks M in chunks of MC rows, staging
// x[chunk, k-tile] and dy[chunk, n-tile] in shared memory as f32; each
// thread owns SPT slots of the tile and accumulates them in registers.
// A tile with more than SPT * THREADS slots is split over blockIdx.z.
//
// What bounds it on the H100: 2 * M * (nkt * nnt * cap) operations on the
// CUDA cores against reading x and dy once (each block re-reads its
// row strip of x and column strip of dy from L2). At llama_1b training
// shapes both are small; the random shared-memory reads (bank conflicts)
// and the scalar loads set its time. Every load is bounds-checked, so the
// ragged K/N edge (d_ff = 5461) and any M need no padding copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // tile edge (support.TILE)
constexpr int THREADS = 256;
constexpr int SPT = 4;        // slots per thread
constexpr int MC = 32;        // token rows staged per chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             const int* __restrict__ rows_t, const int* __restrict__ cols_t,
             float* __restrict__ out, int M, int K, int N, int cap) {
  __shared__ float xs[MC * TILE];
  __shared__ float ds[MC * TILE];

  const int nt = blockIdx.x, kt = blockIdx.y;
  const int nnt = gridDim.x;
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int tid = threadIdx.x;
  const size_t tbase = ((size_t)kt * nnt + nt) * (size_t)cap;
  const int e0 = blockIdx.z * (SPT * THREADS) + tid;

  int r[SPT], c[SPT];
  float acc[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int e = e0 + s * THREADS;
    r[s] = e < cap ? rows_t[tbase + e] : 0;
    c[s] = e < cap ? cols_t[tbase + e] : 0;
    acc[s] = 0.f;
  }

  for (int m0 = 0; m0 < M; m0 += MC) {
    const int rows = min(MC, M - m0);
    for (int i = tid; i < MC * TILE; i += THREADS) {
      const int m = i / TILE, j = i % TILE;
      const bool live = m < rows;
      xs[i] = (live && k0 + j < K) ? to_f(x[(size_t)(m0 + m) * K + k0 + j])
                                   : 0.f;
      ds[i] = (live && n0 + j < N) ? to_f(dy[(size_t)(m0 + m) * N + n0 + j])
                                   : 0.f;
    }
    __syncthreads();
    for (int m = 0; m < rows; ++m) {
      const float* xr = xs + m * TILE;
      const float* dr = ds + m * TILE;
#pragma unroll
      for (int s = 0; s < SPT; ++s) acc[s] = fmaf(xr[r[s]], dr[c[s]], acc[s]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int e = e0 + s * THREADS;
    if (e < cap) out[tbase + e] = acc[s];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const int* rows_t,
                   const int* cols_t, float* out, int M, int K, int N,
                   int nkt, int nnt, int cap, cudaStream_t stream) {
  const int groups = (cap + SPT * THREADS - 1) / (SPT * THREADS);
  const dim3 grid(nnt, nkt, groups);
  sddmm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), rows_t, cols_t,
      out, M, K, N, cap);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bf16.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sddmm_launch(const void* x, const void* dy, const int* rows_t,
                            const int* cols_t, float* out, int M, int K,
                            int N, int nkt, int nnt, int cap, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dy, rows_t, cols_t, out, M, K, N,
                                      nkt, nnt, cap, s);
  return (int)launch<float>(x, dy, rows_t, cols_t, out, M, K, N, nkt, nnt,
                            cap, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
