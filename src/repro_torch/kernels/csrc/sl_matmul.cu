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
// to T, then multiplied by x with f32 accumulation; the sum over K is
// taken in f32 and rounded to T once at the end. Only the order of the
// f32 sums differs between the variants below.
//
// What bounds it on the H100: densifying a tile costs 128*128*r
// multiply-adds, the product M*128*128. At decode (M = a few slots) the
// densify is all the work there is: 2*K*N*r = 11.45 GFLOP per 2048 ->
// 5461 call at r = 512, so the kernel is bound by operations, not bytes.
// At training (M = 2048 tokens) the product dominates (45.8 GFLOP
// against the same 11.45 for the densify). On the card both loops below
// are fed from L2: each tile block reads 256 KB of factors (176 MB per
// 2048 -> 5461 call) and the GEMM 528 MB there, and that traffic, not
// the tensor cores, sets their pace.
//
// bf16: everything on the tensor cores, behind one call.
// * Densify (densify_tc, shared by both variants): each 128x128 tile is
//   B[k0:k0+128, :r] · A[:r, n0:n0+128] on wgmma m64n128k16 (two
//   warpgroups of 64 rows; bf16 operands read from shared memory, f32
//   accumulation in registers), B's rows the K-major operand and A's
//   rows the transposed (MN-major) one, both 128-byte swizzled. The rank
//   streams in chunks of 64 through a three-stage cp.async ring; ranks
//   past r, rows past K and columns past N load as zeros. The tile's
//   sparse entries are read into registers before the rank loop. The
//   epilogue scales into an f32 tile over the ring, adds the sparse
//   values with shared atomicAdd (a real entry may share local (0, 0)
//   with padding slots; the padding slots, v = 0, are skipped), and only
//   then rounds to bf16.
// * Small M (<= 128 rows: a decode batch, a prefill bucket), one pass
//   (sl_tc_tile_kernel): one block per (k-tile, n-tile) densifies its
//   tile once, rounds it into shared memory and multiplies all of x's
//   rows (padded to 16) by it on mma.sync m16n8k16 (ldmatrix operands),
//   writing an f32 partial (nkt, M, N) that sl_reduce_kernel sums over
//   k-tiles in order. That fills the card at decode (688 blocks at
//   2048 -> 5461) and the partials are small (1.4 MB there).
// * Large M (training's forward and dx), two stages and no partials:
//   sl_tc_densify_kernel writes the rounded tile transposed into a bf16
//   Wt (nnt*128, nkt*128) that the wrapper allocates (22.5 MB at 2048 ->
//   5461, in place of 716 MB of f32 partials); sl_tc_gemm_kernel then
//   computes y = x · W with wgmma m64n256k16 (two warpgroups, a 128x256
//   output tile a block), its k loop over all k-tiles in ascending order
//   inside the block with the f32 sums in registers, fed by a 4-stage
//   cp.async ring into 128-byte-swizzled tiles; rounded once, staged in
//   shared memory and stored row by row with bounds checks.
//   Re-densifying per 128-row block instead would cost M/128 times the
//   densify (183 GFLOP at M = 2048).
// * Odd strides (llama_1b d_ff = 5461: rows only 2-byte aligned): every
//   load is a 16-byte cp.async, so the wrapper has pad_rows_kernel copy
//   an x, B or A whose rows are not 16-byte aligned, with zeros past the
//   logical width; the kernels take each operand's row stride (ldx, ldb,
//   lda). Wt's width is a multiple of 128, so its rows always are.
// * Deterministic: no float atomics in device memory, every f32 sum in a
//   fixed order, so a rerun gives the same bits.
//
// Grouped launch (sl_matmul_grouped_launch, the one entry point): E
// linears of one shape at once, each operand stacked on a leading axis
// (an MoE layer's experts, which the TPU kernel runs batched under the
// reference's vmap over the expert stack). Every kernel takes the expert
// as its outermost grid index (blockIdx.z; the f32 small-M kernel folds
// it with its row blocks) and moves each pointer by that expert's stride
// (struct Stack) before its first load; the reduce walks E * M * N
// outputs. A single linear is the case E = 1, so an expert's device
// code, its sums and their order are those of a single launch: a grouped
// launch gives the bits of a loop of single launches. The two bf16
// densifying kernels, held to 128 registers for two blocks an SM, take
// the offsets only in their grouped instantiation (kGrouped): the
// offsets' registers would spill in a single launch. Scratch grows by E
// (the two-stage Wt: E * nnt*128 * nkt*128 bf16, 369 MB at 64 experts
// of 2048 -> 1408).
//
// f32: the CUDA-core kernels of the first port (the tensor cores have no
// f32 mode apart from TF32, which the port never turns on), unchanged:
// * Every (k-tile, n-tile[, row block]) is its own block, writing an f32
//   partial (nkt, M, N) in register-tiled 128x128x32 steps; a second
//   kernel sums the partials over k-tiles in order.
// * Up to 32 rows one block covers all of x's rows (sl_tile_kernel, RPT
//   * 2 rows); above that one block per tile densifies it once and loops
//   over 128-row blocks of x (sl_tile_loop_kernel). Loads are scalar and
//   bounds-checked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int TILE = 128;        // W tile edge (support.TILE)
constexpr int RK = 32;           // rank chunk staged in shared memory
constexpr int BST = TILE + 1;    // padded row stride of the B chunk
constexpr int THREADS = 256;

// Per-expert element strides of a grouped launch: the kernels move each
// pointer by its stride times the expert's index.
struct Stack {
  size_t x, B, A, t, partial, w, y;
};

__device__ __forceinline__ float to_f(float v) { return v; }

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
               int cap, float scale, Stack st) {
  extern __shared__ float smem[];
  float* Wt = smem;                       // [TILE][TILE]
  float* Bs = Wt + TILE * TILE;           // [RK][BST]  (B chunk, transposed)
  float* As = Bs + RK * BST;              // [RK][TILE]
  float* xs = As + RK * TILE;             // [2 * RPT][TILE]

  const int nt = blockIdx.x, kt = blockIdx.y;
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int nrb = (M + 2 * RPT - 1) / (2 * RPT);   // row blocks an expert
  const size_t ex = blockIdx.z / nrb;
  const int m0 = (blockIdx.z % nrb) * (2 * RPT);
  const int tid = threadIdx.x;
  x += ex * st.x; B += ex * st.B; A += ex * st.A;
  v_t += ex * st.t; rows_t += ex * st.t; cols_t += ex * st.t;
  partial += ex * st.partial;

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
                    int cap, float scale, Stack st) {
  extern __shared__ float smem[];
  float* Wt = smem;                       // [TILE][TILE]
  float* Bs = Wt + TILE * TILE;           // [RK][BST]  (B, then x, chunks)
  float* As = Bs + RK * BST;              // [RK][TILE]

  const int nt = blockIdx.x, kt = blockIdx.y;
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t ex = blockIdx.z;
  x += ex * st.x; B += ex * st.B; A += ex * st.A;
  v_t += ex * st.t; rows_t += ex * st.t; cols_t += ex * st.t;
  partial += ex * st.partial;

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

// y[e, m, n] = T(sum over k-tiles, in order, of partial[e, kt, m, n]),
// for E experts' (nkt, M, N) partials and (M, N) outputs, stacked.
template <typename T>
__global__ void sl_reduce_kernel(const float* __restrict__ partial,
                                 T* __restrict__ y, int nkt, size_t mn,
                                 size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t e = i / mn, j = i - e * mn;
  const float* p = partial + e * (size_t)nkt * mn + j;
  float s = 0.f;
  for (int kt = 0; kt < nkt; ++kt) s += p[(size_t)kt * mn];
  y[i] = from_f<T>(s);
}

template <typename T, int RPT>
cudaError_t launch_rpt(const void* x, const void* B, const void* A,
                       const float* v_t, const int* rows_t,
                       const int* cols_t, float* partial, int M, int K,
                       int N, int r, int nkt, int nnt, int cap, float scale,
                       int E, Stack st, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (TILE * TILE + RK * BST + RK * TILE + 2 * RPT * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      sl_tile_kernel<T, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nnt, nkt, E * ((M + 2 * RPT - 1) / (2 * RPT)));
  sl_tile_kernel<T, RPT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(B),
      static_cast<const T*>(A), v_t, rows_t, cols_t, partial, M, K, N, r,
      cap, scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_loop(const void* x, const void* B, const void* A,
                        const float* v_t, const int* rows_t,
                        const int* cols_t, float* partial, int M, int K,
                        int N, int r, int nkt, int nnt, int cap, float scale,
                        int E, Stack st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (TILE * TILE + RK * BST + RK * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      sl_tile_loop_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nnt, nkt, E);
  sl_tile_loop_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(B),
      static_cast<const T*>(A), v_t, rows_t, cols_t, partial, M, K, N, r,
      cap, scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* B, const void* A,
                   const float* v_t, const int* rows_t, const int* cols_t,
                   float* partial, void* y, int M, int K, int N, int r,
                   int nkt, int nnt, int cap, float scale, int E, Stack st,
                   cudaStream_t stream) {
  cudaError_t err;
  if (M <= 8)
    err = launch_rpt<T, 4>(x, B, A, v_t, rows_t, cols_t, partial, M, K, N, r,
                           nkt, nnt, cap, scale, E, st, stream);
  else if (M <= 32)
    err = launch_rpt<T, 16>(x, B, A, v_t, rows_t, cols_t, partial, M, K, N,
                            r, nkt, nnt, cap, scale, E, st, stream);
  else
    err = launch_loop<T>(x, B, A, v_t, rows_t, cols_t, partial, M, K, N, r,
                         nkt, nnt, cap, scale, E, st, stream);
  if (err != cudaSuccess) return err;
  const size_t mn = (size_t)M * N, total = mn * E;
  const int threads = 256;
  sl_reduce_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads,
                        0, stream>>>(partial, static_cast<T*>(y), nkt, mn,
                                     total);
  return cudaGetLastError();
}


// ===========================================================================
// bf16: the tensor-core path
// ===========================================================================

typedef __nv_bfloat16 bf16;

constexpr int RC = 64;                 // rank chunk: one 128-byte row
constexpr int DSTAGES = 3;             // densify ring depth
constexpr int DB_BYTES = TILE * RC * (int)sizeof(bf16);   // B chunk
constexpr int DA_BYTES = RC * TILE * (int)sizeof(bf16);   // A chunk
constexpr int DSTAGE_BYTES = DB_BYTES + DA_BYTES;
constexpr int LD = TILE + 8;           // row stride of the bf16 W, x tiles
constexpr int WF_LD = TILE + 8;        // row stride (floats), f32 tile
constexpr int RING_BYTES = DSTAGES * DSTAGE_BYTES;
constexpr int WF_BYTES = TILE * WF_LD * (int)sizeof(float);
constexpr int DENSE_BYTES = RING_BYTES > WF_BYTES ? RING_BYTES : WF_BYTES;
constexpr int SMALL_M_ROWS = 128;      // most rows of x the single pass holds
// the A chunk's two 64-column halves (MN-major swizzle atoms) lie this
// far apart; its 8-row groups 1024 bytes apart
constexpr int MN_LBO = RC * 128;
constexpr int SMEM_2_BLOCKS = 113 * 1024;  // a block's share, two an SM
constexpr int SPARSE_PREF = 3;         // sparse entries a thread prefetches

__device__ __forceinline__ uint32_t round2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// mma.sync m16n8k16 (bf16 in, f32 accumulate) and its ldmatrix loads
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// two n8 B fragments (k16 x n16) from a [k][n] row-major tile
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&b0)[2],
                                          uint32_t (&b1)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Densify the (kt, nt) W tile on the tensor cores into the f32 tile Wf
// ([TILE][WF_LD] at smem, over the ring): scale * B_tile·A_tile with f32
// accumulation, plus the tile's sparse values; not yet rounded. B (K, r)
// has rows of ldb elements and A (r, N) rows of lda, both multiples of 8
// (the wrapper pads a copy otherwise, with zeros). Two warpgroups, each
// 64 rows of the tile, run wgmma m64n128k16 with B's rows as the K-major
// A operand and A's rows as the MN-major (transposed) B operand. The rank
// streams RC at a time through a DSTAGES-deep cp.async ring (loads two
// chunks ahead); ranks past r, rows past K and columns past lda load as
// zeros. ring_free() runs once the ring is consumed, before the f32
// tile is written (the single pass starts its x loads there). Ends with
// __syncthreads().
template <typename RingFree>
__device__ __forceinline__ void densify_tc(
    const bf16* __restrict__ B, const bf16* __restrict__ A,
    const float* __restrict__ v_t, const int* __restrict__ rows_t,
    const int* __restrict__ cols_t, uint8_t* smem, int kt, int nt, int nnt,
    int K, int r, int ldb, int lda, int cap, float scale,
    RingFree ring_free) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int nch = (r + RC - 1) / RC;

  auto load_chunk = [&](int c) {
    if (c < nch) {
      uint8_t* sb = smem + (c % DSTAGES) * DSTAGE_BYTES;
      uint8_t* sa = sb + DB_BYTES;
      const int r0 = c * RC;
      for (int e = tid; e < TILE * (RC / 8); e += THREADS) {  // B rows
        const int i = e / (RC / 8), q = e % (RC / 8);
        const int gr = k0 + i, gc = r0 + 8 * q;
        const bool ok = gr < K && gc < ldb;
        cp_async16(sb + sw128(i, q), ok ? B + (size_t)gr * ldb + gc : B,
                   ok ? 16 : 0);
      }
      for (int e = tid; e < RC * (TILE / 8); e += THREADS) {  // A rows
        const int i = e / (TILE / 8), q = e % (TILE / 8);
        const int gr = r0 + i, gc = n0 + 8 * q;
        const bool ok = gr < r && gc < lda;
        cp_async16(sa + (q >> 3) * MN_LBO + sw128(i, q & 7),
                   ok ? A + (size_t)gr * lda + gc : A, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // the tile's sparse entries, read now so that their latency hides
  // under the rank loop (SPARSE_PREF a thread; any beyond are read in the
  // epilogue)
  const size_t tbase = ((size_t)kt * nnt + nt) * (size_t)cap;
  float pv[SPARSE_PREF];
  int pr[SPARSE_PREF], pc[SPARSE_PREF];
#pragma unroll
  for (int j = 0; j < SPARSE_PREF; ++j) {
    const int e = tid + THREADS * j;
    pv[j] = e < cap ? v_t[tbase + e] : 0.f;
    pr[j] = e < cap ? rows_t[tbase + e] : 0;
    pc[j] = e < cap ? cols_t[tbase + e] : 0;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) load_chunk(s);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<DSTAGES - 2>();   // chunk c has landed (own copies)
    fence_proxy_async();
    __syncthreads();                // everyone's; chunk c-1 is consumed,
    load_chunk(c + DSTAGES - 1);    // so its buffer takes chunk c+2
    const uint8_t* sb = smem + (c % DSTAGES) * DSTAGE_BYTES;
    const uint8_t* sa = sb + DB_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < RC / 16; ++ks)
      wgmma_m64n128k16<0>(acc, sw128_desc(sb + wg * 64 * 128 + 32 * ks),
                          sw128_mn_desc(sa + 16 * 128 * ks, MN_LBO));
    wgmma_commit();
    wgmma_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
  __syncthreads();                  // the ring is free for the f32 tile
  ring_free();

  // -- scale into the f32 tile: acc[4j + 2h + c] is (row 64*wg + 16*warp
  //    + lane/4 + 8h, col 8j + 2*(lane%4) + c) --
  float* Wf = reinterpret_cast<float*>(smem);
  const int lane = tid & 31, warp = (tid >> 5) & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
      *reinterpret_cast<float2*>(&Wf[row * WF_LD + 8 * j + 2 * (lane & 3)]) =
          make_float2(acc[4 * j + 2 * h] * scale,
                      acc[4 * j + 2 * h + 1] * scale);
    }
  __syncthreads();

  // -- sparse values, with shared atomics: a real entry may share local
  //    (0, 0) with the padding slots. Padding slots (v = 0) are skipped:
  //    adding 0 changes no value, and their shared address would
  //    serialize the atomics --
#pragma unroll
  for (int j = 0; j < SPARSE_PREF; ++j)
    if (pv[j] != 0.f) atomicAdd(&Wf[pr[j] * WF_LD + pc[j]], pv[j]);
  for (int e = tid + THREADS * SPARSE_PREF; e < cap; e += THREADS) {
    const float v = v_t[tbase + e];
    if (v != 0.f)
      atomicAdd(&Wf[rows_t[tbase + e] * WF_LD + cols_t[tbase + e]], v);
  }
  __syncthreads();
}

// Offset of the single pass's x tile (16 * mt rows of LD elements): past
// the ring, loaded with the first chunk, while two blocks still share an
// SM (up to 48 rows); else in the ring past the f32 tile, loaded once
// the ring is free (up to 64 rows); else past the ring again.
__host__ __device__ __forceinline__ int x_tile_offset(int mt) {
  const int bytes = 16 * mt * LD * (int)sizeof(bf16);
  if (SMEM_ALIGN + DENSE_BYTES + bytes <= SMEM_2_BLOCKS) return DENSE_BYTES;
  return WF_BYTES + bytes <= DENSE_BYTES ? WF_BYTES : DENSE_BYTES;
}

// Single pass for small M (a decode batch, a prefill bucket): one block
// per (k-tile, n-tile) densifies its W tile, rounds it to bf16 in shared
// memory and multiplies all of x's rows (padded to 16) by it with
// mma.sync; writes the f32 partial[kt, :M, n0:n0+128]. Each warp owns 16
// columns of the product. x has rows of ldx elements (a multiple of 8).
template <bool kGrouped>
__global__ void __launch_bounds__(THREADS, 2)
sl_tc_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ B,
                  const bf16* __restrict__ A, const float* __restrict__ v_t,
                  const int* __restrict__ rows_t,
                  const int* __restrict__ cols_t, float* __restrict__ partial,
                  int M, int K, int N, int r, int ldx, int ldb, int lda,
                  int cap, float scale, Stack st) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* smem = align_smem(tc_smem);
  const int nt = blockIdx.x, kt = blockIdx.y;
  if (kGrouped) {
    const size_t ex = blockIdx.z;
    x += ex * st.x; B += ex * st.B; A += ex * st.A;
    v_t += ex * st.t; rows_t += ex * st.t; cols_t += ex * st.t;
    partial += ex * st.partial;
  }
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = (M + 15) / 16;
  const int x_off = x_tile_offset(mt);
  bf16* Xs = reinterpret_cast<bf16*>(smem + x_off);
  auto load_x = [&] {
    for (int e = tid; e < 16 * mt * (TILE / 8); e += THREADS) {
      const int i = e / (TILE / 8), q = e % (TILE / 8);
      const int gc = k0 + 8 * q;
      const bool ok = i < M && gc < ldx;
      cp_async16(Xs + i * LD + 8 * q, ok ? x + (size_t)i * ldx + gc : x,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  if (x_off != WF_BYTES) load_x();
  densify_tc(B, A, v_t, rows_t, cols_t, smem, kt, nt, gridDim.x, K, r, ldb,
             lda, cap, scale, [&] {
               if (x_off == WF_BYTES) load_x();
             });

  // -- round the tile to bf16 once, into [TILE][LD] over the f32 tile,
  //    four elements at a time --
  const float* Wf = reinterpret_cast<const float*>(smem);
  float4 vals[TILE * TILE / 4 / THREADS];
#pragma unroll
  for (int i = 0; i < TILE * TILE / 4 / THREADS; ++i) {
    const int e = tid + THREADS * i;
    vals[i] = *reinterpret_cast<const float4*>(
        &Wf[(e / (TILE / 4)) * WF_LD + 4 * (e % (TILE / 4))]);
  }
  __syncthreads();
  bf16* Wb = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < TILE * TILE / 4 / THREADS; ++i) {
    const int e = tid + THREADS * i;
    *reinterpret_cast<uint2*>(&Wb[(e / (TILE / 4)) * LD +
                                  4 * (e % (TILE / 4))]) =
        make_uint2(round2(vals[i].x, vals[i].y),
                   round2(vals[i].z, vals[i].w));
  }
  cp_async_wait<0>();               // the x tile
  __syncthreads();

  // -- partial = x_rows · W_tile, f32 accumulation --
  float o[SMALL_M_ROWS / 16][2][4];
#pragma unroll
  for (int mi = 0; mi < SMALL_M_ROWS / 16; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][nj][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < TILE / 16; ++ks) {
    uint32_t b[2][2];
    ldsm_x4_t(b[0], b[1],
              Wb + (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                  16 * warp + 8 * (lane >> 4));
#pragma unroll
    for (int mi = 0; mi < SMALL_M_ROWS / 16; ++mi) {
      if (mi < mt) {
        uint32_t a[4];
        ldsm_x4(a, Xs + (16 * mi + (lane & 15)) * LD + 16 * ks +
                       8 * (lane >> 4));
        mma16816(o[mi][0], a, b[0]);
        mma16816(o[mi][1], a, b[1]);
      }
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < SMALL_M_ROWS / 16; ++mi) {
    if (mi >= mt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * mi + g + 8 * h;
      if (m >= M) continue;
      float* prow = partial + ((size_t)kt * M + m) * N;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = n0 + 16 * warp + 8 * nj + 2 * t;
        if (n < N) prow[n] = o[mi][nj][2 * h];
        if (n + 1 < N) prow[n + 1] = o[mi][nj][2 * h + 1];
      }
    }
  }
}

// Stage (a) for large M: densify the (kt, nt) tile and write it rounded
// to bf16, transposed, into Wt[(n0 + c) * ldw + k0 + kk] (Wt is
// (nnt*128, nkt*128), K-major for the GEMM's B operand). Rows past K and
// columns past N come out exactly 0.
template <bool kGrouped>
__global__ void __launch_bounds__(THREADS, 2)
sl_tc_densify_kernel(const bf16* __restrict__ B, const bf16* __restrict__ A,
                     const float* __restrict__ v_t,
                     const int* __restrict__ rows_t,
                     const int* __restrict__ cols_t, bf16* __restrict__ Wt,
                     int K, int r, int ldb, int lda, int cap, float scale,
                     Stack st) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* smem = align_smem(tc_smem);
  const int nt = blockIdx.x, kt = blockIdx.y;
  const int ldw = gridDim.y * TILE;
  if (kGrouped) {
    const size_t ex = blockIdx.z;
    B += ex * st.B; A += ex * st.A;
    v_t += ex * st.t; rows_t += ex * st.t; cols_t += ex * st.t;
    Wt += ex * st.w;
  }
  densify_tc(B, A, v_t, rows_t, cols_t, smem, kt, nt, gridDim.x, K, r, ldb,
             lda, cap, scale, [] {});
  const float* Wf = reinterpret_cast<const float*>(smem);
  for (int e = threadIdx.x; e < TILE * (TILE / 8); e += THREADS) {
    const int c = e % TILE, q = e / TILE;
    const float* col = Wf + 8 * q * WF_LD + c;
    *reinterpret_cast<uint4*>(Wt + (size_t)(nt * TILE + c) * ldw +
                              kt * TILE + 8 * q) =
        make_uint4(round2(col[0], col[WF_LD]),
                   round2(col[2 * WF_LD], col[3 * WF_LD]),
                   round2(col[4 * WF_LD], col[5 * WF_LD]),
                   round2(col[6 * WF_LD], col[7 * WF_LD]));
  }
}

// dst (rows, ld) = src (rows, cols) with zeros past cols, ld a multiple
// of 8 (the copy of an operand whose rows are not 16-byte aligned): one
// 16-byte chunk a thread, read element by element.
__global__ void pad_rows_kernel(const bf16* __restrict__ src,
                                bf16* __restrict__ dst, int rows, int cols,
                                int ld) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int cpr = ld / 8;
  if (i >= (size_t)rows * cpr) return;
  const int row = (int)(i / cpr), c0 = (int)(i % cpr) * 8;
  const bf16* s = src + (size_t)row * cols + c0;
  const bf16 z = __float2bfloat16(0.f);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bf16 lo = c0 + 2 * j < cols ? s[2 * j] : z;
    const bf16 hi = c0 + 2 * j + 1 < cols ? s[2 * j + 1] : z;
    w[j] = (uint32_t)__bfloat16_as_ushort(lo) |
           ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  }
  *reinterpret_cast<uint4*>(dst + (size_t)row * ld + c0) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

constexpr int GM = 128, GN = 256, GK = 64, GSTAGES = 4;
constexpr int GX_BYTES = GM * GK * (int)sizeof(bf16);
constexpr int GW_BYTES = GN * GK * (int)sizeof(bf16);
constexpr int GSTAGE_BYTES = GX_BYTES + GW_BYTES;
constexpr int GEMM_SMEM = GSTAGES * GSTAGE_BYTES + SMEM_ALIGN;
constexpr int YLD = GN + 8;            // row stride of the output tile
static_assert(GM * YLD * (int)sizeof(bf16) <= GSTAGES * GSTAGE_BYTES,
              "the output tile fits in the ring");

// Stage (b) for large M: y = x · W with W read as Wt (nrows_w, ldw),
// K-major. One block per 128 x 256 output tile, two warpgroups of 64
// rows each on wgmma m64n256k16; the k loop runs over all of ldw in
// ascending order inside the block with the f32 sums in registers, fed
// by a GSTAGES-deep cp.async ring (loads two stages ahead of the wgmma).
// x has M rows of ldx elements (a multiple of 8, zeros past the logical
// K); rows past M and columns past ldx load as zeros. Rounded once,
// staged in shared memory and stored row by row, bounds-checked.
__global__ void __launch_bounds__(THREADS, 1)
sl_tc_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Wt,
                  bf16* __restrict__ y, int M, int ldx, int N, int nrows_w,
                  int ldw, Stack st) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* smem = align_smem(tc_smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const size_t ex = blockIdx.z;
  x += ex * st.x; Wt += ex * st.w; y += ex * st.y;
  const int nk = ldw / GK;

  auto load_stage = [&](int s) {
    if (s < nk) {
      uint8_t* sx = smem + (s % GSTAGES) * GSTAGE_BYTES;
      uint8_t* sw = sx + GX_BYTES;
      const int kb = s * GK;
      for (int e = tid; e < GM * 8; e += THREADS) {
        const int i = e >> 3, q = e & 7;
        const int gr = m0 + i, gc = kb + 8 * q;
        const bool ok = gr < M && gc < ldx;
        cp_async16(sx + sw128(i, q), ok ? x + (size_t)gr * ldx + gc : x,
                   ok ? 16 : 0);
      }
      for (int e = tid; e < GN * 8; e += THREADS) {
        const int i = e >> 3, q = e & 7;
        const int gr = n0 + i;
        const bool ok = gr < nrows_w;
        cp_async16(sw + sw128(i, q),
                   ok ? Wt + (size_t)gr * ldw + kb + 8 * q : Wt,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;

#pragma unroll
  for (int s = 0; s < GSTAGES - 2; ++s) load_stage(s);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GSTAGES - 3>();    // stage kt has landed (own copies)
    fence_proxy_async();
    __syncthreads();                 // everyone's copies; and every
    load_stage(kt + GSTAGES - 2);    // warpgroup is done with stage kt-2,
    const uint8_t* sx =              // whose buffer this load refills
        smem + (kt % GSTAGES) * GSTAGE_BYTES + wg * 64 * 128;
    const uint8_t* sw = smem + (kt % GSTAGES) * GSTAGE_BYTES + GX_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < GK / 16; ++ks)
      wgmma_m64n256k16(d, sw128_desc(sx + 32 * ks), sw128_desc(sw + 32 * ks));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(d[i]);

  // -- round into a [GM][YLD] tile over the ring, then store whole rows:
  //    16 bytes a thread where y's rows are 16-byte aligned, else one
  //    element a thread, consecutive threads on consecutive columns --
  __syncthreads();                  // both warpgroups are done reading
  bf16* Ys = reinterpret_cast<bf16*>(smem);
  // d[4j + 2h + c] is (row 16*warp + lane/4 + 8h, col 8j + 2*(lane%4) + c)
  const int lane = tid & 31, warp = (tid >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(&Ys[row * YLD + 8 * j + 2 * (lane & 3)]) =
          round2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
  __syncthreads();
  if (N % 8 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
    for (int e = tid; e < GM * (GN / 8); e += THREADS) {
      const int row = e / (GN / 8), c = 8 * (e % (GN / 8));
      const int m = m0 + row, n = n0 + c;
      if (m < M && n < N)
        *reinterpret_cast<uint4*>(y + (size_t)m * N + n) =
            *reinterpret_cast<const uint4*>(&Ys[row * YLD + c]);
    }
  } else {
    for (int e = tid; e < GM * GN; e += THREADS) {
      const int row = e / GN, c = e % GN;
      const int m = m0 + row, n = n0 + c;
      if (m < M && n < N) y[(size_t)m * N + n] = Ys[row * YLD + c];
    }
  }
}

cudaError_t launch_bf16_single(const bf16* x, const bf16* B, const bf16* A,
                               const float* v_t, const int* rows_t,
                               const int* cols_t, float* partial, bf16* y,
                               int M, int K, int N, int r, int nkt, int nnt,
                               int cap, int ldx, int ldb, int lda,
                               float scale, int E, Stack st,
                               cudaStream_t stream) {
  if (M > SMALL_M_ROWS) return cudaErrorInvalidValue;
  const int mt = (M + 15) / 16;
  const int x_end = x_tile_offset(mt) + 16 * mt * LD * (int)sizeof(bf16);
  const int smem = SMEM_ALIGN + (x_end > DENSE_BYTES ? x_end : DENSE_BYTES);
  const auto kernel = E > 1 ? sl_tc_tile_kernel<true>
                            : sl_tc_tile_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nnt, nkt, E), THREADS, smem, stream>>>(
      x, B, A, v_t, rows_t, cols_t, partial, M, K, N, r, ldx, ldb, lda, cap,
      scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mn = (size_t)M * N, total = mn * E;
  sl_reduce_kernel<bf16><<<(unsigned)((total + 255) / 256), 256, 0,
                           stream>>>(partial, y, nkt, mn, total);
  return cudaGetLastError();
}

cudaError_t launch_bf16_two_stage(const bf16* x, const bf16* B,
                                  const bf16* A, const float* v_t,
                                  const int* rows_t, const int* cols_t,
                                  bf16* Wt, bf16* y, int M, int K, int N,
                                  int r, int nkt, int nnt, int cap, int ldx,
                                  int ldb, int lda, float scale, int E,
                                  Stack st, cudaStream_t stream) {
  const int dsmem = SMEM_ALIGN + DENSE_BYTES;
  const auto densify = E > 1 ? sl_tc_densify_kernel<true>
                             : sl_tc_densify_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      densify, cudaFuncAttributeMaxDynamicSharedMemorySize, dsmem);
  if (err != cudaSuccess) return err;
  densify<<<dim3(nnt, nkt, E), THREADS, dsmem, stream>>>(
      B, A, v_t, rows_t, cols_t, Wt, K, r, ldb, lda, cap, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sl_tc_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, E);
  sl_tc_gemm_kernel<<<grid, THREADS, GEMM_SMEM, stream>>>(
      x, Wt, y, M, ldx, N, nnt * TILE, nkt * TILE, st);
  return cudaGetLastError();
}
}  // namespace

// Plain C entry point (bound with ctypes) of E linears of one shape
// (E = 1 for one linear), each operand stacked contiguously on a leading
// expert axis: x (E, M, ldx), B (E, K, ldb), A (E, r, lda),
// v_t/rows_t/cols_t (E, nkt, nnt, cap), y (E, M, N); scratch partial (E,
// nkt, M, N) f32 or w_t (E, nnt*128, nkt*128) bf16. variant: 0 = f32 (partial), 1 = bf16 single
// pass (partial), 2 = bf16 two stage (w_t). For bf16, ldx, ldb and lda
// are the row strides of x, B and A (multiples of 8, 16-byte aligned
// rows; zeros past K, r and N); for f32 they are K, r and N. Scratch
// that a variant does not use may be null. Returns the cudaError_t of
// the launches (0 = success).
extern "C" int sl_matmul_grouped_launch(
    const void* x, const void* B, const void* A, const float* v_t,
    const int* rows_t, const int* cols_t, float* partial, void* w_t,
    void* y, int M, int K, int N, int r, int nkt, int nnt, int cap, int ldx,
    int ldb, int lda, float scale, int variant, int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535) return (int)cudaErrorInvalidValue;
  const Stack st{(size_t)M * ldx, (size_t)K * ldb, (size_t)r * lda,
                 (size_t)nkt * nnt * cap, (size_t)nkt * M * N,
                 (size_t)nnt * TILE * nkt * TILE, (size_t)M * N};
  switch (variant) {
    case 0:
      return (int)launch<float>(x, B, A, v_t, rows_t, cols_t, partial, y, M,
                                K, N, r, nkt, nnt, cap, scale, E, st, s);
    case 1:
      return (int)launch_bf16_single(
          static_cast<const bf16*>(x), static_cast<const bf16*>(B),
          static_cast<const bf16*>(A), v_t, rows_t, cols_t, partial,
          static_cast<bf16*>(y), M, K, N, r, nkt, nnt, cap, ldx, ldb, lda,
          scale, E, st, s);
    case 2:
      return (int)launch_bf16_two_stage(
          static_cast<const bf16*>(x), static_cast<const bf16*>(B),
          static_cast<const bf16*>(A), v_t, rows_t, cols_t,
          static_cast<bf16*>(w_t), static_cast<bf16*>(y), M, K, N, r, nkt,
          nnt, cap, ldx, ldb, lda, scale, E, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dst (rows, ld) = src (rows, cols) padded with zeros, bf16; ld a
// multiple of 8 and dst 16-byte aligned. Returns the cudaError_t.
extern "C" int sl_pad_rows(const void* src, void* dst, int rows, int cols,
                           int ld, void* stream) {
  const size_t chunks = (size_t)rows * (ld / 8);
  if (chunks == 0) return 0;
  pad_rows_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<bf16*>(dst), rows, cols, ld);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
