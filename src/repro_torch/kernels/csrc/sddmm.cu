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
// (exact for bf16), sums over tokens in f32. Only the order of the token
// sum differs between the kernels and the plain version. Neither kernel
// uses atomics, so a rerun gives the same bits.
//
// What bounds it on the H100: the function needs 2 * M * (nkt * nnt * cap)
// operations on the support alone (1.94 GFLOP at llama_1b's M = 2048,
// 2048 -> 5461) against reading x and dy once (30.8 MB), so its bound is
// bytes (0.011 ms). No kernel reaches that: the support is ~3% of each
// tile, scattered, and every design pays either for the whole tile or for
// random reads.
//
// bf16 (sddmm_tc_kernel): the TPU's design, on the tensor cores. Each
// block forms one whole 128x128 tile of G = x^T dy with f32 accumulation
// and gathers the tile's slots from it; G never reaches device memory.
// * Grid: one block per (k-tile, n-tile): 688 blocks at 2048 -> 5461 and
//   5461 -> 2048, 256 at 2048 -> 2048; two blocks an SM (97 KB of shared
//   memory, <= 128 registers a thread).
// * Main loop: the block walks the M tokens in chunks of TC_MC = 64
//   through a STAGES-deep cp.async ring (loads two chunks ahead). A stage
//   holds x[chunk, k-tile] and dy[chunk, n-tile], 16 KB each, each as two
//   64-column atoms of [64 tokens][128 bytes], 128-byte swizzled. Tokens
//   past M, and columns past the operand's row length, load as zeros.
// * MMA: wgmma m64n128k16 on two warpgroups (64 rows of G each), both
//   operands MN-major from shared memory: x^T is A, contiguous along its
//   M (= k), and dy is B, contiguous along its N. Each 16-token step
//   advances both descriptors by 16 rows (2048 bytes).
// * Epilogue: the f32 accumulators go to shared memory over the ring (a
//   [128][136] f32 tile), one barrier, then each thread gathers its slots,
//   dv_t[kt, nt, e] = G[rows_t[e], cols_t[e]], coalesced by e. The slot
//   indices are read before the token loop.
// * The 16-byte cp.async needs 16-byte aligned rows; a (M, 5461) bf16 row
//   is 10922 bytes. The wrapper copies such an operand with its rows
//   padded with zeros to a multiple of 8 (the sl_matmul library's
//   sl_pad_rows) and passes each operand's row length (ldx, ldd).
// This is ~33x the support's arithmetic, but dense, at the tensor cores'
// rate, with no random shared-memory reads in the main loop. What sets
// its pace is the operands' traffic from L2: each block reads its strip
// of x and of dy once, 64 KB a 128 tokens, 721 MB in all at 2048 -> 5461.
//
// f32 (sddmm_kernel, the first port's kernel, unchanged): the tensor cores
// have no f32 mode apart from TF32, which the port never turns on. It
// samples on the CUDA cores: one block per (k-tile, n-tile) walks M in
// chunks of MC rows staged in shared memory as f32, each thread owning SPT
// slots of the tile in registers (a tile with more than SPT * THREADS
// slots is split over blockIdx.z); one fmaf per slot and token, in
// ascending m. Every load is bounds-checked, so no operand is copied.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "once_per_device.cuh"

using namespace hopper;

namespace {

constexpr int TILE = 128;     // tile edge (support.TILE)
constexpr int THREADS = 256;

// ===========================================================================
// f32: sampled on the CUDA cores
// ===========================================================================

constexpr int SPT = 4;        // slots per thread
constexpr int MC = 32;        // token rows staged per chunk

__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const float* __restrict__ x, const float* __restrict__ dy,
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
      xs[i] = (live && k0 + j < K) ? x[(size_t)(m0 + m) * K + k0 + j] : 0.f;
      ds[i] = (live && n0 + j < N) ? dy[(size_t)(m0 + m) * N + n0 + j] : 0.f;
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

cudaError_t launch_f32(const float* x, const float* dy, const int* rows_t,
                       const int* cols_t, float* out, int M, int K, int N,
                       int nkt, int nnt, int cap, cudaStream_t stream) {
  const int groups = (cap + SPT * THREADS - 1) / (SPT * THREADS);
  const dim3 grid(nnt, nkt, groups);
  sddmm_kernel<<<grid, THREADS, 0, stream>>>(x, dy, rows_t, cols_t, out, M,
                                              K, N, cap);
  return cudaGetLastError();
}

// ===========================================================================
// bf16: whole G tiles on the tensor cores, then the gather
// ===========================================================================

typedef __nv_bfloat16 bf16;

constexpr int TC_MC = 64;                      // tokens a stage
constexpr int STAGES = 3;                      // ring depth
constexpr int ATOM_BYTES = TC_MC * 128;        // 64 columns x TC_MC tokens
constexpr int OP_BYTES = 2 * ATOM_BYTES;       // an operand's 128 columns
constexpr int STAGE_BYTES = 2 * OP_BYTES;      // x and dy
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int GLD = TILE + 8;                  // row stride (floats), G tile
constexpr int TC_SMEM = RING_BYTES + SMEM_ALIGN;
constexpr int IDX_PREF = 3;                    // slots a thread prefetches
static_assert(TILE * GLD * (int)sizeof(float) <= RING_BYTES,
              "the f32 G tile fits in the ring");

// One (k-tile, n-tile): G = x[:, k-tile]^T · dy[:, n-tile] over all M
// tokens, then dv_t at the tile's slots. x has rows of ldx elements and dy
// of ldd (multiples of 8, zeros past the logical K and N).
__global__ void __launch_bounds__(THREADS, 2)
sddmm_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                const int* __restrict__ rows_t, const int* __restrict__ cols_t,
                float* __restrict__ out, int M, int ldx, int ldd, int cap) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* smem = align_smem(tc_smem);
  const int nt = blockIdx.x, kt = blockIdx.y, nnt = gridDim.x;
  const int k0 = kt * TILE, n0 = nt * TILE;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nch = (M + TC_MC - 1) / TC_MC;
  const size_t tbase = ((size_t)kt * nnt + nt) * (size_t)cap;

  // the tile's slots, read now so that their latency hides under the
  // token loop (IDX_PREF a thread; any beyond are read in the epilogue)
  int pr[IDX_PREF], pc[IDX_PREF];
#pragma unroll
  for (int j = 0; j < IDX_PREF; ++j) {
    const int e = tid + THREADS * j;
    pr[j] = e < cap ? rows_t[tbase + e] : 0;
    pc[j] = e < cap ? cols_t[tbase + e] : 0;
  }

  auto load_chunk = [&](int c) {
    if (c < nch) {
      uint8_t* sx = smem + (c % STAGES) * STAGE_BYTES;
      uint8_t* sd = sx + OP_BYTES;
      const int m0 = c * TC_MC;
      for (int e = tid; e < TC_MC * (TILE / 8); e += THREADS) {
        const int i = e / (TILE / 8), q = e % (TILE / 8);
        const int m = m0 + i, off = (q >> 3) * ATOM_BYTES + sw128(i, q & 7);
        const int gk = k0 + 8 * q, gn = n0 + 8 * q;
        const bool okx = m < M && gk < ldx, okd = m < M && gn < ldd;
        cp_async16(sx + off, okx ? x + (size_t)m * ldx + gk : x,
                   okx ? 16 : 0);
        cp_async16(sd + off, okd ? dy + (size_t)m * ldd + gn : dy,
                   okd ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_chunk(s);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 2>();    // chunk c has landed (own copies)
    fence_proxy_async();
    __syncthreads();                // everyone's; chunk c-1 is consumed,
    load_chunk(c + STAGES - 1);     // so its buffer takes chunk c+2
    const uint8_t* sx = smem + (c % STAGES) * STAGE_BYTES;
    const uint8_t* sd = sx + OP_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_MC / 16; ++ks)
      wgmma_m64n128k16<1>(acc,
                          sw128_mn_desc(sx + wg * ATOM_BYTES + 2048 * ks,
                                        ATOM_BYTES),
                          sw128_mn_desc(sd + 2048 * ks, ATOM_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the G tile

  // -- acc[4j + 2h + c] is G (row 64*wg + 16*warp + lane/4 + 8h, col 8j +
  //    2*(lane%4) + c) --
  float* Gs = reinterpret_cast<float*>(smem);
  const int lane = tid & 31, warp = (tid >> 5) & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
      *reinterpret_cast<float2*>(&Gs[row * GLD + 8 * j + 2 * (lane & 3)]) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < IDX_PREF; ++j) {
    const int e = tid + THREADS * j;
    if (e < cap) out[tbase + e] = Gs[pr[j] * GLD + pc[j]];
  }
  for (int e = tid + THREADS * IDX_PREF; e < cap; e += THREADS)
    out[tbase + e] = Gs[rows_t[tbase + e] * GLD + cols_t[tbase + e]];
}

cudaError_t launch_tc(const bf16* x, const bf16* dy, const int* rows_t,
                      const int* cols_t, float* out, int M, int ldx, int ldd,
                      int nkt, int nnt, int cap, cudaStream_t stream) {
  if (ldx % 8 != 0 || ldd % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(dy) & 15) != 0)
    return cudaErrorMisalignedAddress;
  static OncePerDevice smem_attr;
  cudaError_t err = smem_attr([] {
    return cudaFuncSetAttribute(
        sddmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TC_SMEM);
  });
  if (err != cudaSuccess) return err;
  sddmm_tc_kernel<<<dim3(nnt, nkt), THREADS, TC_SMEM, stream>>>(
      x, dy, rows_t, cols_t, out, M, ldx, ldd, cap);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bf16.
// For bf16, ldx and ldd are the row lengths of x and dy: multiples of 8,
// 16-byte aligned rows, zeros past K and N (K and N for f32). Returns the
// cudaError_t of the launch (0 = success).
extern "C" int sddmm_launch(const void* x, const void* dy, const int* rows_t,
                            const int* cols_t, float* out, int M, int K,
                            int N, int nkt, int nnt, int cap, int ldx,
                            int ldd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_tc(static_cast<const bf16*>(x),
                          static_cast<const bf16*>(dy), rows_t, cols_t, out,
                          M, ldx, ldd, nkt, nnt, cap, s);
  return (int)launch_f32(static_cast<const float*>(x),
                         static_cast<const float*>(dy), rows_t, cols_t, out,
                         M, K, N, nkt, nnt, cap, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
