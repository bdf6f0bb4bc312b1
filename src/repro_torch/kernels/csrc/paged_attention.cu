// paged_attention / paged_prefill: attention over the paged K/V pools,
// read in place through the block table (the gathered per-slot view
// never exists).
//
// Replaces the Pallas TPU kernels
//   repro/kernels/paged_attention.py::paged_attention (pallas_call at :172,
//     body _kernel at :80)          -- decode, one query token per slot;
//   repro/kernels/paged_attention.py::paged_prefill   (pallas_call at :282,
//     body _prefill_kernel at :181) -- chunked suffix prefill, sq queries.
//
// Layouts (the JAX package's): pools (n_blocks, block_len, Hkv, hd) with
// physical block 0 the null block; block_table (n_slots, bps) int32;
// decode q/out (n_slots, Hkv, group, hd) at positions[s]; prefill q/out
// (n_slots, sq, Hkv, group, hd) with query i at offsets[s] + i. Query
// rows of a (slot, kv head) are flattened group-major, so row rr sits at
// position off + rr / group; decode is the case sq = 1 of the same
// indexing, so both kernels share one body.
//
// Numerics follow the TPU kernels: q * scale in f32, optional tanh
// softcap, online softmax in f32 with running max m (starting at -1e30),
// sum l and accumulator acc; p = where(valid, exp(s - m_new), 0) (the
// where after the exp keeps masked weights at 0 while every score so far
// is masked); output acc / l where l > 0, else exact 0, in q's dtype.
// Masks: a key at kpos = j * block_len + t is valid for a row at qpos iff
// its table entry is not the null block, kpos <= qpos, and, with a
// window, qpos - kpos < window. V rows that no row of the block attends
// are zeroed on load, because 0 * NaN is NaN and unallocated pages hold
// garbage.
//
// What bounds it on the H100: bytes. Each (slot, kv head) reads its live
// K/V blocks once (2 * live_tokens * hd * dtype bytes) and does about
// 4 * rows * live_tokens * hd operations, far below the card's
// operations-per-byte balance point. The design reads only live blocks:
// each block reads its own table entries and stops at the last block any
// of its rows can see (blocks past it are fully masked and change
// nothing), and skips blocks wholly before every row's window. One thread
// block owns one (slot, kv head, 16 query rows), so a kv head's K/V
// block is staged in shared memory once for its whole GQA group. Each of
// the 4 warps owns 4 query rows; lanes split the keys of a block for the
// scores and the head dimension for the accumulator.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;                  // query rows per warp
constexpr int ROWS = WARPS * RPW;       // query rows per thread block
constexpr int MAX_T = 4;                // keys per lane: block_len <= 128
constexpr int MAX_D = 8;                // head dims per lane: hd <= 256
constexpr float NEG_INF = -1e30f;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (n_slots, Hkv, ceil(sq * group / ROWS)), THREADS threads.
template <typename T>
__device__ void attend(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ table,
                       const int* __restrict__ offsets, T* __restrict__ out,
                       int sq, int n_kv, int group, int hd, int block_len,
                       int bps, float scale, float softcap, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [ROWS][hd]
  float* ks = qs + ROWS * hd;                // [block_len][hd + 1]
  float* vs = ks + block_len * (hd + 1);     // [block_len][hd]
  float* ps = vs + block_len * hd;           // [WARPS][block_len]

  const int s = blockIdx.x, h = blockIdx.y;
  const int n_rows = sq * group;
  const int rb0 = blockIdx.z * ROWS;
  const int rb1 = min(rb0 + ROWS, n_rows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int off = offsets[s];

  // q rows of this block, scaled, in f32. Row rr = i * group + g.
  for (int e = tid; e < ROWS * hd; e += THREADS) {
    const int lr = e / hd, d = e % hd, rr = rb0 + lr;
    float val = 0.f;
    if (rr < rb1) {
      const int i = rr / group, g = rr % group;
      val = to_f(q[((((size_t)s * sq + i) * n_kv + h) * group + g) * hd + d]) *
            scale;
    }
    qs[e] = val;
  }

  const int qmin = off + rb0 / group;
  const int qmax = off + (rb1 - 1) / group;
  const int j_hi = min(bps - 1, qmax / block_len);
  int j_lo = 0;
  if (window > 0) j_lo = max(0, qmin - window + 1) / block_len;

  float m[RPW], l[RPW], acc[RPW][MAX_D];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_D; ++u) acc[i][u] = 0.f;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int phys = table[(size_t)s * bps + j];
    __syncthreads();  // previous block's ks/vs fully consumed (and qs ready)
    for (int e = tid; e < block_len * hd; e += THREADS) {
      const int t = e / hd, d = e % hd;
      const int kpos = j * block_len + t;
      const bool col_valid = phys != 0 && kpos <= qmax &&
                             (window <= 0 || kpos + window - 1 >= qmin);
      const size_t src = (((size_t)phys * block_len + t) * n_kv + h) * hd + d;
      ks[t * (hd + 1) + d] = to_f(kp[src]);
      vs[t * hd + d] = col_valid ? to_f(vp[src]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int lr = warp * RPW + i;
      const int rr = rb0 + lr;
      if (rr >= rb1) break;                    // warp-uniform
      const int qpos = off + rr / group;
      const float* qrow = qs + lr * hd;
      float sc[MAX_T];
      bool ok[MAX_T];
      float bmax = NEG_INF;
#pragma unroll
      for (int u = 0; u < MAX_T; ++u) {
        const int t = lane + 32 * u;
        ok[u] = false;
        sc[u] = NEG_INF;
        if (t < block_len) {
          float dot = 0.f;
          const float* krow = ks + t * (hd + 1);
          for (int d = 0; d < hd; ++d) dot = fmaf(qrow[d], krow[d], dot);
          if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
          const int kpos = j * block_len + t;
          ok[u] = phys != 0 && kpos <= qpos &&
                  (window <= 0 || qpos - kpos < window);
          sc[u] = ok[u] ? dot : NEG_INF;
          bmax = fmaxf(bmax, sc[u]);
        }
      }
      const float m_new = fmaxf(m[i], warp_max(bmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < MAX_T; ++u) {
        const int t = lane + 32 * u;
        if (t < block_len) {
          const float p = ok[u] ? expf(sc[u] - m_new) : 0.f;
          ps[warp * block_len + t] = p;
          psum += p;
        }
      }
      __syncwarp();
      l[i] = alpha * l[i] + warp_sum(psum);
#pragma unroll
      for (int u = 0; u < MAX_D; ++u) {
        const int d = lane + 32 * u;
        if (d < hd) {
          float pv = 0.f;
          for (int t = 0; t < block_len; ++t)
            pv = fmaf(ps[warp * block_len + t], vs[t * hd + d], pv);
          acc[i][u] = alpha * acc[i][u] + pv;
        }
      }
      m[i] = m_new;
      __syncwarp();
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rr = rb0 + warp * RPW + i;
    if (rr >= rb1) break;
    const int qi = rr / group, g = rr % group;
    T* orow = out + ((((size_t)s * sq + qi) * n_kv + h) * group + g) * hd;
#pragma unroll
    for (int u = 0; u < MAX_D; ++u) {
      const int d = lane + 32 * u;
      if (d < hd) orow[d] = from_f<T>(l[i] > 0.f ? acc[i][u] / l[i] : 0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* q, const T* kp, const T* vp, const int* table,
                    const int* positions, T* out, int n_kv, int group,
                    int hd, int block_len, int bps, float scale,
                    float softcap, int window) {
  attend<T>(q, kp, vp, table, positions, out, 1, n_kv, group, hd, block_len,
            bps, scale, softcap, window);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(const T* q, const T* kp, const T* vp, const int* table,
                     const int* offsets, T* out, int sq, int n_kv, int group,
                     int hd, int block_len, int bps, float scale,
                     float softcap, int window) {
  attend<T>(q, kp, vp, table, offsets, out, sq, n_kv, group, hd, block_len,
            bps, scale, softcap, window);
}

size_t smem_bytes(int hd, int block_len) {
  return sizeof(float) * ((size_t)ROWS * hd + (size_t)block_len * (hd + 1) +
                          (size_t)block_len * hd + (size_t)WARPS * block_len);
}

template <typename T>
cudaError_t launch(bool decode, const void* q, const void* kp,
                   const void* vp, const int* table, const int* pos,
                   void* out, int n_slots, int sq, int n_kv, int group,
                   int hd, int block_len, int bps, float scale,
                   float softcap, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, block_len);
  const dim3 grid(n_slots, n_kv, (sq * group + ROWS - 1) / ROWS);
  cudaError_t err;
  if (decode) {
    err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), table, pos, static_cast<T*>(out), n_kv,
        group, hd, block_len, bps, scale, softcap, window);
  } else {
    err = cudaFuncSetAttribute(paged_prefill_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    paged_prefill_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), table, pos, static_cast<T*>(out), sq,
        n_kv, group, hd, block_len, bps, scale, softcap, window);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bf16.
// Return the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const int* table,
                                      const int* positions, void* out,
                                      int n_slots, int n_kv, int group,
                                      int hd, int block_len, int bps,
                                      float scale, float softcap, int window,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(true, q, k_pool, v_pool, table,
                                      positions, out, n_slots, 1, n_kv, group,
                                      hd, block_len, bps, scale, softcap,
                                      window, s);
  return (int)launch<float>(true, q, k_pool, v_pool, table, positions, out,
                            n_slots, 1, n_kv, group, hd, block_len, bps,
                            scale, softcap, window, s);
}

extern "C" int paged_prefill_launch(const void* q, const void* k_pool,
                                    const void* v_pool, const int* table,
                                    const int* offsets, void* out,
                                    int n_slots, int sq, int n_kv, int group,
                                    int hd, int block_len, int bps,
                                    float scale, float softcap, int window,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(false, q, k_pool, v_pool, table,
                                      offsets, out, n_slots, sq, n_kv, group,
                                      hd, block_len, bps, scale, softcap,
                                      window, s);
  return (int)launch<float>(false, q, k_pool, v_pool, table, offsets, out,
                            n_slots, sq, n_kv, group, hd, block_len, bps,
                            scale, softcap, window, s);
}

// Shared memory one launch needs, so the wrapper can refuse shapes the
// card cannot hold before launching.
extern "C" long long paged_attention_smem_bytes(int hd, int block_len) {
  return (long long)smem_bytes(hd, block_len);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
