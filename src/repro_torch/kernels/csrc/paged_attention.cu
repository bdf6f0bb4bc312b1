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
// indexing, so the f32 decode and the f32 prefill share one body
// (attend).
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
// What bounds them on the H100: at the engine's shapes, latency. Each
// (slot, kv head) reads its live K/V blocks once (2 * live_tokens * hd *
// dtype bytes) and does about 4 * rows * live_tokens * hd operations, far
// below the card's operations-per-byte balance point. At the engine's
// shapes (4 slots, a few dozen live keys) that is well under a microsecond
// of HBM time, so what a launch really waits on is its chain of dependent
// loads: the position, the table entry, then the page, then the math on
// it, then the merge. At long contexts (a thousand keys a slot) the bytes
// bound it, and then only if enough blocks are in flight to keep HBM busy:
// 4 slots x 32 kv heads is 128 blocks, 4 x 8 at GQA group 4 only 32, for
// 132 SMs.
//
// All kernels read only live keys: a block stops at the last key any of
// its rows can see (later keys are fully masked and change nothing) and
// skips keys wholly before every row's window. One thread block owns one
// (slot, kv head) and a run of its query rows, so a kv head's K/V is
// staged in shared memory once for its whole GQA group.
//
// attend (decode and prefill in f32; the first version, kept as the
// correctness path): 16 query rows a block, each of the 4 warps owns 4
// rows one after another; lanes split the keys of a block for the scores
// and the head dimension for the accumulator, all on the CUDA cores in
// f32.
//
// decode_bf16_kernel (decode in bf16; flash-decoding):
// * the live keys of a (slot, kv head) are split across the block's warps
//   (up to 4), 32 keys a warp at a time, and, where the card would sit
//   idle (far fewer (slot, kv head) blocks than 2 an SM and a long
//   context), across `splits` blocks too; the wrapper's decode_plan picks
//   warps and splits from the shapes alone. Each warp keeps its own
//   running max, sum and accumulator; the warps' partials are merged in
//   warp order through shared memory, and with several splits each block
//   writes its merged partial (acc, m, l) to f32 scratch and the last
//   block of the (slot, kv head) to finish -- found through an int32
//   counter, after __threadfence, as in sparse_decode.cu -- merges them
//   in split order. No float atomics: a rerun gives the same bits;
// * a warp stages its 32 keys' K and V rows with 16-byte cp.async through
//   the block table into padded shared rows (hd + 8), double-buffered:
//   the next chunk's pages are in flight while this one is scored. Lane i
//   looks up key i's table entry once and hands it to the lanes copying
//   its row (a shuffle). A key past the slot's position, outside the
//   window, or on a null page is zero-filled, not read, so the NaN null
//   block and stale pages never reach an operand;
// * all G query rows of the group the block takes (1, 2, 4 or 8) use
//   every staged key: lane i scores key i against each row (q scaled in
//   f32, broadcast from shared memory; K as 16-byte bf16 loads, f32
//   products and sums), and for P V each lane owns pairs of head dims
//   (bf16x2 loads, conflict-free) and takes each key's p from its lane by
//   a shuffle. On the CUDA cores, not mma.sync: a decode has 1 to 8 rows a
//   kv head, so an m16 tile would be at least half padding, the products
//   are not what bounds it, and p stays an exact f32 operand without the
//   prefill's high/low bf16 split.
// Numerics: as attend's, in another order of the f32 sums (a warp's keys
// one after another, then warps and splits in order), so the output is
// within rounding of the reference and equal bit for bit on a rerun.
//
// prefill_tc_kernel (prefill in bf16) runs both products on the tensor
// cores, mma.sync m16n8k16 (bf16 in, f32 accumulate):
// * each warp owns 16 query rows, the m16 of the MMA; a block holds up to
//   8 warps, all sq * group rows of a (slot, kv head) up to 128 (the
//   wrapper's prefill_plan; rows past the end of the last warp's tile are
//   masked and never stored);
// * keys come 64 at a time (4 pages of 16 at llama_1b), each key's
//   head slice (hd bf16, contiguous) copied with 16-byte cp.async through
//   the block table into padded shared rows (hd + 8: ldmatrix reads them
//   without bank conflicts). Two stages: the next 64 keys load while the
//   warps run this stage's MMAs. A key that no row of the block can see
//   (null block, past the last row, before every row's window) is
//   zero-filled instead of read, so the NaN-filled null block and stale
//   rows never reach an MMA operand, and V rows no row attends are zero;
// * S = Q K^T: Q's fragments are loaded once from global into registers,
//   K's through ldmatrix; then, per row, the f32 scale, the optional tanh
//   softcap, the masks and the online softmax in f32 on the accumulator
//   fragments, with quad shuffles for each row's max and sum;
// * O += P V: P's accumulator fragments are the A operand directly (the
//   m16n8 C layout of two key n-tiles is the m16k16 A layout), V through
//   ldmatrix.trans.
// Numerics: QK^T products of bf16 are exact in f32, so only the order of
// the f32 sum differs from the reference. The scale multiplies the f32
// score instead of q; at hd 64 it is a power of two, so the bits equal
// scaling q first (elsewhere they may differ in the last bit). P is not
// rounded to bf16 as a whole: the reference multiplies p in f32, so P is
// split into a bf16 high part and the bf16 rounding of its remainder, and
// each goes through its own PV MMA: P is carried to ~2^-17 relative
// instead of 2^-9, for 2x the PV MMAs of a stage, which is not what
// bounds the kernel. l sums the f32 p. hd must be a multiple of 16, at
// most 128 (the wrapper raises otherwise).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "once_per_device.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;                  // query rows per warp
constexpr int ROWS = WARPS * RPW;       // query rows per thread block
constexpr int MAX_T = 4;                // keys per lane: block_len <= 128
constexpr int MAX_D = 8;                // head dims per lane: hd <= 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
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

// ---------------------------------------------------------------------------
// bf16 prefill on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int KS = 64;                   // keys per stage
constexpr int TC_MAX_WARPS = 8;          // 16 query rows each

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
// what rounding v to bf16 left over
__device__ __forceinline__ float rest(float v) {
  return v - __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KT>
constexpr size_t tc_smem_bytes() {
  // K and V, two stages each, rows of 16 * KT + 8 bf16; a flag per key
  return (size_t)2 * 2 * KS * (16 * KT + 8) * sizeof(bf16) +
         2 * KS * sizeof(int);
}

// grid (n_slots, Hkv, row blocks), 32 * warps threads; hd = 16 * KT.
// Block z owns rows [z * 16 * warps, ...) of its (slot, kv head); warp w
// the 16 of them from 16 * w, its thread (g = lane / 4, t = lane % 4)
// rows g and g + 8 of those.
template <int KT>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32)
prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                  const bf16* __restrict__ vp, const int* __restrict__ table,
                  const int* __restrict__ offsets, bf16* __restrict__ out,
                  int sq, int n_kv, int group, int block_len, int bps,
                  float scale, float softcap, int window) {
  constexpr int HD = 16 * KT, LDS = HD + 8, CH = HD / 8;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);    // [2][KS][LDS]
  bf16* Vs = Ks + 2 * KS * LDS;                   // [2][KS][LDS]
  int* seen = reinterpret_cast<int*>(Vs + 2 * KS * LDS);   // [2][KS]

  const int s = blockIdx.x, h = blockIdx.y;
  const int n_rows = sq * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb0 = blockIdx.z * (blockDim.x / 2);  // 16 rows a warp
  const int rb1 = min(rb0 + (int)blockDim.x / 2, n_rows);
  const int off = offsets[s];
  const int qmin = off + rb0 / group, qmax = off + (rb1 - 1) / group;
  // the keys some row of the block can see, and the stages covering them
  const int klo = window > 0 ? max(0, qmin - window + 1) : 0;
  const int khi = min(bps * block_len - 1, qmax);
  const int n_stages = khi >= klo ? (khi - klo) / KS + 1 : 0;

  auto load_stage = [&](int st) {
    const int buf = st & 1, kb = klo + st * KS;
    bf16* kd = Ks + buf * KS * LDS;
    bf16* vd = Vs + buf * KS * LDS;
    for (int e = tid; e < KS * CH; e += blockDim.x) {
      const int kk = e / CH, c = e % CH, kpos = kb + kk;
      const int phys =
          kpos <= khi ? table[(size_t)s * bps + kpos / block_len] : 0;
      const bool ok = phys != 0;
      const size_t src =
          (((size_t)phys * block_len + kpos % block_len) * n_kv + h) * HD +
          8 * c;
      cp_async16(kd + kk * LDS + 8 * c, ok ? kp + src : kp, ok ? 16 : 0);
      cp_async16(vd + kk * LDS + 8 * c, ok ? vp + src : vp, ok ? 16 : 0);
      if (c == 0) seen[buf * KS + kk] = ok;
    }
    cp_async_commit();
  };
  if (n_stages > 0) load_stage(0);

  // this thread's two rows: 0 = g, 1 = g + 8 of the warp's 16
  const int r0 = rb0 + 16 * warp + g;
  const bool warp_live = rb0 + 16 * warp < rb1;
  bool row_ok[2];
  int qpos[2];
  const bf16* qrow[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int rr = r0 + 8 * u;
    row_ok[u] = rr < rb1;
    qpos[u] = off + rr / group;
    qrow[u] = q + ((((size_t)s * sq + rr / group) * n_kv + h) * group +
                   rr % group) * HD;
  }
  // Q's A fragments, k = hd in steps of 16
  uint32_t qf[KT][4];
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = i & 1, d = 16 * ks + 2 * t + 8 * (i >> 1);
      qf[ks][i] = row_ok[u]
                      ? *reinterpret_cast<const uint32_t*>(qrow[u] + d)
                      : 0u;
    }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;

  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      load_stage(st + 1);
      cp_async_wait<1>();       // this stage's copies have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();            // ... everyone's, and its flags
    const int buf = st & 1, kb = klo + st * KS;
    const bf16* kd = Ks + buf * KS * LDS;
    const bf16* vd = Vs + buf * KS * LDS;
    const int* sn = seen + buf * KS;
    if (warp_live) {
      // S = Q K^T over the stage's 64 keys: 8 n-tiles of 8 keys
      float sc[KS / 8][4];
#pragma unroll
      for (int j = 0; j < KS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
#pragma unroll
      for (int j = 0; j < KS / 8; j += 2)
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          uint32_t b[4];
          ldsm_x4(b, kd + (8 * j + (lane & 7) + 8 * (lane >> 4)) * LDS +
                         16 * ks + 8 * ((lane >> 3) & 1));
          mma16816(sc[j], qf[ks], b[0], b[1]);
          mma16816(sc[j + 1], qf[ks], b[2], b[3]);
        }
      // scale, softcap, masks, online softmax; sc becomes p
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float mx = NEG_INF;
        unsigned okb = 0;
#pragma unroll
        for (int j = 0; j < KS / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kk = 8 * j + 2 * t + c, kpos = kb + kk;
            float v = sc[j][2 * u + c] * scale;
            if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
            const bool ok = row_ok[u] && sn[kk] && kpos <= qpos[u] &&
                            (window <= 0 || qpos[u] - kpos < window);
            okb |= (unsigned)ok << (2 * j + c);
            sc[j][2 * u + c] = ok ? v : NEG_INF;
            mx = fmaxf(mx, sc[j][2 * u + c]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[u], mx);
        const float alpha = expf(m[u] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < KS / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = (okb >> (2 * j + c)) & 1u
                                ? expf(sc[j][2 * u + c] - m_new)
                                : 0.f;
            sc[j][2 * u + c] = p;
            psum += p;
          }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l[u] = alpha * l[u] + psum;
        m[u] = m_new;
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j) {
          o[j][2 * u] *= alpha;
          o[j][2 * u + 1] *= alpha;
        }
      }
      // O += P V, P as a bf16 high part and a bf16 remainder
#pragma unroll
      for (int kc = 0; kc < KS / 16; ++kc) {
        // A fragment of keys 16 kc .. 16 kc + 15: n-tiles 2 kc, 2 kc + 1
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = sc[2 * kc + (i >> 1)][2 * (i & 1)];
          const float b = sc[2 * kc + (i >> 1)][2 * (i & 1) + 1];
          hi[i] = pack2(a, b);
          lo[i] = pack2(rest(a), rest(b));
        }
#pragma unroll
        for (int dn = 0; dn < KT; ++dn) {
          uint32_t b[4];
          ldsm_x4_t(b, vd + (16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                LDS +
                           16 * dn + 8 * (lane >> 4));
          mma16816(o[2 * dn], hi, b[0], b[1]);
          mma16816(o[2 * dn + 1], hi, b[2], b[3]);
          mma16816(o[2 * dn], lo, b[0], b[1]);
          mma16816(o[2 * dn + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();            // the buffer is free for stage st + 2
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!row_ok[u]) continue;
    bf16* orow = out + (qrow[u] - q);
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      const float a = l[u] > 0.f ? o[j][2 * u] / l[u] : 0.f;
      const float b = l[u] > 0.f ? o[j][2 * u + 1] / l[u] : 0.f;
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) = pack2(a, b);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 decode: keys split across warps and blocks
// ---------------------------------------------------------------------------

constexpr int DK = 32;                  // keys a warp stages, one a lane
constexpr int DEC_MAX_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

// the bf16 decode's dynamic shared memory: q's rows in f32, then per warp
// two buffers of K and V, DK padded rows each
size_t decode_smem_bytes(int warps, int rows, int hd) {
  return sizeof(float) * (size_t)rows * hd +
         (size_t)warps * 2 * 2 * DK * (hd + 8) * sizeof(bf16);
}

// grid (n_slots, n_kv * row_blocks, splits), 32 * warps threads. Block
// (s, y, z) owns query rows [g0, g0 + G) of kv head h = y / row_blocks
// (rows past the group are computed on zeros and never stored) and the
// z-th of `splits` contiguous runs of slot s's live keys; warp w takes
// the run's 32-key chunks w, w + warps, ... hd = 8 * CH <= 64 * U.
template <int G, int U>
__global__ void __launch_bounds__(DEC_MAX_WARPS * 32)
decode_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                   const bf16* __restrict__ vp,
                   const int* __restrict__ table,
                   const int* __restrict__ positions, bf16* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int* __restrict__ counter, int n_kv, int group, int hd,
                   int block_len, int bps, float scale, float softcap,
                   int window, int row_blocks) {
  const int LDS = hd + 8, CH = hd / 8, HP = hd / 2;
  extern __shared__ __align__(16) uint8_t dec_smem[];
  float* qs = reinterpret_cast<float*>(dec_smem);          // [G][hd]
  // [warps][2 buffers][K, V][DK][LDS]
  bf16* stage = reinterpret_cast<bf16*>(qs + G * hd);
  __shared__ int is_last;

  const int s = blockIdx.x, n_slots = gridDim.x;
  const int h = blockIdx.y / row_blocks;
  const int g0 = (blockIdx.y % row_blocks) * G;
  const int ng = min(G, group - g0);
  const int splits = gridDim.z, z = blockIdx.z;
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the slot's live keys [klo, khi]: up to its position, inside the
  // window; this block's run of them is [k0, k1)
  const int pos = positions[s];
  const int khi = min(bps * block_len - 1, pos);
  const int klo = window > 0 ? max(0, pos - window + 1) : 0;
  const int live = max(0, khi - klo + 1);
  const int k0 = klo + (int)((long long)z * live / splits);
  const int k1 = klo + (int)((long long)(z + 1) * live / splits);
  const int n_chunks = (k1 - k0 + DK - 1) / DK;
  const int mine = warp < n_chunks ? (n_chunks - 1 - warp) / warps + 1 : 0;
  const size_t row0 = ((size_t)s * n_kv + h) * group + g0;

  for (int e = tid; e < G * hd; e += blockDim.x) {
    const int g = e / hd;
    qs[e] = g < ng ? __bfloat162float(q[(row0 + g) * hd + e % hd]) * scale
                   : 0.f;
  }

  // Stage chunk c of the run into buffer b: lane i looks up key i's page,
  // then every lane copies 16-byte pieces of the chunk's K and V rows.
  // A key past the run or on a null page is zero-filled, not read.
  // Returns whether this lane's key is one to attend.
  bf16* wbuf = stage + (size_t)warp * 2 * 2 * DK * LDS;
  auto load = [&](int c, int b) -> bool {
    const int kb = k0 + c * DK, kpos = kb + lane;
    const int phys =
        kpos < k1 ? table[(size_t)s * bps + kpos / block_len] : 0;
    bf16* kd = wbuf + b * 2 * DK * LDS;
    bf16* vd = kd + DK * LDS;
    for (int i = 0; i < CH; ++i) {
      const int e = lane + 32 * i, key = e / CH, ch = e - key * CH;
      const int ph = __shfl_sync(FULL, phys, key);
      const int kk = kb + key;
      const size_t src =
          (((size_t)ph * block_len + kk % block_len) * n_kv + h) * hd + 8 * ch;
      cp_async16(kd + key * LDS + 8 * ch, ph ? kp + src : kp, ph ? 16 : 0);
      cp_async16(vd + key * LDS + 8 * ch, ph ? vp + src : vp, ph ? 16 : 0);
    }
    cp_async_commit();
    return phys != 0;
  };

  float m[G], l[G], acc[G][U][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) acc[g][u][0] = acc[g][u][1] = 0.f;
  }
  bool ok = false, ok_next = false;
  if (mine > 0) ok = load(warp, 0);
  __syncthreads();                        // q's rows are staged

  for (int i = 0; i < mine; ++i) {
    const int b = i & 1;
    if (i + 1 < mine) {
      ok_next = load(warp + (i + 1) * warps, b ^ 1);
      cp_async_wait<1>();                 // this chunk's copies have landed
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();                         // ... every lane's
    const bf16* kd = wbuf + b * 2 * DK * LDS;
    const bf16* vd = kd + DK * LDS;
    const int nk = min(DK, k1 - (k0 + (warp + i * warps) * DK));

    // scores of this lane's key for the block's rows: q (f32, scaled)
    // broadcast from shared memory, K as 16-byte bf16 loads
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    const bf16* krow = kd + lane * LDS;
    for (int c = 0; c < CH; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + 8 * c);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kf[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(k2[j]);
        kf[2 * j] = f.x;
        kf[2 * j + 1] = f.y;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(qs + g * hd + 8 * c);
        const float4 a2 =
            *reinterpret_cast<const float4*>(qs + g * hd + 8 * c + 4);
        float d = sc[g];
        d = fmaf(a.x, kf[0], d);
        d = fmaf(a.y, kf[1], d);
        d = fmaf(a.z, kf[2], d);
        d = fmaf(a.w, kf[3], d);
        d = fmaf(a2.x, kf[4], d);
        d = fmaf(a2.y, kf[5], d);
        d = fmaf(a2.z, kf[6], d);
        d = fmaf(a2.w, kf[7], d);
        sc[g] = d;
      }
    }
    // softcap, mask, online softmax; sc becomes p
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v = sc[g];
      if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
      v = ok ? v : NEG_INF;
      const float m_new = fmaxf(m[g], warp_max(v));
      const float alpha = expf(m[g] - m_new);
      const float p = ok ? expf(v - m_new) : 0.f;
      l[g] = alpha * l[g] + warp_sum(p);
      m[g] = m_new;
      sc[g] = p;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[g][u][0] *= alpha;
        acc[g][u][1] *= alpha;
      }
    }
    // acc += p V: this lane's pairs of dims, each key's p from its lane
    for (int key = 0; key < nk; ++key) {
      float pk[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pk[g] = __shfl_sync(FULL, sc[g], key);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = lane + 32 * u;
        if (j < HP) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vd + key * LDS +
                                                       2 * j));
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g][u][0] = fmaf(pk[g], f.x, acc[g][u][0]);
            acc[g][u][1] = fmaf(pk[g], f.y, acc[g][u][1]);
          }
        }
      }
    }
    ok = ok_next;
    __syncwarp();                         // buffer b is free again
  }

  // merge the warps' partials in warp order, through the staging memory
  __syncthreads();
  const int MS = hd + 2;                  // acc[hd], m, l per row
  float* mg = reinterpret_cast<float*>(stage);   // [warps][G][MS]
  float* my = mg + (size_t)warp * G * MS;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = lane + 32 * u;
      if (j < HP) {
        my[g * MS + 2 * j] = acc[g][u][0];
        my[g * MS + 2 * j + 1] = acc[g][u][1];
      }
    }
    if (lane == 0) {
      my[g * MS + hd] = m[g];
      my[g * MS + hd + 1] = l[g];
    }
  }
  __syncthreads();
  const size_t rows = (size_t)n_slots * n_kv * group;
  for (int e = tid; e < ng * hd; e += blockDim.x) {
    const int g = e / hd, d = e - g * hd;
    float M = NEG_INF;
    for (int w = 0; w < warps; ++w) M = fmaxf(M, mg[(w * G + g) * MS + hd]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float* r = mg + (w * G + g) * MS;
      const float f = expf(r[hd] - M);
      L += f * r[hd + 1];
      A += f * r[d];
    }
    if (splits == 1) {
      out[(row0 + g) * hd + d] = __float2bfloat16(L > 0.f ? A / L : 0.f);
    } else {
      const size_t pr = (size_t)z * rows + row0 + g;
      part_acc[pr * hd + d] = A;
      if (d == 0) {
        part_ml[2 * pr] = M;
        part_ml[2 * pr + 1] = L;
      }
    }
  }
  if (splits == 1) return;

  // the last block of the (slot, kv head, row block) to finish merges the
  // splits' partials in split order
  __threadfence();                        // the partials are visible first
  __syncthreads();
  if (tid == 0) {
    int* cnt = counter + (size_t)s * gridDim.y + blockIdx.y;
    is_last = atomicAdd(cnt, 1) == splits - 1;
    if (is_last) *cnt = 0;                // reset for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int e = tid; e < ng * hd; e += blockDim.x) {
    const int g = e / hd, d = e - g * hd;
    const size_t r = row0 + g;
    float M = NEG_INF;
    for (int zz = 0; zz < splits; ++zz)
      M = fmaxf(M, __ldcg(part_ml + 2 * (zz * rows + r)));
    float L = 0.f, A = 0.f;
    for (int zz = 0; zz < splits; ++zz) {
      const size_t pr = zz * rows + r;
      const float f = expf(__ldcg(part_ml + 2 * pr) - M);
      L += f * __ldcg(part_ml + 2 * pr + 1);
      A += f * __ldcg(part_acc + pr * hd + d);
    }
    out[r * hd + d] = __float2bfloat16(L > 0.f ? A / L : 0.f);
  }
}

size_t smem_bytes(int hd, int block_len) {
  return sizeof(float) * ((size_t)ROWS * hd + (size_t)block_len * (hd + 1) +
                          (size_t)block_len * hd + (size_t)WARPS * block_len);
}

// attend's and the bf16 decode's shared memory depend on the shapes:
// their kernels are allowed the card's whole opt-in maximum once, less
// what the kernel holds statically; the wrappers refuse shapes above it.
template <typename K>
cudaError_t allow_max_smem(OncePerDevice& once, K kernel) {
  return once([kernel] {
    int dev = 0, most = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most - (int)attr.sharedSizeBytes);
  });
}

// attend's kernels: the f32 decode and the f32 prefill.
cudaError_t launch_decode_f32(const void* q, const void* kp, const void* vp,
                              const int* table, const int* pos, void* out,
                              int n_slots, int n_kv, int group, int hd,
                              int block_len, int bps, float scale,
                              float softcap, int window,
                              cudaStream_t stream) {
  static OncePerDevice smem_attr;
  cudaError_t err = allow_max_smem(smem_attr, paged_decode_kernel<float>);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_slots, n_kv, (group + ROWS - 1) / ROWS);
  paged_decode_kernel<float><<<grid, THREADS, smem_bytes(hd, block_len),
                               stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), table, pos, static_cast<float*>(out),
      n_kv, group, hd, block_len, bps, scale, softcap, window);
  return cudaGetLastError();
}

template <int G, int U>
cudaError_t launch_decode_bf16(const void* q, const void* kp, const void* vp,
                               const int* table, const int* pos, void* out,
                               float* part_acc, float* part_ml, int* counter,
                               int n_slots, int n_kv, int group, int hd,
                               int block_len, int bps, float scale,
                               float softcap, int window, int warps,
                               int row_blocks, int splits,
                               cudaStream_t stream) {
  static OncePerDevice smem_attr;
  cudaError_t err = allow_max_smem(smem_attr, decode_bf16_kernel<G, U>);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_slots, n_kv * row_blocks, splits);
  decode_bf16_kernel<G, U><<<grid, 32 * warps,
                             decode_smem_bytes(warps, G, hd), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), table, pos, static_cast<bf16*>(out),
      part_acc, part_ml, counter, n_kv, group, hd, block_len, bps, scale,
      softcap, window, row_blocks);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_decode_rows(const void* q, const void* kp, const void* vp,
                               const int* table, const int* pos, void* out,
                               float* part_acc, float* part_ml, int* counter,
                               int n_slots, int n_kv, int group, int hd,
                               int block_len, int bps, float scale,
                               float softcap, int window, int warps,
                               int row_blocks, int splits,
                               cudaStream_t stream) {
#define DEC_ARGS                                                          \
  q, kp, vp, table, pos, out, part_acc, part_ml, counter, n_slots, n_kv,  \
      group, hd, block_len, bps, scale, softcap, window, warps,            \
      row_blocks, splits, stream
  if (hd <= 64) return launch_decode_bf16<G, 1>(DEC_ARGS);
  if (hd <= 128) return launch_decode_bf16<G, 2>(DEC_ARGS);
  return launch_decode_bf16<G, 4>(DEC_ARGS);
#undef DEC_ARGS
}

cudaError_t launch_prefill_f32(const void* q, const void* kp, const void* vp,
                               const int* table, const int* offsets,
                               void* out, int n_slots, int sq, int n_kv,
                               int group, int hd, int block_len, int bps,
                               float scale, float softcap, int window,
                               cudaStream_t stream) {
  static OncePerDevice smem_attr;
  cudaError_t err = allow_max_smem(smem_attr, paged_prefill_kernel<float>);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_slots, n_kv, (sq * group + ROWS - 1) / ROWS);
  paged_prefill_kernel<float><<<grid, THREADS, smem_bytes(hd, block_len),
                                stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), table, offsets,
      static_cast<float*>(out), sq, n_kv, group, hd, block_len, bps, scale,
      softcap, window);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_tc(const void* q, const void* kp, const void* vp,
                      const int* table, const int* offsets, void* out,
                      int n_slots, int sq, int n_kv, int group,
                      int block_len, int bps, float scale, float softcap,
                      int window, int warps, int row_blocks,
                      cudaStream_t stream) {
  static OncePerDevice smem_attr;
  constexpr size_t smem = tc_smem_bytes<KT>();
  cudaError_t err = smem_attr([] {
    return cudaFuncSetAttribute(prefill_tc_kernel<KT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  });
  if (err != cudaSuccess) return err;
  const dim3 grid(n_slots, n_kv, row_blocks);
  prefill_tc_kernel<KT><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), table, offsets, static_cast<bf16*>(out),
      sq, n_kv, group, block_len, bps, scale, softcap, window);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bf16.
// Return the cudaError_t of the launch (0 = success).
//
// Decode: f32 runs attend (the plan's arguments are ignored); bf16 runs
// decode_bf16_kernel on the wrapper's decode_plan: warps (1 .. 4), rows
// of the group a block takes (1, 2, 4 or 8) and row_blocks covering the
// group, splits (>= 1) of each slot's keys; hd a multiple of 8 up to 256.
// With splits > 1, part_acc is f32 (splits, n_slots * n_kv * group, hd)
// scratch, part_ml f32 (splits, n_slots * n_kv * group, 2), and counter
// holds n_slots * n_kv * row_blocks int32 zeros, which the kernel leaves
// at zero.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const int* table,
    const int* positions, void* out, float* part_acc, float* part_ml,
    int* counter, int n_slots, int n_kv, int group, int hd, int block_len,
    int bps, float scale, float softcap, int window, int warps, int rows,
    int row_blocks, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1)
    return (int)launch_decode_f32(q, k_pool, v_pool, table, positions, out,
                                  n_slots, n_kv, group, hd, block_len, bps,
                                  scale, softcap, window, s);
  if (warps < 1 || warps > DEC_MAX_WARPS || hd % 8 || hd < 8 || hd > 256 ||
      row_blocks * rows < group || splits < 1 ||
      (splits > 1 && (!part_acc || !part_ml || !counter)))
    return (int)cudaErrorInvalidValue;
  switch (rows) {
#define ROWS_CASE(G)                                                       \
  case G:                                                                  \
    return (int)launch_decode_rows<G>(q, k_pool, v_pool, table, positions, \
                                      out, part_acc, part_ml, counter,     \
                                      n_slots, n_kv, group, hd, block_len, \
                                      bps, scale, softcap, window, warps,  \
                                      row_blocks, splits, s);
    ROWS_CASE(1) ROWS_CASE(2) ROWS_CASE(4) ROWS_CASE(8)
#undef ROWS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Prefill: f32 runs attend; bf16 runs the tensor-core kernel, for hd a
// multiple of 16 up to 128, with warps (1 .. 8, 16 query rows each) and
// row_blocks from the wrapper's prefill_plan covering sq * group rows
// (f32 ignores both).
extern "C" int paged_prefill_launch(const void* q, const void* k_pool,
                                    const void* v_pool, const int* table,
                                    const int* offsets, void* out,
                                    int n_slots, int sq, int n_kv, int group,
                                    int hd, int block_len, int bps,
                                    float scale, float softcap, int window,
                                    int warps, int row_blocks, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1)
    return (int)launch_prefill_f32(q, k_pool, v_pool, table, offsets, out,
                                   n_slots, sq, n_kv, group, hd, block_len,
                                   bps, scale, softcap, window, s);
  if (warps < 1 || warps > TC_MAX_WARPS ||
      row_blocks * warps * 16 < sq * group)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
#define TC_CASE(KT)                                                        \
  case 16 * KT:                                                            \
    return (int)launch_tc<KT>(q, k_pool, v_pool, table, offsets, out,      \
                              n_slots, sq, n_kv, group, block_len, bps,    \
                              scale, softcap, window, warps, row_blocks, s);
    TC_CASE(1) TC_CASE(2) TC_CASE(3) TC_CASE(4)
    TC_CASE(5) TC_CASE(6) TC_CASE(7) TC_CASE(8)
#undef TC_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Shared memory one launch of attend needs, so the wrapper can refuse
// shapes the card cannot hold before launching.
extern "C" long long paged_attention_smem_bytes(int hd, int block_len) {
  return (long long)smem_bytes(hd, block_len);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
