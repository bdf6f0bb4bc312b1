// adam8bit: the fused blockwise 8-bit Adam step (the paper's 8-bit
// SLTrain optimizer, used by the per-layer update sweep), over a list of
// segments in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/adam8bit.py::adam8bit_update
// (def at adam8bit.py:78, pallas_call at :89, body _kernel at :36).
//
// A segment is one parameter leaf or one layer's slice of a stacked leaf:
// p (n elements, contiguous, f32 or bf16), its gradient g (n elements, f32
// or bf16), the moments' int8 codes (ceil(n/256) blocks of 256) and f32
// scales (one per block), and whether weight decay applies. Shared by all
// segments of a launch: scalars f32 (10,) in device memory = [lr, b1, b2,
// 1-b1, 1-b2, bc1, bc2, eps, wd, 0] and the step's clip scale, an f32
// device scalar (null: no clipping). Every output is written in place:
// each lane reads its own elements before it writes them, and a block's
// scales are written after its reduction.
//
// What it computes, per element, each step one IEEE f32 operation in the
// order of the reference (repro/kernels/adam8bit.py:36-74) with the
// gradient clipped first, as the optimizer's g.float() * scale does:
// g = g * clip; dequantize (m = code * s; v = max(code + 128, 0.5) * s),
// zero every lane at flat index >= n (g, m and v, so padding never reaches
// a scale), then
//   m = b1*m + (1-b1)*g,   v = b2*v + ((1-b2)*g)*g,
//   u = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p,   p = p - lr*u,
// with wd = scalars[8] where the segment decays and 0 where it does not,
// and requantize: s_m = max|m| * f32(1/127), code = rint(m / max(s_m,
// 1e-12)); s_v = max v * f32(1/255), code = rint(v / max(s_v, 1e-12)) - 128.
// The scales multiply by the f32 reciprocal because the reference is
// compiled by XLA, which rewrites its "/ 127.0" so (optim/quant.py). The
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn intrinsics
// fix every rounding point: nvcc may not contract a product and a sum into
// an FMA, and divisions and the square root are correctly rounded, so the
// result equals the plain PyTorch version (kernels/ref.py
// adam8bit_segment_ref) bit for bit, codes, scales and parameters.
//
// What bounds it on the H100: by the roofline, bytes; at the per-layer
// sweep's sizes, the launches. Per element it reads p (2 or 4 B), g (2 or
// 4 B) and two codes, and writes p and two codes: 10 B per bf16 parameter
// with a bf16 gradient, ~40 operations. At 3.35 TB/s the 65.5 M-element
// embedding of llama_1b takes at least 0.196 ms. Most segments are far
// smaller (a layer's norm holds 2048 elements), so one launch per leaf
// waited on the launch and its host work; one launch per segment list
// does not.
//
// Design. The TPU kernel tiles 64 quantization blocks per grid step in
// VMEM. Here one warp owns one 256-element block: each lane holds 8
// consecutive elements in registers, loaded with 16-byte vector loads of
// g and p (8-byte loads of the codes) where the block is whole and its
// segment's p and g start on 16-byte bounds, element by element where it
// is the ragged tail of a segment (n not a multiple of 256: the lanes past
// n are neither read nor written, so nothing is padded or copied), so the
// f32 moments never leave registers. The two block maxima are warp-shuffle
// reductions (no shared memory, no block-wide barrier); lane 0 writes the
// scales. Eight warps (eight blocks) per CTA. The segment list is a
// __grid_constant__ kernel parameter (at most MAX_SEGS entries, under the
// 4 KB parameter limit): each warp finds its block's segment by a binary
// search of the segments' first-block offsets, a prefix sum the launcher
// computes, with every lane reading the same constant-bank words.
//
// What holds it back on the card: neither the bytes nor the divisions. A
// warp lives for one block: it loads 1.5 KB, computes, stores and leaves,
// so the kernel runs as fast as the SM keeps warps resident to cover the
// loads' latency. So the kernel is templated on p's and g's types, one
// pair per launch (the wrapper splits a list by dtype), and capped at 51
// registers (5 CTAs an SM). Tried on the card and dropped, each slower: a
// kernel that switched between the four pairs inside (77 registers), more
// CTAs an SM by spilling, and a persistent grid whose warps load the next
// block during this one's math (more registers, fewer warps).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 256;            // quantization block (OptimizerConfig.q_block)
constexpr int EPL = Q / 32;       // elements per lane
constexpr int WARPS = 8;          // blocks per CTA
constexpr int MIN_CTAS = 5;       // CTAs an SM holds: at most 51 registers
constexpr int MAX_SEGS = 48;      // segments per launch (the wrapper splits)
constexpr float INV_127 = 1.0f / 127.0f;
constexpr float INV_255 = 1.0f / 255.0f;

enum : int { DECAY = 1 };

// as the wrapper's ctypes structure lays it out: 72 bytes
struct Seg {
  void* p;
  const void* g;
  int8_t* mc;
  float* ms;
  int8_t* vc;
  float* vs;
  long long n;        // elements
  long long blk0;     // the segment's first block among the launch's
  int flags;          // DECAY
  int pad_;
};
struct SegTable {
  int count;
  int pad_;
  long long blocks;   // the launch's blocks, all segments
  Seg seg[MAX_SEGS];
};
static_assert(sizeof(Seg) == 72, "Seg layout");
static_assert(sizeof(SegTable) <= 4000, "kernel parameters over 4 KB");

__device__ __forceinline__ void load8(const float* p, float (&out)[EPL]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&out)[EPL]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < EPL / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[EPL]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[EPL]) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < EPL; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// one 256-element block of a segment: its lane's 8 elements start at
// flat index base (< n)
template <typename P, typename G>
__device__ __forceinline__ void step_block(const Seg& sg, long long blk,
                                           int lane,
                                           const float* __restrict__ scalars,
                                           float clip) {
  P* p = static_cast<P*>(sg.p);
  const G* g = static_cast<const G*>(sg.g);
  const long long n = sg.n;
  const long long base = blk * Q + lane * EPL;
  const bool whole = (blk + 1) * Q <= n &&
                     ((reinterpret_cast<uintptr_t>(p) |
                       reinterpret_cast<uintptr_t>(g)) & 15) == 0;

  const float lr = __ldg(scalars + 0), b1 = __ldg(scalars + 1),
              b2 = __ldg(scalars + 2), omb1 = __ldg(scalars + 3),
              omb2 = __ldg(scalars + 4), bc1 = __ldg(scalars + 5),
              bc2 = __ldg(scalars + 6), eps = __ldg(scalars + 7),
              wd = (sg.flags & DECAY) ? __ldg(scalars + 8) : 0.f;

  float pv[EPL], gv[EPL];
  if (whole) {
    load8(p + base, pv);
    load8(g + base, gv);
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const bool valid = base + i < n;
      pv[i] = valid ? to_f(p[base + i]) : 0.f;
      gv[i] = valid ? to_f(g[base + i]) : 0.f;
    }
  }
  const int2 mraw = *reinterpret_cast<const int2*>(sg.mc + base);
  const int2 vraw = *reinterpret_cast<const int2*>(sg.vc + base);
  const int8_t* mcv = reinterpret_cast<const int8_t*>(&mraw);
  const int8_t* vcv = reinterpret_cast<const int8_t*>(&vraw);
  const float msb = sg.ms[blk], vsb = sg.vs[blk];

  float m[EPL], v[EPL], pn[EPL];
  float mmax = 0.f, vmax = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const bool valid = base + i < n;
    const float gi = valid ? __fmul_rn(gv[i], clip) : 0.f;
    float mi = valid ? __fmul_rn((float)mcv[i], msb) : 0.f;
    float vi = valid ? __fmul_rn(fmaxf((float)vcv[i] + 128.f, 0.5f), vsb)
                     : 0.f;
    mi = __fadd_rn(__fmul_rn(b1, mi), __fmul_rn(omb1, gi));
    vi = __fadd_rn(__fmul_rn(b2, vi), __fmul_rn(__fmul_rn(omb2, gi), gi));
    float u = __fdiv_rn(__fdiv_rn(mi, bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bc2)), eps));
    u = __fadd_rn(u, __fmul_rn(wd, pv[i]));
    pn[i] = __fsub_rn(pv[i], __fmul_rn(lr, u));
    m[i] = mi;
    v[i] = vi;
    mmax = fmaxf(mmax, fabsf(mi));
    vmax = fmaxf(vmax, vi);
  }
  const float msn = __fmul_rn(warp_max(mmax), INV_127);
  const float vsn = __fmul_rn(warp_max(vmax), INV_255);
  const float mdiv = fmaxf(msn, 1e-12f), vdiv = fmaxf(vsn, 1e-12f);

  int2 mo, vo;
  int8_t* mcw = reinterpret_cast<int8_t*>(&mo);
  int8_t* vcw = reinterpret_cast<int8_t*>(&vo);
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    mcw[i] = (int8_t)__float2int_rn(__fdiv_rn(m[i], mdiv));
    vcw[i] = (int8_t)(__float2int_rn(__fdiv_rn(v[i], vdiv)) - 128);
  }
  if (whole) {
    store8(p + base, pn);
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      if (base + i < n) put(p + base + i, pn[i]);
  }
  *reinterpret_cast<int2*>(sg.mc + base) = mo;
  *reinterpret_cast<int2*>(sg.vc + base) = vo;
  if (lane == 0) {
    sg.ms[blk] = msn;
    sg.vs[blk] = vsn;
  }
}

// one launch: every segment's p in P and g in G
template <typename P, typename G>
__global__ void __launch_bounds__(WARPS * 32, MIN_CTAS)
adam8bit_kernel(const __grid_constant__ SegTable t,
                const float* __restrict__ scalars,
                const float* __restrict__ clip_scale) {
  const int lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (blk >= t.blocks) return;    // the whole warp leaves together
  // the last segment whose first block is at or before blk
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.seg[mid].blk0 <= blk) lo = mid; else hi = mid - 1;
  }
  const Seg& sg = t.seg[lo];
  const float clip = clip_scale ? __ldg(clip_scale) : 1.f;
  step_block<P, G>(sg, blk - sg.blk0, lane, scalars, clip);
}

template <typename P, typename G>
cudaError_t launch(const SegTable& t, const float* scalars,
                   const float* clip_scale, cudaStream_t stream) {
  const long long grid = (t.blocks + WARPS - 1) / WARPS;
  adam8bit_kernel<P, G><<<(unsigned)grid, WARPS * 32, 0, stream>>>(
      t, scalars, clip_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): one launch over the segments
// of ``seg_table``, a SegTable (count 1 .. MAX_SEGS, blk0 the running sum
// of the segments' blocks, ``blocks`` their total), whose p are all bf16
// (p_bf16) or all f32, and whose g likewise (g_bf16). Code arrays start on
// 8-byte bounds (the wrapper checks 16). Returns the cudaError_t of the
// launch (0 = success).
extern "C" int adam8bit_launch(const void* seg_table, const float* scalars,
                               const float* clip_scale, int p_bf16,
                               int g_bf16, void* stream) {
  const SegTable& t = *static_cast<const SegTable*>(seg_table);
  if (t.count < 1 || t.count > MAX_SEGS || t.blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (p_bf16)
    return g_bf16 ? (int)launch<bf16, bf16>(t, scalars, clip_scale, s)
                  : (int)launch<bf16, float>(t, scalars, clip_scale, s);
  return g_bf16 ? (int)launch<float, bf16>(t, scalars, clip_scale, s)
                : (int)launch<float, float>(t, scalars, clip_scale, s);
}

extern "C" int adam8bit_max_segments() { return MAX_SEGS; }

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
