// adam8bit: one fused blockwise 8-bit Adam step (the paper's 8-bit
// SLTrain optimizer, used by the per-layer update sweep).
//
// Replaces the Pallas TPU kernel repro/kernels/adam8bit.py::adam8bit_update
// (def at adam8bit.py:78, pallas_call at :89, body _kernel at :36).
//
// Shapes: the parameter flattened and zero-padded to (n_q, 256)
// quantization blocks. p (n_q, 256) f32 or bf16, g (n_q, 256) f32 (the
// clipped gradient), m/v codes int8 (n_q, 256), m/v scales f32 (n_q,),
// scalars f32 (10,) in device memory = [lr, b1, b2, 1-b1, 1-b2, bc1, bc2,
// eps, wd, 0], n_valid the count of real elements (int64). Outputs: the
// new p in p's dtype, new codes and new scales. The outputs may be the
// inputs themselves (in place): each lane reads its own elements before it
// writes them, and a block's scales are written after its reduction.
//
// What it computes, per element, each step one IEEE f32 operation in the
// order of the reference (repro/kernels/adam8bit.py:36-74): dequantize
// (m = code * s; v = max(code + 128, 0.5) * s), zero every lane at flat
// index >= n_valid (g, m and v, so padding never reaches a scale), then
//   m = b1*m + (1-b1)*g,   v = b2*v + ((1-b2)*g)*g,
//   u = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p,   p = p - lr*u,
// and requantize: s_m = max|m| * f32(1/127), code = rint(m / max(s_m,
// 1e-12)); s_v = max v * f32(1/255), code = rint(v / max(s_v, 1e-12)) - 128.
// The scales multiply by the f32 reciprocal because the reference is
// compiled by XLA, which rewrites its "/ 127.0" so (optim/quant.py). The
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn intrinsics
// fix every rounding point: nvcc may not contract a product and a sum into
// an FMA, and divisions and the square root are correctly rounded, so the
// result equals the plain PyTorch version (kernels/ref.py adam8bit_ref)
// bit for bit, codes, scales and parameters.
//
// What bounds it on the H100: bytes. Per element it reads p (2 or 4 B), g
// (4 B) and two codes, and writes p and two codes: 12 B per bf16
// parameter, ~40 operations. At 3.35 TB/s the 65.5 M-element embedding
// of llama_1b takes at least 0.235 ms.
//
// Design. The TPU kernel tiles 64 quantization blocks per grid step in
// VMEM. Here one warp owns one 256-element block: each lane holds 8
// consecutive elements in registers, loaded with 16-byte vector loads of
// g (and p) and one 8-byte load per code array, so the f32 moments never
// leave registers. The two block maxima are warp-shuffle reductions (no
// shared memory, no block-wide barrier); lane 0 writes the scales. Eight
// warps (eight blocks) per CTA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 256;            // quantization block (OptimizerConfig.q_block)
constexpr int EPL = Q / 32;       // elements per lane
constexpr int WARPS = 8;          // blocks per CTA
constexpr float INV_127 = 1.0f / 127.0f;
constexpr float INV_255 = 1.0f / 255.0f;

__device__ __forceinline__ void load_p(const float* p, float (&out)[EPL]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load_p(const __nv_bfloat16* p,
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

__device__ __forceinline__ void store_p(float* p, const float (&v)[EPL]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_p(__nv_bfloat16* p,
                                        const float (&v)[EPL]) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < EPL; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename P>
__global__ void __launch_bounds__(WARPS * 32)
adam8bit_kernel(P* p_out, const P* p, const float* __restrict__ g,
                int8_t* mc_out, float* ms_out, int8_t* vc_out, float* vs_out,
                const int8_t* mc, const float* ms, const int8_t* vc,
                const float* vs, const float* __restrict__ scalars,
                long long n_valid, long long n_q) {
  const int lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (blk >= n_q) return;         // the whole warp leaves together

  const float lr = __ldg(scalars + 0), b1 = __ldg(scalars + 1),
              b2 = __ldg(scalars + 2), omb1 = __ldg(scalars + 3),
              omb2 = __ldg(scalars + 4), bc1 = __ldg(scalars + 5),
              bc2 = __ldg(scalars + 6), eps = __ldg(scalars + 7),
              wd = __ldg(scalars + 8);

  const long long base = blk * Q + lane * EPL;
  float pv[EPL], gv[EPL];
  load_p(p + base, pv);
  load_p(g + base, gv);
  const int2 mraw = *reinterpret_cast<const int2*>(mc + base);
  const int2 vraw = *reinterpret_cast<const int2*>(vc + base);
  const int8_t* mcv = reinterpret_cast<const int8_t*>(&mraw);
  const int8_t* vcv = reinterpret_cast<const int8_t*>(&vraw);
  const float msb = ms[blk], vsb = vs[blk];

  float m[EPL], v[EPL], pn[EPL];
  float mmax = 0.f, vmax = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const bool valid = base + i < n_valid;
    const float gi = valid ? gv[i] : 0.f;
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
  store_p(p_out + base, pn);
  *reinterpret_cast<int2*>(mc_out + base) = mo;
  *reinterpret_cast<int2*>(vc_out + base) = vo;
  if (lane == 0) {
    ms_out[blk] = msn;
    vs_out[blk] = vsn;
  }
}

template <typename P>
cudaError_t launch(void* p_out, const void* p, const float* g, void* mc_out,
                   float* ms_out, void* vc_out, float* vs_out,
                   const void* mc, const float* ms, const void* vc,
                   const float* vs, const float* scalars, long long n_valid,
                   long long n_q, cudaStream_t stream) {
  const long long grid = (n_q + WARPS - 1) / WARPS;
  adam8bit_kernel<P><<<(unsigned)grid, WARPS * 32, 0, stream>>>(
      static_cast<P*>(p_out), static_cast<const P*>(p), g,
      static_cast<int8_t*>(mc_out), ms_out, static_cast<int8_t*>(vc_out),
      vs_out, static_cast<const int8_t*>(mc), ms,
      static_cast<const int8_t*>(vc), vs, scalars, n_valid, n_q);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype of p: 0 = float32,
// 1 = bf16. Every pointer is 16-byte aligned (the wrapper checks). Returns
// the cudaError_t of the launch (0 = success).
extern "C" int adam8bit_launch(void* p_out, const void* p, const float* g,
                               void* mc_out, float* ms_out, void* vc_out,
                               float* vs_out, const void* mc, const float* ms,
                               const void* vc, const float* vs,
                               const float* scalars, long long n_valid,
                               long long n_q, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(p_out, p, g, mc_out, ms_out, vc_out,
                                      vs_out, mc, ms, vc, vs, scalars,
                                      n_valid, n_q, s);
  return (int)launch<float>(p_out, p, g, mc_out, ms_out, vc_out, vs_out, mc,
                            ms, vc, vs, scalars, n_valid, n_q, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
