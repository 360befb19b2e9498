// Fused implicit-GEMM convolution forward for Hopper (sm_90a).
//
// Replaces mxtpu/ops/pallas/conv.py:_conv_kernel (launched there by
// _forward_pallas through pl.pallas_call). It computes
//
//     out  = relu(conv(x, w) * scale + bias + residual)   (each term optional)
//     craw = conv(x, w) in float32                         (only when scale is given)
//
// for NHWC x [N, H, W, Cin] and HWIO w [KH, KW, Cin, Cout], any stride and
// non-negative padding, groups 1, no dilation; x and w are both float32 or
// both bfloat16, out has their type, scale and bias are float32 [Cout],
// residual is [N, OH, OW, Cout] in the output type or float32.
//
// The convolution is a GEMM of M = N*OH*OW output pixels by Cout channels
// over K = KH*KW*Cin. HWIO w already is a row-major [K, Cout] matrix; the
// rows of A are gathered from x on the fly: k = (dy*KW + dx)*Cin + c reads
// x[n, oh*SH + dy - PH, ow*SW + dx - PW, c], and a tap that falls in the
// padding reads 0. The TPU kernel needed a stride-phase copy of the padded
// input (_phase_pack) and halo-duplicated row blocks so that Mosaic saw only
// static stride-1, block-aligned slices; here every thread computes its own
// coordinates, so no padded or re-laid-out copy of x is ever written.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
// float32 on the CUDA cores, 3.35 TB/s): at batch 8 the ResNet-50 convs this
// kernel serves are memory-bound in bfloat16 -- the 7x7/2 stem does about
// 126 FLOP per byte it must move and the 1x1 convs 30-50, against a ridge of
// about 295. In float32 (TF32 is off by the package's precision policy) the
// CUDA-core ridge is 20 FLOP per byte, so the stem and the 3x3 become
// compute-bound and the 1x1 convs sit near the ridge.
//
// What the design does about it: each output element is written exactly
// once, epilogue included (no separate pass for scale/bias/residual/ReLU),
// and x is read straight from its NHWC layout, so the bytes moved stay close
// to the bound's count (the KH*KW-fold reuse of an input pixel is served
// from L1/L2). The math is a plain shared-memory tiled GEMM on the CUDA
// cores with float32 accumulation: a 64x64 output tile per 256-thread block,
// a 4x4 register micro-tile per thread, K staged 16 at a time, and the next
// K chunk's global loads issued before the current chunk's FMAs. It does not
// reach the tensor cores; wgmma/TMA tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // im2col K per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

struct ConvArgs {
  const void* x;
  const void* w;
  const float* scale;     // nullptr when absent
  const float* bias;      // nullptr when absent
  const void* residual;   // nullptr when absent
  int res_f32;            // residual is float32 (else the output type)
  void* out;
  float* craw;            // written only when scale is given
  int n, h, wd, cin, kh, kw, cout, sh, sw, ph, pw, oh, ow, relu;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_conv_kernel(ConvArgs a) {
  // A is staged K-major so one thread reads its 4 pixels as one float4
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  const int M = a.n * a.oh * a.ow;
  const int K = a.kh * a.kw * a.cin;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: one output pixel per thread, 4 consecutive k of each chunk
  const int a_row = tid >> 2;
  const int a_k = (tid & 3) * 4;
  const int am = m0 + a_row;
  const bool a_valid = am < M;
  int ih0 = 0, iw0 = 0;
  const T* xn = x;
  if (a_valid) {
    const int plane = a.oh * a.ow;
    const int img = am / plane;
    const int r = am - img * plane;
    const int oh = r / a.ow;
    const int ow = r - oh * a.ow;
    ih0 = oh * a.sh - a.ph;
    iw0 = ow * a.sw - a.pw;
    xn = x + (size_t)img * a.h * a.wd * a.cin;
  }
  // (dy, dx, c) of k = k0 + a_k, carried from chunk to chunk without division
  int kc = a_k, kdx = 0, kdy = 0;
  while (kc >= a.cin) {
    kc -= a.cin;
    if (++kdx == a.kw) { kdx = 0; ++kdy; }
  }

  // B loader: one k row per thread, 4 consecutive output channels
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 4;

  float a_reg[4], b_reg[4];
  auto load_chunk = [&](int k0) {
    int c = kc, dx = kdx, dy = kdy;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      if (a_valid && dy < a.kh) {
        const int ih = ih0 + dy;
        const int iw = iw0 + dx;
        if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.wd)
          v = to_f32(xn[((size_t)ih * a.wd + iw) * a.cin + c]);
      }
      a_reg[i] = v;
      if (++c == a.cin) {
        c = 0;
        if (++dx == a.kw) { dx = 0; ++dy; }
      }
    }
    const int k = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + b_n + j;
      b_reg[j] = (k < K && col < a.cout) ? to_f32(w[(size_t)k * a.cout + col]) : 0.f;
    }
    // advance the carried decomposition to the next chunk
    kc += BK;
    while (kc >= a.cin) {
      kc -= a.cin;
      if (++kdx == a.kw) { kdx = 0; ++kdy; }
    }
  };

  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_chunk(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_k + i][a_row] = a_reg[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[b_k][b_n + j] = b_reg[j];
    __syncthreads();
    if (k0 + BK < K) load_chunk(k0 + BK);  // in flight during this chunk's FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  // fused epilogue in float32; one store per output element
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= a.cout) continue;
      const size_t o = (size_t)m * a.cout + col;
      float v = acc[i][j];
      if (a.scale != nullptr) {
        a.craw[o] = v;
        v *= a.scale[col];
      }
      if (a.bias != nullptr) v += a.bias[col];
      if (a.residual != nullptr)
        v += a.res_f32 ? static_cast<const float*>(a.residual)[o]
                       : to_f32(static_cast<const T*>(a.residual)[o]);
      if (a.relu && v < 0.f) v = 0.f;  // NaN passes, as jnp.maximum(v, 0)
      out[o] = from_f32<T>(v);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 float32, 1 bfloat16. Launches on
// `stream` and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int mxtpu_fused_conv_fwd(int dtype, const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    const void* residual, int res_f32, void* out,
                                    void* craw, int n, int h, int wd, int cin,
                                    int kh, int kw, int cout, int sh, int sw,
                                    int ph, int pw, int oh, int ow, int relu,
                                    void* stream) {
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.residual = residual;
  a.res_f32 = res_f32;
  a.out = out;
  a.craw = static_cast<float*>(craw);
  a.n = n; a.h = h; a.wd = wd; a.cin = cin; a.kh = kh; a.kw = kw; a.cout = cout;
  a.sh = sh; a.sw = sw; a.ph = ph; a.pw = pw; a.oh = oh; a.ow = ow; a.relu = relu;
  const long long m = (long long)n * oh * ow;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    fused_conv_kernel<float><<<grid, THREADS, 0, s>>>(a);
  else if (dtype == 1)
    fused_conv_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
