// Flash attention forward for Hopper (sm_90a).
//
// Replaces mxtpu/ops/pallas/flash_attention.py:_fa_kernel (launched there by
// _fa_forward_pallas through pl.pallas_call). For q [B, H, T, D] and k, v
// [B, H, Tk, D], all float32 or all bfloat16, it computes
//
//     s   = (q . k^T) * scale      in float32, -1e30 where causal and q_pos < k_pos
//     out = softmax(s) . v         in the input type, [B, H, T, D] contiguous
//     lse = logsumexp(s)           float32 [B, H, T]
//
// with an online softmax, so the [T, Tk] score matrix never reaches device
// memory: each block keeps its running max m, running sum l and the
// [64, D] accumulator in registers while it walks the k/v tiles. The
// arithmetic is the TPU kernel's: products and sums in float32 (no TF32),
// m_new = max(m, rowmax s), p = exp(s - m_new), l = l*alpha + rowsum p,
// acc = acc*alpha + p . v with alpha = exp(m - m_new); in bfloat16 p is
// rounded to bfloat16 before p . v (l sums the unrounded p); finally
// out = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)). A causal
// k tile that lies wholly above the diagonal of the q tile is skipped.
//
// What is a TPU artifact in the Pallas kernel and is not carried over:
// K arrives there pre-transposed [bh, D, Tk] for the MXU, here it is read as
// [Tk, D] rows; lse is lane-replicated over 128 lanes there, here it is
// written once per row; D is zero-padded to 128 there and T must fill 8/128
// granules, here D <= 128 is masked to the next of 32/64/128 in shared
// memory and the ragged q and k tails are masked in the kernel, so every T
// runs it. q, k and v are read through their batch, head and row strides
// (the last dim contiguous), so the views that slice q, k and v out of one
// fused projection need no copy.
//
// What bounds it on an H100 SXM (67 TFLOP/s float32 on the CUDA cores, 989
// TFLOP/s bf16 on the tensor cores, 3.35 TB/s): at the served shapes (T 128
// to 512, D 64, T = Tk) attention does 4*T*Tk*D FLOPs for (3*Tk + T)*D
// elements moved, T FLOPs per element: 32-128 per byte in float32, above
// the CUDA cores' ridge of 20, so bound by operations; 64-256 per byte in
// bfloat16, below the tensor cores' ridge of 295, so bound by bytes (half
// of that with the causal skip). This first version
// keeps every product on the CUDA cores in float32 (bf16 is widened on
// load): one 256-thread block per (b*h, 64-row q tile); q, the current k
// and v tiles and the p tile in shared memory as float32, rows padded so
// that the column walks hit distinct banks; each thread owns a 4 x 4 tile
// of s (4 rows, 4 strided keys) and the same 4 rows x D/16 strided columns
// of acc, and the row max and sum are shuffles over the 16 lanes that share
// a row. mma.sync / wgmma with TMA-fed tiles for bfloat16 is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int THREADS = 256;    // 16 row groups x 16 lanes
constexpr int PS = BK + 4;      // row stride of the p tile (no bank conflicts)
constexpr float NEG = -1e30f;   // the TPU kernel's mask value: never -inf - -inf
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// p in the value type, back in float32: the TPU kernel's p.astype(v.dtype)
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f32(from_f32<T>(p));
}

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;                     // [B, H, T, D] contiguous, the input type
  float* lse;                    // [B, H, T] contiguous
  long long qsb, qsh, qst;       // element strides of q's batch, head, row
  long long ksb, ksh, kst;
  long long vsb, vsh, vst;
  int h, t, tk, d, causal, n_q;
  float scale;
};

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (DP + 1) + 2 * BK * (DP + 1) + BQ * PS);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(FaArgs a) {
  constexpr int RS = DP + 1;     // row stride of the q, k and v tiles
  constexpr int DJ = DP / 16;    // acc columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][RS]
  float* Ks = Qs + BQ * RS;      // [BK][RS]
  float* Vs = Ks + BK * RS;      // [BK][RS]
  float* Ps = Vs + BK * RS;      // [BQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;       // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;       // keys / columns tx + 16*j
  const int qi = blockIdx.x % a.n_q;
  const int bh = blockIdx.x / a.n_q;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int q0 = qi * BQ;
  const T* __restrict__ q = static_cast<const T*>(a.q) + bi * a.qsb + hi * a.qsh;
  const T* __restrict__ k = static_cast<const T*>(a.k) + bi * a.ksb + hi * a.ksh;
  const T* __restrict__ v = static_cast<const T*>(a.v) + bi * a.vsb + hi * a.vsh;

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    float x = 0.f;
    if (q0 + r < a.t && c < a.d) x = to_f32(q[(q0 + r) * a.qst + c]);
    Qs[r * RS + c] = x;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // causal: a k tile runs when k0 <= q0 + BQ - 1 (the TPU kernel's skip)
  const int k_end = a.causal ? min(a.tk, q0 + BQ) : a.tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // q is staged; the last tile's readers are done
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < a.tk && c < a.d) {
        kx = to_f32(k[(k0 + r) * a.kst + c]);
        vx = to_f32(v[(k0 + r) * a.vst + c]);
      }
      Ks[r * RS + c] = kx;
      Vs[r * RS + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float qr[4], kr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[i] = Qs[(ty * 4 + i) * RS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kr[j] = Ks[(tx + 16 * j) * RS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        // a key past Tk gets the mask value too: key 0 is in every row's
        // first tile, so m is a real score before any masked p is formed
        // and exp(-1e30 - m) is exactly 0
        if (kp >= a.tk || (a.causal && qp < kp)) x = NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = round_p<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(FULL, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vx = Vs[c * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vx, acc[i][j]);
      }
    }
  }

  T* out = static_cast<T*>(a.out) + (size_t)bh * a.t * a.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= a.t) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < a.d) out[(size_t)r * a.d + c] = from_f32<T>(acc[i][j] / den);
    }
    if (tx == 0) a.lse[(size_t)bh * a.t + r] = m[i] + logf(den);
  }
}

template <typename T, int DP>
int launch(const FaArgs& a, unsigned blocks, cudaStream_t s) {
  const size_t smem = smem_bytes<DP>();
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_attention_kernel<T, DP><<<blocks, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const FaArgs& a, unsigned blocks, cudaStream_t s) {
  if (a.d <= 32) return launch<T, 32>(a, blocks, s);
  if (a.d <= 64) return launch<T, 64>(a, blocks, s);
  return launch<T, 128>(a, blocks, s);
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 float32, 1 bfloat16. Strides are
// in elements; the last dim of q, k and v is contiguous. Launches on
// `stream` and returns a CUDA error code (0 on success); never synchronises.
extern "C" int mxtpu_flash_attention_fwd(int dtype, const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         long long qsb, long long qsh, long long qst,
                                         long long ksb, long long ksh, long long kst,
                                         long long vsb, long long vsh, long long vst,
                                         int b, int h, int t, int tk, int d,
                                         int causal, float scale, void* stream) {
  if (b < 1 || h < 1 || t < 1 || tk < 1 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  FaArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse = static_cast<float*>(lse);
  a.qsb = qsb; a.qsh = qsh; a.qst = qst;
  a.ksb = ksb; a.ksh = ksh; a.kst = kst;
  a.vsb = vsb; a.vsh = vsh; a.vst = vst;
  a.h = h; a.t = t; a.tk = tk; a.d = d; a.causal = causal;
  a.n_q = (t + BQ - 1) / BQ;
  a.scale = scale;
  const long long blocks = (long long)a.n_q * b * h;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, (unsigned)blocks, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, (unsigned)blocks, s);
  return (int)cudaErrorInvalidValue;
}
