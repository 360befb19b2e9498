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
// residual is [N, OH, OW, Cout] in the output type or float32. The epilogue
// runs in float32 and stores each output element once; ReLU lets NaN pass,
// as jnp.maximum(v, 0) does.
//
// The convolution is a GEMM of M = N*OH*OW output pixels by Cout channels
// over K = KH*KW*Cin. HWIO w already is a row-major [K, Cout] matrix; the
// rows of A are gathered from x on the fly: k = (dy*KW + dx)*Cin + c reads
// x[n, oh*SH + dy - PH, ow*SW + dx - PW, c], and a tap that falls in the
// padding reads 0. The TPU kernel needed a stride-phase copy of the padded
// input (_phase_pack) and halo-duplicated row blocks so that Mosaic saw only
// static stride-1, block-aligned slices; here every block keeps a table of
// its pixels' (image, top, left) in shared memory and each copy computes its
// own tap, so no padded or re-laid-out copy of x is ever written.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 on the tensor cores, 67
// TFLOP/s float32 on the CUDA cores, 3.35 TB/s): at batch 8 the ResNet-50
// convs this kernel serves are bound by bytes in bfloat16 (the output write
// is the largest term: 12.8 of 16.1 MB for 1x1 64->256), and in float32,
// where TF32 stays off, by operations for all but the 1x1 64->64.
//
// bfloat16, on the tensor cores: one or two 64-row consumer warpgroups per
// block, each owning 64 pixels, over a Cout tile of 64 or 128. K runs in
// chunks of 64: in the 1x1 and 3x3 convs one chunk is one tap's 64
// channels, one 128-byte row per pixel. A chunk's A tile (pixels x 64, K
// contiguous) and B tile (64 x Cout tile, N contiguous: MN-major, the
// transpose flag) are stored in the B128 swizzled layout the wgmma
// descriptors name; each chunk is four wgmma.mma_async m64nNk16 with
// float32 accumulators. The tiles pass through a ring of 4 stages filled
// by 16-byte cp.async copies (src-size 0 zero-fills a tap in the padding,
// a pixel past M, k past K and a column past Cout) issued 3 chunks ahead,
// one barrier a chunk. Rows that are not 16-byte
// aligned, or Cin (for A) or Cout (for B) that do not fill 16-byte pieces,
// take an element-wise staging that zero-fills (the stem: Cin = 3, K = 147
// padded with zeros), one k a thread so that a warp reads 32 consecutive k
// of one pixel. The epilogue passes the float32 accumulators through shared
// memory (the freed ring); each thread then applies scale, bias, residual
// and ReLU to 8 consecutive channels of one pixel, writes craw, rounds once
// and stores 16 bytes. A conv with fewer K chunks than stages asks for
// only the shared memory its chunks fill. What the design search on the
// card found (PERF.md): more blocks in flight always won, so one block
// takes one output tile; persistent blocks that walk several tiles, with or
// without w kept in shared memory, measured slower.
//
// float32, on the CUDA cores in full float32: 8 x 8 register micro-tiles,
// 128 threads over an output tile of 128 pixels by 64 channels or 64 by
// 128, K chunks of 32 through a ring of the same kind, 3 stages: A rows (4 channels
// of one tap) and B rows by 16-byte cp.async when Cin % 4 == 0 (resp. Cout
// % 4 == 0) and the rows are aligned, else by 4-byte cp.async that
// zero-fill, so both stagings run ahead of the FMAs. A is stored pixel-major with a padded row
// (a warp's four pixel rows hit distinct banks), B k-major; both are read
// as float4s, 16 FMAs per shared load. A conv with fewer K chunks than
// stages asks for only the shared memory its chunks fill.
//
// The launch (route, staging, tiles, ring, grid) is decided by the
// wrapper, mxtpu_torch/ops/pallas/conv.py:_launch_args; the C entry point
// only refuses what would take the kernel out of bounds.

#include "hopper.cuh"

#include <limits.h>

namespace {

// dynamic shared memory a block may have: the H100's 227 KB less the
// largest static row tables (3 KB)
constexpr size_t SMEM_MAX = 232448 - 3072;
constexpr int TC_STAGES = 4;    // ring depth, bfloat16
constexpr int F32_STAGES = 3;   // ring depth, float32
constexpr int NO_ROW = -(1 << 30);   // a pixel past M: every tap falls outside x

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
  int m;                  // N*OH*OW
  int k;                  // KH*KW*Cin
  int chunks;             // K chunks of 64 (bf16) or 32 (f32) in K rounded up to 16
};

// the (image, top row, left column) of each of a block's BM pixels
template <int BM>
__device__ __forceinline__ void row_table(const ConvArgs& a, int m0, int tid, int nt,
                                          int* img, int* ih, int* iw) {
  const int plane = a.oh * a.ow;
  for (int r = tid; r < BM; r += nt) {
    const int m = m0 + r;
    int i = 0, t = NO_ROW, l = 0;
    if (m < a.m) {
      i = m / plane;
      const int rem = m - i * plane;
      const int oy = rem / a.ow;
      t = oy * a.sh - a.ph;
      l = (rem - oy * a.ow) * a.sw - a.pw;
    }
    img[r] = i;
    ih[r] = t;
    iw[r] = l;
  }
}

// k -> (c, dx, dy)
struct Tap {
  int c, dx, dy;
  __device__ __forceinline__ Tap(int k, const ConvArgs& a) {
    const int tap = k / a.cin;
    c = k - tap * a.cin;
    dy = tap / a.kw;
    dx = tap - dy * a.kw;
  }
};

// element offset in x of A's element k (tap t) for the pixel whose window
// starts at (img, ih0, iw0), or -1 when k is past K or the tap lies in the
// padding
__device__ __forceinline__ long long x_at(const ConvArgs& a, int k, const Tap& t, int img,
                                          int ih0, int iw0) {
  const int ih = ih0 + t.dy;
  const int iw = iw0 + t.dx;
  if (k >= a.k || (unsigned)ih >= (unsigned)a.h || (unsigned)iw >= (unsigned)a.wd) return -1;
  return (((long long)img * a.h + ih) * a.wd + iw) * a.cin + t.c;
}

// the optional epilogue terms on v, n <= N consecutive channels of one
// pixel from channel col, at element offset o: the raw conv to craw when
// scale is given, then scale, bias, residual and ReLU, in float32
template <int N>
__device__ __forceinline__ void epilogue_terms(const ConvArgs& a, float (&v)[N], long long o,
                                               int col, int n) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (e >= n) break;   // constant indices keep v in registers
    if (a.scale != nullptr) {
      a.craw[o + e] = v[e];
      v[e] *= a.scale[col + e];
    }
    if (a.bias != nullptr) v[e] += a.bias[col + e];
    if (a.residual != nullptr)
      v[e] += a.res_f32 ? static_cast<const float*>(a.residual)[o + e]
                        : __bfloat162float(static_cast<const __nv_bfloat16*>(a.residual)[o + e]);
    if (a.relu && v[e] < 0.f) v[e] = 0.f;   // NaN passes, as jnp.maximum(v, 0)
  }
}

// ------------------------------------------------------- wgmma instructions

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]; A K-major, B MN-major (the
// transpose flag), both in shared memory; scale_d = 0 clears D first
__device__ __forceinline__ void wgmma_tn(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], as above
__device__ __forceinline__ void wgmma_tn(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------- bfloat16: the tensor cores

constexpr int TC_BK = 64;   // K chunk: 64 bf16, one 128-byte swizzled row

// The bf16 kernel's shared memory, from a 1024-byte aligned base: the ring
// of A [BM][64] and B [64][BN] tiles, as many stages as there are K chunks
// up to TC_STAGES, which the float32 output tile [BM][BN + 8] reuses; plus
// 1 KB of alignment slack.
size_t tc_smem_bytes(int bm, int bn, int chunks) {
  const int stages = chunks < TC_STAGES ? chunks : TC_STAGES;
  const size_t ring = (size_t)stages * (bm + bn) * TC_BK * 2;
  const size_t tile = (size_t)bm * (bn + 8) * 4;
  return 1024 + (ring > tile ? ring : tile);
}

template <int NWG, int BN, bool VA, bool VB>
__global__ void __launch_bounds__(NWG * 128) fused_conv_bf16_kernel(ConvArgs a) {
  constexpr int NT = NWG * 128;
  constexpr int BM = NWG * 64;          // pixels per block, 64 per warpgroup
  constexpr int BK = TC_BK;
  constexpr uint32_t A_BYTES = BM * BK * 2;
  constexpr uint32_t SLOT = A_BYTES + BK * BN * 2;
  constexpr int ROWB = Tile<BN>::ROWB;  // 128: B is stored in 64-column blocks
  constexpr int OS = BN + 8;            // output tile row stride: float2 writes in 2 wavefronts
  extern __shared__ uint8_t smem_raw[];
  __shared__ int r_img[BM], r_ih[BM], r_iw[BM];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s0 = (raw + 1023) & ~1023u;
  float* so = reinterpret_cast<float*>(smem_raw + (s0 - raw));   // the output tile

  const uint16_t* __restrict__ x = static_cast<const uint16_t*>(a.x);
  const uint16_t* __restrict__ w = static_cast<const uint16_t*>(a.w);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  row_table<BM>(a, m0, tid, NT, r_img, r_ih, r_iw);
  __syncthreads();

  // A: BM rows x 64 k of one chunk
  auto stage_a = [&](uint32_t dst, int k0) {
    if constexpr (VA) {   // Cin % 8 == 0: pieces of 8 channels of one tap
      const int j = tid & 7;   // the thread's piece column
      const int k = k0 + 8 * j;
      const Tap t(k, a);
#pragma unroll
      for (int p = 0; p < BM * 8 / NT; ++p) {
        const int r = (tid >> 3) + p * (NT / 8);
        const long long o = x_at(a, k, t, r_img[r], r_ih[r], r_iw[r]);
        cp_async16(dst + Tile<64>::off(r, 8 * j, BM), o >= 0 ? x + o : x, o >= 0 ? 16 : 0);
      }
    } else {
      // one k a thread, so a warp reads 32 consecutive k of one pixel (runs
      // of KW*Cin contiguous elements); all loads first, then the stores
      const int kc = tid & 63;
      const int k = k0 + kc;
      const Tap t(k, a);
      const uint32_t col = dst + (kc & 7) * 2;
      uint16_t v[BM * 64 / NT];
#pragma unroll
      for (int p = 0; p < BM * 64 / NT; ++p) {
        const int r = (tid >> 6) + p * (NT / 64);
        const long long o = x_at(a, k, t, r_img[r], r_ih[r], r_iw[r]);
        v[p] = o >= 0 ? x[o] : (uint16_t)0;
      }
#pragma unroll
      for (int p = 0; p < BM * 64 / NT; ++p) {
        const int r = (tid >> 6) + p * (NT / 64);
        asm volatile("st.shared.u16 [%0], %1;\n"
                     :: "r"(col + Tile<64>::off(r, kc & ~7, BM)), "h"(v[p]) : "memory");
      }
    }
  };
  // B: 64 k rows x BN/8 pieces of 8 columns
  auto stage_b = [&](uint32_t dst, int k0) {
    constexpr int CPR = BN / 8;
#pragma unroll
    for (int p = 0; p < BK * CPR / NT; ++p) {
      const int i = tid + p * NT;
      const int r = i / CPR;
      const int c = (i % CPR) * 8;
      const int kr = k0 + r;
      const int col = n0 + c;
      const uint32_t to = dst + Tile<BN>::off(r, c, BK);
      if constexpr (VB) {   // Cout % 8 == 0: a piece is all in or all out
        const bool ok = kr < a.k && col < a.cout;
        cp_async16(to, ok ? w + (long long)kr * a.cout + col : w, ok ? 16 : 0);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (kr < a.k) {
          const uint16_t* src = w + (long long)kr * a.cout;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e < a.cout) v[e >> 1] |= (uint32_t)src[col + e] << (16 * (e & 1));
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(to), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
      }
    }
  };
  auto stage = [&](int t) {   // K chunk t into ring slot t % TC_STAGES
    const uint32_t slot = s0 + (t % TC_STAGES) * SLOT;
    stage_a(slot, t * BK);
    stage_b(slot + A_BYTES, t * BK);
  };
  for (int t = 0; t < TC_STAGES - 1; ++t) {
    if (t < a.chunks) stage(t);
    cp_async_commit();
  }

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int rr = wg * 64 + warp * 16 + (lane >> 2);   // acc[4j + 2i + c] is pixel row
  const int qc = lane & 3;                            // rr + 8i, column 8j + 2qc + c
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < a.chunks; ++t) {
    cp_async_wait<TC_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();   // chunk t is in for everyone; chunk t-1's slot is free
    if (t + TC_STAGES - 1 < a.chunks) stage(t + TC_STAGES - 1);
    cp_async_commit();
    const uint32_t sa = s0 + (t % TC_STAGES) * SLOT + wg * 64 * 128;
    const uint32_t sb = s0 + (t % TC_STAGES) * SLOT + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A K-major: 8-row groups 1024 bytes apart, k-step 32 bytes along the
      // swizzled row; B MN-major: 8-k groups 1024 apart, 64-column blocks
      // BK * ROWB apart
      wgmma_tn(acc, gmma_desc(sa + kk * 32, 16, 1024, 1),
               gmma_desc(sb + kk * 16 * ROWB, BK * ROWB, 1024, 1), t > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait_all();
  __syncthreads();   // every warpgroup is done with the ring

  // fused epilogue: the float32 accumulators go through shared memory, and
  // each thread then takes 8 consecutive channels of one pixel: the
  // optional terms in float32, one rounding to bf16, one 16-byte store (the
  // terms' code, unrolled over every accumulator, measured 2x slower on the
  // plain conv)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(so + (rr + 8 * i) * OS + 8 * j + 2 * qc) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  __syncthreads();
  const bool plain = a.scale == nullptr && a.bias == nullptr && a.residual == nullptr && !a.relu;
  const bool rows16 = (a.cout & 7) == 0;   // out rows start 16-byte aligned
  uint16_t* out = static_cast<uint16_t*>(a.out);
  constexpr int CPR = BN / 8;
#pragma unroll
  for (int p = 0; p < BM * CPR / NT; ++p) {
    const int i = tid + p * NT;
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const int m = m0 + r;
    const int col = n0 + c;
    if (m >= a.m || col >= a.cout) continue;
    const float4 lo = *reinterpret_cast<const float4*>(so + r * OS + c);
    const float4 hi = *reinterpret_cast<const float4*>(so + r * OS + c + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const long long o = (long long)m * a.cout + col;
    const int n = min(8, a.cout - col);
    if (!plain) epilogue_terms(a, v, o, col, n);
    uint16_t* dst = out + o;
    if (rows16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                  pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n) dst[e] = bf16_bits(v[e]);
    }
  }
}

// ----------------------------------------------------- float32: the CUDA cores

constexpr int F32_BK = 32;   // K chunk

// one stage: A [BM][BK + 4] and B [BK][BN + 4] floats
__host__ __device__ constexpr int f32_stage_floats(int bm, int bn) {
  return bm * (F32_BK + 4) + F32_BK * (bn + 4);
}

// the ring: as many stages as there are K chunks, up to F32_STAGES
size_t f32_smem_bytes(int bm, int bn, int chunks) {
  return sizeof(float) * (size_t)(chunks < F32_STAGES ? chunks : F32_STAGES) *
         f32_stage_floats(bm, bn);
}

template <int BM, int BN, bool VA, bool VB>
__global__ void __launch_bounds__((BM / 8) * (BN / 8)) fused_conv_f32_kernel(ConvArgs a) {
  constexpr int TY = BM / 8;        // a thread's pixels: ty + TY*i, i < 8
  constexpr int TX = BN / 8;        // its columns: 4tx + (BN/2)g + (0..3), g < 2
  constexpr int NT = TY * TX;
  constexpr int BK = F32_BK;
  constexpr int AS = BK + 4;        // A row stride: a warp's pixel rows hit distinct banks
  constexpr int BS = BN + 4;
  constexpr int STAGE_FL = f32_stage_floats(BM, BN);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ int r_img[BM], r_ih[BM], r_iw[BM];

  const float* __restrict__ x = static_cast<const float*>(a.x);
  const float* __restrict__ w = static_cast<const float*>(a.w);
  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  row_table<BM>(a, m0, tid, NT, r_img, r_ih, r_iw);
  __syncthreads();

  auto stage = [&](int slot, int k0) {
    float* As = sm + slot * STAGE_FL;
    float* Bs = As + BM * AS;
    if constexpr (VA) {   // Cin % 4 == 0: pieces of 4 channels of one tap
      const int j = tid & 7;
      const int k = k0 + 4 * j;
      const Tap t(k, a);
#pragma unroll
      for (int p = 0; p < BM * 8 / NT; ++p) {
        const int r = (tid >> 3) + p * (NT / 8);
        const long long o = x_at(a, k, t, r_img[r], r_ih[r], r_iw[r]);
        cp_async16(smem_u32(As + r * AS + 4 * j), o >= 0 ? x + o : x, o >= 0 ? 16 : 0);
      }
    } else {              // one k a thread: a warp reads 32 consecutive k of a pixel
      const int j = tid & 31;
      const int k = k0 + j;
      const Tap t(k, a);
#pragma unroll 4
      for (int p = 0; p < BM * 32 / NT; ++p) {
        const int r = (tid >> 5) + p * (NT / 32);
        const long long o = x_at(a, k, t, r_img[r], r_ih[r], r_iw[r]);
        cp_async4(smem_u32(As + r * AS + j), o >= 0 ? x + o : x, o >= 0 ? 4 : 0);
      }
    }
    if constexpr (VB) {   // Cout % 4 == 0
      constexpr int CPR = BN / 4;
#pragma unroll
      for (int p = 0; p < BK * CPR / NT; ++p) {
        const int i = tid + p * NT;
        const int r = i / CPR;
        const int c = (i % CPR) * 4;
        const bool ok = k0 + r < a.k && n0 + c < a.cout;
        cp_async16(smem_u32(Bs + r * BS + c), ok ? w + (long long)(k0 + r) * a.cout + n0 + c : w,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int p = 0; p < BK * BN / NT; ++p) {
        const int i = tid + p * NT;
        const int r = i / BN;
        const int c = i % BN;
        const bool ok = k0 + r < a.k && n0 + c < a.cout;
        cp_async4(smem_u32(Bs + r * BS + c), ok ? w + (long long)(k0 + r) * a.cout + n0 + c : w,
                  ok ? 4 : 0);
      }
    }
  };

  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < a.chunks) stage(s, s * BK);
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < a.chunks; ++t) {
    cp_async_wait<F32_STAGES - 2>();
    __syncthreads();   // chunk t is in for everyone; chunk t-1's stage is free
    if (t + F32_STAGES - 1 < a.chunks)
      stage((t + F32_STAGES - 1) % F32_STAGES, (t + F32_STAGES - 1) * BK);
    cp_async_commit();
    const float* As = sm + (t % F32_STAGES) * STAGE_FL;
    const float* Bs = As + BM * AS;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(As + (ty + TY * i) * AS + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + (kk + q) * BS + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + (kk + q) * BS + BN / 2 + 4 * tx);
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ar = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar, br[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait_all();

  // fused epilogue in float32; one store per output element, float4 where
  // the rows allow it (out is fresh, so Cout % 4 == 0 suffices)
  float* out = static_cast<float*>(a.out);
  const bool plain = a.scale == nullptr && a.bias == nullptr && a.residual == nullptr && !a.relu;
  const bool quads = (a.cout & 3) == 0;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = n0 + BN / 2 * g + 4 * tx;
    if (col >= a.cout) continue;
    const int n = min(4, a.cout - col);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty + TY * i;
      if (m >= a.m) continue;
      const long long o = (long long)m * a.cout + col;
      float v[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]};
      if (!plain) epilogue_terms(a, v, o, col, n);
      if (quads) {
        *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < n) out[o + e] = v[e];
      }
    }
  }
}

// ------------------------------------------------------------------ launchers

template <int NWG, int BN>
int launch_bf16(const ConvArgs& a, int va, int vb, size_t smem, dim3 grid, cudaStream_t s) {
  constexpr int nt = NWG * 128;
  if (va && vb)
    return launch_kernel<fused_conv_bf16_kernel<NWG, BN, true, true>>(a, grid, nt, smem, s);
  if (va)
    return launch_kernel<fused_conv_bf16_kernel<NWG, BN, true, false>>(a, grid, nt, smem, s);
  if (vb)
    return launch_kernel<fused_conv_bf16_kernel<NWG, BN, false, true>>(a, grid, nt, smem, s);
  return launch_kernel<fused_conv_bf16_kernel<NWG, BN, false, false>>(a, grid, nt, smem, s);
}

template <int BM, int BN>
int launch_f32(const ConvArgs& a, int va, int vb, size_t smem, dim3 grid, cudaStream_t s) {
  constexpr int nt = (BM / 8) * (BN / 8);
  if (va && vb)
    return launch_kernel<fused_conv_f32_kernel<BM, BN, true, true>>(a, grid, nt, smem, s);
  if (va)
    return launch_kernel<fused_conv_f32_kernel<BM, BN, true, false>>(a, grid, nt, smem, s);
  if (vb)
    return launch_kernel<fused_conv_f32_kernel<BM, BN, false, true>>(a, grid, nt, smem, s);
  return launch_kernel<fused_conv_f32_kernel<BM, BN, false, false>>(a, grid, nt, smem, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C entry point for ctypes. The wrapper
// (ops/pallas/conv.py:_launch_args) decides the launch: dtype (0 float32,
// 1 bfloat16), route (0 the CUDA cores, float32 only; 1 the tensor cores,
// bfloat16 only), vec_a / vec_b (1: A, resp. B, staged by 16-byte copies;
// 0: element-wise), block_m (64 or 128 pixels) and block_n (64 or 128
// channels) of the output tile (float32: 128 x 64 or 64 x 128), k_pad (K
// rounded up to 16) and the grid (grid_m x grid_n blocks, one output tile
// each). This function only refuses what would take the kernel out of
// bounds: an unknown dtype, route or tile, a k_pad short of K, 16-byte
// copies from x or w rows that are not 16-byte aligned, more shared memory
// than a block may have, a grid or a size past int range. Then come the
// tensors and the conv's sizes. Launches on `stream` and returns a CUDA
// error code (0 on success); never synchronises.
extern "C" int mxtpu_fused_conv_fwd(int dtype, int route, int vec_a, int vec_b, int block_m,
                                    int block_n, int k_pad,
                                    int grid_m, int grid_n, const void* x, const void* w,
                                    const void* scale, const void* bias, const void* residual,
                                    int res_f32, void* out, void* craw, int n, int h, int wd,
                                    int cin, int kh, int kw, int cout, int sh, int sw, int ph,
                                    int pw, int oh, int ow, int relu, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || kh < 1 || kw < 1 || cout < 1 || sh < 1 ||
      sw < 1 || ph < 0 || pw < 0 || oh < 1 || ow < 1 || route != dtype ||
      (dtype != 0 && dtype != 1) || (block_m != 64 && block_m != 128) ||
      (block_n != 64 && block_n != 128) || grid_m < 1 || grid_n < 1 || grid_n > 65535)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)n * oh * ow;
  const long long k = (long long)kh * kw * cin;
  if (m > INT_MAX - 128 || k > INT_MAX - 64 || k_pad < k || k_pad % 16 != 0 ||
      (scale != nullptr && craw == nullptr))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  if ((vec_a && (!aligned16(x) || (cin * es) % 16 != 0)) ||
      (vec_b && (!aligned16(w) || (cout * es) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
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
  a.m = (int)m;
  a.k = (int)k;
  const dim3 grid((unsigned)grid_m, (unsigned)grid_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    a.chunks = (k_pad + TC_BK - 1) / TC_BK;
    const size_t smem = tc_smem_bytes(block_m, block_n, a.chunks);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (block_m == 64) {
      if (block_n == 64) return launch_bf16<1, 64>(a, vec_a, vec_b, smem, grid, s);
      return launch_bf16<1, 128>(a, vec_a, vec_b, smem, grid, s);
    }
    if (block_n == 64) return launch_bf16<2, 64>(a, vec_a, vec_b, smem, grid, s);
    return launch_bf16<2, 128>(a, vec_a, vec_b, smem, grid, s);
  }
  // float32 has the two tiles of 128 threads: 128 x 64 and 64 x 128
  a.chunks = (k_pad + F32_BK - 1) / F32_BK;
  const size_t smem = f32_smem_bytes(block_m, block_n, a.chunks);
  if (block_m * block_n != 128 * 64 || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (block_n == 64) return launch_f32<128, 64>(a, vec_a, vec_b, smem, grid, s);
  return launch_f32<64, 128>(a, vec_a, vec_b, smem, grid, s);
}
