// Flash attention forward for Hopper (sm_90a).
//
// Replaces mxtpu/ops/pallas/flash_attention.py:_fa_kernel (launched there by
// _fa_forward_pallas through pl.pallas_call). For q [B, H, T, D] and k, v
// [B, H, Tk, D], all float32 or all bfloat16, any D >= 1, it computes
//
//     s   = (q . k^T) * scale      in float32, -1e30 where causal and q_pos < k_pos
//     out = softmax(s) . v         in the input type, [B, H, T, D] contiguous
//     lse = logsumexp(s)           float32 [B, H, T]
//
// with an online softmax, so the [T, Tk] score matrix never reaches device
// memory: each block keeps the running max m, running sum l and the output
// accumulator of its query rows in registers while it walks the k/v tiles.
// The arithmetic is the TPU kernel's: scores and sums in float32 (no TF32),
// m_new = max(m, rowmax s), p = exp(s - m_new), l = l*alpha + rowsum p,
// acc = acc*alpha + p . v with alpha = exp(m - m_new); in bfloat16 p is
// rounded to bfloat16 before p . v (l sums the unrounded p); finally
// out = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)). Both paths
// keep m in base 2: each score is multiplied by scale*log2(e) and then
// masked, as the TPU kernel masks after scaling (so any scale is right,
// zero and negative ones too), p = exp2(s - m) is one ex2.approx, and
// lse = m * ln 2 + log(max(l, 1e-30)). A key tile that lies wholly above
// the diagonal of the query rows is skipped when causal.
//
// What is a TPU artifact in the Pallas kernel and is not carried over:
// K arrives there pre-transposed [bh, D, Tk] for the MXU, here it is read as
// [Tk, D] rows; lse is lane-replicated over 128 lanes there, here it is
// written once per row; D is zero-padded to 128 there and T must fill 8/128
// granules, here D is zero-filled in shared memory up to the next tile width
// of 32, 64 or 128 and the ragged q and k tails are masked in the kernel, so
// every T runs it. q, k and v are read through their batch, head and row
// strides (the last dim contiguous), so the views that slice q, k and v out
// of one fused [B, T, 3, H, D] projection need no copy.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 on the tensor cores, 67
// TFLOP/s float32 on the CUDA cores, 3.35 TB/s): attention does 4*T*Tk*D
// FLOPs for (3*Tk + T)*D elements moved, T FLOPs per element at T = Tk. At
// the served shapes (T 128 to 512, D 64) that is 64-256 FLOPs per byte in
// bfloat16, below the tensor cores' ridge of 295, so bound by bytes (half of
// that with the causal skip); and 32-128 per byte in float32, above the CUDA
// cores' ridge of 20, so bound by operations. In practice neither bound is
// near at these sizes (a whole call takes 5-250 us): what limits the kernel
// is latency. In bfloat16 each warpgroup runs S, its softmax and P V one
// after the other, registers (128 a thread at D 64) allow four warpgroups per
// SM, and the b8 x 512 grid is 1.45 waves of 128-row blocks; the wgmma
// products alone, without the softmax or the loads, take about as long as
// PyTorch's whole fused call. Overlapping S_t with P_{t-1} V_{t-1} inside
// the warpgroup (FlashAttention-3's pipelining) costs registers and so
// warpgroups per SM; it measured slower (PERF.md).
//
// bfloat16, on the tensor cores: one or two consumer warpgroups per block,
// each owning 64 query rows (two share one k/v ring where the grid fills the
// card twice over with 128-row blocks; the rule is in the wrapper,
// ops/pallas/flash_attention.py:_launch_args). Both products are
// wgmma.mma_async: S = Q K^T as m64n64k16 with Q and the K tile read from
// shared memory K-major (d contiguous; the first k-step clears S), and
// O += P V as m64nDk16 with P taken from registers -- the S accumulator,
// scaled, masked, exponentiated and packed to bf16, is already laid out as
// the A fragment -- and V read MN-major (the transpose flag). Tiles are
// stored in the swizzled layout the descriptors name: B128 for 128-byte
// rows (D 64, and D 128 as two 64-column halves), B64 for D 32, every tile
// 1024-byte aligned. K/V tiles pass through a 2-stage ring in shared memory
// filled by 16-byte cp.async copies that all threads issue for tile j+1
// right after the one barrier of tile j, so the copies overlap tile j's
// products and softmax. Row max and row sum are quad shuffles on the
// accumulator fragment; the row sum is kept per thread and reduced once at
// the end. Views whose rows are not 16-byte aligned (or D not a multiple of
// 8) take the same kernel with an element-by-element staging routine
// (template argument VEC = false) that zero-fills; it does not overlap.
//
// float32, on the CUDA cores in full float32: 128 threads per block of 128
// query rows, each thread an 8 x 8 register block of S (8 rows, 8 keys) and
// 8 rows of O. Q (once) and each K tile are staged d-major by 4-byte
// cp.async copies scattered so that a warp writes 32 banks, V row-major
// (16-byte cp.async, element-wise when rows are unaligned), K and V through
// the same 2-stage ring, so both products read float4s: 4 FMAs per float
// loaded. P goes through one XOR-swizzled shared tile (conflict-free writes
// and reads) with a single barrier between the two products. 137 KB of
// shared memory at D 64 leave one block (4 warps) per SM, which with the
// two barriers a tile is what holds it at about 40% of the CUDA cores' peak.

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;   // the TPU kernel's mask value: never -inf - -inf
constexpr float LN2 = 0.69314718055994531f;
constexpr unsigned FULL = 0xffffffffu;

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
  int slices;                    // 128-column slices of out per (row block, head); > 1 past D 128
  float scale_log2;              // scale * log2(e)
};

// ------------------------------------------------------- wgmma instructions

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory
// (K-major, descriptors da and db); scale_d = 0 clears D first
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] . B[16 x N], A from registers (four bf16x2 per
// thread), B in shared memory, MN-major (the transpose flag, descriptor db)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (DP == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------- bfloat16: the tensor cores

// Stage rows row0 .. row0+R-1 of a [rows, d] bf16 matrix (row stride st)
// into a swizzled tile at shared address dst; rows past nrows and columns
// past d are zero. VEC: 16-byte cp.async (rows 16-byte aligned, d % 8 == 0);
// otherwise element by element, synchronously.
template <int DP, int R, int NT, bool VEC>
__device__ __forceinline__ void stage_bf16(uint32_t dst, const uint16_t* __restrict__ p,
                                           long long st, int row0, int nrows, int d,
                                           int tid) {
  constexpr int CPR = DP / 8;
  static_assert((R * CPR) % NT == 0, "chunks must divide evenly among the threads");
#pragma unroll
  for (int i = tid; i < R * CPR; i += NT) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const int row = row0 + r;
    const uint32_t to = dst + Tile<DP>::off(r, c, R);
    if constexpr (VEC) {
      const bool ok = row < nrows && c < d;
      cp_async16(to, ok ? p + row * st + c : p, ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t lo = 0, hi = 0;
        if (row < nrows) {
          const uint16_t* src = p + row * st + c + 2 * e;
          if (c + 2 * e < d) lo = src[0];
          if (c + 2 * e + 1 < d) hi = src[1];
        }
        w[e] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(to), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]) : "memory");
    }
  }
}

template <int DP, int NWG>
constexpr size_t bf16_smem_bytes() {
  // 1 KB of alignment slack, Q [64*NWG, DP], 2 stages of K and of V [64, DP]
  return 1024 + (size_t)(64 * NWG + 4 * 64) * DP * 2;
}

template <int DP, int NWG, bool VEC>
__global__ void __launch_bounds__(NWG * 128) flash_attention_bf16_kernel(FaArgs a) {
  using TL = Tile<DP>;
  constexpr int NT = NWG * 128;
  constexpr int BQ = NWG * 64;    // query rows per block, 64 per warpgroup
  constexpr int BK = 64;          // keys per tile
  constexpr uint32_t KV_BYTES = BK * DP * 2;
  constexpr uint32_t SBO = 8 * TL::ROWB;   // from one 8-row group to the next
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + BQ * DP * 2;    // stage s at + s * KV_BYTES
  const uint32_t sV = sK + 2 * KV_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int qi = a.n_q - 1 - (int)(blockIdx.x % a.n_q);   // longest causal rows first
  const int bh = blockIdx.x / a.n_q;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int q0 = qi * BQ;
  const uint16_t* __restrict__ q =
      static_cast<const uint16_t*>(a.q) + bi * a.qsb + hi * a.qsh;
  const uint16_t* __restrict__ k =
      static_cast<const uint16_t*>(a.k) + bi * a.ksb + hi * a.ksh;
  const uint16_t* __restrict__ v =
      static_cast<const uint16_t*>(a.v) + bi * a.vsb + hi * a.vsh;

  // causal: a k tile runs when k0 <= the block's last query row
  const int k_end = a.causal ? min(a.tk, q0 + BQ) : a.tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  stage_bf16<DP, BQ, NT, VEC>(sQ, q, a.qst, q0, a.t, a.d, tid);
  stage_bf16<DP, BK, NT, VEC>(sK, k, a.kst, 0, a.tk, a.d, tid);
  stage_bf16<DP, BK, NT, VEC>(sV, v, a.vst, 0, a.tk, a.d, tid);
  cp_async_commit();

  const int wq0 = q0 + wg * 64;              // this warpgroup's first query row
  const int r0 = warp * 16 + (lane >> 2);    // its thread's rows: r0 and r0 + 8
  const int qc = lane & 3;                   // and columns 8j + 2qc, 8j + 2qc + 1
  float o[DP / 2], s[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};                   // this thread's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // tile t is in for everyone; tile t-1's stage is free
    if (t + 1 < n_tiles) {
      const uint32_t so = ((t + 1) & 1) * KV_BYTES;
      stage_bf16<DP, BK, NT, VEC>(sK + so, k, a.kst, (t + 1) * BK, a.tk, a.d, tid);
      stage_bf16<DP, BK, NT, VEC>(sV + so, v, a.vst, (t + 1) * BK, a.tk, a.d, tid);
      cp_async_commit();
    }
    const int k0 = t * BK;
    // warpgroup-uniform: rows past T, or a tile above this warpgroup's diagonal
    if (wq0 >= a.t || (a.causal && k0 > wq0 + 63)) continue;
    const uint32_t kt = sK + (t & 1) * KV_BYTES;
    const uint32_t vt = sV + (t & 1) * KV_BYTES;

    // S = Q K^T, K-major operands, DP/16 k-steps
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk * 16;
      const uint32_t qa = sQ + (c / TL::HALF) * BQ * TL::ROWB + wg * 64 * TL::ROWB +
                          (c % TL::HALF) * 2;
      const uint32_t kb = kt + (c / TL::HALF) * BK * TL::ROWB + (c % TL::HALF) * 2;
      wgmma_ss_n64(s, gmma_desc(qa, 16, SBO, TL::LAYOUT), gmma_desc(kb, 16, SBO, TL::LAYOUT),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s[4j + 2i + c] is row r0 + 8i, key k0 + 8j + 2qc + c
    const bool mask = k0 + BK > a.tk || (a.causal && k0 + BK - 1 > wq0);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wq0 + r0 + 8 * i;
      float mc[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * a.scale_log2;
          if (mask) {
            // a key past Tk gets the mask value too: key 0 is in every row's
            // first tile, so m is a real score before any masked p is formed
            // and exp2(-1e30 - m) is exactly 0
            const int key = k0 + 8 * j + 2 * qc + c;
            if (key >= a.tk || (a.causal && key > row)) x = NEG;
          }
          s[4 * j + 2 * i + c] = x;
          mc[c] = fmaxf(mc[c], x);
        }
      }
      float mx = fmaxf(mc[0], mc[1]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = ex2(m[i] - m_new);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = ex2(s[4 * j + 2 * i + c] - m_new);
          rs[c] += p;
          s[4 * j + 2 * i + c] = p;
        }
      }
      l[i] = l[i] * alpha[i] + (rs[0] + rs[1]);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
    }

    // O += P V: the S fragment of keys 16kk .. 16kk+15 is the A fragment
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      fence_regs(pf[kk]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // V MN-major: 8-key groups SBO apart, 64-column halves BK*ROWB apart
      wgmma_pv<DP>(o, pf[kk], gmma_desc(vt + kk * 16 * TL::ROWB, BK * TL::ROWB, SBO,
                                        TL::LAYOUT));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  uint16_t* out = static_cast<uint16_t*>(a.out) + (size_t)bh * a.t * a.d;
  const bool pairs = (a.d & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i] + __shfl_xor_sync(FULL, l[i], 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const float den = fmaxf(lt, 1e-30f);
    const int row = wq0 + r0 + 8 * i;
    if (row >= a.t) continue;
    uint16_t* orow = out + (size_t)row * a.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * qc;
      const float x0 = o[4 * j + 2 * i] / den;
      const float x1 = o[4 * j + 2 * i + 1] / den;
      if (pairs && col + 1 < a.d) {
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(x0, x1);
      } else {
        if (col < a.d) orow[col] = bf16_bits(x0);
        if (col + 1 < a.d) orow[col + 1] = bf16_bits(x1);
      }
    }
    if (qc == 0) a.lse[(size_t)bh * a.t + row] = m[i] * LN2 + logf(den);
  }
}

// ----------------------------------------------------- float32: the CUDA cores

constexpr int F32_BQ = 128;       // query rows per block
constexpr int F32_THREADS = 128;  // 16 row groups x 8 key/column groups

template <int DP, int BK>
constexpr size_t f32_smem_bytes() {
  // Q^T [DP][BQ + 8], 2 stages of K^T [DP][BK + 8] and V [BK][DP], P^T [BK][BQ]
  return sizeof(float) *
         (size_t)(DP * (F32_BQ + 8) + 2 * DP * (BK + 8) + 2 * BK * DP + BK * F32_BQ);
}

// the 4-row group g of P^T's row `key`, XOR-swizzled so that the eight
// threads that store one key's rows, and the reads of one key, hit distinct banks
__device__ __forceinline__ int p_col(int key, int g) { return ((g ^ ((key >> 2) & 7)) << 2); }

// Stage rows row0 .. row0+R-1 of a [rows, d] float32 matrix (row stride st)
// transposed into dst [DP][S], zero past nrows and d: each warp copies blocks
// of 8 rows x 4 dims, 4 bytes a thread (S = 8 mod 32: the warp hits 32 banks)
template <int DP, int R, int S, int NT>
__device__ __forceinline__ void stage_f32_t(float* dst, const float* __restrict__ src,
                                            long long st, int row0, int nrows, int d,
                                            int warp, int lane) {
#pragma unroll 4
  for (int b = warp; b < R * DP / 32; b += NT / 32) {
    const int r = (b % (R / 8)) * 8 + (lane & 7);
    const int c = (b / (R / 8)) * 4 + (lane >> 3);
    const bool ok = row0 + r < nrows && c < d;
    cp_async4(smem_u32(dst + c * S + r), ok ? src + (row0 + r) * st + c : src, ok ? 4 : 0);
  }
}

template <int DP, int BK, bool VEC>
__global__ void __launch_bounds__(F32_THREADS) flash_attention_f32_kernel(FaArgs a) {
  constexpr int BQ = F32_BQ;
  constexpr int NT = F32_THREADS;
  constexpr int KG = BK / 32;     // float4 key groups per thread
  constexpr int CG = DP / 32;     // float4 column groups per thread
  constexpr int KN = 4 * KG;
  constexpr int CN = 4 * CG;
  constexpr int QS = BQ + 8;      // row strides of Q^T and K^T (see stage_f32_t)
  constexpr int KS = BK + 8;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [DP][QS]
  float* Kt = Qt + DP * QS;                      // [2][DP][KS]
  float* Vs = Kt + 2 * DP * KS;                  // [2][BK][DP]
  float* Pt = Vs + 2 * BK * DP;                  // [BK][BQ], swizzled by p_col

  const int tid = threadIdx.x;
  const int ty = tid >> 3;        // rows 4ty .. 4ty+3 and 64+4ty .. 64+4ty+3
  const int tx = tid & 7;         // keys (columns) 4tx + 32g .. 4tx + 32g + 3
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qi = a.n_q - 1 - (int)(blockIdx.x % a.n_q);
  const int bh = blockIdx.x / a.n_q;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int q0 = qi * BQ;
  const float* __restrict__ q = static_cast<const float*>(a.q) + bi * a.qsb + hi * a.qsh;
  const float* __restrict__ k = static_cast<const float*>(a.k) + bi * a.ksb + hi * a.ksh;
  const float* __restrict__ v = static_cast<const float*>(a.v) + bi * a.vsb + hi * a.vsh;

  const int k_end = a.causal ? min(a.tk, q0 + BQ) : a.tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  auto stage_k = [&](int stage, int k0) {
    stage_f32_t<DP, BK, KS, NT>(Kt + stage * DP * KS, k, a.kst, k0, a.tk, a.d, warp, lane);
  };
  auto stage_v = [&](int stage, int k0) {
    float* dst = Vs + stage * BK * DP;
    if constexpr (VEC) {
#pragma unroll
      for (int i = tid; i < BK * DP / 4; i += NT) {
        const int r = i / (DP / 4);
        const int c = (i % (DP / 4)) * 4;
        const bool ok = k0 + r < a.tk && c < a.d;
        cp_async16(smem_u32(dst + r * DP + c), ok ? v + (k0 + r) * a.vst + c : v, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < BK * DP; i += NT) {
        const int r = i / DP;
        const int c = i % DP;
        const bool ok = k0 + r < a.tk && c < a.d;
        cp_async4(smem_u32(dst + i), ok ? v + (k0 + r) * a.vst + c : v, ok ? 4 : 0);
      }
    }
  };

  stage_f32_t<DP, BQ, QS, NT>(Qt, q, a.qst, q0, a.t, a.d, warp, lane);
  stage_k(0, 0);
  stage_v(0, 0);
  cp_async_commit();

  float acc[8][CN];
  float m[8], l[8];               // l: this thread's share of the row sums
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t is in for everyone; tile t-1's stage and P^T are free
    if (t + 1 < n_tiles) {
      stage_k((t + 1) & 1, (t + 1) * BK);
      stage_v((t + 1) & 1, (t + 1) * BK);
      cp_async_commit();
    }
    const int k0 = t * BK;
    const float* kt = Kt + (t & 1) * DP * KS;
    const float* vt = Vs + (t & 1) * BK * DP;

    float s[8][KN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + c * QS + 4 * ty);
      const float4 qb = *reinterpret_cast<const float4*>(Qt + c * QS + 64 + 4 * ty);
      const float qr[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float kr[KN];
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const float4 kb = *reinterpret_cast<const float4*>(kt + c * KS + 32 * g + 4 * tx);
        kr[4 * g] = kb.x;
        kr[4 * g + 1] = kb.y;
        kr[4 * g + 2] = kb.z;
        kr[4 * g + 3] = kb.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    const bool mask = k0 + BK > a.tk || (a.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      float mc[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        float x = s[i][j] * a.scale_log2;
        if (mask) {
          const int key = k0 + 32 * (j >> 2) + 4 * tx + (j & 3);
          if (key >= a.tk || (a.causal && key > row)) x = NEG;
        }
        s[i][j] = x;
        mc[j & 1] = fmaxf(mc[j & 1], x);
      }
      float mx = fmaxf(mc[0], mc[1]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - m_new);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        s[i][j] = ex2(s[i][j] - m_new);
        rs[j & 1] += s[i][j];
      }
      l[i] = l[i] * alpha + (rs[0] + rs[1]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      const int key = 32 * (j >> 2) + 4 * tx + (j & 3);
      *reinterpret_cast<float4*>(Pt + key * BQ + p_col(key, ty)) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(Pt + key * BQ + p_col(key, 16 + ty)) =
          make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + kk * BQ + p_col(kk, ty));
      const float4 pb = *reinterpret_cast<const float4*>(Pt + kk * BQ + p_col(kk, 16 + ty));
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vr[CN];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 vb = *reinterpret_cast<const float4*>(vt + kk * DP + 32 * g + 4 * tx);
        vr[4 * g] = vb.x;
        vr[4 * g + 1] = vb.y;
        vr[4 * g + 2] = vb.z;
        vr[4 * g + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
    }
  }

  float* out = static_cast<float*>(a.out) + (size_t)bh * a.t * a.d;
  const bool quads = (a.d & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) lt += __shfl_xor_sync(FULL, lt, off);
    const float den = fmaxf(lt, 1e-30f);
    const int row = q0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= a.t) continue;
    float* orow = out + (size_t)row * a.d;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int col = 32 * g + 4 * tx;
      const float4 x = make_float4(acc[i][4 * g] / den, acc[i][4 * g + 1] / den,
                                   acc[i][4 * g + 2] / den, acc[i][4 * g + 3] / den);
      if (quads && col < a.d) {
        *reinterpret_cast<float4*>(orow + col) = x;
      } else {
        if (col < a.d) orow[col] = x.x;
        if (col + 1 < a.d) orow[col + 1] = x.y;
        if (col + 2 < a.d) orow[col + 2] = x.z;
        if (col + 3 < a.d) orow[col + 3] = x.w;
      }
    }
    if (tx == 0) a.lse[(size_t)bh * a.t + row] = m[i] * LN2 + logf(den);
  }
}

// ------------------------------------------------ head dims past 128: slices
//
// For D > 128 each block owns one 128-column slice of out (grid dimension
// `slices`, the fastest-varying one, so the slices of a row block run side
// by side and share Q and K through L2). It computes all of S = Q K^T,
// walking D in 64-column chunks, then P V and out for its own slice only;
// slice 0 writes lse. S is recomputed once per slice (D 256: 1.5x the
// FLOPs of one pass). Every staged piece -- a chunk of the Q rows and of
// the K tile, or the V tile's slice -- is one item of a ring of
// STAGES slots: the copies of the next STAGES - 1 items are in flight while
// item i is used (item i+STAGES-1's are issued right after item i's
// barrier), so shared memory does not grow with D and every D runs.

constexpr int WIDE_DV = 128;   // columns of out per slice

// bfloat16: one warpgroup of 64 query rows, 64-key tiles; a ring slot is a
// Q chunk and a K chunk (8 KB each, B128 swizzle) or the V tile's slice
// (16 KB, two 64-column halves). 128-column chunks and rings of 3 or 4
// slots measured slower over D 160, 256 and 320 (variant_search.py,
// PERF.md).
constexpr int WIDE_BF16_DC = 64;
constexpr uint32_t WIDE_BF16_SLOT = 16384;
constexpr int WIDE_BF16_STAGES = 2;

template <bool VEC>
__global__ void __launch_bounds__(128) flash_attention_bf16_wide_kernel(FaArgs a) {
  using TV = Tile<WIDE_DV>;
  constexpr int BQ = 64;
  constexpr int BK = 64;
  constexpr uint32_t SBO = 1024;   // 8 rows of 128 bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sl = (int)(blockIdx.x % a.slices);
  const int rest = (int)(blockIdx.x / a.slices);
  const int qi = a.n_q - 1 - rest % a.n_q;   // longest causal rows first
  const int bh = rest / a.n_q;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int q0 = qi * BQ;
  const int c0 = sl * WIDE_DV;               // this block's first column of out
  const uint16_t* __restrict__ q =
      static_cast<const uint16_t*>(a.q) + bi * a.qsb + hi * a.qsh;
  const uint16_t* __restrict__ k =
      static_cast<const uint16_t*>(a.k) + bi * a.ksb + hi * a.ksh;
  const uint16_t* __restrict__ v =
      static_cast<const uint16_t*>(a.v) + bi * a.vsb + hi * a.vsh;

  const int k_end = a.causal ? min(a.tk, q0 + BQ) : a.tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int nc = (a.d + WIDE_BF16_DC - 1) / WIDE_BF16_DC;
  const int ni = nc + 1;                     // items per k tile: nc chunks, then V
  const int n_items = n_tiles * ni;

  // one commit group per item, an empty one past the last, so that
  // waiting for all but the newest STAGES - 2 groups means item i is in
  auto issue = [&](int i) {
    if (i >= n_items) {
      cp_async_commit();
      return;
    }
    const int t = i / ni;
    const int c = i - t * ni;
    const uint32_t slot = ring + (i % WIDE_BF16_STAGES) * WIDE_BF16_SLOT;
    if (c < nc) {
      const int cc = c * WIDE_BF16_DC;
      stage_bf16<WIDE_BF16_DC, BQ, 128, VEC>(slot, q + cc, a.qst, q0, a.t, a.d - cc, tid);
      stage_bf16<WIDE_BF16_DC, BK, 128, VEC>(slot + WIDE_BF16_SLOT / 2, k + cc, a.kst,
                                             t * BK, a.tk, a.d - cc, tid);
    } else {
      stage_bf16<WIDE_DV, BK, 128, VEC>(slot, v + c0, a.vst, t * BK, a.tk, a.d - c0, tid);
    }
    cp_async_commit();
  };

  const int r0 = warp * 16 + (lane >> 2);    // this thread's rows: r0 and r0 + 8
  const int qc = lane & 3;                   // and columns 8j + 2qc, 8j + 2qc + 1
  float o[WIDE_DV / 2], s[32];
#pragma unroll
  for (int i = 0; i < WIDE_DV / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};

  for (int i = 0; i < WIDE_BF16_STAGES - 1; ++i) issue(i);
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<WIDE_BF16_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();   // item i is in for everyone; item i-1's slot is free
    issue(i + WIDE_BF16_STAGES - 1);
    const int t = i / ni;
    const int c = i - t * ni;
    const uint32_t slot = ring + (i % WIDE_BF16_STAGES) * WIDE_BF16_SLOT;
    if (c < nc) {
      // S (+)= Q_c K_c^T, 16 columns a k-step (a chunk of 128 columns
      // would be two 64-column halves, 64 rows of 128 bytes apart); the
      // first clears S
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WIDE_BF16_DC / 16; ++kk) {
        const uint32_t off = (kk / 4) * 64 * TV::ROWB + (kk % 4) * 32;
        wgmma_ss_n64(s, gmma_desc(slot + off, 16, SBO, 1),
                     gmma_desc(slot + WIDE_BF16_SLOT / 2 + off, 16, SBO, 1),
                     c > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      continue;
    }
    const int k0 = t * BK;
    const bool mask = k0 + BK > a.tk || (a.causal && k0 + BK - 1 > q0);
    float alpha[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = q0 + r0 + 8 * h2;
      float mc[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * h2 + e] * a.scale_log2;
          if (mask) {
            const int key = k0 + 8 * j + 2 * qc + e;
            if (key >= a.tk || (a.causal && key > row)) x = NEG;
          }
          s[4 * j + 2 * h2 + e] = x;
          mc[e] = fmaxf(mc[e], x);
        }
      }
      float mx = fmaxf(mc[0], mc[1]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[h2], mx);
      alpha[h2] = ex2(m[h2] - m_new);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(s[4 * j + 2 * h2 + e] - m_new);
          rs[e] += p;
          s[4 * j + 2 * h2 + e] = p;
        }
      }
      l[h2] = l[h2] * alpha[h2] + (rs[0] + rs[1]);
      m[h2] = m_new;
    }
#pragma unroll
    for (int j = 0; j < WIDE_DV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
    }
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      fence_regs(pf[kk]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<WIDE_DV>(o, pf[kk], gmma_desc(slot + kk * 16 * TV::ROWB, BK * TV::ROWB, SBO,
                                             TV::LAYOUT));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  uint16_t* out = static_cast<uint16_t*>(a.out) + (size_t)bh * a.t * a.d;
  const bool pairs = (a.d & 1) == 0;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lt = l[h2] + __shfl_xor_sync(FULL, l[h2], 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const float den = fmaxf(lt, 1e-30f);
    const int row = q0 + r0 + 8 * h2;
    if (row >= a.t) continue;
    uint16_t* orow = out + (size_t)row * a.d;
#pragma unroll
    for (int j = 0; j < WIDE_DV / 8; ++j) {
      const int col = c0 + 8 * j + 2 * qc;
      const float x0 = o[4 * j + 2 * h2] / den;
      const float x1 = o[4 * j + 2 * h2 + 1] / den;
      if (pairs && col + 1 < a.d) {
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(x0, x1);
      } else {
        if (col < a.d) orow[col] = bf16_bits(x0);
        if (col + 1 < a.d) orow[col + 1] = bf16_bits(x1);
      }
    }
    if (sl == 0 && qc == 0) a.lse[(size_t)bh * a.t + row] = m[h2] * LN2 + logf(den);
  }
}

// float32: the 8 x 8 register blocks of flash_attention_f32_kernel over
// 128 query rows and 32-key tiles; a ring slot is Q^T's and K^T's chunk
// [64][BQ + 8] and [64][BK + 8], or the V tile's slice [BK][128]
constexpr int WIDE_DC = 64;
constexpr int WIDE_F32_BK = 32;
constexpr int WIDE_F32_SLOT =   // floats
    WIDE_DC * (F32_BQ + 8) + WIDE_DC * (WIDE_F32_BK + 8);

constexpr size_t wide_f32_smem_bytes() {
  return sizeof(float) * (size_t)(2 * WIDE_F32_SLOT + WIDE_F32_BK * F32_BQ);
}

template <bool VEC>
__global__ void __launch_bounds__(F32_THREADS) flash_attention_f32_wide_kernel(FaArgs a) {
  constexpr int BQ = F32_BQ;
  constexpr int NT = F32_THREADS;
  constexpr int BK = WIDE_F32_BK;
  constexpr int DV = WIDE_DV;
  constexpr int KN = BK / 8;      // keys per thread (4tx .. 4tx+3)
  constexpr int CG = DV / 32;     // float4 column groups per thread
  constexpr int CN = 4 * CG;
  constexpr int QS = BQ + 8;
  constexpr int KS = BK + 8;
  static_assert(KN == 4, "one float4 of keys per thread");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* Pt = ring + 2 * WIDE_F32_SLOT;           // [BK][BQ], swizzled by p_col

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sl = (int)(blockIdx.x % a.slices);
  const int rest = (int)(blockIdx.x / a.slices);
  const int qi = a.n_q - 1 - rest % a.n_q;
  const int bh = rest / a.n_q;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int q0 = qi * BQ;
  const int c0 = sl * DV;
  const float* __restrict__ q = static_cast<const float*>(a.q) + bi * a.qsb + hi * a.qsh;
  const float* __restrict__ k = static_cast<const float*>(a.k) + bi * a.ksb + hi * a.ksh;
  const float* __restrict__ v = static_cast<const float*>(a.v) + bi * a.vsb + hi * a.vsh;

  const int k_end = a.causal ? min(a.tk, q0 + BQ) : a.tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int nc = (a.d + WIDE_DC - 1) / WIDE_DC;
  const int ni = nc + 1;
  const int n_items = n_tiles * ni;
  const int dv = a.d - c0;                        // columns of V left from c0

  auto issue = [&](int i) {
    const int t = i / ni;
    const int c = i - t * ni;
    float* slot = ring + (i & 1) * WIDE_F32_SLOT;
    if (c < nc) {
      const int cc = c * WIDE_DC;
      stage_f32_t<WIDE_DC, BQ, QS, NT>(slot, q + cc, a.qst, q0, a.t, a.d - cc, warp, lane);
      stage_f32_t<WIDE_DC, BK, KS, NT>(slot + WIDE_DC * QS, k + cc, a.kst, t * BK, a.tk,
                                       a.d - cc, warp, lane);
    } else if constexpr (VEC) {
      const int k0 = t * BK;
#pragma unroll
      for (int e = tid; e < BK * DV / 4; e += NT) {
        const int r = e / (DV / 4);
        const int cv = (e % (DV / 4)) * 4;
        const bool ok = k0 + r < a.tk && cv < dv;
        cp_async16(smem_u32(slot + r * DV + cv), ok ? v + (k0 + r) * a.vst + c0 + cv : v,
                   ok ? 16 : 0);
      }
    } else {
      const int k0 = t * BK;
#pragma unroll 4
      for (int e = tid; e < BK * DV; e += NT) {
        const int r = e / DV;
        const int cv = e % DV;
        const bool ok = k0 + r < a.tk && cv < dv;
        cp_async4(smem_u32(slot + e), ok ? v + (k0 + r) * a.vst + c0 + cv : v, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[8][CN];
  float s[8][KN];
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
  }

  issue(0);
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait_all();
    __syncthreads();   // item i is in for everyone; item i-1's slot and P^T are free
    if (i + 1 < n_items) issue(i + 1);
    const int t = i / ni;
    const int c = i - t * ni;
    const float* slot = ring + (i & 1) * WIDE_F32_SLOT;
    if (c < nc) {
      if (c == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < KN; ++j) s[r][j] = 0.f;
      }
      const float* Qt = slot;
      const float* Kt = slot + WIDE_DC * QS;
#pragma unroll 4
      for (int cc = 0; cc < WIDE_DC; ++cc) {
        const float4 qa = *reinterpret_cast<const float4*>(Qt + cc * QS + 4 * ty);
        const float4 qb = *reinterpret_cast<const float4*>(Qt + cc * QS + 64 + 4 * ty);
        const float qr[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float4 kb = *reinterpret_cast<const float4*>(Kt + cc * KS + 4 * tx);
        const float kr[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < KN; ++j) s[r][j] = fmaf(qr[r], kr[j], s[r][j]);
      }
      continue;
    }
    const int k0 = t * BK;
    const bool mask = k0 + BK > a.tk || (a.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
      float mc[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        float x = s[r][j] * a.scale_log2;
        if (mask) {
          const int key = k0 + 4 * tx + j;
          if (key >= a.tk || (a.causal && key > row)) x = NEG;
        }
        s[r][j] = x;
        mc[j & 1] = fmaxf(mc[j & 1], x);
      }
      float mx = fmaxf(mc[0], mc[1]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = ex2(m[r] - m_new);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        s[r][j] = ex2(s[r][j] - m_new);
        rs[j & 1] += s[r][j];
      }
      l[r] = l[r] * alpha + (rs[0] + rs[1]);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[r][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      const int key = 4 * tx + j;
      *reinterpret_cast<float4*>(Pt + key * BQ + p_col(key, ty)) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(Pt + key * BQ + p_col(key, 16 + ty)) =
          make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();
    const float* vt = slot;                      // [BK][DV]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + kk * BQ + p_col(kk, ty));
      const float4 pb = *reinterpret_cast<const float4*>(Pt + kk * BQ + p_col(kk, 16 + ty));
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vr[CN];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 vb = *reinterpret_cast<const float4*>(vt + kk * DV + 32 * g + 4 * tx);
        vr[4 * g] = vb.x;
        vr[4 * g + 1] = vb.y;
        vr[4 * g + 2] = vb.z;
        vr[4 * g + 3] = vb.w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[r][j] = fmaf(pr[r], vr[j], acc[r][j]);
    }
  }

  float* out = static_cast<float*>(a.out) + (size_t)bh * a.t * a.d;
  const bool quads = (a.d & 3) == 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) lt += __shfl_xor_sync(FULL, lt, off);
    const float den = fmaxf(lt, 1e-30f);
    const int row = q0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
    if (row >= a.t) continue;
    float* orow = out + (size_t)row * a.d;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int col = c0 + 32 * g + 4 * tx;
      const float4 x = make_float4(acc[r][4 * g] / den, acc[r][4 * g + 1] / den,
                                   acc[r][4 * g + 2] / den, acc[r][4 * g + 3] / den);
      if (quads && col < a.d) {
        *reinterpret_cast<float4*>(orow + col) = x;
      } else {
        if (col < a.d) orow[col] = x.x;
        if (col + 1 < a.d) orow[col + 1] = x.y;
        if (col + 2 < a.d) orow[col + 2] = x.z;
        if (col + 3 < a.d) orow[col + 3] = x.w;
      }
    }
    if (sl == 0 && tx == 0) a.lse[(size_t)bh * a.t + row] = m[r] * LN2 + logf(den);
  }
}

// ------------------------------------------------------------------ launchers

template <int DP, int NWG>
int launch_bf16(const FaArgs& a, bool vec, unsigned blocks, cudaStream_t s) {
  constexpr size_t smem = bf16_smem_bytes<DP, NWG>();
  if (vec) return launch_kernel<flash_attention_bf16_kernel<DP, NWG, true>>(a, blocks, NWG * 128, smem, s);
  return launch_kernel<flash_attention_bf16_kernel<DP, NWG, false>>(a, blocks, NWG * 128, smem, s);
}

template <int DP>
int launch_bf16_wg(const FaArgs& a, bool vec, int wgs, unsigned blocks, cudaStream_t s) {
  if (wgs == 2) return launch_bf16<DP, 2>(a, vec, blocks, s);
  return launch_bf16<DP, 1>(a, vec, blocks, s);
}

template <int DP, int BK>
int launch_f32(const FaArgs& a, bool vec, unsigned blocks, cudaStream_t s) {
  constexpr size_t smem = f32_smem_bytes<DP, BK>();
  if (vec) return launch_kernel<flash_attention_f32_kernel<DP, BK, true>>(a, blocks, F32_THREADS, smem, s);
  return launch_kernel<flash_attention_f32_kernel<DP, BK, false>>(a, blocks, F32_THREADS, smem, s);
}

int launch_wide(const FaArgs& a, int dtype, bool vec, unsigned blocks, cudaStream_t s) {
  if (dtype == 0) {
    constexpr size_t smem = wide_f32_smem_bytes();
    if (vec) return launch_kernel<flash_attention_f32_wide_kernel<true>>(a, blocks, F32_THREADS, smem, s);
    return launch_kernel<flash_attention_f32_wide_kernel<false>>(a, blocks, F32_THREADS, smem, s);
  }
  constexpr size_t smem = 1024 + WIDE_BF16_STAGES * WIDE_BF16_SLOT;
  if (vec) return launch_kernel<flash_attention_bf16_wide_kernel<true>>(a, blocks, 128, smem, s);
  return launch_kernel<flash_attention_bf16_wide_kernel<false>>(a, blocks, 128, smem, s);
}

// the precondition of the 16-byte copies (VEC): the base address and the
// byte stride of every dim of more than one element are multiples of 16 (a
// dim of one element never advances its stride); the same rule as the
// wrapper's _aligned16, which chooses VEC
bool aligned16(const void* p, const long long (&st)[3], const int (&n)[3], int es) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && (st[i] * es) % 16 != 0) return false;
  return true;
}

}  // namespace

// Plain C entry point for ctypes. The wrapper
// (ops/pallas/flash_attention.py:_launch_args) decides the launch: dtype (0
// float32, 1 bfloat16), d_tile (32, 64 or 128, the tile width of out, so
// d <= d_tile * slices), vec (1: the 16-byte async-copy staging; 0:
// element-wise), wgs (the bfloat16 kernel's warpgroups per block, 1 or 2;
// float32 and the sliced kernels take 1), n_q (row blocks per (batch,
// head)) and slices (128-column slices of out per row block: 1 up to D 128,
// more for the sliced kernels). This function only refuses what would take
// a kernel out of bounds: an unknown dtype or tile, d past the slices, a
// warpgroup count with no instance, 16-byte copies from unaligned rows, a
// grid too large. Then come the element strides of q's, k's and v's batch,
// head and row (the last dim contiguous), b, h, t, tk, d and causal.
// Launches on `stream` and returns a CUDA error code (0 on success); never
// synchronises.
extern "C" int mxtpu_flash_attention_fwd(int dtype, int d_tile, int vec, int wgs, int n_q,
                                         int slices, const void* q, const void* k,
                                         const void* v, void* out, void* lse, long long qsb,
                                         long long qsh, long long qst, long long ksb,
                                         long long ksh, long long kst, long long vsb,
                                         long long vsh, long long vst, int b, int h, int t,
                                         int tk, int d, int causal, float scale, void* stream) {
  if (b < 1 || h < 1 || t < 1 || tk < 1 || d < 1 || n_q < 1 || slices < 1 ||
      (long long)d > (long long)d_tile * slices ||
      (d_tile != 32 && d_tile != 64 && d_tile != 128) || (dtype != 0 && dtype != 1) ||
      (slices > 1 && (d_tile != WIDE_DV || wgs != 1)) ||
      (wgs != 1 && (dtype == 0 || wgs != 2)))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  if (vec && ((d * es) % 16 != 0 || !aligned16(q, {qsb, qsh, qst}, {b, h, t}, es) ||
              !aligned16(k, {ksb, ksh, kst}, {b, h, tk}, es) ||
              !aligned16(v, {vsb, vsh, vst}, {b, h, tk}, es)))
    return (int)cudaErrorInvalidValue;
  FaArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse = static_cast<float*>(lse);
  a.qsb = qsb; a.qsh = qsh; a.qst = qst;
  a.ksb = ksb; a.ksh = ksh; a.kst = kst;
  a.vsb = vsb; a.vsh = vsh; a.vst = vst;
  a.h = h; a.t = t; a.tk = tk; a.d = d; a.causal = causal; a.n_q = n_q;
  a.slices = slices;
  a.scale_log2 = (float)((double)scale * 1.4426950408889634);
  const long long blocks = (long long)n_q * b * h * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
  if (slices > 1) return launch_wide(a, dtype, vec, nb, s);
  if (dtype == 0) {
    if (d_tile == 32) return launch_f32<32, 64>(a, vec, nb, s);
    if (d_tile == 64) return launch_f32<64, 64>(a, vec, nb, s);
    return launch_f32<128, 32>(a, vec, nb, s);
  }
  if (d_tile == 32) return launch_bf16_wg<32>(a, vec, wgs, nb, s);
  if (d_tile == 64) return launch_bf16_wg<64>(a, vec, wgs, nb, s);
  return launch_bf16_wg<128>(a, vec, wgs, nb, s);
}
