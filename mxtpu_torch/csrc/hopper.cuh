// Hopper (sm_90a) building blocks shared by the hand-written kernels of
// this directory: 16- and 4-byte cp.async copies, the wgmma fence, commit
// and wait, the shared-memory matrix descriptor, the B128/B64 swizzled tile
// layout the descriptors name, bf16 packing, and the launcher that opts a
// kernel into more than 48 KB of dynamic shared memory. Every source that
// includes this file is compiled into its own shared library
// (mxtpu_torch/kernels.py hashes this header into each build).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// make this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout (1 = B128 swizzle, 2 = B64)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  __nv_bfloat16 h = __float2bfloat16(x);
  return *reinterpret_cast<uint16_t*>(&h);
}

// A [rows, DP] bf16 tile in shared memory as wgmma reads it: blocks of
// HALF columns (all of DP, or 64 for DP = 128), each [rows][HALF] with
// ROWB-byte rows, 16-byte chunks XOR-swizzled by the row (B128: chunk ^
// (row % 8); B64: chunk ^ ((row / 2) % 4)).
template <int DP>
struct Tile {
  static constexpr int HALF = DP < 64 ? DP : 64;
  static constexpr int ROWB = HALF * 2;
  static constexpr int BITS = DP < 64 ? 2 : 3;
  static constexpr uint32_t LAYOUT = DP < 64 ? 2 : 1;
  // byte offset of the 8-column chunk at (r, c) in a tile of R rows
  __device__ static __forceinline__ uint32_t off(int r, int c, int R) {
    const uint32_t o = r * ROWB + (c % HALF) * 2;
    return (c / HALF) * R * ROWB + (o ^ (((o >> 7) & ((1u << BITS) - 1)) << 4));
  }
};

// ------------------------------------------------------------------ launcher

// Launch KERNEL with `smem` bytes of dynamic shared memory. Above 48 KB a
// block's shared memory must be opted into, per device; the opt-in is
// raised whenever a launch asks for more than any before it.
template <auto KERNEL, typename Args>
int launch_kernel(const Args& a, dim3 grid, int threads, size_t smem, cudaStream_t s) {
  static size_t opted[64] = {};   // bytes device i has opted into
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || smem > opted[dev]) {
    e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted[dev] = smem;
  }
  KERNEL<<<grid, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
