// Helpers shared by the kernels of this directory: cp.async copies into
// shared memory and the one-time dynamic shared-memory opt-in.
//
// ops/_kernels.py hashes every header here into each library's name, so an
// edit to this file rebuilds every source that may include it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Copy `bytes` (16, or 0 to zero-fill) from global src to shared dst.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
// Copy `bytes` (4, or 0 to zero-fill) from global src to shared dst.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Allow a kernel its dynamic shared memory, once per process (before any
// CUDA-graph capture: the wrappers' first launch).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

// 16-byte copies need every row 16-byte aligned: a row length that is a
// multiple of 4 floats and 16-byte-aligned base pointers.
__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
