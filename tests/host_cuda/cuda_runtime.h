// A stand-in for the CUDA runtime header, so that a host compiler builds
// csrc/walk_kernel.cu for the tests: the qualifiers defined away, the
// thread indices as globals, the constant copy as memcpy. The kernel's
// launch (`<<<...>>>`) is cut out of the source by the test that uses it.
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
struct host_dim3 {
  unsigned x, y, z;
};
static host_dim3 blockIdx, threadIdx;
struct float4 {
  float x, y, z, w;
};
static inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d};
}
template <class T>
static inline T __ldg(const T* p) {
  return *p;
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMisalignedAddress = 716
};
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
#define cudaMemcpyToSymbolAsync(sym, src, n, off, kind, st) \
  (memcpy(((char*)&(sym)) + (off), (src), (n)), cudaSuccess)
