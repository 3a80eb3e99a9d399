// A stand-in for the CUDA runtime header, so that a host compiler builds
// csrc/walk_kernel.cu for the tests: the qualifiers defined away, the
// constant copy as memcpy, and blocks run by host threads. The kernel's
// launch (`<<<...>>>`) is cut out of the source by the test that uses it,
// which may put host_launch in its place: a std::thread per CUDA thread
// of a block, a block at a time, the thread indices thread-local, __shared__
// variables static (one block runs at a time), and __syncthreads /
// __syncthreads_count a barrier over the block's threads. The dealt
// loop's launches go through cudaLaunchKernel, which runs host_launch with
// the kernel's arguments; the device queries answer one SM that holds one
// block. Warp-level primitives are not emulated.
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __constant__
#define __shared__ static
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
struct host_dim3 {
  unsigned x, y, z;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local host_dim3 blockIdx, threadIdx;
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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
static inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr,
                                                 int) {
  *v = 1;
  return cudaSuccess;
}
template <class K>
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
#define cudaMemcpyToSymbolAsync(sym, src, n, off, kind, st) \
  (memcpy(((char*)&(sym)) + (off), (src), (n)), cudaSuccess)
static inline unsigned int atomicAdd(unsigned int* p, unsigned int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
static inline int __ffsll(long long x) { return __builtin_ffsll(x); }

// the running block's barrier: every thread of the block arrives, then
// all leave together with the count of those that arrived with a true
// predicate. A waiting thread yields a few times, then sleeps until the
// last one arrives (a block's threads outnumber the cores, and a
// lock-and-notify barrier alone costs every thread a wake-up)
struct host_block_barrier {
  int threads = 0, result = 0;
  std::atomic<int> waiting{0}, count{0};
  std::atomic<unsigned long> generation{0};
  std::mutex m;
  std::condition_variable cv;
  int arrive(int pred) {
    const unsigned long gen = generation.load(std::memory_order_acquire);
    if (pred) count.fetch_add(1, std::memory_order_relaxed);
    if (waiting.fetch_add(1, std::memory_order_acq_rel) + 1 == threads) {
      result = count.load(std::memory_order_relaxed);
      count.store(0, std::memory_order_relaxed);
      waiting.store(0, std::memory_order_relaxed);
      {
        std::lock_guard<std::mutex> lock(m);
        generation.store(gen + 1, std::memory_order_release);
      }
      cv.notify_all();
      return result;
    }
    for (int k = 0; k < 64; ++k) {
      if (generation.load(std::memory_order_acquire) != gen) return result;
      std::this_thread::yield();
    }
    std::unique_lock<std::mutex> lock(m);
    cv.wait(lock, [&] {
      return generation.load(std::memory_order_acquire) != gen;
    });
    return result;
  }
};
static host_block_barrier* host_barrier = nullptr;

static inline void __syncthreads() { host_barrier->arrive(0); }
static inline int __syncthreads_count(int pred) {
  return host_barrier->arrive(pred);
}

// runs `body` as `grid` blocks of `block` threads, one block at a time:
// `block` host threads take the blocks in turn, and a block ends at a
// barrier before the next begins
template <class F>
static void host_launch(int grid, int block, F body) {
  host_block_barrier bar;
  bar.threads = block;
  host_barrier = &bar;
  std::vector<std::thread> threads;
  threads.reserve(block);
  for (int t = 0; t < block; ++t)
    threads.emplace_back([&body, &bar, grid, t] {
      threadIdx = host_dim3{(unsigned)t, 0, 0};
      for (int b = 0; b < grid; ++b) {
        blockIdx = host_dim3{(unsigned)b, 0, 0};
        body();
        bar.arrive(0);
      }
    });
  for (auto& th : threads) th.join();
  host_barrier = nullptr;
}

// a kernel's launch by the runtime call: its arguments by its parameter
// types, its blocks by host_launch
template <class... A, size_t... I>
static void host_call(void (*k)(A...), void** args,
                      std::index_sequence<I...>) {
  k(*static_cast<std::remove_reference_t<A>*>(args[I])...);
}
template <class... A>
static cudaError_t cudaLaunchKernel(void (*k)(A...), dim3 grid, dim3 block,
                                    void** args, size_t, cudaStream_t) {
  host_launch((int)grid.x, (int)block.x, [&] {
    host_call(k, args, std::index_sequence_for<A...>{});
  });
  return cudaSuccess;
}
