// OncePerDevice: a host-side guard for the port's kernel launchers, which
// set a kernel's dynamic shared-memory attribute once per device instead
// of on every launch. Header only (kernels/build.py hashes every .cuh
// beside the sources into each library's digest).
#pragma once

#include <cuda_runtime.h>

#include <atomic>

// Runs set() at a kernel instantiation's first launch on each device and
// not again: the dynamic shared-memory attribute holds for the kernel on
// that device until the process ends. One static of this type in each
// launcher instantiation.
struct OncePerDevice {
  std::atomic<unsigned> done{0};   // bit d: set on device d
  template <typename F>
  cudaError_t operator()(F set) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (bit && (done.load(std::memory_order_acquire) & bit))
      return cudaSuccess;
    err = set();
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return err;
  }
};
