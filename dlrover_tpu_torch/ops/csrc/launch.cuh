// Host side of the ctypes entry points in rmsnorm.cu, cross_entropy.cu and
// quant.cu; the Python side is dlrover_tpu_torch/ops/_launch.py.
//
// The wrappers call an entry point with plain Python ints and no ctypes
// argtypes, and ctypes passes such an int as a 32-bit C int.  So a 64-bit
// value (a data pointer, the stream, a count that may pass 2**31) arrives
// as its low and high halves, and join() puts it back together.
//
// DeviceScope makes the tensors' device current for one launch, only when
// the calling thread's current device is another one, and restores the
// caller's device when it goes out of scope: a tensor on cuda:N launches on
// cuda:N, on the stream the wrapper read for cuda:N.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dlr {

inline uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

template <typename P>
inline P* join_ptr(uint32_t lo, uint32_t hi) {
  return reinterpret_cast<P*>(static_cast<uintptr_t>(join(lo, hi)));
}

class DeviceScope {
 public:
  explicit DeviceScope(int device) : device_(device) {
    status_ = cudaGetDevice(&prev_);
    if (status_ == cudaSuccess && prev_ != device_) {
      status_ = cudaSetDevice(device_);
    }
    // A failed call also sets the thread's last error; clear it, so that a
    // later launch's cudaGetLastError() reports only that launch.
    if (status_ != cudaSuccess) cudaGetLastError();
  }
  ~DeviceScope() {
    if (status_ == cudaSuccess && prev_ != device_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  cudaError_t status() const { return status_; }

 private:
  int device_;
  int prev_ = -1;
  cudaError_t status_;
};

}  // namespace dlr
