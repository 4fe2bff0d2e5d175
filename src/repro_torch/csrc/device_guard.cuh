// Make a device current for one entry point and restore the caller's.
//
// Every kernel entry point takes the device of its tensors and must
// launch there, but the calling thread's current device belongs to
// PyTorch: an entry point that left it changed would move later
// allocations and launches of the caller (the engine's channel split
// launches on several cards in turn).  The guard saves the current
// device, switches only when it differs, and switches back when the
// entry point returns, whatever path it returns by.
#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};
