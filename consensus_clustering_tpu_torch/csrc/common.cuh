// Shared by every kernel library of the port: each library is loaded with
// ctypes on its own, so each exports its own error-string entry.
#pragma once

#include <cuda_runtime.h>

#define CC_EXPORT extern "C" __attribute__((visibility("default")))

CC_EXPORT const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
