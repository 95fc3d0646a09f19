// Host entries of the train-stack forward and backward kernels
// (train_kernel.cuh) at the parity grade (3xTF32), with a plain C interface
// for ctypes; the checks and launches are train_entry.cuh's, shared with the
// one-pass tiers' build (train_kernel_tiers.cu).  Built by
// diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include "train_entry.cuh"

// Each entry launches one kernel on `stream` (a cudaStream_t) of device
// `device` and returns 0 or the cudaError_t of the refused configuration or
// launch (train_entry.cuh: what is supported, the dropout's arguments).
extern "C" int train_stack_forward(TRAIN_FORWARD_PARAMS) {
  return traink::train_forward_entry<tf32::TIER_3XTF32>(TRAIN_FORWARD_ARGS);
}

extern "C" int train_stack_backward(TRAIN_BACKWARD_PARAMS) {
  return traink::train_backward_entry<tf32::TIER_3XTF32>(TRAIN_BACKWARD_ARGS);
}

extern "C" const char* train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
