// Host stand-ins for the CUDA function qualifiers, so that the port's
// device headers (george_tpu_torch/csrc/dual.cuh and the kernel trees that
// george_tpu_torch/dsl/cuda_codegen.py generates) compile with a host C++
// compiler in the CPU tests.  Include it before those headers.
#pragma once

#define __device__
#define __host__
#define __forceinline__ inline
