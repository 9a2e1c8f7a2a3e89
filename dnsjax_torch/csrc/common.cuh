// Shared definitions of the dnsjax_torch kernels (C interface, loaded with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DNSJAX_MAX_LEVELS 32
#define DNSJAX_MAX_FEATURES 16
#define DNSJAX_THREADS 256

static inline unsigned int dnsjax_blocks(long long total) {
  return (unsigned int)((total + DNSJAX_THREADS - 1) / DNSJAX_THREADS);
}
