// Scatter-add of contributions already sorted by row:
//   out = zeros(R, F).at[idx].add(vals)        (idx ascending)
//
// Replaces the Pallas TPU kernel dnsjax/ops/scatter.py:_kernel
// (sorted_scatter_add). The TPU kernel turned each 1024-contribution block
// into a one-hot MXU matmul into a 2048-row window of a VMEM-resident packed
// table, with an XLA fallback for blocks that spill their window. The H100
// needs none of that: a sorted run of equal row ids is a segment, and a
// segmented reduction writes each row once.
//
// One thread owns one (contribution, feature). The thread whose contribution
// starts a run (the first, or one whose row differs from its predecessor's)
// sums its feature over the whole run, in ascending contribution order, and
// stores the sum; every other thread returns. No atomics: the result is the
// same bit for bit on every launch. A long run (a skewed id) serializes in one
// thread. Rows outside [0, R) are dropped, as an XLA scatter drops them; the
// caller zeroes ``out``, so rows no contribution names stay zero.

#include "common.cuh"

__global__ void sorted_scatter_add_kernel(const int* __restrict__ idx,
                                          const float* __restrict__ vals,
                                          float* __restrict__ out, int M, int R,
                                          int F) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)M * F) return;
  const int i = (int)(t / F);
  const int f = (int)(t % F);
  const int row = idx[i];
  if (i > 0 && idx[i - 1] == row) return;  // not the head of its run
  if (row < 0 || row >= R) return;
  float s = 0.0f;
  for (int j = i; j < M && idx[j] == row; ++j) s += vals[(long long)j * F + f];
  out[(long long)row * F + f] = s;
}

extern "C" int dnsjax_sorted_scatter_add(const void* idx, const void* vals,
                                         void* out, int M, int R, int F,
                                         void* stream) {
  long long total = (long long)M * F;
  if (total > 0) {
    sorted_scatter_add_kernel<<<dnsjax_blocks(total), DNSJAX_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const int*)idx, (const float*)vals, (float*)out, M, R, F);
  }
  return (int)cudaGetLastError();
}
