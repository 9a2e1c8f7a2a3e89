// Per-level scatter-add of table-gradient contributions:
//   out[l] = zeros(R, F).at[idx[l]].add(vals[l])
//
// Replaces the Pallas TPU kernel dnsjax/ops/scatter.py:_dense_kernel (the
// hash-encode backward of scatter: pallas_sr / pallas / pallas_split). The
// TPU kernel kept the packed gradient table VMEM-resident and turned each
// contribution block into a one-hot MXU matmul over row windows; the H100
// needs none of that (no VMEM gate, no windows, no level partition).
//
// What bounds it on the H100: float32 atomics. One thread owns one
// (contribution, feature) and issues one atomicAdd; neighbouring threads add
// neighbouring features of the same row, so a warp's atomics hit 32-byte
// row segments. The slice's (4 x 2^16 x 8) float32 gradient table is 8 MiB and
// stays in L2, where the atomics resolve; collisions on a hot row serialize
// there. Contributions arrive already rounded as the config asks (stochastic
// bf16, nearest bf16, or unrounded): the value prepass runs before this
// kernel, so the result equals the TPU kernel's up to summation order.
// Rows outside [0, R) are dropped, as an XLA scatter drops them.

#include "common.cuh"

__global__ void scatter_add_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, int L, int N, int R,
                                   int F) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)L * N * F) return;
  const int f = (int)(t % F);
  const long long ln = t / F;  // (l, n) contribution slot
  const int l = (int)(ln / N);
  const int row = idx[ln];
  if (row < 0 || row >= R) return;
  atomicAdd(out + ((long long)l * R + row) * F + f, vals[t]);
}

extern "C" int dnsjax_scatter_add(const void* idx, const void* vals, void* out,
                                  int L, int N, int R, int F, void* stream) {
  long long total = (long long)L * N * F;
  if (total > 0) {
    scatter_add_kernel<<<dnsjax_blocks(total), DNSJAX_THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const int*)idx, (const float*)vals, (float*)out, L, N, R, F);
  }
  return (int)cudaGetLastError();
}
