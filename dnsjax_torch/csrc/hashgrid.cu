// Multi-resolution hash-grid encode, forward: corner lookup + interpolation.
//
// Replaces the Pallas TPU kernel dnsjax/ops/gather.py:_gather_kernel (and the
// XLA row gather of dnsjax/ops/hashgrid.py:_hash_encode_fwd it reproduces):
// for every point and level, gather the C corner rows of the (L, T, F) table,
// round each row to bf16 (gather_bf16), weight it by its float32
// interpolation weight and sum in float32.
//
// What bounds it on the H100: irregular row reads. Each (point, level) reads
// C rows of F float32 (16-32 bytes for F = 4..8) at hashed or dense indices;
// the arithmetic is a few dozen flops. The TPU kernel kept the packed table
// in VMEM and turned lookups into one-hot MXU matmuls; none of that carries
// over. Here one thread owns one (point, level): it computes the cell, the
// corner indices (dense or hashed) and the weights itself, and reads its rows
// straight from device memory. The whole slice-sized table (4 x 2^16 x 8 x 4
// bytes = 8 MiB) stays resident in the 50 MB L2, so the reads are L2 hits;
// consecutive threads write consecutive output elements.
//
// Traps, each matched to the float32 reference bit for bit:
//   * the spatial hash wraps in uint32 (natural here);
//   * x = p*res, i0 = min(floor(x), res-1), frac = x - i0 are separate float32
//     steps: the library is built with --fmad=false so no multiply-add fuses;
//   * tet ties between equal fracs break by axis index (lower axis ranks first).
//
// Optionally writes the residuals the backward and the forward-mode tangent
// need: per-corner rows (N, L, C, F), flat row indices with the level offset
// (N, L, C), weights (N, L, C), and the tet rank (int32) or trilinear frac
// (float32) per axis (N, L, 3).

#include <cuda_bf16.h>

#include "common.cuh"

struct LevelRes {
  int res[DNSJAX_MAX_LEVELS];
};

__global__ void hash_encode_fwd_kernel(
    const float* __restrict__ pts, const float* __restrict__ table, LevelRes lr,
    float* __restrict__ out, float* __restrict__ feats, int* __restrict__ idx_out,
    float* __restrict__ w_out, void* __restrict__ aux_out, int N, int L, int T,
    int F, int tet, int bf16) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * L) return;
  const int n = (int)(t / L);
  const int l = (int)(t % L);
  const int res = lr.res[l];
  const int C = tet ? 4 : 8;

  int i0[3];
  float fr[3];
  for (int k = 0; k < 3; ++k) {
    float p = fminf(fmaxf(pts[3 * n + k], 0.0f), 1.0f);
    float x = p * (float)res;
    int c = (int)floorf(x);
    i0[k] = c < res - 1 ? c : res - 1;
    fr[k] = x - (float)i0[k];
  }

  int off[8][3];
  float w[8];
  int rank[3];
  if (tet) {
    // rank_k = #axes that outrank axis k (larger frac, or equal frac and a
    // lower axis index); corner c steps along every axis with rank < c
    for (int k = 0; k < 3; ++k) {
      int r = 0;
      for (int j = 0; j < 3; ++j)
        r += (fr[j] > fr[k]) || (fr[j] == fr[k] && j < k);
      rank[k] = r;
    }
    for (int c = 0; c < 4; ++c)
      for (int k = 0; k < 3; ++k) off[c][k] = rank[k] < c;
    float f1 = fmaxf(fmaxf(fr[0], fr[1]), fr[2]);
    float f3 = fminf(fminf(fr[0], fr[1]), fr[2]);
    float s = (fr[0] + fr[1]) + fr[2];
    float f2 = (s - f1) - f3;
    w[0] = 1.0f - f1;
    w[1] = f1 - f2;
    w[2] = f2 - f3;
    w[3] = f3;
  } else {
    for (int c = 0; c < 8; ++c) {
      float prod = 1.0f;
      for (int k = 0; k < 3; ++k) {
        int b = (c >> k) & 1;
        off[c][k] = b;
        prod = prod * (b ? fr[k] : 1.0f - fr[k]);
      }
      w[c] = prod;
    }
  }

  const int nv = res + 1;
  const bool dense = (long long)nv * nv * nv <= (long long)T;
  float acc[DNSJAX_MAX_FEATURES];
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  const long long base = (long long)t * C;  // (n, l) row of the (N, L, C) residuals
  for (int c = 0; c < C; ++c) {
    int x = i0[0] + off[c][0], y = i0[1] + off[c][1], z = i0[2] + off[c][2];
    unsigned int row;
    if (dense) {
      row = (unsigned int)(x + nv * (y + nv * z));
    } else {
      unsigned int h = ((unsigned int)x * 1u) ^ ((unsigned int)y * 2654435761u) ^
                       ((unsigned int)z * 805459861u);
      row = h % (unsigned int)T;
    }
    const float* src = table + ((long long)l * T + row) * F;
    for (int f = 0; f < F; ++f) {
      float v = src[f];
      if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      acc[f] = acc[f] + w[c] * v;
      if (feats) feats[(base + c) * F + f] = v;
    }
    if (feats) {
      idx_out[base + c] = (int)((long long)l * T + row);
      w_out[base + c] = w[c];
    }
  }
  float* o = out + ((long long)n * L + l) * F;
  for (int f = 0; f < F; ++f) o[f] = acc[f];
  if (feats) {
    for (int k = 0; k < 3; ++k) {
      if (tet)
        ((int*)aux_out)[t * 3 + k] = rank[k];
      else
        ((float*)aux_out)[t * 3 + k] = fr[k];
    }
  }
}

extern "C" int dnsjax_hash_encode_fwd(const void* pts, const void* table,
                                      const void* res_host, void* out, void* feats,
                                      void* idx, void* w, void* aux, int N, int L,
                                      int T, int F, int tet, int bf16, void* stream) {
  if (L < 1 || L > DNSJAX_MAX_LEVELS || F < 1 || F > DNSJAX_MAX_FEATURES)
    return (int)cudaErrorInvalidValue;
  LevelRes lr;
  for (int l = 0; l < L; ++l) lr.res[l] = ((const int*)res_host)[l];
  long long total = (long long)N * L;
  if (total > 0) {
    hash_encode_fwd_kernel<<<dnsjax_blocks(total), DNSJAX_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float*)pts, (const float*)table, lr, (float*)out, (float*)feats,
        (int*)idx, (float*)w, aux, N, L, T, F, tet, bf16);
  }
  return (int)cudaGetLastError();
}
