// Multi-resolution hash-grid encode, forward: corner lookup + interpolation.
//
// Replaces the Pallas TPU kernel dnsjax/ops/gather.py:_gather_kernel (and the
// XLA row gather of dnsjax/ops/hashgrid.py:_hash_encode_fwd it reproduces):
// for every point and level, gather the C corner rows of the (L, T, F) table,
// round each row to bf16 (gather_bf16), weight it by its float32
// interpolation weight and sum in float32.
//
// What bounds it on the H100: bytes, and most of them are stores. At the
// mapping shape (93,624 points, 4 levels, tet C = 4, F = 8, with residuals)
// it writes the output (128 B a point) and the residuals the backward and
// the tangent need: per-corner rows (512 B), flat row ids (64 B), weights
// (64 B) and the tet rank (48 B), about 83.7 MB with the points and, read
// once, the table rows they touch (about 6.2 of the table's 8.4 MB; random
// points leave the dense levels' unreachable rows and some hashed ones
// alone): 25 us at 3.35 TB/s. The arithmetic is a few dozen
// flops per corner. The table (8 MiB at that shape) stays in the 50 MB L2.
//
// Layout: one thread per (point, level, corner), the C lanes of one
// (point, level) adjacent in a warp. Each lane computes the cell, its
// corner's row (dense or hashed, ``& (T - 1)``) and weight, loads the row
// with 16-byte loads (8 bytes for F = 2), and writes its residual row, id
// and weight at consecutive addresses, so a warp's stores cover whole
// contiguous lines (one thread per (point, level) put 32 lanes 128 B apart
// and touched 32 lines per store). The C products are summed across the
// group with __shfl_sync in corner order 0..C-1 from 0.0f, the order of the
// one-thread-per-(point, level) kernel this replaces, so ``out`` is the same
// bit for bit; lane c then writes its ceil(F / C) consecutive floats of the
// (point, level)'s output row (one float2 a lane for tet F = 8). All outputs are streaming stores (st.cs,
// evict first), so the residuals do not push the table out of L2. Index
// arithmetic is 32-bit: the wrapper checks N*L*C*F and L*T*F < 2^31.
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
// (float32) per axis (N, L, 3). Without them (mesh chunks, full-frame
// renders) it writes ``out`` only.

#include <cuda_bf16.h>

#include "common.cuh"

struct LevelRes {
  int res[DNSJAX_MAX_LEVELS];
};

#define FULL_MASK 0xffffffffu

// Loads F <= FM floats of one table row (16-, 8- or 4-byte loads).
template <int FM>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int F, float* v) {
  if (F == FM && FM % 4 == 0) {
#pragma unroll
    for (int q = 0; q < FM / 4; ++q) {
      float4 x = __ldg(reinterpret_cast<const float4*>(src) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else if (F == FM && FM % 2 == 0) {
#pragma unroll
    for (int q = 0; q < FM / 2; ++q) {
      float2 x = __ldg(reinterpret_cast<const float2*>(src) + q);
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int f = 0; f < FM; ++f) v[f] = f < F ? __ldg(src + f) : 0.0f;
  }
}

// Streams F <= FM floats to dst (16-, 8- or 4-byte streaming stores).
template <int FM>
__device__ __forceinline__ void store_row(float* __restrict__ dst, int F, const float* v) {
  if (F == FM && FM % 4 == 0) {
#pragma unroll
    for (int q = 0; q < FM / 4; ++q)
      __stcs(reinterpret_cast<float4*>(dst) + q,
             make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  } else if (F == FM && FM % 2 == 0) {
#pragma unroll
    for (int q = 0; q < FM / 2; ++q)
      __stcs(reinterpret_cast<float2*>(dst) + q, make_float2(v[2 * q], v[2 * q + 1]));
  } else {
#pragma unroll
    for (int f = 0; f < FM; ++f)
      if (f < F) __stcs(dst + f, v[f]);
  }
}

// C corners (4 tet, 8 trilinear), F <= FM features.
template <int C, int FM>
__global__ void hash_encode_fwd_kernel(
    const float* __restrict__ pts, const float* __restrict__ table, LevelRes lr,
    float* __restrict__ out, float* __restrict__ feats, int* __restrict__ idx_out,
    float* __restrict__ w_out, void* __restrict__ aux_out, int total, int L, int T,
    int F, int bf16) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  // groups of C lanes never straddle a warp (C divides 32, total is a
  // multiple of C), so the lanes that stay form whole groups
  const unsigned int mask = __ballot_sync(FULL_MASK, t < total);
  if (t >= total) return;
  const int lane = threadIdx.x & 31;
  const int base = lane & ~(C - 1);  // first lane of this (point, level)
  const int c = t & (C - 1);
  const int nl = t / C;  // (n, l) row of the (N, L, ...) outputs
  const int n = nl / L;
  const int l = nl - n * L;
  const int res = lr.res[l];

  int i0[3];
  float fr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float p = fminf(fmaxf(pts[3 * n + k], 0.0f), 1.0f);
    float x = p * (float)res;
    int ic = (int)floorf(x);
    i0[k] = ic < res - 1 ? ic : res - 1;
    fr[k] = x - (float)i0[k];
  }

  int off[3];
  float w;
  int rank[3];
  if (C == 4) {
    // rank_k = #axes that outrank axis k (larger frac, or equal frac and a
    // lower axis index); corner c steps along every axis with rank < c
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int r = 0;
#pragma unroll
      for (int j = 0; j < 3; ++j) r += (fr[j] > fr[k]) || (fr[j] == fr[k] && j < k);
      rank[k] = r;
      off[k] = r < c;
    }
    float f1 = fmaxf(fmaxf(fr[0], fr[1]), fr[2]);
    float f3 = fminf(fminf(fr[0], fr[1]), fr[2]);
    float s = (fr[0] + fr[1]) + fr[2];
    float f2 = (s - f1) - f3;
    w = c == 0 ? 1.0f - f1 : c == 1 ? f1 - f2 : c == 2 ? f2 - f3 : f3;
  } else {
    float prod = 1.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int b = (c >> k) & 1;
      off[k] = b;
      prod = prod * (b ? fr[k] : 1.0f - fr[k]);
    }
    w = prod;
  }

  const int nv = res + 1;
  const bool dense = (long long)nv * nv * nv <= (long long)T;
  const int x = i0[0] + off[0], y = i0[1] + off[1], z = i0[2] + off[2];
  unsigned int row;
  if (dense) {
    row = (unsigned int)(x + nv * (y + nv * z));
  } else {
    unsigned int h = ((unsigned int)x * 1u) ^ ((unsigned int)y * 2654435761u) ^
                     ((unsigned int)z * 805459861u);
    row = h & (unsigned int)(T - 1);
  }
  const int flat = l * T + (int)row;

  float v[FM];
  load_row<FM>(table + flat * F, F, v);
#pragma unroll
  for (int f = 0; f < FM; ++f)
    if (bf16) v[f] = __bfloat162float(__float2bfloat16_rn(v[f]));

  if (feats) {
    store_row<FM>(feats + t * F, F, v);
    __stcs(idx_out + t, flat);
    __stcs(w_out + t, w);
    if (c < 3) {  // lanes 0..2 write the (point, level)'s three aux values
      if (C == 4)
        __stcs((int*)aux_out + nl * 3 + c, c == 0 ? rank[0] : c == 1 ? rank[1] : rank[2]);
      else
        __stcs((float*)aux_out + nl * 3 + c, c == 0 ? fr[0] : c == 1 ? fr[1] : fr[2]);
    }
  }

  // out[f] = sum_c w_c * v_c[f], taken in corner order from 0.0f, by every
  // lane of the group; each lane then writes its share of the output row
  float sum[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) {
    sum[f] = 0.0f;
    if (f < F) {
      const float p = w * v[f];
#pragma unroll
      for (int k = 0; k < C; ++k) sum[f] = sum[f] + __shfl_sync(mask, p, base + k);
    }
  }
  float* dst = out + nl * F;
  if constexpr (FM % C == 0) {
    if (F == FM) {
      // lane c writes the P = F / C consecutive floats [c * P, (c + 1) * P);
      // the branch per lane keeps every register index a constant
      constexpr int P = FM / C;
      float o[P];
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
        if (c == cc) {
#pragma unroll
          for (int j = 0; j < P; ++j) o[j] = sum[cc * P + j];
        }
      if constexpr (P == 4) {
        __stcs(reinterpret_cast<float4*>(dst) + c, make_float4(o[0], o[1], o[2], o[3]));
      } else if constexpr (P == 2) {
        __stcs(reinterpret_cast<float2*>(dst) + c, make_float2(o[0], o[1]));
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) __stcs(dst + c * P + j, o[j]);
      }
      return;
    }
  }
  // otherwise lane c writes the features [c * Q, (c + 1) * Q), Q = ceil(F / C)
  const int Q = (F + C - 1) / C;
#pragma unroll
  for (int f = 0; f < FM; ++f)
    if (f < F && f / Q == c) __stcs(dst + f, sum[f]);
}

template <int C>
static void launch(int FM, unsigned int blocks, cudaStream_t st, const float* pts,
                   const float* table, const LevelRes& lr, float* out, float* feats,
                   int* idx, float* w, void* aux, int total, int L, int T, int F,
                   int bf16) {
#define DNSJAX_ENC(FMV)                                                          \
  hash_encode_fwd_kernel<C, FMV><<<blocks, DNSJAX_THREADS, 0, st>>>(            \
      pts, table, lr, out, feats, idx, w, aux, total, L, T, F, bf16)
  switch (FM) {
    case 1: DNSJAX_ENC(1); break;
    case 2: DNSJAX_ENC(2); break;
    case 4: DNSJAX_ENC(4); break;
    case 8: DNSJAX_ENC(8); break;
    default: DNSJAX_ENC(16); break;
  }
#undef DNSJAX_ENC
}

extern "C" int dnsjax_hash_encode_fwd(const void* pts, const void* table,
                                      const void* res_host, void* out, void* feats,
                                      void* idx, void* w, void* aux, int N, int L,
                                      int T, int F, int tet, int bf16, void* stream) {
  if (L < 1 || L > DNSJAX_MAX_LEVELS || F < 1 || F > DNSJAX_MAX_FEATURES ||
      T < 1 || (T & (T - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int C = tet ? 4 : 8;
  const long long total = (long long)N * L * C;
  if (total * F >= (1LL << 31) || (long long)L * T * F >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  LevelRes lr;
  for (int l = 0; l < L; ++l) lr.res[l] = ((const int*)res_host)[l];
  if (total > 0) {
    const int FM = F <= 1 ? 1 : F <= 2 ? 2 : F <= 4 ? 4 : F <= 8 ? 8 : 16;
    const unsigned int blocks = dnsjax_blocks(total);
    cudaStream_t st = (cudaStream_t)stream;
    if (tet)
      launch<4>(FM, blocks, st, (const float*)pts, (const float*)table, lr, (float*)out,
                (float*)feats, (int*)idx, (float*)w, aux, (int)total, L, T, F, bf16);
    else
      launch<8>(FM, blocks, st, (const float*)pts, (const float*)table, lr, (float*)out,
                (float*)feats, (int*)idx, (float*)w, aux, (int)total, L, T, F, bf16);
  }
  return (int)cudaGetLastError();
}
