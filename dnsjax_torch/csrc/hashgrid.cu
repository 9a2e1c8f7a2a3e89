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

// Position gradient of the encode: d(out)/d(pts)^T g -> (N, 3).
//
// Replaces no TPU kernel: dnsjax computes it in XLA
// (dnsjax/ops/hashgrid.py:318 _position_grad), and the port ran it as a
// chain of plain torch ops (``ops/hashgrid.py:position_grad_plain``) that
// wrote several (N, L, 8, 3) float32 tensors and ran two batched matrix
// products over N * L tiny batches. Here one launch reads the residuals the
// forward saved and writes the (N, 3) gradient alone.
//
// What bounds it on the H100: bytes. A point reads pts (12 B), its L
// levels' corner rows (C * F * 4 B each), aux (12 B each) and g (F * 4 B
// each), and writes 12 B: 1,368 B at L = 16, C = 8, F = 2, or 38.2 us for
// the keystep's 93,624 points at 3.35 TB/s. The arithmetic is a few flops
// a loaded float.
//
// Layout: one lane per (point, level), LP = L rounded up to a power of two
// lanes a point (LP <= 32, so a point's lanes share a warp; the lanes of
// levels >= L add 0). Consecutive lanes read consecutive levels' rows, so a
// point's rows (1 KB at the cells' shape) are read as one coalesced run of
// 16-byte loads. A lane forms s_c = sum_f feats[c, f] * g[f] over its
// corners, then d frac_k: for trilinear the differences of s along axis k
// weighted by the other two axes' factors (frac or 1 - frac, the lower
// axis first, as the plain version's products), for tet s[rank_k + 1] -
// s[rank_k]; times the level's resolution (the float (L,) tensor the plain
// version multiplies by). The point's lanes sum the three values by a
// butterfly of __shfl_xor_sync, whose order is fixed, so the result is the
// same on every launch (no atomics, no scratch); the level-0 lane zeroes
// each axis on which the point lies outside [0, 1] and stores 12 B.
template <int C, int F>
__global__ void hash_encode_pos_grad_kernel(
    const float* __restrict__ pts, const float* __restrict__ feats,
    const void* __restrict__ aux, const float* __restrict__ g,
    const float* __restrict__ res, float* __restrict__ out, int N, int L, int lp_log2) {
  static_assert(C * F % 4 == 0, "a corner row block is whole float4s");
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int n = (int)(t >> lp_log2);
  const int l = (int)(t & ((1 << lp_log2) - 1));
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (n < N && l < L) {
    const int nl = n * L + l;
    float gv[F];
    if constexpr (F % 4 == 0) {
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        float4 x = __ldg(reinterpret_cast<const float4*>(g + nl * F) + q);
        gv[4 * q] = x.x;
        gv[4 * q + 1] = x.y;
        gv[4 * q + 2] = x.z;
        gv[4 * q + 3] = x.w;
      }
    } else if constexpr (F == 2) {
      float2 x = __ldg(reinterpret_cast<const float2*>(g + nl * F));
      gv[0] = x.x;
      gv[1] = x.y;
    } else {
      gv[0] = __ldg(g + nl);
    }
    // s_c = sum_f feats[c, f] * g[f], the row read as C * F / 4 float4s
    float s[C];
    const float4* row = reinterpret_cast<const float4*>(feats + (long long)nl * C * F);
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = 0.0f;
#pragma unroll
    for (int q = 0; q < C * F / 4; ++q) {
      const float4 x = __ldcs(row + q);
      const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * q + j;
        s[e / F] = s[e / F] + v[j] * gv[e % F];
      }
    }
    if constexpr (C == 8) {
      const float* fr = reinterpret_cast<const float*>(aux) + nl * 3;
      float f1[3], f0[3];  // each axis' factor where a corner's bit is 1 / 0
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        f1[k] = __ldcs(fr + k);
        f0[k] = 1.0f - f1[k];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int i = k == 0 ? 1 : 0;  // the other two axes, i < j
        const int j = k == 2 ? 1 : 2;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if ((c >> k) & 1) continue;  // c: the corner of the pair with bit k = 0
          const float wi = ((c >> i) & 1) ? f1[i] : f0[i];
          const float wj = ((c >> j) & 1) ? f1[j] : f0[j];
          d[k] = d[k] + (wi * wj) * (s[c | (1 << k)] - s[c]);
        }
      }
    } else {
      const int* rk = reinterpret_cast<const int*>(aux) + nl * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int r = __ldcs(rk + k);  // 0, 1 or 2
        const float lo = r == 0 ? s[0] : r == 1 ? s[1] : s[2];
        const float hi = r == 0 ? s[1] : r == 1 ? s[2] : s[3];
        d[k] = hi - lo;
      }
    }
    const float rl = __ldg(res + l);
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = d[k] * rl;
  }
  // every lane of the warp takes part (those past the end add 0)
#pragma unroll
  for (int k = 0; k < 3; ++k)
    for (int off = (1 << lp_log2) >> 1; off > 0; off >>= 1)
      d[k] = d[k] + __shfl_xor_sync(FULL_MASK, d[k], off);
  if (n < N && l == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float p = __ldg(pts + 3 * n + k);
      out[3 * n + k] = (p >= 0.0f && p <= 1.0f) ? d[k] : 0.0f;
    }
  }
}

extern "C" int dnsjax_hash_encode_pos_grad(const void* pts, const void* feats,
                                           const void* aux, const void* g, const void* res,
                                           void* out, int N, int L, int F, int tet,
                                           void* stream) {
  if (N < 0 || L < 1 || L > 32 || (F != 1 && F != 2 && F != 4 && F != 8))
    return (int)cudaErrorInvalidValue;
  const int C = tet ? 4 : 8;
  int lp_log2 = 0;
  while ((1 << lp_log2) < L) ++lp_log2;
  const long long total = (long long)N << lp_log2;
  if ((long long)N * L * C * F >= (1LL << 31) || total >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (total > 0) {
    const unsigned int blocks = dnsjax_blocks(total);
    cudaStream_t st = (cudaStream_t)stream;
#define DNSJAX_POS(CV, FV)                                                          \
  hash_encode_pos_grad_kernel<CV, FV><<<blocks, DNSJAX_THREADS, 0, st>>>(          \
      (const float*)pts, (const float*)feats, aux, (const float*)g, (const float*)res, \
      (float*)out, N, L, lp_log2)
#define DNSJAX_POS_F(CV)          \
  switch (F) {                    \
    case 1: DNSJAX_POS(CV, 1); break; \
    case 2: DNSJAX_POS(CV, 2); break; \
    case 4: DNSJAX_POS(CV, 4); break; \
    default: DNSJAX_POS(CV, 8); break; \
  }
    if (tet) {
      DNSJAX_POS_F(4)
    } else {
      DNSJAX_POS_F(8)
    }
#undef DNSJAX_POS_F
#undef DNSJAX_POS
  }
  return (int)cudaGetLastError();
}
