// Hash-grid table gradient, fused: corner draw, value prepass and per-level
// scatter-add in one kernel.
//   out[l] = zeros(T, F).at[row].add(value)        out (L, T, F) float32
//
// Replaces the Pallas TPU kernel dnsjax/ops/scatter.py:_dense_kernel and the
// prepass that XLA fused in front of it in dnsjax/ops/hashgrid.py:
// _hash_encode_bwd: the stochastic corner (_table_grad_contribs), the level
// offset stripped off the flat row ids, and the value rounding (sr_bits16 +
// stochastic_round_bf16 for pallas_sr, nearest bf16 for pallas, float32 for
// pallas_split and xla). The TPU kernel kept the packed gradient table
// VMEM-resident and turned each contribution block into a one-hot MXU
// matmul over row windows; the H100 needs none of that (no VMEM gate, no
// windows, no level partition), and running the prepass as separate torch
// ops cost ~56 launches and ~1.25 GB of int64 traffic a backward, so it
// lives here.
//
// Inputs are the encode's residuals and the cotangent: idx (N, L, C) int32
// flat rows carrying the level offset l*T, w (N, L, C) float32, g (N, L, F)
// float32. Per (n, l) (one sampled corner) or per (n, l, c) (all corners)
// the kernel computes what the plain twin computes, bit for bit:
//   * cdf_c = w_0 + ... + w_c as float32 adds in corner order;
//   * u = ((idx[0] * 0x9E3779B9) ^ (idx[C-1] * 0x85EBCA6B)) >> 8, times 2^-24
//     (uint32 wrap); c* = min(#{c : cdf_c < u}, C - 1);
//   * row = idx[c*] - l*T, dropped outside [0, T) as an XLA scatter drops it;
//   * value g (one corner) or w_c * g (all corners, one float32 product);
//   * pallas_sr: (bits(x) + sr_bits16(row, slot, f, l)) & 0xFFFF0000, slot n
//     (one corner) or n*C + c (all corners), the (L, N[*C]) layout of the
//     prepass; pallas: round to nearest even bf16.
// So the result equals the twin's up to the order of the float32 sums.
//
// What bounds it on the H100: bytes. At the mapping shape (N = 93,624, L = 4,
// tet C = 4, F = 8) it reads idx and w (6.0 MB each) and g (12.0 MB) and
// writes the 8.4 MB table once: 32.4 MB, 9.7 us at 3.35 TB/s; the hashing is
// a dozen integer ops a float. Layout: one thread per (n, l) or (n, l, c),
// consecutive threads on consecutive residuals, so loads coalesce; a thread
// issues the 16-byte loads of its F floats of g first, then those of its C
// ids and weights, and adds its F values with vector reductions (sm_90's
// float4 / float2 atomicAdd on global memory: one red.v4 per 4 floats). The
// table, zeroed just before, stays in the 50 MB L2, where the reductions
// resolve. Samples of one ray are consecutive points and share cells of the
// dense small levels (level 0 has 17^3 rows), so the lanes of a warp that
// add to the same row first sum their values with shuffles
// (__match_any_sync groups them) and only the lowest lane reduces: on an
// H100, 22 % less device time on ray-shaped points at the mapping shape and
// none lost on uniform ones (PERF.md). Not deterministic: the order of the
// atomics changes from launch to launch.
//
// The same kernel serves the per-level scatter-add of values as given
// (ops/scatter.py:scatter_add, the contract of dnsjax's dense_matmul_scatter):
// idx (L, M) rows without offset, g (L, M, F) values, no rounding.
//
// Level draw (model.grid.grad_levels: 1, dnsjax/ops/hashgrid.py:365-377):
// each point keeps one level, l* = min(int(u2 * L), L - 1) with
//   u2 = ((idx[n,0,0] * 0x9E3779B9) ^ (idx[n,L-1,C-1] * (0x85EBCA6B + 2))) >> 8,
// times 2^-24 (the cell hash with salt 1), and that level's contribution
// (one drawn corner, or all C) is multiplied by L. dnsjax runs this mode as
// its flat XLA scatter of float32 values, so it never rounds. The threads
// are K a point (K = 1 one corner, C all corners), not K a (point, level):
// a thread reads the two ids of the draw (one 32-byte sector each, shared
// by the point's K threads) and then only the drawn level's ids, weights
// and cotangent, so the levels not drawn cost no bytes.

#include "common.cuh"

enum Corners { ONE = 0, ALL = 1, GIVEN = 2 };
enum Rounding { AS_F32 = 0, BF16_NEAREST = 1, BF16_STOCHASTIC = 2 };

// dnsjax/ops/scatter.py:sr_bits16 of (row, slot, f, l): murmur3 finalizer.
__device__ __forceinline__ unsigned int sr_bits16(unsigned int row, unsigned int slot,
                                                  unsigned int f, unsigned int l) {
  unsigned int h = (row * 0x9E3779B9u) ^ (slot * 0x85EBCA6Bu) ^ (f * 0xC2B2AE35u) ^
                   (l * 0x27D4EB2Fu);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h >> 16;
}

template <int ROUND>
__device__ __forceinline__ float round_value(float x, unsigned int row, unsigned int slot,
                                             unsigned int f, unsigned int l) {
  const unsigned int u = __float_as_uint(x);
  if constexpr (ROUND == BF16_STOCHASTIC)
    return __uint_as_float((u + sr_bits16(row, slot, f, l)) & 0xFFFF0000u);
  if constexpr (ROUND == BF16_NEAREST) {  // torch's float -> bfloat16 conversion
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) return __uint_as_float(0x7FC00000u);
    return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
  }
  return x;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ src, float* v) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __ldg(src);
  }
}

// One vector reduction of V floats into global memory (sm_90).
template <int V>
__device__ __forceinline__ void red_add(float* dst, const float* v) {
  if constexpr (V == 4)
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (V == 2)
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  else
    atomicAdd(dst, v[0]);
}

// C corners (4 tet, 8 trilinear; 1 for GIVEN), F features (2, 8, 16);
// LEVEL: one drawn level a point (see above).
// 32-bit indexing: the wrapper checks N*L*C*F and L*T*F < 2^31.
template <int C, int CORNERS, int ROUND, int F, bool LEVEL>
__global__ void table_grad_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                                  const float* __restrict__ g, float* __restrict__ out,
                                  int N, int L, int T) {
  constexpr int V = F % 4 == 0 ? 4 : (F % 2 == 0 ? 2 : 1);  // floats a vector access
  constexpr int K = CORNERS == ALL ? C : 1;  // threads a (n, l), or a point under LEVEL
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = (LEVEL ? N : N * L) * K;
  const unsigned int active = __ballot_sync(0xffffffffu, t < total);
  if (t >= total) return;
  int n, l, nl;  // nl: (n, l) row of the residuals; GIVEN: (l, n) of idx (L, N)
  if constexpr (CORNERS == GIVEN) {
    nl = t;
    l = t / N;
    n = t - l * N;
  } else if constexpr (LEVEL) {
    n = t / K;
    // dnsjax/ops/hashgrid.py:_stateless_uniform(idx[:, 0, 0], idx[:, -1, -1], 1)
    const unsigned int a = (unsigned int)__ldg(idx + n * L * C);
    const unsigned int b = (unsigned int)__ldg(idx + (n * L + L - 1) * C + C - 1);
    const unsigned int bits = (a * 0x9E3779B9u) ^ (b * (0x85EBCA6Bu + 2u));
    const float u2 = (float)(bits >> 8) * (1.0f / 16777216.0f);
    l = min((int)(u2 * (float)L), L - 1);
    nl = n * L + l;
  } else {
    nl = t / K;
    n = nl / L;
    l = nl - n * L;
  }
  const int e = nl * K + (t - (t / K) * K);  // this thread's residual: (n, l[, c])
  // the F values of g first: their loads are in flight while the ids arrive
  float v[F];
#pragma unroll
  for (int q = 0; q < F / V; ++q) load_vec<V>(g + nl * F + q * V, v + q * V);
  int row, slot;
  float scale = 1.0f;
  if constexpr (CORNERS == GIVEN) {
    row = idx[t];
    slot = n;
  } else if constexpr (CORNERS == ALL) {
    row = __ldg(idx + e) - l * T;
    scale = __ldg(w + e);
    slot = n * C + (e - nl * C);
  } else {
    int id[C];
    float wt[C];
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(idx + nl * C) + q);
      const float4 b = __ldg(reinterpret_cast<const float4*>(w + nl * C) + q);
      id[4 * q] = a.x;
      id[4 * q + 1] = a.y;
      id[4 * q + 2] = a.z;
      id[4 * q + 3] = a.w;
      wt[4 * q] = b.x;
      wt[4 * q + 1] = b.y;
      wt[4 * q + 2] = b.z;
      wt[4 * q + 3] = b.w;
    }
    // dnsjax/ops/hashgrid.py:_stateless_uniform(idx[0], idx[C-1], 0)
    const unsigned int bits =
        ((unsigned int)id[0] * 0x9E3779B9u) ^ ((unsigned int)id[C - 1] * 0x85EBCA6Bu);
    const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
    float cdf = wt[0];
    int below = cdf < u;
#pragma unroll
    for (int c = 1; c < C; ++c) {
      cdf = cdf + wt[c];
      below += cdf < u;
    }
    row = id[0];
#pragma unroll
    for (int c = 1; c < C; ++c)  // a constant index keeps id[] in registers
      if (c == (below < C - 1 ? below : C - 1)) row = id[c];
    row -= l * T;
    slot = n;
  }
  const bool keep = row >= 0 && row < T;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float x = CORNERS == ALL ? scale * v[f] : v[f];
    if constexpr (LEVEL) x = x * (float)L;  // (w * g) * L, as dnsjax multiplies
    v[f] = round_value<ROUND>(x, (unsigned int)row, (unsigned int)slot, (unsigned int)f,
                              (unsigned int)l);
  }
  // lanes of the warp that add to the same row sum their values at the
  // lowest of them first (in lane order), which then adds them alone
  const int lane = threadIdx.x & 31;
  const unsigned int same = __match_any_sync(active, keep ? l * T + row : -1 - lane);
  const int leader = __ffs(same) - 1;
  const int most = (int)__reduce_max_sync(active, (unsigned int)__popc(same));
  unsigned int rest = lane == leader ? same & (same - 1) : 0u;
  for (int it = 1; it < most; ++it) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float o = __shfl_sync(active, v[f], src);
      if (src != lane) v[f] += o;
    }
  }
  if (lane != leader || !keep) return;
  float* op = out + (l * T + row) * F;
#pragma unroll
  for (int q = 0; q < F / V; ++q) red_add<V>(op + q * V, v + q * V);
}

template <int C, int CORNERS, int ROUND, bool LEVEL = false>
static int launch(const void* idx, const void* w, const void* g, void* out, int N, int L,
                  int T, int F, cudaStream_t stream) {
  const long long total = (long long)N * (LEVEL ? 1 : L) * (CORNERS == ALL ? C : 1);
  const unsigned int blocks = dnsjax_blocks(total);
  const int* i = (const int*)idx;
  const float* wp = (const float*)w;
  const float* gp = (const float*)g;
  float* o = (float*)out;
  if (F == 2)
    table_grad_kernel<C, CORNERS, ROUND, 2, LEVEL><<<blocks, DNSJAX_THREADS, 0, stream>>>(
        i, wp, gp, o, N, L, T);
  else if (F == 8)
    table_grad_kernel<C, CORNERS, ROUND, 8, LEVEL><<<blocks, DNSJAX_THREADS, 0, stream>>>(
        i, wp, gp, o, N, L, T);
  else if (F == 16)
    table_grad_kernel<C, CORNERS, ROUND, 16, LEVEL><<<blocks, DNSJAX_THREADS, 0, stream>>>(
        i, wp, gp, o, N, L, T);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <int C, int CORNERS>
static int launch_rounding(const void* idx, const void* w, const void* g, void* out, int N,
                           int L, int T, int F, int round, cudaStream_t stream) {
  if (round == BF16_STOCHASTIC)
    return launch<C, CORNERS, BF16_STOCHASTIC>(idx, w, g, out, N, L, T, F, stream);
  if (round == BF16_NEAREST)
    return launch<C, CORNERS, BF16_NEAREST>(idx, w, g, out, N, L, T, F, stream);
  return launch<C, CORNERS, AS_F32>(idx, w, g, out, N, L, T, F, stream);
}

// corners: 0 one sampled corner, 1 all C, 2 values as given (C = 1, idx
// (L, N) rows without offset, g (L, N, F), w unused, round 0). round: 0
// float32, 1 nearest bf16, 2 stochastic bf16. level: 1 keeps one drawn
// level a point (corners 0 or 1, round 0, L > 1). F in {2, 8, 16}; idx, w
// and g 16-byte aligned (the wrapper aligns them). out is zeroed by the
// caller. Returns cudaGetLastError(), or cudaErrorInvalidValue for a mode,
// C or F the kernel does not take.
extern "C" int dnsjax_table_grad(const void* idx, const void* w, const void* g, void* out,
                                 int N, int L, int T, int F, int C, int corners, int round,
                                 int level, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)N * L == 0) return (int)cudaGetLastError();
  if (level) {
    if (round != AS_F32 || L < 2) return (int)cudaErrorInvalidValue;
    if (corners == ONE && C == 4) return launch<4, ONE, AS_F32, true>(idx, w, g, out, N, L, T, F, s);
    if (corners == ONE && C == 8) return launch<8, ONE, AS_F32, true>(idx, w, g, out, N, L, T, F, s);
    if (corners == ALL && C == 4) return launch<4, ALL, AS_F32, true>(idx, w, g, out, N, L, T, F, s);
    if (corners == ALL && C == 8) return launch<8, ALL, AS_F32, true>(idx, w, g, out, N, L, T, F, s);
    return (int)cudaErrorInvalidValue;
  }
  if (corners == GIVEN && C == 1) return launch<1, GIVEN, AS_F32>(idx, w, g, out, N, L, T, F, s);
  if (corners == ONE && C == 4) return launch_rounding<4, ONE>(idx, w, g, out, N, L, T, F, round, s);
  if (corners == ONE && C == 8) return launch_rounding<8, ONE>(idx, w, g, out, N, L, T, F, round, s);
  if (corners == ALL && C == 4) return launch_rounding<4, ALL>(idx, w, g, out, N, L, T, F, round, s);
  if (corners == ALL && C == 8) return launch_rounding<8, ALL>(idx, w, g, out, N, L, T, F, round, s);
  return (int)cudaErrorInvalidValue;
}
