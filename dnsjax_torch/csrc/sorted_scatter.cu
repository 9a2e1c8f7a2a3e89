// Scatter-add of contributions already sorted by row:
//   out = zeros(R, F).at[idx].add(vals)        (idx ascending)
//
// Replaces the Pallas TPU kernel dnsjax/ops/scatter.py:_kernel
// (sorted_scatter_add). The TPU kernel turned each 1024-contribution block
// into a one-hot MXU matmul into a 2048-row window of a VMEM-resident packed
// table, with an XLA fallback for blocks that spill their window. The H100
// needs none of that: a sorted run of equal row ids is a segment, and a
// deterministic reduce-by-key writes each row once.
//
// What bounds it on the H100: bytes. Each contribution is read once (4 bytes
// of id, 4F of values) and each output row written once: 121.6 MB at
// 3 * 2^20 contributions of F = 8 into 2^18 rows, 36 us at 3.35 TB/s. The
// arithmetic is one add per value.
//
// The design spreads the work by contribution, not by run, so a skewed id
// (one run of millions) costs no serial walk. The sorted array is cut into
// tiles of SORTED_TILE = 256 consecutive contributions (the wrapper sizes
// its scratch from ``dnsjax_sorted_tile()``); one warp owns one tile (a
// block of 8 warps owns 8 consecutive tiles). The warp walks its tile in
// steps of CPS = 32 / G contributions, G lanes per contribution, each lane
// holding V consecutive values of its contribution's row (V = 4 where F
// allows it, so F = 8 is two float4 per contribution and a warp's loads are
// contiguous).
// Per step a segmented inclusive scan over the contributions (__shfl_up_sync
// in a fixed tree) sums each run; the running sum of the step's last run is
// carried into the next step's first contribution. A contribution that ends
// its run writes the run's sum once: to ``out`` when the run starts and ends
// inside the tile, else to the tile's scratch slot (first run, crossing the
// left edge: slot 0; last run, crossing the right edge: slot 1; a run
// covering the whole tile writes both). A second kernel finds, for every run
// that crosses a tile edge, the tile where it starts (the tile before, or a
// binary search on the tiles' first ids) and adds its partials in ascending
// tile order. So the work of a thread is bounded by the tile whatever the
// run lengths, and one row
// holding all 3 * 2^20 contributions costs 12,288 partials in the second
// pass, read 32 ahead. Smaller tiles give more warps to a small input (the
// textured scene's 374,496 contributions make 1,463 tiles); larger ones
// fewer partials to a long run.
//
// No atomics: every sum is taken in an order fixed by the input alone, so
// the result is the same bit for bit on every launch. Rows outside [0, R)
// are dropped, as an XLA scatter drops them; the caller zeroes ``out``, so
// rows no contribution names stay zero.

#include "common.cuh"

#define FULL_MASK 0xffffffffu
#define SORTED_BATCH 4

constexpr int SORTED_TILE = 256;  // contributions per warp tile

template <int V>
struct Vec;
template <>
struct Vec<4> {
  typedef float4 T;
};
template <>
struct Vec<2> {
  typedef float2 T;
};
template <>
struct Vec<1> {
  typedef float T;
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  typename Vec<V>::T x = *reinterpret_cast<const typename Vec<V>::T*>(p);
  const float* xs = reinterpret_cast<const float*>(&x);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = xs[k];
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  typename Vec<V>::T x;
  float* xs = reinterpret_cast<float*>(&x);
#pragma unroll
  for (int k = 0; k < V; ++k) xs[k] = v[k];
  *reinterpret_cast<typename Vec<V>::T*>(p) = x;
}

// Pass 1: one warp per tile. part is (n_tiles, 2, F).
template <int V>
__global__ void sorted_tile_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, float* __restrict__ part,
                                   int M, int R, int F, int n_tiles) {
  const int lane = threadIdx.x & 31;
  const int tile = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (tile >= n_tiles) return;  // whole warps leave together
  const int G = F / V;          // lanes per contribution (G <= 32)
  const int CPS = 32 / G;       // contributions per step
  const int c = lane / G;       // this lane's contribution slot in a step
  const int g = lane - c * G;   // this lane's V-wide column group
  const int start = tile * SORTED_TILE;
  const int end = min(M, start + SORTED_TILE);
  const int first_row = idx[start];
  const bool cont_left = start > 0 && idx[start - 1] == first_row;
  const bool cont_right = end < M && idx[end] == idx[end - 1];

  float carry[V];
#pragma unroll
  for (int k = 0; k < V; ++k) carry[k] = 0.0f;
  bool carrying = false;  // the previous step's last run continues here

  // steps are loaded SORTED_BATCH at a time, so a warp keeps that many
  // steps' loads in flight before it scans the first of them
  for (int b0 = start; b0 < end; b0 += SORTED_BATCH * CPS) {
    int rows[SORTED_BATCH], nxts[SORTED_BATCH];
    float vs[SORTED_BATCH][V];
#pragma unroll
    for (int u = 0; u < SORTED_BATCH; ++u) {
      const int i = b0 + u * CPS + c;
      rows[u] = nxts[u] = 0;
#pragma unroll
      for (int k = 0; k < V; ++k) vs[u][k] = 0.0f;
      if (c < CPS && i < end) {
        rows[u] = idx[i];
        if (i + 1 < end) nxts[u] = idx[i + 1];
        load_vec<V>(vals + i * F + g * V, vs[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < SORTED_BATCH; ++u) {
      const int s0 = b0 + u * CPS;
      if (s0 >= end) break;  // the same for the whole warp
      const int i = s0 + c;
      const bool valid = c < CPS && i < end;
      const int row = rows[u], nxt = nxts[u];
      float* v = vs[u];
      if (c == 0 && carrying) {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = carry[k] + v[k];
      }
      // segmented inclusive scan over the step's contributions, slot order
      const int prev_row = __shfl_up_sync(FULL_MASK, row, G);
      bool head = c == 0 || prev_row != row;
      for (int d = 1; d < CPS; d <<= 1) {
        const int up = d * G;
        float w[V];
#pragma unroll
        for (int k = 0; k < V; ++k) w[k] = __shfl_up_sync(FULL_MASK, v[k], up);
        const bool up_head = __shfl_up_sync(FULL_MASK, head, up);
        if (c >= d && !head) {
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = w[k] + v[k];
        }
        if (c >= d) head = head || up_head;
      }
      const bool last_in_tile = i + 1 == end;
      const bool ends = valid && (last_in_tile || nxt != row);
      if (ends) {
        const bool left = cont_left && row == first_row;
        const bool right = last_in_tile && cont_right;
        if (left) store_vec<V>(part + (2 * tile) * F + g * V, v);
        if (right) store_vec<V>(part + (2 * tile + 1) * F + g * V, v);
        if (!left && !right && row >= 0 && row < R) store_vec<V>(out + row * F + g * V, v);
      }
      // carry the step's last contribution's running sum if its run goes on
      const int last_slot = min(CPS, end - s0) - 1;
      const bool last_ends = __shfl_sync(FULL_MASK, ends, last_slot * G);
#pragma unroll
      for (int k = 0; k < V; ++k) carry[k] = __shfl_sync(FULL_MASK, v[k], last_slot * G + g);
      carrying = !last_ends;
    }
  }
}

// Pass 2: one thread per (tile, feature). The tile whose first run crosses
// its left edge and ends inside it owns that run: it adds the run's partials
// from the tile where the run starts, in ascending tile order.
__global__ void sorted_edge_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ part,
                                   float* __restrict__ out, int M, int R, int F,
                                   int n_tiles) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles * F) return;
  const int b = t / F;
  const int f = t - b * F;
  const int start = b * SORTED_TILE;
  const int end = min(M, start + SORTED_TILE);
  const int row = idx[start];
  if (start == 0 || idx[start - 1] != row) return;  // starts in this tile
  if (end < M && idx[end] == row) return;           // goes on past this tile
  if (row < 0 || row >= R) return;
  // a: the tile where the run starts. Mostly b - 1; if the run covers tile
  // b - 1 from its first contribution on, search the tiles' first ids.
  int a = b - 1;
  if (idx[a * SORTED_TILE] == row) {
    int lo = 0, hi = a;  // the first tile whose first id is the row
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (idx[mid * SORTED_TILE] < row)
        lo = mid + 1;
      else
        hi = mid;
    }
    a = lo > 0 && idx[lo * SORTED_TILE - 1] == row ? lo - 1 : lo;
  }
  float s = part[(2 * a + 1) * F + f];
#pragma unroll 32
  for (int j = a + 1; j < b; ++j) s = s + part[(2 * j) * F + f];
  s = s + part[(2 * b) * F + f];
  out[row * F + f] = s;
}

// The tile size, from which the caller sizes ``part``: (ceil(M / tile), 2, F).
extern "C" int dnsjax_sorted_tile(void) { return SORTED_TILE; }

extern "C" int dnsjax_sorted_scatter_add(const void* idx, const void* vals,
                                         void* out, void* part, int M, int R, int F,
                                         int V, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if ((V != 1 && V != 2 && V != 4) || F % V != 0 || F / V > 32)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (M + SORTED_TILE - 1) / SORTED_TILE;
  const unsigned int blocks = dnsjax_blocks((long long)n_tiles * 32);
  cudaStream_t st = (cudaStream_t)stream;
  const int* ip = (const int*)idx;
  const float* vp = (const float*)vals;
  float* op = (float*)out;
  float* pp = (float*)part;
  if (V == 4)
    sorted_tile_kernel<4><<<blocks, DNSJAX_THREADS, 0, st>>>(ip, vp, op, pp, M, R, F, n_tiles);
  else if (V == 2)
    sorted_tile_kernel<2><<<blocks, DNSJAX_THREADS, 0, st>>>(ip, vp, op, pp, M, R, F, n_tiles);
  else
    sorted_tile_kernel<1><<<blocks, DNSJAX_THREADS, 0, st>>>(ip, vp, op, pp, M, R, F, n_tiles);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (n_tiles > 1)
    sorted_edge_kernel<<<dnsjax_blocks((long long)n_tiles * F), DNSJAX_THREADS, 0, st>>>(
        ip, pp, op, M, R, F, n_tiles);
  return (int)cudaGetLastError();
}
