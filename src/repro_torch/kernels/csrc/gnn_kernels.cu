// Hand-written Hopper (sm_90a) kernel of the GNN family's aggregation: a
// deterministic segment sum over a CSR.
//
// Replaces no pallas_call: the reference aggregates with
// jax.ops.segment_sum over gathered messages (repro/models/gnn.py:58), which
// XLA lowers to a scatter-add. The port computes
//
//   out[r, :] = sum over e in [indptr[r], indptr[r+1]) of x[col[e], :]
//
// in float32, with the edges of a row summed in the CSR's order (the edge
// list's order within a row: `kernels/segment.prepare_csr` sorts stably).
// It never materialises the (E, F) messages (31.3 GB at ogb_products' hidden
// width) and uses no float atomics, so two calls are bit-equal: a training
// step can be replayed exactly (restart checks).
//
// Bound: bytes. Each edge reads one row of x (F floats) from L2 or device
// memory; there is one add per element read.
//
// Layout: one warp per row, 8 warps a CTA. A warp walks its row's edges in
// order, 32 column ids at a time (one coalesced load, then shuffles), and
// keeps V accumulators a lane for a tile of 32*V columns (lane-contiguous,
// so each edge's row is read as V coalesced 128-byte segments); wider rows
// loop over tiles. Four edges' loads are issued before their adds, which
// stay in edge order. Any F works (the last tile is masked).
//
// Hub rows. The synthetic graphs draw sources from a zipf law, so a few
// rows of the backward's CSR hold millions of edges (13,370 chunks at
// ogb_products, `chip_smoke.py` [gnn_serve]); one warp summing such a row
// would set the step's time alone. So a row of more than `chunk` edges is
// cut into chunks of `chunk` edges: pass 1 sums each chunk into its slot of
// a scratch buffer (one warp a chunk, all in parallel), pass 2 adds a hub
// row's partials in chunk order. The plan (chunk_row, chunk_beg, hub_rows,
// hub_first) is built once per graph by `prepare_csr`; the rows pass skips
// hub rows.
//
// Built by repro_torch/kernels/_build.py with nvcc into the shared library
// of the port's kernels, bound with ctypes. The launcher enqueues on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (rows or chunks) a CTA

// Sum x[col[e], c0 + lane + 32 t] over e in [beg, end) for every column tile
// and write the sums to dst[c] (a row of F floats).
template <int V>
__device__ __forceinline__ void sum_span(const float* __restrict__ x, int F,
                                         const int* __restrict__ col,
                                         long long beg, long long end,
                                         int lane, float* __restrict__ dst) {
  for (int c0 = 0; c0 < F; c0 += 32 * V) {
    bool in[V];
    float acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) {
      in[t] = c0 + lane + 32 * t < F;
      acc[t] = 0.f;
    }
    const float* xc = x + c0 + lane;
    for (long long e0 = beg; e0 < end; e0 += 32) {
      const int n = (int)(end - e0 < 32 ? end - e0 : 32);
      const int mine = lane < n ? __ldg(col + e0 + lane) : 0;
      int j = 0;
      for (; j + 4 <= n; j += 4) {
        float v[4][V];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = __shfl_sync(0xffffffffu, mine, j + u);
          const float* r = xc + (long long)c * F;
#pragma unroll
          for (int t = 0; t < V; ++t) v[u][t] = in[t] ? __ldg(r + 32 * t) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int t = 0; t < V; ++t) acc[t] += v[u][t];
      }
      for (; j < n; ++j) {
        const int c = __shfl_sync(0xffffffffu, mine, j);
        const float* r = xc + (long long)c * F;
#pragma unroll
        for (int t = 0; t < V; ++t)
          if (in[t]) acc[t] += __ldg(r + 32 * t);
      }
    }
#pragma unroll
    for (int t = 0; t < V; ++t)
      if (in[t]) dst[c0 + lane + 32 * t] = acc[t];
  }
}

// Every row of at most `chunk` edges: its sum, straight into out.
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    segment_rows_kernel(const float* __restrict__ x, int F,
                        const long long* __restrict__ indptr,
                        const int* __restrict__ col, int n_rows, int chunk,
                        float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const long long beg = indptr[row], end = indptr[row + 1];
  if (end - beg > chunk) return;  // a hub row: the chunk passes
  sum_span<V>(x, F, col, beg, end, lane, out + row * F);
}

// Pass 1 of the hub rows: chunk k's sum into partial[k, :].
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    segment_chunks_kernel(const float* __restrict__ x, int F,
                          const long long* __restrict__ indptr,
                          const int* __restrict__ col, int chunk,
                          const int* __restrict__ chunk_row,
                          const long long* __restrict__ chunk_beg,
                          int n_chunks, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= n_chunks) return;
  const long long beg = chunk_beg[k];
  const long long row_end = indptr[chunk_row[k] + 1];
  const long long end = beg + chunk < row_end ? beg + chunk : row_end;
  sum_span<V>(x, F, col, beg, end, lane, partial + k * F);
}

// Pass 2: a hub row's partials added in chunk order.
__global__ void __launch_bounds__(kWarps * 32)
    segment_hubs_kernel(int F, const int* __restrict__ hub_rows,
                        const int* __restrict__ hub_first, int n_hubs,
                        const float* __restrict__ partial,
                        float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (h >= n_hubs) return;
  const long long row = hub_rows[h];
  const int k0 = hub_first[h], k1 = hub_first[h + 1];
  for (int c = lane; c < F; c += 32) {
    float acc = 0.f;
    for (int k = k0; k < k1; ++k) acc += partial[(long long)k * F + c];
    out[row * F + c] = acc;
  }
}

inline unsigned blocks(long long n) {
  return (unsigned)((n + kWarps - 1) / kWarps);
}

template <int V>
int launch_segment(const float* x, int F, const long long* indptr,
                   const int* col, int n_rows, int chunk, const int* chunk_row,
                   const long long* chunk_beg, int n_chunks,
                   const int* hub_rows, const int* hub_first, int n_hubs,
                   float* partial, float* out, cudaStream_t s) {
  const dim3 block(kWarps * 32);
  segment_rows_kernel<V><<<blocks(n_rows), block, 0, s>>>(
      x, F, indptr, col, n_rows, chunk, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 0) return (int)err;
  segment_chunks_kernel<V><<<blocks(n_chunks), block, 0, s>>>(
      x, F, indptr, col, chunk, chunk_row, chunk_beg, n_chunks, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_hubs_kernel<<<blocks(n_hubs), block, 0, s>>>(
      F, hub_rows, hub_first, n_hubs, partial, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n_rows, F) = the CSR (indptr (n_rows+1,) int64, col int32) applied
// to x (*, F) float32; rows of more than `chunk` edges go through the hub
// plan (n_chunks chunks, partial (n_chunks, F) float32 scratch; n_hubs hub
// rows with hub_first (n_hubs+1,) int32 offsets into the chunks).
int gnn_segment_sum(const void* x, int F, const void* indptr,
                    const void* col, int n_rows, int chunk,
                    const void* chunk_row, const void* chunk_beg,
                    int n_chunks, const void* hub_rows,
                    const void* hub_first, int n_hubs, void* partial,
                    void* out, void* stream) {
  if (F < 1 || n_rows < 0 || chunk < 1 || n_chunks < 0 || n_hubs < 0 ||
      (n_chunks > 0) != (n_hubs > 0))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* ip = static_cast<const long long*>(indptr);
  const auto* c = static_cast<const int*>(col);
  const auto* cr = static_cast<const int*>(chunk_row);
  const auto* cb = static_cast<const long long*>(chunk_beg);
  const auto* hr = static_cast<const int*>(hub_rows);
  const auto* hf = static_cast<const int*>(hub_first);
  auto* p = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  // narrow rows (F <= 32) take one column a lane, wider ones four
  return F <= 32 ? launch_segment<1>(xf, F, ip, c, n_rows, chunk, cr, cb,
                                     n_chunks, hr, hf, n_hubs, p, o, s)
                 : launch_segment<4>(xf, F, ip, c, n_rows, chunk, cr, cb,
                                     n_chunks, hr, hf, n_hubs, p, o, s);
}

// out: registers, local (spill) bytes a thread and resident CTAs an SM of
// the rows kernel with V = 1 (out[0..2]) and V = 4 (out[3..5])
int gnn_segment_occupancy(int* out) {
  const void* fns[2] = {(const void*)segment_rows_kernel<1>,
                        (const void*)segment_rows_kernel<4>};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
    if (err != cudaSuccess) return (int)err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fns[i],
                                                        kWarps * 32, 0);
    if (err != cudaSuccess) return (int)err;
    out[3 * i] = a.numRegs;
    out[3 * i + 1] = (int)a.localSizeBytes;
    out[3 * i + 2] = ctas;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
