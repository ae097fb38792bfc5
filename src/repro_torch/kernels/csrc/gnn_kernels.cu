// Hand-written Hopper (sm_90a) kernel of the GNN family's aggregation: a
// deterministic segment sum over a CSR.
//
// Replaces no pallas_call: the reference aggregates with
// jax.ops.segment_sum over gathered messages (repro/models/gnn.py:58), which
// XLA lowers to a scatter-add. The port computes
//
//   out[r, :] = sum over e in [indptr[r], indptr[r+1]) of x[col[e], :]
//
// in float32 in the order the CSR fixes (`kernels/segment.py`): a row of at
// most `chunk` entries in entry order; a hub row as chunks, each summed in
// entry order into a partial, then its partials added in slot order. It
// never materialises the (E, F) messages (31.3 GB at ogb_products' hidden
// width) and uses no float atomics, so two calls are bit-equal: a training
// step can be replayed exactly (restart checks).
//
// Bound: bytes. Each entry reads one row of x (F floats); there is one add
// per element read. The synthetic graphs draw sources from a zipf law, so
//   - the forward (rows = destinations) reads a few hundred source rows for
//     most of its entries. `prepare_csr` ranks the hottest sources; their
//     entries in `hot_col` carry the rank beside the id (sign bit set, rank
//     in bits 22-30, id in bits 0-21), and each CTA stages as many of them
//     as fit kStageBytes of shared memory once, then reads them there.
//     L1 and shared memory are one array of 256 KB an SM, and L1 also
//     keeps hot rows, so the stage is kept small: the rest stays L1.
//   - the backward (rows = sources) has a few hundred hub rows holding
//     most entries, each reading destinations spread over the whole
//     cotangent. Their entries are sorted by destination and the chunks
//     cut at destination bands, laid out band-major; the chunk pass takes
//     chunks in table order from a work counter, with 8 warps an SM, so
//     that the chunks in flight read about one band and its rows come
//     from L2.
//   - a row's sum is a chain of dependent loads (its bounds, its column
//     ids, its sources' rows), so each pass keeps loads in flight across
//     it: the next column block is loaded before the current block's
//     rows; the rows pass loads the next row's first block and the bounds
//     of the row after before summing a row; the chunk pass keeps 32
//     entries' rows in flight a lane (its 8 warps an SM have the
//     registers for it). A run of row loads has no branch or other load
//     between them (an entry's code is decoded once a column block).
//
// Layout: a group of L lanes (L = 8, 16 or 32: short rows at F <= 64 share
// a warp, each group on its own) takes one row or chunk; each lane keeps V
// accumulators of W floats (W = 4: 16-byte loads, where F % 4 == 0 and x
// is 16-byte aligned; else W = 1), for a tile of L*V*W columns; wider rows
// loop over tiles. A group loads L column ids at once (coalesced) and
// shuffles them out; its adds stay in entry order. Three launches: the
// chunk pass (hub rows' chunks into partials), the rows pass (every other
// row: persistent CTAs of 32 warps where sources are staged, else CTAs of
// 8 warps, a group a row), the hub pass (a hub's partials in slot order,
// one thread a column).
//
// Built by repro_torch/kernels/_build.py with nvcc into the shared library
// of the port's kernels, bound with ctypes. The launcher enqueues on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the rows pass: persistent CTAs of 32 warps where sources are staged (a
// CTA stages once), else CTAs of 8 warps, one row a group
constexpr int kRowsThreads = 1024;
constexpr int kRowsThreadsUnstaged = 256;
constexpr int kRowsUnroll = 8;        // entries a group has in flight there
constexpr int kChunkThreads = 256;    // the chunk pass: 8 warps, 1 CTA an SM
constexpr int kChunkUnroll = 32;      // entries a group has in flight there
constexpr int kHubThreads = 128;      // the hub pass: one CTA a hub
constexpr int kHubUnroll = 16;        // partials a thread has in flight
// shared memory a CTA stages hot sources in (the rest of the SM's 256 KB
// stays L1)
constexpr int kStageBytes = 65536;
// a hot entry of `hot_col`: sign bit, rank (< 512) in bits 22-30, id below
constexpr int kIdBits = 22;
constexpr int kIdMask = (1 << kIdBits) - 1;
constexpr int kRankMask = 511;

struct SegArgs {
  const float* x;
  int F;
  const long long* indptr;
  const int* col;          // true ids; with hot sources staged, `hot_col`
  int H;                   // hot sources staged in shared memory
  const int* hot_ids;      // rank -> source id
  int n_rows;
  int chunk;
  const long long* chunk_beg;
  const long long* chunk_end;
  const int* chunk_slot;
  int n_chunks;
  float* partial;
  float* out;
  int* counter;            // the chunk pass's next chunk
};

template <int W>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};

// The lanes of this lane's group of L.
template <int L>
__device__ __forceinline__ unsigned group_mask(int lane) {
  return L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane & ~(L - 1));
}

// Column ids beg + gl (gl < n), the block a group shuffles out.
__device__ __forceinline__ int col_block(const SegArgs& a, long long beg,
                                         long long n, int gl) {
  return gl < n ? __ldg(a.col + beg + gl) : 0;
}

// Each CTA copies the H hot sources' rows into shared memory.
template <int W>
__device__ __forceinline__ void stage_hot(const SegArgs& a, float* stage) {
  using T = typename Vec<W>::T;
  const long long n = (long long)a.H * a.F / W;
  const int per_row = a.F / W;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = (int)(i / per_row);
    const int c = (int)(i - (long long)r * per_row);
    reinterpret_cast<T*>(stage)[i] = reinterpret_cast<const T*>(
        a.x + (long long)__ldg(a.hot_ids + r) * a.F)[c];
  }
  __syncthreads();
}

// With S (sources staged), a lane's column id decoded once a block: a hot
// entry whose rank is below H becomes its rank with the sign bit set (a
// row of the stage), any other its source id.
template <bool S>
__device__ __forceinline__ int decode(const SegArgs& a, int c) {
  if (!S || c >= 0) return c;
  const int rank = (c >> kIdBits) & kRankMask;
  return rank < a.H ? (int)(0x80000000u | (unsigned)rank) : (c & kIdMask);
}

// Entry c's (decoded) columns cc.. (W floats) into v where `ok`: from x,
// or with S for a staged row from shared memory. The shared load is made
// for every entry (row 0 of the stage where the entry is not staged) and
// the global one is guarded, each in the form that keeps a run of loads
// free of branches; a pointer that might point to either space would make
// every load a generic one, slower than a global one.
template <int W, bool S>
__device__ __forceinline__ void load_entry(const SegArgs& a,
                                           const float* stage, int c, int cc,
                                           bool ok,
                                           typename Vec<W>::T& v) {
  using T = typename Vec<W>::T;
  if (!S) {
    v = ok ? *reinterpret_cast<const T*>(a.x + (long long)c * a.F + cc)
           : Vec<W>::zero();
    return;
  }
  const bool staged = c < 0;
  const int r = c & 0x7fffffff;
  const T g = ok && !staged
                  ? *reinterpret_cast<const T*>(a.x + (long long)r * a.F + cc)
                  : Vec<W>::zero();
  const T sh = *reinterpret_cast<const T*>(
      stage + (long long)(staged ? r : 0) * a.F + (cc < a.F ? cc : 0));
  v = staged ? sh : g;
}

// The sum of entries [beg, beg + len) into dst (F floats; no write when
// dst is null) by one group of L lanes; `first` is the group's first
// column block, loaded by the caller. The next block is loaded before the
// current one's rows, U of whose loads are in flight before their adds.
template <int W, int V, int L, int U, bool S>
__device__ __forceinline__ void sum_item(const SegArgs& a,
                                         const float* stage, long long beg,
                                         long long len, int first, int gl,
                                         unsigned mask, float* dst) {
  using T = typename Vec<W>::T;
  constexpr int kTile = L * V * W;
  const int F = a.F;
  for (int c0 = 0; c0 < F; c0 += kTile) {
    T acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = Vec<W>::zero();
    int mine = decode<S>(a, c0 == 0 ? first : col_block(a, beg, len, gl));
    for (long long e0 = 0; e0 < len; e0 += L) {
      const int n = (int)(len - e0 < L ? len - e0 : L);
      const int next = col_block(a, beg + e0 + L, len - e0 - L, gl);
      for (int j = 0; j < n; j += U) {
        T v[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = __shfl_sync(mask, mine, (j + u) & (L - 1), L);
          const bool ok = j + u < n;
#pragma unroll
          for (int t = 0; t < V; ++t) {
            const int cc = c0 + (t * L + gl) * W;
            load_entry<W, S>(a, stage, c, cc, ok && cc < F, v[u][t]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < n) {
#pragma unroll
            for (int t = 0; t < V; ++t) Vec<W>::add(acc[t], v[u][t]);
          }
        }
      }
      mine = decode<S>(a, next);
    }
    if (dst != nullptr) {
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int cc = c0 + (t * L + gl) * W;
        if (cc < F) *reinterpret_cast<T*>(dst + cc) = acc[t];
      }
    }
  }
}

// A row of the rows pass: its entries, and where its sum goes (a hub row:
// nothing, the chunk and hub passes sum it).
struct RowItem {
  long long beg, len;
  float* dst;
};

__device__ __forceinline__ RowItem row_item(const SegArgs& a,
                                            long long row) {
  RowItem it{0, 0, nullptr};
  if (row < a.n_rows) {
    it.beg = a.indptr[row];
    it.len = a.indptr[row + 1] - it.beg;
    if (it.len > a.chunk)
      it.len = 0;
    else
      it.dst = a.out + row * a.F;
  }
  return it;
}

// The rows pass: every row of at most `chunk` entries, straight into out.
// A group takes rows strided over the grid (a persistent one where rows
// are staged, so that a CTA stages once; else one row a group), two deep:
// the next row's first column block and the row after's bounds are
// loaded before this row's sum.
template <int W, int V, int L, bool S>
__global__ void __launch_bounds__(kRowsThreads)
    segment_rows_kernel(SegArgs a) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  if (S) stage_hot<W>(a, stage);
  const int lane = threadIdx.x & 31;
  const int gl = lane % L;
  const unsigned mask = group_mask<L>(lane);
  constexpr int G = 32 / L;
  const long long stride = (long long)gridDim.x * (blockDim.x >> 5) * G;
  long long row = ((long long)blockIdx.x * (blockDim.x >> 5) +
                   (threadIdx.x >> 5)) * G + lane / L;
  RowItem cur = row_item(a, row);
  int first = col_block(a, cur.beg, cur.len, gl);
  RowItem nxt = row_item(a, row + stride);
  while (row < a.n_rows) {
    const int nfirst = col_block(a, nxt.beg, nxt.len, gl);
    const RowItem after = row_item(a, row + 2 * stride);
    sum_item<W, V, L, kRowsUnroll, S>(a, stage, cur.beg, cur.len, first, gl,
                                      mask, cur.dst);
    row += stride;
    cur = nxt;
    first = nfirst;
    nxt = after;
  }
}

// The chunk pass: each chunk into its partial's slot, taken by a group in
// table order from the work counter, 8 warps an SM so that the chunks in
// flight read about one band.
template <int W, int V, int L, bool S>
__global__ void __launch_bounds__(kChunkThreads, 1)
    segment_chunks_kernel(SegArgs a) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  if (S) stage_hot<W>(a, stage);
  const int lane = threadIdx.x & 31;
  const int gl = lane % L;
  const unsigned mask = group_mask<L>(lane);
  const int leader = lane & ~(L - 1);
  while (true) {
    int k = 0;
    if (gl == 0) k = atomicAdd(a.counter, 1);
    k = __shfl_sync(mask, k, leader);
    if (k >= a.n_chunks) break;
    const long long beg = a.chunk_beg[k];
    const long long len = a.chunk_end[k] - beg;
    sum_item<W, V, L, kChunkUnroll, S>(
        a, stage, beg, len, col_block(a, beg, len, gl), gl, mask,
        a.partial + (long long)a.chunk_slot[k] * a.F);
  }
}

// The hub pass: a hub row's partials added in slot order, one thread a
// column, kHubUnroll partials' loads in flight.
__global__ void __launch_bounds__(kHubThreads)
    segment_hubs_kernel(int F, const int* __restrict__ hub_rows,
                        const int* __restrict__ hub_first,
                        const float* __restrict__ partial,
                        float* __restrict__ out) {
  constexpr int U = kHubUnroll;
  const int h = blockIdx.x;
  const long long row = hub_rows[h];
  const int k0 = hub_first[h], k1 = hub_first[h + 1];
  for (int c = threadIdx.x; c < F; c += blockDim.x) {
    float acc = 0.f;
    int k = k0;
    for (; k + U <= k1; k += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = partial[(long long)(k + u) * F + c];
#pragma unroll
      for (int u = 0; u < U; ++u) acc += v[u];
    }
    for (; k < k1; ++k) acc += partial[(long long)k * F + c];
    out[row * F + c] = acc;
  }
}

// What a call at width F runs.
struct Plan {
  const void* rows;
  const void* chunks;
  int rows_threads;
  int lanes;
  int vec;     // 1: 16-byte loads
  int H;       // staged hot sources
  size_t smem;
};

template <int W, int V, int L>
Plan plan_of(int F, int n_hot, int stage_max) {
  Plan p;
  const long long fit = (long long)stage_max / ((long long)F * 4);
  p.H = (int)(n_hot < fit ? n_hot : fit);
  p.smem = (size_t)p.H * F * 4;
  p.rows = p.H ? (const void*)segment_rows_kernel<W, V, L, true>
               : (const void*)segment_rows_kernel<W, V, L, false>;
  p.chunks = p.H ? (const void*)segment_chunks_kernel<W, V, L, true>
                 : (const void*)segment_chunks_kernel<W, V, L, false>;
  p.rows_threads = p.H ? kRowsThreads : kRowsThreadsUnstaged;
  p.lanes = L;
  p.vec = W == 4;
  return p;
}

int device_attr(cudaDeviceAttr attr, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out, attr, dev);
  return (int)err;
}

int make_plan(int F, int n_hot, bool vec, Plan* p) {
  int smem_max = 0, sm_smem = 0;
  int err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &smem_max);
  if (!err)
    err = device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor, &sm_smem);
  if (err) return err;
  const int stage = kStageBytes < smem_max ? kStageBytes : smem_max;
  if (vec) {
    *p = F <= 32   ? plan_of<4, 1, 8>(F, n_hot, stage)
         : F <= 64 ? plan_of<4, 1, 16>(F, n_hot, stage)
                   : plan_of<4, 1, 32>(F, n_hot, stage);
  } else {
    *p = F <= 8    ? plan_of<1, 1, 8>(F, n_hot, stage)
         : F <= 16 ? plan_of<1, 1, 16>(F, n_hot, stage)
         : F <= 32 ? plan_of<1, 1, 32>(F, n_hot, stage)
                   : plan_of<1, 4, 32>(F, n_hot, stage);
  }
  // above 48 KB only after this (the kernels have no static shared
  // memory); and the least shared memory carve-out that holds the stage,
  // so that the rest of the SM's memory is L1
  const int carveout = (int)((p->smem * 100 + sm_smem - 1) / sm_smem);
  for (const void* fn : {p->rows, p->chunks}) {
    if ((err = (int)cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max)))
      return err;
    if ((err = (int)cudaFuncSetAttribute(
             fn, cudaFuncAttributePreferredSharedMemoryCarveout, carveout)))
      return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// out (n_rows, F) = the CSR (indptr (n_rows+1,) int64, col int32; hot_col
// int32, col with the n_hot hot sources coded, hot_ids (n_hot,) int32)
// applied to x (*, F) float32; rows of more than `chunk` entries go
// through the hub plan (n_chunks chunks [chunk_beg, chunk_end) into
// partial (n_chunks, F) float32 at chunk_slot; n_hubs hub rows with
// hub_first (n_hubs+1,) int32 offsets into the slots); counter: one int32
// of scratch when n_chunks > 0.
int gnn_segment_sum(const void* x, int F, const void* indptr,
                    const void* col, const void* hot_col, int n_rows,
                    int chunk, const void* hot_ids, int n_hot,
                    const void* chunk_beg, const void* chunk_end,
                    const void* chunk_slot, int n_chunks,
                    const void* hub_rows, const void* hub_first, int n_hubs,
                    void* partial, void* counter, void* out, void* stream) {
  if (F < 1 || n_rows < 0 || chunk < 1 || n_hot < 0 ||
      n_hot > kRankMask + 1 || n_chunks < 0 || n_hubs < 0 ||
      (n_chunks > 0) != (n_hubs > 0))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  auto* s = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  Plan p;
  int err = make_plan(F, n_hot, vec, &p);
  if (err) return err;
  int sms = 0;
  if ((err = device_attr(cudaDevAttrMultiProcessorCount, &sms))) return err;
  SegArgs a;
  a.x = static_cast<const float*>(x);
  a.F = F;
  a.indptr = static_cast<const long long*>(indptr);
  a.col = static_cast<const int*>(p.H ? hot_col : col);
  a.H = p.H;
  a.hot_ids = static_cast<const int*>(hot_ids);
  a.n_rows = n_rows;
  a.chunk = chunk;
  a.chunk_beg = static_cast<const long long*>(chunk_beg);
  a.chunk_end = static_cast<const long long*>(chunk_end);
  a.chunk_slot = static_cast<const int*>(chunk_slot);
  a.n_chunks = n_chunks;
  a.partial = static_cast<float*>(partial);
  a.out = static_cast<float*>(out);
  a.counter = static_cast<int*>(counter);
  void* args[] = {&a};
  if (n_chunks > 0) {
    if ((err = (int)cudaMemsetAsync(a.counter, 0, sizeof(int), s)))
      return err;
    if ((err = (int)cudaLaunchKernel(p.chunks, dim3(sms),
                                     dim3(kChunkThreads), args, p.smem, s)))
      return err;
  }
  // staged: one persistent wave (a CTA stages once); else a group a row
  int per_sm = 0;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, p.rows, p.rows_threads, p.smem)))
    return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long per_cta = (long long)(p.rows_threads / 32) * (32 / p.lanes);
  const long long need = (n_rows + per_cta - 1) / per_cta;
  const long long wave = (long long)sms * per_sm;
  if ((err = (int)cudaLaunchKernel(
           p.rows, dim3((unsigned)(need < wave || !p.H ? need : wave)),
           dim3(p.rows_threads), args, p.smem, s)))
    return err;
  if (n_chunks > 0)
    segment_hubs_kernel<<<n_hubs, kHubThreads, 0, s>>>(
        F, static_cast<const int*>(hub_rows),
        static_cast<const int*>(hub_first), a.partial, a.out);
  return (int)cudaGetLastError();
}

// out: lanes a row, 16-byte loads (1/0), staged rows, dynamic shared
// memory bytes; the rows kernel's registers, local (spill) bytes and
// resident CTAs an SM (at its CTA size); the same of the chunk kernel; the
// hub kernel's registers; the SMs: for a call at width F with n_hot hot
// sources on a 16-byte aligned x.
int gnn_segment_occupancy(int F, int n_hot, int* out) {
  if (F < 1 || n_hot < 0 || n_hot > kRankMask + 1)
    return (int)cudaErrorInvalidValue;
  Plan p;
  int err = make_plan(F, n_hot, F % 4 == 0, &p);
  if (err) return err;
  cudaFuncAttributes ra, ca, ha;
  if ((err = (int)cudaFuncGetAttributes(&ra, p.rows))) return err;
  if ((err = (int)cudaFuncGetAttributes(&ca, p.chunks))) return err;
  if ((err = (int)cudaFuncGetAttributes(
           &ha, (const void*)segment_hubs_kernel)))
    return err;
  int rows = 0, chunks = 0, sms = 0;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &rows, p.rows, p.rows_threads, p.smem)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &chunks, p.chunks, kChunkThreads, p.smem)))
    return err;
  if ((err = device_attr(cudaDevAttrMultiProcessorCount, &sms))) return err;
  const int vals[12] = {p.lanes, p.vec, p.H, (int)p.smem,
                        ra.numRegs, (int)ra.localSizeBytes, rows,
                        ca.numRegs, (int)ca.localSizeBytes, chunks,
                        ha.numRegs, sms};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return (int)cudaSuccess;
}

}  // extern "C"
