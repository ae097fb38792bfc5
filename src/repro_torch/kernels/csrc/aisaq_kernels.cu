// Hand-written Hopper (sm_90a) kernels of the AiSAQ device search path.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface and bound with ctypes. Each extern "C" launcher
// enqueues on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// No library kernel (cuBLAS, CUTLASS GEMM, torch op) runs inside them.
//
// Chunk rows are int32 words, device_stride/4 per row: the vector first
// (float32 words, or uint8 packed four to a word), then the degree, the R
// neighbour ids, and the R*m neighbour PQ codes packed four to a word.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

#ifdef AISAQ_HOP_TRACE
// scripts/hop_trace.py builds with AISAQ_HOP_TRACE defined: thread 0 of the
// first kHopTraceCtas CTAs stamps %globaltimer (ns) at each phase of the hop
// into hop_trace[cta * 16 + phase]
constexpr int kHopTraceCtas = 1024;
__device__ unsigned long long hop_trace[kHopTraceCtas * 16];
#define HOP_STAMP(phase)                                                 \
  do {                                                                   \
    if (threadIdx.x == 0 && blockIdx.x < kHopTraceCtas) {                \
      unsigned long long t_;                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));             \
      hop_trace[blockIdx.x * 16 + (phase)] = t_;                         \
    }                                                                    \
  } while (0)
#else
#define HOP_STAMP(phase) \
  do {                   \
  } while (0)
#endif

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// fused_hop — replaces repro/kernels/chunk_adc.py:_hop_kernel (f32) and
// _hop_kernel_q8 (int8), the pallas_call in chunk_adc.py:fused_hop.
//
// One thread-block cluster per query, one CTA per frontier row (q, i):
// nq clusters of w CTAs (w <= 8), 8 consumer warps and one producer warp
// each. Each CTA copies its chunk row into shared memory with one
// cp.async.bulk (global -> shared, completing on an mbarrier) and emits the
// exact query-node distance (warp 0, warp sum, no block barrier), the R
// neighbour ids and the R neighbour ADC distances.
//
// f32 LUT: the query's (m, ks) LUT streams through shared memory in slabs
// of G subspaces (G*ks*4 B, 32 KB at G=32, ks=256), double-buffered. The
// producer warp of CTA rank 0 fetches each slab once for the cluster with
// cp.async.bulk...multicast::cluster, which writes it into every CTA's ring
// slot and completes each CTA's own "full" mbarrier. Each consumer warp of
// every CTA arrives on rank 0's "empty" mbarrier (through distributed
// shared memory) when it is done with a slot; rank 0's producer waits for
// all c*8 arrivals before it refills that slot. So each LUT byte leaves L2
// once per query and hop, not once per frontier row and lookup sector. The
// last slab may be short (any m).
//
// int8 LUT: quantization happens inside the kernel, bit-equal to
// ref.quantize_lut, and once per query: CTA rank bulk-copies its share, 1/c
// of the query's f32 LUT, into its shared memory (cp.async.bulk onto an
// mbarrier), the partial maxima meet in distributed shared memory around a
// cluster barrier (s = max|lut|), and each CTA quantizes its share as
// rintf((v / fmaxf(s, 1e-20f)) * 127) clamped to +-127 (IEEE divide, then
// multiply, no fast-math) and writes the bytes into every CTA of the
// cluster with 16-byte stores. The whole int8 LUT (m*ks B, 32 KB at SIFT1M
// widths) then sits in each CTA: no ring, and each SM takes in a quarter
// of the f32 path's LUT bytes. Sums are exact in int32, rescaled once by
// s * kInv127f, the float32 reciprocal of 127: the reference's `scale /
// 127.0` runs under jax.jit, where XLA multiplies by that rounded
// reciprocal (a true quotient differs in the last bit on ~4% of scales).
// The int8 hop reads the same f32 LUT bytes from global memory as the f32
// hop.
//
// Lookups: consumer warp k owns neighbours k, k+8, ..., lanes over G
// subspaces at a time. A lane reads its code byte from the staged row (the
// 32 lanes read 32 consecutive bytes of one neighbour: one wavefront, no
// bank conflict; lanes over neighbours would stride by m bytes, a 32-way
// conflict at m=128) and its LUT entry (random banks, ~3.5-way on average,
// unavoidable for a gather). A lane loads all its codes before its lookups,
// so the loads of a warp's neighbours overlap. Partial sums stay in
// registers across slabs and are reduced once per neighbour at the end.
// The plan (G, bytes) comes from chunk_adc.py:hop_plan and is checked here.
//
// Bound: bytes. Per query and hop it reads w rows (31.7 KB at SIFT1M
// widths), the query's LUT once (128 KB f32) and the query vector, and
// writes w*(2R+1) words. The lookups are w*R*m/32 warp-wide shared-memory
// gathers (896 per query at SIFT1M widths, ~3.5 wavefronts each). What
// holds the f32 hop back is filling shared memory: every CTA takes in the
// whole 128 KB LUT each hop. Tensor cores do not serve this kernel: the
// Pallas body's one-hot contraction on the MXU would do ks=256 times the
// arithmetic and first build the one-hot in shared memory; on Hopper the
// ADC is a gather.
// ---------------------------------------------------------------------------

constexpr int kHopConsumerWarps = 8;
constexpr int kHopThreads = (kHopConsumerWarps + 1) * 32;  // + producer warp
constexpr int kHopMaxNbrPerWarp = 16;    // R <= 8 * 16
constexpr int kHopMaxGroup = 32;         // lanes over a slab's subspaces
constexpr int kHopMaxCluster = 8;        // portable cluster size
constexpr int kHopHeaderBytes = 128;     // 5 mbarriers + the int8 partial max
// a wait that outlasts this many cycles (~2 s) is a protocol fault: trap
// (a launch failure the wrapper sees) rather than hang the card
constexpr long long kHopWaitCycles = 1ll << 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// arrive on the barrier at the same offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          remote)
      : "memory");
}

template <bool kClusterScope>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    if (kClusterScope) {
      asm volatile(
          "{ .reg .pred p; "
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2; selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    } else {
      asm volatile(
          "{ .reg .pred p; "
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
          "selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    }
    if (done) return;
    if (clock64() - t0 > kHopWaitCycles) __trap();
  }
}

// global -> own shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// global -> the same offset in every CTA of `mask`, completing on each
// CTA's barrier at `bar`'s offset
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// float32(1/127) = 0x3C010204: the int8 rescale is scale * kInv127f, as
// the jitted reference computes scale / 127.0 (ref.INV127)
constexpr float kInv127f = 0x1.020408p-7f;

// ref.quantize_lut's recipe for one entry: round(v / max(s, 1e-20) * 127)
// to nearest even, clamped to +-127
__device__ __forceinline__ int quantize_q8(float v, float s_div) {
  const float t = rintf(__fmul_rn(__fdiv_rn(v, s_div), 127.f));
  return (int)fminf(fmaxf(t, -127.f), 127.f);
}

template <bool kInt8>
__global__ void __launch_bounds__(kHopThreads)
    hop_kernel(const int32_t* __restrict__ words, long long n_rows,
               int stride_w, const int32_t* __restrict__ fids,
               const float* __restrict__ lut, int m, int ks, int group,
               const float* __restrict__ queries, int d, int u8vec, int mips,
               int off_ids_w, int off_pq_w, int R,
               float* __restrict__ exact_out, int32_t* __restrict__ ids_out,
               float* __restrict__ nbr_d_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  using AccT = typename std::conditional<kInt8, int, float>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();       // == w
  const int rank = (int)cluster.block_rank();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);    // [2], per CTA
  uint64_t* empty = full + 2;                            // [2], rank 0's
  uint64_t* rowbar = full + 4;
  unsigned int* pmax = reinterpret_cast<unsigned int*>(smem + 40);
  const int row_bytes = stride_w * 4;
  unsigned char* row = smem + kHopHeaderBytes;
  // f32: the ring of two slabs; int8: the whole quantized LUT
  float* slabs = reinterpret_cast<float*>(row + row_bytes);
  int8_t* lut8 = reinterpret_cast<int8_t*>(row + row_bytes);
  const int slab_floats = group * ks;

  const int slot = blockIdx.x;                   // q * w + i, i == rank
  const int q = slot / c;
  const int node = fids[slot];
  const bool valid = node >= 0;
  const long long r_i = node < 0 ? 0 : (node >= n_rows ? n_rows - 1 : node);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_slabs = (m + group - 1) / group;
  const float* lut_q = lut + (long long)q * m * ks;
  // int8: CTA rank quantizes the 16-entry groups [lo16, hi16) of the
  // query's LUT (m and ks are multiples of 4, so m*ks of 16), staged as
  // f32 after the int8 LUT
  const int n16 = m * ks / 16, per16 = (n16 + c - 1) / c;
  const int lo16 = min(n16, rank * per16), hi16 = min(n16, lo16 + per16);
  const uint32_t share_bytes = (uint32_t)(hi16 - lo16) * 64;
  const float4* share =
      reinterpret_cast<const float4*>(lut8 + ((m * ks + 15) & ~15));
  HOP_STAMP(0);

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(&empty[0], c * kHopConsumerWarps);
    mbar_init(&empty[1], c * kHopConsumerWarps);
    mbar_init(rowbar, 1);
    *pmax = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // this CTA's own copies need no other CTA: issue them at once
    if (valid) {
      mbar_expect_tx(rowbar, (uint32_t)row_bytes);
      bulk_load(row, words + r_i * (long long)stride_w, (uint32_t)row_bytes,
                rowbar);
    }
    if (kInt8 && share_bytes) {
      mbar_expect_tx(&full[0], share_bytes);
      bulk_load(const_cast<float4*>(share), lut_q + 16 * lo16, share_bytes,
                &full[0]);
    }
  }
  float scale = 0.f;
  if (kInt8) {
    __syncthreads();                   // the barriers and *pmax are set
    // this CTA's share of max|lut|, while the cluster starts up
    if (share_bytes) mbar_wait<false>(&full[0], 0);
    float mx = 0.f;
    for (int i = tid; i < 4 * (hi16 - lo16); i += kHopThreads) {
      const float4 v = share[i];
      mx = fmaxf(mx, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                           fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    mx = warp_max(mx);
    HOP_STAMP(1);
    // |x| >= 0, so the float order is the unsigned order of the bits
    if (lane == 0) atomicMax(pmax, __float_as_uint(mx));
    cluster.sync();
    HOP_STAMP(2);
    scale = warp_max(
        __uint_as_float(*cluster.map_shared_rank(pmax, lane % c)));
    // quantize this CTA's share once and write it into every CTA of the
    // cluster (distributed shared memory): the whole int8 LUT, m*ks bytes,
    // then sits in each CTA and the hop needs no slab ring
    const float s_div = fmaxf(scale, 1e-20f);
    for (int i = lo16 + tid; i < hi16; i += kHopThreads) {
      uint32_t packed[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = share[4 * (i - lo16) + k];
        packed[k] = (uint32_t)(quantize_q8(v.x, s_div) & 0xFF) |
                    (uint32_t)(quantize_q8(v.y, s_div) & 0xFF) << 8 |
                    (uint32_t)(quantize_q8(v.z, s_div) & 0xFF) << 16 |
                    (uint32_t)(quantize_q8(v.w, s_div) & 0xFF) << 24;
      }
      const uint4 group16 = make_uint4(packed[0], packed[1], packed[2],
                                       packed[3]);
      for (int dst = 0; dst < c; ++dst)     // one 16-byte store a CTA
        *reinterpret_cast<uint4*>(
            cluster.map_shared_rank(lut8 + 16 * i, dst)) = group16;
    }
  }
  HOP_STAMP(3);
  cluster.sync();   // f32: every barrier exists; int8: the LUT is in place
  HOP_STAMP(4);

  if (warp == kHopConsumerWarps) {
    // ---- f32 producer warp: lane 0 issues the slab copies ------------------
    auto issue = [&](int s) {
      const int b = s & 1;
      const int g = min(group, m - s * group);
      const uint32_t bytes = (uint32_t)g * ks * 4;
      mbar_expect_tx(&full[b], bytes);
      if (rank == 0)
        bulk_load_multicast(slabs + b * slab_floats,
                            lut_q + (long long)s * group * ks, bytes,
                            &full[b], (uint16_t)((1u << c) - 1u));
    };
    if (!kInt8 && lane == 0) {
      for (int s = 0; s < n_slabs; ++s) {
        if (s >= 2) {
          const uint32_t par = ((s - 2) >> 1) & 1;
          mbar_wait<false>(&full[s & 1], par);  // own slot's slab s-2 landed
          if (rank == 0)                        // every CTA is done with it
            mbar_wait<true>(&empty[s & 1], par);
        }
        issue(s);
      }
    }
    __syncwarp();
  } else {
    // ---- consumer warps ---------------------------------------------------
    const float s127 = __fmul_rn(scale, kInv127f);
    const int32_t* row_w = reinterpret_cast<const int32_t*>(row);
    const long long out0 = (long long)slot * R;
    if (valid) mbar_wait<false>(rowbar, 0);
    HOP_STAMP(5);

    // exact distance: one warp, one warp reduction
    if (warp == 0) {
      const float* qv = queries + (long long)q * d;
      float acc = 0.f;
      if (valid) {
        for (int t = lane; t < d; t += 32) {
          const float v = u8vec ? (float)row[t] : __int_as_float(row_w[t]);
          const float qq = __ldg(qv + t);
          if (mips) {
            acc += v * qq;
          } else {
            const float df = v - qq;
            acc += df * df;
          }
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) exact_out[slot] = valid ? (mips ? -acc : acc) : INFINITY;
    }
    // neighbour ids
    for (int r = tid; r < R; r += kHopConsumerWarps * 32) {
      const int id = valid ? row_w[off_ids_w + r] : -1;
      ids_out[out0 + r] = id >= 0 ? id : -1;
    }

    // inline-PQ ADC: lanes over `group` subspaces at a time
    const unsigned char* codes = row + off_pq_w * 4;
    AccT acc[kHopMaxNbrPerWarp];
#pragma unroll
    for (int k = 0; k < kHopMaxNbrPerWarp; ++k) acc[k] = 0;
    for (int s = 0; s < n_slabs; ++s) {
      const int b = s & 1;
      if (!kInt8) mbar_wait<false>(&full[b], (s >> 1) & 1);
      if (s < 4) HOP_STAMP(9 + s);
      const int j0 = s * group;
      if (valid && lane < min(group, m - j0)) {
        const unsigned char* cj = codes + j0 + lane;
        const float* lrow = slabs + b * slab_floats + lane * ks;
        const int8_t* lrow8 = lut8 + (j0 + lane) * ks;
        // all code loads first, then all lookups: the warp's neighbours
        // are independent, so their loads overlap
        int code[kHopMaxNbrPerWarp];
#pragma unroll
        for (int k = 0; k < kHopMaxNbrPerWarp; ++k) {
          const int r = warp + k * kHopConsumerWarps;
          code[k] = r < R ? min((int)cj[r * m], ks - 1) : 0;
        }
#pragma unroll
        for (int k = 0; k < kHopMaxNbrPerWarp; ++k) {
          if (warp + k * kHopConsumerWarps < R) {
            if (kInt8) {
              acc[k] += lrow8[code[k]];
            } else {
              acc[k] += lrow[code[k]];
            }
          }
        }
      }
      __syncwarp();
      if (!kInt8 && s + 2 < n_slabs && lane == 0)
        mbar_arrive_remote(&empty[b], 0);
    }
    HOP_STAMP(6);
    // all sums at once, so the shuffles of the neighbours interleave
#pragma unroll
    for (int k = 0; k < kHopMaxNbrPerWarp; ++k) acc[k] = warp_sum(acc[k]);
#pragma unroll
    for (int k = 0; k < kHopMaxNbrPerWarp; ++k) {
      const int r = warp + k * kHopConsumerWarps;
      if (r < R && lane == 0) {
        const bool ok = valid && row_w[off_ids_w + r] >= 0;
        nbr_d_out[out0 + r] =
            ok ? (kInt8 ? (float)acc[k] * s127 : (float)acc[k]) : INFINITY;
      }
    }
  }
  HOP_STAMP(7);
  // f32: no CTA leaves while a multicast or a remote arrival may still
  // address its shared memory (int8's remote writes ended at the barrier
  // above)
  if (!kInt8) cluster.sync();
  HOP_STAMP(8);
}

// ---------------------------------------------------------------------------
// pq_lut — replaces repro/kernels/pq_lut.py:_lut_kernel (pallas_call in
// pq_lut.py:pq_lut).
//
// out[q, j, k] = ||q_j||^2 - 2 q_j.c_jk + ||c_jk||^2 (l2) or -q_j.c_jk
// (mips), q_j the j-th dsub-slab of query q. Bound: bytes. The kernel writes
// nq*m*ks*4 B (128 KB a query at SIFT1M widths) from a few KB of input: it
// is a stream of stores.
//
// A CTA of 128 threads owns a block of jb subspaces and a block of qb
// queries (grid: query blocks x subspace blocks). It copies the block's
// centroids (contiguous, jb*ks*dsub floats: 2-16 KB at ks = 256) into
// shared memory with coalesced 16-byte loads, and the block's query slabs
// beside them. Thread (jl, tk) then owns
// the four centroids k0 = 4 tk .. k0+3 of subspace j0 + jl: it takes their
// dsub values into registers (dsub 16-byte shared loads, conflict-free) and
// sums their norms ||c_jk||^2 once; ||q_j||^2 is summed once per (q, j)
// into shared memory. The thread then walks the CTA's queries, reading each
// slab by broadcast, and writes each query's four entries as one 16-byte
// store: a warp writes 512 contiguous bytes, with the default L2 policy, so
// the first hop finds its LUT in L2. tpr, the threads of a subspace, is a
// power of two, so the index math is shifts and masks in 32 bits; only an
// output row's address is 64-bit.
//
// Numerics are the plain version's: cross, qn and cn each accumulate over
// e = 0..dsub-1 in order, one FMA a step. No tensor cores: the contraction
// is dsub (<= 8 at the repo's widths) deep, and TF32 would round the LUT
// whose exact ties the int8 path depends on.
// DSUB is dsub at compile time (1, 2, 4, 5 and 8, the repo's widths, where
// ks % 4 == 0 and the centroids are 16-byte aligned); DSUB = 0 takes any
// dsub and reads the centroid values from global memory (L1) in the loop.
// ---------------------------------------------------------------------------

constexpr int kLutThreads = 128;      // jb * tpr
constexpr int kLutMaxQb = 8;          // queries a CTA
constexpr int kLutMaxSmem = 48 * 1024;

template <int DSUB>
__global__ void __launch_bounds__(kLutThreads)
    pq_lut_kernel(const float* __restrict__ qs, int nq, int d,
                  const float* __restrict__ cent, int m, int ks, int dsub,
                  int lg_tpr, int qb, int mips, int vec_store,
                  float* __restrict__ out) {
  constexpr bool kStaged = DSUB > 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int jb = kLutThreads >> lg_tpr;
  const int jl = t >> lg_tpr;
  const int k0 = (t & ((1 << lg_tpr) - 1)) * 4;
  const int j0 = blockIdx.y * jb;
  const int jn = min(jb, m - j0);
  const int j = j0 + jl;
  const int q0 = blockIdx.x * qb;
  const int nqb = min(qb, nq - q0);
  const bool active = jl < jn && k0 < ks;
  // shared: [kStaged: the jb*ks*dsub centroids] [qb][jb*dsub] query
  // slabs, [qb][jb] their norms
  float* cstage = reinterpret_cast<float*>(smem);
  float* qslab = cstage + (kStaged ? jb * ks * DSUB : 0);
  float* qnorm = qslab + qb * jb * dsub;
  // Thread i < nqb*jb loads slab i = (ql, jj) of the block's queries and
  // sums its ||q_j||^2; every thread copies its share of the centroids. All
  // of a thread's loads are issued before its first store to shared
  // memory, so their latencies overlap, and one barrier ends the staging.
  const int lg_jb = __ffs(jb) - 1;              // jb is a power of two
  const bool qload = t < nqb * jb && (t & (jb - 1)) < jn;
  const float* qa =
      qs + (q0 + (t >> lg_jb)) * d + (j0 + (t & (jb - 1))) * dsub;
  float qv[kStaged ? DSUB : 1];
  if constexpr (kStaged) {
    if (qload) {
#pragma unroll
      for (int e = 0; e < DSUB; ++e) qv[e] = __ldg(qa + e);
    }
    // the block's centroids are contiguous: coalesced 16-byte loads, at
    // most DSUB a thread (jb * ks <= 4 * kLutThreads)
    const int n4 = jn * ks * DSUB / 4;
    const float4* src =
        reinterpret_cast<const float4*>(cent + (size_t)j0 * ks * DSUB);
    float4 cv[DSUB];
#pragma unroll
    for (int r = 0; r < DSUB; ++r)
      if (t + r * kLutThreads < n4) cv[r] = __ldg(src + t + r * kLutThreads);
#pragma unroll
    for (int r = 0; r < DSUB; ++r)
      if (t + r * kLutThreads < n4)
        reinterpret_cast<float4*>(cstage)[t + r * kLutThreads] = cv[r];
  }
  if (qload) {
    float qn = 0.f;
    if constexpr (kStaged) {
#pragma unroll
      for (int e = 0; e < DSUB; ++e) {
        qslab[t * DSUB + e] = qv[e];
        qn += qv[e] * qv[e];
      }
    } else {
      for (int e = 0; e < dsub; ++e) {
        const float x = __ldg(qa + e);
        qslab[t * dsub + e] = x;
        qn += x * x;
      }
    }
    qnorm[t] = qn;
  }
  // blocks of more slabs than threads (ks <= 16 at qb = 8)
  for (int i = t + kLutThreads; i < nqb * jb; i += kLutThreads) {
    if ((i & (jb - 1)) >= jn) continue;
    const float* a =
        qs + (q0 + (i >> lg_jb)) * d + (j0 + (i & (jb - 1))) * dsub;
    float qn = 0.f;
    for (int e = 0; e < dsub; ++e) {
      const float x = __ldg(a + e);
      qslab[i * dsub + e] = x;
      qn += x * x;
    }
    qnorm[i] = qn;
  }
  __syncthreads();
  // the thread's four centroids in registers, c[kk * DSUB + e]
  float c[kStaged ? 4 * DSUB : 1];
  float cn[4] = {0.f, 0.f, 0.f, 0.f};
  const float* cbase = cent + ((size_t)j * ks + k0) * dsub;
  if (active) {
    if constexpr (kStaged) {
      const float4* c4 =
          reinterpret_cast<const float4*>(cstage + (jl * ks + k0) * DSUB);
#pragma unroll
      for (int i = 0; i < DSUB; ++i) {
        const float4 v = c4[i];
        c[4 * i] = v.x;
        c[4 * i + 1] = v.y;
        c[4 * i + 2] = v.z;
        c[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < DSUB; ++e)
          cn[kk] += c[kk * DSUB + e] * c[kk * DSUB + e];
    } else {
      for (int kk = 0; kk < 4 && k0 + kk < ks; ++kk)
        for (int e = 0; e < dsub; ++e) {
          const float b = __ldg(cbase + kk * dsub + e);
          cn[kk] += b * b;
        }
    }
  }
  for (int ql = 0; ql < nqb; ++ql) {
    float v[4];
    if (active) {
      const float* a = qslab + (ql * jb + jl) * dsub;
      float cross[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kStaged) {
#pragma unroll
        for (int e = 0; e < DSUB; ++e) {
          const float x = a[e];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) cross[kk] += x * c[kk * DSUB + e];
        }
      } else {
        for (int e = 0; e < dsub; ++e) {
          const float x = a[e];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (k0 + kk < ks) cross[kk] += x * __ldg(cbase + kk * dsub + e);
        }
      }
      const float qn = qnorm[ql * jb + jl];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        v[kk] = mips ? -cross[kk] : qn - 2.f * cross[kk] + cn[kk];
    }
    if (active) {
      float* row = out + ((size_t)(q0 + ql) * m + j) * ks;
      if (vec_store) {
        *reinterpret_cast<float4*>(row + k0) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (k0 + kk < ks) row[k0 + kk] = v[kk];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// rerank — replaces repro/kernels/rerank.py:_rerank_kernel (pallas_call in
// rerank.py:rerank).
//
// Exact distances in the expanded form, as the TPU kernel computes them:
// ||c||^2 - 2 c.q + ||q||^2 (l2), -c.q (mips). One template, four sources
// of the candidate vectors:
//   kRrDense     f32 (nq, C, d), or (C, d) shared by all queries (qstride
//                0), rows 16-byte aligned (d % 4 == 0): float4 loads;
//   kRrDenseAny  the same at any d or alignment: scalar loads;
//   kRrRowsF32   chunk-table rows by id (rerank_rows): the vector's float32
//                words at the row's start; float4 loads (rows are 128-byte
//                aligned, and any d's last float4 ends inside the row);
//   kRrRowsU8    the same for uint8 vectors packed four to a word: one
//                32-bit (uchar4) load a lane.
// Rows: an id clamps to n_rows-1 above, and an id < 0 gives +inf and loads
// nothing (what the engine's clamp and torch.where did around the gather).
//
// Bound: bytes — each candidate vector is read once, for at most 2 flops a
// byte. One warp a candidate, lane l holding elements 4(32p + l) .. +3 of
// pass p, so a warp-wide load covers 512 contiguous bytes (f32); d = 128 is
// one float4 a lane, KILT's d = 1024 eight. rerank_u(source) candidates
// are in flight a warp (unrolled, independent loads). The query's elements
// sit in registers (NP passes: the whole query up to d = 128 NP, longer
// ones in tiles of NP passes) and each warp sums ||q||^2 from them: once
// for its rerank_u(source) candidates, so once a candidate from a dense
// tensor. Summing it once a query needs one CTA a query; that layout
// measured slower (PERF.md §6: the rows of 64 queries sit on 64 SMs, whose
// loads in flight then bound the call), so these CTAs stay small and many.
// 2-D grid (candidate blocks x queries) and 32-bit index math; 64-bit only
// for a row's address (a 1M-row table spans 7.9 GB). No tensor cores:
// these are nq independent GEMVs, memory-bound.
// ---------------------------------------------------------------------------

constexpr int kRrWarps = 4;
constexpr int kRrThreads = kRrWarps * 32;
constexpr int kRrMaxGridY = 65535;
enum { kRrDense = 0, kRrDenseAny = 1, kRrRowsF32 = 2, kRrRowsU8 = 3 };
// candidates in flight a warp: two by id (their id loads overlap), one
// from a dense tensor (more warps in flight measured faster there)
__host__ __device__ constexpr int rerank_u(int src) {
  return src >= kRrRowsF32 ? 2 : 1;
}

struct RerankArgs {
  const float* q;           // (nq, d)
  const void* src;          // dense: f32 candidates; rows: the i32 table
  const int32_t* ids;       // rows: (nq, C)
  long long qstride;        // dense: floats from one query's set to the next
  long long n_rows;
  int stride_w, nq, C, d, mips;
  float* out;               // (nq, C)
};

// elements 4s .. 4s+3 of the candidate at base, 0 past d (4s < d)
template <int kSrc>
__device__ __forceinline__ float4 rr_load(const void* base, int s, int d) {
  const int n = d - 4 * s;
  float4 v;
  if constexpr (kSrc == kRrRowsU8) {
    const unsigned int w = __ldg(static_cast<const unsigned int*>(base) + s);
    v = make_float4((float)(w & 0xffu), (float)((w >> 8) & 0xffu),
                    (float)((w >> 16) & 0xffu), (float)(w >> 24));
  } else if constexpr (kSrc == kRrDenseAny) {
    const float* p = static_cast<const float*>(base) + 4 * s;
    return make_float4(__ldg(p), n > 1 ? __ldg(p + 1) : 0.f,
                       n > 2 ? __ldg(p + 2) : 0.f,
                       n > 3 ? __ldg(p + 3) : 0.f);
  } else {
    v = __ldg(static_cast<const float4*>(base) + s);
  }
  if (n < 4) {                 // the row's next words are not the vector's
    v.w = 0.f;
    if (n < 3) v.z = 0.f;
    if (n < 2) v.y = 0.f;
  }
  return v;
}

template <int kSrc, int NP>
__global__ void __launch_bounds__(kRrThreads)
    rerank_kernel(const RerankArgs a) {
  constexpr bool kRows = kSrc == kRrRowsF32 || kSrc == kRrRowsU8;
  constexpr int kRrU = rerank_u(kSrc);
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * kRrWarps + (threadIdx.x >> 5)) * kRrU;
  if (c0 >= a.C) return;                            // warp-uniform
  const int nslot = (a.d + 3) >> 2;                 // 4-element slots
  for (int qi = blockIdx.y; qi < a.nq; qi += gridDim.y) {
    const void* base[kRrU];
    bool ok[kRrU];
#pragma unroll
    for (int u = 0; u < kRrU; ++u) {
      const int ci = c0 + u;
      ok[u] = ci < a.C;
      if constexpr (kRows) {
        const int id = ok[u] ? __ldg(a.ids + qi * a.C + ci) : -1;
        ok[u] = id >= 0;
        const long long row = ok[u] ? min((long long)id, a.n_rows - 1) : 0;
        base[u] = static_cast<const int32_t*>(a.src) + row * a.stride_w;
      } else {
        base[u] = static_cast<const float*>(a.src) + qi * a.qstride +
                  (long long)(ok[u] ? ci : 0) * a.d;
      }
    }
    const float* qrow = a.q + qi * a.d;
    float cross[kRrU], cn[kRrU], qn = 0.f;
#pragma unroll
    for (int u = 0; u < kRrU; ++u) cross[u] = cn[u] = 0.f;
    for (int s0 = 0; s0 < nslot; s0 += 32 * NP) {   // one tile for d <= 128 NP
      float4 qr[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int s = s0 + 32 * p + lane;
        qr[p] = s < nslot ? rr_load<kRrDenseAny>(qrow, s, a.d)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        qn += qr[p].x * qr[p].x;
        qn += qr[p].y * qr[p].y;
        qn += qr[p].z * qr[p].z;
        qn += qr[p].w * qr[p].w;
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int s = s0 + 32 * p + lane;
        if (s >= nslot) break;
#pragma unroll
        for (int u = 0; u < kRrU; ++u) {
          if (!ok[u]) continue;
          const float4 v = rr_load<kSrc>(base[u], s, a.d);
          cross[u] += v.x * qr[p].x;
          cross[u] += v.y * qr[p].y;
          cross[u] += v.z * qr[p].z;
          cross[u] += v.w * qr[p].w;
          cn[u] += v.x * v.x;
          cn[u] += v.y * v.y;
          cn[u] += v.z * v.z;
          cn[u] += v.w * v.w;
        }
      }
    }
    qn = warp_sum(qn);
    float my_cross = 0.f, my_cn = 0.f;
    bool my_ok = false;
#pragma unroll
    for (int u = 0; u < kRrU; ++u) {
      const float x = warp_sum(cross[u]), y = warp_sum(cn[u]);
      if (lane == u) {
        my_cross = x;
        my_cn = y;
        my_ok = ok[u];
      }
    }
    if (lane < kRrU && c0 + lane < a.C)
      a.out[qi * a.C + c0 + lane] =
          !my_ok ? INFINITY
                 : (a.mips ? -my_cross : my_cn - 2.f * my_cross + qn);
  }
}

// ---------------------------------------------------------------------------
// pq_adc — replaces repro/kernels/pq_adc.py:_adc_kernel (f32 LUT, the
// pallas_call in pq_adc.py:pq_adc) and _adc_q8_kernel (int8 LUT, the
// pallas_call in pq_adc.py:pq_adc_q8).
//
// out[q, r] = sum_j lut[q, j, codes[r, j]] over n rows of m code bytes (u8)
// or words (i32), codes clamped to [0, ks). f32 sums run in order
// j = 0..m-1; int8 sums are exact in int32 and rescaled once per query by
// scale * kInv127f. The Pallas bodies contract a one-hot of the codes with
// the LUT on the MXU; on Hopper the ADC is a gather. Tensor cores do not
// pay here: the one-hot form costs 2*n*m*ks*nq operations (67 G at nq=8,
// n=1M, m=16), ~34 us even at the int8 wgmma rate before the one-hot is
// built, and TF32 would round the f32 LUT.
//
// Persistent grid, one wave: each CTA (8 consumer warps and a producer
// warp) walks row tiles of T rows strided by the grid. For each group of
// G <= GP queries it stages the group's LUTs in shared memory interleaved
// as table[j][code][GP] (queries padded to GP), so one gather fetches a
// row's entry for every query of the group: GP*4 B in f32 (two lanes a
// row at GP=8, a 16-byte load each), GP B in int8 (one 8-byte load at
// GP=8). The codes then leave HBM once per query group, not once per
// query. A thread owns an entry (j, code), reads its G values with
// coalesced loads, U entries at a time, and stores them as one vector.
// int8 tables are quantized here, bit-equal to ref.quantize_lut, by a
// cluster of kAdcCluster CTAs: each takes a quarter of the entries, the
// partial max|lut| per query meet in distributed shared memory, and each
// CTA quantizes its quarter once into every CTA's table; so pq_adc_q8 is
// one kernel and no torch op. The table holds q + 128 as a byte and a
// lookup adds query pairs into the 16-bit halves of a word (m <= 256 at
// GP > 1); the bias comes off once a row. The plain f32 LUT (GP=1) comes
// by one cp.async.bulk. Where one query's LUT does not fit beside the
// ring, the kGlobal variant reads the f32 LUT through __ldg (int8:
// quantizing each entry it reads).
//
// Code tiles (T*m*sizeof(code) bytes, T a multiple of 16, so each tile
// start is 16-byte aligned) reach a ring of 2-3 shared-memory slots by one
// cp.async.bulk each, issued by the producer warp onto the slot's "full"
// mbarrier; each consumer warp arrives on the slot's "empty" mbarrier when
// it is done. The partial last tile, and every tile when the codes' base
// is not 16-byte aligned, the consumers copy into the slot themselves. A
// thread takes two rows a pass (lane i -> row r0 + i, so the stores
// coalesce) and u8 codes 16, 4 or (any m) 4 at a time from one shared
// load. Lookups carry no branch (a row past the tile's end looks up code
// 0 and is not stored), so a thread's loads issue together.
//
// Bound: bytes at nq=1 (each code byte read once, one f32 written per
// output). At nq=8 the gathers bound it: random banks cost ~3.5 wavefronts
// a warp-wide f32 lookup, ~8 a 16-byte gather of 4 entries a phase, ~6 an
// 8-byte one. The plan (G, GP, T, ring depth, cluster, bytes) comes from
// pq_adc.py:adc_plan and is checked here by adc_plan_ok.
// ---------------------------------------------------------------------------

constexpr int kAdcConsumerWarps = 8;
constexpr int kAdcConsumers = kAdcConsumerWarps * 32;
constexpr int kAdcThreads = kAdcConsumers + 32;   // + the producer warp
// 3 full + 3 empty mbarriers, 16 maxima, the LUT's mbarrier, and the
// cluster's partial maxima [kAdcCluster][16]
constexpr int kAdcHeaderBytes = 384;
constexpr int kAdcCluster = 4;   // CTAs that stage an int8 table together
constexpr int kAdcMaxGroup = 16;

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// a barrier of the consumer warps only (the producer warp runs ahead)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kAdcConsumers) : "memory");
}

// add the GP entries at e (one query each) to acc
template <int GP>
__device__ __forceinline__ void adc_add(float (&acc)[GP], const float* e) {
  if constexpr (GP == 1) {
    acc[0] += e[0];
  } else if constexpr (GP == 2) {
    const float2 v = *reinterpret_cast<const float2*>(e);
    acc[0] += v.x;
    acc[1] += v.y;
  } else {
#pragma unroll
    for (int i = 0; i < GP / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(e)[i];
      acc[4 * i] += v.x;
      acc[4 * i + 1] += v.y;
      acc[4 * i + 2] += v.z;
      acc[4 * i + 3] += v.w;
    }
  }
}

// int8 tables hold q + 128 as a byte (1..255): a lookup adds query pairs
// into the two 16-bit halves of a word (two byte permutes and two adds
// for four queries), exact while m <= 256 (255 * 256 < 65536); the bias
// comes off once a row (adc_q8_sum)
template <int GP>
__device__ __forceinline__ void adc_add(uint32_t (&acc)[GP > 1 ? GP / 2 : 1],
                                        const int8_t* e) {
  if constexpr (GP == 1) {
    acc[0] += *reinterpret_cast<const uint8_t*>(e);
  } else if constexpr (GP == 2) {
    acc[0] += __byte_perm(*reinterpret_cast<const uint16_t*>(e), 0, 0x4140);
  } else {
    uint32_t w[GP / 4];
    if constexpr (GP == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(e);
    } else if constexpr (GP == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(e);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(e);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < GP / 4; ++i) {
      acc[2 * i] += __byte_perm(w[i], 0, 0x4140);
      acc[2 * i + 1] += __byte_perm(w[i], 0, 0x4342);
    }
  }
}

// the int32 sum of query g from the packed, biased sums of m lookups
template <int GP>
__device__ __forceinline__ int adc_q8_sum(
    const uint32_t (&acc)[GP > 1 ? GP / 2 : 1], int g, int m) {
  const uint32_t v = GP == 1 ? acc[0] : (acc[g / 2] >> 16 * (g % 2)) & 0xFFFFu;
  return (int)v - 128 * m;
}

// store a staged entry's GP values (one query each) at dst
template <int GP>
__device__ __forceinline__ void adc_put(float* dst, const float (&v)[GP]) {
  if constexpr (GP == 1) {
    dst[0] = v[0];
  } else if constexpr (GP == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < GP / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

template <int GP>
__device__ __forceinline__ void adc_put(int8_t* dst, const int (&v)[GP]) {
  uint32_t w[(GP + 3) / 4] = {};
#pragma unroll
  for (int g = 0; g < GP; ++g)
    w[g / 4] |= (uint32_t)(v[g] & 0xFF) << 8 * (g % 4);
  if constexpr (GP == 1) {
    *reinterpret_cast<uint8_t*>(dst) = (uint8_t)w[0];
  } else if constexpr (GP == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)w[0];
  } else if constexpr (GP == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else if constexpr (GP == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Calls f(e, v) for this consumer's entries e in [e_lo, e_hi) of the
// group's LUTs (E entries a query), v[g] the entry of query g (0 past the
// group's gq queries): U entries a turn, all their loads issued before the
// first use, so a thread keeps U*GP loads from L2 in flight instead of one.
template <int GP, int U, typename F>
__device__ __forceinline__ void for_entries(const float* lq, long long e_lo,
                                            long long e_hi, long long E,
                                            int gq, F&& f) {
  for (long long e0 = e_lo + threadIdx.x; e0 < e_hi;
       e0 += (long long)U * kAdcConsumers) {
    float v[U][GP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = e0 + (long long)u * kAdcConsumers;
#pragma unroll
      for (int g = 0; g < GP; ++g)
        v[u][g] = g < gq && e < e_hi ? __ldg(lq + g * E + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = e0 + (long long)u * kAdcConsumers;
      if (e < e_hi) f(e, v[u]);
    }
  }
}

// store a staged entry into the tables of all C CTAs of the cluster (its
// own directly, the others through distributed shared memory)
template <int GP, typename T, typename V>
__device__ __forceinline__ void adc_put_all(cg::cluster_group& cluster, int C,
                                            int rank, T* dst,
                                            const V (&v)[GP]) {
  adc_put<GP>(dst, v);
  for (int d = 1; d < C; ++d)
    adc_put<GP>(cluster.map_shared_rank(dst, (rank + d) % C), v);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The consumers copy a tile into its ring slot themselves where no bulk
// copy can: the partial last tile (its size need not be a multiple of 16),
// and every tile of a table whose base is not 16-byte aligned. 16-byte
// loads where the source allows them, bytes otherwise; the loads of a
// thread are independent, so they overlap.
__device__ __forceinline__ void fill_slot(unsigned char* dst,
                                          const unsigned char* src,
                                          int nbytes) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nvec = nbytes / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < nvec; i += kAdcConsumers)
      d4[i] = __ldg(s4 + i);
    done = nvec * 16;
  }
#pragma unroll 8
  for (int i = done + threadIdx.x; i < nbytes; i += kAdcConsumers)
    dst[i] = __ldg(src + i);
}

// one lookup: the entries of code `code` in a subspace whose table starts
// at tj (GP entries a code; this lane's share of the group's queries), or
// (kGlobal) whose f32 LUT row of query q0 starts at gj in global memory.
// Offsets are 32-bit: a staged table is at most 227 KB.
template <bool kInt8, int GP, int GQ, int NA, bool kGlobal, typename AccT,
          typename EntT>
__device__ __forceinline__ void adc_lookup(AccT (&acc)[NA], int code,
                                           const EntT* tj, const float* gj,
                                           float sdiv0) {
  if constexpr (kGlobal) {
    const float v = __ldg(gj + code);
    if constexpr (kInt8) {
      acc[0] += quantize_q8(v, sdiv0);
    } else {
      acc[0] += v;
    }
  } else if constexpr (kInt8) {
    adc_add<GP>(acc, tj + code * GP);
  } else {
    adc_add<GQ>(acc, tj + code * GP);
  }
}

// the lookups of subspaces j0..j0+3 of RB rows, codes packed a byte each
// in cw[k]. A row past the tile's end has mask[k] = 0: it looks up code 0
// (all its lanes read one address, a single wavefront) and is not stored;
// no branch, so the loads of all rows and subspaces issue together.
// kCheck: the last chunk of an m that is not a multiple of 4.
template <bool kInt8, int GP, int GQ, int NA, int RB, bool kGlobal,
          bool kCheck, typename AccT, typename EntT>
__device__ __forceinline__ void adc_take4(AccT (&acc)[RB][NA],
                                          const uint32_t (&cw)[RB],
                                          const uint32_t (&mask)[RB], int j0,
                                          int m, int ks, const EntT* tab,
                                          const float* glut, float sdiv0) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (!kCheck || j0 + b < m) {
      const int jk = (j0 + b) * ks;
      const EntT* tj = tab + jk * GP;
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int code = min((int)((cw[k] >> 8 * b) & mask[k]), ks - 1);
        adc_lookup<kInt8, GP, GQ, NA, kGlobal>(acc[k], code, tj, glut + jk,
                                               sdiv0);
      }
    }
  }
}

// One tile of `rows` rows staged in a ring slot (row r at codes_rows +
// r*m). table: the group's staged LUT, or (kGlobal) query q0's f32 LUT in
// global memory. Writes out[(q0 + g) * n + r0 + r] for the gq queries of
// the group. A lane takes RB rows; f32 at GP=8 puts two lanes on a row,
// each gathering 16 of the entry's 32 bytes (4 queries): a phase of a
// 16-byte gather then holds 4 random entries instead of 8, ~8 wavefronts
// a warp instead of ~13, for 16 rows instead of 32 (1.5x fewer a row).
template <bool kInt8, typename CodeT, int GP, bool kGlobal>
__device__ __forceinline__ void adc_tile(
    const CodeT* codes_rows, int rows, int m, int ks, const void* table,
    const float* glut, float sdiv0, const float (&s127)[GP], float* out,
    long long n, long long r0, int q0, int gq) {
  // f32 sums; int8 from global memory: signed int sums; int8 tables:
  // packed, biased 16-bit sums of query pairs (adc_add)
  using AccT = typename std::conditional<
      !kInt8, float,
      typename std::conditional<kGlobal, int, uint32_t>::type>::type;
  using EntT = typename std::conditional<kInt8, int8_t, float>::type;
  constexpr int QS = !kInt8 && GP == 8 ? 2 : 1;   // lanes a row
  constexpr int GQ = GP / QS;                      // queries a lane
  constexpr int NA = kInt8 && !kGlobal && GP > 1 ? GP / 2 : GQ;  // sums
  constexpr int RB = 2;                            // rows a lane
  constexpr int kStep = kAdcConsumers / QS;        // rows a CTA pass
  constexpr bool kU8 = sizeof(CodeT) == 1;
  const int half = threadIdx.x % QS;
  const EntT* tab = static_cast<const EntT*>(table) + half * GQ;
  for (int rb = threadIdx.x / QS; rb < rows; rb += RB * kStep) {
    AccT acc[RB][NA];
#pragma unroll
    for (int k = 0; k < RB; ++k)
#pragma unroll
      for (int g = 0; g < NA; ++g) acc[k][g] = 0;
    int rr[RB];
    bool ok[RB];
    uint32_t mask[RB];     // the code bits a row keeps: none past the end
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      ok[k] = rb + k * kStep < rows;
      rr[k] = ok[k] ? rb + k * kStep : rows - 1;
      mask[k] = ok[k] ? 0xFFu : 0u;
    }
    if constexpr (kU8) {
      const uint8_t* rows8 = reinterpret_cast<const uint8_t*>(codes_rows);
      uint32_t cw[RB];
      auto take4 = [&](const uint32_t(&w)[RB], int j0) {
        adc_take4<kInt8, GP, GQ, NA, RB, kGlobal, false>(acc, w, mask, j0, m,
                                                         ks, tab, glut, sdiv0);
      };
      if ((m & 15) == 0) {
        // rows 16-byte aligned: one vector load a row takes 16 codes
        for (int j0 = 0; j0 < m; j0 += 16) {
          uint4 c[RB];
#pragma unroll
          for (int k = 0; k < RB; ++k)
            c[k] = *reinterpret_cast<const uint4*>(rows8 + rr[k] * m + j0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int k = 0; k < RB; ++k)
              cw[k] = i == 0 ? c[k].x : i == 1 ? c[k].y : i == 2 ? c[k].z
                                                                : c[k].w;
            take4(cw, j0 + 4 * i);
          }
        }
      } else if ((m & 3) == 0) {
        // rows word-aligned: one word load takes four codes
        for (int j0 = 0; j0 < m; j0 += 4) {
#pragma unroll
          for (int k = 0; k < RB; ++k)
            cw[k] = *reinterpret_cast<const uint32_t*>(rows8 + rr[k] * m + j0);
          take4(cw, j0);
        }
      } else {
        // any m: aligned word loads and a funnel shift (the slot's 16
        // bytes of slack cover the last row's extra word)
        const uint32_t* w[RB];
        uint32_t lo[RB];
        int sh[RB];
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int off = rr[k] * m;
          w[k] = reinterpret_cast<const uint32_t*>(rows8 + (off & ~3));
          sh[k] = (off & 3) * 8;
          lo[k] = w[k][0];
        }
        for (int j0 = 0; j0 < m; j0 += 4) {
#pragma unroll
          for (int k = 0; k < RB; ++k) {
            const uint32_t hi = w[k][j0 / 4 + 1];
            cw[k] = __funnelshift_r(lo[k], hi, sh[k]);
            lo[k] = hi;
          }
          if (j0 + 4 <= m) {
            take4(cw, j0);
          } else {   // the last, short chunk
            adc_take4<kInt8, GP, GQ, NA, RB, kGlobal, true>(
                acc, cw, mask, j0, m, ks, tab, glut, sdiv0);
          }
        }
      }
    } else {
      for (int j = 0; j < m; ++j) {
        const EntT* tj = tab + j * ks * GP;
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int c = codes_rows[rr[k] * m + j];
          adc_lookup<kInt8, GP, GQ, NA, kGlobal>(
              acc[k], ok[k] ? min(max(c, 0), ks - 1) : 0, tj, glut + j * ks,
              sdiv0);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      if (ok[k]) {
        const long long r = r0 + rb + k * kStep;
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const int qg = half * GQ + g;
          if (qg < gq) {
            if constexpr (kInt8 && kGlobal) {
              out[(long long)(q0 + qg) * n + r] = (float)acc[k][0] * s127[0];
            } else if constexpr (kInt8) {
              out[(long long)(q0 + qg) * n + r] =
                  (float)adc_q8_sum<GP>(acc[k], g, m) * s127[g];
            } else {
              out[(long long)(q0 + qg) * n + r] = acc[k][g];
            }
          }
        }
      }
    }
  }
}

template <bool kInt8, typename CodeT, int GP, bool kGlobal>
__global__ void __launch_bounds__(kAdcThreads)
    pq_adc_kernel(const CodeT* __restrict__ codes, long long n, int m,
                  const float* __restrict__ lut, int nq, int ks, int group,
                  int tile_rows, int depth, int slot_bytes, int bulk,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);    // [depth]
  uint64_t* empty = full + 3;                            // [depth]
  unsigned int* pmax = reinterpret_cast<unsigned int*>(smem + 48);  // [16]
  uint64_t* lutbar = reinterpret_cast<uint64_t*>(smem + 112);
  float* pslot = reinterpret_cast<float*>(smem + 128);   // [C][16]
  unsigned char* ring = smem + kAdcHeaderBytes;
  void* table = ring + depth * slot_bytes;
  // int8 tables are staged by a cluster; f32 ones by each CTA alone
  constexpr bool kCl = kInt8 && !kGlobal;
  // entries a turn of for_entries: U*GP values in flight a thread
  constexpr int U = kInt8 ? (GP >= 16 ? 2 : GP >= 8 ? 4 : GP >= 4 ? 8 : 16)
                          : (GP >= 8 ? 8 : 16);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = kCl ? (int)cluster.num_blocks() : 1;
  const int rank = kCl ? (int)cluster.block_rank() : 0;
  // the barrier that closes each staging step: the cluster's, or the
  // consumers' of this CTA
  auto step_sync = [&]() {
    if constexpr (kCl) {
      cluster_arrive();
      cluster_wait();
    } else {
      consumer_sync();
    }
  };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_tiles = (n + tile_rows - 1) / tile_rows;
  const long long n_full = bulk ? n / tile_rows : 0;   // tiles by bulk copy
  const int n_groups = (nq + group - 1) / group;
  const long long E = (long long)m * ks;
  const uint32_t tile_bytes = (uint32_t)tile_rows * m * sizeof(CodeT);
  // this CTA's share of the staging: entries [e_lo, e_hi) of each LUT
  const long long per = ((E + C - 1) / C + 31) / 32 * 32;
  const long long e_lo = min(E, rank * per), e_hi = min(E, e_lo + per);
  // f32 at GP=1: the LUT by one cp.async.bulk where it is 16-byte aligned
  const bool lut_bulk = !kInt8 && GP == 1 && !kGlobal && E % 4 == 0 &&
                        (reinterpret_cast<uintptr_t>(lut) & 15) == 0;

  if (tid == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kAdcConsumerWarps);
    }
    mbar_init(lutbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (kCl) {
    cluster_arrive();     // every barrier of the cluster exists
    cluster_wait();
  } else {
    __syncthreads();
  }

  // Per query group the consumers pass barriers A (done with the previous
  // group's table), int8 M (the partial maxima are exchanged) and B (the
  // group's table is complete). With a cluster these are cluster barriers,
  // which the producer warp passes too.
  if (warp == kAdcConsumerWarps) {
    // ---- producer: lane 0 keeps the ring full, across query groups ------
    long long k = 0;
    for (int gi = 0; gi < n_groups; ++gi) {
      if constexpr (kCl) {
        cluster_arrive();   // A
        cluster_wait();
        cluster_arrive();   // M
        cluster_wait();
        cluster_arrive();   // B: tiles go on arriving while the table fills
      }
      if (lane == 0) {
        for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++k) {
          const int s = (int)(k % depth);
          if (k >= depth)
            mbar_wait<false>(&empty[s], (uint32_t)((k / depth - 1) & 1));
          if (t < n_full) {
            mbar_expect_tx(&full[s], tile_bytes);
            bulk_load(ring + s * slot_bytes, codes + t * tile_rows * m,
                      tile_bytes, &full[s]);
          } else {
            mbar_arrive(&full[s]);    // the slot is free: consumers fill it
          }
        }
      }
      __syncwarp();
      if constexpr (kCl) cluster_wait();
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  long long k = 0;
  for (int gi = 0; gi < n_groups; ++gi) {
    const int q0 = gi * group, gq = min(group, nq - q0);
    const float* lq = lut + (long long)q0 * E;
    float s127[GP], sdiv0 = 1.f;
    step_sync();         // A
    if constexpr (kInt8) {
      if (tid < kAdcMaxGroup) pmax[tid] = 0u;
      consumer_sync();
      float mx[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) mx[g] = 0.f;
      for_entries<GP, U>(lq, e_lo, e_hi, E, gq,
                         [&](long long, const float(&v)[GP]) {
#pragma unroll
        for (int g = 0; g < GP; ++g) mx[g] = fmaxf(mx[g], fabsf(v[g]));
      });
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        mx[g] = warp_max(mx[g]);
        // |x| >= 0, so the float order is the unsigned order of the bits
        if (lane == 0 && g < gq) atomicMax(&pmax[g], __float_as_uint(mx[g]));
      }
      consumer_sync();
      // this CTA's partial maxima into slot `rank` of every CTA
      if (tid < GP) {
        const float pm = __uint_as_float(pmax[tid]);
        if constexpr (kCl) {
          for (int d = 0; d < C; ++d)
            *cluster.map_shared_rank(pslot + rank * kAdcMaxGroup + tid, d) =
                pm;
        } else {
          pslot[tid] = pm;
        }
      }
      step_sync();       // M
      float sdiv[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float s = 0.f;
        for (int r = 0; r < C; ++r)
          s = fmaxf(s, pslot[r * kAdcMaxGroup + g]);
        if (g >= gq) s = 0.f;
        sdiv[g] = fmaxf(s, 1e-20f);
        s127[g] = __fmul_rn(s, kInv127f);
      }
      sdiv0 = sdiv[0];
      if constexpr (!kGlobal) {
        // quantize this CTA's share once, into every CTA's table
        for_entries<GP, U>(lq, e_lo, e_hi, E, gq,
                           [&](long long e, const float(&v)[GP]) {
          int q8[GP];
#pragma unroll
          for (int g = 0; g < GP; ++g)
            q8[g] = quantize_q8(v[g], sdiv[g]) + 128;
          adc_put_all<GP>(cluster, C, rank,
                          static_cast<int8_t*>(table) + e * GP, q8);
        });
      }
    } else {
#pragma unroll
      for (int g = 0; g < GP; ++g) s127[g] = 1.f;
      if (lut_bulk) {
        // one query's f32 LUT is already laid out as [j][code]: one bulk
        // copy, onto its own mbarrier
        if (tid == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_expect_tx(lutbar, (uint32_t)(E * 4));
          bulk_load(table, lq, (uint32_t)(E * 4), lutbar);
        }
        mbar_wait<false>(lutbar, (uint32_t)(gi & 1));
      } else if constexpr (!kGlobal) {
        for_entries<GP, U>(lq, 0, E, E, gq,
                           [&](long long e, const float(&v)[GP]) {
          adc_put<GP>(static_cast<float*>(table) + e * GP, v);
        });
      }
    }
    step_sync();         // B

    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const long long r0 = t * tile_rows;
      const int rows = (int)min((long long)tile_rows, n - r0);
      const int s = (int)(k % depth);
      unsigned char* slot = ring + s * slot_bytes;
      mbar_wait<false>(&full[s], (uint32_t)((k / depth) & 1));
      if (t >= n_full) {
        fill_slot(slot, reinterpret_cast<const unsigned char*>(codes + r0 * m),
                  rows * m * (int)sizeof(CodeT));
        consumer_sync();
      }
      adc_tile<kInt8, CodeT, GP, kGlobal>(
          reinterpret_cast<const CodeT*>(slot), rows, m, ks, table, lq, sdiv0,
          s127, out, n, r0, q0, gq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++k;
    }
  }
}

// the plan of pq_adc.py:adc_plan: header, `depth` ring slots of T rows
// (+16 bytes: the funnel shift reads one word past a row), then the
// interleaved LUT of GP queries (none on the global path); a cluster of
// kAdcCluster CTAs stages an int8 table
int adc_plan_ok(int int8, int esize, int m, int ks, int group, int gp,
                int tile_rows, int depth, int slot_bytes, int global,
                int cluster, int smem_bytes) {
  if (m < 1 || ks < 1 || tile_rows < 16 || tile_rows % 16 || depth < 2 ||
      depth > 3)
    return 0;
  const bool gp_ok = gp == 1 || gp == 2 || gp == 4 || gp == 8 ||
                     (int8 && gp == 16);
  if (!gp_ok || (global ? (gp != 1 || group != 1) : group < 1 || group > gp))
    return 0;
  // int8 tables: a cluster stages them, and packed 16-bit sums take m <= 256
  if (cluster != (global || !int8 ? 1 : kAdcCluster)) return 0;
  if (int8 && gp > 1 && m > 256) return 0;
  const long long tile = (long long)tile_rows * m * esize;
  if (slot_bytes != (tile + 16 + 127) / 128 * 128) return 0;
  const long long lut =
      global ? 0 : ((long long)m * ks * gp * (int8 ? 1 : 4) + 15) / 16 * 16;
  return smem_bytes == kAdcHeaderBytes + depth * (long long)slot_bytes + lut;
}

struct AdcCall {
  const void* codes;
  long long n;
  int m;
  const float* lut;
  int nq, ks, group, tile_rows, depth, slot_bytes, cluster, smem, bulk;
  float* out;
  cudaStream_t stream;
  int* occupancy;   // non-null: report instead of launching
};

template <bool kInt8, typename CodeT, int GP, bool kGlobal>
int adc_run(const AdcCall& a) {
  const auto kern = pq_adc_kernel<kInt8, CodeT, GP, kGlobal>;
  // above 48 KB a block's dynamic shared memory must be allowed first
  static int allowed = 48 * 1024;
  if (a.smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (e != cudaSuccess) return (int)e;
    allowed = a.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)a.cluster);
  cfg.blockDim = dim3(kAdcThreads);
  cfg.dynamicSmemBytes = (size_t)a.smem;
  cfg.stream = a.stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)a.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // resident clusters at this shared memory: the persistent grid's size
  static int occ_smem = -1, occ_cluster = -1, occ_clusters = 0;
  if (a.smem != occ_smem || a.cluster != occ_cluster) {
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&occ_clusters, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    occ_smem = a.smem;
    occ_cluster = a.cluster;
  }
  if (a.occupancy) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    int* o = a.occupancy;
    o[0] = fa.numRegs;
    o[1] = (int)fa.sharedSizeBytes;
    o[2] = a.smem;
    o[3] = (int)fa.localSizeBytes;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[4], kern,
                                                      kAdcThreads,
                                                      (size_t)a.smem);
    if (e != cudaSuccess) return (int)e;
    o[5] = sm_count();
    o[6] = occ_clusters;
    o[7] = a.cluster;
    return 0;
  }
  if (occ_clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = (a.n + a.tile_rows - 1) / a.tile_rows;
  const long long want = (n_tiles + a.cluster - 1) / a.cluster;
  cfg.gridDim = dim3((unsigned)(a.cluster *
                                (want < occ_clusters ? want : occ_clusters)));
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const CodeT*>(a.codes), a.n, a.m, a.lut, a.nq,
      a.ks, a.group, a.tile_rows, a.depth, a.slot_bytes, a.bulk, a.out);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

template <bool kInt8, typename CodeT>
int adc_pick(int gp, int global, const AdcCall& a) {
  if (global) return adc_run<kInt8, CodeT, 1, true>(a);
  switch (gp) {
    case 1: return adc_run<kInt8, CodeT, 1, false>(a);
    case 2: return adc_run<kInt8, CodeT, 2, false>(a);
    case 4: return adc_run<kInt8, CodeT, 4, false>(a);
    case 8: return adc_run<kInt8, CodeT, 8, false>(a);
    case 16:
      if constexpr (kInt8) return adc_run<kInt8, CodeT, 16, false>(a);
  }
  return (int)cudaErrorInvalidValue;
}

int adc_dispatch(int int8, int codes_i32, int gp, int global,
                 const AdcCall& a) {
  if (int8)
    return codes_i32 ? adc_pick<true, int32_t>(gp, global, a)
                     : adc_pick<true, uint8_t>(gp, global, a);
  return codes_i32 ? adc_pick<false, int32_t>(gp, global, a)
                   : adc_pick<false, uint8_t>(gp, global, a);
}

template <bool kInt8>
int hop_smem_attr(int smem_bytes) {
  // above 48 KB a block's dynamic shared memory must be allowed first, or
  // the launch is refused (only cudaGetLastError shows it)
  static int allowed = 48 * 1024;
  if (smem_bytes <= allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      hop_kernel<kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e == cudaSuccess) allowed = smem_bytes;
  return (int)e;
}

// the plan of chunk_adc.py:hop_plan: f32 stages a ring of two slabs of
// `group` subspaces after the row, int8 the whole quantized LUT
int hop_plan_ok(int int8, int stride_w, int m, int ks, int group,
                int smem_bytes, int w, int R) {
  if (w < 1 || w > kHopMaxCluster || group < 1 || group > kHopMaxGroup ||
      R < 0 || R > kHopConsumerWarps * kHopMaxNbrPerWarp || ks % 4 || m < 1)
    return 0;
  // int8: the int8 LUT, then this CTA's f32 share of it (16-entry groups)
  const int per16 = (m * ks / 16 + w - 1) / w;
  const int staged = int8 ? ((m * ks + 15) & ~15) + per16 * 64
                          : 2 * group * ks * 4;
  return smem_bytes == kHopHeaderBytes + stride_w * 4 + staged;
}

cudaLaunchConfig_t hop_config(int nq, int w, int smem_bytes,
                              cudaLaunchAttribute* attr,
                              cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nq * w));
  cfg.blockDim = dim3(kHopThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)w;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kInt8>
int launch_hop(const void* words, long long n_rows, int stride_w,
               const void* fids, int nq, int w, const void* lut, int m,
               int ks, int group, int smem_bytes, const void* queries, int d,
               int u8vec, int mips, int off_ids_w, int off_pq_w, int R,
               void* exact, void* ids, void* nbr_d, void* stream) {
  if (!hop_plan_ok(kInt8, stride_w, m, ks, group, smem_bytes, w, R))
    return (int)cudaErrorInvalidValue;
  if (nq <= 0) return (int)cudaGetLastError();
  const int e = hop_smem_attr<kInt8>(smem_bytes);
  if (e != 0) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = hop_config(
      nq, w, smem_bytes, &attr, static_cast<cudaStream_t>(stream));
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, hop_kernel<kInt8>, static_cast<const int32_t*>(words), n_rows,
      stride_w, static_cast<const int32_t*>(fids),
      static_cast<const float*>(lut), m, ks, group,
      static_cast<const float*>(queries), d, u8vec, mips, off_ids_w,
      off_pq_w, R, static_cast<float*>(exact), static_cast<int32_t*>(ids),
      static_cast<float*>(nbr_d));
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// out: registers a thread, static shared bytes, dynamic shared bytes, local
// (spill) bytes a thread, resident CTAs an SM, resident clusters of w CTAs
template <bool kInt8>
int hop_occupancy(int smem_bytes, int w, int* out) {
  int e = hop_smem_attr<kInt8>(smem_bytes);
  if (e != 0) return e;
  cudaFuncAttributes a;
  cudaError_t ce = cudaFuncGetAttributes(&a, hop_kernel<kInt8>);
  if (ce != cudaSuccess) return (int)ce;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = smem_bytes;
  out[3] = (int)a.localSizeBytes;
  ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], hop_kernel<kInt8>, kHopThreads, (size_t)smem_bytes);
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = hop_config(1, w, smem_bytes, &attr, 0);
  ce = cudaOccupancyMaxActiveClusters(&out[5], hop_kernel<kInt8>, &cfg);
  return (int)ce;
}

// pq_lut's plan: tpr threads a subspace (a power of two, 4 entries each),
// jb = 128 / tpr subspaces and qb queries a CTA, DSUB (0: any dsub), and
// the dynamic shared memory. Returns 0 where the shapes do not fit the
// kernel.
struct LutPlan {
  int lg_tpr, jb, qb, dsub_t, smem, grid_x, grid_y;
};

int lut_plan(int nq, int d, int m, int ks, int dsub, int cent_aligned,
             LutPlan* p) {
  if (nq < 0 || m < 1 || ks < 1 || dsub < 1 || (long long)m * dsub != d ||
      (long long)nq * d >= INT_MAX || (long long)nq * m >= INT_MAX)
    return 0;
  int lg = 0;
  while ((4 << lg) < ks) ++lg;
  if ((1 << lg) > kLutThreads) return 0;          // ks > 512
  p->lg_tpr = lg;
  p->jb = kLutThreads >> lg;
  const bool staged = ks % 4 == 0 && cent_aligned &&
                      (dsub == 1 || dsub == 2 || dsub == 4 || dsub == 5 ||
                       dsub == 8);
  p->dsub_t = staged ? dsub : 0;
  const int fixed = staged ? p->jb * ks * dsub * 4 : 0;
  // max(4, dsub) queries a CTA (up to 8: each CTA reads its centroids
  // once, so wider subspaces want more queries), fewer where that leaves
  // less than two CTAs an SM, or where the slabs do not fit
  p->grid_y = (m + p->jb - 1) / p->jb;
  p->qb = std::max(1, std::min({nq, std::max(4, dsub), kLutMaxQb}));
  while (p->qb > 1 &&
         ((long long)(nq + p->qb - 1) / p->qb * p->grid_y < 2 * sm_count() ||
          fixed + p->qb * p->jb * (dsub + 1) * 4 > kLutMaxSmem))
    --p->qb;
  p->smem = fixed + p->qb * p->jb * (dsub + 1) * 4;
  p->grid_x = (nq + p->qb - 1) / p->qb;
  return p->smem <= kLutMaxSmem && p->grid_y <= 65535;
}

using LutKernel = void (*)(const float*, int, int, const float*, int, int,
                           int, int, int, int, int, float*);

LutKernel lut_kernel_for(int dsub_t) {
  switch (dsub_t) {
    case 1: return pq_lut_kernel<1>;
    case 2: return pq_lut_kernel<2>;
    case 4: return pq_lut_kernel<4>;
    case 5: return pq_lut_kernel<5>;
    case 8: return pq_lut_kernel<8>;
    default: return pq_lut_kernel<0>;
  }
}

// the rerank's passes a lane holds in registers: 1, 2, 4 or 8 (128 NP
// elements of the query); longer queries go in tiles of 8 passes
int rerank_np(int d) {
  const int passes = ((d + 3) / 4 + 31) / 32;
  return passes <= 1 ? 1 : passes <= 2 ? 2 : passes <= 4 ? 4 : 8;
}

using RerankKernel = void (*)(const RerankArgs);

template <int kSrc>
RerankKernel rerank_kernel_np(int np) {
  switch (np) {
    case 1: return rerank_kernel<kSrc, 1>;
    case 2: return rerank_kernel<kSrc, 2>;
    case 4: return rerank_kernel<kSrc, 4>;
    default: return rerank_kernel<kSrc, 8>;
  }
}

RerankKernel rerank_kernel_for(int src, int d) {
  const int np = rerank_np(d);
  switch (src) {
    case kRrDense: return rerank_kernel_np<kRrDense>(np);
    case kRrDenseAny: return rerank_kernel_np<kRrDenseAny>(np);
    case kRrRowsF32: return rerank_kernel_np<kRrRowsF32>(np);
    default: return rerank_kernel_np<kRrRowsU8>(np);
  }
}

int launch_rerank(int src, const RerankArgs& a, cudaStream_t stream) {
  if (a.nq < 0 || a.C < 0 || a.d < 1 ||
      (long long)a.nq * a.C >= INT_MAX || (long long)a.nq * a.d >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (a.nq == 0 || a.C == 0) return (int)cudaGetLastError();
  const int per_cta = kRrWarps * rerank_u(src);
  const dim3 grid((a.C + per_cta - 1) / per_cta,
                  std::min(a.nq, kRrMaxGridY));
  const RerankKernel fn = rerank_kernel_for(src, a.d);
  fn<<<grid, kRrThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// out: registers a thread, static shared bytes, dynamic shared bytes, local
// (spill) bytes a thread, resident CTAs an SM
int kernel_occupancy(const void* fn, int threads, int smem, int* out) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = smem;
  out[3] = (int)at.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], fn, threads, (size_t)smem);
}

}  // namespace

extern "C" {

int aisaq_fused_hop(const void* words, long long n_rows, int stride_w,
                    const void* fids, int nq, int w, const void* lut, int m,
                    int ks, int group, int smem_bytes, const void* queries,
                    int d, int u8vec, int mips, int off_ids_w, int off_pq_w,
                    int R, int int8, void* exact, void* ids, void* nbr_d,
                    void* stream) {
  return int8 ? launch_hop<true>(words, n_rows, stride_w, fids, nq, w, lut,
                                 m, ks, group, smem_bytes, queries, d, u8vec,
                                 mips, off_ids_w, off_pq_w, R, exact, ids,
                                 nbr_d, stream)
              : launch_hop<false>(words, n_rows, stride_w, fids, nq, w, lut,
                                  m, ks, group, smem_bytes, queries, d, u8vec,
                                  mips, off_ids_w, off_pq_w, R, exact, ids,
                                  nbr_d, stream);
}

int aisaq_hop_occupancy(int int8, int smem_bytes, int w, void* out) {
  int* o = static_cast<int*>(out);
  return int8 ? hop_occupancy<true>(smem_bytes, w, o)
              : hop_occupancy<false>(smem_bytes, w, o);
}

#ifdef AISAQ_HOP_TRACE
int aisaq_hop_trace(void* dst, int clear) {
  if (!clear)
    return (int)cudaMemcpyFromSymbol(dst, hop_trace, sizeof(hop_trace));
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, hop_trace);
  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(hop_trace)));
}
#endif

int aisaq_pq_lut(const void* qs, int nq, int d, const void* cent, int m,
                 int ks, int dsub, int mips, void* out, void* stream) {
  LutPlan p;
  if (!lut_plan(nq, d, m, ks, dsub,
                (reinterpret_cast<uintptr_t>(cent) & 15) == 0, &p))
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaGetLastError();
  const int vec = ks % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  lut_kernel_for(p.dsub_t)<<<dim3(p.grid_x, p.grid_y), kLutThreads, p.smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qs), nq, d, static_cast<const float*>(cent),
      m, ks, dsub, p.lg_tpr, p.qb, mips, vec, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// out: registers, static smem, dynamic smem, local bytes, CTAs an SM,
// grid x (query blocks), grid y (subspace blocks), qb, jb, DSUB (0: any)
int aisaq_lut_occupancy(int nq, int d, int m, int ks, int dsub, void* out) {
  LutPlan p;
  if (!lut_plan(nq, d, m, ks, dsub, 1, &p))
    return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  const int e = kernel_occupancy(
      reinterpret_cast<const void*>(lut_kernel_for(p.dsub_t)), kLutThreads,
      p.smem, o);
  o[5] = p.grid_x;
  o[6] = p.grid_y;
  o[7] = p.qb;
  o[8] = p.jb;
  o[9] = p.dsub_t;
  return e;
}

int aisaq_rerank(const void* q, int nq, const void* cand,
                 long long cand_qstride, int C, int d, int mips, void* out,
                 void* stream) {
  RerankArgs a = {static_cast<const float*>(q), cand, nullptr,
                  cand_qstride, 0, 0, nq, C, d, mips,
                  static_cast<float*>(out)};
  // float4 loads where every candidate row starts 16-byte aligned
  const bool vec4 = d % 4 == 0 && cand_qstride % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(cand) & 15) == 0;
  return launch_rerank(vec4 ? kRrDense : kRrDenseAny, a,
                       static_cast<cudaStream_t>(stream));
}

int aisaq_rerank_rows(const void* q, int nq, const void* words,
                      long long n_rows, int stride_w, const void* ids, int C,
                      int d, int u8, int mips, void* out, void* stream) {
  // rows 16-byte aligned, and the vector's last 16-byte (f32) or 4-byte
  // (u8) load inside the row
  const int slots = (d + 3) / 4;
  if (n_rows < 1 || stride_w % 4 || (u8 ? slots : 4 * slots) > stride_w ||
      (reinterpret_cast<uintptr_t>(words) & 15))
    return (int)cudaErrorInvalidValue;
  RerankArgs a = {static_cast<const float*>(q), words,
                  static_cast<const int32_t*>(ids), 0, n_rows, stride_w, nq,
                  C, d, mips, static_cast<float*>(out)};
  return launch_rerank(u8 ? kRrRowsU8 : kRrRowsF32, a,
                       static_cast<cudaStream_t>(stream));
}

// src: 0 dense (float4), 1 dense (scalar), 2 f32 rows, 3 u8 rows. out:
// registers, static smem, dynamic smem, local bytes, CTAs an SM, passes a
// lane holds (NP), candidates a CTA
int aisaq_rerank_occupancy(int src, int d, void* out) {
  if (src < 0 || src > 3 || d < 1) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  const int e = kernel_occupancy(
      reinterpret_cast<const void*>(rerank_kernel_for(src, d)), kRrThreads,
      0, o);
  o[5] = rerank_np(d);
  o[6] = kRrWarps * rerank_u(src);
  return e;
}

int aisaq_pq_adc(const void* codes, long long n, int m, int codes_i32,
                 const void* lut, int nq, int ks, int int8, int group, int gp,
                 int tile_rows, int depth, int slot_bytes, int global,
                 int cluster, int smem_bytes, void* out, void* stream) {
  if (!adc_plan_ok(int8, codes_i32 ? 4 : 1, m, ks, group, gp, tile_rows,
                   depth, slot_bytes, global, cluster, smem_bytes))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || nq <= 0) return (int)cudaGetLastError();
  // tiles go by cp.async.bulk only from a 16-byte aligned base (a sliced
  // table, e.g. codes[1:], is read with plain loads)
  const int bulk = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const AdcCall a = {codes, n, m, static_cast<const float*>(lut), nq, ks,
                     group, tile_rows, depth, slot_bytes, cluster,
                     smem_bytes, bulk,
                     static_cast<float*>(out),
                     static_cast<cudaStream_t>(stream), nullptr};
  return adc_dispatch(int8, codes_i32, gp, global, a);
}

// out: registers a thread, static shared bytes, dynamic shared bytes, local
// (spill) bytes a thread, resident CTAs an SM, SMs, resident clusters,
// CTAs a cluster
int aisaq_adc_occupancy(int m, int codes_i32, int ks, int int8, int group,
                        int gp, int tile_rows, int depth, int slot_bytes,
                        int global, int cluster, int smem_bytes, void* out) {
  if (!adc_plan_ok(int8, codes_i32 ? 4 : 1, m, ks, group, gp, tile_rows,
                   depth, slot_bytes, global, cluster, smem_bytes))
    return (int)cudaErrorInvalidValue;
  AdcCall a = {};
  a.m = m;
  a.ks = ks;
  a.cluster = cluster;
  a.smem = smem_bytes;
  a.occupancy = static_cast<int*>(out);
  return adc_dispatch(int8, codes_i32, gp, global, a);
}

}  // extern "C"
