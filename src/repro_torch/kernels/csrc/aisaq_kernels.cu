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
#include <math.h>
#include <stdint.h>

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
// s / 127 (an IEEE quotient). The int8 hop reads the same f32 LUT bytes
// from global memory as the f32 hop.
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
    const float s127 = scale / 127.f;
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
// One thread per output (q, j, k), a loop over dsub and the expanded-form
// epilogue: ||q_j||^2 - 2 q_j.c_jk + ||c_jk||^2 (l2), -q_j.c_jk (mips).
// Bound: bytes — it writes nq*m*ks*4 B (128 KB per query at SIFT1M widths)
// from a few KB of input; consecutive threads write consecutive k, so the
// stores coalesce and the centroid reads are contiguous.
// ---------------------------------------------------------------------------

__global__ void pq_lut_kernel(const float* __restrict__ qs, int nq,
                              const float* __restrict__ cent, int m, int ks,
                              int dsub, int mips, float* __restrict__ out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long total = (long long)nq * m * ks;
  if (t >= total) return;
  const int k = (int)(t % ks);
  const long long qj = t / ks;
  const int j = (int)(qj % m);
  const long long qi = qj / m;
  const float* qv = qs + (qi * m + j) * dsub;
  const float* c = cent + ((long long)j * ks + k) * dsub;
  float cross = 0.f, qn = 0.f, cn = 0.f;
  for (int e = 0; e < dsub; ++e) {
    const float a = __ldg(qv + e), b = __ldg(c + e);
    cross += a * b;
    qn += a * a;
    cn += b * b;
  }
  out[t] = mips ? -cross : (qn - 2.f * cross + cn);
}

// ---------------------------------------------------------------------------
// rerank — replaces repro/kernels/rerank.py:_rerank_kernel (pallas_call in
// rerank.py:rerank).
//
// One warp per (q, c), lanes over d, expanded form:
// ||c||^2 - 2 c.q + ||q||^2 (l2), -c.q (mips). Candidates are (nq, C, d)
// (cand_qstride = C*d, a set per query) or (C, d) shared by all queries
// (cand_qstride = 0), so a whole serving batch is one launch.
// Bound: bytes — each candidate vector is read once, with 2 flops per
// element; a warp reads 128 contiguous bytes per step.
// ---------------------------------------------------------------------------

__global__ void rerank_kernel(const float* __restrict__ q, int nq,
                              const float* __restrict__ cand,
                              long long cand_qstride, int C, int d, int mips,
                              float* __restrict__ out) {
  const long long gw =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= (long long)nq * C) return;         // warp-uniform
  const long long qi = gw / C, ci = gw % C;
  const float* qv = q + qi * d;
  const float* cv = cand + qi * cand_qstride + ci * d;
  float cross = 0.f, qn = 0.f, cn = 0.f;
  for (int t = lane; t < d; t += 32) {
    const float a = __ldg(qv + t), b = __ldg(cv + t);
    cross += a * b;
    qn += a * a;
    cn += b * b;
  }
  cross = warp_sum(cross);
  qn = warp_sum(qn);
  cn = warp_sum(cn);
  if (lane == 0) out[gw] = mips ? -cross : (cn - 2.f * cross + qn);
}

// ---------------------------------------------------------------------------
// pq_adc — replaces repro/kernels/pq_adc.py:_adc_kernel (f32 LUT, the
// pallas_call in pq_adc.py:pq_adc) and _adc_q8_kernel (int8 LUT, the
// pallas_call in pq_adc.py:pq_adc_q8).
//
// out[q, r] = sum_j lut[q, j, codes[r, j]] over n candidate rows of m code
// bytes (u8) or words (i32). The Pallas body contracts a one-hot of the
// codes with the LUT on the MXU, a TPU device; on Hopper the ADC is a
// gather. Grid (row-tile blocks, nq): each block stages query q's (m, ks)
// LUT in shared memory once (when it fits in 48 KB: 10 KB at m=10 f32,
// 32 KB at m=128 int8; otherwise it reads the LUT through __ldg) and then
// walks row tiles of 256, one thread per row, adding the m entries in
// order j = 0..m-1. The int8 LUT sums exactly in int32 and is rescaled
// once by scale/127. Codes are read as they lie (u8 bytes, no widening
// pass) and clamped to [0, ks) so a bad code cannot read outside the LUT.
//
// Bound: bytes — each row's m code bytes are read once and one f32 is
// written per (q, row); the work is m adds per output. The grid is capped
// at one resident wave (8 blocks of 256 a SM) so the LUT is staged
// ~1k times instead of once per 256 rows.
// ---------------------------------------------------------------------------

template <typename LutT, typename CodeT, bool kSmem>
__global__ void pq_adc_kernel(const CodeT* __restrict__ codes, long long n,
                              int m, const LutT* __restrict__ lut, int ks,
                              const float* __restrict__ scale127,
                              float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kInt8 = sizeof(LutT) == 1;
  using AccT = typename std::conditional<kInt8, int, float>::type;
  const int q = blockIdx.y;
  const LutT* lq = lut + (long long)q * m * ks;
  LutT* slut = reinterpret_cast<LutT*>(smem_raw);
  if (kSmem) {
    for (int i = threadIdx.x; i < m * ks; i += blockDim.x)
      slut[i] = __ldg(lq + i);
    __syncthreads();
  }
  const float s127 = kInt8 ? scale127[q] : 1.f;
  float* oq = out + (long long)q * n;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       r < n; r += step) {
    const CodeT* c = codes + r * m;
    AccT acc = 0;
    for (int j = 0; j < m; ++j) {
      const int code = min(max((int)__ldg(c + j), 0), ks - 1);
      acc += kSmem ? slut[j * ks + code] : __ldg(lq + j * ks + code);
    }
    oq[r] = kInt8 ? (float)acc * s127 : (float)acc;
  }
}

constexpr int kThreads = 256;

constexpr int kAdcBlocksPerSm = 8;
constexpr int kSmemLimit = 48 * 1024;

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

template <typename LutT, typename CodeT>
void launch_pq_adc_typed(const void* codes, long long n, int m,
                         const void* lut, const void* scale127, int nq,
                         int ks, void* out, cudaStream_t stream) {
  const long long tiles = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * kAdcBlocksPerSm;
  const dim3 grid((unsigned)(tiles < cap ? tiles : cap), (unsigned)nq);
  const size_t lut_bytes = (size_t)m * ks * sizeof(LutT);
  const CodeT* c = static_cast<const CodeT*>(codes);
  const LutT* l = static_cast<const LutT*>(lut);
  const float* s = static_cast<const float*>(scale127);
  float* o = static_cast<float*>(out);
  if (lut_bytes <= (size_t)kSmemLimit) {
    pq_adc_kernel<LutT, CodeT, true><<<grid, kThreads, lut_bytes, stream>>>(
        c, n, m, l, ks, s, o);
  } else {
    pq_adc_kernel<LutT, CodeT, false><<<grid, kThreads, 0, stream>>>(
        c, n, m, l, ks, s, o);
  }
}

template <typename LutT>
int launch_pq_adc(const void* codes, long long n, int m, int codes_i32,
                  const void* lut, const void* scale127, int nq, int ks,
                  void* out, void* stream) {
  if (n > 0 && nq > 0 && m > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (codes_i32) {
      launch_pq_adc_typed<LutT, int32_t>(codes, n, m, lut, scale127, nq, ks,
                                         out, st);
    } else {
      launch_pq_adc_typed<LutT, uint8_t>(codes, n, m, lut, scale127, nq, ks,
                                         out, st);
    }
  }
  return (int)cudaGetLastError();
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

int aisaq_pq_lut(const void* qs, int nq, const void* cent, int m, int ks,
                 int dsub, int mips, void* out, void* stream) {
  const long long total = (long long)nq * m * ks;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    pq_lut_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(qs), nq, static_cast<const float*>(cent),
        m, ks, dsub, mips, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

int aisaq_rerank(const void* q, int nq, const void* cand,
                 long long cand_qstride, int C, int d, int mips, void* out,
                 void* stream) {
  const long long threads = (long long)nq * C * 32;
  if (threads > 0) {
    const long long blocks = (threads + kThreads - 1) / kThreads;
    rerank_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), nq, static_cast<const float*>(cand),
        cand_qstride, C, d, mips, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

int aisaq_pq_adc_f32(const void* codes, long long n, int m, int codes_i32,
                     const void* lut, int nq, int ks, void* out,
                     void* stream) {
  return launch_pq_adc<float>(codes, n, m, codes_i32, lut, nullptr, nq, ks,
                              out, stream);
}

int aisaq_pq_adc_int8(const void* codes, long long n, int m, int codes_i32,
                      const void* lut_q8, const void* scale127, int nq,
                      int ks, void* out, void* stream) {
  return launch_pq_adc<int8_t>(codes, n, m, codes_i32, lut_q8, scale127, nq,
                               ks, out, stream);
}

}  // extern "C"
