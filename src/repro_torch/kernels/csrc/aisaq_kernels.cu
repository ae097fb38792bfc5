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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ int code_at(const int32_t* codes, int e) {
  return (__ldg(codes + (e >> 2)) >> (8 * (e & 3))) & 0xFF;
}

// ---------------------------------------------------------------------------
// fused_hop — replaces repro/kernels/chunk_adc.py:_hop_kernel (f32) and
// _hop_kernel_q8 (int8), the pallas_call in chunk_adc.py:fused_hop.
//
// One block per frontier slot (q, i). The block gathers chunk row
// fids[q, i] and emits the exact query-node distance (difference form,
// strided over d, warp + block reduction), the R neighbour ids (one thread
// per slot) and the R neighbour ADC distances (one warp per neighbour,
// lanes over the m subspaces: code byte -> lut[q, j, code], warp sum).
//
// Bound: bytes. Per slot it reads one 7.9 KB row (SIFT1M widths) and
// w*R*m LUT entries that sit in L2 (128 KB f32 / 32 KB int8 per query);
// the arithmetic is a few adds per byte. The design keeps every field of
// the row in registers for one pass and reads the LUT through the
// read-only path (__ldg), since it is L2-resident across the w slots of a
// query. The Pallas kernel's one-hot MXU contraction is a TPU device and
// is not copied: on Hopper the LUT lookup is a plain gather.
// ---------------------------------------------------------------------------

template <bool kInt8>
__global__ void fused_hop_kernel(
    const int32_t* __restrict__ words, long long n_rows, int stride_w,
    const int32_t* __restrict__ fids, int w,
    const void* __restrict__ lut_v, const float* __restrict__ scale127,
    int m, int ks, const float* __restrict__ queries, int d, int u8vec,
    int mips, int off_ids_w, int off_pq_w, int R,
    float* __restrict__ exact_out, int32_t* __restrict__ ids_out,
    float* __restrict__ nbr_d_out) {
  __shared__ float red[32];
  const int slot = blockIdx.x;                 // q * w + i
  const int q = slot / w;
  const int node = fids[slot];
  const bool valid = node >= 0;
  const long long r_i = node < 0 ? 0 : (node >= n_rows ? n_rows - 1 : node);
  const int32_t* row = words + r_i * (long long)stride_w;
  const float* qv = queries + (long long)q * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // ---- exact distance --------------------------------------------------
  float acc = 0.f;
  for (int t = tid; t < d; t += blockDim.x) {
    const float v = u8vec
        ? (float)((__ldg(row + (t >> 2)) >> (8 * (t & 3))) & 0xFF)
        : __int_as_float(__ldg(row + t));
    const float qq = qv[t];
    if (mips) {
      acc += v * qq;
    } else {
      const float df = v - qq;
      acc += df * df;
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nwarps ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) exact_out[slot] = valid ? (mips ? -s : s) : INFINITY;
  }

  // ---- neighbour ids -----------------------------------------------------
  const long long out0 = (long long)slot * R;
  for (int r = tid; r < R; r += blockDim.x) {
    const int id = __ldg(row + off_ids_w + r);
    ids_out[out0 + r] = (valid && id >= 0) ? id : -1;
  }

  // ---- inline-PQ ADC: one warp per neighbour ----------------------------
  const int32_t* codes = row + off_pq_w;
  const long long lut0 = (long long)q * m * ks;
  for (int r = warp; r < R; r += nwarps) {
    const int id = __ldg(row + off_ids_w + r);  // warp-uniform
    float out = INFINITY;
    if (valid && id >= 0) {
      if (kInt8) {
        const int8_t* lut = static_cast<const int8_t*>(lut_v) + lut0;
        int s = 0;
        for (int j = lane; j < m; j += 32)
          s += (int)__ldg(lut + (long long)j * ks + code_at(codes, r * m + j));
        s = warp_sum(s);
        out = (float)s * scale127[q];
      } else {
        const float* lut = static_cast<const float*>(lut_v) + lut0;
        float s = 0.f;
        for (int j = lane; j < m; j += 32)
          s += __ldg(lut + (long long)j * ks + code_at(codes, r * m + j));
        out = warp_sum(s);
      }
    }
    if (lane == 0) nbr_d_out[out0 + r] = out;
  }
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

constexpr int kHopThreads = 256;
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
int launch_fused_hop(const void* words, long long n_rows, int stride_w,
                     const void* fids, int nq, int w, const void* lut,
                     const void* scale127, int m, int ks, const void* queries,
                     int d, int u8vec, int mips, int off_ids_w, int off_pq_w,
                     int R, void* exact, void* ids, void* nbr_d,
                     void* stream) {
  const int slots = nq * w;
  if (slots > 0) {
    fused_hop_kernel<kInt8><<<slots, kHopThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), n_rows, stride_w,
        static_cast<const int32_t*>(fids), w, lut,
        static_cast<const float*>(scale127), m, ks,
        static_cast<const float*>(queries), d, u8vec, mips, off_ids_w,
        off_pq_w, R, static_cast<float*>(exact), static_cast<int32_t*>(ids),
        static_cast<float*>(nbr_d));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int aisaq_fused_hop_f32(const void* words, long long n_rows, int stride_w,
                        const void* fids, int nq, int w, const void* lut,
                        int m, int ks, const void* queries, int d, int u8vec,
                        int mips, int off_ids_w, int off_pq_w, int R,
                        void* exact, void* ids, void* nbr_d, void* stream) {
  return launch_fused_hop<false>(words, n_rows, stride_w, fids, nq, w, lut,
                                 nullptr, m, ks, queries, d, u8vec, mips,
                                 off_ids_w, off_pq_w, R, exact, ids, nbr_d,
                                 stream);
}

int aisaq_fused_hop_int8(const void* words, long long n_rows, int stride_w,
                         const void* fids, int nq, int w, const void* lut_q8,
                         const void* scale127, int m, int ks,
                         const void* queries, int d, int u8vec, int mips,
                         int off_ids_w, int off_pq_w, int R, void* exact,
                         void* ids, void* nbr_d, void* stream) {
  return launch_fused_hop<true>(words, n_rows, stride_w, fids, nq, w, lut_q8,
                                scale127, m, ks, queries, d, u8vec, mips,
                                off_ids_w, off_pq_w, R, exact, ids, nbr_d,
                                stream);
}

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
