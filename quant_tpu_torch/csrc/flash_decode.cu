// INT8-KV flash-decode attention for Hopper (sm_90a).
//
// Replaces: quant_tpu/kernels/attention.py, flash_decode_int8 -> _kernel
//   (the Pallas TPU kernel).
//
// Decode-step (T=1) GQA attention over the stacked int8 cache
// [L, B, Hkv, S, Dh] with per-(token, head) f32 scales [L, B, Hkv, S]. Query
// head h reads kv head h / rep (the [B, Hkv, rep, Dh] view of q). The key
// scale multiplies the logits after the q.k product and the value scale the
// probabilities before the p.v product (both factor out of the Dh sum), with
// an online softmax. Output = acc / max(l, 1e-20): a slot of length 0 gives
// zeros.
//
// What bounds it on this card: the K/V code bytes of each slot's actual
// context (1 byte per element, 264 bytes per token and kv head at Dh=128),
// so device-memory bandwidth, and at short contexts launch latency.
//
// Design: split-S. Block (b*Hkv + h, c) owns the CH-token chunk c of slot b
// and kv head h; chunks at or past min(lengths[b], S) exit at once, so
// tokens past the length are neither loaded nor computed, and a long context
// spreads over many blocks. A block walks its chunk in TT-token tiles. Each
// tile's K and V rows are one contiguous run of bytes in the cache, staged
// into shared memory by all threads with 16-byte loads; two threads score
// one token (half of Dh each) against the rep query rows, one warp per query
// row runs the online-softmax step, and each thread owns Dh columns of the
// p.v product. A block writes its unnormalised (m, l, acc) per query row; a
// second kernel merges the chunks of each (slot, kv head) by their maxima.
// TMA and tensor cores come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int TT = 64;           // tokens per staged tile (2 threads each)
constexpr int CH = 256;          // tokens per block (split-S chunk)
constexpr int MAX_REP = 8;
constexpr int MAX_D = 256;
constexpr int KPAD = 16;         // K row padding: spreads rows over banks
constexpr int DPT = MAX_D / NT;  // Dh columns per thread in the p.v product
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Copy n bytes (a multiple of 16) from global to shared memory, 16 bytes per
// thread per pass; row r of the source (row_bytes long) lands at r * pitch.
__device__ __forceinline__ void stage(int8_t* dst, const int8_t* __restrict__ src,
                                      int n, int row_bytes, int pitch) {
  for (int i = threadIdx.x * 16; i < n; i += NT * 16) {
    const int r = i / row_bytes, c = i - r * row_bytes;
    *reinterpret_cast<int4*>(dst + r * pitch + c) =
        *reinterpret_cast<const int4*>(src + i);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_decode_chunk(const T* __restrict__ q, const int8_t* __restrict__ kc,
                   const float* __restrict__ ks, const int8_t* __restrict__ vc,
                   const float* __restrict__ vs, const int* __restrict__ lengths,
                   float* __restrict__ part_o, float* __restrict__ part_ml,
                   int layer, int B, int Hkv, int S, int D, int rep,
                   float scale) {
  __shared__ __align__(16) int8_t k_t[TT][MAX_D + KPAD];
  __shared__ __align__(16) int8_t v_t[TT][MAX_D];
  __shared__ float q_s[MAX_REP][MAX_D];
  __shared__ float p_s[MAX_REP][TT];
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], alpha_s[MAX_REP];

  const int bh = blockIdx.x, chunk = blockIdx.y, n_chunks = gridDim.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int len = max(0, min(lengths[b], S));
  const int c0 = chunk * CH;
  if (c0 >= len) return;  // the combine reads only chunks below the length
  const int c1 = min(len, c0 + CH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (((size_t)layer * B + b) * Hkv + h) * S;  // token 0
  const size_t qoff = ((size_t)b * Hkv + h) * rep * D;

  for (int i = tid; i < rep * D; i += NT) q_s[i / D][i % D] = to_f32(q[qoff + i]) * scale;
  if (tid < rep) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  float acc[MAX_REP][DPT];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[r][j] = 0.f;

  const int half = D / 2;
  for (int t0 = c0; t0 < c1; t0 += TT) {
    const int n_tok = min(TT, c1 - t0);
    stage(&k_t[0][0], kc + (row0 + t0) * D, n_tok * D, D, MAX_D + KPAD);
    stage(&v_t[0][0], vc + (row0 + t0) * D, n_tok * D, D, MAX_D);
    __syncthreads();

    // scores: threads 2j and 2j+1 take the two halves of token j's row
    const int j = tid >> 1, hoff = (tid & 1) * half;
    float dots[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) dots[r] = 0.f;
    if (j < n_tok) {
      const int8_t* krow = &k_t[j][hoff];
      for (int d0 = 0; d0 < half; d0 += 8) {
        const int2 w = *reinterpret_cast<const int2*>(krow + d0);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float kv = float(kb[e]);
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) dots[r] = fmaf(q_s[r][hoff + d0 + e], kv, dots[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) dots[r] += __shfl_xor_sync(0xffffffffu, dots[r], 1);
    if ((tid & 1) == 0) {
      const float ksc = j < n_tok ? ks[row0 + t0 + j] : 0.f;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) p_s[r][j] = j < n_tok ? dots[r] * ksc : NEG;
    }
    __syncthreads();

    // online softmax: one warp per query row, two tokens per lane
    for (int r = warp; r < rep; r += NT / 32) {
      const float v0 = p_s[r][lane], v1 = p_s[r][lane + 32];
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = lane < n_tok ? __expf(v0 - m_new) : 0.f;
      const float p1 = lane + 32 < n_tok ? __expf(v1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r][lane] = lane < n_tok ? p0 * vs[row0 + t0 + lane] : 0.f;
      p_s[r][lane + 32] = lane + 32 < n_tok ? p1 * vs[row0 + t0 + lane + 32] : 0.f;
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // p.v: thread tid owns Dh columns tid, tid + NT
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < rep) {
        const float a = alpha_s[r];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[r][c] *= a;
      }
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tid + NT * c;
      if (d < D) {
#pragma unroll 4
        for (int t = 0; t < n_tok; ++t) {
          const float vv = float(v_t[t][d]);
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) acc[r][c] = fmaf(p_s[r][t], vv, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  // unnormalised partial of this chunk: o [bh, chunk, r, d], (m, l) [bh, chunk, r]
  const size_t pbase = ((size_t)bh * n_chunks + chunk) * rep;
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tid + NT * c;
      if (d < D) part_o[(pbase + r) * D + d] = acc[r][c];
    }
  }
  if (tid < rep) {
    part_ml[(pbase + tid) * 2] = m_s[tid];
    part_ml[(pbase + tid) * 2 + 1] = l_s[tid];
  }
}

// Merge the chunks of each (slot, kv head): out = sum_c e^(m_c - M) o_c /
// max(sum_c e^(m_c - M) l_c, 1e-20) over the chunks below the length.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_decode_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                     const int* __restrict__ lengths, T* __restrict__ out, int Hkv,
                     int S, int D, int rep, int n_chunks) {
  const int bh = blockIdx.x, b = bh / Hkv;
  const int len = max(0, min(lengths[b], S));
  const int used = (len + CH - 1) / CH;
  for (int i = threadIdx.x; i < rep * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float mx = NEG;
    for (int c = 0; c < used; ++c)
      mx = fmaxf(mx, part_ml[(((size_t)bh * n_chunks + c) * rep + r) * 2]);
    float l = 0.f, o = 0.f;
    for (int c = 0; c < used; ++c) {
      const size_t p = ((size_t)bh * n_chunks + c) * rep + r;
      const float w = __expf(part_ml[p * 2] - mx);
      l += w * part_ml[p * 2 + 1];
      o += w * part_o[p * D + d];
    }
    out[(size_t)bh * rep * D + i] = from_f32<T>(o / fmaxf(l, 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const int8_t* kc, const float* ks, const int8_t* vc,
           const float* vs, const int* lengths, void* out, float* part_o,
           float* part_ml, int layer, int B, int Hkv, int S, int D, int rep,
           float scale, cudaStream_t st) {
  const int n_chunks = (S + CH - 1) / CH;
  flash_decode_chunk<T><<<dim3(B * Hkv, n_chunks), NT, 0, st>>>(
      reinterpret_cast<const T*>(q), kc, ks, vc, vs, lengths, part_o, part_ml,
      layer, B, Hkv, S, D, rep, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine<T><<<B * Hkv, NT, 0, st>>>(
      part_o, part_ml, lengths, reinterpret_cast<T*>(out), Hkv, S, D, rep, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// part_o: f32 [B * Hkv * ceil(S / 256) * rep * Dh], part_ml: f32 [... * rep * 2]
extern "C" int flash_decode_int8_launch(const void* q, int q_bf16, const void* kc,
                                        const void* ks, const void* vc,
                                        const void* vs, const void* lengths,
                                        void* out, void* part_o, void* part_ml,
                                        int layer, int B, int Hkv, int S, int D,
                                        int rep, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* k8 = reinterpret_cast<const int8_t*>(kc);
  const auto* v8 = reinterpret_cast<const int8_t*>(vc);
  const auto* kf = reinterpret_cast<const float*>(ks);
  const auto* vf = reinterpret_cast<const float*>(vs);
  const auto* ln = reinterpret_cast<const int*>(lengths);
  auto* po = reinterpret_cast<float*>(part_o);
  auto* pml = reinterpret_cast<float*>(part_ml);
  if (q_bf16)
    return launch<__nv_bfloat16>(q, k8, kf, v8, vf, ln, out, po, pml, layer, B, Hkv,
                                 S, D, rep, scale, st);
  return launch<float>(q, k8, kf, v8, vf, ln, out, po, pml, layer, B, Hkv, S, D,
                       rep, scale, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
