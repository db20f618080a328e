// MLA (DeepSeek multi-head latent attention) flash decode for Hopper (sm_90a).
//
// Replaces: quant_tpu/kernels/mla_attention.py, mla_flash_decode_int8 ->
//   _kernel (the Pallas TPU kernel).
//
// Decode-step (T=1) attention in the absorbed form: MQA of the queries
// q_eff [B, H, Dq] against one shared int8 latent row per token,
// [c_kv (r) | k_rope | zero pad] of Dq lanes, with one f32 scale per row, in
// the stacked cache [L, B, 1, S, Dq] / [L, B, 1, S]. The value read is the
// row's first r lanes. The row scale multiplies the logits after the q.k
// product and the probabilities before the p.v product (it factors out of
// both sums), with an online softmax; rows at or past lengths[b] are masked.
// Output [B, H, r] = acc / max(l, 1e-20): a slot of length 0 gives zeros.
//
// What bounds it on this card: the latent bytes of each slot's actual
// context (Dq + 4 bytes per token, shared by all H heads), so device-memory
// bandwidth at the roofline; this first kernel computes both dots on the
// CUDA cores in f32 (H * (Dq + r) multiply-adds per token), so in practice
// it is bound by instruction issue, the more so at H=128.
//
// Design: split-S, each latent row read from device memory once per head
// tile. Block (b, head tile, chunk) owns HT=16 heads of slot b and a chunk
// of chunk_tiles * 64 tokens; chunks at or past the slot's length exit at
// once, so tokens past the length are neither loaded nor computed. A block
// walks its chunk in 64-token tiles: all threads stage the tile's rows into
// shared memory (16-byte loads; a row pitch of Dq + 4 bytes keeps the score
// pass's reads on distinct banks) and the one staged copy feeds both dots:
// the score pass (thread (h, j) dots head h's pre-scaled query over all Dq
// lanes with tokens j, j + 16, j + 32, j + 48), the softmax step (one warp
// per two heads), and the value pass over the first r lanes (thread t owns
// value lanes 2t and 2t + 1 for all 16 heads, 32 accumulators in
// registers). A second kernel merges the chunks of each (slot, head) by
// their maxima.
//
// The head count is where the shapes part: at H=16 (DeepSeek-V2-Lite) one
// head tile holds the whole query (16 x 640 f32 = 40 KB of shared memory)
// and the accumulator (16 x 512 f32, 32 registers a thread). At H=128
// (DeepSeek-V3) the query alone (320 KB) and the accumulator (256 KB) exceed
// what a block has, so the grid splits the heads into 8 tiles of 16 and each
// tile re-reads the chunk's rows, mostly from L2 (the tiles of one chunk run
// side by side). Splitting the r value lanes instead would have every split
// recompute the full-width scores. The wrapper gives a chunk more tiles
// when the grid at full lengths would hold many more blocks than two per SM,
// so fewer partials are written and merged. TMA, wgmma and tuning come
// later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int HT = 16;           // heads per block (head tile)
constexpr int TT = 64;           // tokens per staged tile
constexpr int TPT = TT / 16;     // tokens per thread in the score pass
constexpr int KPAD = 4;          // latent row padding in shared memory (bytes)
constexpr int CT = 128;          // threads of the merge kernel
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

// dynamic shared memory: q [HT][Dq] f32, p [TT][HT] f32, row scales [TT],
// (m, l, alpha) [HT] each, then the staged rows [TT][Dq + KPAD] int8
size_t smem_bytes(int Dq) {
  return sizeof(float) * ((size_t)HT * Dq + TT * HT + TT + 3 * HT) +
         (size_t)TT * (Dq + KPAD);
}

template <typename T>
__global__ void __launch_bounds__(NT)
mla_decode_chunk(const T* __restrict__ q, const int8_t* __restrict__ kc,
                 const float* __restrict__ ks, const int* __restrict__ lengths,
                 float* __restrict__ part_o, float* __restrict__ part_ml, int layer,
                 int B, int H, int S, int Dq, int r, int chunk_tok, int n_chunks,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // [HT][Dq], pre-scaled
  float* p_s = q_s + HT * Dq;                    // [TT][HT]: scores, then p * ks
  float* ks_s = p_s + TT * HT;                   // [TT]
  float* m_s = ks_s + TT;
  float* l_s = m_s + HT;
  float* a_s = l_s + HT;
  int8_t* k_t = reinterpret_cast<int8_t*>(a_s + HT);  // [TT][Dq + KPAD]
  const int KP = Dq + KPAD;

  const int n_ht = (H + HT - 1) / HT;
  const int b = blockIdx.x / n_ht, h0 = (blockIdx.x % n_ht) * HT;
  const int nh = min(HT, H - h0);
  const int chunk = blockIdx.y;
  const int len = max(0, min(lengths[b], S));
  const int c0 = chunk * chunk_tok;
  if (c0 >= len) return;  // the merge reads only chunks below the length
  const int c1 = min(len, c0 + chunk_tok);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < HT * Dq; i += NT) {
    const int hh = i / Dq, d = i - hh * Dq;
    q_s[i] = hh < nh ? to_f32(q[((size_t)b * H + h0 + hh) * Dq + d]) * scale : 0.f;
  }
  if (tid < HT) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;
  }
  const int col = 2 * tid;  // this thread's value lanes: col, col + 1
  const bool has_col = col < r;
  float acc[HT][2];
#pragma unroll
  for (int hh = 0; hh < HT; ++hh) acc[hh][0] = acc[hh][1] = 0.f;

  const size_t row0 = ((size_t)layer * B + b) * S;  // latent row of token 0
  const int8_t* src = kc + row0 * Dq;
  const int units_per_row = Dq / 16;

  for (int t0 = c0; t0 < c1; t0 += TT) {
    const int n_tok = min(TT, c1 - t0);
    for (int u = tid; u < n_tok * units_per_row; u += NT) {
      const int j = u / units_per_row, c = (u - j * units_per_row) * 16;
      const int4 w = *reinterpret_cast<const int4*>(src + (size_t)(t0 + j) * Dq + c);
      int* dst = reinterpret_cast<int*>(k_t + j * KP + c);
      dst[0] = w.x;
      dst[1] = w.y;
      dst[2] = w.z;
      dst[3] = w.w;
    }
    if (tid < TT) ks_s[tid] = tid < n_tok ? ks[row0 + t0 + tid] : 0.f;
    __syncthreads();

    // scores over all Dq lanes: head hh, tokens jj + 16 i
    {
      const int hh = tid >> 4, jj = tid & 15;
      const float* qrow = q_s + hh * Dq;
      float dots[TPT];
#pragma unroll
      for (int i = 0; i < TPT; ++i) dots[i] = 0.f;
      for (int d = 0; d < Dq; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
        for (int i = 0; i < TPT; ++i) {
          const char4 k4 = *reinterpret_cast<const char4*>(k_t + (jj + 16 * i) * KP + d);
          dots[i] = fmaf(qv.x, float(k4.x), dots[i]);
          dots[i] = fmaf(qv.y, float(k4.y), dots[i]);
          dots[i] = fmaf(qv.z, float(k4.z), dots[i]);
          dots[i] = fmaf(qv.w, float(k4.w), dots[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int j = jj + 16 * i;
        p_s[j * HT + hh] = j < n_tok ? dots[i] * ks_s[j] : NEG;
      }
    }
    __syncthreads();

    // online softmax: one warp per head, two tokens per lane; heads past
    // the last get zero probabilities
    for (int hh = warp; hh < HT; hh += NT / 32) {
      if (hh >= nh) {
        p_s[lane * HT + hh] = 0.f;
        p_s[(lane + 32) * HT + hh] = 0.f;
        continue;
      }
      const float v0 = p_s[lane * HT + hh], v1 = p_s[(lane + 32) * HT + hh];
      float mx = fmaxf(v0, v1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[hh];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = lane < n_tok ? __expf(v0 - m_new) : 0.f;
      const float p1 = lane + 32 < n_tok ? __expf(v1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[lane * HT + hh] = p0 * ks_s[lane];
      p_s[(lane + 32) * HT + hh] = p1 * ks_s[lane + 32];
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        l_s[hh] = l_s[hh] * alpha + sum;
        m_s[hh] = m_new;
        a_s[hh] = alpha;
      }
    }
    __syncthreads();

    // values: the first r lanes of the same staged rows
    if (has_col) {
#pragma unroll
      for (int hh = 0; hh < HT; ++hh) {
        const float a = a_s[hh];
        acc[hh][0] *= a;
        acc[hh][1] *= a;
      }
      for (int j = 0; j < n_tok; ++j) {
        const char2 kv = *reinterpret_cast<const char2*>(k_t + j * KP + col);
        const float k0 = float(kv.x), k1 = float(kv.y);
        const float4* pj = reinterpret_cast<const float4*>(p_s + j * HT);
#pragma unroll
        for (int q4 = 0; q4 < HT / 4; ++q4) {
          const float4 pv = pj[q4];
          acc[4 * q4 + 0][0] = fmaf(pv.x, k0, acc[4 * q4 + 0][0]);
          acc[4 * q4 + 0][1] = fmaf(pv.x, k1, acc[4 * q4 + 0][1]);
          acc[4 * q4 + 1][0] = fmaf(pv.y, k0, acc[4 * q4 + 1][0]);
          acc[4 * q4 + 1][1] = fmaf(pv.y, k1, acc[4 * q4 + 1][1]);
          acc[4 * q4 + 2][0] = fmaf(pv.z, k0, acc[4 * q4 + 2][0]);
          acc[4 * q4 + 2][1] = fmaf(pv.z, k1, acc[4 * q4 + 2][1]);
          acc[4 * q4 + 3][0] = fmaf(pv.w, k0, acc[4 * q4 + 3][0]);
          acc[4 * q4 + 3][1] = fmaf(pv.w, k1, acc[4 * q4 + 3][1]);
        }
      }
    }
    __syncthreads();
  }

  // unnormalised partial of this chunk: o [b, h, chunk, r], (m, l) [b, h, chunk]
  if (has_col) {
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) {
      if (hh < nh) {
        const size_t p = ((size_t)b * H + h0 + hh) * n_chunks + chunk;
        *reinterpret_cast<float2*>(part_o + p * r + col) = make_float2(acc[hh][0], acc[hh][1]);
      }
    }
  }
  if (tid < nh) {
    const size_t p = ((size_t)b * H + h0 + tid) * n_chunks + chunk;
    part_ml[p * 2] = m_s[tid];
    part_ml[p * 2 + 1] = l_s[tid];
  }
}

// Merge the chunks of each (slot, head): out = sum_c e^(m_c - M) o_c /
// max(sum_c e^(m_c - M) l_c, 1e-20) over the chunks below the length.
template <typename T>
__global__ void __launch_bounds__(CT)
mla_decode_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                   const int* __restrict__ lengths, T* __restrict__ out, int H, int S,
                   int r, int chunk_tok, int n_chunks) {
  const int bh = blockIdx.x, b = bh / H;
  const int len = max(0, min(lengths[b], S));
  const int used = (len + chunk_tok - 1) / chunk_tok;
  const size_t p0 = (size_t)bh * n_chunks;
  float mx = NEG;
  for (int c = 0; c < used; ++c) mx = fmaxf(mx, part_ml[(p0 + c) * 2]);
  float l = 0.f;
  for (int c = 0; c < used; ++c)
    l += __expf(part_ml[(p0 + c) * 2] - mx) * part_ml[(p0 + c) * 2 + 1];
  for (int col = threadIdx.x; col < r; col += CT) {
    float o = 0.f;
    for (int c = 0; c < used; ++c)
      o += __expf(part_ml[(p0 + c) * 2] - mx) * part_o[(p0 + c) * r + col];
    out[(size_t)bh * r + col] = from_f32<T>(o / fmaxf(l, 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const int8_t* kc, const float* ks, const int* lengths,
           void* out, float* part_o, float* part_ml, int layer, int B, int H, int S,
           int Dq, int r, int tiles, float scale, cudaStream_t st) {
  const int chunk_tok = TT * tiles;
  const int n_chunks = (S + chunk_tok - 1) / chunk_tok;
  const int n_ht = (H + HT - 1) / HT;
  const size_t smem = smem_bytes(Dq);
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mla_decode_chunk<T><<<dim3(B * n_ht, n_chunks), NT, smem, st>>>(
      reinterpret_cast<const T*>(q), kc, ks, lengths, part_o, part_ml, layer, B, H, S,
      Dq, r, chunk_tok, n_chunks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_decode_combine<T><<<B * H, CT, 0, st>>>(part_o, part_ml, lengths,
                                               reinterpret_cast<T*>(out), H, S, r,
                                               chunk_tok, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, Dq] (f32, or bf16 when q_bf16); latent cache [L, B, 1, S, Dq] int8 /
// [L, B, 1, S] f32; out [B, H, r] in q's type; part_o f32
// [B * H * n_chunks * r], part_ml f32 [B * H * n_chunks * 2] with
// n_chunks = ceil(S / (64 * chunk_tiles)). Dq a multiple of 16 up to 1024,
// r even, up to min(Dq, 512).
extern "C" int mla_flash_decode_int8_launch(const void* q, int q_bf16, const void* kc,
                                            const void* ks, const void* lengths,
                                            void* out, void* part_o, void* part_ml,
                                            int layer, int B, int H, int S, int Dq,
                                            int r, int chunk_tiles, float scale,
                                            void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* k8 = reinterpret_cast<const int8_t*>(kc);
  const auto* kf = reinterpret_cast<const float*>(ks);
  const auto* ln = reinterpret_cast<const int*>(lengths);
  auto* po = reinterpret_cast<float*>(part_o);
  auto* pml = reinterpret_cast<float*>(part_ml);
  if (q_bf16)
    return launch<__nv_bfloat16>(q, k8, kf, ln, out, po, pml, layer, B, H, S, Dq, r,
                                 chunk_tiles, scale, st);
  return launch<float>(q, k8, kf, ln, out, po, pml, layer, B, H, S, Dq, r, chunk_tiles,
                       scale, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
