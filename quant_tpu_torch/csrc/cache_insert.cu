// In-place KV-cache row insert for Hopper (sm_90a): the contiguous cache, the
// paged pool and the MLA latent cache.
//
// Replaces: quant_tpu/kernels/cache_insert.py, cache_insert_int8 -> _kernel,
//   paged_cache_insert_int8 -> _paged_kernel and mla_cache_insert_int8 ->
//   _mla_kernel (the aliased Pallas TPU kernels).
//
// The GQA pair (rope_kv_insert_kernel) is fused with what feeds it: one
// launch per layer and decode step takes q [B, Hq, Dh] and k, v [B, Hkv, Dh]
// as the wqkv projection left them (bf16 or f32, any slot stride: views of
// one projection row), applies rotate-half RoPE to q and k with the step's
// cos / sin tables [B, Dh/2] f32 and yarn's attention factor, writes the
// rotated q [B, Hq, Dh] for the decode-attention kernel, quantizes k (as
// rounded to the activation type) and v to int8 with one f32 scale per
// (slot, head), and writes the K and V code rows and scales in place:
//
// contiguous: into the stacked caches [L, B, H, S, Dh] / [L, B, H, S] at
// [layer, b, h, lengths[b] - s0]. A position outside [0, S) writes nothing,
// which drops the writes of parked slots and of positions another sequence
// shard owns.
//
// paged: into the page pools [L, P, H, page, Dh] / [L, P, H, page] at
// [layer, page_tbl[b, pos / page], h, pos % page] with pos = lengths[b]; a
// position outside [0, max_pages * page) writes nothing. A parked slot
// (length 0, table row 0) writes into the reserved scratch page 0.
//
// Either way q is written for every slot. On the TPU, XLA fuses the same
// RoPE and quantization into the compiled step ahead of the Pallas insert;
// run eagerly on the card they were about 40 small kernels per layer.
//
// The result is byte-equal to that plain chain (kernels/rope_kv.py, then
// the codes-in inserts of kernels/cache_insert.py) on the card: the RoPE
// products and sums are rounded one by one (__fmul_rn / __fsub_rn /
// __fadd_rn, so nvcc contracts nothing into an FMA), the rotated k is
// rounded to the activation type before its absmax, scale = absmax times
// the f32 reciprocal of 127 (PyTorch's CUDA division by a Python scalar
// multiplies by the reciprocal) or 1 where absmax is 0, and each code is
// rintf of an IEEE division, unclamped, as the plain version.
//
// mla_cache_insert_int8: one latent row [Dq] int8 (c_kv | k_rope | zero pad)
// and its one f32 scale per slot into the stacked latent cache
// [L, B, 1, S, Dq] / [L, B, 1, S] at [layer, b, 0, lengths[b] - s0]; a
// position outside [0, S) writes nothing. The V side of an MLA cache is
// zero-width.
//
// What bounds it on this card: launch latency. The fused kernel moves about
// 183 KB per Llama-3-8B B=8 call (0.055 us at the data sheet's 3.35 TB/s)
// and took 0.0024 ms (paged 0.0026) on an NVIDIA H100 80GB HBM3 at
// 700.00 W, where the unfused chain took 0.1000 (0.2046); the latent
// insert moves a few KB. Design: the fused kernel gives one warp to each
// (slot, head row) of q, k and v, four rows a block; lane l holds the
// rotate-half pairs (p, p + Dh/2) for p = l, l + 32, ..., so a pair sits in
// one lane's registers, a warp's loads and code stores are coalesced, and
// the row's absmax is a __shfl_xor_sync max (exact in any order). The
// latent insert gives one block to each slot, each thread copying bytes of
// the row. On the GPU a row is directly addressable, so the TPU kernels'
// aligned read-modify-write tiles, DMA waves and lane views have no
// counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // rows per block, one warp each
constexpr int kMaxPairs = 4;     // rotate-half pairs per lane: Dh <= 256
constexpr float kInv127 = 1.0f / 127.0f;

// activation type: load as f32, round to the type, store
template <typename T>
struct Act;

template <>
struct Act<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

// row of the contiguous stacked cache [L, B, H, S, Dh], or -1 (dropped)
struct ContiguousRows {
  int s0, S;
  __device__ __forceinline__ long long row(int layer, int b, int h, int B,
                                           int H, int len) const {
    const int pos = len - s0;
    if (pos < 0 || pos >= S) return -1;
    return (((long long)layer * B + b) * H + h) * S + pos;
  }
};

// row of the page pool [L, P, H, page, Dh] through the page table, or -1
struct PagedRows {
  const int* page_tbl;
  int P, page, max_pages;
  __device__ __forceinline__ long long row(int layer, int b, int h, int,
                                           int H, int pos) const {
    if (pos < 0 || pos >= max_pages * page) return -1;
    const int pg = page_tbl[(long long)b * max_pages + pos / page];
    return (((long long)layer * P + pg) * H + h) * page + pos % page;
  }
};

template <typename T>
struct FusedArgs {
  T* q_out;                          // [B, Hq, Dh]
  const T *q, *k, *v;                // [B, Hq | Hkv, Dh], heads packed
  long long sq, sk, sv;              // slot strides (elements)
  const float *cos, *sin;            // [B, Dh / 2]
  int8_t* kc;
  float* ks;
  int8_t* vc;
  float* vs;
  const int* lengths;                // [B]
  int layer, B, Hq, Hkv, Dh;
  float attn_factor;
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(kWarps * 32)
    rope_kv_insert_kernel(const FusedArgs<T> a, const Rows rows) {
  const int lane = threadIdx.x & 31;
  const int units = a.Hq + 2 * a.Hkv;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= a.B * units) return;       // whole warps leave together
  const int b = r / units, u = r % units, half = a.Dh / 2;
  const bool is_q = u < a.Hq, is_k = !is_q && u < a.Hq + a.Hkv;
  const int h = is_q ? u : is_k ? u - a.Hq : u - a.Hq - a.Hkv;
  const T* src = (is_q ? a.q + b * a.sq : is_k ? a.k + b * a.sk
                                               : a.v + b * a.sv) +
                 (long long)h * a.Dh;
  float x1[kMaxPairs], x2[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = lane + 32 * i;
    x1[i] = x2[i] = 0.f;
    if (p < half) {
      x1[i] = Act<T>::load(src + p);
      x2[i] = Act<T>::load(src + p + half);
    }
  }
  if (is_q || is_k) {
    const float* c = a.cos + (long long)b * half;
    const float* s = a.sin + (long long)b * half;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < half) {
        const float cp = c[p], sp = s[p];
        const float y1 = __fsub_rn(__fmul_rn(x1[i], cp), __fmul_rn(x2[i], sp));
        const float y2 = __fadd_rn(__fmul_rn(x2[i], cp), __fmul_rn(x1[i], sp));
        x1[i] = Act<T>::round(__fmul_rn(y1, a.attn_factor));
        x2[i] = Act<T>::round(__fmul_rn(y2, a.attn_factor));
      }
    }
    if (is_q) {
      T* out = a.q_out + ((long long)b * a.Hq + h) * a.Dh;
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        const int p = lane + 32 * i;
        if (p < half) {
          Act<T>::store(out + p, x1[i]);
          Act<T>::store(out + p + half, x2[i]);
        }
      }
      return;
    }
  }
  // a K or V row: one scale per (slot, head), over the whole warp
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) m = fmaxf(m, fmaxf(fabsf(x1[i]), fabsf(x2[i])));
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const long long row = rows.row(a.layer, b, h, a.B, a.Hkv, a.lengths[b]);
  if (row < 0) return;
  const float scale = m == 0.f ? 1.f : __fmul_rn(m, kInv127);
  int8_t* codes = (is_k ? a.kc : a.vc) + row * a.Dh;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = lane + 32 * i;
    if (p < half) {
      codes[p] = (int8_t)(int)rintf(__fdiv_rn(x1[i], scale));
      codes[p + half] = (int8_t)(int)rintf(__fdiv_rn(x2[i], scale));
    }
  }
  if (lane == 0) (is_k ? a.ks : a.vs)[row] = scale;
}

template <typename T, typename Rows>
int launch_fused(void* q_out, const void* q, const void* k, const void* v,
                 long long sq, long long sk, long long sv, const void* cos,
                 const void* sin, void* kc, void* ks, void* vc, void* vs,
                 const void* lengths, int layer, int B, int Hq, int Hkv,
                 int Dh, float attn_factor, const Rows& rows, void* stream) {
  const FusedArgs<T> a{
      reinterpret_cast<T*>(q_out), reinterpret_cast<const T*>(q),
      reinterpret_cast<const T*>(k), reinterpret_cast<const T*>(v), sq, sk,
      sv, reinterpret_cast<const float*>(cos),
      reinterpret_cast<const float*>(sin), reinterpret_cast<int8_t*>(kc),
      reinterpret_cast<float*>(ks), reinterpret_cast<int8_t*>(vc),
      reinterpret_cast<float*>(vs), reinterpret_cast<const int*>(lengths),
      layer, B, Hq, Hkv, Dh, attn_factor};
  const int n_rows = B * (Hq + 2 * Hkv);
  rope_kv_insert_kernel<T, Rows><<<(n_rows + kWarps - 1) / kWarps,
                                   kWarps * 32, 0,
                                   reinterpret_cast<cudaStream_t>(stream)>>>(
      a, rows);
  return (int)cudaGetLastError();
}

template <typename Rows>
int launch_fused_for(int bf16, void* q_out, const void* q, const void* k,
                     const void* v, long long sq, long long sk, long long sv,
                     const void* cos, const void* sin, void* kc, void* ks,
                     void* vc, void* vs, const void* lengths, int layer, int B,
                     int Hq, int Hkv, int Dh, float attn_factor,
                     const Rows& rows, void* stream) {
  return bf16 ? launch_fused<__nv_bfloat16>(q_out, q, k, v, sq, sk, sv, cos,
                                            sin, kc, ks, vc, vs, lengths,
                                            layer, B, Hq, Hkv, Dh,
                                            attn_factor, rows, stream)
              : launch_fused<float>(q_out, q, k, v, sq, sk, sv, cos, sin, kc,
                                    ks, vc, vs, lengths, layer, B, Hq, Hkv,
                                    Dh, attn_factor, rows, stream);
}

__global__ void mla_cache_insert_kernel(int8_t* __restrict__ kc, float* __restrict__ ks,
                                        const int8_t* __restrict__ kn,
                                        const float* __restrict__ kns,
                                        const int* __restrict__ lengths, int layer,
                                        int s0, int B, int S, int D) {
  const int b = blockIdx.x;
  const int pos = lengths[b] - s0;
  if (pos < 0 || pos >= S) return;
  const size_t row = ((size_t)layer * B + b) * S + pos;
  for (int d = threadIdx.x; d < D; d += blockDim.x) kc[row * D + d] = kn[(size_t)b * D + d];
  if (threadIdx.x == 0) ks[row] = kns[b];
}

int threads_for(int D) { return D >= 128 ? 128 : ((D + 31) / 32) * 32; }

}  // namespace

extern "C" int cache_insert_int8_fused_launch(
    void* q_out, const void* q, const void* k, const void* v, long long sq,
    long long sk, long long sv, const void* cos, const void* sin, void* kc,
    void* ks, void* vc, void* vs, const void* lengths, int layer, int s0,
    int S, int B, int Hq, int Hkv, int Dh, float attn_factor, int bf16,
    void* stream) {
  return launch_fused_for(bf16, q_out, q, k, v, sq, sk, sv, cos, sin, kc, ks,
                          vc, vs, lengths, layer, B, Hq, Hkv, Dh, attn_factor,
                          ContiguousRows{s0, S}, stream);
}

extern "C" int paged_cache_insert_int8_fused_launch(
    void* q_out, const void* q, const void* k, const void* v, long long sq,
    long long sk, long long sv, const void* cos, const void* sin, void* kc,
    void* ks, void* vc, void* vs, const void* page_tbl, const void* lengths,
    int layer, int P, int page, int max_pages, int B, int Hq, int Hkv, int Dh,
    float attn_factor, int bf16, void* stream) {
  return launch_fused_for(
      bf16, q_out, q, k, v, sq, sk, sv, cos, sin, kc, ks, vc, vs, lengths,
      layer, B, Hq, Hkv, Dh, attn_factor,
      PagedRows{reinterpret_cast<const int*>(page_tbl), P, page, max_pages},
      stream);
}

extern "C" int mla_cache_insert_int8_launch(void* kc, void* ks, const void* kn,
                                            const void* kns, const void* lengths,
                                            int layer, int s0, int B, int S, int D,
                                            void* stream) {
  mla_cache_insert_kernel<<<B, threads_for(D), 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<int8_t*>(kc), reinterpret_cast<float*>(ks),
      reinterpret_cast<const int8_t*>(kn), reinterpret_cast<const float*>(kns),
      reinterpret_cast<const int*>(lengths), layer, s0, B, S, D);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
