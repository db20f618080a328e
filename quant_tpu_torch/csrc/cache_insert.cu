// In-place KV-cache row insert for Hopper (sm_90a), fused with what feeds
// it: the contiguous cache, the paged pool and the MLA latent cache or pool.
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
// The int4 cache (kv_bits=4) takes the same launch: codes uint8 [.., H/2,
// .., Dh] packed across head pairs (byte d of packed head j: real head 2j's
// code plus 8 in the low nibble, 2j + 1's in the high one), scales per real
// head, scale = absmax times fl(1/7) (how PyTorch's CUDA absmax / 7.0
// rounds) or 1. Two warps writing the two nibbles of one byte would race,
// so one warp owns a (slot, head pair) of K, and one of V: it loads (and
// for K rotates) both heads' rows, takes both absmaxes, and stores each
// byte once.
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
// The MLA latent insert (mla_rope_insert_kernel) is fused likewise: one
// launch per MLA layer and decode step takes ckv [B, r + dr] and q_pe
// [B, H, dr] as the projections left them (strided views) and q_abs
// [B, H, r] (the w_uk product, any slot and head stride), and
//   - c = RMSNorm(ckv[:r]) with the f32 gain [r] and eps (f32 square, mean
//     as the sum times fl(1/r), rsqrtf of var + eps, two products), rounded
//     to the activation type;
//   - k_pe and q_pe rotated with the step's tables and yarn's attention
//     factor, the rotary pairs interleaved (DeepSeek: (2i, 2i + 1), written
//     de-interleaved as [evens | odds]) or rotate-half;
//   - the latent row [c | k_pe | 0 ... 0] of Dq lanes quantized to int8
//     with one f32 scale and written into the stacked latent cache
//     [L, B, 1, S, Dq] / [L, B, 1, S] at [layer, b, 0, lengths[b] - s0]
//     (outside [0, S): nothing; the V side of an MLA cache is zero-width),
//     or into the latent pool [L, P, 1, page, Dq] / [L, P, 1, page] at
//     [layer, page_tbl[b, pos / page], 0, pos % page] with pos =
//     lengths[b] (outside [0, max_pages * page): nothing), through the
//     same row policies as the GQA pair;
//   - q_eff [B, H, Dq] = [q_abs | RoPE(q_pe) | 0 ... 0] written for every
//     slot, the query mla_flash_decode_int8 takes.
// Its plain chain (rmsnorm, rope_apply, cat and pad, quantize_kv, the
// codes-in insert) is about 45 kernels a layer when run eagerly. The
// RMSNorm's sum of squares is taken in another order than ATen's
// reduction, so c can differ from the chain's by one rounding step where
// the f32 result falls on a rounding boundary; everything else rounds as
// the chain does.
//
// What bounds them on this card: launch latency. The GQA kernel moves about
// 183 KB per Llama-3-8B B=8 call (0.055 us at the data sheet's 3.35 TB/s)
// and took 0.0024 ms (paged 0.0026) on an NVIDIA H100 80GB HBM3 at
// 700.00 W, where the unfused chain took 0.1000 (0.2046); the MLA kernel
// moves about 330 KB at DeepSeek-V2-Lite's B=8, H=16 (q_abs read, q_eff
// written; 0.1 us) and 2.5 MB at DeepSeek-V3's H=128 (0.75 us), and took
// 0.0038 ms (H=128: 0.0041) on the same card, where its chain took 0.1014
// (0.1072): the latent row's chain of dependent steps (loads, the sum of
// squares, rsqrtf, the absmax, 18 IEEE divisions a lane) sets it, so
// every load of a row is issued before its first use. Tensor cores, TMA
// and wgmma have nothing to do here: there is no product, and each row is
// read and written once. Design: one warp to each row, four rows a block, so a
// warp's loads and stores are coalesced and a row's reductions are
// __shfl_xor_sync trees. GQA: each (slot, head row) of q, k and v; lane l
// holds the rotate-half pairs (p, p + Dh/2) for p = l, l + 32, ..., so a
// pair sits in one lane's registers and the absmax is a max (exact in any
// order). MLA: each (slot, head) row of q_eff, q_abs copied with 16-byte
// accesses where its rows are aligned, one rotary pair to a lane (an
// interleaved pair is adjacent in memory), the pad zeroed; and one more
// row per slot for the latent, lane l holding c's lanes l, l + 32, ...
// (16 at r = 512) and a rotary pair, the sum of squares an f32 shuffle
// sum and the absmax a shuffle max. On the GPU a row is directly
// addressable, so the TPU kernels' aligned read-modify-write tiles, DMA
// waves and lane views have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // rows per block, one warp each
constexpr int kMaxPairs = 4;     // rotary pairs per lane: Dh, dr <= 256
constexpr int kMaxLat = 16;      // latent c lanes per lane: r <= 512
constexpr int kMaxVec = 4;       // 16-byte q_abs pieces per lane (f32 r 512)
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kInv7 = 1.0f / 7.0f;

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
  int8_t* kc;                        // KV4: uint8 codes of H / 2 heads
  float* ks;
  int8_t* vc;
  float* vs;
  const int* lengths;                // [B]
  int layer, B, Hq, Hkv, Dh;
  float attn_factor;
};

// KV4: the int4 head-pair cache, a K or V unit being a pair of real heads
template <typename T, typename Rows, bool KV4>
__global__ void __launch_bounds__(kWarps * 32)
    rope_kv_insert_kernel(const FusedArgs<T> a, const Rows rows) {
  constexpr int NP = KV4 ? 2 : 1;    // real heads of a K or V unit
  const int lane = threadIdx.x & 31;
  const int hu = a.Hkv / NP;          // K (and V) units of a slot
  const int units = a.Hq + 2 * hu;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= a.B * units) return;       // whole warps leave together
  const int b = r / units, u = r % units, half = a.Dh / 2;
  const bool is_q = u < a.Hq, is_k = !is_q && u < a.Hq + hu;
  // the q head, or the K / V unit (real heads NP h .. NP h + np - 1)
  const int h = is_q ? u : is_k ? u - a.Hq : u - a.Hq - hu;
  const int np = is_q ? 1 : NP;
  const T* src = (is_q ? a.q + b * a.sq : is_k ? a.k + b * a.sk
                                               : a.v + b * a.sv) +
                 (long long)h * np * a.Dh;
  float x1[NP][kMaxPairs], x2[NP][kMaxPairs];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      x1[j][i] = x2[j][i] = 0.f;
      if (j < np && p < half) {
        x1[j][i] = Act<T>::load(src + j * a.Dh + p);
        x2[j][i] = Act<T>::load(src + j * a.Dh + p + half);
      }
    }
  if (is_q || is_k) {
    const float* c = a.cos + (long long)b * half;
    const float* s = a.sin + (long long)b * half;
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        const int p = lane + 32 * i;
        if (j < np && p < half) {
          const float cp = c[p], sp = s[p];
          const float y1 = __fsub_rn(__fmul_rn(x1[j][i], cp), __fmul_rn(x2[j][i], sp));
          const float y2 = __fadd_rn(__fmul_rn(x2[j][i], cp), __fmul_rn(x1[j][i], sp));
          x1[j][i] = Act<T>::round(__fmul_rn(y1, a.attn_factor));
          x2[j][i] = Act<T>::round(__fmul_rn(y2, a.attn_factor));
        }
      }
    if (is_q) {
      T* out = a.q_out + ((long long)b * a.Hq + h) * a.Dh;
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        const int p = lane + 32 * i;
        if (p < half) {
          Act<T>::store(out + p, x1[0][i]);
          Act<T>::store(out + p + half, x2[0][i]);
        }
      }
      return;
    }
  }
  // a K or V unit: one scale per (slot, real head), over the whole warp
  float scale[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) m = fmaxf(m, fmaxf(fabsf(x1[j][i]), fabsf(x2[j][i])));
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    scale[j] = m == 0.f ? 1.f : __fmul_rn(m, KV4 ? kInv7 : kInv127);
  }
  const int len = a.lengths[b];
  const long long row = rows.row(a.layer, b, h, a.B, hu, len);
  if (row < 0) return;
  if constexpr (KV4) {
    uint8_t* codes = reinterpret_cast<uint8_t*>(is_k ? a.kc : a.vc) + row * a.Dh;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < half) {
        const int l1 = (int)rintf(__fdiv_rn(x1[0][i], scale[0])) + 8;
        const int h1 = (int)rintf(__fdiv_rn(x1[1][i], scale[1])) + 8;
        const int l2 = (int)rintf(__fdiv_rn(x2[0][i], scale[0])) + 8;
        const int h2 = (int)rintf(__fdiv_rn(x2[1][i], scale[1])) + 8;
        codes[p] = (uint8_t)(l1 | (h1 << 4));
        codes[p + half] = (uint8_t)(l2 | (h2 << 4));
      }
    }
    if (lane < 2)
      (is_k ? a.ks : a.vs)[rows.row(a.layer, b, 2 * h + lane, a.B, a.Hkv, len)] =
          scale[lane & 1];
  } else {
    int8_t* codes = (is_k ? a.kc : a.vc) + row * a.Dh;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < half) {
        codes[p] = (int8_t)(int)rintf(__fdiv_rn(x1[0][i], scale[0]));
        codes[p + half] = (int8_t)(int)rintf(__fdiv_rn(x2[0][i], scale[0]));
      }
    }
    if (lane == 0) (is_k ? a.ks : a.vs)[row] = scale[0];
  }
}

template <typename T, typename Rows>
int launch_fused(void* q_out, const void* q, const void* k, const void* v,
                 long long sq, long long sk, long long sv, const void* cos,
                 const void* sin, void* kc, void* ks, void* vc, void* vs,
                 const void* lengths, int layer, int B, int Hq, int Hkv,
                 int Dh, float attn_factor, int kv4, const Rows& rows,
                 void* stream) {
  const FusedArgs<T> a{
      reinterpret_cast<T*>(q_out), reinterpret_cast<const T*>(q),
      reinterpret_cast<const T*>(k), reinterpret_cast<const T*>(v), sq, sk,
      sv, reinterpret_cast<const float*>(cos),
      reinterpret_cast<const float*>(sin), reinterpret_cast<int8_t*>(kc),
      reinterpret_cast<float*>(ks), reinterpret_cast<int8_t*>(vc),
      reinterpret_cast<float*>(vs), reinterpret_cast<const int*>(lengths),
      layer, B, Hq, Hkv, Dh, attn_factor};
  const int n_rows = B * (Hq + 2 * (kv4 ? Hkv / 2 : Hkv));
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kv4)
    rope_kv_insert_kernel<T, Rows, true><<<blocks, kWarps * 32, 0, st>>>(a, rows);
  else
    rope_kv_insert_kernel<T, Rows, false><<<blocks, kWarps * 32, 0, st>>>(a, rows);
  return (int)cudaGetLastError();
}

template <typename Rows>
int launch_fused_for(int bf16, void* q_out, const void* q, const void* k,
                     const void* v, long long sq, long long sk, long long sv,
                     const void* cos, const void* sin, void* kc, void* ks,
                     void* vc, void* vs, const void* lengths, int layer, int B,
                     int Hq, int Hkv, int Dh, float attn_factor, int kv4,
                     const Rows& rows, void* stream) {
  if (kv4 && Hkv % 2) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_fused<__nv_bfloat16>(q_out, q, k, v, sq, sk, sv, cos,
                                            sin, kc, ks, vc, vs, lengths,
                                            layer, B, Hq, Hkv, Dh,
                                            attn_factor, kv4, rows, stream)
              : launch_fused<float>(q_out, q, k, v, sq, sk, sv, cos, sin, kc,
                                    ks, vc, vs, lengths, layer, B, Hq, Hkv,
                                    Dh, attn_factor, kv4, rows, stream);
}

template <typename T>
struct MlaArgs {
  T* q_out;                          // [B, H, Dq]
  const T *q_abs, *q_pe, *ckv;       // [B, H, r], [B, H, dr], [B, r + dr]
  long long sab, sah, spb, sph, scb; // slot and head strides (elements)
  const float *w, *cos, *sin;        // [r]; [B, dr / 2]
  int8_t* kc;                        // [L, B, 1, S, Dq] or [L, P, 1, page, Dq]
  float* ks;                         // [L, B, 1, S] or [L, P, 1, page]
  const int* lengths;                // [B]
  int layer, B, H, r, dr, Dq;
  float eps, attn_factor;
  int interleaved, vec;
};

// one rotary pair (x1, x2) rotated in place by (c, s) and times the
// attention factor f, each product and sum rounded on its own, as
// kernels/rope_kv.py rope_apply computes it (before its rounding to the
// activation type)
__device__ __forceinline__ void rotate(float& x1, float& x2, float c,
                                       float s, float f) {
  const float y1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  const float y2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
  x1 = __fmul_rn(y1, f);
  x2 = __fmul_rn(y2, f);
}

template <typename T, typename Rows>
__global__ void __launch_bounds__(kWarps * 32)
    mla_rope_insert_kernel(const MlaArgs<T> a, const Rows rows) {
  const int lane = threadIdx.x & 31;
  const int units = a.H + 1;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.B * units) return;     // whole warps leave together
  const int b = row / units, u = row % units, half = a.dr / 2;
  const float* cs = a.cos + (long long)b * half;
  const float* sn = a.sin + (long long)b * half;
  const bool il = a.interleaved != 0;
  if (u < a.H) {
    // a q_eff row: [q_abs | RoPE(q_pe) | 0 ... 0]; every load is issued
    // before the first store (the compiler may not move a load past a
    // store that could alias it)
    T* out = a.q_out + ((long long)b * a.H + u) * a.Dq;
    const T* qa = a.q_abs + b * a.sab + u * a.sah;
    const T* qp = a.q_pe + b * a.spb + u * a.sph;
    float y1[kMaxPairs], y2[kMaxPairs], yc[kMaxPairs], ys[kMaxPairs];
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < half) {
        y1[i] = Act<T>::load(qp + (il ? 2 * p : p));
        y2[i] = Act<T>::load(qp + (il ? 2 * p + 1 : p + half));
        yc[i] = cs[p];
        ys[i] = sn[p];
      }
    }
    if (a.vec) {
      const int n = a.r * (int)sizeof(T) / 16;
      uint4 v[kMaxVec];
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i)
        if (lane + 32 * i < n)
          v[i] = reinterpret_cast<const uint4*>(qa)[lane + 32 * i];
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i)
        if (lane + 32 * i < n)
          reinterpret_cast<uint4*>(out)[lane + 32 * i] = v[i];
    } else {
      float v[kMaxLat];
#pragma unroll
      for (int i = 0; i < kMaxLat; ++i)
        if (lane + 32 * i < a.r) v[i] = Act<T>::load(qa + lane + 32 * i);
#pragma unroll
      for (int i = 0; i < kMaxLat; ++i)
        if (lane + 32 * i < a.r) Act<T>::store(out + lane + 32 * i, v[i]);
    }
    // an interleaved rotary pair (2p, 2p + 1) is written de-interleaved,
    // to lanes p and p + dr/2, as q and k share that order
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < half) {
        rotate(y1[i], y2[i], yc[i], ys[i], a.attn_factor);
        Act<T>::store(out + a.r + p, y1[i]);
        Act<T>::store(out + a.r + half + p, y2[i]);
      }
    }
    for (int j = a.r + a.dr + lane; j < a.Dq; j += 32)
      Act<T>::store(out + j, 0.f);
    return;
  }
  // the latent row [c | k_pe | 0 ... 0]: c = RMSNorm(ckv[:r]), lane l
  // holding lanes l, l + 32, ... of it. Every load is issued first, so the
  // row pays one round trip to memory, not one per dependent step.
  const T* x = a.ckv + b * a.scb;
  const int len = a.lengths[b];
  float c[kMaxLat], g[kMaxLat];
#pragma unroll
  for (int i = 0; i < kMaxLat; ++i) {
    const int j = lane + 32 * i;
    c[i] = j < a.r ? Act<T>::load(x + j) : 0.f;
    g[i] = j < a.r ? a.w[j] : 0.f;
  }
  float k1[kMaxPairs], k2[kMaxPairs], kc_[kMaxPairs], ks_[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = lane + 32 * i;
    k1[i] = k2[i] = kc_[i] = ks_[i] = 0.f;
    if (p < half) {
      k1[i] = Act<T>::load(x + a.r + (il ? 2 * p : p));
      k2[i] = Act<T>::load(x + a.r + (il ? 2 * p + 1 : p + half));
      kc_[i] = cs[p];
      ks_[i] = sn[p];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxLat; ++i) ss = __fadd_rn(ss, __fmul_rn(c[i], c[i]));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  // mean as ATen's CUDA mean takes it (the sum times fl(1 / r)), then the
  // same rsqrtf ATen's float rsqrt calls
  const float rs =
      rsqrtf(__fadd_rn(__fmul_rn(ss, __fdiv_rn(1.f, (float)a.r)), a.eps));
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxLat; ++i) {
    c[i] = Act<T>::round(__fmul_rn(__fmul_rn(c[i], rs), g[i]));
    m = fmaxf(m, fabsf(c[i]));
  }
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    rotate(k1[i], k2[i], kc_[i], ks_[i], a.attn_factor);
    k1[i] = Act<T>::round(k1[i]);
    k2[i] = Act<T>::round(k2[i]);
    m = fmaxf(m, fmaxf(fabsf(k1[i]), fabsf(k2[i])));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const long long at = rows.row(a.layer, b, 0, a.B, 1, len);
  if (at < 0) return;
  const float scale = m == 0.f ? 1.f : __fmul_rn(m, kInv127);
  int8_t* codes = a.kc + at * a.Dq;
#pragma unroll
  for (int i = 0; i < kMaxLat; ++i) {
    const int j = lane + 32 * i;
    if (j < a.r) codes[j] = (int8_t)(int)rintf(__fdiv_rn(c[i], scale));
  }
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = lane + 32 * i;
    if (p < half) {
      codes[a.r + p] = (int8_t)(int)rintf(__fdiv_rn(k1[i], scale));
      codes[a.r + half + p] = (int8_t)(int)rintf(__fdiv_rn(k2[i], scale));
    }
  }
  for (int j = a.r + a.dr + lane; j < a.Dq; j += 32) codes[j] = 0;
  if (lane == 0) a.ks[at] = scale;
}

template <typename T, typename Rows>
int launch_mla(void* q_out, const void* q_abs, const void* q_pe,
               const void* ckv, long long sab, long long sah, long long spb,
               long long sph, long long scb, const void* w, const void* cos,
               const void* sin, void* kc, void* ks, const void* lengths,
               int layer, int B, int H, int r, int dr, int Dq, float eps,
               float attn_factor, int interleaved, int vec, const Rows& rows,
               void* stream) {
  const MlaArgs<T> a{
      reinterpret_cast<T*>(q_out), reinterpret_cast<const T*>(q_abs),
      reinterpret_cast<const T*>(q_pe), reinterpret_cast<const T*>(ckv),
      sab, sah, spb, sph, scb, reinterpret_cast<const float*>(w),
      reinterpret_cast<const float*>(cos),
      reinterpret_cast<const float*>(sin), reinterpret_cast<int8_t*>(kc),
      reinterpret_cast<float*>(ks), reinterpret_cast<const int*>(lengths),
      layer, B, H, r, dr, Dq, eps, attn_factor, interleaved, vec};
  const int n_rows = B * (H + 1);
  mla_rope_insert_kernel<T, Rows>
      <<<(n_rows + kWarps - 1) / kWarps, kWarps * 32, 0,
         reinterpret_cast<cudaStream_t>(stream)>>>(a, rows);
  return (int)cudaGetLastError();
}

template <typename Rows>
int launch_mla_for(int bf16, void* q_out, const void* q_abs, const void* q_pe,
                   const void* ckv, long long sab, long long sah,
                   long long spb, long long sph, long long scb, const void* w,
                   const void* cos, const void* sin, void* kc, void* ks,
                   const void* lengths, int layer, int B, int H, int r,
                   int dr, int Dq, float eps, float attn_factor,
                   int interleaved, int vec, const Rows& rows, void* stream) {
  return bf16 ? launch_mla<__nv_bfloat16>(
                    q_out, q_abs, q_pe, ckv, sab, sah, spb, sph, scb, w, cos,
                    sin, kc, ks, lengths, layer, B, H, r, dr, Dq, eps,
                    attn_factor, interleaved, vec, rows, stream)
              : launch_mla<float>(q_out, q_abs, q_pe, ckv, sab, sah, spb, sph,
                                  scb, w, cos, sin, kc, ks, lengths, layer, B,
                                  H, r, dr, Dq, eps, attn_factor, interleaved,
                                  vec, rows, stream);
}

}  // namespace

extern "C" int cache_insert_int8_fused_launch(
    void* q_out, const void* q, const void* k, const void* v, long long sq,
    long long sk, long long sv, const void* cos, const void* sin, void* kc,
    void* ks, void* vc, void* vs, const void* lengths, int layer, int s0,
    int S, int B, int Hq, int Hkv, int Dh, float attn_factor, int bf16,
    int kv4, void* stream) {
  return launch_fused_for(bf16, q_out, q, k, v, sq, sk, sv, cos, sin, kc, ks,
                          vc, vs, lengths, layer, B, Hq, Hkv, Dh, attn_factor,
                          kv4, ContiguousRows{s0, S}, stream);
}

extern "C" int paged_cache_insert_int8_fused_launch(
    void* q_out, const void* q, const void* k, const void* v, long long sq,
    long long sk, long long sv, const void* cos, const void* sin, void* kc,
    void* ks, void* vc, void* vs, const void* page_tbl, const void* lengths,
    int layer, int P, int page, int max_pages, int B, int Hq, int Hkv, int Dh,
    float attn_factor, int bf16, int kv4, void* stream) {
  return launch_fused_for(
      bf16, q_out, q, k, v, sq, sk, sv, cos, sin, kc, ks, vc, vs, lengths,
      layer, B, Hq, Hkv, Dh, attn_factor, kv4,
      PagedRows{reinterpret_cast<const int*>(page_tbl), P, page, max_pages},
      stream);
}

extern "C" int mla_cache_insert_int8_fused_launch(
    void* q_out, const void* q_abs, const void* q_pe, const void* ckv,
    long long sab, long long sah, long long spb, long long sph,
    long long scb, const void* w, const void* cos, const void* sin, void* kc,
    void* ks, const void* lengths, int layer, int s0, int S, int B, int H,
    int r, int dr, int Dq, float eps, float attn_factor, int interleaved,
    int vec, int bf16, void* stream) {
  return launch_mla_for(bf16, q_out, q_abs, q_pe, ckv, sab, sah, spb, sph,
                        scb, w, cos, sin, kc, ks, lengths, layer, B, H, r, dr,
                        Dq, eps, attn_factor, interleaved, vec,
                        ContiguousRows{s0, S}, stream);
}

// The latent pool [L, P, 1, page, Dq] / [L, P, 1, page] through page_tbl
// int32 [B, max_pages]; the rest as above.
extern "C" int paged_mla_cache_insert_int8_fused_launch(
    void* q_out, const void* q_abs, const void* q_pe, const void* ckv,
    long long sab, long long sah, long long spb, long long sph,
    long long scb, const void* w, const void* cos, const void* sin, void* kc,
    void* ks, const void* page_tbl, const void* lengths, int layer, int P,
    int page, int max_pages, int B, int H, int r, int dr, int Dq, float eps,
    float attn_factor, int interleaved, int vec, int bf16, void* stream) {
  return launch_mla_for(
      bf16, q_out, q_abs, q_pe, ckv, sab, sah, spb, sph, scb, w, cos, sin, kc,
      ks, lengths, layer, B, H, r, dr, Dq, eps, attn_factor, interleaved, vec,
      PagedRows{reinterpret_cast<const int*>(page_tbl), P, page, max_pages},
      stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
