// INT8- and INT4-KV flash-decode attention for Hopper (sm_90a): the
// contiguous cache and the paged pool, one launch per call.
//
// Replaces: quant_tpu/kernels/attention.py, flash_decode_int8 -> _kernel, and
//   quant_tpu/kernels/paged_attention.py, paged_flash_decode_int8 -> _kernel
//   (the Pallas TPU kernels).
//
// Decode-step (T=1) GQA attention over int8 K/V code rows, or the int4
// head-pair rows below, with per-(token, head) f32 scales. Query head h
// reads kv head h / rep (the [B, Hkv, rep, Dh] view of q). The key scale
// multiplies the logits after the q.k product and the value scale the
// probabilities before the p.v product (both factor out of the Dh sum),
// with an online softmax. Output = acc / max(l, 1e-20): a slot of length 0
// gives zeros.
//
// Two per-layer options of the JAX kernels, both launch arguments:
// - A sliding window w (Mistral, Gemma-2/3 local layers; 0 = full causal):
//   the valid keys of slot b are [wstart, len) with wstart = max(0, len - w).
//   Chunks are counted from wstart, so no block is launched for, or reads,
//   keys before the window, and the wrapper sizes the grid from min(S, w).
// - A logit softcap c (Gemma-2; 0 = off): the natural logit x (after the
//   key scale) becomes c * tanh(x / c) before the mask. The kernel's logits
//   are base 2 (x * log2 e), so it computes cl * tanhf(y / cl) of the
//   base-2 logit y with cl = c * log2 e: the same value. tanhf is the
//   accurate one (tanh.approx.f32's error moves a logit at c = 50 by about
//   0.02, past the f32 path's 1e-4).
//
// The int4 cache (kv_bits=4, the JAX package's head-pair layout): code row
// j holds real heads 2j (low nibble) and 2j + 1 (high nibble) of one token,
// Dh bytes, each nibble the code plus 8; the scales stay per real head. A
// block then owns (slot, packed head j, chunk) and serves both real heads
// and their 2 rep query heads (rows [0, rep) read the low nibbles, [rep,
// 2 rep) the high ones; query head h reads kv head h / rep, packed head
// h / (2 rep)). The ring copies each packed row once, so every code byte
// leaves device memory once per call, and warps 0 and 2 compute on its low
// nibbles while warps 1 and 3 compute on its high ones, from shared memory:
// a warp keeps one real head's softmax state, as at int8, over 32 tokens
// of a tile (two steps of 16) instead of 16. The nibbles become bf16 mma
// operands exactly (0x4300 | n is 128 + n, minus 136) or f32 on the CUDA
// cores; each parity's scales scale its own logits and probabilities.
//
// Where token t of (slot b, code head h) lives is the only difference
// between the two caches, so one kernel body serves both through a row
// policy (Hkv here counts code heads: the packed heads of an int4 cache):
//   contiguous  [L, B, Hkv, S, Dh]: row ((layer * B + b) * Hkv + h) * S + t;
//   paged pool  [L, P, Hkv, page, Dh] through page_tbl [B, max_pages]:
//               row ((layer * P + page_tbl[b, t / page]) * Hkv + h) * page
//               + t % page.
// The scales use the same row index ([.., S] / [.., page] layouts), of real
// head 2h + p (parity p) for the int4 cache.
//
// What bounds it on this card: the K/V code bytes and scales of each slot's
// actual context (264 bytes per token and kv head at Dh=128: 16.9 MB for
// B=8 x 8014 tokens x 8 kv heads, 5 us at 3.35 TB/s), so device-memory
// bandwidth; at rep 4 the work is 8 FLOP per byte, far below the tensor
// cores' 295. At short contexts the launch and the first copies' latency
// dominate.
//
// Design:
// - Work split on the device. Block (bh, c) of a grid of B * Hkv * n_chunks
//   blocks owns chunk c (`chunk` tokens from the window's start, a multiple
//   of the TT-token tile) of slot b and kv head h; the wrapper sizes grid
//   and workspace from static ints only (kernels/attention.py decode_plan).
//   A block reads its slot's length and exits when its chunk starts at or
//   past it, so the work
//   spreads over short chunks whatever the lengths, and tokens past the
//   length are neither loaded nor computed. A paged block loads the page
//   ids of its own chunk (none past the length) into shared memory.
// - A copy ring: each TT-token tile's K rows, V rows and both scale runs
//   are copied by cp.async (16 bytes a lane for codes, 4 for scales; rows
//   past the chunk's end are zero-filled) into one of NST = 2 shared-memory
//   stages, the next tile in flight while the block computes one (3 and 4
//   stages measured slower), so no global load sits on the softmax chain.
//   Each lane addresses its own rows, so a tile may span pages of any size. The 16-byte units of a row are XOR-swizzled (or
//   rows padded) so the compute's shared-memory reads are conflict-free.
// - Four warps each take 16 tokens of a tile and keep their own online
//   softmax state; the block merges the four in warp order at its end.
// - bf16 q on the tensor cores (mma.m16n8k16, bf16 in, f32 accumulate):
//   scores S[16, 8] = Q K^T with q as A (the rep rows padded to 16, dh
//   permuted within each 16-byte unit so a lane's K fragment is one 16-byte
//   read of its token row) and the int8 codes as B; int8 -> bf16 is exact,
//   two codes at a time by bit operations: 0x4300 | (c & 0x7f) is
//   128 + (c & 0x7f), minus 128 or 256 by the sign bit. The key scale and
//   the softmax scale act on the f32 scores; the online softmax runs in
//   registers (exp2, a quad of lanes per query row). Then O^T[dh, 8] =
//   V^T P^T: the score accumulators, times the value scale and rounded to
//   bf16, are P^T's B fragment as they lie; V^T is A, two tokens of one dh
//   column per register, paired by one byte permute of two staged rows.
//   So no padded row enters the p.v product, and a lane ends up holding 4
//   adjacent dh of two heads.
// - f32 q keeps CUDA-core dots (its 1e-4 limit is out of reach of bf16
//   products) on the same ring, split and merge.
// - One launch: a block writes its chunk's unnormalised (m, l, acc) to the
//   workspace; the last block of each (slot, kv head) to finish (a
//   self-resetting counter) merges that pair's chunks in chunk order, so two
//   calls on the same inputs give bit-equal outputs. A slot whose context
//   fits one chunk skips the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;              // threads per block
constexpr int NW = NT / 32;          // warps, 16 tokens of a tile each
constexpr int TT = 64;               // tokens per ring stage
constexpr int NST = 2;               // ring stages (3 or 4 ran slower)
constexpr int MAX_REP = 8;
constexpr int MAX_IDS = 4096 / 8 + 2;  // page ids of a 4096-token chunk
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const int8_t* kc;
  const float* ks;
  const int8_t* vc;
  const float* vs;
  const int* lengths;
  const int* page_tbl;   // paged pool only
  void* out;
  float* part_o;         // [B*Hkv, n_chunks, rep, D]
  float* part_ml;        // [B*Hkv, n_chunks, rep, 2]
  int* counters;         // [B*Hkv], zero between launches
  int layer, B, Hkv, S, D, rep, chunk, n_chunks;  // Hkv: code heads
  int P, page, page_shift, max_pages;  // paged pool only; page_shift is
                                        // log2(page), or -1
  int window;            // sliding window in tokens; 0 = full causal
  float qk_scale;        // softmax scale * log2(e)
  float cap;             // logit softcap * log2(e); 0 = off
};

// Base-2 logit y after the softcap (cap = c * log2 e, 0 = off).
__device__ __forceinline__ float softcap(float y, float cap) {
  return cap > 0.f ? cap * tanhf(y / cap) : y;
}

// First valid key of a slot of `len` tokens under `window`.
__device__ __forceinline__ int window_start(int len, int window) {
  return window > 0 ? max(0, len - window) : 0;
}

// Shared-memory layout of one ring stage: K rows, V rows, then the scale
// runs: K, V (int8), or K of heads 2j, 2j + 1, then V of both (int4). At
// Dh a multiple of 128 the 16-byte units of a row are XOR-swizzled (K by
// row bit 0, V by row bits 1-2); otherwise V rows are padded by 16 bytes.
// Either way the mma fragment reads are conflict-free.
struct Stage {
  int D, kp, vp, ns;  // ns: scale runs of TT floats
  bool swz;
  __host__ __device__ Stage(int d, bool kv4)
      : D(d), kp(d), vp(d % 128 == 0 ? d : d + 16), ns(kv4 ? 4 : 2), swz(d % 128 == 0) {}
  __host__ __device__ int bytes() const { return TT * (kp + vp) + ns * TT * 4; }
  __device__ int koff(int r, int c) const {
    return r * kp + 16 * (swz ? c ^ ((r & 1) << 2) : c);
  }
  __device__ int voff(int r, int c) const {
    return r * vp + 16 * (swz ? c ^ (((r >> 1) & 3) << 1) : c);
  }
};

// Dynamic shared memory of a launch: the ring, which the four warps'
// states reuse after the last tile, then the CUDA-core path's q rows (of
// both real heads at int4) and p runs.
__host__ __device__ inline int scratch_bytes(int D, bool kv4) {
  const int ring = NST * Stage(D, kv4).bytes();
  const int warps = NW * MAX_REP * (D + 2) * 4;
  return ring > warps ? ring : warps;
}
__host__ __device__ inline int smem_bytes(int D, bool tc, bool kv4) {
  return scratch_bytes(D, kv4) +
         (tc ? 0 : (kv4 ? 2 : 1) * MAX_REP * D * 4 + NW * MAX_REP * 16 * 4);
}

// Row of token t in the contiguous cache: one run of rows per (slot, head);
// srow(t, p): the scale row of parity p's real head (p = 0 at int8).
struct ContigRows {
  size_t base, sbase, sstride;  // code and scale rows of token 0; S
  __device__ __forceinline__ size_t row(int t) const { return base + t; }
  __device__ __forceinline__ size_t srow(int t, int p) const { return sbase + p * sstride + t; }
};

// Row of token t in the page pool; ids[] holds the page ids of the block's
// chunk, ids[0] being the page of token first * page. The scale pool has
// sh heads, parity p's real head being sh0 + p.
struct PagedRows {
  const int* ids;
  size_t layer_pages;  // layer * P
  int hkv, h, sh, sh0, page, shift, first;  // shift: log2(page), or -1
  __device__ __forceinline__ int page_of(int t) const {
    return shift >= 0 ? t >> shift : t / page;
  }
  __device__ __forceinline__ size_t row(int t) const {
    const int p = page_of(t);
    return ((layer_pages + ids[p - first]) * hkv + h) * (size_t)page + (t - p * page);
  }
  __device__ __forceinline__ size_t srow(int t, int par) const {
    const int p = page_of(t);
    return ((layer_pages + ids[p - first]) * sh + sh0 + par) * (size_t)page + (t - p * page);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16- and 4-byte copies into shared memory; ok == false writes zeros and
// reads nothing
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four int8 codes [c0 c1 c2 c3] (c0 the low byte) to bf16x2 (c0, c2) and
// (c1, c3), exactly: 0x4300 | (c & 0x7f) is 128 + (c & 0x7f) and
// 0x4300 | (c & 0x80) is 128 or 256, so their difference is c.
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t w1 = w >> 8;
  const uint32_t x0 = (w & 0x007f007fu) | 0x43004300u, y0 = (w & 0x00800080u) | 0x43004300u;
  const uint32_t x1 = (w1 & 0x007f007fu) | 0x43004300u, y1 = (w1 & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d0 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x0),
                                    *reinterpret_cast<const __nv_bfloat162*>(&y0));
  const __nv_bfloat162 d1 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x1),
                                    *reinterpret_cast<const __nv_bfloat162*>(&y1));
  lo = *reinterpret_cast<const uint32_t*>(&d0);
  hi = *reinterpret_cast<const uint32_t*>(&d1);
}

// Four int4 codes, the nibbles at bit sh (0: low, 4: high) of the bytes
// [b0 b1 b2 b3] of w, to bf16x2 (n0, n2) and (n1, n3) minus 8, exactly:
// 0x4300 | n is 128 + n and 0x4308 is 136.
__device__ __forceinline__ void nibbles_bf16(uint32_t w, int sh, uint32_t& lo, uint32_t& hi) {
  const uint32_t x0 = ((w >> sh) & 0x000f000fu) | 0x43004300u;
  const uint32_t x1 = ((w >> (sh + 8)) & 0x000f000fu) | 0x43004300u;
  const uint32_t b = 0x43084308u;
  const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162 d0 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x0), bias);
  const __nv_bfloat162 d1 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x1), bias);
  lo = *reinterpret_cast<const uint32_t*>(&d0);
  hi = *reinterpret_cast<const uint32_t*>(&d1);
}

// The mma operands of four staged code bytes: int8 codes, or parity sh's
// int4 codes
template <bool KV4>
__device__ __forceinline__ void operands(uint32_t w, int sh, uint32_t& lo, uint32_t& hi) {
  if constexpr (KV4) nibbles_bf16(w, sh, lo, hi);
  else codes_bf16(w, lo, hi);
}

// One staged code byte as a float: an int8 code, or parity sh's int4 code
template <bool KV4>
__device__ __forceinline__ float code_f32(uint8_t c, int sh) {
  if constexpr (KV4) return float(int((c >> sh) & 15) - 8);
  else return float(static_cast<int8_t>(c));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store4(float* out, size_t i, float4 v) {
  *reinterpret_cast<float4*>(out + i) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t i, float4 v) {
  uint2 w;
  w.x = pack_bf16(v.x, v.y);
  w.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(out + i) = w;
}

// Copy tile [t0, t0 + TT) of the chunk (tokens at or past c1 zero-filled)
// into stage st.
template <bool KV4, class Rows>
__device__ __forceinline__ void issue(uint8_t* st, const Stage& L, const Args& a,
                                      const Rows& rows, int t0, int c1) {
  const int cpr = L.D / 16, n = TT * cpr;
  uint8_t* kd = st;
  uint8_t* vd = st + TT * L.kp;
  float* sd = reinterpret_cast<float*>(vd + TT * L.vp);
  for (int e = threadIdx.x; e < n; e += NT) {
    const int r = e / cpr, c = e - r * cpr, t = t0 + r;
    const bool ok = t < c1;
    const size_t off = ok ? rows.row(t) * L.D + 16 * c : 0;
    cp16(kd + L.koff(r, c), a.kc + off, ok);
    cp16(vd + L.voff(r, c), a.vc + off, ok);
  }
  // int8: threads [0, TT) copy the key scales, [TT, 2 TT) the value
  // scales; int4: thread x copies both scales of parity x / TT's real head
  // (runs: K of parity 0, 1, then V of parity 0, 1)
  static_assert(NT == 2 * TT, "one thread a token and scale run");
  const int r = threadIdx.x % TT, t = t0 + r;
  const bool ok = t < c1;
  if constexpr (KV4) {
    const int p = threadIdx.x / TT;
    const size_t row = ok ? rows.srow(t, p) : 0;
    cp4(sd + p * TT + r, a.ks + row, ok);
    cp4(sd + (2 + p) * TT + r, a.vs + row, ok);
  } else {
    const size_t row = ok ? rows.row(t) : 0;
    cp4(sd + threadIdx.x, (threadIdx.x < TT ? a.ks : a.vs) + row, ok);
  }
}

// One chunk [c0, c1) of one (slot, code head), the last block of the pair
// merging all of its chunks. The block serves R = rep query rows (int8) or
// 2 rep (int4: rows [0, rep) on the low nibbles, [rep, 2 rep) on the high
// ones); a warp serves the rows of its parity par over its tokens of each
// tile.
template <typename T, int DMAX, bool TC, bool FIX, bool KV4, class Rows>
__device__ __forceinline__ void attend(const Args& a, const Rows& rows, int bh,
                                       int chunk, int c0, int c1, int used) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int D = FIX ? DMAX : a.D, rep = a.rep;  // FIX: Dh known at compile time
  const int R = KV4 ? 2 * rep : rep;            // query rows of the block
  // int4: warps 0, 2 take the low nibbles (parity 0), 1, 3 the high ones,
  // each 32 tokens of a tile in two steps of 16; int8: 16 tokens a warp
  constexpr int NSUB = KV4 ? 2 : 1;
  const int par = KV4 ? (warp & 1) : 0, sh = 4 * par, qr0 = par * rep;
  const int wt0 = KV4 ? 32 * (warp >> 1) : 16 * warp;  // the warp's first token
  constexpr int QROWS = (KV4 ? 2 : 1) * MAX_REP;
  const Stage L(D, KV4);
  const T* q = reinterpret_cast<const T*>(a.q) + (size_t)bh * R * D;

  // per-warp online-softmax state. tensor cores: m, l of query row g (l a
  // partial over the lane's tokens), o[c][x][i] the O^T fragments of dh
  // 32c + 4g + {0, 1} (x = 0) and {2, 3} (x = 1) for heads 2t, 2t + 1.
  // CUDA cores: m[r], l[r] of every row, acc[r][i] of dh lane + 32i.
  constexpr int NV = TC ? DMAX / 32 : 1;
  constexpr int NA = TC ? 1 : DMAX / 32;
  float m_tc = NEG, l_tc = 0.f;
  float o[NV][2][4];
  float m_cc[MAX_REP], l_cc[MAX_REP], acc[MAX_REP][NA];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[c][x][i] = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m_cc[r] = NEG;
    l_cc[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[r][i] = 0.f;
  }

  // the ring: NST - 1 tiles ahead
  const int n_tiles = (c1 - c0 + TT - 1) / TT;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) issue<KV4>(smem + s * L.bytes(), L, a, rows, c0 + s * TT, c1);
    cp_commit();
  }
  // q, while the first tiles are in flight: tensor cores take bf16
  // fragments in registers (row g of the warp's parity; dh of 16-byte unit
  // 4h + t, permuted as the K codes are; the softmax scale goes on the f32
  // scores), CUDA cores f32 rows times the softmax scale in shared memory.
  constexpr int NH = TC ? DMAX / 64 : 1;
  uint32_t qa[NH][4][2];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) qa[h][j][0] = qa[h][j][1] = 0u;
  float* q_s = reinterpret_cast<float*>(smem + scratch_bytes(D, KV4));
  float* p_s = q_s + QROWS * D + warp * MAX_REP * 16;  // this warp's p run
  if constexpr (TC) {
    if (g < rep) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int c = 4 * h + t;
        if (c < D / 16) {
          const uint4* src =
              reinterpret_cast<const uint4*>(q + (size_t)(qr0 + g) * D + 16 * c);
          const uint4 u0 = src[0], u1 = src[1];
          const uint32_t w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qa[h][j][0] = __byte_perm(w[2 * j], w[2 * j + 1], 0x5410);  // dh 4j, 4j+2
            qa[h][j][1] = __byte_perm(w[2 * j], w[2 * j + 1], 0x7632);  // 4j+1, 4j+3
          }
        }
      }
    }
  } else {
    for (int i = tid; i < R * D; i += NT) q_s[i] = to_f32(q[i]) * a.qk_scale;
    __syncthreads();
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_wait<NST - 2>();  // tile i has landed
    __syncthreads();
    if (i + NST - 1 < n_tiles)
      issue<KV4>(smem + ((i + NST - 1) % NST) * L.bytes(), L, a, rows,
                 c0 + (i + NST - 1) * TT, c1);
    cp_commit();
    const int t0 = c0 + i * TT;
    const uint8_t* kt = smem + (i % NST) * L.bytes();
    const uint8_t* vt = kt + TT * L.kp;
    const float* kss = reinterpret_cast<const float*>(vt + TT * L.vp) + par * TT;
    const float* vss = kss + (L.ns / 2) * TT;
#pragma unroll
    for (int u = 0; u < NSUB; ++u) {
      const int w0 = wt0 + 16 * u;  // the step's first token
      if (t0 + w0 >= c1) break;     // nothing valid for this warp

      if constexpr (TC) {
        // scores of query row g against tokens w0 + 8n + 2t + {0, 1}
        // one accumulator per 64 dh, so the mma chains are 4 long
        float sc[2][4], part[NH][2][4];
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[h][n][i] = 0.f;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          if (4 * h >= D / 16) break;
          const int c = 4 * h + t;
          // tokens w0 + g and w0 + 8 + g share the swizzle (row bit 0)
          const uint8_t* krow = kt + L.koff(w0 + g, c);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint4 kw = make_uint4(0u, 0u, 0u, 0u);
            if (c < D / 16) kw = *reinterpret_cast<const uint4*>(krow + 8 * n * L.kp);
            const uint32_t kv[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              uint32_t b0, b1;
              operands<KV4>(kv[j], sh, b0, b1);
              mma(part[h][n], qa[h][j][0], 0u, qa[h][j][1], 0u, b0, b1);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sc[n][i] = part[0][n][i];
#pragma unroll
            for (int h = 1; h < NH; ++h) sc[n][i] += part[h][n][i];
          }
        float s[2][2], p[2][2];
        bool ok[2][2];
        float mx = NEG;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = w0 + 8 * n + 2 * t + e;
            ok[n][e] = t0 + r < c1;
            s[n][e] = softcap(sc[n][e] * a.qk_scale * kss[r], a.cap);
            if (ok[n][e]) mx = fmaxf(mx, s[n][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_tc, mx);
        const float alpha = ex2(m_tc - m_new);
        m_tc = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[n][e] = ok[n][e] ? ex2(s[n][e] - m_new) : 0.f;
            sum += p[n][e];
          }
        l_tc = l_tc * alpha + sum;
        // P^T as B: tokens 2t, 2t + 1 (b0) and 8 + 2t, 9 + 2t (b1) of head g
        const int r0 = w0 + 2 * t;
        const uint32_t b0 = pack_bf16(p[0][0] * vss[r0], p[0][1] * vss[r0 + 1]);
        const uint32_t b1 = pack_bf16(p[1][0] * vss[r0 + 8], p[1][1] * vss[r0 + 9]);
        const float a_even = __shfl_sync(0xffffffffu, alpha, 8 * t);
        const float a_odd = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          if (c >= D / 32) break;
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            o[c][x][0] *= a_even;
            o[c][x][1] *= a_odd;
            o[c][x][2] *= a_even;
            o[c][x][3] *= a_odd;
          }
          // V^T as A: codes of dh 32c + 4g + {0..3}, tokens 2t, 2t+1, 2t+8, 2t+9
          // rows r0, r0 + 1, r0 + 8 and r0 + 9 share the swizzle (row bits 1-2)
          const uint8_t* vrow = vt + L.voff(r0, 2 * c + (g >> 2)) + 4 * (g & 3);
          const uint32_t v0 = *reinterpret_cast<const uint32_t*>(vrow);
          const uint32_t v1 = *reinterpret_cast<const uint32_t*>(vrow + L.vp);
          const uint32_t v2 = *reinterpret_cast<const uint32_t*>(vrow + 8 * L.vp);
          const uint32_t v3 = *reinterpret_cast<const uint32_t*>(vrow + 9 * L.vp);
          uint32_t x0, x1, x2, x3, y0, y1, y2, y3;
          operands<KV4>(__byte_perm(v0, v1, 0x5410), sh, x0, x1);  // dh +0 (x0), +1 (x1)
          operands<KV4>(__byte_perm(v0, v1, 0x7632), sh, y0, y1);  // dh +2, +3
          operands<KV4>(__byte_perm(v2, v3, 0x5410), sh, x2, x3);
          operands<KV4>(__byte_perm(v2, v3, 0x7632), sh, y2, y3);
          mma(o[c][0], x0, x1, x2, x3, b0, b1);
          mma(o[c][1], y0, y1, y2, y3, b0, b1);
        }
      } else {
        // scores: lanes 2j, 2j + 1 take alternate 16-byte units of token w0 + j
        const int j = lane >> 1, half = lane & 1, r = w0 + j;
        float dots[MAX_REP];
#pragma unroll
        for (int k = 0; k < MAX_REP; ++k) dots[k] = 0.f;
        for (int c = half; c < D / 16; c += 2) {
          const uint4 kw = *reinterpret_cast<const uint4*>(kt + L.koff(r, c));
          const uint8_t* kb = reinterpret_cast<const uint8_t*>(&kw);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float kv = code_f32<KV4>(kb[e], sh);
#pragma unroll
            for (int k = 0; k < MAX_REP; ++k)
              if (k < rep) dots[k] = fmaf(q_s[(qr0 + k) * D + 16 * c + e], kv, dots[k]);
          }
        }
        const bool ok = t0 + r < c1;
        const float ksc = kss[r], vsc = vss[r];
        float alpha[MAX_REP];
#pragma unroll
        for (int k = 0; k < MAX_REP; ++k) {
          alpha[k] = 1.f;
          if (k >= rep) continue;
          const float s =
              softcap((dots[k] + __shfl_xor_sync(0xffffffffu, dots[k], 1)) * ksc, a.cap);
          float mx = ok ? s : NEG;
#pragma unroll
          for (int x = 2; x < 32; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
          const float m_new = fmaxf(m_cc[k], mx);
          const float p = ok ? ex2(s - m_new) : 0.f;
          float sum = p;
#pragma unroll
          for (int x = 2; x < 32; x <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, x);
          alpha[k] = ex2(m_cc[k] - m_new);
          l_cc[k] = l_cc[k] * alpha[k] + sum;
          m_cc[k] = m_new;
          if (!half) p_s[k * 16 + j] = p * vsc;
        }
        __syncwarp();
        // p.v: lane owns dh lane + 32i
#pragma unroll
        for (int k = 0; k < MAX_REP; ++k)
#pragma unroll
          for (int i = 0; i < NA; ++i) acc[k][i] *= alpha[k];
        for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
          for (int i = 0; i < NA; ++i) {
            const int d = lane + 32 * i;
            if (d >= D) break;
            const float vv = code_f32<KV4>(vt[L.voff(w0 + jj, d >> 4) + (d & 15)], sh);
#pragma unroll
            for (int k = 0; k < MAX_REP; ++k)
              if (k < rep) acc[k][i] = fmaf(p_s[k * 16 + jj], vv, acc[k][i]);
          }
        }
        __syncwarp();
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the four warps' states into the scratch (over the ring), then merged in
  // warp order: o_s [warp][row][D], m_s / l_s [warp][row], rows of the
  // warp's parity
  float* o_s = reinterpret_cast<float*>(smem);
  float* m_s = o_s + NW * MAX_REP * D;
  float* l_s = m_s + NW * MAX_REP;
  if constexpr (TC) {
    l_tc += __shfl_xor_sync(0xffffffffu, l_tc, 1);
    l_tc += __shfl_xor_sync(0xffffffffu, l_tc, 2);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (c >= D / 32) break;
      const int d = 32 * c + 4 * g;
      if (2 * t < rep)
        store4(o_s, (size_t)(warp * MAX_REP + 2 * t) * D + d,
               make_float4(o[c][0][0], o[c][0][2], o[c][1][0], o[c][1][2]));
      if (2 * t + 1 < rep)
        store4(o_s, (size_t)(warp * MAX_REP + 2 * t + 1) * D + d,
               make_float4(o[c][0][1], o[c][0][3], o[c][1][1], o[c][1][3]));
    }
    if (t == 0 && g < rep) {
      m_s[warp * MAX_REP + g] = m_tc;
      l_s[warp * MAX_REP + g] = l_tc;
    }
  } else {
#pragma unroll
    for (int k = 0; k < MAX_REP; ++k) {
      if (k >= rep) break;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int d = lane + 32 * i;
        if (d < D) o_s[(warp * MAX_REP + k) * D + d] = acc[k][i];
      }
      if (lane == 0) {
        m_s[warp * MAX_REP + k] = m_cc[k];
        l_s[warp * MAX_REP + k] = l_cc[k];
      }
    }
  }
  __syncthreads();

  // row r of the block: parity r / rep, the warps of that parity (all four
  // at int8) merged in warp order
  constexpr int NE = QROWS * DMAX / 4 / NT;  // this thread's float4s, at most
  constexpr int WSTEP = KV4 ? 2 : 1;
  const int d4 = D / 4;
  const size_t pbase = (size_t)bh * a.n_chunks;
  float4 res[NE];
  float res_m[NE], res_l[NE];
#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const int e = tid + k * NT;
    if (e >= R * d4) break;
    const int r = e / d4, d = 4 * (e - r * d4);
    const int pr = KV4 ? r / rep : 0, rl = r - pr * rep;
    float mx = NEG;
#pragma unroll
    for (int w = pr; w < NW; w += WSTEP) mx = fmaxf(mx, m_s[w * MAX_REP + rl]);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int w = pr; w < NW; w += WSTEP) {
      const float f = ex2(m_s[w * MAX_REP + rl] - mx);
      const float4 x = *reinterpret_cast<const float4*>(o_s + (w * MAX_REP + rl) * D + d);
      v = make_float4(v.x + f * x.x, v.y + f * x.y, v.z + f * x.z, v.w + f * x.w);
      l += f * l_s[w * MAX_REP + rl];
    }
    res[k] = v;
    res_m[k] = mx;
    res_l[k] = l;
  }
  T* out = reinterpret_cast<T*>(a.out) + (size_t)bh * R * D;
  if (used == 1) {  // the whole context in this chunk
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const int e = tid + k * NT;
      if (e >= R * d4) break;
      const float inv = 1.f / fmaxf(res_l[k], 1e-20f);
      const float4 v = res[k];
      store4(out, 4 * (size_t)e, make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv));
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < NE; ++k) {
    const int e = tid + k * NT;
    if (e >= R * d4) break;
    const int r = e / d4;
    const size_t p = (pbase + chunk) * R + r;
    store4(a.part_o, p * D + 4 * (e - r * d4), res[k]);
    if (e == r * d4) {
      a.part_ml[2 * p] = res_m[k];
      a.part_ml[2 * p + 1] = res_l[k];
    }
  }

  // the last block of the pair to finish merges the chunks in chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counters + bh, 1) == used - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // one pass per float4 with a running maximum; its loads do not wait on
  // the sums, so they are all in flight at once
  const size_t step = (size_t)R * D / 4;  // float4s per chunk
  for (int e = tid; e < R * d4; e += NT) {
    const int r = e / d4;
    const float4* src = reinterpret_cast<const float4*>(a.part_o + (pbase * R + r) * D) + (e - r * d4);
    const float2* ml = reinterpret_cast<const float2*>(a.part_ml) + pbase * R + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float mx = NEG, l = 0.f;
#pragma unroll 4
    for (int c = 0; c < used; ++c) {
      const float2 w = __ldcg(ml + (size_t)c * R);
      const float4 x = __ldcg(src + c * step);
      const float m_new = fmaxf(mx, w.x), fo = ex2(mx - m_new), fc = ex2(w.x - m_new);
      v = make_float4(v.x * fo + x.x * fc, v.y * fo + x.y * fc, v.z * fo + x.z * fc,
                      v.w * fo + x.w * fc);
      l = l * fo + w.y * fc;
      mx = m_new;
    }
    const float inv = 1.f / fmaxf(l, 1e-20f);
    store4(out, 4 * (size_t)e, make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv));
  }
  if (tid == 0) a.counters[bh] = 0;
}

// DMAX: the largest Dh the instance takes (its register arrays), FIX: Dh is
// DMAX, KV4: the int4 head-pair cache. Up to Dh 128 four blocks fit an SM
// (128 registers a thread).
template <typename T, int DMAX, bool TC, bool FIX, bool KV4>
__global__ void __launch_bounds__(NT, DMAX <= 128 ? 4 : 2) flash_decode(const Args a) {
  const int bh = blockIdx.x / a.n_chunks, chunk = blockIdx.x - bh * a.n_chunks;
  const int b = bh / a.Hkv, h = bh - b * a.Hkv;
  const int len = max(0, min(a.lengths[b], a.S)), ws = window_start(len, a.window);
  const int used = max(1, (len - ws + a.chunk - 1) / a.chunk);
  if (chunk >= used) return;
  const int c0 = ws + chunk * a.chunk, c1 = min(len, c0 + a.chunk);
  const size_t slot = (size_t)a.layer * a.B + b;
  const size_t base = (slot * a.Hkv + h) * a.S;
  const ContigRows rows{base, KV4 ? (slot * 2 * a.Hkv + 2 * h) * a.S : base, (size_t)a.S};
  attend<T, DMAX, TC, FIX, KV4>(a, rows, bh, chunk, c0, c1, used);
}

template <typename T, int DMAX, bool TC, bool FIX, bool KV4>
__global__ void __launch_bounds__(NT, DMAX <= 128 ? 4 : 2) paged_flash_decode(const Args a) {
  __shared__ int ids[MAX_IDS];
  const int bh = blockIdx.x / a.n_chunks, chunk = blockIdx.x - bh * a.n_chunks;
  const int b = bh / a.Hkv, h = bh - b * a.Hkv;
  const int len = max(0, min(a.lengths[b], a.S)), ws = window_start(len, a.window);
  const int used = max(1, (len - ws + a.chunk - 1) / a.chunk);
  if (chunk >= used) return;
  const int c0 = ws + chunk * a.chunk, c1 = min(len, c0 + a.chunk);
  const int first = c0 / a.page;
  const int n_ids = c1 > c0 ? (c1 - 1) / a.page - first + 1 : 0;
  for (int i = threadIdx.x; i < n_ids; i += NT)
    ids[i] = a.page_tbl[(size_t)b * a.max_pages + first + i];
  __syncthreads();
  const PagedRows rows{ids, (size_t)a.layer * a.P, a.Hkv, h, KV4 ? 2 * a.Hkv : a.Hkv,
                       KV4 ? 2 * h : h, a.page, a.page_shift, first};
  attend<T, DMAX, TC, FIX, KV4>(a, rows, bh, chunk, c0, c1, used);
}

template <typename T, int DMAX, bool TC, bool FIX = false, bool KV4 = false>
int run(const Args& a, bool paged, cudaStream_t st) {
  auto kernel = paged ? paged_flash_decode<T, DMAX, TC, FIX, KV4>
                      : flash_decode<T, DMAX, TC, FIX, KV4>;
  static bool sized[2] = {false, false};
  if (!sized[paged]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(DMAX, TC, KV4));
    if (err != cudaSuccess) return (int)err;
    sized[paged] = true;
  }
  kernel<<<a.B * a.Hkv * a.n_chunks, NT, smem_bytes(a.D, TC, KV4), st>>>(a);
  return (int)cudaGetLastError();
}

// The int4 cache's instances: the tensor cores at the serving Dh 128 and
// 256 and any Dh up to 256, the CUDA cores for f32 and bf16 q
int dispatch_kv4(const Args& a, int q_bf16, int tc, bool paged, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (tc) {
    if (a.D == 128) return run<bf16, 128, true, true, true>(a, paged, st);
    if (a.D == 256) return run<bf16, 256, true, true, true>(a, paged, st);
    return a.D <= 128 ? run<bf16, 128, true, false, true>(a, paged, st)
                      : run<bf16, 256, true, false, true>(a, paged, st);
  }
  if (q_bf16)
    return a.D <= 128 ? run<bf16, 128, false, false, true>(a, paged, st)
                      : run<bf16, 256, false, false, true>(a, paged, st);
  return a.D <= 128 ? run<float, 128, false, false, true>(a, paged, st)
                    : run<float, 256, false, false, true>(a, paged, st);
}

int dispatch(const Args& a, int q_bf16, int tc, int kv4, bool paged, cudaStream_t st) {
  if (a.rep < 1 || a.rep > MAX_REP || a.D % 16 || a.D > 256 || a.chunk % TT ||
      a.chunk > 4096 || a.window < 0 || !(a.cap >= 0.f) || (tc && (!q_bf16 || a.D % 32)) ||
      (paged && (a.page < 1 || a.chunk / a.page + 2 > MAX_IDS)))
    return (int)cudaErrorInvalidValue;
  if (kv4) return dispatch_kv4(a, q_bf16, tc, paged, st);
  using bf16 = __nv_bfloat16;
  if (tc) {  // the serving Dh at compile time
    if (a.D == 64) return run<bf16, 64, true, true>(a, paged, st);
    if (a.D == 128) return run<bf16, 128, true, true>(a, paged, st);
    if (a.D == 256) return run<bf16, 256, true, true>(a, paged, st);
    return a.D <= 128 ? run<bf16, 128, true>(a, paged, st) : run<bf16, 256, true>(a, paged, st);
  }
  if (q_bf16)
    return a.D <= 128 ? run<bf16, 128, false>(a, paged, st) : run<bf16, 256, false>(a, paged, st);
  if (a.D == 128) return run<float, 128, false, true>(a, paged, st);
  return a.D <= 128 ? run<float, 128, false>(a, paged, st) : run<float, 256, false>(a, paged, st);
}

}  // namespace

// Hkv: code heads (the packed heads when kv4: uint8 codes [.., Hkv, S, Dh]
// beside f32 scales [.., 2 Hkv, S]); rep: query heads per real kv head; R =
// rep (int8) or 2 rep (kv4) query rows per code head. part_o: f32 [B * Hkv *
// n_chunks * R * Dh], part_ml: f32 [... * R * 2] (unused, and may be null,
// when n_chunks is 1); counters: int32 [B * Hkv], zero, left zero. tc: the
// tensor-core path (bf16 q, Dh % 32 == 0). window: sliding window (0 = full
// causal); cap: logit softcap (0 = off).
extern "C" int flash_decode_int8_launch(const void* q, int q_bf16, int tc, const void* kc,
                                        const void* ks, const void* vc, const void* vs,
                                        const void* lengths, void* out, void* part_o,
                                        void* part_ml, void* counters, int layer, int B,
                                        int Hkv, int S, int D, int rep, int kv4,
                                        float scale, int window, float cap, int chunk,
                                        int n_chunks, void* stream) {
  Args a{};
  a.q = q;
  a.kc = reinterpret_cast<const int8_t*>(kc);
  a.ks = reinterpret_cast<const float*>(ks);
  a.vc = reinterpret_cast<const int8_t*>(vc);
  a.vs = reinterpret_cast<const float*>(vs);
  a.lengths = reinterpret_cast<const int*>(lengths);
  a.out = out;
  a.part_o = reinterpret_cast<float*>(part_o);
  a.part_ml = reinterpret_cast<float*>(part_ml);
  a.counters = reinterpret_cast<int*>(counters);
  a.layer = layer;
  a.B = B;
  a.Hkv = Hkv;
  a.S = S;
  a.D = D;
  a.rep = rep;
  a.chunk = chunk;
  a.n_chunks = n_chunks;
  a.qk_scale = scale * LOG2E;
  a.window = window;
  a.cap = cap * LOG2E;
  return dispatch(a, q_bf16, tc, kv4, false, reinterpret_cast<cudaStream_t>(stream));
}

// Pools [L, P, Hkv, page, Dh] / [L, P, Hkv, page] (kv4: [L, P, 2 Hkv, page]
// scales); page_tbl int32 [B, max_pages]; the rest as above with S =
// max_pages * page.
extern "C" int paged_flash_decode_int8_launch(
    const void* q, int q_bf16, int tc, const void* kc, const void* ks, const void* vc,
    const void* vs, const void* page_tbl, const void* lengths, void* out, void* part_o,
    void* part_ml, void* counters, int layer, int B, int Hkv, int P, int page,
    int max_pages, int D, int rep, int kv4, float scale, int window, float cap,
    int chunk, int n_chunks, void* stream) {
  Args a{};
  a.q = q;
  a.kc = reinterpret_cast<const int8_t*>(kc);
  a.ks = reinterpret_cast<const float*>(ks);
  a.vc = reinterpret_cast<const int8_t*>(vc);
  a.vs = reinterpret_cast<const float*>(vs);
  a.page_tbl = reinterpret_cast<const int*>(page_tbl);
  a.lengths = reinterpret_cast<const int*>(lengths);
  a.out = out;
  a.part_o = reinterpret_cast<float*>(part_o);
  a.part_ml = reinterpret_cast<float*>(part_ml);
  a.counters = reinterpret_cast<int*>(counters);
  a.layer = layer;
  a.B = B;
  a.Hkv = Hkv;
  a.S = max_pages * page;
  a.D = D;
  a.rep = rep;
  a.chunk = chunk;
  a.n_chunks = n_chunks;
  a.P = P;
  a.page = page;
  a.page_shift = (page & (page - 1)) ? -1 : __builtin_ctz(page);
  a.max_pages = max_pages;
  a.qk_scale = scale * LOG2E;
  a.window = window;
  a.cap = cap * LOG2E;
  return dispatch(a, q_bf16, tc, kv4, true, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
