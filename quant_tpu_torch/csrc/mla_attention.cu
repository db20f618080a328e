// MLA (DeepSeek multi-head latent attention) flash decode for Hopper
// (sm_90a), over the contiguous latent cache and the paged latent pool, one
// launch per call.
//
// Replaces: quant_tpu/kernels/mla_attention.py, mla_flash_decode_int8 ->
//   _kernel (the Pallas TPU kernel). The JAX package has no Pallas kernel
//   for the paged pool: it gathers each slot's pages into a contiguous copy
//   per layer (quant_tpu/models/llama.py _mla_attn); here the same kernel
//   body reads the pool through the page table.
//
// Decode-step (T=1) attention in the absorbed form: MQA of the queries
// q_eff [B, H, Dq] against one shared int8 latent row per token,
// [c_kv (r) | k_rope | zero pad] of Dq lanes, with one f32 scale per row, in
//   contiguous: the stacked cache [L, B, 1, S, Dq] / [L, B, 1, S], token t
//               of slot b at row (layer * B + b) * S + t;
//   paged:      the pool [L, P, 1, page, Dq] / [L, P, 1, page] through
//               page_tbl [B, max_pages], token t at row
//               (layer * P + page_tbl[b, t / page]) * page + t % page
//               (S = max_pages * page).
// The value read is the
// row's first r lanes. The row scale multiplies the logits after the q.k
// product and the probabilities before the p.v product (it factors out of
// both sums), with an online softmax; rows at or past lengths[b] are masked.
// Output [B, H, r] = acc / max(l, 1e-20): a slot of length 0 gives zeros.
//
// What bounds it on this card: the latent bytes of each slot's actual
// context (Dq + 4 bytes per token, shared by all H heads: 5.2 MB for B=8 x
// 8014 tokens at Dq=640, 1.5 us at 3.35 TB/s) and, at many heads, the
// 2 * H * (Dq + r) operations per token (H=128: 2.4 us at the bf16 peak).
// Both dots have as many rows as heads, so bf16 q maps onto mma tiles with
// the heads as M; the int8 codes have to be turned into bf16 operands on
// the way, and at short contexts the launch, the first copies' latency and
// the merge of the chunks dominate.
//
// Design:
// - Work split on the device. Block (bg, c) of a grid of B * NG * n_chunks
//   blocks owns the HB heads [h0, h0 + HB) of slot b (NG = ceil(H / HB)
//   head groups) and chunk c of `chunk` tokens (a multiple of the TT-token
//   tile); the wrapper sizes grid and workspace from static ints only
//   (kernels/mla_attention.py mla_decode_plan). A block reads its slot's
//   length and exits when its chunk starts at or past it.
// - A copy ring: each TT-token tile's latent rows (all Dq lanes, 16 bytes a
//   lane) and their scales arrive by cp.async into one of NST = 2
//   shared-memory stages (rows past the chunk's end zero-filled), the next
//   tile in flight while the block computes one. Row pitch is Dq rounded up
//   to 128 bytes; the 16-byte units of a row are XOR-swizzled by row bits
//   0-2 so that both dots' fragment reads below are conflict-free. One
//   staged row feeds both dots: the scores over all Dq lanes, the values
//   over the first r.
// - bf16 q on the tensor cores (mma.m16n8k16, bf16 in, f32 accumulate), in
//   blocks of RT row tiles of 16 heads (HB = 16 RT; fewer heads than 16
//   are zero rows) and 16 warps, so that one tile keeps a whole SM busy:
//   - scores S[16 heads, 16 tokens] = Q K^T: warp w takes the 16 tokens
//     16 (w % 4) + [0, 16) of the tile against row tile (w / 4) % RT and
//     one of KS = 4 / RT parts of Dq; the first warp of each (row tile,
//     token group) adds the other parts' sums, in part order. q is A,
//     loaded once per block into shared memory in fragment order (d
//     permuted within each 16-byte unit, so a lane's K fragment is one
//     16-byte read of its token's row); the codes are B, two codes to a
//     bf16x2 exactly by bit operations (0x4300 | (c & 0x7f) is
//     128 + (c & 0x7f), minus 128 or 256 by the sign bit). Each staged
//     code is converted once per block, whatever the number of heads.
//   - softmax in registers (exp2, a quad of lanes per head row): the warp
//     holding a token group's scores takes the maximum and sum of its 16
//     tokens and leaves its probabilities times the row scales (f32, in
//     A-fragment order) and its (max, sum) per row in shared memory; one
//     barrier; then every warp computes the tile's maximum per row from the
//     four, rescales its accumulators, and scales each token group's
//     probabilities to the common maximum as it rounds them to bf16 (one
//     rounding).
//   - values O[16 heads, r] += P V: P is A (16 tokens a k-step), the same
//     staged rows' first r lanes are B: 4 adjacent codes of 4 token rows
//     per lane, paired by byte permutes into 4 n-tiles' fragments. Warp w
//     takes value lanes [32 w, 32 w + 32) of every row tile.
//   So a tile costs three barriers, and every staged row is read from
//   device memory once per block: HB = 32 reads it once for 32 heads.
//   What bounds it (tools/attn_probe.py mla): not the mma (a copy of the
//   kernel without either dot's mma took the same time) but issuing the
//   rest (the int8 -> bf16 conversions of both dots, shared-memory reads,
//   barriers): one block spends about 3 us of compute and 1.4 us of copies
//   on a 64-token tile.
// - f32 q (and any shape the tensor cores do not take) keeps CUDA-core dots
//   in f32 on the same ring, split and merge, 16 heads a block.
// - The row policy is a template argument of both paths (as in
//   flash_decode.cu): a paged block first loads the page ids of its own
//   chunk into shared memory (none before the chunk's first page, none past
//   its last token), then each lane of the copy ring addresses its own row
//   through them (a shift where the page is a power of two, else a
//   division), so a 64-token tile may span pages of any size. The ring, the
//   tiles and the merge are those of the contiguous cache.
// - One launch: a block writes its chunk's unnormalised (m, l, acc) to the
//   workspace; the last block of each (slot, head group) to finish (a
//   self-resetting counter) merges that group's chunks in chunk order, so
//   two calls on the same inputs give bit-equal outputs. A slot whose
//   context fits one chunk skips the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 64;        // tokens per ring stage
constexpr int NST = 2;        // ring stages
constexpr int HT = 16;        // heads per row tile (the mma's M)
constexpr int MAX_R = 512;    // the largest value width
constexpr int MAX_DQ = 1024;  // the largest row
constexpr int SMEM_MAX = 232448;
constexpr int MAX_CHUNK = 4096;     // the largest chunk
constexpr int MAX_IDS = MAX_CHUNK / 8 + 2;  // page ids of a chunk at page 8
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const int8_t* kc;
  const float* ks;
  const int* lengths;
  const int* page_tbl;  // paged pool only
  void* out;
  float* part_o;    // [B * NG, n_chunks, HB, r]
  float* part_ml;   // [B * NG, n_chunks, HB, 2]
  int* counters;    // [B * NG], zero between launches
  int layer, B, H, S, Dq, r, chunk, n_chunks;
  int P, page, page_shift, max_pages;  // paged pool only; page_shift is
                                       // log2(page), or -1
  float qk_scale;   // softmax scale * log2(e)
};

// Ring stage: TT rows of kp = Dq rounded up to 128 bytes, then TT scales.
__host__ __device__ inline int row_pitch(int dq) { return (dq + 127) & ~127; }
__host__ __device__ inline int stage_bytes(int dq) { return TT * row_pitch(dq) + TT * 4; }
__host__ __device__ inline int ring_bytes(int dq) { return NST * stage_bytes(dq); }

// The XOR of a row's 16-byte units (within each aligned group of 8): row
// bits 1-2 on unit bits 1-2, row bit 0 on unit bit 2.
__device__ __forceinline__ int swz(int row) { return (((row >> 1) & 3) << 1) ^ ((row & 1) << 2); }
__device__ __forceinline__ int koff(int kp, int row, int u) { return row * kp + 16 * (u ^ swz(row)); }

// Shared memory of the tensor-core path past the ring: q fragments
// [RT][G][4][32] uint4, probabilities [RT][4][2][32] float4, (max, sum)
// [RT][4][16] float2, partial scores [4 / RT - 1][RT][4][2][32] float4.
__host__ __device__ inline int tc_smem(int dq, int rt) {
  const int g = (dq / 16 + 3) / 4;
  return ring_bytes(dq) + rt * (g * 4 * 32 * 16 + 4 * 2 * 32 * 16 + 4 * HT * 8) +
         (4 / rt - 1) * rt * 4 * 2 * 32 * 16;
}
// CUDA-core path: q [16][Dq + 4] f32, scores [16][TT + 4] f32, m, l, alpha.
constexpr int QPAD = 4, SP = TT + 4;
__host__ __device__ inline int cc_smem(int dq) {
  return ring_bytes(dq) + 4 * (HT * (dq + QPAD) + HT * SP + 3 * HT);
}

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
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

// Copy tile [t0, t0 + TT) of the slot (tokens at or past c1 zero-filled)
// into stage st: NT threads, the (row, unit) pairs stepped without a
// division, each row addressed through the block's row policy.
template <int NT, class Rows>
__device__ __forceinline__ void issue(uint8_t* st, int kp, const Args& a, const Rows& rows,
                                      int t0, int c1) {
  const int units = a.Dq / 16;
  const int dr = NT / units, du = NT - dr * units;
  int r = threadIdx.x / units, u = threadIdx.x - r * units;
  while (r < TT) {
    const int t = t0 + r;
    const bool ok = t < c1;
    cp16(st + koff(kp, r, u), a.kc + (ok ? rows.row(t) * a.Dq + 16 * u : 0), ok);
    r += dr;
    u += du;
    if (u >= units) {
      u -= units;
      ++r;
    }
  }
  if (threadIdx.x < TT) {
    const int t = t0 + threadIdx.x;
    const bool ok = t < c1;
    cp4(st + TT * kp + 4 * threadIdx.x, a.ks + (ok ? rows.row(t) : 0), ok);
  }
}

struct Block {
  int bg, chunk, b, h0, nh, used, c0, c1;
};

// The block's (slot, head group, chunk); false when its chunk starts at or
// past the slot's length (chunk 0 of an empty slot works: it writes zeros).
__device__ __forceinline__ bool locate(const Args& a, int hb, Block& k) {
  const int ng = (a.H + hb - 1) / hb;
  k.bg = blockIdx.x / a.n_chunks;
  k.chunk = blockIdx.x - k.bg * a.n_chunks;
  k.b = k.bg / ng;
  k.h0 = (k.bg - k.b * ng) * hb;
  k.nh = min(hb, a.H - k.h0);
  const int len = max(0, min(a.lengths[k.b], a.S));
  k.used = max(1, (len + a.chunk - 1) / a.chunk);
  k.c0 = k.chunk * a.chunk;
  k.c1 = min(len, k.c0 + a.chunk);
  return k.chunk < k.used;
}

// Row of token t of the block's slot in the contiguous stacked cache.
struct ContigRows {
  static constexpr int kIds = 1;  // no page ids
  size_t row0;                    // the row of token 0
  __device__ ContigRows(const Args& a, const Block& k, int*)
      : row0(((size_t)a.layer * a.B + k.b) * a.S) {}
  __device__ __forceinline__ size_t row(int t) const { return row0 + t; }
};

// Row of token t in the page pool; the constructor loads the page ids of
// the block's chunk [c0, c1) into ids (ids[0] the page of token first *
// page), every thread of the block calling it.
struct PagedRows {
  static constexpr int kIds = MAX_IDS;
  const int* ids;
  size_t layer_pages;  // layer * P
  int page, shift, first;
  __device__ PagedRows(const Args& a, const Block& k, int* ids_s)
      : ids(ids_s), layer_pages((size_t)a.layer * a.P), page(a.page),
        shift(a.page_shift), first(k.c0 / a.page) {
    const int n = k.c1 > k.c0 ? (k.c1 - 1) / page - first + 1 : 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      ids_s[i] = a.page_tbl[(size_t)k.b * a.max_pages + first + i];
    __syncthreads();
  }
  __device__ __forceinline__ size_t row(int t) const {
    const int p = shift >= 0 ? t >> shift : t / page;
    return (layer_pages + ids[p - first]) * (size_t)page + (t - p * page);
  }
};

// After a block wrote its partial: the last block of the (slot, head
// group) merges the group's chunks in chunk order into out, V floats at a
// time, U positions a thread, CU chunks' loads in flight, and resets the
// counter. smem: at least used * hb floats, free.
template <typename T, int NT, int V, int U, int CU>
__device__ void merge(const Args& a, const Block& k, int hb, uint8_t* smem) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counters + k.bg, 1) == k.used - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // weights e^(m_c - M) / L per chunk and head
  float* w = reinterpret_cast<float*>(smem);
  const size_t p0 = (size_t)k.bg * a.n_chunks;
  for (int hh = threadIdx.x; hh < k.nh; hh += NT) {
    float mx = NEG;
    for (int c = 0; c < k.used; ++c) mx = fmaxf(mx, __ldcg(a.part_ml + ((p0 + c) * hb + hh) * 2));
    float l = 0.f;
    for (int c = 0; c < k.used; ++c) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.part_ml) + (p0 + c) * hb + hh);
      l += ex2(ml.x - mx) * ml.y;
    }
    const float inv = 1.f / fmaxf(l, 1e-20f);
    for (int c = 0; c < k.used; ++c)
      w[c * hb + hh] = ex2(__ldcg(a.part_ml + ((p0 + c) * hb + hh) * 2) - mx) * inv;
  }
  __syncthreads();
  const int rv = a.r / V, n = k.nh * rv;
  const size_t step = (size_t)hb * a.r;  // floats per chunk
  T* out = reinterpret_cast<T*>(a.out) + ((size_t)k.b * a.H + k.h0) * a.r;
  for (int e0 = threadIdx.x; e0 < n; e0 += NT * U) {
    int off[U], head[U];
    float acc[U][V];
#pragma unroll
    for (int x = 0; x < U; ++x) {
      const int e = min(e0 + x * NT, n - 1);
      head[x] = e / rv;
      off[x] = head[x] * a.r + V * (e - head[x] * rv);
#pragma unroll
      for (int y = 0; y < V; ++y) acc[x][y] = 0.f;
    }
    const float* src = a.part_o + p0 * step;
#pragma unroll(CU)
    for (int c = 0; c < k.used; ++c, src += step) {
#pragma unroll
      for (int x = 0; x < U; ++x) {
        const float f = w[c * hb + head[x]];
        float val[V];
        if constexpr (V == 4) {
          const float4 t = __ldcg(reinterpret_cast<const float4*>(src + off[x]));
          val[0] = t.x, val[1] = t.y, val[2] = t.z, val[3] = t.w;
        } else {
          const float2 t = __ldcg(reinterpret_cast<const float2*>(src + off[x]));
          val[0] = t.x, val[1] = t.y;
        }
#pragma unroll
        for (int y = 0; y < V; ++y) acc[x][y] = fmaf(f, val[y], acc[x][y]);
      }
    }
#pragma unroll
    for (int x = 0; x < U; ++x) {
      if (e0 + x * NT >= n) break;
#pragma unroll
      for (int y = 0; y < V; ++y) out[off[x] + y] = from_f32<T>(acc[x][y]);
    }
  }
  if (threadIdx.x == 0) a.counters[k.bg] = 0;
}

// ---------------------------------------------------------------------------
// bf16 q on the tensor cores: RT row tiles of 16 heads, 16 warps. The
// scores split each row tile's Dq over KS = 4 / RT warps (the first of
// them adds the others' partial sums), the values split r over all 16.
// DQF: Dq known at compile time (0: read it from the arguments); DeepSeek's
// 640-byte rows run 4-6% faster so (tools/attn_probe.py mla, A B B A).
// Rows: ContigRows or PagedRows.
template <int RT, int DQF, class Rows>
__global__ void __launch_bounds__(512, 1) mla_decode_tc(const Args a) {
  constexpr int NW = 16, NT = 32 * NW, HB = HT * RT, KS = 4 / RT;
  constexpr int NSLOT = MAX_R / 32 / NW;  // value groups of 32 lanes per warp
  constexpr int PC = 2;                    // score accumulators per n-tile (mma chains)
  constexpr int GM = DQF ? (DQF / 16 + 3) / 4 : MAX_DQ / 64;  // the most unit groups
  constexpr int QE = (RT * GM * 128 + NT - 1) / NT;          // q fragments per thread
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ids[Rows::kIds];
  Block k;
  if (!locate(a, HB, k)) return;
  const Rows rows(a, k, ids);
  const int Dq = DQF ? DQF : a.Dq;
  const int kp = row_pitch(Dq), sb = stage_bytes(Dq);
  const int units = Dq / 16, G = (units + 3) / 4;
  uint4* qf = reinterpret_cast<uint4*>(smem + ring_bytes(Dq));  // [RT][G][4][32]
  float4* ps = reinterpret_cast<float4*>(qf + RT * G * 128);     // [RT][4][2][32]
  float2* mls = reinterpret_cast<float2*>(ps + RT * 256);         // [RT][4][16]
  float4* spart = reinterpret_cast<float4*>(mls + RT * 64);       // [KS - 1][RT][4][2][32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  // scores: token group, row tile, and the unit groups [g_lo, g_hi) of Dq
  const int tg = warp & 3, rs = (warp >> 2) % RT, kq = warp / (4 * RT);
  const int g_lo = kq * G / KS, g_hi = (kq + 1) * G / KS;
  // values: this lane's 4 codes of value group s * NW + warp sit at byte
  // voff[s][0] of token rows 16 kk + 2t and + 8, voff[s][1] of rows + 1 and
  // + 9 (row bits 0-2 set the swizzle)
  int voff[NSLOT][2];
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    const int u = 2 * (s * NW + warp) + (g >> 2), byte = 4 * (g & 3);
    voff[s][0] = koff(kp, 2 * t, u) + byte;
    voff[s][1] = koff(kp, 2 * t + 1, u) + byte;
  }

  // the ring: NST - 1 tiles ahead
  const int n_tiles = (k.c1 - k.c0 + TT - 1) / TT;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) issue<NT>(smem + s * sb, kp, a, rows, k.c0 + s * TT, k.c1);
    cp_commit();
  }
  // q fragments, while the first tiles are in flight, every load issued
  // before the first store: entry e = (rt, h, j, lane (gg, tt)) holds heads
  // 16 rt + gg (a0, a2) and + 8 (a1, a3) at dq 16 (4h + tt) + 4j + {0, 2}
  // (a0, a1) and + {1, 3} (a2, a3)
  {
    const __nv_bfloat16* q =
        reinterpret_cast<const __nv_bfloat16*>(a.q) + ((size_t)k.b * a.H + k.h0) * Dq;
    uint2 qv[QE][2];
#pragma unroll
    for (int i = 0; i < QE; ++i) {
      const int e = tid + i * NT, j = (e >> 5) & 3, hg = (e >> 7) % G, rt = (e >> 7) / G;
      const int u = 4 * hg + (lane & 3), d = 16 * u + 4 * j;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int hh = HT * rt + g + 8 * x;
        qv[i][x] = make_uint2(0u, 0u);
        if (e < RT * G * 128 && hh < k.nh && u < units)
          qv[i][x] = *reinterpret_cast<const uint2*>(q + (size_t)hh * Dq + d);
      }
    }
#pragma unroll
    for (int i = 0; i < QE; ++i) {
      const int e = tid + i * NT;
      if (e < RT * G * 128)
        qf[e] = make_uint4(__byte_perm(qv[i][0].x, qv[i][0].y, 0x5410),
                           __byte_perm(qv[i][1].x, qv[i][1].y, 0x5410),
                           __byte_perm(qv[i][0].x, qv[i][0].y, 0x7632),
                           __byte_perm(qv[i][1].x, qv[i][1].y, 0x7632));
    }
  }

  // running max and sum of rows g (x = 0) and g + 8 (x = 1) of each row
  // tile, the same in every warp; acc[rt][slot][c] the fragments of n-tile
  // c of value group slot * NW + warp: lanes v = 32 group + 4 n + c
  float m_run[RT][2], l_run[RT][2];
  float acc[RT][NSLOT][4][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    m_run[rt][0] = m_run[rt][1] = NEG;
    l_run[rt][0] = l_run[rt][1] = 0.f;
#pragma unroll
    for (int s = 0; s < NSLOT; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[rt][s][c][i] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_wait<NST - 2>();  // tile i has landed
    __syncthreads();
    if (i + NST - 1 < n_tiles)
      issue<NT>(smem + ((i + NST - 1) % NST) * sb, kp, a, rows, k.c0 + (i + NST - 1) * TT, k.c1);
    cp_commit();
    const int t0 = k.c0 + i * TT;
    const uint8_t* kt = smem + (i % NST) * sb;
    const float* kss = reinterpret_cast<const float*>(kt + TT * kp);

    // scores of row tile rs against tokens 16 tg + 8 n + 2 t + {0, 1}, over
    // this warp's unit groups
    {
      float sc[PC][2][4];
#pragma unroll
      for (int p = 0; p < PC; ++p)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[p][n][x] = 0.f;
      const uint4* qa = qf + rs * G * 128 + lane;
      const uint8_t* krow0 = kt + (16 * tg + g) * kp;  // tokens 16 tg + g, + 8 (same swizzle)
      const int sw = swz(16 * tg + g);
      for (int h0 = g_lo; h0 < g_hi; h0 += PC) {
#pragma unroll
        for (int p = 0; p < PC; ++p) {
          const int hg = h0 + p;
          if (hg >= g_hi) break;
          const int off = 16 * ((4 * hg + t) ^ sw);
          const uint4 k0 = *reinterpret_cast<const uint4*>(krow0 + off);
          const uint4 k1 = *reinterpret_cast<const uint4*>(krow0 + 8 * kp + off);
          const uint32_t w0[4] = {k0.x, k0.y, k0.z, k0.w}, w1[4] = {k1.x, k1.y, k1.z, k1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint4 av = qa[(4 * hg + j) * 32];
            uint32_t b0, b1, b2, b3;
            codes_bf16(w0[j], b0, b1);
            codes_bf16(w1[j], b2, b3);
            mma(sc[p][0], av.x, av.y, av.z, av.w, b0, b1);
            mma(sc[p][1], av.x, av.y, av.z, av.w, b2, b3);
          }
        }
      }
#pragma unroll
      for (int p = 1; p < PC; ++p)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[0][n][x] += sc[p][n][x];
      // the other Dq parts' sums to the first warp of (row tile, token
      // group), added in part order
      float4* sp = spart + (rs * 4 + tg) * 64 + lane;
      if (KS > 1) {
        if (kq > 0) {
          sp[((kq - 1) * RT * 4) * 64] = make_float4(sc[0][0][0], sc[0][0][1], sc[0][0][2], sc[0][0][3]);
          sp[((kq - 1) * RT * 4) * 64 + 32] = make_float4(sc[0][1][0], sc[0][1][1], sc[0][1][2], sc[0][1][3]);
        }
        __syncthreads();
        if (kq == 0) {
#pragma unroll
          for (int o = 1; o < KS; ++o) {
            const float4 u0 = sp[((o - 1) * RT * 4) * 64], u1 = sp[((o - 1) * RT * 4) * 64 + 32];
            sc[0][0][0] += u0.x, sc[0][0][1] += u0.y, sc[0][0][2] += u0.z, sc[0][0][3] += u0.w;
            sc[0][1][0] += u1.x, sc[0][1][1] += u1.y, sc[0][1][2] += u1.z, sc[0][1][3] += u1.w;
          }
        }
      }
      if (kq == 0) {
        // this token group's softmax: rows g (x = 0), g + 8
        float s[2][2][2], mloc[2] = {NEG, NEG};
        bool ok[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = 16 * tg + 8 * n + 2 * t + e;
            ok[n][e] = t0 + tok < k.c1;
            const float f = a.qk_scale * kss[tok];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              s[n][x][e] = sc[0][n][2 * x + e] * f;
              if (ok[n][e]) mloc[x] = fmaxf(mloc[x], s[n][x][e]);
            }
          }
        float lloc[2] = {0.f, 0.f}, pv[2][2][2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          mloc[x] = fmaxf(mloc[x], __shfl_xor_sync(0xffffffffu, mloc[x], 1));
          mloc[x] = fmaxf(mloc[x], __shfl_xor_sync(0xffffffffu, mloc[x], 2));
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = ok[n][e] ? ex2(s[n][x][e] - mloc[x]) : 0.f;
              lloc[x] += p;
              pv[n][x][e] = p * kss[16 * tg + 8 * n + 2 * t + e];
            }
          lloc[x] += __shfl_xor_sync(0xffffffffu, lloc[x], 1);
          lloc[x] += __shfl_xor_sync(0xffffffffu, lloc[x], 2);
        }
        // A fragment of k-step tg: (a0, a1) = n-tile 0 rows g, g + 8, (a2, a3) n-tile 1
        float4* pw = ps + (rs * 4 + tg) * 64 + lane;
        pw[0] = make_float4(pv[0][0][0], pv[0][0][1], pv[0][1][0], pv[0][1][1]);
        pw[32] = make_float4(pv[1][0][0], pv[1][0][1], pv[1][1][0], pv[1][1][1]);
        if (t == 0) {
          mls[(rs * 4 + tg) * HT + g] = make_float2(mloc[0], lloc[0]);
          mls[(rs * 4 + tg) * HT + g + 8] = make_float2(mloc[1], lloc[1]);
        }
      }
    }
    __syncthreads();

    // the tile's maximum per row from the four token groups, the same in
    // every warp; rescale the accumulators
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float2 ml[4];
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ml[j] = mls[(rt * 4 + j) * HT + g + 8 * x];
          mx = fmaxf(mx, ml[j].x);
        }
        const float m_new = fmaxf(m_run[rt][x], mx);
        const float alpha = ex2(m_run[rt][x] - m_new);
        float l = l_run[rt][x] * alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j) l = fmaf(ex2(ml[j].x - m_new), ml[j].y, l);
        l_run[rt][x] = l;
        m_run[rt][x] = m_new;
#pragma unroll
        for (int s = 0; s < NSLOT; ++s)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[rt][s][c][2 * x] *= alpha;
            acc[rt][s][c][2 * x + 1] *= alpha;
          }
      }

    // values: k-step kk is token group kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[RT][4];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        const float f0 = ex2(mls[(rt * 4 + kk) * HT + g].x - m_run[rt][0]);
        const float f1 = ex2(mls[(rt * 4 + kk) * HT + g + 8].x - m_run[rt][1]);
        const float4 u0 = ps[(rt * 4 + kk) * 64 + lane], u1 = ps[(rt * 4 + kk) * 64 + 32 + lane];
        pa[rt][0] = pack_bf16(u0.x * f0, u0.y * f0);
        pa[rt][1] = pack_bf16(u0.z * f1, u0.w * f1);
        pa[rt][2] = pack_bf16(u1.x * f0, u1.y * f0);
        pa[rt][3] = pack_bf16(u1.z * f1, u1.w * f1);
      }
      // B: codes of lanes 32 group + 4 g + {0..3} (n-tiles 0..3), tokens
      // 16 kk + 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1); rows 2t, 2t + 1,
      // 2t + 8 and 2t + 9 share row bits 1-2, so the swizzle is conflict-free
      const uint8_t* kr = kt + 16 * kk * kp;
#pragma unroll
      for (int s = 0; s < NSLOT; ++s) {
        if (32 * (s * NW + warp) >= a.r) break;
        const uint32_t v0 = *reinterpret_cast<const uint32_t*>(kr + voff[s][0]);
        const uint32_t v1 = *reinterpret_cast<const uint32_t*>(kr + voff[s][1]);
        const uint32_t v2 = *reinterpret_cast<const uint32_t*>(kr + 8 * kp + voff[s][0]);
        const uint32_t v3 = *reinterpret_cast<const uint32_t*>(kr + 8 * kp + voff[s][1]);
        uint32_t lo[4], hi[4];
        codes_bf16(__byte_perm(v0, v1, 0x5410), lo[0], lo[1]);
        codes_bf16(__byte_perm(v0, v1, 0x7632), lo[2], lo[3]);
        codes_bf16(__byte_perm(v2, v3, 0x5410), hi[0], hi[1]);
        codes_bf16(__byte_perm(v2, v3, 0x7632), hi[2], hi[3]);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mma(acc[rt][s][c], pa[rt][0], pa[rt][1], pa[rt][2], pa[rt][3], lo[c], hi[c]);
      }
    }
  }
  cp_wait<0>();

  // lanes 32 group + 8t + {0..3} (fragment 2x, n-tiles 0..3) and
  // + 4 + {0..3} (fragment 2x + 1) of rows g + 8x
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(a.out) + ((size_t)k.b * a.H + k.h0) * a.r;
  const size_t part = ((size_t)k.bg * a.n_chunks + k.chunk) * HB;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int hh = HT * rt + g + 8 * x;
      const float inv = k.used == 1 ? 1.f / fmaxf(l_run[rt][x], 1e-20f) : 1.f;
#pragma unroll
      for (int s = 0; s < NSLOT; ++s) {
        const int grp = s * NW + warp;
        if (32 * grp >= a.r) break;
        const int v = 32 * grp + 8 * t;
        float o[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o[c] = acc[rt][s][c][2 * x] * inv;
          o[4 + c] = acc[rt][s][c][2 * x + 1] * inv;
        }
        if (k.used == 1) {
          if (hh < k.nh)
            *reinterpret_cast<uint4*>(out + (size_t)hh * a.r + v) =
                make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                           pack_bf16(o[6], o[7]));
        } else {
          float4* dst = reinterpret_cast<float4*>(a.part_o + (part + hh) * a.r + v);
          dst[0] = make_float4(o[0], o[1], o[2], o[3]);
          dst[1] = make_float4(o[4], o[5], o[6], o[7]);
        }
      }
      if (k.used > 1 && warp == 0 && t == 0)
        *reinterpret_cast<float2*>(a.part_ml + (part + hh) * 2) =
            make_float2(m_run[rt][x], l_run[rt][x]);
    }
  if (k.used == 1) return;
  merge<__nv_bfloat16, NT, 4, 4 * RT, 4 / RT>(a, k, HB, smem);
}

// ---------------------------------------------------------------------------
// CUDA-core dots in f32: 16 heads a block, 4 warps.
template <typename T, class Rows>
__global__ void __launch_bounds__(128, 2) mla_decode_cc(const Args a) {
  constexpr int NT = 128, NSLOT = MAX_R / 32 / 4;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ids[Rows::kIds];
  Block k;
  if (!locate(a, HT, k)) return;
  const Rows rows(a, k, ids);
  const int Dq = a.Dq, QP = Dq + QPAD;
  const int kp = row_pitch(Dq), sb = stage_bytes(Dq), units = Dq / 16;
  float* q_s = reinterpret_cast<float*>(smem + ring_bytes(Dq));  // [16][QP], times qk_scale
  float* s_s = q_s + HT * QP;                                     // [16][SP]: scores, then p * ks
  float* m_s = s_s + HT * SP;
  float* l_s = m_s + HT;
  float* a_s = l_s + HT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int n_tiles = (k.c1 - k.c0 + TT - 1) / TT;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) issue<NT>(smem + s * sb, kp, a, rows, k.c0 + s * TT, k.c1);
    cp_commit();
  }
  const T* q = reinterpret_cast<const T*>(a.q) + ((size_t)k.b * a.H + k.h0) * Dq;
#pragma unroll 8
  for (int e = tid; e < HT * Dq; e += NT) {
    const int hh = e / Dq, d = e - hh * Dq;
    q_s[hh * QP + d] = hh < k.nh ? to_f32(q[(size_t)hh * Dq + d]) * a.qk_scale : 0.f;
  }
  if (tid < HT) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  float acc[NSLOT][HT];  // value lane 32 (slot * 4 + warp) + lane of each head
#pragma unroll
  for (int s = 0; s < NSLOT; ++s)
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) acc[s][hh] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_wait<NST - 2>();
    __syncthreads();
    if (i + NST - 1 < n_tiles)
      issue<NT>(smem + ((i + NST - 1) % NST) * sb, kp, a, rows, k.c0 + (i + NST - 1) * TT, k.c1);
    cp_commit();
    const int t0 = k.c0 + i * TT, n_ok = min(TT, k.c1 - t0);
    const uint8_t* kt = smem + (i % NST) * sb;
    const float* kss = reinterpret_cast<const float*>(kt + TT * kp);

    // scores: token j of the tile, heads hf + 2x
    {
      const int j = 16 * warp + (lane & 15), hf = lane >> 4, sw = swz(j);
      const uint8_t* krow = kt + j * kp;
      float dots[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) dots[x] = 0.f;
      for (int u = 0; u < units; ++u) {
        const uint4 kw = *reinterpret_cast<const uint4*>(krow + 16 * (u ^ sw));
        const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const float c0 = float(int8_t(words[e4])), c1 = float(int8_t(words[e4] >> 8));
          const float c2 = float(int8_t(words[e4] >> 16)), c3 = float(int8_t(words[e4] >> 24));
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const float4 qv =
                *reinterpret_cast<const float4*>(q_s + (hf + 2 * x) * QP + 16 * u + 4 * e4);
            dots[x] = fmaf(qv.x, c0, fmaf(qv.y, c1, fmaf(qv.z, c2, fmaf(qv.w, c3, dots[x]))));
          }
        }
      }
      const bool ok = j < n_ok;
#pragma unroll
      for (int x = 0; x < 8; ++x) s_s[(hf + 2 * x) * SP + j] = ok ? dots[x] * kss[j] : NEG;
    }
    __syncthreads();

    // online softmax: warp w takes heads 4w .. 4w + 3, two tokens a lane
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int hh = 4 * warp + y;
      const bool ok0 = lane < n_ok, ok1 = lane + 32 < n_ok;
      const float v0 = s_s[hh * SP + lane], v1 = s_s[hh * SP + lane + 32];
      float mx = fmaxf(ok0 ? v0 : NEG, ok1 ? v1 : NEG);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[hh], m_new = fmaxf(m_old, mx);
      const float p0 = ok0 ? ex2(v0 - m_new) : 0.f, p1 = ok1 ? ex2(v1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s_s[hh * SP + lane] = p0 * kss[lane];
      s_s[hh * SP + lane + 32] = p1 * kss[lane + 32];
      if (lane == 0) {
        const float alpha = ex2(m_old - m_new);
        a_s[hh] = alpha;
        l_s[hh] = l_s[hh] * alpha + sum;
        m_s[hh] = m_new;
      }
    }
    __syncthreads();

    // values: lanes of the first r of the same staged rows
#pragma unroll
    for (int s = 0; s < NSLOT; ++s)
#pragma unroll
      for (int hh = 0; hh < HT; ++hh) acc[s][hh] *= a_s[hh];
    for (int j0 = 0; j0 < n_ok; j0 += 4) {
      float code[NSLOT][4];
#pragma unroll
      for (int s = 0; s < NSLOT; ++s) {
        const int v = 32 * (s * 4 + warp) + lane;
#pragma unroll
        for (int y = 0; y < 4; ++y)
          code[s][y] = v < a.r ? float(int8_t(kt[koff(kp, j0 + y, v >> 4) + (v & 15)])) : 0.f;
      }
#pragma unroll
      for (int hh = 0; hh < HT; ++hh) {
        const float4 p = *reinterpret_cast<const float4*>(s_s + hh * SP + j0);
#pragma unroll
        for (int s = 0; s < NSLOT; ++s)
          acc[s][hh] = fmaf(p.x, code[s][0], fmaf(p.y, code[s][1],
                            fmaf(p.z, code[s][2], fmaf(p.w, code[s][3], acc[s][hh]))));
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  T* out = reinterpret_cast<T*>(a.out) + ((size_t)k.b * a.H + k.h0) * a.r;
  const size_t part = ((size_t)k.bg * a.n_chunks + k.chunk) * HT;
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    const int v = 32 * (s * 4 + warp) + lane;
    if (v >= a.r) continue;
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) {
      if (hh >= k.nh) break;
      if (k.used == 1)
        out[(size_t)hh * a.r + v] = from_f32<T>(acc[s][hh] / fmaxf(l_s[hh], 1e-20f));
      else
        a.part_o[(part + hh) * a.r + v] = acc[s][hh];
    }
  }
  if (k.used == 1) return;
  if (tid < HT) {
    a.part_ml[(part + tid) * 2] = m_s[tid];
    a.part_ml[(part + tid) * 2 + 1] = l_s[tid];
  }
  merge<T, NT, 2, 8, 2>(a, k, HT, smem);
}

template <auto Kernel>
int launch(int threads, int smem, const Args& a, int hb, cudaStream_t st) {
  static int sized = 0;  // the dynamic shared memory this kernel may use
  if (smem > sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  const int ng = (a.H + hb - 1) / hb;
  Kernel<<<a.B * ng * a.n_chunks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int RT, class Rows>
int run_tc(const Args& a, int smem, cudaStream_t st) {
  if (a.Dq == 640)
    return launch<mla_decode_tc<RT, 640, Rows>>(512, smem, a, HT * RT, st);
  return launch<mla_decode_tc<RT, 0, Rows>>(512, smem, a, HT * RT, st);
}

// The checks and the instance of a call: tc or CUDA cores, heads per
// block, the row policy.
template <class Rows>
int dispatch(const Args& a, int q_bf16, int tc, int heads_per_block, cudaStream_t st) {
  const int ids = Rows::kIds > 1 ? 4 * Rows::kIds : 0;  // static shared memory
  if (a.Dq % 16 || a.Dq > MAX_DQ || a.r % 2 || a.r < 2 || a.r > a.Dq || a.r > MAX_R ||
      a.chunk % TT || a.chunk < TT || a.chunk > MAX_CHUNK || a.n_chunks < 1 ||
      (size_t)a.n_chunks * heads_per_block * 4 > (size_t)ring_bytes(a.Dq))
    return (int)cudaErrorInvalidValue;
  if (tc) {
    if (!q_bf16 || a.Dq % 32 || a.r % 32) return (int)cudaErrorInvalidValue;
    const int rt = heads_per_block / HT;
    if ((rt != 1 && rt != 2) || heads_per_block % HT) return (int)cudaErrorInvalidValue;
    const int smem = tc_smem(a.Dq, rt);
    if (smem + ids > SMEM_MAX) return (int)cudaErrorInvalidValue;
    return rt == 1 ? run_tc<1, Rows>(a, smem, st) : run_tc<2, Rows>(a, smem, st);
  }
  if (heads_per_block != HT) return (int)cudaErrorInvalidValue;
  const int smem = cc_smem(a.Dq);
  if (smem + ids > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (q_bf16) return launch<mla_decode_cc<__nv_bfloat16, Rows>>(128, smem, a, HT, st);
  return launch<mla_decode_cc<float, Rows>>(128, smem, a, HT, st);
}

Args make_args(const void* q, const void* kc, const void* ks, const void* lengths, void* out,
               void* part_o, void* part_ml, void* counters, int layer, int B, int H, int Dq,
               int r, int chunk, int n_chunks, float scale) {
  Args a{};
  a.q = q;
  a.kc = reinterpret_cast<const int8_t*>(kc);
  a.ks = reinterpret_cast<const float*>(ks);
  a.lengths = reinterpret_cast<const int*>(lengths);
  a.out = out;
  a.part_o = reinterpret_cast<float*>(part_o);
  a.part_ml = reinterpret_cast<float*>(part_ml);
  a.counters = reinterpret_cast<int*>(counters);
  a.layer = layer;
  a.B = B;
  a.H = H;
  a.Dq = Dq;
  a.r = r;
  a.chunk = chunk;
  a.n_chunks = n_chunks;
  a.qk_scale = scale * LOG2E;
  return a;
}

}  // namespace

// q [B, H, Dq] (f32, or bf16 when q_bf16); latent cache [L, B, 1, S, Dq]
// int8 / [L, B, 1, S] f32; out [B, H, r] in q's type. tc: the tensor-core
// path (bf16 q, Dq and r multiples of 32) with heads_per_block 16 or 32;
// otherwise CUDA cores, heads_per_block 16. chunk: tokens per block, a
// multiple of 64 up to 4096. part_o f32 [B * NG * n_chunks *
// heads_per_block * r], part_ml f32 [... * 2] (NG = ceil(H /
// heads_per_block); unused, and may be null, when n_chunks is 1); counters
// int32 [B * NG], zero, left zero. Dq a multiple of 16 up to 1024, r even,
// up to min(Dq, 512).
extern "C" int mla_flash_decode_int8_launch(const void* q, int q_bf16, int tc, const void* kc,
                                            const void* ks, const void* lengths, void* out,
                                            void* part_o, void* part_ml, void* counters,
                                            int layer, int B, int H, int S, int Dq, int r,
                                            int heads_per_block, int chunk, int n_chunks,
                                            float scale, void* stream) {
  Args a = make_args(q, kc, ks, lengths, out, part_o, part_ml, counters, layer, B, H, Dq, r,
                     chunk, n_chunks, scale);
  a.S = S;
  return dispatch<ContigRows>(a, q_bf16, tc, heads_per_block,
                              reinterpret_cast<cudaStream_t>(stream));
}

// The latent pool [L, P, 1, page, Dq] int8 / [L, P, 1, page] f32 through
// page_tbl int32 [B, max_pages]; the rest as above with S = max_pages *
// page. chunk / page + 2 page ids must fit a block's MAX_IDS.
extern "C" int paged_mla_flash_decode_int8_launch(
    const void* q, int q_bf16, int tc, const void* kc, const void* ks, const void* page_tbl,
    const void* lengths, void* out, void* part_o, void* part_ml, void* counters, int layer,
    int B, int H, int P, int page, int max_pages, int Dq, int r, int heads_per_block, int chunk,
    int n_chunks, float scale, void* stream) {
  Args a = make_args(q, kc, ks, lengths, out, part_o, part_ml, counters, layer, B, H, Dq, r,
                     chunk, n_chunks, scale);
  if (page < 1 || max_pages < 1 || chunk / page + 2 > MAX_IDS) return (int)cudaErrorInvalidValue;
  a.page_tbl = reinterpret_cast<const int*>(page_tbl);
  a.S = max_pages * page;
  a.P = P;
  a.page = page;
  a.page_shift = (page & (page - 1)) ? -1 : __builtin_ctz(page);
  a.max_pages = max_pages;
  return dispatch<PagedRows>(a, q_bf16, tc, heads_per_block,
                             reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
