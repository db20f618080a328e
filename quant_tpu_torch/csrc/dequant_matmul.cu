// Fused dequantize + matmul for Hopper (sm_90a): y[M, N] = x[M, K] @ dequant(W),
// and its mixture-of-experts form over a stack of expert weights.
//
// Replaces: quant_tpu/kernels/dequant_matmul.py, dequant_matmul ->
//   _dequant_matmul_2d -> _kernel_int4 / _kernel_int8 (the Pallas TPU kernel),
//   and dequant_matmul_moe (the same Pallas bodies fanned over expert slots).
//
// W is a QTensor: int4 codes uint8 [K/2, N] in the split-K layout (byte[i, n]
// holds row i in the low nibble and row i + K/2 in the high nibble, biased by
// +8) or int8 codes [K, N], with f32 group scales [K/G, N]. Stacked weights
// arrive as the codes[layer] / scales[layer] views of the stack. The layout
// is read as stored: nothing is repacked at load time.
//
// Three tiles; the wrapper (kernels/dequant_matmul.py) picks one from x's
// dtype, M and the shape, and counts each launch under the tile's name. The
// tensor-core tiles, the int8-activation (aq) tile and its x pre-pass are
// here; the CUDA-core tile is csrc/dequant_matmul_cc.cu, built beside it.
//
// * tc_decode, bf16 x and M <= 16 (tc::decode_tile). Bound by the bytes of
//   the codes (half a byte per weight). On the CUDA cores each weight costs
//   unpack, scale and rounding before its FMAs, and the instruction issue,
//   not the bytes, sets the time. Here the tensor cores do the products:
//   mma.m16n8k16 with the operands swapped, the weight as A (16 output
//   columns x 16 k), x^T as B (8 tokens), so no tensor-core row pads M up
//   to 16. Each code byte feeds two k-steps, its low nibble against x[:, i]
//   and its high nibble against x[:, i + K/2]. A nibble becomes bf16 without
//   a multiply: one lop3 ORs two nibbles into the mantissa of 128.0, which
//   gives 128 + q exactly, and one more mma per k-step, of an all-ones A
//   against the same x, gives sum(x), of which 136 times comes off each
//   group's partial sums. int8 codes are exact in bf16 too. The group
//   scales multiply f32 partial sums, per group and half, as the JAX
//   kernel's _scaled_dots does, not each weight: a group costs a thread two
//   float4 scale loads and a few FMAs. The codes and x stream through a
//   4-stage cp.async ring of 64 packed rows a stage (16-byte copies, each
//   thread's offsets fixed for the block); only the block's K slices of x
//   are staged. Split-K across blocks keeps enough bytes in flight; the
//   last block of an output tile (a self-resetting counter) sums the f32
//   partials in partition order and stores the output type, so there is no
//   memset and no cast launch and the sum order is fixed.
// * tc_prefill, bf16 x and M > 16 (tc::prefill_tile). Bound by the tensor
//   cores at M = 512. 128 x 128 output tiles of 2 x 2 warps, mma.m16n8k16
//   with x as A (ldmatrix from a swizzled cp.async ring) and the codes
//   dequantized straight into B fragments. A warp's 128 f32 accumulators
//   leave no registers for per-group partial sums, so here the scale
//   multiplies the bf16 weights (one bf16x2 multiply per two weights; the
//   plain version scales its weights before the product too). Split-K only
//   where the output tiles would not fill the SMs.
//
// Codebook weights (the JAX kernel's lut_mode; int4 codes whose nibble is an
// index into a float32 table lut[16] of the layer): both tensor-core tiles
// look each nibble up in a 16-word table in shared memory (lut_frags) where
// the linear tiles turn it into 128 + q. word4 takes round(lut * 127),
// exact in bf16, and multiplies the group scales by fl(1/127), as the JAX
// kernel folds 1/127 in; sel15 takes the float32 table, split into bf16 hi
// and lo parts at decode M (two mma a k-step) and rounded to bf16 at
// prefill M, as the JAX kernel's bf16 compute type rounds it above M = 64.
// Int8 activations (aq, the JAX kernel's _scaled_dots_aq; W8A8 and W4A8):
// a pre-pass (act_quant_kernel) puts x on its per-(row, group) int8 grid
// and the aq tile (aq_tile) runs mma.m16n8k32.s8, each group's dot exact in
// int32 before its scales; its note gives the layout.
//
// Mixture of experts (dequant_matmul_moe_kernel, every tile): the expert
// weights are one expert-major stack [E * L, K/2 or K, N]; expert e of layer
// l is entry e * L + l. Expert SLOTS ride the grid's z dimension beside the
// split-K partitions, and slot j uses expert j, or hot[1 + j] when a hot
// list [n_hot, ids...] is given. Every stack offset is 64-bit: Mixtral's
// gate|up stack holds 15 GB of codes.
// * concat: every slot reads the same x [M, K] and writes its own N columns
//   of y [M, slots * N].
// * sum: slot j reads its own rows x[j] of [slots, M, K] and y is [M, N].
//   The tensor-core tiles run the slots as one long contraction (the slots'
//   K ranges end to end); the CUDA-core tile adds them by atomicAdd.
// * grouped (the capacity dispatch's grouped GEMM, the JAX kernel's
//   mode="grouped"): slot j reads its own rows x[j] of [slots, M, K], as
//   sum does, and writes its own y[j] of [slots, M, N], as concat writes
//   its own columns; jobs, split-K and the fix-up are concat's, per (slot,
//   output tile). JAX builds [M, slots * N] and moves the axis; the values
//   are the same.
// * hot: each block reads n_hot and its slot's expert id on the device (no
//   host sync, no grid sized per step), and the grid's z blocks are shared
//   out among the n_hot active slots only, so the whole grid streams the hot
//   experts' bytes and a slot at or past n_hot streams nothing: its concat
//   columns (grouped: its rows) are exact zeros, and in sum mode it adds
//   nothing; its x rows are never read.
// * aq (int8 activations) runs every mode under the same slot plan: the
//   pre-pass quantizes x as rows ([M, K] for concat, [slots * M, K] for the
//   per-slot modes), and the aq tile reads a slot's codes and scales at the
//   slot's first row; its partitions hold whole K groups (the plan rounds
//   them to lcm(64, G) packed rows), so each group's int32 dot is whole.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// word4 (LUT 1): the table's entries arrive times 127, so the group scales
// are multiplied by fl(1/127), as the JAX kernel and transcode_lut_int8 do
constexpr float INV127 = 1.0f / 127.0f;
template <int LUT> __device__ __forceinline__ float4 fold(float4 s) {
  if (LUT == 1) {
    s.x *= INV127;
    s.y *= INV127;
    s.z *= INV127;
    s.w *= INV127;
  }
  return s;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ── tensor-core tiles (bf16 x) ─────────────────────────────────────────────
namespace tc {

constexpr int STAGES = 4;     // ring depth: three stages in flight
constexpr int THREADS = 128;  // 4 warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; ok == false writes 16 zero bytes and
// reads nothing
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The nibbles at bits 0-3 and 16-19 of w as bf16x2 128 + q: one lop3 ORs
// them into the mantissa of 128.0 (0x4300, whose last mantissa bit is worth
// 1). Exact.
__device__ __forceinline__ uint32_t nib_bf16x2(uint32_t w) {
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"      // (w & 0x000F000F) | 0x43004300
      : "=r"(v)
      : "r"(w), "r"(0x000F000Fu), "r"(0x43004300u));
  return v;
}

// 128 + q -> q - 8 (the stored bias), exact
__device__ __forceinline__ uint32_t unbias(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"       // v * 1.0 - 136.0
      : "=r"(r)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Signed bytes b0 (low half) and b1 (high half) of w as bf16x2, exact.
__device__ __forceinline__ uint32_t s8_bf16x2(uint32_t w, int b0, int b1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      static_cast<float>(static_cast<int8_t>(w >> (8 * b0))),
      static_cast<float>(static_cast<int8_t>(w >> (8 * b1))));
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"       // a * b + (-0.0)
      : "=r"(r)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return r;
}

// Weight fragments of one 16-row k-step for one thread (lane = 4 g + t):
// rows[q] holds 8 code bytes (columns 8g .. 8g+7 of the warp's 64) of four
// packed rows of the k-step. f[h][c][p] is the bf16x2 pair {rows[2p],
// rows[2p+1]} of column 8g+c in half h (int4: h = 0 the low nibbles, rows
// i; h = 1 the high nibbles, rows i + K/2). That pair is what one fragment
// register of mma.m16n8k16 holds for one row of A or one column of B: k
// slots {2t, 2t+1} (p = 0) or {2t+8, 2t+9}; the caller picks which packed
// rows stand in those slots and gives x the same order. int4 weights come
// out as q - 8, or as 128 + q when BIASED (the caller takes 136 * sum(x)
// off the partial sums instead).
template <int BITS, bool BIASED>
__device__ __forceinline__ void weight_frags(const uint2 (&rows)[4],
                                             uint32_t (&f)[BITS == 4 ? 2 : 1][8][2]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t ua = i < 2 ? rows[2 * p].x : rows[2 * p].y;
      const uint32_t ub = i < 2 ? rows[2 * p + 1].x : rows[2 * p + 1].y;
      // bytes {row a col 2i, row a col 2i+1, row b col 2i, row b col 2i+1}
      const uint32_t w = __byte_perm(ua, ub, (i & 1) ? 0x7632 : 0x5410);
      if constexpr (BITS == 4) {
        f[0][2 * i][p] = nib_bf16x2(w);
        f[0][2 * i + 1][p] = nib_bf16x2(w >> 8);
        f[1][2 * i][p] = nib_bf16x2(w >> 4);
        f[1][2 * i + 1][p] = nib_bf16x2(w >> 12);
        if constexpr (!BIASED) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            f[h][2 * i][p] = unbias(f[h][2 * i][p]);
            f[h][2 * i + 1][p] = unbias(f[h][2 * i + 1][p]);
          }
        }
      } else {
        f[0][2 * i][p] = s8_bf16x2(w, 0, 2);
        f[0][2 * i + 1][p] = s8_bf16x2(w, 1, 3);
      }
    }
  }
}

// A codebook weight's fragments, in weight_frags's layout: the nibble is an
// index into tab[16], each entry a bf16x2 {hi, lo} (hi in the low half):
// fh[h][c][p] the pair {rows[2p], rows[2p+1]} of the entries' hi parts, fl
// of their lo parts (LO; sel15 on the decode tile splits the float32 table
// into hi + lo). Eight shared-memory lookups per code word; a table of
// 16 words sits in 16 banks, so lanes that read one entry share the read.
template <bool LO>
__device__ __forceinline__ void lut_frags(const uint2 (&rows)[4],
                                          const uint32_t* __restrict__ tab,
                                          uint32_t (&fh)[2][8][2],
                                          uint32_t (&fl)[2][8][2]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t ua = i < 2 ? rows[2 * p].x : rows[2 * p].y;
      const uint32_t ub = i < 2 ? rows[2 * p + 1].x : rows[2 * p + 1].y;
      // nibbles 0..7: (a, 2i) lo, hi, (a, 2i+1) lo, hi, then row b's
      const uint32_t w = __byte_perm(ua, ub, (i & 1) ? 0x7632 : 0x5410);
      uint32_t e[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) e[q] = tab[(w >> (4 * q)) & 0xF];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fh[h][2 * i][p] = __byte_perm(e[h], e[4 + h], 0x5410);
        fh[h][2 * i + 1][p] = __byte_perm(e[2 + h], e[6 + h], 0x5410);
        if constexpr (LO) {
          fl[h][2 * i][p] = __byte_perm(e[h], e[4 + h], 0x7632);
          fl[h][2 * i + 1][p] = __byte_perm(e[2 + h], e[6 + h], 0x7632);
        }
      }
    }
  }
}

// The table entry of float32 value v: word4 (LUT 1) rint(v * 127), exact in
// bf16; sel15 (LUT 2) bf16(v), with bf16(v - hi) in the high half when LO.
template <int LUT, bool LO>
__device__ __forceinline__ uint32_t lut_entry(float v) {
  const float q = LUT == 1 ? rintf(v * 127.f) : v;
  const __nv_bfloat16 hi = __float2bfloat16_rn(q);
  const __nv_bfloat16 lo =
      __float2bfloat16_rn(LO ? q - __bfloat162float(hi) : 0.f);
  const __nv_bfloat162 h2 = __halves2bfloat162(hi, lo);
  return *reinterpret_cast<const uint32_t*>(&h2);
}

// Code rows in shared memory: 16-byte chunk c of row r lives at chunk
// c ^ cswz<S>(r), so the four rows a warp reads at once (rows 4t + q at
// decode, S = 2; rows 2t + q at prefill, S = 1; t = 0..3) fall in both
// halves of the banks.
template <int S> __device__ __forceinline__ int cswz(int r) {
  return ((r >> S) & 1) << 2;
}

struct Args {
  const __nv_bfloat16* x;
  const int8_t* xq;     // aq: x's int8 codes [M, K] and scales [M, K/G]
  const float* sx;
  const float* lut;     // a codebook weight's table [16] (null: linear)
  const uint8_t* codes;
  const float* scales;
  void* out;
  float* ws;            // [grid z, M, N] f32 partials (null: one partition)
  int* counters;        // per output tile, zero between launches
  const int* hot;       // [1 + slots]: n_hot, then expert ids; null: all
  long long codes_stride, scales_stride;  // per stack entry (bytes, floats)
  int out_f32, M, K, N, G;
  int layer, stride, experts, slots, sum;
  int grouped;          // x [slots, M, K] -> y [slots, M, N]
  int splits, per, cap;  // host plan: partitions, packed rows each; cap:
                         // most partitions of a concat slot under a hot list
};

// What a block computes: the packed rows [e0, e1) of the contraction, in
// slot-major order with KPpad rows per slot (K/2 or K rows padded to a
// whole number of the tile's stages; the sum mode's slots are one
// long contraction), as partition `part` of the `parts` that make up its
// output tile (concat: slot `slot`'s columns).
struct Job {
  int e0, e1, slot, part, parts, zbase;
};

constexpr __host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ int active_slots(const Args& a) {
  return a.hot == nullptr ? a.slots : min(max(__ldg(a.hot), 0), a.slots);
}

// Where output row m of slot `slot` starts: y [M, N] (sum), [M, slots * N]
// (concat) or [slots, M, N] (grouped).
__device__ __forceinline__ size_t out_row(const Args& a, int slot, int m) {
  if (a.sum) return (size_t)m * a.N;
  if (a.grouped) return ((size_t)slot * a.M + m) * a.N;
  return (size_t)m * a.slots * a.N + (size_t)slot * a.N;
}

// Without a hot list the host's plan; with one, the grid's z blocks shared
// out on the device among the n_hot active slots (concat) or over the
// n_hot slots' rows (sum). false: the block has no partition.
__device__ bool plan(const Args& a, int KPpad, int bkp, int active, Job& j) {
  const int Z = gridDim.z, z = blockIdx.z;
  if (active == 0) return false;
  if (a.sum) {
    const int total = active * KPpad;
    const int per = a.hot ? cdiv(cdiv(total, Z), bkp) * bkp : a.per;
    j.parts = cdiv(total, per);
    j.slot = 0;
    j.part = z;
    j.zbase = 0;
    if (z >= j.parts) return false;
    j.e0 = z * per;
    j.e1 = min(total, j.e0 + per);
    return true;
  }
  int zs = a.splits, per = a.per;
  if (a.hot) {
    zs = max(1, min(min(Z / active, a.cap), KPpad / bkp));
    per = cdiv(cdiv(KPpad, zs), bkp) * bkp;
  }
  j.parts = cdiv(KPpad, per);
  j.slot = z / zs;
  j.part = z - j.slot * zs;
  j.zbase = j.slot * zs;
  if (j.slot >= active || j.part >= j.parts) return false;
  j.e0 = j.slot * KPpad + j.part * per;
  j.e1 = j.slot * KPpad + min(KPpad, (j.part + 1) * per);
  return true;
}

// Where the block's contraction stands: the slot rank and first packed row
// of a stage, stepped one stage at a time (no division per stage), with the
// slot's weights and x. B: packed rows per stage.
template <int B>
struct Cursor {
  const uint8_t* codes;
  const float* scales;
  const __nv_bfloat16* x;
  size_t xrow;          // the slot's first row of x (and of the aq codes)
  int rank, kp0, rows;  // the stage holds packed rows [kp0, kp0 + rows)
  bool live;            // false: the slot's expert id is outside the stack

  __device__ __forceinline__ void point(const Args& a) {
    const int ex = a.hot ? __ldg(a.hot + 1 + rank) : rank;
    live = ex >= 0 && ex < a.experts;
    const size_t w = live ? (size_t)ex * a.stride + a.layer : 0;
    codes = a.codes + w * a.codes_stride;
    scales = a.scales + w * a.scales_stride;
    xrow = a.sum || a.grouped ? (size_t)rank * a.M : 0;
    x = a.x == nullptr ? nullptr : a.x + xrow * a.K;
  }
  __device__ __forceinline__ void start(const Args& a, int e, int KP,
                                        int KPpad) {
    rank = e / KPpad;
    kp0 = e - rank * KPpad;
    rows = min(B, KP - kp0);
    point(a);
  }
  // to the next stage; `more`: there is one (the rank may not be read past
  // the last)
  __device__ __forceinline__ void next(const Args& a, int KP, int KPpad,
                                       bool more) {
    kp0 += B;
    if (kp0 >= KPpad) {
      kp0 = 0;
      ++rank;
      if (more) point(a);
    }
    rows = min(B, KP - kp0);
  }
};

// A thread's share of a stage's code copies, as offsets fixed for the
// block: chunk c of rows r0 + R q (R = THREADS / chunks per row), columns
// [n0, n0 + BN), B rows per stage. A copy past the stage's rows or the
// matrix's columns reads nothing and writes zeros.
template <int BN, int S, int B>
struct CodeCopies {
  static constexpr int CH = BN / 16, R = THREADS / CH, NQ = B / R;
  int r0, src0, dst0;
  bool col_ok;

  __device__ __forceinline__ CodeCopies(int tid, int N, int n0) {
    r0 = tid / CH;
    const int c = tid % CH, col = n0 + 16 * c;
    col_ok = col < N;
    src0 = r0 * N + col;
    dst0 = r0 * BN + 16 * (c ^ cswz<S>(r0));  // the swizzle repeats every R
  }
  __device__ __forceinline__ void issue(uint8_t* dst, const Cursor<B>& cur,
                                        int N) const {
    const uint8_t* src = cur.codes + (size_t)cur.kp0 * N + src0;
    const bool ok = cur.live && col_ok;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      cp16(dst + dst0 + q * R * BN, src + (size_t)q * R * N,
           ok && r0 + R * q < cur.rows);
  }
};

// 8 consecutive output values to out[idx ..] (16-byte aligned)
__device__ __forceinline__ void store8(void* out, int out_f32, size_t idx,
                                       const float (&v)[8]) {
  if (out_f32) {
    float4* y = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + idx);
    y[0] = make_float4(v[0], v[1], v[2], v[3]);
    y[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 u;
    uint32_t* p = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      p[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(out) + idx) = u;
  }
}

__device__ __forceinline__ void store4(void* out, int out_f32, size_t idx,
                                       float4 v) {
  if (out_f32) {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + idx) = v;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + idx) = u;
  }
}

// Output tile [m0, m0 + BM) x [n0, n0 + BN) of slot `slot`'s output: exact
// zeros (a cold slot under a hot list, or a sum over no slot).
template <int BM, int BN>
__device__ void zero_tile(const Args& a, int slot, int m0, int n0, int tid) {
  for (int i = tid; i < BM * BN / 4; i += THREADS) {
    const int m = m0 + i / (BN / 4), n = n0 + 4 * (i % (BN / 4));
    if (m < a.M && n < a.N)
      store4(a.out, a.out_f32, out_row(a, slot, m) + n,
             make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// After a block stored its partial in ws: the last partition of the output
// tile to finish (a self-resetting counter) sums the partials in partition
// order (a fixed order, whichever block comes last) and stores the output.
template <int BM, int BN>
__device__ void fix_up(const Args& a, const Job& j, int m0, int n0, int tid) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int mt = gridDim.y, nt = gridDim.x;
  int* counter = a.counters +
                 ((size_t)j.slot * mt + blockIdx.y) * nt + blockIdx.x;
  if (tid == 0) last = atomicAdd(counter, 1) == j.parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each thread sums its float4s of the tile four at a time, so 16 loads
  // are in flight per thread and a partial's sum does not wait on the last
  constexpr int PER = BM * BN / 4 / THREADS, CHUNK = PER < 4 ? PER : 4;
  const size_t step = (size_t)a.M * a.N / 4;        // float4s per partial
  const float4* ws = reinterpret_cast<const float4*>(a.ws) + j.zbase * step;
#pragma unroll 1
  for (int k0 = 0; k0 < PER; k0 += CHUNK) {
    float4 sum[CHUNK];
    size_t off[CHUNK], dst[CHUNK];                  // float4 in ws, out index
    bool ok[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int e = tid + (k0 + k) * THREADS;
      const int m = m0 + e / (BN / 4), n = n0 + 4 * (e % (BN / 4));
      ok[k] = m < a.M && n < a.N;
      off[k] = ok[k] ? ((size_t)m * a.N + n) / 4 : 0;
      dst[k] = ok[k] ? out_row(a, j.slot, m) + n : 0;
      sum[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 4
    for (int p = 0; p < j.parts; ++p)
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        if (ok[k]) {
          const float4 v = __ldcg(ws + p * step + off[k]);
          sum[k] = make_float4(sum[k].x + v.x, sum[k].y + v.y, sum[k].z + v.z,
                               sum[k].w + v.w);
        }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k)
      if (ok[k]) store4(a.out, a.out_f32, dst[k], sum[k]);
  }
  if (tid == 0) *counter = 0;
}

// ── decode tile: M <= 16, bound by the bytes of the codes ──────────────────
// The operands are swapped: the dequantized weight is the A operand (16
// output columns x 16 k), x^T the B operand (8 tokens per n-tile), so no
// tensor-core row pads M up to 16. Each warp owns 64 columns (4 A tiles);
// lane (g, t) reads 8 code bytes (columns 8g .. 8g+7) of the 4 packed rows
// 4t .. 4t+3 of each k-step (k slots 2t, 2t+1, 2t+8, 2t+9), so its x^T
// fragment is one 8-byte load, and A tile i's rows g and g+8 are columns
// 8g+2i and 8g+2i+1. int4 weights enter as 128 + q: one more mma per
// k-step, of an all-ones A against the same x, gives sum(x), and 136 times
// it comes off each group's partial sums. The group scales multiply those
// f32 partial sums, per group and half, not weights.
template <int BITS_, int NT_, int LUT_ = 0>
struct Decode {
  static constexpr bool DECODE = true, AQ = false;
  static constexpr int BITS = BITS_, NT = NT_, LUT = LUT_;
  static constexpr int BKP = 64;                    // packed rows per stage
  static constexpr int HALVES = BITS == 4 ? 2 : 1;
  static constexpr int BM = 8 * NT;                 // token rows
  static constexpr int BN = 256;                    // 4 warps x 64 columns
  static constexpr int XP = HALVES * BKP + 16;      // x row pitch (bf16): a
                                                    // half-warp's 8-byte B
                                                    // loads hit 32 banks
  static constexpr int CODE_BYTES = STAGES * BKP * BN;
  static constexpr int TAB = CODE_BYTES + STAGES * BM * XP * 2;  // table
  static constexpr int SMEM = TAB + (LUT ? 64 : 0);
  static constexpr int MIN_BLOCKS = NT == 1 ? 3 : 2;  // per SM: registers
};

// A codebook weight (LUT 1 word4, 2 sel15) takes the table's entries for
// its nibbles in place of 128 + q, so no sum(x) correction runs; sel15
// splits each float32 entry into bf16 hi + lo and runs a second mma per
// k-step on the lo parts into the same partial sums (about 2^-17 of the
// entry, where bf16 alone keeps 2^-9); word4's entries are exact integers
// and its scales carry the 1/127.
template <int BITS, int NT, int LUT>
__device__ void decode_tile(const Args& a, const Job& j, uint8_t* smem) {
  using D = Decode<BITS, NT, LUT>;
  constexpr int H = D::HALVES, BKP = D::BKP;
  constexpr bool BIASED = BITS == 4 && LUT == 0, LO = LUT == 2;
  constexpr uint32_t ONES = 0x3F803F80u;            // bf16x2 {1, 1}
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int KP = BITS == 4 ? a.K / 2 : a.K;
  const int KPpad = cdiv(KP, BKP) * BKP;
  const int n0 = blockIdx.x * D::BN;
  const int ncol = n0 + 64 * warp + 8 * g;          // this lane's 8 columns
  const bool col_ok = ncol < a.N;
  const int nst = cdiv(j.e1 - j.e0, BKP);
  uint8_t* codes_s = smem;
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem + D::CODE_BYTES);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + D::TAB);
  // read after the first stage's barrier
  if (LUT && tid < 16) tab[tid] = lut_entry<LUT, LO>(a.lut[tid]);

  // the stage the loader fills next and the stage the warps compute
  Cursor<BKP> ld, cu;
  ld.start(a, j.e0, KP, KPpad);
  cu = ld;
  const CodeCopies<D::BN, 2, BKP> copies(tid, a.N, n0);
  // x: chunk xc (half xh) of token rows xm + XR q
  constexpr int XCH = H * BKP / 8;                  // chunks per staged row
  constexpr int XR = THREADS / XCH, XQ = cdiv(D::BM * XCH, THREADS);
  const int xm = tid / XCH, xc = tid % XCH;
  const int xh = xc / (BKP / 8), xk8 = 8 * (xc % (BKP / 8));
  const int x_src = xm * a.K + xh * KP + xk8, x_dst = xm * D::XP + xh * BKP + xk8;
  auto load = [&](int s) {
    const int slot = s % STAGES;
    copies.issue(codes_s + slot * BKP * D::BN, ld, a.N);
    const __nv_bfloat16* src = ld.x + ld.kp0 + x_src;
    __nv_bfloat16* dst = x_s + slot * D::BM * D::XP + x_dst;
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      if (xm + XR * q >= D::BM) break;
      cp16(dst + q * XR * D::XP, src + (size_t)q * XR * a.K,
           ld.live && xm + XR * q < a.M && xk8 < ld.rows);
    }
    ld.next(a, KP, KPpad, s + 1 < nst);
  };
  // acc: the output; part: this group's partial sums, per half; xsum: the
  // group's sum(x) per half and token (int4)
  float acc[4][NT][4], part[H][4][NT][4], xsum[H][NT][4];
  float4 sc[H][2];
  int rem[H], grp[H];                               // k-steps left, group row
#pragma unroll
  for (int h = 0; h < H; ++h) {
    sc[h][0] = sc[h][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    rem[h] = grp[h] = 0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xsum[h][n][c] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) part[h][i][n][c] = 0.f;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nst) load(s + STAGES - 1);
    cp_commit();
    const Cursor<BKP> st = cu;
    cu.next(a, KP, KPpad, s + 1 < nst);
    if (!st.live) continue;
    const uint8_t* cs = codes_s + (s % STAGES) * BKP * D::BN;
    const __nv_bfloat16* xs = x_s + (s % STAGES) * D::BM * D::XP;
    // k-steps in pairs, each pair's code rows and x^T fragments read ahead
    // of its products
    constexpr int KS = BKP / 16;
#pragma unroll
    for (int k2 = 0; k2 < KS; k2 += 2) {
    uint2 rows[2][4], bx[2][H][NT];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = k2 + kk;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * ks + 4 * t + q;
        const int chunk = 4 * warp + (g >> 1);
        rows[kk][q] = *reinterpret_cast<const uint2*>(
            cs + r * D::BN + 16 * (chunk ^ cswz<2>(r)) + 8 * (g & 1));
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          bx[kk][h][n] = *reinterpret_cast<const uint2*>(
              xs + (8 * n + g) * D::XP + h * BKP + 16 * ks + 4 * t);
    }
    // a stage holds a multiple of 16 rows; past them the codes and x are
    // zeros, so a k-step there adds nothing, and its bookkeeping is skipped
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = k2 + kk;
      const bool valid = 16 * ks < st.rows;
      const int kp = st.kp0 + 16 * ks;
      if (valid && ((s == 0 && ks == 0) || kp == 0)) {  // a slot's first k-step
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int kh = kp + h * KP;
          grp[h] = kh / a.G;
          rem[h] = (a.G - kh % a.G) / 16;
          if (col_ok) {
            const float4* p = reinterpret_cast<const float4*>(
                st.scales + (size_t)grp[h] * a.N + ncol);
            sc[h][0] = fold<LUT>(__ldg(p));
            sc[h][1] = fold<LUT>(__ldg(p + 1));
          }
        }
      }
      uint32_t f[H][8][2], fl[H][8][2];
      if constexpr (LUT != 0)
        lut_frags<LO>(rows[kk], tab, f, fl);
      else
        weight_frags<BITS, BIASED>(rows[kk], f);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint2 b = bx[kk][h][n];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mma(part[h][i][n], f[h][2 * i][0], f[h][2 * i + 1][0],
                f[h][2 * i][1], f[h][2 * i + 1][1], b.x, b.y);
            if (LO)
              mma(part[h][i][n], fl[h][2 * i][0], fl[h][2 * i + 1][0],
                  fl[h][2 * i][1], fl[h][2 * i + 1][1], b.x, b.y);
          }
          if (BIASED) mma(xsum[h][n], ONES, ONES, ONES, ONES, b.x, b.y);
        }
      if (!valid) continue;
      const bool slot_end = kp + 16 == KP;
      const bool last = slot_end ||
                        (s == nst - 1 && (ks == KS - 1 || 16 * (ks + 1) >= st.rows));
#pragma unroll
      for (int h = 0; h < H; ++h) {
        --rem[h];
        if (rem[h] == 0 || last) {
          // flush: column 8g + 2i + (c >> 1) of tile i, token 8n + 2t +
          // (c & 1); every row of the all-ones product is sum(x)
          float u[NT][4];
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              u[n][c] = BIASED ? -136.f * xsum[h][n][c] : 0.f;
              xsum[h][n][c] = 0.f;
            }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float s0 = i < 2 ? (i == 0 ? sc[h][0].x : sc[h][0].z)
                                   : (i == 2 ? sc[h][1].x : sc[h][1].z);
            const float s1 = i < 2 ? (i == 0 ? sc[h][0].y : sc[h][0].w)
                                   : (i == 2 ? sc[h][1].y : sc[h][1].w);
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[i][n][c] = fmaf(c < 2 ? s0 : s1, part[h][i][n][c] + u[n][c],
                                    acc[i][n][c]);
                part[h][i][n][c] = 0.f;
              }
          }
        }
        if (rem[h] == 0) {
          // the next group's scales load now and wait in registers until
          // it is flushed
          rem[h] = a.G / 16;
          ++grp[h];
          if (!slot_end && col_ok) {
            const float4* p = reinterpret_cast<const float4*>(
                st.scales + (size_t)grp[h] * a.N + ncol);
            sc[h][0] = fold<LUT>(__ldg(p));
            sc[h][1] = fold<LUT>(__ldg(p + 1));
          }
        }
      }
    }
    }
  }
  cp_wait<0>();

  // lane (g, t) holds columns ncol .. ncol+7 of tokens 8n + 2t + b
  const bool direct = j.parts == 1;
  void* dst = direct ? a.out : a.ws;
  const int dst_f32 = direct ? a.out_f32 : 1;
  const size_t base = (size_t)(j.zbase + j.part) * a.M * a.N;
  if (col_ok) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int m = 8 * n + 2 * t + b;
        if (m >= a.M) continue;
        float v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[2 * i] = acc[i][n][b];
          v[2 * i + 1] = acc[i][n][2 + b];
        }
        store8(dst, dst_f32,
               (direct ? out_row(a, j.slot, m) : base + (size_t)m * a.N) + ncol,
               v);
      }
  }
  if (!direct) fix_up<D::BM, D::BN>(a, j, 0, n0, tid);
}

// ── prefill tile: M > 16, bound by the tensor cores ────────────────────────
// 128 x 128 output tiles, 2 x 2 warps of 64 x 64. x goes to shared memory
// by cp.async (128-byte rows, 16-byte chunks swizzled for ldmatrix), the
// codes as at decode. Each warp dequantizes its 64 columns straight into B
// fragments (n8-tile j, column g is column 8g + j of the warp's strip) and
// reads A (x) with ldmatrix. A warp tile's 128 f32 accumulators leave no
// room for per-group partial sums, so here the scale multiplies the bf16
// weights (one bf16x2 multiply per two weights), as the plain version
// scales its weights before the product.
template <int BITS_, int LUT_ = 0>
struct Prefill {
  static constexpr bool DECODE = false, AQ = false;
  static constexpr int BITS = BITS_, LUT = LUT_;
  static constexpr int BKP = 32;                    // packed rows per stage
  static constexpr int HALVES = BITS == 4 ? 2 : 1;
  static constexpr int BM = 128, BN = 128;
  static constexpr int XROW = HALVES * BKP * 2;     // bytes per staged x row
  static constexpr int CODE_BYTES = STAGES * BKP * BN;
  static constexpr int TAB = CODE_BYTES + STAGES * BM * XROW;  // table
  static constexpr int SMEM = TAB + (LUT ? 64 : 0);
  static constexpr int MIN_BLOCKS = 1;
};

// 16-byte chunk c of staged x row r: int4 rows are 8 chunks (c ^ (r & 7)),
// int8 rows 4 chunks (c ^ ((r >> 1) & 3)); either way the 8 rows an
// ldmatrix reads hit all 32 banks.
template <int HALVES>
__device__ __forceinline__ int xswz(int r, int c) {
  return HALVES == 2 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

// A codebook weight's B fragments come from the table (LUT 1 word4's exact
// integers with the scales times fl(1/127); LUT 2 sel15's float32 entries
// rounded to bf16, as the JAX kernel's bf16 compute type rounds them above
// M = 64) and are scaled like linear codes.
template <int BITS, int LUT>
__device__ void prefill_tile(const Args& a, const Job& j, uint8_t* smem) {
  using P = Prefill<BITS, LUT>;
  constexpr int H = P::HALVES, BKP = P::BKP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int KP = BITS == 4 ? a.K / 2 : a.K;
  const int KPpad = cdiv(KP, BKP) * BKP;
  const int n0 = blockIdx.x * P::BN, m0 = blockIdx.y * P::BM;
  const int ncol = n0 + 64 * wn + 8 * g;            // this lane's B columns
  const bool col_ok = ncol < a.N;
  const int nst = cdiv(j.e1 - j.e0, BKP);
  uint8_t* codes_s = smem;
  uint8_t* x_s = smem + P::CODE_BYTES;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + P::TAB);
  if (LUT && tid < 16) tab[tid] = lut_entry<LUT, false>(a.lut[tid]);

  // the stage the loader fills next and the stage the warps compute
  Cursor<BKP> ld, cu;
  ld.start(a, j.e0, KP, KPpad);
  cu = ld;
  const CodeCopies<P::BN, 1, BKP> copies(tid, a.N, n0);
  // x: chunk xc of rows xr0 + XR q of the tile
  constexpr int XCH = P::XROW / 16, XR = THREADS / XCH, XQ = P::BM / XR;
  const int xr0 = tid / XCH, xc = tid % XCH;
  const int xk8 = 8 * (xc % 4);
  const int x_src = (m0 + xr0) * a.K + (xc / 4) * KP + xk8;
  const int x_dst = xr0 * P::XROW + 16 * xswz<H>(xr0, xc);  // repeats every XR
  auto load = [&](int s) {
    const int slot = s % STAGES;
    copies.issue(codes_s + slot * BKP * P::BN, ld, a.N);
    uint8_t* xs = x_s + slot * P::BM * P::XROW + x_dst;
    const __nv_bfloat16* src = ld.x + ld.kp0 + x_src;
#pragma unroll
    for (int q = 0; q < XQ; ++q)
      cp16(xs + q * XR * P::XROW, src + (size_t)q * XR * a.K,
           ld.live && m0 + xr0 + XR * q < a.M && xk8 < ld.rows);
    ld.next(a, KP, KPpad, s + 1 < nst);
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
  uint32_t sc[H][8];                                // bf16x2 {s, s} per column
  int rem[H], grp[H];                               // k-steps left, group row
#pragma unroll
  for (int h = 0; h < H; ++h) {
    rem[h] = grp[h] = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) sc[h][c] = 0u;
  }
  // half h's scales of group grp[h], this lane's 8 B columns
  auto load_scales = [&](const Cursor<BKP>& st, int h) {
    if (!col_ok) return;
    const float4* p = reinterpret_cast<const float4*>(
        st.scales + (size_t)grp[h] * a.N + ncol);
    const float4 u = fold<LUT>(__ldg(p)), v = fold<LUT>(__ldg(p + 1));
    const float f8[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(f8[c], f8[c]);
      sc[h][c] = *reinterpret_cast<const uint32_t*>(&b2);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nst) load(s + STAGES - 1);
    cp_commit();
    const Cursor<BKP> st = cu;
    cu.next(a, KP, KPpad, s + 1 < nst);
    if (!st.live) continue;
    const uint8_t* cs = codes_s + (s % STAGES) * BKP * P::BN;
    const uint32_t xs = smem_addr(x_s + (s % STAGES) * P::BM * P::XROW);
#pragma unroll
    for (int ks = 0; ks < BKP / 16; ++ks) {
      if (16 * ks >= st.rows) break;
      const int kp = st.kp0 + 16 * ks;
      if ((s == 0 && ks == 0) || kp == 0) {         // a slot's first k-step
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int kh = kp + h * KP;
          grp[h] = kh / a.G;
          rem[h] = (a.G - kh % a.G) / 16;
          load_scales(st, h);
        }
      }
      uint2 rows[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * ks + 2 * t + (q & 1) + 8 * (q >> 1);
        const int chunk = 4 * wn + (g >> 1);
        rows[q] = *reinterpret_cast<const uint2*>(
            cs + r * P::BN + 16 * (chunk ^ cswz<1>(r)) + 8 * (g & 1));
      }
      uint32_t f[H][8][2];
      if constexpr (LUT != 0)
        lut_frags<false>(rows, tab, f, f);
      else
        weight_frags<BITS, false>(rows, f);
#pragma unroll
      for (int h = 0; h < H; ++h) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          f[h][c][0] = bf16x2_mul(f[h][c][0], sc[h][c]);
          f[h][c][1] = bf16x2_mul(f[h][c][1], sc[h][c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = lane >> 3;
          const int r = 64 * wm + 16 * i + 8 * (q & 1) + (lane & 7);
          const int c = 4 * h + 2 * ks + (q >> 1);
          uint32_t af[4];
          ldsm_x4(af, xs + r * P::XROW + 16 * xswz<H>(r, c));
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mma(acc[i][n], af[0], af[1], af[2], af[3], f[h][n][0], f[h][n][1]);
        }
      }
      const bool slot_end = kp + 16 == KP;
#pragma unroll
      for (int h = 0; h < H; ++h)
        if (--rem[h] == 0) {
          rem[h] = a.G / 16;
          ++grp[h];
          if (!slot_end) load_scales(st, h);
        }
    }
  }
  cp_wait<0>();

  // lane (g, t) holds rows 16i + g + 8rh, columns 16t .. 16t+15 of the
  // warp's strip: n8-tile n's c (rh = c >> 1) is column 16t + 8(c & 1) + n
  const bool direct = j.parts == 1;
  void* dst = direct ? a.out : a.ws;
  const int dst_f32 = direct ? a.out_f32 : 1;
  const size_t base = (size_t)(j.zbase + j.part) * a.M * a.N;
  const int col = n0 + 64 * wn + 16 * t;
  if (col < a.N) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int m = m0 + 64 * wm + 16 * i + g + 8 * rh;
        if (m >= a.M) continue;
        const size_t row =
            direct ? out_row(a, j.slot, m) : base + (size_t)m * a.N;
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {
          float v[8];
#pragma unroll
          for (int n = 0; n < 8; ++n) v[n] = acc[i][n][2 * rh + cb];
          store8(dst, dst_f32, row + col + 8 * cb, v);
        }
      }
  }
  if (!direct) fix_up<P::BM, P::BN>(a, j, m0, n0, tid);
}


// ── aq tile: int8 activations x int8 (or int4) weights ─────────────────────
// W8A8 / W4A8 (the JAX kernel's _scaled_dots_aq): x arrives as int8 codes
// [M, K] with f32 scales [M, K/G] per (row, group) from act_quant_kernel,
// and each group's dot runs exactly in int32 on mma.m16n8k32.s8 before
// acc += float(dot) * sx[row, g] * s[g, col]. The decode tile's layout and
// ring, with the weight as A (16 output columns x 32 k) and x^T as B (8
// token rows), so no mma row pads M; a block owns 256 columns and BM = 8 NT
// token rows, and prefill M runs cdiv(M, 16) row blocks of the same tile.
// Lane (g, t) reads 8 code bytes (columns 8g .. 8g+7) of the 8 packed rows
// 8t .. 8t+7 of each k-step, standing in k slots 4t .. 4t+3 and 16+4t ..
// 16+4t+3, so its x^T fragment is one 8-byte load of those rows; a 4 x 4
// byte transpose (8 prmt) turns 4 rows of 4 columns into 4 columns of 4 k.
// An int4 nibble becomes the signed byte 16 (q - 8) by one lop3 (the high
// nibble) or a shift and a lop3 (the low), so its dot comes out times 16,
// which the scale step takes off exactly. Code row r's 16-byte chunk c sits
// at c ^ 2 ((r >> 3) & 3), so the lanes of a half-warp, four rows apart in
// t, read all 32 banks. A block's K partition covers whole groups of both
// halves (the host's plan), so every group's dot is whole before scaling.
template <int BITS_, int NT_>
struct DecodeAQ {
  static constexpr bool DECODE = false, AQ = true;
  static constexpr int BITS = BITS_, NT = NT_, LUT = 0;
  static constexpr int BKP = 64;                    // packed rows per stage
  static constexpr int HALVES = BITS == 4 ? 2 : 1;
  static constexpr int BM = 8 * NT, BN = 256;
  static constexpr int XP = HALVES * BKP + 32;      // x code row pitch (bytes)
  static constexpr int CODE_BYTES = STAGES * BKP * BN;
  static constexpr int SMEM = CODE_BYTES + STAGES * BM * XP;
  static constexpr int MIN_BLOCKS = 2;
};

// d += a (16x32 s8, row) * b (32x8 s8, col), exact in int32
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c[k] = byte k of r0 .. r3 (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// four int4 codes (nibble h of each byte) as signed bytes 16 (q - 8)
template <int H> __device__ __forceinline__ uint32_t nib_s8x16(uint32_t w) {
  return ((H == 0 ? w << 4 : w) & 0xF0F0F0F0u) ^ 0x80808080u;
}

template <int BITS, int NT>
__device__ void aq_tile(const Args& a, const Job& j, uint8_t* smem) {
  using D = DecodeAQ<BITS, NT>;
  constexpr int H = D::HALVES, BKP = D::BKP;
  constexpr float UNIT = BITS == 4 ? 1.f / 16.f : 1.f;   // int4 dots are x16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int KP = BITS == 4 ? a.K / 2 : a.K;
  const int KPpad = cdiv(KP, BKP) * BKP;
  const int KG = a.K / a.G;
  const int n0 = blockIdx.x * D::BN, m0 = blockIdx.y * D::BM;
  const int ncol = n0 + 64 * warp + 8 * g;          // this lane's 8 columns
  const bool col_ok = ncol < a.N;
  const int nst = cdiv(j.e1 - j.e0, BKP);
  uint8_t* codes_s = smem;
  uint8_t* x_s = smem + D::CODE_BYTES;

  Cursor<BKP> ld, cu;
  ld.start(a, j.e0, KP, KPpad);
  cu = ld;
  // codes: chunk cc of rows cr + 8 q (16 chunks a row, 8 rows a pass)
  const int cr = tid >> 4, ccol = tid & 15;
  const bool ccol_ok = n0 + 16 * ccol < a.N;
  // x codes: chunk xc (half xh) of token row xm
  constexpr int XCH = H * BKP / 16, XR = THREADS / XCH;
  constexpr int XQ = cdiv(D::BM * XCH, THREADS);
  const int xm = tid / XCH, xc = tid % XCH;
  const int xh = xc / (BKP / 16), xk16 = 16 * (xc % (BKP / 16));
  auto load = [&](int s) {
    const int slot = s % STAGES;
    uint8_t* cs = codes_s + slot * BKP * D::BN;
    const uint8_t* src = ld.codes + (size_t)ld.kp0 * a.N + n0 + 16 * ccol;
#pragma unroll
    for (int q = 0; q < BKP / 8; ++q) {
      const int r = cr + 8 * q;
      cp16(cs + r * D::BN + 16 * (ccol ^ (2 * (q & 3))), src + (size_t)r * a.N,
           ld.live && ccol_ok && r < ld.rows);
    }
    uint8_t* xs = x_s + slot * D::BM * D::XP + xm * D::XP + xh * BKP + xk16;
    const int8_t* xsrc =
        a.xq + (ld.xrow + m0 + xm) * a.K + xh * KP + ld.kp0 + xk16;
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      if (xm + XR * q >= D::BM) break;
      cp16(xs + q * XR * D::XP, xsrc + (size_t)q * XR * a.K,
           ld.live && m0 + xm + XR * q < a.M && xk16 < ld.rows);
    }
    ld.next(a, KP, KPpad, s + 1 < nst);
  };

  float acc[4][NT][4];
  int part[H][4][NT][4];
  float4 sc[H][2];
  float sxv[H][NT][2];
  int rem[H], grp[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    rem[h] = grp[h] = 0;
    sc[h][0] = sc[h][1] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sxv[h][n][0] = sxv[h][n][1] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[h][i][n][c] = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
  // half h's weight scales and this lane's token scales of group grp[h]
  auto load_scales = [&](const Cursor<BKP>& st, int h) {
    if (col_ok) {
      const float4* p = reinterpret_cast<const float4*>(
          st.scales + (size_t)grp[h] * a.N + ncol);
      sc[h][0] = __ldg(p);
      sc[h][1] = __ldg(p + 1);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int m = m0 + 8 * n + 2 * t + b;
        sxv[h][n][b] =
            m < a.M ? __ldg(a.sx + (st.xrow + m) * KG + grp[h]) : 0.f;
      }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nst) load(s + STAGES - 1);
    cp_commit();
    const Cursor<BKP> st = cu;
    cu.next(a, KP, KPpad, s + 1 < nst);
    if (!st.live) continue;
    const uint8_t* cs = codes_s + (s % STAGES) * BKP * D::BN;
    const uint8_t* xs = x_s + (s % STAGES) * D::BM * D::XP;
#pragma unroll
    for (int ks = 0; ks < BKP / 32; ++ks) {
      if (32 * ks >= st.rows) break;
      const int kp = st.kp0 + 32 * ks;
      if ((s == 0 && ks == 0) || kp == 0) {         // a slot's first k-step
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int kh = kp + h * KP;
          grp[h] = kh / a.G;
          rem[h] = (a.G - kh % a.G) / 32;
          load_scales(st, h);
        }
      }
      // this lane's 8 code rows (columns 8g .. 8g+7), transposed into
      // columns of 4 k: tr[v][r][c], v = 0 columns 8g .. 8g+3, 1 the next
      // four; r = 0 rows 8t .. 8t+3, 1 rows 8t+4 .. 8t+7
      uint2 rows[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = 32 * ks + 8 * t + q;
        rows[q] = *reinterpret_cast<const uint2*>(
            cs + r * D::BN + 16 * ((4 * warp + (g >> 1)) ^ (2 * t)) + 8 * (g & 1));
      }
      uint32_t tr[2][2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        transpose4(rows[4 * r].x, rows[4 * r + 1].x, rows[4 * r + 2].x,
                   rows[4 * r + 3].x, tr[0][r]);
        transpose4(rows[4 * r].y, rows[4 * r + 1].y, rows[4 * r + 2].y,
                   rows[4 * r + 3].y, tr[1][r]);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        uint2 bx[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          bx[n] = *reinterpret_cast<const uint2*>(
              xs + (8 * n + g) * D::XP + h * BKP + 32 * ks + 8 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // A tile i: rows g and g + 8 are columns 8g + 2i and 8g + 2i + 1
          const int v = i >> 1, c0 = 2 * (i & 1);
          uint32_t f[4] = {tr[v][0][c0], tr[v][0][c0 + 1], tr[v][1][c0],
                           tr[v][1][c0 + 1]};
          if (BITS == 4) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              f[q] = h == 0 ? nib_s8x16<0>(f[q]) : nib_s8x16<1>(f[q]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_s8(part[h][i][n], f[0], f[1], f[2], f[3], bx[n].x, bx[n].y);
        }
      }
      const bool slot_end = kp + 32 == KP;
      const bool last = slot_end ||
                        (s == nst - 1 && (ks == BKP / 32 - 1 || 32 * (ks + 1) >= st.rows));
#pragma unroll
      for (int h = 0; h < H; ++h) {
        --rem[h];
        if (rem[h] == 0 || last) {
          // column 8g + 2i + (c >> 1) of tile i, token 8n + 2t + (c & 1)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float s0 = i < 2 ? (i == 0 ? sc[h][0].x : sc[h][0].z)
                                   : (i == 2 ? sc[h][1].x : sc[h][1].z);
            const float s1 = i < 2 ? (i == 0 ? sc[h][0].y : sc[h][0].w)
                                   : (i == 2 ? sc[h][1].y : sc[h][1].w);
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float dot = float(part[h][i][n][c]) * UNIT;
                acc[i][n][c] += dot * sxv[h][n][c & 1] * (c < 2 ? s0 : s1);
                part[h][i][n][c] = 0;
              }
          }
        }
        if (rem[h] == 0) {
          rem[h] = a.G / 32;
          ++grp[h];
          if (!slot_end) load_scales(st, h);
        }
      }
    }
  }
  cp_wait<0>();

  const bool direct = j.parts == 1;
  void* dst = direct ? a.out : a.ws;
  const int dst_f32 = direct ? a.out_f32 : 1;
  const size_t base = (size_t)(j.zbase + j.part) * a.M * a.N;
  if (col_ok) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int m = m0 + 8 * n + 2 * t + b;
        if (m >= a.M) continue;
        float v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[2 * i] = acc[i][n][b];
          v[2 * i + 1] = acc[i][n][2 + b];
        }
        store8(dst, dst_f32,
               (direct ? out_row(a, j.slot, m) : base + (size_t)m * a.N) + ncol,
               v);
      }
  }
  if (!direct) fix_up<D::BM, D::BN>(a, j, m0, n0, tid);
}

// Shared by every kernel: zero what a hot list leaves cold, plan, run the
// tile. The aq tile's partitions hold whole K groups: on the device (a hot
// list) they are rounded to lcm(64, G) packed rows, as the host's plan is.
template <class Tile>
__device__ __forceinline__ void body(const Args& a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int active = active_slots(a);
  const int m0 = blockIdx.y * Tile::BM, n0 = blockIdx.x * Tile::BN;
  if (a.hot != nullptr) {
    const int z = blockIdx.z;
    if (!a.sum && z >= active && z < a.slots)
      zero_tile<Tile::BM, Tile::BN>(a, z, m0, n0, threadIdx.x);
    if (a.sum && active == 0 && z == 0)
      zero_tile<Tile::BM, Tile::BN>(a, 0, m0, n0, threadIdx.x);
  }
  const int KP = Tile::BITS == 4 ? a.K / 2 : a.K;
  int unit = Tile::BKP;
  if constexpr (Tile::AQ)
    while (unit % a.G) unit += Tile::BKP;
  Job j;
  if (!plan(a, cdiv(KP, Tile::BKP) * Tile::BKP, unit, active, j)) return;
  if constexpr (Tile::AQ)
    aq_tile<Tile::BITS, Tile::NT>(a, j, smem);
  else if constexpr (Tile::DECODE)
    decode_tile<Tile::BITS, Tile::NT, Tile::LUT>(a, j, smem);
  else
    prefill_tile<Tile::BITS, Tile::LUT>(a, j, smem);
}

template <class Tile>
__global__ void __launch_bounds__(THREADS, Tile::MIN_BLOCKS)
dequant_matmul_kernel(const Args a) {
  body<Tile>(a);
}

template <class Tile>
__global__ void __launch_bounds__(THREADS, Tile::MIN_BLOCKS)
dequant_matmul_moe_kernel(const Args a) {
  body<Tile>(a);
}

template <int BITS, int NT>
__global__ void __launch_bounds__(THREADS, DecodeAQ<BITS, NT>::MIN_BLOCKS)
dequant_matmul_aq_kernel(const Args a) {
  body<DecodeAQ<BITS, NT>>(a);
}

template <int BITS, int NT>
__global__ void __launch_bounds__(THREADS, DecodeAQ<BITS, NT>::MIN_BLOCKS)
dequant_matmul_aq_moe_kernel(const Args a) {
  body<DecodeAQ<BITS, NT>>(a);
}

template <class Tile>
int launch_one(const Args& a, bool moe, int gridz, cudaStream_t st) {
  auto* k = dequant_matmul_kernel<Tile>;
  if constexpr (Tile::LUT == 0)    // the MoE kernel runs linear codes only
    if (moe) k = dequant_matmul_moe_kernel<Tile>;
  // dynamic and static shared memory together above 48 KB only by opting in
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(a.N, Tile::BN), cdiv(a.M, Tile::BM), gridz);
  k<<<grid, THREADS, Tile::SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <int LUT>
int launch_lut(const Args& a, int bits, int tile, bool moe, int gridz,
               cudaStream_t st) {
  if (tile == 0) {
    if (a.M <= 8)
      return bits == 4 ? launch_one<Decode<4, 1, LUT>>(a, moe, gridz, st)
                       : launch_one<Decode<8, 1>>(a, moe, gridz, st);
    return bits == 4 ? launch_one<Decode<4, 2, LUT>>(a, moe, gridz, st)
                     : launch_one<Decode<8, 2>>(a, moe, gridz, st);
  }
  return bits == 4 ? launch_one<Prefill<4, LUT>>(a, moe, gridz, st)
                   : launch_one<Prefill<8>>(a, moe, gridz, st);
}

// tile: 0 decode (M <= 16), 1 prefill; lut_mode: 0 linear, 1 word4, 2 sel15
// (int4 codes; the wrapper passes a table only with them)
int launch(const Args& a, int bits, int tile, bool moe, int gridz,
           cudaStream_t st, int lut_mode = 0) {
  if (lut_mode == 1) return launch_lut<1>(a, bits, tile, moe, gridz, st);
  if (lut_mode == 2) return launch_lut<2>(a, bits, tile, moe, gridz, st);
  return launch_lut<0>(a, bits, tile, moe, gridz, st);
}

template <int BITS, int NT>
int launch_aq_tile(const Args& a, bool moe, int gridz, cudaStream_t st) {
  using D = DecodeAQ<BITS, NT>;
  auto* k = moe ? dequant_matmul_aq_moe_kernel<BITS, NT>
                : dequant_matmul_aq_kernel<BITS, NT>;
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(a.N, D::BN), cdiv(a.M, D::BM), gridz);
  k<<<grid, THREADS, D::SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

// rows: token rows a block, 8 (NT 1) or 16 (NT 2)
int launch_aq(const Args& a, int bits, int rows, bool moe, int gridz,
              cudaStream_t st) {
  if (rows == 8)
    return bits == 4 ? launch_aq_tile<4, 1>(a, moe, gridz, st)
                     : launch_aq_tile<8, 1>(a, moe, gridz, st);
  return bits == 4 ? launch_aq_tile<4, 2>(a, moe, gridz, st)
                   : launch_aq_tile<8, 2>(a, moe, gridz, st);
}

// x [M, K] (f32 or bf16) -> int8 codes [M, K] and f32 scales [M, K/G], one
// warp per (row, group): sx = absmax * fl(1/127) (1 where absmax is 0; the
// card's torch computes absmax / 127.0 so), codes rint(x / sx) by an IEEE
// division, as the plain version's tensor division. The replaced JAX kernel
// quantizes x inside _scaled_dots_aq; here one pass per call quantizes each
// value once, where each column block of the matmul would redo it, and a
// group's absmax needs all of it before its first code (the matmul stages
// 64 rows at a time).
template <typename T>
__global__ void act_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                                 float* __restrict__ sx, int M, int K, int G) {
  const int w = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31, groups = K / G;
  if (w >= M * groups) return;
  const int row = w / groups, grp = w - row * groups;
  const size_t off = (size_t)row * K + (size_t)grp * G;
  float amax = 0.f;
  for (int i = lane; i < G; i += 32) amax = fmaxf(amax, fabsf(to_f32(x[off + i])));
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  float s = amax * INV127;
  if (s == 0.f) s = 1.f;
  for (int i = lane; i < G; i += 32)
    xq[off + i] = (int8_t)rintf(__fdiv_rn(to_f32(x[off + i]), s));
  if (lane == 0) sx[(size_t)row * groups + grp] = s;
}

}  // namespace tc

// The tensor-core tiles (bf16 x). tile: 0 tc_decode (M <= 16), 1 tc_prefill.
// ws: f32 [splits, M, N] for the split-K partials (null when splits == 1);
// counters: int32 per output tile, zero, left zero; lut / lut_mode as for
// dequant_matmul_launch.
extern "C" int dequant_matmul_tc_launch(const void* x, const void* codes,
                                        const void* scales, void* out,
                                        int out_f32, void* ws, void* counters,
                                        int M, int K, int N, int G, int bits,
                                        int tile, int splits, int per,
                                        const void* lut, int lut_mode,
                                        void* stream) {
  tc::Args a{};
  a.x = reinterpret_cast<const __nv_bfloat16*>(x);
  a.codes = reinterpret_cast<const uint8_t*>(codes);
  a.scales = reinterpret_cast<const float*>(scales);
  a.out = out;
  a.ws = reinterpret_cast<float*>(ws);
  a.counters = reinterpret_cast<int*>(counters);
  a.out_f32 = out_f32;
  a.M = M, a.K = K, a.N = N, a.G = G;
  a.experts = 1, a.slots = 1;
  a.splits = splits, a.per = per, a.cap = splits;
  a.lut = reinterpret_cast<const float*>(lut);
  return tc::launch(a, bits, tile, false, splits,
                    reinterpret_cast<cudaStream_t>(stream), lut_mode);
}

// W8A8 / W4A8: xq int8 [M, K] and sx f32 [M, K/G] from act_quant_launch;
// rows: token rows a block (8 or 16); K / 2 (int4) or K and G multiples of
// 32, N of 16; ws / counters as for dequant_matmul_tc_launch, each
// partition of `per` packed rows covering whole groups of both halves.
extern "C" int dequant_matmul_aq_launch(const void* xq, const void* sx,
                                        const void* codes, const void* scales,
                                        void* out, int out_f32, void* ws,
                                        void* counters, int M, int K, int N,
                                        int G, int bits, int rows, int splits,
                                        int per, void* stream) {
  tc::Args a{};
  a.xq = reinterpret_cast<const int8_t*>(xq);
  a.sx = reinterpret_cast<const float*>(sx);
  a.codes = reinterpret_cast<const uint8_t*>(codes);
  a.scales = reinterpret_cast<const float*>(scales);
  a.out = out;
  a.ws = reinterpret_cast<float*>(ws);
  a.counters = reinterpret_cast<int*>(counters);
  a.out_f32 = out_f32;
  a.M = M, a.K = K, a.N = N, a.G = G;
  a.experts = 1, a.slots = 1;
  a.splits = splits, a.per = per, a.cap = splits;
  return tc::launch_aq(a, bits, rows, false, splits,
                       reinterpret_cast<cudaStream_t>(stream));
}

// x [M, K] (bf16 when x_bf16, else f32) -> xq int8 [M, K], sx f32 [M, K/G];
// G a multiple of 32 dividing K.
extern "C" int act_quant_launch(const void* x, int x_bf16, void* xq, void* sx,
                                int M, int K, int G, void* stream) {
  const long long warps = (long long)M * (K / G);
  const int blocks = (int)((warps * 32 + 255) / 256);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16)
    tc::act_quant_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<int8_t*>(xq),
        reinterpret_cast<float*>(sx), M, K, G);
  else
    tc::act_quant_kernel<float><<<blocks, 256, 0, st>>>(
        reinterpret_cast<const float*>(x), reinterpret_cast<int8_t*>(xq),
        reinterpret_cast<float*>(sx), M, K, G);
  return (int)cudaGetLastError();
}

// The MoE launches' slot arguments. mode: 0 concat (x [M, K]), 1 sum (x
// [slots, M, K] -> y [M, N]), 2 grouped (x [slots, M, K] -> y [slots, M,
// N]); codes / scales: the whole expert-major stack; hot: device int32
// [1 + slots] or null.
static void moe_args(tc::Args& a, int K, int N, int G, int bits, int slots,
                     int mode, int layer, int stride, int experts,
                     const void* hot) {
  const long long kp = bits == 4 ? K / 2 : K;
  a.hot = reinterpret_cast<const int*>(hot);
  a.codes_stride = kp * N;
  a.scales_stride = (long long)(K / G) * N;
  a.layer = layer, a.stride = stride, a.experts = experts;
  a.slots = slots, a.sum = mode == 1, a.grouped = mode == 2;
}

// x: [M, K] (concat) or [slots, M, K] (sum, grouped); mode, the stack and
// hot as moe_args. The grid has slots * splits z blocks (concat, grouped)
// or splits (sum); cap: the most of them one slot takes under a hot list
// (concat, grouped). ws: f32 [z blocks, M, N] when a tile can have more
// than one partition, else null; counters: one per (slot, output tile).
extern "C" int dequant_matmul_moe_tc_launch(
    const void* x, const void* codes, const void* scales, void* out,
    int out_f32, void* ws, void* counters, int M, int K, int N, int G,
    int bits, int tile, int splits, int per, int cap, int slots, int mode,
    int layer, int stride, int experts, const void* hot, void* stream) {
  tc::Args a{};
  a.x = reinterpret_cast<const __nv_bfloat16*>(x);
  a.codes = reinterpret_cast<const uint8_t*>(codes);
  a.scales = reinterpret_cast<const float*>(scales);
  a.out = out;
  a.ws = reinterpret_cast<float*>(ws);
  a.counters = reinterpret_cast<int*>(counters);
  a.out_f32 = out_f32;
  a.M = M, a.K = K, a.N = N, a.G = G;
  moe_args(a, K, N, G, bits, slots, mode, layer, stride, experts, hot);
  a.splits = splits, a.per = per, a.cap = cap;
  return tc::launch(a, bits, tile, true, a.sum ? splits : slots * splits,
                    reinterpret_cast<cudaStream_t>(stream));
}

// W8A8 / W4A8 over the expert stack: xq int8 and sx f32 from
// act_quant_launch over x's rows ([M, K] concat, [slots * M, K] sum and
// grouped); rows, splits, per as for dequant_matmul_aq_launch (each
// partition whole K groups; in sum mode the slots' rows end to end); cap,
// slots, mode, the stack, hot, ws and counters as for
// dequant_matmul_moe_tc_launch.
extern "C" int dequant_matmul_aq_moe_launch(
    const void* xq, const void* sx, const void* codes, const void* scales,
    void* out, int out_f32, void* ws, void* counters, int M, int K, int N,
    int G, int bits, int rows, int splits, int per, int cap, int slots,
    int mode, int layer, int stride, int experts, const void* hot,
    void* stream) {
  tc::Args a{};
  a.xq = reinterpret_cast<const int8_t*>(xq);
  a.sx = reinterpret_cast<const float*>(sx);
  a.codes = reinterpret_cast<const uint8_t*>(codes);
  a.scales = reinterpret_cast<const float*>(scales);
  a.out = out;
  a.ws = reinterpret_cast<float*>(ws);
  a.counters = reinterpret_cast<int*>(counters);
  a.out_f32 = out_f32;
  a.M = M, a.K = K, a.N = N, a.G = G;
  moe_args(a, K, N, G, bits, slots, mode, layer, stride, experts, hot);
  a.splits = splits, a.per = per, a.cap = cap;
  return tc::launch_aq(a, bits, rows, true, a.sum ? splits : slots * splits,
                       reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
