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
// dtype, M and the shape, and counts each launch under the tile's name.
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
// * cuda_core, f32 x, or a bf16 shape the tensor-core tiles do not take
//   (K/2, K or G not a multiple of 16, N not a multiple of 16, x or the
//   codes not 16-byte aligned) (cc::dmm_tile). f32 weights and activations
//   on the CUDA cores: the f32 checks hold it to 1e-4 of the plain version,
//   which bf16 products cannot meet. A block owns 256 columns (64 threads x
//   4 adjacent columns) and BM = TM * TY rows of x staged in shared memory as
//   f32; the weight is dequantized in registers and rounded to the
//   activation type like the plain version; split-K partials meet by
//   atomicAdd in a cleared f32 buffer, which a second kernel casts to bf16.
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
// * hot: each block reads n_hot and its slot's expert id on the device (no
//   host sync, no grid sized per step), and the grid's z blocks are shared
//   out among the n_hot active slots only, so the whole grid streams the hot
//   experts' bytes and a slot at or past n_hot streams nothing: its concat
//   columns are exact zeros, and in sum mode it adds nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ── CUDA-core tile (f32 x) ─────────────────────────────────────────────────
namespace cc {


constexpr int TX = 64;        // threads along N
constexpr int COLS = 4;       // adjacent columns per thread
constexpr int BN = TX * COLS; // columns per block
constexpr int BKP = 64;       // packed rows staged per tile
constexpr int U = 16;         // packed rows whose code words load together

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The plain version dequantizes the weight to the activation type before the
// product; do the same so both round alike.
template <typename T> __device__ __forceinline__ float round_w(float w);
template <> __device__ __forceinline__ float round_w<float>(float w) { return w; }
template <> __device__ __forceinline__ float round_w<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// One block's tile: rows [blockIdx.y * BM, + BM) of x against the 256 columns
// of blockIdx.x of one weight, over packed rows [kp_begin, kp_end). Output
// element (row, n) lands at row * ldo + col0 + n of `out` (or of `partial`,
// by atomicAdd, when `atomic`).
template <typename T, int BITS, int TM, int TY, int KS>
__device__ __forceinline__ void dmm_tile(
    const T* __restrict__ x, const uint8_t* __restrict__ codes,
    const float* __restrict__ scales, void* __restrict__ out, int out_f32,
    float* __restrict__ partial, bool atomic, size_t ldo, size_t col0, int M,
    int K, int N, int G, int kp_begin, int kp_end) {
  constexpr int BM = TM * TY;
  constexpr int HALVES = BITS == 4 ? 2 : 1;
  constexpr int NT = TX * TY * KS;
  constexpr int BMP = BM + 1;  // padded row: conflict-free staging stores
  __shared__ float xs[HALVES][BKP][BMP];
  __shared__ float red[KS > 1 ? KS - 1 : 1][KS > 1 ? BM : 1][KS > 1 ? BN : 1];

  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int tid = tx + TX * (ty + TY * tz);
  const int n0 = (blockIdx.x * TX + tx) * COLS;
  const int mb = blockIdx.y * BM;
  const int KP = BITS == 4 ? K / 2 : K;          // packed code rows
  const bool col_ok = n0 < N;

  float acc[TM][COLS];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  int g_lo = -1, g_hi = -1;
  float4 s_lo = make_float4(0.f, 0.f, 0.f, 0.f), s_hi = s_lo;

  for (int t0 = kp_begin; t0 < kp_end; t0 += BKP) {
    const int rows = min(BKP, kp_end - t0);
    __syncthreads();
    for (int idx = tid; idx < HALVES * BKP * BM; idx += NT) {
      const int r = idx % BKP;
      const int m = (idx / BKP) % BM;
      const int h = idx / (BKP * BM);
      float v = 0.f;
      if (r < rows && mb + m < M)
        v = to_f32(x[(size_t)(mb + m) * K + (size_t)h * KP + t0 + r]);
      xs[h][r][m] = v;
    }
    __syncthreads();
    if (!col_ok) continue;
    // slice tz takes runs of U rows, KS * U apart; the U code words of a run
    // are loaded before any is used, so U loads per thread are in flight
    for (int r0 = tz * U; r0 < rows; r0 += KS * U) {
      uint32_t words[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        words[u] = r0 + u < rows ? *reinterpret_cast<const uint32_t*>(
                                       codes + (size_t)(t0 + r0 + u) * N + n0)
                                 : 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u;
        if (r >= rows) break;
        const int kp = t0 + r;
        const uint32_t word = words[u];
        const int gl = kp / G;
        if (gl != g_lo) {
          g_lo = gl;
          s_lo = *reinterpret_cast<const float4*>(scales + (size_t)gl * N + n0);
        }
        float w_lo[COLS], w_hi[COLS];
        if (BITS == 4) {
          const int gh = (kp + KP) / G;
          if (gh != g_hi) {
            g_hi = gh;
            s_hi = *reinterpret_cast<const float4*>(scales + (size_t)gh * N + n0);
          }
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int b = (word >> (8 * c)) & 0xFF;
            w_lo[c] = round_w<T>(float((b & 0xF) - 8) * lane4(s_lo, c));
            w_hi[c] = round_w<T>(float((b >> 4) - 8) * lane4(s_hi, c));
          }
        } else {
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int8_t q = (int8_t)((word >> (8 * c)) & 0xFF);
            w_lo[c] = round_w<T>(float(q) * lane4(s_lo, c));
            w_hi[c] = 0.f;
          }
        }
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float a = xs[0][r][ty * TM + m];
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[m][c] = fmaf(a, w_lo[c], acc[m][c]);
          if (BITS == 4) {
            const float a2 = xs[HALVES - 1][r][ty * TM + m];
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[m][c] = fmaf(a2, w_hi[c], acc[m][c]);
          }
        }
      }
    }
  }

  if (KS > 1) {  // sum the in-block K slices
    __syncthreads();
    if (tz > 0) {
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          red[tz - 1][ty * TM + m][tx * COLS + c] = acc[m][c];
    }
    __syncthreads();
    if (tz > 0) return;
#pragma unroll
    for (int z = 0; z < KS - 1; ++z)
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[m][c] += red[z][ty * TM + m][tx * COLS + c];
  }
  if (!col_ok) return;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int row = mb + ty * TM + m;
    if (row >= M) break;
    const size_t o = (size_t)row * ldo + col0 + n0;
    if (atomic) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) atomicAdd(partial + o + c, acc[m][c]);
    } else if (out_f32) {
      float* y = reinterpret_cast<float*>(out) + o;
#pragma unroll
      for (int c = 0; c < COLS; ++c) y[c] = acc[m][c];
    } else {
      __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(out) + o;
#pragma unroll
      for (int c = 0; c < COLS; ++c) y[c] = __float2bfloat16_rn(acc[m][c]);
    }
  }
}

template <typename T, int BITS, int TM, int TY, int KS>
__global__ void __launch_bounds__(TX * TY * KS)
dequant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                      const float* __restrict__ scales, void* __restrict__ out,
                      int out_f32, float* __restrict__ partial, int M, int K,
                      int N, int G, int kp_per_split) {
  const int KP = BITS == 4 ? K / 2 : K;
  const int kp_begin = blockIdx.z * kp_per_split;
  dmm_tile<T, BITS, TM, TY, KS>(x, codes, scales, out, out_f32, partial,
                                gridDim.z > 1, N, 0, M, K, N, G, kp_begin,
                                min(KP, kp_begin + kp_per_split));
}

struct MoeArgs {
  const int* hot;           // [1 + slots]: n_hot, then expert ids; null: slot j is expert j
  long long codes_stride;   // bytes between stack entries (K/2 or K) * N
  long long scales_stride;  // floats between stack entries (K / G) * N
  int layer, stride;        // stack entry of expert e: e * stride + layer
  int experts;              // experts in the stack (ids outside stream nothing)
  int slots;                // expert slots (columns of y in concat)
  int sum;                  // 1: x [slots, M, K] -> y [M, N]; 0: concat
};

// With a hot list the output is always the cleared atomic buffer (`atomic`):
// the cold slots get no block at all.
template <typename T, int BITS, int TM, int TY, int KS>
__global__ void __launch_bounds__(TX * TY * KS)
dequant_matmul_moe_kernel(const T* __restrict__ x,
                          const uint8_t* __restrict__ codes,
                          const float* __restrict__ scales, void* __restrict__ out,
                          int out_f32, float* __restrict__ partial, int atomic,
                          int M, int K, int N, int G, MoeArgs a) {
  const int KP = BITS == 4 ? K / 2 : K;
  // read on the device: no host sync per layer
  const int active =
      a.hot == nullptr ? a.slots : min(max(a.hot[0], 0), a.slots);
  if (active == 0) return;
  // the z blocks shared out among the active slots, at least one staged tile
  // of K per partition; without a hot list this is the host's split
  const int per_slot = min((int)gridDim.z / active, (KP + BKP - 1) / BKP);
  const int slot = blockIdx.z / per_slot;
  const int split = blockIdx.z - slot * per_slot;
  const int kp_per = ((KP + per_slot - 1) / per_slot + BKP - 1) / BKP * BKP;
  const int kp_begin = split * kp_per;
  if (slot >= active || kp_begin >= KP) return;
  const int e = a.hot == nullptr ? slot : a.hot[1 + slot];
  if (e < 0 || e >= a.experts) return;
  const size_t w = (size_t)e * a.stride + a.layer;
  dmm_tile<T, BITS, TM, TY, KS>(
      x + (a.sum ? (size_t)slot * M * K : 0), codes + w * a.codes_stride,
      scales + w * a.scales_stride, out, out_f32, partial, atomic != 0,
      a.sum ? (size_t)N : (size_t)a.slots * N, a.sum ? 0 : (size_t)slot * N,
      M, K, N, G, kp_begin, min(KP, kp_begin + kp_per));
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

// One call's operands; acc is the f32 [M, ldo] buffer the partials meet in
// (null: direct stores).
struct Call {
  const void* x;
  const void* codes;
  const float* scales;
  void* out;
  int out_f32;
  float* acc;
  int M, K, N, G, splits, kp_per_split;
};

template <typename T, int BITS, int TM, int TY, int KS>
void launch(const Call& c, const MoeArgs* moe, cudaStream_t st) {
  constexpr int BM = TM * TY;
  const int slots = moe ? moe->slots : 1;
  dim3 grid((c.N + BN - 1) / BN, (c.M + BM - 1) / BM, c.splits * slots);
  dim3 block(TX, TY, KS);
  const T* x = reinterpret_cast<const T*>(c.x);
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(c.codes);
  if (moe)
    dequant_matmul_moe_kernel<T, BITS, TM, TY, KS><<<grid, block, 0, st>>>(
        x, codes, c.scales, c.out, c.out_f32, c.acc, c.acc != nullptr, c.M,
        c.K, c.N, c.G, *moe);
  else
    dequant_matmul_kernel<T, BITS, TM, TY, KS><<<grid, block, 0, st>>>(
        x, codes, c.scales, c.out, c.out_f32, c.acc, c.M, c.K, c.N, c.G,
        c.kp_per_split);
}

template <typename T, int BITS>
void dispatch(const Call& c, const MoeArgs* moe, cudaStream_t st) {
  // decode M: one row tile, K split over 4 slices per block; prefill M:
  // 64-row tiles of 8 x 8 rows
  if (c.M <= 1)
    launch<T, BITS, 1, 1, 4>(c, moe, st);
  else if (c.M <= 2)
    launch<T, BITS, 2, 1, 4>(c, moe, st);
  else if (c.M <= 4)
    launch<T, BITS, 4, 1, 4>(c, moe, st);
  else if (c.M <= 8)
    launch<T, BITS, 8, 1, 4>(c, moe, st);
  else
    launch<T, BITS, 8, 8, 1>(c, moe, st);
}

// Clears the f32 buffer the partials meet in (when they do), launches, and
// casts that buffer to bf16 when the output is bf16. `atomic`: the partials
// of split-K or of summed slots add up by atomicAdd; the buffer is `out`
// itself for f32 output, else `partial`.
int run(Call c, int x_bf16, int bits, const MoeArgs* moe, bool atomic,
        size_t ldo, void* partial, cudaStream_t st) {
  const size_t n = (size_t)c.M * ldo;
  if (atomic) {
    c.acc = c.out_f32 ? reinterpret_cast<float*>(c.out)
                      : reinterpret_cast<float*>(partial);
    const cudaError_t err = cudaMemsetAsync(c.acc, 0, n * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (x_bf16) {
    if (bits == 4)
      dispatch<__nv_bfloat16, 4>(c, moe, st);
    else
      dispatch<__nv_bfloat16, 8>(c, moe, st);
  } else {
    if (bits == 4)
      dispatch<float, 4>(c, moe, st);
    else
      dispatch<float, 8>(c, moe, st);
  }
  if (atomic && !c.out_f32) {
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    f32_to_bf16_kernel<<<blocks, 256, 0, st>>>(
        c.acc, reinterpret_cast<__nv_bfloat16*>(c.out), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace cc

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

// Code rows in shared memory: 16-byte chunk c of row r lives at chunk
// c ^ cswz<S>(r), so the four rows a warp reads at once (rows 4t + q at
// decode, S = 2; rows 2t + q at prefill, S = 1; t = 0..3) fall in both
// halves of the banks.
template <int S> __device__ __forceinline__ int cswz(int r) {
  return ((r >> S) & 1) << 2;
}

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* codes;
  const float* scales;
  void* out;
  float* ws;            // [grid z, M, N] f32 partials (null: one partition)
  int* counters;        // per output tile, zero between launches
  const int* hot;       // [1 + slots]: n_hot, then expert ids; null: all
  long long codes_stride, scales_stride;  // per stack entry (bytes, floats)
  int out_f32, M, K, N, G;
  int layer, stride, experts, slots, sum;
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
  int rank, kp0, rows;  // the stage holds packed rows [kp0, kp0 + rows)
  bool live;            // false: the slot's expert id is outside the stack

  __device__ __forceinline__ void point(const Args& a) {
    const int ex = a.hot ? __ldg(a.hot + 1 + rank) : rank;
    live = ex >= 0 && ex < a.experts;
    const size_t w = live ? (size_t)ex * a.stride + a.layer : 0;
    codes = a.codes + w * a.codes_stride;
    scales = a.scales + w * a.scales_stride;
    x = a.x + (a.sum ? (size_t)rank * a.M * a.K : 0);
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

// Output tile [m0, m0 + BM) x [n0, n0 + BN) of slot `slot`'s columns: exact
// zeros (a cold slot under a hot list, or a sum over no slot).
template <int BM, int BN>
__device__ void zero_tile(const Args& a, int slot, int m0, int n0, int tid) {
  const size_t ldo = a.sum ? (size_t)a.N : (size_t)a.slots * a.N;
  for (int i = tid; i < BM * BN / 4; i += THREADS) {
    const int m = m0 + i / (BN / 4), n = n0 + 4 * (i % (BN / 4));
    if (m < a.M && n < a.N)
      store4(a.out, a.out_f32, m * ldo + (size_t)slot * a.N + n,
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
  const size_t ldo = a.sum ? (size_t)a.N : (size_t)a.slots * a.N;
  const size_t col0 = (size_t)j.slot * a.N;
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
      dst[k] = m * ldo + col0 + n;
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
template <int BITS_, int NT_>
struct Decode {
  static constexpr bool DECODE = true;
  static constexpr int BITS = BITS_, NT = NT_;
  static constexpr int BKP = 64;                    // packed rows per stage
  static constexpr int HALVES = BITS == 4 ? 2 : 1;
  static constexpr int BM = 8 * NT;                 // token rows
  static constexpr int BN = 256;                    // 4 warps x 64 columns
  static constexpr int XP = HALVES * BKP + 16;      // x row pitch (bf16): a
                                                    // half-warp's 8-byte B
                                                    // loads hit 32 banks
  static constexpr int CODE_BYTES = STAGES * BKP * BN;
  static constexpr int SMEM = CODE_BYTES + STAGES * BM * XP * 2;
  static constexpr int MIN_BLOCKS = NT == 1 ? 3 : 2;  // per SM: registers
};

template <int BITS, int NT>
__device__ void decode_tile(const Args& a, const Job& j, uint8_t* smem) {
  using D = Decode<BITS, NT>;
  constexpr int H = D::HALVES, BKP = D::BKP;
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
            sc[h][0] = __ldg(p);
            sc[h][1] = __ldg(p + 1);
          }
        }
      }
      uint32_t f[H][8][2];
      weight_frags<BITS, BITS == 4>(rows[kk], f);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint2 b = bx[kk][h][n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma(part[h][i][n], f[h][2 * i][0], f[h][2 * i + 1][0],
                f[h][2 * i][1], f[h][2 * i + 1][1], b.x, b.y);
          if (BITS == 4) mma(xsum[h][n], ONES, ONES, ONES, ONES, b.x, b.y);
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
              u[n][c] = BITS == 4 ? -136.f * xsum[h][n][c] : 0.f;
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
            sc[h][0] = __ldg(p);
            sc[h][1] = __ldg(p + 1);
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
  const size_t ldo = !direct ? (size_t)a.N : a.sum ? (size_t)a.N : (size_t)a.slots * a.N;
  const size_t base = direct ? (size_t)j.slot * a.N
                             : (size_t)(j.zbase + j.part) * a.M * a.N;
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
        store8(dst, dst_f32, base + m * ldo + ncol, v);
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
template <int BITS_>
struct Prefill {
  static constexpr bool DECODE = false;
  static constexpr int BITS = BITS_;
  static constexpr int BKP = 32;                    // packed rows per stage
  static constexpr int HALVES = BITS == 4 ? 2 : 1;
  static constexpr int BM = 128, BN = 128;
  static constexpr int XROW = HALVES * BKP * 2;     // bytes per staged x row
  static constexpr int CODE_BYTES = STAGES * BKP * BN;
  static constexpr int SMEM = CODE_BYTES + STAGES * BM * XROW;
  static constexpr int MIN_BLOCKS = 1;
};

// 16-byte chunk c of staged x row r: int4 rows are 8 chunks (c ^ (r & 7)),
// int8 rows 4 chunks (c ^ ((r >> 1) & 3)); either way the 8 rows an
// ldmatrix reads hit all 32 banks.
template <int HALVES>
__device__ __forceinline__ int xswz(int r, int c) {
  return HALVES == 2 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

template <int BITS>
__device__ void prefill_tile(const Args& a, const Job& j, uint8_t* smem) {
  using P = Prefill<BITS>;
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
    const float4 u = __ldg(p), v = __ldg(p + 1);
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
  const size_t ldo = !direct ? (size_t)a.N : a.sum ? (size_t)a.N : (size_t)a.slots * a.N;
  const size_t base = direct ? (size_t)j.slot * a.N
                             : (size_t)(j.zbase + j.part) * a.M * a.N;
  const int col = n0 + 64 * wn + 16 * t;
  if (col < a.N) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int m = m0 + 64 * wm + 16 * i + g + 8 * rh;
        if (m >= a.M) continue;
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {
          float v[8];
#pragma unroll
          for (int n = 0; n < 8; ++n) v[n] = acc[i][n][2 * rh + cb];
          store8(dst, dst_f32, base + m * ldo + col + 8 * cb, v);
        }
      }
  }
  if (!direct) fix_up<P::BM, P::BN>(a, j, m0, n0, tid);
}

// Shared by both kernels: zero what a hot list leaves cold, plan, run the
// tile.
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
  Job j;
  if (!plan(a, cdiv(KP, Tile::BKP) * Tile::BKP, Tile::BKP, active, j)) return;
  if constexpr (Tile::DECODE)
    decode_tile<Tile::BITS, Tile::NT>(a, j, smem);
  else
    prefill_tile<Tile::BITS>(a, j, smem);
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

template <class Tile>
int launch_one(const Args& a, bool moe, int gridz, cudaStream_t st) {
  auto* k = moe ? dequant_matmul_moe_kernel<Tile> : dequant_matmul_kernel<Tile>;
  // dynamic and static shared memory together above 48 KB only by opting in
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(a.N, Tile::BN), cdiv(a.M, Tile::BM), gridz);
  k<<<grid, THREADS, Tile::SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

// tile: 0 decode (M <= 16), 1 prefill
int launch(const Args& a, int bits, int tile, bool moe, int gridz,
           cudaStream_t st) {
  if (tile == 0) {
    if (a.M <= 8)
      return bits == 4 ? launch_one<Decode<4, 1>>(a, moe, gridz, st)
                       : launch_one<Decode<8, 1>>(a, moe, gridz, st);
    return bits == 4 ? launch_one<Decode<4, 2>>(a, moe, gridz, st)
                     : launch_one<Decode<8, 2>>(a, moe, gridz, st);
  }
  return bits == 4 ? launch_one<Prefill<4>>(a, moe, gridz, st)
                   : launch_one<Prefill<8>>(a, moe, gridz, st);
}

}  // namespace tc

extern "C" int dequant_matmul_launch(const void* x, int x_bf16, const void* codes,
                                     const void* scales, void* out, int out_f32,
                                     void* partial, int M, int K, int N, int G,
                                     int bits, int splits, int kp_per_split,
                                     void* stream) {
  const cc::Call c{x, codes, reinterpret_cast<const float*>(scales), out, out_f32,
               nullptr, M, K, N, G, splits, kp_per_split};
  return cc::run(c, x_bf16, bits, nullptr, splits > 1, N, partial,
             reinterpret_cast<cudaStream_t>(stream));
}

// x: [M, K] (concat) or [slots, M, K] (sum); codes / scales: the whole
// expert-major stack; hot: device int32 [1 + slots] or null; the grid has
// slots * splits blocks in z. `atomic`: the partials meet by atomicAdd in a
// cleared f32 buffer (`out` itself for f32 output, else `partial`); the
// caller sets it when K is split, slots are summed or a hot list is given.
extern "C" int dequant_matmul_moe_launch(
    const void* x, int x_bf16, const void* codes, const void* scales, void* out,
    int out_f32, void* partial, int atomic, int M, int K, int N, int G,
    int bits, int splits, int slots, int sum, int layer, int stride,
    int experts, const void* hot, void* stream) {
  const long long kp = bits == 4 ? K / 2 : K;
  cc::MoeArgs a{reinterpret_cast<const int*>(hot), kp * N, (long long)(K / G) * N,
            layer, stride, experts, slots, sum};
  const cc::Call c{x, codes, reinterpret_cast<const float*>(scales), out, out_f32,
               nullptr, M, K, N, G, splits, 0};
  return cc::run(c, x_bf16, bits, &a, atomic != 0,
             sum ? (size_t)N : (size_t)slots * N, partial,
             reinterpret_cast<cudaStream_t>(stream));
}

// The tensor-core tiles (bf16 x). tile: 0 tc_decode (M <= 16), 1 tc_prefill.
// ws: f32 [splits, M, N] for the split-K partials (null when splits == 1);
// counters: int32 per output tile, zero, left zero.
extern "C" int dequant_matmul_tc_launch(const void* x, const void* codes,
                                        const void* scales, void* out,
                                        int out_f32, void* ws, void* counters,
                                        int M, int K, int N, int G, int bits,
                                        int tile, int splits, int per,
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
  return tc::launch(a, bits, tile, false, splits,
                    reinterpret_cast<cudaStream_t>(stream));
}

// x: [M, K] (concat) or [slots, M, K] (sum); codes / scales: the whole
// expert-major stack; hot: device int32 [1 + slots] or null. The grid has
// slots * splits z blocks (concat) or splits (sum); cap: the most of them
// one concat slot takes under a hot list. ws: f32 [z blocks, M, N] when a
// tile can have more than one partition, else null.
extern "C" int dequant_matmul_moe_tc_launch(
    const void* x, const void* codes, const void* scales, void* out,
    int out_f32, void* ws, void* counters, int M, int K, int N, int G,
    int bits, int tile, int splits, int per, int cap, int slots, int sum,
    int layer, int stride, int experts, const void* hot, void* stream) {
  const long long kp = bits == 4 ? K / 2 : K;
  tc::Args a{};
  a.x = reinterpret_cast<const __nv_bfloat16*>(x);
  a.codes = reinterpret_cast<const uint8_t*>(codes);
  a.scales = reinterpret_cast<const float*>(scales);
  a.out = out;
  a.ws = reinterpret_cast<float*>(ws);
  a.counters = reinterpret_cast<int*>(counters);
  a.hot = reinterpret_cast<const int*>(hot);
  a.codes_stride = kp * N;
  a.scales_stride = (long long)(K / G) * N;
  a.out_f32 = out_f32;
  a.M = M, a.K = K, a.N = N, a.G = G;
  a.layer = layer, a.stride = stride, a.experts = experts;
  a.slots = slots, a.sum = sum;
  a.splits = splits, a.per = per, a.cap = cap;
  return tc::launch(a, bits, tile, true, sum ? splits : slots * splits,
                    reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
