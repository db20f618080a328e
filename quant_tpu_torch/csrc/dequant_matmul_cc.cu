// Fused dequantize + matmul for Hopper (sm_90a), the CUDA-core tile:
// y[M, N] = x[M, K] @ dequant(W) and its mixture-of-experts form, for f32 x
// and the bf16 shapes the tensor-core tiles of csrc/dequant_matmul.cu do
// not take. A source of its own so the two build side by side.
//
// Replaces: quant_tpu/kernels/dequant_matmul.py, dequant_matmul ->
//   _dequant_matmul_2d -> _kernel_int4 / _kernel_int8 (the Pallas TPU kernel),
//   with its codebook (lut) variants, and dequant_matmul_moe. The layout
//   contract (split-K int4, f32 group scales, stacked views, expert-major
//   stacks with 64-bit offsets) is dequant_matmul.cu's header note.
//
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

}  // namespace cc

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

namespace cc {

// One block's tile: rows [blockIdx.y * BM, + BM) of x against the 256 columns
// of blockIdx.x of one weight, over packed rows [kp_begin, kp_end). Output
// element (row, n) lands at row * ldo + col0 + n of `out` (or of `partial`,
// by atomicAdd, when `atomic`).
// LUT: 0 linear codes; a codebook weight's table lut[16] (the nibble is the
// index), 1 word4 (round(lut * 127), the scales times fl(1/127)), 2 sel15
// (the float32 table). The weight is value * scale in f32, rounded to the
// activation type, as the plain version computes it.
template <typename T, int BITS, int TM, int TY, int KS, int LUT>
__device__ __forceinline__ void dmm_tile(
    const T* __restrict__ x, const uint8_t* __restrict__ codes,
    const float* __restrict__ scales, void* __restrict__ out, int out_f32,
    float* __restrict__ partial, bool atomic, size_t ldo, size_t col0, int M,
    int K, int N, int G, int kp_begin, int kp_end,
    const float* __restrict__ lut) {
  constexpr int BM = TM * TY;
  constexpr int HALVES = BITS == 4 ? 2 : 1;
  constexpr int NT = TX * TY * KS;
  constexpr int BMP = BM + 1;  // padded row: conflict-free staging stores
  __shared__ float xs[HALVES][BKP][BMP];
  __shared__ float red[KS > 1 ? KS - 1 : 1][KS > 1 ? BM : 1][KS > 1 ? BN : 1];
  __shared__ float tab[LUT ? 16 : 1];

  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int tid = tx + TX * (ty + TY * tz);
  // the table, read after the first staging barrier
  if (LUT && tid < 16) tab[tid] = LUT == 1 ? rintf(lut[tid] * 127.f) : lut[tid];
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
          s_lo = fold<LUT>(*reinterpret_cast<const float4*>(scales + (size_t)gl * N + n0));
        }
        float w_lo[COLS], w_hi[COLS];
        if (BITS == 4) {
          const int gh = (kp + KP) / G;
          if (gh != g_hi) {
            g_hi = gh;
            s_hi = fold<LUT>(*reinterpret_cast<const float4*>(scales + (size_t)gh * N + n0));
          }
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int b = (word >> (8 * c)) & 0xFF;
            const float q_lo = LUT ? tab[b & 0xF] : float((b & 0xF) - 8);
            const float q_hi = LUT ? tab[b >> 4] : float((b >> 4) - 8);
            w_lo[c] = round_w<T>(q_lo * lane4(s_lo, c));
            w_hi[c] = round_w<T>(q_hi * lane4(s_hi, c));
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

template <typename T, int BITS, int TM, int TY, int KS, int LUT>
__global__ void __launch_bounds__(TX * TY * KS)
dequant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                      const float* __restrict__ scales, void* __restrict__ out,
                      int out_f32, float* __restrict__ partial, int M, int K,
                      int N, int G, int kp_per_split,
                      const float* __restrict__ lut) {
  const int KP = BITS == 4 ? K / 2 : K;
  const int kp_begin = blockIdx.z * kp_per_split;
  dmm_tile<T, BITS, TM, TY, KS, LUT>(x, codes, scales, out, out_f32, partial,
                                     gridDim.z > 1, N, 0, M, K, N, G, kp_begin,
                                     min(KP, kp_begin + kp_per_split), lut);
}

struct MoeArgs {
  const int* hot;           // [1 + slots]: n_hot, then expert ids; null: slot j is expert j
  long long codes_stride;   // bytes between stack entries (K/2 or K) * N
  long long scales_stride;  // floats between stack entries (K / G) * N
  int layer, stride;        // stack entry of expert e: e * stride + layer
  int experts;              // experts in the stack (ids outside stream nothing)
  int slots;                // expert slots (columns of y in concat)
  int sum;                  // 1: x [slots, M, K] -> y [M, N]
  int grouped;              // 1: x [slots, M, K] -> y [slots, M, N]
                            // (neither: concat, x [M, K] -> y [M, slots * N])
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
  // output row m of the slot at m * ldo + col0
  const size_t ldo = a.sum || a.grouped ? (size_t)N : (size_t)a.slots * N;
  const size_t col0 = a.sum       ? 0
                      : a.grouped ? (size_t)slot * M * N
                                  : (size_t)slot * N;
  dmm_tile<T, BITS, TM, TY, KS, 0>(
      x + (a.sum || a.grouped ? (size_t)slot * M * K : 0),
      codes + w * a.codes_stride, scales + w * a.scales_stride, out, out_f32,
      partial, atomic != 0, ldo, col0, M, K, N, G, kp_begin,
      min(KP, kp_begin + kp_per), nullptr);
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

// One call's operands; acc is the f32 [M, ldo] buffer the partials meet in
// (null: direct stores); lut: a codebook weight's table (null: linear).
struct Call {
  const void* x;
  const void* codes;
  const float* scales;
  void* out;
  int out_f32;
  float* acc;
  int M, K, N, G, splits, kp_per_split;
  const float* lut;
};

// The MoE kernel runs linear codes only (LUT 0).
template <typename T, int BITS, int TM, int TY, int KS, int LUT>
void launch(const Call& c, const MoeArgs* moe, cudaStream_t st) {
  constexpr int BM = TM * TY;
  const int slots = moe ? moe->slots : 1;
  dim3 grid((c.N + BN - 1) / BN, (c.M + BM - 1) / BM, c.splits * slots);
  dim3 block(TX, TY, KS);
  const T* x = reinterpret_cast<const T*>(c.x);
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(c.codes);
  if constexpr (LUT == 0) {
    if (moe) {
      dequant_matmul_moe_kernel<T, BITS, TM, TY, KS><<<grid, block, 0, st>>>(
          x, codes, c.scales, c.out, c.out_f32, c.acc, c.acc != nullptr, c.M,
          c.K, c.N, c.G, *moe);
      return;
    }
  }
  dequant_matmul_kernel<T, BITS, TM, TY, KS, LUT><<<grid, block, 0, st>>>(
      x, codes, c.scales, c.out, c.out_f32, c.acc, c.M, c.K, c.N, c.G,
      c.kp_per_split, c.lut);
}

template <typename T, int BITS, int LUT>
void dispatch(const Call& c, const MoeArgs* moe, cudaStream_t st) {
  // decode M: one row tile, K split over 4 slices per block; prefill M:
  // 64-row tiles of 8 x 8 rows
  if (c.M <= 1)
    launch<T, BITS, 1, 1, 4, LUT>(c, moe, st);
  else if (c.M <= 2)
    launch<T, BITS, 2, 1, 4, LUT>(c, moe, st);
  else if (c.M <= 4)
    launch<T, BITS, 4, 1, 4, LUT>(c, moe, st);
  else if (c.M <= 8)
    launch<T, BITS, 8, 1, 4, LUT>(c, moe, st);
  else
    launch<T, BITS, 8, 8, 1, LUT>(c, moe, st);
}

// x's type from x_bf16; a table (lut_mode 1 word4, 2 sel15) only with int4
template <typename T>
void dispatch_codes(const Call& c, int bits, int lut_mode, const MoeArgs* moe,
                    cudaStream_t st) {
  if (bits == 8)
    dispatch<T, 8, 0>(c, moe, st);
  else if (lut_mode == 1)
    dispatch<T, 4, 1>(c, moe, st);
  else if (lut_mode == 2)
    dispatch<T, 4, 2>(c, moe, st);
  else
    dispatch<T, 4, 0>(c, moe, st);
}

// Clears the f32 buffer the partials meet in (when they do), launches, and
// casts that buffer to bf16 when the output is bf16. `atomic`: the partials
// of split-K or of summed slots add up by atomicAdd; the buffer is `out`
// itself for f32 output, else `partial`.
int run(Call c, int x_bf16, int bits, int lut_mode, const MoeArgs* moe,
        bool atomic, size_t ldo, void* partial, cudaStream_t st) {
  const size_t n = (size_t)c.M * ldo;
  if (atomic) {
    c.acc = c.out_f32 ? reinterpret_cast<float*>(c.out)
                      : reinterpret_cast<float*>(partial);
    const cudaError_t err = cudaMemsetAsync(c.acc, 0, n * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (x_bf16)
    dispatch_codes<__nv_bfloat16>(c, bits, lut_mode, moe, st);
  else
    dispatch_codes<float>(c, bits, lut_mode, moe, st);
  if (atomic && !c.out_f32) {
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    f32_to_bf16_kernel<<<blocks, 256, 0, st>>>(
        c.acc, reinterpret_cast<__nv_bfloat16*>(c.out), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace cc


// lut: a codebook weight's float32 table [16] and lut_mode 1 (word4) or 2
// (sel15), with int4 codes; null and 0 for linear codes.
extern "C" int dequant_matmul_launch(const void* x, int x_bf16, const void* codes,
                                     const void* scales, void* out, int out_f32,
                                     void* partial, int M, int K, int N, int G,
                                     int bits, int splits, int kp_per_split,
                                     const void* lut, int lut_mode,
                                     void* stream) {
  const cc::Call c{x, codes, reinterpret_cast<const float*>(scales), out, out_f32,
               nullptr, M, K, N, G, splits, kp_per_split,
               reinterpret_cast<const float*>(lut)};
  return cc::run(c, x_bf16, bits, lut_mode, nullptr, splits > 1, N, partial,
             reinterpret_cast<cudaStream_t>(stream));
}

// mode: 0 concat (x [M, K] -> y [M, slots * N]), 1 sum (x [slots, M, K]
// -> y [M, N]), 2 grouped (x [slots, M, K] -> y [slots, M, N]); codes /
// scales: the whole expert-major stack; hot: device int32 [1 + slots] or
// null; the grid has slots * splits blocks in z. `atomic`: the partials
// meet by atomicAdd in a cleared f32 buffer of y's size (`out` itself for
// f32 output, else `partial`); the caller sets it when K is split, slots
// are summed or a hot list is given.
extern "C" int dequant_matmul_moe_launch(
    const void* x, int x_bf16, const void* codes, const void* scales, void* out,
    int out_f32, void* partial, int atomic, int M, int K, int N, int G,
    int bits, int splits, int slots, int mode, int layer, int stride,
    int experts, const void* hot, void* stream) {
  const long long kp = bits == 4 ? K / 2 : K;
  cc::MoeArgs a{reinterpret_cast<const int*>(hot), kp * N, (long long)(K / G) * N,
            layer, stride, experts, slots, mode == 1, mode == 2};
  const cc::Call c{x, codes, reinterpret_cast<const float*>(scales), out, out_f32,
               nullptr, M, K, N, G, splits, 0, nullptr};
  // run() clears and casts M * ldo values: all of y
  return cc::run(c, x_bf16, bits, 0, &a, atomic != 0,
             mode == 1 ? (size_t)N : (size_t)slots * N, partial,
             reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
