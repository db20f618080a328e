// Fused dequantize + matmul for Hopper (sm_90a): y[M, N] = x[M, K] @ dequant(W).
//
// Replaces: quant_tpu/kernels/dequant_matmul.py, dequant_matmul ->
//   _dequant_matmul_2d -> _kernel_int4 / _kernel_int8 (the Pallas TPU kernel).
//
// W is a QTensor: int4 codes uint8 [K/2, N] in the split-K layout (byte[i, n]
// holds row i in the low nibble and row i + K/2 in the high nibble, biased by
// +8) or int8 codes [K, N], with f32 group scales [K/G, N]. Stacked weights
// arrive as the codes[layer] / scales[layer] views of the stack.
//
// What bounds it on this card: at decode M (1-8) the codes are the traffic
// (0.5 byte per weight) and the op is memory bound; at prefill M (up to a
// 512-token chunk) it is bound by arithmetic. This first kernel runs on the
// CUDA cores in f32, so at prefill M it is far from the tensor-core rate.
//
// Design: a block owns 256 columns (64 threads x 4 adjacent columns, so each
// packed code row is one coalesced 4-byte load per thread and one float4 of
// scales per group) and BM = TM * TY rows of x. The x tile for a stretch of
// 64 packed rows is staged in shared memory as f32: both halves for int4
// (rows i and i + K/2 of the stretch). Each code byte feeds two rows; the
// high half's scale row is (i + K/2) / G. The weight is dequantized in
// registers (code * scale, rounded to the activation type like the plain
// version) and multiplied into f32 accumulators. A thread loads the code
// words of U packed rows before it uses any of them, so U loads per thread are
// in flight. At decode M the K range is
// split over KS warps-slices in the block and over blocks (split-K), so
// enough blocks stream the codes; split-K partials meet by atomicAdd in an f32
// buffer, which a second small kernel casts to the output type when that type
// is bf16. wgmma, TMA and a tensor-core path come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int BITS, int TM, int TY, int KS>
__global__ void __launch_bounds__(TX * TY * KS)
dequant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                      const float* __restrict__ scales, void* __restrict__ out,
                      int out_f32, float* __restrict__ partial, int M, int K,
                      int N, int G, int kp_per_split) {
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
  const int kp_begin = blockIdx.z * kp_per_split;
  const int kp_end = min(KP, kp_begin + kp_per_split);
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
    const size_t o = (size_t)row * N + n0;
    if (gridDim.z > 1) {
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

__global__ void f32_to_bf16_kernel(const float* __restrict__ src,
                                   __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

template <typename T, int BITS, int TM, int TY, int KS>
void launch(const void* x, const void* codes, const float* scales, void* out,
            int out_f32, float* partial, int M, int K, int N, int G,
            int splits, int kp_per_split, cudaStream_t st) {
  constexpr int BM = TM * TY;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  dim3 block(TX, TY, KS);
  dequant_matmul_kernel<T, BITS, TM, TY, KS><<<grid, block, 0, st>>>(
      reinterpret_cast<const T*>(x), reinterpret_cast<const uint8_t*>(codes),
      scales, out, out_f32, partial, M, K, N, G, kp_per_split);
}

template <typename T, int BITS>
void dispatch(const void* x, const void* codes, const float* scales, void* out,
              int out_f32, float* partial, int M, int K, int N, int G,
              int splits, int kp_per_split, cudaStream_t st) {
  // decode M: one row tile, K split over 4 slices per block; prefill M:
  // 64-row tiles of 8 x 8 rows
  if (M <= 1)
    launch<T, BITS, 1, 1, 4>(x, codes, scales, out, out_f32, partial, M, K, N, G, splits, kp_per_split, st);
  else if (M <= 2)
    launch<T, BITS, 2, 1, 4>(x, codes, scales, out, out_f32, partial, M, K, N, G, splits, kp_per_split, st);
  else if (M <= 4)
    launch<T, BITS, 4, 1, 4>(x, codes, scales, out, out_f32, partial, M, K, N, G, splits, kp_per_split, st);
  else if (M <= 8)
    launch<T, BITS, 8, 1, 4>(x, codes, scales, out, out_f32, partial, M, K, N, G, splits, kp_per_split, st);
  else
    launch<T, BITS, 8, 8, 1>(x, codes, scales, out, out_f32, partial, M, K, N, G, splits, kp_per_split, st);
}

}  // namespace

extern "C" int dequant_matmul_launch(const void* x, int x_bf16, const void* codes,
                                     const void* scales, void* out, int out_f32,
                                     void* partial, int M, int K, int N, int G,
                                     int bits, int splits, int kp_per_split,
                                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* s = reinterpret_cast<const float*>(scales);
  float* acc = nullptr;
  if (splits > 1) {
    acc = out_f32 ? reinterpret_cast<float*>(out) : reinterpret_cast<float*>(partial);
    const cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (x_bf16) {
    if (bits == 4)
      dispatch<__nv_bfloat16, 4>(x, codes, s, out, out_f32, acc, M, K, N, G, splits, kp_per_split, st);
    else
      dispatch<__nv_bfloat16, 8>(x, codes, s, out, out_f32, acc, M, K, N, G, splits, kp_per_split, st);
  } else {
    if (bits == 4)
      dispatch<float, 4>(x, codes, s, out, out_f32, acc, M, K, N, G, splits, kp_per_split, st);
    else
      dispatch<float, 8>(x, codes, s, out, out_f32, acc, M, K, N, G, splits, kp_per_split, st);
  }
  if (splits > 1 && !out_f32) {
    const size_t n = (size_t)M * N;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    f32_to_bf16_kernel<<<blocks, 256, 0, st>>>(
        acc, reinterpret_cast<__nv_bfloat16*>(out), n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
