// Split-K int4 unpack for Hopper (sm_90a): packed uint8 [K/2, N] -> int8
// codes [K, N].
//
// Replaces: quant_tpu/kernels/unpack.py, unpack_int4_device -> _kernel (the
//   Pallas TPU kernel that proves the int4 layout of packed weights on the
//   device, independently of the matmul; a verification utility, never on
//   the load path: dequant_matmul unpacks nibbles in its own tiles).
//
// Layout (core/codec.py pack_int4_matmul): packed[i, n] holds code (i, n) in
// its low nibble and code (i + K/2, n) in its high nibble, each biased by +8.
// Row-major, the output's first half [0, K/2*N) is the low nibbles of the
// packed bytes in order and its second half the high nibbles, so the unpack
// is one flat pass over the M = K/2*N packed bytes, whatever N is.
//
// What bounds it on this card: bytes. It reads M bytes and writes 2M, and
// does four integer operations per 4 bytes (bound: 3M bytes over 3.35 TB/s).
// Design: each thread loads 16 packed bytes as one 16-byte vector, splits
// every 32-bit word into its low and high nibbles (mask, shift) and takes 8
// from each byte with __vsub4 (bytewise, no borrow between bytes), then
// stores the 16 low codes at the same offset of the first half and the 16
// high codes at the same offset of the second half, both as 16-byte
// vectors; neighbouring threads touch neighbouring 16 bytes. A tail (M not
// a multiple of 16) or an unaligned pointer takes a bytewise kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t lo_codes(uint32_t w) {
  return __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
}

__device__ __forceinline__ uint32_t hi_codes(uint32_t w) {
  return __vsub4((w >> 4) & 0x0F0F0F0Fu, 0x08080808u);
}

__global__ void unpack_int4_vec_kernel(const uint4* __restrict__ packed,
                                       uint4* __restrict__ lo,
                                       uint4* __restrict__ hi, int64_t m16) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m16) return;
  const uint4 w = packed[i];
  lo[i] = make_uint4(lo_codes(w.x), lo_codes(w.y), lo_codes(w.z),
                     lo_codes(w.w));
  hi[i] = make_uint4(hi_codes(w.x), hi_codes(w.y), hi_codes(w.z),
                     hi_codes(w.w));
}

__global__ void unpack_int4_byte_kernel(const uint8_t* __restrict__ packed,
                                        int8_t* __restrict__ out,
                                        int64_t begin, int64_t m) {
  const int64_t j = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int b = packed[j];
  out[j] = (int8_t)((b & 0xF) - 8);
  out[m + j] = (int8_t)((b >> 4) - 8);
}

constexpr int kThreads = 256;

}  // namespace

// m = K/2 * N packed bytes; out holds 2m bytes.
extern "C" int unpack_int4_launch(const void* packed, void* out, int64_t m,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(packed);
  int8_t* o = reinterpret_cast<int8_t*>(out);
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(o) | (uintptr_t)m) &
                        15) == 0;
  int64_t done = 0;
  if (aligned) {
    const int64_t m16 = m / 16;
    if (m16 > 0) {
      const int64_t blocks = (m16 + kThreads - 1) / kThreads;
      unpack_int4_vec_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
          reinterpret_cast<const uint4*>(p), reinterpret_cast<uint4*>(o),
          reinterpret_cast<uint4*>(o + m), m16);
    }
    done = m16 * 16;
  }
  if (done < m) {
    const int64_t rest = m - done;
    const int64_t blocks = (rest + kThreads - 1) / kThreads;
    unpack_int4_byte_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(p, o, done,
                                                                 m);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
