// In-place KV-cache row insert for Hopper (sm_90a).
//
// Replaces: quant_tpu/kernels/cache_insert.py, cache_insert_int8 -> _kernel
//   (the aliased Pallas TPU kernel).
//
// Writes each slot's new int8 K and V code rows [Dh] and their two f32 scales
// into the stacked caches [L, B, H, S, Dh] / [L, B, H, S] at
// [layer, b, h, lengths[b] - s0]. A position outside [0, S) writes nothing,
// which drops the writes of parked slots and of positions another sequence
// shard owns.
//
// What bounds it on this card: a few kilobytes per call, so launch latency.
// Design: one block per (slot, head), each thread copies bytes of the rows
// straight into the cache buffers. On the GPU a row is directly addressable,
// so the TPU kernel's aligned read-modify-write tiles, DMA waves and lane
// views have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cache_insert_kernel(int8_t* __restrict__ kc, float* __restrict__ ks,
                                    int8_t* __restrict__ vc, float* __restrict__ vs,
                                    const int8_t* __restrict__ kn,
                                    const float* __restrict__ kns,
                                    const int8_t* __restrict__ vn,
                                    const float* __restrict__ vns,
                                    const int* __restrict__ lengths, int layer,
                                    int s0, int B, int H, int S, int D) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int pos = lengths[b] - s0;
  if (pos < 0 || pos >= S) return;
  const size_t row = (((size_t)layer * B + b) * H + h) * S + pos;
  const size_t src = (size_t)b * H + h;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    kc[row * D + d] = kn[src * D + d];
    vc[row * D + d] = vn[src * D + d];
  }
  if (threadIdx.x == 0) {
    ks[row] = kns[src];
    vs[row] = vns[src];
  }
}

}  // namespace

extern "C" int cache_insert_int8_launch(void* kc, void* ks, void* vc, void* vs,
                                        const void* kn, const void* kns,
                                        const void* vn, const void* vns,
                                        const void* lengths, int layer, int s0,
                                        int B, int H, int S, int D, void* stream) {
  const int threads = D >= 128 ? 128 : ((D + 31) / 32) * 32;
  cache_insert_kernel<<<B * H, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<int8_t*>(kc), reinterpret_cast<float*>(ks),
      reinterpret_cast<int8_t*>(vc), reinterpret_cast<float*>(vs),
      reinterpret_cast<const int8_t*>(kn), reinterpret_cast<const float*>(kns),
      reinterpret_cast<const int8_t*>(vn), reinterpret_cast<const float*>(vns),
      reinterpret_cast<const int*>(lengths), layer, s0, B, H, S, D);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
