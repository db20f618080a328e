// In-place KV-cache row insert for Hopper (sm_90a): the contiguous cache, the
// paged pool and the MLA latent cache.
//
// Replaces: quant_tpu/kernels/cache_insert.py, cache_insert_int8 -> _kernel,
//   paged_cache_insert_int8 -> _paged_kernel and mla_cache_insert_int8 ->
//   _mla_kernel (the aliased Pallas TPU kernels).
//
// cache_insert_int8: writes each slot's new int8 K and V code rows [Dh] and
// their two f32 scales into the stacked caches [L, B, H, S, Dh] /
// [L, B, H, S] at [layer, b, h, lengths[b] - s0]. A position outside [0, S)
// writes nothing, which drops the writes of parked slots and of positions
// another sequence shard owns.
//
// paged_cache_insert_int8: the same rows into the page pools
// [L, P, H, page, Dh] / [L, P, H, page] at
// [layer, page_tbl[b, pos / page], h, pos % page] with pos = lengths[b]; a
// position outside [0, max_pages * page) writes nothing. A parked slot
// (length 0, table row 0) writes into the reserved scratch page 0.
//
// mla_cache_insert_int8: one latent row [Dq] int8 (c_kv | k_rope | zero pad)
// and its one f32 scale per slot into the stacked latent cache
// [L, B, 1, S, Dq] / [L, B, 1, S] at [layer, b, 0, lengths[b] - s0]; a
// position outside [0, S) writes nothing. The V side of an MLA cache is
// zero-width.
//
// What bounds it on this card: a few kilobytes per call, so launch latency.
// Design: one block per (slot, head) (per slot for the latent row), each
// thread copies bytes of the rows straight into the cache buffers. On the GPU a row is directly addressable,
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

__global__ void paged_cache_insert_kernel(
    int8_t* __restrict__ kc, float* __restrict__ ks, int8_t* __restrict__ vc,
    float* __restrict__ vs, const int8_t* __restrict__ kn, const float* __restrict__ kns,
    const int8_t* __restrict__ vn, const float* __restrict__ vns,
    const int* __restrict__ page_tbl, const int* __restrict__ lengths, int layer, int H,
    int P, int page, int max_pages, int D) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int pos = lengths[b];
  if (pos < 0 || pos >= max_pages * page) return;
  const int pg = page_tbl[(size_t)b * max_pages + pos / page];
  const size_t row = (((size_t)layer * P + pg) * H + h) * page + pos % page;
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

extern "C" int cache_insert_int8_launch(void* kc, void* ks, void* vc, void* vs,
                                        const void* kn, const void* kns,
                                        const void* vn, const void* vns,
                                        const void* lengths, int layer, int s0,
                                        int B, int H, int S, int D, void* stream) {
  cache_insert_kernel<<<B * H, threads_for(D), 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<int8_t*>(kc), reinterpret_cast<float*>(ks),
      reinterpret_cast<int8_t*>(vc), reinterpret_cast<float*>(vs),
      reinterpret_cast<const int8_t*>(kn), reinterpret_cast<const float*>(kns),
      reinterpret_cast<const int8_t*>(vn), reinterpret_cast<const float*>(vns),
      reinterpret_cast<const int*>(lengths), layer, s0, B, H, S, D);
  return (int)cudaGetLastError();
}

extern "C" int paged_cache_insert_int8_launch(void* kc, void* ks, void* vc, void* vs,
                                              const void* kn, const void* kns,
                                              const void* vn, const void* vns,
                                              const void* page_tbl, const void* lengths,
                                              int layer, int B, int H, int P, int page,
                                              int max_pages, int D, void* stream) {
  paged_cache_insert_kernel<<<B * H, threads_for(D), 0,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<int8_t*>(kc), reinterpret_cast<float*>(ks),
      reinterpret_cast<int8_t*>(vc), reinterpret_cast<float*>(vs),
      reinterpret_cast<const int8_t*>(kn), reinterpret_cast<const float*>(kns),
      reinterpret_cast<const int8_t*>(vn), reinterpret_cast<const float*>(vns),
      reinterpret_cast<const int*>(page_tbl), reinterpret_cast<const int*>(lengths),
      layer, H, P, page, max_pages, D);
  return (int)cudaGetLastError();
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
