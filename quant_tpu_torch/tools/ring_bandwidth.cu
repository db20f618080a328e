// Bandwidth of the dequant_matmul decode tile's access pattern without its
// compute: blocks stream [rows, BN] strips of a [KP, N] byte matrix (packed
// int4 codes at Llama-3-8B's lm_head, w_gate_up and w_down shapes) through a
// cp.async ring and fold each word into a checksum, beside a flat 16-byte
// grid-stride read of the same bytes. Built and run by
// `python -m quant_tpu_torch.tools.dmm_probe ring`.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

template <int BN, int BKP, int STAGES, int THREADS>
__global__ void __launch_bounds__(THREADS) ring(const uint8_t* __restrict__ w, int KP, int N, int per, uint32_t* out) {
  extern __shared__ __align__(128) uint8_t sm[];
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * per;
  const int k1 = min(KP, k0 + per);
  const int nst = (k1 - k0) / BKP;
  auto load = [&](int s) {
    uint8_t* d = sm + (s % STAGES) * BKP * BN;
    for (int i = threadIdx.x; i < BKP * BN / 16; i += THREADS) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      cp16(d + r * BN + 16 * c, w + (size_t)(k0 + s * BKP + r) * N + n0 + 16 * c);
    }
  };
  uint32_t acc = 0;
  for (int s = 0; s < STAGES - 1; ++s) { if (s < nst) load(s); cp_commit(); }
  for (int s = 0; s < nst; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < nst) load(s + STAGES - 1);
    cp_commit();
    const uint2* d = reinterpret_cast<const uint2*>(sm + (s % STAGES) * BKP * BN);
    for (int i = threadIdx.x; i < BKP * BN / 8; i += THREADS) { const uint2 v = d[i]; acc ^= v.x ^ v.y; }
  }
  cp_wait<0>();
  if (acc == 0x12345678u) out[0] = acc;
}

// plain loads, 16 bytes a thread, grid-stride: the contiguous yardstick
__global__ void flat(const uint4* __restrict__ w, size_t n, uint32_t* out) {
  uint32_t acc = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    const uint4 v = __ldg(w + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345678u) out[0] = acc;
}

template <int BN, int BKP, int STAGES, int THREADS>
float run(const uint8_t* w, int KP, int N, int splits, uint32_t* out, cudaEvent_t a, cudaEvent_t b, int reps) {
  auto k = ring<BN, BKP, STAGES, THREADS>;
  const int smem = STAGES * BKP * BN;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int per = (KP / splits + BKP - 1) / BKP * BKP;
  dim3 grid(N / BN, (KP + per - 1) / per);
  k<<<grid, THREADS, smem>>>(w, KP, N, per, out);
  cudaEventRecord(a);
  for (int r = 0; r < reps; ++r) k<<<grid, THREADS, smem>>>(w + (size_t)(r % 4) * KP * N, KP, N, per, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  int nb = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, THREADS, smem);
  const float t = ms / reps;
  printf("  ring BN=%d BKP=%d stages=%d threads=%d splits=%d blocks=%d (%d/SM): %.4f ms %.2f TB/s\n", BN, BKP, STAGES,
         THREADS, splits, grid.x * grid.y, nb, t, (double)KP * N / t / 1e9);
  return t;
}

int main() {
  const int shapes[3][2] = {{2048, 131072}, {2048, 28672}, {7168, 4096}};
  uint8_t* w;
  uint32_t* out;
  cudaMalloc(&w, (size_t)4 * 2048 * 131072);
  cudaMalloc(&out, 4);
  cudaMemset(w, 1, (size_t)4 * 2048 * 131072);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (auto& sh : shapes) {
    const int KP = sh[0], N = sh[1];
    printf("KP=%d N=%d (%.1f MB)\n", KP, N, KP * (double)N / 1e6);
    {
      const size_t n = (size_t)KP * N / 16;
      flat<<<132 * 8, 512>>>(reinterpret_cast<const uint4*>(w), n, out);
      cudaEventRecord(a);
      for (int r = 0; r < 20; ++r) flat<<<132 * 8, 512>>>(reinterpret_cast<const uint4*>(w + (size_t)(r % 4) * KP * N), n, out);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      printf("  flat: %.4f ms %.2f TB/s\n", ms / 20, (double)KP * N / (ms / 20) / 1e9);
    }
    const int tiles = N / 256;
    const int s2 = tiles >= 264 ? 1 : (264 + tiles - 1) / tiles;
    run<256, 32, 4, 128>(w, KP, N, s2, out, a, b, 20);
    run<256, 32, 4, 128>(w, KP, N, s2 * 4, out, a, b, 20);
    run<256, 64, 4, 128>(w, KP, N, s2, out, a, b, 20);
    run<256, 32, 8, 128>(w, KP, N, s2, out, a, b, 20);
    run<512, 32, 4, 256>(w, KP, N, s2 * 2, out, a, b, 20);
    run<1024, 16, 4, 256>(w, KP, N, s2 * 4, out, a, b, 20);
    run<128, 64, 4, 128>(w, KP, N, s2, out, a, b, 20);
  }
  printf("err %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
