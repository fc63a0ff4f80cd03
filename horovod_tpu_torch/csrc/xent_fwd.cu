// Fused softmax cross-entropy forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_xent_kernel` (horovod_tpu/ops/pallas_xent.py).
// Same function: for each row of logits [N, V] and its integer label, a running
// max and sum in fp32 give lse = m + log(l), and loss = lse - logits[label]; a
// label outside [0, V) contributes no logit, so its loss is lse.
//
// What bounds it on the H100: the logits are read once and two fp32 words a row
// are written, about 131 MB at the flagship's N 2048 x V 32000 in bf16, so the
// floor is the memory, about 39 us; the exps, some 66 M, fit well under it. The
// design aims at that floor: one block of 256 threads a row, each thread
// streaming 16-byte vectors of the row with its own online (max, sum), merged
// across the block at the end. The V edge is masked in the kernel, so a vocab
// that is not a multiple of any block needs no padded copy (the JAX wrapper pads
// V to a multiple of 512 with a concatenate). A row whose start is not 16-byte
// aligned takes its first elements one at a time. The label's logit is one
// extra load per row, by the thread that writes the row's result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;  // the Pallas kernel's initial running max

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// fold a partial (m2, l2) into (m, l)
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    xent_fwd_kernel(const T* __restrict__ logits, long long row_stride,
                    const long long* __restrict__ labels, float* __restrict__ loss,
                    float* __restrict__ lse, int V) {
  constexpr int VEC = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* x = logits + row * row_stride;

  float m = NEG_INF, l = 0.0f;
  int head = (int)(((16u - (reinterpret_cast<uintptr_t>(x) & 15u)) & 15u) / sizeof(T));
  head = min(head, V);
  const int nvec = (V - head) / VEC;
  for (int i = threadIdx.x; i < head; i += THREADS) merge(m, l, to_f(x[i]), 1.0f);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    float f[VEC];
    unpack(__ldg(xv + i), f);
    float vm = f[0];
#pragma unroll
    for (int j = 1; j < VEC; ++j) vm = fmaxf(vm, f[j]);
    const float mn = fmaxf(m, vm);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += expf(f[j] - mn);
    l = l * expf(m - mn) + s;
    m = mn;
  }
  for (int i = head + nvec * VEC + threadIdx.x; i < V; i += THREADS)
    merge(m, l, to_f(x[i]), 1.0f);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  __shared__ float wm[THREADS / 32], wl[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = wm[0];
    l = wl[0];
    for (int w = 1; w < THREADS / 32; ++w) merge(m, l, wm[w], wl[w]);
    const float row_lse = m + logf(l);
    const long long label = labels[row];
    const float z = (label >= 0 && label < V) ? to_f(x[label]) : 0.0f;
    lse[row] = row_lse;
    loss[row] = row_lse - z;
  }
}

template <typename T>
int launch(const void* logits, long long row_stride, const long long* labels,
           float* loss, float* lse, long long N, int V, cudaStream_t stream) {
  xent_fwd_kernel<T><<<(unsigned)N, THREADS, 0, stream>>>(
      static_cast<const T*>(logits), row_stride, labels, loss, lse, V);
  return (int)cudaGetLastError();
}

}  // namespace

// logits: [N, V] with unit stride along V and row_stride elements between rows;
// labels: contiguous int64 [N]; loss, lse: contiguous fp32 [N]. dtype 0 is fp32,
// 1 is bf16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int xent_fwd(const void* logits, long long row_stride,
                        const long long* labels, float* loss, float* lse,
                        long long N, int V, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(logits, row_stride, labels, loss, lse, N, V, st);
  if (dtype == 0) return launch<float>(logits, row_stride, labels, loss, lse, N, V, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* xent_fwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
