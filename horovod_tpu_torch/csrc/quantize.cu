// Block-wise int8 codec and fused dequantize + optimizer apply for Hopper
// (sm_90a): six kernels, one plain C entry each.
//
// Replaces the six Pallas TPU kernels of horovod_tpu/ops/pallas_quantize.py:
//   quantize     <- _quantize_kernel      per-row scale = absmax/127 (1 for an
//                                         all-zero row), codes
//                                         clip(round_half_even(x/scale), +-127)
//   quantize_ef  <- _quantize_ef_kernel   the same plus the error-feedback
//                                         residual x - q*scale
//   dequantize   <- _dequantize_kernel    codes*scale as fp32
//   fused_sgd0   <- _fused_sgd0_kernel    delta = -lr*(codes*scale)
//   fused_sgd    <- _fused_sgd_kernel     t = g + mu*t_prev, delta = -lr*t
//   fused_adam   <- _fused_adam_kernel    Adam moments and
//                                         delta = -lr*(m/bc1)/(sqrt(v/bc2)+eps)
// Operands are [rows, block] row-major with one fp32 scale a row.
//
// What bounds them on the H100: memory. Each does a handful of flops per
// element against 5 to 21 bytes, far below the ~295 operations a byte at which
// the card stops being bound by its 3.35 TB/s. At the flagship embedding's
// [64000, 256] the bytes are 82 MB (quantize, dequantize, sgd0), 148 MB
// (quantize_ef), 213 MB (sgd) and 344 MB (adam): 24.5 to 103 us.
//
// What the design does about it: every input element is read once and every
// output written once, nothing is rematerialized and nothing is padded. One
// warp owns one row at a time (a grid-stride loop over rows), so the row's
// scale is one broadcast load and the absmax one __shfl_xor_sync reduction.
// Loads and stores are 16 bytes a lane wherever the row length and the
// pointers allow it (block 256: 8 fp32 a lane in two float4s), with a scalar
// path for the rest, so any block >= 1 and a ragged row count are taken as they
// are (the JAX wrappers pad rows to the 32-row int8 tile and need block % 128).
// The quantizers keep a row's values in registers between the absmax and the
// codes (up to 32 a lane, as few as the row needs: 8 at block 256 in fp32);
// only a row longer than 1024 is read a second time (from L1/L2).
//
// Numerics follow the Pallas code: x/scale and absmax/127 are IEEE divisions
// (never build with --use_fast_math), rounding is rintf (half to even, as
// jnp.round; roundf would round halves away from zero), and every product and
// sum is rounded on its own (__fmul_rn/__fadd_rn keep nvcc from contracting
// them into FMAs), so the kernels give the plain PyTorch versions' bits. The
// optimizer kernels may write their new moments over the old ones (the
// pointers may be equal): each element is read before it is written, by the
// same thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;     // rows in flight per block of threads
constexpr int THREADS = WARPS * 32;
constexpr int CAP = 32;      // most values a lane keeps in registers per row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// V consecutive elements of a row, as fp32: one 16-byte load when V > 1
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "fp32 vectors are 4 wide");
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  } else {
    static_assert(V == 8, "bf16 vectors are 8 wide");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// plain loads for state the kernel may overwrite in place (no __ldg)
template <int V>
__device__ __forceinline__ void load_state(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = p[0];
  } else {
    static_assert(V == 4, "state vectors are 4 wide");
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = f[0];
  } else {
    static_assert(V % 4 == 0, "fp32 stores go 4 at a time");
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

__device__ __forceinline__ uint32_t pack4(const float* q) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(q[i]) << (8 * i);
  return w;
}

template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const float (&q)[V]) {
  if constexpr (V == 1) {
    p[0] = (int8_t)__float2int_rn(q[0]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = pack4(q);
  } else {
    static_assert(V == 8, "codes go 1, 4 or 8 at a time");
    *reinterpret_cast<uint2*>(p) = make_uint2(pack4(q), pack4(q + 4));
  }
}

// V codes of a row as fp32 (a 4-byte load when V == 4)
template <int V>
__device__ __forceinline__ void load_codes(const int8_t* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = (float)__ldg(p);
  } else {
    static_assert(V == 4, "codes are read 1 or 4 at a time");
    const int w = __ldg(reinterpret_cast<const int*>(p));
    f[0] = (float)((w << 24) >> 24);
    f[1] = (float)((w << 16) >> 24);
    f[2] = (float)((w << 8) >> 24);
    f[3] = (float)(w >> 24);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// codes and residual of V values already in registers
template <int V, bool EF>
__device__ __forceinline__ void emit(const float (&x)[V], float scale, int8_t* vals, float* res) {
  float q[V], r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    q[j] = fminf(fmaxf(rintf(__fdiv_rn(x[j], scale)), -127.0f), 127.0f);
    if constexpr (EF) r[j] = __fsub_rn(x[j], __fmul_rn(q[j], scale));
  }
  store_codes<V>(vals, q);
  if constexpr (EF) store_f32<V>(res, r);
}

// _quantize_kernel (EF = false) and _quantize_ef_kernel (EF = true). A row of
// `block` elements is `nvec` loads of V; lane l takes loads l, l + 32, ...
// and keeps up to NV of them in registers (the launch picks the least NV that
// holds the row, so short rows cost few registers and many warps fit an SM).
template <typename T, int V, int NV, bool EF>
__global__ void __launch_bounds__(THREADS)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ vals,
                    float* __restrict__ scales, float* __restrict__ res,
                    long long rows, int block) {
  const int lane = threadIdx.x & 31;
  const int nvec = block / V;
  const bool fits = nvec <= 32 * NV;
  for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * WARPS) {
    const long long base = row * block;
    const T* xr = x + base;
    float f[NV][V];
    float amax = 0.0f;
    if (fits) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = lane + 32 * k;
        if (i < nvec) {
          load_vec<T, V>(xr + (long long)i * V, f[k]);
#pragma unroll
          for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(f[k][j]));
        }
      }
    } else {
      for (int i = lane; i < nvec; i += 32) {
        float t[V];
        load_vec<T, V>(xr + (long long)i * V, t);
#pragma unroll
        for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(t[j]));
      }
    }
    amax = warp_max(amax);
    // all-zero rows quantize through scale 1 to zeros
    const float scale = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
    if (lane == 0) scales[row] = scale;
    if (fits) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = lane + 32 * k;
        if (i < nvec) {
          const long long o = base + (long long)i * V;
          emit<V, EF>(f[k], scale, vals + o, EF ? res + o : nullptr);
        }
      }
    } else {
      for (int i = lane; i < nvec; i += 32) {
        float t[V];
        load_vec<T, V>(xr + (long long)i * V, t);
        const long long o = base + (long long)i * V;
        emit<V, EF>(t, scale, vals + o, EF ? res + o : nullptr);
      }
    }
  }
}

// The elementwise kernels share one walk: warp w takes rows w, w + W, ...;
// each lane takes V-element pieces l, l + 32, ... of the row and hands the
// dequantized gradient g (codes * scale) to `op` with the piece's offset.
template <int V, typename Op>
__device__ __forceinline__ void walk_rows(const int8_t* __restrict__ vals,
                                          const float* __restrict__ scales,
                                          long long rows, int block, Op op) {
  const int lane = threadIdx.x & 31;
  const int nvec = block / V;
  for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * WARPS) {
    const float scale = __ldg(scales + row);
    const long long base = row * block;
    for (int i = lane; i < nvec; i += 32) {
      const long long o = base + (long long)i * V;
      float g[V];
      load_codes<V>(vals + o, g);
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = __fmul_rn(g[j], scale);
      op(o, g);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    dequantize_kernel(const int8_t* __restrict__ vals, const float* __restrict__ scales,
                      float* __restrict__ out, long long rows, int block) {
  walk_rows<V>(vals, scales, rows, block,
               [&](long long o, float (&g)[V]) { store_f32<V>(out + o, g); });
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    fused_sgd0_kernel(const int8_t* __restrict__ vals, const float* __restrict__ scales,
                      float* __restrict__ delta, float lr, long long rows, int block) {
  const float neg_lr = -lr;
  walk_rows<V>(vals, scales, rows, block, [&](long long o, float (&g)[V]) {
    float d[V];
#pragma unroll
    for (int j = 0; j < V; ++j) d[j] = __fmul_rn(neg_lr, g[j]);
    store_f32<V>(delta + o, d);
  });
}

// mom and new_mom may be the same array
template <int V>
__global__ void __launch_bounds__(THREADS)
    fused_sgd_kernel(const int8_t* __restrict__ vals, const float* __restrict__ scales,
                     const float* mom, float* __restrict__ delta, float* new_mom, float lr,
                     float momentum, long long rows, int block) {
  const float neg_lr = -lr;
  walk_rows<V>(vals, scales, rows, block, [&](long long o, float (&g)[V]) {
    float m[V], d[V];
    load_state<V>(mom + o, m);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = __fadd_rn(g[j], __fmul_rn(momentum, m[j]));
      d[j] = __fmul_rn(neg_lr, m[j]);
    }
    store_f32<V>(new_mom + o, m);
    store_f32<V>(delta + o, d);
  });
}

// m/new_m and v/new_v may be the same arrays
template <int V>
__global__ void __launch_bounds__(THREADS)
    fused_adam_kernel(const int8_t* __restrict__ vals, const float* __restrict__ scales,
                      const float* m_in, const float* v_in, float* __restrict__ delta,
                      float* new_m, float* new_v, float lr, float b1, float b2, float eps,
                      float bc1, float bc2, long long rows, int block) {
  const float neg_lr = -lr;
  const float c1 = __fsub_rn(1.0f, b1), c2 = __fsub_rn(1.0f, b2);
  walk_rows<V>(vals, scales, rows, block, [&](long long o, float (&g)[V]) {
    float m[V], v[V], d[V];
    load_state<V>(m_in + o, m);
    load_state<V>(v_in + o, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = __fadd_rn(__fmul_rn(b1, m[j]), __fmul_rn(c1, g[j]));
      v[j] = __fadd_rn(__fmul_rn(b2, v[j]), __fmul_rn(__fmul_rn(c2, g[j]), g[j]));
      d[j] = __fdiv_rn(__fmul_rn(neg_lr, __fdiv_rn(m[j], bc1)),
                       __fadd_rn(__fsqrt_rn(__fdiv_rn(v[j], bc2)), eps));
    }
    store_f32<V>(new_m + o, m);
    store_f32<V>(new_v + o, v);
    store_f32<V>(delta + o, d);
  });
}

bool aligned(const void* p, unsigned bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

unsigned grid_for(long long rows) {
  const long long g = (rows + WARPS - 1) / WARPS;
  return (unsigned)(g < (1LL << 20) ? g : (1LL << 20));  // grid-stride beyond
}

template <typename T, int V, bool EF>
void launch_rows(const T* x, int8_t* vals, float* scales, float* res, long long rows, int block,
                 cudaStream_t st) {
  const int nvec = block / V;
  const unsigned grid = grid_for(rows);
  if (nvec <= 32)
    quantize_kernel<T, V, 1, EF><<<grid, THREADS, 0, st>>>(x, vals, scales, res, rows, block);
  else if (nvec <= 64)
    quantize_kernel<T, V, 2, EF><<<grid, THREADS, 0, st>>>(x, vals, scales, res, rows, block);
  else if (nvec <= 128)
    quantize_kernel<T, V, 4, EF><<<grid, THREADS, 0, st>>>(x, vals, scales, res, rows, block);
  else  // longer rows are read a second time, from L1/L2
    quantize_kernel<T, V, CAP / V, EF><<<grid, THREADS, 0, st>>>(x, vals, scales, res, rows, block);
}

template <typename T, bool EF>
int launch_quantize(const void* x, int8_t* vals, float* scales, float* res, long long rows,
                    int block, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = block % V == 0 && aligned(x, 16) && aligned(vals, V) && aligned(res, 16);
  const T* xt = static_cast<const T*>(x);
  if (vec)
    launch_rows<T, V, EF>(xt, vals, scales, res, rows, block, st);
  else
    launch_rows<T, 1, EF>(xt, vals, scales, res, rows, block, st);
  return (int)cudaGetLastError();
}

template <bool EF>
int quantize_entry(const void* x, int8_t* vals, float* scales, float* res, long long rows,
                   int block, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return 0;
  if (block <= 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_quantize<float, EF>(x, vals, scales, res, rows, block, st);
  if (dtype == 1) return launch_quantize<bf16, EF>(x, vals, scales, res, rows, block, st);
  return (int)cudaErrorInvalidValue;
}

// the elementwise kernels take 4-wide pieces when every row starts aligned
bool vec4(int block, const void* vals, std::initializer_list<const void*> f32) {
  if (block % 4 != 0 || !aligned(vals, 4)) return false;
  for (const void* p : f32)
    if (!aligned(p, 16)) return false;
  return true;
}

int prepare(int device, long long rows, int block) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0 && block <= 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x: [rows, block] contiguous, fp32 (dtype 0) or bf16 (dtype 1); vals int8 and
// res fp32 [rows, block], scales fp32 [rows]. Each entry returns
// cudaGetLastError() after its launch (0 on success) and launches nothing for
// rows == 0.
extern "C" int quantize(const void* x, int8_t* vals, float* scales, long long rows, int block,
                        int dtype, int device, void* stream) {
  return quantize_entry<false>(x, vals, scales, nullptr, rows, block, dtype, device, stream);
}

extern "C" int quantize_ef(const void* x, int8_t* vals, float* scales, float* res,
                           long long rows, int block, int dtype, int device, void* stream) {
  return quantize_entry<true>(x, vals, scales, res, rows, block, dtype, device, stream);
}

extern "C" int dequantize(const int8_t* vals, const float* scales, float* out, long long rows,
                          int block, int device, void* stream) {
  if (int e = prepare(device, rows, block)) return e;
  if (rows <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (vec4(block, vals, {out}))
    dequantize_kernel<4><<<grid_for(rows), THREADS, 0, st>>>(vals, scales, out, rows, block);
  else
    dequantize_kernel<1><<<grid_for(rows), THREADS, 0, st>>>(vals, scales, out, rows, block);
  return (int)cudaGetLastError();
}

extern "C" int fused_sgd0(const int8_t* vals, const float* scales, float* delta, float lr,
                          long long rows, int block, int device, void* stream) {
  if (int e = prepare(device, rows, block)) return e;
  if (rows <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (vec4(block, vals, {delta}))
    fused_sgd0_kernel<4><<<grid_for(rows), THREADS, 0, st>>>(vals, scales, delta, lr, rows, block);
  else
    fused_sgd0_kernel<1><<<grid_for(rows), THREADS, 0, st>>>(vals, scales, delta, lr, rows, block);
  return (int)cudaGetLastError();
}

extern "C" int fused_sgd(const int8_t* vals, const float* scales, const float* mom, float* delta,
                         float* new_mom, float lr, float momentum, long long rows, int block,
                         int device, void* stream) {
  if (int e = prepare(device, rows, block)) return e;
  if (rows <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (vec4(block, vals, {mom, delta, new_mom}))
    fused_sgd_kernel<4><<<grid_for(rows), THREADS, 0, st>>>(vals, scales, mom, delta, new_mom,
                                                           lr, momentum, rows, block);
  else
    fused_sgd_kernel<1><<<grid_for(rows), THREADS, 0, st>>>(vals, scales, mom, delta, new_mom,
                                                           lr, momentum, rows, block);
  return (int)cudaGetLastError();
}

extern "C" int fused_adam(const int8_t* vals, const float* scales, const float* m,
                          const float* v, float* delta, float* new_m, float* new_v, float lr,
                          float b1, float b2, float eps, float bc1, float bc2, long long rows,
                          int block, int device, void* stream) {
  if (int e = prepare(device, rows, block)) return e;
  if (rows <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (vec4(block, vals, {m, v, delta, new_m, new_v}))
    fused_adam_kernel<4><<<grid_for(rows), THREADS, 0, st>>>(
        vals, scales, m, v, delta, new_m, new_v, lr, b1, b2, eps, bc1, bc2, rows, block);
  else
    fused_adam_kernel<1><<<grid_for(rows), THREADS, 0, st>>>(
        vals, scales, m, v, delta, new_m, new_v, lr, b1, b2, eps, bc1, bc2, rows, block);
  return (int)cudaGetLastError();
}

extern "C" const char* quantize_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
