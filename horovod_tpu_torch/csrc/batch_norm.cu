// Batch normalization in training mode for Hopper (sm_90a): four kernels, two
// for the forward and two for the backward.
//
// Replaces no Pallas kernel: the JAX package's batch norm
// (horovod_tpu/train/sync_batch_norm.py, flax's nn.BatchNorm in the zoo) is
// jnp code that XLA fuses on the TPU. In PyTorch the same code runs as some 25
// elementwise, reduction and cast kernels a layer forward and 16 backward,
// each reading or writing a full fp32 copy of the activations.
//
// What bounds it on the H100: bytes. Each element takes a handful of flops,
// and every pass over a layer's activations (up to 411 MB in bf16 at
// ResNet-50's stem and first stage at batch 256, more than the 50 MB L2)
// moves them through device memory. The least a layer needs is five passes:
// x read and y written forward, x and dy read and dx written backward. This
// design takes eight: the forward statistics read x, the forward normalize
// reads x and writes y, the backward sums read x and dy, the backward input
// gradient reads x and dy and writes dx. No pass writes an fp32 copy, and the
// running averages, mean, variance and rstd are written by the normalize.
//
// Layouts. The activations are seen as [N, C, S]. Layout 0 has the channels
// innermost (S 1, rows M = N·S): channels_last NCHW, or [..., C]. Each thread
// owns VEC channels of a 128-byte row segment (16-byte loads, 8 threads a
// segment) and walks rows; a CTA is a tile of those channels by 256/tx rows.
// Layout 1 has S innermost (NCHW-contiguous, [N, C, L]); a CTA owns one
// channel and its threads walk S in 16-byte vectors. Either way the grid is
// (channel tiles, strips of rows): the host picks enough strips to fill the
// card (four CTAs an SM forward, two backward: the best of 1 to 8 over
// ResNet-50's layers) from the shape it sees.
//
// Reductions are deterministic. A thread sums its rows in order, a CTA sums
// its threads in a fixed order and writes one partial per value to a scratch
// buffer, and the last CTA of a channel tile (a counter and __threadfence)
// sums the partials in strip order. No float atomics. The counter is reset by
// that last CTA, so the next launch on the stream finds it at zero.
//
// Arithmetic: every sum is taken in fp64 (the elements and their products
// are exact in it) and stays fp64 through the cross-rank
// all-reduce; the normalize and the input gradient round the sums to the
// statistics' dtype (fp32, fp64 for fp64 input) first. So the sums hardly
// depend on how the rows were split, over CTAs or over ranks: a batch split
// over two ranks normalizes with the statistics one process would take, as
// the plain PyTorch sums nearly do (a near-cancelling sum, a BN bias's
// gradient, showed the difference). From there the elementwise formulas are
// the plain PyTorch version's, operation for operation, each rounded on its
// own (__fmul_rn and friends: nvcc would contract a product and a sum into
// an FMA), so from the same rounded sums both give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int THREADS = 256;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(f16 v) { return __half2float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  __device__ static float from(float v) { return v; }
};
template <> struct Cvt<bf16> {
  __device__ static bf16 from(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Cvt<f16> {
  __device__ static f16 from(float v) { return __float2half_rn(v); }
};
template <> struct Cvt<double> {
  __device__ static double from(double v) { return v; }
};

// IEEE operations rounded one at a time, as PyTorch's elementwise kernels do
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
// torch.rsqrt on the card is ::rsqrt, which is rsqrtf for fp32
__device__ __forceinline__ float rsqrt_(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_(double a) { return rsqrt(a); }

__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }

// VEC elements moved as one access: 16 bytes, or less on the scalar path.
// The copies go through integer vector types, so each is one vector
// instruction.
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <int N, typename T>
__device__ __forceinline__ Pack<T, N> ld(const T* p) {
  constexpr int B = sizeof(T) * N, W = B < 16 ? B : 16;
  using R = typename Raw<W>::type;
  Pack<T, N> out;
#pragma unroll
  for (int i = 0; i < B / W; ++i)
    reinterpret_cast<R*>(&out)[i] = reinterpret_cast<const R*>(p)[i];
  return out;
}

template <int N, typename T>
__device__ __forceinline__ void st(T* p, const Pack<T, N>& v) {
  constexpr int B = sizeof(T) * N, W = B < 16 ? B : 16;
  using R = typename Raw<W>::type;
#pragma unroll
  for (int i = 0; i < B / W; ++i)
    reinterpret_cast<R*>(p)[i] = reinterpret_cast<const R*>(&v)[i];
}

// The geometry of a launch. rows is M (layout 0) or N (layout 1), S the
// inner size (1 in layout 0), rps the rows of a strip (blockIdx.y), tx the
// threads along C (layout 0) or S (layout 1); ty = THREADS / tx along rows.
struct Geo {
  long long rows, S, rps;
  int C, tx;
};

// One CTA's two sums a value, (a, b), reduced over its threads and written
// as this strip's partials; the last CTA of the channel tile then sums the
// partials of every strip in order into out[0:C] and out[C:2C] (and n into
// out[2C] when n_out). Layout 0: a thread's VEC values are VEC channels;
// layout 1: the whole CTA is one channel (blockIdx.x). Every sum is fp64.
template <int L, int VEC>
__device__ __forceinline__ void reduce_finish(const double (&a)[VEC], const double (&b)[VEC],
                                              double* part, unsigned* counters, double* out,
                                              const Geo& g, bool n_out) {
  __shared__ double red[2 * THREADS * (L == 0 ? VEC : 1)];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long C = g.C;
  const int tile = L == 0 ? g.tx * VEC : 1;     // channels of this CTA
  const long long cbase = (long long)blockIdx.x * tile;
  double* mine = part + (long long)blockIdx.y * 2 * C;

  if (L == 0) {
    const int ty = THREADS / g.tx, txi = tid % g.tx, tyi = tid / g.tx;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[tyi * tile + txi * VEC + j] = a[j];
      red[(ty + tyi) * tile + txi * VEC + j] = b[j];
    }
    __syncthreads();
    if (tid < 2 * tile) {
      const int q = tid / tile, w = tid % tile;
      double s = 0;
      for (int k = 0; k < ty; ++k) s += red[(q * ty + k) * tile + w];
      if (cbase + w < C) mine[q * C + cbase + w] = s;
    }
  } else {
    double sa = 0, sb = 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sa += a[j];
      sb += b[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    const int warp = tid / 32, lane = tid % 32;
    if (lane == 0) {
      red[warp] = sa;
      red[THREADS / 32 + warp] = sb;
    }
    __syncthreads();
    if (tid < 2) {
      double s = 0;
      for (int w = 0; w < THREADS / 32; ++w) s += red[tid * (THREADS / 32) + w];
      mine[tid * C + cbase] = s;
    }
  }

  // the last CTA of this channel tile to get here sums every strip's partials
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) counters[blockIdx.x] = 0;

  const int nv = 2 * tile;              // values: q * tile + w
  const int groups = THREADS / nv;      // threads a value, over the strips
  const int strips = gridDim.y;
  if (tid < nv * groups) {
    const int v = tid % nv, grp = tid / nv;
    const int q = v / tile, w = v % tile;
    double s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    if (cbase + w < C) {
      const double* p = part + q * C + cbase + w;
      const long long step = 2 * C;
      int s = grp;
      for (; s + 3 * groups < strips; s += 4 * groups) {
        s0 += ldcg(p + s * step);
        s1 += ldcg(p + (s + groups) * step);
        s2 += ldcg(p + (s + 2 * groups) * step);
        s3 += ldcg(p + (s + 3 * groups) * step);
      }
      for (; s < strips; s += groups) s0 += ldcg(p + s * step);
    }
    red[grp * nv + v] = (s0 + s1) + (s2 + s3);
  }
  __syncthreads();
  if (tid < nv) {
    const int q = tid / tile, w = tid % tile;
    double s = 0;
    for (int grp = 0; grp < groups; ++grp) s += red[grp * nv + tid];
    if (cbase + w < C) out[q * C + cbase + w] = s;
  }
  if (n_out && blockIdx.x == 0 && tid == 0) out[2 * C] = (double)(g.rows * g.S);
}

// ---- forward statistics: out = [Σx (C), Σx² (C), n] -------------------------

template <int L, int VEC, typename T>
__global__ void __launch_bounds__(THREADS)
    bn_stats_kernel(const T* __restrict__ x, double* part,
                    unsigned* counters, double* out, Geo g) {
  using A = typename AccOf<T>::type;
  double s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0;
  const int tid = threadIdx.x, tx = g.tx, ty = THREADS / tx;
  const int txi = tid % tx, tyi = tid / tx;
  const long long r0 = (long long)blockIdx.y * g.rps;
  const long long r1 = min(r0 + g.rps, g.rows);
  const long long C = g.C;

  if (L == 0) {
    const long long c0 = ((long long)blockIdx.x * tx + txi) * VEC;
    if (c0 < C) {
      long long r = r0 + tyi;
      for (; r + 3 * ty < r1; r += 4 * ty) {
        Pack<T, VEC> p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] = ld<VEC>(x + (r + k * ty) * C + c0);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const double v = to_acc(p[k].v[j]);
            s1[j] += v;
            s2[j] = fma(v, v, s2[j]);
          }
      }
      for (; r < r1; r += ty) {
        const Pack<T, VEC> p = ld<VEC>(x + r * C + c0);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const double v = to_acc(p.v[j]);
          s1[j] += v;
          s2[j] = fma(v, v, s2[j]);
        }
      }
    }
  } else {
    const long long c = blockIdx.x;
    for (long long n = r0 + tyi; n < r1; n += ty) {
      const T* row = x + (n * C + c) * g.S;
#pragma unroll 4
      for (long long s = (long long)txi * VEC; s < g.S; s += (long long)tx * VEC) {
        const Pack<T, VEC> p = ld<VEC>(row + s);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const double v = to_acc(p.v[j]);
          s1[j] += v;
          s2[j] = fma(v, v, s2[j]);
        }
      }
    }
  }
  reduce_finish<L, VEC>(s1, s2, part, counters, out, g, true);
}

// ---- forward normalize: y, [mean, var, rstd], the running averages ------------

template <typename A>
struct Running {
  A* mean;      // null: leave the running averages alone
  A* var;
  A keep, take; // new = keep·old + take·batch
  int unbiased; // the variance times n/(n−1) first
};

// mean, var, rstd and scale·rstd of channel c from the statistics vector, as
// the plain version computes them
template <typename A>
__device__ __forceinline__ void channel_consts(const double* stats, const A* scale, A eps,
                                               long long C, long long c, A& mean,
                                               A& var, A& rstd, A& mul) {
  const A n = (A)stats[2 * C];
  mean = div_rn((A)stats[c], n);
  var = sub_rn(div_rn((A)stats[C + c], n), mul_rn(mean, mean));
  var = var < (A)0 ? (A)0 : var;   // clamp_min, NaN kept
  rstd = rsqrt_(add_rn(var, eps));
  mul = mul_rn(rstd, scale[c]);
}

template <typename A>
__device__ __forceinline__ void write_channel(A* mvr, const Running<A>& run, const double* stats,
                                              long long C, long long c, A mean, A var,
                                              A rstd) {
  mvr[c] = mean;
  mvr[C + c] = var;
  mvr[2 * C + c] = rstd;
  if (run.mean != nullptr) {
    A v = var;
    if (run.unbiased) {
      const A n = (A)stats[2 * C];
      v = mul_rn(var, n > (A)1 ? div_rn(n, sub_rn(n, (A)1)) : (A)1);
    }
    run.mean[c] = add_rn(mul_rn(run.mean[c], run.keep), mul_rn(run.take, mean));
    run.var[c] = add_rn(mul_rn(run.var[c], run.keep), mul_rn(run.take, v));
  }
}

template <int L, int VEC, typename T>
__global__ void __launch_bounds__(THREADS)
    bn_normalize_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const double* __restrict__ stats,
                    const typename AccOf<T>::type* __restrict__ scale,
                    const typename AccOf<T>::type* __restrict__ bias,
                    typename AccOf<T>::type* __restrict__ mvr,
                    Running<typename AccOf<T>::type> run,
                    typename AccOf<T>::type eps, Geo g) {
  using A = typename AccOf<T>::type;
  const int tid = threadIdx.x, tx = g.tx, ty = THREADS / tx;
  const int txi = tid % tx, tyi = tid / tx;
  const long long r0 = (long long)blockIdx.y * g.rps;
  const long long r1 = min(r0 + g.rps, g.rows);
  const long long C = g.C;

  if (L == 0) {
    const long long c0 = ((long long)blockIdx.x * tx + txi) * VEC;
    if (c0 >= C) return;
    A mean[VEC], mul[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      A var, rstd;
      channel_consts(stats, scale, eps, C, c0 + j, mean[j], var, rstd, mul[j]);
      b[j] = bias[c0 + j];
      if (blockIdx.y == 0 && tyi == 0) write_channel(mvr, run, stats, C, c0 + j, mean[j], var, rstd);
    }
    long long r = r0 + tyi;
    for (; r + 3 * ty < r1; r += 4 * ty) {
      Pack<T, VEC> p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) p[k] = ld<VEC>(x + (r + k * ty) * C + c0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Pack<T, VEC> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = Cvt<T>::from(
              add_rn(mul_rn(sub_rn(to_acc(p[k].v[j]), mean[j]), mul[j]), b[j]));
        st<VEC>(y + (r + k * ty) * C + c0, o);
      }
    }
    for (; r < r1; r += ty) {
      const Pack<T, VEC> p = ld<VEC>(x + r * C + c0);
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = Cvt<T>::from(add_rn(mul_rn(sub_rn(to_acc(p.v[j]), mean[j]), mul[j]), b[j]));
      st<VEC>(y + r * C + c0, o);
    }
  } else {
    const long long c = blockIdx.x;
    A mean, var, rstd, mul;
    channel_consts(stats, scale, eps, C, c, mean, var, rstd, mul);
    const A b = bias[c];
    if (blockIdx.y == 0 && tid == 0) write_channel(mvr, run, stats, C, c, mean, var, rstd);
    for (long long n = r0 + tyi; n < r1; n += ty) {
      const long long base = (n * C + c) * g.S;
#pragma unroll 4
      for (long long s = (long long)txi * VEC; s < g.S; s += (long long)tx * VEC) {
        const Pack<T, VEC> p = ld<VEC>(x + base + s);
        Pack<T, VEC> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = Cvt<T>::from(add_rn(mul_rn(sub_rn(to_acc(p.v[j]), mean), mul), b));
        st<VEC>(y + base + s, o);
      }
    }
  }
}

// ---- backward sums: out = [Σdy (C), Σdy·x̂ (C)], x̂ = (x − mean)·rstd ----------

template <int L, int VEC, typename T>
__global__ void __launch_bounds__(THREADS)
    bn_grad_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const typename AccOf<T>::type* __restrict__ mean_,
                        const typename AccOf<T>::type* __restrict__ rstd_,
                        double* part, unsigned* counters,
                        double* out, Geo g) {
  using A = typename AccOf<T>::type;
  double s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0;
  const int tid = threadIdx.x, tx = g.tx, ty = THREADS / tx;
  const int txi = tid % tx, tyi = tid / tx;
  const long long r0 = (long long)blockIdx.y * g.rps;
  const long long r1 = min(r0 + g.rps, g.rows);
  const long long C = g.C;

  if (L == 0) {
    const long long c0 = ((long long)blockIdx.x * tx + txi) * VEC;
    if (c0 < C) {
      A mean[VEC], rstd[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        mean[j] = mean_[c0 + j];
        rstd[j] = rstd_[c0 + j];
      }
      long long r = r0 + tyi;
      for (; r + 3 * ty < r1; r += 4 * ty) {
        Pack<T, VEC> p[4];
        Pack<T, VEC> d[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          p[k] = ld<VEC>(x + (r + k * ty) * C + c0);
          d[k] = ld<VEC>(dy + (r + k * ty) * C + c0);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const double dv = to_acc(d[k].v[j]);
            s1[j] += dv;
            s2[j] = fma(dv, (double)mul_rn(sub_rn(to_acc(p[k].v[j]), mean[j]), rstd[j]),
                        s2[j]);
          }
      }
      for (; r < r1; r += ty) {
        const Pack<T, VEC> p = ld<VEC>(x + r * C + c0);
        const Pack<T, VEC> d = ld<VEC>(dy + r * C + c0);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const double dv = to_acc(d.v[j]);
          s1[j] += dv;
          s2[j] = fma(dv, (double)mul_rn(sub_rn(to_acc(p.v[j]), mean[j]), rstd[j]), s2[j]);
        }
      }
    }
  } else {
    const long long c = blockIdx.x;
    const A mean = mean_[c], rstd = rstd_[c];
    for (long long n = r0 + tyi; n < r1; n += ty) {
      const long long base = (n * C + c) * g.S;
#pragma unroll 4
      for (long long s = (long long)txi * VEC; s < g.S; s += (long long)tx * VEC) {
        const Pack<T, VEC> p = ld<VEC>(x + base + s);
        const Pack<T, VEC> d = ld<VEC>(dy + base + s);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const double dv = to_acc(d.v[j]);
          s1[j] += dv;
          s2[j] = fma(dv, (double)mul_rn(sub_rn(to_acc(p.v[j]), mean), rstd), s2[j]);
        }
      }
    }
  }
  reduce_finish<L, VEC>(s1, s2, part, counters, out, g, false);
}

// ---- backward input gradient: dx = (dy − Σdy/n − x̂·Σdy·x̂/n)·rstd·scale ------

template <typename A>
__device__ __forceinline__ void grad_consts(const A* mean_, const A* rstd_, const A* scale,
                                            const double* glob, A n, long long C, long long c,
                                            A& mean, A& rstd, A& sdy, A& sdyx, A& k) {
  mean = mean_[c];
  rstd = rstd_[c];
  sdy = div_rn((A)glob[c], n);
  sdyx = div_rn((A)glob[C + c], n);
  k = mul_rn(rstd, scale[c]);
}

template <typename A>
__device__ __forceinline__ A grad_at(A xv, A dv, A mean, A rstd, A sdy, A sdyx, A k) {
  const A xh = mul_rn(sub_rn(xv, mean), rstd);
  return mul_rn(sub_rn(sub_rn(dv, sdy), mul_rn(xh, sdyx)), k);
}

template <int L, int VEC, typename T>
__global__ void __launch_bounds__(THREADS)
    bn_grad_input_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         T* __restrict__ dx,
                         const typename AccOf<T>::type* __restrict__ mean_,
                         const typename AccOf<T>::type* __restrict__ rstd_,
                         const typename AccOf<T>::type* __restrict__ scale,
                         const double* __restrict__ glob,
                         const double* __restrict__ n_ptr, Geo g) {
  using A = typename AccOf<T>::type;
  const int tid = threadIdx.x, tx = g.tx, ty = THREADS / tx;
  const int txi = tid % tx, tyi = tid / tx;
  const long long r0 = (long long)blockIdx.y * g.rps;
  const long long r1 = min(r0 + g.rps, g.rows);
  const long long C = g.C;
  const A n = (A)*n_ptr;

  if (L == 0) {
    const long long c0 = ((long long)blockIdx.x * tx + txi) * VEC;
    if (c0 >= C) return;
    A mean[VEC], rstd[VEC], sdy[VEC], sdyx[VEC], k[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      grad_consts(mean_, rstd_, scale, glob, n, C, c0 + j, mean[j], rstd[j], sdy[j], sdyx[j], k[j]);
    long long r = r0 + tyi;
    for (; r + 3 * ty < r1; r += 4 * ty) {
      Pack<T, VEC> p[4];
      Pack<T, VEC> d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        p[u] = ld<VEC>(x + (r + u * ty) * C + c0);
        d[u] = ld<VEC>(dy + (r + u * ty) * C + c0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        Pack<T, VEC> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = Cvt<T>::from(grad_at(to_acc(p[u].v[j]), to_acc(d[u].v[j]), mean[j],
                                         rstd[j], sdy[j], sdyx[j], k[j]));
        st<VEC>(dx + (r + u * ty) * C + c0, o);
      }
    }
    for (; r < r1; r += ty) {
      const Pack<T, VEC> p = ld<VEC>(x + r * C + c0);
      const Pack<T, VEC> d = ld<VEC>(dy + r * C + c0);
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = Cvt<T>::from(grad_at(to_acc(p.v[j]), to_acc(d.v[j]), mean[j], rstd[j],
                                       sdy[j], sdyx[j], k[j]));
      st<VEC>(dx + r * C + c0, o);
    }
  } else {
    const long long c = blockIdx.x;
    A mean, rstd, sdy, sdyx, k;
    grad_consts(mean_, rstd_, scale, glob, n, C, c, mean, rstd, sdy, sdyx, k);
    for (long long m = r0 + tyi; m < r1; m += ty) {
      const long long base = (m * C + c) * g.S;
#pragma unroll 4
      for (long long s = (long long)txi * VEC; s < g.S; s += (long long)tx * VEC) {
        const Pack<T, VEC> p = ld<VEC>(x + base + s);
        const Pack<T, VEC> d = ld<VEC>(dy + base + s);
        Pack<T, VEC> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = Cvt<T>::from(
              grad_at(to_acc(p.v[j]), to_acc(d.v[j]), mean, rstd, sdy, sdyx, k));
        st<VEC>(dx + base + s, o);
      }
    }
  }
}

// ---- dispatch ----------------------------------------------------------------

template <typename T> struct Tag { using type = T; };
template <int V> struct Int { static constexpr int value = V; };

// dtype codes: 0 fp32, 1 bf16, 2 fp16, 3 fp64
template <typename F>
int with_x(int dt, F f) {
  switch (dt) {
    case 0: return f(Tag<float>{});
    case 1: return f(Tag<bf16>{});
    case 2: return f(Tag<f16>{});
    case 3: return f(Tag<double>{});
  }
  return (int)cudaErrorInvalidValue;
}

// layout 0 or 1; vec 1: 16-byte accesses, 0: one element at a time
template <typename T, typename F>
int with_shape(int layout, int vec, F f) {
  constexpr int V = 16 / sizeof(T);
  if (layout == 0) return vec ? f(Int<0>{}, Int<V>{}) : f(Int<0>{}, Int<1>{});
  if (layout == 1) return vec ? f(Int<1>{}, Int<V>{}) : f(Int<1>{}, Int<1>{});
  return (int)cudaErrorInvalidValue;
}

int prologue(int device) {
  const cudaError_t err = cudaSetDevice(device);
  return err == cudaSuccess ? 0 : (int)err;
}

// geo: rows, S, rows a strip, C, tx, tiles, strips, layout, vec
Geo geometry(const long long* geo) {
  return Geo{geo[0], geo[1], geo[2], (int)geo[3], (int)geo[4]};
}
dim3 grid_of(const long long* geo) { return dim3((unsigned)geo[5], (unsigned)geo[6]); }

}  // namespace

// Every entry: geo, nine integers (rows, S, rows a strip, C, tx, tiles,
// strips, layout, vec) as the host planned them
// (horovod_tpu_torch/ops/batch_norm.plan); the sums ([Σx, Σx², n] and
// [Σdy, Σdy·x̂]), their partials (strips × 2C) and n in fp64; scale, bias,
// mean, var and rstd in the statistics' dtype (fp32, fp64 for fp64 x);
// counters: `tiles` unsigned ints at zero. Returns
// cudaGetLastError() after the launch (0 on success).

extern "C" int bn_stats(const void* x, void* part, void* counters, void* out,
                        const long long* geo, int dtype, int device, void* stream) {
  if (int e = prologue(device)) return e;
  const Geo g = geometry(geo);
  const dim3 grid = grid_of(geo);
  const int layout = (int)geo[7], vec = (int)geo[8];
  auto st_ = static_cast<cudaStream_t>(stream);
  return with_x(dtype, [&](auto t_) {
    using T = typename decltype(t_)::type;
    using A = typename AccOf<T>::type;
    return with_shape<T>(layout, vec, [&](auto l, auto v) {
      bn_stats_kernel<decltype(l)::value, decltype(v)::value, T><<<grid, THREADS, 0, st_>>>(
          static_cast<const T*>(x), static_cast<double*>(part), static_cast<unsigned*>(counters),
          static_cast<double*>(out), g);
      return (int)cudaGetLastError();
    });
  });
}

extern "C" int bn_normalize(const void* x, void* y, const void* stats, const void* scale,
                            const void* bias, void* mvr, void* run_mean, void* run_var,
                            double eps, double keep, double take, int unbiased,
                            const long long* geo, int dtype, int device,
                            void* stream) {
  if (int e = prologue(device)) return e;
  const Geo g = geometry(geo);
  const dim3 grid = grid_of(geo);
  const int layout = (int)geo[7], vec = (int)geo[8];
  auto st_ = static_cast<cudaStream_t>(stream);
  return with_x(dtype, [&](auto t_) {
    using T = typename decltype(t_)::type;
    using A = typename AccOf<T>::type;
    const Running<A> run{static_cast<A*>(run_mean), static_cast<A*>(run_var), (A)keep,
                         (A)take, unbiased};
    return with_shape<T>(layout, vec, [&](auto l, auto v) {
      bn_normalize_kernel<decltype(l)::value, decltype(v)::value, T>
          <<<grid, THREADS, 0, st_>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                      static_cast<const double*>(stats),
                                      static_cast<const A*>(scale),
                                      static_cast<const A*>(bias), static_cast<A*>(mvr),
                                      run, (A)eps, g);
      return (int)cudaGetLastError();
    });
  });
}

extern "C" int bn_grad_sums(const void* x, const void* dy, const void* mean,
                            const void* rstd, void* part, void* counters, void* out,
                            const long long* geo, int dtype, int device,
                            void* stream) {
  if (int e = prologue(device)) return e;
  const Geo g = geometry(geo);
  const dim3 grid = grid_of(geo);
  const int layout = (int)geo[7], vec = (int)geo[8];
  auto st_ = static_cast<cudaStream_t>(stream);
  return with_x(dtype, [&](auto t_) {
    using T = typename decltype(t_)::type;
    using A = typename AccOf<T>::type;
    return with_shape<T>(layout, vec, [&](auto l, auto v) {
      bn_grad_sums_kernel<decltype(l)::value, decltype(v)::value, T>
          <<<grid, THREADS, 0, st_>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                      static_cast<const A*>(mean),
                                      static_cast<const A*>(rstd), static_cast<double*>(part),
                                      static_cast<unsigned*>(counters),
                                      static_cast<double*>(out), g);
      return (int)cudaGetLastError();
    });
  });
}

extern "C" int bn_grad_input(const void* x, const void* dy, void* dx, const void* mean,
                             const void* rstd, const void* scale, const void* glob,
                             const void* n, const long long* geo, int dtype,
                             int device, void* stream) {
  if (int e = prologue(device)) return e;
  const Geo g = geometry(geo);
  const dim3 grid = grid_of(geo);
  const int layout = (int)geo[7], vec = (int)geo[8];
  auto st_ = static_cast<cudaStream_t>(stream);
  return with_x(dtype, [&](auto t_) {
    using T = typename decltype(t_)::type;
    using A = typename AccOf<T>::type;
    return with_shape<T>(layout, vec, [&](auto l, auto v) {
      bn_grad_input_kernel<decltype(l)::value, decltype(v)::value, T>
          <<<grid, THREADS, 0, st_>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                      static_cast<T*>(dx), static_cast<const A*>(mean),
                                      static_cast<const A*>(rstd),
                                      static_cast<const A*>(scale),
                                      static_cast<const double*>(glob),
                                      static_cast<const double*>(n), g);
      return (int)cudaGetLastError();
    });
  });
}

extern "C" const char* batch_norm_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
