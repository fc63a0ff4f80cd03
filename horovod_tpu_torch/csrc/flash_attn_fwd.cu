// Flash attention forward for Hopper (sm_90a), with the log-sum-exp residual.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (horovod_tpu/ops/pallas_attention.py).
// Same function: causal or full attention over q/k/v [B, S, H, D], an online
// softmax (running max m, running sum l, accumulator acc) kept in fp32, key tiles
// above the diagonal skipped, and the outputs o [B, Sq, H, D] and
// lse = m + log(max(l, 1e-30)) laid out [B*H, Sq] as the JAX package lays it out.
//
// What bounds it on the H100: at the flagship shape (B 8, S 256, H 8, D 64, bf16,
// causal) it moves about 8.4 MB and does 0.54 GFLOP of matrix products, so the
// card's floor is the memory, about 2.5 us. A simple tiled kernel is far from that
// floor: it is bound by shared-memory traffic and by the serial softmax between the
// two products, not by device memory. The design keeps device traffic at the floor
// (each q tile read once, each k/v tile once per q tile, o and lse written once,
// no transpose copy: the kernel reads [B, S, H, D] through its strides) and puts
// the two products of the bf16 path on the tensor cores (WMMA 16x16x16, fp32
// accumulation). The fp32 path does them with scalar FMAs, so that it agrees with
// the plain version to fp32 rounding. wgmma, TMA and a pipelined k/v ring are later
// work.
//
// Layout of the work: one block of 4 warps per (b*h, 64-row q tile); the TPU's
// sequential k grid axis is the loop inside the block. Each warp owns 16 q rows;
// inside a warp, lanes 2r and 2r+1 share row r's softmax state and each holds half
// of that row's scores and of its accumulator. Blocks are issued heaviest q tile
// first, which evens out the causal triangle across the SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;               // q rows per block
constexpr int BK = 64;               // keys per tile
constexpr int WARPS = 4;             // each warp owns WROWS q rows
constexpr int WROWS = BQ / WARPS;    // 16: one WMMA tile high
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;    // the Pallas kernel's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory: the q, k and v tiles and the probability tile, all in the input
// type with rows padded by 16 bytes (against bank conflicts; WMMA needs 32-byte
// aligned 16-row blocks, which the padding keeps), and for the bf16 path an fp32
// scratch where a warp's WMMA results are spilled for the per-row softmax.
template <typename T, int D>
struct Layout {
  static constexpr bool kMma = std::is_same<T, bf16>::value;
  static constexpr int VEC = 16 / sizeof(T);       // elements in 16 bytes
  static constexpr int LD = D + VEC;                // q/k/v tile row stride
  static constexpr int LDP = BK + VEC;              // probability tile row stride
  static constexpr int LDS = (D > BK ? D : BK) + 4; // fp32 scratch row stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(T) * BQ * LD);
  static constexpr size_t v_off = align128(k_off + sizeof(T) * BK * LD);
  static constexpr size_t p_off = align128(v_off + sizeof(T) * BK * LD);
  static constexpr size_t s_off = align128(p_off + sizeof(T) * BQ * LDP);
  static constexpr size_t bytes =
      align128(s_off + (kMma ? sizeof(float) * BQ * LDS : 0));
};

struct Strides {
  long long b, s, h;  // in elements; the last dim is contiguous
};

// rows x D elements of sequence rows s0.. of (b, h) into a tile; rows at or past S
// are zero, so a ragged edge adds nothing to a product.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, Strides st, int b,
                                          int h, int s0, int S, int rows) {
  using L = Layout<T, D>;
  constexpr int CH = D / L::VEC;
  const T* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * L::VEC;
    const int s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(base + s * st.s + c);
    *reinterpret_cast<uint4*>(dst + r * L::LD + c) = val;
  }
}

// Raw scores of this lane's half row: s[j] = q[r] . k[c] for c = half + 2j.
template <typename T, int D>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* Sw,
                                       int warp, int r, int half, float* s) {
  using L = Layout<T, D>;
  if constexpr (L::kMma) {
    using namespace nvcuda;
    // S_w [16 x 64] = Q[warp rows, :] . K[0:64, :]^T, spilled to the warp's scratch
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, Qs + warp * WROWS * L::LD + kk, L::LD);
        wmma::load_matrix_sync(bm, Ks + n * 16 * L::LD + kk, L::LD);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(Sw + n * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
    const float* row = Sw + (r % WROWS) * L::LDS;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = row[half + 2 * j];
  } else {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.0f;
    const T* qr = Qs + r * L::LD;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = to_f(qr[d]);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        s[j] = fmaf(qd, to_f(Ks[(half + 2 * j) * L::LD + d]), s[j]);
    }
  }
}

// acc[i] = acc[i] * alpha + (P . V)[r, half + 2i]
template <typename T, int D>
__device__ __forceinline__ void accumulate(const T* Ps, const T* Vs, float* Sw,
                                           int warp, int r, int half, float alpha,
                                           float* acc) {
  using L = Layout<T, D>;
  if constexpr (L::kMma) {
    using namespace nvcuda;
    // PV_w [16 x D] = P[warp rows, 0:64] . V[0:64, :], spilled to the scratch
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, Ps + warp * WROWS * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(bm, Vs + kk * L::LD + n * 16, L::LD);
        wmma::mma_sync(c, a, bm, c);
      }
      wmma::store_matrix_sync(Sw + n * 16, c, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
    const float* row = Sw + (r % WROWS) * L::LDS;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(acc[i], alpha, row[half + 2 * i]);
  } else {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha;
    const T* pr = Ps + r * L::LDP;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float pc = to_f(pr[c]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        acc[i] = fmaf(pc, to_f(Vs[c * L::LD + half + 2 * i]), acc[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk, Strides sq,
                     Strides sk, Strides sv, int causal, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * WROWS + lane / 2;  // this lane's row in the tile
  const int half = lane & 1;
  const int qpos = q0 + r;
  float* Sw = reinterpret_cast<float*>(smem + L::s_off) + warp * WROWS * L::LDS;

  load_tile<T, D>(Qs, q, sq, b, h, q0, Sq, BQ);

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // stop at the diagonal

  float m = NEG_INF, l = 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<T, D>(Ks, k, sk, b, h, k0, Sk, BK);
    load_tile<T, D>(Vs, v, sv, b, h, k0, Sk, BK);
    __syncthreads();

    float s[BK / 2];
    scores<T, D>(Qs, Ks, Sw, warp, r, half, s);

    // scale, mask (causal and the ragged key edge), then the online softmax;
    // the first tile always holds key 0, so every row has a live score there
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int kpos = k0 + half + 2 * j;
      const bool live = kpos < Sk && (!causal || kpos <= qpos);
      s[j] = live ? s[j] * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_next = fmaxf(m, mx);
    const float alpha = expf(m - m_next);
    T* prow = Ps + r * L::LDP;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const T p = from_f<T>(expf(s[j] - m_next));
      prow[half + 2 * j] = p;
      rs += to_f(p);  // sum what the product will use
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_next;
    __syncwarp();  // the warp's probability rows are complete
    accumulate<T, D>(Ps, Vs, Sw, warp, r, half, alpha, acc);
  }

  // finalize as the Pallas kernel does; the warp's own q rows are free now, so
  // they stage o for a coalesced store
  const float l_safe = fmaxf(l, 1e-30f);
  __syncwarp();
  T* orow = Qs + r * L::LD;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) orow[half + 2 * i] = from_f<T>(acc[i] / l_safe);
  if (half == 0 && qpos < Sq) lse[(long long)bh * Sq + qpos] = m + logf(l_safe);
  __syncwarp();
  constexpr int CH = D / L::VEC;
  for (int i = lane; i < WROWS * CH; i += 32) {
    const int rr = warp * WROWS + i / CH, c = (i % CH) * L::VEC;
    const int s = q0 + rr;
    if (s < Sq)
      *reinterpret_cast<uint4*>(o + (((long long)b * Sq + s) * H + h) * D + c) =
          *reinterpret_cast<const uint4*>(Qs + rr * L::LD + c);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int H, int Sq, int Sk, Strides sq, Strides sk, Strides sv, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Sq, Sk, sq, sk, sv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H, D] with the given element strides (last dim contiguous,
// every stride and pointer 16-byte aligned); o: contiguous [B, Sq, H, D];
// lse: contiguous fp32 [B*H, Sq]. dtype 0 is fp32, 1 is bf16; D is 64 or 128.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              float* lse, int B, int H, int Sq, int Sk, int D,
                              int dtype, long long sqb, long long sqs, long long sqh,
                              long long skb, long long sks, long long skh,
                              long long svb, long long svs, long long svh,
                              int causal, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch<bf16, 64>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv, causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch<bf16, 128>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv, causal, scale, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv, causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_fwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
