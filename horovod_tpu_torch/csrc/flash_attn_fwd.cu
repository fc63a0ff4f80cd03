// Flash attention forward for Hopper (sm_90a), with the log-sum-exp residual.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (horovod_tpu/ops/pallas_attention.py).
// Same function: causal or full attention over q/k/v [B, S, H, D], an online
// softmax (running max m, running sum l, accumulator acc) kept in fp32, key tiles
// above the diagonal skipped, and the outputs o [B, Sq, H, D] and
// lse = m + log(max(l, 1e-30)) laid out [B*H, Sq] as the JAX package lays it out.
//
// What bounds it on the H100: at the flagship shape (B 8, S 256, H 8, D 64, bf16,
// causal) it moves about 8.4 MB and does 0.54 GFLOP, so the floor is the memory,
// about 2.5 us, and a block's four key tiles in series set its latency. At long
// sequences (S 4096) the products bound it: 68.7 GFLOP, 69.5 us at 989 TFLOP/s.
//
// The bf16 path is built for both. One block per (b*h, 64-row q tile), blocks
// issued heaviest causal tile first:
// - a producer warp loads Q once and streams K and V through a two-stage ring in
//   shared memory with TMA (tensor maps over the strided [B, S, H, D] layout, so no
//   transpose copy; rows past S arrive as zeros). Each copy completes on an
//   mbarrier, so key tile k+1 is in flight while tile k is computed;
// - one consumer warpgroup computes S = Q.K^T with wgmma.m64n64k16 from the
//   128-byte-swizzled tiles, holds S in registers (32 fp32 a thread: rows r and
//   r+8, 16 columns each), runs the online softmax there in the exp2 domain
//   (scale*log2(e) folded into one FFMA; the mask only on the diagonal tile and the
//   ragged key edge; exp2 is the hardware's ex2.approx.ftz), converts P to bf16
//   in registers and feeds it to wgmma.m64nDk16 as the register A operand against
//   V read as a transposed B. O stays in registers (D/2 fp32 a thread); nothing
//   round-trips through shared memory but the tiles themselves. The scores of
//   tile k are issued before P.V of tile k-1, so the softmax of tile k runs while
//   that product is on the tensor cores;
// - the epilogue divides by l, stages o in the freed Q buffer for 16-byte stores
//   and writes lse converted back to the natural log.
// The fp32 path (fp32 parity, not the main path) keeps scalar FMAs and plain
// loads in a kernel of its own.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;              // q rows per block
constexpr int BK = 64;              // keys per tile
constexpr float NEG_INF = -1e30f;   // the Pallas kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;  // in elements; the last dim is contiguous
};

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, register-resident softmax
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;                      // K/V ring depth
constexpr int CONSUMERS = 128;                 // one warpgroup
constexpr int THREADS_BF16 = CONSUMERS + 32;   // and one producer warp
constexpr int PANEL_COLS = 64;                 // bf16 columns in one 128-byte row
constexpr int PANEL = BQ * PANEL_COLS * 2;     // 8 KB: 64 rows of 128 bytes
static_assert(BQ == BK, "the ring's tiles and the Q tile share one layout");

// A 64-row tile of D columns is D/64 panels, each 64 rows x 128 bytes in the
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)): what TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B and what a wgmma descriptor of layout
// type 1 reads. Every panel starts on a 1024-byte boundary.
template <int D>
struct Ring {
  static constexpr int TILE = (D / PANEL_COLS) * PANEL;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + TILE;
  static constexpr int v_off = k_off + STAGES * TILE;
  static constexpr int bar_off = v_off + STAGES * TILE;  // Q, full K/V, empty K/V
  static constexpr int n_bars = 1 + 4 * STAGES;
  static constexpr int bytes = bar_off + 8 * n_bars + 1024;  // + room to align to 1024
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A copy or an arrival
// that never comes is a fault: trap after some seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One 64-column panel of 64 rows: coordinates (d0, h, s0, b), innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte offsets
// (16-byte units), layout type 1 = 128-byte swizzle. Base offset 0: every swizzle
// atom (8 rows x 128 bytes) starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
#define WG_F32(i) WG_F16(i), WG_F16(i + 16)
#define WG_R32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "   \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "   \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "    \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "    \
  "%62, %63}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : WG_F32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major in shared.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : WG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major in shared.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : WG_F32(0), WG_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// S = Q . K^T into sc, issued and not committed: D/16 steps of 16 columns, each 32
// bytes further into the 128-byte rows of a panel.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[32], uint32_t sQ, uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
    wgmma_ss_n64(sc, wg_desc(sQ + off, 16, 1024), wg_desc(sK + off, 16, 1024),
                 kk > 0);
  }
}

// O += P . V, issued and not committed: 4 steps of 16 keys (16 rows of 128 bytes);
// V is the B operand read transposed, its panels LBO apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[16],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = wg_desc(sV + kk * 16 * 128, PANEL, 1024);
    if constexpr (D == 64)
      wgmma_rs_n64(acc, pa + 4 * kk, dv);
    else
      wgmma_rs_n128(acc, pa + 4 * kk, dv);
  }
}

// P in bf16 as the A operand: the score fragment of columns 16kk..16kk+15 is
// exactly the A fragment of k-step kk.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[16], const float (&sc)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// Accumulator layout of wgmma m64nN (per warp w of the warpgroup, lane t):
// element 4j+e sits at row 16w + t/4 + 8*(e/2), column 8j + 2*(t%4) + e%2. For
// the scores, j < 8; rows r0 and r0 + 8 are this thread's two rows.
//
// kPos: scale > 0, so the row max of the raw scores gives the max of the scaled
// ones and p = exp2(s*scale*log2e - m) is one FFMA; otherwise the scores are
// scaled first. m and l are kept in the log2 domain.
template <bool kPos>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], float sl2,
                                             bool mask, int k0, int Sk, int qrow,
                                             int causal, int c2) {
  if (!kPos) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= sl2;
  }
  // the mask: only the diagonal tile and the tile at the ragged key edge
  if (mask) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kpos = k0 + 8 * (i / 4) + c2 + (i % 2);
      const int qpos = qrow + 8 * ((i / 2) % 2);
      if (kpos >= Sk || (causal && kpos > qpos)) sc[i] = -CUDART_INF_F;
    }
  }
  // the quad of lanes t/4 holds one row pair
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = quad_max(mx);
    const float m_next = fmaxf(m[r], kPos ? mx * sl2 : mx);
    alpha[r] = exp2_approx(m[r] - m_next);
    m[r] = m_next;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        x = exp2_approx(kPos ? fmaf(x, sl2, -m_next) : x - m_next);
        rs += x;
      }
    }
    l[r] = l[r] * alpha[r] + rs;  // this thread's part; the quad sums at the end
  }
}

template <int D, bool kPos>
__global__ void __launch_bounds__(THREADS_BF16, D == 64 ? 3 : 2)
    flash_fwd_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ o, float* __restrict__ lse, int H,
                          int Sq, int Sk, int causal, float sl2) {
  using R = Ring<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t barQ = base + R::bar_off;
  auto fullK = [&](int s) { return barQ + 8u * (1 + s); };
  auto fullV = [&](int s) { return barQ + 8u * (1 + STAGES + s); };
  auto emptyK = [&](int s) { return barQ + 8u * (1 + 2 * STAGES + s); };
  auto emptyV = [&](int s) { return barQ + 8u * (1 + 3 * STAGES + s); };
  auto sK = [&](int s) { return base + R::k_off + s * R::TILE; };
  auto sV = [&](int s) { return base + R::v_off + s * R::TILE; };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, qt + 1);  // stop at the diagonal

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(fullK(s), 1);
      mbar_init(fullV(s), 1);
      mbar_init(emptyK(s), CONSUMERS / 32);  // one arrival per consumer warp
      mbar_init(emptyV(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // -- producer: one lane issues every copy
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(barQ, R::TILE);
#pragma unroll
      for (int p = 0; p < D / PANEL_COLS; ++p)
        tma_load(base + R::q_off + p * PANEL, &tq, barQ, p * PANEL_COLS, h, q0, b);
      // a stage's K and V are freed apart: K once the scores are in, V once
      // P.V is done
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const uint32_t parity = ((kt / STAGES) - 1) & 1;
        if (kt >= STAGES) mbar_wait(emptyK(s), parity);
        mbar_expect_tx(fullK(s), R::TILE);
#pragma unroll
        for (int p = 0; p < D / PANEL_COLS; ++p)
          tma_load(sK(s) + p * PANEL, &tk, fullK(s), p * PANEL_COLS, h, kt * BK, b);
        if (kt >= STAGES) mbar_wait(emptyV(s), parity);
        mbar_expect_tx(fullV(s), R::TILE);
#pragma unroll
        for (int p = 0; p < D / PANEL_COLS; ++p)
          tma_load(sV(s) + p * PANEL, &tv, fullV(s), p * PANEL_COLS, h, kt * BK, b);
      }
    }
    return;
  }

  // -- consumer warpgroup
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;  // rows r0 and r0 + 8
  const int c2 = 2 * (lane % 4);        // first of this thread's column pair
  const uint32_t sQ = base + R::q_off;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f}, alpha[2];
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
    __syncwarp();
  };
  auto wait_full = [&](uint32_t bar, int kt) {
    mbar_wait(bar, (kt / STAGES) & 1);
    __syncwarp();
  };
  auto softmax = [&](float (&sc)[32], int kt) {
    const int k0 = kt * BK;
    softmax_tile<kPos>(sc, m, l, alpha, sl2,
                       (causal && k0 + BK > q0) || k0 + BK > Sk, k0, Sk,
                       q0 + r0, causal, c2);
  };

  // Tile k's scores are issued before P.V of tile k-1, and its softmax runs
  // while that product is on the tensor cores.
  float sc[32];
  uint32_t pa[16];
  wait_full(barQ, 0);
  // One branch around the whole pipeline: with tile 0 and the last P.V in
  // branches of their own, long sequences ran measurably slower on the H100.
  if (n_kt > 0) {
    wait_full(fullK(0), 0);
    wg_fence();
    issue_scores<D>(sc, sQ, sK(0));
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);
    release(emptyK(0));
    softmax(sc, 0);
    pack_p(pa, sc);
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % STAGES, sp = (kt - 1) % STAGES;
      wait_full(fullK(s), kt);
      reg_fence(acc);
      wg_fence();
      issue_scores<D>(sc, sQ, sK(s));
      wg_commit();
      wait_full(fullV(sp), kt - 1);
      issue_pv<D>(acc, pa, sV(sp));
      wg_commit();
      wg_wait<1>();  // the scores are in; P.V of tile kt-1 may still run
      reg_fence(sc);
      release(emptyK(s));
      softmax(sc, kt);
      wg_wait<0>();
      reg_fence(acc);
      release(emptyV(sp));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
      pack_p(pa, sc);
    }
    const int sp = (n_kt - 1) % STAGES;
    wait_full(fullV(sp), n_kt - 1);
    reg_fence(acc);
    wg_fence();
    issue_pv<D>(acc, pa, sV(sp));
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    release(emptyV(sp));
  }

  // -- epilogue: o = acc / l staged in the Q buffer (free once every warp's last
  // product is done), then 16-byte row stores; lse back in the natural log
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.0f / l_safe;
    const int qpos = q0 + r0 + 8 * r;
    if ((lane % 4) == 0 && qpos < Sq)
      lse[(long long)bh * Sq + qpos] = m[r] * LN2 + logf(l_safe);
  }
  unsigned char* const stage = smem + R::q_off;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const int off =
          (j / 8) * PANEL + row * 128 + (((j % 8) ^ (row % 8)) * 16) + c2 * 2;
      *reinterpret_cast<uint32_t*>(stage + off) =
          pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < BQ * CPR; i += CONSUMERS) {
    const int row = i / CPR, ch = i % CPR;
    const int sq = q0 + row;
    if (sq < Sq) {
      const int off = (ch / 8) * PANEL + row * 128 + (((ch % 8) ^ (row % 8)) * 16);
      *reinterpret_cast<uint4*>(o + (((long long)b * Sq + sq) * H + h) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + off);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime: no -lcuda at link time.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Entry errors of the host side, below cudaError_t's range.
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_MAP_Q = -2;  // -2, -3, -4: q, k, v

// A 4-D map over [B, S, H, D] read through its strides, innermost first; one box is
// one panel: 64 columns of 64 rows of one (b, h). A dim of extent 1 is never
// stepped over, so its stride is set to a packed one (TMA takes multiples of 16).
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
            Strides st) {
  const long long ext[3] = {H, S, B}, el[3] = {st.h, st.s, st.b};
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)(S > 0 ? S : 1),
                        (cuuint64_t)B};
  cuuint64_t strides[3];
  long long prev = (long long)D * 2, prev_ext = 1;
  for (int i = 0; i < 3; ++i) {
    strides[i] = ext[i] > 1 ? el[i] * 2 : prev * prev_ext;
    prev = strides[i];
    prev_ext = ext[i] > 0 ? ext[i] : 1;
  }
  const cuuint32_t box[4] = {PANEL_COLS, 1, BQ, 1}, step[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                   dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kPos>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                int B, int H, int Sq, int Sk, Strides sq, Strides sk, Strides sv,
                int causal, float scale, int device, cudaStream_t stream) {
  if (encoder() == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, Sq, H, D, sq)) return ERR_MAP_Q;
  if (!encode(&tk, k, B, Sk, H, D, sk)) return ERR_MAP_Q - 1;
  if (!encode(&tv, v, B, Sk, H, D, sv)) return ERR_MAP_Q - 2;
  constexpr int smem = Ring<D>::bytes;
  // the shared-memory limit once per device for this instance
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(ready.load() & bit)) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_bf16<D, kPos>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel_bf16<D, kPos><<<grid, THREADS_BF16, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, H, Sq, Sk, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs for parity with the plain version, plain loads
// ---------------------------------------------------------------------------

constexpr int WARPS_F32 = 4;                 // each warp owns 16 q rows
constexpr int THREADS_F32 = WARPS_F32 * 32;  // lanes 2r and 2r+1 share row r

// Shared memory: q, k, v and probability tiles, rows padded by 16 bytes.
template <int D>
struct LayoutF32 {
  static constexpr int LD = D + 4;    // q/k/v row stride
  static constexpr int LDP = BK + 4;  // probability row stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(float) * BQ * LD;
  static constexpr size_t v_off = k_off + sizeof(float) * BK * LD;
  static constexpr size_t p_off = v_off + sizeof(float) * BK * LD;
  static constexpr size_t bytes = p_off + sizeof(float) * BQ * LDP;
};

// rows x D floats of sequence rows s0.. of (b, h) into a tile; rows at or past S
// are zero, so a ragged edge adds nothing to a product.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, Strides st,
                                              int b, int h, int s0, int S, int rows) {
  constexpr int CH = D / 4;
  const float* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS_F32) {
    const int r = i / CH, c = (i % CH) * 4;
    const int s = s0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s < S) val = *reinterpret_cast<const float4*>(base + s * st.s + c);
    *reinterpret_cast<float4*>(dst + r * LayoutF32<D>::LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS_F32)
    flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int Sq, int Sk, Strides sq,
                         Strides sk, Strides sv, int causal, float scale) {
  using L = LayoutF32<D>;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32 + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem_f32 + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem_f32 + L::v_off);
  float* Ps = reinterpret_cast<float*>(smem_f32 + L::p_off);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2;  // this lane's row in the tile
  const int half = lane & 1;           // and its half of the columns
  const int qpos = q0 + r;

  load_tile_f32<D>(Qs, q, sq, b, h, q0, Sq, BQ);

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // stop at the diagonal

  float m = NEG_INF, l = 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_f32<D>(Ks, k, sk, b, h, k0, Sk, BK);
    load_tile_f32<D>(Vs, v, sv, b, h, k0, Sk, BK);
    __syncthreads();

    // raw scores of this lane's half row: s[j] = q[r] . k[half + 2j]
    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.0f;
    const float* qr = Qs + r * L::LD;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        s[j] = fmaf(qd, Ks[(half + 2 * j) * L::LD + d], s[j]);
    }

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
    float* prow = Ps + r * L::LDP;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = expf(s[j] - m_next);
      prow[half + 2 * j] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
    m = m_next;
    __syncwarp();  // the warp's probability rows are complete

    // acc[i] = acc[i] * alpha + (P . V)[r, half + 2i]
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float pc = prow[c];
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        acc[i] = fmaf(pc, Vs[c * L::LD + half + 2 * i], acc[i]);
    }
  }

  // finalize as the Pallas kernel does; the warp's own q rows are free now, so
  // they stage o for a coalesced store
  const float l_safe = fmaxf(l, 1e-30f);
  __syncwarp();
  float* orow = Qs + r * L::LD;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) orow[half + 2 * i] = acc[i] / l_safe;
  if (half == 0 && qpos < Sq) lse[(long long)bh * Sq + qpos] = m + logf(l_safe);
  __syncwarp();
  constexpr int CH = D / 4;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int rr = warp * 16 + i / CH, c = (i % CH) * 4;
    const int s = q0 + rr;
    if (s < Sq)
      *reinterpret_cast<float4*>(o + (((long long)b * Sq + s) * H + h) * D + c) =
          *reinterpret_cast<const float4*>(Qs + rr * L::LD + c);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int H, int Sq, int Sk, Strides sq, Strides sk, Strides sv, int causal,
               float scale, int device, cudaStream_t stream) {
  constexpr size_t smem = LayoutF32<D>::bytes;
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(ready.load() & bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel_f32<D><<<grid, THREADS_F32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Sq, Sk, sq, sk, sv,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H, D] with the given element strides (last dim contiguous,
// every stride and pointer 16-byte aligned); o: contiguous [B, Sq, H, D];
// lse: contiguous fp32 [B*H, Sq]. dtype 0 is fp32, 1 is bf16; D is 64 or 128.
// Returns cudaGetLastError() after the launch (0 on success), or a negative code
// when a tensor map cannot be made (flash_attn_fwd_error names it).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              float* lse, int B, int H, int Sq, int Sk, int D,
                              int dtype, long long sqb, long long sqs, long long sqh,
                              long long skb, long long sks, long long skh,
                              long long svb, long long svs, long long svh,
                              int causal, float scale, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh};
  auto st = static_cast<cudaStream_t>(stream);
  const bool pos = scale > 0.0f;
  if (dtype == 1 && D == 64)
    return pos ? launch_bf16<64, true>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv, causal,
                                       scale, device, st)
               : launch_bf16<64, false>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv,
                                        causal, scale, device, st);
  if (dtype == 1 && D == 128)
    return pos ? launch_bf16<128, true>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv,
                                        causal, scale, device, st)
               : launch_bf16<128, false>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv,
                                         causal, scale, device, st);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv, causal, scale,
                          device, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, o, lse, B, H, Sq, Sk, sq, sk, sv, causal, scale,
                           device, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_fwd_error(int err) {
  switch (err) {
    case ERR_NO_ENCODER:
      return "the driver has no cuTensorMapEncodeTiled";
    case ERR_MAP_Q:
      return "cuTensorMapEncodeTiled refused q's layout";
    case ERR_MAP_Q - 1:
      return "cuTensorMapEncodeTiled refused k's layout";
    case ERR_MAP_Q - 2:
      return "cuTensorMapEncodeTiled refused v's layout";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
