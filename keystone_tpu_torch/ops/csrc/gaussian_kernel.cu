// Gaussian kernel block  K[i, j] = exp(-gamma * max(|x_i|^2 - 2 x_i.y_j + |y_j|^2, 0))
// for X (n, d) and Xb (b, d), float32 in and out, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gaussian_kernel_block_pallas
// (keystone_tpu/ops/gaussian_kernel.py:51, its pallas_call at :64, tile body
// _kernel), which keeps the whole Xb resident in VMEM, tiles X in 512-row
// blocks, forms the cross term on the MXU and the norms and exp on the VPU.
//
// Bound on an H100 SXM. The cross term x.y is formed on the tensor cores in
// 3xTF32: each operand is split x = hi + lo with hi = tf32_rna(x) and
// lo = tf32_rna(x - hi), and x.y ~ hi.hi + hi.lo + lo.hi. That is 3 * 2nbd
// TF32 operations at 495 TFLOP/s, against 4 (nd + bd + nb) bytes at
// 3.35 TB/s. At the KRR fit shape (50000, 800) x (5000, 800): 1.2e12
// operations = 2.42 ms against 1.18 GB = 0.35 ms, so operations bound it.
// (One FP32 FFMA SGEMM of the same product is bound at 6.0 ms; no FFMA
// kernel can come in under that.)
//
// Why 3xTF32 and not one TF32 pass: one pass keeps 10 mantissa bits of each
// operand and is ~1e-5 off the FP32 result at the CIFAR gamma (2e-4, d 800);
// the three products drop only lo.lo (~2^-22 relative) and land as close to
// the float64 value as FP32 does (1.4e-7 at (10000, 800, 5000), plain FP32
// 1.5e-7, on an H100). The norms and the epilogue
// (xx - 2c) + bb -> max(., 0) -> exp(-gamma .) stay in FP32, in the order of
// the plain version (ops/gaussian_kernel.py::gaussian_kernel_block_plain).
//
// Why the tensor cores' sums are promoted: they truncate as they
// accumulate. Over a long sum of one sign, a row against itself at d = 800,
// that drifts in x.y far past FP32's rounding: unpromoted, the kernel
// failed the card tests' self block at gamma 0.03. So each warpgroup sums
// PROMOTE stages (32 of d) on the tensor cores into tc, starting afresh
// each time, and adds tc into its FP32 accumulator acc (round to nearest)
// after a wgmma wait; the self block then meets the card tolerance
// (chip_smoke.py holds one at the fit shape).
//
// Design, against the operation bound (choices timed on an H100 at the fit
// shape with edited builds of this file):
//  * Pre-pass (split_rows): one warp per row of X and of Xb writes the FP32
//    norm and the hi and lo parts, zero-filled to d_pad (d rounded up to
//    PROMOTE * BK), into scratch the caller allocates. A row of the split
//    is interleaved BK at a time, hi[k0, k0 + 16) then lo[k0, k0 + 16), so
//    one 128-byte TMA row brings both halves of a stage. Every operand is
//    then 128-byte aligned and K-major whatever the caller's stride (row
//    slices at 4-byte offsets, d = 5), which TMA needs, and the main loop
//    does no conversion. X (n, d) and Xb (b, d) are both K-major, as TF32
//    wgmma requires of A and of B. It moves ~0.5 GB at the fit shape.
//  * Main kernel (gaussian_block): persistent, one block of 384 threads per
//    SM walking 128 x 192 output tiles, b-tiles fastest, so the tiles in
//    flight share a few X row tiles and all of Xb's split (32 MB at
//    b = 5000) stays in the 50 MB L2. Warpgroup 0 gives up registers
//    (setmaxnreg 40) and one of its threads issues the TMA loads (128-byte
//    swizzle) of the A and B tiles into a ring of STAGES stages of
//    (128 + 192) rows x 128 B = 40 KB, five in the 227 KB, each guarded by a
//    "full" and an "empty" mbarrier. Warpgroups 1 and 2 take registers
//    (setmaxnreg 232), each owns 64 rows of the tile and issues three
//    wgmma.m64n192k8.f32.tf32 per k8 step (hi.hi, hi.lo, lo.hi), keeping
//    one stage in flight while the next is issued within a promotion
//    interval. tc and acc take 96 registers each; BN = 256 would need 256.
//    The loads, not the tensor cores, set the pace: one product instead of
//    three saved only a fifth of the time; a ring of two 96 KB stages, or
//    of four with separate 64-byte hi and lo rows, was slower than the
//    interleaved 128-byte rows. Promoting every stage was slower; every
//    second stage cost nothing measurable. Tiles of 128 x 128 (seven
//    stages) time the same.
//  * Epilogue: from acc, with the two norm vectors read from the scratch;
//    each warp's stores cover whole 32-byte sectors (8 rows x 8 consecutive
//    floats), as float2 where b is even. The producer is already loading
//    the next tile's stages meanwhile. The (n, b) squared distances never
//    reach device memory.
//  * Ragged n and b: TMA fills zeros past the edge on load, and the stores
//    are masked. Ragged d: the pre-pass zero-fills up to d_pad.
//  * Capture: the two TMA descriptors are encoded on the host at each call
//    (cuTensorMapEncodeTiled, no device work) and passed by value as
//    __grid_constant__ parameters; nothing is allocated, copied or
//    synchronised in a call, so the launch records into a CUDA graph. The
//    dynamic shared-memory size is set once per device (gaussian_kernel_setup).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // rows of X per tile: two warpgroups of 64
constexpr int BN = 192;            // rows of Xb per tile: one m64n192k8 per warpgroup
constexpr int BK = 16;             // floats of d per stage
constexpr int ROW = 2 * BK;        // a stage row: BK of hi, then BK of lo = 128 B
constexpr int PROMOTE = 2;         // stages summed on the tensor cores between promotions
constexpr int THREADS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;     // threads that arrive on an "empty" barrier
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int A_BYTES = BM * ROW * 4;                      // 16 KB
constexpr int B_BYTES = BN * ROW * 4;                      // 24 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;             // 40 KB
constexpr int STAGES = (232448 - 2048) / STAGE_BYTES;      // as many as fit: 5
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "shared memory beyond what a block can have");
static_assert(ROW * 4 == 128, "a stage row must be one 128-byte swizzle row");
static_assert((THREADS - 128) / 128 * 64 == BM, "one consumer warpgroup per 64 rows");

// Errors of this file's own, beside the cudaError_t values (all > 0)
constexpr int ERR_NO_ENCODER = -1;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;       // cuTensorMapEncodeTiled refused a map
constexpr int ERR_REGISTERS = -3;    // too few registers for the setmaxnreg split

// ---- device helpers ------------------------------------------------------

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One 2-D TMA box (ROW floats, `rows` rows) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 B, 8-row groups 1024 B apart (SBO), leading
// offset unused for this layout, layout type 1 = SWIZZLE_128B. A k8 step of
// TF32 is 32 bytes, so it adds 2 to the address field (16-byte units), and
// the lo half of a row (64 B in) adds 4.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(1) << 16)
       | (static_cast<uint64_t>(1024 >> 4) << 32)
       | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and wait.
__device__ __forceinline__ void fence_acc(float (&d)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define GK_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define GK_F16(i) GK_F4(i), GK_F4(i + 4), GK_F4(i + 8), GK_F4(i + 12)

// D(64 x BN, FP32) = A(64 x 8, TF32) . B(BN x 8, TF32)^T + (scale_d ? D : 0),
// both from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t a, uint64_t b,
                                           int scale_d) {
  static_assert(BN == 192, "the operand list below is written out for BN = 192");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1;\n}\n"
      : GK_F16(0), GK_F16(16), GK_F16(32), GK_F16(48), GK_F16(64), GK_F16(80)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef GK_F16
#undef GK_F4

// ---- pre-pass ------------------------------------------------------------

// One warp per row r of [X; Xb]: |row|^2 into norms[r], and the row's hi
// and lo parts, zero-filled to d_pad, interleaved BK at a time (a stage row
// of the main kernel: hi[k0, k0 + BK) then lo[k0, k0 + BK)) into
//   A (n x 2 d_pad) | B (b x 2 d_pad) | norms (n + b).
__global__ void split_rows(const float* __restrict__ X, int64_t ldx, int64_t n,
                           const float* __restrict__ Xb, int64_t ldb, int64_t b,
                           int64_t d, int64_t d_pad, float* __restrict__ scratch) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n + b) return;  // uniform across the warp
  const float* src = row < n ? X + row * ldx : Xb + (row - n) * ldb;
  float* dst = scratch + row * 2 * d_pad;
  const bool is_hi = lane < BK;  // a warp writes one stage row of ROW floats
  float s = 0.f;
  for (int64_t k0 = 0; k0 < d_pad; k0 += BK) {
    const int64_t k = k0 + lane % BK;
    const float v = k < d ? src[k] : 0.f;
    const float h = tf32_rna(v);
    if (is_hi) s = fmaf(v, v, s);
    dst[2 * k0 + lane] = is_hi ? h : tf32_rna(v - h);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) scratch[2 * (n + b) * d_pad + row] = s;
}

// ---- main kernel ---------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
gaussian_block(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap b_map,
               const float* __restrict__ norms, float* __restrict__ out,
               int n, int b, int k_tiles, float gamma, int vec2) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 B: align the stages to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full0 = base + STAGES * STAGE_BYTES;  // STAGES barriers of 8 B
  const uint32_t empty0 = full0 + STAGES * 8;

  const int b_tiles = (b + BN - 1) / BN;
  const int tiles = ((n + BM - 1) / BM) * b_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring of stages filled ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = (tile / b_tiles) * BM;
        const int col0 = (tile % b_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t phase = (it / STAGES) & 1;
          mbar_wait(empty0 + 8 * s, phase ^ 1);  // the first round passes at once
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, STAGE_BYTES);
          const uint32_t st = base + s * STAGE_BYTES;
          tma_load(st, &a_map, kt * ROW, row0, full);
          tma_load(st + A_BYTES, &b_map, kt * ROW, col0, full);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of the tile each, 3xTF32 on the tensor cores ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    float tc[BN / 2];   // the tensor cores' partial sum of the current stages
    float acc[BN / 2];  // the tile's cross term, summed in FP32 (round to nearest)
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / b_tiles) * BM;
      const int col0 = (tile % b_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      // d_pad is a multiple of PROMOTE stages: each interval is whole
      for (int kt = 0; kt < k_tiles; kt += PROMOTE) {
        int prev = 0;  // the interval's stage before this one
#pragma unroll
        for (int p = 0; p < PROMOTE; ++p, ++it) {
          const int s = it % STAGES;
          mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
          const uint32_t st = base + s * STAGE_BYTES;
          const uint64_t da = smem_desc(st + cw * (A_BYTES / 2));  // hi; lo at + 4
          const uint64_t db = smem_desc(st + A_BYTES);
          fence_acc(tc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            wgmma_tf32(tc, da + 2 * kk, db + 2 * kk, p > 0 || kk > 0);  // hi . hi
            wgmma_tf32(tc, da + 2 * kk, db + 4 + 2 * kk, 1);            // hi . lo
            wgmma_tf32(tc, da + 4 + 2 * kk, db + 2 * kk, 1);            // lo . hi
          }
          wgmma_commit();
          fence_acc(tc);
          if (p < PROMOTE - 1) {
            wgmma_wait<1>();  // the stage before this one is read: release it
            fence_acc(tc);
            if (p > 0) mbar_arrive(empty0 + 8 * prev);
            prev = s;
          } else {
            // promote: the tensor cores truncate as they accumulate, which
            // drifts over a long sum of one sign (a row against itself), so
            // their partial over PROMOTE stages is added here in FP32
            wgmma_wait<0>();
            fence_acc(tc);
            if (p > 0) mbar_arrive(empty0 + 8 * prev);
            mbar_arrive(empty0 + 8 * s);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] += tc[i];
          }
        }
      }

      // Epilogue. Accumulator layout of m64nNk8 (FP32): register 4c + j
      // holds row 16 warp + lane / 4 + 8 (j / 2), column 8c + 2 (lane % 4)
      // + j % 2 of this warpgroup's 64 x BN block.
      const int64_t r0 = (int64_t)row0 + cw * 64 + warp * 16 + lane / 4;
      const int64_t r1 = r0 + 8;
      const float xx0 = r0 < n ? norms[r0] : 0.f;
      const float xx1 = r1 < n ? norms[r1] : 0.f;
      const float* bb = norms + n;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int col = col0 + 8 * c + 2 * (lane % 4);
        if (col >= b) continue;
        const bool two = col + 1 < b;
        const float bb0 = bb[col];
        const float bb1 = two ? bb[col + 1] : 0.f;
        const float v00 = expf(-gamma * fmaxf((xx0 - 2.f * acc[4 * c]) + bb0, 0.f));
        const float v01 = expf(-gamma * fmaxf((xx0 - 2.f * acc[4 * c + 1]) + bb1, 0.f));
        const float v10 = expf(-gamma * fmaxf((xx1 - 2.f * acc[4 * c + 2]) + bb0, 0.f));
        const float v11 = expf(-gamma * fmaxf((xx1 - 2.f * acc[4 * c + 3]) + bb1, 0.f));
        if (r0 < n) {
          float* o = out + r0 * b + col;
          if (vec2) {
            *reinterpret_cast<float2*>(o) = make_float2(v00, v01);
          } else {
            o[0] = v00;
            if (two) o[1] = v01;
          }
        }
        if (r1 < n) {
          float* o = out + r1 * b + col;
          if (vec2) {
            *reinterpret_cast<float2*>(o) = make_float2(v10, v11);
          } else {
            o[0] = v10;
            if (two) o[1] = v11;
          }
        }
      }
    }
  }
}

// ---- host ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (no
// link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// d rounded up to whole promotion intervals (at least one)
int64_t padded_depth(int64_t d) {
  constexpr int64_t step = (int64_t)PROMOTE * BK;
  return (d > 0 ? (d + step - 1) / step : 1) * step;
}

// A map of one (rows, 2 d_pad) row-major split buffer, read in boxes of ROW
// floats by box_rows rows with the 128-byte swizzle; zeros past the edge.
int encode(CUtensorMap* map, const float* buf, int64_t rows, int64_t d_pad, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)(2 * d_pad), (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(2 * d_pad) * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)ROW, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(buf), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

}  // namespace

// Floats of scratch one call needs: the interleaved hi and lo split of X
// and Xb, 2 d_pad floats a row, and the n + b norms.
extern "C" int64_t gaussian_kernel_scratch_floats(int64_t n, int64_t b, int64_t d) {
  return 2 * (n + b) * padded_depth(d) + n + b;
}

// Once per device, before its first launch: the main kernel's dynamic
// shared memory, and a check that the kernel holds the registers that the
// setmaxnreg split hands out (otherwise setmaxnreg.inc would never return).
extern "C" int gaussian_kernel_setup() {
  cudaError_t err = cudaFuncSetAttribute(gaussian_block,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gaussian_block);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs * THREADS < 128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS)
    return ERR_REGISTERS;
  return 0;
}

// out (n, b) contiguous; scratch of gaussian_kernel_scratch_floats(n, b, d)
// floats, 16-byte aligned. Rows of X and Xb are ldx and ldb floats apart,
// each contiguous. Launches the pre-pass and the main kernel on `stream`
// and returns 0, a cudaError_t, or one of this file's negative errors.
extern "C" int gaussian_kernel_block_f32(const float* X, int64_t ldx,
                                         const float* Xb, int64_t ldb,
                                         float* scratch, float* out,
                                         int64_t n, int64_t b, int64_t d,
                                         float gamma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t d_pad = padded_depth(d);
  const float* norms = scratch + 2 * (n + b) * d_pad;

  CUtensorMap maps[2];
  int rc;
  if ((rc = encode(&maps[0], scratch, n, d_pad, BM)) != 0) return rc;
  if ((rc = encode(&maps[1], scratch + 2 * n * d_pad, b, d_pad, BN)) != 0) return rc;

  const int64_t rows = n + b;
  const int warps_per_block = 8;
  split_rows<<<(unsigned)((rows + warps_per_block - 1) / warps_per_block),
               32 * warps_per_block, 0, s>>>(X, ldx, n, Xb, ldb, b, d, d_pad, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int64_t tiles = ((n + BM - 1) / BM) * ((b + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  const int vec2 = (b % 2 == 0) && ((uintptr_t)out % 8 == 0);
  gaussian_block<<<grid, THREADS, SMEM_BYTES, s>>>(
      maps[0], maps[1], norms, out, (int)n, (int)b,
      (int)(d_pad / BK), gamma, vec2);
  return (int)cudaGetLastError();
}

extern "C" const char* keystone_cuda_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled is not available from libcuda";
    case ERR_ENCODE: return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_REGISTERS: return "the kernel was built with too few registers for its setmaxnreg split";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
