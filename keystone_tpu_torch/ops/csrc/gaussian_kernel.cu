// Gaussian kernel block  K[i, j] = exp(-gamma * max(|x_i|^2 - 2 x_i.y_j + |y_j|^2, 0))
// for X (n, d) and Xb (b, d), float32 throughout, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gaussian_kernel_block_pallas
// (keystone_tpu/ops/gaussian_kernel.py, tile body _kernel), which keeps the
// whole Xb resident in VMEM and tiles X in 512-row blocks. Here Xb is tiled
// too: a 128 x 128 output tile per block of 256 threads, a K-loop over d in
// steps of 16 through shared memory, an 8 x 8 register tile per thread, and
// the norms, -2c and exp fused into the epilogue, so the (n, b) squared
// distances never reach device memory.
//
// Bound on an H100 SXM: 2·n·b·d flops in FP32 outside the tensor cores
// (67 TFLOP/s) against 4·(n·d + b·d + n·b) bytes (3.35 TB/s). At the KRR fit
// shape (50000, 800) x (5000, 800) that is 4.0e11 flops = 6.0 ms against
// 1.18 GB = 0.35 ms: compute-bound. This first version is a plain FFMA
// SGEMM; tensor cores (TF32 or 3xTF32 wgmma) and TMA are later work.
//
// Ragged n, b and d are masked, never padded. Rows of X and Xb are read
// through row strides (the KRR block X[start:start+bs] needs no copy), and
// output offsets are 64-bit. The row norms come from a small pre-pass
// kernel into a scratch buffer of n + b floats that the caller allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // rows of X per block
constexpr int BN = 128;      // rows of Xb per block
constexpr int BK = 16;       // depth per shared-memory stage
constexpr int PAD = 4;       // keeps rows 16-byte aligned for float4 reads
constexpr int THREADS = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int LOADS = BM * BK / THREADS;  // elements of each tile per thread

// One warp per row: norms[r] = |X[r]|^2 for r < n, |Xb[r - n]|^2 after.
__global__ void row_sqnorms(const float* __restrict__ X, int64_t ldx, int64_t n,
                            const float* __restrict__ Xb, int64_t ldb, int64_t b,
                            int64_t d, float* __restrict__ norms) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n + b) return;  // uniform across the warp
  const float* p = row < n ? X + row * ldx : Xb + (row - n) * ldb;
  float s = 0.f;
  for (int64_t k = lane; k < d; k += 32) {
    const float v = p[k];
    s = fmaf(v, v, s);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) norms[row] = s;
}

__global__ void __launch_bounds__(THREADS)
gaussian_block(const float* __restrict__ X, int64_t ldx,
               const float* __restrict__ Xb, int64_t ldb,
               const float* __restrict__ norms, float* __restrict__ out,
               int64_t n, int64_t b, int64_t d, float gamma, int vec_store) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t row0 = (int64_t)blockIdx.y * BM;  // first row of X
  const int64_t col0 = (int64_t)blockIdx.x * BN;  // first row of Xb

  // Loader: consecutive threads read consecutive k of one row (coalesced).
  const int lk = tid % BK;
  const int lr = tid / BK;  // 0..15, rows lr + 16 i
  float ra[LOADS], rb[LOADS];

#define LOAD_TILE(k0)                                                   \
  {                                                                     \
    const int64_t k = (k0) + lk;                                        \
    const bool kin = k < d;                                             \
    _Pragma("unroll") for (int i = 0; i < LOADS; ++i) {                 \
      const int64_t r = row0 + lr + 16 * i;                             \
      const int64_t c = col0 + lr + 16 * i;                             \
      ra[i] = (kin && r < n) ? X[r * ldx + k] : 0.f;                    \
      rb[i] = (kin && c < b) ? Xb[c * ldb + k] : 0.f;                   \
    }                                                                   \
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  LOAD_TILE(0);
  for (int64_t k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      As[lk][lr + 16 * i] = ra[i];
      Bs[lk][lr + 16 * i] = rb[i];
    }
    __syncthreads();
    // next tile into registers while this one is multiplied
    if (k0 + BK < d) LOAD_TILE(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#undef LOAD_TILE

  // Epilogue: thread rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
  // likewise with tx; the same algebra and order as the plain version.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= n) continue;
    const float xx = norms[r];
    float* orow = out + r * b;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t c = col0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float bb = (c + jj < b) ? norms[n + c + jj] : 0.f;
        const float sq = (xx - 2.f * acc[i][h * 4 + jj]) + bb;
        v[jj] = expf(-gamma * fmaxf(sq, 0.f));
      }
      if (vec_store && c + 3 < b) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (c + jj < b) orow[c + jj] = v[jj];
      }
    }
  }
}

}  // namespace

// out (n, b) contiguous; norms scratch of n + b floats. Returns the
// cudaError_t of the launches (0 on success). The caller checks that the
// grid fits: ceil(n / 128) <= 65535.
extern "C" int gaussian_kernel_block_f32(const float* X, int64_t ldx,
                                         const float* Xb, int64_t ldb,
                                         float* norms, float* out,
                                         int64_t n, int64_t b, int64_t d,
                                         float gamma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = n + b;
  const int warps_per_block = 8;
  row_sqnorms<<<(unsigned)((rows + warps_per_block - 1) / warps_per_block),
                32 * warps_per_block, 0, s>>>(X, ldx, n, Xb, ldb, b, d, norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec_store = (b % 4 == 0) && ((uintptr_t)out % 16 == 0);
  dim3 grid((unsigned)((b + BN - 1) / BN), (unsigned)((n + BM - 1) / BM));
  gaussian_block<<<grid, THREADS, 0, s>>>(X, ldx, Xb, ldb, norms, out, n, b, d,
                                          gamma, vec_store);
  return (int)cudaGetLastError();
}

extern "C" const char* keystone_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
