// MXFP8 quantize of an (M, N) tensor, both orientations from one read
// (te_mxfp8_quantize_2x) or one of them (te_mxfp8_quantize_1x, the
// colwise form transposing on chip from the untransposed input): the
// rowwise (M, N) payload with its (M, ceil(N/32)) E8M0 grid, the colwise
// (N, M) payload with its (N, ceil(M/32)) grid, for any M and N.
//
// Replaces transformerengine_tpu/ops/quantize_kernels.py
// mxfp8_quantize_2x (`_mxfp8_kernel`, `_mxfp8_pair`, `_e8m0_exp`) and
// mxfp8_quantize_1x (`_mxfp8_1x_kernel`). Bit-exact to quantize/qmath.py
// mxfp8_quantize of each orientation (the rule is in mxfp8.cuh).
//
// Bound on an H100: bytes. The 2x form reads x once and writes two
// one-byte payloads and two grids: at the MLP's (4096, 14336) bf16 that
// is 235 MB, 70 us at 3.35 TB/s. A few operations per byte.
//
// Design: one block of 256 threads per 32 x 64 tile, so a tile holds
// whole 32-element blocks of both orientations. Each thread loads 8
// consecutive elements of one row with a 16-byte load (two for f32); the
// rowwise amax of a block is a shuffle over 4 lanes and the rowwise
// bytes go straight out (8-byte stores). The colwise half stages the tile
// in shared memory (8.3 KB) and each thread quantizes 8 elements of one
// column, its 4-lane group writing 32 consecutive colwise bytes. Edges
// are masked, so any shape launches the same kernel. Left for later:
// more bytes in flight per thread, TMA loads.
#include "mxfp8.cuh"

namespace {

using namespace mxfp8;

template <typename T, bool kRow, bool kCol>
__global__ void __launch_bounds__(kThreads)
    mxfp8_quantize_kernel(const T* __restrict__ x, int e5m2,
                          uint8_t* __restrict__ row, uint8_t* __restrict__ col,
                          uint8_t* __restrict__ srow,
                          uint8_t* __restrict__ scol, int M, int N) {
  const int t = threadIdx.x;
  float v[8];
  load8(x, M, N, blockIdx.y * kTileRows + (t >> 3),
        blockIdx.x * kTileCols + (t & 7) * 8, v);
  quantize_tile<kRow, kCol>(v, M, N, Fp8Cast(e5m2), row, col, srow, scol);
}

template <typename T>
cudaError_t launch(const void* x, int e5m2, void* row, void* col, void* srow,
                   void* scol, int M, int N, cudaStream_t s) {
  dim3 grid;
  if (!tile_grid(M, N, &grid)) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  uint8_t* r = static_cast<uint8_t*>(row);
  uint8_t* c = static_cast<uint8_t*>(col);
  uint8_t* sr = static_cast<uint8_t*>(srow);
  uint8_t* sc = static_cast<uint8_t*>(scol);
  if (r != nullptr && c != nullptr) {
    mxfp8_quantize_kernel<T, true, true>
        <<<grid, kThreads, 0, s>>>(xt, e5m2, r, c, sr, sc, M, N);
  } else if (r != nullptr) {
    mxfp8_quantize_kernel<T, true, false>
        <<<grid, kThreads, 0, s>>>(xt, e5m2, r, c, sr, sc, M, N);
  } else {
    mxfp8_quantize_kernel<T, false, true>
        <<<grid, kThreads, 0, s>>>(xt, e5m2, r, c, sr, sc, M, N);
  }
  return cudaGetLastError();
}

int dispatch(const void* x, int x_dtype, int q_dtype, void* row, void* col,
             void* srow, void* scol, int M, int N, void* stream) {
  if (q_dtype != kFloat8E4M3 && q_dtype != kFloat8E5M2)
    return cudaErrorInvalidValue;
  const int e5m2 = q_dtype == kFloat8E5M2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kBFloat16:
      return launch<__nv_bfloat16>(x, e5m2, row, col, srow, scol, M, N, s);
    case kFloat32:
      return launch<float>(x, e5m2, row, col, srow, scol, M, N, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int te_mxfp8_quantize_2x(const void* x, int x_dtype, int q_dtype,
                                    void* row, void* col, void* srow,
                                    void* scol, int M, int N, void* stream) {
  if (row == nullptr || col == nullptr || srow == nullptr || scol == nullptr)
    return cudaErrorInvalidValue;
  return dispatch(x, x_dtype, q_dtype, row, col, srow, scol, M, N, stream);
}

// One orientation: `out` and `scale` are the rowwise payload and grid, or
// with `colwise` the colwise ones.
extern "C" int te_mxfp8_quantize_1x(const void* x, int x_dtype, int q_dtype,
                                    void* out, void* scale, int colwise,
                                    int M, int N, void* stream) {
  if (out == nullptr || scale == nullptr) return cudaErrorInvalidValue;
  if (colwise)
    return dispatch(x, x_dtype, q_dtype, nullptr, out, nullptr, scale, M, N,
                    stream);
  return dispatch(x, x_dtype, q_dtype, out, nullptr, scale, nullptr, M, N,
                  stream);
}
