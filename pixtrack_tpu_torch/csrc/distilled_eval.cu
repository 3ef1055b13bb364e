// K2: per-sample evaluation of the distilled field, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pixtrack_tpu/nerf/fused_mlp.py::fused_distilled_eval
// (kernel body _fused_kernel). For each of N samples, a grid-space position
// and a unit view direction in, the density sigma and the rgb colour out:
// the sin/cos encoding of `octaves` octaves, a ReLU trunk of `depth` 128-wide
// layers, a 16-row head giving sigma = expm1(softplus) and 15 geometry
// features, the degree-4 SH of this sample's own direction, and a
// 32->64->64->3 colour MLP with a sigmoid. Every dense layer rounds its
// operands to bf16 and sums in f32, as the TPU kernel and the plain PyTorch
// version (DistilledField.field_T) do. The staged render's importance pass
// (64 stratified + 32 importance samples per ray) evaluates every sample
// through it.
//
// What bounds it on an H100: arithmetic. A sample costs ~66k multiply-adds
// (131,456 FLOP at 10 octaves) against 40 bytes in and out (6 floats in, 4
// out), ~3,300 FLOP per byte: far above the card's ridge point on any unit.
// This first version runs the products on the FP32 pipes (67 TFLOP/s), not
// the tensor cores, which is the headroom left for later work (wgmma on bf16).
//
// What the design does about it: the network is distilled_mlp.cuh, shared
// with K1 (weights and activations in shared memory, register tiles of f32
// sums). A tile here is only 64 samples, and the weights are ~131 KB, so
// reloading them per tile would cost as much traffic as the samples carry
// arithmetic: the grid is persistent instead, one block per SM, each block
// loading the weights once and striding over the tiles. The ragged last tile
// computes on zero inputs and stores nothing.
//
// Built by nvcc into a shared library with a plain C entry point
// (k2_distilled_eval), loaded with ctypes by pixtrack_tpu_torch/nerf/fused_mlp.py.

#include "distilled_mlp.cuh"

namespace {

using namespace distilled;

// x, d: (3, N) positions and unit directions; out: (4, N) rows sigma, rgb(3).
template <int OCT>
__global__ void __launch_bounds__(NT) eval_kernel(
    const float* __restrict__ x, const float* __restrict__ d, int N,
    const bf16* __restrict__ wg, const float* __restrict__ bg, int depth,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile tile = carve<OCT>(smem, depth);
  load_weights<OCT>(tile, wg, bg, depth);

  const int tid = threadIdx.x;
  const int n_tiles = (N + TR - 1) / TR;
  for (int k = blockIdx.x; k < n_tiles; k += gridDim.x) {
    const int i = k * TR + tid;
    if (tid < TR) {
      const bool in = i < N;
#pragma unroll
      for (int c = 0; c < 3; ++c) tile.pos[c * TR + tid] = in ? x[static_cast<size_t>(c) * N + i] : 0.f;
      const float dx = in ? d[i] : 0.f;
      const float dy = in ? d[static_cast<size_t>(N) + i] : 0.f;
      const float dz = in ? d[2 * static_cast<size_t>(N) + i] : 0.f;
      sh_deg4(dx, dy, dz, tile.cin, tid);
    }
    // also orders this tile's writes after the previous tile's reads
    __syncthreads();

    network<OCT>(tile, depth);

    if (tid < TR && i < N) {
      out[i] = density(tile.hd[tid]);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[static_cast<size_t>(1 + c) * N + i] = sigmoid(tile.rgbl[c * TR + tid]);
    }
  }
}

template <int OCT>
cudaError_t launch(const float* x, const float* d, int N, const void* w, const float* b,
                   int depth, float* out, cudaStream_t stream) {
  cudaError_t err = allow_smem(eval_kernel<OCT>, OCT, depth);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + TR - 1) / TR;
  const dim3 grid(n_tiles < sms ? n_tiles : sms);
  eval_kernel<OCT><<<grid, NT, smem_bytes(OCT, depth), stream>>>(
      x, d, N, static_cast<const bf16*>(w), b, depth, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t k2_smem_bytes(int octaves, int depth) { return smem_bytes(octaves, depth); }

// Weights `w` (bf16) and biases `b` (f32) are packed as the wrapper's
// _pack_weights writes them (K1's layout). Returns the CUDA error code of the
// launch (0 = ok).
int k2_distilled_eval(const float* x, const float* d, int N, const void* w, const float* b,
                      int octaves, int depth, float* out, void* stream) {
  if (N <= 0) return 0;
  if (depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (octaves) {
    case 8:
      return static_cast<int>(launch<8>(x, d, N, w, b, depth, out, st));
    case 10:
      return static_cast<int>(launch<10>(x, d, N, w, b, depth, out, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
