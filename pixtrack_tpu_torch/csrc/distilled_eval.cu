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
// out), ~3,300 FLOP per byte, far above the card's ridge point: the limit is
// the tensor cores' bf16 rate, and after them the FP32 pipes that compute 30
// sincosf a sample and the layers' epilogues.
//
// What the design does about it: the network is distilled_mlp.cuh, shared
// with K1: every layer a chain of wgmma products on the bf16 tensor cores,
// weights resident in shared memory, activations in registers from the
// encoding to the colour logits. The ~131 KB of weights allow one block per
// SM, so the grid is persistent: one block per SM loads the weights once,
// and each of its warpgroups strides over 64-sample tiles of its own, so
// that one warpgroup's sin/cos and epilogues overlap another's products. A
// thread reads the positions and directions of the two tile rows its
// fragments hold and the threads that hold column 0 (sigma, r, g) and
// column 2 (b) of a row store it; the ragged last tile computes on zeros
// and stores nothing.
//
// Built by nvcc into a shared library with a plain C entry point
// (k2_distilled_eval), loaded with ctypes by pixtrack_tpu_torch/nerf/fused_mlp.py.

#include "distilled_mlp.cuh"

namespace {

using namespace distilled;

// x, d: (3, N) positions and unit directions; out: (4, N) rows sigma, rgb(3).
template <int OCT>
__global__ void __launch_bounds__(NWG * WG, 1) eval_kernel(
    const float* __restrict__ x, const float* __restrict__ d, int N,
    const bf16* __restrict__ wg, const float* __restrict__ bg, int depth,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Net net = load_network(smem, wg, bg, depth);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + g;  // this thread's tile rows: row, row + 8
  const size_t n = static_cast<size_t>(N);
  const int n_tiles = (N + TR - 1) / TR;
  for (int k = blockIdx.x * NWG + (threadIdx.x >> 7); k < n_tiles; k += gridDim.x * NWG) {
    const int i0 = k * TR + row, i1 = i0 + 8;
    float p0[3], p1[3], d0[3], d1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p0[c] = i0 < N ? x[c * n + i0] : 0.f;
      p1[c] = i1 < N ? x[c * n + i1] : 0.f;
      d0[c] = i0 < N ? d[c * n + i0] : 0.f;
      d1[c] = i1 < N ? d[c * n + i1] : 0.f;
    }
    uint32_t enc[16], sh[4];
    encode<OCT>(p0, p1, t, enc);
    sh_fragment(d0[0], d0[1], d0[2], t, sh[0], sh[2]);
    sh_fragment(d1[0], d1[1], d1[2], t, sh[1], sh[3]);

    float head[2], rgb[4];
    network(net, enc, sh, t, head, rgb);

    if (t == 0) {
      if (i0 < N) {
        out[i0] = density(head[0]);
        out[n + i0] = sigmoid(rgb[0]);
        out[2 * n + i0] = sigmoid(rgb[1]);
      }
      if (i1 < N) {
        out[i1] = density(head[1]);
        out[n + i1] = sigmoid(rgb[2]);
        out[2 * n + i1] = sigmoid(rgb[3]);
      }
    } else if (t == 1) {
      if (i0 < N) out[3 * n + i0] = sigmoid(rgb[0]);
      if (i1 < N) out[3 * n + i1] = sigmoid(rgb[2]);
    }
  }
}

template <int OCT>
cudaError_t launch(const float* x, const float* d, int N, const void* w, const float* b,
                   int depth, float* out, cudaStream_t stream) {
  cudaError_t err = allow_smem(eval_kernel<OCT>, smem_bytes(depth));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int n_blocks = ((N + TR - 1) / TR + NWG - 1) / NWG;
  const dim3 grid(n_blocks < sms ? n_blocks : sms);
  eval_kernel<OCT><<<grid, NWG * WG, smem_bytes(depth), stream>>>(
      x, d, N, static_cast<const bf16*>(w), b, depth, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t k2_smem_bytes(int depth) { return smem_bytes(depth); }

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
