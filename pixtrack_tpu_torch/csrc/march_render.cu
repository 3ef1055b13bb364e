// K1: whole-ray fused march render of the distilled field, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pixtrack_tpu/nerf/fused_mlp.py::fused_march_render
// (kernel body _march_kernel). For every ray: S stratified midpoint samples
// clipped to [0,1]^3; at each sample the distilled MLP (sin/cos encoding of
// `octaves` octaves, a ReLU trunk of `depth` 128-wide layers, a 16-row head
// giving sigma = expm1(softplus) and 15 geometry features, the degree-4 SH of
// the ray direction computed once per ray, and a 32->64->64->3 colour MLP with
// a sigmoid); front-to-back compositing with the transmittance cutoff applied
// before each sample adds, a last delta of 0.5*dt, and the weighted-mean depth
// where acc > 1e-4. Every dense layer rounds its operands to bf16 and sums in
// f32, as the TPU kernel and the plain PyTorch version do.
//
// What bounds it on an H100: arithmetic. A sample costs ~66k multiply-adds and
// a ray moves 52 bytes to and from device memory, so the kernel does ~10^5
// FMAs per byte: far above the card's ridge point, on any unit. This first
// version runs the products on the FP32 pipes (67 TFLOP/s), not the tensor
// cores, which is the main headroom left for later work (wgmma on bf16).
//
// What the design does about it: a block of 256 threads owns a tile of 64
// rays and walks the S samples in order, so no per-sample tensor ever leaves
// the SM. The whole weight set (~130 KB in bf16) is copied into shared memory
// once per block and reused for all 64*S samples; activations live in shared
// memory as bf16 (they are rounded to bf16 before every product anyway); each
// thread keeps a 4-ray by (rows/16) tile of f32 sums in registers, so one
// shared-memory load feeds several FMAs. Each ray's transmittance, colour,
// alpha and depth stay in the registers of the thread that composites it. A
// tile stops marching once no ray in it can still add colour (all missed, or
// all below the transmittance cutoff), which changes no output.
//
// The network itself is distilled_mlp.cuh, shared with K2. Built by nvcc into
// a shared library with a plain C entry point (k1_march_render), loaded with
// ctypes by pixtrack_tpu_torch/nerf/fused_mlp.py.

#include "distilled_mlp.cuh"

namespace {

using namespace distilled;

// rays: (8, R) rows o(3), d(3), t_near, t_far in grid space (t in NeRF units;
// a miss has t_far <= t_near). out: (5, R) rows alpha, rgb(3), depth.
template <int OCT>
__global__ void __launch_bounds__(NT) march_kernel(
    const float* __restrict__ rays, int R, const bf16* __restrict__ wg,
    const float* __restrict__ bg, int depth, int S, float min_trans, float density_scale,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile tile = carve<OCT>(smem, depth);
  load_weights<OCT>(tile, wg, bg, depth);

  // per-ray state, held by thread `tid` < TR for ray blockIdx.x * TR + tid
  const int tid = threadIdx.x;
  const int ray = blockIdx.x * TR + tid;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  float t_near = 0.f, dt = 0.f, t = 0.f;
  bool valid = false;
  float trans = 1.f, acc = 0.f, dep = 0.f, rgb_acc[3] = {0.f, 0.f, 0.f};
  if (tid < TR) {
    if (ray < R) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = rays[c * R + ray];
        d[c] = rays[(3 + c) * R + ray];
      }
      t_near = rays[6 * R + ray];
      const float t_far = rays[7 * R + ray];
      valid = t_far > t_near;
      dt = fmaxf(t_far - t_near, 0.f) / static_cast<float>(S);
    }
    // SH of the unit direction, once per ray
    const float norm = fmaxf(sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]), 1e-9f);
    sh_deg4(d[0] / norm, d[1] / norm, d[2] / norm, tile.cin, tid);
  }

  for (int s = 0; s < S; ++s) {
    bool alive = false;
    if (tid < TR) {
      t = t_near + (static_cast<float>(s) + 0.5f) * dt;
#pragma unroll
      for (int c = 0; c < 3; ++c) tile.pos[c * TR + tid] = fminf(fmaxf(o[c] + t * d[c], 0.f), 1.f);
      alive = valid && trans > min_trans;
    }
    // nothing left to add in this tile: the remaining samples all weigh 0
    if (!__syncthreads_or(alive)) break;

    network<OCT>(tile, depth);

    if (tid < TR) {
      const float sigma = density(tile.hd[tid]);
      const float delta = (s == S - 1) ? 0.5f * dt : dt;
      const float a = 1.f - expf(-sigma * density_scale * delta);
      const float w = (valid && trans > min_trans) ? a * trans : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb_acc[c] += w * sigmoid(tile.rgbl[c * TR + tid]);
      acc += w;
      dep += w * t;
      trans *= 1.f - a + 1e-10f;
    }
  }

  if (tid < TR && ray < R) {
    out[ray] = acc;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[(1 + c) * R + ray] = rgb_acc[c];
    out[4 * R + ray] = acc > 1e-4f ? dep / fmaxf(acc, 1e-8f) : 0.f;
  }
}

template <int OCT>
cudaError_t launch(const float* rays, int R, const void* w, const float* b, int depth, int S,
                   float min_trans, float density_scale, float* out, cudaStream_t stream) {
  cudaError_t err = allow_smem(march_kernel<OCT>, OCT, depth);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + TR - 1) / TR);
  march_kernel<OCT><<<grid, NT, smem_bytes(OCT, depth), stream>>>(
      rays, R, static_cast<const bf16*>(w), b, depth, S, min_trans, density_scale, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t k1_smem_bytes(int octaves, int depth) { return smem_bytes(octaves, depth); }

// Weights `w` (bf16) and biases `b` (f32) are packed as the wrapper's
// _pack_weights writes them. Returns the CUDA error code of the launch (0 = ok).
int k1_march_render(const float* rays, int R, const void* w, const float* b, int octaves,
                    int depth, int S, float min_trans, float density_scale, float* out,
                    void* stream) {
  if (R <= 0) return 0;
  if (depth < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (octaves) {
    case 8:
      return static_cast<int>(launch<8>(rays, R, w, b, depth, S, min_trans, density_scale, out, st));
    case 10:
      return static_cast<int>(launch<10>(rays, R, w, b, depth, S, min_trans, density_scale, out, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
