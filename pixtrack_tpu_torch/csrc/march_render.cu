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
// Built by nvcc into a shared library with a plain C entry point
// (k1_march_render), loaded with ctypes by pixtrack_tpu_torch/nerf/fused_mlp.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TR = 64;      // rays per block
constexpr int NT = 256;     // threads per block
constexpr int WIDTH = 128;  // trunk width
constexpr int HEAD = 16;    // sigma + 15 geometry features
constexpr int GEO = 15;
constexpr int CIN = 32;     // colour input: 15 geometry + 16 SH + 1 zero row
constexpr int CW = 64;      // colour hidden width
constexpr int NRGB = 3;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int enc_rows(int octaves) { return 3 + 6 * octaves; }
__host__ __device__ constexpr int enc_pad(int octaves) { return (enc_rows(octaves) + 7) / 8 * 8; }

__host__ __device__ inline int n_weights(int octaves, int depth) {
  return WIDTH * enc_pad(octaves) + (depth - 1) * WIDTH * WIDTH + HEAD * WIDTH + CW * CIN +
         CW * CW + NRGB * CW;
}
__host__ __device__ inline int n_biases(int depth) {
  return WIDTH + (depth - 1) * WIDTH + HEAD + CW + CW + NRGB;
}
__host__ __device__ inline size_t smem_bytes(int octaves, int depth) {
  return align16(sizeof(bf16) * n_weights(octaves, depth)) +
         align16(sizeof(float) * n_biases(depth)) +
         sizeof(bf16) * TR * (enc_pad(octaves) + 2 * WIDTH + CIN) +
         sizeof(float) * TR * (HEAD + NRGB + 3);
}

__device__ __forceinline__ float b2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(bf16& dst, float v) { dst = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float& dst, float v) { dst = v; }

// out[row][ray] = act(sum_k W[row][k] * in[k][ray] + b[row]) over the block's
// TR rays. Thread t sums rows {t/16 + 16j} for rays {t%16 + 16m}, m < 4: the
// 16 threads of a half-warp read 16 neighbouring activations, and the two row
// groups of a warp read two broadcast weights.
template <int NOUT, int NIN, bool RELU, typename OutT>
__device__ __forceinline__ void dense(const bf16* __restrict__ W, const float* __restrict__ b,
                                      const bf16* __restrict__ in, OutT* __restrict__ out) {
  constexpr int RPT = (NOUT + 15) / 16;
  const int rg = threadIdx.x & 15;
  const int og = threadIdx.x >> 4;
  if (og >= NOUT) return;
  float acc[RPT][4];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[j][m] = 0.f;
#pragma unroll 4
  for (int k = 0; k < NIN; ++k) {
    float a[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = b2f(in[k * TR + rg + 16 * m]);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int row = og + 16 * j;
      if (row < NOUT) {
        const float w = b2f(W[row * NIN + k]);
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[j][m] = fmaf(w, a[m], acc[j][m]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int row = og + 16 * j;
    if (row < NOUT) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float v = acc[j][m] + b[row];
        if (RELU) v = fmaxf(v, 0.f);
        put(out[row * TR + rg + 16 * m], v);
      }
    }
  }
}

// rays: (8, R) rows o(3), d(3), t_near, t_far in grid space (t in NeRF units;
// a miss has t_far <= t_near). out: (5, R) rows alpha, rgb(3), depth.
template <int OCT>
__global__ void __launch_bounds__(NT) march_kernel(
    const float* __restrict__ rays, int R, const bf16* __restrict__ wg,
    const float* __restrict__ bg, int depth, int S, float min_trans, float density_scale,
    float* __restrict__ out) {
  constexpr int NENC = enc_rows(OCT);
  constexpr int EP = enc_pad(OCT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = n_weights(OCT, depth);
  const int nb = n_biases(depth);
  bf16* sw = reinterpret_cast<bf16*>(smem);
  float* sb = reinterpret_cast<float*>(smem + align16(sizeof(bf16) * nw));
  bf16* enc = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sb) + align16(sizeof(float) * nb));
  bf16* hA = enc + EP * TR;
  bf16* hB = hA + WIDTH * TR;
  bf16* cin = hB + WIDTH * TR;
  float* hd = reinterpret_cast<float*>(cin + CIN * TR);
  float* rgbl = hd + HEAD * TR;
  float* pos = rgbl + NRGB * TR;

  const int tid = threadIdx.x;
  // weights: one 16-byte copy per thread step (every block is a multiple of 16 B)
  {
    const uint4* src = reinterpret_cast<const uint4*>(wg);
    uint4* dst = reinterpret_cast<uint4*>(sw);
    const int n16 = static_cast<int>(sizeof(bf16) * nw / 16);
    for (int i = tid; i < n16; i += NT) dst[i] = src[i];
    for (int i = tid; i < nb; i += NT) sb[i] = bg[i];
  }
  const bf16* W1 = sw;
  const bf16* WT = W1 + WIDTH * EP;
  const bf16* WH = WT + (depth - 1) * WIDTH * WIDTH;
  const bf16* WC1 = WH + HEAD * WIDTH;
  const bf16* WC2 = WC1 + CW * CIN;
  const bf16* WC3 = WC2 + CW * CW;
  const float* B1 = sb;
  const float* BT = B1 + WIDTH;
  const float* BH = BT + (depth - 1) * WIDTH;
  const float* BC1 = BH + HEAD;
  const float* BC2 = BC1 + CW;
  const float* BC3 = BC2 + CW;

  for (int i = NENC * TR + tid; i < EP * TR; i += NT) enc[i] = __float2bfloat16_rn(0.f);

  // per-ray state, held by thread `tid` < TR for ray blockIdx.x * TR + tid
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
    // SH of the unit direction, once per ray: colour-input rows 15..30
    const float norm = fmaxf(sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]), 1e-9f);
    const float x = d[0] / norm, y = d[1] / norm, z = d[2] / norm;
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    const float sh[16] = {
        0.28209479177387814f,
        -0.48860251190291987f * y,
        0.48860251190291987f * z,
        -0.48860251190291987f * x,
        1.0925484305920792f * xy,
        -1.0925484305920792f * yz,
        0.94617469575755997f * zz - 0.31539156525251999f,
        -1.0925484305920792f * xz,
        0.54627421529603959f * (xx - yy),
        0.59004358992664352f * y * (-3.f * xx + yy),
        2.8906114426405538f * xy * z,
        0.45704579946446572f * y * (1.f - 5.f * zz),
        0.3731763325901154f * z * (5.f * zz - 3.f),
        0.45704579946446572f * x * (1.f - 5.f * zz),
        1.4453057213202769f * z * (xx - yy),
        0.59004358992664352f * x * (-xx + 3.f * yy),
    };
#pragma unroll
    for (int i = 0; i < 16; ++i) cin[(GEO + i) * TR + tid] = __float2bfloat16_rn(sh[i]);
    cin[(CIN - 1) * TR + tid] = __float2bfloat16_rn(0.f);
  }

  for (int s = 0; s < S; ++s) {
    bool alive = false;
    if (tid < TR) {
      t = t_near + (static_cast<float>(s) + 0.5f) * dt;
#pragma unroll
      for (int c = 0; c < 3; ++c) pos[c * TR + tid] = fminf(fmaxf(o[c] + t * d[c], 0.f), 1.f);
      alive = valid && trans > min_trans;
    }
    // nothing left to add in this tile: the remaining samples all weigh 0
    if (!__syncthreads_or(alive)) break;

    // encoding rows: [xyz, sin(x f_0..f_{O-1}, y .., z ..), cos(same)]
    for (int i = tid; i < 3 * TR; i += NT) enc[i] = __float2bfloat16_rn(pos[i]);
    for (int i = tid; i < 3 * OCT * TR; i += NT) {
      const int r = i % TR, q = i / TR;  // q = axis * OCT + octave
      const float ang = pos[(q / OCT) * TR + r] * ldexpf(3.14159265358979323846f, q % OCT);
      float sn, cs;
      sincosf(ang, &sn, &cs);
      enc[(3 + q) * TR + r] = __float2bfloat16_rn(sn);
      enc[(3 + 3 * OCT + q) * TR + r] = __float2bfloat16_rn(cs);
    }
    __syncthreads();

    dense<WIDTH, EP, true>(W1, B1, enc, hA);
    __syncthreads();
    bf16* cur = hA;
    bf16* nxt = hB;
    for (int l = 0; l < depth - 1; ++l) {
      dense<WIDTH, WIDTH, true>(WT + l * WIDTH * WIDTH, BT + l * WIDTH, cur, nxt);
      __syncthreads();
      bf16* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    dense<HEAD, WIDTH, false>(WH, BH, cur, hd);
    __syncthreads();
    for (int i = tid; i < GEO * TR; i += NT) cin[i] = __float2bfloat16_rn(hd[TR + i]);
    __syncthreads();
    dense<CW, CIN, true>(WC1, BC1, cin, hA);
    __syncthreads();
    dense<CW, CW, true>(WC2, BC2, hA, hB);
    __syncthreads();
    dense<NRGB, CW, false>(WC3, BC3, hB, rgbl);
    __syncthreads();

    if (tid < TR) {
      const float h0 = hd[tid];
      const float sigma = expm1f(fmaxf(h0, 0.f) + log1pf(expf(-fabsf(h0))));
      const float delta = (s == S - 1) ? 0.5f * dt : dt;
      const float a = 1.f - expf(-sigma * density_scale * delta);
      const float w = (valid && trans > min_trans) ? a * trans : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb_acc[c] += w * (1.f / (1.f + expf(-rgbl[c * TR + tid])));
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
  const size_t smem = smem_bytes(OCT, depth);
  cudaError_t err = cudaFuncSetAttribute(
      march_kernel<OCT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((R + TR - 1) / TR);
  march_kernel<OCT><<<grid, NT, smem, stream>>>(
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
