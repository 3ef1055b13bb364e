// The distilled field's MLP on a tile of 64 samples, shared by K1
// (march_render.cu) and K2 (distilled_eval.cu), for Hopper (sm_90a).
//
// One block of 256 threads evaluates the network for the 64 samples whose
// grid-space positions sit in shared memory (`pos`, 3 rows of 64) and whose
// colour-input rows 15..31 (the degree-4 SH of the view direction and one
// zero row) are already in `cin`: the sin/cos encoding of OCT octaves, a
// ReLU trunk of `depth` 128-wide layers, a 16-row head (row 0 the raw
// density, rows 1..15 geometry features, left in `hd` as f32) and the
// 32->64->64->3 colour MLP (logits left in `rgbl` as f32). Every dense layer
// rounds its operands to bf16 and sums in f32, as the TPU kernels and the
// plain PyTorch version (DistilledField.field_T) do.
//
// Layout: all weights in bf16 (~131 KB at 10 octaves) and activations in
// shared memory, one block per SM; each thread keeps a 4-sample by
// (rows/16) tile of f32 sums in registers, so one shared-memory load feeds
// several FMAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace distilled {

typedef __nv_bfloat16 bf16;

constexpr int TR = 64;      // samples (K1: rays) per tile
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
// dynamic shared memory of one block: weights, biases, then the tile
__host__ __device__ inline size_t smem_bytes(int octaves, int depth) {
  return align16(sizeof(bf16) * n_weights(octaves, depth)) +
         align16(sizeof(float) * n_biases(depth)) +
         sizeof(bf16) * TR * (enc_pad(octaves) + 2 * WIDTH + CIN) +
         sizeof(float) * TR * (HEAD + NRGB + 3);
}

__device__ __forceinline__ float b2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(bf16& dst, float v) { dst = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float& dst, float v) { dst = v; }

// out[row][s] = act(sum_k W[row][k] * in[k][s] + b[row]) over the tile's TR
// samples. Thread t sums rows {t/16 + 16j} for samples {t%16 + 16m}, m < 4:
// the 16 threads of a half-warp read 16 neighbouring activations, and the
// two row groups of a warp read two broadcast weights.
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

// The block's shared memory, carved in the order smem_bytes counts it.
struct Tile {
  bf16* sw;     // weights [W1 (128, EP) | trunk (depth-1, 128, 128) | head (16, 128) |
                //          colour0 (64, 32) | colour1 (64, 64) | colour2 (3, 64)]
  float* sb;    // the matching biases
  bf16* enc;    // (EP, TR) encoding
  bf16* hA;     // (128, TR) activations, ping
  bf16* hB;     // (128, TR) activations, pong
  bf16* cin;    // (CIN, TR) colour input
  float* hd;    // (HEAD, TR) head output
  float* rgbl;  // (NRGB, TR) colour logits
  float* pos;   // (3, TR) sample positions
};

template <int OCT>
__device__ inline Tile carve(unsigned char* smem, int depth) {
  Tile t;
  t.sw = reinterpret_cast<bf16*>(smem);
  t.sb = reinterpret_cast<float*>(smem + align16(sizeof(bf16) * n_weights(OCT, depth)));
  t.enc = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(t.sb) +
                                  align16(sizeof(float) * n_biases(depth)));
  t.hA = t.enc + enc_pad(OCT) * TR;
  t.hB = t.hA + WIDTH * TR;
  t.cin = t.hB + WIDTH * TR;
  t.hd = reinterpret_cast<float*>(t.cin + CIN * TR);
  t.rgbl = t.hd + HEAD * TR;
  t.pos = t.rgbl + NRGB * TR;
  return t;
}

// Copies the packed weights (bf16, `wg`) and biases (f32, `bg`) into the
// tile's shared memory and zeroes the encoding's padding rows. The caller
// synchronises before the first use.
template <int OCT>
__device__ inline void load_weights(const Tile& t, const bf16* __restrict__ wg,
                                    const float* __restrict__ bg, int depth) {
  const int tid = threadIdx.x;
  // one 16-byte copy per thread step (every block is a multiple of 16 B)
  const uint4* src = reinterpret_cast<const uint4*>(wg);
  uint4* dst = reinterpret_cast<uint4*>(t.sw);
  const int n16 = static_cast<int>(sizeof(bf16) * n_weights(OCT, depth) / 16);
  for (int i = tid; i < n16; i += NT) dst[i] = src[i];
  const int nb = n_biases(depth);
  for (int i = tid; i < nb; i += NT) t.sb[i] = bg[i];
  for (int i = enc_rows(OCT) * TR + tid; i < enc_pad(OCT) * TR; i += NT)
    t.enc[i] = __float2bfloat16_rn(0.f);
}

// Colour-input rows GEO..CIN-1 of sample column `col`: the degree-4 real SH
// of the unit direction (x, y, z), then the zero row.
__device__ inline void sh_deg4(float x, float y, float z, bf16* cin, int col) {
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
  for (int i = 0; i < 16; ++i) cin[(GEO + i) * TR + col] = __float2bfloat16_rn(sh[i]);
  cin[(CIN - 1) * TR + col] = __float2bfloat16_rn(0.f);
}

// The network on the tile's positions; leaves the head in `hd` and the colour
// logits in `rgbl`. Every thread of the block calls it after `pos` and the SH
// rows of `cin` are written and the block has synchronised; it ends
// synchronised.
template <int OCT>
__device__ inline void network(const Tile& t, int depth) {
  const int tid = threadIdx.x;
  const bf16* W1 = t.sw;
  const bf16* WT = W1 + WIDTH * enc_pad(OCT);
  const bf16* WH = WT + (depth - 1) * WIDTH * WIDTH;
  const bf16* WC1 = WH + HEAD * WIDTH;
  const bf16* WC2 = WC1 + CW * CIN;
  const bf16* WC3 = WC2 + CW * CW;
  const float* B1 = t.sb;
  const float* BT = B1 + WIDTH;
  const float* BH = BT + (depth - 1) * WIDTH;
  const float* BC1 = BH + HEAD;
  const float* BC2 = BC1 + CW;
  const float* BC3 = BC2 + CW;

  // encoding rows: [xyz, sin(x f_0..f_{O-1}, y .., z ..), cos(same)]
  for (int i = tid; i < 3 * TR; i += NT) t.enc[i] = __float2bfloat16_rn(t.pos[i]);
  for (int i = tid; i < 3 * OCT * TR; i += NT) {
    const int r = i % TR, q = i / TR;  // q = axis * OCT + octave
    const float ang = t.pos[(q / OCT) * TR + r] * ldexpf(3.14159265358979323846f, q % OCT);
    float sn, cs;
    sincosf(ang, &sn, &cs);
    t.enc[(3 + q) * TR + r] = __float2bfloat16_rn(sn);
    t.enc[(3 + 3 * OCT + q) * TR + r] = __float2bfloat16_rn(cs);
  }
  __syncthreads();

  dense<WIDTH, enc_pad(OCT), true>(W1, B1, t.enc, t.hA);
  __syncthreads();
  bf16* cur = t.hA;
  bf16* nxt = t.hB;
  for (int l = 0; l < depth - 1; ++l) {
    dense<WIDTH, WIDTH, true>(WT + l * WIDTH * WIDTH, BT + l * WIDTH, cur, nxt);
    __syncthreads();
    bf16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  dense<HEAD, WIDTH, false>(WH, BH, cur, t.hd);
  __syncthreads();
  for (int i = tid; i < GEO * TR; i += NT) t.cin[i] = __float2bfloat16_rn(t.hd[TR + i]);
  __syncthreads();
  dense<CW, CIN, true>(WC1, BC1, t.cin, t.hA);
  __syncthreads();
  dense<CW, CW, true>(WC2, BC2, t.hA, t.hB);
  __syncthreads();
  dense<NRGB, CW, false>(WC3, BC3, t.hB, t.rgbl);
  __syncthreads();
}

// sigma = exp(softplus(h)) - 1 in its stable form
__device__ __forceinline__ float density(float h) {
  return expm1f(fmaxf(h, 0.f) + log1pf(expf(-fabsf(h))));
}
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Sets the kernel's dynamic shared memory limit to what one block needs.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int octaves, int depth) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(octaves, depth)));
}

}  // namespace distilled
