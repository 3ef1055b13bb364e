// The distilled field's MLP on Hopper's tensor cores (sm_90a), shared by K1
// (march_render.cu) and K2 (distilled_eval.cu).
//
// What bounds the network on an H100: arithmetic. A sample costs ~66k
// multiply-adds of bf16 operands summed in f32 against a few dozen bytes, so
// the limit is the tensor cores' bf16 rate, and the design's work is to keep
// them fed.
//
// What the design does: one warpgroup (four warps, 128 threads) owns a tile
// of 64 samples and runs every dense layer as `wgmma` products with the
// samples on M: D (64 samples, N) = A (64 samples, K) . B (K, N), N the
// layer's output rows (128 trunk, 16 head, 64 and 64 colour, 8 for the 3 rgb
// logits) and K its input width in steps of 16.
//  - B is the layer's weight matrix, resident in shared memory for the whole
//    launch in the layout wgmma's descriptor reads without a swizzle: 8x8
//    core matrices of 128 contiguous bytes, [k/8][n/8][n%8][k%8]. The host
//    packs that layout (nerf/fused_mlp.py::_pack_weights), so the kernel's
//    copy is flat.
//  - A comes from registers, and activations never touch shared memory: a
//    layer's f32 accumulator fragment, after bias, ReLU and rounding to bf16,
//    is already laid out as the next layer's A fragments (accumulator columns
//    16k..16k+15 of a thread are exactly its A fragment of k-step k). There
//    is no __syncthreads() between layers; wgmma.fence / commit_group /
//    wait_group order the products.
//  - The encoding is computed straight into A fragments. Its columns are
//    ordered [sin a_0, cos a_0, sin a_1, cos a_1, ..., x, y, z, 0...] (a_m =
//    pi 2^(m % octaves) * position[m / octaves]) so that a thread's column
//    pair (2m, 2m+1) is one sincosf; the host orders the first layer's weight
//    columns to match and zero-pads them to 64.
//  - The colour MLP's input is [head fragment | SH fragment]: the head's 16
//    columns (raw density, 15 geometry features) feed K columns 0..15
//    unshifted, the raw density against a zero weight column, and the
//    degree-4 SH of the direction K columns 16..31.
// Four warpgroups (NWG) share a block (and the weights); while one waits for
// its products another computes sin/cos or an epilogue.
//
// Every dense layer rounds its operands to bf16 and sums in f32, as the TPU
// kernels and the plain PyTorch version (DistilledField.field_T) do; the
// tensor cores sum the same exact products in their own order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace distilled {

typedef __nv_bfloat16 bf16;

constexpr int TR = 64;        // samples (K1: ray slots) of a warpgroup's tile, wgmma's M
constexpr int WG = 128;       // threads of a warpgroup
constexpr int NWG = 4;        // warpgroups of a block, each with a tile of its own (128 registers a thread)
constexpr int WIDTH = 128;    // trunk width
constexpr int KENC = 64;      // encoding columns: 6 * octaves + 3, zero-padded
constexpr int HEAD = 16;      // raw density + 15 geometry features
constexpr int CIN = 32;       // colour input: the head's 16 columns + 16 SH
constexpr int CW = 64;        // colour hidden width
constexpr int NRGB = 8;       // the 3 rgb logits, padded to wgmma's least N
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int n_weights(int depth) {
  return WIDTH * KENC + (depth - 1) * WIDTH * WIDTH + HEAD * WIDTH + CW * CIN + CW * CW + NRGB * CW;
}
__host__ __device__ constexpr int n_biases(int depth) { return depth * WIDTH + HEAD + CW + CW + NRGB; }
// dynamic shared memory of one block: the weights, then the biases
__host__ __device__ constexpr size_t smem_bytes(int depth) {
  return align16(sizeof(bf16) * n_weights(depth)) + align16(sizeof(float) * n_biases(depth));
}

// ---------------------------------------------------------------- wgmma --

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving a use of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The shared-memory descriptor of a K-major B operand (a weight matrix of
// `n_rows` output rows) stored without swizzle as [k/8][n/8][n%8][k%8]: the
// two core matrices of a k-step lie n_rows * 16 bytes apart (the leading
// byte offset, bits 16-29) and neighbouring 8-row groups 128 bytes apart
// (the stride byte offset, bits 32-45), both in units of 16 bytes.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int n_rows) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(n_rows) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// D (64 x 128, f32) = or += A (64 x 16, bf16, registers) . B (16 x 128, bf16, shared memory)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t* a, uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// D (64 x 64, f32) = or += A (64 x 16, bf16, registers) . B (16 x 64, bf16, shared memory)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t* a, uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// D (64 x 16, f32) = or += A (64 x 16, bf16, registers) . B (16 x 16, bf16, shared memory)
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t* a, uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// D (64 x 8, f32) = or += A (64 x 16, bf16, registers) . B (16 x 8, bf16, shared memory)
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t* a, uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t* a, uint64_t desc, int accumulate) {
  if constexpr (N == 128) wgmma_n128(d, a, desc, accumulate);
  else if constexpr (N == 64) wgmma_n64(d, a, desc, accumulate);
  else if constexpr (N == 16) wgmma_n16(d, a, desc, accumulate);
  else wgmma_n8(d, a, desc, accumulate);
}

// acc (64 samples, N) = A (64, 16 * KSTEPS) . W^T for the (N, 16 * KSTEPS)
// weight matrix at shared-memory address `w`; `a` holds the A fragments, 4
// registers a k-step. Returns with the products done.
template <int N, int KSTEPS>
__device__ __forceinline__ void product(float (&acc)[N / 2], const uint32_t* a, uint32_t w) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) wgmma<N>(acc, a + 4 * ks, b_desc(w + ks * N * 32, N), ks > 0);
  wgmma_commit();
  wgmma_wait();
  pin(acc);
}

// Two f32 rounded to nearest-even bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// pack(max(lo, 0), max(hi, 0)) in one instruction.
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t v;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

// Bias, ReLU and rounding to bf16 of a layer's accumulator fragment, written
// as the next layer's A fragments. Thread (g = lane / 4, t = lane % 4) holds
// of each 8-column block j the columns 8j + 2t, 8j + 2t + 1 of tile rows g
// (acc[4j], acc[4j + 1]) and g + 8 (acc[4j + 2], acc[4j + 3]); k-step ks
// wants rows g, g + 8 of columns 16ks + 2t.. in a[4ks], a[4ks + 1] and of
// columns 16ks + 8 + 2t.. in a[4ks + 2], a[4ks + 3].
template <int N>
__device__ __forceinline__ void activate(const float (&acc)[N / 2], const float* __restrict__ bias, int t,
                                         uint32_t* a) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    a[2 * j] = pack_relu(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
    a[2 * j + 1] = pack_relu(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
  }
}

// -------------------------------------------------------------- weights --

// The network in the block's shared memory: the weights' shared-memory
// address, the biases, the trunk's depth. Layer offsets are worked out where
// they are used, so that the struct holds few registers.
struct Net {
  uint32_t w;
  const float* b;
  int depth;
};

// Copies the packed weights (bf16, `wg`) and biases (f32, `bg`) into shared
// memory, 16 bytes a thread step, and makes them visible to wgmma. Every
// thread of the block calls it; it ends synchronised.
__device__ inline Net load_network(unsigned char* smem, const bf16* __restrict__ wg,
                                   const float* __restrict__ bg, int depth) {
  const uint4* src = reinterpret_cast<const uint4*>(wg);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  const int n16 = static_cast<int>(sizeof(bf16) * n_weights(depth) / 16);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = src[i];
  float* sb = reinterpret_cast<float*>(smem + align16(sizeof(bf16) * n_weights(depth)));
  for (int i = threadIdx.x; i < n_biases(depth); i += blockDim.x) sb[i] = bg[i];
  // the weights were written through the generic proxy and are read by wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  return Net{static_cast<uint32_t>(__cvta_generic_to_shared(smem)), sb, depth};
}

// --------------------------------------------------------------- inputs --

// The encoding of tile rows g (position p0) and g + 8 (p1) as the first
// layer's A fragments. Column pair m of this thread's k-step ks, half j is
// m = 8ks + 4j + t: (sin, cos) of angle m for m < 3 * OCT, then (x, y),
// (z, 0), and zeros.
template <int OCT>
__device__ __forceinline__ void encode(const float (&p0)[3], const float (&p1)[3], int t, uint32_t (&enc)[16]) {
  constexpr int NANG = 3 * OCT;
#pragma unroll
  for (int q = 0; q < 8; ++q) {  // q = 2ks + j
    const int m = 4 * q + t;
    float lo0 = 0.f, hi0 = 0.f, lo1 = 0.f, hi1 = 0.f;
    if (4 * q <= NANG + 1) {  // else this pair is padding for every t
      if (m < NANG) {
        const int axis = m / OCT;
        // pi * 2^octave, exact
        const float freq = __int_as_float(0x40490fdb + ((m - axis * OCT) << 23));
        const float x0 = axis == 0 ? p0[0] : (axis == 1 ? p0[1] : p0[2]);
        const float x1 = axis == 0 ? p1[0] : (axis == 1 ? p1[1] : p1[2]);
        sincosf(x0 * freq, &lo0, &hi0);
        sincosf(x1 * freq, &lo1, &hi1);
      } else if (m == NANG) {
        lo0 = p0[0], hi0 = p0[1], lo1 = p1[0], hi1 = p1[1];
      } else if (m == NANG + 1) {
        lo0 = p0[2], lo1 = p1[2];
      }
    }
    enc[2 * q] = pack(lo0, hi0);
    enc[2 * q + 1] = pack(lo1, hi1);
  }
}

// The degree-4 real SH of the unit direction (x, y, z) of one tile row, as
// this thread's part of the colour input's second k-step: columns 2t, 2t + 1
// (`lo`) and 8 + 2t, 9 + 2t (`hi`) of the 16.
__device__ __forceinline__ void sh_fragment(float x, float y, float z, int t, uint32_t& lo, uint32_t& hi) {
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
  if (t == 0) lo = pack(sh[0], sh[1]), hi = pack(sh[8], sh[9]);
  else if (t == 1) lo = pack(sh[2], sh[3]), hi = pack(sh[10], sh[11]);
  else if (t == 2) lo = pack(sh[4], sh[5]), hi = pack(sh[12], sh[13]);
  else lo = pack(sh[6], sh[7]), hi = pack(sh[14], sh[15]);
}

// -------------------------------------------------------------- network --

// The network on a warpgroup's tile. `enc` is the encoding (encode), `sh`
// the SH fragments of rows g (sh[0], sh[2]) and g + 8 (sh[1], sh[3]). Leaves
// in `head` the raw density of rows g and g + 8 (meaningful where t == 0:
// that thread holds head column 0) and in `rgb` this thread's colour logits:
// columns 2t, 2t + 1 of row g (rgb[0], rgb[1]) and of row g + 8 (rgb[2],
// rgb[3]), so t == 0 holds r and g, t == 1 holds b. All 128 threads of the
// warpgroup call it together.
__device__ __forceinline__ void network(const Net& n, const uint32_t (&enc)[16], const uint32_t (&sh)[4], int t,
                                        float (&head)[2], float (&rgb)[4]) {
  constexpr uint32_t W1 = sizeof(bf16) * WIDTH * KENC, WT = sizeof(bf16) * WIDTH * WIDTH;
  constexpr uint32_t WH = sizeof(bf16) * HEAD * WIDTH, WC0 = sizeof(bf16) * CW * CIN, WC1 = sizeof(bf16) * CW * CW;
  uint32_t w = n.w;          // the next layer's weights
  const float* b = n.b;      // and biases
  uint32_t a[32];
  {
    float acc[WIDTH / 2];
    product<WIDTH, KENC / 16>(acc, enc, w);
    activate<WIDTH>(acc, b, t, a);
    w += W1, b += WIDTH;
    for (int l = 0; l < n.depth - 1; ++l) {
      product<WIDTH, WIDTH / 16>(acc, a, w);
      activate<WIDTH>(acc, b, t, a);
      w += WT, b += WIDTH;
    }
  }
  // the head, no ReLU; its 16 columns rounded to bf16 are the colour input's
  // first k-step (the raw density in column 0 meets a zero weight column)
  uint32_t c[8];
  {
    float h[HEAD / 2];
    product<HEAD, WIDTH / 16>(h, a, w);
    const float2 b0 = *reinterpret_cast<const float2*>(b + 2 * t);
    const float2 b1 = *reinterpret_cast<const float2*>(b + 8 + 2 * t);
    h[0] += b0.x, h[1] += b0.y, h[2] += b0.x, h[3] += b0.y;
    h[4] += b1.x, h[5] += b1.y, h[6] += b1.x, h[7] += b1.y;
    head[0] = h[0];
    head[1] = h[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = pack(h[2 * i], h[2 * i + 1]);
    w += WH, b += HEAD;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[4 + i] = sh[i];
  float e[CW / 2];
  product<CW, CIN / 16>(e, c, w);
  activate<CW>(e, b, t, a);
  w += WC0, b += CW;
  product<CW, CW / 16>(e, a, w);
  activate<CW>(e, b, t, a);
  w += WC1, b += CW;
  product<NRGB, CW / 16>(rgb, a, w);
  const float2 br = *reinterpret_cast<const float2*>(b + 2 * t);
  rgb[0] += br.x, rgb[1] += br.y, rgb[2] += br.x, rgb[3] += br.y;
}

// sigma = exp(softplus(h)) - 1 in its stable form
__device__ __forceinline__ float density(float h) {
  return expm1f(fmaxf(h, 0.f) + log1pf(expf(-fabsf(h))));
}
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Sets the kernel's dynamic shared memory limit to what one block needs.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// The card's SM count: both kernels launch one persistent block on each.
inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace distilled
