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
// a ray moves 52 bytes to and from device memory, so the limit is the tensor
// cores' bf16 rate over the samples the rays need: a miss needs none, and the
// transmittance cutoff ends most hit rays well before their last sample.
//
// What the design does about it: the network is distilled_mlp.cuh, shared
// with K2 (wgmma on the bf16 tensor cores, weights resident in shared memory,
// activations in registers), and the kernel walks through it only samples
// that can still add colour:
//  - a first small kernel writes every miss ray's zeros and compacts the hit
//    rays into an index list;
//  - the march is a persistent grid, one block per SM, four warpgroups a
//    block. The 64 rows of a warpgroup's tile are 32 slots of two rows: a
//    slot holds one ray (its step and transmittance in the registers of the
//    four threads whose fragments hold its rows, its constants and sums in
//    shared memory, so that four warpgroups fit the register file) and walks
//    two successive samples of it a step (the network does not care that
//    they belong to one ray; the compositing takes them in order and drops
//    the second if the ray ends at the first). Two samples a step halve the
//    steps of the longest ray, which is what a tile waits for once the list
//    has run dry. When a ray ends (its last sample, or transmittance at or
//    under the cutoff) the slot writes the ray's outputs and takes the next
//    ray of the list from a global atomic counter, so a tile stays full
//    until then;
//  - a sample's products sum over k in an order that does not depend on its
//    row or on its neighbours, so a ray's result does not depend on the slot
//    it ran in: the outputs are bit-equal under a permutation of the rays.
//
// Built by nvcc into a shared library with a plain C entry point
// (k1_march_render), loaded with ctypes by pixtrack_tpu_torch/nerf/fused_mlp.py.

#include "distilled_mlp.cuh"

namespace {

using namespace distilled;

// scratch (four 64-bit words, zeroed by the caller)
constexpr int N_HIT = 0;      // int: hit rays in the list
constexpr int NEXT = 1;       // int: rays handed out beyond every slot's first
constexpr int EVALUATED = 2;  // u64: samples walked through the network, empty slots included
constexpr int LIVE = 3;       // u64: of those, samples of a ray that could still add colour

// First pass: zeros for every miss (t_far <= t_near), the index of every hit
// appended to `hits`.
__global__ void hit_list_kernel(const float* __restrict__ rays, int R, int* __restrict__ hits,
                                unsigned long long* __restrict__ scratch, float* __restrict__ out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t r = static_cast<size_t>(R);
  bool hit = false;
  if (ray < R) {
    hit = rays[7 * r + ray] > rays[6 * r + ray];
    if (!hit) {
#pragma unroll
      for (int c = 0; c < 5; ++c) out[c * r + ray] = 0.f;
    }
  }
  const unsigned votes = __ballot_sync(FULL, hit);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && votes) base = atomicAdd(reinterpret_cast<int*>(scratch + N_HIT), __popc(votes));
  base = __shfl_sync(FULL, base, 0);
  if (hit) hits[base + __popc(votes & ((1u << lane) - 1u))] = ray;
}

// A tile's 64 rows are 32 slots of two rows each: a slot marches one ray, two
// successive samples a step.
constexpr int SLOTS = TR / 2;

// One slot's ray. Its index, its next sample and its transmittance are held
// alike in the registers of the four threads of its rows; the rest lies in
// shared memory (Slot), read and written back each step, so that it holds no
// registers while the network runs.
constexpr int EMPTY = -1, DRY = -2;
struct Ray {
  int id;  // index into the ray set; EMPTY; or DRY, empty with no ray left in the list
  int s;   // the next sample
  float trans;
};
struct __align__(16) Slot {
  float o[3], t_near, d[3], dt;  // fixed for the ray
  float rgb[3], acc, dep;        // its sums so far
};

// dynamic shared memory of one block: the network, every slot's Slot, and
// each warpgroup's count of steps
constexpr size_t k1_smem(int depth) {
  return smem_bytes(depth) + NWG * SLOTS * sizeof(Slot) + NWG * sizeof(unsigned);
}

// The slot takes entry `idx` of the hit list, or learns that the list is dry.
// Thread t == 0 of the slot writes its shared memory; the caller synchronises
// the warp before that is read.
__device__ __forceinline__ void take(Ray& a, Slot* slot, int idx, int n_hit, const int* __restrict__ hits,
                                     const float* __restrict__ rays, size_t r, int S, int t,
                                     uint32_t& sh_lo, uint32_t& sh_hi) {
  a.id = DRY;
  if (idx >= n_hit) return;
  a.id = hits[idx];
  a.s = 0;
  a.trans = 1.f;
  Slot f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.o[c] = rays[c * r + a.id];
    f.d[c] = rays[(3 + c) * r + a.id];
    f.rgb[c] = 0.f;
  }
  f.t_near = rays[6 * r + a.id];
  f.dt = fmaxf(rays[7 * r + a.id] - f.t_near, 0.f) / static_cast<float>(S);
  f.acc = f.dep = 0.f;
  if (t == 0) *slot = f;
  // SH of the unit direction, once per ray
  const float norm = fmaxf(sqrtf(f.d[0] * f.d[0] + f.d[1] * f.d[1] + f.d[2] * f.d[2]), 1e-9f);
  sh_fragment(f.d[0] / norm, f.d[1] / norm, f.d[2] / norm, t, sh_lo, sh_hi);
}

// or of `p` over the 128 threads of warpgroup `wgi` (named barrier 1 + wgi)
__device__ __forceinline__ bool warpgroup_any(bool p, int wgi) {
  int any;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\n"
      "selp.b32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(any)
      : "r"(static_cast<int>(p)), "r"(wgi + 1)
      : "memory");
  return any != 0;
}

// rays: (8, R) rows o(3), d(3), t_near, t_far in grid space (t in NeRF units;
// a miss has t_far <= t_near). out: (5, R) rows alpha, rgb(3), depth. hits:
// the first pass's list.
template <int OCT>
__global__ void __launch_bounds__(NWG * WG, 1) march_kernel(
    const float* __restrict__ rays, int R, const int* __restrict__ hits,
    unsigned long long* __restrict__ scratch, const bf16* __restrict__ wg,
    const float* __restrict__ bg, int depth, int S, float min_trans, float density_scale,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Net net = load_network(smem, wg, bg, depth);

  const int wgi = threadIdx.x >> 7, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t r = static_cast<size_t>(R);
  const int n_hit = *reinterpret_cast<const int*>(scratch + N_HIT);
  // neighbouring warpgroups lie on different SMs, so a short list spreads over the card
  const int n_wg = gridDim.x * NWG;
  const int wg_id = wgi * gridDim.x + blockIdx.x;
  int* next = reinterpret_cast<int*>(scratch + NEXT);

  // this quad's slot: tile rows g and g + 8 of its warp hold two successive
  // samples of one ray, so the rows carry the same direction
  const int q = 8 * ((threadIdx.x >> 5) & 3) + g;
  unsigned char* state = smem + smem_bytes(depth);
  Slot* slot = reinterpret_cast<Slot*>(state) + wgi * SLOTS + q;
  // the counters live in memory too
  unsigned* steps = reinterpret_cast<unsigned*>(state + NWG * SLOTS * sizeof(Slot)) + wgi;
  const bool counts = (threadIdx.x & (WG - 1)) == 0;  // the warpgroup's first thread
  if (counts) *steps = 0;
  Ray ray;
  uint32_t sh[4] = {0u, 0u, 0u, 0u};
  take(ray, slot, wg_id * SLOTS + q, n_hit, hits, rays, r, S, t, sh[0], sh[2]);

  for (;;) {
    // refill the slot if its ray ended in the last step
    const bool need = ray.id == EMPTY;
    int idx = 0;
    if (need && t == 0) idx = n_wg * SLOTS + atomicAdd(next, 1);
    idx = __shfl_sync(FULL, idx, lane & ~3);
    if (need) take(ray, slot, idx, n_hit, hits, rays, r, S, t, sh[0], sh[2]);
    __syncwarp();
    if (!warpgroup_any(ray.id >= 0, wgi)) break;
    if (counts) ++*steps;
    sh[1] = sh[0], sh[3] = sh[2];

    // samples s and s + 1 (the second is walked in vain if the ray ends at the first)
    uint32_t enc[16];
    {
      float p[2][3];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float ts = slot->t_near + (static_cast<float>(ray.s + j) + 0.5f) * slot->dt;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          p[j][c] = ray.id >= 0 ? fminf(fmaxf(slot->o[c] + ts * slot->d[c], 0.f), 1.f) : 0.f;
      }
      encode<OCT>(p[0], p[1], t, enc);
    }

    float head[2], logit[4];
    network(net, enc, sh, t, head, logit);

    const float t_near = slot->t_near, dt = slot->dt;
    float rgb[3] = {slot->rgb[0], slot->rgb[1], slot->rgb[2]}, acc = slot->acc, dep = slot->dep;
    __syncwarp();  // every thread of the slot has read its sums before thread t == 0 writes them
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // a row's raw density, r and g live in its thread t == 0, b in t == 1
      const float h = __shfl_sync(FULL, head[j], lane & ~3);
      const float lr = __shfl_sync(FULL, logit[2 * j], lane & ~3);
      const float lg = __shfl_sync(FULL, logit[2 * j + 1], lane & ~3);
      const float lb = __shfl_sync(FULL, logit[2 * j], (lane & ~3) + 1);
      if (ray.id >= 0) {
        const float ts = t_near + (static_cast<float>(ray.s) + 0.5f) * dt;
        const float sigma = density(h);
        const float delta = (ray.s == S - 1) ? 0.5f * dt : dt;
        const float al = 1.f - expf(-sigma * density_scale * delta);
        const float w = ray.trans > min_trans ? al * ray.trans : 0.f;
        rgb[0] += w * sigmoid(lr);
        rgb[1] += w * sigmoid(lg);
        rgb[2] += w * sigmoid(lb);
        acc += w;
        dep += w * ts;
        ray.trans *= 1.f - al + 1e-10f;
        ++ray.s;
        // nothing left to add: the remaining samples all weigh 0
        if (ray.s == S || !(ray.trans > min_trans)) {
          if (t == 0) {
            out[ray.id] = acc;
#pragma unroll
            for (int c = 0; c < 3; ++c) out[(1 + c) * r + ray.id] = rgb[c];
            out[4 * r + ray.id] = acc > 1e-4f ? dep / fmaxf(acc, 1e-8f) : 0.f;
            atomicAdd(scratch + LIVE, static_cast<unsigned long long>(ray.s));  // the samples it needed
          }
          ray.id = EMPTY;
        }
      }
    }
    if (ray.id >= 0 && t == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) slot->rgb[c] = rgb[c];
      slot->acc = acc, slot->dep = dep;
    }
  }

  if (counts && *steps) atomicAdd(scratch + EVALUATED, static_cast<unsigned long long>(*steps) * TR);
}

template <int OCT>
cudaError_t launch(const float* rays, int R, int* hits, unsigned long long* scratch, const void* w,
                   const float* b, int depth, int S, float min_trans, float density_scale,
                   float* out, cudaStream_t stream) {
  cudaError_t err = allow_smem(march_kernel<OCT>, k1_smem(depth));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  hit_list_kernel<<<(R + 255) / 256, 256, 0, stream>>>(rays, R, hits, scratch, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  march_kernel<OCT><<<sms, NWG * WG, k1_smem(depth), stream>>>(
      rays, R, hits, scratch, static_cast<const bf16*>(w), b, depth, S, min_trans, density_scale,
      out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
size_t k1_smem_bytes(int depth) { return k1_smem(depth); }

// Weights `w` (bf16) and biases `b` (f32) are packed as the wrapper's
// _pack_weights writes them. `hits` is scratch for R ints, `scratch` four
// zeroed 64-bit words that hold, after the launch, the hit rays (word 0), the
// samples walked through the network (word 2) and those of them that belonged
// to a ray that could still add colour (word 3). Returns the CUDA error code
// of the launch (0 = ok).
int k1_march_render(const float* rays, int R, const void* w, const float* b, int octaves,
                    int depth, int S, float min_trans, float density_scale, float* out, int* hits,
                    unsigned long long* scratch, void* stream) {
  if (R <= 0) return 0;
  if (depth < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (octaves) {
    case 8:
      return static_cast<int>(launch<8>(rays, R, hits, scratch, w, b, depth, S, min_trans,
                                        density_scale, out, st));
    case 10:
      return static_cast<int>(launch<10>(rays, R, hits, scratch, w, b, depth, S, min_trans,
                                         density_scale, out, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
