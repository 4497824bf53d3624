// Cluster-mesh sweep (sm_90a): K3 of the port.
//
// Replaces the Pallas kernel yetanotherconsolegameengine_tpu/ops/
// mesh_clusters.py::_trace_kernel (launched by _run_kernel, its
// pallas_call at :557). It computes what that kernel computes, not its TPU
// mechanics. One thread block per ray tile of 256 binned rays, one thread
// per ray. The block walks the tile's candidate list (cluster ids in
// near-to-far order of their conservative entry distance) and for each
// entry:
//   - the threads copy the cluster's (12, kc) Woop block (rows U x/y/z/c,
//     V x/y/z/c, W x/y/z/c; 12 KB at kc=256, 24 KB at kc=512) into shared
//     memory together;
//   - each thread tests its ray against the kc triangles in fp32:
//       ou = Ux*ox + Uy*oy + Uz*oz + Uc   du = Ux*dx + Uy*dy + Uz*dz  (V, W alike)
//       t = -ow / dw,  u = ou + t*du,  v = ov + t*dv
//       valid = u, v, 1-u-v >= -1e-3  and  t > tmin (strict, per ray)
//     and keeps the winner: the lexicographic minimum of (key(t), flat
//     triangle id = cluster*kc + k), key(t) = t's bits with the low `qmask`
//     bits cleared (qmask 0: exact t). Visit order then does not matter.
// Before every entry a block-wide vote (__syncthreads_or) asks whether any
// ray could still improve: key(entry t) <= its best key. In
// any-hit mode a ray that already has a hit no longer votes. No triangle
// of a later entry is nearer than its entry distance, so in nearest mode
// the exit never changes a result.
//
// Rays are rows of 8 floats: o (3), d (3), tmin, tinit. tinit is the
// ray's starting best key (its tmax) and -inf for a ray that takes no part.
// Outputs per ray: the winner's t (3e38 with no hit) and flat triangle id
// (-1 with no hit); per tile: the entries visited.
//
// Not carried over from the TPU kernel: the hi/lo-bf16 K=12 matmul, the
// approximate reciprocal + Newton step, the winner packed into t's low
// mantissa bits (the thread keeps its winner's cluster id itself), the
// SMEM list-chunk DMA, the NBUF pipeline and its drain, VISIT_BATCH and
// the 128-padding of the lists.
//
// What bounds it on this card: the ray-triangle arithmetic, ~35 fp32
// operations and 12 shared-memory broadcast reads per test; the block's
// copy of a cluster is 12 KB-24 KB from L2/HBM once per entry, shared by
// 256 rays. Arithmetic follows ops/cluster_kernel.py::trace_tiles_plain
// operation by operation (built with -fmad=false), so both give the same
// bits.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 256;   // rays per tile = threads per block
constexpr int kRows = 12;    // Woop rows per cluster block
constexpr float kNoHit = 3.0e38f;

__device__ __forceinline__ float key_of(float t, int qmask) {
  return __int_as_float(__float_as_int(t) & ~qmask);
}

__global__ void __launch_bounds__(kTile) cluster_sweep_kernel(
    const int* __restrict__ lens, const int* __restrict__ ids,
    const float* __restrict__ entry_t, const float* __restrict__ gmat,
    const float* __restrict__ rays, int n_lists, int kc, int any_hit,
    int qmask, float* __restrict__ out_t, int* __restrict__ out_win,
    int* __restrict__ out_steps) {
  extern __shared__ float4 smem4[];
  float* blk = reinterpret_cast<float*>(smem4);
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t r = (size_t)tile * kTile + lane;
  const float* ray = rays + r * 8;
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5];
  const float tmin = ray[6];
  float best_key = key_of(ray[7], qmask);
  float best_t = kNoHit;
  int best_id = -1;

  const int n = lens[tile];
  const int* list = ids + (size_t)tile * n_lists;
  const float* list_t = entry_t + (size_t)tile * n_lists;
  const int n4 = kRows * kc / 4;
  int e = 0;
  for (; e < n; ++e) {
    const float bound = (any_hit && best_id >= 0) ? -CUDART_INF_F : best_key;
    if (!__syncthreads_or(key_of(list_t[e], qmask) <= bound)) break;
    const int cid = list[e];
    __syncthreads();   // every thread is done with the previous block
    const float4* src = reinterpret_cast<const float4*>(gmat) + (size_t)cid * n4;
    for (int i = lane; i < n4; i += kTile) smem4[i] = src[i];
    __syncthreads();
    const int base = cid * kc;
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      const float ou = ((blk[k] * ox + blk[kc + k] * oy) + blk[2 * kc + k] * oz)
                       + blk[3 * kc + k];
      const float du = (blk[k] * dx + blk[kc + k] * dy) + blk[2 * kc + k] * dz;
      const float ov = ((blk[4 * kc + k] * ox + blk[5 * kc + k] * oy)
                        + blk[6 * kc + k] * oz) + blk[7 * kc + k];
      const float dv = (blk[4 * kc + k] * dx + blk[5 * kc + k] * dy)
                       + blk[6 * kc + k] * dz;
      const float ow = ((blk[8 * kc + k] * ox + blk[9 * kc + k] * oy)
                        + blk[10 * kc + k] * oz) + blk[11 * kc + k];
      const float dw = (blk[8 * kc + k] * dx + blk[9 * kc + k] * dy)
                       + blk[10 * kc + k] * dz;
      const float t = -ow / dw;
      const float u = ou + t * du;
      const float v = ov + t * dv;
      // NaN (degenerate or padding slot) fails every comparison.
      if (u >= -1e-3f && v >= -1e-3f && (1.0f - u) - v >= -1e-3f && t > tmin) {
        const float key = key_of(t, qmask);
        const int flat = base + k;
        if (key < best_key || (key == best_key && flat < best_id)) {
          best_key = key;
          best_t = t;
          best_id = flat;
        }
      }
    }
  }
  out_t[r] = best_t;
  out_win[r] = best_id;
  if (lane == 0) out_steps[tile] = e;
}

}  // namespace

// lens (n_tiles,) i32; ids (n_tiles, n_lists) i32; entry_t (n_tiles,
// n_lists) f32; gmat (C, 12, kc) f32; rays (n_tiles*256, 8) f32. Returns
// a cudaError_t (0 on success).
extern "C" int yacge_cluster_launch(
    const int* lens, const int* ids, const float* entry_t, const float* gmat,
    const float* rays, int n_tiles, int n_lists, int kc, int any_hit,
    int qmask, float* out_t, int* out_win, int* out_steps, void* stream_ptr) {
  if (n_tiles == 0) return 0;
  if (kc <= 0 || kc % 4 != 0 || kRows * kc * (int)sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t smem = (size_t)kRows * kc * sizeof(float);
  cluster_sweep_kernel<<<n_tiles, kTile, smem, stream>>>(
      lens, ids, entry_t, gmat, rays, n_lists, kc, any_hit, qmask, out_t,
      out_win, out_steps);
  return (int)cudaGetLastError();
}
