// The BVH walk (sm_90a): a lane group of four threads a ray, the node
// headers staged in shared memory, triangles in 64-byte records.
//
// Replaces the JAX package's device loop yetanotherconsolegameengine_tpu/
// ops/mesh_bvh.py::intersect_mesh (its jax.lax.while_loop at :364-367, with
// the narrowing to P/4 and P/16), which has no pallas_call: on the TPU the
// whole sweep is one program. The port's plain version (ops/mesh_bvh.py
// ::_walk) runs the same walk as lockstep torch rounds that the host drives.
// Here a ray's walk is a loop in its lane group, and a sweep is one launch
// with no host wait:
//
//   node = 0; t = tmax
//   while node < n_nodes:
//     head = heads[node]               (bmin, bmax, skip, count: 32 bytes)
//     slab test of the head's box against [tmin, t]
//     a leaf whose box is hit: double-sided Moller-Trumbore on its count
//       triangles (tris[node, k], 64 bytes each); the first of equal minima
//       wins, and only when strictly nearer than t
//     node = node + 1 on an internal box hit, else the skip link
//
// Skip links point forward in DFS pre-order, so every step raises node and
// the loop ends within n_nodes steps; the step counter caps it there, which
// no well-formed tree reaches. A group computes, step for step, what its
// lane of the plain walk computes, in the same operation order (dot
// products ((a0*b0 + a1*b1) + a2*b2), cross products component-wise, IEEE
// division for 1/det and 1/d, NaN-propagating min and max as torch.minimum
// / amax give them, the first of equal minima), built with -fmad=false: the
// outputs equal the plain walk's bit for bit. A lane the plain walk has
// finished changes nothing in its later rounds, so running each ray only
// until its own end changes no result. The visit order stays the skip-link
// pre-order: a near-child-first or stack order would change which of two
// equal hits wins.
//
// What bounds it on this card: neither bytes nor arithmetic. A ray makes
// ~33 node visits on the bunny's LBVH (up to ~500), each ~25 fp32
// operations on a 32-byte header plus ~57 per triangle test at a leaf whose
// box is hit; the least time for the bunny's 28,800 primary rays is ~1.5 us
// (chip_smoke.py::walk_bound). Each visit depends on the one before, so the
// walk is bound by the latency of its loads and its dependent arithmetic
// (the slab test's min/max chain, the IEEE divisions of the triangle
// tests, the group's shuffles) and by divergence: a warp runs as long as
// its longest ray, and rays end after 1 to ~500 visits.
// What the design does about each:
//
// - Four lanes a ray (kLanes). The group's lanes all run the box test on
//   the same header and compute the same values, so they agree on every
//   branch without exchanging anything. At a leaf whose box is hit, lane k
//   tests triangle k, so the four tests (each with its IEEE division) run
//   side by side, and the group's four 64-byte records are 256 contiguous
//   bytes, read as four aligned float4s a lane. The group takes the least
//   (tk, k) lexicographically with __shfl_xor_sync, which is the serial
//   scan's first of equal minima (none valid: triangle 0, as the plain
//   walk's argmin gives), then the winner's u, v, n and mat from its lane.
//   A warp holds 8 rays, not 32, so a sweep fills 4x as many warps and a
//   warp waits for the longest of 8 rays. Every shuffle names only its own
//   group's lanes: the groups of a warp diverge.
// - Headers in shared memory. At block start the first n_shared headers
//   are copied in with cp.async and read from there; the rest, the end of
//   the pre-order, through __ldg. The wrapper stages at most 128 KB
//   (mesh_bvh.HEAD_BUDGET): every tree the port's scenes build (1,023 to
//   4,095 nodes, 33 to 131 KB) fits whole, and the other half of the SM's
//   L1 and shared memory keeps the triangle records in L1 (an 8,191-node
//   table staged whole measured slower than none).
// - One block of 1,024 threads an SM (kBlockRays rays, 55 registers a
//   thread: the registers hold one such block), so 32 warps share one
//   staged table. At most SMs x resident blocks are launched; each warp
//   loops over batches of 8 rays, interleaved over the blocks, so the
//   staging is paid once a block and a warp whose rays end takes the next
//   batch without waiting for the rest of its block.
// - The slab test's NaN-propagating min and max are single min.NaN /
//   max.NaN instructions, which shortens each visit's dependent chain.
//
// What was tried and measured slower on this card: loading both
// possible next headers ahead of the box test, testing a leaf's triangles
// before its box test is known, a ballot that skips the shuffles at a
// leaf with no candidate, and blocks of 256 or 512 threads.

#include <cuda_runtime.h>

namespace {

constexpr int kLeafK = 4;                 // triangles per leaf
constexpr int kHead4 = 2;                 // float4s a node header
constexpr int kTri4 = 4;                  // float4s a triangle record
constexpr int kLanes = 4;                 // threads a ray
constexpr int kBlockRays = 256;           // rays a block walks at a time
constexpr int kThreads = kBlockRays * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRays = 32 / kLanes;    // rays a warp walks at a time
constexpr float kInf = 3.0e38f;           // ops/intersect.py INF
constexpr unsigned kGroupBits = (1u << kLanes) - 1u;
static_assert(kLeafK % kLanes == 0, "each lane tests whole triangles");

// NaN if either operand is NaN, as torch.minimum / torch.maximum (one
// instruction each on sm_80 and later). Of +0 and -0 either may come back;
// the slab test only compares its t0 and t1, so that changes no result.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// _safe_div(1, x): x pushed away from zero to +-1e-12, then IEEE division.
__device__ __forceinline__ float safe_inv(float x) {
  const float s = fabsf(x) < 1e-12f ? (x < 0.0f ? -1e-12f : 1e-12f) : x;
  return 1.0f / s;
}

struct Tri {
  float tt, u, v;
  bool ok;   // the candidate passes every test but tmin <= tt < t
};

// A triangle record's first three float4s: a (q0.xyz), e1 (q0.w, q1.xy),
// e2 (q1.zw, q2.x); then n (q2.yzw) and mat (q3.x).
// Double-sided Moller-Trumbore in the plain walk's operation order.
__device__ __forceinline__ Tri moller_trumbore(float4 q0, float4 q1, float4 q2,
                                               float ox, float oy, float oz,
                                               float dx, float dy, float dz) {
  const float ax = q0.x, ay = q0.y, az = q0.z;
  const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
  const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
  const float hx = dy * e2z - dz * e2y;   // cross3(d, e2)
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float det = (e1x * hx + e1y * hy) + e1z * hz;
  const float inv_det = safe_inv(det);
  const float sx = ox - ax, sy = oy - ay, sz = oz - az;
  const float u = ((sx * hx + sy * hy) + sz * hz) * inv_det;
  const float qx = sy * e1z - sz * e1y;   // cross3(s, e1)
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = ((dx * qx + dy * qy) + dz * qz) * inv_det;
  const float tt = ((e2x * qx + e2y * qy) + e2z * qz) * inv_det;
  Tri r;
  r.tt = tt;
  r.u = u;
  r.v = v;
  r.ok = fabsf(det) >= 1e-8f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
         u + v <= 1.0f;
  return r;
}

__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float4* __restrict__ heads,
                const float4* __restrict__ tris, int n_nodes, int n_shared,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin, const float* __restrict__ tmax,
                int n_rays, float* __restrict__ out_t,
                float* __restrict__ out_n, float* __restrict__ out_u,
                float* __restrict__ out_v, int* __restrict__ out_mat,
                unsigned char* __restrict__ out_hit) {
  extern __shared__ float4 s_heads[];
  // Stage the first n_shared headers, 16 bytes a cp.async, once a block.
  for (int j = threadIdx.x; j < kHead4 * n_shared; j += kThreads) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(s_heads + j));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(heads + j)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int k = lane & (kLanes - 1);       // this lane's first triangle
  const int first = lane & ~(kLanes - 1);  // the group's first lane
  const unsigned group = kGroupBits << first;
  // Warp w of block b walks batches w * gridDim.x + b, then every
  // kWarps * gridDim.x on: a warp starts its next batch when its own rays
  // end, and a sweep of fewer batches than the grid holds is spread over
  // every block.
  for (int batch = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;;
       batch += kWarps * gridDim.x) {
    // The group's lanes share i, so a group past the end leaves whole;
    // later batches lie further on. Nothing below syncs the block.
    const int i = batch * kWarpRays + lane / kLanes;
    if (i >= n_rays) break;
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const float t_lo = tmin[i], t_hi = tmax[i];
    float t = t_hi, nx = 0.0f, ny = 0.0f, nz = 0.0f, wm = 0.0f;
    float bu = 0.0f, bv = 0.0f;
    int node = 0;
    for (int step = 0; node < n_nodes && step < n_nodes; ++step) {
      float4 h0, h1;   // the header: from the staged copy, else through L1
      if (node < n_shared) {
        h0 = s_heads[kHead4 * node];
        h1 = s_heads[kHead4 * node + 1];
      } else {
        h0 = __ldg(heads + kHead4 * node);
        h1 = __ldg(heads + kHead4 * node + 1);
      }
      const float tax = (h0.x - ox) * ix, tay = (h0.y - oy) * iy,
                  taz = (h0.z - oz) * iz;
      const float tbx = (h0.w - ox) * ix, tby = (h1.x - oy) * iy,
                  tbz = (h1.y - oz) * iz;
      const float t0 = max_nan(max_nan(min_nan(tax, tbx), min_nan(tay, tby)),
                               min_nan(taz, tbz));
      const float t1 = min_nan(min_nan(max_nan(tax, tbx), max_nan(tay, tby)),
                               max_nan(taz, tbz));
      const bool box_hit = t0 <= t1 && t1 >= t_lo && t0 <= t;
      const float count = h1.w;
      const bool is_leaf = count > 0.0f;
      const float4* rec = tris + (size_t)node * kLeafK * kTri4;
      if (box_hit && is_leaf) {
        // This lane's triangles k, k + kLanes, ...: the first of its equal
        // minima, with the winner's u, v, normal and material.
        float best = kInf, cu = 0.0f, cv = 0.0f, wx = 0.0f, wy = 0.0f,
              wz = 0.0f, wmat = 0.0f;
        int kk = k;
        float4 q[kLeafK / kLanes][kTri4];   // all loads issued before a test
#pragma unroll
        for (int j = 0; j < kLeafK / kLanes; ++j)
#pragma unroll
          for (int m = 0; m < kTri4; ++m)
            q[j][m] = __ldg(rec + (k + j * kLanes) * kTri4 + m);
#pragma unroll
        for (int j = 0; j < kLeafK / kLanes; ++j) {
          const int kt = k + j * kLanes;
          const float4 q2 = q[j][2], q3 = q[j][3];
          const Tri c =
              moller_trumbore(q[j][0], q[j][1], q2, ox, oy, oz, dx, dy, dz);
          const bool valid = static_cast<float>(kt) < count && c.ok &&
                             c.tt >= t_lo && c.tt < t;
          const float tk = valid ? c.tt : kInf;
          if (j == 0 || tk < best) {
            best = tk;
            kk = kt;
            cu = c.u;
            cv = c.v;
            wx = q2.y;
            wy = q2.z;
            wz = q2.w;
            wmat = q3.x;
          }
        }
        // The group's least (tk, k), lexicographically. tk is never NaN
        // (a NaN t fails tt < t), so this is a total order and every lane
        // ends with the same winner.
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1) {
          const float ob = __shfl_xor_sync(group, best, off);
          const int ok = __shfl_xor_sync(group, kk, off);
          if (ob < best || (ob == best && ok < kk)) {
            best = ob;
            kk = ok;
          }
        }
        if (best < t) {
          const int src = first | (kk & (kLanes - 1));
          t = best;
          bu = __shfl_sync(group, cu, src);
          bv = __shfl_sync(group, cv, src);
          nx = __shfl_sync(group, wx, src);
          ny = __shfl_sync(group, wy, src);
          nz = __shfl_sync(group, wz, src);
          wm = __shfl_sync(group, wmat, src);
        }
      } else if (kInf < t) {
        // No candidate: the plain walk's row minimum is INF, which still
        // wins over a t above INF (a tmax of inf), with triangle 0's data.
        // Every lane reads it, so the group stays in agreement.
        const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1), q2 = __ldg(rec + 2),
                     q3 = __ldg(rec + 3);
        const Tri c = moller_trumbore(q0, q1, q2, ox, oy, oz, dx, dy, dz);
        t = kInf;
        bu = c.u;
        bv = c.v;
        nx = q2.y;
        ny = q2.z;
        nz = q2.w;
        wm = q3.x;
      }
      node = box_hit && !is_leaf ? node + 1 : static_cast<int>(h1.z);
    }
    if (k != 0) continue;
    const bool hit = t < t_hi;
    if ((nx * dx + ny * dy) + nz * dz >= 0.0f) {   // face the ray
      nx = -nx;
      ny = -ny;
      nz = -nz;
    }
    out_t[i] = hit ? t : kInf;
    out_n[3 * i] = nx;
    out_n[3 * i + 1] = ny;
    out_n[3 * i + 2] = nz;
    out_u[i] = bu;
    out_v[i] = bv;
    out_mat[i] = static_cast<int>(wm);
    out_hit[i] = hit;
  }
}

}  // namespace

// The walk on `stream`: heads (n_nodes, 8) f32, tris (n_nodes, 4, 16) f32,
// both 16-byte aligned; the first n_shared headers staged in shared memory
// (n_shared * 32 bytes), `blocks` blocks. Returns a cudaError_t (0 on
// success), that of cudaFuncSetAttribute above 48 KB too.
extern "C" int yacge_bvh_launch(const float* heads, const float* tris,
                                int n_nodes, int n_shared, int blocks,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax,
                                int n_rays, float* out_t, float* out_n,
                                float* out_u, float* out_v, int* out_mat,
                                unsigned char* out_hit, void* stream_ptr) {
  if (n_rays == 0) return 0;
  if (n_shared < 0 || n_shared > n_nodes || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = n_shared * kHead4 * (int)sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bvh_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // clear it: the next launch reports its own
      return (int)err;
    }
  }
  bvh_walk_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream_ptr>>>(
      reinterpret_cast<const float4*>(heads),
      reinterpret_cast<const float4*>(tris), n_nodes, n_shared, o, d, tmin,
      tmax, n_rays, out_t, out_n, out_u, out_v, out_mat, out_hit);
  return (int)cudaGetLastError();
}

// The walk kernel's limits on the current device, into out[0..4]: the
// dynamic shared memory a block may opt in to, the SMs, the blocks an SM
// holds with `smem` bytes of staged headers, kThreads and kLanes.
extern "C" int yacge_bvh_limits(int smem, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        bvh_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], bvh_walk_kernel, kThreads, smem);
  out[3] = kThreads;
  out[4] = kLanes;
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
