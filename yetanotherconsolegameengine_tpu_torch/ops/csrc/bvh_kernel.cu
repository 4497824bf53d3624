// The BVH walk (sm_90a): one thread a ray, the whole skip-link walk in it.
//
// Replaces the JAX package's device loop yetanotherconsolegameengine_tpu/
// ops/mesh_bvh.py::intersect_mesh (its jax.lax.while_loop at :364-367, with
// the narrowing to P/4 and P/16), which has no pallas_call: on the TPU the
// whole sweep is one program. The port's plain version (ops/mesh_bvh.py
// ::_walk) runs the same walk as lockstep torch rounds that the host drives.
// Here a ray's walk is a loop in its thread, and a sweep is one launch with
// no host wait:
//
//   node = 0; t = tmax
//   while node < n_nodes:
//     row = rows[node]                 (bmin, bmax, skip, count, 4 triangles)
//     slab test of the row's box against [tmin, t]
//     a leaf whose box is hit: double-sided Moller-Trumbore on its count
//       triangles; the first of equal minima wins, and only when strictly
//       nearer than t
//     node = node + 1 on an internal box hit, else the skip link
//
// Skip links point forward in DFS pre-order, so every step raises node and
// the loop ends within n_nodes steps; the step counter caps it there, which
// no well-formed tree reaches. A thread computes, step for step, what its
// lane of the plain walk computes, in the same operation order (dot
// products ((a0*b0 + a1*b1) + a2*b2), cross products component-wise, IEEE
// division for 1/det and 1/d, NaN-propagating min and max as torch.minimum
// / amax give them, strict < scans for the first of equal minima), built
// with -fmad=false: the outputs equal the plain walk's bit for bit. A lane
// the plain walk has finished changes nothing in its later rounds, so
// running each ray only until its own end changes no result.
//
// What bounds it on this card: neither bytes nor arithmetic. The work a ray
// needs is ~13 node visits on the bunny's primary rays (at most 131), each
// a 240-byte row read through L1 (__ldg, 15 float4 loads, the 52 triangle
// floats only for a leaf whose box is hit) and ~24 fp32 operations, plus
// ~60 per triangle test. A warp runs as long as its longest ray, and the
// rows' loads are dependent and scattered, so the kernel is latency- and
// divergence-bound. One thread a ray keeps the design right and simple; a
// shared-memory copy of the top of the tree and reordering rays into
// coherent warps are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kLeafK = 4;                 // triangles per node row
constexpr int kTri = 13;                  // floats per triangle: a e1 e2 n mat
constexpr int kRow = 8 + kTri * kLeafK;   // 60 floats: 240 bytes, 15 float4
constexpr int kRow4 = kRow / 4;
constexpr float kInf = 3.0e38f;           // ops/intersect.py INF
constexpr int kThreads = 128;
static_assert(kRow % 4 == 0, "node rows must be whole float4s");

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
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

// Double-sided Moller-Trumbore on triangle `k` of a leaf's 52 floats, in
// the plain walk's operation order.
__device__ __forceinline__ Tri moller_trumbore(const float* tri, int k,
                                               float ox, float oy, float oz,
                                               float dx, float dy, float dz) {
  const float* p = tri + k * kTri;
  const float ax = p[0], ay = p[1], az = p[2];
  const float e1x = p[3], e1y = p[4], e1z = p[5];
  const float e2x = p[6], e2y = p[7], e2z = p[8];
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

__device__ __forceinline__ void load_tris(const float4* r4, float* tri) {
#pragma unroll
  for (int i = 0; i < kTri * kLeafK / 4; ++i) {
    const float4 q = __ldg(r4 + 2 + i);
    tri[4 * i] = q.x;
    tri[4 * i + 1] = q.y;
    tri[4 * i + 2] = q.z;
    tri[4 * i + 3] = q.w;
  }
}

__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float4* __restrict__ rows, int n_nodes,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin, const float* __restrict__ tmax,
                int n_rays, float* __restrict__ out_t,
                float* __restrict__ out_n, float* __restrict__ out_u,
                float* __restrict__ out_v, int* __restrict__ out_mat,
                unsigned char* __restrict__ out_hit) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float t_lo = tmin[i], t_hi = tmax[i];
  float t = t_hi, nx = 0.0f, ny = 0.0f, nz = 0.0f, wm = 0.0f;
  float bu = 0.0f, bv = 0.0f;
  float tri[kTri * kLeafK];
  int node = 0;
  for (int step = 0; node < n_nodes && step < n_nodes; ++step) {
    const float4* r4 = rows + (size_t)node * kRow4;
    const float4 h0 = __ldg(r4), h1 = __ldg(r4 + 1);
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
    if (box_hit && is_leaf) {
      load_tris(r4, tri);
      float best = kInf, cu = 0.0f, cv = 0.0f;
      int kk = 0;
#pragma unroll
      for (int k = 0; k < kLeafK; ++k) {
        const Tri c = moller_trumbore(tri, k, ox, oy, oz, dx, dy, dz);
        const bool valid = static_cast<float>(k) < count && c.ok &&
                           c.tt >= t_lo && c.tt < t;
        const float tk = valid ? c.tt : kInf;
        if (k == 0 || tk < best) {   // the first of equal minima
          best = tk;
          kk = k;
          cu = c.u;
          cv = c.v;
        }
      }
      if (best < t) {
        t = best;
        bu = cu;
        bv = cv;
#pragma unroll
        for (int k = 0; k < kLeafK; ++k) {
          if (k == kk) {
            nx = tri[k * kTri + 9];
            ny = tri[k * kTri + 10];
            nz = tri[k * kTri + 11];
            wm = tri[k * kTri + 12];
          }
        }
      }
    } else if (kInf < t) {
      // No candidate: the plain walk's row minimum is INF, which still
      // wins over a t above INF (a tmax of inf), with triangle 0's data.
      load_tris(r4, tri);
      const Tri c = moller_trumbore(tri, 0, ox, oy, oz, dx, dy, dz);
      t = kInf;
      bu = c.u;
      bv = c.v;
      nx = tri[9];
      ny = tri[10];
      nz = tri[11];
      wm = tri[12];
    }
    node = box_hit && !is_leaf ? node + 1 : static_cast<int>(h1.z);
  }
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

}  // namespace

extern "C" int yacge_bvh_launch(const float* rows, int n_nodes,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax,
                                int n_rays, float* out_t, float* out_n,
                                float* out_u, float* out_v, int* out_mat,
                                unsigned char* out_hit, void* stream_ptr) {
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  bvh_walk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream_ptr>>>(
      reinterpret_cast<const float4*>(rows), n_nodes, o, d, tmin, tmax,
      n_rays, out_t, out_n, out_u, out_v, out_mat, out_hit);
  return (int)cudaGetLastError();
}
