// The primitive tables of a wavefront sweep (sm_90a): one thread a ray,
// every row of the seven tables tested in it, one launch a sweep.
//
// Replaces no Pallas kernel. The JAX package's primitive pass is XLA ops
// (yetanotherconsolegameengine_tpu/ops/intersect.py, the seven intersectors
// and their merges), and so is the port's plain version, the loop over
// ops/intersect.py::INTERSECTORS in intersect_scene. On the card that loop
// is ~470 small torch kernels a call, each type building (P, N)
// temporaries that later ops gather again; the wavefront's sweeps of a
// museum frame spent most of their device time there for 24 rows. Here a
// sweep reads each ray once, tests the rows in registers and writes its
// winner once.
//
// A thread computes, for its ray, what the plain loop computes for that
// lane, in the same operation order: dot products summed x + y + z, every
// product and sum its own rounding (built with -fmad=false), 1/x and x/y
// by IEEE division, the epsilons and literals rounded from the double as
// torch rounds a Python float, torch's NaN-propagating clamp, minimum and
// maximum, amax and amin as torch's reductions fold them, argmax and
// argmin taking the first of equal values. Within a type the first
// masked-in row of least t wins (argmin's order); across types spheres,
// boxes, rects, cylinders, disks, planes and triangles, a later type
// winning only when strictly nearer (merge). The winner's normal and u, v
// come from o + t * d (spheres, boxes, cylinders), the row's own pu, pv
// (rects) or the barycentrics (triangles), as in the loop. So the outputs
// equal the plain loop's bit for bit.
//
// What bounds it on this card: neither bytes (24 bytes a ray in for o and
// d, plus 4 for each per-lane tmin or tmax; 29 out) nor operations (a few
// dozen a row), but the launch and the latency of each thread's chain over
// the rows; the rows are the same for every ray. So every thread reads the
// tables (their columns as the scene holds them, padded rows and masks
// included) from global memory, where a warp reads one address a row and L1
// serves the rest of the block; staging them in shared memory first was
// slower on the museum's sweeps (PERF.md § 6). An empty table is a loop of
// no rows. The wrapper builds the column table once a scene, allocates the
// outputs, and the launch neither allocates nor waits, so CUDA graphs
// capture it.

#include <cuda_runtime.h>

#include "torch_order.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTables = 7;
constexpr int kCols = 39;

// ops/intersect.py's literals as torch rounds them to float32: from the
// Python float (a double), once.
constexpr float kInf = static_cast<float>(3.0e38);
constexpr float kEps8 = static_cast<float>(1e-8);
constexpr float kEps6 = static_cast<float>(1e-6);
constexpr float kTiny = static_cast<float>(1e-20);

// Column indices, in ops/intersect.py::PRIM_COLUMNS's order.
enum Col {
  kSphCenter, kSphRadius, kSphMat, kSphMask,
  kBoxMin, kBoxMax, kBoxMat, kBoxMask,
  kRectAxis, kRectK, kRectU0, kRectU1, kRectV0, kRectV1, kRectMat, kRectMask,
  kCylCx, kCylCz, kCylRadius, kCylYmin, kCylYmax, kCylCapped, kCylMat,
  kCylMask,
  kDiskCenter, kDiskNormal, kDiskRadius, kDiskMat, kDiskMask,
  kPlaneNormal, kPlaneD, kPlaneMat, kPlaneMask,
  kTriA, kTriE1, kTriE2, kTriN, kTriMat, kTriMask,
};
static_assert(kTriMask + 1 == kCols, "column count");
enum Table { kSpheres, kBoxes, kRects, kCylinders, kDisks, kPlanes,
             kTriangles };

struct Tables {
  const void* col[kCols];   // the scene's columns on the card
  int rows[kTables];        // each table's padded row count
};

// x[a] of a 3-vector held in registers, a in 0..2.
__device__ __forceinline__ float pick(const float* x, int a) {
  return a == 0 ? x[0] : (a == 1 ? x[1] : x[2]);
}

struct Ray {
  float o[3], d[3];
  float lo, hi;   // tmin, tmax
};

// The sweep's nearest hit so far (merge's a).
struct Best {
  float t, n[3], u, v;
  int mat;
  bool hit;
};

// merge(best, b) for a type whose winner has t = tb: true where b is taken.
__device__ __forceinline__ bool take(Best& best, float tb) {
  const bool hit_b = tb < kInf;
  best.hit = best.hit || hit_b;
  return hit_b && tb < best.t;
}

// The normal one_hot(ax) * (d[ax] < 0 ? 1 : -1) of a box or rect face.
__device__ __forceinline__ void face_normal(Best& b, const Ray& r, int ax) {
  const float s = pick(r.d, ax) < 0.0f ? 1.0f : -1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) b.n[c] = (c == ax ? 1.0f : 0.0f) * s;
}

// _flip_against: the row's normal, negated unless it faces the ray.
__device__ __forceinline__ void flip_against(Best& b, const Ray& r,
                                             const float* nrm) {
  const bool keep = dot3(nrm, r.d) < 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) b.n[c] = keep ? nrm[c] : -nrm[c];
}

template <typename T>
__device__ __forceinline__ const T* column(const Tables& tb, int k) {
  return static_cast<const T*>(tb.col[k]);
}

__device__ __forceinline__ void load3(float* x, const float* col, int i) {
  x[0] = col[3 * i];
  x[1] = col[3 * i + 1];
  x[2] = col[3 * i + 2];
}

__device__ void spheres(Best& best, const Ray& r, const Tables& tb) {
  const int n = tb.rows[kSpheres];
  const float* center = column<float>(tb, kSphCenter);
  const float* radius = column<float>(tb, kSphRadius);
  const unsigned char* mask = column<unsigned char>(tb, kSphMask);
  float tbest = kInf;
  int idx = 0;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    float c3[3];
    load3(c3, center, i);
    const float rad = radius[i];
    float oc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) oc[c] = r.o[c] - c3[c];
    const float half_b = dot3(oc, r.d);
    const float c = dot3(oc, oc) - rad * rad;
    const float disc = half_b * half_b - c;
    const float s = sqrtf(clamp_lo(disc, 0.0f));
    const float t_near = -half_b - s;
    const float t_far = -half_b + s;
    const bool near_ok = t_near >= r.lo && t_near <= r.hi;
    const bool far_ok = t_far >= r.lo && t_far <= r.hi;
    float t = near_ok ? t_near : t_far;
    t = (disc >= 0.0f && (near_ok || far_ok)) ? t : kInf;
    if (t < tbest) {
      tbest = t;
      idx = i;
    }
  }
  if (!take(best, tbest)) return;
  float c3[3];
  load3(c3, center, idx);
  const float inv_r = 1.0f / clamp_lo(radius[idx], kTiny);
  best.t = tbest;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    best.n[c] = (r.o[c] + tbest * r.d[c] - c3[c]) * inv_r;
  best.u = 0.0f;
  best.v = 0.0f;
  best.mat = column<int>(tb, kSphMat)[idx];
}

__device__ void boxes(Best& best, const Ray& r, const float* inv_d,
                      const Tables& tb) {
  const int n = tb.rows[kBoxes];
  const float* bmin = column<float>(tb, kBoxMin);
  const float* bmax = column<float>(tb, kBoxMax);
  const unsigned char* mask = column<unsigned char>(tb, kBoxMask);
  float tbest = kInf;
  int idx = 0, ax_best = 0;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    float lo3[3], hi3[3], tn[3], tf[3];
    load3(lo3, bmin, i);
    load3(hi3, bmax, i);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ta = (lo3[c] - r.o[c]) * inv_d[c];
      const float tc = (hi3[c] - r.o[c]) * inv_d[c];
      tn[c] = tmin2(ta, tc);
      tf[c] = tmax2(ta, tc);
    }
    const float t0 = amax_step(amax_step(tn[0], tn[1]), tn[2]);
    const float t1 = amin_step(amin_step(tf[0], tf[1]), tf[2]);
    const bool enter_ok = t0 <= t1 && t0 >= r.lo && t0 <= r.hi;
    const bool exit_ok = t0 <= t1 && t1 >= r.lo && t1 <= r.hi;
    float t = enter_ok ? t0 : t1;
    // argmax(tn) / argmin(tf): the first of equal values.
    int ax;
    if (enter_ok) {
      ax = 0;
      if (tn[1] > tn[ax]) ax = 1;
      if (tn[2] > pick(tn, ax)) ax = 2;
    } else {
      ax = 0;
      if (tf[1] < tf[ax]) ax = 1;
      if (tf[2] < pick(tf, ax)) ax = 2;
    }
    t = (enter_ok || exit_ok) ? t : kInf;
    if (t < tbest) {
      tbest = t;
      idx = i;
      ax_best = ax;
    }
  }
  if (!take(best, tbest)) return;
  float lo3[3], hi3[3], p[3];
  load3(lo3, bmin, idx);
  load3(hi3, bmax, idx);
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = r.o[c] + tbest * r.d[c];
  const int fa = ax_best == 0 ? 1 : 0;
  const int fb = ax_best == 2 ? 1 : 2;
  best.t = tbest;
  face_normal(best, r, ax_best);
  best.u = safe_div(pick(p, fa) - pick(lo3, fa),
                    pick(hi3, fa) - pick(lo3, fa));
  best.v = safe_div(pick(p, fb) - pick(lo3, fb),
                    pick(hi3, fb) - pick(lo3, fb));
  best.mat = column<int>(tb, kBoxMat)[idx];
}

__device__ void rects(Best& best, const Ray& r, const Tables& tb) {
  const int n = tb.rows[kRects];
  const int* axis = column<int>(tb, kRectAxis);
  const float* kk = column<float>(tb, kRectK);
  const float* u0 = column<float>(tb, kRectU0);
  const float* u1 = column<float>(tb, kRectU1);
  const float* v0 = column<float>(tb, kRectV0);
  const float* v1 = column<float>(tb, kRectV1);
  const unsigned char* mask = column<unsigned char>(tb, kRectMask);
  float tbest = kInf, pu_best = 0.0f, pv_best = 0.0f;
  int idx = 0;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    const int ax = axis[i];
    const int fa = ax == 0 ? 1 : 0;
    const int fb = ax == 2 ? 1 : 2;
    const float d_ax = pick(r.d, ax);
    const float ad = fabsf(d_ax);
    const float safe = ad < kEps8 ? (d_ax < 0.0f ? -kEps8 : kEps8) : d_ax;
    const float t = (kk[i] - pick(r.o, ax)) / safe;
    const float pu = pick(r.o, fa) + t * pick(r.d, fa);
    const float pv = pick(r.o, fb) + t * pick(r.d, fb);
    const bool valid = ad >= kEps8 && t >= r.lo && t <= r.hi &&
                       pu >= u0[i] && pu <= u1[i] && pv >= v0[i] &&
                       pv <= v1[i];
    if ((valid ? t : kInf) < tbest) {
      tbest = t;
      idx = i;
      pu_best = pu;
      pv_best = pv;
    }
  }
  if (!take(best, tbest)) return;
  best.t = tbest;
  face_normal(best, r, axis[idx]);
  best.u = safe_div(pu_best - u0[idx], u1[idx] - u0[idx]);
  best.v = safe_div(pv_best - v0[idx], v1[idx] - v0[idx]);
  best.mat = column<int>(tb, kRectMat)[idx];
}

__device__ void cylinders(Best& best, const Ray& r, const Tables& tb) {
  const int n = tb.rows[kCylinders];
  const float* cx = column<float>(tb, kCylCx);
  const float* cz = column<float>(tb, kCylCz);
  const float* radius = column<float>(tb, kCylRadius);
  const float* ymin = column<float>(tb, kCylYmin);
  const float* ymax = column<float>(tb, kCylYmax);
  const unsigned char* capped = column<unsigned char>(tb, kCylCapped);
  const unsigned char* mask = column<unsigned char>(tb, kCylMask);
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  const float a = dx * dx + dz * dz;
  const float inv_a = safe_div(1.0f, a);
  const bool dy_ok = fabsf(dy) > kEps8;
  float tbest = kInf;
  int idx = 0;
  bool top_best = false, bot_best = false;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    const float ox = r.o[0] - cx[i];
    const float oy = r.o[1];
    const float oz = r.o[2] - cz[i];
    const float rad = radius[i];
    const float r2 = rad * rad;
    const float y_lo = ymin[i], y_hi = ymax[i];
    const float half_b = ox * dx + oz * dz;
    const float c = ox * ox + oz * oz - r2;
    const float disc = half_b * half_b - a * c;
    const float s = sqrtf(clamp_lo(disc, 0.0f));
    const bool quad_ok = a > kEps12 && disc >= 0.0f;
    const float t1 = (-half_b - s) * inv_a;
    const float t2 = (-half_b + s) * inv_a;
    const float y1 = oy + t1 * dy;
    const float y2 = oy + t2 * dy;
    const bool v1 = quad_ok && t1 > r.lo && t1 < r.hi && y1 >= y_lo &&
                    y1 <= y_hi;
    const bool v2 = quad_ok && t2 > r.lo && t2 < r.hi && y2 >= y_lo &&
                    y2 <= y_hi && !v1;
    float t_cur = v1 ? t1 : (v2 ? t2 : kInf);
    const bool cap_possible = capped[i] && dy_ok;
    bool cap_ok[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {   // the top cap, then the bottom one
      const float t = safe_div((k == 0 ? y_hi : y_lo) - oy, dy);
      const float rx = ox + t * dx;
      const float rz = oz + t * dz;
      cap_ok[k] = cap_possible && t > r.lo && t < r.hi &&
                  rx * rx + rz * rz <= r2 && t < t_cur;
      t_cur = cap_ok[k] ? t : t_cur;
    }
    const bool valid = v1 || v2 || cap_ok[0] || cap_ok[1];
    if ((valid ? t_cur : kInf) < tbest) {
      tbest = t_cur;
      idx = i;
      top_best = cap_ok[0] && !cap_ok[1];
      bot_best = cap_ok[1];
    }
  }
  if (!take(best, tbest)) return;
  const float inv_r = 1.0f / clamp_lo(radius[idx], kTiny);
  const float px = r.o[0] + tbest * dx;
  const float pz = r.o[2] + tbest * dz;
  float nrm[3];
  if (top_best || bot_best) {
    nrm[0] = 0.0f;
    nrm[1] = top_best ? 1.0f : -1.0f;
    nrm[2] = 0.0f;
  } else {
    nrm[0] = (px - cx[idx]) * inv_r;
    nrm[1] = 0.0f;
    nrm[2] = (pz - cz[idx]) * inv_r;
  }
  const bool flip = dot3(nrm, r.d) >= 0.0f;
  best.t = tbest;
#pragma unroll
  for (int c = 0; c < 3; ++c) best.n[c] = flip ? -nrm[c] : nrm[c];
  best.u = 0.0f;
  best.v = 0.0f;
  best.mat = column<int>(tb, kCylMat)[idx];
}

__device__ void disks(Best& best, const Ray& r, const Tables& tb) {
  const int n = tb.rows[kDisks];
  const float* center = column<float>(tb, kDiskCenter);
  const float* normal = column<float>(tb, kDiskNormal);
  const float* radius = column<float>(tb, kDiskRadius);
  const unsigned char* mask = column<unsigned char>(tb, kDiskMask);
  float tbest = kInf;
  int idx = 0;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    float c3[3], n3[3];
    load3(c3, center, i);
    load3(n3, normal, i);
    const float rad = radius[i];
    const float denom = dot3(r.d, n3);
    const float nd_c = dot3(n3, c3);
    const float no = dot3(r.o, n3);
    const float adenom = fabsf(denom);
    const float safe =
        adenom < kEps8 ? (denom < 0.0f ? -kEps8 : kEps8) : denom;
    const float t = (nd_c - no) / safe;
    const float ex = r.o[0] + t * r.d[0] - c3[0];
    const float ez = r.o[2] + t * r.d[2] - c3[2];
    const bool valid = adenom >= kEps6 && t >= r.lo && t <= r.hi &&
                       ex * ex + ez * ez <= rad * rad;
    if ((valid ? t : kInf) < tbest) {
      tbest = t;
      idx = i;
    }
  }
  if (!take(best, tbest)) return;
  float n3[3];
  load3(n3, normal, idx);
  best.t = tbest;
  flip_against(best, r, n3);
  best.u = 0.0f;
  best.v = 0.0f;
  best.mat = column<int>(tb, kDiskMat)[idx];
}

__device__ void planes(Best& best, const Ray& r, const Tables& tb) {
  const int n = tb.rows[kPlanes];
  const float* normal = column<float>(tb, kPlaneNormal);
  const float* dist = column<float>(tb, kPlaneD);
  const unsigned char* mask = column<unsigned char>(tb, kPlaneMask);
  float tbest = kInf;
  int idx = 0;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    float n3[3];
    load3(n3, normal, i);
    const float denom = dot3(r.d, n3);
    const float no = dot3(r.o, n3);
    const float t = safe_div(dist[i] - no, denom);
    const bool valid = fabsf(denom) >= kEps6 && t >= r.lo && t <= r.hi;
    if ((valid ? t : kInf) < tbest) {
      tbest = t;
      idx = i;
    }
  }
  if (!take(best, tbest)) return;
  float n3[3];
  load3(n3, normal, idx);
  best.t = tbest;
  flip_against(best, r, n3);
  best.u = 0.0f;
  best.v = 0.0f;
  best.mat = column<int>(tb, kPlaneMat)[idx];
}

// Double-sided Moller-Trumbore.
__device__ void triangles(Best& best, const Ray& r, const Tables& tb) {
  const int n = tb.rows[kTriangles];
  const float* va = column<float>(tb, kTriA);
  const float* ve1 = column<float>(tb, kTriE1);
  const float* ve2 = column<float>(tb, kTriE2);
  const unsigned char* mask = column<unsigned char>(tb, kTriMask);
  const float* d = r.d;
  float tbest = kInf, u_best = 0.0f, v_best = 0.0f;
  int idx = 0;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    float a3[3], e1[3], e2[3];
    load3(a3, va, i);
    load3(e1, ve1, i);
    load3(e2, ve2, i);
    const float h[3] = {d[1] * e2[2] - d[2] * e2[1],
                        d[2] * e2[0] - d[0] * e2[2],
                        d[0] * e2[1] - d[1] * e2[0]};
    const float det = dot3(e1, h);
    const float inv_det = safe_div(1.0f, det);
    float s[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] = r.o[c] - a3[c];
    const float u = dot3(s, h) * inv_det;
    const float q[3] = {s[1] * e1[2] - s[2] * e1[1],
                        s[2] * e1[0] - s[0] * e1[2],
                        s[0] * e1[1] - s[1] * e1[0]};
    const float v = dot3(d, q) * inv_det;
    const float t = dot3(e2, q) * inv_det;
    const bool valid = fabsf(det) >= kEps8 && u >= 0.0f && u <= 1.0f &&
                       v >= 0.0f && u + v <= 1.0f && t >= r.lo && t <= r.hi;
    if ((valid ? t : kInf) < tbest) {
      tbest = t;
      idx = i;
      u_best = u;
      v_best = v;
    }
  }
  if (!take(best, tbest)) return;
  float n3[3];
  load3(n3, column<float>(tb, kTriN), idx);
  best.t = tbest;
  flip_against(best, r, n3);
  best.u = u_best;
  best.v = v_best;
  best.mat = column<int>(tb, kTriMat)[idx];
}

__global__ void __launch_bounds__(kThreads)
prim_kernel(Tables tb, const float* __restrict__ o,
            const float* __restrict__ d, const float* __restrict__ tmin,
            float tmin_s, const float* __restrict__ tmax, float tmax_s,
            int n_rays, float* __restrict__ out_t, float* __restrict__ out_n,
            float* __restrict__ out_u, float* __restrict__ out_v,
            int* __restrict__ out_mat, bool* __restrict__ out_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  Ray r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.o[c] = o[3 * i + c];
    r.d[c] = d[3 * i + c];
  }
  r.lo = tmin ? tmin[i] : tmin_s;
  r.hi = tmax ? tmax[i] : tmax_s;

  Best best;
  best.t = kInf;
  best.n[0] = best.n[1] = best.n[2] = 0.0f;
  best.u = best.v = 0.0f;
  best.mat = 0;
  best.hit = false;

  spheres(best, r, tb);
  if (tb.rows[kBoxes] > 0) {
    float inv_d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) inv_d[c] = safe_div(1.0f, r.d[c]);
    boxes(best, r, inv_d, tb);
  }
  rects(best, r, tb);
  cylinders(best, r, tb);
  disks(best, r, tb);
  planes(best, r, tb);
  triangles(best, r, tb);

  out_t[i] = best.t;
#pragma unroll
  for (int c = 0; c < 3; ++c) out_n[3 * i + c] = best.n[c];
  out_u[i] = best.u;
  out_v[i] = best.v;
  out_mat[i] = best.mat;
  out_hit[i] = best.hit;
}

}  // namespace

// cols: kCols device pointers; rows: each table's padded row count.
// tmin / tmax: a (n_rays,) array, or NULL for the scalar beside.
extern "C" int yacge_prim_launch(const void* const* cols, const int* rows,
                                 const float* o, const float* d,
                                 const float* tmin, float tmin_s,
                                 const float* tmax, float tmax_s, int n_rays,
                                 float* out_t, float* out_n, float* out_u,
                                 float* out_v, int* out_mat,
                                 unsigned char* out_hit, void* stream_ptr) {
  if (n_rays == 0) return 0;
  Tables tb;
  for (int t = 0; t < kTables; ++t) tb.rows[t] = rows[t];
  for (int k = 0; k < kCols; ++k) tb.col[k] = cols[k];
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  prim_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream_ptr>>>(
      tb, o, d, tmin, tmin_s, tmax, tmax_s, n_rays, out_t, out_n, out_u,
      out_v, out_mat, reinterpret_cast<bool*>(out_hit));
  return (int)cudaGetLastError();
}
