// The voxel DDA (sm_90a): one thread a ray, the whole march in it.
//
// Replaces the JAX package's device loop yetanotherconsolegameengine_tpu/
// ops/dda.py::intersect_voxels (its jax.lax.while_loop at :207-210, with the
// narrowing to P/4 and P/16), which has no pallas_call. The port's plain
// version (ops/dda.py::_step) runs the same march as lockstep torch rounds
// that the host drives, over an int32 copy of the grid. Here a sweep is one
// launch with no host wait; each thread enters the grid box, marches its
// ray and writes the hit with its entry-face normal:
//
//   t = max(t_enter, tmin); tcap = min(t_exit, tmax)
//   while alive:
//     p = o + (t + eps) * d;  cell = floor((p - origin) / h)
//     outside the grid or t >= tcap -> done
//     enc = cells[cell] (int16, read directly)
//     enc > 0 -> hit at t, normal from the axis crossed to enter
//     t = max(next cell boundary, t + max(-2 - enc, 0) * h, t + eps)
//
// A thread computes, round for round, what its lane of the plain loop
// computes, in the same operation order: IEEE division for (p - origin) / h
// and 1/d, int-to-float conversions before the f32 products, torch's
// NaN-propagating minimum and maximum, the first index of equal minima
// (torch.min over the axes) and of equal maxima (torch.max over the entry
// slabs), eps = float32(1e-4) * h in f32. Built with -fmad=false, the
// outputs equal the plain loop's bit for bit. A lane the plain loop has
// finished changes nothing in its later rounds, so marching each ray only
// until its own end changes no result.
//
// Each round moves t to the next cell boundary at least, so a ray ends
// within about nx + ny + nz rounds (the distance-field jump makes it far
// fewer); kMaxRounds only guards the card against a ray that would never
// end, and no ray of a grid the port builds comes near it.
//
// What bounds it on this card: a round is ~50 fp32 operations and one
// 2-byte cell read, dependent on the previous round, so the kernel is
// latency-bound, and a warp runs as long as its longest ray. One thread a
// ray keeps the design right and simple; reordering rays into coherent
// warps is later work.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e38f;   // ops/intersect.py INF
constexpr int kThreads = 128;
constexpr int kMaxRounds = 1 << 20;

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

__global__ void __launch_bounds__(kThreads)
dda_march_kernel(const short* __restrict__ cells, int gx, int gy, int gz,
                 const float* __restrict__ origin,
                 const float* __restrict__ voxel_size,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmin,
                 const float* __restrict__ tmax, int n_rays,
                 float* __restrict__ out_t, float* __restrict__ out_n,
                 float* __restrict__ out_uv, int* __restrict__ out_mat,
                 unsigned char* __restrict__ out_hit) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const float h = __ldg(voxel_size);
  const float eps = 1e-4f * h;
  const int dims[3] = {gx, gy, gz};
  float oo[3], dd[3], inv[3], gmin[3];
  for (int a = 0; a < 3; ++a) {
    oo[a] = o[3 * i + a];
    dd[a] = d[3 * i + a];
    inv[a] = safe_inv(dd[a]);
    gmin[a] = __ldg(origin + a);
  }
  const float t_lo = tmin[i], t_hi = tmax[i];

  // The grid box's entry and exit: t_enter is the first of equal maxima
  // of the per-axis entry distances (NaN first), t_exit their exits' min.
  float t_enter = 0.0f, t_exit = 0.0f;
  int enter_axis = 0;
  for (int a = 0; a < 3; ++a) {
    const float gmax = gmin[a] + static_cast<float>(dims[a]) * h;
    const float ta = (gmin[a] - oo[a]) * inv[a];
    const float tb = (gmax - oo[a]) * inv[a];
    const float lo = min_nan(ta, tb), hi = max_nan(ta, tb);
    if (a == 0) {
      t_enter = lo;
      t_exit = hi;
    } else {
      if ((lo != lo && t_enter == t_enter) || lo > t_enter) {
        t_enter = lo;
        enter_axis = a;
      }
      t_exit = min_nan(t_exit, hi);
    }
  }
  const float t_start = max_nan(t_enter, t_lo);
  const bool inside = t_enter < t_lo;
  bool alive = t_enter <= t_exit && t_start < t_hi && t_exit >= t_lo;
  const float tcap = min_nan(t_exit, t_hi);
  int up[3];
  bool flat[3];
  for (int a = 0; a < 3; ++a) {
    up[a] = dd[a] > 0.0f ? 1 : 0;
    flat[a] = fabsf(dd[a]) < 1e-12f;
  }

  float t = t_start, t_hit = kInf;
  int axis = enter_axis, axis_hit = 0, mat = 0;
  bool hit = false;
  for (int round = 0; alive && round < kMaxRounds; ++round) {
    const float te = t + eps;
    int cell[3];
    bool in_grid = true;
    long long lin = 0;
    for (int a = 0; a < 3; ++a) {
      const float p = oo[a] + te * dd[a];
      cell[a] = static_cast<int>(floorf((p - gmin[a]) / h));
      const int cc = min(max(cell[a], 0), dims[a] - 1);
      in_grid = in_grid && cc == cell[a];
      lin = lin * dims[a] + cc;
    }
    if (!(in_grid && t < tcap)) break;
    const int enc = __ldg(cells + lin);
    if (enc > 0) {   // solid: a lane hits at most once
      hit = true;
      t_hit = t;
      axis_hit = axis;
      mat = enc;
      break;
    }
    // The next cell boundary on each axis (INF where the ray is parallel),
    // the first of equal minima (NaN first).
    float t_new = 0.0f;
    int new_axis = 0;
    for (int a = 0; a < 3; ++a) {
      float ta = ((static_cast<float>(cell[a] + up[a]) * h + gmin[a]) - oo[a])
                 * inv[a];
      if (flat[a]) ta = kInf;
      if (a == 0 || (ta != ta && t_new == t_new) || ta < t_new) {
        t_new = ta;
        new_axis = a;
      }
    }
    // Distance-field skip: (D - 1) cells, D = -enc - 1 on an empty cell.
    const int jump = max(-2 - enc, 0);
    t_new = max_nan(t_new, t + static_cast<float>(jump) * h);
    t = max_nan(t_new, te);
    axis = new_axis;
  }

  const float s = dd[axis_hit] < 0.0f ? 1.0f : -1.0f;
  const bool face_ray = inside && t_hit <= t_start + eps;
  for (int a = 0; a < 3; ++a)
    out_n[3 * i + a] = face_ray ? -dd[a] : (a == axis_hit ? 1.0f : 0.0f) * s;
  out_t[i] = hit ? t_hit : kInf;
  out_uv[i] = 0.0f;   // a voxel hit has no surface coordinates
  out_mat[i] = mat;
  out_hit[i] = hit;
}

}  // namespace

extern "C" int yacge_dda_launch(const short* cells, int nx, int ny, int nz,
                                const float* origin, const float* voxel_size,
                                const float* o, const float* d,
                                const float* tmin, const float* tmax,
                                int n_rays, float* out_t, float* out_n,
                                float* out_uv, int* out_mat,
                                unsigned char* out_hit, void* stream_ptr) {
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  dda_march_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream_ptr>>>(
      cells, nx, ny, nz, origin, voxel_size, o, d, tmin, tmax, n_rays, out_t,
      out_n, out_uv, out_mat, out_hit);
  return (int)cudaGetLastError();
}
