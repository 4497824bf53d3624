// The voxel DDA (sm_90a): one thread a ray, the whole march in it, a
// round shortened for this card.
//
// Replaces the JAX package's device loop yetanotherconsolegameengine_tpu/
// ops/dda.py::intersect_voxels (its jax.lax.while_loop at :207-210, with the
// narrowing to P/4 and P/16), which has no pallas_call. The port's plain
// version (ops/dda.py::_step) runs the same march as lockstep torch rounds
// that the host drives, over an int32 copy of the grid. Here a sweep is one
// launch with no host wait; each thread enters the grid box, marches its
// ray and writes the hit with its entry-face normal. A round:
//
//   te = t + eps;  p = o + te * d;  cell = floor((p - origin) / h)
//   outside the grid or t >= tcap -> done
//   enc = cells[cell] (int16, read directly)
//   enc > 0 -> hit at t, normal from the axis crossed to enter
//   t = max(max(next cell boundary, t + jump * h), te),
//       jump = max(-2 - enc, 0): (D - 1) cells on an empty cell at
//       Chebyshev distance D
//
// A thread computes, round for round, what its lane of the plain loop
// computes, in the same operation order: (p - origin) / h, int-to-float
// conversions before the f32 products, 1/d by IEEE division, torch's
// NaN-propagating minimum and maximum, the first index of equal minima
// (torch.min over the axes) and of equal maxima (torch.max over the entry
// slabs), eps = float32(1e-4) * h in f32. Built with -fmad=false, the
// outputs equal the plain loop's bit for bit. A lane the plain loop has
// finished changes nothing in its later rounds, so marching each ray only
// until its own end changes no result.
//
// What bounds it on this card: not bytes (a sweep reads a few hundred
// distinct cells and 57 bytes a ray) nor operations, but the longest ray's
// chain of dependent rounds: the 8 rays with the most rounds, alone on the
// card, take about as long as the whole sweep. A round is ~30 dependent
// operations from t to the cell's address and from the cell's value to the
// next t, and one cell read (an L1 hit on a small grid, L2 on the
// island's); a sweep of 28,800 rays is ~7 warps an SM, too few to hide a
// round's latency behind another warp.
//
// The shorter round, the port's design. The linear cell index is 32-bit
// (dda.march refuses a grid of 2^31 cells or more). When h is a power of
// two whose reciprocal is a float, (p - origin) / h is the exact product
// (p - origin) * (1/h): division by 2^k only scales, and both round the
// same real value once. The kernel decides it from h's bits, a branch
// uniform over the launch that picks one of two instantiations of the
// march; every other h keeps the IEEE division. The boundary's
// float(cell + up) is floor(x) + up, without the round trip through an
// int; torch's minimum and maximum and the first of equal minima are one
// select each; the linear index is two independent products. A round reads
// its cell before it computes the next boundary, and has the next t for a
// cell of jump 0 (a grazing ray's rounds) ready when the value arrives.
// Whatever does not change over the march (eps, 0 * h, up, ny * nz, the
// tests for a ray parallel to an axis) is computed once.
//
// Each round moves t to the next cell boundary at least, so a ray ends
// within about nx + ny + nz rounds (the distance-field jump makes it far
// fewer); kMaxRounds only guards the card against a ray that would never
// end, and no ray of a grid the port builds comes near it.
//
// Reading cells ahead along a grazing ray's jump-0 rounds was tried and
// measured slower on this card at every batch size from 2 to 8: a batch's
// rounds are still computed one after another, and on the port's grids
// the arithmetic, not the cell read, is most of a round.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e38f;   // ops/intersect.py INF
constexpr int kThreads = 128;
constexpr int kMaxRounds = 1 << 20;

// torch.minimum / torch.maximum: NaN if either operand is NaN (a if both
// are), else b only where it is strictly less (greater), as in
// a != a ? a : (b != b ? b : (b < a ? b : a)), in one select: !(b >= a)
// holds where b < a or either is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return a == a && !(b >= a) ? b : a;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a == a && !(b <= a) ? b : a;
}

// _safe_div(1, x): x pushed away from zero to +-1e-12, then IEEE division.
__device__ __forceinline__ float safe_inv(float x) {
  const float s = fabsf(x) < 1e-12f ? (x < 0.0f ? -1e-12f : 1e-12f) : x;
  return 1.0f / s;
}

// h = +-2^e with 1/h a normal float: (x / h) == (x * (1/h)) for every x.
__device__ __forceinline__ bool exact_reciprocal(float h) {
  const unsigned bits = __float_as_uint(h);
  const unsigned expo = (bits >> 23) & 0xffu;
  return (bits & 0x7fffffu) == 0u && expo >= 1u && expo <= 253u;
}

// What a thread holds of its ray over the march.
struct Ray {
  float o[3], d[3], inv[3], gmin[3], up[3];
  int dims[3], yz;   // yz = ny * nz
  bool flat[3];
  float h, inv_h, eps, zero_h, tcap;
};

struct Result {
  float t_hit;
  int axis_hit, mat;
  bool hit;
};

// March from t (entered along axis) to the ray's end. A round reads its
// cell (clamped into the grid, so always a valid address) as soon as it
// has the index, and computes the next boundary and the next t for a cell
// of jump 0 beside the read; on a grazing ray's rounds of jump 0 only a
// compare and a select then wait on the cell's value.
template <bool kExactInv>
__device__ __forceinline__ Result march(const Ray& r,
                                        const short* __restrict__ cells,
                                        float t, int axis, bool alive) {
  Result res = {kInf, 0, 0, false};
  int rounds = 0;
  while (alive) {
    const float te = t + r.eps;
    float fl[3];
    int cc[3];
    bool in_grid = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float p = r.o[a] + te * r.d[a];
      const float x = kExactInv ? (p - r.gmin[a]) * r.inv_h
                                : (p - r.gmin[a]) / r.h;
      fl[a] = floorf(x);
      const int cell = static_cast<int>(fl[a]);
      cc[a] = min(max(cell, 0), r.dims[a] - 1);
      in_grid = in_grid && cc[a] == cell;
    }
    // (x * ny + y) * nz + z as two independent products.
    const int lin = cc[0] * r.yz + (cc[1] * r.dims[2] + cc[2]);
    const int enc = __ldg(cells + lin);
    // The next cell boundary on each axis (INF where the ray is parallel),
    // the first of equal minima (NaN first). float(cell + up) is computed
    // as floor(x) + up, off the float-int-float chain: the two are equal
    // inside the grid, and a round outside it ends the march before its
    // boundary is used.
    float t_new = 0.0f;
    int new_axis = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float ta = (((fl[a] + r.up[a]) * r.h + r.gmin[a]) - r.o[a]) * r.inv[a];
      if (r.flat[a]) ta = kInf;
      // (ta != ta && t_new == t_new) || ta < t_new, in one select.
      if (a == 0 || (t_new == t_new && !(ta >= t_new))) {
        t_new = ta;
        new_axis = a;
      }
    }
    // The next t if the cell's jump is 0: max(max(t_new, t + 0 * h), te).
    const float t_next = max_nan(max_nan(t_new, t + r.zero_h), te);
    if (!(in_grid && t < r.tcap) || rounds >= kMaxRounds) break;
    ++rounds;
    if (enc > 0) {   // solid: a lane hits at most once
      res = {t, axis, enc, true};
      break;
    }
    axis = new_axis;
    // Distance-field skip: (D - 1) cells, D = -enc - 1 on an empty cell.
    const int jump = max(-2 - enc, 0);
    if (jump == 0)
      t = t_next;
    else
      t = max_nan(max_nan(t_new, t + static_cast<float>(jump) * r.h), te);
  }
  return res;
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
  Ray r;
  r.h = __ldg(voxel_size);
  r.eps = 1e-4f * r.h;
  r.zero_h = 0.0f * r.h;
  const bool exact_inv = exact_reciprocal(r.h);
  r.inv_h = exact_inv ? 1.0f / r.h : 0.0f;
  r.dims[0] = gx;
  r.dims[1] = gy;
  r.dims[2] = gz;
  r.yz = gy * gz;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = o[3 * i + a];
    r.d[a] = d[3 * i + a];
    r.inv[a] = safe_inv(r.d[a]);
    r.gmin[a] = __ldg(origin + a);
    r.up[a] = r.d[a] > 0.0f ? 1.0f : 0.0f;
    r.flat[a] = fabsf(r.d[a]) < 1e-12f;
  }
  const float t_lo = tmin[i], t_hi = tmax[i];

  // The grid box's entry and exit: t_enter is the first of equal maxima
  // of the per-axis entry distances (NaN first), t_exit their exits' min.
  float t_enter = 0.0f, t_exit = 0.0f;
  int enter_axis = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float gmax = r.gmin[a] + static_cast<float>(r.dims[a]) * r.h;
    const float ta = (r.gmin[a] - r.o[a]) * r.inv[a];
    const float tb = (gmax - r.o[a]) * r.inv[a];
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
  const bool alive = t_enter <= t_exit && t_start < t_hi && t_exit >= t_lo;
  r.tcap = min_nan(t_exit, t_hi);

  // h's test is the same for every thread of the launch.
  const Result res =
      exact_inv ? march<true>(r, cells, t_start, enter_axis, alive)
                : march<false>(r, cells, t_start, enter_axis, alive);

  const float d_hit = res.axis_hit == 0 ? r.d[0]
                      : (res.axis_hit == 1 ? r.d[1] : r.d[2]);
  const float s = d_hit < 0.0f ? 1.0f : -1.0f;
  const bool face_ray = inside && res.t_hit <= t_start + r.eps;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    out_n[3 * i + a] =
        face_ray ? -r.d[a] : (a == res.axis_hit ? 1.0f : 0.0f) * s;
  out_t[i] = res.hit ? res.t_hit : kInf;
  out_uv[i] = 0.0f;   // a voxel hit has no surface coordinates
  out_mat[i] = res.mat;
  out_hit[i] = res.hit;
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
