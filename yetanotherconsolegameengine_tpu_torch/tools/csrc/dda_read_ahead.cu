// A variant of the voxel DDA kernel (ops/csrc/dda_kernel.cu) that reads
// cells ahead along a ray's one-cell steps, for tools/dda_ladder.py only:
// the port does not build it. It is the port's kernel (the same shorter
// round, the same C entry point yacge_dda_launch, bit-equal outputs) with
// three build knobs: YACGE_DDA_AHEAD rounds a batch (1: none, the port's
// march), YACGE_DDA_THREADS threads a block and YACGE_DDA_RUN jump-0
// rounds in a row a lane needs before its warp reads ahead (0: always).
//
// The read-ahead (YACGE_DDA_AHEAD > 1). Where a cell's jump is 0, the next
// round's t does not depend on the cell's value: max(max(boundary, t + 0 * h),
// te). A thread then computes the next kAhead rounds as if each cell had jump
// 0 (enc == -2), with exactly a round's expressions, issues all kAhead cell
// reads before it uses any, and resolves them in order, committing each round
// as the serial loop would. It stops at the first round that leaves the grid,
// reaches tcap, finds a solid cell or has a jump > 0 (that round commits its
// own t from the jump), discards the rounds read after it and starts the next
// batch from the committed t. Every committed value is the serial loop's
// expression on the serial loop's inputs, so the result is bit-equal by
// construction, whatever the batch sizes; a round read past the ray's end
// reads a cell clamped into the grid. It takes the cell read off the chain of
// a grazing ray's rounds, not the arithmetic: a batch's rounds are still
// computed one after another, and a batch cut short costs the rounds it
// discards. On the port's grids the arithmetic is most of a round, so every
// batch size from 2 to 8, read ahead always or only while a lane grazes, made
// the sweeps slower than one round a batch (tools/dda_ladder.py).

#include <cuda_runtime.h>

#ifndef YACGE_DDA_AHEAD
#define YACGE_DDA_AHEAD 1
#endif
#ifndef YACGE_DDA_THREADS
#define YACGE_DDA_THREADS 128
#endif
// Jump-0 rounds in a row a lane needs before its warp reads ahead (0:
// always).
#ifndef YACGE_DDA_RUN
#define YACGE_DDA_RUN 1
#endif

namespace {

constexpr float kInf = 3.0e38f;   // ops/intersect.py INF
constexpr int kAhead = YACGE_DDA_AHEAD;
constexpr int kThreads = YACGE_DDA_THREADS;
constexpr int kRun = YACGE_DDA_RUN;
constexpr int kMaxRounds = 1 << 20;
static_assert(kAhead >= 1 && kAhead <= 16, "YACGE_DDA_AHEAD");

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

// One round's values from its start t, read ahead or not: the cell's
// linear index, whether the round marches (inside the grid, t < tcap), the
// next boundary and its axis, and the next t if the cell's jump is 0.
struct Round {
  float t, te, t_new, t_next;
  int lin, axis;
  bool go;
};

template <bool kExactInv>
__device__ __forceinline__ Round probe(const Ray& r, float t) {
  Round q;
  q.t = t;
  q.te = t + r.eps;
  float fl[3];
  int cc[3];
  bool in_grid = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = r.o[a] + q.te * r.d[a];
    const float x = kExactInv ? (p - r.gmin[a]) * r.inv_h
                              : (p - r.gmin[a]) / r.h;
    fl[a] = floorf(x);
    const int cell = static_cast<int>(fl[a]);
    cc[a] = min(max(cell, 0), r.dims[a] - 1);
    in_grid = in_grid && cc[a] == cell;
  }
  // (x * ny + y) * nz + z as two independent products.
  q.lin = cc[0] * r.yz + (cc[1] * r.dims[2] + cc[2]);
  q.go = in_grid && t < r.tcap;
  // The next cell boundary on each axis (INF where the ray is parallel),
  // the first of equal minima (NaN first). float(cell + up) is computed as
  // floor(x) + up, off the float-int-float chain: the two are equal where
  // the cell is inside the grid, and a round outside it ends the march
  // before its boundary is used.
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
  q.t_new = t_new;
  q.axis = new_axis;
  // The round's t with jump 0: max(max(t_new, t + 0 * h), te).
  q.t_next = max_nan(max_nan(t_new, t + r.zero_h), q.te);
  return q;
}

// A cell read through the read-only path, as volatile asm so that the
// compiler issues it where it stands (all of a batch's reads before the
// first is used) and does not sink it into the branch that uses it.
__device__ __forceinline__ int load_cell(const short* p) {
  short v;
  asm volatile("ld.global.nc.s16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}

struct Result {
  float t_hit;
  int axis_hit, mat;
  bool hit;
};

// The march between batches: t and the axis crossed to enter its cell,
// the jump-0 rounds just committed in a row, the rounds so far.
struct March {
  float t;
  int axis, run, rounds;
  bool alive;
  Result res;
};

// kN rounds from m.t, each cell assumed at jump 0 until it is read: all
// kN probes, all kN reads, then each round committed in order as the
// serial loop commits it, up to the first that ends the march or jumps.
template <int kN, bool kExactInv>
__device__ __forceinline__ void batch(const Ray& r,
                                      const short* __restrict__ cells,
                                      March& m) {
  Round q[kN];
  float tt = m.t;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    q[k] = probe<kExactInv>(r, tt);
    tt = q[k].t_next;
  }
  int enc[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) enc[k] = load_cell(cells + q[k].lin);
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (!q[k].go || m.rounds >= kMaxRounds) {
      m.alive = false;
      return;
    }
    ++m.rounds;
    if (enc[k] > 0) {   // solid: a lane hits at most once
      m.res = {q[k].t, m.axis, enc[k], true};
      m.alive = false;
      return;
    }
    m.axis = q[k].axis;
    // Distance-field skip: (D - 1) cells, D = -enc - 1 on an empty cell.
    const int jump = max(-2 - enc[k], 0);
    if (jump == 0) {
      m.t = q[k].t_next;
      ++m.run;
    } else {   // the rounds read after this one assumed jump 0
      m.t = max_nan(max_nan(q[k].t_new,
                            q[k].t + static_cast<float>(jump) * r.h),
                    q[k].te);
      m.run = 0;
      return;
    }
  }
}

// March from t (entered along axis) to the ray's end: one round a batch,
// kAhead while a lane of the warp has just committed kRun rounds of jump 0
// in a row (a ray that grazes a surface). The choice is the warp's, so its
// lanes run one batch size at a time; a lane that does not graze mostly
// has its batch cut at its first round (a jump), and every lane commits
// the serial loop's rounds whatever the batch size.
template <bool kExactInv>
__device__ __forceinline__ Result march(const Ray& r,
                                        const short* __restrict__ cells,
                                        float t, int axis, bool alive) {
  March m = {t, axis, 0, 0, alive, {kInf, 0, 0, false}};
  while (m.alive) {
    if (kAhead > 1 && __any_sync(__activemask(), m.run >= kRun))
      batch<kAhead, kExactInv>(r, cells, m);
    else
      batch<1, kExactInv>(r, cells, m);
  }
  return m.res;
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
