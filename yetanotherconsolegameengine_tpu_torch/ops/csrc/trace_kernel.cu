// Path-trace kernel for primitive-table scenes (sm_90a).
//
// Replaces the Pallas megakernel yetanotherconsolegameengine_tpu/ops/
// pallas_trace.py::build_kernel (its pallas_call at :1049). Each pixel
// generates its jittered primary ray from one row of 18 ray_params scalars
// and the frame index, seeds its SplitMix64 state, and runs the whole path
// tree: the mirror/refraction stack, Oren-Nayar direct light with shadow
// rays (tinted transmittance through transparent hits), one diffuse bounce,
// the sky gradient and emission. It writes 12 planes: radiance rgb, sky,
// albedo rgb, normal xyz, depth and the pixel's ray count. A launch traces
// the rows [y0, y0 + band_h) of a frame ``height`` rows tall (a row band of
// parallel/sharding.py; the whole frame is y0 = 0, band_h = height): its
// pixels take their global row for the jitter, v and the seed, so a band's
// planes are those rows of the whole frame's.
//
// What bounds it on this card: divergent scalar float math per ray (IEEE
// divisions and square roots in dependent chains under -fmad=false) over
// the rows of every table, so instruction latency and issue, not memory
// (the scene is a few KB; the output is 48 B/pixel). The design:
//
// * One thread a ray: a thread walks the rows of every table in table
//   order (spheres, boxes, rects, cylinders, disks, planes, triangles)
//   with the strict t < best of the serial walk from t = INF. Lane groups
//   of 2, 4 and 8 threads a ray, reducing (t, table position) by
//   shuffles, were measured on the shipped scenes (4 and 8 rows) and lost
//   to one thread a ray on every one of them, since every lane repeats
//   the ray's shading (PERF.md § 6).
// * Shared memory: each block stages the packed scene table and its header
//   once with coalesced loads; every row read after that is a shared load.
//   The path stack lives there too, stack_slots(cfg) entries of 11 words
//   per ray (the wrapper checks that table + stack fit), in place of a
//   fixed 16-entry stack in local memory.
//
// Arithmetic follows yetanotherconsolegameengine_tpu_torch/ops/trace.py
// operation by operation (dot products summed x + y + z, the same selects
// and clamps, the same winner order across tables), and the build uses
// -fmad=false, so the kernel agrees with the plain version to a few float
// ulps; the RNG is the exact SplitMix64 sequence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Header layout: (count, offset) per table, then globals and flags.
// Keep in sync with ops/trace_kernel.py::pack_scene.
enum {
  H_NSPH, H_OSPH, H_NBOX, H_OBOX, H_NRECT, H_ORECT, H_NCYL, H_OCYL,
  H_NDISK, H_ODISK, H_NPLANE, H_OPLANE, H_NTRI, H_OTRI,
  H_NLIGHT, H_OLIGHT, H_NMAT, H_OMAT, H_OGLOB, H_BINARY, H_LEN
};
// Row widths (floats). Material ids are stored as floats (exact < 2^24).
constexpr int W_SPH = 5;     // cx cy cz r mat
constexpr int W_BOX = 7;     // bmin3 bmax3 mat
constexpr int W_RECT = 7;    // axis k u0 u1 v0 v1 mat
constexpr int W_CYL = 7;     // cx cz r ymin ymax capped mat
constexpr int W_DISK = 8;    // c3 n3 r mat
constexpr int W_PLANE = 5;   // n3 d mat
constexpr int W_TRI = 13;    // a3 e1_3 e2_3 n3 mat
constexpr int W_LIGHT = 7;   // pos3 color3 intensity
constexpr int W_MAT = 18;    // albedo3 emission3 transmission3 albedo2_3
                             // specular reflectivity transparency ior
                             // proc proc_scale
// Shared memory (floats): the header padded to HDR_PAD, the table, then
// per ray stack_slots entries of W_STACK words (o3 d3 beta3 mirror
// diffuse). Keep in sync with ops/trace_kernel.py::shared_bytes.
constexpr int THREADS = 128;
constexpr int HDR_PAD = 32;
constexpr int W_STACK = 11;
constexpr float INF = 3.0e38f;
constexpr float EPS = 1e-4f;
constexpr float INV_PI = 0.318309886183790671538f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 v) {
  float len = sqrtf(fmaxf(dot(v, v), 1e-20f));
  return {v.x / len, v.y / len, v.z / len};
}
__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  return sub(v, scale(n, 2.0f * dot(v, n)));
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float safe_den(float den, float eps) {
  return fabsf(den) < eps ? (den < 0.0f ? -eps : eps) : den;
}
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
// Component k of v by selects (a dynamically indexed local array would
// live in local memory).
__device__ __forceinline__ float comp(V3 v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : v.z);
}

// ---- SplitMix64 (core/u64.py, core/sampler.py) ----------------------------
__device__ __forceinline__ unsigned long long splitmix64(unsigned long long z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}
__device__ __forceinline__ float rng_next_unit(unsigned long long& s) {
  s = splitmix64(s);
  return ((float)(unsigned int)(s >> 40) + 0.5f) * (1.0f / 16777216.0f);
}
__device__ unsigned long long per_frame_seed(unsigned int px, unsigned int py,
                                             unsigned int frame,
                                             unsigned long long salt) {
  unsigned long long h = 1469598103934665603ull;
  h = splitmix64(h ^ ((unsigned long long)px * 0x9E3779B97F4A7C15ull));
  h = splitmix64(h ^ ((unsigned long long)py * 0xC2B2AE3D27D4EB4Full));
  h = splitmix64(h ^ ((unsigned long long)frame * 0x165667B19E3779F9ull));
  h = splitmix64(h);
  return splitmix64(h ^ salt);
}
__device__ __forceinline__ float frac(float v) { return v - floorf(v); }

// ---- nearest hit over every table (ops/intersect.py) ----------------------
// Strict t < b.t keeps the first row of least t, as the serial walk.
struct Hit {
  float t = INF; V3 n = {0.0f, 0.0f, 0.0f}; int mat = 0; bool hit = false;
  __device__ __forceinline__ void take(float t_, V3 n_, int mat_) {
    t = t_; n = n_; mat = mat_; hit = true;
  }
};

__device__ Hit intersect(const float* __restrict__ sc, const int* __restrict__ hdr,
                         V3 o, V3 d, float tmin, float tmax) {
  Hit b;
  // Spheres: near root if in range, else far; outward normal.
  for (int i = 0; i < hdr[H_NSPH]; ++i) {
    const float* r = sc + hdr[H_OSPH] + i * W_SPH;
    V3 c = ld3(r);
    float rad = r[3];
    V3 oc = sub(o, c);
    float half_b = dot(oc, d);
    float cc = dot(oc, oc) - rad * rad;
    float disc = half_b * half_b - cc;
    float s = sqrtf(fmaxf(disc, 0.0f));
    float tn = -half_b - s, tf = -half_b + s;
    bool near_ok = tn >= tmin && tn <= tmax;
    bool far_ok = tf >= tmin && tf <= tmax;
    float t = near_ok ? tn : tf;
    if (disc >= 0.0f && (near_ok || far_ok) && t < b.t) {
      float inv_r = 1.0f / fmaxf(rad, 1e-20f);
      V3 p = add(o, scale(d, t));
      b.take(t, scale(sub(p, c), inv_r), (int)r[4]);
    }
  }
  // Boxes: slab test, entry face else exit face, normal against the ray.
  if (hdr[H_NBOX] > 0) {
    float inv_d[3] = {1.0f / safe_den(d.x, 1e-12f), 1.0f / safe_den(d.y, 1e-12f),
                      1.0f / safe_den(d.z, 1e-12f)};
    float oo[3] = {o.x, o.y, o.z};
    for (int i = 0; i < hdr[H_NBOX]; ++i) {
      const float* r = sc + hdr[H_OBOX] + i * W_BOX;
      float tn[3], tf[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float ta = (r[k] - oo[k]) * inv_d[k];
        float tc = (r[3 + k] - oo[k]) * inv_d[k];
        tn[k] = fminf(ta, tc);
        tf[k] = fmaxf(ta, tc);
      }
      int ax_in = 0; float t0 = tn[0];
      if (tn[1] > t0) { ax_in = 1; t0 = tn[1]; }
      if (tn[2] > t0) { ax_in = 2; t0 = tn[2]; }
      int ax_out = 0; float t1 = tf[0];
      if (tf[1] < t1) { ax_out = 1; t1 = tf[1]; }
      if (tf[2] < t1) { ax_out = 2; t1 = tf[2]; }
      bool enter_ok = t0 <= t1 && t0 >= tmin && t0 <= tmax;
      bool exit_ok = t0 <= t1 && t1 >= tmin && t1 <= tmax;
      float t = enter_ok ? t0 : t1;
      if ((enter_ok || exit_ok) && t < b.t) {
        int ax = enter_ok ? ax_in : ax_out;
        float sg = comp(d, ax) < 0.0f ? 1.0f : -1.0f;
        b.take(t,
               v3(ax == 0 ? sg : 0.0f, ax == 1 ? sg : 0.0f, ax == 2 ? sg : 0.0f),
               (int)r[6]);
      }
    }
  }
  // Axis-aligned rects.
  for (int i = 0; i < hdr[H_NRECT]; ++i) {
    const float* r = sc + hdr[H_ORECT] + i * W_RECT;
    int a = (int)r[0];
    int fa = a == 0 ? 1 : 0;
    int fb = a == 2 ? 1 : 2;
    float d_ax = comp(d, a);
    float ad = fabsf(d_ax);
    float safe = ad < 1e-8f ? (d_ax < 0.0f ? -1e-8f : 1e-8f) : d_ax;
    float t = (r[1] - comp(o, a)) / safe;
    float pu = comp(o, fa) + t * comp(d, fa);
    float pv = comp(o, fb) + t * comp(d, fb);
    if (ad >= 1e-8f && t >= tmin && t <= tmax && pu >= r[2] && pu <= r[3] &&
        pv >= r[4] && pv <= r[5] && t < b.t) {
      float sg = d_ax < 0.0f ? 1.0f : -1.0f;
      b.take(t, v3(a == 0 ? sg : 0.0f, a == 1 ? sg : 0.0f, a == 2 ? sg : 0.0f),
             (int)r[6]);
    }
  }
  // Y-axis capped cylinders: near side root, else far; closer caps win.
  for (int i = 0; i < hdr[H_NCYL]; ++i) {
    const float* r = sc + hdr[H_OCYL] + i * W_CYL;
    float cx = r[0], cz = r[1], rad = r[2], ymin = r[3], ymax = r[4];
    bool capped = r[5] > 0.5f;
    float ox = o.x - cx, oy = o.y, oz = o.z - cz;
    float r2 = rad * rad;
    float a = d.x * d.x + d.z * d.z;
    float half_b = ox * d.x + oz * d.z;
    float c = ox * ox + oz * oz - r2;
    float disc = half_b * half_b - a * c;
    float s = sqrtf(fmaxf(disc, 0.0f));
    float inv_a = 1.0f / safe_den(a, 1e-12f);
    bool quad_ok = a > 1e-12f && disc >= 0.0f;
    float t1 = (-half_b - s) * inv_a;
    float t2 = (-half_b + s) * inv_a;
    float y1 = oy + t1 * d.y, y2 = oy + t2 * d.y;
    bool v1 = quad_ok && t1 > tmin && t1 < tmax && y1 >= ymin && y1 <= ymax;
    bool v2 = quad_ok && t2 > tmin && t2 < tmax && y2 >= ymin && y2 <= ymax && !v1;
    float t_cur = v1 ? t1 : (v2 ? t2 : INF);
    bool cap_possible = capped && fabsf(d.y) > 1e-8f;
    bool cap_ok[2];
    float kys[2] = {ymax, ymin};
    for (int k = 0; k < 2; ++k) {
      float t = (kys[k] - oy) / safe_den(d.y, 1e-12f);
      float rx = ox + t * d.x, rz = oz + t * d.z;
      cap_ok[k] = cap_possible && t > tmin && t < tmax &&
                  rx * rx + rz * rz <= r2 && t < t_cur;
      if (cap_ok[k]) t_cur = t;
    }
    bool is_top = cap_ok[0] && !cap_ok[1];
    bool is_bot = cap_ok[1];
    if ((v1 || v2 || is_top || is_bot) && t_cur < b.t) {
      float inv_r = 1.0f / fmaxf(rad, 1e-20f);
      float px = o.x + t_cur * d.x, pz = o.z + t_cur * d.z;
      V3 n = (is_top || is_bot)
                 ? v3(0.0f, is_top ? 1.0f : -1.0f, 0.0f)
                 : v3((px - cx) * inv_r, 0.0f, (pz - cz) * inv_r);
      if (dot(n, d) >= 0.0f) n = neg(n);
      b.take(t_cur, n, (int)r[6]);
    }
  }
  // Disks (XZ-distance radius test, as the reference).
  for (int i = 0; i < hdr[H_NDISK]; ++i) {
    const float* r = sc + hdr[H_ODISK] + i * W_DISK;
    V3 c = ld3(r), nrm = ld3(r + 3);
    float denom = dot(d, nrm);
    float nd_c = dot(nrm, c);
    float no = dot(o, nrm);
    float ad = fabsf(denom);
    float safe = ad < 1e-8f ? (denom < 0.0f ? -1e-8f : 1e-8f) : denom;
    float t = (nd_c - no) / safe;
    float ex = o.x + t * d.x - c.x, ez = o.z + t * d.z - c.z;
    if (ad >= 1e-6f && t >= tmin && t <= tmax && ex * ex + ez * ez <= r[6] * r[6] &&
        t < b.t)
      b.take(t, dot(nrm, d) < 0.0f ? nrm : neg(nrm), (int)r[7]);
  }
  // Infinite planes.
  for (int i = 0; i < hdr[H_NPLANE]; ++i) {
    const float* r = sc + hdr[H_OPLANE] + i * W_PLANE;
    V3 nrm = ld3(r);
    float denom = dot(d, nrm);
    float no = dot(o, nrm);
    float t = (r[3] - no) / safe_den(denom, 1e-12f);
    if (fabsf(denom) >= 1e-6f && t >= tmin && t <= tmax && t < b.t)
      b.take(t, dot(nrm, d) < 0.0f ? nrm : neg(nrm), (int)r[4]);
  }
  // Double-sided Moller-Trumbore triangles.
  for (int i = 0; i < hdr[H_NTRI]; ++i) {
    const float* r = sc + hdr[H_OTRI] + i * W_TRI;
    V3 a = ld3(r), e1 = ld3(r + 3), e2 = ld3(r + 6), nrm = ld3(r + 9);
    V3 hh = cross(d, e2);
    float det = dot(e1, hh);
    float inv_det = 1.0f / safe_den(det, 1e-12f);
    V3 s = sub(o, a);
    float u = dot(s, hh) * inv_det;
    V3 q = cross(s, e1);
    float v = dot(d, q) * inv_det;
    float t = dot(e2, q) * inv_det;
    if (fabsf(det) >= 1e-8f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
        u + v <= 1.0f && t >= tmin && t <= tmax && t < b.t)
      b.take(t, dot(nrm, d) < 0.0f ? nrm : neg(nrm), (int)r[12]);
  }
  return b;
}

// Oren-Nayar BRDF clipped to [0, 1] per channel (ops/trace.py oren_nayar).
__device__ V3 oren_nayar(V3 albedo, V3 n, V3 wo, V3 wi, float on_a, float on_b) {
  float cos_i = fmaxf(dot(n, wi), 0.0f);
  float cos_o = fmaxf(dot(n, wo), 0.0f);
  float sin_i = sqrtf(fmaxf(1.0f - cos_i * cos_i, 0.0f));
  float sin_o = sqrtf(fmaxf(1.0f - cos_o * cos_o, 0.0f));
  V3 proj_i = normalize(sub(wi, scale(n, cos_i)));
  V3 proj_o = normalize(sub(wo, scale(n, cos_o)));
  float cos_phi = fmaxf(dot(proj_i, proj_o), 0.0f);
  float sin_alpha = fmaxf(sin_i, sin_o);
  float tan_beta = fminf(sin_i / fmaxf(cos_i, 1e-6f), sin_o / fmaxf(cos_o, 1e-6f));
  float on = on_a + on_b * cos_phi * sin_alpha * tan_beta;
  if (cos_i <= 0.0f || cos_o <= 0.0f) return v3(0.0f, 0.0f, 0.0f);
  float f = on * INV_PI;
  return v3(clampf(albedo.x * f, 0.0f, 1.0f), clampf(albedo.y * f, 0.0f, 1.0f),
            clampf(albedo.z * f, 0.0f, 1.0f));
}

__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x * (x2 * x2);
}

struct TraceArgs {
  int max_rounds, max_mirror, max_refr, diffuse_bounces, stack_slots;
  float mirror_threshold, on_a, on_b;
  unsigned long long salt;
};

// One path-stack entry in shared memory.
struct Frame { V3 o, d, beta; int mirror, diffuse; };

__device__ __forceinline__ void push(float* st, int sp, const Frame& f) {
  float* e = st + sp * W_STACK;
  e[0] = f.o.x; e[1] = f.o.y; e[2] = f.o.z;
  e[3] = f.d.x; e[4] = f.d.y; e[5] = f.d.z;
  e[6] = f.beta.x; e[7] = f.beta.y; e[8] = f.beta.z;
  e[9] = __int_as_float(f.mirror); e[10] = __int_as_float(f.diffuse);
}
__device__ __forceinline__ Frame pop(const float* st, int sp) {
  const float* e = st + sp * W_STACK;
  return {ld3(e), ld3(e + 3), ld3(e + 6), __float_as_int(e[9]), __float_as_int(e[10])};
}

__global__ void __launch_bounds__(THREADS)
trace_kernel(const float* __restrict__ sc_g, const int* __restrict__ hdr_g,
             int table_len, const float* __restrict__ params_all,
             const int* __restrict__ frames, int row, float* __restrict__ out,
             int width, int height, int y0, int band_h, TraceArgs cfg) {
  extern __shared__ float smem[];
  int* hdr = reinterpret_cast<int*>(smem);
  float* sc = smem + HDR_PAD;
  for (int k = threadIdx.x; k < H_LEN; k += THREADS) hdr[k] = hdr_g[k];
  for (int k = threadIdx.x; k < table_len; k += THREADS) sc[k] = sc_g[k];
  __syncthreads();

  // Pixel pix of the band is global row y0 + pix / width of a frame
  // ``height`` rows tall; out holds the band's rows only.
  int pix = blockIdx.x * THREADS + threadIdx.x;
  int n_pix = width * band_h;
  if (pix >= n_pix) return;
  float* st = sc + table_len + threadIdx.x * cfg.stack_slots * W_STACK;

  const float* p = params_all + row * 18;
  const float* glob = sc + hdr[H_OGLOB];
  V3 amb_rgb = scale(ld3(glob), glob[3]);
  V3 bg_top = ld3(glob + 4), bg_bottom = ld3(glob + 7);

  // ---- jittered primary ray (core/camera.py make_jittered_rays) ----------
  int py = y0 + pix / width, px = pix - (py - y0) * width;
  int bx = px & 7, by = py & 7, bxy = bx ^ by, bv = 0;
  for (int i = 0; i < 3; ++i)
    bv += (((bxy >> i) & 1) << (2 * (2 - i) + 1)) + (((by >> i) & 1) << (2 * (2 - i)));
  float base = ((float)bv + 0.5f) * (1.0f / 64.0f);
  float jx = frac(frac(base + p[14]) + p[16]) - 0.5f;
  float jy = frac(frac(base + p[15]) + p[17]) - 0.5f;
  // One rounding each, as core/camera.py::screen_coord.
  float u = fmaf((float)px + 0.5f + jx, (float)(2.0 / (double)width), -1.0f);
  float v = fmaf((float)py + 0.5f + jy, -(float)(2.0 / (double)height), 1.0f);
  float uw = u * p[12], vh = v * p[13];
  V3 d = normalize(v3(p[3] + p[6] * uw + p[9] * vh, p[4] + p[7] * uw + p[10] * vh,
                      p[5] + p[8] * uw + p[11] * vh));
  V3 o = v3(p[0], p[1], p[2]);
  unsigned long long rng = per_frame_seed((unsigned)px, (unsigned)py,
                                          (unsigned)frames[row], cfg.salt);

  // ---- per-pixel path state (ops/trace.py trace_all) ---------------------
  V3 beta = v3(1.0f, 1.0f, 1.0f), rad = v3(0.0f, 0.0f, 0.0f);
  V3 g_alb = rad, g_n = rad;
  float g_depth = INF, nray = 0.0f;
  int mirror = 0, diffuse = 0, sp = 0;
  bool is_primary = true, primary_hit = false, is_sky = false, g_valid = false;

  for (int round = 0; round < cfg.max_rounds; ++round) {
    nray += 1.0f;
    Hit h = intersect(sc, hdr, o, d, 1e-3f, INF);
    V3 pt = add(o, scale(d, h.t));
    const float* m = sc + hdr[H_OMAT] + h.mat * W_MAT;
    V3 albedo = ld3(m);
    if ((int)m[16] == 1) {  // world-XZ checker
      int cx = (int)floorf(pt.x / m[17]);
      int cz = (int)floorf(pt.z / m[17]);
      if (((cx + cz) & 1) != 0) albedo = ld3(m + 9);
    }
    if (!h.hit) {  // sky gradient
      float tbg = 0.5f * (d.y + 1.0f);
      V3 sky = add(scale(bg_bottom, 1.0f - tbg), scale(bg_top, tbg));
      rad = add(rad, mul(beta, sky));
      if (is_primary && !primary_hit) { is_sky = true; g_valid = true; }
      // A miss never continues; pop a pending stack item if any.
      if (sp == 0) break;
      Frame f = pop(st, --sp);
      o = f.o; d = f.d; beta = f.beta; mirror = f.mirror; diffuse = f.diffuse;
      continue;
    }
    if (is_primary) {
      primary_hit = true;
      if (!g_valid) { g_alb = albedo; g_n = h.n; g_depth = h.t; g_valid = true; }
      is_primary = false;
    }
    rad = add(rad, mul(beta, ld3(m + 3)));

    float transparency = m[14], reflectivity = m[13];
    bool transparent = transparency > 0.0f;
    bool can_bounce = mirror < cfg.max_mirror;
    bool is_mirror = !transparent && reflectivity >= cfg.mirror_threshold;
    bool is_diffuse = !transparent && !is_mirror;
    V3 n = h.n;

    if (transparent && can_bounce) {  // Fresnel reflect + refract pushes
      bool front = dot(n, d) < 0.0f;
      V3 nl = front ? n : neg(n);
      float ior = m[15];
      float eta_i = front ? 1.0f : ior, eta_t = front ? ior : 1.0f;
      float eta = eta_i / eta_t;
      V3 refl_dir = normalize(reflect(d, nl));
      float cosi = -clampf(dot(d, nl), -1.0f, 1.0f);
      float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
      V3 refr_dir = add(scale(d, eta), scale(nl, eta * cosi - sqrtf(fmaxf(k, 0.0f))));
      float rr = (eta_i - eta_t) / (eta_i + eta_t);
      float r0 = rr * rr;
      float fres = r0 + (1.0f - r0) * pow5(1.0f - fabsf(dot(nl, neg(d))));
      float tr_amt = clampf(transparency, 0.0f, 1.0f);
      float t_w = k >= 0.0f ? (1.0f - fres) * tr_amt : 0.0f;
      float r_w = clampf(fres + reflectivity * (1.0f - fres), 0.0f, 1.0f);
      if (r_w > 0.0f && sp < cfg.stack_slots)
        push(st, sp++, {add(pt, scale(nl, EPS)), refl_dir,
                        scale(mul(beta, albedo), r_w), mirror + 1, diffuse});
      if (t_w > 0.0f && sp < cfg.stack_slots)
        push(st, sp++, {sub(pt, scale(nl, EPS)), normalize(refr_dir),
                        scale(mul(beta, ld3(m + 6)), t_w), mirror + 1, diffuse});
    }

    V3 wo = neg(d);
    bool want_bounce = false;
    if (is_diffuse) {
      rad = add(rad, mul(beta, mul(amb_rgb, albedo)));
      V3 acc = v3(0.0f, 0.0f, 0.0f);
      V3 so = add(pt, scale(n, EPS));
      for (int l = 0; l < hdr[H_NLIGHT]; ++l) {
        const float* lr = sc + hdr[H_OLIGHT] + l * W_LIGHT;
        V3 to_l = sub(ld3(lr), pt);
        float dist2 = fmaxf(dot(to_l, to_l), 1e-12f);
        float dist = sqrtf(dist2);
        V3 ldir = v3(to_l.x / dist, to_l.y / dist, to_l.z / dist);
        float ndotl = fmaxf(dot(n, ldir), 0.0f);
        float intensity = lr[6];
        if (!(ndotl > 0.0f && intensity > 0.0f)) continue;
        // Shadow ray: colored transmittance through transparent hits.
        V3 tr = v3(1.0f, 1.0f, 1.0f);
        float smax = dist - EPS;
        if (hdr[H_BINARY]) {
          nray += 1.0f;
          Hit sh = intersect(sc, hdr, so, ldir, 1e-3f, smax);
          if (sh.hit) tr = v3(0.0f, 0.0f, 0.0f);
        } else {
          float smin = EPS;
          for (int it = 0; it < cfg.max_refr; ++it) {
            nray += 1.0f;
            Hit sh = intersect(sc, hdr, so, ldir, smin, smax);
            if (!sh.hit) break;
            const float* sm = sc + hdr[H_OMAT] + sh.mat * W_MAT;
            if (sm[14] <= 0.0f) { tr = v3(0.0f, 0.0f, 0.0f); break; }
            tr = mul(tr, scale(ld3(sm + 6), sm[14]));
            if (tr.x <= 1e-6f && tr.y <= 1e-6f && tr.z <= 1e-6f) break;
            smin = sh.t + EPS;
          }
          if (tr.x <= 1e-6f && tr.y <= 1e-6f && tr.z <= 1e-6f) tr = v3(0.0f, 0.0f, 0.0f);
        }
        float atten = intensity / dist2;
        V3 f_on = oren_nayar(albedo, n, wo, ldir, cfg.on_a, cfg.on_b);
        V3 contrib = mul(scale(mul(scale(f_on, ndotl), ld3(lr + 3)), atten), tr);
        acc = add(acc, contrib);
      }
      rad = add(rad, mul(beta, acc));
      want_bounce = diffuse < cfg.diffuse_bounces;
    }

    bool mirror_cont = is_mirror && can_bounce;
    if (mirror_cont) {
      o = add(pt, scale(n, EPS));
      d = normalize(reflect(d, n));
      beta = mul(beta, albedo);
      ++mirror;
      continue;
    }
    if (want_bounce) {  // cosine hemisphere bounce (core/sampler.py)
      float u1 = rng_next_unit(rng);
      float u2 = rng_next_unit(rng);
      float rs = sqrtf(u1);
      float phi = u2 * TWO_PI_F;
      float bx2 = rs * cosf(phi), by2 = rs * sinf(phi);
      float bz2 = sqrtf(fmaxf(1.0f - u1, 0.0f));
      bool degen = n.z < -0.999999f;
      float a = 1.0f / (1.0f + (degen ? 0.0f : n.z));
      float b = -n.x * n.y * a;
      V3 ua = degen ? v3(0.0f, -1.0f, 0.0f) : v3(1.0f - n.x * n.x * a, b, -n.x);
      V3 va = degen ? v3(-1.0f, 0.0f, 0.0f) : v3(b, 1.0f - n.y * n.y * a, -n.y);
      V3 bdir = v3(ua.x * bx2 + va.x * by2 + n.x * bz2,
                   ua.y * bx2 + va.y * by2 + n.y * bz2,
                   ua.z * bx2 + va.z * by2 + n.z * bz2);
      V3 f_b = oren_nayar(albedo, n, wo, bdir, cfg.on_a, cfg.on_b);
      o = add(pt, scale(n, EPS));
      d = bdir;
      beta = scale(mul(beta, f_b), PI_F);
      ++diffuse;
      continue;
    }
    // The path ends here: pop a pending stack item if any.
    if (sp == 0) break;
    Frame f = pop(st, --sp);
    o = f.o; d = f.d; beta = f.beta; mirror = f.mirror; diffuse = f.diffuse;
  }

  float vals[12] = {rad.x, rad.y, rad.z, is_sky ? 1.0f : 0.0f,
                    g_alb.x, g_alb.y, g_alb.z, g_n.x, g_n.y, g_n.z, g_depth, nray};
#pragma unroll
  for (int c = 0; c < 12; ++c) out[(size_t)c * n_pix + pix] = vals[c];
}

}  // namespace

extern "C" {

const char* yacge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int yacge_trace_launch(const float* scene, const int* header, int table_len,
                       const float* params_all, const int* frames, int row,
                       float* out, int width, int height, int y0, int band_h,
                       int max_rounds,
                       int max_mirror, int max_refr, int diffuse_bounces,
                       int stack_slots, float mirror_threshold,
                       float on_a, float on_b, unsigned long long salt,
                       void* stream_ptr) {
  TraceArgs cfg{max_rounds, max_mirror, max_refr, diffuse_bounces, stack_slots,
                mirror_threshold, on_a, on_b, salt};
  size_t smem = sizeof(float) * ((size_t)HDR_PAD + table_len +
                                 (size_t)THREADS * stack_slots * W_STACK);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (y0 < 0 || band_h < 1 || y0 + band_h > height) return (int)cudaErrorInvalidValue;
  int n = width * band_h;
  trace_kernel<<<(n + THREADS - 1) / THREADS, THREADS, smem, (cudaStream_t)stream_ptr>>>(
      scene, header, table_len, params_all, frames, row, out, width, height, y0, band_h,
      cfg);
  return (int)cudaGetLastError();
}

}  // extern "C"
