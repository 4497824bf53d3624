// Post-processing of one frame (sm_90a): TAA, the dilated à-trous passes,
// auto-exposure and the tone-map + ANSI-256 tail.
//
// Replaces the Pallas program yetanotherconsolegameengine_tpu/ops/
// pallas_post.py::build_post_kernel (its pallas_call at :434). The TPU
// version keeps every plane in VMEM and runs one program. Here each pass
// reads +-2*dilation around a pixel, across tiles, and the exposure is a
// whole-image reduction the tail reads, so the phases need grid-wide order.
//
// What bounds it on this card: at terminal sizes (28.8k pixels for 160x180)
// the planes (~3 MB) live in L2 and the arithmetic is ~2.4k flops a pixel,
// a least time of ~1 us; what costs is latency: dependent phases, and
// 75 taps a pixel on one thread a pixel, under 8 warps an SM. The design:
//
// * One launch: a cooperative grid of co-resident blocks (occupancy x SMs,
//   at most one block a tile) loops over 16x16 output tiles in each phase;
//   cooperative_groups grid syncs separate TAA -> pass 1 -> ... -> last
//   pass (+ each tile's exposure partial) -> exposure and tail. (Two
//   launches, the first running TAA and every pass per tile with the halo
//   recomputed, +-15 pixels, measured 2.7x (160x180) and 4x (240x270)
//   slower on an H100, PERF.md § 6.)
// * Each phase stages its tile plus halo in shared memory with coalesced
//   loads, and taps read shared memory only. TAA writes, once per pixel,
//   the guide record the passes share: (unit normal, guide depth) and
//   (albedo, sky) as two float4, so a tap does not normalise. Each pass
//   stages colour as (rgb, luma). Staging windows are the tile +- halo cut
//   to the image, and every tap clamps its index to the image edge first.
//   A phase whose window does not fit in a block's shared memory (a fifth
//   pass: +-32 pixels, 80x80 cells of 48 B; a TAA clamp radius above ~80)
//   reads its taps from the same records in global memory instead; the
//   default configuration stages every phase.
// * The exposure is a fixed-order sum: each tile's partial (log-luma sum
//   and count over its sample_step grid points) is a tree over the tile's
//   256 threads, and the total a strided sum over tiles then a tree, the
//   same order however the blocks ran (tests/test_torch_kernel_orders.py
//   models it on the CPU). Every block computes the same exposure itself;
//   block 0 writes it.
//
// * Row bands (parallel/sharding.py): a band of a frame sharded by rows is
//   two launches. Launch A is the kernel above over the band plus its halo
//   rows (the extended band; its edges clamp like image edges, and what
//   that changes stays inside the halo): it writes blended and denoised
//   colour of the owned rows only and, in place of exposure and tail, one
//   (log-luma sum, count) partial over the owned rows, sampled on global
//   rows (y_base is the extended band's first global row), by the same
//   fixed-order sum. The ranks combine their partials; launch B
//   (post_band_tail, one thread a pixel) computes the exposure from the
//   combined partial and runs the tail on the owned rows. The whole frame
//   stays the one launch (y_base 0, every row owned, no partial out).
//
// Arithmetic follows the plain PyTorch stages (ops/taa.py, atrous.py,
// tonemap.py, ansi.py) operation by operation; only the exposure sum's
// order differs from torch's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr float INF_DEPTH = 3.0e38f;   // trace output for "no hit"
constexpr float FAR_DEPTH = 3.4e38f;   // the G-buffer depth the post reads

// G-buffer plane indices (ops/trace_kernel.py PLANES).
enum { G_RAD = 0, G_SKY = 3, G_ALB = 4, G_NRM = 7, G_DEPTH = 10 };

// Output tiles; keep in sync with ops/post_kernel.py TILE_H, TILE_W.
constexpr int TILE_W = 16, TILE_H = 16, THREADS = TILE_W * TILE_H;
constexpr int SHARED_LIMIT = 232448;

struct PostArgs {
  float alpha, lum_pad;
  int clamp_radius;
  float inv_c, inv_n, inv_z, inv_a;
  int sample_step, auto_exposure;
  float ae_key, ae_min, ae_max, ae_rate;
  float tone_exposure, inv_gamma, saturation, vibrance;
};

// Everything one call touches. col, guide and partials are written and
// read within a launch (across grid syncs), so they are not restrict.
struct Post {
  const float* gb;
  const float* prev;
  const float* hist;
  const unsigned char* force_reset;
  const unsigned char* history_valid;
  const float* ae_in;
  float* out;
  int* ansi;
  float* ae_out;
  float* part_out;   // band mode: the owned rows' (sum, count); else null
  float4* col;       // 2 x n: (rgb, luma), ping-pong between passes
  float4* guide;     // 2 x n: (unit normal, guide depth), (albedo, sky)
  float* partials;   // 2 per tile: log-luma sum, count (int bits)
  int w, h, n, tiles_x, n_tiles, iterations, fuse_tail;
  // Owned rows [own0, own1) of the launch's rows, written to out with a
  // plane stride of out_n pixels; y_base: the global row of row 0.
  int own0, own1, out_n, y_base;
  PostArgs a;
};

__device__ __forceinline__ float luma(float r, float g, float b) {
  return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}
__device__ __forceinline__ float guide_depth(float z) {
  return z >= INF_DEPTH ? FAR_DEPTH : z;
}
__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// A staging window: the pixels [y0, y0 + hh) x [x0, x0 + ww), all inside
// the image, in row-major shared memory.
struct Win {
  int y0, x0, hh, ww;
  __device__ __forceinline__ int cells() const { return hh * ww; }
  __device__ __forceinline__ int cell(int y, int x) const {
    return (y - y0) * ww + (x - x0);
  }
};

__device__ __forceinline__ Win window(const Post& p, int tile, int halo) {
  int ty = tile / p.tiles_x, tx = tile - ty * p.tiles_x;
  int y0 = max(ty * TILE_H - halo, 0), x0 = max(tx * TILE_W - halo, 0);
  int y1 = min((ty + 1) * TILE_H + halo, p.h), x1 = min((tx + 1) * TILE_W + halo, p.w);
  return {y0, x0, y1 - y0, x1 - x0};
}

// This thread's pixel of a tile; false past the image edge.
__device__ __forceinline__ bool tile_pixel(const Post& p, int tile, int& y, int& x) {
  int ty = tile / p.tiles_x, tx = tile - ty * p.tiles_x;
  y = ty * TILE_H + (int)threadIdx.x / TILE_W;
  x = tx * TILE_W + (int)threadIdx.x % TILE_W;
  return y < p.h && x < p.w;
}

// Whether row y is owned, and pixel (y, x)'s index in out's planes.
__device__ __forceinline__ bool owned(const Post& p, int y) {
  return y >= p.own0 && y < p.own1;
}
__device__ __forceinline__ int out_index(const Post& p, int y, int x) {
  return (y - p.own0) * p.w + x;
}

// Shared memory: a reduction area, then a pass's staged colour and guide;
// TAA's (luma, sky) of the current radiance aliases the colour.
struct Smem {
  float* red_v;
  int* red_c;
  float2* ls;
  float4 *col, *g0, *g1;
};

// Tree sum over the block's threads, in one fixed order.
__device__ void block_sum(float& v, int& c, const Smem& s) {
  int t = threadIdx.x;
  s.red_v[t] = v;
  s.red_c[t] = c;
  __syncthreads();
  for (int k = THREADS / 2; k > 0; k >>= 1) {
    if (t < k) {
      s.red_v[t] = s.red_v[t] + s.red_v[t + k];
      s.red_c[t] = s.red_c[t] + s.red_c[t + k];
    }
    __syncthreads();
  }
  v = s.red_v[0];
  c = s.red_c[0];
  __syncthreads();
}

// ---- TAA (ops/taa.py temporal_blend) ---------------------------------------
// (luma, sky) of the current radiance at pixel i.
__device__ __forceinline__ float2 luma_sky(const Post& p, int i) {
  const float* gb = p.gb;
  return make_float2(luma(gb[i], gb[p.n + i], gb[2 * p.n + i]),
                     gb[G_SKY * p.n + i] > 0.5f ? 1.0f : 0.0f);
}

__device__ void stage_luma_sky(const Post& p, Win win, float2* ls) {
  for (int c = threadIdx.x; c < win.cells(); c += THREADS)
    ls[c] = luma_sky(p, (win.y0 + c / win.ww) * p.w + win.x0 + c % win.ww);
}

// Blended rgb of pixel (y, x) and its guide record; ls holds (luma, sky)
// of the window ``win`` around it, or is null and the taps read them from
// the G-buffer.
__device__ void taa_pixel(const Post& p, bool reset, const float2* ls, Win win,
                          int y, int x, float4& c, float4& g0, float4& g1) {
  const PostArgs& a = p.a;
  const float* gb = p.gb;
  const float* pv = p.prev;
  size_t n = p.n;
  int i = y * p.w + x;
  float cr = gb[i], cg = gb[n + i], cb = gb[2 * n + i];
  bool sky = gb[G_SKY * n + i] > 0.5f;
  float nx = gb[G_NRM * n + i], ny = gb[(G_NRM + 1) * n + i], nz = gb[(G_NRM + 2) * n + i];
  float len = fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-20f);
  float dep = guide_depth(gb[G_DEPTH * n + i]);
  g0 = make_float4(nx / len, ny / len, nz / len, dep);
  g1 = make_float4(gb[G_ALB * n + i], gb[(G_ALB + 1) * n + i], gb[(G_ALB + 2) * n + i],
                   sky ? 1.0f : 0.0f);
  if (reset) {
    c = make_float4(cr, cg, cb, luma(cr, cg, cb));
    return;
  }
  float pdep = guide_depth(pv[G_DEPTH * n + i]);
  bool nonfinite = !(isfinite(dep) && isfinite(pdep));
  float rel = fabsf(dep - pdep) / fmaxf(fminf(dep, pdep), 1e-4f);
  float px = pv[G_NRM * n + i], py = pv[(G_NRM + 1) * n + i], pz = pv[(G_NRM + 2) * n + i];
  float plen = fmaxf(sqrtf(px * px + py * py + pz * pz), 1e-20f);
  float ndot = g0.x * (px / plen) + g0.y * (py / plen) + g0.z * (pz / plen);
  bool react = (sky != (pv[G_SKY * n + i] > 0.5f)) || nonfinite || rel > 0.05f ||
               ndot < 0.8f;
  float la = react ? 1.0f : a.alpha;

  float min_l = INFINITY, max_l = -INFINITY;
  for (int oy = -a.clamp_radius; oy <= a.clamp_radius; ++oy)
    for (int ox = -a.clamp_radius; ox <= a.clamp_radius; ++ox) {
      int ty = clampi(y + oy, p.h - 1), tx = clampi(x + ox, p.w - 1);
      float2 v = ls ? ls[win.cell(ty, tx)] : luma_sky(p, ty * p.w + tx);
      if ((v.y > 0.5f) != sky) continue;
      min_l = fminf(min_l, v.x);
      max_l = fmaxf(max_l, v.x);
    }
  float rng = max_l - min_l;
  float l_min = min_l - rng * a.lum_pad, l_max = max_l + rng * a.lum_pad;
  float hr = p.hist[i], hg = p.hist[n + i], hb = p.hist[2 * n + i];
  float prev_l = luma(hr, hg, hb);
  float safe_l = fmaxf(prev_l, 1e-6f);
  float s = prev_l > l_max ? l_max / safe_l : (prev_l < l_min ? l_min / safe_l : 1.0f);
  float ka = 1.0f - la;
  float br = hr * s * ka + cr * la, bg = hg * s * ka + cg * la, bb = hb * s * ka + cb * la;
  c = make_float4(br, bg, bb, luma(br, bg, bb));
}

__device__ __forceinline__ void write_rgb(float* plane0, size_t n, int i, float4 c) {
  plane0[i] = c.x;
  plane0[n + i] = c.y;
  plane0[2 * n + i] = c.z;
}

// ---- à-trous (ops/atrous.py) -----------------------------------------------
__constant__ float K5[5] = {1.0f / 16.0f, 1.0f / 4.0f, 3.0f / 8.0f, 1.0f / 4.0f,
                            1.0f / 16.0f};

// Where a pass's taps read colour and guide: the staged window ``win`` in
// shared memory, or the whole image (win = the image) in global memory.
struct Stencil {
  const float4 *col, *g0, *g1;
  Win win;
};

__device__ Stencil stage_pass(const Post& p, Win win, const float4* src, const Smem& s) {
  for (int c = threadIdx.x; c < win.cells(); c += THREADS) {
    int i = (win.y0 + c / win.ww) * p.w + win.x0 + c % win.ww;
    s.col[c] = src[i];
    s.g0[c] = p.guide[i];
    s.g1[c] = p.guide[p.n + i];
  }
  return {s.col, s.g0, s.g1, win};
}

// One pass at dilation ``step`` for pixel (y, x). Returns (rgb, luma).
__device__ float4 atrous_pixel(const Post& p, const Stencil& st, int step, int y,
                               int x) {
  const float4* col = st.col;
  const Win& win = st.win;
  const PostArgs& a = p.a;
  int me = win.cell(y, x);
  float4 c0 = col[me], n0 = st.g0[me], a0 = st.g1[me];
  if (a0.w > 0.5f) return c0;  // sky passes through
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int ky = -2; ky <= 2; ++ky) {
    int row = (clampi(y + ky * step, p.h - 1) - win.y0) * win.ww - win.x0;
#pragma unroll
    for (int kx = -2; kx <= 2; ++kx) {
      int j = row + clampi(x + kx * step, p.w - 1);
      float4 tc = col[j], ta = st.g1[j];
      float w = 0.0f;
      if (!(ta.w > 0.5f)) {
        float4 tn = st.g0[j];
        float dl = fabsf(tc.w - c0.w);
        float dn = fmaxf(1.0f - (n0.x * tn.x + n0.y * tn.y + n0.z * tn.z), 0.0f);
        float dz = fabsf(tn.w - n0.w);
        float da = fabsf(ta.x - a0.x) + fabsf(ta.y - a0.y) + fabsf(ta.z - a0.z);
        float w_base = K5[kx + 2] * K5[ky + 2];
        w = w_base * expf(-(dl * a.inv_c + dn * a.inv_n + dz * a.inv_z + da * a.inv_a));
      }
      ar = ar + tc.x * w;
      ag = ag + tc.y * w;
      ab = ab + tc.z * w;
      wsum = wsum + w;
    }
  }
  if (!(wsum > 1e-8f)) return c0;
  float ws = fmaxf(wsum, 1e-8f);
  float r = ar / ws, g = ag / ws, b = ab / ws;
  return make_float4(r, g, b, luma(r, g, b));
}

// The last pass's pixels of a tile, one per thread in tile order: write
// out[3:6] and the tile's exposure partial over the sample_step grid.
__device__ void last_pass_tile(const Post& p, int tile, const Stencil& st, int step,
                               const Smem& s) {
  int y, x;
  float v = 0.0f;
  int cnt = 0;
  if (tile_pixel(p, tile, y, x) && owned(p, y)) {
    float4 c = atrous_pixel(p, st, step, y, x);
    write_rgb(p.out + 3 * (size_t)p.out_n, p.out_n, out_index(p, y, x), c);
    bool sky = st.g1[st.win.cell(y, x)].w > 0.5f;
    if ((y + p.y_base) % p.a.sample_step == 0 && x % p.a.sample_step == 0 && !sky &&
        c.w > 0.0f) {
      v = logf(1e-6f + c.w);
      cnt = 1;
    }
  }
  block_sum(v, cnt, s);
  if (threadIdx.x == 0) {
    p.partials[2 * tile] = v;
    p.partials[2 * tile + 1] = __int_as_float(cnt);
  }
}

// ---- exposure and tail (ops/tonemap.py, ops/ansi.py) -----------------------
// The tiles' partials summed in one fixed order: strided over tiles, then
// a tree over the block.
__device__ void tile_total(const Post& p, const Smem& s, float& v, int& cnt) {
  v = 0.0f;
  cnt = 0;
  for (int k = threadIdx.x; k < p.n_tiles; k += THREADS) {
    v = v + p.partials[2 * k];
    cnt += __float_as_int(p.partials[2 * k + 1]);
  }
  block_sum(v, cnt, s);
}

// The new exposure from the image's (log-luma sum, count) and the last one
// (tonemap.exposure_from_partials).
__device__ __forceinline__ float exposure_from(const PostArgs& a, float ae, float v,
                                               int cnt) {
  if (a.auto_exposure) {
    float avg = expf(v / (float)max(cnt, 1));
    float target = fminf(fmaxf(a.ae_key / fmaxf(avg, 1e-6f), a.ae_min), a.ae_max);
    if (cnt == 0) target = ae;
    ae = ae + (target - ae) * a.ae_rate;
  }
  return ae;
}

__device__ float exposure(const Post& p, const Smem& s) {
  float v;
  int cnt;
  tile_total(p, s, v, cnt);
  return exposure_from(p.a, *p.ae_in, v, cnt);
}

__device__ __forceinline__ float aces(float x) {
  float num = x * (2.51f * x + 0.03f);
  float den = x * (2.43f * x + 0.59f) + 0.14f;
  return fminf(fmaxf(den > 0.0f ? num / den : 0.0f, 0.0f), 1.0f);
}
__device__ __forceinline__ float srgb8(float c) {
  c = fminf(fmaxf(c, 0.0f), 1.0f);
  float s = c <= 0.0031308f ? 12.92f * c : 1.055f * powf(c, 1.0f / 2.4f) - 0.055f;
  return rintf(fminf(fmaxf(s * 255.0f, 0.0f), 255.0f));
}
__device__ __forceinline__ int cube_level(float v) {
  return (v >= 48.0f) + (v >= 114.0f) + (v >= 154.0f) + (v >= 194.0f) + (v >= 234.0f);
}

__constant__ float CUBE[6] = {0.0f, 95.0f, 135.0f, 175.0f, 215.0f, 255.0f};

// Tone map + saturation + ANSI-256 of pixel i of the n-pixel planes src,
// written to dst (may be src) and ansi.
__device__ void tail_pixel(const PostArgs& a, const float* src, float* dst, int* ansi,
                           size_t n, int i, float ae) {
  float eff = a.tone_exposure * ae;
  float c[3];
  for (int k = 0; k < 3; ++k)
    c[k] = powf(fminf(fmaxf(aces(fmaxf(src[k * n + i], 0.0f) * eff), 0.0f), 1.0f),
                a.inv_gamma);
  float y = luma(c[0], c[1], c[2]);
  float chroma = fmaxf(c[0], fmaxf(c[1], c[2])) - fminf(c[0], fminf(c[1], c[2]));
  float f = a.saturation * (1.0f + a.vibrance * (1.0f - chroma));
  for (int k = 0; k < 3; ++k) {
    c[k] = fminf(fmaxf(y + (c[k] - y) * f, 0.0f), 1.0f);
    dst[k * n + i] = c[k];
  }
  float r = srgb8(c[0]), g = srgb8(c[1]), b = srgb8(c[2]);
  int ir = cube_level(r), ig = cube_level(g), ib = cube_level(b);
  int idx_cube = 16 + 36 * ir + 6 * ig + ib;
  float dr = r - CUBE[ir], dg = g - CUBE[ig], db = b - CUBE[ib];
  float d_cube = dr * dr + dg * dg + db * db;
  float y8 = srgb8(luma(c[0], c[1], c[2]));
  int gi = (int)fminf(fmaxf(rintf((y8 - 8.0f) / 10.0f), 0.0f), 23.0f);
  float gv = 8.0f + 10.0f * (float)gi;
  float gr = r - gv, gg = g - gv, gbb = b - gv;
  float d_gray = gr * gr + gg * gg + gbb * gbb + 64.0f;
  float chr = fmaxf(fabsf(r - g), fmaxf(fabsf(r - b), fabsf(g - b)));
  ansi[i] = (chr <= 18.0f && d_gray < d_cube) ? 232 + gi : idx_cube;
}

// Every block: the exposure; block 0 writes it; with the tail, the
// block's tiles.
__device__ void exposure_and_tail(const Post& p, const Smem& s) {
  float ae = exposure(p, s);
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.ae_out = ae;
  if (!p.fuse_tail) return;
  float* img = p.out + 3 * (size_t)p.n;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    int y, x;
    if (tile_pixel(p, t, y, x)) tail_pixel(p.a, img, img, p.ansi, p.n, y * p.w + x, ae);
  }
}

// Band mode, launch A's end: block 0 writes the owned rows' partial.
__device__ void band_partial(const Post& p, const Smem& s) {
  if (blockIdx.x != 0) return;
  float v;
  int cnt;
  tile_total(p, s, v, cnt);
  if (threadIdx.x == 0) {
    p.part_out[0] = v;
    p.part_out[1] = (float)cnt;
  }
}

// ---- shared-memory layout -------------------------------------------------
// Cells of a window of halo ``halo`` around a full tile.
__host__ __device__ __forceinline__ long long win_cells(long long halo) {
  return (TILE_H + 2 * halo) * (TILE_W + 2 * halo);
}
constexpr int RED_BYTES = THREADS * 8;

// Whether a window of ``cell_bytes`` a cell fits beside the reduction
// area (no halo above 1024 does; the bound keeps the product in range).
__host__ __device__ __forceinline__ bool fits(long long halo, int cell_bytes) {
  return halo <= 1024 && RED_BYTES + cell_bytes * win_cells(halo) <= SHARED_LIMIT;
}
// Whether a phase stages its window: a pass's (colour, g0, g1) at 48 B a
// cell, TAA's (luma, sky) at 8 B.
__host__ __device__ __forceinline__ bool pass_staged(int step) {
  return fits(2LL * step, 48);
}
__host__ __device__ __forceinline__ bool taa_staged(int clamp_radius) {
  return fits(clamp_radius, 8);
}

// float4 cells of each of the colour, g0 and g1 windows: enough for every
// staged pass and, as float2 aliasing the colour, for a staged TAA.
__host__ __device__ __forceinline__ int window_cells(int clamp_radius, int iterations) {
  long long cells = 0;
  for (int it = 0; it < iterations && pass_staged(1 << it); ++it)
    cells = win_cells(2LL << it);
  if (taa_staged(clamp_radius)) {
    long long taa = (win_cells(clamp_radius) + 1) / 2;  // float2 cells in float4s
    cells = cells > taa ? cells : taa;
  }
  return (int)cells;
}
__host__ __device__ __forceinline__ size_t shared_bytes(int clamp_radius, int iterations) {
  return RED_BYTES + (size_t)3 * 16 * window_cells(clamp_radius, iterations);
}

__device__ Smem carve(unsigned char* base, int cells) {
  Smem s;
  s.red_v = reinterpret_cast<float*>(base);
  s.red_c = reinterpret_cast<int*>(base + THREADS * 4);
  float4* f4 = reinterpret_cast<float4*>(base + RED_BYTES);
  s.col = f4;
  s.g0 = f4 + cells;
  s.g1 = f4 + 2 * cells;
  s.ls = reinterpret_cast<float2*>(f4);
  return s;
}

// ---- the kernel ---------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) post_persistent(Post p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const PostArgs& a = p.a;
  Smem s = carve(smem, window_cells(a.clamp_radius, p.iterations));
  bool reset = *p.force_reset || !*p.history_valid;
  bool stage_taa = taa_staged(a.clamp_radius);

  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {  // TAA
    Win win = window(p, t, a.clamp_radius);
    if (stage_taa) stage_luma_sky(p, win, s.ls);
    __syncthreads();
    int y, x;
    if (tile_pixel(p, t, y, x)) {
      float4 c, g0, g1;
      taa_pixel(p, reset, stage_taa ? s.ls : nullptr, win, y, x, c, g0, g1);
      int i = y * p.w + x;
      if (owned(p, y)) write_rgb(p.out, p.out_n, out_index(p, y, x), c);
      p.col[i] = c;
      p.guide[i] = g0;
      p.guide[p.n + i] = g1;
    }
    __syncthreads();
  }
  for (int it = 0; it < p.iterations; ++it) {  // the à-trous passes
    grid.sync();
    int step = 1 << it;
    const float4* src = p.col + (size_t)(it % 2) * p.n;
    float4* dst = p.col + (size_t)((it + 1) % 2) * p.n;
    bool staged = pass_staged(step);
    Stencil image = {src, p.guide, p.guide + p.n, {0, 0, p.h, p.w}};
    for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      Stencil st = staged ? stage_pass(p, window(p, t, 2 * step), src, s) : image;
      __syncthreads();
      if (it == p.iterations - 1) {
        last_pass_tile(p, t, st, step, s);
      } else {
        int y, x;
        if (tile_pixel(p, t, y, x))
          dst[y * p.w + x] = atrous_pixel(p, st, step, y, x);
      }
      __syncthreads();
    }
  }
  grid.sync();
  if (p.part_out)
    band_partial(p, s);
  else
    exposure_and_tail(p, s);
}

// Band mode, launch B: the exposure from the ranks' combined partial
// total = (log-luma sum, count), then with fuse_tail the tail of the n
// owned pixels from src into dst and ansi.
__global__ void __launch_bounds__(THREADS)
post_band_tail(const float* __restrict__ src, float* __restrict__ dst, int* __restrict__ ansi,
               const float* __restrict__ total, const float* __restrict__ ae_in,
               float* __restrict__ ae_out, int n, int fuse_tail, PostArgs a) {
  float ae = exposure_from(a, *ae_in, total[0], (int)total[1]);
  int i = blockIdx.x * THREADS + threadIdx.x;
  if (i == 0) *ae_out = ae;
  if (fuse_tail && i < n) tail_pixel(a, src, dst, ansi, (size_t)n, i, ae);
}

// Blocks per SM of the persistent kernel at ``smem`` bytes, and SMs; asked
// once per (device, smem).
cudaError_t persistent_capacity(size_t smem, int& per_sm, int& sms) {
  static int c_dev = -1, c_per_sm = 0, c_sms = 0;
  static size_t c_smem = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != c_dev || smem != c_smem) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(post_persistent,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &c_per_sm, post_persistent, THREADS, smem)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&c_sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    c_dev = dev;
    c_smem = smem;
  }
  per_sm = c_per_sm;
  sms = c_sms;
  return cudaSuccess;
}

}  // namespace

// The whole frame (part_out null: y_base 0, own0 0, own1 height) or launch
// A of a band (part_out: 2 floats; ansi, ae_in, ae_out unused).
extern "C" int yacge_post_launch(
    const float* gbuf, const float* prev_gbuf, const float* history,
    const unsigned char* force_reset, const unsigned char* history_valid,
    const float* ae_in, float* out, int* ansi, float* ae_out, float* scratch,
    float* part_out, int width, int height, int y_base, int own0, int own1,
    int iterations, int fuse_tail, float alpha,
    float lum_pad, int clamp_radius, float inv_c, float inv_n, float inv_z,
    float inv_a, int sample_step, int auto_exposure, float ae_key,
    float ae_min, float ae_max, float ae_rate, float tone_exposure,
    float inv_gamma, float saturation, float vibrance, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (iterations < 1 || clamp_radius < 0 || sample_step < 1 || y_base < 0 ||
      own0 < 0 || own0 >= own1 || own1 > height ||
      (!part_out && (y_base != 0 || own0 != 0 || own1 != height)))
    return (int)cudaErrorInvalidValue;
  Post p;
  p.gb = gbuf; p.prev = prev_gbuf; p.hist = history;
  p.force_reset = force_reset; p.history_valid = history_valid;
  p.ae_in = ae_in; p.out = out; p.ansi = ansi; p.ae_out = ae_out;
  p.part_out = part_out;
  p.w = width; p.h = height; p.n = width * height;
  p.own0 = own0; p.own1 = own1; p.out_n = width * (own1 - own0); p.y_base = y_base;
  p.tiles_x = (width + TILE_W - 1) / TILE_W;
  p.n_tiles = p.tiles_x * ((height + TILE_H - 1) / TILE_H);
  p.iterations = iterations; p.fuse_tail = fuse_tail;
  // scratch (ops/post_kernel.py scratch_floats): col 2n, guide 2n float4s,
  // then 2 floats per tile.
  p.col = reinterpret_cast<float4*>(scratch);
  p.guide = p.col + 2 * (size_t)p.n;
  p.partials = reinterpret_cast<float*>(p.guide + 2 * (size_t)p.n);
  p.a = PostArgs{alpha, lum_pad, clamp_radius, inv_c, inv_n, inv_z, inv_a,
                 sample_step, auto_exposure, ae_key, ae_min, ae_max, ae_rate,
                 tone_exposure, inv_gamma, saturation, vibrance};
  size_t smem = shared_bytes(clamp_radius, iterations);
  int per_sm, sms;
  cudaError_t err = persistent_capacity(smem, per_sm, sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int grid = per_sm * sms < p.n_tiles ? per_sm * sms : p.n_tiles;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel((void*)post_persistent, grid, THREADS, args,
                                          smem, stream);
}

extern "C" int yacge_post_tail_launch(
    const float* src, float* dst, int* ansi, const float* total, const float* ae_in,
    float* ae_out, int n, int fuse_tail, float alpha, float lum_pad, int clamp_radius,
    float inv_c, float inv_n, float inv_z, float inv_a, int sample_step,
    int auto_exposure, float ae_key, float ae_min, float ae_max, float ae_rate,
    float tone_exposure, float inv_gamma, float saturation, float vibrance,
    void* stream_ptr) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  PostArgs a{alpha, lum_pad, clamp_radius, inv_c, inv_n, inv_z, inv_a,
             sample_step, auto_exposure, ae_key, ae_min, ae_max, ae_rate,
             tone_exposure, inv_gamma, saturation, vibrance};
  int grid = fuse_tail ? (n + THREADS - 1) / THREADS : 1;
  post_band_tail<<<grid, THREADS, 0, (cudaStream_t)stream_ptr>>>(
      src, dst, ansi, total, ae_in, ae_out, n, fuse_tail, a);
  return (int)cudaGetLastError();
}
