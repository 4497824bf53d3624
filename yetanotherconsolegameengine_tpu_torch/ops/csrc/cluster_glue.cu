// The cluster sweep's cull and resolve around K3 (sm_90a): three launches
// a sweep of ops/mesh_clusters.py::intersect_clusters on the card.
//
// Replaces no Pallas kernel. The JAX package's cull and resolve are XLA ops
// (yetanotherconsolegameengine_tpu/ops/mesh_clusters.py, intersect_clusters
// around _run_kernel), and so is the port's plain twin, ops/mesh_clusters.py
// ::_sweep (the prefilter, the binning keys, _tile_cull, the unsort and the
// Moller-Trumbore recompute). On the card that twin is ~360 small torch
// kernels a sweep (two Morton loops of 21 shift-and-or rounds, three
// interval tests of nested selects over (tiles, sub-bundles, clusters), the
// padding, gathers and scatters): the dragon's frame spent most of its host
// time launching them, for under 2 ms of device work.
//
//   prep     one thread a ray, the batch padded to whole 256-ray tiles: the
//            global-AABB prefilter and window clamp (t_hi = min(t_hi,
//            tf * 1.0001 + 1e-3)), the binning key (octant << 21 | 5-bit
//            origin Morton << 6 | 2-bit direction Morton; 1 << 29 for a
//            lane out of play), and the ray's packed row o, d, tmin, t_hi.
//            With binning on, the row's t_hi is -1 for a lane out of play,
//            so the row alone says whether it plays, as in the twin. The
//            bounds come as a (P,) array or a number, so a Python bound is
//            an argument and no copy from the host.
//   (the binning order is torch.sort(key, stable=True) between the two)
//   cull     one block a tile: the tile's rows gathered through the sort's
//            permutation (or in place), K3's rays (o, d, tmin, tinit)
//            written, each 64-ray sub-bundle's origin and direction box
//            folded in shared memory, the three slab intervals of every
//            sub-bundle against every cluster box, the cluster's key the
//            least entry t over the sub-bundles that may touch it (3e38
//            where none may), and the list: (key, id) pairs ordered near to
//            far by a bitonic sort in shared memory. The ids are unique, so
//            that order is exactly torch.sort's stable order. A set of more
//            than kSortMax clusters writes the keys alone, and the wrapper
//            orders them with torch.sort (the count of clusters decides).
//            That second way for every set cost the dragon's frame 0.44 to
//            0.68 ms more host time and 0.03 to 0.06 ms more device time
//            on an H100 (six more device operations a sweep; PERF.md § 6),
//            so the sort in shared memory stays where it fits.
//   resolve  one thread a sorted lane: K3's two winner words unsorted
//            through the permutation, the winner's triangle row gathered
//            and Moller-Trumbore rerun for t, u, v; the normal flipped
//            against the ray; in any-hit mode t or 3e38, n = -d, u = v = 0
//            and the material of row 0.
//
// Every value equals the twin's bit for bit: each product and sum its own
// rounding (built with -fmad=false), IEEE division, the literals rounded
// from the double as torch rounds a Python float, torch's NaN-propagating
// minimum, maximum and clamp, the reductions' folds (torch_order.cuh,
// shared with prim_kernel.cu). The sub-bundle boxes
// and the cluster keys are minima and maxima of values that hold no NaN,
// and no -0 can change what they select, so their order of folding is
// free. So K3 sees the lists the twin gives it.
//
// What bounds it on this card: neither bytes (~60 a ray in, 32 a ray and
// 8 a list entry out) nor operations (a few dozen a ray, ~200 a tile and
// cluster), but the launches and, in the cull, a tile's chain: the rays
// staged, the sub-bundles folded, the clusters tested, the list sorted,
// each between two barriers. The design keeps one launch for each and the
// intermediate arrays of the twin out of device memory; the launches
// neither allocate nor wait.

#include <cuda_runtime.h>

#include "torch_order.cuh"

namespace {

constexpr int kTile = 256;       // rays a tile (K3's and the twin's TILE)
constexpr int kSubW = 64;        // rays a sub-bundle (SUB_W)
constexpr int kSubs = kTile / kSubW;
constexpr int kThreads = 256;
constexpr int kSortMax = 4096;   // pairs a tile's sort holds (SORT_MAX)
constexpr int kOut = 1 << 29;    // a lane out of play's binning key
// A sub-bundle's box: origin min[3], max[3], direction min[3], max[3], the
// largest window end of its lanes in play, whether any lane is in play.
constexpr int kBox = 14;

// ops/mesh_clusters.py's literals as torch rounds them to float32: from
// the Python float (a double), once.
constexpr float kInf = static_cast<float>(3.0e38);
constexpr float kBig = static_cast<float>(2.0e30);
constexpr float kFar = static_cast<float>(1.0e30);
constexpr float kWinScale = static_cast<float>(1.0001);
constexpr float kWinPad = static_cast<float>(1e-3);
constexpr float kCandPad = static_cast<float>(1e-4);
constexpr float kSpanMin = static_cast<float>(1e-6);
constexpr float kDirScale = static_cast<float>(3.999);
constexpr float kTinitMax = static_cast<float>(3.0e37);

// _morton3: three `bits`-bit ints interleaved, x lowest.
__device__ __forceinline__ int morton3(const int* q, int bits) {
  int code = 0;
  for (int b = 0; b < bits; ++b)
    for (int ax = 0; ax < 3; ++ax) code |= ((q[ax] >> b) & 1) << (3 * b + ax);
  return code;
}

// _sort_keys for a lane in play: direction octant, origin Morton over the
// mesh bounds `bd` (min x, y, z, max x, y, z), direction Morton.
__device__ int sort_key(const float* o, const float* d, const float* bd) {
  const int oct = (d[0] < 0.0f ? 1 : 0) | (d[1] < 0.0f ? 2 : 0) |
                  (d[2] < 0.0f ? 4 : 0);
  int q[3], dq[3];
  for (int c = 0; c < 3; ++c) {
    const float span = clamp_lo(bd[3 + c] - bd[c], kSpanMin);
    q[c] = static_cast<int>(clamp((o[c] - bd[c]) / span * 31.0f, 0.0f,
                                  31.0f));
    dq[c] = static_cast<int>(clamp(fabsf(d[c]) * kDirScale, 0.0f, 3.0f));
  }
  return (oct << 21) | (morton3(q, 5) << 6) | morton3(dq, 2);
}

__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ tmin, float tmin_s,
            const float* __restrict__ tmax, float tmax_s,
            const float* __restrict__ bounds, int n_rays, int n_pad,
            int presort, float* __restrict__ rows, int* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  float* row = rows + 8 * static_cast<size_t>(i);
  if (i >= n_rays) {   // padding: o = 0, d = 1, window 0, out of play
    for (int c = 0; c < 3; ++c) {
      row[c] = 0.0f;
      row[3 + c] = 1.0f;
    }
    row[6] = 0.0f;
    row[7] = presort ? -1.0f : 0.0f;
    keys[i] = kOut;
    return;
  }
  float ro[3], rd[3], bd[6];
  for (int c = 0; c < 3; ++c) {
    ro[c] = o[3 * i + c];
    rd[c] = d[3 * i + c];
  }
  for (int c = 0; c < 6; ++c) bd[c] = bounds[c];
  const float lo = tmin ? tmin[i] : tmin_s;
  float hi = tmax ? tmax[i] : tmax_s;
  const float o_max = amax_step(amax_step(fabsf(ro[0]), fabsf(ro[1])),
                                fabsf(ro[2]));
  float near3[3], far3[3];
  for (int c = 0; c < 3; ++c) {
    const float inv = safe_div(1.0f, rd[c]);
    const float ta = (bd[c] - ro[c]) * inv;
    const float tb = (bd[3 + c] - ro[c]) * inv;
    near3[c] = tmin2(ta, tb);
    far3[c] = tmax2(ta, tb);
  }
  const float tn = amax_step(amax_step(near3[0], near3[1]), near3[2]);
  const float tf = amin_step(amin_step(far3[0], far3[1]), far3[2]);
  const bool active = o_max < kFar && tn <= tf && tf >= lo && tn <= hi;
  hi = tmin2(hi, tf * kWinScale + kWinPad);
  for (int c = 0; c < 3; ++c) {
    row[c] = ro[c];
    row[3 + c] = rd[c];
  }
  row[6] = lo;
  row[7] = presort ? (active ? hi : -1.0f) : hi;
  keys[i] = active ? sort_key(ro, rd, bd) : kOut;
}

// _axis_interval of one axis: [t_lo, t_hi] of a sub-bundle's box (origin
// ol..oh, direction dl..dh) in the slab lo..hi; t_hi clamped at 0.
__device__ __forceinline__ void axis_interval(float ol, float oh, float dl,
                                              float dh, float lo, float hi,
                                              float& t_lo, float& t_hi) {
  const bool overlap = oh >= lo && ol <= hi;
  const bool right = ol > hi;
  t_lo = overlap ? 0.0f
                 : (right ? (dl < 0.0f ? (hi - ol) / dl : kInf)
                          : (dh > 0.0f ? (lo - oh) / dh : kInf));
  t_hi = clamp_lo(dl > 0.0f ? (hi - ol) / dl
                            : (dh < 0.0f ? (lo - oh) / dh : kInf),
                  0.0f);
}

// Every loop of a block strides by blockDim.x, so one thread a block runs
// it whole (as the tests run the kernel's code on the host).
__global__ void __launch_bounds__(kThreads)
cull_kernel(const float* __restrict__ rows, const int* __restrict__ keys,
            const long long* __restrict__ sidx,
            const float* __restrict__ cbmin, const float* __restrict__ cbmax,
            int n_clusters, int n_pairs, float* __restrict__ rays,
            int* __restrict__ ids, float* __restrict__ entry_t,
            int* __restrict__ lens) {
  __shared__ float s_o[3][kTile], s_d[3][kTile], s_thi[kTile];
  __shared__ bool s_act[kTile];
  __shared__ float s_box[kSubs][kBox];
  __shared__ int s_len;
  extern __shared__ unsigned long long s_pairs[];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) s_len = 0;

  // The tile's rows, in play read from the sign of t_hi (binning on) or
  // from the key; K3's rays.
  for (int r = tid; r < kTile; r += nt) {
    const long long dst = static_cast<long long>(tile) * kTile + r;
    const long long src = sidx ? sidx[dst] : dst;
    float v[8];
    for (int c = 0; c < 8; ++c) v[c] = rows[8 * src + c];
    const bool act = sidx ? v[7] >= 0.0f : keys[src] != kOut;
    const float thi = sidx ? clamp_lo(v[7], 0.0f) : v[7];
    float* out = rays + 8 * dst;
    for (int c = 0; c < 7; ++c) out[c] = v[c];
    out[7] = act ? clamp_hi(thi, kTinitMax) : __int_as_float(0xff800000);
    for (int c = 0; c < 3; ++c) {
      s_o[c][r] = v[c];
      s_d[c][r] = v[3 + c];
    }
    s_thi[r] = thi;
    s_act[r] = act;
  }
  __syncthreads();

  // Sub-bundle boxes: one fold a (sub-bundle, quantity) over its 64 rays,
  // a lane out of play giving the twin's fill (2e30, -2e30 or 0).
  for (int job = tid; job < kSubs * kBox; job += nt) {
    const int s = job / kBox, k = job % kBox;
    const int c = k < 12 ? k % 3 : 0;
    const float* x = k < 6 ? s_o[c] : (k < 12 ? s_d[c] : s_thi);
    const bool lower = k < 3 || (k >= 6 && k < 9);
    const float fill = k == 12 ? 0.0f : (lower ? kBig : -kBig);
    const int r0 = s * kSubW;
    float acc = s_act[r0] ? x[r0] : fill;
    bool any = s_act[r0];
    for (int r = r0 + 1; r < r0 + kSubW; ++r) {
      const float v = s_act[r] ? x[r] : fill;
      acc = lower ? amin_step(acc, v) : amax_step(acc, v);
      any = any || s_act[r];
    }
    s_box[s][k] = k == 13 ? (any ? 1.0f : 0.0f) : acc;
  }
  __syncthreads();

  // Every cluster box against every sub-bundle: its key and whether any
  // sub-bundle may touch it.
  int listed = 0;
  const size_t base = static_cast<size_t>(tile) * n_clusters;
  for (int cl = tid; cl < n_clusters; cl += nt) {
    float lo3[3], hi3[3];
    for (int c = 0; c < 3; ++c) {
      lo3[c] = cbmin[3 * cl + c];
      hi3[c] = cbmax[3 * cl + c];
    }
    float key = kInf;
    bool cand_any = false;
    for (int s = 0; s < kSubs; ++s) {
      const float* b = s_box[s];
      float t_lo = 0.0f, t_hi = kInf;
      for (int ax = 0; ax < 3; ++ax) {
        float a_lo, a_hi;
        axis_interval(b[ax], b[3 + ax], b[6 + ax], b[9 + ax], lo3[ax],
                      hi3[ax], a_lo, a_hi);
        t_lo = tmax2(t_lo, a_lo);
        t_hi = tmin2(t_hi, a_hi);
      }
      const bool cand = t_lo <= t_hi * kWinScale + kCandPad &&
                        t_lo < b[12] && b[13] != 0.0f;
      key = amin_step(key, cand ? t_lo : kInf);
      cand_any = cand_any || cand;
    }
    listed += cand_any ? 1 : 0;
    // Every key is +0 or above, so its bits order as the float does.
    if (n_pairs)
      s_pairs[cl] = (static_cast<unsigned long long>(__float_as_uint(key))
                     << 32) | static_cast<unsigned>(cl);
    else
      entry_t[base + cl] = key;
  }
  atomicAdd(&s_len, listed);

  if (n_pairs) {
    for (int i = n_clusters + tid; i < n_pairs; i += nt) s_pairs[i] = ~0ull;
    __syncthreads();
    // Bitonic sort, ascending, of n_pairs (a power of two) pairs.
    for (int k = 2; k <= n_pairs; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < n_pairs; i += nt) {
          const int l = i ^ j;
          if (l <= i) continue;
          const unsigned long long a = s_pairs[i], b = s_pairs[l];
          if ((a > b) == ((i & k) == 0)) {
            s_pairs[i] = b;
            s_pairs[l] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int cl = tid; cl < n_clusters; cl += nt) {
      const unsigned long long p = s_pairs[cl];
      ids[base + cl] = static_cast<int>(p & 0xffffffffu);
      entry_t[base + cl] = __uint_as_float(static_cast<unsigned>(p >> 32));
    }
  }
  __syncthreads();
  if (tid == 0) lens[tile] = s_len;
}

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const float* __restrict__ t_w, const int* __restrict__ win,
               const long long* __restrict__ sidx, int n_rays, int n_pad,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tri_rows, int any_hit,
               float* __restrict__ out_t, float* __restrict__ out_n,
               float* __restrict__ out_u, float* __restrict__ out_v,
               int* __restrict__ out_mat, bool* __restrict__ out_hit) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_pad) return;
  const long long k = sidx ? sidx[j] : j;
  if (k >= n_rays) return;   // a padding lane
  const float tw = t_w[j];
  const int w = win[j];
  const bool hit = w >= 0;
  float ro[3], rd[3];
  for (int c = 0; c < 3; ++c) {
    ro[c] = o[3 * k + c];
    rd[c] = d[3 * k + c];
  }
  out_hit[k] = hit;
  if (any_hit) {
    out_t[k] = hit ? tw : kInf;
    for (int c = 0; c < 3; ++c) out_n[3 * k + c] = -rd[c];
    out_u[k] = 0.0f;
    out_v[k] = 0.0f;
    out_mat[k] = hit ? static_cast<int>(tri_rows[12]) : 0;
    return;
  }
  const float* row = tri_rows + 16 * static_cast<size_t>(hit ? w : 0);
  float a[3], e1[3], e2[3], n[3];
  for (int c = 0; c < 3; ++c) {
    a[c] = row[c];
    e1[c] = row[3 + c];
    e2[c] = row[6 + c];
    n[c] = row[9 + c];
  }
  float h[3], s[3], q[3];
  cross3(h, rd, e2);
  const float det = dot3(e1, h);
  const float inv_det = safe_div(1.0f, det);
  for (int c = 0; c < 3; ++c) s[c] = ro[c] - a[c];
  const float u = dot3(s, h) * inv_det;
  cross3(q, s, e1);
  const float v = dot3(rd, q) * inv_det;
  const float t = dot3(e2, q) * inv_det;
  const bool ok = fabsf(det) >= kEps12;
  out_t[k] = hit ? (ok ? t : tw) : kInf;
  out_u[k] = clamp(ok ? u : 0.0f, 0.0f, 1.0f);
  out_v[k] = clamp(ok ? v : 0.0f, 0.0f, 1.0f);
  const bool keep = dot3(n, rd) < 0.0f;
  for (int c = 0; c < 3; ++c) out_n[3 * k + c] = keep ? n[c] : -n[c];
  out_mat[k] = static_cast<int>(row[12]);
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// o, d: (n_rays, 3); tmin / tmax: a (n_rays,) array, or NULL for the
// number beside; bounds: the mesh's (2, 3) box. Writes rows (n_pad, 8) and
// keys (n_pad,), n_pad a multiple of 256.
extern "C" int yacge_cluster_prep_launch(const float* o, const float* d,
                                         const float* tmin, float tmin_s,
                                         const float* tmax, float tmax_s,
                                         const float* bounds, int n_rays,
                                         int n_pad, int presort, float* rows,
                                         int* keys, void* stream_ptr) {
  if (n_pad == 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  prep_kernel<<<blocks(n_pad), kThreads, 0, stream>>>(
      o, d, tmin, tmin_s, tmax, tmax_s, bounds, n_rays, n_pad, presort, rows,
      keys);
  return (int)cudaGetLastError();
}

// sidx: the binning permutation (n_tiles * 256,), or NULL for the rows'
// own order. n_pairs: a power of two from n_clusters to kSortMax, the
// lists then ordered here; 0 writes the keys into entry_t unordered and
// leaves ids. Writes rays (n_tiles * 256, 8), ids and entry_t
// (n_tiles, n_clusters), lens (n_tiles,).
extern "C" int yacge_cluster_cull_launch(const float* rows, const int* keys,
                                         const long long* sidx,
                                         const float* cbmin,
                                         const float* cbmax, int n_tiles,
                                         int n_clusters, int n_pairs,
                                         float* rays, int* ids,
                                         float* entry_t, int* lens,
                                         void* stream_ptr) {
  if (n_pairs && (n_pairs < n_clusters || n_pairs > kSortMax ||
                  (n_pairs & (n_pairs - 1))))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t smem = sizeof(unsigned long long) * n_pairs;
  cull_kernel<<<n_tiles, kThreads, smem, stream>>>(
      rows, keys, sidx, cbmin, cbmax, n_clusters, n_pairs, rays, ids,
      entry_t, lens);
  return (int)cudaGetLastError();
}

// t_w, win: K3's words in the sorted lanes (n_pad,); sidx as above;
// o, d: (n_rays, 3); tri_rows: (C * kc, 16). Writes the Hit fields
// (n_rays,) and n (n_rays, 3).
extern "C" int yacge_cluster_resolve_launch(
    const float* t_w, const int* win, const long long* sidx, const float* o,
    const float* d, const float* tri_rows, int n_rays, int n_pad,
    int any_hit, float* out_t, float* out_n, float* out_u, float* out_v,
    int* out_mat, unsigned char* out_hit, void* stream_ptr) {
  if (n_pad == 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  resolve_kernel<<<blocks(n_pad), kThreads, 0, stream>>>(
      t_w, win, sidx, n_rays, n_pad, o, d, tri_rows, any_hit, out_t, out_n,
      out_u, out_v, out_mat, reinterpret_cast<bool*>(out_hit));
  return (int)cudaGetLastError();
}
