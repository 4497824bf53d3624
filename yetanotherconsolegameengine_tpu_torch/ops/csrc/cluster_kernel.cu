// Cluster-mesh sweep (sm_90a): K3 of the port.
//
// Replaces the Pallas kernel yetanotherconsolegameengine_tpu/ops/
// mesh_clusters.py::_trace_kernel (launched by _run_kernel, its
// pallas_call at :557). It computes what that kernel computes, not its TPU
// mechanics: per ray of a 256-ray tile, the winner over the triangles of
// the tile's candidate list (cluster ids in near-to-far order of their
// conservative entry distance), each tested in fp32:
//     ou = Ux*ox + Uy*oy + Uz*oz + Uc   du = Ux*dx + Uy*dy + Uz*dz  (V, W alike)
//     t = -ow / dw,  u = ou + t*du,  v = ov + t*dv
//     valid = u, v, 1-u-v >= -1e-3  and  t > tmin (strict, per ray)
// The winner is the lexicographic minimum of (key(t), list index =
// e*kc + k), key(t) = t's bits with the low `qmask` bits cleared and e the
// entry's position in the tile's list: of equal keys the earlier entry
// wins, then the lower triangle slot, as in the TPU kernel.
//
// What bounds it on this card: the ray-triangle arithmetic (~40 fp32
// operations per test); the bytes (a 24 KB cluster block per entry, shared
// by every ray of the block) are small beside it. What limited the first,
// one-block-per-tile walk was not arithmetic but its shape: the longest
// list set the sweep time while most SMs idled, lanes without a live ray
// still ran the loop, and every cluster copy sat exposed between two
// barriers. This design:
//
//   1. Splits each tile's list into pieces of kPiece entries. A block is
//      one work item (kRaysPerBlock rays of a tile, first entry), so a
//      long list spreads over many SMs. The grid is (tiles x kParts,
//      ceil(C / kPiece)); an item past its tile's list length returns at
//      once, so the items need no host wait. The schedule was chosen on
//      the card (PERF.md); a retune edits the two constants.
//   2. Keeps one 64-bit word per ray in device memory: (order-preserving
//      uint32 image of key(t)) << 32 | list index, combined across blocks
//      with atomicMin. Its minimum is exactly the (key, index) rule, so the
//      winner does not depend on which block finishes first. The word
//      starts at (image of key(tinit)) << 32 | 0: only a strictly smaller
//      key beats tinit.
//   3. Before every entry the block asks which of its rays can still
//      improve: key(entry t) <= the key of the ray's current word (any-hit
//      mode: and no hit yet). Words only fall, and no triangle of an entry
//      is nearer than its entry distance, so the exit stays exact. Those
//      rays are packed into the first slots (ballot + prefix over warps);
//      when they fill fewer than all warps, the idle warps take a share of
//      the entry's kc triangles for the same rays (G groups of triangles),
//      so a tile with 16 live rays of 256 still runs full warps.
//   4. Double-buffers the cluster blocks: the cp.async copy of entry e+1
//      into shared memory runs under the tests of entry e (2 x 24 KB at
//      kc=512, past the 48 KB default, so the launcher raises the block's
//      dynamic shared memory limit).
//   5. An epilogue maps each winner's list index to its flat triangle id
//      (cluster*kc + k) and recomputes its exact t from its 12 gmat values
//      in the same operation order, so t is bit-equal to the plain version.
//
// In any-hit mode a ray stops at its first blocker, and any blocker may win
// (the frame reads only the hit mask there). Rays are rows of 8 floats: o
// (3), d (3), tmin, tinit; tinit is the ray's starting best key (its tmax)
// and -inf for a ray that takes no part. Outputs per ray: the winner's t
// (3e38 with no hit) and flat triangle id (-1 with no hit); per tile: the
// list entries tested, summed over its pieces.
//
// Not carried over from the TPU kernel: the hi/lo-bf16 K=12 matmul, the
// approximate reciprocal + Newton step, the winner packed into t's low
// mantissa bits, the SMEM list-chunk DMA, VISIT_BATCH and the 128-padding
// of the lists. Built with -fmad=false; the arithmetic follows
// ops/cluster_kernel.py::trace_tiles_plain operation by operation.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 256;      // rays per tile (the cull's unit)
constexpr int kThreads = 256;   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 12;       // Woop rows per cluster block
constexpr int kVec = 4;         // triangles per shared-memory load (float4)
constexpr int kMaxSmem = 200 * 1024;
constexpr int kPiece = 2;             // list entries per work item
constexpr int kRaysPerBlock = 128;    // rays of a tile per work item
constexpr int kParts = kTile / kRaysPerBlock;
static_assert(kRaysPerBlock % 32 == 0 && kTile % kRaysPerBlock == 0,
              "a work item is whole warps of one tile");
constexpr float kNoHit = 3.0e38f;

struct Sweep {
  const int* lens;
  const int* ids;
  const float* entry_t;
  const float* gmat;
  const float* rays;
  unsigned long long* best;
  int* steps;
  float* out_t;
  int* out_win;
  int n_tiles, n_lists, kc, any_hit, qmask;
};

__device__ __forceinline__ float key_of(float t, int qmask) {
  return __int_as_float(__float_as_int(t) & ~qmask);
}

// Order-preserving uint32 image of a key; -0 maps with +0.
__device__ __forceinline__ unsigned order_of(float key) {
  const unsigned b = __float_as_uint(key == 0.0f ? 0.0f : key);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long word_of(float key,
                                                      unsigned idx) {
  return ((unsigned long long)order_of(key) << 32) | idx;
}

__device__ __forceinline__ unsigned long long init_word(const Sweep& s,
                                                        size_t r) {
  return word_of(key_of(s.rays[r * 8 + 7], s.qmask), 0u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void init_kernel(Sweep s, int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_rays) s.best[i] = init_word(s, i);
  if (i < s.n_tiles) s.steps[i] = 0;
}

__global__ void __launch_bounds__(kThreads) sweep_kernel(Sweep s) {
  extern __shared__ float4 smem4[];   // two (12, kc) cluster blocks
  __shared__ unsigned long long slot_word[kTile];
  __shared__ int slot_ray[kTile];
  __shared__ int warp_live[kWarps];

  const int tile = blockIdx.x / kParts;
  const int n = s.lens[tile];
  const int e0 = blockIdx.y * kPiece;
  if (e0 >= n) return;
  const int e1 = min(n, e0 + kPiece);
  const size_t ray0 =
      (size_t)tile * kTile + (size_t)(blockIdx.x % kParts) * kRaysPerBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* list = s.ids + (size_t)tile * s.n_lists;
  const float* list_t = s.entry_t + (size_t)tile * s.n_lists;
  const int kc = s.kc, kq = kc / kVec;   // kq: float4 quads per row
  const int n4 = kRows * kq;          // float4 per cluster block
  volatile unsigned long long* best = s.best + ray0;
  // The ray this thread votes for, and the word it started from.
  const unsigned long long init =
      tid < kRaysPerBlock ? init_word(s, ray0 + tid) : 0ull;

  auto load = [&](int e, int buf) {
    const float4* src =
        reinterpret_cast<const float4*>(s.gmat) + (size_t)list[e] * n4;
    float4* dst = smem4 + buf * n4;
    for (int i = tid; i < n4; i += kThreads) cp_async16(dst + i, src + i);
    cp_async_commit();
  };

  load(e0, 0);
  int tested = 0;
  for (int e = e0; e < e1; ++e) {
    // 1. The vote: which rays can still improve on entry e.
    bool want = false;
    unsigned long long w = 0;
    if (tid < kRaysPerBlock) {
      w = best[tid];
      const unsigned ek = order_of(key_of(list_t[e], s.qmask));
      want = ek <= (unsigned)(w >> 32) && !(s.any_hit && w < init);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, want);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int n_live = 0, before = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = warp_live[i];
      before += i < warp ? c : 0;
      n_live += c;
    }
    if (n_live == 0) break;   // the same on every thread
    // 2. Pack the live rays into the first slots.
    if (want) {
      const int slot = before + __popc(ballot & ((1u << lane) - 1u));
      slot_ray[slot] = tid;
      slot_word[slot] = w;
    }
    ++tested;
    const int buf = (e - e0) & 1;
    if (e + 1 < e1) {
      load(e + 1, buf ^ 1);   // lands under this entry's tests
    } else {
      cp_async_commit();      // an empty group keeps the wait count
    }
    cp_async_wait<1>();
    __syncthreads();

    // 3. S slots (whole warps) x G groups of the kc triangles.
    const int S = (n_live + 31) & ~31;
    int G = 1;
    while (2 * G * S <= kThreads && 2 * G <= kq) G *= 2;
    const float4* rows = smem4 + buf * n4;   // row i, quad q: rows[i*kq + q]
    const unsigned base = (unsigned)e * (unsigned)kc;   // list index base
    for (int u = tid; u < S * G; u += kThreads) {
      const int slot = u % S, g = u / S;
      if (slot >= n_live) continue;
      const int rl = slot_ray[slot];
      const float4* ray = reinterpret_cast<const float4*>(s.rays) +
                          (ray0 + rl) * 2;
      const float4 ra = __ldg(ray), rb = __ldg(ray + 1);
      const float ox = ra.x, oy = ra.y, oz = ra.z, dx = ra.w;
      const float dy = rb.x, dz = rb.y, tmin = rb.z;
      const unsigned long long start = slot_word[slot];
      unsigned long long cur = start;
      const int q1 = (g + 1) * kq / G;
      for (int q = g * kq / G; q < q1; ++q) {
        float4 r4[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) r4[i] = rows[i * kq + q];
        // f[i*kVec + c]: row i of the quad's triangle c.
        const float* f = reinterpret_cast<const float*>(r4);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float ou = ((f[0 * kVec + c] * ox + f[1 * kVec + c] * oy)
                            + f[2 * kVec + c] * oz) + f[3 * kVec + c];
          const float du = (f[0 * kVec + c] * dx + f[1 * kVec + c] * dy)
                           + f[2 * kVec + c] * dz;
          const float ov = ((f[4 * kVec + c] * ox + f[5 * kVec + c] * oy)
                            + f[6 * kVec + c] * oz) + f[7 * kVec + c];
          const float dv = (f[4 * kVec + c] * dx + f[5 * kVec + c] * dy)
                           + f[6 * kVec + c] * dz;
          const float ow = ((f[8 * kVec + c] * ox + f[9 * kVec + c] * oy)
                            + f[10 * kVec + c] * oz) + f[11 * kVec + c];
          const float dw = (f[8 * kVec + c] * dx + f[9 * kVec + c] * dy)
                           + f[10 * kVec + c] * dz;
          const float t = -ow / dw;
          const float uu = ou + t * du;
          const float vv = ov + t * dv;
          // NaN (degenerate or padding slot) fails every comparison.
          if (uu >= -1e-3f && vv >= -1e-3f && (1.0f - uu) - vv >= -1e-3f &&
              t > tmin) {
            const unsigned long long cand =
                word_of(key_of(t, s.qmask), base + (unsigned)(kVec * q + c));
            cur = cand < cur ? cand : cur;
          }
        }
        if (s.any_hit && cur < start) break;
      }
      if (cur < start) atomicMin(s.best + ray0 + rl, cur);
    }
    __syncthreads();   // tests done: the buffer and the words are free
  }
  cp_async_wait<0>();
  if (tid == 0 && tested > 0) atomicAdd(s.steps + tile, tested);
}

// The winner's exact t from its W rows, in the sweep's operation order.
__global__ void epilogue_kernel(Sweep s, int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const unsigned long long w = s.best[i];
  if (w >= init_word(s, i)) {
    s.out_t[i] = kNoHit;
    s.out_win[i] = -1;
    return;
  }
  const unsigned idx = (unsigned)w;
  const int tile = i / kTile;
  const unsigned flat =
      (unsigned)s.ids[(size_t)tile * s.n_lists + idx / s.kc] * s.kc
      + idx % s.kc;
  const float* g = s.gmat + (size_t)(flat / s.kc) * kRows * s.kc
                   + flat % s.kc;
  const float* ray = s.rays + (size_t)i * 8;
  const float ow = ((g[8 * s.kc] * ray[0] + g[9 * s.kc] * ray[1])
                    + g[10 * s.kc] * ray[2]) + g[11 * s.kc];
  const float dw = (g[8 * s.kc] * ray[3] + g[9 * s.kc] * ray[4])
                   + g[10 * s.kc] * ray[5];
  s.out_t[i] = -ow / dw;
  s.out_win[i] = (int)flat;
}

}  // namespace

// lens (n_tiles,) i32; ids (n_tiles, n_lists) i32; entry_t (n_tiles,
// n_lists) f32; gmat (C, 12, kc) f32; rays (n_tiles*256, 8) f32; best
// (n_tiles*256,) u64 scratch. Three launches on `stream`: init words and
// steps, the sweep, the epilogue. Returns a cudaError_t (0 on success).
extern "C" int yacge_cluster_launch(
    const int* lens, const int* ids, const float* entry_t, const float* gmat,
    const float* rays, int n_tiles, int n_lists, int kc, int any_hit,
    int qmask, void* best, float* out_t, int* out_win, int* out_steps,
    void* stream_ptr) {
  if (n_tiles == 0) return 0;
  const int smem = 2 * kRows * kc * (int)sizeof(float);
  const int pieces = (n_lists + kPiece - 1) / kPiece;
  if (kc <= 0 || kc % 4 != 0 || smem > kMaxSmem || pieces > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Sweep s{lens, ids, entry_t, gmat, rays,
          static_cast<unsigned long long*>(best), out_steps, out_t, out_win,
          n_tiles, n_lists, kc, any_hit, qmask};
  const int n_rays = n_tiles * kTile;
  const int blocks = (n_rays + 255) / 256;
  init_kernel<<<blocks, 256, 0, stream>>>(s, n_rays);
  const dim3 grid(n_tiles * kParts, pieces);
  if (pieces > 0) sweep_kernel<<<grid, kThreads, smem, stream>>>(s);
  epilogue_kernel<<<blocks, 256, 0, stream>>>(s, n_rays);
  return (int)cudaGetLastError();
}
