// Trilinear sampling of a channels-last feature grid, forward and backward,
// for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its sample_grid_trilinear
// (evennicer_slam_tpu/ops/grid_sample.py) to XLA. It was added because the
// mapper's sample as plain PyTorch ops is eight `flat[idx]` gathers a grid:
// autograd keeps the eight [N, C] corner arrays (and the lerps' operands) for
// the backward, and the gathers' backward zero-fills a grid-sized gradient
// each and sums it with a sorted index backward whose time is set by the
// longest run of points on one vertex, not by its bytes.
//
// Contract (evennicer_slam_tpu_torch/ops/grid_sample.py::sample_grid_trilinear,
// whose plain version is sample_grid_trilinear_plain): grid float32
// [Z, Y, X, C] contiguous, points p float32 [N, 3] in [-1, 1] (x, y, z),
// align_corners and border padding.
//   * Every kernel locates a point with `locate`, which repeats the plain
//     version's elementwise ops one by one with round-to-nearest intrinsics
//     and no FMA contraction: u = ((p + 1) * 0.5) * (size - 1), clamped into
//     [0, size - 1], floor, fraction u - floor(u), upper corner clamped at
//     size - 1. So all kernels see the plain version's cells and fractions.
//   * Forward: one warp a point, lane = channel; the eight corner rows read
//     straight from the grid and the seven lerps in the plain version's order
//     (c00 = c000 * (1 - fx) + c001 * fx, ..., out = c0 * (1 - fz) + c1 * fz),
//     each product and sum rounded once: the output is the plain version's
//     bit for bit. Nothing is written but the output.
//   * Both gradients repeat the plain version's autograd chain operation by
//     operation, so they too are its bits (the mapper's readings against the
//     plain reference move with any other order of summation: a mapping call
//     amplifies a last-bit difference of its grid gradient).
//   * Grid backward. Autograd gives each of the plain version's eight gathers
//     a zero-filled gradient summed point by point in order (a stable sort of
//     the indices, then one sequential sum a vertex: PyTorch's index
//     backward) and adds the eight as their nodes run, corner c111 first,
//     c000 last. Here: one key a (point, corner) pair, 8 times the corner's
//     vertex plus 7 - corner, sorted stably by the wrapper (pair index 8n + k,
//     so a key's pairs stay in point order); each key's run is summed in
//     sorted order from 0, lane = channel, each contribution recomputed in
//     registers as the chain forms it, ((g * wz) * wy) * wx, from the point's
//     cotangent row and fractions, and a vertex's runs are added in key order.
//     A vertex with more than SHORT pairs gets a block of 8 warps, one a run
//     (the coarse grid gets thousands of pairs a vertex), found by the block
//     whose tile of TILE sorted positions holds its first pair; the run's
//     loads are issued a batch of 32 pairs ahead of its additions. Every
//     other vertex is summed by a warp of 32 consecutive vertices, 0 where no
//     point lands. Every vertex is written once: no zero fill, no scatter, no
//     atomics, the same bits on every run.
//   * Coordinate backward: one warp a point; the corners read again; the
//     products of each lerp's cotangent and corner values, each reduced over
//     the channels as PyTorch's CUDA sum reduces a row (grid_sample_coord_kernel
//     has the order), added in the order autograd accumulates them, then
//     torch.clamp's pass-through (the gradient passes where the unclamped
//     coordinate lies in [0, size - 1], the ends included) and the chain rule
//     of u: times (size - 1), times 0.5.
//
// What bounds it on an H100 (3.35 TB/s), at the mapper's N = 48,000 points
// and C = 32: the forward reads 12 B of point a point and each touched grid
// row once (at most the grid, 23.3 MB for the 44x56x74 fine grid; a mapping
// batch touches a small part of it) and writes 128 B a point, 6.1 MB: about
// 2 us of memory. The grid backward reads 12 B and 128 B of cotangent a point
// and writes the whole grid once (23.3 MB, about 7 us); the sort moves 8N
// keys and pair indices. Arithmetic is a few multiply-adds a value. The eight
// corner reads a point and the backward's eight re-reads of the cotangent
// come from L2 (50 MB), so the kernels are bound by latency and L2 traffic,
// not by device memory: their design keeps many loads in flight (a warp a
// point; in a run the next 32 pairs' cotangent rows). The grid backward's
// sums are sequential a run, as the plain version's are, so the longest run
// sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;            // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int LONG_WARPS = 8;       // warps a block of the long kernel, one a corner key
constexpr int LONG_THREADS = 32 * LONG_WARPS;
constexpr int TILE = LONG_THREADS;  // sorted positions a block of the long kernel scans
constexpr int SHORT = 32;           // pairs a vertex of the short kernel has at most
constexpr unsigned FULL = 0xffffffffu;

struct Loc {
    int x0, y0, z0, x1, y1, z1;
    float fx, fy, fz;
    bool inx, iny, inz;   // the unclamped coordinate lies in [0, size - 1]
};

// One axis of sample_grid_trilinear_plain's _unnormalize (align_corners,
// border padding). A NaN coordinate lands on 0 (the plain version's index is
// undefined there), so no read leaves the grid.
__device__ __forceinline__ float unnorm(float p, int size, bool* inside) {
    const float hi = float(size - 1);
    const float u = __fmul_rn(__fmul_rn(__fadd_rn(p, 1.0f), 0.5f), hi);
    *inside = (u >= 0.0f) && (u <= hi);
    return fminf(fmaxf(u, 0.0f), hi);
}

__device__ __forceinline__ Loc locate_xyz(float px, float py, float pz, int Z, int Y, int X) {
    Loc l;
    const float ux = unnorm(px, X, &l.inx);
    const float uy = unnorm(py, Y, &l.iny);
    const float uz = unnorm(pz, Z, &l.inz);
    const float fx0 = floorf(ux), fy0 = floorf(uy), fz0 = floorf(uz);
    l.x0 = int(fx0);
    l.y0 = int(fy0);
    l.z0 = int(fz0);
    l.fx = __fsub_rn(ux, fx0);
    l.fy = __fsub_rn(uy, fy0);
    l.fz = __fsub_rn(uz, fz0);
    l.x1 = min(l.x0 + 1, X - 1);
    l.y1 = min(l.y0 + 1, Y - 1);
    l.z1 = min(l.z0 + 1, Z - 1);
    return l;
}

__device__ __forceinline__ Loc locate(const float* __restrict__ p, long long n,
                                      int Z, int Y, int X) {
    return locate_xyz(__ldg(p + 3 * n), __ldg(p + 3 * n + 1), __ldg(p + 3 * n + 2), Z, Y, X);
}

// The weight factors of corner k (bits dz dy dx) of a located point.
__device__ __forceinline__ void corner_weights(const Loc& l, int k, float& wz, float& wy,
                                               float& wx) {
    wz = (k & 4) ? l.fz : __fsub_rn(1.0f, l.fz);
    wy = (k & 2) ? l.fy : __fsub_rn(1.0f, l.fy);
    wx = (k & 1) ? l.fx : __fsub_rn(1.0f, l.fx);
}

__device__ __forceinline__ long long vertex(int z, int y, int x, int Y, int X) {
    return (static_cast<long long>(z) * Y + y) * X + x;
}

// c_a * (1 - f) + c_b * f, each operation rounded as the plain version's
__device__ __forceinline__ float lerp(float a, float b, float omf, float f) {
    return __fadd_rn(__fmul_rn(a, omf), __fmul_rn(b, f));
}

struct Corners {
    float c000, c001, c010, c011, c100, c101, c110, c111;
};

__device__ __forceinline__ Corners read_corners(const float* __restrict__ grid, const Loc& l,
                                                int Y, int X, int C, int c) {
    Corners k;
    k.c000 = __ldg(grid + vertex(l.z0, l.y0, l.x0, Y, X) * C + c);
    k.c001 = __ldg(grid + vertex(l.z0, l.y0, l.x1, Y, X) * C + c);
    k.c010 = __ldg(grid + vertex(l.z0, l.y1, l.x0, Y, X) * C + c);
    k.c011 = __ldg(grid + vertex(l.z0, l.y1, l.x1, Y, X) * C + c);
    k.c100 = __ldg(grid + vertex(l.z1, l.y0, l.x0, Y, X) * C + c);
    k.c101 = __ldg(grid + vertex(l.z1, l.y0, l.x1, Y, X) * C + c);
    k.c110 = __ldg(grid + vertex(l.z1, l.y1, l.x0, Y, X) * C + c);
    k.c111 = __ldg(grid + vertex(l.z1, l.y1, l.x1, Y, X) * C + c);
    return k;
}

__global__ void __launch_bounds__(THREADS)
grid_sample_fwd_kernel(const float* __restrict__ grid, const float* __restrict__ p,
                       int Z, int Y, int X, int C, long long n, float* __restrict__ out) {
    const long long pt = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
    if (pt >= n) return;
    const int lane = threadIdx.x & 31;
    const Loc l = locate(p, pt, Z, Y, X);
    const float omfx = __fsub_rn(1.0f, l.fx);
    const float omfy = __fsub_rn(1.0f, l.fy);
    const float omfz = __fsub_rn(1.0f, l.fz);
    for (int c = lane; c < C; c += 32) {
        const Corners k = read_corners(grid, l, Y, X, C, c);
        const float c00 = lerp(k.c000, k.c001, omfx, l.fx);
        const float c01 = lerp(k.c010, k.c011, omfx, l.fx);
        const float c10 = lerp(k.c100, k.c101, omfx, l.fx);
        const float c11 = lerp(k.c110, k.c111, omfx, l.fx);
        const float c0 = lerp(c00, c01, omfy, l.fy);
        const float c1 = lerp(c10, c11, omfy, l.fy);
        out[pt * C + c] = lerp(c0, c1, omfz, l.fz);
    }
}

// The sort key of corner k of every point, at 8n + k: its vertex times 8
// plus 7 - k, so that a vertex's pairs sort together and, inside the vertex,
// corner 7 (c111) first: the order in which autograd adds the plain version's
// eight gathers' gradients (see the header).
__global__ void __launch_bounds__(THREADS)
grid_sample_keys_kernel(const float* __restrict__ p, int Z, int Y, int X, long long n,
                        int* __restrict__ keys) {
    const long long pt = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    if (pt >= n) return;
    const Loc l = locate(p, pt, Z, Y, X);
    int* k = keys + 8 * pt;
    k[0] = int(vertex(l.z0, l.y0, l.x0, Y, X)) * 8 + 7;
    k[1] = int(vertex(l.z0, l.y0, l.x1, Y, X)) * 8 + 6;
    k[2] = int(vertex(l.z0, l.y1, l.x0, Y, X)) * 8 + 5;
    k[3] = int(vertex(l.z0, l.y1, l.x1, Y, X)) * 8 + 4;
    k[4] = int(vertex(l.z1, l.y0, l.x0, Y, X)) * 8 + 3;
    k[5] = int(vertex(l.z1, l.y0, l.x1, Y, X)) * 8 + 2;
    k[6] = int(vertex(l.z1, l.y1, l.x0, Y, X)) * 8 + 1;
    k[7] = int(vertex(l.z1, l.y1, l.x1, Y, X)) * 8 + 0;
}

// A vertex with at most 32 pairs, from its first sorted position s: lane j
// loads pair s + j (key, point, weights) and every lane the cotangent of each
// pair's point at its channel; then each run of one corner is summed in
// sorted order from 0 and the runs are added in key order, each as 0 + run
// (the zero-filled gradient of its gather).
__device__ float sum_short_vertex(const int* __restrict__ skeys,
                                  const long long* __restrict__ perm, long long s, long long e,
                                  const float* __restrict__ p, const float* __restrict__ g,
                                  long long g_stride, int Z, int Y, int X, int c, bool on,
                                  int lane) {
    const long long i = s + lane;
    int key = -1, pt = 0;
    float wz = 0.0f, wy = 0.0f, wx = 0.0f;
    if (i < e) {
        key = __ldg(skeys + i);
        const long long pair = __ldg(perm + i);
        pt = int(pair >> 3);
        corner_weights(locate(p, pt, Z, Y, X), int(pair & 7), wz, wy, wx);
    }
    const int cnt = int(e - s);
    float gv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int pj = __shfl_sync(FULL, pt, j);
        gv[j] = (on && j < cnt) ? __ldg(g + pj * g_stride + c) : 0.0f;
    }
    float total = 0.0f, run = 0.0f;
    int cur = -1;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int kj = __shfl_sync(FULL, key, j);
        const float a = __shfl_sync(FULL, wz, j);
        const float b = __shfl_sync(FULL, wy, j);
        const float d = __shfl_sync(FULL, wx, j);
        if (j < cnt) {
            if (kj != cur) {
                if (cur >= 0) total = __fadd_rn(total, __fadd_rn(0.0f, run));
                cur = kj;
                run = 0.0f;
            }
            run = __fadd_rn(run, __fmul_rn(__fmul_rn(__fmul_rn(gv[j], a), b), d));
        }
    }
    return __fadd_rn(total, __fadd_rn(0.0f, run));
}

// The loads of 32 sorted pairs (stage B of sum_run): lane j's corner and its
// point's coordinates, every lane's cotangent of each pair's point at its
// channel. Nothing loaded is used here, so the loads are in flight while the
// previous batch is summed.
struct Loads {
    int k;
    float px, py, pz;
    float g[32];
};

__device__ __forceinline__ void issue_loads(Loads& ld, long long pair, long long b, long long e,
                                            const float* __restrict__ p,
                                            const float* __restrict__ g, long long g_stride,
                                            int c, bool on, int lane) {
    const int pt = int(pair >> 3);
    ld.k = int(pair & 7);
    ld.px = ld.py = ld.pz = 0.0f;
    if (b + lane < e) {
        ld.px = __ldg(p + 3 * pt);
        ld.py = __ldg(p + 3 * pt + 1);
        ld.pz = __ldg(p + 3 * pt + 2);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int pj = __shfl_sync(FULL, pt, j);
        ld.g[j] = (on && b + j < e) ? __ldg(g + pj * g_stride + c) : 0.0f;
    }
}

// One run [a, e) of one key, summed in sorted order from 0, 32 pairs a batch
// in three stages a batch apart: A loads the pair indices two batches ahead,
// B issues the points' and cotangents' loads one batch ahead, C forms the
// contributions ((g * wz) * wy) * wx and adds them.
__device__ float sum_run(const long long* __restrict__ perm, long long a, long long e,
                         const float* __restrict__ p, const float* __restrict__ g,
                         long long g_stride, int Z, int Y, int X, int c, bool on, int lane) {
    long long pa1 = a + 32 + lane < e ? __ldg(perm + a + 32 + lane) : 0;
    Loads cur, nxt;
    issue_loads(cur, a + lane < e ? __ldg(perm + a + lane) : 0, a, e, p, g, g_stride, c, on,
                lane);
    float run = 0.0f;
    for (long long b = a;; b += 32) {
        const long long pa2 = b + 64 + lane < e ? __ldg(perm + b + 64 + lane) : 0;
        const bool more = b + 32 < e;
        if (more) issue_loads(nxt, pa1, b + 32, e, p, g, g_stride, c, on, lane);
        float wz, wy, wx;
        corner_weights(locate_xyz(cur.px, cur.py, cur.pz, Z, Y, X), cur.k, wz, wy, wx);
        const int cnt = int(min(32LL, e - b));
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const float f = __shfl_sync(FULL, wz, j);
            const float h = __shfl_sync(FULL, wy, j);
            const float q = __shfl_sync(FULL, wx, j);
            if (j < cnt)
                run = __fadd_rn(run, __fmul_rn(__fmul_rn(__fmul_rn(cur.g[j], f), h), q));
        }
        if (!more) break;
        cur = nxt;
        pa1 = pa2;
    }
    return run;
}

__device__ __forceinline__ long long lower_bound(const int* __restrict__ a, long long m,
                                                 int v) {
    long long lo = 0, hi = m;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (__ldg(a + mid) < v)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// Vertices with more than SHORT pairs. A block of 8 warps scans a tile of
// TILE sorted positions for the first positions of such vertices; for each,
// warp r sums the vertex's run of corner key r (searched in the sorted keys),
// and warp 0 adds the runs in key order. So every run of a long vertex has a
// warp of its own, and neighbouring long vertices are other blocks' work.
// Grid y: channel groups of 32.
__global__ void __launch_bounds__(LONG_THREADS)
grid_sample_long_kernel(const int* __restrict__ skeys, const long long* __restrict__ perm,
                        long long m, const float* __restrict__ p, const float* __restrict__ g,
                        long long g_stride, int Z, int Y, int X, int C,
                        float* __restrict__ dgrid) {
    __shared__ unsigned starts[LONG_WARPS];
    __shared__ float runs[LONG_WARPS][32];
    __shared__ int has[LONG_WARPS];
    const long long start = static_cast<long long>(blockIdx.x) * TILE;
    if (start >= m) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = blockIdx.y * 32 + lane;
    const bool on = c < C;
    {
        const long long i = start + threadIdx.x;
        bool first_of_long = false;
        if (i < m) {
            const int v = __ldg(skeys + i) >> 3;
            first_of_long = (i == 0 || (__ldg(skeys + i - 1) >> 3) != v) &&
                            i + SHORT < m && (__ldg(skeys + i + SHORT) >> 3) == v;
        }
        const unsigned mask = __ballot_sync(FULL, first_of_long);
        if (lane == 0) starts[warp] = mask;
    }
    __syncthreads();
    for (int w = 0; w < LONG_WARPS; ++w) {
        unsigned mask = starts[w];
        while (mask) {
            const long long s = start + 32 * w + (__ffs(mask) - 1);
            mask &= mask - 1;
            const int v = __ldg(skeys + s) >> 3;
            const int key = v * 8 + warp;
            const long long a = lower_bound(skeys + s, m - s, key) + s;
            const long long e = lower_bound(skeys + a, m - a, key + 1) + a;
            if (a < e)
                runs[warp][lane] = sum_run(perm, a, e, p, g, g_stride, Z, Y, X, c, on, lane);
            if (lane == 0) has[warp] = a < e;
            __syncthreads();
            if (warp == 0) {
                float total = 0.0f;
                for (int r = 0; r < LONG_WARPS; ++r)
                    if (has[r]) total = __fadd_rn(total, __fadd_rn(0.0f, runs[r][lane]));
                if (on) dgrid[static_cast<long long>(v) * C + c] = total;
            }
            __syncthreads();
        }
    }
}

// Every other vertex: a warp for 32 consecutive vertices, each lane finding
// one vertex's sorted range; a vertex no point reaches gets 0, one with at
// most SHORT pairs is walked here, a longer one is left to the long kernel.
// Grid y: channel groups of 32.
__global__ void __launch_bounds__(THREADS)
grid_sample_short_kernel(const int* __restrict__ skeys, const long long* __restrict__ perm,
                         long long m, const float* __restrict__ p, const float* __restrict__ g,
                         long long g_stride, int Z, int Y, int X, int C,
                         float* __restrict__ dgrid) {
    const long long cells = static_cast<long long>(Z) * Y * X;
    const long long base = ((static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5)
                           * 32;
    if (base >= cells) return;
    const int lane = threadIdx.x & 31;
    const int c = blockIdx.y * 32 + lane;
    const bool on = c < C;
    long long s = 0, e = 0;
    if (base + lane < cells) {
        s = lower_bound(skeys, m, int(base + lane) * 8);
        e = lower_bound(skeys, m, int(base + lane) * 8 + 8);
    }
    for (int j = 0; j < 32 && base + j < cells; ++j) {
        const long long sj = __shfl_sync(FULL, s, j);
        const long long ej = __shfl_sync(FULL, e, j);
        if (ej - sj > SHORT) continue;
        const float t = sj < ej ? sum_short_vertex(skeys, perm, sj, ej, p, g, g_stride, Z, Y,
                                                   X, c, on, lane)
                                : 0.0f;
        if (on) dgrid[(base + j) * C + c] = t;
    }
}

// PyTorch's CUDA sum over the last dimension of a contiguous [N, C] tensor
// (what autograd's reduction of a broadcast [N, 1] operand's gradient runs,
// ATen/native/cuda/Reduce.cuh for C <= 128): bw = min(largest power of two
// <= C, 32) threads an output; thread l adds channels l + i bw into four
// accumulators (i mod 4) from 0, then ((a0 + a1) + a2) + a3; the threads'
// values are added down a shuffle tree, offsets bw / 2, bw / 4, ..., 1 (lane
// 0 holds the sum). A lane >= bw holds 0.
struct Acc4 {
    float a[4];
};

__device__ __forceinline__ float reduce_lanes(const Acc4& v, int bw) {
    float x = __fadd_rn(__fadd_rn(__fadd_rn(v.a[0], v.a[1]), v.a[2]), v.a[3]);
    for (int o = bw >> 1; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_down_sync(FULL, x, o));
    return __shfl_sync(FULL, x, 0);
}

// The coordinate gradient, repeating the plain version's autograd chain
// operation by operation: the products of each lerp's cotangent with the
// corner values, each reduced over the channels as above (S), added in the
// order autograd accumulates them:
//   dfz = S(g c1) + -S(g c0)
//   dfy = ((S(g1 c11) + -S(g1 c10)) + S(g0 c01)) + -S(g0 c00)
//   dfx = S(g11 c111) + -S(g11 c110) + S(g10 c101) + -S(g10 c100)
//         + S(g01 c011) + -S(g01 c010) + S(g00 c001) + -S(g00 c000)  (left to right)
// with g0 = g (1 - fz), g1 = g fz, g00 = g0 (1 - fy), g01 = g0 fy, g10 = g1 (1 - fy),
// g11 = g1 fy; then torch.clamp's pass-through, times (size - 1), times 0.5,
// and + 0 (the three columns' select gradients added).
__global__ void __launch_bounds__(THREADS)
grid_sample_coord_kernel(const float* __restrict__ grid, const float* __restrict__ p,
                         const float* __restrict__ g, long long g_stride, int Z, int Y, int X,
                         int C, long long n, float* __restrict__ dp) {
    const long long pt = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
    if (pt >= n) return;
    const int lane = threadIdx.x & 31;
    const Loc l = locate(p, pt, Z, Y, X);
    const float omfx = __fsub_rn(1.0f, l.fx);
    const float omfy = __fsub_rn(1.0f, l.fy);
    const float omfz = __fsub_rn(1.0f, l.fz);
    int bw = 1;
    while (bw * 2 <= C && bw < 32) bw *= 2;
    Acc4 q[14];
#pragma unroll
    for (int k = 0; k < 14; ++k) q[k].a[0] = q[k].a[1] = q[k].a[2] = q[k].a[3] = 0.0f;
    if (lane < bw) {
        for (int c0 = lane; c0 < C; c0 += 4 * bw) {
#pragma unroll
            for (int slot = 0; slot < 4; ++slot) {
                const int c = c0 + slot * bw;
                if (c >= C) break;
                const Corners k = read_corners(grid, l, Y, X, C, c);
                const float gv = __ldg(g + pt * g_stride + c);
                const float c00 = lerp(k.c000, k.c001, omfx, l.fx);
                const float c01 = lerp(k.c010, k.c011, omfx, l.fx);
                const float c10 = lerp(k.c100, k.c101, omfx, l.fx);
                const float c11 = lerp(k.c110, k.c111, omfx, l.fx);
                const float c0 = lerp(c00, c01, omfy, l.fy);
                const float c1 = lerp(c10, c11, omfy, l.fy);
                const float g0 = __fmul_rn(gv, omfz), g1 = __fmul_rn(gv, l.fz);
                const float g00 = __fmul_rn(g0, omfy), g01 = __fmul_rn(g0, l.fy);
                const float g10 = __fmul_rn(g1, omfy), g11 = __fmul_rn(g1, l.fy);
                const float x[14] = {
                    __fmul_rn(gv, c1), __fmul_rn(gv, c0),
                    __fmul_rn(g1, c11), __fmul_rn(g1, c10), __fmul_rn(g0, c01), __fmul_rn(g0, c00),
                    __fmul_rn(g11, k.c111), __fmul_rn(g11, k.c110), __fmul_rn(g10, k.c101),
                    __fmul_rn(g10, k.c100), __fmul_rn(g01, k.c011), __fmul_rn(g01, k.c010),
                    __fmul_rn(g00, k.c001), __fmul_rn(g00, k.c000)};
#pragma unroll
                for (int t = 0; t < 14; ++t) q[t].a[slot] = __fadd_rn(q[t].a[slot], x[t]);
            }
        }
    }
    float S[14];
#pragma unroll
    for (int t = 0; t < 14; ++t) S[t] = reduce_lanes(q[t], bw);
    const float dfz = __fadd_rn(S[0], -S[1]);
    const float dfy = __fadd_rn(__fadd_rn(__fadd_rn(S[2], -S[3]), S[4]), -S[5]);
    float dfx = S[6];
#pragma unroll
    for (int t = 7; t < 14; ++t) dfx = __fadd_rn(dfx, (t & 1) ? -S[t] : S[t]);
    if (lane < 3) {
        const float df = lane == 0 ? dfx : (lane == 1 ? dfy : dfz);
        const bool in = lane == 0 ? l.inx : (lane == 1 ? l.iny : l.inz);
        const int size = lane == 0 ? X : (lane == 1 ? Y : Z);
        const float du = in ? df : 0.0f;
        dp[3 * pt + lane] = __fadd_rn(__fmul_rn(__fmul_rn(du, float(size - 1)), 0.5f), 0.0f);
    }
}

inline unsigned blocks_for(long long warps) {
    return unsigned((warps + WARPS - 1) / WARPS);
}

inline bool bad_shape(int Z, int Y, int X, int C) {
    return Z <= 0 || Y <= 0 || X <= 0 || C <= 0 ||
           static_cast<long long>(Z) * Y * X > 0x7fffffffLL;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). No synchronisation, no
// allocation: the wrapper allocates every output and scratch buffer. Each
// returns cudaGetLastError() (0 on success). grid float32 [Z*Y*X][C], p
// float32 [n][3], g (the cotangent of the output) float32 rows of C values
// g_stride apart.

// out float32 [n][C]
extern "C" int grid_sample_fwd(const void* grid, const void* p, int Z, int Y, int X, int C,
                               long long n, void* out, void* stream) {
    if (n <= 0) return 0;
    if (bad_shape(Z, Y, X, C)) return int(cudaErrorInvalidValue);
    grid_sample_fwd_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grid), static_cast<const float*>(p), Z, Y, X, C, n,
        static_cast<float*>(out));
    return int(cudaGetLastError());
}

// keys int32 [8n]: the sort key of corner k of point i at 8i + k (8 times
// its vertex plus 7 - k)
extern "C" int grid_sample_keys(const void* p, int Z, int Y, int X, long long n, void* keys,
                                void* stream) {
    if (n <= 0) return 0;
    if (bad_shape(Z, Y, X, 1) || static_cast<long long>(Z) * Y * X > 0x7fffffffLL / 8 ||
        n > 0x7fffffffLL / 8)
        return int(cudaErrorInvalidValue);
    const unsigned blocks = unsigned((n + THREADS - 1) / THREADS);
    grid_sample_keys_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), Z, Y, X, n, static_cast<int*>(keys));
    return int(cudaGetLastError());
}

// skeys int32 [8n]: the keys sorted stably, perm int64 [8n]: their pair
// indices (the sort's permutation); dgrid float32 [Z*Y*X][C], every value
// written.
extern "C" int grid_sample_grid_bwd(const void* skeys, const void* perm, const void* p,
                                    const void* g, long long g_stride, int Z, int Y, int X,
                                    int C, long long n, void* dgrid, void* stream) {
    if (n < 0 || bad_shape(Z, Y, X, C) || static_cast<long long>(Z) * Y * X > 0x7fffffffLL / 8 ||
        n > 0x7fffffffLL / 8)
        return int(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long m = 8 * n;
    const long long cells = static_cast<long long>(Z) * Y * X;
    const unsigned groups = unsigned((C + 31) / 32);
    const int* k = static_cast<const int*>(skeys);
    const long long* pm = static_cast<const long long*>(perm);
    const float* pp = static_cast<const float*>(p);
    const float* gg = static_cast<const float*>(g);
    float* out = static_cast<float*>(dgrid);
    if (m > 0) {
        grid_sample_long_kernel<<<dim3(unsigned((m + TILE - 1) / TILE), groups), LONG_THREADS,
                                  0, s>>>(k, pm, m, pp, gg, g_stride, Z, Y, X, C, out);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return int(err);
    }
    grid_sample_short_kernel<<<dim3(blocks_for((cells + 31) / 32), groups), THREADS, 0, s>>>(
        k, pm, m, pp, gg, g_stride, Z, Y, X, C, out);
    return int(cudaGetLastError());
}

// dp float32 [n][3]: the gradient to p. C at most 128 (the reduction over the
// channels repeats PyTorch's for that width).
extern "C" int grid_sample_coord_bwd(const void* grid, const void* p, const void* g,
                                     long long g_stride, int Z, int Y, int X, int C,
                                     long long n, void* dp, void* stream) {
    if (n <= 0) return 0;
    if (bad_shape(Z, Y, X, C) || C > 128) return int(cudaErrorInvalidValue);
    grid_sample_coord_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(grid), static_cast<const float*>(p),
        static_cast<const float*>(g), g_stride, Z, Y, X, C, n, static_cast<float*>(dp));
    return int(cudaGetLastError());
}
