// Fused colour-stage NICE decode, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_fwd_kernel` of
// evennicer_slam_tpu/ops/fused_decode.py (launched by `_fused_fwd_impl`).
// For every query point it computes, without any row or activation touching
// device memory:
//   1. the 8 trilinear corner weights from the two fraction triples,
//   2. the corner reduction of the point's packed-corner rows (bf16), read
//      from the two read-only packed grids at the point's cell indices, to
//      the features middle[32] | fine[32] | colour[32], in f32,
//   3. for each of the three MLPs (middle, fine, colour) the f32 Fourier
//      embedding sin(p . B) (93 wide) and five width-32 blocks with per-block
//      feature injection and the skip [emb | h] into block 3,
//   4. raw = (colour rgb, middle_occ + fine_occ).
// The fine MLP's feature is [fine | middle]; the middle copy carries no
// gradient, which is a statement about the backward only
// (fused_decode_bwd.cu). The device functions both kernels run are in
// fused_decode_common.cuh.
//
// Numerics (the contract the plain PyTorch version states too): both
// operands of every MLP product are rounded to bf16 (round to nearest even),
// products are accumulated in f32; the embedding product, the sine and the
// corner reduction are f32. The sine sees arguments of O(+-100), so this
// file must not be compiled with -use_fast_math and does not use __sinf: its
// sine is the math library's sinf bit for bit (sin_cos in the header).
// The corner reduction and the embedding argument use explicit
// round-to-nearest multiplies and adds (no FMA contraction) in the order of
// the plain version, so both produce bit-identical features and sine
// arguments; the only remaining difference is the order of the f32 sums
// inside the MLP products (the tensor cores' own).
//
// What bounds it on an H100: each point reads 44 B of point, fractions and
// cell indices and writes 16 B, and the rows of its two cells (1,536 B),
// against 50,816 multiply-adds with bf16 operands and 279 sines. A ray's
// samples and its neighbours share cells, so the distinct rows a call reads
// are far fewer than its points and mostly hit L2: the memory floor is the
// points' own 60 B (0.02 ms at N = 881,280 and 3.35 TB/s) plus the distinct
// rows once, against 0.09 ms of products at the bf16 tensor-core peak. On the
// CUDA cores the products alone would cost 1.3 ms of f32 FMA at N = 881,280,
// and about twice that counting the bf16 unpacks: they have to run on the
// tensor cores.
//
// Design. The three MLPs keep their own weights (51,200 bf16 values with the
// embedding padded to 96 rows, 102 KB, swizzled for ldmatrix) and are staged
// once per block into shared memory, with the f32 biases, embedding matrices
// and heads (9 KB). One persistent block per SM; its FD_WARPS warps each walk
// their own tiles of 16 x FD_MTILES points (warp-level grid stride), so no
// block-wide barrier sits in the tile loop and one warp's row loads overlap
// the others' products. Per tile:
//   A. half-warps stream the packed rows of one point each straight from the
//      grids (cell indices fetched a tile ahead, handed round by shuffles)
//      with coalesced 4-byte loads, reduce over the 8 corners and leave the
//      features in the warp's own shared-memory buffer as bf16 rows;
//   B. the three MLPs on the tensor cores (mlp_forward in the header): the
//      feature's A fragments are loaded once per MLP and kept through its five
//      blocks, the hidden state stays in registers, each lane computes the
//      sines of its own A positions; the head [32] -> 1 or 3 is a per-lane dot
//      over the lane's 8 columns and a reduction over the quad by shuffles.
// What is left on the CUDA cores: the 279 sines a point, the corner
// reduction, the fragment epilogues (bias, ReLU, rounding) and the heads.

#include "fused_decode_common.cuh"

// Warps per block and m16 tiles per warp (scripts/tune_fused_decode.py). On an
// H100, 12 warps of one m16 tile: as fast as 16 (which spill at the 128
// registers a thread they leave), faster than 8; two m16 tiles a warp need
// more than 255 registers and spill.
#ifndef FD_WARPS
#define FD_WARPS 12
#endif
#ifndef FD_MTILES
#define FD_MTILES 1
#endif

namespace {

using namespace fd;

constexpr int WARPS = FD_WARPS;
constexpr int MT = FD_MTILES;
constexpr int NP = 16 * MT;  // points per warp tile
constexpr int THREADS = 32 * WARPS;

constexpr size_t SMEM_BYTES = SMEM_PARAMS + WARPS * feat_bytes(MT);

static_assert(WARPS >= 1 && WARPS <= 32 && MT >= 1 && MT <= 4, "block shape");
static_assert(SMEM_BYTES <= SMEM_BLOCK_MAX, "exceeds a block's shared memory");

// raw head of MLP M: [32] -> 1 (occupancy) or 3 (rgb) for the lane's rows g
// and g + 8, summed over the quad; o[mt][row][j]
template <int M>
__device__ __forceinline__ void head(const float* fsm, const float (&h)[MT][4][4], int lane,
                                     float (&o)[MT][2][3]) {
    constexpr int NO = (M == 2) ? 3 : 1;
    const float* ow = fsm + M * F_MLP + F_OUTW;
    const int t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < 3; ++j) o[mt][r][j] = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
            const float4 w = *reinterpret_cast<const float4*>(ow + 4 * (8 * n + 2 * t + x));
            const float wj[3] = {w.x, w.y, w.z};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const float a = bf16_round(h[mt][n][2 * r + x]);
#pragma unroll
                    for (int j = 0; j < NO; ++j) o[mt][r][j] = fmaf(a, wj[j], o[mt][r][j]);
                }
        }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int j = 0; j < NO; ++j)
                    o[mt][r][j] += __shfl_xor_sync(0xffffffffu, o[mt][r][j], off);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_decode_fwd_kernel(const float* __restrict__ p, const float* __restrict__ frac_m,
                        const float* __restrict__ frac_f, const int* __restrict__ idx_m,
                        const int* __restrict__ idx_f, const uint32_t* __restrict__ packed_m,
                        const uint32_t* __restrict__ packed_f, uint32_t cells_m,
                        uint32_t cells_f, const uint4* __restrict__ w_bf16,
                        const uint4* __restrict__ w_f32, float4* __restrict__ out,
                        long long n_points, long long n_tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    const float* fsm = reinterpret_cast<const float*>(smem + SMEM_W);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    uint32_t* feat = reinterpret_cast<uint32_t*>(smem + SMEM_PARAMS + warp * feat_bytes(MT));
    const uint32_t wsm = smem_u32(smem);
    const uint32_t feat_s = smem_u32(feat);

    stage_params<THREADS>(smem, w_bf16, w_f32, threadIdx.x);
    __syncthreads();

    // warp-major over the blocks, so a short launch spreads over the SMs
    const long long stride = (long long)gridDim.x * WARPS;
    long long tile = (long long)warp * gridDim.x + blockIdx.x;
    uint32_t cells[MT];
    load_cells<MT>(cells, idx_m, idx_f, tile * NP, n_points, lane);
    for (; tile < n_tiles; tile += stride) {
        const long long base = tile * NP;
        // the next tile's cell indices, in flight through this tile's work
        uint32_t ahead[MT];
        load_cells<MT>(ahead, idx_m, idx_f, base + stride * NP, n_points, lane);

        // ---- phase A: gather and corner reduction into the feature rows --
        reduce_corners<NP, MT>(feat, frac_m, frac_f, cells, packed_m, packed_f, cells_m,
                               cells_f, base, n_points, lane);
        __syncwarp();

        // ---- phase B: the three MLPs on the tensor cores -----------------
        float q[MT][2][3];
        load_points<MT>(p, base, n_points, lane, q);
        float h[MT][4][4];
        uint32_t unused[MT][5];
        float om[MT][2][3], of[MT][2][3], oc[MT][2][3];
        mlp_forward<0, MT, false>(wsm, fsm, feat_s, q, h, unused, lane);
        head<0>(fsm, h, lane, om);
        mlp_forward<1, MT, false>(wsm, fsm, feat_s, q, h, unused, lane);
        head<1>(fsm, h, lane, of);
        mlp_forward<2, MT, false>(wsm, fsm, feat_s, q, h, unused, lane);
        head<2>(fsm, h, lane, oc);

        const float* ob_m = fsm + 0 * F_MLP + F_OUTB;
        const float* ob_f = fsm + 1 * F_MLP + F_OUTB;
        const float* ob_c = fsm + 2 * F_MLP + F_OUTB;
        const int t = lane & 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            // lane t = 0 writes row g, lane t = 1 row g + 8
            const int r = t & 1;
            const long long n = base + 16 * mt + 8 * r + (lane >> 2);
            if (t < 2 && n < n_points) {
                const float occ_m = om[mt][r][0] + ob_m[0];
                const float occ = (of[mt][r][0] + ob_f[0]) + occ_m;  // fine + middle
                out[n] = make_float4(oc[mt][r][0] + ob_c[0], oc[mt][r][1] + ob_c[1],
                                     oc[mt][r][2] + ob_c[2], occ);
            }
        }
        __syncwarp();  // the next tile's phase A overwrites the features
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) cells[mt] = ahead[mt];
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). No synchronisation, no
// allocation. Returns cudaGetLastError() (0 on success). All pointers must be
// 16-byte aligned; idx_m / idx_f are int32 [n], each point's cell in the
// packed-corner grids packed_m (bf16 [cells_m][256]) and packed_f (bf16
// [cells_f][512]); w_bf16 / w_f32 are the packed parameter buffers in the
// layout of fused_decode_common.cuh.
extern "C" int fused_decode_fwd(const void* p, const void* frac_m, const void* frac_f,
                                const void* idx_m, const void* idx_f, const void* packed_m,
                                const void* packed_f, long long cells_m, long long cells_f,
                                const void* w_bf16, const void* w_f32, void* out,
                                long long n_points, void* stream) {
    if (n_points <= 0) return 0;
    if (cells_m <= 0 || cells_f <= 0 || cells_m > 0x7fffffffLL || cells_f > 0x7fffffffLL)
        return int(cudaErrorInvalidValue);
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return int(err);
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    err = cudaFuncSetAttribute(fused_decode_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    const long long n_tiles = (n_points + NP - 1) / NP;
    const int grid = n_tiles < n_sm ? int(n_tiles) : n_sm;
    fused_decode_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(frac_m),
        static_cast<const float*>(frac_f), static_cast<const int*>(idx_m),
        static_cast<const int*>(idx_f), static_cast<const uint32_t*>(packed_m),
        static_cast<const uint32_t*>(packed_f), uint32_t(cells_m), uint32_t(cells_f),
        static_cast<const uint4*>(w_bf16),
        static_cast<const uint4*>(w_f32), static_cast<float4*>(out), n_points, n_tiles);
    return int(cudaGetLastError());
}

// Sizes of the packed parameter buffers and the block shape, for the
// wrapper's checks and the reports.
extern "C" int fused_decode_w_bf16_elems() { return W_TOTAL; }
extern "C" int fused_decode_w_f32_elems() { return F_TOTAL; }
extern "C" int fused_decode_warps() { return WARPS; }
extern "C" int fused_decode_warp_points() { return NP; }
extern "C" int fused_decode_smem_bytes() { return int(SMEM_BYTES); }
