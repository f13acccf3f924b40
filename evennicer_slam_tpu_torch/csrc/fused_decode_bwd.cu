// Fused colour-stage NICE decode, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_bwd_kernel` of
// evennicer_slam_tpu/ops/fused_decode.py (launched by `_fused_call_bwd`).
// For every query point it takes the cotangent g[4] of raw = (colour rgb,
// middle + fine occupancy) and returns the cotangents of the point and of the
// two fraction triples: dp[3], dfrac_m[3], dfrac_f[3]. The packed grids and
// the decoder weights are frozen and get nothing. The forward is recomputed per tile by
// the very device function the forward kernel runs (mlp_forward in
// fused_decode_common.cuh); no activation touches device memory.
//
// What it computes is the gradient autograd gives for the plain PyTorch
// version (ops/fused_decode.py::fused_decode_packed_plain):
//   - p gets gradient through the three sine embeddings,
//     darg = demb * cos(arg), dp += B[:, k] * darg;
//   - frac_m gets gradient from the middle MLP's feature only: the copy of
//     the middle feature inside the fine MLP's feature is detached;
//   - frac_f gets gradient from the fine MLP's first 32 feature channels and
//     from the colour MLP's 32;
//   - the bf16 rounding of a product's operands is the identity for the
//     gradient, but autograd casts the cotangent of every rounded activation
//     operand to bf16 on its way back (the backward of a dtype cast is the
//     cast back). So each transposed product dh @ W^T is accumulated in f32
//     and its result rounded to bf16, as there; sums of several such results
//     (the five feature injections, the two uses of the embedding) are f32.
//     The weights in the transposed products are the forward's bf16 values.
//
// What bounds it on an H100: per point 60 B in (point, fractions, cell
// indices, cotangent) and 36 B out, and the rows of its two cells read twice
// from the grids (1,536 B each time, mostly from L2: neighbouring samples
// share cells), against the recomputed forward (50,816 multiply-adds with
// bf16 operands, 279 sines) and 45,696 multiply-adds of the reverse pass (279
// cosines). Every cotangent that enters a transposed product, the head's
// apart, is a bf16 value (rounded as said above), so the tensor cores take
// those products: at N = 881,280 the operations come to 0.26 ms against
// 0.03 ms for the points' own bytes and 0.06 ms for every row of both grids
// of the benchmark's room once, and the floor is the operations. On the CUDA
// cores (f32 FMA, one thread per point) the products alone would take 85 G
// multiply-adds at this size, about 5 ms of instructions: they have to run on
// the tensor cores.
//
// Design: the forward kernel's block and warp shape (one persistent block per
// SM, the weights resident in shared memory, FD_BWD_WARPS warps each walking
// its own tiles of 16 x FD_BWD_MTILES points). Per tile:
//   A. gather and corner reduction into the warp's feature rows (as the
//      forward, the cell indices fetched a tile ahead);
//   B. per MLP: the forward recompute on the tensor cores keeps only the ReLU
//      signs (5 x 16 bits a lane per m16 tile); the head's cotangent is f32 on
//      the CUDA cores and rounded to bf16; then the reverse pass on the
//      tensor cores, every dh @ W^T from the same resident weights through
//      plain ldmatrix, its result rounded to bf16 in registers and packed as
//      the next A operand. The five feature-injection cotangents are each
//      rounded and summed in f32 in accumulator fragments (for the fine MLP
//      only its own first 32 channels: the middle copy is detached). The two
//      embedding cotangents are rounded and added per n8 tile of the 96
//      embedding columns, multiplied by cos(arg) at the lane's own positions
//      (sin_cos again, as the sines of the recompute) and folded into dp, which
//      is reduced over the quad by shuffles at the end. The feature cotangents
//      go to the warp's own buffer (16 points x 96 f32 per m16 tile);
//   C. one point per half-warp: the rows are read a second time from the
//      grids at the same cells (from L2, 1,536 B per point),
//      dw8[k] = sum_c rows[k][c] * dfeat[c] is folded with the derivative of
//      the corner weights per lane, and six values are reduced over the 16
//      lanes by shuffles.

#include "fused_decode_common.cuh"

// Warps per block and m16 tiles per warp (scripts/tune_fused_decode.py
// --backward). 12 warps of one m16 tile fill the block's shared memory (the
// weights and 9,984 B a warp) and beat 8; two m16 tiles a warp spill.
#ifndef FD_BWD_WARPS
#define FD_BWD_WARPS 12
#endif
#ifndef FD_BWD_MTILES
#define FD_BWD_MTILES 1
#endif

namespace {

using namespace fd;

constexpr int WARPS = FD_BWD_WARPS;
constexpr int MT = FD_BWD_MTILES;
constexpr int NP = 16 * MT;
constexpr int THREADS = 32 * WARPS;

// per-warp f32 feature cotangents, one row of 96 (+8 padding) per point
constexpr int DFEAT_STRIDE = 104;
constexpr size_t DFEAT_BYTES = size_t(NP) * DFEAT_STRIDE * 4;
constexpr size_t WARP_BYTES = feat_bytes(MT) + DFEAT_BYTES;
constexpr size_t SMEM_BYTES = SMEM_PARAMS + WARPS * WARP_BYTES;

static_assert(WARPS >= 1 && WARPS <= 32 && MT >= 1 && MT <= 4, "block shape");
static_assert(SMEM_BYTES <= SMEM_BLOCK_MAX, "exceeds a block's shared memory");

// cotangents of the three fractions from the cotangents of the 8 corner
// weights w[dz][dy][dx] = (wz * wy) * wx
__device__ __forceinline__ void corner_weights_bwd(const float* __restrict__ frac,
                                                   const float (&dw)[8], float (&g)[3]) {
    const float fx = frac[0], fy = frac[1], fz = frac[2];
    g[0] = 0.f; g[1] = 0.f; g[2] = 0.f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
        const float wz = dz ? fz : 1.0f - fz;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
            const float wy = dy ? fy : 1.0f - fy;
            const float wzy = wz * wy;
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
                const float wx = dx ? fx : 1.0f - fx;
                const float d = dw[dz * 4 + dy * 2 + dx];
                g[0] += (dx ? d : -d) * wzy;
                g[1] += (dy ? d : -d) * (wz * wx);
                g[2] += (dz ? d : -d) * (wy * wx);
            }
        }
    }
}

// dp += B[:, k] * (bf16(d0 @ lin_w[0]^T) + bf16(d3 @ lin_w[3][:93]^T))[k] *
// cos(p . B[:, k]) at the lane's own positions, one n8 tile of the 96
// embedding columns at a time (MLP weights from row r0)
template <int MT, bool FAR>
__device__ __forceinline__ void embed_backward(uint32_t wsm, const float* B, int r0,
                                               const float (&q)[MT][2][3],
                                               const uint32_t (&d0)[MT][2][4],
                                               const uint32_t (&d3)[MT][2][4],
                                               float (&dp)[MT][2][3], int lane) {
    const int t = lane & 3, mi = lane >> 3, rr = lane & 7;
#pragma unroll 2
    for (int j = 0; j < EMB_PAD / 8; ++j) {
        uint32_t b0[4], b3[4];
        ldsm_x4(wsm + w_off(r0 + R_EMB0 + 8 * j + rr, mi), b0);
        ldsm_x4(wsm + w_off(r0 + R_EMB3 + 8 * j + rr, mi), b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            float c0[4] = {0.f, 0.f, 0.f, 0.f}, c3[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(c0, d0[mt][0], b0[0], b0[1]);
            mma_bf16(c0, d0[mt][1], b0[2], b0[3]);
            mma_bf16(c3, d3[mt][0], b3[0], b3[1]);
            mma_bf16(c3, d3[mt][1], b3[2], b3[3]);
            round2(c0[0], c0[1]);
            round2(c0[2], c0[3]);
            round2(c3[0], c3[1]);
            round2(c3[2], c3[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = 8 * j + 2 * t + (e & 1);
                if (k < EMB) {
                    const int r = e >> 1;
                    const float de = c3[e] + c0[e];
                    const float darg = de * sin_cos<FAR>(embed_arg(q[mt][r], B, k), 1);
                    dp[mt][r][0] = fmaf(B[k], darg, dp[mt][r][0]);
                    dp[mt][r][1] = fmaf(B[EMB_PAD + k], darg, dp[mt][r][1]);
                    dp[mt][r][2] = fmaf(B[2 * EMB_PAD + k], darg, dp[mt][r][2]);
                }
            }
        }
    }
}

// Forward recompute and reverse pass of MLP M for the warp's tiles: adds the
// MLP's share of dp (per lane, before the quad reduction) and leaves its
// feature cotangents in the warp's buffer, columns 32 M .. 32 M + 31.
template <int M>
__device__ __forceinline__ void mlp_backward(uint32_t wsm, const float* fsm, uint32_t feat_s,
                                             float* dfeat, const float (&q)[MT][2][3],
                                             const float4 (&gr)[MT][2], float (&dp)[MT][2][3],
                                             int lane) {
    constexpr int FEAT = (M == 1) ? 64 : 32;
    const int r0 = (M == 0) ? ROW_MIDDLE : (M == 1 ? ROW_FINE : ROW_COLOR);
    const float* F = fsm + M * F_MLP;
    const int g = lane >> 2, t = lane & 3;

    float dh[MT][4][4];
    uint32_t sign[MT][5];
    // the forward up to the last block's pre-activation; only the signs are
    // kept (the head is linear, its input is not needed)
    mlp_forward<M, MT, true>(wsm, fsm, feat_s, q, dh, sign, lane);

    // cotangent of the head's input: occupancy for middle and fine, rgb for
    // colour (its own occupancy is unused), f32, rounded to bf16
    {
        const float* ow = F + F_OUTW;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
                const float4 w = *reinterpret_cast<const float4*>(ow + 4 * (8 * n + 2 * t + x));
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        const float4 go = gr[mt][r];
                        float s;
                        if (M == 2) {
                            s = go.x * w.x;
                            s = fmaf(go.y, w.y, s);
                            s = fmaf(go.z, w.z, s);
                        } else {
                            s = go.w * w.x;
                        }
                        dh[mt][n][2 * r + x] = bf16_round(s);
                    }
            }
    }

    float df[MT][4][4];   // the MLP's own 32 feature cotangents
    uint32_t da[MT][2][4], d3[MT][2][4];
#pragma unroll
    for (int blk = 4; blk >= 0; --blk) {
        // h = relu(pre) + feat @ fc_w + fc_b: the injection's cotangent
        to_a(dh, da);
        {
            float v[MT][4][4];
            mma_wt<MT, 4>(v, da, wsm, r0 + R_FC + blk * FEAT, lane);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    round2(v[mt][n][0], v[mt][n][1]);
                    round2(v[mt][n][2], v[mt][n][3]);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        df[mt][n][e] = (blk == 4) ? v[mt][n][e] : df[mt][n][e] + v[mt][n][e];
                }
        }
        // through the ReLU
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (!((sign[mt][blk] >> (4 * n + e)) & 1u)) dh[mt][n][e] = 0.f;
        to_a(dh, da);  // exact: bf16 values
        if (blk == 3) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int s = 0; s < 2; ++s)
#pragma unroll
                    for (int i = 0; i < 4; ++i) d3[mt][s][i] = da[mt][s][i];
        }
        // pre = h_prev @ lin_w (+ emb @ lin_w[3][:93] at block 3)
        if (blk > 0) {
            mma_wt<MT, 4>(dh, da, wsm, r0 + R_HID + (blk - 1) * HID, lane);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    round2(dh[mt][n][0], dh[mt][n][1]);
                    round2(dh[mt][n][2], dh[mt][n][3]);
                }
        }
    }

    // embedding: da is block 0's pre-activation cotangent, d3 block 3's
    if (near_range<M, MT>(fsm + F_TOTAL, q))
        embed_backward<MT, false>(wsm, F + F_B, r0, q, da, d3, dp, lane);
    else
        embed_backward<MT, true>(wsm, F + F_B, r0, q, da, d3, dp, lane);

    // the feature cotangents to the warp's buffer, rows g and g + 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float* row = dfeat + (16 * mt + 8 * r + g) * DFEAT_STRIDE + 32 * M + 2 * t;
#pragma unroll
            for (int n = 0; n < 4; ++n)
                *reinterpret_cast<float2*>(row + 8 * n) =
                    make_float2(df[mt][n][2 * r], df[mt][n][2 * r + 1]);
        }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_decode_bwd_kernel(const float* __restrict__ p, const float* __restrict__ frac_m,
                        const float* __restrict__ frac_f, const int* __restrict__ idx_m,
                        const int* __restrict__ idx_f, const uint32_t* __restrict__ packed_m,
                        const uint32_t* __restrict__ packed_f, uint32_t cells_m,
                        uint32_t cells_f, const uint4* __restrict__ w_bf16,
                        const uint4* __restrict__ w_f32, const float4* __restrict__ g,
                        float* __restrict__ dp_out, float* __restrict__ dfrac_m,
                        float* __restrict__ dfrac_f, long long n_points, long long n_tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    const float* fsm = reinterpret_cast<const float*>(smem + SMEM_W);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    unsigned char* mine = smem + SMEM_PARAMS + warp * WARP_BYTES;
    uint32_t* feat = reinterpret_cast<uint32_t*>(mine);
    float* dfeat = reinterpret_cast<float*>(mine + feat_bytes(MT));
    const uint32_t wsm = smem_u32(smem);
    const uint32_t feat_s = smem_u32(feat);
    const int hl = lane & 15;  // lane within the half-warp

    stage_params<THREADS>(smem, w_bf16, w_f32, threadIdx.x);
    __syncthreads();

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

        // ---- phase B: forward recompute and reverse pass per MLP ---------
        float q[MT][2][3];
        load_points<MT>(p, base, n_points, lane, q);
        float4 gr[MT][2];
        float dp[MT][2][3];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const long long n = base + 16 * mt + 8 * r + (lane >> 2);
                gr[mt][r] = n < n_points ? g[n] : make_float4(0.f, 0.f, 0.f, 0.f);
                dp[mt][r][0] = dp[mt][r][1] = dp[mt][r][2] = 0.f;
            }
        mlp_backward<0>(wsm, fsm, feat_s, dfeat, q, gr, dp, lane);
        mlp_backward<1>(wsm, fsm, feat_s, dfeat, q, gr, dp, lane);
        mlp_backward<2>(wsm, fsm, feat_s, dfeat, q, gr, dp, lane);
        const int t = lane & 3;
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                    for (int a = 0; a < 3; ++a)
                        dp[mt][r][a] += __shfl_xor_sync(0xffffffffu, dp[mt][r][a], off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int r = t & 1;  // lane t = 0 writes row g, lane t = 1 row g + 8
            const long long n = base + 16 * mt + 8 * r + (lane >> 2);
            if (t < 2 && n < n_points) {
#pragma unroll
                for (int a = 0; a < 3; ++a) dp_out[n * 3 + a] = dp[mt][r][a];
            }
        }
        __syncwarp();  // the feature cotangents are complete

        // ---- phase C: fractions, one point per half-warp -----------------
        // (every lane runs every iteration: the shuffles need the whole warp)
        for (int i = lane >> 4; i < NP; i += 2) {
            const long long nn = base + i;
            const bool valid = nn < n_points;
            const CellRows rows =
                cell_rows<MT>(cells, i, packed_m, packed_f, cells_m, cells_f, lane);
            float gm[3] = {0.f, 0.f, 0.f}, gf[3] = {0.f, 0.f, 0.f};
            if (valid) {
                const float* drow = dfeat + i * DFEAT_STRIDE + 2 * hl;
                const float2 dm = *reinterpret_cast<const float2*>(drow);
                const float2 dfn = *reinterpret_cast<const float2*>(drow + 32);
                const float2 dc = *reinterpret_cast<const float2*>(drow + 64);
                const uint32_t* rm = rows.m;
                const uint32_t* rf = rows.f;
                float dwm[8], dwf[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const uint32_t vm = __ldg(rm + k * 16);
                    const uint32_t vf = __ldg(rf + k * 32);
                    const uint32_t vc = __ldg(rf + k * 32 + 16);
                    dwm[k] = fmaf(bf_hi(vm), dm.y, bf_lo(vm) * dm.x);
                    dwf[k] = fmaf(bf_hi(vc), dc.y,
                                  fmaf(bf_lo(vc), dc.x, fmaf(bf_hi(vf), dfn.y, bf_lo(vf) * dfn.x)));
                }
                corner_weights_bwd(frac_m + nn * 3, dwm, gm);
                corner_weights_bwd(frac_f + nn * 3, dwf, gf);
            }
#pragma unroll
            for (int off = 8; off >= 1; off >>= 1) {
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    gm[a] += __shfl_xor_sync(0xffffffffu, gm[a], off);
                    gf[a] += __shfl_xor_sync(0xffffffffu, gf[a], off);
                }
            }
            if (valid && hl == 0) {
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    dfrac_m[nn * 3 + a] = gm[a];
                    dfrac_f[nn * 3 + a] = gf[a];
                }
            }
        }
        __syncwarp();  // the next tile overwrites features and cotangents
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) cells[mt] = ahead[mt];
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). No synchronisation, no
// allocation. Returns cudaGetLastError() (0 on success). All pointers must be
// 16-byte aligned; idx_m / idx_f and the packed grids as for the forward
// (fused_decode.cu); g is f32 [n][4]; dp, dfrac_m, dfrac_f are f32 [n][3];
// w_bf16 / w_f32 are the packed parameter buffers of the forward
// (fused_decode_common.cuh).
extern "C" int fused_decode_bwd(const void* p, const void* frac_m, const void* frac_f,
                                const void* idx_m, const void* idx_f, const void* packed_m,
                                const void* packed_f, long long cells_m, long long cells_f,
                                const void* w_bf16, const void* w_f32, const void* g, void* dp,
                                void* dfrac_m, void* dfrac_f, long long n_points,
                                void* stream) {
    if (n_points <= 0) return 0;
    if (cells_m <= 0 || cells_f <= 0 || cells_m > 0x7fffffffLL || cells_f > 0x7fffffffLL)
        return int(cudaErrorInvalidValue);
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return int(err);
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    err = cudaFuncSetAttribute(fused_decode_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    const long long n_tiles = (n_points + NP - 1) / NP;
    const int grid = n_tiles < n_sm ? int(n_tiles) : n_sm;
    fused_decode_bwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(frac_m),
        static_cast<const float*>(frac_f), static_cast<const int*>(idx_m),
        static_cast<const int*>(idx_f), static_cast<const uint32_t*>(packed_m),
        static_cast<const uint32_t*>(packed_f), uint32_t(cells_m), uint32_t(cells_f),
        static_cast<const uint4*>(w_bf16),
        static_cast<const uint4*>(w_f32), static_cast<const float4*>(g),
        static_cast<float*>(dp), static_cast<float*>(dfrac_m), static_cast<float*>(dfrac_f),
        n_points, n_tiles);
    return int(cudaGetLastError());
}

// Sizes of the packed parameter buffers and the block shape, for the
// wrapper's checks and the reports.
extern "C" int fused_decode_bwd_w_bf16_elems() { return W_TOTAL; }
extern "C" int fused_decode_bwd_w_f32_elems() { return F_TOTAL; }
extern "C" int fused_decode_bwd_warps() { return WARPS; }
extern "C" int fused_decode_bwd_warp_points() { return NP; }
extern "C" int fused_decode_bwd_smem_bytes() { return int(SMEM_BYTES); }
