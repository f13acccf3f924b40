// Fused colour-stage NICE decode, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_bwd_kernel` of
// evennicer_slam_tpu/ops/fused_decode.py (launched by `_fused_call_bwd`).
// For every query point it takes the cotangent g[4] of raw = (colour rgb,
// middle + fine occupancy) and returns the cotangents of the point and of the
// two fraction triples: dp[3], dfrac_m[3], dfrac_f[3]. Rows and decoder
// weights are frozen and get nothing. The forward is recomputed per point
// (fused_decode_common.cuh, the functions the forward kernel runs); no
// activation touches device memory.
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
// No activation is kept but the ReLU signs: there are no weight gradients, so
// the reverse pass of one MLP needs the 32 cotangents of the hidden state
// (registers), 5 x 32 sign bits (five registers) and cos(arg), which is
// recomputed in the embedding loop. The transposed products need no
// transposed weights: with W stored [in][out], dh_in[k] = dot(W[k][:], dh_out)
// is one 32-wide weight row at one shared-memory address (a broadcast)
// against the thread's registers. The result is indexed by k, so it is parked
// in the thread's own shared-memory column (as bf16 pairs: the values are
// bf16-rounded anyway, and the column is the one the forward parks its hidden
// state in), then read back into registers at static indices. The embedding
// cotangent needs the pre-activation cotangents of block 0 and block 3 at
// once; block 3's stays in 32 more registers until the embedding loop.
//
// Phases per tile of FD_BWD_TILE points:
//   A. corner reduction, one point per half-warp (as the forward);
//   B. one point per thread: per MLP the forward recompute, then the reverse
//      pass; the feature cotangents (96 f32 per point) are left in shared
//      memory, dp is written;
//   C. one point per half-warp again: the rows are read a second time (from
//      L2, 1,536 B per point), dw8[k] = sum_c rows[k][c] * dfeat[c] is folded
//      with the derivative of the corner weights per lane, and six values are
//      reduced over the 16 lanes by shuffles.
//
// What bounds it on an H100: per point 1,588 B in and 36 B out against the
// recomputed forward (50,816 multiply-adds with bf16 operands, 279 sines) and
// 45,696 multiply-adds of the reverse pass (279 cosines). Every cotangent
// that enters a transposed product, the head's apart, is a bf16 value
// (rounded as said above), so the tensor cores could take those products
// too: at N = 881,280 the operations come to 0.26 ms against 0.43 ms for the
// bytes, and the floor is the bytes. (Taken as f32 values the cotangents
// would run at the f32 rate outside the tensor cores: 1.38 ms.) This first
// version does not come near that floor: it runs all products as FMA loops
// on the CUDA cores, one thread per point, and the f32 feature cotangents
// hold the tile to at most 160 points, so an SM runs only four or five
// warps; it is bound by FMA throughput and latency. For later work: the products
// on the tensor cores (wgmma on 64-point tiles, the reverse pass with the
// bf16 cotangents it already has), the feature cotangents out of shared
// memory so the tile can grow, the row gather inside the kernel.

#include "fused_decode_common.cuh"

// Points per tile = threads per block. The per-point columns are 160 words
// (48 features, 16 hidden pairs, 96 feature cotangents); 160 points is the
// most that fits beside the weights. 128 was the fastest of 64..160 on an
// H100 (scripts/tune_fused_decode.py --backward): one warp for each of the
// SM's four schedulers, where 160 gives one scheduler two.
#ifndef FD_BWD_TILE
#define FD_BWD_TILE 128
#endif

namespace {

using namespace fd;

constexpr int TILE = FD_BWD_TILE;
constexpr int TP = TILE + 1;  // column stride in words (odd: no bank conflicts)
constexpr int DFEAT_ROWS = 96;  // f32 cotangents of middle | fine | colour features

constexpr size_t SMEM_FEAT = size_t(FEAT_ROWS) * TP * 4;
constexpr size_t SMEM_HS = size_t(HS_ROWS) * TP * 4;
constexpr size_t SMEM_DFEAT = size_t(DFEAT_ROWS) * TP * 4;
constexpr size_t SMEM_BYTES = SMEM_W + SMEM_F + SMEM_FEAT + SMEM_HS + SMEM_DFEAT;

static_assert(TILE % 32 == 0 && TILE >= 32 && TILE <= 1024, "tile size");
static_assert(SMEM_BYTES <= SMEM_BLOCK_MAX, "exceeds a block's shared memory");

// sum_j row[j] * d[j]: one row of 32 bf16 weights against 32 registers, in
// four independent chains
__device__ __forceinline__ float dot_row(const float (&d)[HID], const uint4* row) {
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint4 v = row[q];
        float t = bf_lo(v.x) * d[8 * q + 0];
        t = fmaf(bf_hi(v.x), d[8 * q + 1], t);
        t = fmaf(bf_lo(v.y), d[8 * q + 2], t);
        t = fmaf(bf_hi(v.y), d[8 * q + 3], t);
        t = fmaf(bf_lo(v.z), d[8 * q + 4], t);
        t = fmaf(bf_hi(v.z), d[8 * q + 5], t);
        t = fmaf(bf_lo(v.w), d[8 * q + 6], t);
        t = fmaf(bf_hi(v.w), d[8 * q + 7], t);
        s[q] = t;
    }
    return (s[0] + s[1]) + (s[2] + s[3]);
}

// d <- bf16(d @ W^T) for W [32][32]: the results go through the thread's
// column as bf16 pairs and come back into the registers
__device__ __forceinline__ void dense_t(float (&d)[HID], const __nv_bfloat16* w, uint32_t* col) {
    const uint4* rows = reinterpret_cast<const uint4*>(w);
#pragma unroll 2
    for (int kk = 0; kk < HS_ROWS; ++kk) {
        const float a = dot_row(d, rows + (2 * kk) * 4);
        const float b = dot_row(d, rows + (2 * kk + 1) * 4);
        col[kk * TP] = pack2(a, b);
    }
#pragma unroll
    for (int jj = 0; jj < HS_ROWS; ++jj) {
        const uint32_t w2 = col[jj * TP];
        d[2 * jj] = bf_lo(w2);
        d[2 * jj + 1] = bf_hi(w2);
    }
}

// dcol[c] (+)= bf16(dot(fc_w[c][:], d)) for the MLP's own 32 feature channels
__device__ __forceinline__ void dfeat_add(const float (&d)[HID], const __nv_bfloat16* wfc,
                                          float* dcol, bool first) {
    const uint4* rows = reinterpret_cast<const uint4*>(wfc);
#pragma unroll 2
    for (int c = 0; c < 32; ++c) {
        const float v = bf16_round(dot_row(d, rows + c * 4));
        dcol[c * TP] = first ? v : dcol[c * TP] + v;
    }
}

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

__global__ void __launch_bounds__(TILE, 1)
fused_decode_bwd_kernel(const float* __restrict__ p, const float* __restrict__ frac_m,
                        const float* __restrict__ frac_f, const uint32_t* __restrict__ rows_m,
                        const uint32_t* __restrict__ rows_f, const uint4* __restrict__ w_bf16,
                        const uint4* __restrict__ w_f32, const float4* __restrict__ g,
                        float* __restrict__ dp, float* __restrict__ dfrac_m,
                        float* __restrict__ dfrac_f, long long n_points, int n_tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    const __nv_bfloat16* wsm = reinterpret_cast<const __nv_bfloat16*>(smem);
    const float* fsm = reinterpret_cast<const float*>(smem + SMEM_W);
    uint32_t* feat = reinterpret_cast<uint32_t*>(smem + SMEM_W + SMEM_F);
    uint32_t* hs = reinterpret_cast<uint32_t*>(smem + SMEM_W + SMEM_F + SMEM_FEAT);
    float* dfeat = reinterpret_cast<float*>(smem + SMEM_W + SMEM_F + SMEM_FEAT + SMEM_HS);

    const int tid = threadIdx.x;
    const int hl = tid & 15;   // lane within the half-warp
    const int grp = tid >> 4;  // half-warp index
    constexpr int NGRP = TILE / 16;

    stage_params<TILE>(smem, w_bf16, w_f32, tid);
    __syncthreads();

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long tile0 = (long long)tile * TILE;

        // ---- phase A: corner reduction, one point per half-warp ----------
        reduce_corners<TILE, TP>(feat, frac_m, frac_f, rows_m, rows_f, tile0, n_points, tid);
        __syncthreads();

        // ---- phase B: forward recompute and reverse pass, one point per thread
        const long long n = tile0 + tid;
        if (n < n_points) {
            const float px = p[n * 3 + 0], py = p[n * 3 + 1], pz = p[n * 3 + 2];
            const float4 gn = g[n];
            uint32_t* hcol = hs + tid;
            float dpx = 0.f, dpy = 0.f, dpz = 0.f;

#pragma unroll 1
            for (int m = 0; m < 3; ++m) {
                const MlpView v = mlp_view<TP>(m, wsm, fsm, feat, tid);
                uint32_t sign[5] = {0u, 0u, 0u, 0u, 0u};
                float dh[HID];
                // the forward up to the last block's output; only the signs
                // are kept (the head is linear, its input is not needed)
                mlp_hidden<TP, true>(v, px, py, pz, hcol, dh, sign);

                // cotangent of this MLP's head outputs: occupancy for middle
                // and fine, rgb for colour (its own occupancy is unused)
                const float go0 = (m == 2) ? gn.x : gn.w;
                const float go1 = (m == 2) ? gn.y : 0.f;
                const float go2 = (m == 2) ? gn.z : 0.f;
                {
                    const uint2* wo =
                        reinterpret_cast<const uint2*>(v.W + W_FC + 5 * v.fc_stride);
#pragma unroll
                    for (int k = 0; k < HID; ++k) {
                        const uint2 w = wo[k];
                        float s = go0 * bf_lo(w.x);
                        s = fmaf(go1, bf_hi(w.x), s);
                        s = fmaf(go2, bf_lo(w.y), s);
                        dh[k] = bf16_round(s);
                    }
                }

                float d3[HID];  // cotangent of block 3's pre-activation
#pragma unroll
                for (int j = 0; j < HID; ++j) d3[j] = 0.f;
                float* dcol = dfeat + (m * 32) * TP + tid;

#pragma unroll 1
                for (int blk = 4; blk >= 0; --blk) {
                    // h = relu(pre) + feat @ fc_w + fc_b
                    dfeat_add(dh, v.W + W_FC + blk * v.fc_stride, dcol, blk == 4);
                    uint32_t s = 0u;
#pragma unroll
                    for (int b = 0; b < 5; ++b) s = (b == blk) ? sign[b] : s;
#pragma unroll
                    for (int j = 0; j < HID; ++j) dh[j] = ((s >> j) & 1u) ? dh[j] : 0.f;
                    if (blk == 3) {
#pragma unroll
                        for (int j = 0; j < HID; ++j) d3[j] = dh[j];
                    }
                    // pre = h_prev @ lin_w (+ emb @ lin_w[3][:93] at block 3)
                    if (blk > 0) dense_t(dh, v.W + W_HID + (blk - 1) * HID * HID, hcol);
                }

                // embedding: dh is block 0's pre-activation cotangent
                {
                    const uint4* w0 = reinterpret_cast<const uint4*>(v.W + W_EMB0);
                    const uint4* w3 = reinterpret_cast<const uint4*>(v.W + W_EMB3);
                    const float* B = v.F + F_B;
#pragma unroll 3
                    for (int k = 0; k < EMB; ++k) {
                        const float c = cosf(embed_arg(px, py, pz, B, k));
                        const float de = bf16_round(dot_row(d3, w3 + k * 4)) +
                                         bf16_round(dot_row(dh, w0 + k * 4));
                        const float darg = de * c;
                        dpx = fmaf(B[k], darg, dpx);
                        dpy = fmaf(B[EMB + k], darg, dpy);
                        dpz = fmaf(B[2 * EMB + k], darg, dpz);
                    }
                }
            }
            dp[n * 3 + 0] = dpx;
            dp[n * 3 + 1] = dpy;
            dp[n * 3 + 2] = dpz;
        }
        __syncthreads();  // the feature cotangents are complete

        // ---- phase C: fractions, one point per half-warp -----------------
        // (every lane runs every iteration: the shuffles need the whole warp)
        for (int i = grp; i < TILE; i += NGRP) {
            const long long nn = tile0 + i;
            const bool valid = nn < n_points;
            float gm[3] = {0.f, 0.f, 0.f}, gf[3] = {0.f, 0.f, 0.f};
            if (valid) {
                const float dm0 = dfeat[(2 * hl) * TP + i], dm1 = dfeat[(2 * hl + 1) * TP + i];
                const float df0 = dfeat[(32 + 2 * hl) * TP + i];
                const float df1 = dfeat[(33 + 2 * hl) * TP + i];
                const float dc0 = dfeat[(64 + 2 * hl) * TP + i];
                const float dc1 = dfeat[(65 + 2 * hl) * TP + i];
                const uint32_t* rm = rows_m + nn * 128 + hl;
                const uint32_t* rf = rows_f + nn * 256 + hl;
                float dwm[8], dwf[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const uint32_t vm = __ldg(rm + k * 16);
                    const uint32_t vf = __ldg(rf + k * 32);
                    const uint32_t vc = __ldg(rf + k * 32 + 16);
                    dwm[k] = fmaf(bf_hi(vm), dm1, bf_lo(vm) * dm0);
                    dwf[k] = fmaf(bf_hi(vc), dc1,
                                  fmaf(bf_lo(vc), dc0, fmaf(bf_hi(vf), df1, bf_lo(vf) * df0)));
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
        __syncthreads();  // the next tile overwrites features and cotangents
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). No synchronisation, no
// allocation. Returns cudaGetLastError() (0 on success). All pointers must be
// 16-byte aligned; rows are bf16 [n][256] and [n][512]; g is f32 [n][4];
// dp, dfrac_m, dfrac_f are f32 [n][3]; w_bf16 / w_f32 are the packed
// parameter buffers of the forward (fused_decode_common.cuh).
extern "C" int fused_decode_bwd(const void* p, const void* frac_m, const void* frac_f,
                                const void* rows_m, const void* rows_f, const void* w_bf16,
                                const void* w_f32, const void* g, void* dp, void* dfrac_m,
                                void* dfrac_f, long long n_points, void* stream) {
    if (n_points <= 0) return 0;
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return int(err);
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    err = cudaFuncSetAttribute(fused_decode_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    const long long tiles = (n_points + TILE - 1) / TILE;
    if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    const int n_tiles = int(tiles);
    const int grid = n_tiles < n_sm ? n_tiles : n_sm;
    fused_decode_bwd_kernel<<<grid, TILE, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(frac_m),
        static_cast<const float*>(frac_f), static_cast<const uint32_t*>(rows_m),
        static_cast<const uint32_t*>(rows_f), static_cast<const uint4*>(w_bf16),
        static_cast<const uint4*>(w_f32), static_cast<const float4*>(g),
        static_cast<float*>(dp), static_cast<float*>(dfrac_m), static_cast<float*>(dfrac_f),
        n_points, n_tiles);
    return int(cudaGetLastError());
}

// Sizes of the packed parameter buffers and the tile, for the wrapper's checks.
extern "C" int fused_decode_bwd_w_bf16_elems() { return W_TOTAL; }
extern "C" int fused_decode_bwd_w_f32_elems() { return F_TOTAL; }
extern "C" int fused_decode_bwd_tile() { return TILE; }
extern "C" int fused_decode_bwd_smem_bytes() { return int(SMEM_BYTES); }
