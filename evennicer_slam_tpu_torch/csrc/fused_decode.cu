// Fused colour-stage NICE decode, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_fwd_kernel` of
// evennicer_slam_tpu/ops/fused_decode.py (launched by `_fused_fwd_impl`).
// For every query point it computes, without any activation touching device
// memory:
//   1. the 8 trilinear corner weights from the two fraction triples,
//   2. the corner reduction of the gathered packed rows (bf16) to the
//      features middle[32] | fine[32] | colour[32], in f32,
//   3. for each of the three MLPs (middle, fine, colour) the f32 Fourier
//      embedding sin(p . B) (93 wide) and five width-32 blocks with per-block
//      feature injection and the skip [emb | h] into block 3,
//   4. raw = (colour rgb, middle_occ + fine_occ).
// The fine MLP's feature is [fine | middle]; the middle copy carries no
// gradient in the reference, which is a statement about the backward only.
//
// Numerics (the contract the plain PyTorch version states too): both
// operands of every MLP product are rounded to bf16 (round to nearest even),
// products are accumulated in f32; the embedding product, the sine and the
// corner reduction are f32. The sine sees arguments of O(+-100), so this
// file must not be compiled with -use_fast_math and does not use __sinf.
// The corner reduction and the embedding argument use explicit
// round-to-nearest multiplies and adds (no FMA contraction) in the order of
// the plain version, so both produce bit-identical features and sine
// arguments; the only remaining difference is the order of the f32 sums
// inside the MLP products.
//
// What bounds it on an H100: each point reads 1,536 B of gathered rows and
// 36 B of point/fractions and writes 16 B, against about 0.1 MFLOP of
// non-zero MLP work. At 3.35 TB/s and the bf16 tensor-core peak the memory
// time is about four times the arithmetic time, so the floor is the row
// traffic. This first version does not reach that floor: it runs the
// products as plain FMA loops on the CUDA cores (f32 peak 67 TFLOP/s), one
// thread per point, and is bound by those.
//
// Design. The TPU kernel stacked the three MLPs block-diagonally to fill a
// 128x128 matrix unit; stored densely that is three times the weights, two
// thirds of them zeros, and does not fit a block's shared memory. Here the
// three MLPs keep their own weights (51,008 bf16 values, 102 KB) and are
// staged once per block into shared memory, together with the f32 biases and
// embedding matrices (7 KB). A block walks over tiles of FD_TILE points
// (grid-stride, one block per SM), each in two phases:
//   A. half-warps stream the packed rows of one point each with coalesced
//      4-byte loads (16 lanes x 2 channels per corner), reduce over the 8
//      corners in registers and leave the features in shared memory as
//      packed bf16 pairs, one column per point;
//   B. each thread takes one point through the three MLPs. The 32 hidden
//      units live in registers as f32 accumulators; every weight row is read
//      from shared memory at one address by the whole warp (a broadcast, four
//      16-byte loads per 32 weights). The embedding feeds block 0 and the
//      skip half of block 3 at once, so each sine is computed once and never
//      stored. Between blocks the bf16-rounded hidden state is parked in the
//      thread's own shared-memory column so the product loops need no
//      register indexing and stay small in code.
//
// For later work, in order of expected gain: run the products on the tensor
// cores (wgmma, 64-point tiles against the resident weights); do the row
// gather inside the kernel from the packed grids (removes the 1.5 KB per
// point of gathered rows from device memory altogether); TMA loads for the
// rows with a producer warp so phase A overlaps phase B; two points per
// thread to halve the weight unpacking.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Points per tile = threads per block. 384 was the fastest of 128..448 on an
// H100 (scripts/tune_fused_decode.py); 448 and up leave too few registers a
// thread (spills), 512 does not fit shared memory.
#ifndef FD_TILE
#define FD_TILE 384
#endif

namespace {

constexpr int TILE = FD_TILE;  // points per tile == threads per block
constexpr int TP = TILE + 1;   // column stride in words (odd: no bank conflicts)
constexpr int EMB = 93;
constexpr int HID = 32;

// bf16 weight layout of one MLP, in elements (every offset a multiple of 8,
// so every weight row starts on a 16-byte boundary)
constexpr int W_EMB0 = 0;               // lin_w[0]        [93][32]
constexpr int W_EMB3 = EMB * HID;       // lin_w[3][:93]   [93][32]
constexpr int W_HID = 2 * EMB * HID;    // lin_w[1], lin_w[2], lin_w[3][93:], lin_w[4]
constexpr int W_FC = W_HID + 4 * HID * HID;  // fc_w[0..4]  [F][32] each
constexpr int W_OUT_ROWS = HID * 4;     // out_w padded to [32][4]
constexpr int mlp_w_size(int feat) { return W_FC + 5 * feat * HID + W_OUT_ROWS; }
constexpr int W_OFF_MIDDLE = 0;
constexpr int W_OFF_FINE = mlp_w_size(32);
constexpr int W_OFF_COLOR = W_OFF_FINE + mlp_w_size(64);
constexpr int W_TOTAL = W_OFF_COLOR + mlp_w_size(32);  // 51,008

// f32 parameter layout of one MLP, in floats
constexpr int F_B = 0;        // B [3][93], padded to 280
constexpr int F_LINB = 280;   // lin_b [5][32]
constexpr int F_FCB = 440;    // fc_b  [5][32]
constexpr int F_OUTB = 600;   // out_b padded to 4
constexpr int F_MLP = 604;
constexpr int F_TOTAL = 3 * F_MLP;  // 1,812

constexpr int FEAT_ROWS = 48;  // 96 feature channels as bf16 pairs
constexpr int HS_ROWS = 16;    // 32 hidden units as bf16 pairs

constexpr size_t SMEM_W = size_t(W_TOTAL) * 2;
constexpr size_t SMEM_F = size_t(F_TOTAL) * 4;
constexpr size_t SMEM_FEAT = size_t(FEAT_ROWS) * TP * 4;
constexpr size_t SMEM_HS = size_t(HS_ROWS) * TP * 4;
constexpr size_t SMEM_BYTES = SMEM_W + SMEM_F + SMEM_FEAT + SMEM_HS;

static_assert(SMEM_W % 16 == 0 && SMEM_F % 16 == 0, "uint4 staging");
static_assert(TILE % 32 == 0 && TILE >= 32 && TILE <= 1024, "tile size");
static_assert(SMEM_BYTES <= 232448, "exceeds a block's shared memory");

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
           (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

// acc[0..32) += a * row, row = 32 bf16 weights at one shared-memory address
__device__ __forceinline__ void fma_row(float (&acc)[HID], float a, const uint4* row) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint4 v = row[q];
        acc[8 * q + 0] = fmaf(a, bf_lo(v.x), acc[8 * q + 0]);
        acc[8 * q + 1] = fmaf(a, bf_hi(v.x), acc[8 * q + 1]);
        acc[8 * q + 2] = fmaf(a, bf_lo(v.y), acc[8 * q + 2]);
        acc[8 * q + 3] = fmaf(a, bf_hi(v.y), acc[8 * q + 3]);
        acc[8 * q + 4] = fmaf(a, bf_lo(v.z), acc[8 * q + 4]);
        acc[8 * q + 5] = fmaf(a, bf_hi(v.z), acc[8 * q + 5]);
        acc[8 * q + 6] = fmaf(a, bf_lo(v.w), acc[8 * q + 6]);
        acc[8 * q + 7] = fmaf(a, bf_hi(v.w), acc[8 * q + 7]);
    }
}

// acc += act @ W for 2*npairs activations kept as bf16 pairs in this thread's
// shared-memory column (stride TP words); W is [2*npairs][32] bf16
__device__ __forceinline__ void dense(float (&acc)[HID], const uint32_t* col, int npairs,
                                      const __nv_bfloat16* w) {
    const uint4* rows = reinterpret_cast<const uint4*>(w);
#pragma unroll 2
    for (int kk = 0; kk < npairs; ++kk) {
        const uint32_t a = col[kk * TP];
        fma_row(acc, bf_lo(a), rows + (2 * kk) * 4);
        fma_row(acc, bf_hi(a), rows + (2 * kk + 1) * 4);
    }
}

// the 8 trilinear corner weights, corner order (dz, dy, dx) lexicographic
__device__ __forceinline__ void corner_weights(const float* __restrict__ frac, float (&w)[8]) {
    const float fx = frac[0], fy = frac[1], fz = frac[2];
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
        const float wz = dz ? fz : __fsub_rn(1.0f, fz);
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
            const float wzy = __fmul_rn(wz, dy ? fy : __fsub_rn(1.0f, fy));
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
                w[dz * 4 + dy * 2 + dx] = __fmul_rn(wzy, dx ? fx : __fsub_rn(1.0f, fx));
            }
        }
    }
}

__global__ void __launch_bounds__(TILE, 1)
fused_decode_fwd_kernel(const float* __restrict__ p, const float* __restrict__ frac_m,
                        const float* __restrict__ frac_f, const uint32_t* __restrict__ rows_m,
                        const uint32_t* __restrict__ rows_f, const uint4* __restrict__ w_bf16,
                        const uint4* __restrict__ w_f32, float4* __restrict__ out,
                        long long n_points, int n_tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);
    float* fsm = reinterpret_cast<float*>(smem + SMEM_W);
    uint32_t* feat = reinterpret_cast<uint32_t*>(smem + SMEM_W + SMEM_F);
    uint32_t* hs = reinterpret_cast<uint32_t*>(smem + SMEM_W + SMEM_F + SMEM_FEAT);

    const int tid = threadIdx.x;

    // stage the trio's parameters once per block
    {
        uint4* dst = reinterpret_cast<uint4*>(smem);
        constexpr int NW = int(SMEM_W / 16);
        constexpr int NF = int(SMEM_F / 16);
        for (int i = tid; i < NW; i += TILE) dst[i] = w_bf16[i];
        for (int i = tid; i < NF; i += TILE) dst[NW + i] = w_f32[i];
    }
    __syncthreads();

    const int hl = tid & 15;         // lane within the half-warp
    const int grp = tid >> 4;        // half-warp index
    constexpr int NGRP = TILE / 16;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long tile0 = (long long)tile * TILE;

        // ---- phase A: corner reduction, one point per half-warp ----------
        for (int i = grp; i < TILE; i += NGRP) {
            const long long n = tile0 + i;
            if (n >= n_points) break;
            float wm[8], wf[8];
            corner_weights(frac_m + n * 3, wm);
            corner_weights(frac_f + n * 3, wf);
            const uint32_t* rm = rows_m + n * 128 + hl;   // [8][32] bf16 = [8][16] words
            const uint32_t* rf = rows_f + n * 256 + hl;   // [8][64] bf16 = [8][32] words
            uint32_t vm[8], vf[8], vc[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                vm[k] = __ldg(rm + k * 16);
                vf[k] = __ldg(rf + k * 32);
                vc[k] = __ldg(rf + k * 32 + 16);
            }
            float m0 = 0.f, m1 = 0.f, f0 = 0.f, f1 = 0.f, c0 = 0.f, c1 = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                m0 = __fadd_rn(m0, __fmul_rn(bf_lo(vm[k]), wm[k]));
                m1 = __fadd_rn(m1, __fmul_rn(bf_hi(vm[k]), wm[k]));
                f0 = __fadd_rn(f0, __fmul_rn(bf_lo(vf[k]), wf[k]));
                f1 = __fadd_rn(f1, __fmul_rn(bf_hi(vf[k]), wf[k]));
                c0 = __fadd_rn(c0, __fmul_rn(bf_lo(vc[k]), wf[k]));
                c1 = __fadd_rn(c1, __fmul_rn(bf_hi(vc[k]), wf[k]));
            }
            feat[(hl)*TP + i] = pack2(m0, m1);        // middle channels 2hl, 2hl+1
            feat[(16 + hl) * TP + i] = pack2(f0, f1);  // fine
            feat[(32 + hl) * TP + i] = pack2(c0, c1);  // colour
        }
        __syncthreads();

        // ---- phase B: the three MLPs, one point per thread ----------------
        const long long n = tile0 + tid;
        if (n < n_points) {
            const float px = p[n * 3 + 0], py = p[n * 3 + 1], pz = p[n * 3 + 2];
            uint32_t* hcol = hs + tid;
            float res[4] = {0.f, 0.f, 0.f, 0.f};  // r, g, b, occupancy

#pragma unroll 1
            for (int m = 0; m < 3; ++m) {
                // m: 0 middle (feature middle), 1 fine ([fine | middle]), 2 colour
                const __nv_bfloat16* W =
                    wsm + (m == 0 ? W_OFF_MIDDLE : (m == 1 ? W_OFF_FINE : W_OFF_COLOR));
                const float* F = fsm + m * F_MLP;
                const uint32_t* feat_a = feat + (m * 16) * TP + tid;
                const uint32_t* feat_b = feat + tid;  // middle, second half of the fine feature
                const int pairs_b = (m == 1) ? 16 : 0;
                const int fc_stride = (m == 1) ? 64 * HID : 32 * HID;

                float acc[HID], acc3[HID];
#pragma unroll
                for (int j = 0; j < HID; ++j) { acc[j] = 0.f; acc3[j] = 0.f; }

                // Fourier embedding, consumed at once by block 0 and by the
                // skip half of block 3
                {
                    const uint4* w0 = reinterpret_cast<const uint4*>(W + W_EMB0);
                    const uint4* w3 = reinterpret_cast<const uint4*>(W + W_EMB3);
                    const float* B = F + F_B;
#pragma unroll 3
                    for (int k = 0; k < EMB; ++k) {
                        const float arg = __fadd_rn(
                            __fadd_rn(__fmul_rn(px, B[k]), __fmul_rn(py, B[EMB + k])),
                            __fmul_rn(pz, B[2 * EMB + k]));
                        const float e = bf16_round(sinf(arg));
                        fma_row(acc, e, w0 + k * 4);
                        fma_row(acc3, e, w3 + k * 4);
                    }
                }

#pragma unroll 1
                for (int blk = 0; blk < 5; ++blk) {
                    if (blk > 0) {
#pragma unroll
                        for (int j = 0; j < HID; ++j) acc[j] = (blk == 3) ? acc3[j] : 0.f;
                        dense(acc, hcol, HS_ROWS, W + W_HID + (blk - 1) * HID * HID);
                    }
                    const float* lb = F + F_LINB + blk * HID;
#pragma unroll
                    for (int j = 0; j < HID; ++j) acc[j] = fmaxf(acc[j] + lb[j], 0.f);

                    // feature injection: h = h + feat @ fc_w + fc_b
                    float inj[HID];
#pragma unroll
                    for (int j = 0; j < HID; ++j) inj[j] = 0.f;
                    const __nv_bfloat16* wfc = W + W_FC + blk * fc_stride;
                    dense(inj, feat_a, 16, wfc);
                    dense(inj, feat_b, pairs_b, wfc + 32 * HID);
                    const float* fb = F + F_FCB + blk * HID;
#pragma unroll
                    for (int j = 0; j < HID; ++j) acc[j] = (acc[j] + inj[j]) + fb[j];

                    if (blk < 4) {
#pragma unroll
                        for (int jj = 0; jj < HS_ROWS; ++jj)
                            hcol[jj * TP] = pack2(acc[2 * jj], acc[2 * jj + 1]);
                    }
                }

                // head: [32] -> 4 (columns past the MLP's own are zero padding)
                float o[4] = {0.f, 0.f, 0.f, 0.f};
                {
                    const uint2* wo = reinterpret_cast<const uint2*>(W + W_FC + 5 * fc_stride);
#pragma unroll
                    for (int k = 0; k < HID; ++k) {
                        const float a = bf16_round(acc[k]);
                        const uint2 v = wo[k];
                        o[0] = fmaf(a, bf_lo(v.x), o[0]);
                        o[1] = fmaf(a, bf_hi(v.x), o[1]);
                        o[2] = fmaf(a, bf_lo(v.y), o[2]);
                        o[3] = fmaf(a, bf_hi(v.y), o[3]);
                    }
                }
                const float* ob = F + F_OUTB;
                if (m == 0) {
                    res[3] = o[0] + ob[0];
                } else if (m == 1) {
                    res[3] = (o[0] + ob[0]) + res[3];  // fine_occ + middle_occ
                } else {
                    res[0] = o[0] + ob[0];
                    res[1] = o[1] + ob[1];
                    res[2] = o[2] + ob[2];
                }
            }
            out[n] = make_float4(res[0], res[1], res[2], res[3]);
        }
        __syncthreads();  // the next tile's phase A overwrites the features
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). No synchronisation, no
// allocation. Returns cudaGetLastError() (0 on success). All pointers must be
// 16-byte aligned; rows are bf16 [n][256] and [n][512]; w_bf16 / w_f32 are
// the packed parameter buffers in the layout above.
extern "C" int fused_decode_fwd(const void* p, const void* frac_m, const void* frac_f,
                                const void* rows_m, const void* rows_f, const void* w_bf16,
                                const void* w_f32, void* out, long long n_points, void* stream) {
    if (n_points <= 0) return 0;
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return int(err);
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    err = cudaFuncSetAttribute(fused_decode_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    const long long tiles = (n_points + TILE - 1) / TILE;
    if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    const int n_tiles = int(tiles);
    const int grid = n_tiles < n_sm ? n_tiles : n_sm;
    fused_decode_fwd_kernel<<<grid, TILE, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(frac_m),
        static_cast<const float*>(frac_f), static_cast<const uint32_t*>(rows_m),
        static_cast<const uint32_t*>(rows_f), static_cast<const uint4*>(w_bf16),
        static_cast<const uint4*>(w_f32), static_cast<float4*>(out), n_points, n_tiles);
    return int(cudaGetLastError());
}

// Sizes of the packed parameter buffers and the tile, for the wrapper's checks.
extern "C" int fused_decode_w_bf16_elems() { return W_TOTAL; }
extern "C" int fused_decode_w_f32_elems() { return F_TOTAL; }
extern "C" int fused_decode_tile() { return TILE; }
extern "C" int fused_decode_smem_bytes() { return int(SMEM_BYTES); }
