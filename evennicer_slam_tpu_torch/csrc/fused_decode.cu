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
// gradient, which is a statement about the backward only
// (fused_decode_bwd.cu). The device functions both kernels run are in
// fused_decode_common.cuh.
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

#include "fused_decode_common.cuh"

// Points per tile = threads per block. 384 was the fastest of 128..448 on an
// H100 (scripts/tune_fused_decode.py); 448 and up leave too few registers a
// thread (spills), 512 does not fit shared memory.
#ifndef FD_TILE
#define FD_TILE 384
#endif

namespace {

using namespace fd;

constexpr int TILE = FD_TILE;  // points per tile == threads per block
constexpr int TP = TILE + 1;   // column stride in words (odd: no bank conflicts)

constexpr size_t SMEM_FEAT = size_t(FEAT_ROWS) * TP * 4;
constexpr size_t SMEM_HS = size_t(HS_ROWS) * TP * 4;
constexpr size_t SMEM_BYTES = SMEM_W + SMEM_F + SMEM_FEAT + SMEM_HS;

static_assert(TILE % 32 == 0 && TILE >= 32 && TILE <= 1024, "tile size");
static_assert(SMEM_BYTES <= SMEM_BLOCK_MAX, "exceeds a block's shared memory");

__global__ void __launch_bounds__(TILE, 1)
fused_decode_fwd_kernel(const float* __restrict__ p, const float* __restrict__ frac_m,
                        const float* __restrict__ frac_f, const uint32_t* __restrict__ rows_m,
                        const uint32_t* __restrict__ rows_f, const uint4* __restrict__ w_bf16,
                        const uint4* __restrict__ w_f32, float4* __restrict__ out,
                        long long n_points, int n_tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    const __nv_bfloat16* wsm = reinterpret_cast<const __nv_bfloat16*>(smem);
    const float* fsm = reinterpret_cast<const float*>(smem + SMEM_W);
    uint32_t* feat = reinterpret_cast<uint32_t*>(smem + SMEM_W + SMEM_F);
    uint32_t* hs = reinterpret_cast<uint32_t*>(smem + SMEM_W + SMEM_F + SMEM_FEAT);

    const int tid = threadIdx.x;

    stage_params<TILE>(smem, w_bf16, w_f32, tid);
    __syncthreads();

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long tile0 = (long long)tile * TILE;

        // ---- phase A: corner reduction, one point per half-warp ----------
        reduce_corners<TILE, TP>(feat, frac_m, frac_f, rows_m, rows_f, tile0, n_points, tid);
        __syncthreads();

        // ---- phase B: the three MLPs, one point per thread ----------------
        const long long n = tile0 + tid;
        if (n < n_points) {
            const float px = p[n * 3 + 0], py = p[n * 3 + 1], pz = p[n * 3 + 2];
            uint32_t* hcol = hs + tid;
            float res[4] = {0.f, 0.f, 0.f, 0.f};  // r, g, b, occupancy

#pragma unroll 1
            for (int m = 0; m < 3; ++m) {
                const MlpView v = mlp_view<TP>(m, wsm, fsm, feat, tid);
                float acc[HID];
                uint32_t unused[5];
                mlp_hidden<TP, false>(v, px, py, pz, hcol, acc, unused);

                // head: [32] -> 4 (columns past the MLP's own are zero padding)
                float o[4] = {0.f, 0.f, 0.f, 0.f};
                {
                    const uint2* wo =
                        reinterpret_cast<const uint2*>(v.W + W_FC + 5 * v.fc_stride);
#pragma unroll
                    for (int k = 0; k < HID; ++k) {
                        const float a = bf16_round(acc[k]);
                        const uint2 w = wo[k];
                        o[0] = fmaf(a, bf_lo(w.x), o[0]);
                        o[1] = fmaf(a, bf_hi(w.x), o[1]);
                        o[2] = fmaf(a, bf_lo(w.y), o[2]);
                        o[3] = fmaf(a, bf_hi(w.y), o[3]);
                    }
                }
                const float* ob = v.F + F_OUTB;
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
