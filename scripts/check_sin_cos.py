#!/usr/bin/env python3
"""Check on one NVIDIA GPU that the decode kernels' inline sine and cosine
(``sin_cos`` in ``evennicer_slam_tpu_torch/csrc/fused_decode_common.cuh``) give
the CUDA math library's ``sinf`` / ``cosf`` bit for bit.

    python3 scripts/check_sin_cos.py

Builds a small test kernel against the header with the same nvcc flags as the
kernels, evaluates both over every float32 bit pattern (2^32 values, NaNs
compared as NaNs) and over a fine grid of [-2e5, 2e5], which crosses the far
range, and prints the number of differing results. Exits 1 on any difference.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from evennicer_slam_tpu_torch.ops import cuda_build  # noqa: E402

SOURCE = r'''
#include <stdint.h>
#include "fused_decode_common.cuh"
// mode 0: x = lo + (hi - lo) * i / n; mode 1: x = the float with bits i
__global__ void k(unsigned long long n, int mode, float lo, float hi,
                  unsigned long long* bad) {
    for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
         i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
        const float x = mode ? __uint_as_float((uint32_t)i)
                             : lo + (hi - lo) * (float)((double)i / (double)n);
        const float ref[2] = {sinf(x), cosf(x)};
        for (int c = 0; c < 2; ++c) {
            const float got = fd::sin_cos<true>(x, c);
            if (__float_as_uint(got) != __float_as_uint(ref[c]) && !(isnan(got) && isnan(ref[c])))
                atomicAdd(&bad[c], 1ull);
        }
    }
}
extern "C" int run(unsigned long long n, int mode, float lo, float hi, void* bad) {
    k<<<1320, 256>>>(n, mode, lo, hi, (unsigned long long*)bad);
    return int(cudaDeviceSynchronize());
}
'''


def main():
    if not torch.cuda.is_available():
        sys.exit("check_sin_cos: needs a CUDA device")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "check_sin_cos.cu")
    lib_path = os.path.join(cuda_build.BUILD_DIR, "libcheck_sin_cos.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR,
                    "-o", lib_path, src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                        ctypes.c_void_p]
    lib.run.restype = ctypes.c_int
    failed = False
    for n, mode, lo, hi, what in ((1 << 32, 1, 0.0, 0.0, "every float32 bit pattern"),
                                  (1 << 28, 0, -2e5, 2e5, "2^28 points of [-2e5, 2e5]")):
        bad = torch.zeros(2, dtype=torch.int64, device="cuda")
        err = lib.run(n, mode, lo, hi, bad.data_ptr())
        if err:
            sys.exit(f"check_sin_cos: CUDA error {err}")
        n_sin, n_cos = (int(v) for v in bad.tolist())
        print(f"{what}: sin_cos differs from sinf at {n_sin}, from cosf at {n_cos} of {n} values",
              flush=True)
        failed |= bool(n_sin or n_cos)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
