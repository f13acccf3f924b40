#!/usr/bin/env python3
"""Time variants of the fused decode kernel on one NVIDIA GPU.

    python3 scripts/tune_fused_decode.py [--tiles 128 192 256 320 384 448]

Builds ``evennicer_slam_tpu_torch/csrc/fused_decode.cu`` once per tile size
(``-DFD_TILE=<n>``: points per tile = threads per block; all builds started
together), checks each variant against the plain PyTorch version at
N = 881,280 and times the kernel alone with CUDA events, in two rounds so the
spread shows. Prints registers and spills from ptxas beside each time.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from evennicer_slam_tpu_torch.ops import cuda_build, fused_decode  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[128, 192, 256, 320, 384, 448])
    ap.add_argument("--iters", type=int, default=10)
    opts = ap.parse_args()
    dev = torch.device("cuda")
    print(f"device: {cs.nvidia_smi_line()}", flush=True)
    cs.setup_torch(verbose=False)
    flags = {t: (f"-DFD_TILE={t}",) for t in opts.tiles}
    handles = {t: cuda_build.start_build("fused_decode", f) for t, f in flags.items()}
    libs, logs = {}, {}
    for t, h in handles.items():
        cuda_build.finish_build(h)
        logs[t] = [ln.strip() for ln in str(cuda_build.BUILD_LOG["fused_decode"]["ptxas"])
                   .splitlines() if "registers" in ln or "spill" in ln]
        libs[t] = fused_decode.declare_signatures(
            cuda_build.load_kernel_library("fused_decode", flags[t]))

    _, _, decoders, packed = cs.make_scene(dev)
    bound_t = torch.from_numpy(cs.BOUND).to(dev)
    args = cs.decode_inputs(packed, bound_t, cs.N_MAIN, dev, seed=1)
    w16, f32 = fused_decode.pack_trio_weights(decoders)
    with torch.no_grad():
        ref = fused_decode.fused_decode_packed_plain(decoders, *args)
        for rnd in (1, 2):
            order = opts.tiles if rnd == 1 else opts.tiles[::-1]
            for t in order:
                run = lambda: fused_decode.launch_fused_decode_fwd(*args, w16, f32, lib=libs[t])
                err = float((run() - ref).abs().max())
                ms = cs.cuda_ms(run, opts.iters)
                print(f"round {rnd}  FD_TILE={t:4d}  smem {libs[t].fused_decode_smem_bytes():6d} B"
                      f"  {ms:7.3f} ms  max abs err {err:.2e}  {' | '.join(logs[t])}", flush=True)


if __name__ == "__main__":
    main()
