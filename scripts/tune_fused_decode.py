#!/usr/bin/env python3
"""Time variants of the fused decode kernels on one NVIDIA GPU.

    python3 scripts/tune_fused_decode.py [--shapes 8x1 12x1 16x1]
    python3 scripts/tune_fused_decode.py --backward [--shapes 8x1 12x1]

Builds ``evennicer_slam_tpu_torch/csrc/fused_decode.cu`` (or, with
``--backward``, ``fused_decode_bwd.cu``) once per block shape ``WxM``: W warps
a block, M m16 tiles (16 points each) a warp (``-DFD_WARPS=W -DFD_MTILES=M``,
``-DFD_BWD_WARPS`` / ``-DFD_BWD_MTILES`` for the backward; all builds started
together), checks each variant against the plain PyTorch version at
N = 881,280 and times the kernel alone with CUDA events, in two rounds so the
spread shows. Prints registers and spills from ptxas beside each time. A
shape that does not fit a block's shared memory fails its ``static_assert``
and is reported as such.
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
    ap.add_argument("--backward", action="store_true",
                    help="tune the backward kernel (default shapes 8x1 12x1)")
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="block shapes WxM: W warps a block, M m16 tiles a warp")
    ap.add_argument("--iters", type=int, default=10)
    opts = ap.parse_args()
    if opts.shapes is None:
        opts.shapes = ["8x1", "12x1"] if opts.backward else ["8x1", "12x1", "16x1"]
    name = "fused_decode_bwd" if opts.backward else "fused_decode"
    prefix = "FD_BWD_" if opts.backward else "FD_"
    declare = (fused_decode.declare_bwd_signatures if opts.backward
               else fused_decode.declare_signatures)
    dev = torch.device("cuda")
    print(f"device: {cs.nvidia_smi_line()}", flush=True)
    cs.setup_torch(verbose=False)
    flags = {}
    for shape in opts.shapes:
        w, m = shape.split("x")
        flags[shape] = (f"-D{prefix}WARPS={int(w)}", f"-D{prefix}MTILES={int(m)}")
    handles = {t: cuda_build.start_build(name, f) for t, f in flags.items()}
    libs, logs = {}, {}
    for t, h in handles.items():
        try:
            cuda_build.finish_build(h)
        except RuntimeError as e:
            print(f"{t}: does not build: "
                  + next((ln for ln in str(e).splitlines() if "error" in ln), str(e)[:200]),
                  flush=True)
            opts.shapes = [x for x in opts.shapes if x != t]
            continue
        logs[t] = [ln.strip() for ln in str(cuda_build.BUILD_LOG[name]["ptxas"])
                   .splitlines() if "registers" in ln or "spill" in ln]
        libs[t] = declare(cuda_build.load_kernel_library(name, flags[t]))

    _, _, decoders, packed = cs.make_scene(dev)
    bound_t = torch.from_numpy(cs.BOUND).to(dev)
    args = cs.decode_inputs(packed, bound_t, cs.N_MAIN, dev, seed=1)
    w16, f32 = fused_decode.pack_trio_weights(decoders)
    if opts.backward:
        g = torch.randn(cs.N_MAIN, 4, device=dev, generator=torch.Generator(dev).manual_seed(0))
        ref = fused_decode.fused_decode_bwd_plain(decoders, *cs.rows_of(args), g,
                                                  chunk=cs.BWD_PLAIN_CHUNK)
        for rnd in (1, 2):
            for t in (opts.shapes if rnd == 1 else opts.shapes[::-1]):
                run = lambda: fused_decode.launch_fused_decode_bwd(
                    *args, w16, f32, g, lib=libs[t])
                rel = max(float((o - r).norm() / r.norm()) for o, r in zip(run(), ref))
                ms = cs.cuda_ms(run, opts.iters)
                print(f"round {rnd}  {t:>5s}  smem "
                      f"{libs[t].fused_decode_bwd_smem_bytes():6d} B  {ms:7.3f} ms  "
                      f"max rel norm err {rel:.2e}  {' | '.join(logs[t])}", flush=True)
        return
    with torch.no_grad():
        ref = fused_decode.fused_decode_packed_plain(decoders, *cs.rows_of(args))
        for rnd in (1, 2):
            order = opts.shapes if rnd == 1 else opts.shapes[::-1]
            for t in order:
                run = lambda: fused_decode.launch_fused_decode_fwd(*args, w16, f32, lib=libs[t])
                err = float((run() - ref).abs().max())
                ms = cs.cuda_ms(run, opts.iters)
                print(f"round {rnd}  {t:>5s}  smem {libs[t].fused_decode_smem_bytes():6d} B"
                      f"  {ms:7.3f} ms  max abs err {err:.2e}  {' | '.join(logs[t])}", flush=True)


if __name__ == "__main__":
    main()
