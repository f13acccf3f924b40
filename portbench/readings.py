"""The readings that the check's limits were set from, on the card.

    python3 -m portbench.readings --workload <cell> --seeds 1 2 3 ... [--control]
                                  [--faults unchanged half_batch altered] [--out F]

For each seed, in one process: the cell's set-up (the warm-up and the
checked period, through ``EvenNICERSLAM.step``), then the reference over
the checked calls and the compared numbers of the sound run; with
``--control`` the same numbers with the control (the reference one
precision down) in the program's place; with ``--faults`` the numbers of a
set-up of its own with each fault planted in the program for the checked
period. One JSON line a seed,
to standard output and to ``--out``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _followed(cell, seed, device, overrides, fault=None):
    from portbench import check, harness

    t0 = time.perf_counter()
    run = harness.Run(cell, seed, 0, False, t0, device=device, overrides=overrides)
    run.setup(fault=fault)
    setup_s = time.perf_counter() - t0
    run.free_program()
    ref = check.Reference(run.cfg, run.nice, run.eventnet_path, run.device)
    t1 = time.perf_counter()
    followed = check.follow(run.capture, ref)
    return run, ref, followed, setup_s, time.perf_counter() - t1


def read_seed(cell, seed, control=False, faults=(), device="cuda", overrides=None):
    from portbench import check

    run, ref, followed, setup_s, ref_s = _followed(cell, seed, device, overrides)
    line = {"seed": seed, "setup_s": setup_s, "reference_s": ref_s,
            "sound": check.numbers(run.capture, followed),
            "frames_next": check.next_frame_gap(run.capture.tracks, ref)}
    if control:
        lowered = check.follow_control(run.capture, ref)
        line["control"] = check.control_numbers(run.capture, followed, lowered)
    run.cleanup()
    for f in faults:
        # planted in the program for its checked period, on a set-up of its own
        frun, _, fol, _, _ = _followed(cell, seed, device, overrides, fault=f)
        line[f] = check.numbers(frun.capture, fol)
        frun.cleanup()
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from portbench import cells

    if not torch.cuda.is_available():
        print("portbench.readings: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.workload(cells.load_benchmark(), args.workload)
    for seed in args.seeds:
        line = read_seed(cell, seed, args.control, args.faults)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
