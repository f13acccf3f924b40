"""Where the card idles, by the program's own spans, in one traced window
of a cell.

    python3 -m portbench.idle --workload <cell> --seed <n> [--seconds 45] [--out F]

Runs the cell's set-up and window as ``portbench.run --trace 1`` does, but
checks no result, then prints one JSON line (and appends it to ``--out``):
the device-traced periods' idle time by the innermost span of the thread
that steps the frames (``program.idle_by_span``: exclusive nanoseconds a
span name, those in no span, the share inside a span below ``slam.step``),
the per-layer metrics and the harness's breakdown. Needs a CUDA card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import run as _run  # noqa: E402,F401  (the environment the harness sets)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, default=45)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import threading

    import torch

    from portbench import cells, harness, program
    from portbench.trace import Trace

    if not torch.cuda.is_available():
        print("portbench.idle: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = cells.workload(cells.load_benchmark(), args.workload)
    run = harness.Run(cell, args.seed, args.seconds, True, T0)
    run.setup()
    run.window()
    events, window_ns = run.traced["device"]
    reading = {"device_trace": Trace.from_events(events, threading.get_native_id()),
               "window_ns": window_ns}
    idle = program.idle_by_span(reading)
    del reading, events
    metrics = run.layer_metrics()
    line = {"workload": args.workload, "seed": args.seed, "card": harness.card(),
            "setup_s": run.setup_s, "idle": idle,
            "metrics": {k: v["value"] for k, v in metrics.items()},
            "breakdown": run.breakdown}
    run.free_program()
    run.cleanup()
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
