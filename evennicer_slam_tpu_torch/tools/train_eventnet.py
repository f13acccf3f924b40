"""Train EventNet on synthetic ESIM-style data and save ``.npz`` weights
(counterpart of ``evennicer_slam_tpu/tools/train_eventnet.py``).

The file is the JAX package's layout: either package loads it. Runs on the
CUDA device unless ``--device cpu`` is given.

Usage:
    python -m evennicer_slam_tpu_torch.tools.train_eventnet \
        --out build/eventnet_synth.npz [--steps 400] [--batch 4] \
        [--height 64 --width 96] [--device cuda|cpu]
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join("build", "eventnet_synth.npz"))
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--height", type=int, default=64)
    parser.add_argument("--width", type=int, default=96)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    from evennicer_slam_tpu_torch.models.eventnet_train import (
        save_eventnet_npz,
        train_eventnet,
    )
    from evennicer_slam_tpu_torch.utils.runtime import resolve_device, setup_torch

    device = resolve_device(None if args.device == "cuda" else args.device)
    if device.type == "cuda":
        setup_torch(verbose=False)
    params = train_eventnet(
        steps=args.steps, batch=args.batch, hw=(args.height, args.width),
        lr=args.lr, seed=args.seed, verbose=True, device=device,
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_eventnet_npz(params, args.out)
    print("saved", args.out)


if __name__ == "__main__":
    main()
