"""The port's command line (counterpart of the repository's ``run.py``).

    python -m evennicer_slam_tpu_torch.run configs/Replica/room0.yaml \
        [--input_folder F] [--event_folder E] [--output O] [--resume] \
        [--end_frame N] [--device cuda|cpu] [--nice | --imap] [--viz_port P]
        [--spans FILE]

Runs ``EvenNICERSLAM.run`` over the sequence: checkpoints every
``mapping.ckpt_freq`` frames, a mesh every ``mapping.mesh_freq`` frames,
then ``mesh/final_mesh.ply`` (and ``mesh/final_mesh_eval_rec.ply`` with
``meshing.eval_rec``). ``--resume`` restarts from the latest checkpoint in
the output directory. The run is on the CUDA device unless ``--device cpu``
asks for the CPU. ``--imap`` runs iMAP, its configuration over
``configs/imap.yaml`` (``--nice``, the default, over ``configs/nice_slam.yaml``).

``enable_vis: true`` (the shipped default) writes the visualiser's panels
under the output directory. ``--viz_port P`` serves the browser viewer
(``tools/viz_server.py``) on port P (0: any free port) while the run goes
on, watching the output directory.

``--spans FILE`` turns the program's tracer on (``utils/telemetry.py``) and
writes its spans as a Chrome trace to FILE at the end of the run.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Arguments for running EvenNICER-SLAM (PyTorch port)."
    )
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--input_folder", type=str,
                        help="input folder, overrides the config")
    parser.add_argument("--event_folder", type=str,
                        help="event input folder, overrides the config")
    parser.add_argument("--output", type=str,
                        help="output folder, overrides the config")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint")
    parser.add_argument("--end_frame", type=int, default=None,
                        help="stop after this many frames (debugging)")
    parser.add_argument("--viz_port", type=int, default=None,
                        help="serve the live browser viewer on this port while running")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the run (default cuda; cpu for tests)")
    parser.add_argument("--spans", type=str, default=None,
                        help="record the program's spans and write them to this "
                             "Chrome trace file at the end")
    nice_parser = parser.add_mutually_exclusive_group(required=False)
    nice_parser.add_argument("--nice", dest="nice", action="store_true")
    nice_parser.add_argument("--imap", dest="nice", action="store_false",
                             help="iMAP: one MLP, no grids (default config imap.yaml)")
    parser.set_defaults(nice=True)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from evennicer_slam_tpu_torch.config import default_config_path, load_config
    from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
    from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger
    from evennicer_slam_tpu_torch.utils.runtime import setup_torch
    from evennicer_slam_tpu_torch.utils.telemetry import TRACER

    cfg = load_config(args.config, default_config_path(args.nice))
    if args.spans:
        TRACER.enable()
    if args.device.startswith("cuda"):
        setup_torch(verbose=cfg.get("verbose", False))
    slam = EvenNICERSLAM(cfg, args, nice=args.nice, device=args.device)

    start = 0
    if args.resume:
        ckpt = CheckpointLogger.latest(os.path.join(slam.output, "ckpts"))
        if ckpt:
            start = CheckpointLogger.restore(slam, ckpt)
            print(f"Resumed from {ckpt} at frame {start}")
    if args.viz_port is not None:
        from evennicer_slam_tpu_torch.tools.viz_server import serve

        serve(slam.output, port=args.viz_port, blocking=False)
    # a resumed run goes through run() too, so its checkpoint and mesh
    # cadence and its final meshes are those of an uninterrupted run
    try:
        return slam.run(end_frame=args.end_frame, start_frame=start)
    finally:
        if args.spans:
            TRACER.export_chrome(args.spans)
            TRACER.disable()


if __name__ == "__main__":
    main()
