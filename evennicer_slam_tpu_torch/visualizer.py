"""Visualise a SLAM run (counterpart of the repository's ``visualizer.py``).

Two frontends over the same run artifacts, ``$OUTPUT/ckpts/*.npz`` and
``$OUTPUT/mesh/*.ply`` as the command line writes them (live or finished):

    # the browser viewer (the mesh reloading, trajectories, frustum)
    python -m evennicer_slam_tpu_torch.visualizer configs/Replica/room0.yaml --serve [--port 8765]

    # replay: chase-cam frames, and with --gif an animated GIF
    python -m evennicer_slam_tpu_torch.visualizer configs/Replica/room0.yaml --save_rendering --gif

``--follow`` keeps polling a running job.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Arguments to visualize the SLAM process."
    )
    parser.add_argument("config", type=str, help="Path to config file.")
    parser.add_argument("--input_folder", type=str,
                        help="accepted for reference-CLI compatibility; this"
                             " visualizer replays run artifacts only"
                             " ($OUTPUT/ckpts + mesh) and never reads the"
                             " input dataset")
    parser.add_argument("--output", type=str,
                        help="output folder, overrides the config")
    nice_parser = parser.add_mutually_exclusive_group(required=False)
    nice_parser.add_argument("--nice", dest="nice", action="store_true")
    nice_parser.add_argument("--imap", dest="nice", action="store_false")
    parser.set_defaults(nice=True)
    parser.add_argument("--serve", action="store_true",
                        help="interactive browser viewer instead of replay")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--save_rendering", action="store_true",
                        help="render replay frames to $OUTPUT/vis/replay")
    parser.add_argument("--gif", action="store_true",
                        help="assemble replay frames into $OUTPUT/replay.gif")
    parser.add_argument("--follow", action="store_true",
                        help="keep polling a live run")
    parser.add_argument("--poll_s", type=float, default=2.0)
    parser.add_argument("--frame_step", type=int, default=10)
    args = parser.parse_args(argv)

    from evennicer_slam_tpu_torch.config import default_config_path, load_config

    cfg = load_config(args.config, default_config_path(args.nice))
    output = args.output or cfg["data"]["output"]
    if args.input_folder:
        print("note: --input_folder is ignored — the visualizer replays run"
              f" artifacts from {output} and never reads the input dataset")

    if args.serve:
        from evennicer_slam_tpu_torch.tools.viz_server import serve

        serve(output, args.host, args.port, args.poll_s)
    else:
        from evennicer_slam_tpu_torch.tools import viz

        viz.replay(
            output,
            save_rendering=args.save_rendering or args.gif,
            gif=args.gif,
            follow=args.follow,
            poll_s=args.poll_s,
            frame_step=args.frame_step,
        )


if __name__ == "__main__":
    main()
