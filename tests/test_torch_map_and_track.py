"""Map and track the same frames with the JAX package and with the port, on
the CPU: the test holds the port's tracker to the JAX package's on every
frame of a tiny interleaved run; run as a script, it prints both frameworks'
trajectory errors at the shipped configuration's width.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_map_and_track.py -q
    JAX_PLATFORMS=cpu python tests/test_torch_map_and_track.py [--scale 0.25]
        [--seeds 0 1] [--schedules bench every] [--out results.json]

The loop is ``chip_smoke.py::map_and_track``, run through each framework's
own ``Mapper`` and ``Tracker`` with the same calls: frame 0 mapped from its
true pose (300 iterations at lr x 5), frames 1..25 tracked on the fitted
map, a steady mapping call (60 iterations, the tracker's device pose, the
coarse mapper fused, BA from the fifth keyframe) and a new keyframe every
fifth frame. The shipped ``configs/nice_slam.yaml`` with the bench
workload's event settings (EventNet from ``pretrained/eventnet_mapdomain.npz``)
at full width; only the camera is cut: 680x1200 scaled by ``--scale`` (the
focal lengths and the tracker's ignored edges with it). The furnished
synthetic room, ``traj_step`` 0.01. The map starts from
``PRNGKey(seed)`` on both sides.

Both sides make the same random draws: the JAX package's pixel and window
selection draws are handed to the port's mapper, its tracking pixel draws to
the port's tracker. So the two runs start alike and part only by rounding,
which the tracker's and mapper's Adam steps amplify over the frames.

The port runs twice: the tracker's decode in f32 (as the JAX package runs it
on the CPU) and through the packed bf16 snapshot (the decode the card runs,
here through its plain version). Schedules: ``bench`` (event only, RGB-D
every fifth frame) and ``every`` (RGB-D + event on every frame).

Prints one JSON line per run and a summary line; ``--out`` writes them all.

The test (36x48 frames of the synthetic room, the small mapping of
``test_torch_mapper.py``, the analytic event predictor to keep the JAX
compiles small) runs the JAX package's map-and-track loop over five frames,
mapping every second frame, with the port's f32 tracker beside it: started
from the JAX side's state on each frame, the port's tracked position lies
within SHADOW_ATOL of the JAX package's (three Adam steps at lr 1e-3; the
single-frame tolerance of ``test_torch_tracker.py``).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from evennicer_slam_tpu.config import load_config as j_load_config  # noqa: E402
from evennicer_slam_tpu.config import update_recursive as j_update  # noqa: E402
from evennicer_slam_tpu.core.rays import sample_pixels as j_sample_pixels  # noqa: E402
from evennicer_slam_tpu.models import decoders as jd  # noqa: E402
from evennicer_slam_tpu.models.eventnet_train import (  # noqa: E402
    load_eventnet_npz as j_load_eventnet,
)
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids  # noqa: E402
from evennicer_slam_tpu.render.renderer import RenderSettings as JSettings  # noqa: E402
from evennicer_slam_tpu.slam import mapper as jm  # noqa: E402
from evennicer_slam_tpu.slam import tracker as jt  # noqa: E402
from evennicer_slam_tpu.slam.camera import Camera as JCamera  # noqa: E402
from evennicer_slam_tpu_torch.config import (  # noqa: E402
    default_config_path,
    load_config,
    update_recursive,
)
from evennicer_slam_tpu_torch.data.synthetic import synthetic_frames  # noqa: E402
from evennicer_slam_tpu_torch.models.decoders import pack_grids_for_tracking  # noqa: E402
from evennicer_slam_tpu_torch.models.eventnet import load_eventnet_npz  # noqa: E402
from evennicer_slam_tpu_torch.render.renderer import RenderSettings  # noqa: E402
from evennicer_slam_tpu_torch.slam import mapper as tm  # noqa: E402
from evennicer_slam_tpu_torch.slam import tracker as tt  # noqa: E402
from evennicer_slam_tpu_torch.slam.camera import Camera  # noqa: E402

from torch_parity import to_torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "pretrained", "eventnet_mapdomain.npz")
BOUND = np.array([[-2.0, 2.0], [-1.6, 1.6], [-1.2, 1.2]], np.float32)
ROOM = BOUND + np.array([[0.02, -0.02]], np.float32)  # as chip_smoke.py
N_FRAMES = 26
EVERY = 5           # mapping cadence, keyframe_every, RGB-D cadence of the bench schedule
ITERS_FIRST = 300   # bench.py:82
# the closed-loop runs, the JAX package's first: the port's tracker decodes in
# f32 or through the packed bf16 snapshot
RUNS = {"jax": None, "port_f32": False, "port_bf16_snapshot": True}
# the bench workload's event settings (bench.py:62-72), as chip_smoke.py sets them
EVENT = {"rgbd_every_frame": 5, "activate_events": True, "balancer": 0.025,
         "scale_factor": 0.15, "blur": True, "kernel_sizes": [9], "unblurred_weight": 0,
         "kernel_weights": [1]}


def configure(cfg, scale, update):
    update(cfg, {"event": dict(EVENT),
                 "tracking": {"ignore_edge_W": round(100 * scale),
                              "ignore_edge_H": round(100 * scale)},
                 "mapping": {"iters_first": ITERS_FIRST, "keyframe_every": EVERY}})
    c = cfg["cam"]
    H, W = round(c["H"] * scale), round(c["W"] * scale)
    cfg["cam"].update(H=H, W=W, fx=c["fx"] * scale, fy=c["fy"] * scale,
                      cx=(W - 1) / 2.0, cy=(H - 1) / 2.0)
    return cfg


def jax_map_draws(seed, stage, n, K, pix, hw, coarse):
    """The JAX mapper's draws of a stage's n iterations, as the port takes
    them: [n, K, pix] (``map_frame_jit`` folds the stage, the iteration and,
    for the fused coarse term, 2 into ``PRNGKey(seed)``)."""
    out = []
    for it in range(n):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                                                    np.int32(tm.STAGE_IDS[stage])), np.int32(it))
        if coarse:
            key = jax.random.fold_in(key, 2)
        out.append(np.asarray(jax.vmap(lambda k: jax.random.randint(k, (pix,), 0, hw))(
            jax.random.split(key, K))))
    return torch.from_numpy(np.stack(out).astype(np.int64))


class JaxDrawsMapper(tm.Mapper):
    """The port's mapper with the JAX package's pixel and selection draws."""

    def _draw_pixels(self, seed, stage, term, n, K, pix):
        return jax_map_draws(seed, stage, n, K, pix, self.cam.H * self.cam.W, bool(term))

    def _selection_draws(self, seed, n_kf):
        k_pix, k_pri = jax.random.split(jax.random.PRNGKey(np.uint32(seed * 2 + 1)))
        idx = np.asarray(jax.random.randint(k_pix, (100,), 0, self.cam.H * self.cam.W))
        pri = np.asarray(jax.random.uniform(k_pri, (n_kf - 1,)))
        return torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(pri)


def jax_track_draws(seed, cfg, cam):
    """The JAX tracker's pixel draws of a frame: ``fold_in(PRNGKey(seed), it)``."""
    key = jax.random.PRNGKey(seed)
    out = []
    for it in range(cfg.iters):
        i, j = j_sample_pixels(jax.random.fold_in(key, it), cfg.pixels, cfg.ignore_edge_h,
                               cam.H - cfg.ignore_edge_h, cfg.ignore_edge_w,
                               cam.W - cfg.ignore_edge_w)
        out.append((torch.from_numpy(np.array(i)), torch.from_numpy(np.array(j))))
    return out


def drive(side, frames, rgbd_every, shadows=(), every=EVERY):
    """The map-and-track loop of ``chip_smoke.py::map_and_track`` over
    ``side``'s classes; returns the per-frame position errors, the losses of
    each mapping call and, for each shadow, its per-frame distance from this
    side's tracked pose (mm)."""
    mapper, tracker, dev = side["mapper"], side["tracker"], side["dev"]
    grids, decoders = side["grids"], side["decoders"]
    mcfg, n = mapper.cfg, len(frames)
    f0 = frames[0]
    imgs = [(dev(f.color), dev(f.depth), dev(f.event)) for f in frames]
    tracker.reset_event_integration(f0.event.shape)
    tracker.pre_gt_color = imgs[0][0]
    tracker.end_of_window(0, imgs[0][0], every)
    mapper.update_ba_state()
    grids, decoders, _ = mapper.optimize_map(
        mcfg.iters_first, mcfg.lr_first_factor, 0, f0.color, f0.depth, f0.event,
        f0.c2w.copy(), seed=0, grids=grids, decoders=decoders, cur_images_dev=imgs[0][:2])
    mapper.maybe_add_keyframe(0, n, f0.color, f0.depth, f0.event, f0.c2w, f0.c2w,
                              device_images=imgs[0][:2])
    map_losses = [float(mapper.last_loss)]
    track_grids = side["pack"](grids)
    for s in shadows:
        s["reload"](grids, decoders)
    est = {0: dev(f0.c2w)}
    apart = {s["name"]: [] for s in shadows}
    for f in frames[1:]:
        i = f.index
        c, d, e = imgs[i]
        state = (tracker.gt_event_integrate, tracker.pre_gt_color, tracker.event_bias)
        est[i] = tracker.track(i, c, d, e, est[i - 1], est[i - 2] if i >= 2 else None,
                               decoders, track_grids, seed=i,
                               **side["track_draws"](i, i % rgbd_every == 0))
        mine = np.asarray(side["to_np"](est[i]), np.float64)
        for s in shadows:
            got = s["track"](f, state, est[i - 1], est[i - 2] if i >= 2 else None,
                             i % rgbd_every == 0)
            apart[s["name"]].append(round(1e3 * float(np.linalg.norm(got[:3, 3] - mine[:3, 3])),
                                          4))
        tracker.end_of_window(i, c, every)
        if i % every == 0:
            mapper.update_ba_state()
            grids, decoders, new = mapper.optimize_map(
                mcfg.iters, mcfg.lr_factor, i, f.color, f.depth, f.event, est[i],
                seed=i * 97, grids=grids, decoders=decoders, cur_images_dev=(c, d))
            if new is not None:
                est[i] = new
            mapper.maybe_add_keyframe(i, n, f.color, f.depth, f.event, est[i], f.c2w,
                                      device_images=(c, d))
            map_losses.append(float(mapper.last_loss))
            track_grids = side["pack"](grids)
            for s in shadows:
                s["reload"](grids, decoders)
    est_t = np.stack([np.asarray(side["to_np"](est[k]))[:3, 3] for k in range(n)])
    gt_t = np.stack([f.c2w[:3, 3] for f in frames])
    return np.linalg.norm(est_t.astype(np.float64) - gt_t, axis=1), map_losses, apart


def _eventnet(npz, load, **kw):
    return load(npz, **kw) if npz else None


def shadow(cfg, packed, name, bound=BOUND, npz=NPZ):
    """The port's tracker run beside the JAX package's on every frame, from
    the JAX side's state: its map, its previous poses, its event integral,
    previous colour and bias, and its pixel draws. Its pose is compared with
    the JAX package's and then dropped, so the two never part by more than
    one frame's tracking."""
    tcfg = tt.TrackerConfig.from_cfg(cfg, use_events=True)
    cam = Camera.from_cfg(cfg)
    tracker = tt.Tracker(tcfg, cam, RenderSettings.from_cfg(cfg)._replace(fused_decode=packed),
                         bound, _eventnet(npz, load_eventnet_npz, device="cpu"), device="cpu")
    held = {}

    def to_t(a):
        return None if a is None else torch.from_numpy(np.array(a, np.float32))

    def reload(grids, decoders):
        g = to_torch(grids)
        held["grids"] = pack_grids_for_tracking(g) if packed else g
        held["decoders"] = to_torch(decoders)

    def track(f, state, pre, prepre, rgbd):
        tracker.gt_event_integrate, tracker.pre_gt_color, tracker.event_bias = map(to_t, state)
        out = tracker.track(f.index, to_t(f.color), to_t(f.depth), to_t(f.event), to_t(pre),
                            to_t(prepre), held["decoders"], held["grids"], seed=f.index,
                            pixel_draws=jax_track_draws(f.index, tcfg, cam) if rgbd else None)
        return out.numpy().astype(np.float64)

    return dict(name=name, reload=reload, track=track)


def jax_side(cfg, seed, bound=BOUND, npz=NPZ):
    tcfg = jt.TrackerConfig.from_cfg(cfg, use_events=True)
    cam = JCamera.from_cfg(cfg)
    settings = JSettings.from_cfg(cfg)
    mapper = jm.Mapper(jm.MapperConfig.from_cfg(cfg), cam, settings, bound, seed=1234)
    mapper.fuse_coarse = True
    tracker = jt.Tracker(tcfg, cam, settings._replace(fused_decode=False), bound,
                         _eventnet(npz, j_load_eventnet))
    grids = j_init_grids(jax.random.PRNGKey(seed), bound, cfg["grid_len"],
                         c_dim=cfg["model"]["c_dim"], coarse=True,
                         coarse_bound_enlarge=cfg["model"]["coarse_bound_enlarge"])
    decoders = jd.init_nice_decoders(jax.random.PRNGKey(seed + 1),
                                     c_dim=cfg["model"]["c_dim"], coarse=True)
    return dict(mapper=mapper, tracker=tracker, grids=grids, decoders=decoders,
                dev=jnp.asarray, to_np=np.asarray, pack=lambda g: g,
                track_draws=lambda i, rgbd: {})


def port_side(cfg, jax_map, packed):
    tcfg = tt.TrackerConfig.from_cfg(cfg, use_events=True)
    cam = Camera.from_cfg(cfg)
    settings = RenderSettings.from_cfg(cfg)
    mapper = JaxDrawsMapper(tm.MapperConfig.from_cfg(cfg), cam, settings, BOUND, seed=1234,
                            device="cpu")
    mapper.fuse_coarse = True
    tracker = tt.Tracker(tcfg, cam, settings._replace(fused_decode=packed), BOUND,
                         load_eventnet_npz(NPZ, device="cpu"), device="cpu")

    return dict(mapper=mapper, tracker=tracker, grids=to_torch(jax_map[0]),
                decoders=to_torch(jax_map[1]),
                dev=lambda a: torch.from_numpy(np.asarray(a, np.float32)).clone(),
                to_np=lambda x: x.detach().numpy(),
                pack=pack_grids_for_tracking if packed else (lambda g: g),
                track_draws=lambda i, rgbd: (
                    {"pixel_draws": jax_track_draws(i, tcfg, cam)} if rgbd else {}))


# ---- the test: a tiny interleaved run --------------------------------------------

SHADOW_ATOL = 2e-4
TINY_BOUND = np.array([[-1.22, 1.38], [-1.02, 1.18], [-0.82, 0.98]], np.float32)
TINY_ROOM = np.array([[-1.2, 1.2], [-1.0, 1.0], [-0.8, 0.8]], np.float32)


def tiny_cfg(load, update):
    """The small sizes of ``test_torch_mapper.py`` (36x48, 120 mapping pixels,
    window 3, a keyframe and a mapping call every second frame) and of
    ``test_torch_tracker.py`` (64 pixels, 3 iterations, half-scale events),
    RGB-D every second frame, the analytic event predictor."""
    cfg = load(default_config_path(nice=True))
    update(cfg, {
        "cam": {"H": 36, "W": 48, "fx": 60.0, "fy": 60.0, "cx": 23.5, "cy": 17.5},
        "grid_len": {"coarse": 0.8, "middle": 0.4, "fine": 0.2, "color": 0.2,
                     "bound_divisible": 0.2},
        "mapping": {"iters_first": 12, "iters": 6, "every_frame": 2, "pixels": 120,
                    "mapping_window_size": 3, "keyframe_every": 2, "BA": True},
        "tracking": {"pixels": 64, "iters": 3, "ignore_edge_W": 5, "ignore_edge_H": 4},
        "event": {"rgbd_every_frame": 2, "activate_events": True, "scale_factor": 0.5,
                  "kernel_sizes": [5], "kernel_weights": [1], "predictor": "esim"},
    })
    return cfg


def test_port_tracker_follows_jax_through_map_and_track():
    torch.set_num_threads(1)
    frames = list(synthetic_frames(5, 36, 48, fx=60.0, fy=60.0, bound=TINY_ROOM,
                                   traj_step=0.02))
    side = jax_side(tiny_cfg(j_load_config, j_update), 0, bound=TINY_BOUND, npz=None)
    port = shadow(tiny_cfg(load_config, update_recursive), False, "port_f32",
                  bound=TINY_BOUND, npz=None)
    err, map_losses, apart = drive(side, frames, 2, [port], every=2)
    assert len(apart["port_f32"]) == 4 and np.isfinite(err).all()
    assert all(np.isfinite(map_losses)) and len(map_losses) == 3
    assert max(apart["port_f32"]) <= 1e3 * SHADOW_ATOL, apart


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.25,
                    help="camera size as a fraction of 680x1200")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--schedules", nargs="+", default=["bench", "every"],
                    choices=["bench", "every"])
    ap.add_argument("--no_shadows", action="store_true",
                    help="skip the port's trackers beside the JAX run")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None, help="write every result to this JSON file")
    opts = ap.parse_args()
    torch.set_num_threads(opts.threads)
    cam0 = Camera.from_cfg(configure(load_config(default_config_path(nice=True)), opts.scale,
                                     update_recursive))
    t0 = time.perf_counter()
    frames = list(synthetic_frames(N_FRAMES, cam0.H, cam0.W, fx=cam0.fx, fy=cam0.fy,
                                   bound=ROOM, traj_step=0.01, furnished=True))
    gt_t = np.stack([f.c2w[:3, 3] for f in frames]).astype(np.float64)
    held = float(np.sqrt(np.mean(np.sum((gt_t - gt_t[0]) ** 2, axis=1))))
    print(f"{N_FRAMES} frames {cam0.H}x{cam0.W} in {time.perf_counter() - t0:.1f} s; "
          f"held camera RMSE {held:.5f} m", flush=True)
    results = []
    for seed in opts.seeds:
        for sched in opts.schedules:
            every = EVENT["rgbd_every_frame"] if sched == "bench" else 1
            jax_map = None
            for name, packed in RUNS.items():
                cfg = configure(j_load_config(default_config_path(nice=True)) if name == "jax"
                                else load_config(default_config_path(nice=True)),
                                opts.scale, j_update if name == "jax" else update_recursive)
                cfg["event"]["rgbd_every_frame"] = every
                shadows = ()
                if name == "jax":
                    side = jax_side(cfg, seed)
                    jax_map = (side["grids"], side["decoders"])
                    pcfg = configure(load_config(default_config_path(nice=True)), opts.scale,
                                     update_recursive)
                    pcfg["event"]["rgbd_every_frame"] = every
                    shadows = [] if opts.no_shadows else [
                        shadow(pcfg, False, "port_f32"), shadow(pcfg, True, "port_bf16_snapshot")]
                else:
                    side = port_side(cfg, jax_map, packed)
                t1 = time.perf_counter()
                err, map_losses, apart = drive(side, frames, every, shadows)
                rec = {"seed": seed, "schedule": sched, "run": name,
                       "ate_rmse_m": float(np.sqrt(np.mean(err ** 2))),
                       "held_camera_rmse_m": held,
                       "err_mm_per_frame": [round(1e3 * x, 2) for x in err],
                       "mapping_losses": map_losses, "s": round(time.perf_counter() - t1, 1)}
                if apart:
                    rec["shadow_mm_from_jax_per_frame"] = apart
                results.append(rec)
                print(json.dumps(rec), flush=True)
    summary = {}
    for r in results:
        summary.setdefault(r["schedule"], {}).setdefault(r["run"], []).append(r["ate_rmse_m"])
    print(json.dumps({"cam": [cam0.H, cam0.W], "held_camera_rmse_m": held,
                      "ate_rmse_m": summary}), flush=True)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump({"args": vars(opts), "runs": results, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
