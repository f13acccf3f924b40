"""Procedural synthetic RGB-D + event sequences (counterpart of
``evennicer_slam_tpu/data/synthetic.py``; numpy only).

A textured axis-aligned room, optionally furnished, rendered analytically by
ray/box and ray/sphere intersection along a smooth camera path, with
ESIM-style ground-truth event frames. :func:`synthetic_frames` yields, frame
by frame, what the Replica-event dataset reader hands the pipeline after the
scene has made the round trip through its PNG files: colour quantised to 8
bits, depth to 16 bits at ``PNG_DEPTH_SCALE``, the event image as 8-bit
counts with polarity order [-, +], and the pose. :func:`make_synthetic_replica`
writes the same scene to disk in the Replica-event layout (PNG through
``data/png.py``). The ground-truth mesh comes with the mesher.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np

from evennicer_slam_tpu_torch.data.png import read_png, write_png

PNG_DEPTH_SCALE = 6553.5


def _wall_texture(u: np.ndarray, v: np.ndarray, face: int) -> np.ndarray:
    """Smooth per-face texture in [0,1]^3; face in 0..5 (±x, ±y, ±z)."""
    base = np.array(
        [
            [0.9, 0.3, 0.3],
            [0.3, 0.9, 0.3],
            [0.3, 0.3, 0.9],
            [0.9, 0.9, 0.3],
            [0.3, 0.9, 0.9],
            [0.9, 0.3, 0.9],
        ],
        np.float32,
    )[face]
    # texture with gradient in BOTH face axes so every pose DoF is observable
    # photometrically (a plain wall leaves motion along the wall plane with a
    # flat loss landscape)
    pat = 0.5 + 0.2 * np.sin(6.0 * np.pi * u) * np.cos(5.0 * np.pi * v)
    pat += 0.15 * np.sin(2.5 * np.pi * v) + 0.1 * np.cos(3.5 * np.pi * u)
    check = 0.12 * (((u * 8).astype(int) + (v * 8).astype(int)) % 2)
    c = base[None, :] * (pat + check)[:, None]
    # monotonic per-channel ramps make every wall position locally UNIQUE at
    # low frequency: periodic texture alone lets the pose slide along a wall
    # once the map's color render is still blurry (high-frequency content
    # washes out; measured 2.5 cm/frame gauge drift in ceiling-corner views),
    # while a ramp survives any blur. Channel directions differ per face so
    # u and v are separately observable in color.
    ramp = np.stack(
        [0.22 * (u - 0.5), 0.22 * (v - 0.5), 0.11 * (v - u)], axis=1
    )
    if face % 2 == 1:  # vary sign across opposite faces
        ramp = -ramp
    c = c + np.roll(ramp, face // 2, axis=1)
    return np.clip(c, 0.0, 1.0)


def scene_primitives(bound: np.ndarray):
    """Interior furniture for the "furnished" scene variant: boxes and
    spheres placed in room-relative coordinates (so any bound works) —
    occluders at different heights, giving the validation scene clutter,
    occlusion, and non-planar geometry."""
    lo = bound[:, 0].astype(np.float64)
    e = (bound[:, 1] - bound[:, 0]).astype(np.float64)

    def rel(p):
        return lo + np.asarray(p, np.float64) * e

    rmin = float(e.min())
    return [
        # table-like block mid-room
        {"type": "box", "lo": rel([0.55, 0.30, 0.0]), "hi": rel([0.75, 0.50, 0.18]),
         "color": np.array([0.78, 0.55, 0.30]), "pat": 7.0},
        # tall cabinet against the -x wall (strong occluder)
        {"type": "box", "lo": rel([0.05, 0.62, 0.0]), "hi": rel([0.18, 0.85, 0.55]),
         "color": np.array([0.35, 0.45, 0.80]), "pat": 9.0},
        # low sofa block along the -y wall
        {"type": "box", "lo": rel([0.30, 0.05, 0.0]), "hi": rel([0.52, 0.20, 0.28]),
         "color": np.array([0.70, 0.30, 0.55]), "pat": 5.0},
        # ball on the floor
        {"type": "sphere", "c": rel([0.35, 0.70, 0.10]), "r": 0.075 * rmin,
         "color": np.array([0.90, 0.62, 0.20]), "pat": 11.0},
        # floating lamp (mid-air occluder)
        {"type": "sphere", "c": rel([0.50, 0.50, 0.75]), "r": 0.06 * rmin,
         "color": np.array([0.30, 0.85, 0.75]), "pat": 13.0},
        # --- surface relief: every wall/ceiling/floor fronto view must
        # contain a depth discontinuity, or in-plane translation is
        # unconstrained by depth and the const-speed motion model integrates
        # open-loop through the stretch (measured: 2 cm/frame slide through
        # a 40-frame ceiling-only window). Real rooms have relief everywhere;
        # picture frames / shelves / beams give the synthetic scene the same
        # property.
        # pictures on the -y and +y walls
        {"type": "box", "lo": rel([0.15, 0.0, 0.45]), "hi": rel([0.35, 0.03, 0.75]),
         "color": np.array([0.85, 0.75, 0.40]), "pat": 15.0},
        {"type": "box", "lo": rel([0.60, 0.0, 0.35]), "hi": rel([0.85, 0.025, 0.70]),
         "color": np.array([0.45, 0.70, 0.45]), "pat": 17.0},
        {"type": "box", "lo": rel([0.20, 0.97, 0.40]), "hi": rel([0.45, 1.0, 0.72]),
         "color": np.array([0.60, 0.50, 0.85]), "pat": 19.0},
        {"type": "box", "lo": rel([0.65, 0.975, 0.30]), "hi": rel([0.90, 1.0, 0.62]),
         "color": np.array([0.80, 0.45, 0.35]), "pat": 21.0},
        # pictures/shelves on the -x and +x walls
        {"type": "box", "lo": rel([0.0, 0.25, 0.50]), "hi": rel([0.03, 0.50, 0.80]),
         "color": np.array([0.40, 0.80, 0.70]), "pat": 23.0},
        {"type": "box", "lo": rel([0.97, 0.30, 0.35]), "hi": rel([1.0, 0.55, 0.75]),
         "color": np.array([0.75, 0.65, 0.30]), "pat": 25.0},
        {"type": "box", "lo": rel([0.965, 0.70, 0.30]), "hi": rel([1.0, 0.90, 0.60]),
         "color": np.array([0.50, 0.40, 0.75]), "pat": 27.0},
        # ceiling beam (full y span) + hanging lamp box
        {"type": "box", "lo": rel([0.45, 0.0, 0.93]), "hi": rel([0.55, 1.0, 1.0]),
         "color": np.array([0.70, 0.55, 0.40]), "pat": 29.0},
        {"type": "box", "lo": rel([0.72, 0.65, 0.82]), "hi": rel([0.78, 0.72, 1.0]),
         "color": np.array([0.85, 0.85, 0.55]), "pat": 31.0},
        # floor ottoman (thick rug)
        {"type": "box", "lo": rel([0.25, 0.45, 0.0]), "hi": rel([0.60, 0.75, 0.08]),
         "color": np.array([0.55, 0.30, 0.30]), "pat": 33.0},
    ]


_LIGHT = np.array([0.40824829, 0.40824829, 0.81649658])  # fixed scene light


def _prim_color(prim, hit: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """Procedural texture + Lambert shading for a primitive hit batch."""
    p = prim["pat"]
    tex = (
        0.72
        + 0.18 * np.sin(p * hit[:, 0]) * np.cos(p * hit[:, 1])
        + 0.10 * np.sin(p * 1.7 * hit[:, 2])
    )
    lam = 0.55 + 0.45 * np.clip(normal @ _LIGHT, 0.0, 1.0)
    return np.clip(prim["color"][None, :] * (tex * lam)[:, None], 0.0, 1.0)


def render_box_views(
    c2w: np.ndarray,
    H: int,
    W: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bound: np.ndarray,
    prims=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic render of the room interior (plus optional interior
    primitives) from one pose, with correct nearest-hit occlusion.

    Returns (color [H, W, 3] in [0,1], depth [H, W] in meters)."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    dirs = np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)

    flat_d = rays_d.reshape(-1, 3)
    flat_o = rays_o.reshape(-1, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (bound.T[None] - flat_o[:, None, :]) / flat_d[:, None, :]  # [N, 2, 3]
    t = np.where(np.isfinite(t), t, np.inf)
    t_exit = np.min(np.max(t, axis=1), axis=1)  # room-wall exit per ray
    N = flat_o.shape[0]
    t_best = t_exit.copy()
    hit_prim = np.full(N, -1, np.int32)

    for pi, prim in enumerate(prims or ()):
        with np.errstate(divide="ignore", invalid="ignore"):
            if prim["type"] == "box":
                t0 = (prim["lo"][None] - flat_o) / flat_d
                t1 = (prim["hi"][None] - flat_o) / flat_d
                tn = np.nanmax(np.minimum(t0, t1), axis=1)
                tf = np.nanmin(np.maximum(t0, t1), axis=1)
                tp = np.where((tf > tn) & (tn > 1e-4), tn, np.inf)
            else:  # sphere
                oc = flat_o - prim["c"][None]
                b = np.sum(oc * flat_d, axis=1)
                a = np.sum(flat_d * flat_d, axis=1)
                c = np.sum(oc * oc, axis=1) - prim["r"] ** 2
                disc = b * b - a * c
                sq = np.sqrt(np.maximum(disc, 0.0))
                tp = np.where(disc > 0, (-b - sq) / a, np.inf)
                tp = np.where(tp > 1e-4, tp, np.inf)
        closer = tp < t_best
        t_best = np.where(closer, tp, t_best)
        hit_prim = np.where(closer, pi, hit_prim)

    hit = flat_o + t_best[:, None] * flat_d
    # pixel dirs have z_cam = -1, so the ray parameter t IS the z-depth —
    # exactly the quantity stored in Replica depth PNGs and consumed by the
    # renderer's depth-led sampling.
    depth = t_best

    colors = np.zeros((N, 3), np.float32)
    # wall texture for rays that exit on the room box
    eps = 1e-4
    assigned = hit_prim >= 0
    ext = bound[:, 1] - bound[:, 0]
    for axis in range(3):
        for side in range(2):
            face = axis * 2 + side
            plane = bound[axis, side]
            m = np.abs(hit[:, axis] - plane) < eps * max(1.0, abs(plane))
            m &= ~assigned
            assigned |= m
            if not np.any(m):
                continue
            other = [a for a in range(3) if a != axis]
            u = (hit[m, other[0]] - bound[other[0], 0]) / ext[other[0]]
            v = (hit[m, other[1]] - bound[other[1], 0]) / ext[other[1]]
            colors[m] = _wall_texture(u, v, face)

    for pi, prim in enumerate(prims or ()):
        m = hit_prim == pi
        if not np.any(m):
            continue
        ph = hit[m]
        if prim["type"] == "box":
            # face normal = axis of the slab the hit lies on
            dlo = np.abs(ph - prim["lo"][None])
            dhi = np.abs(ph - prim["hi"][None])
            d6 = np.concatenate([dlo, dhi], axis=1)
            k = np.argmin(d6, axis=1)
            normal = np.zeros_like(ph)
            normal[np.arange(len(ph)), k % 3] = np.where(k < 3, -1.0, 1.0)
        else:
            normal = ph - prim["c"][None]
            normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        colors[m] = _prim_color(prim, ph, normal)

    return colors.reshape(H, W, 3), depth.reshape(H, W).astype(np.float32)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """c2w rotation for a camera at ``eye`` looking at ``target`` (camera
    convention of core.rays: x right, y up, z backward)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(up, z)
    nx = np.linalg.norm(x)
    if nx < 1e-6:  # looking straight up/down
        up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        nx = np.linalg.norm(x)
    x = x / nx
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = R
    c2w[:3, 3] = eye
    return c2w


def circular_trajectory(
    n: int,
    center: np.ndarray,
    radius: float = 0.3,
    height_amp: float = 0.05,
    step: float = None,
    jitter: float = 0.0,
    jitter_seed: int = 7,
    gaze_mult: float = 1.0,
    pitch_base: float = -0.7,
    pitch_amp: float = 0.25,
    pitch_freq: float = 3.0,
) -> np.ndarray:
    """Smooth camera path inside the room: the eye orbits the center while the
    gaze pans along the walls (so views hit corners — varied depth gives
    tracking a full 6-DoF signal). ``step`` is the per-frame angle increment
    (radians); default sweeps a quarter turn over the sequence.

    ``gaze_mult``/``pitch_*`` shape surface COVERAGE: the gaze pans at
    ``gaze_mult`` x the eye's angular speed and the gaze target's height
    swings ``pitch_base ± pitch_amp`` — a coverage trajectory uses a fast
    pan + tall pitch sweep to observe floor, ceiling, and all four walls.
    Returns [n, 4, 4] c2w."""
    poses = []
    jr = np.random.default_rng(jitter_seed)
    for k in range(n):
        th = k * step if step is not None else 2.0 * np.pi * k / max(n, 1) * 0.25
        eye = center + np.array(
            [radius * np.cos(th), radius * np.sin(th), height_amp * np.sin(2 * th)]
        )
        if jitter > 0:
            # non-smooth motion: breaks constant-velocity extrapolation so
            # frame-to-frame supervision (events) has something to correct
            eye = eye + jr.normal(scale=jitter, size=3)
        gaze = th * gaze_mult + 0.6  # pan ahead of the eye position
        # pitch the gaze down toward the floor corner so depth varies along
        # the image v-axis too (full 6-DoF observability)
        target = center + np.array(
            [2.0 * np.cos(gaze), 2.0 * np.sin(gaze),
             pitch_base + pitch_amp * np.sin(pitch_freq * th)]
        )
        poses.append(_look_at(eye, target))
    return np.stack(poses)


class Frame(NamedTuple):
    """One frame as the dataset reader yields it."""

    index: int
    color: np.ndarray   # [H, W, 3] float32 in [0, 1]
    depth: np.ndarray   # [H, W] float32, metres
    event: np.ndarray   # [H, W, 2] float32 event counts, polarity [-, +]
    event_mask: np.ndarray  # [H, W] int32, 1 where any polarity fired
    c2w: np.ndarray     # [4, 4] float32


def _scene_images(n_frames, H, W, fx, fy, bound, event_gain, traj_step, traj_jitter,
                  traj_seed, furnished, traj_kwargs):
    """(pose, colour [H, W, 3] uint8, depth [H, W] uint16 at
    ``PNG_DEPTH_SCALE``, events [H, W, 2] uint8 with polarity [-, +]) of
    each frame: what the scene's PNG files hold. Frame ``k``'s events are the
    brightness change from frame ``k - 1`` to ``k`` of the unquantised
    render, times ``event_gain``, clipped to [0, 255] and truncated to whole
    counts; frame 0 has none."""
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    poses = circular_trajectory(n_frames, bound.mean(axis=1), step=traj_step,
                                jitter=traj_jitter, jitter_seed=traj_seed,
                                **(traj_kwargs or {}))
    prims = scene_primitives(bound) if furnished else None
    prev_intensity = None
    for k in range(n_frames):
        color, depth = render_box_views(poses[k], H, W, fx, fy, cx, cy, bound,
                                        prims=prims)
        intensity = color.mean(axis=-1)
        if k > 0:
            diff = (intensity - prev_intensity) * event_gain
            event = np.stack([np.clip(-diff, 0, 255), np.clip(diff, 0, 255)],
                             axis=-1).astype(np.uint8)
        else:
            event = np.zeros((H, W, 2), np.uint8)
        prev_intensity = intensity
        yield (poses[k], (color * 255).astype(np.uint8),
               np.clip(depth * PNG_DEPTH_SCALE, 0, 65535).astype(np.uint16), event)


def _default_bound(bound):
    if bound is None:
        return np.array([[-1.2, 1.2], [-1.0, 1.0], [-0.8, 0.8]], np.float32)
    return bound


def synthetic_frames(
    n_frames: int = 8,
    H: int = 120,
    W: int = 200,
    fx: float = 100.0,
    fy: float = 100.0,
    bound: Optional[np.ndarray] = None,
    event_gain: float = 20.0,
    traj_step: float = None,
    traj_jitter: float = 0.0,
    traj_seed: int = 7,
    furnished: bool = False,
    traj_kwargs: Optional[Dict] = None,
) -> Iterator[Frame]:
    """The frames of the synthetic Replica-event scene, one at a time, equal
    to what the reader (``data/datasets.py``) returns for the dataset
    :func:`make_synthetic_replica` writes with the same arguments (principal
    point at the image centre)."""
    bound = _default_bound(bound)
    images = _scene_images(n_frames, H, W, fx, fy, bound, event_gain, traj_step,
                           traj_jitter, traj_seed, furnished, traj_kwargs)
    for k, (pose, color8, depth16, event8) in enumerate(images):
        event = event8.astype(np.float32)
        yield Frame(
            index=k,
            color=(color8.astype(np.float64) / 255.0).astype(np.float32),
            depth=(depth16.astype(np.float32) / PNG_DEPTH_SCALE).astype(np.float32),
            event=event,
            event_mask=np.any(event != 0, axis=-1).astype(np.int32),
            # the reader parses the pose from nine decimals of text
            c2w=np.round(pose.astype(np.float64), 9).astype(np.float32),
        )


# ---- the scene on disk -----------------------------------------------------------

def _event_file(event8: np.ndarray) -> np.ndarray:
    """Events [-, +] -> the event PNG's pixels, RGB order [0, -, +] (the
    JAX package writes BGR [+, -, 0] through cv2, the same file)."""
    return np.concatenate([np.zeros_like(event8[..., :1]), event8], axis=-1)


def _raw_traj(pose: np.ndarray) -> np.ndarray:
    """traj.txt stores the pose before the reader's y/z flip."""
    raw = pose.copy()
    raw[..., :3, 1] *= -1
    raw[..., :3, 2] *= -1
    return raw


def make_synthetic_replica(
    out_dir: str,
    n_frames: int = 8,
    H: int = 120,
    W: int = 200,
    fx: float = 100.0,
    fy: float = 100.0,
    bound: Optional[np.ndarray] = None,
    event_gain: float = 20.0,
    traj_step: float = None,
    traj_jitter: float = 0.0,
    traj_seed: int = 7,
    furnished: bool = False,
    traj_kwargs: Optional[Dict] = None,
    reuse_if_current: bool = False,
) -> Dict:
    """Write a Replica-format dataset (+ event folder) and return a config
    fragment describing it: ``results/frame*.png`` (RGB),
    ``results/depth*.png`` (16-bit, x6553.5), ``traj.txt`` (poses before
    the reader's y/z flip), ``events/frame*.png`` (RGB [0, -, +]). The
    files hold the same pixels as the JAX package's writer's.

    With ``reuse_if_current`` an existing directory is kept when it matches
    the requested parameters (frame count, trajectory, and re-renders of
    frames 0 and 1 against the files, which catches a change of the scene
    code or of ``event_gain``): full-resolution generation is minutes of
    host ray tracing per hundred frames."""
    bound = _default_bound(bound)
    args = (n_frames, H, W, fx, fy, bound, event_gain, traj_step, traj_jitter, traj_seed,
            furnished, traj_kwargs)
    res = os.path.join(out_dir, "results")
    ev_dir = os.path.join(out_dir, "events")
    os.makedirs(res, exist_ok=True)
    os.makedirs(ev_dir, exist_ok=True)
    if reuse_if_current and _scene_is_current(out_dir, res, ev_dir, args):
        return _scene_frag(out_dir, ev_dir, H, W, fx, fy, bound)
    # remove stale frames of an earlier scene of another length
    for stale in glob.glob(os.path.join(res, "*.png")) + glob.glob(os.path.join(ev_dir, "*.png")):
        os.remove(stale)

    traj_lines = []
    for k, (pose, color8, depth16, event8) in enumerate(_scene_images(*args)):
        write_png(os.path.join(res, f"frame{k:06d}.png"), color8)
        write_png(os.path.join(res, f"depth{k:06d}.png"), depth16)
        if k > 0:
            write_png(os.path.join(ev_dir, f"frame{k - 1:06d}.png"), _event_file(event8))
        traj_lines.append(" ".join(f"{v:.9f}" for v in _raw_traj(pose).reshape(-1)))
    with open(os.path.join(out_dir, "traj.txt"), "w") as f:
        f.write("\n".join(traj_lines) + "\n")
    return _scene_frag(out_dir, ev_dir, H, W, fx, fy, bound)


def _scene_is_current(out_dir, res, ev_dir, args) -> bool:
    """Whether the scene on disk is the one ``args`` describe: the frame,
    depth and event counts, the stored trajectory against a fresh one, and
    re-renders of frames 0 and 1 compared pixel for pixel with the stored
    colour, depth and event images."""
    n_frames, H, W, _, _, bound, _, traj_step, traj_jitter, traj_seed, _, traj_kwargs = args
    traj_path = os.path.join(out_dir, "traj.txt")
    if not os.path.exists(traj_path):
        return False
    n_have = len([f for f in os.listdir(res) if f.startswith("frame")])
    if n_have != n_frames or len(os.listdir(ev_dir)) != n_frames - 1:
        return False
    try:
        traj = np.loadtxt(traj_path).reshape(-1, 4, 4)
    except ValueError:
        return False
    poses = circular_trajectory(n_frames, bound.mean(axis=1), step=traj_step,
                                jitter=traj_jitter, jitter_seed=traj_seed,
                                **(traj_kwargs or {}))
    # traj.txt rounds to 9 decimals
    if len(traj) != n_frames or not np.allclose(traj, _raw_traj(poses), atol=2e-9):
        return False
    images = _scene_images(*args)  # lazy: renders the frames it is asked for
    _, color8, depth16, _ = next(images)
    try:
        disk_c = read_png(os.path.join(res, "frame000000.png"))
        disk_d = read_png(os.path.join(res, "depth000000.png"))
        if not (np.array_equal(disk_c, color8) and np.array_equal(disk_d, depth16)):
            return False
        if n_frames > 1:
            # one more render pins the event encoding, event_gain included
            _, _, _, event8 = next(images)
            disk_ev = read_png(os.path.join(ev_dir, "frame000000.png"))
            if not np.array_equal(disk_ev, _event_file(event8)):
                return False
    except (OSError, ValueError):
        return False
    return True


def _scene_frag(out_dir, ev_dir, H, W, fx, fy, bound) -> Dict:
    margin = 0.02
    cfg_bound = (bound + np.array([-margin, margin])).tolist()
    return {
        "dataset": "replica_event",
        "data": {
            "input_folder": out_dir,
            "event_folder": ev_dir,
            "output": os.path.join(out_dir, "output"),
        },
        "cam": {
            "H": H, "W": W, "fx": fx, "fy": fy, "cx": (W - 1) / 2.0, "cy": (H - 1) / 2.0,
            "png_depth_scale": PNG_DEPTH_SCALE, "crop_edge": 0,
        },
        "mapping": {"bound": cfg_bound, "marching_cubes_bound": cfg_bound},
    }
