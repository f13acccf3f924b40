"""The benchmark's scene: the analytic furnished room of
``evennicer_slam_tpu_torch/data/synthetic.py``, rendered with torch on the
card (the same arithmetic: room box and furniture primitives, wall and
primitive textures, depth as z, events as brightness differences times the
gain), and written in the layout of the cell's dataset.

The camera runs one exactly periodic loop of ``P`` frames. The loop's files
are written once per checkout; the dataset the program reads is a directory
of links, frame ``k`` to loop frame ``k mod P``, so no window runs out of
frames. The event file of loop frame ``j`` holds the brightness change from
loop frame ``j - 1 (mod P)``, so the event that closes the loop is as
periodic as the rest.

A mix's ``scene`` may name the layout (``layout``, default
``replica_event``); what the layout's camera records beyond the Replica
camera (the lens, the depth PNGs' scale, event frames an image) is the
configuration's, ``cam.distortion``, ``cam.png_depth_scale`` and
``data.density`` (:func:`recorded`). A Replica configuration over a mix that
names no layout gets the Replica-event scene of the first benchmark, the
same key, files and fragment:

- ``replica_event``: RGB colour and depth PNGs under ``results/``, one event
  PNG an image in ``[0, -, +]`` order (frame ``k`` reads event file
  ``k - 1``), ``traj.txt``;
- ``replica``: the same files, read by the ``replica`` reader, without
  events; it shares the ``replica_event`` scene's directory;
- ``rpg_event_dense``: colour as one grey channel, the brightness the events
  are taken from; ``density`` event PNGs an image in ``[+, -, 0]`` order,
  each the brightness change between consecutive dense poses; dense step
  ``k`` reads image ``k // density`` and event file ``k - 1``; ``traj.txt``
  holds the image poses, ``traj_density{d}.txt`` the dense ones.

With a lens, colour and events are rendered through it (each pixel's ray the
inverse-distorted one) and depth at the same rays, as the sensor records
it; the reader's undistortion gives back the pinhole view.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.data.png import write_png

PNG_DEPTH_SCALE = 6553.5
SCENE_VERSION = 1
LAYOUTS = ("replica_event", "replica", "rpg_event_dense")
# cv2.undistortPoints' iteration, run past its default of 5 to its fixed point
UNDISTORT_POINT_ITERS = 20
_LIGHT = (0.40824829, 0.40824829, 0.81649658)
_WALL_BASE = ((0.9, 0.3, 0.3), (0.3, 0.9, 0.3), (0.3, 0.3, 0.9),
              (0.9, 0.9, 0.3), (0.3, 0.9, 0.9), (0.9, 0.3, 0.9))


def scene_primitives(bound: np.ndarray) -> List[Dict]:
    """The furniture of the furnished room, in room-relative coordinates
    (``data/synthetic.py::scene_primitives``)."""
    lo = bound[:, 0].astype(np.float64)
    e = (bound[:, 1] - bound[:, 0]).astype(np.float64)

    def rel(p):
        return lo + np.asarray(p, np.float64) * e

    rmin = float(e.min())
    boxes = [  # (lo, hi, colour, pattern)
        ([0.55, 0.30, 0.0], [0.75, 0.50, 0.18], [0.78, 0.55, 0.30], 7.0),
        ([0.05, 0.62, 0.0], [0.18, 0.85, 0.55], [0.35, 0.45, 0.80], 9.0),
        ([0.30, 0.05, 0.0], [0.52, 0.20, 0.28], [0.70, 0.30, 0.55], 5.0),
    ]
    spheres = [  # (centre, radius / rmin, colour, pattern)
        ([0.35, 0.70, 0.10], 0.075, [0.90, 0.62, 0.20], 11.0),
        ([0.50, 0.50, 0.75], 0.06, [0.30, 0.85, 0.75], 13.0),
    ]
    relief = [
        ([0.15, 0.0, 0.45], [0.35, 0.03, 0.75], [0.85, 0.75, 0.40], 15.0),
        ([0.60, 0.0, 0.35], [0.85, 0.025, 0.70], [0.45, 0.70, 0.45], 17.0),
        ([0.20, 0.97, 0.40], [0.45, 1.0, 0.72], [0.60, 0.50, 0.85], 19.0),
        ([0.65, 0.975, 0.30], [0.90, 1.0, 0.62], [0.80, 0.45, 0.35], 21.0),
        ([0.0, 0.25, 0.50], [0.03, 0.50, 0.80], [0.40, 0.80, 0.70], 23.0),
        ([0.97, 0.30, 0.35], [1.0, 0.55, 0.75], [0.75, 0.65, 0.30], 25.0),
        ([0.965, 0.70, 0.30], [1.0, 0.90, 0.60], [0.50, 0.40, 0.75], 27.0),
        ([0.45, 0.0, 0.93], [0.55, 1.0, 1.0], [0.70, 0.55, 0.40], 29.0),
        ([0.72, 0.65, 0.82], [0.78, 0.72, 1.0], [0.85, 0.85, 0.55], 31.0),
        ([0.25, 0.45, 0.0], [0.60, 0.75, 0.08], [0.55, 0.30, 0.30], 33.0),
    ]
    out = [{"type": "box", "lo": rel(a), "hi": rel(b), "color": np.array(c), "pat": p}
           for a, b, c, p in boxes]
    out += [{"type": "sphere", "c": rel(c), "r": f * rmin, "color": np.array(col), "pat": p}
            for c, f, col, p in spheres]
    out += [{"type": "box", "lo": rel(a), "hi": rel(b), "color": np.array(c), "pat": p}
            for a, b, c, p in relief]
    return out


def _wall_texture(u: torch.Tensor, v: torch.Tensor, face: int) -> torch.Tensor:
    base = torch.tensor(_WALL_BASE[face], dtype=torch.float32, device=u.device)
    pat = 0.5 + 0.2 * torch.sin(6.0 * np.pi * u) * torch.cos(5.0 * np.pi * v)
    pat = pat + 0.15 * torch.sin(2.5 * np.pi * v) + 0.1 * torch.cos(3.5 * np.pi * u)
    check = 0.12 * ((torch.trunc(u * 8).long() + torch.trunc(v * 8).long()) % 2)
    c = base[None, :].double() * (pat + check)[:, None]
    ramp = torch.stack([0.22 * (u - 0.5), 0.22 * (v - 0.5), 0.11 * (v - u)], dim=1)
    if face % 2 == 1:
        ramp = -ramp
    c = c + torch.roll(ramp, face // 2, dims=1)
    return torch.clamp(c, 0.0, 1.0)


def _prim_color(prim, hit: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    p = prim["pat"]
    tex = (0.72 + 0.18 * torch.sin(p * hit[:, 0]) * torch.cos(p * hit[:, 1])
           + 0.10 * torch.sin(p * 1.7 * hit[:, 2]))
    light = torch.tensor(_LIGHT, dtype=torch.float64, device=hit.device)
    lam = 0.55 + 0.45 * torch.clamp(normal.double() @ light, 0.0, 1.0)
    col = torch.as_tensor(prim["color"], dtype=torch.float64, device=hit.device)
    return torch.clamp(col[None, :] * (tex * lam)[:, None], 0.0, 1.0)


def render_view(c2w: np.ndarray, H: int, W: int, fx: float, fy: float, bound: np.ndarray,
                prims, device, xy=None) -> tuple:
    """(colour [H, W, 3] float32 in [0, 1], depth [H, W] float32 metres) of
    the room seen from ``c2w``, principal point at the image centre; the
    precisions of ``data/synthetic.py::render_box_views`` (rays in float32,
    primitive hits in float64). ``xy`` ([H, W, 2], x right, y down) gives
    each pixel's normalised ray in place of the pinhole's (a lens)."""
    if xy is None:
        cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
        j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                              torch.arange(W, dtype=torch.float32, device=device),
                              indexing="ij")
        dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], -1)
    else:
        xy = torch.as_tensor(np.asarray(xy, np.float32), device=device)
        dirs = torch.stack([xy[..., 0], -xy[..., 1], -torch.ones_like(xy[..., 0])], -1)
    rot = torch.as_tensor(np.asarray(c2w[:3, :3], np.float32), device=device)
    flat_d = (dirs @ rot.T).reshape(-1, 3)
    flat_o = torch.as_tensor(np.asarray(c2w[:3, 3], np.float32), device=device)[None].expand_as(
        flat_d)
    bnd = torch.as_tensor(np.asarray(bound, np.float32), device=device)
    t = (bnd.T[None] - flat_o[:, None, :]) / flat_d[:, None, :]
    t = torch.where(torch.isfinite(t), t, torch.full_like(t, float("inf")))
    t_best = torch.amin(torch.amax(t, dim=1), dim=1).double()
    n = flat_d.shape[0]
    hit_prim = torch.full((n,), -1, dtype=torch.long, device=device)
    o64, d64 = flat_o.double(), flat_d.double()
    inf = torch.full_like(t_best, float("inf"))
    for pi, prim in enumerate(prims):
        if prim["type"] == "box":
            lo = torch.as_tensor(prim["lo"], device=device)[None]
            hi = torch.as_tensor(prim["hi"], device=device)[None]
            t0 = (lo - o64) / d64
            t1 = (hi - o64) / d64
            tn = torch.amax(torch.nan_to_num(torch.minimum(t0, t1), nan=-float("inf")), dim=1)
            tf = torch.amin(torch.nan_to_num(torch.maximum(t0, t1), nan=float("inf")), dim=1)
            tp = torch.where((tf > tn) & (tn > 1e-4), tn, inf)
        else:
            oc = o64 - torch.as_tensor(prim["c"], device=device)[None]
            b = torch.sum(oc * d64, dim=1)
            a = torch.sum(d64 * d64, dim=1)
            c = torch.sum(oc * oc, dim=1) - prim["r"] ** 2
            disc = b * b - a * c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            tp = torch.where(disc > 0, (-b - sq) / a, inf)
            tp = torch.where(tp > 1e-4, tp, inf)
        closer = tp < t_best
        t_best = torch.where(closer, tp, t_best)
        hit_prim = torch.where(closer, torch.full_like(hit_prim, pi), hit_prim)

    hit = o64 + t_best[:, None] * d64
    colors = torch.zeros((n, 3), dtype=torch.float32, device=device)
    assigned = hit_prim >= 0
    ext = (bound[:, 1] - bound[:, 0]).astype(np.float32)
    for axis in range(3):
        for side in range(2):
            plane = float(np.float32(bound[axis, side]))
            m = (torch.abs(hit[:, axis] - plane) < 1e-4 * max(1.0, abs(plane))) & ~assigned
            assigned |= m
            other = [a for a in range(3) if a != axis]
            u = (hit[m, other[0]] - float(np.float32(bound[other[0], 0]))) / float(ext[other[0]])
            v = (hit[m, other[1]] - float(np.float32(bound[other[1], 0]))) / float(ext[other[1]])
            colors[m] = _wall_texture(u, v, axis * 2 + side).float()
    for pi, prim in enumerate(prims):
        m = hit_prim == pi
        ph = hit[m]
        if prim["type"] == "box":
            lo = torch.as_tensor(prim["lo"], device=device)[None]
            hi = torch.as_tensor(prim["hi"], device=device)[None]
            k = torch.argmin(torch.cat([torch.abs(ph - lo), torch.abs(ph - hi)], dim=1), dim=1)
            normal = torch.zeros_like(ph)
            normal[torch.arange(ph.shape[0], device=device), k % 3] = torch.where(
                k < 3, -1.0, 1.0).double()
        else:
            normal = ph - torch.as_tensor(prim["c"], device=device)[None]
            normal = normal / torch.linalg.norm(normal, dim=1, keepdim=True)
        colors[m] = _prim_color(prim, ph, normal).float()
    return colors.reshape(H, W, 3), t_best.reshape(H, W).float()


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """c2w of a camera at ``eye`` looking at ``target`` (x right, y up, z
    backward; ``data/synthetic.py::_look_at``)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(up, z)
    nx = np.linalg.norm(x)
    if nx < 1e-6:
        up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        nx = np.linalg.norm(x)
    x = x / nx
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([x, y, z], axis=1)
    c2w[:3, 3] = eye
    return c2w


def trajectory(angles, center: np.ndarray, radius: float = 0.3, height_amp: float = 0.05,
               gaze_mult: float = 1.0, pitch_base: float = -0.7, pitch_amp: float = 0.25,
               pitch_freq: float = 3.0) -> np.ndarray:
    """[n, 4, 4] c2w: the eye on a circle about ``center`` at each angle,
    the gaze panning ahead of it (``data/synthetic.py::circular_trajectory``
    at the angles given)."""
    poses = []
    for th in angles:
        eye = center + np.array([radius * np.cos(th), radius * np.sin(th),
                                 height_amp * np.sin(2 * th)])
        gaze = th * gaze_mult + 0.6
        target = center + np.array([2.0 * np.cos(gaze), 2.0 * np.sin(gaze),
                                    pitch_base + pitch_amp * np.sin(pitch_freq * th)])
        poses.append(look_at(eye, target))
    return np.stack(poses)


def loop_angles(n: int, amplitude: float) -> np.ndarray:
    """A swing of ``amplitude`` radians each way, one period in ``n`` frames."""
    k = np.arange(n, dtype=np.float64)
    return amplitude * np.sin(2.0 * np.pi * k / n)


def distorted_rays(H: int, W: int, fx: float, fy: float, dist) -> np.ndarray:
    """[H, W, 2] float64: the normalised ray (x right, y down) that reaches
    each pixel of a sensor behind the lens ``dist`` (k1 k2 p1 p2 [k3 [k4 k5
    k6]]), principal point at the image centre: ``cv2.undistortPoints``'
    fixed-point iteration, ``UNDISTORT_POINT_ITERS`` times."""
    d = np.zeros(8)
    d[:len(dist)] = np.asarray(dist, np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    j, i = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                       indexing="ij")
    x0, y0 = (i - cx) / fx, (j - cy) / fy
    x, y = x0, y0
    for _ in range(UNDISTORT_POINT_ITERS):
        r2 = x * x + y * y
        icdist = (1 + ((k6 * r2 + k5) * r2 + k4) * r2) / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return np.stack([x, y], axis=-1)


def quantised_frames(poses: np.ndarray, H, W, fx, fy, bound, gain, device, furnished=True,
                     xy=None, grey=False, depth_scale=PNG_DEPTH_SCALE):
    """Yield (colour uint8 [H, W, 3], or [H, W] brightness with ``grey``;
    depth uint16 [H, W]; event uint8 [H, W, 2] with polarity [-, +]) of each
    pose; the first pose's events are the change from the LAST pose, which
    closes the loop. ``xy``: each pixel's ray (:func:`render_view`)."""
    prims = scene_primitives(bound) if furnished else []

    def intensity(c):
        return c.mean(dim=-1)

    renders = [render_view(poses[-1], H, W, fx, fy, bound, prims, device, xy)]
    prev = intensity(renders[0][0])
    for k in range(len(poses)):
        color, depth = render_view(poses[k], H, W, fx, fy, bound, prims, device, xy)
        cur = intensity(color)
        diff = (cur - prev) * gain
        event = torch.stack([torch.clamp(-diff, 0, 255), torch.clamp(diff, 0, 255)], dim=-1)
        prev = cur
        yield (((cur if grey else color) * 255).to(torch.uint8).cpu().numpy(),
               torch.clamp(depth * depth_scale, 0, 65535).to(torch.int32).cpu().numpy()
               .astype(np.uint16),
               event.to(torch.uint8).cpu().numpy())


def raw_traj(pose: np.ndarray) -> np.ndarray:
    """traj.txt holds the pose before the reader's y/z flip."""
    raw = pose.copy()
    raw[..., :3, 1] *= -1
    raw[..., :3, 2] *= -1
    return raw


def layout(params: Dict) -> str:
    name = params.get("layout", "replica_event")
    if name not in LAYOUTS:
        raise ValueError(f"scene layout {name!r}: one of {LAYOUTS}")
    return name


def file_params(params: Dict) -> Dict:
    """The parameters that fix the scene's files: the ``replica`` layout
    reads the files of ``replica_event``, so it is keyed without its name."""
    return {k: v for k, v in params.items() if not (k == "layout" and v == "replica")}


# what a scene records beyond the Replica camera, and the Replica camera's
REPLICA_CAMERA = {"png_depth_scale": PNG_DEPTH_SCALE, "distortion": None, "density": 1}


def recorded(params: Dict, cfg: Dict) -> Dict:
    """The mix's scene with what the camera of the run's configuration
    ``cfg`` records where it differs from the Replica camera: its lens, its
    depth PNGs' scale and, in the dense layout, its event frames an image."""
    if set(params) & set(REPLICA_CAMERA):
        raise ValueError(f"a mix's scene names no {sorted(REPLICA_CAMERA)}: the "
                         "configuration states them")
    cam = cfg["cam"]
    rec = {"png_depth_scale": cam.get("png_depth_scale", PNG_DEPTH_SCALE),
           "distortion": cam.get("distortion"),
           "density": (cfg["data"]["density"] if layout(params) == "rpg_event_dense" else 1)}
    return dict(params, **{k: v for k, v in rec.items() if v != REPLICA_CAMERA[k]})


def scene_key(params: Dict) -> str:
    blob = json.dumps({"v": SCENE_VERSION, **file_params(params)}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def write_scene(root: str, params: Dict, device) -> Dict:
    """Write (or keep, when its stamp matches) the loop and the linked
    dataset under ``root``; return the config fragment that points the
    reader at it. ``params``: H, W, fx, fy, bound [[lo, hi]] x 3, margin,
    loop_frames, frames, amplitude, event_gain, ``layout``, and what the
    camera records (:func:`recorded`)."""
    key = scene_key(params)
    out = os.path.join(root, f"scene_{key}")
    stamp = os.path.join(out, "stamp.json")
    if not os.path.exists(stamp):
        # written aside and renamed into place: a run cut short leaves no
        # half scene, and two runs that write at once both end with one
        tmp = f"{out}.partial{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        _write(tmp, params)
        with open(os.path.join(tmp, "stamp.json"), "w") as f:
            json.dump(file_params(params), f, sort_keys=True)
        try:
            os.rename(tmp, out)
        except OSError:
            if not os.path.exists(stamp):
                raise
        shutil.rmtree(tmp, ignore_errors=True)
    return scene_fragment(out, params)


def room_box(params: Dict) -> np.ndarray:
    """The room's walls: the configured bound less the margin."""
    return np.asarray(params["bound"], np.float64) + np.array([params["margin"],
                                                               -params["margin"]])


def density(params: Dict) -> int:
    """Event frames an image: 1 but in the dense layout."""
    return int(params.get("density", 1))


def loop_poses(params: Dict) -> np.ndarray:
    """The loop's poses, ``density`` of them an image: image ``j`` is seen
    from pose ``j * density``."""
    box = room_box(params)
    return trajectory(loop_angles(params["loop_frames"] * density(params), params["amplitude"]),
                      box.mean(axis=1))


def loop_frames(params: Dict, device) -> "iter":
    """:func:`quantised_frames` of the loop's poses through the scene's lens."""
    H, W, fx, fy = params["H"], params["W"], params["fx"], params["fy"]
    xy = distorted_rays(H, W, fx, fy, params["distortion"]) if "distortion" in params else None
    return quantised_frames(loop_poses(params), H, W, fx, fy, room_box(params),
                            params["event_gain"], device=device, xy=xy,
                            grey=layout(params) == "rpg_event_dense",
                            depth_scale=params.get("png_depth_scale", PNG_DEPTH_SCALE))


def _write_traj(path: str, poses: np.ndarray) -> None:
    lines = [" ".join(f"{v:.9f}" for v in raw_traj(pose).reshape(-1)) for pose in poses]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write(out: str, params: Dict) -> None:
    """The loop's files and ``frames`` images linked into it, ``density``
    event files an image less the first image's: event file ``e`` holds the
    change from dense pose ``e`` to ``e + 1``, loop pose ``(e + 1) mod P *
    density`` (the reader gives dense step ``k`` event file ``k - 1``)."""
    poses = loop_poses(params)
    P, N, d = params["loop_frames"], params["frames"], density(params)
    dense = layout(params) == "rpg_event_dense"
    loop = os.path.join(out, "loop")
    os.makedirs(loop)
    for m, (color8, depth16, event8) in enumerate(loop_frames(params, _device())):
        if m % d == 0:
            write_png(os.path.join(loop, f"frame{m // d:06d}.png"), color8)
            write_png(os.path.join(loop, f"depth{m // d:06d}.png"), depth16)
        zero = np.zeros_like(event8[..., :1])
        # RGB [+, -, 0] for the RPG event readers, [0, -, +] for Replica's
        write_png(os.path.join(loop, f"event{m:06d}.png"), np.concatenate(
            [event8[..., 1:], event8[..., :1], zero] if dense else [zero, event8], axis=-1))
    res = os.path.join(out, "data", "results")
    ev = os.path.join(out, "data", "events")
    os.makedirs(res)
    os.makedirs(ev)
    for k in range(N):
        j = k % P
        os.symlink(f"../../loop/frame{j:06d}.png", os.path.join(res, f"frame{k:06d}.png"))
        os.symlink(f"../../loop/depth{j:06d}.png", os.path.join(res, f"depth{k:06d}.png"))
    for e in range(N * d - d):
        os.symlink(f"../../loop/event{(e + 1) % (P * d):06d}.png",
                   os.path.join(ev, f"frame{e:06d}.png"))
    _write_traj(os.path.join(out, "data", "traj.txt"), poses[(np.arange(N) % P) * d])
    if dense:
        _write_traj(os.path.join(out, "data", f"traj_density{d}.txt"),
                    poses[np.arange(N * d - d + 1) % (P * d)])


def _device():
    return torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")


def scene_fragment(out: str, params: Dict) -> Dict:
    """The configuration's keys that point the layout's reader at the scene
    and state its camera."""
    H, W = params["H"], params["W"]
    name = layout(params)
    data = {"input_folder": os.path.join(out, "data")}
    if name != "replica":
        data["event_folder"] = os.path.join(out, "data", "events")
    if name == "rpg_event_dense":
        data["density"] = density(params)
    cam = {"H": H, "W": W, "fx": params["fx"], "fy": params["fy"],
           "cx": (W - 1) / 2.0, "cy": (H - 1) / 2.0,
           "png_depth_scale": params.get("png_depth_scale", PNG_DEPTH_SCALE), "crop_edge": 0}
    if "distortion" in params:
        cam["distortion"] = [float(v) for v in params["distortion"]]
    return {
        "dataset": name,
        "data": data,
        "cam": cam,
        "mapping": {"bound": params["bound"], "marching_cubes_bound": params["bound"]},
    }
