"""What decides ``correct``: the calls that the timed path makes, followed
step by step by a plain reference.

In set-up, after the warm-up, the harness steps one more mapping period
through ``EvenNICERSLAM.step`` (the window's own call and feed, at the
window's sizes) and keeps host copies of what each ``Tracker.track`` and
``Mapper.optimize_map`` call started from (the program's map, poses,
keyframe registry and random-number state) and what it produced
(:class:`Capture`). After the window, with the program's state freed, the
reference (``portbench/reference/``: a frozen copy of the port's plain
PyTorch modules, no kernel) decodes the frames from the scene's files
itself, loads the EventNet weights from the same ``.npz``, re-derives the
window, masks and draws, and runs each call again from the program's state
(:class:`Reference`), each part at the precision that the configuration
states: the tracking decode of the NICE trio on the card with bf16 grid rows
and bf16 product operands (f32 accumulation, the cotangents rounded to bf16
as autograd rounds them), the mapping decode, iMAP's MLP and EventNet in
float32 with TF32 off. :func:`numbers` turns the two into the numbers held
against the cell's limits (:func:`limits`).

The control (:func:`control`) is the same reference computed one precision
below what the configuration states: the tracking decode's grid rows and
product operands in fp8, the float32 products and convolutions in TF32.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

LIMITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "limits")


def limits(cell: str) -> Dict[str, float]:
    """The compared numbers of ``cell`` and their limits
    (``portbench/limits/<cell>.json``; PERF.md gives the readings each was
    set from). A number the file does not name is a reading, not compared."""
    with open(os.path.join(LIMITS_DIR, f"{cell}.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


# -- host copies ---------------------------------------------------------------

def host(x):
    """A host copy of ``x`` (tensors cloned to the CPU, arrays copied),
    through dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x)
    return x


def to_dev(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_dev(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_dev(v, device) for v in x)
    return x


def named_leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}[{i}]")


def keyframe_poses(store) -> np.ndarray:
    """[n, 4, 4] estimated poses of a keyframe store as its next window
    would read them (device rows where it holds them, host rows after),
    without changing the store."""
    n = len(store.frames)
    rows = [np.asarray(f["est_c2w"], np.float32) for f in store.frames]
    dev = store._poses_dev
    if dev is not None:
        d = dev.detach().cpu().numpy()
        for i in range(min(n, d.shape[0])):
            rows[i] = d[i]
    return np.stack(rows) if rows else np.zeros((0, 4, 4), np.float32)


class Capture:
    """Host copies of the checked calls' inputs and outputs."""

    def __init__(self):
        self.tracks: List[Dict[str, Any]] = []
        self.maps: List[Dict[str, Any]] = []
        self._copies: Dict[int, Any] = {}
        self._steps: Optional[List] = None
        self._decode: List[Dict] = []
        self._eventnet: List[Dict] = []

    def _state(self, tree):
        # the map is one object for every frame tracked from it
        key = id(tree)
        if key not in self._copies:
            self._copies[key] = (tree, host(tree))
        return self._copies[key][1]

    def track_before(self, slam, idx, gt_color, gt_depth, gt_event, pre_c2w, pre_pre_c2w,
                     decoders, grids, seed):
        tr = slam.tracker
        self._steps = []
        self._decode = []
        self._eventnet = []
        return {"idx": int(idx), "seed": int(seed), "pre": host(pre_c2w),
                "pre_pre": host(pre_pre_c2w), "decoders": self._state(decoders),
                "grids": self._state(grids), "event_bias": host(tr.event_bias),
                "integrate": host(tr.gt_event_integrate), "pre_gt_color": host(tr.pre_gt_color),
                "frame": (host(gt_color), host(gt_depth), host(gt_event))}

    def wants_decode(self) -> bool:
        """The first tracking decode of each checked frame is kept whole."""
        return self._steps is not None and not self._decode

    def decode(self, p, out, bound):
        """The decode's points and output, and, through hooks, the gradient
        that reaches its output and the one it passes to its points."""
        rec = {"p": host(p), "out": host(out), "bound": host(bound)}
        self._decode.append(rec)
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("g_out", host(g)))
        if p.requires_grad:
            p.register_hook(lambda g: rec.__setitem__("g_p", host(g)))

    def wants_eventnet(self) -> bool:
        """The first EventNet call of each checked frame is kept whole."""
        return self._steps is not None and not self._eventnet

    def eventnet(self, img1, img2, out):
        """EventNet's inputs and outputs, and, through hooks, the gradients
        that reach its outputs and the one it passes to the rendered image."""
        rec = {"img1": host(img1), "img2": host(img2), "out": host(list(out)), "g_out": {}}
        self._eventnet.append(rec)
        if out[0].requires_grad:
            out[0].register_hook(lambda g: rec["g_out"].__setitem__(0, host(g)))
        if img2.requires_grad:
            img2.register_hook(lambda g: rec.__setitem__("g_img2", host(g)))

    def step(self, grad, before, after):
        """One Adam step of the frame being tracked."""
        if self._steps is not None:
            self._steps.append((host(grad), host(before), host(after)))

    def track_after(self, rec, c2w, losses):
        rec["c2w"] = host(c2w)
        rec["losses"] = host(losses)
        rec["steps"], self._steps = self._steps, None
        rec["decode"], self._decode = self._decode, []
        rec["eventnet"], self._eventnet = self._eventnet, []
        self.tracks.append(rec)

    def map_before(self, slam, args, kw):
        names = ("num_joint_iters", "lr_factor", "idx", "cur_gt_color", "cur_gt_depth",
                 "cur_gt_event", "cur_c2w")
        a = dict(zip(names, args))
        a.update(kw)
        m = slam.mapper
        return {"idx": int(a["idx"]), "iters": int(a["num_joint_iters"]),
                "lr_factor": a["lr_factor"], "seed": int(a.get("seed", 0)),
                "color_refine": bool(a.get("color_refine", False)),
                "cur_c2w": host(a["cur_c2w"]),
                "grids": host(a.get("grids")), "decoders": host(a.get("decoders")),
                "kf_idx": list(m.keyframes.indices),
                "kf_gt": [f["gt_c2w"].copy() for f in m.keyframes.frames],
                "kf_est": keyframe_poses(m.keyframes),
                "rng": copy.deepcopy(m.rng), "rng_coarse": copy.deepcopy(m.rng_coarse),
                "ba": bool(m.BA_active), "prev_map_idx": int(slam.mapping_idx)}

    def map_after(self, slam, rec, out):
        grids, decoders, new_c2w = out
        rec["new_grids"] = host(grids)
        rec["new_decoders"] = host(decoders)
        rec["new_c2w"] = host(new_c2w)
        rec["kf_est_after"] = keyframe_poses(slam.mapper.keyframes)
        loss = slam.mapper.last_loss
        rec["loss"] = float(loss) if isinstance(loss, torch.Tensor) else float(loss)
        self.maps.append(rec)

    def release(self):
        self._copies = {k: (None, v) for k, (_, v) in self._copies.items()}


# -- the reference -------------------------------------------------------------

GRID_LEVELS = ("coarse", "middle", "fine", "color")


def own_grids(grids):
    """The map's own grid levels: anything the program derived from them
    (packed rows, packed weights) is left for the reference to derive again."""
    if grids is None:
        return None
    return {k: v for k, v in grids.items() if k in GRID_LEVELS}


def scene_bound(cfg) -> np.ndarray:
    """The scene bound scaled and rounded up to ``grid_len.bound_divisible``."""
    bound = np.array(cfg["mapping"]["bound"], np.float64) * cfg["scale"]
    bd = cfg["grid_len"]["bound_divisible"]
    bound[:, 1] = (((bound[:, 1] - bound[:, 0]) / bd).astype(int) + 1) * bd + bound[:, 0]
    return bound.astype(np.float32)


# the readers that give their frames events (``has_events``)
EVENT_DATASETS = ("replica_event", "rpg_event", "rpg_event_dense")
# the RPG readers: colour read as grey, events in [+, -, 0] order
RPG_DATASETS = ("rpg", "rpg_event", "rpg_event_dense")


def uses_events(cfg) -> bool:
    """Whether the program runs its event branch: the reader has events and
    the configuration an ``event`` section."""
    return cfg["dataset"] in EVENT_DATASETS and bool(cfg.get("event"))


class Frames:
    """The scene's frames decoded from its files, as the reader of the
    configuration's ``dataset`` decodes them: colour / 255 (a grey file
    repeated to three channels),
    depth / png_depth_scale x scale; colour and events undistorted where
    ``cam.distortion`` is given, depth never. Events, polarity [-, +]:
    ``replica_event`` frame k reads event file k - 1 in [0, -, +] order;
    ``rpg_event_dense`` step k reads event file k - 1 in [+, -, 0] order and
    image k // density; ``replica`` has none, nor has frame 0."""

    def __init__(self, cfg, device):
        from portbench.reference.data.png import read_png
        from portbench.reference.data.undistort import Undistorter

        self.read_png = read_png
        self.folder = cfg["data"]["input_folder"]
        dataset = cfg["dataset"]
        self.event_folder = (cfg["data"].get("event_folder") if dataset in EVENT_DATASETS
                             else None)
        self.events = [1, 0] if dataset in RPG_DATASETS else slice(1, None)
        self.density = cfg["data"]["density"] if dataset == "rpg_event_dense" else 1
        cam = cfg["cam"]
        self.undistort = None if cam.get("distortion") is None else Undistorter(
            [[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]],
            cam["distortion"])
        self.depth_scale = cam["png_depth_scale"]
        self.scale = cfg["scale"]
        self.device = device
        self._cache: Dict[int, tuple] = {}

    def colour(self, path: str) -> np.ndarray:
        img = self.read_png(path)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if self.undistort is not None:
            img = self.undistort(img)
        return (img.astype(np.float64) / 255.0).astype(np.float32)

    def host(self, k: int):
        if k not in self._cache:
            res = os.path.join(self.folder, "results")
            image = k // self.density
            color = self.colour(os.path.join(res, f"frame{image:06d}.png"))
            depth = self.read_png(os.path.join(res, f"depth{image:06d}.png")).astype(np.float32)
            depth = (depth / self.depth_scale) * self.scale
            if k > 0 and self.event_folder:
                ev = self.read_png(os.path.join(self.event_folder, f"frame{k - 1:06d}.png"))
                if self.undistort is not None:
                    ev = self.undistort(ev.astype(np.float64))
                event = ev.astype(np.float32)[..., self.events]
            else:
                event = np.zeros(depth.shape + (2,), np.float32)
            self._cache[k] = (color, depth.astype(np.float32), event)
        return self._cache[k]

    def dev(self, k: int):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in self.host(k))


class Reference:
    """Follows the checked calls from the program's captured state with the
    frozen plain modules."""

    def __init__(self, cfg, nice: bool, eventnet_path: Optional[str], device,
                 packed: Optional[bool] = None):
        """``packed`` follows a tracker whose decode path was forced (the CPU
        tests); by default the reference decodes as the program chooses."""
        from portbench.reference.models.eventnet import load_eventnet_npz
        from portbench.reference.render.renderer import RenderSettings
        from portbench.reference.slam.camera import Camera

        self.cfg, self.nice, self.device = cfg, nice, torch.device(device)
        self.cam = Camera.from_cfg(cfg)
        self.bound = scene_bound(cfg)
        self.settings = RenderSettings.from_cfg(cfg, nice=nice)
        # as the program: on the card the tracker decodes the NICE trio from
        # bf16 packed corner rows with bf16 products (the plain ops of that
        # precision here); elsewhere, and in mapping, in float32
        self.packed = (self.device.type == "cuda" and nice) if packed is None else packed
        self.track_settings = self.settings._replace(fused_decode=self.packed)
        self.use_events = uses_events(cfg)
        self.eventnet = (load_eventnet_npz(eventnet_path, device=self.device)
                         if self.use_events and eventnet_path else {})
        self.frames = Frames(cfg, self.device)
        self.every = cfg["mapping"]["every_frame"]

    def track(self, rec):
        """The frame's tracking call, forced along the program's pose
        trajectory: at each iteration the reference computes the losses and
        the pose gradient at the program's pose, records them, checks the
        program's Adam step against its own Adam on the program's gradient,
        and goes on from the program's next pose."""
        from portbench.reference.slam import tracker as rt
        from portbench.reference.utils.optim import adam_init

        t_cfg = rt.TrackerConfig.from_cfg(self.cfg, self.use_events)
        tr = rt.Tracker(t_cfg, self.cam, self.track_settings, self.bound, self.eventnet,
                        device=self.device)
        idx = rec["idx"]
        b = ((idx - 1) // self.every) * self.every
        state = {}
        if self.use_events:
            tr.pre_gt_color = self.frames.dev(b)[0]
            integ = torch.zeros_like(self.frames.dev(idx)[2])
            for j in range(b + 1, idx):
                integ = integ + self.frames.dev(j)[2]
            tr.gt_event_integrate = integ
            state = {"integrate": integ, "pre_gt_color": tr.pre_gt_color}
        if rec["event_bias"] is not None:
            tr.event_bias = rec["event_bias"].to(self.device)
        color, depth, event = self.frames.dev(idx)
        steps = rec["steps"] or []
        grads, step_gap, own = [], [0.0], {}
        orig = rt.adam_update

        def forced(g, st, params, lr, *a, **k):
            i = len(grads)
            grads.append(g.detach().cpu())
            if i >= len(steps):  # the program stepped fewer times: follow its own way
                return orig(g, st, params, lr, *a, **k)
            pg, pbefore, pafter = (x.to(self.device) for x in steps[i])
            if i == 0 or "state" not in own:
                own["state"] = adam_init(pbefore)
            mine, own["state"] = orig(pg, own["state"], pbefore, lr, *a, **k)
            step_gap[0] = max(step_gap[0], float((mine - pafter).abs().max()))
            return pafter, st

        rt.adam_update = forced
        try:
            c2w = tr.track(idx, color, depth, event, to_dev(rec["pre"], self.device),
                           to_dev(rec["pre_pre"], self.device),
                           to_dev(rec["decoders"], self.device),
                           to_dev(own_grids(rec["grids"]), self.device), seed=rec["seed"])
        finally:
            rt.adam_update = orig
        return {"c2w": c2w.detach().cpu(), "losses": host(tr.last_losses), "grads": grads,
                "step_gap": step_gap[0], "n_steps": len(grads),
                "frame": (color, depth, event), "state": state,
                "decode": [self.decode(d, rec) for d in rec.get("decode", [])],
                "eventnet": [self.event_net(e) for e in rec.get("eventnet", [])]}

    def event_net(self, e):
        """EventNet with the reference's own weights on the program's pair,
        and its gradient to the rendered image for the gradients that reached
        the program's outputs."""
        from portbench.reference.models.eventnet import inference_event

        img2 = e["img2"].to(self.device).requires_grad_()
        out = inference_event(self.eventnet, e["img1"].to(self.device), img2)
        res = {"out": [t.detach().cpu() for t in out]}
        # the loss reads the prediction (output 0); the mask head enters it
        # only detached, and the gradient a hook sees at the mask is the
        # prediction's own path through it, so it is not fed in again
        if 0 in e["g_out"] and "g_img2" in e:
            (g,) = torch.autograd.grad(out[0], img2, e["g_out"][0].to(self.device))
            res["g_img2"] = g.cpu()
        return res

    def decode(self, d, rec):
        """The reference's colour-stage decode of the program's points, at
        the tracking decode's precision, and its gradient to them for the
        gradient that reached the program's decode."""
        from portbench.reference.models.decoders import nice_forward

        p = d["p"].to(self.device).requires_grad_()
        out = nice_forward(to_dev(rec["decoders"], self.device),
                           to_dev(own_grids(rec["grids"]), self.device),
                           p, d["bound"].to(self.device), "color", fused=self.packed)
        res = {"out": out.detach().cpu()}
        if "g_out" in d:
            (g,) = torch.autograd.grad(out, p, d["g_out"].to(self.device))
            res["g_p"] = g.cpu()
        return res

    def map(self, rec):
        from portbench.reference.slam import mapper as rm

        m_cfg = rm.MapperConfig.from_cfg(
            self.cfg, use_events=self.cfg.get("mapping", {}).get("use_events", False))
        mp = rm.Mapper(m_cfg, self.cam, self.settings, self.bound, eventnet=self.eventnet,
                       device=self.device)
        mp.fuse_coarse = bool(self.cfg["coarse"] and self.nice)
        for k, gt, est in zip(rec["kf_idx"], rec["kf_gt"], rec["kf_est"]):
            c, d, e = self.frames.host(k)
            mp.keyframes.append(k, c, d, e, est.copy(), gt)
        mp.rng = copy.deepcopy(rec["rng"])
        mp.rng_coarse = copy.deepcopy(rec["rng_coarse"])
        mp.update_ba_state()
        if mp.BA_active != rec["ba"]:
            raise RuntimeError("reference keyframe registry disagrees on BA")
        idx = rec["idx"]
        color, depth, _ = self.frames.dev(idx)
        c_np, d_np, _ = self.frames.host(idx)
        event = None
        for j in range(idx - self.every + 1, idx + 1):
            ev = self.frames.dev(j)[2]
            event = ev if event is None else event + ev
        cur = rec["cur_c2w"]
        cur = cur.to(self.device) if isinstance(cur, torch.Tensor) else cur.copy()
        adams = []
        orig = rm.map_frame

        def keep_adam(*a, **k):
            out = orig(*a, **k)
            adams.append(out[3])
            return out

        rm.map_frame = keep_adam
        try:
            grids, decoders, new_c2w = mp.optimize_map(
                rec["iters"], rec["lr_factor"], idx, c_np, d_np, event, cur,
                pre_gt_color=self.frames.dev(rec["prev_map_idx"])[0],
                color_refine=rec["color_refine"], seed=rec["seed"],
                grids=to_dev(rec["grids"], self.device),
                decoders=to_dev(rec["decoders"], self.device),
                cur_images_dev=(color, depth))
        finally:
            rm.map_frame = orig
        loss = mp.last_loss
        adam = adams[-1]
        v = None if adam is None else [t.detach().cpu() for _, t in named_leaves(adam.v)]
        return {"new_grids": host(grids), "new_decoders": host(decoders),
                "new_c2w": host(new_c2w), "kf_est_after": keyframe_poses(mp.keyframes),
                "loss": float(loss), "v": v}


# -- the numbers ---------------------------------------------------------------

def _rel(a: float, r: float) -> float:
    return abs(a - r) / max(abs(r), 1e-30)


def _max_abs(a, b) -> float:
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def _gaps(pairs) -> List[float]:
    """|a - r| over the larger of |r| and the median |r|, each pair."""
    if not pairs:
        return [0.0]
    med = float(np.median([abs(r) for _, r in pairs]))
    return [abs(a - r) / max(abs(r), med, 1e-30) for a, r in pairs]


def _scaled_gaps(pairs):
    """:func:`_gaps`, worst of the pairs."""
    return max(_gaps(pairs))


def compare_tracks(prog: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    """Worst over the checked frames, along the program's own pose
    trajectory: each iteration's loss terms (``track_event``,
    ``track_rgbd``; and the worst frame's median over its iterations,
    ``track_event_frame``, ``track_rgbd_frame``, which a pixel that crosses
    the RGB-D loss's outlier threshold on one side alone, in one iteration,
    does not move) and the norm of the pose gradient as Adam gets it, on
    frames with events only and on frames with RGB-D
    (``grad_event_frames``, ``grad_rgbd_frames``), each against the larger
    of the reference's value and its median; the program's Adam step against
    Adam on the program's gradient (``track_step``, absolute); and which
    pose the frame returns (``track_pick``): the reference's criterion loss
    at the returned pose over its least along the trajectory, less one, or 1
    where the returned pose is none of the trajectory's; and the direction
    of the pose gradient (``grad_cos``): one less the cosine between the
    program's gradient and the reference's, worst over every iteration
    (1 where one side's is zero and the other's is not, 2 where they point
    apart)."""
    from portbench.reference.core.quaternion import pose_matrix_from_tensor

    terms: Dict[str, list] = {}
    sizes: Dict[str, list] = {}
    grads: Dict[str, list] = {}
    step, pick, cos_gap = 0.0, 0.0, 0.0
    for p, r in zip(prog, ref):
        for k in ("rgbd", "event"):
            if k in r["losses"] and k in p["losses"]:
                pairs = list(zip(p["losses"][k].double().tolist(),
                                 r["losses"][k].double().tolist()))
                terms.setdefault(k, []).extend(pairs)
                sizes.setdefault(k, []).append(len(pairs))
        steps = p.get("steps") or []
        kind = "rgbd_frames" if "rgbd" in r["losses"] else "event_frames"
        for (g, _, _), gr in zip(steps, r["grads"]):
            grads.setdefault(kind, []).append((float(torch.linalg.norm(g.double())),
                                               float(torch.linalg.norm(gr.double()))))
            cos_gap = max(cos_gap, direction_gap(g, gr))
        if len(steps) != r["n_steps"]:
            step = max(step, 1.0)
        step = max(step, r["step_gap"])
        # the criterion: the event loss wherever the event branch runs
        ref_crit = r["losses"]["event" if "event" in r["losses"] else "rgbd"].double()
        # the returned pose is one of the trajectory's, to rounding: the card
        # and the host compute the matrix from the 7-vector apart
        chosen, near = None, 1e-5
        with torch.no_grad():
            for i, (_, _, after) in enumerate(steps):
                gap = float((pose_matrix_from_tensor(after.double())
                             - p["c2w"][:3].double()).abs().max())
                if gap <= near:
                    chosen, near = i, gap
        if chosen is None:
            pick = max(pick, 1.0)
        else:
            best = float(ref_crit.min())
            pick = max(pick, (float(ref_crit[chosen]) - best) / max(abs(best), 1e-30))
    out = {f"track_{k}": _scaled_gaps(v) for k, v in terms.items()}
    for k, v in terms.items():
        frames = np.split(np.asarray(_gaps(v)), np.cumsum(sizes[k])[:-1])
        out[f"track_{k}_frame"] = max(float(np.median(f)) for f in frames if f.size)
    out.update({f"grad_{k}": _scaled_gaps(v) for k, v in grads.items()})
    out["track_step"] = step
    out["track_pick"] = pick
    if grads:
        out["grad_cos"] = cos_gap
    return out


def direction_gap(a: torch.Tensor, r: torch.Tensor) -> float:
    """One less the cosine between ``a`` and ``r``; 0 where both are zero,
    1 where one is."""
    a, r = a.double().reshape(-1), r.double().reshape(-1)
    na, nr = float(torch.linalg.norm(a)), float(torch.linalg.norm(r))
    if na == 0.0 and nr == 0.0:
        return 0.0
    if na == 0.0 or nr == 0.0:
        return 1.0
    return 1.0 - float(a @ r) / (na * nr)


def _rel_err(a: torch.Tensor, r: torch.Tensor) -> float:
    return float(torch.linalg.norm((a.double() - r.double()).reshape(-1))
                 / max(float(torch.linalg.norm(r.double().reshape(-1))), 1e-30))


def compare_decodes(prog: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    """The tracking decode of the first render of each checked frame, point
    by point: its output (``decode_fwd``) and the gradient it passed to its
    points (``decode_bwd``), each as the norm of the gap over the norm of
    the reference's, worst over the frames."""
    fwd, bwd = [], []
    for p, r in zip(prog, ref):
        for dp, dr in zip(p.get("decode", []), r.get("decode", [])):
            fwd.append(_rel_err(dp["out"], dr["out"]))
            if "g_p" in dp and "g_p" in dr:
                bwd.append(_rel_err(dp["g_p"], dr["g_p"]))
    out = {}
    if fwd:
        out["decode_fwd"] = max(fwd)
    if bwd:
        out["decode_bwd"] = max(bwd)
    return out


def compare_eventnet(prog: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    """EventNet's first call of each checked frame, pixel by pixel: its two
    outputs (``eventnet_fwd``) and the gradient it passed to the rendered
    image (``eventnet_bwd``), each as the norm of the gap over the norm of
    the reference's, worst over the frames."""
    fwd, bwd = [], []
    for p, r in zip(prog, ref):
        for ep, er in zip(p.get("eventnet", []), r.get("eventnet", [])):
            fwd.extend(_rel_err(a, b) for a, b in zip(ep["out"], er["out"]))
            if "g_img2" in ep and "g_img2" in er:
                bwd.append(_rel_err(ep["g_img2"], er["g_img2"]))
    out = {}
    if fwd:
        out["eventnet_fwd"] = max(fwd)
    if bwd:
        out["eventnet_bwd"] = max(bwd)
    return out


def compare_frames(prog: List[Dict], ref: List[Dict]) -> float:
    """The frames and the tracker's frame-derived state the program held,
    against the reference's own decode of the files, largest absolute gap."""
    gap = 0.0
    for p, r in zip(prog, ref):
        for a, b in zip(p["frame"], r["frame"]):
            gap = max(gap, _max_abs(a, b))
        for k, v in r["state"].items():
            gap = max(gap, _max_abs(p[k], v))
    return gap


def next_frame_gap(prog: List[Dict], reference: "Reference") -> float:
    """The same gap where the program had read the next frame's files in
    place of each checked frame's: what ``frames`` reads on a frame read
    one off."""
    gap = 0.0
    for p in prog:
        for a, b in zip(p["frame"], reference.frames.host(p["idx"] + 1)):
            gap = max(gap, _max_abs(a, b))
    return gap


def compare_maps(prog: List[Dict], ref: List[Dict], before: List[Dict]) -> Dict[str, float]:
    """Worst over the checked mapping calls: the loss as a share of the
    reference's; by the worst leaf, the gap between the norms of the two
    sides' changes to the map, as a share of the larger of that leaf's and
    the median leaf's reference change (leaves whose reference gradient is
    under a thousandth of the median leaf's are left out); the gap of the
    keyframe and current-frame positions after the BA write-back, in
    metres."""
    loss, move, pose = 0.0, 0.0, 0.0
    for p, r, b in zip(prog, ref, before):
        loss = max(loss, _rel(p["loss"], r["loss"]))
        tree_b = (b["grids"], b["decoders"])
        tree_p = (p["new_grids"], p["new_decoders"])
        tree_r = (r["new_grids"], r["new_decoders"])
        lb, lp, lr = (list(named_leaves(t)) for t in (tree_b, tree_p, tree_r))
        n_leaf = len(lb)
        g = r["v"]
        grad = ([float(torch.sqrt(t.double().mean())) for t in g[:n_leaf]]
                if g is not None else [1.0] * n_leaf)
        live = [x for x in grad if x > 0]
        gmed = float(np.median(live)) if live else 0.0
        rows = []
        for i, ((name, tb), (_, tp), (_, tr)) in enumerate(zip(lb, lp, lr)):
            if grad[i] < 1e-3 * gmed:
                continue
            dp = float(torch.linalg.norm((tp.double() - tb.double()).reshape(-1)))
            dr = float(torch.linalg.norm((tr.double() - tb.double()).reshape(-1)))
            rows.append((name, dp, dr))
        if rows:
            med = float(np.median([dr for _, _, dr in rows]))
            for name, dp, dr in rows:
                move = max(move, abs(dp - dr) / max(dr, med, 1e-30))
        pose = max(pose, float(np.abs(p["kf_est_after"][:, :3, 3]
                                      - r["kf_est_after"][:, :3, 3]).max(initial=0.0)))
        if p["new_c2w"] is not None and r["new_c2w"] is not None:
            pose = max(pose, _max_abs(torch.as_tensor(np.asarray(p["new_c2w"]))[:3, 3],
                                      torch.as_tensor(np.asarray(r["new_c2w"]))[:3, 3]))
    return {"map_loss": loss, "map_move": move, "map_pose_m": pose}


def follow(capture: Capture, reference: Reference) -> Dict[str, List[Dict]]:
    """Run the reference over every checked call."""
    out = {"tracks": [reference.track(r) for r in capture.tracks]}
    out["maps"] = [reference.map(r) for r in capture.maps]
    return out


def numbers(capture: Capture, followed: Dict[str, List[Dict]], with_frames: bool = True):
    out = {}
    if with_frames:
        out["frames"] = compare_frames(capture.tracks, followed["tracks"])
    out.update(compare_tracks(capture.tracks, followed["tracks"]))
    out.update(compare_decodes(capture.tracks, followed["tracks"]))
    out.update(compare_eventnet(capture.tracks, followed["tracks"]))
    if capture.maps:
        out.update(compare_maps(capture.maps, followed["maps"], capture.maps))
    return out


# -- the control -----------------------------------------------------------------

def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a tensor (amax to 448)."""
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _Fp8(torch.autograd.Function):
    """An operand in fp8, as the bf16 path has it in bf16: the value
    rounded forward, the cotangent rounded backward, each with its own
    scale."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


@contextlib.contextmanager
def control(track: bool):
    """The reference one precision below the configuration: in tracking
    (``track``, the packed decode) the grid rows and every MLP product's
    operands rounded to fp8 in place of bf16; everywhere the float32
    products and convolutions in TF32."""
    from portbench.reference.models import decoders as rd

    saved = (rd._bf16_matmul, rd.pack_corner_grid,
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    if track:
        pack = saved[1]
        rd._bf16_matmul = lambda a, b: _fp8(a) @ _fp8(b)
        rd.pack_corner_grid = lambda grid, dtype=torch.bfloat16: _round_fp8(
            pack(grid, torch.float32))
    try:
        yield
    finally:
        (rd._bf16_matmul, rd.pack_corner_grid,
         torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = saved


def follow_control(capture: Capture, reference: Reference) -> Dict[str, List[Dict]]:
    """The control over every checked call: fp8 tracking where the
    configuration's tracking decode is the bf16 kernel (NICE on the card),
    TF32 for every float32 product and convolution."""
    with control(track=reference.packed):
        tracks = [reference.track(r) for r in capture.tracks]
    with control(track=False):
        maps = [reference.map(r) for r in capture.maps]
    return {"tracks": tracks, "maps": maps}


def control_numbers(capture: Capture, followed, lowered) -> Dict[str, float]:
    """The numbers with the control in the program's place."""
    prog_tracks = [dict(c, c2w=l["c2w"], losses=l["losses"],
                        steps=[(g, b, a) for g, (_, b, a) in zip(l["grads"], c["steps"])])
                   for c, l in zip(capture.tracks, lowered["tracks"])]
    prog_maps = [dict(c, new_grids=l["new_grids"], new_decoders=l["new_decoders"],
                      new_c2w=l["new_c2w"], kf_est_after=l["kf_est_after"], loss=l["loss"])
                 for c, l in zip(capture.maps, lowered["maps"])]
    out = compare_tracks(prog_tracks, followed["tracks"])
    out.update(compare_decodes(
        [{"decode": [dict(d, out=l["out"], **({"g_p": l["g_p"]} if "g_p" in l else {}))
                     for d, l in zip(c.get("decode", []), lt["decode"])]}
         for c, lt in zip(capture.tracks, lowered["tracks"])],
        followed["tracks"]))
    out.update(compare_eventnet(
        [{"eventnet": [dict(e, out=l["out"], **({"g_img2": l["g_img2"]} if "g_img2" in l else {}))
                       for e, l in zip(c.get("eventnet", []), lt["eventnet"])]}
         for c, lt in zip(capture.tracks, lowered["tracks"])],
        followed["tracks"]))
    if prog_maps:
        out.update(compare_maps(prog_maps, followed["maps"], capture.maps))
    return out


def verdict(nums: Dict[str, float], lims: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number with a limit against
    it; a compared number that the run did not produce fails."""
    rows = [(k, nums.get(k, float("nan")), lim) for k, lim in lims.items()]
    ok = bool(rows) and all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
