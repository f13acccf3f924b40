"""Checkpoints with resume (counterpart of
``evennicer_slam_tpu/utils/logger.py``).

One ``{idx:05d}.npz`` per checkpoint holds every array of the scene state
under the JAX package's key layout (``grids.<level>``,
``decoders.<mlp>.<leaf>`` with ``[i]`` for list items,
``estimate_c2w_list``, ``gt_c2w_list``, ``idx``), and
``{idx:05d}.keyframes.pkl`` the keyframe registry as numpy arrays only: each
package restores the other's checkpoints. :meth:`CheckpointLogger.restore`
resumes a run mid-sequence.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch


def _flatten_tree(tree: Any, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_tree(v, f"{prefix}.{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_tree(v, f"{prefix}[{i}]", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)


def _unflatten_into(template: Any, prefix: str, flat: Dict[str, np.ndarray], device):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, f"{prefix}.{k}", flat, device)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, f"{prefix}[{i}]", flat, device)
                              for i, v in enumerate(template))
    return torch.from_numpy(np.array(flat[prefix])).to(device)


class CheckpointLogger:
    """Writes ``{idx:05d}.npz`` checkpoints and the keyframe pickle beside
    them into ``ckpt_dir``."""

    def __init__(self, ckpt_dir: str, verbose: bool = False):
        self.ckpt_dir = ckpt_dir
        self.verbose = verbose
        os.makedirs(ckpt_dir, exist_ok=True)

    def log(self, slam, idx: int) -> str:
        flat: Dict[str, np.ndarray] = {}
        _flatten_tree(slam.grids, "grids", flat)
        _flatten_tree(slam.decoders, "decoders", flat)
        flat["estimate_c2w_list"] = slam.estimate_c2w_list
        flat["gt_c2w_list"] = slam.gt_c2w_list
        flat["idx"] = np.asarray(idx)
        path = os.path.join(self.ckpt_dir, f"{idx:05d}.npz")
        np.savez_compressed(path, **flat)
        with open(os.path.join(self.ckpt_dir, f"{idx:05d}.keyframes.pkl"), "wb") as f:
            pickle.dump(
                {
                    "keyframe_list": slam.mapper.keyframes.indices,
                    "keyframes": slam.mapper.keyframes.frames,
                    "selected_keyframes": slam.mapper.selected_keyframes or None,
                },
                f,
            )
        if self.verbose:
            print("Saved checkpoint at", path)
        return path

    @staticmethod
    def latest(ckpt_dir: str):
        ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
        return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None

    @staticmethod
    def restore(slam, path: str) -> int:
        """Load a checkpoint (of either package) into a live pipeline;
        returns the frame index to resume from (the checkpoint's idx + 1).

        Checkpoints are written right after a mapped frame, at an
        ``every_frame`` window boundary, so the transient tracker and mapper
        state is rebuilt from the checkpointed frame: the tracker's
        ``pre_gt_color`` is frame ``idx``'s colour (``Tracker.end_of_window``
        set it), the event integral has just been reset, and the mapper's
        previous colour is frame ``idx``'s (``_map_frame`` set it). The
        keyframe pickle is read with ``pickle``: restore only checkpoints
        this program wrote."""
        from evennicer_slam_tpu_torch.slam.keyframes import KeyframeStore

        dev = slam.device
        with np.load(path, allow_pickle=False) as npz:
            data = {k: npz[k] for k in npz.files}
        slam.grids = _unflatten_into(slam.grids, "grids", data, dev)
        slam.decoders = _unflatten_into(slam.decoders, "decoders", data, dev)
        slam.estimate_c2w_list = data["estimate_c2w_list"]
        slam.gt_c2w_list = np.asarray(data["gt_c2w_list"], np.float32)
        idx = int(data["idx"])
        kf_path = path.replace(".npz", ".keyframes.pkl")
        if os.path.exists(kf_path):
            with open(kf_path, "rb") as f:
                kf = pickle.load(f)
            store = KeyframeStore(device=dev)
            store.frames = kf["keyframes"]
            slam.mapper.keyframes = store
            slam.mapper.selected_keyframes = kf.get("selected_keyframes") or {}
        slam.idx = idx
        slam.mapping_idx = idx
        frame = slam.frame_reader[idx]
        slam.tracker.pre_gt_color = torch.from_numpy(np.array(frame.color)).to(dev)
        if slam.use_events:
            slam.tracker.reset_event_integration(frame.event.shape)
        slam.pre_gt_color_mapper = frame.color
        return idx + 1
