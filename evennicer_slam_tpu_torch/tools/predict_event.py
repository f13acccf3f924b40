"""Standalone EventNet prediction (counterpart of
``evennicer_slam_tpu/tools/predict_event.py``): load a trained 2-head UNet
(the JAX package's ``.npz`` or the reference's torch ``.pth``), feed it a
pair of intensity images, and write the predicted event image and the
binary existence mask as PNGs.

Without OpenCV: the images are read by ``data/datasets.py::read_image``
(PNG or JPEG by their magic bytes, RGB as ``cv2.imread`` + ``BGR2RGB`` gives
them), scaled by ``ops/resize.py::resize_bilinear`` and written by
``data/png.py``. Runs on the CUDA device unless ``--device cpu`` is given.

Usage:
    python -m evennicer_slam_tpu_torch.tools.predict_event \
        --model pretrained/eventnet_mapdomain.npz -img1 a.png -img2 b.png \
        [--scale 0.5] [--mask-threshold 0.5] [--event out_event.png] \
        [--binary out_mask.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def event_to_image(event: np.ndarray) -> np.ndarray:
    """[-, +] polarity channels -> RGB uint8 (negative red, positive green),
    counts x 50."""
    h, w = event.shape[:2]
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = np.clip(event[..., 0] * 50, 0, 255).astype(np.uint8)
    img[..., 1] = np.clip(event[..., 1] * 50, 0, 255).astype(np.uint8)
    return img


def mask_to_image(mask: np.ndarray) -> np.ndarray:
    return (np.clip(mask, 0, 1) * 255).astype(np.uint8)


def load_model(path: str, device=None):
    """EventNet weights from ``.npz`` or a torch ``.pth`` on ``device``."""
    from evennicer_slam_tpu_torch.models.eventnet import load_eventnet_npz, load_eventnet_torch

    load = load_eventnet_npz if path.endswith(".npz") else load_eventnet_torch
    return load(path, device=device)


def predict(model, img1: np.ndarray, img2: np.ndarray, scale: float, threshold: float):
    """(event [h, w, 2], binary mask [h, w]) at ``scale`` x the input size,
    as numpy; the net runs on the device its weights lie on."""
    from evennicer_slam_tpu_torch.models.eventnet import inference_event
    from evennicer_slam_tpu_torch.ops.resize import resize_bilinear

    dev = model["inc"]["w1"].device
    hw = (int(img1.shape[0] * scale), int(img1.shape[1] * scale))

    def prep(img):
        return resize_bilinear(torch.from_numpy(np.asarray(img, np.float32)).to(dev) / 255.0,
                               hw)

    with torch.no_grad():
        event, mask = inference_event(model, prep(img1), prep(img2))  # mask: [1, h, w, 2]
    binary = mask[0, ..., 1].cpu().numpy() > threshold
    return event.cpu().numpy(), binary.astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Predict event images from an intensity-image pair")
    parser.add_argument("--model", "-m", required=True)
    parser.add_argument("--input1", "-img1", required=True)
    parser.add_argument("--input2", "-img2", required=True)
    parser.add_argument("--event", "-e", default=None,
                        help="output event PNG (default <img1>_<img2>_event.png)")
    parser.add_argument("--binary", "-b", default=None,
                        help="output binary mask PNG")
    parser.add_argument("--mask-threshold", "-t", type=float, default=0.5)
    parser.add_argument("--scale", "-s", type=float, default=0.5)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    from evennicer_slam_tpu_torch.data.datasets import read_image
    from evennicer_slam_tpu_torch.data.png import write_png
    from evennicer_slam_tpu_torch.utils.runtime import resolve_device, setup_torch

    stem = (os.path.splitext(os.path.basename(args.input1))[0] + "_"
            + os.path.splitext(os.path.basename(args.input2))[0])
    event_file = args.event or f"{stem}_event.png"
    binary_file = args.binary or f"{stem}_binary.png"

    imgs = []
    for path in (args.input1, args.input2):
        try:
            imgs.append(read_image(path))
        except (OSError, ValueError) as e:
            raise SystemExit(f"cannot read image {path}: {e}")
    device = resolve_device(None if args.device == "cuda" else args.device)
    if device.type == "cuda":
        setup_torch(verbose=False)
    model = load_model(args.model, device)
    event, binary = predict(model, *imgs, args.scale, args.mask_threshold)

    write_png(event_file, event_to_image(event))
    write_png(binary_file, mask_to_image(binary))
    print(f"event saved to {event_file}")
    print(f"binary mask saved to {binary_file}")


if __name__ == "__main__":
    main()
