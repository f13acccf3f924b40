"""Shared helpers of the ``test_torch_*`` files: they hold the PyTorch port
(``evennicer_slam_tpu_torch``) against the JAX package on the CPU. Inputs are
made with numpy from a seed and handed to both; weights are made by the JAX
package and carried across with the port's ``convert`` module."""

import jax
import numpy as np
import torch

from evennicer_slam_tpu.core.rays import sample_pixels as j_sample_pixels
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.slam import mapper as tm


def cap_threads():
    """One torch thread per test process: the suite runs on several workers."""
    torch.set_num_threads(1)


def jax_to_np(tree):
    """A JAX pytree of dicts / lists / tuples -> the same nesting of numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_to_np(v) for v in tree]
    return np.asarray(tree)


def to_torch(tree):
    """JAX pytree -> the port's nested dicts of CPU tensors."""
    return convert.tree_from_numpy(jax_to_np(tree), device="cpu")


def t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def assert_close(got, want, atol, rtol=0.0, msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


# ---- the JAX package's random draws, handed to the port -----------------------------

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


def jax_regulation_draws(seed, stage, n, rays, n_samples):
    """The JAX mapper's free-space regulation jitter of a stage's n
    iterations, as the port takes it: [n, rays, n_samples] (``_map_loss``
    folds 1 into the iteration's key)."""
    out = []
    for it in range(n):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                                                    np.int32(tm.STAGE_IDS[stage])), np.int32(it))
        out.append(np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (rays, n_samples))))
    return torch.from_numpy(np.stack(out))


class JaxDrawsMapper(tm.Mapper):
    """The port's mapper with the JAX package's pixel, regulation and
    selection draws."""

    def _draw_pixels(self, seed, stage, term, n, K, pix):
        return jax_map_draws(seed, stage, n, K, pix, self.cam.H * self.cam.W, bool(term))

    def _draw_regulation(self, seed, stage, n, rays):
        return jax_regulation_draws(seed, stage, n, rays, self.settings.n_samples)

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
