"""Shared helpers of the ``test_torch_*`` files: they hold the PyTorch port
(``evennicer_slam_tpu_torch``) against the JAX package on the CPU. Inputs are
made with numpy from a seed and handed to both; weights are made by the JAX
package and carried across with the port's ``convert`` module."""

import numpy as np
import torch

from evennicer_slam_tpu_torch import convert


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
