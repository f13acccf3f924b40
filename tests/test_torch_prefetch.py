"""The port's prefetching reader (``data/prefetch.py``) on the CPU device:
``get_with_device`` hands out the reader's frame bit for bit (the uint8
expansion ``u8 / 255`` in float32 equals the reader's float64 division
rounded to float32 for all 256 values), ``_compact`` equals the JAX
package's, and the decode-ahead, ``preload_device`` and ``release_device``
keep the cache as the JAX package's reader does.
"""

import threading
import types

import numpy as np
import pytest
import torch

from evennicer_slam_tpu.data import prefetch as jp
from evennicer_slam_tpu_torch.data import prefetch as tp
from evennicer_slam_tpu_torch.data import synthetic as ts
from evennicer_slam_tpu_torch.data.datasets import get_dataset
from torch_parity import cap_threads

cap_threads()

SCENE = dict(n_frames=5, H=32, W=40, fx=40.0, fy=40.0, traj_step=0.03)


class CountingReader:
    """A dataset reader that counts its reads, per frame."""

    def __init__(self, reader):
        self.reader, self.reads = reader, {}
        self.has_events = reader.has_events
        self.lock = threading.Lock()

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, idx):
        with self.lock:
            self.reads[idx] = self.reads.get(idx, 0) + 1
        return self.reader[idx]


@pytest.fixture(scope="module")
def reader(tmp_path_factory):
    frag = ts.make_synthetic_replica(str(tmp_path_factory.mktemp("scene")), **SCENE)
    return get_dataset({"dataset": frag["dataset"], "data": frag["data"], "cam": frag["cam"]})


def test_get_with_device_equals_the_readers_frame(reader):
    pre = tp.PrefetchingReader(reader, device="cpu")
    for idx in range(len(reader)):
        frame, dev = pre.get_with_device(idx)
        want = reader[idx]
        for got, ref in zip(dev, (want.color, want.depth, want.event)):
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            assert np.array_equal(got.numpy(), ref)
        assert np.array_equal(frame.color, want.color) and np.array_equal(frame.c2w, want.c2w)


def test_compact_equals_the_jax_packages(reader):
    rng = np.random.default_rng(0)
    exact = reader[2]
    off = types.SimpleNamespace(color=exact.color + 1e-3, depth=exact.depth,
                                event=exact.event)
    frac = types.SimpleNamespace(color=exact.color, depth=exact.depth,
                                 event=exact.event + rng.random(exact.event.shape,
                                                                np.float32) * 0.5)
    for f in (exact, off, frac):
        got, want = tp._compact(f), jp._compact(f)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tp._compact(exact)[3] and not tp._compact(off)[3] and not tp._compact(frac)[3]
    # an inexact frame goes up as float32 and comes back unchanged
    dev = tp._upload(frac, torch.device("cpu"), None)
    assert not dev.exact and np.array_equal(tp.expand_device_frame(dev)[2].numpy(), frac.event)


def test_decode_ahead_reads_each_frame_once(reader):
    counting = CountingReader(reader)
    pre = tp.PrefetchingReader(counting, device="cpu")
    for idx in range(len(reader)):
        pre.get_with_device(idx)
    pre._join()
    assert counting.reads == {i: 1 for i in range(len(reader))}
    # a backward sweep (event re-integration) decodes nothing ahead
    before = dict(counting.reads)
    pre[3]
    pre[2]
    pre._join()
    assert counting.reads == {**before, 3: 2, 2: 2}


def test_preload_and_release_device(reader):
    counting = CountingReader(reader)
    pre = tp.PrefetchingReader(counting, device="cpu")
    pre.preload_device(range(1, 4))
    assert sorted(pre._pinned) == [1, 2, 3] and counting.reads == {1: 1, 2: 1, 3: 1}
    for _ in range(2):  # pinned frames are not popped on read
        frame, dev = pre.get_with_device(2)
        assert np.array_equal(dev[0].numpy(), reader[2].color)
    pre._join()
    assert counting.reads[2] == 1
    pre.release_device(range(1, 4))
    assert not pre._pinned and not any(k in pre._cache for k in (1, 2, 3))
    pre.get_with_device(2)
    assert counting.reads[2] == 2


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is allowed to run")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.PrefetchingReader([])
