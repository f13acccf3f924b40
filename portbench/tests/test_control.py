"""The control on the card, at each cell's own size: the reference one
precision below the configuration, put in the program's place, fails the
check on every seed, while the program passes. Needs a CUDA card; run it
there with ``python3 -m pytest portbench/tests/test_control.py -m cuda``
(three seeds a cell, a few minutes each)."""

import pytest

from portbench import cells, check
from portbench.readings import read_seed

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["nice.event_k5", "imap.rgbd", "nice.rgbd_k5"])
def test_control_fails_and_program_passes(cell, card, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    w = cells.workload(cells.load_benchmark(), cell)
    for seed in SEEDS:
        line = read_seed(w, seed, control=True)
        sound_ok, _ = check.verdict(line["sound"], check.limits(cell))
        control_ok, rows = check.verdict(line["control"], check.limits(cell))
        assert sound_ok, line
        assert not control_ok, rows
