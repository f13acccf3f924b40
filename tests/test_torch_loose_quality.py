"""The port's ``tools/loose_quality.py`` against the JAX package's: the
configuration it builds, and its three rows run through ``main`` on eight
CPU slots over 6 frames at 64x80 with one seed (mapping and tracking
iterations cut through the configuration the rows are built from, as
``test_torch_tools.py`` cuts ``validate_synthetic``'s)."""

import json

from evennicer_slam_tpu.tools import loose_quality as jlq
from evennicer_slam_tpu_torch.tools import loose_quality as tlq
from torch_parity import cap_threads

cap_threads()


def test_build_cfg_equals_the_jax_tools(tmp_path):
    got = tlq.build_cfg(str(tmp_path / "scene"), 6, 3)
    want = jlq.build_cfg(str(tmp_path / "scene"), 6, 3)
    assert got == want


def test_three_rows_run_and_the_loose_row_runs_concurrently(tmp_path, monkeypatch):
    build = tlq.build_cfg

    def cut(scene_dir, frames, seed):
        cfg = build(scene_dir, frames, seed)
        cfg["mapping"].update(iters_first=12, iters=6, pixels=120)
        cfg["tracking"].update(iters=3, pixels=60)
        return cfg

    monkeypatch.setattr(tlq, "build_cfg", cut)
    out = str(tmp_path / "lq.json")
    res = tlq.main(["--frames", "6", "--seeds", "0", "--device", "cpu", "--out", out,
                    "--scene", str(tmp_path / "scene")])
    with open(out) as f:
        assert json.load(f) == res
    assert list(res["configs"]) == ["strict5", "strict7", "loose"]
    for name, row in res["configs"].items():
        assert len(row["runs"]) == 1 and 0.0 <= row["ate_rmse_mean_m"] < 0.5, name
    loose = res["configs"]["loose"]["runs"][0]
    assert loose["concurrent"] and loose["n_maps"] >= 2 and loose["n_frames"] == 6
