"""The yardstick's counts on the CPU: the decode's work as a function, the
step's arithmetic, iMAP's products, EventNet's convolutions."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import work
from portbench.reference.models import decoders as rd
from portbench.reference.models import eventnet as re


def _mlp_flops(params, n):
    """FLOPs of ``n`` points through one MLP, counted by torch."""
    p = torch.randn(n, 3)
    feat = None
    if "fc_w" in params:
        feat = torch.randn(n, params["fc_w"][0].shape[0])
    with FlopCounterMode(display=False) as fc:
        rd._mlp_forward(params, p, feat)
    return fc.get_total_flops()


def test_nice_products_match_the_decoders():
    dec = rd.init_nice_decoders(torch.Generator().manual_seed(0), 32, 32, coarse=True,
                                device="cpu")
    prods = work.nice_products(32, 32)
    for name in ("middle", "fine", "color"):
        assert work.flops_of(prods[name]) * 7 == _mlp_flops(dec[name], 7), name
    with FlopCounterMode(display=False) as fc:
        rd._mlp_no_xyz_forward(dec["coarse"], torch.randn(5, 32))
    assert work.flops_of(prods["coarse"]) * 5 == fc.get_total_flops()


def test_stage_flops_split_embedding_from_products():
    emb, other = work.nice_point_flops(32, 32, "color")
    prods = work.nice_products(32, 32)
    assert emb == 3 * 2 * 3 * work.EMBEDDING
    assert emb + other == sum(work.flops_of(prods[n]) for n in ("middle", "fine", "color"))
    assert work.nice_point_flops(32, 32, "coarse")[0] == 0


def test_imap_products():
    mlp = rd.init_imap_decoder(torch.Generator().manual_seed(0), device="cpu")["imap"]
    assert work.imap_point_flops() == 2 * (3 * 93 + 93 * 256 + 3 * 256 * 256 + 256 * 4)
    assert work.imap_point_flops() * 9 == _mlp_flops(mlp, 9)


def test_eventnet_flops_match_torch_count():
    params = re.init_eventnet(torch.Generator().manual_seed(0), device="cpu")
    h, w = 32, 48
    with FlopCounterMode(display=False) as fc:
        re.eventnet_forward(params, torch.rand(1, h, w, 6))
    counted = sum(v for k, v in fc.get_flop_counts()["Global"].items()
                  if "convolution" in str(k))
    assert work.eventnet_forward_flops(h, w) == counted


def test_decode_work_counts_the_function_not_the_gathered_rows():
    verts = {"middle": 1000, "fc": 4000}
    fwd = work.decode_forward_work(10_000, verts, 32, 32)
    emb, other = work.nice_point_flops(32, 32, "color")
    assert fwd["f32"] == 10_000 * emb and fwd["bf16"] == 10_000 * other
    weights = work.nice_weight_bytes(32, 32)
    # coordinates in, [N, 4] out, each touched vertex once in bf16, weights once
    assert fwd["bytes"] == 10_000 * (12 + 16) + 1000 * 64 + 4000 * 128 + weights
    bwd = work.decode_backward_work(10_000, verts, 32, 32)
    # the incoming gradient and the coordinate gradient on top of the inputs
    assert bwd["bytes"] == fwd["bytes"] + 10_000 * 12
    # the per-point corner rows (1,536 bytes a point) are not counted
    assert fwd["bytes"] < 10_000 * 1536


def test_least_seconds_takes_the_larger_bound():
    compute = {"bf16": 989e12, "f32": 67e12, "bytes": 0.0}
    assert abs(work.least_seconds(compute) - 2.0) < 1e-12
    memory = {"bf16": 0.0, "bytes": 3.35e12 * 3}
    assert abs(work.least_seconds(memory) - 3.0) < 1e-12


def test_step_mfu_reader_sums_each_precision_at_its_peak():
    from portbench import cells

    read = cells.reader("step_mfu")
    r = {"flops": {"bf16": 989e12 * 0.5, "f32": 67e12 * 0.25}, "window_s": 10.0}
    assert abs(read(r) - 7.5) < 1e-9
    assert read({"flops": {}, "window_s": 10.0}) is None
