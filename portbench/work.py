"""The yardstick's arithmetic: operations and bytes of the functions the
benchmark reads rooflines of, counted from the configuration's shapes, and
the published peaks they are held against.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without
sparsity, at the full power limit of 700 W (a card set lower runs slower;
every run prints its limit beside these).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

PEAK_FLOPS = {
    "bf16": 989e12,
    "fp16": 989e12,
    "tf32": 495e12,
    "f32": 67e12,
    "fp8": 1979e12,
}
PEAK_BYTES_PER_S = 3.35e12
PEAK_POWER_W = 700.0

EMBEDDING = 93  # Fourier embedding width of the NICE and iMAP decoders


def mlp_products(in_dim: int, hidden: int, n_blocks: int, skips: Sequence[int], out_dim: int,
                 feat_dim: int = 0, embedding: bool = True) -> list:
    """(rows, cols) of every matrix product one point goes through in a NICE
    decoder MLP (``models/decoders.py::_mlp_forward``): the embedding
    ``p @ B`` [3, emb], block i's ``h @ lin_w[i]`` (the block after a skip
    takes ``hidden + emb``), block i's feature injection
    ``feat @ fc_w[i]`` when ``feat_dim``, and the head."""
    emb = in_dim
    prods = [(3, emb)] if embedding else []
    d = emb
    for i in range(n_blocks):
        prods.append((d, hidden))
        if feat_dim:
            prods.append((feat_dim, hidden))
        d = hidden + emb if i in skips else hidden
    prods.append((d, out_dim))
    return prods


def flops_of(prods: Iterable[Tuple[int, int]]) -> int:
    """Multiply-adds of a point through ``prods``, counted as 2 FLOPs each."""
    return sum(2 * r * c for r, c in prods)


def nice_products(c_dim: int, hidden: int) -> Dict[str, list]:
    """Every product of each NICE decoder for one point: middle and colour
    take ``c_dim`` features, fine ``2 c_dim`` (its own and middle's), the
    coarse decoder its feature alone (no embedding). Five blocks, a skip
    after block 2, as ``init_nice_decoders`` builds them."""
    return {
        "middle": mlp_products(EMBEDDING, hidden, 5, (2,), 1, c_dim),
        "fine": mlp_products(EMBEDDING, hidden, 5, (2,), 1, 2 * c_dim),
        "color": mlp_products(EMBEDDING, hidden, 5, (2,), 4, c_dim),
        "coarse": mlp_products(c_dim, hidden, 5, (2,), 1, 0, embedding=False),
    }


STAGE_DECODERS = {
    "coarse": ("coarse",),
    "middle": ("middle",),
    "fine": ("middle", "fine"),
    "color": ("middle", "fine", "color"),
}


def nice_point_flops(c_dim: int, hidden: int, stage: str) -> Tuple[int, int]:
    """(FLOPs of the embeddings, FLOPs of the other products) for one point
    decoded at ``stage``. The embeddings stay in float32 on every path; the
    tracker's fused decode runs the rest in bf16."""
    prods = nice_products(c_dim, hidden)
    emb = other = 0
    for name in STAGE_DECODERS[stage]:
        p = prods[name]
        if name != "coarse":
            emb += flops_of(p[:1])
            p = p[1:]
        other += flops_of(p)
    return emb, other


def imap_point_flops(hidden: int = 256, n_blocks: int = 4) -> int:
    """FLOPs of one point through iMAP's MLP: 93 -> 256 x 4 -> 4."""
    return flops_of(mlp_products(EMBEDDING, hidden, n_blocks, (), 4))


def nice_weight_bytes(c_dim: int, hidden: int, bytes_per_weight: int = 2) -> int:
    """Bytes of the decoder trio's weights as the fused decode reads them
    (bf16 products, float32 embedding matrices and biases counted at
    ``bytes_per_weight`` too: a lower bound)."""
    prods = nice_products(c_dim, hidden)
    n = 0
    for name in ("middle", "fine", "color"):
        n += sum(r * c + c for r, c in prods[name])
    return n * bytes_per_weight


def decode_forward_work(n_points: int, vertices: Dict[str, int], c_dim: int,
                        hidden: int) -> Dict[str, float]:
    """The tracking decode's forward (``nice_forward_packed``) as a function:
    read each point's coordinates (3 float32), each grid vertex the points
    touch once (``vertices``: middle and fine+colour counts; bf16 channels,
    ``c_dim`` per grid), the trio's weights; write [N, 4] float32. Returns
    FLOPs by precision and bytes."""
    emb, other = nice_point_flops(c_dim, hidden, "color")
    nbytes = (n_points * 3 * 4 + n_points * 4 * 4
              + vertices.get("middle", 0) * c_dim * 2 + vertices.get("fc", 0) * 2 * c_dim * 2
              + nice_weight_bytes(c_dim, hidden))
    return {"f32": float(n_points * emb), "bf16": float(n_points * other), "bytes": float(nbytes)}


def decode_backward_work(n_points: int, vertices: Dict[str, int], c_dim: int,
                         hidden: int) -> Dict[str, float]:
    """The same function's backward to its coordinates: read the
    coordinates, the incoming [N, 4] gradient, the touched vertices and the
    weights; write the [N, 3] coordinate gradient. Every product's input
    gradient costs what its forward costs."""
    emb, other = nice_point_flops(c_dim, hidden, "color")
    nbytes = (n_points * 3 * 4 + n_points * 4 * 4 + n_points * 3 * 4
              + vertices.get("middle", 0) * c_dim * 2 + vertices.get("fc", 0) * 2 * c_dim * 2
              + nice_weight_bytes(c_dim, hidden))
    return {"f32": float(n_points * emb), "bf16": float(n_points * other), "bytes": float(nbytes)}


def least_seconds(work: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the arithmetic at
    the peak of each precision and the bytes at the memory's peak."""
    compute = sum(v / PEAK_FLOPS[k] for k, v in work.items() if k in PEAK_FLOPS)
    return max(compute, work.get("bytes", 0.0) / PEAK_BYTES_PER_S)


# EventNet's UNet (``models/eventnet.py``): (block, in, mid, out) of each
# double 3x3 convolution, at the encoder's pooling level.
_EVENTNET_ENCODER = (("inc", 6, 64, 64, 0), ("down1", 64, 128, 128, 1),
                     ("down2", 128, 256, 256, 2), ("down3", 256, 512, 512, 3),
                     ("down4", 512, 512, 512, 4))
_EVENTNET_DECODER = (("up1", 1024, 512, 256, 3), ("up2", 512, 256, 128, 2),
                     ("up3", 256, 128, 64, 1), ("up4", 128, 64, 64, 0))


def eventnet_forward_flops(h: int, w: int) -> int:
    """FLOPs of EventNet's convolutions on one [h, w] image pair: the
    encoder, two decoder heads, each head's 1x1 output convolution. Pooling
    halves and floors each side; a decoder block runs at its skip's size."""
    sizes = [(h, w)]
    for _ in range(4):
        hh, ww = sizes[-1]
        sizes.append((hh // 2, ww // 2))
    total = 0
    for _, cin, mid, cout, lvl in _EVENTNET_ENCODER:
        hh, ww = sizes[lvl]
        total += 2 * hh * ww * 9 * (cin * mid + mid * cout)
    for _ in range(2):
        for _, cin, mid, cout, lvl in _EVENTNET_DECODER:
            hh, ww = sizes[lvl]
            total += 2 * hh * ww * 9 * (cin * mid + mid * cout)
        total += 2 * h * w * 64 * 2
    return total
