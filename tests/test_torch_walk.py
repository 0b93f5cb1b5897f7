"""The walk over the graph (``models/darknet.py:walk``) that every forward
of the port runs, seen through the folded forward and the height-sharded
one: each saved value leaves ``saved`` right after its last reader and
none is left at the end; a fused run's inner layers never enter it; and
the fused forward (K2's units, SPP blocks and the routes joined in place)
and the sharded one give the layer-by-layer forward's head maps bit for
bit (float32 on the CPU).

Graphs: the mini YOLOv3 (residual units for K2's plain version, routes,
upsamples), the mini YOLOv4 of ``benchmark/tests/mini_v4.cfg`` (an SPP
block, CSP routes) and a graph of 2/2, 2/1 and 3/1 max pools.
"""

import os

import pytest
import torch

from amyloid_yolo_tpu_torch.graphspec import from_cfg
from amyloid_yolo_tpu_torch.kernels.conv_block import fused_residual_block_plain
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.parallel import spatial

from torch_port_helpers import port_mini_spec, port_pool_spec

MINI_V4 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "benchmark", "tests", "mini_v4.cfg")

GRAPHS = {"mini": (port_mini_spec, 64), "mini_v4": (lambda: from_cfg(MINI_V4), 64),
          "pools": (lambda: port_pool_spec(24), 24)}


def _recording_walk(monkeypatch, calls, left):
    """Replace ``darknet.walk`` by one that records ``(start, end, keys of
    saved)`` at each step or run and what ``saved`` holds at the end."""
    real = darknet.walk

    def rec(start, end, fn):
        def call(*args):
            calls.append((start, end, frozenset(args[-1])))
            return fn(*args)
        return call

    def walk(spec, step, prev, saved, **kw):
        runs = {i: (end, rec(i, end, fn))
                for i, (end, fn) in (kw.pop("runs", None) or {}).items()}
        out = real(spec, lambda i, *a: rec(i, i, step)(i, *a), prev, saved, runs=runs, **kw)
        left.append(dict(saved))
        return out

    monkeypatch.setattr(darknet, "walk", walk)


@pytest.mark.parametrize("forward", ["layers", "fused", "sharded"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_walk_frees_after_last_reader_and_fuses_runs(graph, forward, monkeypatch):
    build, size = GRAPHS[graph]
    spec = build()
    folded = darknet.fold_batchnorm(darknet.init_params(torch.Generator().manual_seed(0), spec),
                                    spec)
    x = torch.rand(2, size, size, 3, generator=torch.Generator().manual_seed(1))
    want = darknet.apply_folded(folded, spec, x, compute_dtype=torch.float32)

    runs = {}
    kw = {}
    if forward == "fused":
        packs = darknet.pack_residual_blocks(folded, spec, torch.float32)
        spp = darknet.spp_blocks(spec)
        kw = dict(packs=packs, block_fn=fused_residual_block_plain, spp=spp,
                  routes=darknet.route_slices(spec))
        runs = {**{i: i + 2 for i in packs}, **{i: b.route for i, b in spp.items()}}
        assert runs or graph == "pools"
    calls, left = [], []
    _recording_walk(monkeypatch, calls, left)
    if forward == "sharded":
        got = spatial.apply_sharded(folded, spec, x,
                                    spatial.make_spatial_mesh(2, devices=["cpu"] * 2))
    else:
        got = darknet.apply_folded(folded, spec, x, compute_dtype=torch.float32, **kw)

    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert left == [{}]
    assert [(s, e) for s, e, _ in calls if e > s] == sorted(runs.items())
    assert [s for s, _, _ in calls] == [0] + [e + 1 for _, e, _ in calls[:-1]]
    assert calls[-1][1] == len(spec.layers) - 1
    inner = {j for s, e in runs.items() for j in range(s, e)}
    for start, _, live in calls:
        assert live == {k for k in range(start) if k not in inner and spec.consumers[k]
                        and max(spec.consumers[k]) >= start}, start
