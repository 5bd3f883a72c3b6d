"""The hop between pipe ranks (``repro_torch.core.p2p``) in one process.

``P2PHop`` speaks to ``torch.distributed`` through four calls; here two
hops (ranks 0 and 1) share an in-process stand-in for them, which matches
each message by (source, destination, tag) in order, as gloo does.  That
reaches the message protocol without spawning: every dtype and shape
round trips bitwise into fresh tensors, the layout header goes once per
(stream, source, stage) and again when the layout changes, each payload
class counts its hops and bytes, the mpmd register latches and posts
where it is told, and every disagreement between plan and payloads
raises.  ``LocalHop``, the in-process default, is held to the same
refusals.  Under grad (``p2p.Backprop``) a payload's cotangent comes back
to its sender bitwise what one process's autograd gives, an arrival
nothing used sends an empty one, and cotangents that land before they
are asked for wait in their slot.  The executors across real gloo ranks
are in ``tests/test_torch_dist.py``.
"""
from collections import defaultdict, deque

import pytest
import torch

from repro_torch.core import p2p


class _Done:
    def wait(self):
        return True


class FakeNet:
    """Messages in flight, by (source, destination, tag), in order."""

    def __init__(self):
        self.queues = defaultdict(deque)
        self.sent = []                       # (src, dst, tag, message)

    def view(self, rank):
        return _RankView(self, rank)


class _RankView:
    def __init__(self, net, rank):
        self.net, self.rank = net, rank

    def isend(self, tensor, dst, group=None, tag=0):
        msg = tensor.clone()
        self.net.queues[(self.rank, dst, tag)].append(msg)
        self.net.sent.append((self.rank, dst, tag, msg))
        return _Done()

    def irecv(self, tensor, src, group=None, tag=0):
        msg = self.net.queues[(src, self.rank, tag)].popleft()
        assert msg.dtype == tensor.dtype and msg.shape == tensor.shape
        tensor.copy_(msg)
        return _Done()


def _pair(executor="spmd"):
    """Hops for ranks 0 and 1 of a two-rank group, on one fake network."""
    net = FakeNet()
    hops = []
    for r in (0, 1):
        hop = p2p.P2PHop(p2p.PipeGroup(r, 2, torch.device("cpu")), executor)
        hop.dist = net.view(r)
        hops.append(hop)
    return net, hops


def _value(dtype, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape,
                         generator=g, dtype=torch.int64).to(dtype)


DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
          torch.int8, torch.uint8, torch.int32, torch.int64, torch.bool]
SHAPES = [(), (0,), (3, 5), (2, 3, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_leaf_round_trips_bitwise_into_a_fresh_tensor(dtype, shape):
    net, (a, b) = _pair()
    x = _value(dtype, shape)
    a.put("f", 0, 1, (3, 1), {"h": x}, None)
    tag, wire, proto = b.take("f", 0, 1, expect=True)
    got = wire["h"]
    assert tag == (3, 1) and proto is None
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got.reshape(-1).view(torch.uint8),
                       x.reshape(-1).view(torch.uint8))
    assert got._base is None and got.storage_offset() == 0
    a.finish()
    b.finish()


def test_int8_wire_tree_and_proto_round_trip():
    """An int8-ef payload: blocks and scales, and the proto its arrival
    decodes to (meta tensors of the value's shape and dtype)."""
    net, (a, b) = _pair()
    wire = {"h": {"q": _value(torch.int8, (12, 256)),
                  "s": _value(torch.float32, (12, 1))}}
    proto = {"h": torch.empty((2, 16, 96), dtype=torch.bfloat16,
                              device="meta")}
    a.put("b", 0, 1, (0, 0), wire, proto)
    tag, got, got_proto = b.take("b", 0, 1, expect=True)
    assert torch.equal(got["h"]["q"], wire["h"]["q"])
    assert torch.equal(got["h"]["s"], wire["h"]["s"])
    p = got_proto["h"]
    assert (p.device.type, p.dtype, tuple(p.shape)) == (
        "meta", torch.bfloat16, (2, 16, 96))
    st = a.stats["cotangent"]
    assert (st["hops"], st["bytes"]) == (1, 12 * 256 + 12 * 4)


def _headers(net, tag):
    """Layout headers sent on ``tag``: the byte messages that hold the
    JSON layout (a payload of ones holds no ``{``)."""
    return sum(1 for _, _, t, m in net.sent
               if t == tag and m.dtype == torch.uint8 and m.numel()
               and bytes(m[:9].tolist()) == b'{"wire": ')


def test_layout_header_once_per_stream_source_and_stage():
    net, (a, b) = _pair()
    tag = p2p._stream_tag("f")
    x = torch.ones(2, 3)
    for micro in range(3):                        # one stage: one header
        a.put("f", 0, 1, (micro, 1), {"h": x}, None)
        b.take("f", 0, 1, expect=True)
    assert _headers(net, tag) == 1
    a.put("f", 0, 1, (0, 3), {"h": x}, None)      # another stage
    b.take("f", 0, 1, expect=True)
    assert _headers(net, tag) == 2
    a.put("f", 0, 1, (1, 3), {"h": torch.ones(4, 3)}, None)   # new layout
    assert b.take("f", 0, 1, expect=True)[1]["h"].shape == (4, 3)
    assert _headers(net, tag) == 3


@pytest.mark.parametrize("stream, cls", [
    ("f", "chain"), ("b", "cotangent"), ("g:mem@2", "cotangent"),
    ("r:mem@2", "portal"), ("s", "stream"), ("embed", "embed"),
    ("tok", "token")])
def test_each_stream_counts_under_its_class(stream, cls):
    net, (a, b) = _pair()
    value = {"x": torch.zeros(5, 7), "n": torch.zeros(3, dtype=torch.int64)}
    for _ in range(2):
        a.put(stream, 0, 1, (0, 1), value, None)
        b.take(stream, 0, 1, expect=True)
    assert p2p.payload_class(stream) == cls
    assert {c: (s["hops"], s["bytes"]) for c, s in a.stats.items()} == {
        c: ((2, 2 * (5 * 7 * 4 + 3 * 8)) if c == cls else (0, 0))
        for c in p2p.CLASSES}
    assert b.stats[cls]["hops"] == 0         # the receiver sends nothing


def test_streams_do_not_cross():
    """Two streams between one pair of ranks, received in the other order
    than they were sent: each takes its own payload."""
    net, (a, b) = _pair()
    a.put("f", 0, 1, (0, 1), {"h": torch.full((2,), 1.0)}, None)
    a.put("r:mem@1", 0, 1, (0, 1), {"m": torch.full((3,), 2.0)}, None)
    assert torch.equal(b.take("r:mem@1", 0, 1, True)[1]["m"],
                       torch.full((3,), 2.0))
    assert torch.equal(b.take("f", 0, 1, True)[1]["h"],
                       torch.full((2,), 1.0))


def test_mpmd_latches_until_posted():
    net, (a, b) = _pair("mpmd")
    a.put("f", 0, 1, (0, 1), {"h": torch.ones(2)}, None)
    assert not net.sent                      # latched, not sent
    with pytest.raises(RuntimeError, match="latched twice"):
        a.put("f", 0, 1, (1, 1), {"h": torch.ones(2)}, None)
    with pytest.raises(RuntimeError, match="does not ship"):
        a.check_posted(1)
    a.post("f")
    assert net.sent
    a.check_posted(1)
    assert b.take("f", 0, 1, True)[0] == (0, 1)
    with pytest.raises(RuntimeError, match="nothing was latched"):
        a.post("f")


def test_mpmd_finish_refuses_a_latched_payload():
    net, (a, b) = _pair("mpmd")
    a.put("b", 0, 1, (0, 0), {"h": torch.ones(2)}, None)
    with pytest.raises(RuntimeError, match="does not ship"):
        a.finish()


def test_same_rank_payload_stays_in_the_local_outbox():
    net, (a, b) = _pair("mpmd")
    x = {"m": torch.arange(4.0)}
    a.put("r:mem@2", 0, 0, (1, 2), x, None)   # both ends on rank 0
    assert not net.sent
    a.check_posted(0)                         # not latched either
    tag, wire, _ = a.take("r:mem@2", 0, 0, expect=True)
    assert tag == (1, 2) and wire is x
    with pytest.raises(RuntimeError, match="two values reach rank 0"):
        a.put("r:mem@2", 0, 0, (2, 2), x, None)
        a.put("r:mem@2", 0, 0, (3, 2), x, None)


@pytest.mark.parametrize("expect", [True, False])
def test_local_arrival_must_match_the_plan(expect):
    net, (a, b) = _pair()
    if not expect:
        a.put("f", 0, 0, (0, 0), {"h": torch.ones(1)}, None)
    with pytest.raises(RuntimeError, match="expects an arrival nobody "
                       "shipped" if expect else "has no slot"):
        a.take("f", 0, 0, expect=expect)


def test_no_expected_remote_arrival_receives_nothing():
    net, (a, b) = _pair()
    assert b.take("f", 0, 1, expect=False) is None
    assert not net.sent


def test_ships_only_for_its_own_rank():
    net, (a, b) = _pair()
    with pytest.raises(RuntimeError, match="ships for rank 1"):
        a.put("f", 1, 0, (0, 0), {"h": torch.ones(1)}, None)


def test_payload_without_its_layout_raises():
    net, (a, b) = _pair()
    a.put("f", 0, 1, (0, 1), {"h": torch.ones(2)}, None)
    b.take("f", 0, 1, True)
    b.recv_layouts.clear()                    # a receiver that lost it
    a.put("f", 0, 1, (1, 1), {"h": torch.ones(2)}, None)
    with pytest.raises(RuntimeError, match="without its layout"):
        b.take("f", 0, 1, True)


def test_payload_that_does_not_fill_its_layout_raises():
    net, (a, b) = _pair()
    a.put("f", 0, 1, (0, 1), {"h": torch.ones(2)}, None)
    b.take("f", 0, 1, True)
    # the receiver holds a layout of 3 floats, the sender sends 2 and no
    # header (it sent that layout before)
    b.recv_layouts[("f", 0, 1)] = {"wire": {"h": ["float32", [3]]},
                                   "proto": None}
    a.put("f", 0, 1, (1, 1), {"h": torch.ones(2)}, None)
    with pytest.raises(RuntimeError, match="do not fill its layout"):
        b.take("f", 0, 1, True)


def test_unknown_dtype_in_a_layout_raises():
    with pytest.raises(ValueError, match="unknown dtype"):
        p2p._layout_leaves({"h": ["complex_thing", [2]]})


def test_unknown_executor_raises():
    with pytest.raises(ValueError, match="unknown executor"):
        p2p.P2PHop(p2p.PipeGroup(0, 2, torch.device("cpu")), "eager")


def test_local_hop_refusals():
    hop = p2p.LocalHop(2, [torch.device("cpu")] * 2)
    hop.put("f", 0, 1, (0, 1), {"h": torch.ones(1)}, None)
    with pytest.raises(RuntimeError, match="two values reach rank 1"):
        hop.put("f", 0, 1, (1, 1), {"h": torch.ones(1)}, None)
    with pytest.raises(RuntimeError, match="never landed"):
        hop.finish()
    assert hop.take("f", 0, 1, expect=True)[0] == (0, 1)
    with pytest.raises(RuntimeError, match="expects an arrival"):
        hop.take("f", 0, 1, expect=True)
    hop.put("b", 1, 0, (0, 0), {"h": torch.ones(1)}, None)
    with pytest.raises(RuntimeError, match="has no slot"):
        hop.take("b", 1, 0, expect=False)
    hop.finish()


# ---------------------------------------------------------------------------
# autograd across the hop (p2p.Backprop)
# ---------------------------------------------------------------------------

def _grad_pair(executor="spmd"):
    net, hops = _pair(executor)
    bps = [p2p.Backprop(), p2p.Backprop()]
    for hop, bp in zip(hops, bps):
        bp.attach(hop)
    return net, hops, bps


@pytest.mark.parametrize("executor", ["spmd", "mpmd"])
def test_cotangent_comes_back_bitwise(executor):
    """Rank 0 ships ``3 w``, rank 1 differentiates ``sum(h^2 + h)`` with
    its arrival; rank 0's gradient of ``w`` equals one process's, and the
    cotangent is one hop of the payload's bytes."""
    w = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    w1 = w.clone().requires_grad_()
    u = 3 * w1
    want = torch.autograd.grad((u ** 2 + u).sum(), w1)[0]
    net, (a, b), (bp0, bp1) = _grad_pair(executor)
    w0 = w.clone().requires_grad_()
    with torch.enable_grad():
        a.put("f", 0, 1, (0, 1), {"h": 3 * w0}, None)
        if executor == "mpmd":
            a.post("f")
        h = b.take("f", 0, 1, expect=True)[1].resolve()["h"]
        assert h.requires_grad
        bp1.grad([(h ** 2 + h).sum()], [])
        got = bp0.grad([], [w0])[0]
    assert torch.equal(got, want)
    assert b.stats["cotangent"] == {"hops": 1, "bytes": 4 * 20,
                                    "wait_s": b.stats["cotangent"]["wait_s"]}


def test_unused_arrival_ships_an_empty_cotangent():
    """An arrival nothing on its rank reads runs no backward: its sender
    gets an empty cotangent and adds nothing (zeros where unused)."""
    net, (a, b), (bp0, bp1) = _grad_pair()
    w = torch.ones(3, requires_grad=True)
    v = torch.ones(2, requires_grad=True)
    with torch.enable_grad():
        a.put("f", 0, 1, (0, 1), {"h": w * 2}, None)
        b.take("f", 0, 1, expect=True)[1].resolve()
        bp1.grad([(v * 5).sum()], [v])
        assert torch.equal(bp0.grad([], [w])[0], torch.zeros(3))
    assert (b.stats["cotangent"]["hops"], b.stats["cotangent"]["bytes"]) \
        == (1, 0)


def _two_micro_pair(consume_order):
    """Rank 0 ships ``3 w`` as micro 0 and ``5 w`` as micro 1; rank 1
    reads them in ``consume_order`` and differentiates the sum of both
    squared: the engine visits the arrival read last first."""
    w = torch.randn(2, 3, generator=torch.Generator().manual_seed(1))
    net, (a, b), (bp0, bp1) = _grad_pair()
    w0 = w.clone().requires_grad_()
    with torch.enable_grad():
        for micro, k in ((0, 3), (1, 5)):
            a.put("f", 0, 1, (micro, 1), {"h": k * w0}, None)
        got = {micro: b.take("f", 0, 1, expect=True)[1]
               for micro in (0, 1)}
        h = {micro: got[micro].resolve()["h"] for micro in consume_order}
        root = (h[0] ** 2).sum() + (h[1] ** 2).sum()
    return w, w0, root, bp0, bp1, b


def test_two_micro_batches_consumed_in_order():
    """Micro 1's payload read after micro 0's, as the forward executor
    reads them: the backward ships micro 1's cotangent, then micro 0's,
    and rank 0's gradient is one process's bitwise."""
    w, w0, root, bp0, bp1, b = _two_micro_pair((0, 1))
    w1 = w.clone().requires_grad_()
    want = torch.autograd.grad(((3 * w1) ** 2).sum() + ((5 * w1) ** 2).sum(),
                               w1)[0]
    with torch.enable_grad():
        bp1.grad([root], [])
        got = bp0.grad([], [w0])[0]
    assert torch.equal(got, want)
    assert bp1.reached == 0
    assert (b.stats["cotangent"]["hops"], b.stats["cotangent"]["bytes"]) \
        == (2, 2 * 4 * 6)


def test_backward_back_to_a_later_micro_batch_raises():
    """Micro 1's payload read after micro 0's was consumed, so the engine
    reaches micro 0 first and gives micro 1's arrival up: its backward
    coming after that raises, naming the order it relied on."""
    _, _, root, _, bp1, _ = _two_micro_pair((1, 0))
    with torch.enable_grad(), \
            pytest.raises(RuntimeError, match="descending order"):
        bp1.grad([root], [])


def test_cotangents_landing_early_wait_in_their_slot():
    """The backward asks for micro 0's cotangent, micro 1's lands first:
    it waits in its slot until asked for; one asked for twice raises."""
    net, (a, b) = _pair()
    for micro in (1, 0):
        b.send_cotangent("b", 0, (micro, 1), {"0": torch.full((2,), micro)})
    assert torch.equal(a.recv_cotangent("b", 1, (0, 1))["0"],
                       torch.zeros(2, dtype=torch.int64))
    assert a.early[("b", 1)].keys() == {(1, 1)}
    with pytest.raises(RuntimeError, match="nobody asked for"):
        a.finish()
    assert torch.equal(a.recv_cotangent("b", 1, (1, 1))["0"],
                       torch.ones(2, dtype=torch.int64))
    a.finish()


def test_backprop_serves_one_call():
    _, (a, b) = _pair()
    bp = p2p.Backprop()
    bp.attach(a)
    with pytest.raises(RuntimeError, match="one forward call"):
        bp.attach(b)
    with pytest.raises(ValueError, match="carries no cotangent"):
        p2p.cotangent_stream("s")
