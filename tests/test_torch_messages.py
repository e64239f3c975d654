"""The port's control-plane messages (``dlrover_tpu_torch/common/
messages.py``) against the reference's (``dlrover_tpu/common/
messages.py``): for every ported type, with seeded field values, the
port's bytes equal the reference's ``serialize`` and each package decodes
the other's bytes; the port's registry is the training wire the reference
servicer's table names, plus the serving fleet's messages (serving slice
3), with the reference's fields and defaults."""

import dataclasses
import random

import pytest
import torch

from dlrover_tpu.common import messages as R
from dlrover_tpu.master.servicer import MasterServicer as RServicer
from dlrover_tpu_torch.common import messages as P

PORTED = sorted(n for n in P._REGISTRY)
#: The slices that bring the rest of the reference's wire.
LATER = ("Serve", "Replica", "Cell", "Fleet", "Reshard", "KvSegment",
         "Draft", "Embedding", "Obs")
#: The serving fleet's messages (reference ``common/messages.py:665-970``),
#: ported with serving slice 3; its gateway dispatches them, not the
#: master's servicer.
SERVING = {"ServeSubmit", "ServeAck", "ServeStatusRequest",
           "ServeStatusReply", "ServeReplicaRegister",
           "ServeReplicaDeregister", "ServeReplicaPoll", "ServeGrants",
           "ServeTokens", "ServeDone", "ServeKvReady", "KvSegmentFetch",
           "KvSegmentData", "DraftRoll", "DraftProposals", "ServeKvReject",
           "ServeDrainRequest", "ServeFleetStatsRequest",
           "ServeFleetStats"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _value(tp, rng: random.Random, depth: int = 0):
    """A seeded value of annotation ``tp`` (a string: the modules use
    ``from __future__ import annotations``)."""
    if tp == "bool":
        return rng.random() < 0.5
    if tp == "int":
        return rng.choice([0, 1, -1, 127, 128, -33, 65535, 1 << 40,
                           -(1 << 40), rng.randrange(-10 ** 6, 10 ** 6)])
    if tp == "float":
        return rng.choice([0.0, -1.5, 1e-300, rng.uniform(-1e6, 1e6)])
    if tp == "str":
        n = rng.choice([0, 1, 31, 32, 300])
        return "".join(rng.choice("abcxyz_-/é漢") for _ in range(n))
    if tp == "bytes":
        return bytes(rng.randrange(256) for _ in range(
            rng.choice([0, 3, 255, 256, 70000])))
    if tp == "dict":
        # Maps as the control plane sends them: str and int keys, nested
        # scalars, lists and maps (a rendezvous world is int -> dict).
        return {0: {"node_id": rng.randrange(9), "host": "127.0.0.1",
                    "coordinator_port": rng.randrange(1 << 16)},
                "k": [1, 2.5, "s", None, True], "b": b"\x00\xff",
                17: -3} if depth == 0 else {"x": 1}
    if tp.startswith("List["):
        inner = tp[5:-1]
        n = rng.choice([0, 1, 3, 17])
        if inner in P._REGISTRY:
            return [_message(P._REGISTRY[inner], rng, depth + 1)
                    for _ in range(n)]
        return [_value(inner, rng, depth + 1) for _ in range(n)]
    raise AssertionError(f"no generator for {tp}")


def _message(cls, rng: random.Random, depth: int = 0):
    return cls(**{f.name: _value(f.type, rng, depth)
                  for f in dataclasses.fields(cls)})


def _as_reference(msg):
    """The reference's message with the same field values."""
    cls = R._REGISTRY[type(msg).__name__]
    kw = {}
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if isinstance(v, list) and v and isinstance(v[0], P.Message):
            v = [_as_reference(x) for x in v]
        kw[f.name] = v
    return cls(**kw)


def test_registry_is_the_training_wire():
    table = {c.__name__ for c in RServicer(
        rdzv_managers={})._dispatch}
    later = {n for n in table if n.startswith(LATER)}
    replies = {"BaseResponse", "Empty", "DiagnosisAction",
               "HeartbeatResponse", "RendezvousRound", "CommWorld",
               "WaitingNodeNum", "KVStoreValue", "KVStoreMultiValue",
               "KVStoreCount", "KVStoreScanResult", "Task", "FaultNodes",
               "Stragglers", "ElasticRunConfig", "ParallelConfig",
               "JournalChunk"}
    assert set(PORTED) == (table - later) | replies | SERVING
    assert set(PORTED) <= set(R._REGISTRY)


@pytest.mark.parametrize("name", PORTED)
def test_fields_and_defaults_are_the_references(name):
    p, r = P._REGISTRY[name], R._REGISTRY[name]

    def spec(cls):
        return [(f.name, f.type, f.default if f.default is not
                 dataclasses.MISSING else f.default_factory())
                for f in dataclasses.fields(cls)]

    assert spec(p) == spec(r)
    assert p._WIRE_OPTIONAL == r._WIRE_OPTIONAL
    assert P.serialize(p()) == R.serialize(r())


@pytest.mark.parametrize("name", PORTED)
def test_bytes_equal_and_decode_both_ways(name):
    rng = random.Random(f"msg-{name}")
    for _ in range(4):
        msg = _message(P._REGISTRY[name], rng)
        ref = _as_reference(msg)
        data = P.serialize(msg)
        assert data == R.serialize(ref)
        assert P.deserialize(R.serialize(ref)) == msg
        assert R.deserialize(data) == ref


def test_a_bad_payload_does_not_decode():
    for bad in (b"", b"\xc1", P.serialize(P.Empty())[:-1] + b"\xc1",
                R.serialize(R.ReplicaFetch())):
        with pytest.raises((ValueError, KeyError)):
            P.deserialize(bad)


def test_wire_optional_fields_are_left_out_when_empty():
    @dataclasses.dataclass
    class _Probe(P.Message):
        a: int = 0
        trace: dict = dataclasses.field(default_factory=dict)
        _WIRE_OPTIONAL = frozenset({"trace"})

    try:
        assert P.serialize(_Probe(a=1)) == R.msgpack.packb(
            {"__msg__": "_Probe", "f": {"a": 1}}, use_bin_type=True)
        full = P.serialize(_Probe(a=1, trace={"id": "x"}))
        assert P.deserialize(full) == _Probe(a=1, trace={"id": "x"})
        assert P.deserialize(P.serialize(_Probe(a=2))) == _Probe(a=2)
    finally:
        del P._REGISTRY["_Probe"]
