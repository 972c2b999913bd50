"""The port's UDP runtime (``stateright_tpu_torch/actor/spawn.py``), its
``Id`` socket addresses, ``ScriptActor``, and the Explorer's display hooks
``format_step`` and ``as_svg``, held against the JAX package's.

- ``Id.from_addr``/``to_addr``/``vec_from`` give the reference's ints;
- ``json_codec`` writes the reference's bytes for every message type of
  Paxos, single-copy-register and ABD, and reads them back;
- ``format_step`` and ``as_svg`` give the reference's strings on a 2pc and
  a Paxos witness path;
- live runs over loopback UDP: ping-pong, the Paxos cluster deciding and
  serving a read, and ABD's read seeing a write. Every port comes from
  binding port 0, every wait has a timeout and every runtime is stopped in
  a ``finally``.
"""

import socket
import threading

import pytest

from stateright_tpu.actor import Id as RefId
from stateright_tpu.actor import Out as RefOut
from stateright_tpu.actor import ScriptActor as RefScriptActor
from stateright_tpu.actor import register as ref_reg
from stateright_tpu.actor.spawn import json_codec as ref_json_codec
from stateright_tpu.actor.spawn import serialize_json as ref_serialize_json
from stateright_tpu.checker.path import Path as RefPath
from stateright_tpu.models import linearizable_register as ref_abd
from stateright_tpu.models import paxos as ref_paxos
from stateright_tpu.models import two_phase_commit as ref_2pc
from stateright_tpu_torch.actor import Id, Out, ScriptActor, StateRef
from stateright_tpu_torch.actor import register as reg
from stateright_tpu_torch.actor.spawn import (
    deserialize_json,
    json_codec,
    serialize_json,
    spawn,
)
from stateright_tpu_torch.checker.path import Path
from stateright_tpu_torch.models import linearizable_register as abd
from stateright_tpu_torch.models import paxos
from stateright_tpu_torch.models import two_phase_commit as tpc
from stateright_tpu_torch.utils.variant import variant

ADDRS = [("127.0.0.1", 3000), ("10.1.2.3", 65535), ("0.0.0.0", 0), ("255.255.255.255", 1)]


@pytest.mark.parametrize("ip, port", ADDRS)
def test_id_socket_addresses_equal_the_references(ip, port):
    i = Id.from_addr(ip, port)
    assert type(i) is Id and int(i) == int(RefId.from_addr(ip, port))
    assert i.to_addr() == (ip, port) == RefId(int(i)).to_addr()
    assert repr(i) == repr(RefId(int(i)))
    assert Id.vec_from([1, int(i)]) == [Id(1), i]
    assert all(type(x) is Id for x in Id.vec_from(range(3)))


def _messages(pkg_reg, pkg_paxos, pkg_abd, ident):
    """Every message type of Paxos, single-copy-register and ABD, built in
    one package, with ``Id``s, ballots, proposals and ``None`` inside."""
    a, b = ident(Id.from_addr("127.0.0.1", 3000)), ident(Id.from_addr("127.0.0.1", 3001))
    ballot = (2, a)
    proposal = (7, b, "X")
    p, abd_mod = pkg_paxos, pkg_abd
    internal = [
        p.Prepare(ballot), p.Prepared(ballot, None), p.Prepared(ballot, (ballot, proposal)),
        p.Accept(ballot, proposal), p.Accepted(ballot), p.Decided(ballot, proposal),
        abd_mod.Query(5), abd_mod.AckQuery(5, (1, a), "Y"), abd_mod.AckQuery(5, (0, b), None),
        abd_mod.Record(6, (3, b), "Z"), abd_mod.AckRecord(6),
    ]
    return [
        pkg_reg.Put(1, "X"), pkg_reg.Get(2), pkg_reg.PutOk(1), pkg_reg.GetOk(2, "X"),
        pkg_reg.GetOk(3, None),
    ] + [pkg_reg.Internal(m) for m in internal]


def _codec(pkg_reg, pkg_paxos, pkg_abd):
    return pkg_reg.Put, pkg_reg.Get, pkg_reg.PutOk, pkg_reg.GetOk, pkg_reg.Internal, \
        pkg_paxos.Prepare, pkg_paxos.Prepared, pkg_paxos.Accept, pkg_paxos.Accepted, \
        pkg_paxos.Decided, pkg_abd.Query, pkg_abd.AckQuery, pkg_abd.Record, pkg_abd.AckRecord


def test_json_codec_writes_the_references_bytes_for_every_message():
    ser, de = json_codec(*_codec(reg, paxos, abd))
    rser, rde = ref_json_codec(*_codec(ref_reg, ref_paxos, ref_abd))
    mine = _messages(reg, paxos, abd, Id)
    theirs = _messages(ref_reg, ref_paxos, ref_abd, RefId)
    assert len(mine) == 16
    for m, r in zip(mine, theirs):
        assert ser(m) == rser(r), m
        back = de(rser(r))
        assert back == m and type(back) is type(m)
        assert repr(rde(ser(m))) == repr(r)
    # Ids inside payloads come back as the port's Id.
    ballot = de(ser(mine[5])).msg.ballot
    assert type(ballot[1]) is Id
    # Containers the wire tags, as the reference does.
    for value in ({1, 2}, frozenset({3}), {"k": (1, 4)}, [1, [2, None]], (True, 2.5)):
        assert ser(value) == rser(value) and de(ser(value)) == value
    assert ser({"k": (1, Id(4))}) == rser({"k": (1, RefId(4))})
    with pytest.raises(TypeError, match="cannot serialize"):
        ser(object())
    assert serialize_json({"a": [1]}) == ref_serialize_json({"a": [1]})
    assert deserialize_json(b'{"a": [1]}') == {"a": [1]}


def test_script_actor_equals_the_references():
    script = [(Id(1), "a"), (Id(2), "b")]
    out, rout = Out(), RefOut()
    mine, theirs = ScriptActor(script), RefScriptActor(script)
    assert mine.on_start(Id(0), out) == theirs.on_start(RefId(0), rout) == 1
    assert repr(out) == repr(rout)
    ref = StateRef(1)
    out = Out()
    mine.on_msg(Id(0), ref, Id(1), "ack", out)
    assert (ref.get(), repr(out)) == (2, "[Send(dst=Id(2), msg='b')]")
    ref, out = StateRef(2), Out()
    mine.on_msg(Id(0), ref, Id(2), "ack", out)
    assert not ref.changed and not out.commands
    assert ScriptActor([]).on_start(Id(0), Out()) == 0


def _replay(model, ref_model, actions):
    """The port's action sequence replayed in both models from their first
    init states: ``(port pairs, reference pairs)``, each step's reference
    action found by its repr."""
    state, rstate = model.init_states()[0], ref_model.init_states()[0]
    pairs, rpairs = [], []
    for action in actions:
        racts = []
        ref_model.actions(rstate, racts)
        raction = next(a for a in racts if repr(a) == repr(action))
        pairs.append((state, action))
        rpairs.append((rstate, raction))
        state, rstate = model.next_state(state, action), ref_model.next_state(rstate, raction)
        assert repr(state) == repr(rstate)
    pairs.append((state, None))
    rpairs.append((rstate, None))
    return pairs, rpairs


@pytest.mark.parametrize("which", ["2pc", "paxos"])
def test_format_step_and_as_svg_equal_the_references(which):
    if which == "2pc":
        model, ref_model, name = tpc.TwoPhaseSys(3), ref_2pc.TwoPhaseSys(3), "commit agreement"
    else:
        model, ref_model = paxos.paxos_model(1, 3), ref_paxos.paxos_model(1, 3)
        name = "value chosen"
    path = model.checker().spawn_bfs().join().discovery(name)
    actions = [a for _, a in path.into_vec()][:-1]
    assert actions
    pairs, rpairs = _replay(model, ref_model, actions)
    for (s, a), (rs, ra) in zip(pairs[:-1], rpairs[:-1]):
        assert model.format_action(a) == ref_model.format_action(ra)
        assert model.format_step(s, a) == ref_model.format_step(rs, ra)
    svg = model.as_svg(Path(pairs))
    assert svg == ref_model.as_svg(RefPath(rpairs))
    if which == "paxos":
        assert svg.startswith("<svg") and svg.count("svg-event-line") >= len(actions) // 2
        steps = [model.format_step(s, a) for s, a in pairs[:-1]]
        assert all(st and st.startswith("OUT: ") for st in steps)
    else:
        assert svg is None


# --- live runs over loopback UDP -------------------------------------------

Ping = variant("Ping", ["n"])
Pong = variant("Pong", ["n"])


def _free_ids(n):
    """``n`` actor ids on loopback ports the system chose (port 0)."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [Id.from_addr("127.0.0.1", s.getsockname()[1]) for s in socks]
    finally:
        for s in socks:
            s.close()


def _run(serialize, deserialize, actors, done, timeout):
    handles = spawn(serialize, deserialize, actors, background=True)
    try:
        return done.wait(timeout=timeout)
    finally:
        for _thread, runtime in handles:
            runtime.stopped.set()
        # A datagram that does not deserialize wakes each receive loop, so
        # that it sees the stop at once rather than at its timeout.
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as wake:
            for _thread, runtime in handles:
                wake.sendto(b"\xff", runtime.id.to_addr())
        for thread, _runtime in handles:
            thread.join(timeout=5)
        assert not any(thread.is_alive() for thread, _ in handles)


class Ponger:
    def on_start(self, id, out):
        return 0

    def on_msg(self, id, state, src, msg, out):
        if isinstance(msg, Ping):
            out.send(src, Pong(msg.n))
            state.set(state.get() + 1)

    def on_timeout(self, id, state, timer, out):
        pass


class Pinger:
    def __init__(self, target, count, record, done):
        self.target, self.count, self.record, self.done = target, count, record, done

    def on_start(self, id, out):
        out.set_timer("kick", (0.02, 0.02))
        return 0

    def on_timeout(self, id, state, timer, out):
        if state.get() < self.count:
            out.send(self.target, Ping(state.get()))
            out.set_timer("resend", (0.4, 0.4))

    def on_msg(self, id, state, src, msg, out):
        if isinstance(msg, Pong) and msg.n == state.get():
            self.record.append(msg.n)
            state.set(msg.n + 1)
            if msg.n + 1 < self.count:
                out.send(src, Ping(msg.n + 1))
            else:
                out.cancel_timer("resend")
                self.done.set()


def test_live_ping_pong_over_loopback_udp():
    pinger, ponger = _free_ids(2)
    record, done = [], threading.Event()
    ser, de = json_codec(Ping, Pong)
    ok = _run(ser, de, [(ponger, Ponger()), (pinger, Pinger(ponger, 5, record, done))], done, 5)
    assert ok, f"ping-pong stalled; got {record!r}"
    assert record == [0, 1, 2, 3, 4]


class Driver:
    """Put at one server, then Get at another, resending on a timer."""

    def __init__(self, put_at, get_at, record, done):
        self.put_at, self.get_at, self.record, self.done = put_at, get_at, record, done

    def on_start(self, id, out):
        out.set_timer("kick", (0.05, 0.05))
        return "put"

    def on_timeout(self, id, state, timer, out):
        phase = state.get()
        if phase == "put":
            out.send(self.put_at, reg.Put(1, "X"))
        elif phase == "get":
            out.send(self.get_at, reg.Get(2))
        if phase != "done":
            out.set_timer("kick", (0.5, 0.5))

    def on_msg(self, id, state, src, msg, out):
        if isinstance(msg, reg.PutOk) and state.get() == "put":
            state.set("get")
            out.send(self.get_at, reg.Get(2))
        elif isinstance(msg, reg.GetOk) and state.get() == "get":
            self.record.append(msg.value)
            state.set("done")
            out.cancel_timer("kick")
            self.done.set()


@pytest.mark.parametrize("system", ["paxos", "abd"])
def test_live_cluster_serves_a_read_of_the_write(system):
    ids = _free_ids(4)
    servers, client = ids[:3], ids[3]
    if system == "paxos":
        ser, de = json_codec(reg.Put, reg.Get, reg.PutOk, reg.GetOk, reg.Internal,
                             paxos.Prepare, paxos.Prepared, paxos.Accept, paxos.Accepted,
                             paxos.Decided)
        actor, get_at = paxos.PaxosActor, servers[0]
    else:
        ser, de = json_codec(reg.Put, reg.Get, reg.PutOk, reg.GetOk, reg.Internal,
                             abd.Query, abd.AckQuery, abd.Record, abd.AckRecord)
        actor, get_at = abd.AbdActor, servers[2]
    record, done = [], threading.Event()
    actors = [(i, actor([x for x in servers if x != i])) for i in servers]
    actors.append((client, Driver(servers[0], get_at, record, done)))
    assert _run(ser, de, actors, done, 15), f"{system} cluster did not answer within 15 s"
    assert record == ["X"]
