"""Real-network execution of actors over UDP.

The port's own copy of ``stateright_tpu/actor/spawn.py`` (stateright's
``src/actor/spawn.rs``): one OS thread per actor, a UDP socket bound to the
address encoded in the actor's :class:`Id`, a receive loop whose read
timeout is the earliest pending timer deadline, and pluggable
serialization. :func:`json_codec` writes the same bytes as the reference's
for the same message. Pure host code: the real transport runs no kernel.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_PRACTICALLY_NEVER = 60 * 60 * 24 * 365.0  # spawn.rs:36-39


def serialize_json(msg: Any) -> bytes:
    """Wire format for *plain-JSON* messages (ints, strings, lists, dicts).

    NamedTuple/typed messages cannot round-trip through bare JSON (the type
    tag is lost) — use :func:`json_codec` for those, the analogue of the
    reference examples' serde_json enum tagging."""
    return json.dumps(msg).encode("utf-8")


def deserialize_json(data: bytes) -> Any:
    return json.loads(data.decode("utf-8"))


def json_codec(*msg_types: type):
    """Builds a ``(serialize, deserialize)`` pair that tags values with
    their class name *recursively* and reconstructs them on receive — so
    typed messages (NamedTuples), including nested ones and tuple/set/dict
    payloads, survive the wire like serde's tagged enums.

    ``msg_types`` are the NamedTuple classes the actors exchange; scalars
    and lists pass through untagged.
    """
    by_name = {t.__name__: t for t in msg_types}

    def _enc(v: Any) -> Any:
        from . import Id

        t = type(v)
        if t.__name__ in by_name and isinstance(v, tuple):
            return {"@": t.__name__, "f": [_enc(x) for x in v]}
        if t is Id:
            # Framework type, handled natively: actor ids ride inside
            # protocol payloads (Paxos ballots, ABD sequencers) the same
            # way the reference's serde serializes its u64 newtype.
            return {"@": "__id__", "f": int(v)}
        if t is tuple:
            return {"@": "__tuple__", "f": [_enc(x) for x in v]}
        if t in (set, frozenset):
            tag = "__set__" if t is set else "__frozenset__"
            return {"@": tag, "f": [_enc(x) for x in v]}
        if t is dict:
            return {"@": "__dict__", "f": [[_enc(k), _enc(x)] for k, x in v.items()]}
        if t is list:
            return [_enc(x) for x in v]
        if v is None or t in (bool, int, float, str):
            return v
        raise TypeError(
            f"json_codec cannot serialize {t.__qualname__}; register the "
            f"class or use a custom serialize fn"
        )

    def _dec(v: Any) -> Any:
        if isinstance(v, list):
            return [_dec(x) for x in v]
        if isinstance(v, dict):
            tag, fields = v["@"], v["f"]
            if tag == "__id__":
                from . import Id

                return Id(fields)
            if tag == "__tuple__":
                return tuple(_dec(x) for x in fields)
            if tag == "__set__":
                return set(_dec(x) for x in fields)
            if tag == "__frozenset__":
                return frozenset(_dec(x) for x in fields)
            if tag == "__dict__":
                return {_dec(k): _dec(x) for k, x in fields}
            return by_name[tag](*(_dec(x) for x in fields))
        return v

    def serialize(msg: Any) -> bytes:
        return json.dumps(_enc(msg)).encode("utf-8")

    def deserialize(data: bytes) -> Any:
        return _dec(json.loads(data.decode("utf-8")))

    return serialize, deserialize


class _ActorRuntime:
    def __init__(self, id, actor, serialize, deserialize):
        from . import CancelTimer, Out, Send, SetTimer, StateRef

        self.id = id
        self.actor = actor
        self.serialize = serialize
        self.deserialize = deserialize
        self.deadlines: Dict[Any, float] = {}
        ip, port = id.to_addr()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((ip, port))
        self._Out, self._StateRef = Out, StateRef
        self._Send, self._SetTimer, self._CancelTimer = Send, SetTimer, CancelTimer
        self.stopped = threading.Event()

    def _on_commands(self, out) -> None:
        """Applies commands: sends serialize+send_to, timers maintain a
        deadline map with randomized durations (spawn.rs:146-202)."""
        from . import Id

        for c in out.commands:
            if isinstance(c, self._Send):
                ip, port = Id(c.dst).to_addr()
                try:
                    self.sock.sendto(self.serialize(c.msg), (ip, port))
                except OSError:
                    pass  # sends are fire-and-forget over UDP
            elif isinstance(c, self._SetTimer):
                low, high = c.duration
                self.deadlines[c.timer] = time.monotonic() + random.uniform(low, high)
            elif isinstance(c, self._CancelTimer):
                # Cancel = move the deadline out of reach (spawn.rs:195-200).
                self.deadlines[c.timer] = time.monotonic() + _PRACTICALLY_NEVER
            else:  # pragma: no cover
                raise TypeError(f"unknown command {c!r}")

    def run(self) -> None:
        from . import Id

        out = self._Out()
        state = self.actor.on_start(self.id, out)
        self._on_commands(out)
        while not self.stopped.is_set():
            now = time.monotonic()
            next_deadline = min(self.deadlines.values(), default=now + 1.0)
            timeout = max(0.0, min(next_deadline - now, 1.0))
            self.sock.settimeout(timeout if timeout > 0 else 0.000001)
            try:
                data, (ip, port) = self.sock.recvfrom(65536)
            except socket.timeout:
                now = time.monotonic()
                fired = [t for t, d in self.deadlines.items() if d <= now]
                for timer in fired:
                    del self.deadlines[timer]
                    ref = self._StateRef(state)
                    out = self._Out()
                    self.actor.on_timeout(self.id, ref, timer, out)
                    if ref.changed:
                        state = ref.get()
                    self._on_commands(out)
                continue
            except OSError:
                break
            try:
                msg = self.deserialize(data)
            except Exception:
                continue  # ignore undeserializable input
            src = Id.from_addr(ip, port)
            ref = self._StateRef(state)
            out = self._Out()
            self.actor.on_msg(self.id, ref, src, msg, out)
            if ref.changed:
                state = ref.get()
            self._on_commands(out)
        self.sock.close()


def spawn(
    serialize: Callable[[Any], bytes],
    deserialize: Callable[[bytes], Any],
    actors: List[Tuple["Id", Any]],
    *,
    background: bool = False,
) -> List[Tuple[threading.Thread, _ActorRuntime]]:
    """Runs actors on UDP sockets, one thread per actor (spawn.rs:64-143).

    Blocks until interrupted unless ``background=True``, in which case the
    (thread, runtime) handles are returned; call ``runtime.stopped.set()``
    to stop an actor.
    """
    handles = []
    for id, actor in actors:
        runtime = _ActorRuntime(id, actor, serialize, deserialize)
        thread = threading.Thread(
            target=runtime.run, name=f"actor-{int(id)}", daemon=True
        )
        thread.start()
        handles.append((thread, runtime))
    if not background:
        try:
            for thread, _ in handles:
                thread.join()
        except KeyboardInterrupt:
            for _, runtime in handles:
                runtime.stopped.set()
    return handles
