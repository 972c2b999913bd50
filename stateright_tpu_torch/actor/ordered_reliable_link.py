"""Ordered reliable link (ORL): a wrapper giving lossless/ordered/
non-duplicated virtual channels over a lossy network.

Counterpart of ``stateright_tpu/actor/ordered_reliable_link.py``
(stateright's ``src/actor/ordered_reliable_link.rs``): sequence numbers +
acks + a periodic resend timer ("perfect link" plus ordering).
Order holds per source/destination pair; actors are assumed not to restart
(ordered_reliable_link.rs:1-15).

Deltas from stateright, the JAX package's own:

- ``SetTimer``/``CancelTimer`` from the wrapped actor raise
  ``NotImplementedError`` (stateright ``todo!()``s the same way,
  ordered_reliable_link.rs:186-192).
- Stateright silently discards wrapped-state updates made in a *user*
  timeout handler (it only processes the emitted commands); here the updated
  state is written back — user timers otherwise couldn't evolve state.
"""

from __future__ import annotations

from typing import Any, Tuple

from ..utils.variant import variant

#: Payload carrier: sequence number + wrapped message.
Deliver = variant("Deliver", ["seq", "msg"])
Ack = variant("Ack", ["seq"])
#: The periodic resend timer.
NetworkTimer = variant("NetworkTimer", [])
#: A timer belonging to the wrapped actor.
UserTimer = variant("UserTimer", ["timer"])

#: ORL bookkeeping around the wrapped actor's state
#: (ordered_reliable_link.rs:50-60).  Maps are stored as sorted item tuples
#: so states stay immutable, hashable, and fingerprintable:
#: msgs_pending_ack is seq -> (dst, msg); last_delivered_seqs is src -> seq.
LinkState = variant(
    "LinkState",
    ["next_send_seq", "msgs_pending_ack", "last_delivered_seqs", "wrapped_state"],
)


def _items_set(items: Tuple, key: Any, value: Any) -> Tuple:
    d = dict(items)
    d[key] = value
    return tuple(sorted(d.items(), key=lambda kv: repr(kv[0])))


def _items_remove(items: Tuple, key: Any) -> Tuple:
    d = dict(items)
    d.pop(key, None)
    return tuple(sorted(d.items(), key=lambda kv: repr(kv[0])))


class ActorWrapper:
    """Wraps an actor to maintain message order, resend lost messages, and
    avoid redelivery (ordered_reliable_link.rs:32-205)."""

    def __init__(self, wrapped_actor, resend_interval: Tuple[float, float] = (1.0, 2.0)):
        self.wrapped_actor = wrapped_actor
        self.resend_interval = resend_interval

    @staticmethod
    def with_default_timeout(wrapped_actor) -> "ActorWrapper":
        return ActorWrapper(wrapped_actor, (1.0, 2.0))

    # -- helpers -----------------------------------------------------------

    def _process_output(self, state: LinkState, wrapped_out, out) -> LinkState:
        """Sends of the wrapped actor become sequenced Deliver envelopes and
        join the pending-ack set (ordered_reliable_link.rs:176-205)."""
        from . import CancelTimer, Send, SetTimer

        next_seq = state.next_send_seq
        pending = state.msgs_pending_ack
        for c in wrapped_out.commands:
            if isinstance(c, (SetTimer, CancelTimer)):
                raise NotImplementedError(
                    "wrapped-actor timers are not supported by the ORL yet"
                )
            if isinstance(c, Send):
                out.send(c.dst, Deliver(next_seq, c.msg))
                pending = _items_set(pending, next_seq, (c.dst, c.msg))
                next_seq += 1
        return LinkState(next_seq, pending, state.last_delivered_seqs, state.wrapped_state)

    # -- Actor interface ---------------------------------------------------

    def on_start(self, id, out):
        from . import Out

        out.set_timer(NetworkTimer(), self.resend_interval)
        wrapped_out = Out()
        wrapped_state = self.wrapped_actor.on_start(id, wrapped_out)
        state = LinkState(1, (), (), wrapped_state)
        return self._process_output(state, wrapped_out, out)

    def on_msg(self, id, state, src, msg, out):
        from . import Out, StateRef, is_no_op

        current: LinkState = state.get()
        if isinstance(msg, Deliver):
            # Always ack (even redeliveries) to stop resends
            # (ordered_reliable_link.rs:110-114).
            out.send(src, Ack(msg.seq))
            if msg.seq <= dict(current.last_delivered_seqs).get(src, 0):
                return
            ref = StateRef(current.wrapped_state)
            wrapped_out = Out()
            self.wrapped_actor.on_msg(id, ref, src, msg.msg, wrapped_out)
            if is_no_op(ref, wrapped_out):
                return
            updated = LinkState(
                current.next_send_seq,
                current.msgs_pending_ack,
                _items_set(current.last_delivered_seqs, src, msg.seq),
                ref.get(),
            )
            state.set(self._process_output(updated, wrapped_out, out))
        elif isinstance(msg, Ack):
            # Unconditional write like the reference's to_mut() — a stale
            # ack still counts as a state-touching action
            # (ordered_reliable_link.rs:146-148).
            state.set(
                LinkState(
                    current.next_send_seq,
                    _items_remove(current.msgs_pending_ack, msg.seq),
                    current.last_delivered_seqs,
                    current.wrapped_state,
                )
            )

    def on_timeout(self, id, state, timer, out):
        from . import Out, StateRef, is_no_op

        current: LinkState = state.get()
        if isinstance(timer, NetworkTimer):
            # Re-arm and resend everything unacked
            # (ordered_reliable_link.rs:157-163).  With nothing pending this
            # is a no-op-with-timer and the action is ignored.
            out.set_timer(NetworkTimer(), self.resend_interval)
            for seq, (dst, msg) in current.msgs_pending_ack:
                out.send(dst, Deliver(seq, msg))
        elif isinstance(timer, UserTimer):
            ref = StateRef(current.wrapped_state)
            wrapped_out = Out()
            self.wrapped_actor.on_timeout(id, ref, timer.timer, wrapped_out)
            if is_no_op(ref, wrapped_out):
                return
            updated = LinkState(
                current.next_send_seq,
                current.msgs_pending_ack,
                current.last_delivered_seqs,
                ref.get(),
            )
            state.set(self._process_output(updated, wrapped_out, out))
