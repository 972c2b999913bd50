"""The rank mesh's process group: one process a rank over ``torch.distributed``.

Counterpart of the JAX package's use of ``jax.distributed.initialize`` and
``jax.experimental.multihost_utils`` (``stateright_tpu/parallel/__init__.py``,
``sharded.py`` ``_host_read`` and ``_counts_total``). Each rank is one OS
process that holds a contiguous block of a mesh's shards on its own device
(``sharded.default_mesh``); every collective of the sharded engine goes
through this module:

- :func:`initialize` makes the group (``init_process_group`` over
  ``tcp://<coordinator_address>``) and gives the rank its device:
  ``cuda:(process_id % device_count)``, or the CPU when asked;
- :func:`choose_backend` picks the backend before the group exists, from
  what the process can observe: ``gloo`` on the CPU, ``nccl`` when every
  rank of the machine has a card of its own, ``gloo`` when ranks share a
  card (NCCL refuses two ranks on one device). An explicit ``backend=``
  wins. A failed ``init_process_group`` raises; no other backend is tried;
- :meth:`Group.host_read` is the all-gather of each rank's leading-axis
  block into the global host array (the reference's ``_host_read``),
  :meth:`Group.gather_ragged` the same for blocks whose lengths differ by
  rank, :meth:`Group.all_gather` the device-side form, and
  :meth:`Group.reduce` a sum, max or or of host integers;
- :meth:`Group.exchange` is the route buffer's ``all_to_all_single`` (the
  reference's ``all_to_all``): on the device under NCCL; under gloo with a
  card, explicitly through pinned host buffers, which is what gloo would do
  anyway, so the staging is on the page and timed
  (:attr:`Group.exchange_log`).

Every collective runs under the group's ``timeout``, so a rank whose peer
died raises instead of hanging (gloo raises at once when the peer's socket
closes).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..backend import make_current, rank_device, visible_cards

#: The group's collective timeout when the caller gives none, in seconds.
DEFAULT_TIMEOUT_S = 300.0
#: Coordinator hosts on this machine's loopback interface.
LOOPBACK = ("127.0.0.1", "localhost", "[::1]")

_GROUP: Optional["Group"] = None


def choose_backend(device_type: str, ranks_on_machine: int, cards: int) -> str:
    """The backend for ``ranks_on_machine`` ranks of this machine on devices
    of ``device_type`` when the machine has ``cards`` CUDA cards: ``gloo`` on
    the CPU, ``nccl`` when each rank has a card of its own, ``gloo`` when
    ranks share a card."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"a rank runs on 'cuda' or 'cpu', not {device_type!r}")
    return "nccl" if ranks_on_machine <= cards else "gloo"


class Group:
    """The initialized process group as this rank sees it: its ``rank``, the
    ``world`` size, its ``device``, every rank's device (``devices``, by
    rank), the ``backend`` and the collective ``timeout_s``."""

    def __init__(self, rank: int, world: int, device: torch.device, devices: List[str],
                 backend: str, timeout_s: float):
        self.rank = rank
        self.world = world
        self.device = device
        self.devices = devices
        self.backend = backend
        self.timeout_s = timeout_s
        #: ``(start, seconds, bytes, legs)`` of every exchange, ``start`` on
        #: the ``time.perf_counter`` clock (the gaps between starts are the
        #: levels' walls), ``legs`` the seconds of its copy to the host, the
        #: collective and the copy back (staged; else None).
        self.exchange_log: List[tuple] = []
        self._pinned: Dict[tuple, torch.Tensor] = {}

    # --- where a collective's tensors live -----------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through host memory for a collective: a card's
        tensor under gloo."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def _pinned_like(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """A pinned host buffer of ``t``'s shape and type, kept for reuse."""
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf

    def _comm(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend reads it: on the host under gloo, on the
        rank's card under NCCL (a host reduction's values too)."""
        return t.cpu() if self.backend == "gloo" else t.to(self.device)

    # --- gathers and reductions ----------------------------------------------------------

    def _gathered(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on every rank), by rank, where the
        backend reads them."""
        src = self._comm(t.contiguous())
        out = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(out, src)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked by rank: ``[world, *t.shape]`` on
        ``t``'s device."""
        return torch.stack(self._gathered(t)).to(t.device)

    def host_read(self, t: torch.Tensor) -> np.ndarray:
        """The global host array of which ``t`` is this rank's block along
        the leading axis (every rank's block of one shape): the reference's
        ``_host_read``."""
        return torch.cat(self._gathered(t)).cpu().numpy()

    def gather_ragged(self, a: np.ndarray) -> np.ndarray:
        """Every rank's host array ``a`` (its rows may differ in number by
        rank, the trailing shape not), concatenated in rank order."""
        a = np.ascontiguousarray(a)
        lengths = self.host_read(torch.tensor([len(a)], dtype=torch.int64))
        width = int(lengths.max())
        pad = np.zeros((width, *a.shape[1:]), dtype=a.dtype)
        pad[:len(a)] = a
        rows = self.host_read(torch.from_numpy(pad)[None]).reshape(self.world, width, *a.shape[1:])
        return np.concatenate([rows[r, :int(n)] for r, n in enumerate(lengths)])

    def reduce(self, values: Sequence[int], op: str) -> List[int]:
        """Host integers reduced over the ranks, elementwise: ``op`` is
        ``"sum"``, ``"max"`` or ``"or"``."""
        got = self.host_read(torch.tensor(list(values), dtype=torch.int64)[None])
        if op == "sum":
            out = got.sum(0)
        elif op == "max":
            out = got.max(0)
        elif op == "or":
            out = (got != 0).any(0)
        else:
            raise ValueError(f"unknown reduction {op!r}")
        return [int(v) for v in out]

    def any(self, flag: bool) -> bool:
        """``flag`` ORed over the ranks."""
        return bool(self.reduce([int(bool(flag))], "or")[0])

    # --- the route exchange ----------------------------------------------------------------

    def exchange(self, send: torch.Tensor, recv: torch.Tensor) -> None:
        """The route buffer's all-to-all: ``send`` and ``recv`` are
        ``[world, ...]`` and contiguous, ``send[q]`` goes to rank ``q`` and
        ``recv[p]`` comes from rank ``p``. Under NCCL on the device. Under
        gloo with a card, the card's stream is drained, this rank's own
        block copied on the card, and the other ranks' blocks copied to a
        pinned host buffer, exchanged there (``all_to_all_single`` with no
        rows for this rank) and copied back. The bytes counted are those
        that leave the rank's device."""
        t0 = time.perf_counter()
        block = send[0].numel() * send.element_size()
        if self._staged(send):
            torch.cuda.current_stream(send.device).synchronize()
            t0 = time.perf_counter()
            me, others = self.rank, [q for q in range(self.world) if q != self.rank]
            recv[me].copy_(send[me])
            host_send = self._pinned_like(send[:len(others)], "send")
            host_recv = self._pinned_like(recv[:len(others)], "recv")
            for j, q in enumerate(others):
                host_send[j].copy_(send[q])
            t1 = time.perf_counter()
            splits = [0 if q == me else 1 for q in range(self.world)]
            dist.all_to_all_single(host_recv, host_send, splits, splits)
            t2 = time.perf_counter()
            for j, p in enumerate(others):
                recv[p].copy_(host_recv[j])
            torch.cuda.current_stream(send.device).synchronize()
            legs = (t1 - t0, t2 - t1, time.perf_counter() - t2)
            moved = block * len(others)
        else:
            dist.all_to_all_single(recv, send)
            if send.device.type == "cuda":
                torch.cuda.current_stream(send.device).synchronize()
            moved = block * (self.world - 1)
            legs = None
        self.exchange_log.append((t0, time.perf_counter() - t0, moved, legs))

    def exchange_totals(self) -> Dict[str, float]:
        """The exchanges so far: their count, host seconds and bytes."""
        return {"calls": len(self.exchange_log),
                "seconds": sum(row[1] for row in self.exchange_log),
                "bytes": sum(row[2] for row in self.exchange_log)}


def initialize(coordinator_address: str, num_processes: int, process_id: int, *,
               device: Union[None, str, torch.device] = None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Group:
    """Join the group of ``num_processes`` ranks as rank ``process_id``
    (``jax.distributed.initialize``'s arguments): ``coordinator_address``
    is ``host:port`` of rank 0's store. ``device`` is the rank's device
    (:func:`rank_device`); ``backend`` overrides :func:`choose_backend`,
    which counts the ranks of this machine as the ``LOCAL_WORLD_SIZE``
    environment variable says (``torchrun`` sets it), else every rank.
    ``timeout_s`` bounds every collective. Returns the :class:`Group`."""
    global _GROUP
    if _GROUP is not None:
        raise RuntimeError("the process group is initialized already; call shutdown() first")
    dev = rank_device(process_id, device)
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        backend = choose_backend(dev.type, local, visible_cards(dev))
    if backend == "gloo" and coordinator_address.rsplit(":", 1)[0] in LOOPBACK:
        # gloo binds the interface its host name resolves to, which a
        # machine without a network may not have; ranks that meet on the
        # loopback address talk over it.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    make_current(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    devices: List[Optional[str]] = [None] * num_processes
    dist.all_gather_object(devices, str(dev))
    _GROUP = Group(process_id, num_processes, dev, devices, backend, timeout_s)
    return _GROUP


def group() -> Optional[Group]:
    """The initialized group, or None in a process that is no rank."""
    return _GROUP


def process_index() -> int:
    """This process's rank (0 outside a group), as ``jax.process_index``."""
    return _GROUP.rank if _GROUP is not None else 0


def process_count() -> int:
    """The number of ranks (1 outside a group), as ``jax.process_count``."""
    return _GROUP.world if _GROUP is not None else 1


def shutdown() -> None:
    """Leave the group (``destroy_process_group``); a no-op outside one."""
    global _GROUP
    if _GROUP is not None:
        _GROUP = None
        dist.destroy_process_group()
