"""The sharded engine: ``spawn_xla(mesh=)`` over fingerprint-owned shards.

Counterpart of ``stateright_tpu/parallel/__init__.py``. The reference
scales with worker threads sharing a ``DashMap`` visited set; the JAX
package shards the frontier and the visited set over a device mesh by
fingerprint ownership (every 64-bit fingerprint has exactly one owner
shard, so dedup needs no locks), routes each candidate to its owner with
one ``all_to_all`` a level, and combines counters and discoveries with
``psum``/``pmax``. Children live where their fingerprint lands, so the
frontier balances itself by hash uniformity.

In one process the mesh is D shards on ONE device: the shard axis is the
leading dimension of every buffer, the ``all_to_all`` a transpose of the
route buffer, ``psum``/``pmax`` reductions over that axis. It runs
wherever the single-chip engine runs (the card, or the CPU by request:
``default_mesh(8, device="cpu")``, the counterpart of the reference's
8-device virtual CPU mesh).

Over several processes (the reference's ``jax.distributed`` path), each
process is one rank of a ``torch.distributed`` group
(:mod:`.distributed`: ``initialize``, ``process_index``,
``process_count``, the host reads, reductions and the route exchange,
``shutdown``), holding a contiguous block of the mesh's shards on its own
device: ``distributed.initialize(...)`` on every rank, then
``spawn_xla(mesh=default_mesh(n))``. The route buffer goes through
``all_to_all_single``, the level's flags, counts and election keys through
one all-gather, and every rank takes the same host decisions; the result
is the one-process mesh's, shard for shard. NCCL is chosen when each rank
has a card of its own, gloo on the CPU and when ranks share a card (the
only layout a one-card machine can run). A mesh over several devices in
one process raises ``NotImplementedError``: run one rank a card.
"""

from . import distributed
from .sharded import Mesh, ShardedXlaChecker, default_mesh, mesh_device, owner_bits

__all__ = ["Mesh", "ShardedXlaChecker", "default_mesh", "distributed", "mesh_device",
           "owner_bits"]
