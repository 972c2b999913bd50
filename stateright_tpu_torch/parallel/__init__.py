"""The sharded engine: ``spawn_xla(mesh=)`` over fingerprint-owned shards.

Counterpart of ``stateright_tpu/parallel/__init__.py``. The reference
scales with worker threads sharing a ``DashMap`` visited set; the JAX
package shards the frontier and the visited set over a device mesh by
fingerprint ownership (every 64-bit fingerprint has exactly one owner
shard, so dedup needs no locks), routes each candidate to its owner with
one ``all_to_all`` a level, and combines counters and discoveries with
``psum``/``pmax``. Children live where their fingerprint lands, so the
frontier balances itself by hash uniformity.

Here the mesh is one process and D shards on ONE device: the shard axis is
the leading dimension of every buffer, the ``all_to_all`` a transpose of
the route buffer, ``psum``/``pmax`` reductions over that axis. It runs
wherever the single-chip engine runs (the card, or the CPU by request:
``default_mesh(8, device="cpu")``, the counterpart of the reference's
8-device virtual CPU mesh). A mesh over several devices, and the
multi-process mesh over ``torch.distributed``, are ROADMAP A10b-2: a mesh
whose devices differ raises ``NotImplementedError``.
"""

from .sharded import Mesh, ShardedXlaChecker, default_mesh, mesh_device, owner_bits

__all__ = ["Mesh", "ShardedXlaChecker", "default_mesh", "mesh_device", "owner_bits"]
