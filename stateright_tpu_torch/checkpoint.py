"""Checkpoint and resume for the port's engine, in the reference's format.

Counterpart of ``stateright_tpu/checkpoint.py``, whose files each side
resumes: a search saved by the JAX package's engine resumes in the port
(``spawn_xla(checkpoint=path)``), and a search saved here resumes in the
JAX package's engine. The file is format 3, an ``np.savez_compressed``
archive of the *logical* search state, independent of either engine's
memory layout:

- the visited set as compacted ``(fingerprint, parent)`` pairs (four
  ``uint32`` lanes: ``key_hi/key_lo/val_hi/val_lo``), unique, in the
  structure's plane order (sorted for the sorted set; slot order for the
  hash set; main then delta for the delta set), as the reference writes;
- the frontier as packed ``uint32`` state rows and eventually-bit words;
- scalar progress counters and discovery pins, and the model's identity
  (class name, packed geometry, configuration digest, property names,
  symmetry tag), validated on restore;
- a SHA-256 over every payload array in the meta, recomputed on load.

The port's planes are int64 tensors of 32-bit words (``ops/words.py``);
the writer narrows them to ``uint32``, so the payload and its digest are
the reference's byte for byte.

Crash safety, as in the reference: a write lands in a same-directory temp
file and goes live by ``os.replace``; ``keep=K`` shifts the previous file
to ``<path>.1`` (and so on); a torn, foreign or tampered file raises the
typed :class:`CheckpointCorrupt`, and :func:`latest_valid_checkpoint` falls
back to the newest rotation that verifies. :class:`AutoCheckpointer` is the
in-loop cadence of ``spawn_xla(checkpoint_to=...)``. The reference's
fault-injection hook is here too: a ``checkpoint.torn`` clause of
``STPU_CHAOS`` (``chaos.py``) tears the file just written.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import chaos
from .ops.words import to_u32

#: v3: the metadata embeds a payload SHA-256 (``payload_sha256``) that loads
#: verify; v1 and v2 files are rejected as unsupported formats.
FORMAT_VERSION = 3

#: Payload members of the archive, in digest order. The order is part of the
#: format: the digest is a running hash over these arrays' bytes.
PAYLOAD_KEYS = (
    "key_hi",
    "key_lo",
    "val_hi",
    "val_lo",
    "frontier",
    "frontier_ebits",
)


class CheckpointCorrupt(Exception):
    """A checkpoint file that cannot be trusted: torn or truncated
    mid-write, unreadable as an archive, missing payload members, or
    failing its embedded payload digest. Callers catch this and fall back
    to the previous rotation (:func:`latest_valid_checkpoint`)."""


def _normalize(path: str) -> str:
    """``np.savez`` appends '.npz' when absent; normalize both ends so any
    path round-trips. An existing exact FILE (a rotation like
    ``ck.npz.1``) wins over suffix normalization; a directory never does."""
    if path.endswith(".npz") or os.path.isfile(path):
        return path
    return path + ".npz"


def model_digest(model) -> str:
    """A digest of the model's configuration: its packed initial states pin
    every knob that shapes the transition system, so a checkpoint cannot
    resume into a differently configured instance of the same class."""
    rows = np.ascontiguousarray(np.asarray(model.packed_init(), dtype=np.uint32))
    h = hashlib.sha256()
    h.update(repr((rows.shape, model.state_words, model.max_actions)).encode())
    h.update(rows.tobytes())
    return h.hexdigest()[:16]


def _payload_digest(arrays: Dict[str, np.ndarray]) -> str:
    """SHA-256 over every payload array's name, shape, dtype and bytes, in
    :data:`PAYLOAD_KEYS` order."""
    h = hashlib.sha256()
    for key in PAYLOAD_KEYS:
        a = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def checkpoint_arrays(checker) -> Dict[str, np.ndarray]:
    """The payload of ``checker``'s current search state as ``uint32``
    arrays: the visited set's occupied rows in its plane order (the
    structure's ``occupied_rows``; on the sharded engine every shard's,
    shard by shard, as the reference's global planes lie) and the live
    frontier rows with their eventually-bits (:func:`_live_frontier`). On a
    mesh over several processes both are gathered from every rank (a
    collective every rank takes), so rank 0's file is the global file."""
    from .parallel import ShardedXlaChecker

    if isinstance(checker, ShardedXlaChecker):
        rows = checker._occupied_rows()
    else:
        rows = checker._ds.occupied_rows(checker._table)
    frontier, ebits = _live_frontier(checker)
    return {**dict(zip(PAYLOAD_KEYS[:4], rows)), "frontier": frontier, "frontier_ebits": ebits}


def _live_frontier(checker):
    """The live frontier rows ``[n, W]`` and eventually-bits ``[n]`` as host
    ``uint32``, whatever the engine's layout: the sharded engine's shard by
    shard."""
    from .parallel import ShardedXlaChecker

    if isinstance(checker, ShardedXlaChecker):
        return checker._live_frontier()
    return (checker._frontier_rows_host(),
            to_u32(checker._frontier_ebits[: checker._frontier_count]))


def save_checkpoint(checker, path: str, keep: int = 1) -> None:
    """Writes the checker's logical search state; valid at any quiescent
    point between dispatches. The write is atomic (temp file +
    ``os.replace``) and rotating: with ``keep=K > 1`` the previous live file
    shifts to ``<path>.1`` (``.1`` to ``.2``, ...), keeping the last K."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    arrays = checkpoint_arrays(checker)
    meta = {
        "format_version": FORMAT_VERSION,
        "model": type(checker._model).__name__,
        "init_digest": model_digest(checker._model),
        "state_words": checker._W,
        "max_actions": checker._A,
        "property_names": checker._prop_names,
        # The symmetry identity (None, "spec:<hash12>" or
        # "model:packed_representative"), the same string in both packages:
        # a file resumes only under the tag it was written with.
        "symmetry": getattr(checker, "_sym_tag", None),
        "depth": checker._depth,
        "max_depth": checker._max_depth,
        "state_count": checker._state_count,
        "unique_count": checker._unique_count,
        "found_names": {k: int(v) for k, v in checker._found_names.items()},
        "exhausted": checker._exhausted,
        "target_reached": checker._target_reached,
        # is_done() is wider than the two flags above (an empty frontier or
        # every property found also completes a run).
        "done": bool(checker.is_done()),
        "payload_sha256": _payload_digest(arrays),
        "written_unix_ts": time.time(),
    }
    dst = _normalize(path)
    # Same-directory temp (os.replace must not cross filesystems), with a
    # .npz suffix so np.savez does not append its own.
    tmp = f"{dst}.tmp-{os.getpid()}.npz"
    # Sweep temps orphaned by a writer killed mid-save: the finally below
    # never runs under SIGKILL, and one writer owns a base path at a time.
    for stale in glob.glob(f"{glob.escape(dst)}.tmp-*.npz"):
        if stale != tmp:
            try:
                os.unlink(stale)
            except OSError:
                pass
    try:
        np.savez_compressed(
            tmp,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **arrays,
        )
        if keep > 1 and os.path.exists(dst):
            for i in range(keep - 1, 1, -1):
                older = f"{dst}.{i - 1}"
                if os.path.exists(older):
                    os.replace(older, f"{dst}.{i}")
            os.replace(dst, f"{dst}.1")
        os.replace(tmp, dst)
        inj = chaos.fire("checkpoint.torn", size=os.path.getsize(dst))
        if inj is not None:
            # Deterministic fault injection (chaos.py): tear the rotation
            # just written at byte ``at``, the corrupt-newest shape that
            # latest_valid_checkpoint falls back from. A no-op unless an
            # STPU_CHAOS plan names it.
            chaos.tear_file(dst, inj.get("at", 1))
    finally:
        # Only a failed save leaves the temp behind (success replaced it).
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _read_archive(path: str):
    """The raw ``(meta, arrays)`` of a checkpoint archive; every way a torn
    or foreign file can fail to parse becomes :class:`CheckpointCorrupt`. A
    missing file stays ``FileNotFoundError``: "no checkpoint yet" and
    "checkpoint destroyed" are different verdicts."""
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            arrays = {k: np.asarray(z[k]) for k in PAYLOAD_KEYS if k in z}
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            f"{path}: unreadable checkpoint ({type(e).__name__}: {e})"
        ) from e
    return meta, arrays


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Reads a checkpoint into host arrays and its meta:
    ``{"meta": ..., **arrays}``. Raises :class:`CheckpointCorrupt` on a torn,
    truncated or digest-mismatched file and ``ValueError`` on a readable
    file of an unsupported format version."""
    p = _normalize(path)
    meta, arrays = _read_archive(p)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {meta.get('format_version')}")
    missing = [k for k in PAYLOAD_KEYS if k not in arrays]
    if missing:
        raise CheckpointCorrupt(f"{p}: missing payload members {missing}")
    digest = _payload_digest(arrays)
    if meta.get("payload_sha256") != digest:
        raise CheckpointCorrupt(
            f"{p}: payload digest mismatch "
            f"({meta.get('payload_sha256')} != {digest}) — torn or tampered"
        )
    return {"meta": meta, **arrays}


def rotations(path: str) -> List[str]:
    """Existing rotation files for ``path``, newest first: the live file,
    then ``.1``, ``.2``, ... (contiguous: the shift in
    :func:`save_checkpoint` leaves no gaps)."""
    p = _normalize(path)
    out = [p] if os.path.exists(p) else []
    i = 1
    while os.path.exists(f"{p}.{i}"):
        out.append(f"{p}.{i}")
        i += 1
    return out


def latest_valid_checkpoint(path: str, *, with_meta: bool = False):
    """The newest rotation of ``path`` that loads and verifies clean, or
    None; a torn newest file is skipped for the rotation before it.
    ``with_meta=True`` returns ``(path, meta)`` (``(None, None)`` on a
    miss), so a caller need not load the winning file twice."""
    for candidate in rotations(path):
        try:
            meta = load_checkpoint(candidate)["meta"]
        except (CheckpointCorrupt, ValueError):
            continue
        return (candidate, meta) if with_meta else candidate
    return (None, None) if with_meta else None


def validate_model(meta: Dict[str, Any], model, prop_names) -> None:
    """A checkpoint loads only into the model that wrote it."""
    problems = []
    if meta["model"] != type(model).__name__:
        problems.append(f"model {meta['model']!r} != {type(model).__name__!r}")
    if meta["state_words"] != model.state_words:
        problems.append(f"state_words {meta['state_words']} != {model.state_words}")
    if meta["max_actions"] != model.max_actions:
        problems.append(f"max_actions {meta['max_actions']} != {model.max_actions}")
    digest = model_digest(model)
    if meta["init_digest"] != digest:
        problems.append(
            f"model config digest {meta['init_digest']} != {digest} "
            "(same class, different configuration)"
        )
    if meta["property_names"] != list(prop_names):
        problems.append(f"properties {meta['property_names']} != {list(prop_names)}")
    if problems:
        raise ValueError("checkpoint does not match this model: " + "; ".join(problems))


def validate_symmetry(meta: Dict[str, Any], sym_tag) -> None:
    """A checkpoint loads only into a checker with the same
    canonicalization (``sym_tag``): the visited keys are fingerprints of
    canonical forms, so another symmetry configuration would mis-dedup
    every state inserted after the resume. Files without the key predate
    the tag and skip the check."""
    if "symmetry" not in meta:
        return
    if meta["symmetry"] != sym_tag:
        raise ValueError(
            f"checkpoint symmetry mismatch: written with {meta['symmetry']!r}, "
            f"resuming with {sym_tag!r} — a resume must keep the symmetry "
            "configuration the checkpoint was written under"
        )


def _parse_every(every):
    """Cadence spec -> ``(levels, seconds)``, exactly one set. An int (or a
    digit string) is committed BFS levels; a string with an ``s`` suffix is
    wall-clock seconds (``"45s"``, ``"2.5s"``)."""
    if isinstance(every, bool):
        raise ValueError(f"checkpoint_every must be an int or 'Ns': {every!r}")
    if isinstance(every, int):
        if every < 1:
            raise ValueError(f"checkpoint_every levels must be >= 1: {every}")
        return every, None
    s = str(every).strip()
    if s.endswith("s"):
        seconds = float(s[:-1])
        if seconds <= 0:
            raise ValueError(f"checkpoint_every seconds must be > 0: {s!r}")
        return None, seconds
    try:
        return _parse_every(int(s))
    except ValueError:
        raise ValueError(
            f"checkpoint_every must be an int (levels) or 'Ns' (seconds): {every!r}"
        ) from None


class AutoCheckpointer:
    """In-loop auto-checkpoint cadence of ``spawn_xla(checkpoint_to=...)``.

    The engine calls :meth:`maybe` at every quiescent point (after a
    dispatch's commit bookkeeping); this object decides whether a
    checkpoint is due — every ``checkpoint_every`` committed levels, or
    every that many seconds with an ``"Ns"`` spec — and writes it through
    ``checker.save_checkpoint``, which counts ``checkpoints_written``. Under
    fused dispatch the cadence is checked at block boundaries, so its
    granularity is the block.
    """

    #: Cadence when ``checkpoint_to`` is set without ``checkpoint_every``.
    DEFAULT_EVERY = "60s"
    DEFAULT_KEEP = 3

    def __init__(self, path: str, every=None, keep: Optional[int] = None):
        self.path = path
        self.every_levels, self.every_seconds = _parse_every(
            self.DEFAULT_EVERY if every is None else every
        )
        self.keep = self.DEFAULT_KEEP if keep is None else int(keep)
        if self.keep < 1:
            raise ValueError(f"checkpoint_keep must be >= 1: {self.keep}")
        self._last_depth: Optional[int] = None
        self._last_time: Optional[float] = None

    @classmethod
    def resolve(cls, checkpoint_to, checkpoint_every, checkpoint_keep):
        """The spawn-kwarg/environment resolution: ``checkpoint_to`` (env
        ``STPU_CHECKPOINT_TO``) arms auto-checkpointing;
        ``checkpoint_every`` (env ``STPU_CHECKPOINT_EVERY``) and
        ``checkpoint_keep`` (env ``STPU_CHECKPOINT_KEEP``) tune it. None when
        off. The environment arms every checker of the process onto one
        file; a process with several checkers passes ``checkpoint_to``."""
        path = checkpoint_to or os.environ.get("STPU_CHECKPOINT_TO") or None
        if path is None:
            return None
        every = (
            checkpoint_every
            if checkpoint_every is not None
            else os.environ.get("STPU_CHECKPOINT_EVERY") or None
        )
        keep = (
            checkpoint_keep
            if checkpoint_keep is not None
            else os.environ.get("STPU_CHECKPOINT_KEEP") or None
        )
        return cls(path, every, None if keep is None else int(keep))

    def arm(self, depth: int) -> None:
        """Baseline the cadence at the checker's starting point (fresh init
        or restore), so a resumed checker does not at once rewrite the
        checkpoint it resumed from."""
        self._last_depth = depth
        self._last_time = time.monotonic()

    def due(self, depth: int) -> bool:
        if self._last_depth is None:
            self.arm(depth)
            return False
        if self.every_levels is not None:
            return depth - self._last_depth >= self.every_levels
        return time.monotonic() - self._last_time >= self.every_seconds

    def maybe(self, checker, agree=None) -> bool:
        """Write a checkpoint if one is due; returns whether it wrote.
        ``agree`` (a rank mesh's ``Group.any``) turns this process's
        verdict into the one every rank takes."""
        depth = checker._depth
        due = self.due(depth)
        if agree is not None:
            due = agree(due)
        if not due:
            return False
        checker.save_checkpoint(self.path, keep=self.keep)
        self._last_depth = depth
        self._last_time = time.monotonic()
        return True
