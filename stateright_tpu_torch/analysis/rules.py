"""stpu-lint's rule registry, findings, and the waiver file.

Counterpart of ``stateright_tpu/analysis/rules.py``: the same ``Rule``,
``Finding``, ``Waiver`` (with ``expires``), ``WaiverError``, waiver-file
parser and ``apply_waivers``, with the same behaviour. ``RULES`` keeps
every rule ID of the reference and states what each means on CUDA:

- ``fx`` rules scan the aten graph of a shipped model kernel
  (``fx_lint.py``, traced on fake CPU tensors by ``surfaces.py``);
- ``cuda`` rules compile each ``csrc/`` source with ``nvcc`` for
  ``sm_90a`` and read ``ptxas``'s report (``fx_lint.py``, ``surfaces.py``);
- ``plan`` is the census of CUDA-graph captures a run plan commits to
  (``census.py``);
- ``ast`` rules parse the package source (``astlint.py``);
- ``admission`` rules are the spec checks the service's flight-check ran
  before this package had the others (``ADM001``/``ADM002``);
- ``none`` marks a reference rule that pins a TPU or XLA behaviour the port
  cannot have. It stays registered, with the reason, so that a reader of
  the reference's IDs finds it; it has no surface, and a waiver naming it
  is an error (it would waive nothing).

Known-correct exceptions are waived in the port's own waiver file,
``stateright_tpu_torch/analysis/waivers.toml`` (the reference's
``.stpu-lint-waivers.toml`` speaks of the JAX package). Each waiver carries
a one-line reason and matches findings by rule and glob patterns over the
surface name and file; an unmatched waiver is reported as stale.

The waiver file is TOML restricted to ``[[waiver]]`` tables with string
values, parsed by :func:`_parse_waivers_toml`, loud on anything else.
"""

from __future__ import annotations

import datetime
import fnmatch
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    #: Which pass owns it: "fx", "cuda", "plan", "ast", "admission", or
    #: "none" (a reference rule with no meaning on CUDA).
    kind: str
    #: What the rule pins and why (``--list-rules``, the SARIF rule text).
    history: str


RULES: Dict[str, Rule] = {
    r.id: r
    for r in (
        Rule(
            "STPU001",
            "no write that can name one position twice in a model kernel",
            "fx",
            "The reference's rule: XLA:TPU dropped data-dependent one-element "
            "scatters in vmapped model kernels at batch >= 4096. On CUDA the "
            "hazard is another: when one scatter-class write (aten scatter, "
            "index_put, index_copy, put_) names one position twice, the card "
            "keeps an unspecified winner while the CPU writes in order, so "
            "the card and the CPU tests can disagree. The scan walks the aten "
            "graph of every shipped kernel (make_fx on fake tensors) and "
            "flags such a write whose index derives from the kernel's input. "
            "Exempt: static indices, and one index per row (size 1 along the "
            "written dim, the shape packing.Layout.set_ writes; for "
            "index_put, another index that is an arange over the written "
            "positions, as out[arange(B), i] = v). "
            "masked_scatter is not in the class: its mask names each "
            "position at most once. A write with accumulate=True adds, and "
            "the sum does not depend on the order of integer terms.",
        ),
        Rule(
            "STPU002",
            "no transpose fused into a vmapped kernel on the CPU path",
            "none",
            "The reference's rule pins an XLA:CPU miscompile of a transpose "
            "fused into a vmapped kernel. The port's CPU path is eager ATen "
            "with no fusing compiler, and its kernels are written with the "
            "batch dimension out, not vmapped, so the shape cannot arise.",
        ),
        Rule(
            "STPU003",
            "sort operand count within the chip-proven width",
            "none",
            "The reference's rule pins an XLA:TPU compile stall on a "
            "many-operand lax.sort. torch.sort takes one key tensor, and the "
            "port sorts one int64 word with the lanes as payload gathered "
            "after it (ops/sortedset.py, ops/compact.py), so no sort has an "
            "operand count to bound.",
        ),
        Rule(
            "STPU004",
            "deltaset flush never under a device-side branch",
            "none",
            "The reference's rule pins an XLA:TPU fault of a lax.cond that "
            "carries the delta set's flush sort. The port's programs have no "
            "device-side branch (no CUDA-graph conditional nodes): the flush "
            "is driven from the host between graph replays (ops/deltaset.py).",
        ),
        Rule(
            "STPU005",
            "every CUDA source compiles for sm_90a",
            "cuda",
            "The reference's rule scanned Mosaic kernels and pre-flighted "
            "their TPU lowering from the CPU; the Mosaic scans mean nothing "
            "here. On CUDA the pre-flight is the compiler: every "
            "csrc/<name>.cu of ops/_cuda.SOURCES is compiled with "
            "ops/_cuda.NVCC_FLAGS (the one source of the flags) for sm_90a "
            "before a card is booked, and a failure is a finding anchored at "
            "nvcc's file(line). Without nvcc the surface is skipped with the "
            "reason, never passed.",
        ),
        Rule(
            "STPU006",
            "every CUDA kernel fits the H100's registers and shared memory",
            "cuda",
            "The reference's rule priced a Pallas block's VMEM against the "
            "TPU core's 16 MiB. On the H100 the scarce resources are "
            "registers and shared memory: ptxas's -v report of each kernel "
            "(registers, static shared memory, spill bytes) is checked "
            "against the card's limits (H100_* constants below) and against "
            "the occupancy the kernel's __launch_bounds__ asks for (for "
            "example merge.cu's 6 blocks of 256 threads). ptxas meets a "
            "launch bound by spilling, so any spill is a finding too.",
        ),
        Rule(
            "STPU007",
            "graph captures of a run plan within the declared budget",
            "plan",
            "The reference counted the XLA programs a run plan compiles "
            "(about a minute each over its tunnel). The port captures one "
            "CUDA graph per (bucket, candidate rung), every rung of a bucket "
            "with the bucket, so the count is captures, and a capture costs "
            "its warm-up level and the capture itself. The census "
            "(census.py) enumerates them from the engine's own planner "
            "(xla.ladder_buckets, default_cand_cap, cand_rungs) with no "
            "device, and a plan over MAX_CAPTURES is a finding before it is "
            "a cold wall; an exception is a waiver in waivers.toml. The "
            "census is a lower bound: it prices the declared plan and no "
            "growth. A table growth captures every shape again, a frontier "
            "growth adds the doubled ceiling's buckets, and a candidate-cap "
            "growth adds a bucket's rungs at the grown cap: 2pc rm=8's plan "
            "is 22 captures, and its cold run on an H100 captured 46 graphs "
            "of 18 shapes.",
        ),
        Rule(
            "STPU008",
            "no pathology-class op in only one backend's lowering",
            "none",
            "The reference diffed each kernel's StableHLO lowering for the "
            "CPU and the TPU. PyTorch has no per-backend compiler here: the "
            "CPU and the card run the same ATen graph, and the one place they "
            "run different code is a CUDA kernel against its plain version, "
            "which chip_smoke.py holds equal on the card. The "
            "nondeterministic-write class it guarded is STPU001.",
        ),
        Rule(
            "STPU101",
            "model kernels write through packing, not scatter calls",
            "ast",
            "The source form of STPU001, caught before anything is traced: a "
            "scatter-family method call (scatter, index_put, index_copy, "
            "put_, and their in-place forms) in models/ code. Route field "
            "writes through packing.Layout.set/set_, which writes one index "
            "per row.",
        ),
        Rule(
            "STPU102",
            "no CUDA probe or bring-up outside backend.py",
            "ast",
            "The reference's rule kept jax.devices() behind its backend "
            "probe. The port's rule is that nothing falls back to the CPU "
            "quietly: a torch.cuda.is_available / device_count / set_device "
            "call outside backend.py is the shape such a fallback takes. "
            "Move the decision into backend.py (resolve_device, rank_device, "
            "ordinal_device, make_current, visible_cards, platform_label), "
            "or waive the call with a one-line reason.",
        ),
        Rule(
            "STPU103",
            "checkpoint/heartbeat files written atomically",
            "ast",
            "Checkpoints and heartbeats are read by watchdogs and resumed "
            "from after SIGKILL; a plain open(path, 'w') can be observed "
            "torn. checkpoint.py and obs/ own the tmp + os.replace pattern; "
            "writes to *checkpoint* / *heartbeat* paths outside them must go "
            "through those codecs.",
        ),
        Rule(
            "ADM001",
            "spec resolves to a model with the packed interface",
            "admission",
            "The GPU engine needs the PackedModel protocol (xla.PACKED_ATTRS). "
            "A spec whose model lacks it has no kernel to trace; the finding "
            "names the missing attributes.",
        ),
        Rule(
            "ADM002",
            "spawn_xla accepts the packed model",
            "admission",
            "Building the model's checker on the CPU at the spec's capacities "
            "must not raise: the refusal, with its message, is the finding.",
        ),
    )
}

#: The H100's per-block and per-SM limits STPU006 holds each kernel to
#: (NVIDIA's H100 data sheet and the CUDA C++ Programming Guide's table for
#: compute capability 9.0): 227 KiB of shared memory a block can use, at
#: most 48 KiB of it static (the rest only as dynamic shared memory after
#: cudaFuncSetAttribute); 228 KiB of shared memory and 65,536 32-bit
#: registers a streaming multiprocessor; at most 255 registers a thread,
#: 2,048 resident threads and 32 resident blocks an SM; and 1 KiB of shared
#: memory the system reserves for each resident block.
H100_SMEM_PER_BLOCK_BYTES = 227 * 1024
H100_STATIC_SMEM_PER_BLOCK_BYTES = 48 * 1024
H100_SMEM_PER_SM_BYTES = 228 * 1024
H100_SMEM_RESERVED_PER_BLOCK_BYTES = 1024
H100_REGS_PER_SM = 65536
H100_MAX_REGS_PER_THREAD = 255
H100_MAX_THREADS_PER_SM = 2048
H100_MAX_BLOCKS_PER_SM = 32
#: Registers are allocated to a warp in units of 256.
H100_REG_ALLOC_UNIT = 256

#: STPU007's budget: graph captures a run plan may commit to. A
#: capture costs its warm-up level and the capture: on an NVIDIA H100 80GB
#: HBM3 at 700 W, 26-27 ms for 2pc (``chip_smoke.py``: the main path's
#: cold rm=8 run, 46 captures in 1.25 s; a 2pc:8 service job, 220 in
#: 5.81 s; PERF.md). 32 such captures cost about 0.87 s, under one second
#: of a cold run's wall. A wide model's capture costs more (Paxos 2c/3s:
#: 4 in 1.08 s). The largest shipped plan, with the mux and symmetry
#: classes, commits to 11. The budget holds the declared plan, which is a
#: lower bound on a run's captures (census.py): rm=8's 46 captures came
#: from a plan of 22 and its growths.
MAX_CAPTURES = 32


@dataclass
class Finding:
    rule: str
    #: Which registered surface (traced or compiled) or file (AST pass)
    #: tripped.
    surface: str
    #: Repo-relative path and 1-based line of the best source anchor.
    file: str
    line: int
    message: str
    #: The graph node, compiler line or source line that matched.
    excerpt: str
    waived: bool = False
    waiver_reason: str = ""

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "surface": self.surface,
            "file": self.file,
            "line": self.line,
            "message": self.message,
            "excerpt": self.excerpt,
            "waived": self.waived,
            "waiver_reason": self.waiver_reason,
        }

    def format(self) -> str:
        loc = f"{self.file}:{self.line}" if self.file else "<no-source>"
        tag = " [waived: %s]" % self.waiver_reason if self.waived else ""
        out = f"{loc}: {self.rule} [{self.surface}] {self.message}{tag}"
        if self.excerpt:
            out += f"\n    | {self.excerpt}"
        return out


@dataclass
class Waiver:
    rule: str
    reason: str
    surface: str = "*"
    file: str = "*"
    #: Optional ``YYYY-MM-DD`` expiry. Past it the waiver stops suppressing
    #: (its findings go active) and it is reported like a stale one. Empty =
    #: never expires.
    expires: str = ""
    used: int = field(default=0, compare=False)

    @property
    def expired(self) -> bool:
        if not self.expires:
            return False
        return datetime.date.fromisoformat(self.expires) < datetime.date.today()

    def matches(self, f: Finding) -> bool:
        return (
            not self.expired
            and f.rule == self.rule
            and fnmatch.fnmatchcase(f.surface, self.surface)
            and fnmatch.fnmatchcase(f.file, self.file)
        )


class WaiverError(ValueError):
    """Malformed waiver file: typed, so the CLI exits 2 (a configuration
    error), never silently ignoring a waiver that was meant to apply."""


def _parse_waivers_toml(text: str, path: str) -> List[Waiver]:
    """Minimal TOML subset parser: ``[[waiver]]`` tables of
    ``key = "string"`` pairs; comments and blank lines. Loud on anything
    else."""
    waivers: List[Waiver] = []
    current: Optional[dict] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[waiver]]":
            if current is not None:
                waivers.append(_finish_waiver(current, path))
            current = {"_line": lineno}
            continue
        if "=" in line and current is not None:
            key, _, val = line.partition("=")
            key = key.strip()
            val = val.strip()
            if key in ("rule", "reason", "surface", "file", "expires") and (
                len(val) >= 2 and val[0] == '"' and val[-1] == '"'
            ):
                current[key] = val[1:-1]
                continue
        raise WaiverError(
            f"{path}:{lineno}: unsupported waiver syntax {raw!r} "
            "(only [[waiver]] tables with rule/reason/surface/file/"
            'expires string keys, e.g. rule = "STPU001")'
        )
    if current is not None:
        waivers.append(_finish_waiver(current, path))
    return waivers


def _finish_waiver(d: dict, path: str) -> Waiver:
    line = d.pop("_line")
    if "rule" not in d or "reason" not in d:
        raise WaiverError(
            f"{path}:{line}: every [[waiver]] needs 'rule' and a "
            "one-line 'reason' justifying it"
        )
    if d["rule"] not in RULES:
        raise WaiverError(
            f"{path}:{line}: unknown rule {d['rule']!r}; "
            f"known: {sorted(RULES)}"
        )
    if RULES[d["rule"]].kind == "none":
        raise WaiverError(
            f"{path}:{line}: rule {d['rule']} has no meaning on CUDA and "
            "no surface, so a waiver of it waives nothing"
        )
    if not d["reason"].strip():
        raise WaiverError(f"{path}:{line}: empty waiver reason")
    if d.get("expires"):
        try:
            datetime.date.fromisoformat(d["expires"])
        except ValueError:
            raise WaiverError(
                f"{path}:{line}: expires must be YYYY-MM-DD, got "
                f"{d['expires']!r}"
            ) from None
    return Waiver(**d)


def load_waivers(path: Optional[str]) -> List[Waiver]:
    """Waivers from ``path`` (missing file = no waivers)."""
    if path is None or not os.path.exists(path):
        return []
    with open(path) as fh:
        return _parse_waivers_toml(fh.read(), path)


def apply_waivers(
    findings: List[Finding], waivers: List[Waiver]
) -> Tuple[List[Finding], List[Finding], List[Waiver]]:
    """Split findings into (active, waived); also return UNUSED waivers
    (stale entries worth pruning: reported, not fatal)."""
    active: List[Finding] = []
    waived: List[Finding] = []
    for f in findings:
        for w in waivers:
            if w.matches(f):
                f.waived = True
                f.waiver_reason = w.reason
                w.used += 1
                waived.append(f)
                break
        else:
            active.append(f)
    unused = [w for w in waivers if w.used == 0]
    return active, waived, unused
