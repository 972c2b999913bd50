"""The graph and compiler passes: STPU001 over aten graphs, STPU005/006
over ``nvcc`` and ``ptxas`` reports.

Counterpart of ``stateright_tpu/analysis/jaxpr_lint.py``. The port's
"jaxpr" is the aten graph ``torch.fx.experimental.proxy_tensor.make_fx``
records from a kernel called on fake tensors (``tracing_mode="fake"``): no
device, no data, no execution. The graph names every ATen operation the
kernel asks for, each with the shapes of its operands, so a finding names
the operation the program asked for and, from the node's ``stack_trace``
meta, the repository ``file:line`` that asked.

- :func:`trace` records the graph; :func:`source_of` anchors a node at the
  innermost repository frame of its stack trace (the lint's own
  frames never count).
- :func:`write_hazards` is STPU001: a scatter-class write whose index comes
  from the kernel's input (a forward taint from the graph's placeholders)
  and can name one position twice along the written dim.
- :func:`nvcc_findings` and :func:`ptxas_report` are STPU005/006: a failed
  compile anchored at the compiler's ``file(line)``, and each kernel's
  registers, shared memory and spills from ``-Xptxas -v`` held against the
  H100's limits and the occupancy its ``__launch_bounds__`` asks for
  (:func:`launch_bounds`).

The reference's other scans (fused transposes, wide sorts, a flush under a
branch, the Mosaic shapes, VMEM, the lowering diff) have no meaning here
(``rules.py``).
"""

from __future__ import annotations

import ast
import contextlib
import math
import os
import re
import sys
import traceback
from typing import Any, Dict, List, Optional, Tuple

from .rules import (
    H100_MAX_BLOCKS_PER_SM,
    H100_MAX_REGS_PER_THREAD,
    H100_MAX_THREADS_PER_SM,
    H100_REG_ALLOC_UNIT,
    H100_REGS_PER_SM,
    H100_SMEM_PER_BLOCK_BYTES,
    H100_SMEM_PER_SM_BYTES,
    H100_SMEM_RESERVED_PER_BLOCK_BYTES,
    H100_STATIC_SMEM_PER_BLOCK_BYTES,
    Finding,
)

_ANALYSIS = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_ANALYSIS)
_REPO = os.path.dirname(_PKG)

#: The aten writes STPU001 keys on (overload packets, in-place forms too).
SCATTER_OPS = frozenset({
    "scatter", "scatter_", "index_put", "index_put_", "_unsafe_index_put",
    "index_copy", "index_copy_", "put", "put_",
})


# --- tracing ----------------------------------------------------------------


@contextlib.contextmanager
def _fresh_caches():
    """Empty every ``functools.lru_cache`` of the loaded package modules
    before and after a trace: a cache filled while tracing holds fake
    tensors (``semantics/device._step_tables``), which the next trace, in
    another fake mode, or a real run in this process would read."""

    def clear():
        for name, mod in list(sys.modules.items()):
            if mod is None or not name.startswith("stateright_tpu_torch"):
                continue
            for v in list(vars(mod).values()):
                if hasattr(v, "__wrapped__") and callable(getattr(v, "cache_clear", None)):
                    v.cache_clear()

    clear()
    try:
        yield
    finally:
        clear()


def _lint_frame(filename: str) -> bool:
    """A frame of the lint itself (this package, its command-line wrapper),
    never a finding's anchor."""
    return filename.startswith(_ANALYSIS + os.sep) or (
        os.path.splitext(os.path.basename(filename))[0] == "stpu_lint")


@contextlib.contextmanager
def _repository_frames():
    """make_fx keeps only frames named ``forward`` in a node's stack trace;
    for the duration of a trace keep the repository's frames instead
    (``PythonKeyTracer._filter_traceback_frames`` is the tracer's hook for
    this). A torch without the hook keeps its own filter."""
    from torch.fx.experimental.proxy_tensor import PythonKeyTracer

    if not hasattr(PythonKeyTracer, "_filter_traceback_frames"):
        yield
        return

    def keep(self, summary):
        return traceback.StackSummary.from_list([
            f for f in summary
            if f.filename.startswith(_REPO + os.sep) and not _lint_frame(f.filename)
        ])

    had = "_filter_traceback_frames" in PythonKeyTracer.__dict__
    orig = PythonKeyTracer.__dict__.get("_filter_traceback_frames")
    PythonKeyTracer._filter_traceback_frames = keep
    try:
        yield
    finally:
        if had:
            PythonKeyTracer._filter_traceback_frames = orig
        else:
            del PythonKeyTracer._filter_traceback_frames


def trace(fn, *args, stack_traces: bool = False):
    """The aten graph (a ``torch.fx.GraphModule``) of ``fn(*args)``, traced
    on fake copies of ``args``: shapes and dtypes only, nothing runs. With
    ``stack_traces`` each node carries the repository frames that made it
    (a stack walk a node: :func:`kernel_findings` asks for it only for a
    graph that has a finding)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def call(*a):
        return fn(*a)

    frames = _repository_frames() if stack_traces else contextlib.nullcontext()
    with _fresh_caches(), frames:
        return make_fx(call, tracing_mode="fake", record_stack_traces=stack_traces)(*args)


def op_name(node) -> str:
    """``aten.scatter_.src`` -> ``scatter_``; '' for a non-aten target."""
    parts = str(node.target).split(".")
    return parts[1] if len(parts) >= 2 and parts[0] == "aten" else ""


_FRAME = re.compile(r'File "(?P<file>[^"]+)", line (?P<line>\d+)')


def source_of(node) -> Tuple[str, int]:
    """Best repo-relative ``(file, line)`` anchor for a node: the innermost
    repository frame of its ``stack_trace`` meta outside the lint itself;
    ``("", 0)`` when the trace carries none."""
    frames = [
        (m["file"], int(m["line"]))
        for m in _FRAME.finditer(node.meta.get("stack_trace") or "")
        if m["file"].startswith(_REPO + os.sep) and not _lint_frame(m["file"])
    ]
    if not frames:
        return "", 0
    path, line = frames[-1]
    return os.path.relpath(path, _REPO), line


def excerpt_of(node, limit: int = 160) -> str:
    txt = " ".join(node.format_node().split())
    return txt if len(txt) <= limit else txt[: limit - 3] + "..."


def _shape(arg) -> Optional[Tuple[int, ...]]:
    val = getattr(arg, "meta", {}).get("val")
    return tuple(val.shape) if val is not None and hasattr(val, "shape") else None


# --- STPU001 ----------------------------------------------------------------


def _repeat_hazard(node, name: str, tainted: set) -> str:
    """Why ``node`` (a :data:`SCATTER_OPS` write) can name one position
    twice from the kernel's input, or '' when it cannot: its index is static
    or one a row, or the write accumulates."""
    args = list(node.args)
    kw = node.kwargs
    if name in ("scatter", "scatter_"):
        index, dim = args[2], args[1]
        if len(args) > 4 or "reduce" in kw or index not in tainted:
            return ""
        shape = _shape(index)
        if shape is None:
            return "index of unknown shape"
        d = dim % len(shape) if shape else 0
        if not shape or shape[d] == 1:
            return ""
        return f"index {list(shape)} holds {shape[d]} positions a row along dim {dim}"
    if name in ("index_copy", "index_copy_"):
        index = args[2]
        n = math.prod(_shape(index) or (2,))
        if index not in tainted or n <= 1:
            return ""
        return f"index of {n} positions along dim {args[1]}"
    if name in ("put", "put_"):
        index = args[1]
        accumulate = args[3] if len(args) > 3 else kw.get("accumulate", False)
        n = math.prod(_shape(index) or (2,))
        if accumulate or index not in tainted or n <= 1:
            return ""
        return f"flat index of {n} positions"
    # index_put(self, indices, values, accumulate=False)
    accumulate = args[3] if len(args) > 3 else kw.get("accumulate", False)
    indices = [i for i in args[1] if i is not None]
    if accumulate or not any(i in tainted for i in indices):
        return ""
    import torch

    shapes = [_shape(i) for i in indices]
    if any(sh is None for sh in shapes):
        return "advanced index of unknown shape"
    n = math.prod(torch.broadcast_shapes(*shapes))
    # One position a row: another index numbers the written positions.
    if n <= 1 or any(i not in tainted and _numbers(i, n) for i in indices):
        return ""
    return f"advanced index from the kernel's input names {n} positions"


#: Ops that keep an index's values as they are (and so its distinctness).
_SAME_VALUES = frozenset({
    "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze", "alias", "clone",
})


def _numbers(index, n: int) -> bool:
    """Whether ``index`` holds ``n`` distinct values: an ``arange`` of
    ``n`` elements, through ops that keep its values only."""
    while getattr(index, "op", "") == "call_function" and op_name(index) in _SAME_VALUES:
        index = index.args[0]
    return (getattr(index, "op", "") == "call_function" and op_name(index) == "arange"
            and math.prod(_shape(index) or (0,)) == n)


def write_hazards(gm, surface: str) -> List[Finding]:
    """STPU001: scatter-class writes whose index derives from the graph's
    inputs and can name one position twice. On CUDA the winner of such a
    write is unspecified, while the CPU writes in order."""
    findings: List[Finding] = []
    tainted: set = set()
    for node in gm.graph.nodes:
        if node.op == "placeholder" or any(i in tainted for i in node.all_input_nodes):
            tainted.add(node)
            if node.op == "call_function" and op_name(node).endswith("_") and node.args:
                # An in-place write taints the tensor it writes, for later reads.
                first = node.args[0]
                if hasattr(first, "op"):
                    tainted.add(first)
        if node.op != "call_function" or op_name(node) not in SCATTER_OPS:
            continue
        why = _repeat_hazard(node, op_name(node), tainted)
        if not why:
            continue
        file, line = source_of(node)
        findings.append(
            Finding(
                rule="STPU001",
                surface=surface,
                file=file,
                line=line,
                message=(
                    f"data-dependent {op_name(node)} in a model kernel can write "
                    f"one position twice ({why}): the card keeps an unspecified "
                    "winner where the CPU writes in order; write one index per "
                    "row through packing.Layout.set/set_"
                ),
                excerpt=excerpt_of(node),
            )
        )
    return findings


def kernel_findings(fn, args, surface: str) -> List[Finding]:
    """STPU001 over ``fn(*args)``'s graph. A graph with a finding is traced
    a second time with stack traces, for the anchors."""
    hits = write_hazards(trace(fn, *args), surface)
    if hits:
        hits = write_hazards(trace(fn, *args, stack_traces=True), surface)
    return hits


# --- STPU005: the compile ---------------------------------------------------

#: ``path(line): error: message`` (nvcc's front end, and its fatal and
#: catastrophic forms).
_NVCC_ERROR = re.compile(r"^(?P<file>[^\s(][^(]*)\((?P<line>\d+)\): (?:\w+ )?error[^:]*: (?P<msg>.*)$")


def _rel(path: str) -> str:
    p = os.path.abspath(path)
    return os.path.relpath(p, _REPO) if p.startswith(_REPO + os.sep) else path


def nvcc_findings(text: str, returncode: int, surface: str) -> List[Finding]:
    """STPU005 (and STPU006 for a ptxas resource error) from a compile's
    output: one finding per error line, anchored where the compiler says;
    a failed compile with no line the parser knows is one unanchored
    finding."""
    findings: List[Finding] = []
    for raw in text.splitlines():
        line = raw.strip()
        m = _NVCC_ERROR.match(line)
        if m:
            findings.append(Finding(
                rule="STPU005", surface=surface, file=_rel(m["file"]), line=int(m["line"]),
                message=f"nvcc cannot compile this source for sm_90a: {m['msg']}",
                excerpt=line[:160]))
        elif line.startswith("ptxas error"):
            resource = "too much shared data" in line or "registers" in line
            findings.append(Finding(
                rule="STPU006" if resource else "STPU005", surface=surface, file="", line=0,
                message=("a kernel exceeds the H100's resources" if resource
                         else "ptxas cannot assemble this source for sm_90a"),
                excerpt=line[:160]))
    if returncode != 0 and not findings:
        first = next((ln.strip() for ln in text.splitlines() if ln.strip()), "")
        findings.append(Finding(
            rule="STPU005", surface=surface, file="", line=0,
            message=f"nvcc failed (exit code {returncode}) for sm_90a",
            excerpt=first[:160]))
    return findings


# --- STPU006: each kernel's resources --------------------------------------

_ENTRY = re.compile(r"Compiling entry function '(?P<name>[^']+)' for '(?P<arch>[^']+)'")
_PROPS = re.compile(r"Function properties for (?P<name>\S+)")
_FRAME_LINE = re.compile(
    r"(?P<stack>\d+) bytes stack frame, (?P<stores>\d+) bytes spill stores, "
    r"(?P<loads>\d+) bytes spill loads")
_USED = re.compile(r"Used (?P<regs>\d+) registers")
_SMEM = re.compile(r"(?P<smem>\d+) bytes smem")


def demangle(name: str) -> str:
    """The qualified name of an Itanium-mangled function (``_ZN4stpu12merge_
    kernelE...`` -> ``stpu::merge_kernel``), template arguments and
    parameters dropped, an anonymous namespace (``_GLOBAL__N_...``) as
    ``(anonymous namespace)``; a name that is not mangled, as it is."""
    if not name.startswith("_Z"):
        return name
    s, i, parts = name, 2, []
    nested = i < len(s) and s[i] == "N"
    i += nested
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        n = int(s[i:j])
        part = s[j:j + n]
        parts.append("(anonymous namespace)" if part.startswith("_GLOBAL__N") else part)
        i = j + n
        if not nested:
            break
    return "::".join(parts) or name


def ptxas_kernels(text: str) -> Dict[str, Dict[str, int]]:
    """Each entry function's ``registers``, static ``smem_bytes``,
    ``stack_bytes``, ``spill_stores`` and ``spill_loads`` from a compile's
    ``-Xptxas -v`` output, by demangled name."""
    out: Dict[str, Dict[str, int]] = {}
    current: Optional[str] = None
    props_of: Optional[str] = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m["name"]
            out[demangle(current)] = {"registers": 0, "smem_bytes": 0, "stack_bytes": 0,
                                      "spill_stores": 0, "spill_loads": 0}
            continue
        m = _PROPS.search(line)
        if m:
            props_of = m["name"]
            continue
        m = _FRAME_LINE.search(line)
        if m and current is not None and props_of == current:
            out[demangle(current)].update(stack_bytes=int(m["stack"]),
                                          spill_stores=int(m["stores"]),
                                          spill_loads=int(m["loads"]))
            continue
        m = _USED.search(line)
        if m and current is not None:
            rec = out[demangle(current)]
            rec["registers"] = int(m["regs"])
            s = _SMEM.search(line)
            rec["smem_bytes"] = int(s["smem"]) if s else 0
    return out


_INCLUDE = re.compile(r'#include\s+"(?P<name>[^"]+)"')
_CONSTEXPR = re.compile(r"constexpr\s+[\w\s]+?\b(?P<name>k\w+)\s*=\s*(?P<expr>[^;,]+)[;,]")
_KERNEL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\((?P<bounds>[^)]*)\)\s*)?(?P<name>\w+)\s*\(")


def _eval_int(expr: str, consts: Dict[str, int]) -> Optional[int]:
    """An integer constant expression of the sources (names, casts, + - * /),
    or None."""
    expr = re.sub(r"\(\s*(?:unsigned\s+)?(?:long\s+long|long|int|unsigned)\s*\)", "", expr)

    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name) and n.id in consts:
            return consts[n.id]
        if isinstance(n, ast.BinOp):
            a, b = ev(n.left), ev(n.right)
            ops = {ast.Add: a + b, ast.Sub: a - b, ast.Mult: a * b}
            if type(n.op) in ops:
                return ops[type(n.op)]
            if isinstance(n.op, (ast.Div, ast.FloorDiv)) and b:
                return a // b
        raise ValueError(expr)

    try:
        return ev(ast.parse(expr.strip().rstrip("uUlL"), mode="eval"))
    except (SyntaxError, ValueError, TypeError):
        return None


def launch_bounds(source: str) -> Dict[str, Dict[str, Any]]:
    """Each ``__global__`` kernel of ``source`` and the local headers it
    includes: its ``file`` and ``line`` and, where it declares
    ``__launch_bounds__``, its ``max_threads`` and ``min_blocks`` (1 when
    not given), by name."""
    texts: List[Tuple[str, str]] = []
    seen = set()

    def load(path: str) -> None:
        if path in seen or not os.path.exists(path):
            return
        seen.add(path)
        with open(path) as fh:
            text = fh.read()
        for m in _INCLUDE.finditer(text):
            load(os.path.join(os.path.dirname(path), m["name"]))
        texts.append((path, text))

    load(source)
    out: Dict[str, Dict[str, Any]] = {}
    for path, text in texts:
        consts: Dict[str, int] = {}
        for _, t in texts:
            for m in _CONSTEXPR.finditer(t):
                v = _eval_int(m["expr"], consts)
                if v is not None:
                    consts.setdefault(m["name"], v)
        for m in _KERNEL.finditer(text):
            rec: Dict[str, Any] = {"file": _rel(path), "line": text.count("\n", 0, m.start()) + 1}
            if m["bounds"]:
                vals = [_eval_int(b, consts) for b in m["bounds"].split(",")]
                rec["max_threads"] = vals[0]
                rec["min_blocks"] = vals[1] if len(vals) > 1 else 1
            out[m["name"]] = rec
    return out


def blocks_per_sm(threads: int, registers: int, smem_bytes: int) -> int:
    """Blocks of ``threads`` threads, each thread holding ``registers`` and
    each block ``smem_bytes`` of static shared memory, that one H100 SM
    holds at once."""
    warps = -(-threads // 32)
    per_warp = -(-max(registers, 1) * 32 // H100_REG_ALLOC_UNIT) * H100_REG_ALLOC_UNIT
    return min(
        H100_REGS_PER_SM // (warps * per_warp),
        H100_SMEM_PER_SM_BYTES // (smem_bytes + H100_SMEM_RESERVED_PER_BLOCK_BYTES),
        H100_MAX_THREADS_PER_SM // threads,
        H100_MAX_BLOCKS_PER_SM,
    )


def ptxas_report(text: str, source: str, surface: str) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """STPU006 over a compile's ``-Xptxas -v`` output for ``source``: each
    kernel's resources (the list returned beside the findings, one dict a
    kernel with its occupancy) held against the H100's per-block limits,
    against the blocks per SM its ``__launch_bounds__`` asks for, and for
    spills."""
    bounds = launch_bounds(source)
    findings: List[Finding] = []
    kernels: List[Dict[str, Any]] = []
    for name, res in sorted(ptxas_kernels(text).items()):
        short = name.split("::")[-1]
        decl = bounds.get(short, {})
        threads, want = decl.get("max_threads"), decl.get("min_blocks")
        row = {"kernel": name, **res, "max_threads": threads, "min_blocks": want,
               "blocks_per_sm": blocks_per_sm(threads, res["registers"], res["smem_bytes"])
               if threads else None}
        kernels.append(row)
        problems = []
        if res["spill_stores"] or res["spill_loads"]:
            problems.append(f"spills {res['spill_stores']} bytes stored and "
                            f"{res['spill_loads']} loaded")
        if res["registers"] > H100_MAX_REGS_PER_THREAD:
            problems.append(f"{res['registers']} registers a thread, over "
                            f"{H100_MAX_REGS_PER_THREAD}")
        if res["smem_bytes"] > H100_STATIC_SMEM_PER_BLOCK_BYTES:
            problems.append(f"{res['smem_bytes']} bytes of static shared memory, over "
                            f"{H100_STATIC_SMEM_PER_BLOCK_BYTES}")
        if res["smem_bytes"] > H100_SMEM_PER_BLOCK_BYTES:
            problems.append(f"{res['smem_bytes']} bytes of shared memory a block, over "
                            f"{H100_SMEM_PER_BLOCK_BYTES}")
        if threads and row["blocks_per_sm"] < want:
            problems.append(
                f"__launch_bounds__ asks for {want} blocks of {threads} threads an SM, and "
                f"{res['registers']} registers a thread with {res['smem_bytes']} bytes of "
                f"shared memory a block fit {row['blocks_per_sm']}")
        for p in problems:
            findings.append(Finding(
                rule="STPU006", surface=surface, file=decl.get("file", _rel(source)),
                line=decl.get("line", 0), message=f"kernel {name} {p} on the H100",
                excerpt=(f"{name}: {res['registers']} registers, {res['smem_bytes']} bytes "
                         f"smem, {res['spill_stores']}/{res['spill_loads']} bytes spilled")))
    return findings, kernels
