"""The AST lint pass: STPU101-103 over the port's source.

Counterpart of ``stateright_tpu/analysis/astlint.py``. These are
source-level rules, cheaper than tracing: the pass parses every ``.py``
under ``stateright_tpu_torch/`` (no imports, no execution) and walks the
trees once.

- STPU101: a scatter-family method call in ``models/`` (the source form of
  STPU001);
- STPU102: a CUDA probe or bring-up (``torch.cuda.is_available``,
  ``device_count``, ``set_device``) outside ``backend.py``;
- STPU103: a plain write to a checkpoint or heartbeat path outside
  ``checkpoint.py`` and ``obs/``, unchanged from the reference.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator, List, Tuple

from .rules import Finding

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)

#: Tensor methods STPU101 flags in model code: the writes STPU001 scans
#: the aten graph for.
_SCATTER_METHODS = frozenset({
    "scatter", "scatter_", "index_put", "index_put_", "index_copy", "index_copy_", "put_",
})

#: ``torch.cuda`` calls STPU102 reserves for backend.py.
_BRINGUP_ATTRS = frozenset({"is_available", "device_count", "set_device"})

#: Path-name fragments that mark a write target as a checkpoint or
#: heartbeat artifact for STPU103.
_DURABLE_HINTS = ("heartbeat", "checkpoint", "ckpt", "hb_path", "hb_file")


def iter_sources(root: str = _PKG) -> Iterator[Tuple[str, str]]:
    """``(abs_path, rel_path)`` for every package source file."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                p = os.path.join(dirpath, fn)
                yield p, os.path.relpath(p, _REPO)


def _line_of(src_lines: List[str], node: ast.AST) -> str:
    i = getattr(node, "lineno", 0)
    if 1 <= i <= len(src_lines):
        return src_lines[i - 1].strip()
    return ""


def _is_scatter_call(node: ast.Call) -> bool:
    """``X.scatter_(...)`` and the rest of the family."""
    return isinstance(node.func, ast.Attribute) and node.func.attr in _SCATTER_METHODS


def _is_cuda_bringup(node: ast.Call) -> bool:
    """``torch.cuda.is_available()`` and its siblings, through any receiver
    whose last name is ``cuda`` (``torch.cuda``, an imported ``cuda``)."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr in _BRINGUP_ATTRS):
        return False
    recv = f.value
    return (isinstance(recv, ast.Attribute) and recv.attr == "cuda") or (
        isinstance(recv, ast.Name) and recv.id == "cuda")


def _open_write_target(node: ast.Call) -> str:
    """For ``open(path, mode)`` calls whose mode writes, the unparsed
    path expression; '' otherwise."""
    f = node.func
    if not (isinstance(f, ast.Name) and f.id == "open"):
        return ""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return ""
    if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)):
        return ""
    if not any(c in mode.value for c in "wa+x"):
        return ""
    if not node.args:
        return ""
    return ast.unparse(node.args[0])


def lint_file(path: str, rel: str) -> List[Finding]:
    with open(path) as fh:
        src = fh.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [
            Finding(
                rule="STPU101",
                surface=f"ast:{rel}",
                file=rel,
                line=e.lineno or 0,
                message=f"source failed to parse: {e.msg}",
                excerpt="",
            )
        ]
    lines = src.splitlines()
    in_models = f"{os.sep}models{os.sep}" in path
    in_backend = os.path.basename(path) == "backend.py"
    in_durable_owner = (
        os.path.basename(path) == "checkpoint.py"
        or f"{os.sep}obs{os.sep}" in path
    )
    in_analysis = f"{os.sep}analysis{os.sep}" in path

    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if in_models and _is_scatter_call(node):
            out.append(
                Finding(
                    rule="STPU101",
                    surface=f"ast:{rel}",
                    file=rel,
                    line=node.lineno,
                    message=(
                        "scatter-family write in model kernel code: route it "
                        "through packing.Layout.set/set_ (one index per row; "
                        "STPU001's source form)"
                    ),
                    excerpt=_line_of(lines, node),
                )
            )
        if not in_backend and not in_analysis and _is_cuda_bringup(node):
            out.append(
                Finding(
                    rule="STPU102",
                    surface=f"ast:{rel}",
                    file=rel,
                    line=node.lineno,
                    message=(
                        "CUDA probe or bring-up outside backend.py: the shape "
                        "of a quiet CPU fallback, which the port forbids; go "
                        "through backend.py or justify a waiver"
                    ),
                    excerpt=_line_of(lines, node),
                )
            )
        if not in_durable_owner and not in_analysis:
            target = _open_write_target(node)
            if target and any(h in target.lower() for h in _DURABLE_HINTS):
                out.append(
                    Finding(
                        rule="STPU103",
                        surface=f"ast:{rel}",
                        file=rel,
                        line=node.lineno,
                        message=(
                            "non-atomic write to a checkpoint/heartbeat "
                            "path outside checkpoint.py/obs/: watchdogs "
                            "and resume can observe a torn file — write "
                            "through the owning codec (tmp + os.replace)"
                        ),
                        excerpt=_line_of(lines, node),
                    )
                )
    return out


def run_ast_pass(root: str = _PKG) -> List[Finding]:
    findings: List[Finding] = []
    for path, rel in iter_sources(root):
        findings.extend(lint_file(path, rel))
    return findings
