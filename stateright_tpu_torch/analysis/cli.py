"""stpu-lint orchestration and CLI (``python -m stateright_tpu_torch.analysis``).

Counterpart of ``stateright_tpu/analysis/cli.py``, with its flags, report
schema and exit codes. It runs on the CPU with no device access: the
surface sweep traces model kernels on fake tensors, prices capture plans,
builds the admission check's checker on the CPU and compiles ``csrc/`` with
``nvcc`` where there is one (``surfaces.py``); the AST pass parses the
package source (``astlint.py``); findings are filtered through the waiver
file (``rules.py``). Exit codes:

- 0: clean (waived findings allowed; they are reported, not counted),
- 1: unwaived findings,
- 2: infrastructure error (a surface failed to trace, a malformed waiver
  file, a spec that does not resolve): the tree was NOT verified.

``--json`` / ``--json-out`` emit the machine-readable report; the checker
service's admission gate reads ``--admission SPEC --json``
(``service/core.py``, through ``tools/stpu_lint.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from .rules import RULES, Finding, WaiverError, apply_waivers, load_waivers

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
DEFAULT_WAIVERS = os.path.join(_HERE, "waivers.toml")
DEFAULT_CENSUS_OUT = os.path.join(_REPO, "runs", "torch_compile_plan.json")
#: The rule kinds the surface sweep checks (the AST pass owns "ast").
SWEPT_KINDS = ("fx", "cuda", "plan", "admission")


def run_lint(
    *,
    trace: bool = True,
    ast_pass: bool = True,
    full: bool = False,
    only: Optional[List[str]] = None,
    rules: Optional[List[str]] = None,
    waivers_path: Optional[str] = DEFAULT_WAIVERS,
    admission: Optional[str] = None,
    use_cache: bool = True,
    cache_dir: Optional[str] = None,
) -> dict:
    """The whole lint as a dict report (the CLI's JSON schema; the tests and
    the service's admission gate consume it). ``admission`` swaps the sweep
    for one spec's flight-check subset (``surfaces.build_admission_sweep``);
    the AST pass is whole-package and is skipped there."""
    t0 = time.monotonic()
    waivers = load_waivers(waivers_path)
    if admission is not None:
        ast_pass = False

    findings: List[Finding] = []
    surfaces = []
    errors: List[str] = []
    # A --rules filter naming only AST rules never needs the (much slower)
    # surface sweep, and one naming no AST rule never needs the AST pass.
    if rules:
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            raise ValueError(f"unknown rule(s) {unknown}; known: {sorted(RULES)}")
        kinds = {RULES[r].kind for r in rules}
        trace = trace and bool(kinds & set(SWEPT_KINDS))
        ast_pass = ast_pass and "ast" in kinds
    if trace:
        from .surfaces import run_sweep

        for rep in run_sweep(
            full=full,
            only=only,
            admission_spec=admission,
            use_cache=use_cache,
            cache_dir=cache_dir,
        ):
            surfaces.append(
                {
                    "name": rep.name,
                    "seconds": rep.seconds,
                    "findings": len(rep.findings),
                    "error": rep.error,
                    "skipped": rep.skipped,
                    "cached": rep.cached,
                    **({"detail": rep.detail} if rep.detail else {}),
                }
            )
            findings.extend(rep.findings)
            if rep.error:
                errors.append(f"{rep.name}: {rep.error}")
    if ast_pass:
        from .astlint import run_ast_pass

        findings.extend(run_ast_pass())

    if rules:
        keep = set(rules)
        findings = [f for f in findings if f.rule in keep]

    active, waived, unused = apply_waivers(findings, waivers)
    # An EXPIRED waiver stopped suppressing (its findings are active above)
    # and is always reported: unlike a merely stale one it is actionable on
    # any run, partial or not.
    expired = [w for w in unused if w.expired]
    # A filtered run is PARTIAL: its verdict covers only what it swept, so
    # stale-waiver detection is suppressed (a live waiver's findings may
    # simply never have fired), and the flag rides in the report.
    partial = bool(rules or only or admission or not (trace and ast_pass))
    if partial:
        unused = expired
    return {
        "ok": not active and not errors,
        "partial": partial,
        "admission": admission,
        "elapsed_s": round(time.monotonic() - t0, 2),
        "surfaces": surfaces,
        "findings": [f.to_json() for f in active],
        "waived": [f.to_json() for f in waived],
        "unused_waivers": [
            {
                "rule": w.rule,
                "surface": w.surface,
                "file": w.file,
                "reason": w.reason,
                "expires": w.expires,
                "expired": w.expired,
            }
            for w in unused
        ],
        "errors": errors,
        "rules": {r.id: r.title for r in RULES.values()},
    }


def _print_human(report: dict) -> None:
    for f in report["findings"] + report["waived"]:
        print(Finding(**{k: f[k] for k in (
            "rule", "surface", "file", "line", "message", "excerpt",
            "waived", "waiver_reason")}).format())
    for e in report["errors"]:
        print(f"ERROR: {e}")
    for s in report["surfaces"]:
        if s.get("skipped"):
            print(f"skipped {s['name']}: {s['skipped']}")
    for w in report["unused_waivers"]:
        if w.get("expired"):
            print(
                f"EXPIRED waiver (no longer suppressing since "
                f"{w['expires']}): {w['rule']} surface={w['surface']!r} "
                f"file={w['file']!r} — renew with a fresh justification "
                "or fix the finding"
            )
        else:
            print(
                f"stale waiver (matched nothing): {w['rule']} "
                f"surface={w['surface']!r} file={w['file']!r} — prune it"
            )
    n_surf = len(report["surfaces"])
    n_cached = sum(1 for s in report["surfaces"] if s.get("cached"))
    print(
        f"stpu-lint: {n_surf} surfaces ({n_cached} cached), "
        f"{len(report['findings'])} finding(s), "
        f"{len(report['waived'])} waived, "
        f"{len(report['errors'])} error(s) "
        f"in {report['elapsed_s']}s -> "
        + ("OK" if report["ok"] else "FAIL")
    )


def write_sarif(report: dict, path: str) -> None:
    """The report as SARIF 2.1.0 (code-scanning annotations: one result per
    finding, waived ones at ``note`` level)."""
    results = []
    for f, level in [(f, "error") for f in report["findings"]] + [
        (f, "note") for f in report["waived"]
    ]:
        msg = f["message"]
        if f.get("waiver_reason"):
            msg += f" [waived: {f['waiver_reason']}]"
        result = {
            "ruleId": f["rule"],
            "level": level,
            "message": {"text": f"[{f['surface']}] {msg}"},
        }
        if f["file"]:
            result["locations"] = [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f["file"]},
                        "region": {"startLine": max(f["line"], 1)},
                    }
                }
            ]
        results.append(result)
    sarif = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "stpu-lint",
                        "informationUri": "stateright_tpu_torch/analysis/rules.py",
                        "rules": [
                            {
                                "id": r.id,
                                "shortDescription": {"text": r.title},
                                "fullDescription": {"text": r.history},
                            }
                            for r in RULES.values()
                        ],
                    }
                },
                "results": results,
            }
        ],
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(sarif, fh, indent=1)


def _bank_census(path: str) -> None:
    """Write the STPU007 census of every shipped spec to ``path``, keyed by
    the tree it describes."""
    from .cache import tree_hash
    from .census import build_census

    census = build_census()
    census["tree"] = tree_hash()[:12]
    census["generated_unix_ts"] = time.time()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(census, fh, indent=1)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m stateright_tpu_torch.analysis",
        description=(
            "stpu-lint for the PyTorch port: the pinned rules over every "
            "shipped model kernel, CUDA source and capture plan"
        ),
    )
    p.add_argument("--json", action="store_true", help="JSON report on stdout")
    p.add_argument("--json-out", metavar="PATH", help="also write the JSON report here")
    p.add_argument(
        "--rules",
        metavar="IDS",
        help="comma-separated rule filter, e.g. STPU001,STPU006",
    )
    p.add_argument(
        "--only",
        metavar="SUBSTR",
        action="append",
        help="only surfaces whose name contains SUBSTR (repeatable)",
    )
    p.add_argument(
        "--waivers",
        default=DEFAULT_WAIVERS,
        help="waiver file (default: stateright_tpu_torch/analysis/waivers.toml)",
    )
    p.add_argument(
        "--no-trace", action="store_true",
        help="skip the surface sweep (kernels, CUDA sources, plans, admission)",
    )
    p.add_argument("--no-ast", action="store_true", help="skip the AST pass")
    p.add_argument(
        "--full",
        action="store_true",
        help="also price the mux and symmetry capture classes of every plan",
    )
    p.add_argument(
        "--admission",
        metavar="SPEC",
        help="one spec's admission flight-check (admission rules, kernel "
        "graphs, capture census): what CheckerService runs at submit; "
        "implies a partial report",
    )
    p.add_argument(
        "--no-cache",
        action="store_true",
        help="ignore the content-hash per-surface result cache "
        "(runs/torch_lint_cache) and check everything afresh",
    )
    p.add_argument(
        "--sarif",
        metavar="PATH",
        help="also write the report as SARIF 2.1.0 (code-scanning annotations)",
    )
    p.add_argument(
        "--census-out",
        metavar="PATH",
        default=DEFAULT_CENSUS_OUT,
        help="where a clean full run writes the STPU007 capture census "
        "(default: runs/torch_compile_plan.json)",
    )
    p.add_argument(
        "--list-rules", action="store_true", help="print the rule registry and exit"
    )
    args = p.parse_args(argv)

    if args.list_rules:
        for r in RULES.values():
            print(f"{r.id} [{r.kind}] {r.title}\n    {r.history}\n")
        return 0

    rules = None
    if args.rules:
        rules = [s.strip() for s in args.rules.split(",") if s.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"unknown rule(s): {unknown}; known: {sorted(RULES)}", file=sys.stderr)
            return 2

    try:
        report = run_lint(
            trace=not args.no_trace,
            ast_pass=not args.no_ast,
            full=args.full,
            only=args.only,
            rules=rules,
            waivers_path=args.waivers,
            admission=args.admission,
            use_cache=not args.no_cache,
        )
    except WaiverError as e:
        print(f"waiver file error: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        # A spec that does not resolve (an unknown family, a bad
        # STPU_FAMILIES entry) is an infrastructure verdict. With --json it
        # still goes to stdout as a parseable not-ok report: the service's
        # admission gate must REJECT such a spec, not fail open as if the
        # lint itself had crashed.
        print(f"stpu-lint error: {e}", file=sys.stderr)
        if args.json:
            json.dump(
                {
                    "ok": False,
                    "partial": True,
                    "admission": args.admission,
                    "surfaces": [],
                    "findings": [],
                    "waived": [],
                    "unused_waivers": [],
                    "errors": [f"{type(e).__name__}: {e}"],
                },
                sys.stdout,
                indent=1,
            )
            print()
        return 2

    # A CLEAN full (non-partial) run banks the STPU007 census as the
    # capture-plan artifact. A failing run banks nothing (the artifact
    # describes a verified tree), and a census crash must not eat the
    # report or the exit code.
    if report["ok"] and not report["partial"] and not args.no_trace and args.census_out:
        try:
            _bank_census(args.census_out)
        except Exception as e:  # noqa: BLE001 - the sweep's verdict stands
            print(f"census bank failed: {e}", file=sys.stderr)

    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump(report, fh, indent=1)
    if args.sarif:
        write_sarif(report, args.sarif)
    if args.json:
        json.dump(report, sys.stdout, indent=1)
        print()
    else:
        _print_human(report)

    if report["errors"]:
        return 2
    return 0 if report["ok"] else 1
