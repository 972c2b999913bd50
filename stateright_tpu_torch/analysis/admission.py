"""The admission flight-check: one spec, checked in a fresh process.

The port's counterpart of ``stateright_tpu/analysis/cli.py``'s
``--admission`` mode, which ``CheckerService.submit`` runs as a subprocess
(``python admission.py --admission SPEC --json``). It checks what has a
meaning before the reference's kernel and lowering rules do (ROADMAP A10d):
the spec resolves, in a process of its own, to a packed model that
``spawn_xla`` accepts. The JSON verdict carries the reference's keys
(``ok``, ``findings`` of ``rule``/``surface``/``message``, ``waived``,
``errors``, ...), so the service reads either package's report alike.

Rules of this check (the reference's STPU001-008 wait for A10d):

- ``ADM001`` -- the model lacks the packed interface the GPU engine needs
  (the missing attributes are named);
- ``ADM002`` -- ``spawn_xla`` refuses the model: building its checker on
  the CPU at the spec's capacities raised.

A spec that does not resolve at all (an unknown family, an
``STPU_FAMILIES`` module that cannot load) is a caller defect, not a
finding: the report is not ok and names it under ``errors``, and the exit
code is 2, as the reference's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

RULES = {
    "ADM001": "spec resolves to a model without the packed interface",
    "ADM002": "spawn_xla refuses the packed model",
}


def _finding(rule: str, spec: str, message: str) -> dict:
    return {"rule": rule, "surface": f"admission:{spec}", "message": message,
            "file": None, "line": None}


def check_spec(spec: str) -> dict:
    """The admission report of ``spec``; raises ``ValueError`` when the spec
    does not resolve."""
    from stateright_tpu_torch.service.registry import resolve
    from stateright_tpu_torch.xla import PACKED_ATTRS, is_packed

    t0 = time.monotonic()
    model, caps = resolve(spec)
    findings = []
    if not is_packed(model):
        missing = [a for a in PACKED_ATTRS if not hasattr(model, a)]
        findings.append(_finding(
            "ADM001", spec,
            f"{type(model).__name__} lacks the packed interface: {', '.join(missing)}"))
    else:
        try:
            model.checker().spawn_xla(device="cpu", **caps)
        except Exception as e:  # noqa: BLE001 - the refusal IS the finding
            findings.append(_finding(
                "ADM002", spec, f"spawn_xla refused {type(model).__name__}: "
                f"{type(e).__name__}: {e}"))
    return {
        "ok": not findings,
        "partial": True,
        "admission": spec,
        "elapsed_s": round(time.monotonic() - t0, 2),
        "surfaces": [{"name": f"admission:{spec}", "seconds": round(time.monotonic() - t0, 3),
                      "findings": len(findings), "error": None, "skipped": False,
                      "cached": False}],
        "findings": findings,
        "waived": [],
        "unused_waivers": [],
        "errors": [],
        "rules": dict(RULES),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--admission", metavar="SPEC", required=True,
                   help="one spec's admission flight-check")
    p.add_argument("--json", action="store_true", help="print the report as JSON")
    args = p.parse_args(argv)
    try:
        report = check_spec(args.admission)
        rc = 0 if report["ok"] else 1
    except ValueError as e:
        # A spec that cannot even resolve is a spec defect: a parseable
        # not-ok report, so the service REJECTS it instead of failing open.
        print(f"admission error: {e}", file=sys.stderr)
        report = {"ok": False, "partial": True, "admission": args.admission,
                  "surfaces": [], "findings": [], "waived": [], "unused_waivers": [],
                  "errors": [f"{type(e).__name__}: {e}"]}
        rc = 2
    if args.json:
        json.dump(report, sys.stdout, indent=1)
        print()
    else:
        for f in report["findings"]:
            print(f"{f['rule']} {f['surface']}: {f['message']}")
        for e in report["errors"]:
            print(f"error: {e}")
        print("ok" if report["ok"] else "not ok")
    return rc


if __name__ == "__main__":
    sys.exit(main())
