"""stpu-lint for the port: static checks of the shipped model kernels' aten
graphs, the CUDA sources, the capture plans and the package source.

Counterpart of ``stateright_tpu/analysis``. CLI: ``python -m
stateright_tpu_torch.analysis`` (wrapped by
``stateright_tpu_torch/tools/stpu_lint.py``, which the checker service runs
at submit with ``--admission SPEC --json``); library entry:
:func:`run_lint`. The rules and what each means on CUDA are in
``rules.py``.
"""

from .rules import (  # noqa: F401
    MAX_CAPTURES,
    RULES,
    Finding,
    Rule,
    Waiver,
    WaiverError,
    apply_waivers,
    load_waivers,
)
from .cli import DEFAULT_WAIVERS, main, run_lint  # noqa: F401
