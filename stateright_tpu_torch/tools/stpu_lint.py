#!/usr/bin/env python
"""stpu-lint wrapper: ``python stateright_tpu_torch/tools/stpu_lint.py
[args]`` is ``python -m stateright_tpu_torch.analysis [args]`` from any
directory.

The checker service runs it in a subprocess at submit
(``--admission SPEC --json``, ``service/core.py``), so that the spec
resolves, and a user family imports, there and never in the service
process. Importing this module does nothing.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from stateright_tpu_torch.analysis import main

    sys.exit(main())
