#!/usr/bin/env python3
"""dg16lint over the PyTorch port — a dependency-free launcher.

``python -m distributed_groth16_tpu_torch.analysis`` imports the package
__init__, which imports torch; this launcher loads the (stdlib-only)
``analysis`` subpackage directly by file path so the lint runs on a bare
interpreter, as the JAX package's tools/dg16lint does. Same CLI, same
exit codes:

    python distributed_groth16_tpu_torch/tools/dg16lint.py --strict
"""

import importlib.util
import sys
from pathlib import Path


def _load_analysis():
    pkg_dir = Path(__file__).resolve().parent.parent / "analysis"
    spec = importlib.util.spec_from_file_location(
        "dg16lint_torch_analysis",
        pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)],
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["dg16lint_torch_analysis"] = mod
    spec.loader.exec_module(mod)
    return mod


if __name__ == "__main__":
    sys.exit(_load_analysis().main())
