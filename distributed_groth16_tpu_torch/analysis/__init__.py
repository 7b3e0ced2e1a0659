"""dg16lint — project-native static analysis for distributed_groth16_tpu,
run over the PyTorch port (distributed_groth16_tpu_torch): the JAX
package's analysis/, its rules DG101-DG108 unchanged, pointed at the
port's package, its utils/config.py, its metric catalog
(docs/torch/OBSERVABILITY.md) and its baseline.

The zkSaaS design's core guarantee is that no single server learns the
witness; the repo's failure modes (blocked event loops, mismatched
king/client collectives, secret values reaching a log line or a metric
label, jitted code silently falling back to Python control flow) are
exactly the bugs tests miss and an AST pass catches. This package is a
small rule framework plus seven project-specific rules:

    DG101  async-blocking        blocking calls inside ``async def``
    DG102  secret-taint          witness/trapdoor identifiers at log/span/
                                 metric/DTO/dump sinks; unstripped
                                 ProvingKey reaching serialization
    DG103  env-knob discipline   DG16_* env reads outside utils/config.py;
                                 knobs declared but undocumented
    DG104  metric-catalog drift  code registrations vs the
                                 docs/OBSERVABILITY.md catalog
    DG105  lock-discipline       ``# guarded-by: _lock`` attributes mutated
                                 outside ``with self._lock``
    DG106  tracer-hygiene        Python control flow on traced values in
                                 jit/mesh_jit/shard_map functions
    DG107  collective-pairing    king/client MpcNet collective sequences
                                 must pair up (static deadlock detector)

Run it with ``python -m distributed_groth16_tpu_torch.analysis`` or
``python distributed_groth16_tpu_torch/tools/dg16lint.py`` (the latter
needs no third-party deps — the whole package is stdlib-only and
self-contained; nothing here may import jax, torch or any sibling
package). Findings are suppressed inline with
``# dg16lint: disable=DG1xx`` (same line) or
``# dg16lint: disable-file=DG1xx`` (whole file), or grandfathered in the
checked-in baseline
(``distributed_groth16_tpu_torch/tools/dg16lint-baseline.json``). See
docs/STATIC_ANALYSIS.md for the rule catalog.
"""

from .core import Finding, Module, Project, Rule, all_rules, rule  # noqa: F401
from .cli import main  # noqa: F401
