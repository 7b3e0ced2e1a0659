"""Rule modules — importing this package registers every DG1xx rule."""

from . import (  # noqa: F401
    dg101_async_blocking,
    dg102_secret_taint,
    dg103_env_knobs,
    dg104_metric_catalog,
    dg105_lock_discipline,
    dg106_tracer_hygiene,
    dg107_collective_pairing,
    dg108_print_discipline,
)
