"""``paddle.profiler`` of the port (``paddle_tpu.profiler`` counterpart):
the scheduler state machine, ``RecordEvent`` host spans, the chrome
export and the summary, with the device trace taken by
``torch.profiler``."""
from .profiler import (  # noqa: F401
    Profiler,
    ProfilerState,
    ProfilerTarget,
    RecordEvent,
    export_chrome_tracing,
    load_profiler_result,
    make_scheduler,
)
from .profiler_statistic import SortedKeys  # noqa: F401
