"""paddle_tpu_torch.testing — the fault-injection seams the serving path
marks (:mod:`faults`) and the seeded trace generators that drive it
(:mod:`load_gen`)."""
from . import faults  # noqa: F401
from . import load_gen  # noqa: F401
from .faults import FaultInjected, fault_point, inject  # noqa: F401

__all__ = ["faults", "load_gen", "FaultInjected", "fault_point", "inject"]
