"""paddle_tpu_torch.testing — the fault-injection seams the serving path
marks (:mod:`faults`)."""
from . import faults  # noqa: F401
from .faults import FaultInjected, fault_point, inject  # noqa: F401

__all__ = ["faults", "FaultInjected", "fault_point", "inject"]
