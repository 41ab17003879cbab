from .base_gate import BaseGate
from .gshard_gate import GShardGate
from .naive_gate import NaiveGate
from .switch_gate import SwitchGate

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]
