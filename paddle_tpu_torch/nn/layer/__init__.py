"""Layers of the port (``paddle_tpu.nn.layer`` counterparts)."""
from . import loss  # noqa: F401
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import LSTM  # noqa: F401
from .transformer import *  # noqa: F401,F403
