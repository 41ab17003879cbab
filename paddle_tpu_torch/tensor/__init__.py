"""paddle.tensor — the tensor-function namespace
(``paddle_tpu.tensor`` counterpart): the reference's import paths
(``paddle.tensor.math.add``, ``from paddle.tensor.creation import
arange``) over the functions in ``paddle_tpu_torch.ops``."""
from ..ops import (creation, extended, linalg, logic,  # noqa: F401
                   manipulation, math, search)
from ..ops import random_ops as random  # noqa: F401
from ..ops import reduction as stat  # noqa: F401
from ..ops.creation import *  # noqa: F401,F403
from ..ops.linalg import *  # noqa: F401,F403
from ..ops.logic import *  # noqa: F401,F403
from ..ops.manipulation import *  # noqa: F401,F403
from ..ops.math import *  # noqa: F401,F403
from ..ops.random_ops import *  # noqa: F401,F403
from ..ops.reduction import *  # noqa: F401,F403
from ..ops.search import *  # noqa: F401,F403
from ..ops.extended import *  # noqa: F401,F403
from ..ops.compat_surface import *  # noqa: F401,F403
