"""The op corpus.  Importing this package registers every op (and its
Tensor methods) with ``core.op.OP_REGISTRY``.  ``extended.py`` and
``compat_surface.py`` of the JAX package are not ported yet (ROADMAP
module entry 6)."""
from . import (creation, linalg, logic, manipulation, math,  # noqa: F401
               random_ops, reduction, search)
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .random_ops import *  # noqa: F401,F403
