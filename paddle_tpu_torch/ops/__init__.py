"""The op corpus.  Importing this package registers every op (and its
Tensor methods) with ``core.op.OP_REGISTRY``: the ten ``ops`` modules of
the JAX package, ``extended`` and ``compat_surface`` (the top-level long
tail) included."""
from . import (compat_surface, creation, extended, linalg,  # noqa: F401
               logic, manipulation, math, random_ops, reduction, search)
from .extended import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .random_ops import *  # noqa: F401,F403
from .compat_surface import *  # noqa: F401,F403
