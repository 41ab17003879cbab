"""``incubate/sparse/multiary.py`` names."""
from ...sparse import addmm  # noqa: F401
