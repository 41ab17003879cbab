"""``incubate/sparse/binary.py`` names."""
from ...sparse import (add, divide, masked_matmul, matmul,  # noqa: F401
                       multiply, mv, subtract)
