"""``incubate/sparse/unary.py`` names (the value-wise ops)."""
from ...sparse import (abs, asin, asinh, atan, atanh, cast,  # noqa: F401
                       divide_scalar, expm1, leaky_relu, log1p, pow,
                       relu, relu6, scale, sin, sinh, softmax, sqrt, square,
                       tan, tanh, transpose)
