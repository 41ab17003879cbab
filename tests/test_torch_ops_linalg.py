"""Parity sweep of the port's registered ops against the JAX package:
linear algebra (``paddle_tpu_torch.ops.linalg``).
Forward values and dtypes, and gradients where the registry sweep's spec
marks the op differentiable; f32 to 1e-5 relative (1e-6 absolute), the
decompositions, inverses and solves to 1e-4 (1e-5): f32 rounding grows
with the draw's condition number (``_torch_op_specs.tolerance``)."""
import pytest

from _torch_op_parity import check, family


@pytest.mark.parametrize("name", family("ops.linalg"))
def test_op_matches_jax(name):
    check(name)
