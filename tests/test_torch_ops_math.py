"""Parity sweep of the port's registered ops against the JAX package:
elementwise and scalar math, the cumulative ops
(``paddle_tpu_torch.ops.math``).
Forward values and dtypes, and gradients where the registry sweep's spec
marks the op differentiable; f32 to 1e-5 relative (1e-6 absolute)."""
import pytest

from _torch_op_parity import check, family


@pytest.mark.parametrize("name", family("ops.math"))
def test_op_matches_jax(name):
    check(name)
