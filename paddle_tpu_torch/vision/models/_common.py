"""What the zoo's constructors share."""
from __future__ import annotations


def no_pretrained(pretrained):
    """``pretrained=True`` raises, as in the JAX package: no weights are
    bundled and nothing is downloaded."""
    if pretrained:
        raise ValueError("pretrained weights are not bundled; load a local "
                         "state dict with models.load_jax_state instead")
