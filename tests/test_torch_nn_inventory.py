"""The names of ``paddle_tpu.nn`` and ``paddle_tpu.nn.functional`` against
the port's: every public name is in the port except the ones listed here,
each under the module that will bring it (ROADMAP.md, module entry 7) or
with the reason it is not ported.  The lists are exact: a name ported
later must leave them."""
import types

import pytest

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
import paddle_tpu_torch
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as pF

# left for the next slice, in the order ROADMAP.md queues them
NEXT_NN = {
    "nn/layer/rnn.py": {"RNNCellBase", "SimpleRNNCell", "LSTMCell",
                        "GRUCell", "RNN", "BiRNN", "SimpleRNN", "GRU"},
    "nn/layer/extra.py": {"BeamSearchDecoder", "Fold", "HSigmoidLoss",
                          "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
                          "MultiLabelSoftMarginLoss", "PairwiseDistance",
                          "SoftMarginLoss", "Softmax2D", "ThresholdedReLU",
                          "TripletMarginWithDistanceLoss", "dynamic_decode",
                          "Unfold"},
    "nn/utils.py": {"utils", "spectral_norm"},
    "nn/layout.py": {"layout", "channels_last", "is_channels_last"},
    "nn/meta.py": {"meta", "abstract_init", "is_abstract_init"},
    "nn/quant.py": {"quant"},
}
NEXT_F = {
    "nn/functional/extra.py": {
        "extra", "dice_loss", "npair_loss", "zeropad2d", "pairwise_distance",
        "soft_margin_loss", "multi_label_soft_margin_loss",
        "triplet_margin_with_distance_loss", "thresholded_relu",
        "hsigmoid_loss", "margin_cross_entropy", "sparse_attention",
        "max_unpool1d", "max_unpool3d", "elu_", "softmax_", "tanh_"},
    # ops/extended.py, re-exported by the JAX nn.functional (ROADMAP
    # module entry 6)
    "ops/extended.py": {"affine_grid", "diag_embed", "gather_tree",
                        "grid_sample", "max_unpool2d", "temporal_shift"},
}
NOT_PORTED_F = {
    # helpers the JAX modules' imports leak into nn.functional
    "Tensor": "helper", "apply_op": "helper", "defop": "helper",
    "get_default_dtype": "helper", "rnd": "helper",
    "to_jax": "a jnp dtype",
    # the JAX flash routing toggle (a TPU tiling threshold): the port sends
    # every mask-free call to the kernel on the card
    "enable_flash_attention": "no TPU routing threshold",
}


def _public(mod):
    out = set()
    for n, v in vars(mod).items():
        if n.startswith("_") or n == "annotations":
            continue
        if isinstance(v, types.ModuleType):
            if v.__name__.startswith("paddle_tpu."):
                out.add(n)
            continue
        owner = getattr(v, "__module__", None)
        if (isinstance(v, type) or callable(v)) and owner is not None and \
                not owner.startswith("paddle_tpu"):
            continue
        out.add(n)
    return out


@pytest.mark.parametrize("jmod,pmod,listed", [
    (jnn, pnn, set().union(*NEXT_NN.values())),
    (jF, pF, set().union(*NEXT_F.values()) | set(NOT_PORTED_F))],
    ids=["nn", "nn.functional"])
def test_missing_names_are_exactly_the_listed_ones(jmod, pmod, listed):
    missing = _public(jmod) - set(dir(pmod))
    assert missing == listed, (sorted(missing - listed),
                               sorted(listed - missing))


def test_top_level_param_attr_and_the_layer_surface():
    assert paddle_tpu_torch.ParamAttr is pnn.ParamAttr
    for name in ("Layer", "Parameter", "ParamAttr", "initializer",
                 "functional_call", "module_fn", "state_values"):
        assert hasattr(pnn, name), name
    assert issubclass(pnn.Linear, pnn.Layer)
    assert issubclass(pnn.Parameter, paddle_tpu_torch.Tensor)
