"""``paddle_tpu.distribution`` counterpart: probability distributions over
the port's Tensors, in torch on the parameters' device, drawing from the
port's generators (``paddle_tpu_torch.seed`` steers them); the KL
registry and the transforms."""
from .distributions import (  # noqa: F401
    Bernoulli,
    Beta,
    Categorical,
    Dirichlet,
    Distribution,
    Exponential,
    ExponentialFamily,
    Gamma,
    Geometric,
    Gumbel,
    Independent,
    Laplace,
    LogNormal,
    Multinomial,
    Normal,
    Poisson,
    Uniform,
    kl_divergence,
    register_kl,
)
from .transform import (  # noqa: F401
    AbsTransform,
    AffineTransform,
    ChainTransform,
    ExpTransform,
    PowerTransform,
    SigmoidTransform,
    SoftmaxTransform,
    TanhTransform,
    Transform,
    TransformedDistribution,
)
