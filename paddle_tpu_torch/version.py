"""``paddle.version`` (``paddle_tpu.version`` counterpart): the fields
describe the port's own build, as the JAX package's describe its build:
a CUDA build when torch is one (``cuda_version`` is
``torch.version.cuda``), no TPU."""
import torch as _torch

full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
istaged = False
commit = "unknown"
with_gpu = "ON" if _torch.version.cuda else "OFF"
with_tpu = "OFF"
cuda_version = _torch.version.cuda or "False"
cudnn_version = str(_torch.backends.cudnn.version()) \
    if _torch.backends.cudnn.is_available() else "False"


def show():
    print(f"paddle-tpu {full_version} (the PyTorch/CUDA port, torch "
          f"{_torch.__version__}, CUDA {cuda_version})")


def cuda():
    """The CUDA version the port's torch was built with, or False."""
    return _torch.version.cuda or False


def tpu():
    return False
