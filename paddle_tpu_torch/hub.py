"""``paddle.hub`` (``paddle_tpu.hub`` counterpart): ``list``, ``help``
and ``load`` of the entry points of a local ``hubconf.py``
(``source="local"``; the github and gitee sources need the network and
raise, as in the JAX package)."""
from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

_HUBCONF = "hubconf.py"
_MODULE = "paddle_tpu_torch_hubconf"


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {_HUBCONF} in {repo_dir}")
    spec = importlib.util.spec_from_file_location(_MODULE, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_MODULE] = mod
    spec.loader.exec_module(mod)
    return mod


def _check_source(source):
    if source not in ("local",):
        raise RuntimeError(
            f"hub source {source!r} needs network egress (not available in "
            "this build); use source='local' with a checked-out repo dir")


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return [k for k, v in vars(mod).items()
            if callable(v) and not k.startswith("_")]


def _resolve(repo_dir, model, source):
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    fn = getattr(mod, model, None)
    if fn is None:
        raise ValueError(f"model {model!r} not in {repo_dir}/{_HUBCONF}")
    return fn


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    return _resolve(repo_dir, model, source).__doc__


def load(repo_dir, model, source="local", force_reload=False, **kwargs):
    return _resolve(repo_dir, model, source)(**kwargs)
