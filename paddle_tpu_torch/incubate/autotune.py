"""``paddle_tpu.incubate.autotune`` counterpart: ``set_config`` takes the
three tuning domains ("kernel", "layout", "dataloader") as a dict, a
JSON file's path or None (every domain on), and ``get_config`` returns
them.

- kernel: the flag is recorded; the port's hand-written kernels are
  chosen by their wrappers' shape rules, so nothing is tuned.
- layout: sets the process default of ``nn.layout`` (channels-last
  construction of the image layers).
- dataloader: recorded for ``get_config()``.
"""
from __future__ import annotations

import json
import warnings

__all__ = ["set_config"]

_config = {"kernel": {"enable": False, "tuning_range": [1, 10]},
           "layout": {"enable": False},
           "dataloader": {"enable": False}}


def get_config() -> dict:
    return dict(_config)


def set_config(config=None):
    """Enable/disable the autotune domains.  config: None (enable all),
    a dict like {"kernel": {"enable": True, "tuning_range": [1, 3]}},
    or a path to a JSON file with the same shape."""
    if config is None:
        for dom in _config.values():
            dom["enable"] = True
        _apply()
        return
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise ValueError(
            "config should be a dict, a json file path, or None")
    for key in ("kernel", "layout", "dataloader"):
        if key not in config:
            continue
        dom = config[key]
        if "enable" in dom:
            if not isinstance(dom["enable"], bool):
                warnings.warn(f"{key}.enable should be bool")
            else:
                _config[key]["enable"] = dom["enable"]
        if key == "kernel" and "tuning_range" in dom:
            if isinstance(dom["tuning_range"], (list, tuple)):
                _config[key]["tuning_range"] = list(dom["tuning_range"])
            else:
                warnings.warn("kernel.tuning_range should be a list")
    _apply()


def _apply():
    from ..nn import layout as _layout
    _layout.set_global_channels_last(_config["layout"]["enable"])
