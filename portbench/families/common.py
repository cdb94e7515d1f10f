"""What the families share: the system's flags from a configuration's
file, the check that the system's dataset configuration is the file's,
and loading a state dict into a model built on the meta device."""

from __future__ import annotations

import numpy as np
import torch


def argv(flags: dict) -> list[str]:
    """``{"num_point": 40000, "use_height": true}`` -> the command line
    ``--num_point 40000 --use_height``."""
    out = []
    for key, value in flags.items():
        if value is True:
            out.append(f"--{key}")
        elif value is not False:
            out += [f"--{key}", str(value)]
    return out


def check_config(config: dict, cfg) -> None:
    """Refuse to run where the system's dataset configuration differs from
    the configuration's file: both sides have to see one model."""
    m = config["model"]
    same = (cfg.num_class == m["num_class"]
            and cfg.num_heading_bin == m["num_heading_bin"]
            and cfg.num_size_cluster == m["num_size_cluster"]
            and cfg.max_num_obj == config["max_num_obj"]
            and np.array_equal(np.asarray(cfg.mean_size_arr, np.float32),
                               np.asarray(config["mean_size_arr"],
                                          np.float32)))
    if not same:
        raise ValueError(f"the system's {cfg.name} differs from the"
                         " configuration's file")


def check_train(config: dict, **system) -> None:
    """Refuse to run where the system's training settings differ from the
    reference's (the file's ``train``)."""
    for key, value in system.items():
        if value != config["train"][key]:
            raise ValueError(f"train {key}: the system takes {value}, the"
                             f" file {config['train'][key]}")


def load(model: torch.nn.Module, device, weights: dict) -> torch.nn.Module:
    """`model` (built on the meta device) on `device` with `weights`."""
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model
