"""Config: YAML with ``_BASE_CONFIG_`` inheritance and typed
``--set KEY.SUBKEY value`` overrides. The port's own copy of
``sug_tpu/utils/config.py``, with two deliberate differences:

- ``parser_config`` returns a fresh ``ConfigDict`` on every call instead of
  filling one module-wide config, so two runs in one process share nothing;
- a ``--set`` bool stays a bool: it is not widened to 1.0 on a float key
  (only an int is), and a bool onto a float key raises.
"""

from __future__ import annotations

import argparse
import secrets
from ast import literal_eval
from pathlib import Path

import yaml


class ConfigDict(dict):
    """dict with attribute access; nested dicts are wrapped recursively."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        for k, v in {**(d or {}), **kwargs}.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                ConfigDict(v) if isinstance(v, dict) and not isinstance(v, ConfigDict) else v
                for v in value
            )
        super().__setitem__(key, value)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


def merge_new_config(config: ConfigDict, new_config: dict) -> ConfigDict:
    """Recursive merge honouring ``_BASE_CONFIG_`` file inheritance."""
    if "_BASE_CONFIG_" in new_config:
        with open(new_config["_BASE_CONFIG_"], "r") as f:
            config.update(ConfigDict(yaml.safe_load(f)))
    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if not isinstance(val, dict):
            config[key] = val
            continue
        if key not in config or not isinstance(config[key], dict):
            config[key] = ConfigDict()
        merge_new_config(config[key], val)
    return config


def cfg_from_yaml_file(cfg_file: str, config: ConfigDict) -> ConfigDict:
    with open(cfg_file, "r") as f:
        return merge_new_config(config, yaml.safe_load(f) or {})


# --set roots and dotted paths that may be created when the YAML lacks them;
# every other key must exist (typo protection)
_CREATABLE_SET_ROOTS = ("MODEL_CFG", "PRECISION")
_CREATABLE_SET_PATHS = ("DATASET.FIXED_X_ROTATION", "RANDOM_SEED")


def _parse(v: str):
    try:
        value = literal_eval(v)
    except (ValueError, SyntaxError):
        value = v
    # "--set KEY 4,5" evaluates to a tuple; lists are the config's currency
    return list(value) if isinstance(value, tuple) else value


def cfg_from_list(cfg_list, config: ConfigDict) -> None:
    """Typed dotted-path overrides: ``--set A.B 1 C.D foo``."""
    if len(cfg_list) % 2 != 0:
        raise ValueError(f"--set expects KEY VALUE pairs, got {cfg_list}")
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = config
        creatable = key_list[0] in _CREATABLE_SET_ROOTS or k in _CREATABLE_SET_PATHS
        for subkey in key_list[:-1]:
            if subkey not in d and creatable:
                d[subkey] = ConfigDict()
            if subkey not in d:
                raise KeyError(f"--set {k}: NotFoundKey: {subkey}")
            d = d[subkey]
        subkey = key_list[-1]
        if subkey not in d and not creatable:
            raise KeyError(f"--set {k}: NotFoundKey: {subkey}")
        value = _parse(v)
        old = d.get(subkey)
        if subkey not in d or type(value) is type(old):
            d[subkey] = value
        elif isinstance(old, ConfigDict):
            for src in str(v).split(","):
                cur_key, cur_val = src.split(":")
                d[subkey][cur_key] = type(d[subkey][cur_key])(cur_val)
        elif isinstance(old, list):
            d[subkey] = [type(old[0])(x) for x in str(value).split(",")]
        elif isinstance(old, float) and type(value) is int:
            d[subkey] = float(value)  # "0" onto a float key; a bool stays a bool and raises
        else:
            raise TypeError(f"--set {k}: value {v!r} parsed as {type(value).__name__}, "
                            f"but the config key is {type(old).__name__}")


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SUG DG training (PyTorch/CUDA port)")
    parser.add_argument("--cfg", type=str, default=None, help="training config yaml")
    parser.add_argument("--source", "-s", type=str, default="scannet", help="source dataset")
    parser.add_argument("--batch_size", "-b", type=int, default=64, help="batch size")
    parser.add_argument("--num_points", type=int, default=1024,
                        help="points per cloud (clouds are padded or subsampled to it)")
    parser.add_argument("--ckpt_save_interval", type=int, default=10)
    parser.add_argument("--max_ckpt_save_num", type=int, default=50)
    parser.add_argument("--fix_random_seed", action="store_true", default=False)
    parser.add_argument("--resume", type=str, default=None, help="checkpoint file to resume from")
    parser.add_argument("--pretrained_model", type=str, default=None,
                        help="checkpoint file whose weights start the run (train_source)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER,
                        help="set extra config keys [use in last position]")
    return parser


def parser_config(argv=None):
    """Parse the command line and the YAML into (args, cfg)."""
    args = build_arg_parser().parse_args(argv)
    cfg = ConfigDict(LOCAL_RANK=0)
    if args.cfg is not None:
        cfg_from_yaml_file(args.cfg, cfg)
        cfg.TAG = Path(args.cfg).stem
        cfg.EXP_GROUP_PATH = "/".join(args.cfg.split("/")[1:-1])
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def log_config_to_file(config, pre="cfg", logger=None):
    for key, val in config.items():
        if isinstance(val, ConfigDict):
            logger.info("\n%s.%s = edict()" % (pre, key))
            log_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
            continue
        logger.info("%s.%s: %s" % (pre, key, val))


def resolve_seed(args, cfg=None) -> int:
    """``--set RANDOM_SEED N`` first, then ``--fix_random_seed`` (666), else
    fresh OS entropy, as the JAX package resolves it on one process."""
    local_rank = int(cfg.get("LOCAL_RANK", 0)) if cfg is not None else 0
    if cfg is not None and cfg.get("RANDOM_SEED") is not None:
        return int(cfg["RANDOM_SEED"]) + local_rank
    if getattr(args, "fix_random_seed", False):
        return 666 + local_rank
    return int(secrets.randbits(31))
