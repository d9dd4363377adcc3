"""Logger, experiment folder layout and metrics writer: the port's copy of
``sug_tpu/utils/logging.py``. The metrics writer writes the JSONL file
only (no tensorboardX)."""

from __future__ import annotations

import json
import logging
import os
from datetime import datetime
from typing import Optional


def create_logger(log_file: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger("sug_tpu_torch")
    logger.setLevel(logging.INFO)
    formatter = logging.Formatter(
        "%(asctime)s %(filename)s %(funcName)s %(lineno)d %(levelname)5s  %(message)s"
    )
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)
    console = logging.StreamHandler()
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(filename=log_file)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def exp_log_folder_creator(cfg, extra_tag: Optional[str] = None):
    """Create the output and checkpoint directories,
    ``DATA_ROOT/output/EXTRA_TAG[/source]``, with a timestamp suffix when one
    exists already."""
    today_str = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    data_root = cfg["DATA_ROOT"]
    dir_root = data_root if "data" in data_root else os.path.join(data_root, "PointDA_data/")
    output_dir = os.path.join(dir_root, "output", cfg["EXTRA_TAG"])
    ckpt_dir = os.path.join(output_dir, "ckpt", cfg.get("EXPERIMENT", "exp"), cfg["EXTRA_TAG"])
    if extra_tag is not None:
        output_dir = os.path.join(output_dir, extra_tag)
        ckpt_dir = os.path.join(ckpt_dir, extra_tag)
    if os.path.exists(output_dir):
        output_dir = os.path.join(output_dir, today_str)
    os.makedirs(output_dir)
    if os.path.exists(ckpt_dir):
        ckpt_dir = os.path.join(ckpt_dir, today_str)
    os.makedirs(ckpt_dir)
    return output_dir, ckpt_dir


def open_run(cfg, source: str, log_stem: str):
    """The run's folders (``exp_log_folder_creator`` tagged by ``source``),
    a logger writing to ``<output_dir>/<log_stem><timestamp>.txt`` too, and a
    ``MetricsWriter`` under ``<output_dir>/metrics``. Returns (ckpt_dir,
    logger, writer)."""
    output_dir, ckpt_dir = exp_log_folder_creator(cfg, extra_tag=source)
    log_name = log_stem + datetime.now().strftime("%Y%m%d-%H%M%S") + ".txt"
    logger = create_logger(log_file=os.path.join(output_dir, log_name))
    return ckpt_dir, logger, MetricsWriter(os.path.join(output_dir, "metrics"))


class MetricsWriter:
    """Scalar metrics as JSON lines, ``{"tag", "value", "step"}``, in
    ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
