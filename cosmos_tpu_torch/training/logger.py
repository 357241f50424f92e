"""Logging setup (counterpart of ``cosmos_tpu/training/logger.py``)."""

from __future__ import annotations

import logging


def setup_logging(log_file=None, level=logging.INFO, include_host=False):
    if include_host:
        import socket

        hostname = socket.gethostname()
        fmt = f"%(asctime)s | {hostname} | %(levelname)s | %(message)s"
    else:
        fmt = "%(asctime)s | %(levelname)s | %(message)s"
    formatter = logging.Formatter(fmt, datefmt="%Y-%m-%d,%H:%M:%S")

    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    root.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        root.addHandler(fh)
    # PIL logs every image plugin it tries at DEBUG
    logging.getLogger("PIL").setLevel(logging.INFO)
