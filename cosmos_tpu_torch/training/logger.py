"""Logging setup (counterpart of ``cosmos_tpu/training/logger.py``)."""

from __future__ import annotations

import logging


def setup_logging(log_file=None, level=logging.INFO, include_host=False,
                  rank=None):
    """Lines on stderr and in ``log_file``; with the host name and, when
    ``rank`` is given, the rank of a data-parallel run."""
    where = ""
    if include_host:
        import socket

        where += f"{socket.gethostname()} | "
    if rank is not None:
        where += f"rank {rank} | "
    fmt = f"%(asctime)s | {where}%(levelname)s | %(message)s"
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
