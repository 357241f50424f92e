"""Remote checkpoint sync and remote-capable file opening (counterpart of
``cosmos_tpu/training/file_utils.py``).

- ``remote_sync_s3``: ``aws s3 sync`` as a subprocess;
- ``remote_sync_fsspec``: any fsspec protocol; a file is copied when the
  remote one is missing or has another size (read from the remote
  filesystem's metadata, never through the mapper, which would download
  every checkpoint each period);
- both leave out ``epoch_latest`` and the ``*.tmp`` files that
  ``checkpoint.save_checkpoint`` writes before it renames them (JAX's sync
  leaves out ``epoch_latest`` only: a sync during a save would copy a
  half-written file that stays on the remote);
- ``start_sync_process``: a forkserver daemon that syncs every
  ``--remote-sync-frequency`` seconds;
- ``remote_open``: ``open`` for local paths, fsspec for ``s3://``,
  ``gs://`` and ``http(s)://``.

The module imports no torch (the forkserver child stays light) and imports
fsspec only when a sync or a remote open needs it.
"""

from __future__ import annotations

import fnmatch
import logging
import multiprocessing as mp
import os
import subprocess
import time

logger = logging.getLogger(__name__)

# what a sync leaves out: the mutable latest pointer and files in writing
EXCLUDE = ("*epoch_latest*", "*.tmp")


def _excluded(name: str) -> bool:
    return any(fnmatch.fnmatch(name, pattern) for pattern in EXCLUDE)


def remote_sync_s3(local_dir: str, remote_dir: str) -> bool:
    result = subprocess.run(
        ["aws", "s3", "sync", local_dir, remote_dir,
         *(arg for pattern in EXCLUDE for arg in ("--exclude", pattern))],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
    )
    if result.returncode != 0:
        logger.error(f"remote sync failed: {result.stderr.decode()[:500]}")
        return False
    logger.info("remote sync successful")
    return True


def remote_sync_fsspec(local_dir: str, remote_dir: str) -> bool:
    try:
        import fsspec
        import fsspec.core

        a = fsspec.get_mapper(local_dir)
        b = fsspec.get_mapper(remote_dir)
        rfs, rroot = fsspec.core.url_to_fs(remote_dir)
        try:
            remote_sizes = {
                os.path.relpath(i["name"], rroot): i.get("size")
                for i in rfs.find(rroot, detail=True).values()
            }
        except FileNotFoundError:
            remote_sizes = {}
        for k in a:
            if _excluded(k):
                continue
            local_size = os.path.getsize(os.path.join(local_dir, k))
            if remote_sizes.get(k) != local_size:
                b[k] = a[k]
        return True
    except Exception as e:
        # a boundary that must keep the run going: the trainer logs and
        # carries on without the sync
        logger.error(f"fsspec sync error: {e!r}")
        return False


def remote_sync(local_dir: str, remote_dir: str, protocol: str = "s3") -> bool:
    if protocol == "s3":
        return remote_sync_s3(local_dir, remote_dir)
    return remote_sync_fsspec(local_dir, remote_dir)


def _keep_running_remote_sync(sync_every: float, local_dir: str,
                              remote_dir: str, protocol: str) -> None:
    while True:
        time.sleep(sync_every)
        remote_sync(local_dir, remote_dir, protocol)


def start_sync_process(sync_every: float, local_dir: str, remote_dir: str,
                       protocol: str = "s3"):
    """A daemon process (not started) that syncs every ``sync_every``
    seconds; the caller starts it and terminates it at the end."""
    return mp.get_context("forkserver").Process(
        target=_keep_running_remote_sync,
        args=(sync_every, local_dir, remote_dir, protocol),
        daemon=True,
    )


def remote_open(path: str, mode: str = "rb"):
    """Open a local path, or an ``s3://``, ``gs://`` or ``http(s)://`` one
    through fsspec."""
    if path.startswith(("s3://", "gs://", "http://", "https://")):
        import fsspec

        return fsspec.open(path, mode).open()
    return open(path, mode)
