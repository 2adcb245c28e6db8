"""Run-artifact stores: train/val data, checkpoints, logs per run.

A copy of ``horovod_tpu/spark/store.py`` (framework-free; the port imports
nothing of the JAX package). Reference: ``horovod/spark/common/store.py`` — ``Store`` base with
``get_train_data_path`` / ``get_val_data_path`` / ``get_checkpoint_path`` and
a scheme-based factory (``Store.create``), concrete ``LocalStore`` (a.k.a.
``FilesystemStore``), ``HDFSStore``, and ``DBFSLocalStore`` (Databricks
``dbfs:/`` → ``/dbfs`` fuse mapping).

Notes: data materialization is parquet (read back with pyarrow by
each rank — the Petastorm-analog path, see :mod:`horovod_tpu_torch.spark.util`);
checkpoints are single-blob pickles written atomically.
"""

from __future__ import annotations

import os
from typing import Optional


class Store:
    """Storage locations for intermediate data, checkpoints and logs
    (reference: store.py ``Store``)."""

    def get_train_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_val_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_test_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> str:
        raise NotImplementedError

    # -- checkpoint-blob convenience (the estimator's surface) -------------
    def save(self, run_id: str, payload: bytes) -> str:
        return self.write(self.get_checkpoint_path(run_id), payload)

    def load(self, run_id: str) -> bytes:
        return self.read(self.get_checkpoint_path(run_id))

    @staticmethod
    def create(prefix_path: str, **kwargs) -> "Store":
        """Scheme-based factory (reference: store.py ``Store.create``):
        ``hdfs://`` → HDFSStore, ``dbfs:/`` or ``/dbfs`` → DBFSLocalStore,
        anything else → LocalStore."""
        if prefix_path.startswith("hdfs://"):
            return HDFSStore(prefix_path, **kwargs)
        if prefix_path.startswith("dbfs:/") or \
                prefix_path.startswith("/dbfs"):
            return DBFSLocalStore(prefix_path, **kwargs)
        return LocalStore(prefix_path, **kwargs)


class FilesystemStore(Store):
    """Store on a mounted filesystem (reference: store.py
    ``FilesystemStore``)."""

    def __init__(self, prefix_path: str):
        self.prefix_path = self._normalize(prefix_path)
        os.makedirs(self.prefix_path, exist_ok=True)

    def _normalize(self, path: str) -> str:
        return path

    def _run_path(self, run_id: str, name: str) -> str:
        return os.path.join(self.prefix_path, run_id, name)

    def get_train_data_path(self, run_id: str) -> str:
        return self._run_path(run_id, "train_data")

    def get_val_data_path(self, run_id: str) -> str:
        return self._run_path(run_id, "val_data")

    def get_test_data_path(self, run_id: str) -> str:
        return self._run_path(run_id, "test_data")

    def get_checkpoint_path(self, run_id: str) -> str:
        return self._run_path(run_id, "checkpoint.pkl")

    def get_logs_path(self, run_id: str) -> str:
        return self._run_path(run_id, "logs")

    def exists(self, path: str) -> bool:
        return os.path.exists(self._normalize(path))

    def read(self, path: str) -> bytes:
        with open(self._normalize(path), "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> str:
        path = self._normalize(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic: readers never see a torn checkpoint
        return path


class LocalStore(FilesystemStore):
    """Local-disk store (reference: store.py ``LocalStore``)."""


class DBFSLocalStore(FilesystemStore):
    """Databricks DBFS via the ``/dbfs`` fuse mount (reference: store.py
    ``DBFSLocalStore`` — maps ``dbfs:/path`` to ``/dbfs/path``)."""

    def _normalize(self, path: str) -> str:
        if path.startswith("dbfs:/"):
            return "/dbfs/" + path[len("dbfs:/"):].lstrip("/")
        return path


class HDFSStore(Store):
    """HDFS-backed store via ``pyarrow.fs.HadoopFileSystem``
    (reference: store.py ``HDFSStore``). Import-gated: requires a working
    libhdfs in the runtime (same requirement as the reference's
    ``pyarrow.hdfs`` path)."""

    def __init__(self, prefix_path: str, host: Optional[str] = None,
                 port: Optional[int] = None, user: Optional[str] = None,
                 filesystem=None):
        from urllib.parse import urlparse

        parsed = urlparse(prefix_path)
        if filesystem is not None:
            # Injected pyarrow FileSystem (same API as HadoopFileSystem) —
            # lets tests exercise the full remote-store code path against
            # LocalFileSystem without a libhdfs runtime, and lets users
            # supply a pre-configured/kerberized fs.
            self._fs = filesystem
        else:
            import pyarrow.fs as pafs
            self._fs = pafs.HadoopFileSystem(
                host=host or parsed.hostname or "default",
                port=port or parsed.port or 0, user=user)
        self.prefix_path = parsed.path or "/"

    def _run_path(self, run_id: str, name: str) -> str:
        return "/".join([self.prefix_path.rstrip("/"), run_id, name])

    def get_train_data_path(self, run_id: str) -> str:
        return self._run_path(run_id, "train_data")

    def get_val_data_path(self, run_id: str) -> str:
        return self._run_path(run_id, "val_data")

    def get_test_data_path(self, run_id: str) -> str:
        return self._run_path(run_id, "test_data")

    def get_checkpoint_path(self, run_id: str) -> str:
        return self._run_path(run_id, "checkpoint.pkl")

    def get_logs_path(self, run_id: str) -> str:
        return self._run_path(run_id, "logs")

    def exists(self, path: str) -> bool:
        import pyarrow.fs as pafs
        info = self._fs.get_file_info([path])[0]
        return info.type != pafs.FileType.NotFound

    def read(self, path: str) -> bytes:
        with self._fs.open_input_stream(path) as f:
            return f.read()

    def write(self, path: str, data: bytes) -> str:
        parent = path.rsplit("/", 1)[0]
        self._fs.create_dir(parent, recursive=True)
        with self._fs.open_output_stream(path) as f:
            f.write(data)
        return path
