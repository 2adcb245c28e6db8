"""Pandas-backed DataFrame speaking the pyspark slice the data path uses.

A copy of ``horovod_tpu/spark/pandas_df.py`` (framework-free).

Reference: ``horovod/spark/common/util.py`` ``prepare_data`` consumes a tiny
slice of the ``pyspark.sql.DataFrame`` API — ``count()``, ``repartition()``,
``randomSplit()``, ``df.write.mode().parquet()``. :class:`PandasDataFrame`
implements exactly that slice over an in-memory pandas frame, writing real
multi-fragment parquet via pyarrow, so the estimator's DataFrame→parquet→
train pipeline runs end-to-end WITHOUT a Spark installation (this
environment cannot install pyspark — see ``docs/parity.md``) and so users
with pandas-sized data get the same API surface as Spark users. On a real
cluster the estimator accepts a genuine Spark DataFrame through the same
code path (:func:`~horovod_tpu_torch.spark.fit_dispatch.as_dataframe`
duck-types this slice).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Sequence

import numpy as np


class _ParquetWriter:
    """The ``df.write`` handle: ``mode("overwrite").parquet(path)``
    (pyspark semantics: default mode errors on an existing target)."""

    def __init__(self, df: "PandasDataFrame"):
        self._df = df
        self._mode = "errorifexists"

    def mode(self, saveMode: str) -> "_ParquetWriter":
        self._mode = saveMode
        return self

    def parquet(self, path: str) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        if os.path.exists(path):
            if self._mode != "overwrite":
                raise FileExistsError(
                    f"{path!r} exists; use .mode('overwrite') "
                    "(pyspark default mode is errorifexists)")
            shutil.rmtree(path)
        os.makedirs(path)
        pdf = self._df._pdf
        n_parts = max(1, min(self._df._partitions, max(len(pdf), 1)))
        for i, chunk in enumerate(np.array_split(np.arange(len(pdf)),
                                                 n_parts)):
            table = pa.Table.from_pandas(pdf.iloc[chunk],
                                         preserve_index=False)
            pq.write_table(table,
                           os.path.join(path, f"part-{i:05d}.parquet"))


class PandasDataFrame:
    """A pandas frame wearing the pyspark DataFrame API slice that
    :func:`~horovod_tpu_torch.spark.util.prepare_data` and
    :class:`~horovod_tpu_torch.integrations.estimator.Estimator` consume.

    ``partitions`` controls how many parquet fragments a write produces
    (pyspark: the frame's partition count); ``repartition(n)`` returns a
    new frame with ``n``.
    """

    def __init__(self, pdf, partitions: int = 1):
        if partitions < 1:
            raise ValueError(f"partitions must be >= 1, got {partitions}")
        self._pdf = pdf.reset_index(drop=True)
        self._partitions = int(partitions)

    @property
    def columns(self) -> List[str]:
        return list(self._pdf.columns)

    def count(self) -> int:
        return int(len(self._pdf))

    def repartition(self, numPartitions: int) -> "PandasDataFrame":
        return PandasDataFrame(self._pdf, partitions=numPartitions)

    def randomSplit(self, weights: Sequence[float],
                    seed: Optional[int] = None) -> List["PandasDataFrame"]:
        """Proportional random row split (pyspark contract: weights are
        normalized; every row lands in exactly one output frame)."""
        w = np.asarray(weights, np.float64)
        if (w <= 0).any():
            raise ValueError(f"weights must be positive, got {weights}")
        w = w / w.sum()
        rng = np.random.RandomState(seed)
        perm = rng.permutation(len(self._pdf))
        bounds = np.floor(np.cumsum(w) * len(perm)).astype(int)
        # Float cumsum of normalized weights can land below 1.0 (e.g. seven
        # equal weights sum to 0.9999999999999998), which would silently
        # drop the last row(s); the final bound IS the row count.
        bounds[-1] = len(perm)
        out, start = [], 0
        for end in bounds:
            idx = np.sort(perm[start:end])
            out.append(PandasDataFrame(self._pdf.iloc[idx],
                                       partitions=self._partitions))
            start = end
        return out

    @property
    def write(self) -> _ParquetWriter:
        return _ParquetWriter(self)


def is_dataframe_like(obj) -> bool:
    """True when ``obj`` exposes the DataFrame API slice the data path
    consumes — a real ``pyspark.sql.DataFrame``, a
    :class:`PandasDataFrame`, or any other duck-typed frame (e.g. Spark
    Connect's)."""
    return all(hasattr(obj, a)
               for a in ("count", "repartition", "randomSplit", "write"))
