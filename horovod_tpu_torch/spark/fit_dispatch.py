"""Shared ``fit(data, ...)`` data-form dispatch for the estimators.

A copy of ``horovod_tpu/spark/fit_dispatch.py`` (framework-free).
Both estimator families (``integrations.Estimator`` and
``torch.estimator.TorchEstimator``) accept the same three data forms the
reference estimators do — a Spark-like DataFrame, a parquet directory path,
or in-memory arrays (reference: ``horovod/spark/common/estimator.py`` fit /
``fit_on_parquet``). The detection and the num_proc/validation-form rules
live here once so the two estimators cannot drift.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple


def as_dataframe(data):
    """``data`` as a DataFrame-like, else None. Duck-typed on the exact API
    slice ``prepare_data`` consumes (count/repartition/randomSplit/write)
    rather than isinstance-gated on pyspark, so
    :class:`~horovod_tpu_torch.spark.PandasDataFrame` — and e.g. Spark Connect
    frames — take the same DataFrame→parquet→train path a classic
    ``pyspark.sql.DataFrame`` does. A RAW ``pandas.DataFrame`` is
    auto-wrapped (it has ``count`` but not the rest — falling through to
    the array path would die with an opaque error far from the cause).
    (x, y) tuples, arrays, and path strings don't expose the slice and
    fall through."""
    from .pandas_df import PandasDataFrame, is_dataframe_like
    if isinstance(data, (str, bytes, tuple, list)):
        return None
    try:
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            return PandasDataFrame(data)
    except ImportError:
        pass
    return data if is_dataframe_like(data) else None


def resolve_fit_data(data, validation, num_proc: Optional[int]
                     ) -> Tuple[str, Any, Any]:
    """Classify ``data`` and normalize ``validation`` to match its form.

    Returns ``(kind, payload, validation)`` with ``kind`` one of:

    * ``"df"`` — payload is the DataFrame-like (validation normalized to a
      DataFrame-like or float fraction);
    * ``"path"`` — payload is the parquet directory (validation must be a
      path);
    * ``"arrays"`` — payload is ``data`` unchanged (in-memory training).

    Raises the standard errors for invalid combinations (num_proc without
    a fan-out-able form; num_proc on a pandas-backed frame, which has no
    live SparkSession; a validation form that does not match the data
    form)."""
    spark_df = as_dataframe(data)
    if spark_df is None and not isinstance(data, str) and num_proc:
        raise ValueError(
            "num_proc requires a Spark DataFrame or a parquet directory "
            "path; in-memory data trains in-process only")
    if num_proc and spark_df is not None:
        # Fail BEFORE materializing the dataset: num_proc fans out via
        # horovod_tpu_torch.spark.run, which needs a live SparkSession — a
        # pandas-backed frame can never provide one, and the eventual
        # ImportError would point at pyspark instead of num_proc.
        from .pandas_df import PandasDataFrame
        if isinstance(spark_df, PandasDataFrame):
            raise ValueError(
                "num_proc fan-out needs a real Spark DataFrame (live "
                "SparkSession); a pandas-backed frame trains in-process — "
                "drop num_proc")
    if spark_df is not None:
        if validation is not None and not isinstance(validation, float):
            val_df = as_dataframe(validation)
            if val_df is None:
                raise ValueError(
                    "validation must be a Spark DataFrame or a float "
                    "fraction when fitting a Spark DataFrame")
            validation = val_df
        return "df", spark_df, validation
    if isinstance(data, str):
        if validation is not None and not isinstance(validation, str):
            raise ValueError(
                "validation must be a parquet directory path when fitting "
                "a parquet directory")
        return "path", data, validation
    return "arrays", data, validation
