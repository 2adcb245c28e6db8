"""DataFrame materialization + per-rank parquet shard reading.

Counterpart of ``horovod_tpu/spark/util.py`` (reference:
``horovod/spark/common/util.py``, 708 LoC) — ``prepare_data`` writes the
Spark DataFrame to a parquet store, and each training rank then reads its
own shard. The store format is plain parquet; ranks read their shard
directly with **pyarrow** (no Petastorm dependency) — fragment-level
sharding when there are enough files, row-level round-robin otherwise, so
every row is seen exactly once per epoch across the world.

One deviation: the JAX reader turns every column into numpy through
``to_pylist()``, a Python object a value; at an image's 150,528 floats a
row that is minutes and gigabytes for a few hundred rows. This reader takes
numeric columns, and list columns whose rows are equally long, from
Arrow's value buffers, and gives the array the JAX reader gives (the dtype
numpy infers from Python scalars: float64 for floating types, int64 for
integers); any other column goes through ``to_pylist()`` as there.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from .store import Store


def prepare_data(df, store: Store, run_id: str, validation=None,
                 partitions: Optional[int] = None) -> dict:
    """Materialize a Spark DataFrame under the store's train/val data paths
    (reference: ``spark/common/util.py`` prepare_data → Petastorm parquet).

    ``partitions`` repartitions before the write so the parquet fragment
    count matches the training world size (each rank gets whole fragments).
    Returns metadata: row counts + output paths.
    """
    if isinstance(validation, float):
        # Fraction split (reference: util.py validation ratio — there via a
        # rand() < ratio column filter; randomSplit is the same contract).
        if not 0.0 < validation < 1.0:
            raise ValueError(
                f"validation fraction must be in (0, 1), got {validation}")
        df, validation = df.randomSplit([1.0 - validation, validation],
                                        seed=42)
    train_path = store.get_train_data_path(run_id)
    train_df = df if partitions is None else df.repartition(partitions)
    train_df.write.mode("overwrite").parquet(train_path)
    meta = {"train_data_path": train_path, "train_rows": df.count()}
    if validation is not None:
        val_path = store.get_val_data_path(run_id)
        val_df = validation if partitions is None else \
            validation.repartition(partitions)
        val_df.write.mode("overwrite").parquet(val_path)
        meta.update(val_data_path=val_path, val_rows=validation.count())
    return meta


def _python_dtype(typ) -> Optional[np.dtype]:
    """The dtype ``np.asarray`` infers from the Python scalars of an Arrow
    type's values, for the types read from buffers; None for the rest."""
    import pyarrow as pa
    if pa.types.is_float32(typ) or pa.types.is_float64(typ):
        return np.dtype(np.float64)
    if pa.types.is_integer(typ) and not pa.types.is_uint64(typ):
        return np.dtype(np.int64)
    if pa.types.is_boolean(typ):
        return np.dtype(np.bool_)
    return None


def _from_buffers(arr) -> Optional[np.ndarray]:
    """``arr`` (a pyarrow Array) as numpy from its buffers, or None when
    the ``to_pylist()`` route must decide: nulls, another type, an empty
    column, or list rows of different or zero lengths."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if len(arr) == 0 or arr.null_count:
        return None
    typ = arr.type
    if pa.types.is_list(typ) or pa.types.is_large_list(typ) or \
            pa.types.is_fixed_size_list(typ):
        lengths = pc.list_value_length(arr)
        width = pc.min(lengths).as_py()
        if width == 0 or width != pc.max(lengths).as_py():
            return None
        values = arr.flatten()
        dtype = _python_dtype(values.type)
        if dtype is None or values.null_count:
            return None
        return values.to_numpy(zero_copy_only=False).astype(
            dtype).reshape(len(arr), width)
    dtype = _python_dtype(typ)
    if dtype is None:
        return None
    # A copy, writable as the JAX reader's arrays are (Arrow's own buffers
    # come out read-only).
    return arr.to_numpy(zero_copy_only=False).astype(dtype)


def _column_to_array(col) -> np.ndarray:
    """A pyarrow column → numpy, flattening list-typed cells into a trailing
    feature axis (the reference's vector-column handling): the array of
    ``np.asarray(col.to_pylist())``, from Arrow's buffers where it can
    (module docstring)."""
    fast = _from_buffers(col.combine_chunks())
    if fast is not None:
        return fast
    return np.asarray(col.to_pylist())


def table_to_x(table, feature_cols: List[str]) -> np.ndarray:
    """Feature columns of a pyarrow table → one numpy array. Scalar columns
    stack into a trailing feature axis; a single list-typed column is used
    as-is."""
    cols = [_column_to_array(table.column(c)) for c in feature_cols]
    if len(cols) == 1:
        x = cols[0]
    else:
        cols = [c[..., None] if c.ndim == 1 else c for c in cols]
        x = np.concatenate(cols, axis=-1)
    return np.ascontiguousarray(x)


def table_to_xy(table, feature_cols: List[str],
                label_col: str) -> Tuple[np.ndarray, np.ndarray]:
    """A pyarrow table → (x, y) numpy pair."""
    y = _column_to_array(table.column(label_col))
    return table_to_x(table, feature_cols), np.ascontiguousarray(y)


class ParquetShardReader:
    """Per-rank batched reader over a parquet directory (the Petastorm-reader
    analog; reference: ``spark/common/util.py`` + the estimators' remote
    training loops reading ``store.get_train_data_path``).

    Sharding: whole fragments ``rank::size`` when the directory has at least
    ``size`` fragments (no cross-rank byte amplification); otherwise
    row-level round-robin over the concatenated rows. Each row lands on
    exactly one rank either way.
    """

    def __init__(self, path: str, feature_cols: List[str], label_col,
                 batch_size: int = 32, rank: int = 0, size: int = 1,
                 filesystem=None, weight_col: Optional[str] = None):
        import pyarrow.dataset as pads
        self._ds = pads.dataset(path, format="parquet",
                                filesystem=filesystem)
        self._fragments = sorted(self._ds.get_fragments(),
                                 key=lambda f: f.path)
        self.feature_cols = list(feature_cols)
        # One label column → y is an array; a LIST of label columns → y is
        # a list of arrays, one per head (reference: multi-label estimators,
        # ``label_cols`` + per-label ``loss_constructors``).
        self.label_cols = list(label_col) if isinstance(
            label_col, (list, tuple)) else [label_col]
        self.label_col = self.label_cols[0]
        self._multi_label = isinstance(label_col, (list, tuple)) \
            and len(self.label_cols) > 1
        # Optional per-row weight column (reference: ``sample_weight_col``).
        self.weight_col = weight_col
        self.batch_size = batch_size
        self.rank = rank
        self.size = size
        self._fragment_sharded = len(self._fragments) >= size

    def rows(self) -> int:
        """Row count of this rank's shard."""
        if self._fragment_sharded:
            return sum(f.count_rows()
                       for f in self._fragments[self.rank::self.size])
        total = sum(f.count_rows() for f in self._fragments)
        return len(range(self.rank, total, self.size))

    def _shard_tables(self):
        import pyarrow as pa
        columns = self.feature_cols + self.label_cols
        if self.weight_col:
            columns = columns + [self.weight_col]
        if self._fragment_sharded:
            for frag in self._fragments[self.rank::self.size]:
                yield frag.to_table(columns=columns)
        else:
            table = pa.concat_tables(
                f.to_table(columns=columns) for f in self._fragments)
            yield table.take(list(range(self.rank, table.num_rows,
                                        self.size)))

    def batches(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield numpy batches of ``batch_size`` rows; a trailing partial
        batch is dropped (uniform shapes keep the step compiled once — the
        reference's Petastorm loader cycles for the same reason).

        Batch shape: ``(x, y)``, plus a trailing weights array when
        ``weight_col`` is set. ``y`` is a list of arrays when constructed
        with a list of label columns (multi-head)."""
        leftover = None
        for table in self._shard_tables():
            x = table_to_x(table, self.feature_cols)
            ys = [_column_to_array(table.column(c)) for c in self.label_cols]
            arrays = [x] + ys
            if self.weight_col:
                arrays.append(_column_to_array(table.column(self.weight_col)))
            if leftover is not None:
                arrays = [np.concatenate([lo, a])
                          for lo, a in zip(leftover, arrays)]
            n = arrays[0].shape[0]
            n_full = n // self.batch_size
            for i in range(n_full):
                sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
                cut = [a[sl] for a in arrays]
                yield self._pack(cut)
            rem = n - n_full * self.batch_size
            leftover = [a[-rem:] for a in arrays] if rem else None

    def _pack(self, arrays):
        x = arrays[0]
        n_labels = len(self.label_cols)
        ys = arrays[1:1 + n_labels]
        y = ys if self._multi_label else ys[0]
        if self.weight_col:
            return x, y, arrays[-1]
        return x, y
