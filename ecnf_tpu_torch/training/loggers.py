"""Metric loggers: in-memory, CSV and optional wandb (port of
`ecnf_tpu/training/loggers.py`).

`ListLogger` keeps a columnar history with numpy scalar coercion (a
tensor, on any device, is read as a number); `CSVLogger` writes
``logging_history.csv`` with the ``csv`` module in the layout pandas
writes (an index column, then a column set that grows as new keys
appear), flushing every ``save_period`` rows and resuming from an existing
file; `WandbLogger` falls back to the in-memory history when the wandb
package is absent.
"""
import abc
import csv
import math
import os
import pathlib
import pickle
import warnings
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

LoggingData = Mapping[str, Any]


class Logger(abc.ABC):
    @abc.abstractmethod
    def write(self, data: LoggingData) -> None:
        """Write `data` to the destination."""

    @abc.abstractmethod
    def close(self) -> None:
        """Close the logger; no further writes expected."""


def _to_scalar(value: Any) -> Optional[float]:
    """Coerce a metric value to a python float; None if it isn't scalar."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.is_floating_point():
            value = value.double()
    try:
        arr = np.asarray(value)
    except Exception:
        return None
    if arr.shape != () or not np.issubdtype(arr.dtype, np.number):
        return None
    return float(arr)


class ListLogger(Logger):
    """Columnar in-memory history (``{metric: [values...]}``) with optional
    pickle snapshots every ``save_period`` writes and at close."""

    def __init__(
        self,
        save: bool = False,
        save_path: str = "logging_hist.pkl",
        save_period: int = 100,
    ):
        self.save = save
        self.save_path = save_path
        self.save_period = save_period
        self.history: Dict[str, List[Any]] = {}
        self._writes = 0
        self._warned_non_scalar = False
        if save:
            pathlib.Path(save_path).parent.mkdir(exist_ok=True, parents=True)

    def write(self, data: LoggingData) -> None:
        for key, value in data.items():
            scalar = _to_scalar(value)
            if scalar is None:
                if not self._warned_non_scalar:
                    warnings.warn(
                        f"ListLogger: metric {key!r} is not a scalar; storing it "
                        "as-is (history pickles may be large)."
                    )
                    self._warned_non_scalar = True
                self.history.setdefault(key, []).append(value)
            else:
                self.history.setdefault(key, []).append(scalar)
        self._writes += 1
        if self.save and (self._writes + 1) % self.save_period == 0:
            self._snapshot()

    def _snapshot(self) -> None:
        with open(self.save_path, "wb") as f:
            pickle.dump(self.history, f)

    def close(self) -> None:
        if self.save:
            self._snapshot()


def _cell(value: Any) -> str:
    """One CSV cell as pandas writes it: floats by ``repr``, NaN and
    missing values empty."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return repr(value) if isinstance(value, float) else str(value)


def _parse_cell(text: str) -> Any:
    """A cell read back as pandas' ``read_csv`` reads a numeric column:
    empty as NaN, numbers as floats; other text as itself."""
    if text == "":
        return math.nan
    try:
        return float(text)
    except ValueError:
        return text


class CSVLogger(Logger):
    """Append metric rows to ``<save_path>/logging_history.csv``, resume-aware.

    Rows are buffered and flushed every ``save_period`` writes: appended in
    place while their keys fit the file's columns, otherwise the file is
    rewritten once with the widened column set (first-seen order).
    """

    def __init__(
        self,
        save: bool = True,
        save_path: Optional[str] = None,
        save_period: int = 100,
    ):
        save_dir = save_path or "."
        self.save_path = os.path.join(save_dir, "logging_history.csv")
        self.save = save
        self.save_period = save_period
        self.rows: List[Dict[str, Any]] = []
        self.buffer: List[Dict[str, Any]] = []
        self.iter = 0
        self._file_columns: Optional[List[str]] = None
        if os.path.exists(self.save_path):
            with open(self.save_path, newline="") as f:
                reader = csv.reader(f)
                header = next(reader)[1:]
                self.rows = [
                    {k: _parse_cell(v) for k, v in zip(header, line[1:])} for line in reader
                ]
            self.iter = len(self.rows)
            self._file_columns = header

    def write(self, data: LoggingData) -> None:
        row = {}
        for k, v in data.items():
            scalar = _to_scalar(v)
            row[k] = v if scalar is None else scalar
        self.buffer.append(row)
        self.iter += 1
        if self.save and (self.iter + 1) % self.save_period == 0:
            self._flush()

    def _write_rows(self, mode: str, columns: List[str], start: int, rows, header: bool) -> None:
        with open(self.save_path, mode, newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            if header:
                writer.writerow([""] + columns)
            for i, row in enumerate(rows, start=start):
                writer.writerow([str(i)] + [_cell(row.get(c)) for c in columns])

    def _flush(self) -> None:
        if not self.buffer:
            return
        buffered, self.buffer = self.buffer, []
        start = len(self.rows)
        self.rows.extend(buffered)
        pathlib.Path(self.save_path).parent.mkdir(exist_ok=True, parents=True)
        cols = self._file_columns
        if cols is not None and all(set(r) <= set(cols) for r in buffered):
            self._write_rows("a", cols, start, buffered, header=False)
        else:
            cols = list(dict.fromkeys(k for r in self.rows for k in r))
            self._write_rows("w", cols, 0, self.rows, header=True)
            self._file_columns = cols

    def close(self) -> None:
        if self.save:
            self._flush()


class WandbLogger(Logger):
    """wandb-backed logger (its own monotone step, ``commit=False``); falls
    back to `ListLogger` when wandb is missing."""

    def __init__(self, **kwargs: Any):
        try:
            import wandb  # noqa: F401

            self._wandb = wandb
            self.run = wandb.init(**kwargs, reinit=True)
        except ImportError:
            print("wandb not available; WandbLogger falling back to in-memory history")
            self._wandb = None
            self._fallback = ListLogger()
        self.iter = 0

    def write(self, data: LoggingData) -> None:
        if self._wandb is None:
            self._fallback.write(data)
        else:
            self.run.log(data, step=self.iter, commit=False)
        self.iter += 1

    def close(self) -> None:
        if self._wandb is None:
            self._fallback.close()
        else:
            self.run.finish()


def setup_logger(
    logger_cfg: Mapping[str, Any],
    save_dir: str = ".",
    save: bool = True,
    experiment_config: Optional[Mapping[str, Any]] = None,
) -> Logger:
    """Select a logger by which key is present in the config section; the
    full experiment config, when given, goes into the wandb run's config."""
    if logger_cfg is None:
        return ListLogger()
    if "wandb" in logger_cfg:
        kwargs = dict(logger_cfg["wandb"] or {})
        if experiment_config is not None and "config" not in kwargs:
            kwargs["config"] = dict(experiment_config)
        return WandbLogger(**kwargs)
    if "list_logger" in logger_cfg:
        return ListLogger()
    if "pandas_logger" in logger_cfg or "csv_logger" in logger_cfg:
        section = logger_cfg.get("pandas_logger") or logger_cfg.get("csv_logger") or {}
        return CSVLogger(
            save=save,
            save_path=save_dir,
            save_period=int(section.get("save_period", 100)),
        )
    raise ValueError(
        "No logger specified: add one of wandb / list_logger / pandas_logger "
        "to the logger config section."
    )
