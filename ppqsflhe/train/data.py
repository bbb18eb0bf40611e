"""Time-series data pipeline for the FL clients.

Mirrors the reference client's pandas feature engineering exactly
(client/src/c_trainAndUpdate.py:104-119): calendar features from the
Timestamp column, StandardScaler fit on the train split only, and
lookback-window sequences whose channels are [6 scaled features, scaled
target] (prepare_sequences, c_trainAndUpdate.py:36-44). Reading uses only
``csv``, ``datetime`` and numpy.
"""

from __future__ import annotations

import csv
import re
from dataclasses import dataclass
from datetime import datetime
from typing import Dict, Sequence

import numpy as np

FEATURE_NAMES = ["DayOfYear", "Month", "DayOfWeek", "WeekOfYear", "AcademicMonth", "HourOfDay"]
TARGET = "Data"
_ACADEMIC_MONTHS = (1, 2, 3, 4, 5, 8, 9, 10, 11)

# numeric timestamps: three date fields split by one of - / . (one of them a
# four-digit year, first or last), then an optional H:M or H:M:S time
_TS_RE = re.compile(r"(\d{1,4})([-/.])(\d{1,2})\2(\d{1,4})"
                    r"(?:([ T])\d{1,2}:\d{1,2}(:\d{1,2})?)?")


class Frame:
    """A table of named numpy columns, one row per CSV line."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = dict(columns)

    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def rows(self, mask: np.ndarray) -> "Frame":
        return Frame({k: v[mask] for k, v in self.columns.items()})

    def matrix(self, names: Sequence[str]) -> np.ndarray:
        """The named columns as one float64 (rows, len(names)) array."""
        return np.stack([self.columns[n].astype(np.float64) for n in names], axis=1)


def infer_timestamp_format(sample: str, dayfirst: bool) -> str:
    """The strptime format pandas' ``to_datetime`` infers from its first
    value: the four-digit field is the year, and ``dayfirst`` orders the
    other two unless the value rules that order out (a field > 12 cannot be
    the month)."""
    m = _TS_RE.fullmatch(sample.strip())
    if m is None or (len(m.group(1)) != 4 and len(m.group(4)) != 4):
        raise ValueError(f"unsupported timestamp format: {sample!r}")
    a, sep, b, c, tsep, secs = m.groups()
    year_first = len(a) == 4
    x, y = (int(b), int(c)) if year_first else (int(a), int(b))
    day_month = y <= 12 if dayfirst else x > 12
    pair = f"%d{sep}%m" if day_month else f"%m{sep}%d"
    fmt = f"%Y{sep}{pair}" if year_first else f"{pair}{sep}%Y"
    if tsep:
        fmt += f"{tsep}%H:%M" + (":%S" if secs else "")
    return fmt


def parse_timestamps(values: Sequence[str], dayfirst: bool) -> np.ndarray:
    """datetime64[s] array; values that do not match the format inferred
    from the first non-empty value become NaT (pandas ``errors='coerce'``)."""
    first = next((v for v in values if v.strip()), None)
    out = np.full(len(values), np.datetime64("NaT"), "datetime64[s]")
    if first is None:
        return out
    fmt = infer_timestamp_format(first, dayfirst)
    for i, v in enumerate(values):
        try:
            out[i] = np.datetime64(datetime.strptime(v.strip(), fmt))
        except ValueError:
            pass
    return out


def _calendar_features(ts: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-row calendar columns; NaT rows carry NaN in every one of them
    except AcademicMonth, which is 0 there (pandas' ``x in [...]`` on NaN)."""
    cols = {k: np.full(len(ts), np.nan) for k in FEATURE_NAMES}
    for i, t in enumerate(ts):
        if np.isnat(t):
            cols["AcademicMonth"][i] = 0
            continue
        d = t.astype(datetime)
        cols["DayOfYear"][i] = d.timetuple().tm_yday
        cols["Month"][i] = d.month
        cols["DayOfWeek"][i] = d.weekday()
        cols["WeekOfYear"][i] = d.isocalendar()[1]
        cols["AcademicMonth"][i] = 1 if d.month in _ACADEMIC_MONTHS else 0
        cols["HourOfDay"][i] = d.hour
    return cols


def _to_float(v: str) -> float:
    return float(v) if v.strip() else np.nan


def load_timeseries(csv_path: str, dayfirst: bool = True) -> Frame:
    """``dayfirst=True`` (default) parses the reference datasets' DD-MM-YYYY
    timestamps correctly. ``dayfirst=False`` replicates the reference
    scripts' own month-first pandas default (c_trainAndUpdate.py:96,
    c_evalulate_rounds.py:75): on its day-first CSVs that reading turns
    days 1-12 of July into the 7th of Jan..Dec and coerces days 13+ to NaT
    (dropped by the date-split comparisons) — the committed reference
    metrics were computed on THAT 168-train-row/120-test-row view, so
    bug-compatible parsing is required for apples-to-apples parity
    (docs/PARITY.md)."""
    with open(csv_path, newline="", encoding="utf-8-sig") as f:
        reader = csv.DictReader(f)
        names = reader.fieldnames or []
        if "Timestamp" not in names:
            raise ValueError(f"expected 'Timestamp' column, got {list(names)}")
        rows = list(reader)
    cols = {n: np.array([r[n] or "" for r in rows], dtype=object) for n in names}
    if TARGET in cols:
        cols[TARGET] = np.array([_to_float(v) for v in cols[TARGET]], np.float64)
    cols["Timestamp"] = parse_timestamps(list(cols["Timestamp"]), dayfirst)
    cols.update(_calendar_features(cols["Timestamp"]))
    return Frame(cols)


@dataclass
class Scaler:
    """StandardScaler twin (mean/std per column, ddof=0 like sklearn)."""

    mean: np.ndarray = None
    std: np.ndarray = None

    def fit(self, x: np.ndarray) -> "Scaler":
        self.mean = np.asarray(x, np.float64).mean(axis=0)
        self.std = np.asarray(x, np.float64).std(axis=0)
        self.std = np.where(self.std == 0, 1.0, self.std)
        return self

    def transform(self, x):
        return (np.asarray(x, np.float64) - self.mean) / self.std

    def inverse(self, x):
        return np.asarray(x, np.float64) * self.std + self.mean


def prepare_sequences(df: Frame, lookback: int, fs: Scaler, ts: Scaler):
    """Sliding windows: X[i] = [features||target][i-lookback:i], y[i] = target[i]."""
    features = fs.transform(df.matrix(FEATURE_NAMES))
    targets = ts.transform(df.matrix([TARGET]))
    chan = np.concatenate([features, targets], axis=1)
    n = len(df)
    if n <= lookback:
        return np.zeros((0, lookback, chan.shape[1])), np.zeros((0,))
    idx = np.arange(lookback, n)
    seqs = np.stack([chan[i - lookback : i] for i in idx])
    targs = targets[idx, 0]
    return seqs.astype(np.float32), targs.astype(np.float32)


def train_test_frames(df: Frame, train_end: str, test_start: str):
    """Rows up to ``train_end`` and from ``test_start`` (ISO date or date
    time); NaT rows fall in neither."""
    ts = df["Timestamp"]
    train = df.rows(ts <= np.datetime64(datetime.fromisoformat(train_end)))
    test = df.rows(ts >= np.datetime64(datetime.fromisoformat(test_start)))
    return train, test


def train_val_split(X, y, val_frac: float = 0.1):
    """Last-10%-as-validation split (c_trainAndUpdate.py:122-123)."""
    nval = int(val_frac * len(X))
    if nval == 0:
        return X, y, X[:0], y[:0]
    return X[:-nval], y[:-nval], X[-nval:], y[-nval:]
