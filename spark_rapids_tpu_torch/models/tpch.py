"""TPC-H lineitem data, Q6 and Q1, and numpy oracles.

Counterpart of ``spark_rapids_tpu/models/tpch.py``.  The generator is a
numpy-only copy of the reference's ``gen_lineitem`` column draws (:21-60),
in the same order from the same seed, so both packages see the same
values; it returns the dict of numpy arrays that both packages'
``create_dataframe`` take, instead of writing parquet.  The oracles are
plain numpy (``np.add.at`` for the groups), independent of both engines.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LINEITEM_ROWS_PER_SF", "gen_lineitem_arrays", "q6", "q1",
           "q6_numpy", "q1_numpy"]

LINEITEM_ROWS_PER_SF = 6_001_215


def gen_lineitem_arrays(sf: float, seed: int = 19920101,
                        chunk: int = 1_000_000,
                        rows: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Seeded lineitem columns: ``rows`` or ``int(6_001_215 * sf)`` rows.
    Strings come back as numpy unicode arrays, l_shipdate as
    ``datetime64[D]``."""
    n = rows if rows is not None else int(LINEITEM_ROWS_PER_SF * sf)
    rng = np.random.default_rng(seed)
    base = np.datetime64("1992-01-01")
    parts: Dict[str, List[np.ndarray]] = {}
    for off in range(0, n, chunk):
        m = min(chunk, n - off)
        qty = rng.integers(1, 51, m).astype(np.float64)
        price = np.round(rng.uniform(900.0, 105000.0, m), 2)
        disc = rng.integers(0, 11, m).astype(np.float64) / 100.0
        tax = rng.integers(0, 9, m).astype(np.float64) / 100.0
        ship = base + rng.integers(0, 2526, m).astype("timedelta64[D]")
        rflag = rng.choice(np.array(["A", "N", "R"]), m)
        status = rng.choice(np.array(["O", "F"]), m)
        okey = rng.integers(1, max(2, n // 4), m).astype(np.int64)
        pkey = rng.integers(1, 200_001, m).astype(np.int64)
        skey = rng.integers(1, 10_001, m).astype(np.int64)
        for name, arr in (("l_orderkey", okey), ("l_partkey", pkey),
                          ("l_suppkey", skey), ("l_quantity", qty),
                          ("l_extendedprice", price), ("l_discount", disc),
                          ("l_tax", tax), ("l_returnflag", rflag),
                          ("l_linestatus", status), ("l_shipdate", ship)):
            parts.setdefault(name, []).append(arr)
    if not parts:
        return {}
    return {name: np.concatenate(arrs) for name, arrs in parts.items()}


def q6(df):
    """TPC-H Q6: scan → filter → SUM(price * discount)."""
    from ..sql import functions as F
    lo, hi = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
    return (df.where((F.col("l_shipdate") >= lo) & (F.col("l_shipdate") < hi)
                     & (F.col("l_discount") >= 0.05)
                     & (F.col("l_discount") <= 0.07)
                     & (F.col("l_quantity") < 24))
              .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
                   .alias("revenue")))


def q1(df, delta_days: int = 90):
    """TPC-H Q1: the pricing summary report."""
    from ..sql import functions as F
    cutoff = datetime.date(1998, 12, 1) - datetime.timedelta(days=delta_days)
    disc_price = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    charge = disc_price * (1 + F.col("l_tax"))
    return (df.where(F.col("l_shipdate") <= cutoff)
              .group_by("l_returnflag", "l_linestatus")
              .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                   F.sum(F.col("l_extendedprice")).alias("sum_base_price"),
                   F.sum(disc_price).alias("sum_disc_price"),
                   F.sum(charge).alias("sum_charge"),
                   F.avg(F.col("l_quantity")).alias("avg_qty"),
                   F.avg(F.col("l_extendedprice")).alias("avg_price"),
                   F.avg(F.col("l_discount")).alias("avg_disc"),
                   F.count_star().alias("count_order"))
              .sort("l_returnflag", "l_linestatus"))


def q6_numpy(data: Dict[str, np.ndarray]) -> Optional[float]:
    """Q6 over the generator's arrays; None when no row qualifies."""
    ship = data["l_shipdate"]
    m = ((ship >= np.datetime64("1994-01-01"))
         & (ship < np.datetime64("1995-01-01"))
         & (data["l_discount"] >= 0.05) & (data["l_discount"] <= 0.07)
         & (data["l_quantity"] < 24))
    if not m.any():
        return None
    return float(np.sum(data["l_extendedprice"][m] * data["l_discount"][m]))


def q1_numpy(data: Dict[str, np.ndarray], delta_days: int = 90
             ) -> List[tuple]:
    """Q1 over the generator's arrays, rows in (returnflag, linestatus)
    order, with the same columns as :func:`q1`."""
    cutoff = np.datetime64(datetime.date(1998, 12, 1)
                           - datetime.timedelta(days=delta_days))
    m = data["l_shipdate"] <= cutoff
    flag, status = data["l_returnflag"][m], data["l_linestatus"][m]
    qty, price = data["l_quantity"][m], data["l_extendedprice"][m]
    disc, tax = data["l_discount"][m], data["l_tax"][m]
    flags, fi = np.unique(flag, return_inverse=True)
    stats, si = np.unique(status, return_inverse=True)
    groups, gid = np.unique(fi.reshape(-1) * len(stats) + si.reshape(-1),
                            return_inverse=True)
    gid = gid.reshape(-1)
    g = len(groups)

    def total(x):
        out = np.zeros(g, dtype=np.float64)
        np.add.at(out, gid, x)
        return out

    cnt = np.zeros(g, dtype=np.int64)
    np.add.at(cnt, gid, 1)
    disc_price = price * (1 - disc)
    sums = [total(qty), total(price), total(disc_price),
            total(disc_price * (1 + tax))]
    avgs = [total(qty) / cnt, total(price) / cnt, total(disc) / cnt]
    rows = []
    for i, k in enumerate(groups.tolist()):
        f, s = str(flags[k // len(stats)]), str(stats[k % len(stats)])
        rows.append((f, s, *(float(x[i]) for x in sums),
                     *(float(x[i]) for x in avgs), int(cnt[i])))
    return rows
