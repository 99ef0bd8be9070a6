"""TPC-H lineitem, orders and customer data, Q6, Q1 and Q3, and numpy
oracles.

Counterpart of ``spark_rapids_tpu/models/tpch.py``.  The generators are
numpy-only copies of the reference's ``gen_lineitem`` (:21-60),
``gen_orders`` (:67) and ``gen_customer`` (:102) column draws, in the same
order from the same seeds, so both packages see the same values; they
return the dict of numpy arrays that both packages' ``create_dataframe``
take, instead of writing parquet.  The oracles are plain numpy
(``np.add.at``/``np.bincount`` for the groups, direct addressing for Q3's
dense keys), independent of both engines.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LINEITEM_ROWS_PER_SF", "SEGMENTS", "gen_lineitem_arrays",
           "gen_orders_arrays", "gen_customer_arrays", "q6", "q1", "q3",
           "q6_numpy", "q1_numpy", "q3_numpy"]

LINEITEM_ROWS_PER_SF = 6_001_215
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
Q3_CUTOFF = datetime.date(1995, 3, 15)


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


def gen_orders_arrays(sf: float, seed: int = 19930101,
                      rows: Optional[int] = None,
                      chunk: int = 1_000_000) -> Dict[str, np.ndarray]:
    """Seeded orders columns: ``rows`` or ``max(2, n_lineitem // 4 - 1)``
    rows, so ``o_orderkey`` covers every ``l_orderkey`` of
    :func:`gen_lineitem_arrays` at the same ``sf``.  o_orderdate comes
    back as ``datetime64[D]``."""
    n_li = int(LINEITEM_ROWS_PER_SF * sf)
    n = rows if rows is not None else max(2, n_li // 4 - 1)
    rng = np.random.default_rng(seed)
    n_cust = max(2, int(150_000 * sf))
    base = np.datetime64("1992-01-01")
    parts: Dict[str, List[np.ndarray]] = {}
    for off in range(0, n, chunk):
        m = min(chunk, n - off)
        okey = np.arange(off + 1, off + 1 + m, dtype=np.int64)
        odate = base + rng.integers(0, 2406, m).astype("timedelta64[D]")
        ckey = rng.integers(1, n_cust, m).astype(np.int64)
        for name, arr in (("o_orderkey", okey), ("o_custkey", ckey),
                          ("o_orderdate", odate),
                          ("o_shippriority", np.zeros(m, dtype=np.int64))):
            parts.setdefault(name, []).append(arr)
    return {name: np.concatenate(arrs) for name, arrs in parts.items()}


def gen_customer_arrays(sf: float, seed: int = 19940101,
                        rows: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Seeded customer columns: ``rows`` or ``max(2, int(150_000 * sf))``
    rows; c_mktsegment is a numpy unicode array."""
    n = rows if rows is not None else max(2, int(150_000 * sf))
    rng = np.random.default_rng(seed)
    return {"c_custkey": np.arange(1, n + 1, dtype=np.int64),
            "c_mktsegment": rng.choice(np.array(SEGMENTS), n)}


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


def q3(cust, orders, lineitem):
    """TPC-H Q3 shipping priority: two inner equi-joins, a 3-key GROUP BY
    with a SUM, ORDER BY revenue DESC, o_orderdate, LIMIT 10."""
    from ..sql import functions as F
    revenue = F.col("l_extendedprice") * (1 - F.col("l_discount"))
    return (cust.where(F.col("c_mktsegment") == "BUILDING")
            .join(orders, [("c_custkey", "o_custkey")])
            .join(lineitem, [("o_orderkey", "l_orderkey")])
            .where((F.col("o_orderdate") < Q3_CUTOFF)
                   & (F.col("l_shipdate") > Q3_CUTOFF))
            .group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(revenue).alias("revenue"))
            .sort(F.col("revenue").desc(), F.col("o_orderdate"))
            .limit(10))


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


def q3_numpy(cust: Dict[str, np.ndarray], orders: Dict[str, np.ndarray],
             lineitem: Dict[str, np.ndarray], k: int = 10) -> List[tuple]:
    """Q3 over the generators' arrays by direct addressing (every key is
    dense: c_custkey and o_orderkey are 1..n), rows as :func:`q3` returns
    them: (l_orderkey, o_orderdate, o_shippriority, revenue).  Ties in
    revenue keep o_orderdate order, then l_orderkey order, as a stable
    sort of the groups in key order does."""
    cutoff = np.datetime64(Q3_CUTOFF)
    ckey, okey = cust["c_custkey"], orders["o_orderkey"]
    if not (np.array_equal(ckey, np.arange(1, len(ckey) + 1))
            and np.array_equal(okey, np.arange(1, len(okey) + 1))):
        raise ValueError("q3_numpy needs c_custkey and o_orderkey = 1..n")
    cust_ok = np.zeros(len(ckey) + 1, dtype=bool)
    cust_ok[ckey] = cust["c_mktsegment"] == "BUILDING"
    odate = orders["o_orderdate"]
    ok_o = cust_ok[orders["o_custkey"]] & (odate < cutoff)
    lkey = lineitem["l_orderkey"]
    m = ok_o[lkey - 1] & (lineitem["l_shipdate"] > cutoff)
    rev = lineitem["l_extendedprice"][m] * (1 - lineitem["l_discount"][m])
    size = len(okey) + 1
    revenue = np.bincount(lkey[m], weights=rev, minlength=size)
    groups = np.flatnonzero(np.bincount(lkey[m], minlength=size))
    days = odate[groups - 1].astype(np.int64)
    order = np.lexsort((days, -revenue[groups]))[:k]
    top = groups[order]
    prio = orders["o_shippriority"]
    return [(int(g), odate[g - 1].astype(datetime.date),
             int(prio[g - 1]), float(revenue[g])) for g in top]
