"""TPC-H data, Q6, Q1, Q3, Q4, Q10, Q11, Q13, Q18 and Q21, the lineitem
sort and the per-supplier window history, and numpy oracles.

Counterpart of ``spark_rapids_tpu/models/tpch.py`` and
``spark_rapids_tpu/models/tpch_suite.py``.  The generators are numpy-only
copies of the reference's column draws, in the same order from the same
seeds, so both packages see the same values: ``gen_lineitem`` (:21-60),
``gen_orders`` (:67) and ``gen_customer`` (:102) for Q6/Q1/Q3, and the
suite's ``gen_db`` (:45) for the other queries (:func:`gen_db_arrays`).
They return the dicts of numpy arrays that both packages'
``create_dataframe`` take, instead of writing parquet.  The query bodies
mirror the suite's ``run_q*``; the oracles are plain numpy
(``np.add.at``/``np.bincount`` for the groups, ``np.unique`` and
``np.isin`` for the distinct pairs and the semi/anti joins, direct
addressing for the dense keys, stable sorts for the ORDER BY and the
windows), independent of both engines.

``sort_lineitem`` is a global ORDER BY over a lineitem projection handed to
the device (``to_device_arrays``), as a user does before a clustered write
or an ML job: at SF10 its 15 batches take the out-of-core sort.
``supplier_history`` is a per-supplier window history (two specs, so two
sorts of the whole table: ranks, a running sum, 7-row moving frames, lag,
a 30-day RANGE frame and the partition maximum), filtered to the last
month of ship dates above the windows.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LINEITEM_ROWS_PER_SF", "SEGMENTS", "PRIORITIES", "SHIPMODES",
           "NATIONS", "DB_TABLES", "gen_lineitem_arrays",
           "gen_orders_arrays", "gen_customer_arrays", "gen_db_arrays",
           "db_rows", "q6", "q1", "q3", "q4", "q10", "q11", "q13", "q18",
           "q21", "sort_lineitem", "supplier_history", "SORT_COLUMNS",
           "HISTORY_CUTOFF", "q6_numpy", "q1_numpy", "q3_numpy", "q4_numpy",
           "q10_numpy", "q11_numpy", "q13_numpy", "q18_numpy", "q21_numpy",
           "sort_lineitem_numpy", "supplier_history_numpy"]

LINEITEM_ROWS_PER_SF = 6_001_215
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES"]
Q3_CUTOFF = datetime.date(1995, 3, 15)
HISTORY_CUTOFF = datetime.date(1998, 11, 1)
SORT_COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_shipdate",
                "l_extendedprice", "l_discount")


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


# TPC-H shapes of the reference suite's ``gen_db`` (tpch_suite.py:27-44)
_DB_SF1_ROWS = {"lineitem": 6_001_215, "orders": 1_500_000,
                "customer": 150_000, "part": 200_000, "partsupp": 800_000,
                "supplier": 10_000}
DB_TABLES = ("nation", "customer", "supplier", "partsupp", "orders",
             "lineitem")
_DB_SEEDS = {"nation": 1001, "customer": 1002, "supplier": 1003,
             "partsupp": 1005, "orders": 1006, "lineitem": 1007}


def db_rows(table: str, sf: float) -> int:
    """Rows of ``table`` at ``sf`` in the reference suite's ``gen_db``."""
    if table == "nation":
        return len(NATIONS)
    if table == "partsupp":
        return 4 * db_rows("part", sf)
    return max(8, int(_DB_SF1_ROWS[table] * sf))


def _keep(out: Dict[str, List[np.ndarray]], cols, name: str, make) -> None:
    """Append ``make()`` to column ``name`` when the caller keeps it; the
    draws inside ``make`` happen either way, so the stream stays aligned."""
    arr = make()
    if cols is None or name in cols:
        out.setdefault(name, []).append(arr)


def gen_db_arrays(sf: float, tables=DB_TABLES, columns=None,
                  chunk: int = 1_000_000) -> Dict[str, Dict[str, np.ndarray]]:
    """The reference suite's ``gen_db`` (tpch_suite.py:45) tables as dicts
    of numpy arrays: the same per-table seeds, the same 1,000,000-row
    chunks and the same draw order within a chunk, so every value equals
    what ``gen_db`` writes to parquet.  ``tables`` picks tables (each has
    its own seed, so skipping one changes no other); ``columns`` maps a
    table to the columns to return (None: all).  Columns left out are
    still drawn, then dropped.  Dates come back as ``datetime64[D]``,
    strings as numpy unicode."""
    base = np.datetime64("1992-01-01")
    out: Dict[str, Dict[str, np.ndarray]] = {}
    n_cust, n_supp = db_rows("customer", sf), db_rows("supplier", sf)
    n_part, n_ord = db_rows("part", sf), db_rows("orders", sf)
    for table in tables:
        cols = None if columns is None else columns.get(table)
        rng = np.random.default_rng(_DB_SEEDS[table])
        parts: Dict[str, List[np.ndarray]] = {}
        if table == "nation":
            n = len(NATIONS)
            _keep(parts, cols, "n_nationkey",
                  lambda: np.arange(n, dtype=np.int64))
            _keep(parts, cols, "n_name", lambda: np.array(NATIONS))
            _keep(parts, cols, "n_regionkey", lambda: rng.integers(
                0, len(REGIONS), n).astype(np.int64))
        elif table == "partsupp":
            ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
            slot = np.tile(np.arange(4, dtype=np.int64), n_part)
            ps_supp = ((ps_part - 1) * 7 + slot * 13) % n_supp + 1
            ps_supp = (ps_supp + slot) % n_supp + 1
            n = len(ps_part)
            _keep(parts, cols, "ps_partkey", lambda: ps_part)
            _keep(parts, cols, "ps_suppkey", lambda: ps_supp)
            _keep(parts, cols, "ps_availqty", lambda: rng.integers(
                1, 10000, n).astype(np.int64))
            _keep(parts, cols, "ps_supplycost", lambda: np.round(
                rng.uniform(1.0, 1000.0, n), 2))
        elif table == "customer":
            n = n_cust
            _keep(parts, cols, "c_custkey",
                  lambda: np.arange(1, n + 1, dtype=np.int64))
            _keep(parts, cols, "c_name", lambda: np.array(
                [f"Customer#{i:09d}" for i in range(1, n + 1)]))
            _keep(parts, cols, "c_nationkey", lambda: rng.integers(
                0, len(NATIONS), n).astype(np.int64))
            _keep(parts, cols, "c_mktsegment",
                  lambda: rng.choice(np.array(SEGMENTS), n))
            _keep(parts, cols, "c_acctbal", lambda: np.round(
                rng.uniform(-999.99, 9999.99, n), 2))
            phone = [rng.integers(10, 35, n), rng.integers(100, 999, n),
                     rng.integers(100, 999, n), rng.integers(1000, 9999, n)]
            _keep(parts, cols, "c_phone", lambda: np.array(
                [f"{a}-{b}-{c}-{d}" for a, b, c, d in zip(*phone)]))
        elif table == "supplier":
            n = n_supp
            _keep(parts, cols, "s_suppkey",
                  lambda: np.arange(1, n + 1, dtype=np.int64))
            _keep(parts, cols, "s_name", lambda: np.array(
                [f"Supplier#{i:09d}" for i in range(1, n + 1)]))
            _keep(parts, cols, "s_nationkey", lambda: rng.integers(
                0, len(NATIONS), n).astype(np.int64))
            _keep(parts, cols, "s_acctbal", lambda: np.round(
                rng.uniform(-999.99, 9999.99, n), 2))
        elif table == "orders":
            for off in range(0, n_ord, chunk):
                m = min(chunk, n_ord - off)
                odate = base + rng.integers(0, 2406, m).astype(
                    "timedelta64[D]")
                _keep(parts, cols, "o_orderkey", lambda: np.arange(
                    off + 1, off + 1 + m, dtype=np.int64))
                _keep(parts, cols, "o_custkey", lambda: rng.integers(
                    1, n_cust + 1, m).astype(np.int64))
                _keep(parts, cols, "o_orderstatus", lambda: rng.choice(
                    np.array(["O", "F", "P"]), m))
                _keep(parts, cols, "o_totalprice", lambda: np.round(
                    rng.uniform(800.0, 500_000.0, m), 2))
                _keep(parts, cols, "o_orderdate", lambda: odate)
                _keep(parts, cols, "o_orderpriority", lambda: rng.choice(
                    np.array(PRIORITIES), m))
                _keep(parts, cols, "o_shippriority",
                      lambda: np.zeros(m, dtype=np.int64))
        elif table == "lineitem":
            n_li = db_rows("lineitem", sf)
            for off in range(0, n_li, chunk):
                m = min(chunk, n_li - off)
                ship = base + rng.integers(0, 2526, m).astype(
                    "timedelta64[D]")
                commit = ship + rng.integers(-30, 60, m).astype(
                    "timedelta64[D]")
                receipt = ship + rng.integers(1, 60, m).astype(
                    "timedelta64[D]")
                for name, make in (
                        ("l_orderkey", lambda: rng.integers(
                            1, n_ord + 1, m).astype(np.int64)),
                        ("l_partkey", lambda: rng.integers(
                            1, n_part + 1, m).astype(np.int64)),
                        ("l_suppkey", lambda: rng.integers(
                            1, n_supp + 1, m).astype(np.int64)),
                        ("l_quantity", lambda: rng.integers(
                            1, 51, m).astype(np.float64)),
                        ("l_extendedprice", lambda: np.round(
                            rng.uniform(900.0, 105000.0, m), 2)),
                        ("l_discount", lambda: rng.integers(
                            0, 11, m).astype(np.float64) / 100.0),
                        ("l_tax", lambda: rng.integers(
                            0, 9, m).astype(np.float64) / 100.0),
                        ("l_returnflag", lambda: rng.choice(
                            np.array(["A", "N", "R"]), m)),
                        ("l_linestatus", lambda: rng.choice(
                            np.array(["O", "F"]), m)),
                        ("l_shipdate", lambda: ship),
                        ("l_commitdate", lambda: commit),
                        ("l_receiptdate", lambda: receipt),
                        ("l_shipmode", lambda: rng.choice(
                            np.array(SHIPMODES), m))):
                    _keep(parts, cols, name, make)
        else:
            raise ValueError(f"gen_db_arrays does not generate {table!r}")
        out[table] = {name: np.concatenate(arrs) if len(arrs) > 1
                      else arrs[0] for name, arrs in parts.items()}
    return out


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


def q4(orders, lineitem):
    """TPC-H Q4 order priority checking (tpch_suite.py:231 run_q4): orders
    of one quarter semi-joined to their late lineitems, counted by
    priority."""
    from ..sql import functions as F
    lo, hi = datetime.date(1993, 7, 1), datetime.date(1993, 10, 1)
    late = lineitem.filter(F.col("l_commitdate") < F.col("l_receiptdate"))
    return (orders
            .filter((F.col("o_orderdate") >= lo) & (F.col("o_orderdate") < hi))
            .join(late, on=[("o_orderkey", "l_orderkey")], how="semi")
            .group_by("o_orderpriority")
            .agg(F.count_star().alias("order_count"))
            .sort("o_orderpriority"))


def q10(customer, orders, lineitem):
    """TPC-H Q10 returned item reporting (tpch_suite.py:346 run_q10):
    customer joined to its orders of one quarter, joined to their returned
    lineitems, revenue per (c_custkey, c_name, c_acctbal), top 20.  At
    SF10 neither side of the second join fits the broadcast threshold, so
    it plans as a sort-merge join over two shuffle exchanges."""
    from ..sql import functions as F
    lo, hi = datetime.date(1993, 10, 1), datetime.date(1994, 1, 1)
    return (customer
            .join(orders, on=[("c_custkey", "o_custkey")])
            .filter((F.col("o_orderdate") >= lo) & (F.col("o_orderdate") < hi))
            .join(lineitem.filter(F.col("l_returnflag") == "R"),
                  on=[("o_orderkey", "l_orderkey")])
            .select("c_custkey", "c_name", "c_acctbal",
                    (F.col("l_extendedprice") * (1 - F.col("l_discount")))
                    .alias("volume"))
            .group_by("c_custkey", "c_name", "c_acctbal")
            .agg(F.sum(F.col("volume")).alias("revenue"))
            .sort(F.col("revenue").desc(), F.col("c_custkey")).limit(20))


def q11(partsupp, supplier, nation, fraction: float = 0.0001):
    """TPC-H Q11 important stock (tpch_suite.py:363 run_q11): partsupp
    joined to the German suppliers, an ungrouped SUM of the stock value
    (collected), then the value per part over ``fraction`` of it, value
    descending then ps_partkey.  Runs the total's query; returns the
    DataFrame of the second.  As the reference, the fraction stays 0.0001
    at every scale factor (the spec's is 0.0001 / SF)."""
    from ..sql import functions as F
    ps_n = (partsupp
            .join(supplier, on=[("ps_suppkey", "s_suppkey")])
            .join(nation.filter(F.col("n_name") == "GERMANY"),
                  on=[("s_nationkey", "n_nationkey")])
            .with_column("value",
                         F.col("ps_supplycost") * F.col("ps_availqty")))
    total = ps_n.agg(F.sum(F.col("value")).alias("t")).collect()[0][0]
    return (ps_n.group_by("ps_partkey")
            .agg(F.sum(F.col("value")).alias("value"))
            .filter(F.col("value") > F.lit((total or 0.0) * fraction))
            .sort(F.col("value").desc(), "ps_partkey"))


def sort_lineitem(lineitem, functions=None):
    """A global ORDER BY of a lineitem projection: ship date, price
    descending, order key; ties keep input order.  ``functions`` is the
    functions module of the DataFrame's package (default: this one's)."""
    if functions is None:
        from ..sql import functions
    F = functions
    return (lineitem.select(*SORT_COLUMNS)
            .sort("l_shipdate", F.col("l_extendedprice").desc(),
                  "l_orderkey"))


def supplier_history(lineitem, cutoff: datetime.date = HISTORY_CUTOFF,
                     functions=None, window=None):
    """Each lineitem's history within its supplier, for the ship dates
    from ``cutoff`` on: row number, running revenue, 7-row moving average
    quantity and maximum price, the previous price, the day's rank and
    dense rank, the trailing 30-day revenue and the supplier's maximum
    price.  ``functions`` and ``window`` are the functions module and the
    Window class of the DataFrame's package (default: this one's)."""
    if functions is None:
        from ..sql import functions
    if window is None:
        from ..sql.window import Window as window
    F, Window = functions, window
    wa = Window.partition_by("l_suppkey").order_by(
        "l_shipdate", "l_orderkey", "l_partkey")
    wb = Window.partition_by("l_suppkey").order_by("l_shipdate")
    price, qty = F.col("l_extendedprice"), F.col("l_quantity")
    return (lineitem.select(
        "l_suppkey", "l_orderkey", "l_partkey", "l_shipdate",
        "l_extendedprice", "l_quantity",
        F.row_number().over(wa).alias("rn"),
        F.sum(price).over(wa.rows_between(Window.unboundedPreceding, 0))
        .alias("running_rev"),
        F.avg(qty).over(wa.rows_between(-6, 0)).alias("qty_ma7"),
        F.max(price).over(wa.rows_between(-6, 0)).alias("price_max7"),
        F.lag("l_extendedprice", 1).over(wa).alias("prev_price"),
        F.rank().over(wb).alias("day_rank"),
        F.dense_rank().over(wb).alias("day_drank"),
        F.sum(price).over(wb.range_between(-30, 0)).alias("rev_30d"),
        F.max(price).over(wb.rows_between(Window.unboundedPreceding,
                                          Window.unboundedFollowing))
        .alias("supp_max"))
        .where(F.col("l_shipdate") >= cutoff))


def q13(customer, orders):
    """TPC-H Q13 customer distribution (tpch_suite.py:403 run_q13): a
    left outer join of customer to its non-urgent orders, orders counted
    per customer, customers counted per order count."""
    from ..sql import functions as F
    kept = orders.filter(F.col("o_orderpriority") != "1-URGENT")
    per_cust = (customer
                .join(kept, on=[("c_custkey", "o_custkey")], how="left")
                .group_by("c_custkey")
                .agg(F.count(F.col("o_orderkey")).alias("c_count")))
    return (per_cust.group_by("c_count")
            .agg(F.count_star().alias("custdist"))
            .sort(F.col("custdist").desc(), F.col("c_count").desc()))


def q18(orders, lineitem, customer):
    """TPC-H Q18 large volume customer (tpch_suite.py:484 run_q18): orders
    whose lineitem quantity passes 300 (a HAVING over a dense GROUP BY),
    semi-joined, joined to customer for ``c_name``, top 100."""
    from ..sql import functions as F
    big = (lineitem.group_by("l_orderkey")
           .agg(F.sum(F.col("l_quantity")).alias("qty"))
           .filter(F.col("qty") > 300))
    return (orders
            .join(big, on=[("o_orderkey", "l_orderkey")], how="semi")
            .join(customer, on=[("o_custkey", "c_custkey")])
            .select("c_name", "o_orderkey", "o_totalprice")
            .sort(F.col("o_totalprice").desc(), F.col("o_orderkey"))
            .limit(100))


def q21(lineitem, orders, supplier):
    """TPC-H Q21 suppliers who kept orders waiting (tpch_suite.py:538
    run_q21), without the reference's ``.cache()`` of the late pairs (the
    port has no cache yet), so they are computed twice: two DISTINCTs on
    the hash aggregate, two semi joins, an anti join, an inner join that
    carries ``s_name``, a GROUP BY ``s_name`` and a top 100."""
    from ..sql import functions as F
    late = (lineitem
            .filter(F.col("l_receiptdate") > F.col("l_commitdate"))
            .select(F.col("l_orderkey").alias("late_ok"),
                    F.col("l_suppkey").alias("late_sk")))
    multi = (lineitem.select("l_orderkey", "l_suppkey").distinct()
             .group_by("l_orderkey")
             .agg(F.count_star().alias("n_sups"))
             .filter(F.col("n_sups") > 1)
             .select(F.col("l_orderkey").alias("mk")))
    late_d = late.distinct()
    multi_late = (late_d.group_by("late_ok")
                  .agg(F.count_star().alias("n_late"))
                  .filter(F.col("n_late") > 1)
                  .select(F.col("late_ok").alias("xk")))
    return (late_d
            .join(orders.filter(F.col("o_orderstatus") == "F"),
                  on=[("late_ok", "o_orderkey")], how="semi")
            .join(multi, on=[("late_ok", "mk")], how="semi")
            .join(multi_late, on=[("late_ok", "xk")], how="anti")
            .join(supplier, on=[("late_sk", "s_suppkey")])
            .group_by("s_name")
            .agg(F.count_star().alias("numwait"))
            .sort(F.col("numwait").desc(), "s_name").limit(100))


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


def _distinct(x: np.ndarray) -> np.ndarray:
    """The distinct values of an integer array, in order, by a sort: some
    numpy releases (2.3) take a hash path in ``np.unique`` that runs two
    orders of magnitude slower on tens of millions of distinct int64."""
    s = np.sort(x)
    return s[np.concatenate(([True], s[1:] != s[:-1]))] if len(s) else s


def q4_numpy(orders: Dict[str, np.ndarray],
             lineitem: Dict[str, np.ndarray]) -> List[tuple]:
    """Q4 over the generator's arrays: (o_orderpriority, order_count) in
    priority order."""
    late = _distinct(lineitem["l_orderkey"][
        lineitem["l_commitdate"] < lineitem["l_receiptdate"]])
    od = orders["o_orderdate"]
    m = ((od >= np.datetime64("1993-07-01"))
         & (od < np.datetime64("1993-10-01"))
         & np.isin(orders["o_orderkey"], late))
    prio, cnt = np.unique(orders["o_orderpriority"][m], return_counts=True)
    return [(str(p), int(c)) for p, c in zip(prio, cnt)]


def q10_numpy(customer: Dict[str, np.ndarray], orders: Dict[str, np.ndarray],
              lineitem: Dict[str, np.ndarray], k: int = 20) -> List[tuple]:
    """Q10: (c_custkey, c_name, c_acctbal, revenue), revenue descending
    then c_custkey; both joins by direct addressing (c_custkey and
    o_orderkey are 1..n)."""
    ckey, okey = customer["c_custkey"], orders["o_orderkey"]
    if not (np.array_equal(ckey, np.arange(1, len(ckey) + 1))
            and np.array_equal(okey, np.arange(1, len(okey) + 1))):
        raise ValueError("q10_numpy needs c_custkey and o_orderkey = 1..n")
    od = orders["o_orderdate"]
    in_q = (od >= np.datetime64("1993-10-01")) & (od < np.datetime64(
        "1994-01-01"))
    lkey = lineitem["l_orderkey"]
    m = (lineitem["l_returnflag"] == "R") & in_q[lkey - 1]
    vol = lineitem["l_extendedprice"][m] * (1 - lineitem["l_discount"][m])
    cust = orders["o_custkey"][lkey[m] - 1]
    size = len(ckey) + 1
    revenue = np.bincount(cust, weights=vol, minlength=size)
    groups = np.flatnonzero(np.bincount(cust, minlength=size))
    top = groups[np.lexsort((groups, -revenue[groups]))][:k]
    return [(int(c), str(customer["c_name"][c - 1]),
             float(customer["c_acctbal"][c - 1]), float(revenue[c]))
            for c in top]


def q13_numpy(customer: Dict[str, np.ndarray],
              orders: Dict[str, np.ndarray]) -> List[tuple]:
    """Q13: (c_count, custdist), custdist then c_count descending.
    c_custkey is 1..n (direct addressing)."""
    ckey = customer["c_custkey"]
    if not np.array_equal(ckey, np.arange(1, len(ckey) + 1)):
        raise ValueError("q13_numpy needs c_custkey = 1..n")
    kept = orders["o_orderpriority"] != "1-URGENT"
    per = np.bincount(orders["o_custkey"][kept], minlength=len(ckey) + 1)
    cc, dist = np.unique(per[ckey], return_counts=True)
    order = np.lexsort((-cc, -dist))
    return [(int(cc[i]), int(dist[i])) for i in order]


def q18_numpy(orders: Dict[str, np.ndarray], lineitem: Dict[str, np.ndarray],
              customer: Dict[str, np.ndarray], k: int = 100) -> List[tuple]:
    """Q18: (c_name, o_orderkey, o_totalprice), totalprice descending then
    orderkey.  o_orderkey and c_custkey are 1..n."""
    okey, ckey = orders["o_orderkey"], customer["c_custkey"]
    if not (np.array_equal(okey, np.arange(1, len(okey) + 1))
            and np.array_equal(ckey, np.arange(1, len(ckey) + 1))):
        raise ValueError("q18_numpy needs o_orderkey and c_custkey = 1..n")
    qty = np.bincount(lineitem["l_orderkey"], weights=lineitem["l_quantity"],
                      minlength=len(okey) + 1)
    rows = np.flatnonzero(qty[okey] > 300)
    price = orders["o_totalprice"][rows]
    top = rows[np.lexsort((okey[rows], -price))][:k]
    names = customer["c_name"][orders["o_custkey"][top] - 1]
    return [(str(n), int(okey[r]), float(orders["o_totalprice"][r]))
            for n, r in zip(names, top)]


def q21_numpy(lineitem: Dict[str, np.ndarray], orders: Dict[str, np.ndarray],
              supplier: Dict[str, np.ndarray], k: int = 100) -> List[tuple]:
    """Q21: (s_name, numwait), numwait descending then s_name.  Pairs of
    (l_orderkey, l_suppkey) are packed into one int64 and deduplicated by
    a sort; s_suppkey is 1..n."""
    skey = supplier["s_suppkey"]
    if not np.array_equal(skey, np.arange(1, len(skey) + 1)):
        raise ValueError("q21_numpy needs s_suppkey = 1..n")
    width = np.int64(len(skey) + 1)
    lok, lsk = lineitem["l_orderkey"], lineitem["l_suppkey"]
    late = lineitem["l_receiptdate"] > lineitem["l_commitdate"]
    late_pairs = _distinct(lok[late] * width + lsk[late])
    all_pairs = _distinct(lok * width + lsk)
    ok_all, n_sup = np.unique(all_pairs // width, return_counts=True)
    ok_late, n_late = np.unique(late_pairs // width, return_counts=True)
    f_orders = orders["o_orderkey"][orders["o_orderstatus"] == "F"]
    lo = late_pairs // width
    m = (np.isin(lo, f_orders) & np.isin(lo, ok_all[n_sup > 1])
         & ~np.isin(lo, ok_late[n_late > 1]))
    names = supplier["s_name"][late_pairs[m] % width - 1]
    name, cnt = np.unique(names, return_counts=True)
    order = np.lexsort((name, -cnt))[:k]
    return [(str(name[i]), int(cnt[i])) for i in order]


def q11_numpy(partsupp: Dict[str, np.ndarray], supplier: Dict[str, np.ndarray],
              nation: Dict[str, np.ndarray], fraction: float = 0.0001
              ) -> List[tuple]:
    """Q11: (ps_partkey, value), value descending then ps_partkey.
    s_suppkey is 1..n (direct addressing)."""
    skey = supplier["s_suppkey"]
    if not np.array_equal(skey, np.arange(1, len(skey) + 1)):
        raise ValueError("q11_numpy needs s_suppkey = 1..n")
    german = np.isin(supplier["s_nationkey"],
                     nation["n_nationkey"][nation["n_name"] == "GERMANY"])
    m = german[partsupp["ps_suppkey"] - 1]
    value = (partsupp["ps_supplycost"] * partsupp["ps_availqty"])[m]
    part = partsupp["ps_partkey"][m]
    total = float(value.sum())
    size = int(partsupp["ps_partkey"].max(initial=0)) + 1
    per = np.bincount(part, weights=value, minlength=size)
    present = np.bincount(part, minlength=size) > 0
    keys = np.flatnonzero(present & (per > total * fraction))
    order = np.lexsort((keys, -per[keys]))
    return [(int(k), float(per[k])) for k in keys[order]]


def _stable_order(primary: np.ndarray, *minor: np.ndarray) -> np.ndarray:
    """The stable order of rows by ``primary`` then ``minor`` keys (all
    non-negative int64): one stable argsort of ``primary``, then the rare
    runs of equal ``primary`` reordered by the minor keys (a stable
    lexsort of just those rows)."""
    n = len(primary)
    if n < (1 << 26) and (n == 0 or primary.max() < (1 << 37)):
        # a value sort of (key, row) words is several times faster than
        # a stable argsort
        order = np.sort((primary << 26) | np.arange(n, dtype=np.int64)) \
            & ((1 << 26) - 1)
    else:
        order = np.argsort(primary, kind="stable")
    if not minor or len(order) < 2:
        return order
    p = primary[order]
    dup = np.zeros(len(p), dtype=bool)
    dup[1:] = p[1:] == p[:-1]
    dup[:-1] |= dup[1:]
    at = np.flatnonzero(dup)
    if len(at):
        rows = order[at]
        sub = np.lexsort(tuple(m[rows] for m in reversed(minor))
                         + (primary[rows],))
        order[at] = rows[sub]
    return order


def _packs(*fields) -> bool:
    """Whether non-negative int fields (array, bits) fit 63 bits."""
    return sum(b for _, b in fields) <= 63 and all(
        len(a) == 0 or (a.min() >= 0 and a.max() < (1 << b))
        for a, b in fields)


def _pack(*fields) -> np.ndarray:
    out = np.zeros(len(fields[0][0]), dtype=np.int64)
    for a, b in fields:
        out = (out << b) | a.astype(np.int64)
    return out


def sort_lineitem_numpy(lineitem: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
    """The sorted projection: stable by (l_shipdate, l_extendedprice
    descending, l_orderkey), ties in input order.  The three keys pack into
    one int64 (prices as cents) when they fit, else ``np.lexsort``."""
    date = lineitem["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    price, okey = lineitem["l_extendedprice"], lineitem["l_orderkey"]
    cents = np.round(price * 100).astype(np.int64)
    day = date - (date.min() if len(date) else 0)
    fields = ((day, 12), ((1 << 24) - 1 - cents, 24))
    if np.array_equal(cents / 100.0, price) and _packs(*fields):
        order = _stable_order(_pack(*fields), okey)
    else:
        order = np.lexsort((okey, -price, date))
    return {c: lineitem[c][order] for c in SORT_COLUMNS}


def _segmented_cumsum(x: np.ndarray, pid: np.ndarray, pos: np.ndarray,
                      parts: int) -> np.ndarray:
    """Running sums within partitions (rows grouped by partition, ``pos``
    the row's place in it), summed left to right within each partition
    only, so a float's error follows the partition's running total."""
    grid = np.zeros((parts, int(pos.max(initial=0)) + 1), dtype=x.dtype)
    grid[pid, pos] = x
    return np.cumsum(grid, axis=1)[pid, pos]


def supplier_history_numpy(lineitem: Dict[str, np.ndarray],
                           cutoff: datetime.date = HISTORY_CUTOFF
                           ) -> Dict[str, tuple]:
    """:func:`supplier_history` in numpy: ``{column: (data, valid)}`` in
    the output's order (by supplier, ship date, order key, part key, ties
    in input order; the second window's stable sort by supplier and ship
    date keeps that order).  Rows are sorted once; the windows are then
    evaluated at the kept rows only, from each supplier's rows before the
    kept ones (counts, sums, distinct days) and the rows the frames
    reach."""
    supp, okey = lineitem["l_suppkey"], lineitem["l_orderkey"]
    pkey = lineitem["l_partkey"]
    date = lineitem["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    day = date - (date.min() if len(date) else 0)
    if _packs((supp, 20), (day, 13), (okey, 30)):
        order = _stable_order(_pack((supp, 20), (day, 13), (okey, 30)),
                              pkey)
    else:
        order = np.lexsort((pkey, okey, date, supp))
    supp, okey, pkey, date = (supp[order], okey[order], pkey[order],
                              date[order])
    price = lineitem["l_extendedprice"][order]
    qty = lineitem["l_quantity"][order]
    n = len(order)
    start = np.ones(n, dtype=bool)
    start[1:] = supp[1:] != supp[:-1]
    pid = np.cumsum(start) - 1
    first = np.flatnonzero(start)
    parts = len(first)
    peer = start.copy()
    peer[1:] |= date[1:] != date[:-1]
    cut = (np.datetime64(cutoff, "D") - np.datetime64("1970-01-01", "D")
           ).astype(np.int64)
    keep = date >= cut            # a suffix of every supplier's rows
    # rows 30 days before the cutoff on: what the 30-day frames reach
    near = date >= cut - 30
    before = ~near
    base_rev = np.bincount(pid[before], weights=price[before],
                           minlength=parts)
    base_n = np.bincount(pid[before], minlength=parts)
    base_days = np.bincount(pid[before], weights=peer[before],
                            minlength=parts).astype(np.int64)
    # over the near rows: positions, running sums within the supplier
    ni = np.flatnonzero(near)
    npid = pid[ni]
    nfirst = np.ones(len(ni), dtype=bool)
    nfirst[1:] = npid[1:] != npid[:-1]
    nstart = np.flatnonzero(nfirst)
    npos = np.arange(len(ni)) - nstart[np.cumsum(nfirst) - 1]
    run_rev = base_rev[npid] + _segmented_cumsum(
        price[ni], np.cumsum(nfirst) - 1, npos, len(nstart))
    days = base_days[npid] + _segmented_cumsum(
        peer[ni].astype(np.int64), np.cumsum(nfirst) - 1, npos,
        len(nstart))
    comp = supp[ni] * (1 << 24) + date[ni]
    lo30 = np.searchsorted(comp, comp - 30, side="left")
    hi30 = np.searchsorted(comp, comp, side="right") - 1  # peers included
    rev30 = run_rev[hi30] - run_rev[lo30] + price[ni][lo30]
    k = keep[ni]
    idx = ni[k]                   # kept rows in the sorted order
    kp = pid[idx]
    pos = base_n[kp] + npos[k]    # place within the supplier
    lo7 = np.maximum(idx - 6, first[kp])
    qsum = np.zeros(len(idx))
    max7 = np.full(len(idx), -np.inf)
    for j in range(7):
        r = idx - j
        ok = r >= lo7
        qsum += np.where(ok, qty[np.maximum(r, 0)], 0.0)
        max7 = np.where(ok, np.maximum(max7, price[np.maximum(r, 0)]), max7)
    prev_ok = pos > 0
    peer_first = np.searchsorted(comp, comp[k], side="left")
    day_rank = base_n[kp] + npos[peer_first] + 1
    supp_max = np.maximum.reduceat(price, first)[kp] if n else price[:0]
    cols = {"l_suppkey": supp[idx], "l_orderkey": okey[idx],
            "l_partkey": pkey[idx], "l_shipdate": date[idx].astype(np.int32),
            "l_extendedprice": price[idx], "l_quantity": qty[idx],
            "rn": (pos + 1).astype(np.int32), "running_rev": run_rev[k],
            "qty_ma7": qsum / (idx - lo7 + 1), "price_max7": max7,
            "prev_price": np.where(prev_ok, price[np.maximum(idx - 1, 0)],
                                   0.0),
            "day_rank": day_rank.astype(np.int32),
            "day_drank": days[k].astype(np.int32), "rev_30d": rev30[k],
            "supp_max": supp_max}
    return {c: (a, prev_ok if c == "prev_price" else None)
            for c, a in cols.items()}
