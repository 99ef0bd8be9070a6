"""TPC-H data, all 22 queries of the reference suite and Q21 in its EXISTS
form, the lineitem sort and the per-supplier window history, and numpy
oracles.

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
windows), independent of both engines.  ``QUERY_TABLES`` names each
later query's tables in argument order; ``q21_exists`` builds its
conditioned semi and anti joins as logical ``Join`` nodes
(``conditioned_join``), so the same plan runs in either package.

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
import decimal
import os
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LINEITEM_ROWS_PER_SF", "SEGMENTS", "PRIORITIES", "SHIPMODES",
           "NATIONS", "DB_TABLES", "gen_lineitem_arrays",
           "gen_orders_arrays", "gen_customer_arrays", "gen_db_arrays",
           "db_rows", "q6", "q1", "q3", "q4", "q10", "q11", "q13", "q18",
           "q21", "sort_lineitem", "supplier_history", "SORT_COLUMNS",
           "HISTORY_CUTOFF", "q6_numpy", "q1_numpy", "q3_numpy", "q4_numpy",
           "q10_numpy", "q11_numpy", "q13_numpy", "q18_numpy", "q21_numpy",
           "sort_lineitem_numpy", "supplier_history_numpy", "TYPES",
           "CONTAINERS", "QUERY_TABLES", "Q22_CODES", "q2", "q5", "q7", "q8",
           "q9", "q12", "q14", "q15", "q16", "q17", "q19", "q20", "q22",
           "conditioned_join", "q21_exists", "q2_numpy", "q5_numpy",
           "q7_numpy", "q8_numpy", "q9_numpy", "q12_numpy", "q14_numpy",
           "q15_numpy", "q16_numpy", "q17_numpy", "q19_numpy", "q20_numpy",
           "q22_numpy", "q21_exists_numpy", "MONEY_COLUMNS",
           "decimal_columns", "q1_dec", "q6_dec", "q18_dec", "f1", "f1u",
           "w2", "q1_dec_numpy", "q6_dec_numpy", "q18_dec_numpy",
           "f1_numpy", "f1u_numpy", "w2_numpy", "F1U_CUTOFF",
           "Q1_SAMPLE_FRACTION", "Q1_SAMPLE_SEED", "q1_sample",
           "sample_keep", "q1_sample_numpy", "X1_YEAR", "order_quantities",
           "x1", "x1_numpy", "x1o", "x1o_numpy", "q18_in", "q16_notin",
           "q22_scalar", "SUITE_QUERIES", "run_query", "query_oracle",
           "gen_db", "load_db"]

LINEITEM_ROWS_PER_SF = 6_001_215
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
TYPES = ["PROMO BRUSHED COPPER", "STANDARD POLISHED BRASS",
         "PROMO ANODIZED TIN", "ECONOMY BURNISHED NICKEL",
         "PROMO PLATED STEEL", "SMALL PLATED COPPER",
         "MEDIUM BRUSHED STEEL", "LARGE ANODIZED BRASS"]
CONTAINERS = ["SM CASE", "SM BOX", "MED BAG", "MED BOX", "LG CASE", "LG BOX"]
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
DB_TABLES = ("region", "nation", "customer", "supplier", "part", "partsupp",
             "orders", "lineitem")
# region takes no draws (the reference writes it before nation, from
# nation's generator)
_DB_SEEDS = {"region": 1001, "nation": 1001, "customer": 1002,
             "supplier": 1003, "part": 1004, "partsupp": 1005,
             "orders": 1006, "lineitem": 1007}


def db_rows(table: str, sf: float) -> int:
    """Rows of ``table`` at ``sf`` in the reference suite's ``gen_db``."""
    if table == "nation":
        return len(NATIONS)
    if table == "region":
        return len(REGIONS)
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
        if table == "region":
            _keep(parts, cols, "r_regionkey",
                  lambda: np.arange(len(REGIONS), dtype=np.int64))
            _keep(parts, cols, "r_name", lambda: np.array(REGIONS))
        elif table == "part":
            n = n_part
            brands = np.array([f"Brand#{i}{j}" for i in range(1, 6)
                               for j in range(1, 6)])
            _keep(parts, cols, "p_partkey",
                  lambda: np.arange(1, n + 1, dtype=np.int64))
            _keep(parts, cols, "p_name", lambda: np.array(
                [f"part {i} goldenrod" if i % 7 == 0 else f"part {i}"
                 for i in range(1, n + 1)]))
            _keep(parts, cols, "p_type",
                  lambda: rng.choice(np.array(TYPES), n))
            _keep(parts, cols, "p_size", lambda: rng.integers(
                1, 51, n).astype(np.int64))
            _keep(parts, cols, "p_container",
                  lambda: rng.choice(np.array(CONTAINERS), n))
            _keep(parts, cols, "p_brand", lambda: rng.choice(brands, n))
        elif table == "nation":
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


def q1(df, delta_days: int = 90, functions=None):
    """TPC-H Q1: the pricing summary report."""
    F = _functions(functions)
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
    run_q21): the late pairs deduplicated once and cached (``.cache()``,
    read by both of their consumers), two DISTINCTs on the hash
    aggregate, two semi joins, an anti join, an inner join that carries
    ``s_name``, a GROUP BY ``s_name`` and a top 100."""
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
    late_d = late.distinct().cache()
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


# ---------------------------------------------------------------------------------
# The rest of TPC-H (tpch_suite.py:206-586): Q2, Q5, Q7, Q8, Q9, Q12, Q14,
# Q15, Q16, Q17, Q19, Q20, Q22, and Q21 in its EXISTS form
# ---------------------------------------------------------------------------------

# the tables each query takes, in its argument order
QUERY_TABLES = {
    "q2": ("partsupp", "supplier", "nation", "region", "part"),
    "q5": ("customer", "orders", "lineitem", "supplier", "nation", "region"),
    "q7": ("supplier", "lineitem", "orders", "customer", "nation"),
    "q8": ("lineitem", "part", "supplier", "orders", "customer", "nation",
           "region"),
    "q9": ("part", "lineitem", "supplier", "nation", "orders"),
    "q12": ("orders", "lineitem"),
    "q14": ("lineitem", "part"),
    "q15": ("lineitem", "supplier"),
    "q16": ("partsupp", "supplier", "part"),
    "q17": ("lineitem", "part"),
    "q19": ("lineitem", "part"),
    "q20": ("lineitem", "part", "partsupp", "supplier", "nation"),
    "q22": ("customer", "orders"),
    "q21_exists": ("lineitem", "orders", "supplier"),
}
D = datetime.date

# The reference suite's 22 queries as bench.py runs them (tpch_suite.py
# QUERIES and TABLES :915-944): each query's tables in the argument order
# of its body here (and of its numpy oracle, ``<name>_numpy``)
SUITE_QUERIES = {
    "q1": ("lineitem",), "q2": QUERY_TABLES["q2"],
    "q3": ("customer", "orders", "lineitem"), "q4": ("orders", "lineitem"),
    "q5": QUERY_TABLES["q5"], "q6": ("lineitem",), "q7": QUERY_TABLES["q7"],
    "q8": QUERY_TABLES["q8"], "q9": QUERY_TABLES["q9"],
    "q10": ("customer", "orders", "lineitem"),
    "q11": ("partsupp", "supplier", "nation"), "q12": QUERY_TABLES["q12"],
    "q13": ("customer", "orders"), "q14": QUERY_TABLES["q14"],
    "q15": QUERY_TABLES["q15"], "q16": QUERY_TABLES["q16"],
    "q17": QUERY_TABLES["q17"], "q18": ("orders", "lineitem", "customer"),
    "q19": QUERY_TABLES["q19"], "q20": QUERY_TABLES["q20"],
    "q21": ("lineitem", "orders", "supplier"), "q22": QUERY_TABLES["q22"],
}


def run_query(name: str, dfs) -> list:
    """Query ``name`` of :data:`SUITE_QUERIES` over ``dfs`` ({table:
    DataFrame}), collected: the suite's ``run_<name>(dfs)``."""
    return globals()[name](*(dfs[t] for t in SUITE_QUERIES[name])).collect()


def query_oracle(name: str, tables) -> list:
    """The numpy oracle of query ``name`` over ``tables`` ({table: dict of
    numpy arrays}), as rows (Q6's single value as one row)."""
    out = globals()[f"{name}_numpy"](*(tables[t]
                                       for t in SUITE_QUERIES[name]))
    return out if isinstance(out, list) else [(out,)]


def gen_db(sf: float, out_dir: str, chunk: int = 1_000_000,
           data: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
           codec: str = "UNCOMPRESSED", tables=DB_TABLES) -> Dict[str, str]:
    """The reference suite's ``gen_db`` (tpch_suite.py:45) with the port's
    parquet writer: the eight tables of :func:`gen_db_arrays` (or those of
    ``tables``; or of ``data``, the same dicts already drawn) written to
    ``<out_dir>/tpch_sf<sf>/<table>.parquet``, with pyarrow's row groups
    (one per ``chunk`` rows of orders and lineitem, which the reference
    writes chunk by chunk; 1,048,576-row groups of the other tables).
    Returns {table: path}; tables already written are kept."""
    from ..io.writers import ROW_GROUP_ROWS, write_table
    root = os.path.join(out_dir, f"tpch_sf{sf}")
    paths = {t: os.path.join(root, f"{t}.parquet") for t in tables}
    os.makedirs(root, exist_ok=True)
    for t, path in paths.items():
        if os.path.exists(path):
            continue
        cols = data[t] if data is not None \
            else gen_db_arrays(sf, tables=(t,), chunk=chunk)[t]
        tmp = path + ".tmp"
        write_table(cols, tmp, codec, chunk if t in ("orders", "lineitem")
                    else ROW_GROUP_ROWS)
        os.replace(tmp, path)
    return paths


def load_db(sess, sf: float, out_dir: str):
    """{table: ``sess.read_parquet``} over :func:`gen_db`'s files
    (tpch_suite.py:181)."""
    return {t: sess.read_parquet(p) for t, p in gen_db(sf, out_dir).items()}


def _F():
    from ..sql import functions
    return functions


def q2(partsupp, supplier, nation, region, part):
    """TPC-H Q2 minimum cost supplier (tpch_suite.py:206 run_q2): the
    European suppliers' cheapest offer per part of size 15."""
    f = _F()
    eu_sup = (supplier
              .join(nation, on=[("s_nationkey", "n_nationkey")])
              .join(region.filter(f.col("r_name") == "EUROPE"),
                    on=[("n_regionkey", "r_regionkey")]))
    ps_eu = partsupp.join(eu_sup, on=[("ps_suppkey", "s_suppkey")])
    min_cost = (ps_eu.group_by("ps_partkey")
                .agg(f.min(f.col("ps_supplycost")).alias("min_cost")))
    return (ps_eu.join(min_cost, on=["ps_partkey"])
            .filter(f.col("ps_supplycost") == f.col("min_cost"))
            .join(part.filter(f.col("p_size") == 15),
                  on=[("ps_partkey", "p_partkey")])
            .select("s_acctbal", "s_name", "n_name", "ps_partkey",
                    "ps_supplycost")
            .sort(f.col("s_acctbal").desc(), "s_name", "ps_partkey")
            .limit(100))


def q5(customer, orders, lineitem, supplier, nation, region):
    """TPC-H Q5 local supplier volume (tpch_suite.py:245 run_q5)."""
    f = _F()
    lo, hi = D(1994, 1, 1), D(1995, 1, 1)
    return (customer
            .join(orders, on=[("c_custkey", "o_custkey")])
            .filter((f.col("o_orderdate") >= lo) & (f.col("o_orderdate") < hi))
            .join(lineitem, on=[("o_orderkey", "l_orderkey")])
            .join(supplier, on=[("l_suppkey", "s_suppkey")])
            .filter(f.col("c_nationkey") == f.col("s_nationkey"))
            .join(nation, on=[("s_nationkey", "n_nationkey")])
            .join(region.filter(f.col("r_name") == "ASIA"),
                  on=[("n_regionkey", "r_regionkey")])
            .select("n_name",
                    (f.col("l_extendedprice") * (1 - f.col("l_discount")))
                    .alias("volume"))
            .group_by("n_name").agg(f.sum(f.col("volume")).alias("revenue"))
            .sort(f.col("revenue").desc()))


def q7(supplier, lineitem, orders, customer, nation):
    """TPC-H Q7 volume shipping (tpch_suite.py:269 run_q7): the nation
    pair's filter reads two string columns that joins produced."""
    f = _F()
    n1, n2 = "FRANCE", "GERMANY"
    lo, hi = D(1995, 1, 1), D(1996, 12, 31)
    sup_n = nation.filter(f.col("n_name").isin(n1, n2)) \
        .select(f.col("n_nationkey").alias("sn_key"),
                f.col("n_name").alias("supp_nation"))
    cust_n = nation.filter(f.col("n_name").isin(n1, n2)) \
        .select(f.col("n_nationkey").alias("cn_key"),
                f.col("n_name").alias("cust_nation"))
    return (supplier.join(sup_n, on=[("s_nationkey", "sn_key")])
            .join(lineitem, on=[("s_suppkey", "l_suppkey")])
            .filter((f.col("l_shipdate") >= lo) & (f.col("l_shipdate") <= hi))
            .join(orders, on=[("l_orderkey", "o_orderkey")])
            .join(customer, on=[("o_custkey", "c_custkey")])
            .join(cust_n, on=[("c_nationkey", "cn_key")])
            .filter(((f.col("supp_nation") == n1)
                     & (f.col("cust_nation") == n2))
                    | ((f.col("supp_nation") == n2)
                       & (f.col("cust_nation") == n1)))
            .select("supp_nation", "cust_nation",
                    f.year(f.col("l_shipdate")).alias("l_year"),
                    (f.col("l_extendedprice") * (1 - f.col("l_discount")))
                    .alias("volume"))
            .group_by("supp_nation", "cust_nation", "l_year")
            .agg(f.sum(f.col("volume")).alias("revenue"))
            .sort("supp_nation", "cust_nation", "l_year"))


def q8(lineitem, part, supplier, orders, customer, nation, region):
    """TPC-H Q8 national market share (tpch_suite.py:298 run_q8)."""
    f = _F()
    lo, hi = D(1995, 1, 1), D(1996, 12, 31)
    n2 = nation.select(f.col("n_nationkey").alias("n2_key"),
                       f.col("n_name").alias("n2_name"))
    return (lineitem
            .join(part, on=[("l_partkey", "p_partkey")])
            .join(supplier, on=[("l_suppkey", "s_suppkey")])
            .join(orders, on=[("l_orderkey", "o_orderkey")])
            .filter((f.col("o_orderdate") >= lo) & (f.col("o_orderdate") <= hi))
            .join(customer, on=[("o_custkey", "c_custkey")])
            .join(nation, on=[("c_nationkey", "n_nationkey")])
            .join(region.filter(f.col("r_name") == "AMERICA"),
                  on=[("n_regionkey", "r_regionkey")])
            .join(n2, on=[("s_nationkey", "n2_key")])
            .with_column("o_year", f.year(f.col("o_orderdate")))
            .with_column("volume",
                         f.col("l_extendedprice") * (1 - f.col("l_discount")))
            .with_column("brazil_volume",
                         f.when(f.col("n2_name") == "BRAZIL",
                                f.col("volume")).otherwise(f.lit(0.0)))
            .group_by("o_year")
            .agg(f.sum(f.col("brazil_volume")).alias("bv"),
                 f.sum(f.col("volume")).alias("tv"))
            .select("o_year", (f.col("bv") / f.col("tv")).alias("mkt_share"))
            .sort("o_year"))


def q9(part, lineitem, supplier, nation, orders):
    """TPC-H Q9 product type profit (tpch_suite.py:329 run_q9)."""
    f = _F()
    return (part.filter(f.col("p_name").like("%goldenrod%"))
            .join(lineitem, on=[("p_partkey", "l_partkey")])
            .join(supplier, on=[("l_suppkey", "s_suppkey")])
            .join(nation, on=[("s_nationkey", "n_nationkey")])
            .join(orders, on=[("l_orderkey", "o_orderkey")])
            .select(f.col("n_name").alias("nation"),
                    f.year(f.col("o_orderdate")).alias("o_year"),
                    (f.col("l_extendedprice") * (1 - f.col("l_discount"))
                     - f.lit(0.01) * f.col("l_quantity")).alias("amount"))
            .group_by("nation", "o_year")
            .agg(f.sum(f.col("amount")).alias("sum_profit"))
            .sort("nation", f.col("o_year").desc()))


def q12(orders, lineitem):
    """TPC-H Q12 shipping modes and order priority (tpch_suite.py:380
    run_q12)."""
    f = _F()
    lo, hi = D(1994, 1, 1), D(1995, 1, 1)
    high = f.when(f.col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                  f.lit(1)).otherwise(f.lit(0))
    low = f.when(~f.col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                 f.lit(1)).otherwise(f.lit(0))
    return (orders
            .join(lineitem
                  .filter(f.col("l_shipmode").isin("MAIL", "SHIP")
                          & (f.col("l_commitdate") < f.col("l_receiptdate"))
                          & (f.col("l_shipdate") < f.col("l_commitdate"))
                          & (f.col("l_receiptdate") >= lo)
                          & (f.col("l_receiptdate") < hi)),
                  on=[("o_orderkey", "l_orderkey")])
            .select("l_shipmode", high.alias("high"), low.alias("low"))
            .group_by("l_shipmode")
            .agg(f.sum(f.col("high")).alias("high_line_count"),
                 f.sum(f.col("low")).alias("low_line_count"))
            .sort("l_shipmode"))


def q14(lineitem, part):
    """TPC-H Q14 promotion effect (tpch_suite.py:418 run_q14)."""
    f = _F()
    lo, hi = D(1995, 9, 1), D(1995, 10, 1)
    vol = f.col("l_extendedprice") * (1 - f.col("l_discount"))
    return (lineitem
            .filter((f.col("l_shipdate") >= lo) & (f.col("l_shipdate") < hi))
            .join(part, on=[("l_partkey", "p_partkey")])
            .select(f.when(f.col("p_type").like("PROMO%"), vol)
                    .otherwise(f.lit(0.0)).alias("promo"),
                    vol.alias("total"))
            .agg(f.sum(f.col("promo")).alias("p"),
                 f.sum(f.col("total")).alias("t"))
            .select((f.col("p") / f.col("t") * 100.0).alias("promo_revenue")))


def q15(lineitem, supplier):
    """TPC-H Q15 top supplier (tpch_suite.py:433 run_q15): runs the
    maximum's query (collected); returns the DataFrame of the second, which
    keeps the suppliers whose revenue equals it."""
    f = _F()
    lo, hi = D(1996, 1, 1), D(1996, 4, 1)
    revenue = (lineitem
               .filter((f.col("l_shipdate") >= lo)
                       & (f.col("l_shipdate") < hi))
               .with_column("rev", f.col("l_extendedprice")
                            * (1 - f.col("l_discount")))
               .group_by("l_suppkey")
               .agg(f.sum(f.col("rev")).alias("total_revenue")))
    top = revenue.agg(f.max(f.col("total_revenue")).alias("m")) \
        .collect()[0][0]
    return (supplier
            .join(revenue.filter(f.col("total_revenue") == f.lit(top)),
                  on=[("s_suppkey", "l_suppkey")])
            .select("s_suppkey", "s_name", "total_revenue")
            .sort("s_suppkey"))


def q16(partsupp, supplier, part):
    """TPC-H Q16 parts/supplier relationship (tpch_suite.py:452 run_q16)."""
    f = _F()
    bad = supplier.filter(f.col("s_acctbal") < 0)
    return (partsupp
            .join(bad, on=[("ps_suppkey", "s_suppkey")], how="anti")
            .join(part.filter((f.col("p_brand") != "Brand#45")
                              & (f.col("p_size").isin(1, 4, 7, 10, 14, 23))),
                  on=[("ps_partkey", "p_partkey")])
            .select("p_brand", "p_type", "p_size", "ps_suppkey").distinct()
            .group_by("p_brand", "p_type", "p_size")
            .agg(f.count_star().alias("supplier_cnt"))
            .sort(f.col("supplier_cnt").desc(), "p_brand", "p_type",
                  "p_size"))


def q17(lineitem, part):
    """TPC-H Q17 small-quantity-order revenue (tpch_suite.py:467
    run_q17)."""
    f = _F()
    parts = part.filter(f.col("p_container") == "JUMBO PKG")
    avg_qty = (lineitem.group_by("l_partkey")
               .agg(f.avg(f.col("l_quantity")).alias("aq"))
               .select(f.col("l_partkey").alias("ak"),
                       (f.col("aq") * 0.2).alias("lim")))
    return (lineitem
            .join(parts, on=[("l_partkey", "p_partkey")])
            .join(avg_qty, on=[("l_partkey", "ak")])
            .filter(f.col("l_quantity") < f.col("lim"))
            .agg(f.sum(f.col("l_extendedprice")).alias("s"))
            .select((f.col("s") / 7.0).alias("avg_yearly")))


def q19(lineitem, part):
    """TPC-H Q19 discounted revenue (tpch_suite.py:497 run_q19): the
    container lists read a string column the join produced."""
    f = _F()
    return (lineitem
            .join(part, on=[("l_partkey", "p_partkey")])
            .filter(
                (f.col("p_container").isin("SM CASE", "SM BOX")
                 & (f.col("l_quantity") >= 1) & (f.col("l_quantity") <= 20)
                 & (f.col("p_size") <= 15))
                | (f.col("p_container").isin("MED BAG", "MED BOX")
                   & (f.col("l_quantity") >= 10)
                   & (f.col("l_quantity") <= 30)
                   & (f.col("p_size") <= 25)))
            .agg(f.sum(f.col("l_extendedprice") * (1 - f.col("l_discount")))
                 .alias("revenue")))


def q20(lineitem, part, partsupp, supplier, nation):
    """TPC-H Q20 potential part promotion (tpch_suite.py:512 run_q20)."""
    f = _F()
    lo, hi = D(1994, 1, 1), D(1995, 1, 1)
    shipped = (lineitem
               .filter((f.col("l_shipdate") >= lo)
                       & (f.col("l_shipdate") < hi))
               .group_by("l_partkey", "l_suppkey")
               .agg(f.sum(f.col("l_quantity")).alias("sq"))
               .with_column("half_qty", f.col("sq") * 0.5))
    forest = part.filter(f.like(f.col("p_name"), "part 1%"))
    excess = (partsupp
              .join(forest, on=[("ps_partkey", "p_partkey")], how="semi")
              .join(shipped.select(f.col("l_partkey").alias("pk"),
                                   f.col("l_suppkey").alias("sk"),
                                   "half_qty"),
                    on=[("ps_partkey", "pk"), ("ps_suppkey", "sk")])
              .filter(f.col("ps_availqty") > f.col("half_qty")))
    return (supplier
            .join(excess, on=[("s_suppkey", "ps_suppkey")], how="semi")
            .join(nation.filter(f.col("n_name") == "CANADA"),
                  on=[("s_nationkey", "n_nationkey")])
            .select("s_name", "s_suppkey").sort("s_name"))


Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def q22(customer, orders):
    """TPC-H Q22 global sales opportunity (tpch_suite.py:567 run_q22):
    groups and filters on ``substring(c_phone, 1, 2)``, a string column
    the stage computes; runs the average balance's query (collected) and
    returns the DataFrame of the second."""
    f = _F()
    cust = customer.with_column(
        "cntrycode", f.substring(f.col("c_phone"), 1, 2))
    in_codes = cust.filter(f.col("cntrycode").isin(*Q22_CODES))
    avg_bal = in_codes.filter(f.col("c_acctbal") > 0.0) \
        .agg(f.avg(f.col("c_acctbal")).alias("a")).collect()[0][0]
    return (in_codes.filter(f.col("c_acctbal") > f.lit(avg_bal))
            .join(orders, on=[("c_custkey", "o_custkey")], how="anti")
            .group_by("cntrycode")
            .agg(f.count_star().alias("numcust"),
                 f.sum(f.col("c_acctbal")).alias("totacctbal"))
            .sort("cntrycode"))


def conditioned_join(left, right, on, how: str, condition, logical=None):
    """``left`` joined to ``right`` on the (left, right) name pairs ``on``
    with a residual ``condition`` (a Column over both sides' columns), as
    Spark plans a correlated EXISTS: the logical ``Join`` wrapped in a
    DataFrame of ``left``'s package (``DataFrame.join`` has no condition
    argument).  ``logical`` is that package's ``plan.logical`` module
    (default: this one's)."""
    import importlib
    if logical is None:
        from ..plan import logical
    # the expression module of the condition's package
    exprs = importlib.import_module(type(condition.expr).__module__)
    node = logical.Join(left._plan, right._plan,
                        [exprs.UnresolvedColumn(a) for a, _ in on],
                        [exprs.UnresolvedColumn(b) for _, b in on],
                        how=how, condition=condition.expr)
    return type(left)(node, left.session)


def q21_exists(lineitem, orders, supplier, functions=None, logical=None):
    """TPC-H Q21 suppliers who kept orders waiting, in the official EXISTS
    form as Spark plans it: the late lineitems ``l1`` semi-joined to every
    lineitem of their order under ``l2.l_suppkey <> l1.l_suppkey`` (EXISTS)
    and anti-joined to the late ones under the same condition (NOT
    EXISTS), semi-joined to the orders with status 'F', joined to
    supplier; late lines counted per supplier name, top 100.  Counts
    ``l1`` rows, where ``q21`` (the reference suite's rewrite) counts
    distinct (order, supplier) pairs.  ``functions`` and ``logical`` are
    the DataFrame's package's modules (default: this one's)."""
    f = functions if functions is not None else _F()
    late = f.col("l_receiptdate") > f.col("l_commitdate")
    l1 = lineitem.filter(late)
    l2 = lineitem.select(f.col("l_orderkey").alias("l2_orderkey"),
                         f.col("l_suppkey").alias("l2_suppkey"))
    l3 = lineitem.filter(late).select(
        f.col("l_orderkey").alias("l3_orderkey"),
        f.col("l_suppkey").alias("l3_suppkey"))
    exists = conditioned_join(
        l1, l2, [("l_orderkey", "l2_orderkey")], "semi",
        f.col("l2_suppkey") != f.col("l_suppkey"), logical)
    waiting = conditioned_join(
        exists, l3, [("l_orderkey", "l3_orderkey")], "anti",
        f.col("l3_suppkey") != f.col("l_suppkey"), logical)
    return (waiting
            .join(orders.filter(f.col("o_orderstatus") == "F"),
                  on=[("l_orderkey", "o_orderkey")], how="semi")
            .join(supplier, on=[("l_suppkey", "s_suppkey")])
            .group_by("s_name")
            .agg(f.count_star().alias("numwait"))
            .sort(f.col("numwait").desc(), "s_name").limit(100))


# -- numpy oracles of the rest of TPC-H -----------------------------------------
#
# Every key of gen_db is dense (c_custkey, o_orderkey, p_partkey and
# s_suppkey are 1..n, the nation and region keys 0..n-1), so the joins are
# direct addressing; groups use np.unique over small label sets or a sort
# of packed int64 keys (``_distinct``).

def _dense(table: Dict[str, np.ndarray], key: str, base: int = 1) -> None:
    k = table[key]
    if not np.array_equal(k, np.arange(base, base + len(k))):
        raise ValueError(f"the oracle needs {key} = {base}..{base}+n-1")


def _year(days) -> np.ndarray:
    return days.astype("datetime64[Y]").astype(np.int64) + 1970


def _group_sum(labels: np.ndarray, x: np.ndarray):
    """(distinct labels in order, the sum of ``x`` per label)."""
    keys, inv = np.unique(labels, return_inverse=True)
    return keys, np.bincount(inv.reshape(-1), weights=x,
                             minlength=len(keys))


def _in_range(d, lo: str, hi: str, closed: bool = False):
    lo, hi = np.datetime64(lo), np.datetime64(hi)
    return (d >= lo) & ((d <= hi) if closed else (d < hi))


def _vol(li, m):
    return li["l_extendedprice"][m] * (1 - li["l_discount"][m])


def q2_numpy(partsupp, supplier, nation, region, part, k: int = 100):
    """Q2: (s_acctbal, s_name, n_name, ps_partkey, ps_supplycost),
    s_acctbal descending, then s_name, then ps_partkey."""
    _dense(supplier, "s_suppkey")
    _dense(part, "p_partkey")
    eu = region["r_regionkey"][region["r_name"] == "EUROPE"]
    n_eu = np.isin(nation["n_regionkey"], eu)
    sn = supplier["s_nationkey"]
    ps_s = partsupp["ps_suppkey"] - 1
    ok = n_eu[sn[ps_s]]
    pk, cost = partsupp["ps_partkey"], partsupp["ps_supplycost"]
    min_cost = np.full(len(part["p_partkey"]) + 1, np.inf)
    np.minimum.at(min_cost, pk[ok], cost[ok])
    rows = np.flatnonzero(ok & (cost == min_cost[pk])
                          & (part["p_size"][pk - 1] == 15))
    s = ps_s[rows]
    bal, name = supplier["s_acctbal"][s], supplier["s_name"][s]
    order = np.lexsort((pk[rows], name, -bal))[:k]
    return [(float(bal[i]), str(name[i]),
             str(nation["n_name"][sn[s[i]]]), int(pk[rows][i]),
             float(cost[rows][i])) for i in order]


def q5_numpy(customer, orders, lineitem, supplier, nation, region):
    """Q5: (n_name, revenue), revenue descending."""
    for t, c in ((customer, "c_custkey"), (orders, "o_orderkey"),
                 (supplier, "s_suppkey")):
        _dense(t, c)
    o = lineitem["l_orderkey"] - 1
    cn = customer["c_nationkey"][orders["o_custkey"][o] - 1]
    sn = supplier["s_nationkey"][lineitem["l_suppkey"] - 1]
    asia = region["r_regionkey"][region["r_name"] == "ASIA"]
    m = (_in_range(orders["o_orderdate"][o], "1994-01-01", "1995-01-01")
         & (cn == sn) & np.isin(nation["n_regionkey"][sn], asia))
    keys, rev = _group_sum(sn[m], _vol(lineitem, m))
    order = np.argsort(-rev, kind="stable")
    return [(str(nation["n_name"][keys[i]]), float(rev[i])) for i in order]


def q7_numpy(supplier, lineitem, orders, customer, nation):
    """Q7: (supp_nation, cust_nation, l_year, revenue) in that order."""
    for t, c in ((customer, "c_custkey"), (orders, "o_orderkey"),
                 (supplier, "s_suppkey")):
        _dense(t, c)
    names = nation["n_name"]
    sn = names[supplier["s_nationkey"][lineitem["l_suppkey"] - 1]]
    cn = names[customer["c_nationkey"][
        orders["o_custkey"][lineitem["l_orderkey"] - 1] - 1]]
    ship = lineitem["l_shipdate"]
    pair = (((sn == "FRANCE") & (cn == "GERMANY"))
            | ((sn == "GERMANY") & (cn == "FRANCE")))
    m = _in_range(ship, "1995-01-01", "1996-12-31", closed=True) & pair
    label = np.char.add(np.char.add(sn[m], "|"), cn[m])
    year = _year(ship[m])
    keys, inv = np.unique(np.char.add(label, year.astype(str)),
                          return_inverse=True)
    rev = np.bincount(inv.reshape(-1), weights=_vol(lineitem, m),
                      minlength=len(keys))
    rows = []
    for i, kk in enumerate(keys.tolist()):
        a, b = kk.split("|")
        rows.append((a, b[:-4], int(b[-4:]), float(rev[i])))
    return sorted(rows, key=lambda r: r[:3])


def q8_numpy(lineitem, part, supplier, orders, customer, nation, region):
    """Q8: (o_year, mkt_share) by year."""
    for t, c in ((customer, "c_custkey"), (orders, "o_orderkey"),
                 (supplier, "s_suppkey"), (part, "p_partkey")):
        _dense(t, c)
    o = lineitem["l_orderkey"] - 1
    od = orders["o_orderdate"][o]
    cn = customer["c_nationkey"][orders["o_custkey"][o] - 1]
    america = region["r_regionkey"][region["r_name"] == "AMERICA"]
    m = (_in_range(od, "1995-01-01", "1996-12-31", closed=True)
         & np.isin(nation["n_regionkey"][cn], america))
    vol = _vol(lineitem, m)
    sn = supplier["s_nationkey"][lineitem["l_suppkey"][m] - 1]
    brazil = np.where(nation["n_name"][sn] == "BRAZIL", vol, 0.0)
    keys, tv = _group_sum(_year(od[m]), vol)
    _, bv = _group_sum(_year(od[m]), brazil)
    return [(int(y), float(b / t)) for y, b, t in zip(keys, bv, tv)]


def q9_numpy(part, lineitem, supplier, nation, orders):
    """Q9: (nation, o_year, sum_profit), nation then year descending."""
    for t, c in ((orders, "o_orderkey"), (supplier, "s_suppkey"),
                 (part, "p_partkey")):
        _dense(t, c)
    green = np.char.find(part["p_name"], "goldenrod") >= 0
    m = green[lineitem["l_partkey"] - 1]
    nat = supplier["s_nationkey"][lineitem["l_suppkey"][m] - 1]
    year = _year(orders["o_orderdate"][lineitem["l_orderkey"][m] - 1])
    amount = _vol(lineitem, m) - 0.01 * lineitem["l_quantity"][m]
    keys, profit = _group_sum(nat * 10_000 + year, amount)
    rows = [(str(nation["n_name"][kk // 10_000]), int(kk % 10_000),
             float(p)) for kk, p in zip(keys, profit)]
    return sorted(rows, key=lambda r: (r[0], -r[1]))


def q12_numpy(orders, lineitem):
    """Q12: (l_shipmode, high_line_count, low_line_count) by ship mode."""
    _dense(orders, "o_orderkey")
    li = lineitem
    m = (np.isin(li["l_shipmode"], ["MAIL", "SHIP"])
         & (li["l_commitdate"] < li["l_receiptdate"])
         & (li["l_shipdate"] < li["l_commitdate"])
         & _in_range(li["l_receiptdate"], "1994-01-01", "1995-01-01"))
    prio = orders["o_orderpriority"][li["l_orderkey"][m] - 1]
    high = np.isin(prio, ["1-URGENT", "2-HIGH"]).astype(np.float64)
    modes, hi_cnt = _group_sum(li["l_shipmode"][m], high)
    _, lo_cnt = _group_sum(li["l_shipmode"][m], 1.0 - high)
    return [(str(s), int(round(h)), int(round(lo)))
            for s, h, lo in zip(modes, hi_cnt, lo_cnt)]


def q14_numpy(lineitem, part):
    """Q14: [(promo_revenue,)]."""
    _dense(part, "p_partkey")
    m = _in_range(lineitem["l_shipdate"], "1995-09-01", "1995-10-01")
    vol = _vol(lineitem, m)
    promo = np.char.startswith(part["p_type"][lineitem["l_partkey"][m] - 1],
                               "PROMO")
    return [(float(vol[promo].sum() / vol.sum() * 100.0),)]


def q15_numpy(lineitem, supplier):
    """Q15: (s_suppkey, s_name, total_revenue) by s_suppkey."""
    _dense(supplier, "s_suppkey")
    m = _in_range(lineitem["l_shipdate"], "1996-01-01", "1996-04-01")
    n = len(supplier["s_suppkey"]) + 1
    sk = lineitem["l_suppkey"][m]
    rev = np.bincount(sk, weights=_vol(lineitem, m), minlength=n)
    present = np.bincount(sk, minlength=n) > 0
    if not present.any():
        return []
    top = rev[present].max()
    keys = np.flatnonzero(present & (rev == top))
    return [(int(kk), str(supplier["s_name"][kk - 1]), float(rev[kk]))
            for kk in keys]


def q16_numpy(partsupp, supplier, part):
    """Q16: (p_brand, p_type, p_size, supplier_cnt), count descending,
    then brand, type and size."""
    _dense(part, "p_partkey")
    _dense(supplier, "s_suppkey")
    sk, pk = partsupp["ps_suppkey"], partsupp["ps_partkey"] - 1
    brand, ptype, size = part["p_brand"], part["p_type"], part["p_size"]
    m = ((supplier["s_acctbal"][sk - 1] >= 0) & (brand[pk] != "Brand#45")
         & np.isin(size[pk], [1, 4, 7, 10, 14, 23]))
    bi = np.unique(brand, return_inverse=True)
    ti = np.unique(ptype, return_inverse=True)
    b, t = bi[1].reshape(-1)[pk[m]], ti[1].reshape(-1)[pk[m]]
    group = (b * len(ti[0]) + t) * 64 + size[pk[m]]
    pairs = _distinct(group * (1 << 32) + sk[m])
    g, cnt = np.unique(pairs >> 32, return_counts=True)
    rows = [(str(bi[0][x // 64 // len(ti[0])]),
             str(ti[0][x // 64 % len(ti[0])]), int(x % 64), int(c))
            for x, c in zip(g, cnt)]
    return sorted(rows, key=lambda r: (-r[3], r[0], r[1], r[2]))


def q17_numpy(lineitem, part):
    """Q17: [(avg_yearly,)], None when no lineitem qualifies."""
    _dense(part, "p_partkey")
    pk, qty = lineitem["l_partkey"], lineitem["l_quantity"]
    n = len(part["p_partkey"]) + 1
    avg = np.bincount(pk, weights=qty, minlength=n) / np.maximum(
        np.bincount(pk, minlength=n), 1)
    m = (part["p_container"][pk - 1] == "JUMBO PKG") & (qty < avg[pk] * 0.2)
    if not m.any():
        return [(None,)]
    return [(float(lineitem["l_extendedprice"][m].sum() / 7.0),)]


def q19_numpy(lineitem, part):
    """Q19: [(revenue,)], None when no lineitem qualifies."""
    _dense(part, "p_partkey")
    p = lineitem["l_partkey"] - 1
    cont, size = part["p_container"][p], part["p_size"][p]
    qty = lineitem["l_quantity"]
    m = ((np.isin(cont, ["SM CASE", "SM BOX"]) & (qty >= 1) & (qty <= 20)
          & (size <= 15))
         | (np.isin(cont, ["MED BAG", "MED BOX"]) & (qty >= 10)
            & (qty <= 30) & (size <= 25)))
    if not m.any():
        return [(None,)]
    return [(float(_vol(lineitem, m).sum()),)]


def q20_numpy(lineitem, part, partsupp, supplier, nation):
    """Q20: (s_name, s_suppkey) by s_name."""
    _dense(part, "p_partkey")
    _dense(supplier, "s_suppkey")
    w = np.int64(len(supplier["s_suppkey"]) + 1)
    m = _in_range(lineitem["l_shipdate"], "1994-01-01", "1995-01-01")
    key = lineitem["l_partkey"][m] * w + lineitem["l_suppkey"][m]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.concatenate(([True], ks[1:] != ks[:-1])) if len(ks) else ks
    keys = ks[first]
    sq = np.add.reduceat(lineitem["l_quantity"][m][order],
                         np.flatnonzero(first)) if len(ks) else ks
    forest = np.char.startswith(part["p_name"], "part 1")
    ps_key = partsupp["ps_partkey"] * w + partsupp["ps_suppkey"]
    found = np.zeros(len(ps_key), dtype=bool)
    half = np.zeros(len(ps_key))
    if len(keys):
        at = np.minimum(np.searchsorted(keys, ps_key), len(keys) - 1)
        found = keys[at] == ps_key
        half = np.where(found, sq[at] * 0.5, 0.0)
    ok = (forest[partsupp["ps_partkey"] - 1] & found
          & (partsupp["ps_availqty"] > half))
    supp = np.unique(partsupp["ps_suppkey"][ok])
    canada = nation["n_nationkey"][nation["n_name"] == "CANADA"]
    supp = supp[np.isin(supplier["s_nationkey"][supp - 1], canada)]
    names = supplier["s_name"][supp - 1]
    order = np.argsort(names, kind="stable")
    return [(str(names[i]), int(supp[i])) for i in order]


def q22_numpy(customer, orders):
    """Q22: (cntrycode, numcust, totacctbal) by cntrycode."""
    code = customer["c_phone"].astype("U2")
    bal = customer["c_acctbal"]
    inc = np.isin(code, Q22_CODES)
    pos = inc & (bal > 0.0)
    if not pos.any():
        return []
    avg = bal[pos].mean()
    has_order = np.isin(customer["c_custkey"], orders["o_custkey"])
    m = inc & (bal > avg) & ~has_order
    keys, inv = np.unique(code[m], return_inverse=True)
    inv = inv.reshape(-1)
    cnt = np.bincount(inv, minlength=len(keys))
    tot = np.bincount(inv, weights=bal[m], minlength=len(keys))
    return [(str(c), int(n), float(t)) for c, n, t in zip(keys, cnt, tot)]


def q21_exists_numpy(lineitem, orders, supplier, k: int = 100):
    """Q21 in its EXISTS form: (s_name, numwait), numwait descending then
    s_name, counting late lines ``l1`` of 'F' orders for which another
    supplier has a line of the order (EXISTS) and no other supplier has a
    late one (NOT EXISTS).  With per-order line counts and per (order,
    supplier) counts: EXISTS holds when the order has more lines than the
    pair, NOT EXISTS when it has no more late lines than the pair."""
    _dense(supplier, "s_suppkey")
    _dense(orders, "o_orderkey")
    ok, sk = lineitem["l_orderkey"], lineitem["l_suppkey"]
    late = lineitem["l_receiptdate"] > lineitem["l_commitdate"]
    n_ord = len(orders["o_orderkey"]) + 1
    lines = np.bincount(ok, minlength=n_ord)
    late_lines = np.bincount(ok[late], minlength=n_ord)
    pair = ok * np.int64(len(supplier["s_suppkey"]) + 1) + sk
    order = np.argsort(pair, kind="stable")
    ps = pair[order]
    start = np.concatenate(([True], ps[1:] != ps[:-1])) if len(ps) else ps
    gid = np.empty(len(pair), dtype=np.int64)
    gid[order] = np.cumsum(start) - 1
    pair_lines = np.bincount(gid)
    pair_late = np.bincount(gid[late], minlength=len(pair_lines))
    f = orders["o_orderstatus"] == "F"
    m = (late & (lines[ok] > pair_lines[gid])
         & (late_lines[ok] == pair_late[gid]) & f[ok - 1])
    name, cnt = np.unique(supplier["s_name"][sk[m] - 1], return_counts=True)
    top = np.lexsort((name, -cnt))[:k]
    return [(str(name[i]), int(cnt[i])) for i in top]


# ---------------------------------------------------------------------------------
# Decimal money columns (Q1-dec, Q6-dec, Q18-dec) and FIRST/LAST (F1, F1u, W2)
# ---------------------------------------------------------------------------------

# the money columns of the TPC-H schema that gen_db_arrays draws with two
# decimals (DECIMAL(12, 2) in the TPC-H schema)
MONEY_COLUMNS = {"lineitem": ("l_quantity", "l_extendedprice", "l_discount",
                              "l_tax"),
                 "orders": ("o_totalprice",), "customer": ("c_acctbal",)}
F1U_CUTOFF = datetime.date(1998, 8, 1)


def _functions(functions):
    if functions is None:
        from ..sql import functions
    return functions


def _cents(x: np.ndarray, scale: int = 2) -> np.ndarray:
    return np.round(x * 10 ** scale).astype(np.int64)


def decimal_columns(table: Dict[str, np.ndarray], names, precision: int = 12,
                    scale: int = 2) -> Dict[str, object]:
    """A copy of ``table`` whose ``names`` columns are DECIMAL(precision,
    scale) ``DecimalArray``s of ``round(x * 10^scale)``: exact for the
    gen_db money columns, which are drawn with two decimals."""
    from ..batch import DecimalArray
    out = dict(table)
    for n in names:
        out[n] = DecimalArray(_cents(table[n], scale), precision, scale)
    return out


def q1_dec(df, functions=None, delta_days: int = 90):
    """TPC-H Q1 over DECIMAL(12, 2) money columns, with decimal literals:
    four wide sums (DECIMAL(22, 2), (22, 2), (28, 4), (28, 6)) and three
    decimal averages (doubles, as the reference computes them)."""
    F = _functions(functions)
    one = F.lit(decimal.Decimal("1"))
    cutoff = datetime.date(1998, 12, 1) - datetime.timedelta(days=delta_days)
    disc_price = F.col("l_extendedprice") * (one - F.col("l_discount"))
    charge = disc_price * (one + F.col("l_tax"))
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


def q6_dec(df, functions=None):
    """TPC-H Q6 over DECIMAL(12, 2) columns and decimal literals: the
    ungrouped sum of a DECIMAL(18, 4) product, a DECIMAL(28, 4)."""
    F = _functions(functions)
    lo, hi = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
    return (df.where((F.col("l_shipdate") >= lo) & (F.col("l_shipdate") < hi)
                     & (F.col("l_discount") >= decimal.Decimal("0.05"))
                     & (F.col("l_discount") <= decimal.Decimal("0.07"))
                     & (F.col("l_quantity") < decimal.Decimal("24")))
              .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
                   .alias("revenue")))


def q18_dec(orders, lineitem, customer, functions=None):
    """TPC-H Q18 as :func:`q18` writes it, over DECIMAL(12, 2) quantities
    and prices: the HAVING compares a DECIMAL(22, 2) sum with 300."""
    F = _functions(functions)
    big = (lineitem.group_by("l_orderkey")
           .agg(F.sum(F.col("l_quantity")).alias("qty"))
           .filter(F.col("qty") > 300))
    return (orders
            .join(big, on=[("o_orderkey", "l_orderkey")], how="semi")
            .join(customer, on=[("o_custkey", "c_custkey")])
            .select("c_name", "o_orderkey", "o_totalprice")
            .sort(F.col("o_totalprice").desc(), F.col("o_orderkey"))
            .limit(100))


def _first_last_aggs(F, date, price, key, marked, dated):
    return (F.first(F.col(date)).alias("first_date"),
            F.last(F.col(price)).alias("last_price"),
            F.last(F.col(key)).alias("last_key"),
            F.first(F.col(marked), ignore_nulls=True).alias("first_marked"),
            F.last(F.col(dated), ignore_nulls=True).alias("last_dated"),
            F.count_star().alias("n"))


def f1(orders, functions=None):
    """F1: FIRST/LAST per customer over orders in input order: the first
    order date, the last (decimal) total price and order key, the first
    urgent order's key and the last filled order's date (nulls ignored),
    and the count.  The nullable inputs come from a stage below the
    aggregate, so no aggregate argument holds a string predicate."""
    F = _functions(functions)
    staged = orders.select(
        "o_custkey", "o_orderkey", "o_orderdate", "o_totalprice",
        F.when(F.col("o_orderpriority") == "1-URGENT", F.col("o_orderkey"))
        .alias("urgent_key"),
        F.when(F.col("o_orderstatus") == "F", F.col("o_orderdate"))
        .alias("filled_date"))
    return staged.group_by("o_custkey").agg(*_first_last_aggs(
        F, "o_orderdate", "o_totalprice", "o_orderkey", "urgent_key",
        "filled_date"))


def f1u(lineitem, functions=None, cutoff: datetime.date = F1U_CUTOFF):
    """F1u: F1's FIRST/LAST shapes ungrouped, over the lineitems shipped
    from ``cutoff`` on: first ship date, last (decimal) price and order
    key, the first returned line's order key and the last finished line's
    ship date (nulls ignored), and the count."""
    F = _functions(functions)
    staged = lineitem.where(F.col("l_shipdate") >= cutoff).select(
        "l_orderkey", "l_shipdate", "l_extendedprice",
        F.when(F.col("l_returnflag") == "R", F.col("l_orderkey"))
        .alias("returned_key"),
        F.when(F.col("l_linestatus") == "F", F.col("l_shipdate"))
        .alias("finished_date"))
    return staged.agg(*_first_last_aggs(
        F, "l_shipdate", "l_extendedprice", "l_orderkey", "returned_key",
        "finished_date"))


def w2(lineitem, cutoff: datetime.date = HISTORY_CUTOFF, functions=None,
       window=None):
    """W2: W1's two window specs and cutoff (:func:`supplier_history`)
    with windowed FIRST/LAST: the price 6 rows back and 6 ahead (frame
    edges), the supplier's first returned price so far and the last
    returned quantity within 30 days (nulls ignored), and the supplier's
    first and last price."""
    F = _functions(functions)
    if window is None:
        from ..sql.window import Window as window
    Window = window
    wa = Window.partition_by("l_suppkey").order_by(
        "l_shipdate", "l_orderkey", "l_partkey")
    wb = Window.partition_by("l_suppkey").order_by("l_shipdate")
    base = ("l_suppkey", "l_orderkey", "l_partkey", "l_shipdate",
            "l_extendedprice", "l_quantity")
    returned = F.col("l_returnflag") == "R"
    staged = lineitem.select(
        *base, F.when(returned, F.col("l_extendedprice"))
        .alias("returned_price"),
        F.when(returned, F.col("l_quantity")).alias("returned_qty"))
    price = F.col("l_extendedprice")
    whole = wa.rows_between(Window.unboundedPreceding,
                            Window.unboundedFollowing)
    return (staged.select(
        *base,
        F.first(price).over(wa.rows_between(-6, 0)).alias("price_back6"),
        F.last(price).over(wa.rows_between(0, 6)).alias("price_ahead6"),
        F.first(F.col("returned_price"), ignore_nulls=True)
        .over(wa.rows_between(Window.unboundedPreceding, 0))
        .alias("first_returned"),
        F.last(F.col("returned_qty"), ignore_nulls=True)
        .over(wb.range_between(-30, 0)).alias("last_returned_30d"),
        F.first(price).over(whole).alias("supp_first"),
        F.last(price).over(whole).alias("supp_last"))
        .where(F.col("l_shipdate") >= cutoff))


# -- oracles in exact integers ---------------------------------------------------

def _exact_sum(x: np.ndarray) -> int:
    """The exact sum of int64 values (32-bit halves summed apart)."""
    x = x.astype(np.int64)
    return (int((x >> 32).sum()) << 32) + int((x & 0xFFFFFFFF).sum())


def _dec(unscaled: int, scale: int) -> decimal.Decimal:
    return decimal.Decimal(int(unscaled)).scaleb(-scale)


def q1_dec_numpy(data: Dict[str, np.ndarray], delta_days: int = 90
                 ) -> List[tuple]:
    """:func:`q1_dec` over the float gen_db arrays, in exact integers:
    rows in (returnflag, linestatus) order, sums as ``Decimal``, averages
    as the exact quotient in float64."""
    cutoff = np.datetime64(datetime.date(1998, 12, 1)
                           - datetime.timedelta(days=delta_days))
    m = data["l_shipdate"] <= cutoff
    flag, status = data["l_returnflag"][m], data["l_linestatus"][m]
    qty, price = _cents(data["l_quantity"][m]), \
        _cents(data["l_extendedprice"][m])
    disc, tax = _cents(data["l_discount"][m]), _cents(data["l_tax"][m])
    disc_price = price * (100 - disc)                  # scale 4
    charge = disc_price * (100 + tax)                  # scale 6
    rows = []
    for f in np.unique(flag):
        for st in np.unique(status):
            g = (flag == f) & (status == st)
            cnt = int(g.sum())
            if not cnt:
                continue
            sq, sp = _exact_sum(qty[g]), _exact_sum(price[g])
            rows.append((str(f), str(st), _dec(sq, 2), _dec(sp, 2),
                         _dec(_exact_sum(disc_price[g]), 4),
                         _dec(_exact_sum(charge[g]), 6),
                         sq / 100 / cnt, sp / 100 / cnt,
                         _exact_sum(disc[g]) / 100 / cnt, cnt))
    return rows


def q6_dec_numpy(data: Dict[str, np.ndarray]):
    """:func:`q6_dec` in exact integers: the revenue as a ``Decimal`` with
    scale 4, None when no row qualifies."""
    ship = data["l_shipdate"]
    disc = _cents(data["l_discount"])
    m = ((ship >= np.datetime64("1994-01-01"))
         & (ship < np.datetime64("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (_cents(data["l_quantity"]) < 2400))
    if not m.any():
        return None
    return _dec(_exact_sum(_cents(data["l_extendedprice"][m]) * disc[m]), 4)


def q18_dec_numpy(orders, lineitem, customer, k: int = 100) -> List[tuple]:
    """:func:`q18_dec` in exact integers: (c_name, o_orderkey,
    o_totalprice as a ``Decimal``)."""
    okey = orders["o_orderkey"]
    if not (np.array_equal(okey, np.arange(1, len(okey) + 1))
            and np.array_equal(customer["c_custkey"],
                               np.arange(1, len(customer["c_custkey"]) + 1))):
        raise ValueError("q18_dec_numpy needs o_orderkey and c_custkey = "
                         "1..n")
    # integral weights summed in float64: exact below 2^53
    qty = np.bincount(lineitem["l_orderkey"],
                      weights=_cents(lineitem["l_quantity"]),
                      minlength=len(okey) + 1).astype(np.int64)
    rows = np.flatnonzero(qty[okey] > 30000)
    price = _cents(orders["o_totalprice"][rows])
    top = rows[np.lexsort((okey[rows], -price))][:k]
    names = customer["c_name"][orders["o_custkey"][top] - 1]
    return [(str(n), int(okey[r]), _dec(_cents(orders["o_totalprice"][r]), 2))
            for n, r in zip(names, top)]


def _first_last_numpy(key, date, price_cents, rkey, marked, dated):
    """Per group of ``key`` (all rows one group when ``key`` is None), in
    row order: (first date, last price cents, last rkey, first rkey where
    ``marked``, last date where ``dated``, count); None for a group with
    no marked (dated) row.  Dates as int32 days."""
    n = len(date)
    if key is None:
        key = np.zeros(n, dtype=np.int64)
    keys, first = np.unique(key, return_index=True)
    last = n - 1 - np.unique(key[::-1], return_index=True)[1]
    count = np.bincount(np.searchsorted(keys, key), minlength=len(keys))

    def pick(mask, take_last):
        at = np.flatnonzero(mask)
        g = np.searchsorted(keys, key[at])
        out = np.full(len(keys), -1, dtype=np.int64)
        if take_last:
            out[g] = at          # later rows overwrite earlier ones
        else:
            out[g[::-1]] = at[::-1]
        return out

    fm, ld = pick(marked, False), pick(dated, True)
    return keys, {"first_date": (date[first], None),
                  "last_price": (price_cents[last], None),
                  "last_key": (rkey[last], None),
                  "first_marked": (np.where(fm >= 0, rkey[fm], 0), fm >= 0),
                  "last_dated": (np.where(ld >= 0, date[ld], 0), ld >= 0),
                  "n": (count, None)}


def _days(x: np.ndarray) -> np.ndarray:
    return x.astype("datetime64[D]").astype(np.int64).astype(np.int32)


def f1_numpy(orders: Dict[str, np.ndarray]) -> Dict[str, tuple]:
    """:func:`f1`: ``{column: (data, valid)}`` in o_custkey order; the
    price as unscaled DECIMAL(12, 2) cents, dates as int32 days."""
    keys, cols = _first_last_numpy(
        orders["o_custkey"], _days(orders["o_orderdate"]),
        _cents(orders["o_totalprice"]), orders["o_orderkey"],
        orders["o_orderpriority"] == "1-URGENT",
        orders["o_orderstatus"] == "F")
    return {"o_custkey": (keys, None), **cols}


def f1u_numpy(lineitem: Dict[str, np.ndarray],
              cutoff: datetime.date = F1U_CUTOFF) -> List[tuple]:
    """:func:`f1u`'s one row, dates as ``datetime.date`` and the price as
    a ``Decimal``, as ``collect()`` returns them."""
    m = lineitem["l_shipdate"] >= np.datetime64(cutoff)
    if not m.any():
        return [(None, None, None, None, None, 0)]
    _, cols = _first_last_numpy(
        None, _days(lineitem["l_shipdate"][m]),
        _cents(lineitem["l_extendedprice"][m]), lineitem["l_orderkey"][m],
        lineitem["l_returnflag"][m] == "R",
        lineitem["l_linestatus"][m] == "F")

    def day(d, ok=True):
        return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d))
                if ok else None)
    fm, fm_ok = cols["first_marked"]
    ld, ld_ok = cols["last_dated"]
    return [(day(cols["first_date"][0][0]), _dec(cols["last_price"][0][0], 2),
             int(cols["last_key"][0][0]),
             int(fm[0]) if fm_ok[0] else None, day(ld[0], ld_ok[0]),
             int(cols["n"][0][0]))]


def w2_numpy(lineitem: Dict[str, np.ndarray],
             cutoff: datetime.date = HISTORY_CUTOFF) -> Dict[str, tuple]:
    """:func:`w2` in numpy: ``{column: (data, valid)}`` in the output's
    order (by supplier, ship date, order key, part key, ties in input
    order, as :func:`supplier_history_numpy` orders them)."""
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
    ret = lineitem["l_returnflag"][order] == "R"
    n = len(order)
    idx = np.arange(n)
    start = np.ones(n, dtype=bool)
    start[1:] = supp[1:] != supp[:-1]
    pid = np.cumsum(start) - 1
    first = np.flatnonzero(start)
    last = np.append(first[1:], n) - 1
    lo = first[pid]
    hi = last[pid]
    # next returned row at or after each row, previous at or before
    nxt = np.minimum.accumulate(np.where(ret, idx, n)[::-1])[::-1]
    prv = np.maximum.accumulate(np.where(ret, idx, -1))
    first_ret = nxt[lo]
    comp = supp * (1 << 24) + date
    lo30 = np.searchsorted(comp, comp - 30, side="left")
    hi30 = np.searchsorted(comp, comp, side="right") - 1
    last_ret = prv[hi30]
    ok_first = first_ret <= idx
    ok_last = last_ret >= lo30
    cut = (np.datetime64(cutoff, "D") - np.datetime64("1970-01-01", "D")
           ).astype(np.int64)
    k = date >= cut
    cols = {"l_suppkey": (supp, None), "l_orderkey": (okey, None),
            "l_partkey": (pkey, None),
            "l_shipdate": (date.astype(np.int32), None),
            "l_extendedprice": (price, None), "l_quantity": (qty, None),
            "price_back6": (price[np.maximum(idx - 6, lo)], None),
            "price_ahead6": (price[np.minimum(idx + 6, hi)], None),
            "first_returned": (np.where(ok_first, price[np.minimum(
                first_ret, n - 1)], 0.0), ok_first),
            "last_returned_30d": (np.where(ok_last, qty[np.maximum(
                last_ret, 0)], 0.0), ok_last),
            "supp_first": (price[lo], None), "supp_last": (price[hi], None)}
    return {c: (a[k], None if v is None else v[k])
            for c, (a, v) in cols.items()}


# ---------------------------------------------------------------------------------
# Slice 8: the sample, explodes of lists, subqueries
# ---------------------------------------------------------------------------------

Q1_SAMPLE_FRACTION = 0.01
Q1_SAMPLE_SEED = 20240101
X1_YEAR = (datetime.date(1995, 1, 1), datetime.date(1996, 1, 1))


def q1_sample(df, fraction: float = Q1_SAMPLE_FRACTION,
              seed: int = Q1_SAMPLE_SEED, functions=None):
    """TPC-H Q1 over a Bernoulli sample of lineitem."""
    return q1(df.sample(fraction, seed=seed), functions=functions)


def sample_keep(n_rows: int, batch_rows: int,
                fraction: float = Q1_SAMPLE_FRACTION,
                seed: int = Q1_SAMPLE_SEED) -> np.ndarray:
    """Bool [n_rows]: the rows a sample over a scan of ``batch_rows``-row
    batches keeps, from the plain version of the sample kernel (the
    reference's draw, bit for bit)."""
    from ..ops import sample
    parts = [np.zeros(0, dtype=bool)]
    for idx, off in enumerate(range(0, n_rows, batch_rows)):
        m = min(batch_rows, n_rows - off)
        parts.append(sample.sample_mask_plain(
            sample.batch_key(seed, idx), fraction, None, m, m,
            "cpu").numpy())
    return np.concatenate(parts)


def q1_sample_numpy(data: Dict[str, np.ndarray], keep: np.ndarray
                    ) -> List[tuple]:
    """Q1 over the rows ``keep`` marks."""
    cols = ("l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
            "l_extendedprice", "l_discount", "l_tax")
    return q1_numpy({c: data[c][keep] for c in cols})


def order_quantities(orders: Dict[str, np.ndarray],
                     lineitem: Dict[str, np.ndarray], null_frac: float = 0.0,
                     empty_frac: float = 0.0, seed: int = 20240102,
                     order: Optional[np.ndarray] = None):
    """A ``ListArray`` with one list per order: the ``l_quantity`` of the
    order's lineitems, in lineitem order (``o_orderkey`` is 1..n).  A
    seeded ``null_frac`` of the lists is set null and an ``empty_frac``
    emptied.  ``order`` is the stable sort permutation of ``l_orderkey``
    when the caller has it."""
    from ..batch import ListArray
    okey = orders["o_orderkey"]
    n = len(okey)
    if not np.array_equal(okey, np.arange(1, n + 1)):
        raise ValueError("order_quantities needs o_orderkey = 1..n")
    lk = lineitem["l_orderkey"]
    if order is None:
        order = np.argsort(lk, kind="stable")
    values = lineitem["l_quantity"][order]
    lens = np.bincount(lk, minlength=n + 1)[1:].astype(np.int64)
    valid = None
    if null_frac or empty_frac:
        r = np.random.default_rng(seed).random(n)
        null = r < null_frac
        gone = r < null_frac + empty_frac
        values = values[np.repeat(~gone, lens)]
        lens = np.where(gone, 0, lens)
        valid = ~null
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return ListArray(offsets, values, valid=valid)


def x1(orders, functions=None):
    """X1: one year of orders, exploded to their lineitem quantities, then
    per order priority the quantity's sum, count and average."""
    F = _functions(functions)
    lo, hi = X1_YEAR
    return (orders.filter((F.col("o_orderdate") >= lo)
                          & (F.col("o_orderdate") < hi))
            .explode("o_qty", out_name="qty")
            .group_by("o_orderpriority")
            .agg(F.sum(F.col("qty")).alias("sum_qty"),
                 F.count_star().alias("n"),
                 F.avg(F.col("qty")).alias("avg_qty"))
            .sort("o_orderpriority"))


def x1_numpy(orders: Dict[str, np.ndarray], lineitem: Dict[str, np.ndarray]
             ) -> List[tuple]:
    """X1 as lineitem joined to its orders (``o_orderkey`` is 1..n)."""
    lo, hi = (np.datetime64(d) for d in X1_YEAR)
    date = orders["o_orderdate"]
    prio = np.array(sorted(PRIORITIES))
    code = np.searchsorted(prio, orders["o_orderpriority"])
    o = lineitem["l_orderkey"] - 1
    keep = (date[o] >= lo) & (date[o] < hi)
    g = code[o[keep]]
    qty = lineitem["l_quantity"][keep]
    cnt = np.bincount(g, minlength=len(prio))
    tot = np.bincount(g, weights=qty, minlength=len(prio))
    return [(str(p), float(t), int(c), float(t) / int(c))
            for p, t, c in zip(prio, tot, cnt) if c]


def x1o(orders):
    """X1o: every order's quantities, exploded with OUTER."""
    return orders.select("o_orderkey", "o_qty").explode(
        "o_qty", out_name="qty", outer=True)


def x1o_numpy(orders: Dict[str, np.ndarray], lists) -> Dict[str, tuple]:
    """X1o's columns in parent order: ``{"o_orderkey": (keys, None),
    "qty": (values with 0 at nulls, validity)}``."""
    lens = np.diff(lists.offsets)
    out_lens = np.maximum(lens, 1)
    keys = np.repeat(orders["o_orderkey"], out_lens)
    starts = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(out_lens, out=starts[1:])
    has = np.repeat(lens > 0, out_lens)
    qty = np.zeros(int(starts[-1]), dtype=lists.values.dtype)
    qty[has] = lists.values[lists.offsets[0]:lists.offsets[-1]]
    valid = has.copy()
    if lists.elem_valid is not None:
        valid[has] = lists.elem_valid
    return {"o_orderkey": (keys, None), "qty": (qty, valid)}


def q18_in(orders, lineitem, customer, functions=None):
    """Q18 with its orders picked by ``IN (subquery)``."""
    F = _functions(functions)
    big = (lineitem.group_by("l_orderkey")
           .agg(F.sum(F.col("l_quantity")).alias("qty"))
           .filter(F.col("qty") > 300).select("l_orderkey"))
    return (orders.filter(F.col("o_orderkey").isin_subquery(big))
            .join(customer, on=[("o_custkey", "c_custkey")])
            .select("c_name", "o_orderkey", "o_totalprice")
            .sort(F.col("o_totalprice").desc(), F.col("o_orderkey"))
            .limit(100))


def q16_notin(partsupp, supplier, part, functions=None):
    """Q16 with the complaining suppliers dropped by ``NOT IN
    (subquery)``."""
    F = _functions(functions)
    bad = supplier.filter(F.col("s_acctbal") < 0).select("s_suppkey")
    return (partsupp
            .filter(~F.col("ps_suppkey").isin_subquery(bad))
            .join(part.filter((F.col("p_brand") != "Brand#45")
                              & (F.col("p_size").isin(1, 4, 7, 10, 14, 23))),
                  on=[("ps_partkey", "p_partkey")])
            .select("p_brand", "p_type", "p_size", "ps_suppkey").distinct()
            .group_by("p_brand", "p_type", "p_size")
            .agg(F.count_star().alias("supplier_cnt"))
            .sort(F.col("supplier_cnt").desc(), "p_brand", "p_type",
                  "p_size"))


def q22_scalar(customer, orders, functions=None):
    """Q22 with the average balance as a scalar subquery."""
    F = _functions(functions)
    cust = customer.with_column(
        "cntrycode", F.substring(F.col("c_phone"), 1, 2))
    in_codes = cust.filter(F.col("cntrycode").isin(*Q22_CODES))
    avg_bal = F.scalar_subquery(in_codes.filter(F.col("c_acctbal") > 0.0)
                                .agg(F.avg(F.col("c_acctbal")).alias("a")))
    return (in_codes.filter(F.col("c_acctbal") > avg_bal)
            .join(orders, on=[("c_custkey", "o_custkey")], how="anti")
            .group_by("cntrycode")
            .agg(F.count_star().alias("numcust"),
                 F.sum(F.col("c_acctbal")).alias("totacctbal"))
            .sort("cntrycode"))
