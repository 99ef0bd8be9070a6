"""TPC-DS data, the 22 queries ``bench.py`` runs, and numpy oracles.

Counterpart of ``spark_rapids_tpu/models/tpcds.py`` (the star schema's
``gen_db`` :29 and the starter queries q3, q42, q52, q55, q7 :435-590) and
``spark_rapids_tpu/models/tpcds_q2.py`` (q12, q13, q19, q20, q25, q26, q34,
q46, q48, q64, q65, q68, q73, q79, q94, q95, q98 :33-900).

:func:`gen_db_arrays` draws the reference's sixteen tables as dicts of
numpy arrays: the same ``default_rng`` seeds (2001 item, 2002 promotion,
2003 and 2007 store sales and returns, 2004 store, 2005 customer_address,
2006 customer, 2008 the catalog channel, 2009 the web channel), the same
draws in the same order and the same 1,000,000-row chunks, so every value
equals what the reference writes to parquet.  A foreign key the reference
nulls (``_null_some`` :408) comes back as a ``np.ma.MaskedArray``, masked
where it is null; dates as ``datetime64[D]``, strings as numpy unicode.
:func:`gen_db` writes them with the port's parquet writer
(``io/writers.py``), in the reference's row groups (one per chunk for the
fact tables and their returns), cached by path.

The query bodies ``run_q*(dfs)`` are the reference's plans over
``{table: DataFrame}``, collected, with its two ``.cache()`` calls (ds_q94
and ds_q95's ``_multi_wh_orders``, ds_q64's ``_q64_cs_ui``) and its
``.count()``.  The oracles ``numpy_q*(tables)`` are plain numpy over the
arrays, independent of both engines (the reference's are pandas, which
the card's machine does not have): joins to the dense surrogate keys by
direct addressing, other equi-joins by a sort and ``searchsorted``, groups
by ``np.unique``, money sums exact in integer cents.  :data:`QUERIES` maps
each name to (body, oracle) and :data:`TABLES` to its tables, with the
reference's shape; :func:`rows_rel_err` is ``tpch_suite.py:947``'s
comparison.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

import numpy as np

__all__ = ["DB_TABLES", "db_rows", "gen_db_arrays", "gen_db", "load_db",
           "QUERIES", "TABLES", "run_query", "query_oracle",
           "rows_rel_err", "CACHED_QUERIES", "ORDER_BY", "in_query_order"]

# SF1 row counts (TPC-DS spec shapes, approximately; reference :21-26)
_STORE_SALES_PER_SF = 2_880_404
_CATALOG_SALES_PER_SF = 1_441_548
_WEB_SALES_PER_SF = 719_384
_ITEM_PER_SF = 18_000
_D_START = datetime.date(1998, 1, 1)
_N_DATES = 6 * 365 + 2  # 1998-01-01 .. 2003-12-31
_SK0 = 2_450_815        # d_date_sk of 1998-01-01

# the reference's file order (:37-41)
DB_TABLES = ("date_dim", "item", "customer_demographics", "promotion",
             "store_sales", "store", "customer", "customer_address",
             "household_demographics", "income_band", "store_returns",
             "catalog_sales", "catalog_returns", "web_sales", "web_returns",
             "web_site")
# a fact table and its returns come from one stream of draws
_GROUP = {"store_returns": "store_sales", "catalog_returns": "catalog_sales",
          "web_returns": "web_sales"}
_CHUNKED = ("store_sales", "store_returns", "catalog_sales",
            "catalog_returns", "web_sales", "web_returns")

_CATS = ["Books", "Electronics", "Home", "Jewelry", "Men", "Music", "Shoes",
         "Sports", "Children", "Women"]
_CLASSES = ["accessories", "athletic", "birdal", "classical", "computers",
            "country", "dresses", "earings", "fiction", "fishing"]
_COLORS = ["papaya", "peach", "firebrick", "sienna", "slate", "chartreuse",
           "orchid", "salmon", "plum", "maroon", "azure", "gainsboro",
           "powder", "metallic"]
_GENDERS = ["M", "F"]
_MARITAL = ["M", "S", "D", "W", "U"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]
_COUNTIES = ["Williamson County", "Ziebach County", "Walker County",
             "Daviess County", "Barrow County", "Fairfield County"]
_CITIES = ["Midway", "Fairview", "Cedar Grove", "Five Points", "Oak Grove",
           "Pleasant Hill", "Centerville", "Liberty", "Salem", "Union"]
_STATES = ["TN", "SD", "AL", "IN", "GA", "OH", "TX", "IL", "KY", "NM", "MI",
           "VA"]
_STORE_NAMES = ["ought", "able", "ation", "eing", "ese", "anti", "cally",
                "bar"]
_POTS = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
         "Unknown"]
_FIRSTS = ["James", "Mary", "John", "Linda", "Robert", "Barbara", "Michael",
           "Susan", "William", "Lisa"]
_LASTS = ["Smith", "Johnson", "Brown", "Jones", "Davis", "Miller", "Wilson",
          "Moore", "Taylor", "Thomas"]


def _sizes(sf: float) -> Dict[str, int]:
    """Row counts of the tables whose size follows ``sf``, and of the
    fixed ones the others reference (reference :65-312)."""
    return {"item": max(8, int(_ITEM_PER_SF * sf)),
            "customer_demographics": max(
                len(_GENDERS) * len(_MARITAL) * len(_EDUCATION),
                int(19_208 * max(sf, 0.01))),
            "promotion": max(4, int(300 * max(sf, 0.05))),
            "store": max(2, int(12 * max(sf, 0.1))),
            "customer_address": max(32, int(50_000 * sf)),
            "household_demographics": 20 * 6 * 10 * 5,
            "customer": max(64, int(100_000 * sf)),
            "store_sales": max(64, int(_STORE_SALES_PER_SF * sf)),
            "catalog_sales": max(64, int(_CATALOG_SALES_PER_SF * sf)),
            "web_sales": max(64, int(_WEB_SALES_PER_SF * sf))}


def db_rows(table: str, sf: float) -> Optional[int]:
    """Rows of ``table`` at ``sf`` (None for a returns table: its size is
    drawn)."""
    fixed = {"date_dim": _N_DATES, "income_band": 20, "web_site": 30}
    if table in fixed:
        return fixed[table]
    return _sizes(sf).get(table)


def _null_some(rng, arr: np.ndarray, frac: float = 0.04):
    """``arr`` with a draw of ``frac`` of its rows null (reference :408):
    a masked array, or ``arr`` itself when no row drew null."""
    mask = rng.random(len(arr)) < frac
    return np.ma.MaskedArray(arr, mask=mask) if mask.any() else arr


def _ids(n: int) -> np.ndarray:
    """``AAAAAAAA00000001`` .. for rows 1..n."""
    return np.char.add("AAAAAAAA", np.char.zfill(
        np.arange(1, n + 1).astype(str), 8))


def _zips(values: np.ndarray) -> np.ndarray:
    return np.char.zfill(values.astype(str), 5)


def _concat(parts: List[np.ndarray]):
    if len(parts) == 1:
        return parts[0]
    if any(isinstance(p, np.ma.MaskedArray) for p in parts):
        return np.ma.concatenate(parts)
    return np.concatenate(parts)


def _date_dim() -> Dict[str, np.ndarray]:
    days = np.arange(_N_DATES)
    dates = np.datetime64(_D_START) + days.astype("timedelta64[D]")
    y = dates.astype("datetime64[Y]")
    m = dates.astype("datetime64[M]")
    years = y.astype(np.int64) + 1970
    moys = (m - y).astype(np.int64) + 1
    return {"d_date_sk": (_SK0 + days).astype(np.int64),
            "d_date": dates,
            "d_year": years,
            "d_moy": moys,
            "d_dom": (dates - m).astype(np.int64) + 1,
            "d_month_seq": (years - 1998) * 12 + (moys - 1) + 1176,
            # dow 0 = Sunday; 1970-01-01 was a Thursday
            "d_dow": (dates.astype(np.int64) + 4) % 7,
            "d_qoy": (moys - 1) // 3 + 1}


def _dims(table: str, n: Dict[str, int]) -> Dict[str, np.ndarray]:
    """One dimension table, drawn as the reference draws it."""
    if table == "date_dim":
        return _date_dim()
    if table == "item":
        k = n["item"]
        rng = np.random.default_rng(2001)
        cat_id = rng.integers(1, 11, k).astype(np.int64)
        brand_id = rng.integers(1001001, 10016017, k).astype(np.int64)
        class_id = rng.integers(1, 11, k).astype(np.int64)
        out = {"i_item_sk": np.arange(1, k + 1, dtype=np.int64),
               "i_item_id": _ids(k),
               "i_brand_id": brand_id,
               "i_brand": np.char.add("brand#", (brand_id % 997).astype(str)),
               "i_category_id": cat_id,
               "i_category": np.array(_CATS)[cat_id - 1],
               "i_class_id": class_id,
               "i_class": np.array(_CLASSES)[class_id - 1]}
        out["i_color"] = np.array(_COLORS)[rng.integers(0, len(_COLORS), k)]
        out["i_product_name"] = np.char.add(
            "product#", np.arange(1, k + 1).astype(str))
        out["i_manufact_id"] = rng.integers(1, 1001, k).astype(np.int64)
        out["i_manager_id"] = rng.integers(1, 101, k).astype(np.int64)
        out["i_current_price"] = np.round(rng.uniform(0.1, 300.0, k), 2)
        return out
    if table == "customer_demographics":
        idx = np.arange(n["customer_demographics"])
        return {"cd_demo_sk": (idx + 1).astype(np.int64),
                "cd_gender": np.array(_GENDERS)[idx % 2],
                "cd_marital_status": np.array(_MARITAL)[(idx // 2) % 5],
                "cd_education_status": np.array(_EDUCATION)[(idx // 10) % 7]}
    if table == "promotion":
        k = n["promotion"]
        rng = np.random.default_rng(2002)
        yn = np.array(["Y", "N"])
        out = {"p_promo_sk": np.arange(1, k + 1, dtype=np.int64)}
        out["p_channel_email"] = rng.choice(yn, k, p=[0.1, 0.9])
        out["p_channel_event"] = rng.choice(yn, k, p=[0.1, 0.9])
        return out
    if table == "store":
        k = n["store"]
        rng = np.random.default_rng(2004)
        st_city = rng.integers(0, len(_CITIES), k)
        out = {"s_store_sk": np.arange(1, k + 1, dtype=np.int64),
               "s_store_id": _ids(k)}
        out["s_store_name"] = np.array(_STORE_NAMES)[rng.integers(0, 8, k)]
        out["s_city"] = np.array(_CITIES)[st_city]
        out["s_county"] = np.array(_COUNTIES)[
            rng.integers(0, len(_COUNTIES), k)]
        out["s_state"] = np.array(_STATES)[rng.integers(0, len(_STATES), k)]
        out["s_zip"] = _zips(rng.integers(10000, 99999, k))
        out["s_number_employees"] = rng.integers(200, 300, k).astype(
            np.int64)
        out["s_gmt_offset"] = np.full(k, -5.0)
        return out
    if table == "customer_address":
        k = n["customer_address"]
        rng = np.random.default_rng(2005)
        out = {"ca_address_sk": np.arange(1, k + 1, dtype=np.int64)}
        out["ca_city"] = np.array(_CITIES)[rng.integers(0, len(_CITIES), k)]
        out["ca_county"] = np.array(_COUNTIES)[
            rng.integers(0, len(_COUNTIES), k)]
        out["ca_state"] = np.array(_STATES)[rng.integers(0, len(_STATES), k)]
        out["ca_zip"] = _zips(rng.integers(10000, 99999, k))
        out["ca_country"] = np.array(["United States"]).repeat(k)
        out["ca_gmt_offset"] = rng.choice(np.array([-5.0, -6.0, -7.0]), k)
        return out
    if table == "income_band":
        low = np.arange(20, dtype=np.int64) * 10_000
        return {"ib_income_band_sk": np.arange(1, 21, dtype=np.int64),
                "ib_lower_bound": low + 1, "ib_upper_bound": low + 10_000}
    if table == "household_demographics":
        hidx = np.arange(n["household_demographics"])
        return {"hd_demo_sk": (hidx + 1).astype(np.int64),
                "hd_income_band_sk": (hidx % 20 + 1).astype(np.int64),
                "hd_buy_potential": np.array(_POTS)[(hidx // 20) % 6],
                "hd_dep_count": ((hidx // 120) % 10).astype(np.int64),
                "hd_vehicle_count": ((hidx // 1200) % 5).astype(np.int64)}
    if table == "customer":
        k = n["customer"]
        rng = np.random.default_rng(2006)
        first_sale = _SK0 + rng.integers(0, _N_DATES, k)
        out = {"c_customer_sk": np.arange(1, k + 1, dtype=np.int64),
               "c_customer_id": _ids(k)}
        out["c_current_cdemo_sk"] = _null_some(rng, rng.integers(
            1, n["customer_demographics"] + 1, k).astype(np.int64))
        out["c_current_hdemo_sk"] = _null_some(rng, rng.integers(
            1, n["household_demographics"] + 1, k).astype(np.int64))
        out["c_current_addr_sk"] = rng.integers(
            1, n["customer_address"] + 1, k).astype(np.int64)
        out["c_first_name"] = np.array(_FIRSTS)[
            rng.integers(0, len(_FIRSTS), k)]
        out["c_last_name"] = np.array(_LASTS)[rng.integers(0, len(_LASTS), k)]
        out["c_preferred_cust_flag"] = rng.choice(np.array(["Y", "N"]), k)
        out["c_birth_country"] = rng.choice(
            np.array(["UNITED STATES", "CANADA", "MEXICO"]), k)
        out["c_first_sales_date_sk"] = _null_some(
            rng, first_sale.astype(np.int64))
        out["c_first_shipto_date_sk"] = _null_some(
            rng, (first_sale + 30).astype(np.int64))
        return out
    if table == "web_site":
        return {"web_site_sk": np.arange(1, 31, dtype=np.int64),
                "web_site_id": _ids(30),
                "web_company_name": np.array(
                    ["pri", "able", "ought", "ese", "anti", "cally"])[
                    np.arange(30) % 6]}
    raise ValueError(f"gen_db_arrays does not generate {table!r}")


def _store_channel(n, chunk, keep):
    """store_sales and store_returns, chunk by chunk (reference :231-305):
    {table: {column: [chunk arrays]}}."""
    rng = np.random.default_rng(2003)
    sr_rng = np.random.default_rng(2007)
    ss, sr = {}, {}
    n_ss = n["store_sales"]
    for off in range(0, n_ss, chunk):
        m = min(chunk, n_ss - off)
        qty = rng.integers(1, 101, m).astype(np.int64)
        list_price = np.round(rng.uniform(1.0, 200.0, m), 2)
        sales_price = np.round(list_price * rng.uniform(0.2, 1.0, m), 2)
        wholesale = np.round(list_price * rng.uniform(0.1, 0.6, m), 2)
        item_sk = rng.integers(1, n["item"] + 1, m).astype(np.int64)
        cust_sk = rng.integers(1, n["customer"] + 1, m).astype(np.int64)
        ticket = (off + np.arange(m) + 1).astype(np.int64)
        sold_sk = (_SK0 + rng.integers(0, _N_DATES, m)).astype(np.int64)
        ext_sales = np.round(sales_price * qty, 2)
        ext_wholesale = np.round(wholesale * qty, 2)
        cols = {"ss_sold_date_sk": lambda: _null_some(rng, sold_sk),
                "ss_sold_time_sk": lambda: rng.integers(
                    0, 86400, m).astype(np.int64),
                "ss_item_sk": lambda: item_sk,
                "ss_customer_sk": lambda: _null_some(rng, cust_sk, 0.02)}
        for name, fk in (("ss_cdemo_sk", "customer_demographics"),
                         ("ss_hdemo_sk", "household_demographics"),
                         ("ss_addr_sk", "customer_address"),
                         ("ss_store_sk", "store"),
                         ("ss_promo_sk", "promotion")):
            cols[name] = (lambda fk=fk: _null_some(rng, rng.integers(
                1, n[fk] + 1, m).astype(np.int64)))
        cols.update({
            "ss_ticket_number": lambda: ticket,
            "ss_quantity": lambda: qty,
            "ss_wholesale_cost": lambda: wholesale,
            "ss_list_price": lambda: list_price,
            "ss_sales_price": lambda: sales_price,
            "ss_ext_sales_price": lambda: ext_sales,
            "ss_ext_wholesale_cost": lambda: ext_wholesale,
            "ss_ext_list_price": lambda: np.round(list_price * qty, 2),
            "ss_coupon_amt": lambda: np.round(
                rng.uniform(0, 50.0, m) * (rng.random(m) < 0.2), 2),
            "ss_net_paid": lambda: ext_sales,
            "ss_net_profit": lambda: np.round(ext_sales - ext_wholesale, 2)})
        _draw(ss, cols, keep["store_sales"])
        # ~10% of tickets return
        ridx = np.flatnonzero(sr_rng.random(m) < 0.10)
        rqty = sr_rng.integers(1, 1 + qty[ridx])
        ramt = np.round(sales_price[ridx] * rqty, 2)
        _draw(sr, {
            "sr_returned_date_sk": lambda: (
                sold_sk[ridx] + sr_rng.integers(1, 60, len(ridx))).astype(
                np.int64),
            "sr_item_sk": lambda: item_sk[ridx],
            "sr_customer_sk": lambda: cust_sk[ridx],
            "sr_cdemo_sk": lambda: sr_rng.integers(
                1, n["customer_demographics"] + 1, len(ridx)).astype(
                np.int64),
            "sr_ticket_number": lambda: ticket[ridx],
            "sr_return_quantity": lambda: rqty.astype(np.int64),
            "sr_return_amt": lambda: ramt,
            "sr_net_loss": lambda: np.round(ramt * 0.1 + 5.0, 2)},
            keep["store_returns"])
    return {"store_sales": ss, "store_returns": sr}


def _catalog_channel(n, chunk, keep):
    """catalog_sales and catalog_returns (reference :307-369)."""
    rng = np.random.default_rng(2008)
    cs, cr = {}, {}
    n_cs = n["catalog_sales"]
    for off in range(0, n_cs, chunk):
        m = min(chunk, n_cs - off)
        qty = rng.integers(1, 101, m).astype(np.int64)
        list_price = np.round(rng.uniform(1.0, 300.0, m), 2)
        sales_price = np.round(list_price * rng.uniform(0.2, 1.0, m), 2)
        wholesale = np.round(list_price * rng.uniform(0.1, 0.6, m), 2)
        item_sk = rng.integers(1, n["item"] + 1, m).astype(np.int64)
        order = (off + np.arange(m) + 1).astype(np.int64)
        ext_sales = np.round(sales_price * qty, 2)
        ext_list = np.round(list_price * qty, 2)
        _draw(cs, {
            "cs_sold_date_sk": lambda: _null_some(rng, (
                _SK0 + rng.integers(0, _N_DATES, m)).astype(np.int64)),
            "cs_item_sk": lambda: item_sk,
            "cs_order_number": lambda: order,
            "cs_bill_customer_sk": lambda: rng.integers(
                1, n["customer"] + 1, m).astype(np.int64),
            "cs_bill_cdemo_sk": lambda: _null_some(rng, rng.integers(
                1, n["customer_demographics"] + 1, m).astype(np.int64)),
            "cs_promo_sk": lambda: _null_some(rng, rng.integers(
                1, n["promotion"] + 1, m).astype(np.int64)),
            "cs_quantity": lambda: qty,
            "cs_list_price": lambda: list_price,
            "cs_sales_price": lambda: sales_price,
            "cs_wholesale_cost": lambda: wholesale,
            "cs_ext_sales_price": lambda: ext_sales,
            "cs_ext_list_price": lambda: ext_list,
            "cs_ext_wholesale_cost": lambda: np.round(wholesale * qty, 2),
            "cs_ext_discount_amt": lambda: np.round(ext_list - ext_sales, 2),
            "cs_coupon_amt": lambda: np.round(
                rng.uniform(0, 50.0, m) * (rng.random(m) < 0.2), 2),
            "cs_net_profit": lambda: np.round(ext_sales - wholesale * qty,
                                              2)},
            keep["catalog_sales"])
        ridx = np.flatnonzero(rng.random(m) < 0.10)
        ramt = np.round(sales_price[ridx] * rng.integers(1, 1 + qty[ridx]),
                        2)
        third = np.round(ramt / 3.0, 2)
        _draw(cr, {"cr_item_sk": lambda: item_sk[ridx],
                   "cr_order_number": lambda: order[ridx],
                   "cr_return_amount": lambda: ramt,
                   "cr_refunded_cash": lambda: third,
                   "cr_reversed_charge": lambda: third,
                   "cr_store_credit": lambda: np.round(ramt - 2 * third, 2)},
              keep["catalog_returns"])
    return {"catalog_sales": cs, "catalog_returns": cr}


def _web_channel(n, chunk, keep):
    """web_sales and web_returns (reference :371-405): several line items
    share an order (the q94/q95 existence probe)."""
    rng = np.random.default_rng(2009)
    ws, wr = {}, {}
    n_ws = n["web_sales"]
    for off in range(0, n_ws, chunk):
        m = min(chunk, n_ws - off)
        qty = rng.integers(1, 101, m).astype(np.int64)
        sales_price = np.round(rng.uniform(1.0, 300.0, m), 2)
        ext_sales = np.round(sales_price * qty, 2)
        sold_sk = (_SK0 + rng.integers(0, _N_DATES, m)).astype(np.int64)
        order = (off + np.arange(m)) // 3 + 1
        _draw(ws, {
            "ws_sold_date_sk": lambda: _null_some(rng, sold_sk),
            "ws_ship_date_sk": lambda: (
                sold_sk + rng.integers(1, 90, m)).astype(np.int64),
            "ws_item_sk": lambda: rng.integers(
                1, n["item"] + 1, m).astype(np.int64),
            "ws_order_number": lambda: order.astype(np.int64),
            "ws_bill_customer_sk": lambda: rng.integers(
                1, n["customer"] + 1, m).astype(np.int64),
            "ws_ship_addr_sk": lambda: rng.integers(
                1, n["customer_address"] + 1, m).astype(np.int64),
            "ws_web_site_sk": lambda: rng.integers(1, 31, m).astype(
                np.int64),
            "ws_warehouse_sk": lambda: rng.integers(1, 6, m).astype(
                np.int64),
            "ws_quantity": lambda: qty,
            "ws_sales_price": lambda: sales_price,
            "ws_ext_sales_price": lambda: ext_sales,
            "ws_ext_ship_cost": lambda: np.round(ext_sales * 0.05, 2),
            "ws_net_profit": lambda: np.round(ext_sales * 0.2, 2)},
            keep["web_sales"])
        ridx = np.flatnonzero(rng.random(m) < 0.05)
        _draw(wr, {"wr_order_number": lambda: order[ridx].astype(np.int64),
                   "wr_item_sk": lambda: rng.integers(
                       1, n["item"] + 1, len(ridx)).astype(np.int64),
                   "wr_return_amt": lambda: np.round(
                       rng.uniform(1, 300, len(ridx)), 2)},
              keep["web_returns"])
    return {"web_sales": ws, "web_returns": wr}


def _draw(out: Dict[str, List[np.ndarray]], cols, keep) -> None:
    """Make every column of ``cols`` in order (so the draws stay aligned)
    and append them to ``out`` if the caller ``keep``s the table."""
    for name, make in cols.items():
        arr = make()
        if keep:
            out.setdefault(name, []).append(arr)


_CHANNELS = {"store_sales": _store_channel, "catalog_sales": _catalog_channel,
             "web_sales": _web_channel}


def gen_db_arrays(sf: float, tables=DB_TABLES, chunk: int = 1_000_000,
                  row_groups: Optional[Dict[str, List[int]]] = None
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """The reference's ``gen_db`` (tpcds.py:29) tables as dicts of numpy
    arrays, value for value.  ``tables`` picks tables (a fact table and its
    returns share one stream of draws, so asking for either draws both).
    ``row_groups``, when given, is filled with each fact and returns
    table's chunk sizes: the row groups the reference writes."""
    n = _sizes(sf)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    wanted = [t for t in DB_TABLES if t in tables]
    for t in tables:
        if t not in DB_TABLES:
            raise ValueError(f"gen_db_arrays does not generate {t!r}")
    for fact, make in _CHANNELS.items():
        members = [t for t, g in _GROUP.items() if g == fact] + [fact]
        if not any(t in wanted for t in members):
            continue
        drawn = make(n, chunk, {t: t in wanted for t in members})
        for t in members:
            if t not in wanted:
                continue
            parts = drawn[t]
            out[t] = {c: _concat(v) for c, v in parts.items()}
            if row_groups is not None and parts:
                row_groups[t] = [len(a) for a in next(iter(parts.values()))]
    for t in wanted:
        if t not in _CHUNKED:
            out[t] = _dims(t, n)
    return {t: out[t] for t in wanted}


def gen_db(sf: float, out_dir: str,
           data: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
           row_groups: Optional[Dict[str, List[int]]] = None
           ) -> Dict[str, str]:
    """The reference's ``gen_db`` (tpcds.py:29) with the port's parquet
    writer: the tables of :func:`gen_db_arrays` (or of ``data``, the same
    dicts already drawn, with their ``row_groups``) written uncompressed
    to ``<out_dir>/tpcds_v2_sf<sf>/<table>.parquet``, a row group
    per chunk of a fact or returns table as the reference writes them,
    1,048,576-row groups for the others.  Returns {table: path}; tables
    already written are kept."""
    from ..io.writers import ROW_GROUP_ROWS, ParquetWriter
    root = os.path.join(out_dir, f"tpcds_v2_sf{sf}")
    paths = {t: os.path.join(root, f"{t}.parquet") for t in DB_TABLES}
    os.makedirs(root, exist_ok=True)
    for t, path in paths.items():
        if os.path.exists(path):
            continue
        if data is not None:
            cols, groups = data[t], (row_groups or {}).get(t)
        else:
            groups_of: Dict[str, List[int]] = {}
            cols = gen_db_arrays(sf, tables=(t,), row_groups=groups_of)[t]
            groups = groups_of.get(t)
        n = len(next(iter(cols.values())))
        if groups is None:
            groups = [min(ROW_GROUP_ROWS, n - off)
                      for off in range(0, n, ROW_GROUP_ROWS)] or [0]
        tmp = path + ".tmp"
        with ParquetWriter(tmp, "UNCOMPRESSED", max(max(groups), 1)) as w:
            off = 0
            for g in groups:
                w.write_table({c: a[off:off + g] for c, a in cols.items()})
                off += g
        os.replace(tmp, path)
    return paths


def load_db(sess, sf: float, out_dir: str):
    """{table: ``sess.read_parquet``} over :func:`gen_db`'s files
    (reference :416)."""
    return {t: sess.read_parquet(p) for t, p in gen_db(sf, out_dir).items()}


# ---------------------------------------------------------------------------------
# Queries (the reference's plans, models/tpcds.py:435-590 and
# models/tpcds_q2.py:33-900), each collected
# ---------------------------------------------------------------------------------

def _F():
    from ..sql import functions
    return functions


def run_q3(dfs):
    f = _F()
    q = (dfs["store_sales"]
         .join(dfs["date_dim"].filter(f.col("d_moy") == 11),
               on=[("ss_sold_date_sk", "d_date_sk")])
         .join(dfs["item"].filter(f.col("i_manufact_id") == 128),
               on=[("ss_item_sk", "i_item_sk")])
         .group_by("d_year", "i_brand_id", "i_brand")
         .agg(f.sum(f.col("ss_ext_sales_price")).alias("sum_agg"))
         .sort("d_year", f.col("sum_agg").desc(), "i_brand_id")
         .limit(100))
    return q.collect()


def _brand_month_year(dfs, year, moy, manager):
    f = _F()
    return (dfs["store_sales"]
            .join(dfs["date_dim"]
                  .filter((f.col("d_moy") == moy)
                          & (f.col("d_year") == year)),
                  on=[("ss_sold_date_sk", "d_date_sk")])
            .join(dfs["item"].filter(f.col("i_manager_id") == manager),
                  on=[("ss_item_sk", "i_item_sk")]))


def run_q42(dfs):
    f = _F()
    q = (_brand_month_year(dfs, 2000, 11, 1)
         .group_by("d_year", "i_category_id", "i_category")
         .agg(f.sum(f.col("ss_ext_sales_price")).alias("s"))
         .sort(f.col("s").desc(), "d_year", "i_category_id", "i_category")
         .limit(100))
    return q.collect()


def run_q52(dfs):
    f = _F()
    q = (_brand_month_year(dfs, 2000, 11, 1)
         .group_by("d_year", "i_brand_id", "i_brand")
         .agg(f.sum(f.col("ss_ext_sales_price")).alias("ext_price"))
         .sort("d_year", f.col("ext_price").desc(), "i_brand_id")
         .limit(100))
    return q.collect()


def run_q55(dfs):
    f = _F()
    q = (_brand_month_year(dfs, 1999, 11, 28)
         .group_by("i_brand_id", "i_brand")
         .agg(f.sum(f.col("ss_ext_sales_price")).alias("ext_price"))
         .sort(f.col("ext_price").desc(), "i_brand_id")
         .limit(100))
    return q.collect()


def _demo_promo(dfs):
    f = _F()
    cd = dfs["customer_demographics"].filter(
        (f.col("cd_gender") == "M") & (f.col("cd_marital_status") == "S")
        & (f.col("cd_education_status") == "College"))
    promo = dfs["promotion"].filter(
        (f.col("p_channel_email") == "N")
        | (f.col("p_channel_event") == "N"))
    return cd, promo


def _avg4(fact, pre, cdemo):
    """q7 (store) and q26 (catalog): four averages per item under the
    demographic and promotion filters."""
    def run(dfs):
        f = _F()
        cd, promo = _demo_promo(dfs)
        q = (dfs[fact]
             .join(cd, on=[(cdemo, "cd_demo_sk")])
             .join(dfs["date_dim"].filter(f.col("d_year") == 2000),
                   on=[(pre + "_sold_date_sk", "d_date_sk")])
             .join(dfs["item"], on=[(pre + "_item_sk", "i_item_sk")])
             .join(promo, on=[(pre + "_promo_sk", "p_promo_sk")])
             .group_by("i_item_id")
             .agg(f.avg(f.col(pre + "_quantity")).alias("agg1"),
                  f.avg(f.col(pre + "_list_price")).alias("agg2"),
                  f.avg(f.col(pre + "_coupon_amt")).alias("agg3"),
                  f.avg(f.col(pre + "_sales_price")).alias("agg4"))
             .sort("i_item_id").limit(100))
        return q.collect()
    return run


run_q7 = _avg4("store_sales", "ss", "ss_cdemo_sk")
run_q26 = _avg4("catalog_sales", "cs", "cs_bill_cdemo_sk")

_Q12_CATS = ["Sports", "Books", "Home"]
_Q12_DATES = (datetime.date(1999, 2, 22), datetime.date(1999, 3, 24))
_PRE = {"web_sales": "ws", "catalog_sales": "cs", "store_sales": "ss"}


def _revratio(fact):
    """q12 (web), q20 (catalog), q98 (store): each item's revenue as a
    share of its class's (tpcds_q2.py:33)."""
    pre = _PRE[fact]

    def run(dfs):
        f = _F()
        lo, hi = _Q12_DATES
        sales = (dfs[fact]
                 .join(dfs["item"].filter(
                     f.col("i_category").isin(_Q12_CATS)),
                     on=[(pre + "_item_sk", "i_item_sk")])
                 .join(dfs["date_dim"].filter(
                     (f.col("d_date") >= lo) & (f.col("d_date") <= hi)),
                     on=[(pre + "_sold_date_sk", "d_date_sk")]))
        per_item = (sales.group_by("i_item_id", "i_class", "i_category",
                                   "i_current_price")
                    .agg(f.sum(f.col(pre + "_ext_sales_price"))
                         .alias("itemrevenue")))
        per_class = (per_item.group_by(f.col("i_class").alias("cls"))
                     .agg(f.sum(f.col("itemrevenue")).alias("classrevenue")))
        q = (per_item.join(per_class, on=[("i_class", "cls")])
             .select("i_item_id", "i_category", "i_class", "i_current_price",
                     "itemrevenue",
                     (f.col("itemrevenue") * 100.0
                      / f.col("classrevenue")).alias("revenueratio"))
             .sort("i_category", "i_class", "i_item_id", "revenueratio")
             .limit(100))
        return q.collect()
    return run


run_q12 = _revratio("web_sales")
run_q20 = _revratio("catalog_sales")
run_q98 = _revratio("store_sales")

# q13 and q48's OR'd branches: (marital, education, sales price range) and
# (states, net profit range)
_Q13_CD = (("M", "Advanced Degree", 100.0, 150.0),
           ("S", "College", 50.0, 100.0),
           ("W", "2 yr Degree", 150.0, 200.0))
_Q13_CA = ((["TX", "OH", "TX"], 100.0, 200.0),
           (["OR", "NM", "KY"], 150.0, 300.0),
           (["VA", "TX", "MS"], 50.0, 250.0))
_Q48_CD = (("M", "4 yr Degree", 100.0, 150.0),
           ("D", "2 yr Degree", 50.0, 100.0),
           ("S", "College", 150.0, 200.0))
_Q48_CA = ((["CO", "OH", "TX"], 0.0, 2000.0),
           (["OR", "MN", "KY"], 150.0, 3000.0),
           (["VA", "CA", "MS"], 50.0, 25000.0))


def _demo_sales(dfs, year, cd_branches, ca_branches):
    f = _F()
    cd_ok = None
    for ms, ed, lo, hi in cd_branches:
        b = ((f.col("cd_marital_status") == ms)
             & (f.col("cd_education_status") == ed)
             & f.col("ss_sales_price").between(lo, hi))
        cd_ok = b if cd_ok is None else cd_ok | b
    ca_ok = None
    for states, lo, hi in ca_branches:
        b = (f.col("ca_state").isin(states)
             & f.col("ss_net_profit").between(lo, hi))
        ca_ok = b if ca_ok is None else ca_ok | b
    return (dfs["store_sales"]
            .join(dfs["store"], on=[("ss_store_sk", "s_store_sk")])
            .join(dfs["date_dim"].filter(f.col("d_year") == year),
                  on=[("ss_sold_date_sk", "d_date_sk")])
            .join(dfs["customer_demographics"],
                  on=[("ss_cdemo_sk", "cd_demo_sk")])
            .join(dfs["customer_address"].filter(
                f.col("ca_country") == "United States"),
                on=[("ss_addr_sk", "ca_address_sk")])
            .filter(cd_ok & ca_ok))


def run_q13(dfs):
    f = _F()
    q = (_demo_sales(dfs, 2001, _Q13_CD, _Q13_CA)
         .agg(f.avg(f.col("ss_quantity")).alias("a1"),
              f.avg(f.col("ss_ext_sales_price")).alias("a2"),
              f.avg(f.col("ss_ext_wholesale_cost")).alias("a3"),
              f.sum(f.col("ss_ext_wholesale_cost")).alias("a4")))
    return q.collect()


def run_q48(dfs):
    f = _F()
    q = (_demo_sales(dfs, 2000, _Q48_CD, _Q48_CA)
         .agg(f.sum(f.col("ss_quantity")).alias("q")))
    return q.collect()


def run_q19(dfs):
    f = _F()
    q = (dfs["store_sales"]
         .join(dfs["date_dim"].filter(
             (f.col("d_moy") == 11) & (f.col("d_year") == 1998)),
             on=[("ss_sold_date_sk", "d_date_sk")])
         .join(dfs["item"].filter(f.col("i_manager_id") == 8),
               on=[("ss_item_sk", "i_item_sk")])
         .join(dfs["customer"], on=[("ss_customer_sk", "c_customer_sk")])
         .join(dfs["customer_address"],
               on=[("c_current_addr_sk", "ca_address_sk")])
         .join(dfs["store"], on=[("ss_store_sk", "s_store_sk")])
         .filter(f.col("ca_zip").substr(1, 5)
                 != f.col("s_zip").substr(1, 5))
         .group_by("i_brand_id", "i_brand", "i_manufact_id")
         .agg(f.sum(f.col("ss_ext_sales_price")).alias("ext_price"))
         .sort(f.col("ext_price").desc(), f.col("i_brand_id").asc(),
               f.col("i_brand").asc(), f.col("i_manufact_id").asc())
         .limit(100))
    return q.collect()


def run_q25(dfs):
    f = _F()
    d1 = dfs["date_dim"].filter((f.col("d_moy") == 4)
                                & (f.col("d_year") == 2001))
    d2 = (dfs["date_dim"]
          .filter(f.col("d_moy").between(4, 10) & (f.col("d_year") == 2001))
          .select(f.col("d_date_sk").alias("d2_sk")))
    d3 = (dfs["date_dim"]
          .filter(f.col("d_moy").between(4, 10) & (f.col("d_year") == 2001))
          .select(f.col("d_date_sk").alias("d3_sk")))
    q = (dfs["store_sales"]
         .join(dfs["store_returns"],
               on=[("ss_customer_sk", "sr_customer_sk"),
                   ("ss_item_sk", "sr_item_sk"),
                   ("ss_ticket_number", "sr_ticket_number")])
         .join(dfs["catalog_sales"],
               on=[("sr_customer_sk", "cs_bill_customer_sk"),
                   ("sr_item_sk", "cs_item_sk")])
         .join(d1, on=[("ss_sold_date_sk", "d_date_sk")])
         .join(d2, on=[("sr_returned_date_sk", "d2_sk")])
         .join(d3, on=[("cs_sold_date_sk", "d3_sk")])
         .join(dfs["store"], on=[("ss_store_sk", "s_store_sk")])
         .join(dfs["item"], on=[("ss_item_sk", "i_item_sk")])
         .group_by("i_item_id", "s_store_id", "s_store_name")
         .agg(f.sum(f.col("ss_net_profit")).alias("store_sales_profit"),
              f.sum(f.col("sr_net_loss")).alias("store_returns_loss"),
              f.sum(f.col("cs_net_profit")).alias("catalog_sales_profit"))
         .sort("i_item_id", "s_store_id", "s_store_name")
         .limit(100))
    return q.collect()


_Q34_COUNTIES = ["Williamson County", "Walker County", "Daviess County",
                 "Barrow County"]
# q34 and q73: (buy potentials, count range, day-of-month ranges)
_Q34 = ([">10000", "Unknown"], 15, 20, ((1, 3), (25, 28)))
_Q73 = ([">10000", "5001-10000"], 1, 5, ((1, 2),))


def _ticket_counts(spec):
    """q34 and q73: tickets of a count range per customer
    (tpcds_q2.py:358)."""
    pots, lo, hi, doms = spec

    def run(dfs):
        f = _F()
        dom = None
        for a, b in doms:
            c = f.col("d_dom").between(a, b)
            dom = c if dom is None else dom | c
        hd = dfs["household_demographics"].filter(
            f.col("hd_buy_potential").isin(pots)
            & (f.col("hd_vehicle_count") > 0)
            & ((f.col("hd_dep_count") * 1.0
                / f.col("hd_vehicle_count")) > 1.2))
        q = (dfs["store_sales"]
             .join(dfs["date_dim"].filter(
                 dom & f.col("d_year").isin([1999, 2000, 2001])),
                 on=[("ss_sold_date_sk", "d_date_sk")])
             .join(dfs["store"].filter(f.col("s_county").isin(_Q34_COUNTIES)),
                   on=[("ss_store_sk", "s_store_sk")])
             .join(hd, on=[("ss_hdemo_sk", "hd_demo_sk")])
             .group_by("ss_ticket_number", "ss_customer_sk")
             .agg(f.count_star().alias("cnt")))
        q = (q.filter(f.col("cnt").between(lo, hi))
             .join(dfs["customer"], on=[("ss_customer_sk", "c_customer_sk")])
             .select("c_last_name", "c_first_name", "c_salutation"
                     if "c_salutation" in dfs["customer"].columns
                     else "c_preferred_cust_flag", "ss_ticket_number", "cnt")
             .sort("c_last_name", "c_first_name", "ss_ticket_number")
             .limit(200))
        return q.collect()
    return run


run_q34 = _ticket_counts(_Q34)
run_q73 = _ticket_counts(_Q73)

_Q46_CITIES = ["Fairview", "Midway", "Cedar Grove", "Five Points",
               "Oak Grove"]
# q46, q68, q79: (household filter, date filter, store filter, sums); each
# filter as (column, operator, value) conjuncts or disjuncts
_Q46 = ((("or", ("hd_dep_count", "==", 4), ("hd_vehicle_count", "==", 3)),),
        (("d_dow", "in", [6, 0]), ("d_year", "in", [1999, 2000, 2001])),
        (("s_city", "in", _Q46_CITIES),),
        (("ss_coupon_amt", "amt"), ("ss_net_profit", "profit")))
_Q68 = ((("or", ("hd_dep_count", "==", 4), ("hd_vehicle_count", "==", 3)),),
        (("d_dom", "between", (1, 2)), ("d_year", "in", [1998, 1999, 2000])),
        (("s_city", "in", ["Midway", "Fairview"]),),
        (("ss_ext_sales_price", "extended_price"),
         ("ss_ext_list_price", "list_price"),
         ("ss_ext_wholesale_cost", "extended_tax")))
_Q79 = ((("or", ("hd_dep_count", "==", 6), ("hd_vehicle_count", ">", 2)),),
        (("d_dow", "==", 1), ("d_year", "in", [1998, 1999, 2000])),
        (("s_number_employees", "between", (200, 295)),),
        (("ss_coupon_amt", "amt"), ("ss_net_profit", "profit")))


def _cond(f, terms):
    """The AND of ``terms`` as a Column (an ``("or", a, b)`` term is the
    OR of two terms)."""
    out = None
    for t in terms:
        if t[0] == "or":
            c = _cond(f, (t[1],)) | _cond(f, (t[2],))
        else:
            name, op, v = t
            col = f.col(name)
            c = {"==": lambda: col == v, ">": lambda: col > v,
                 "in": lambda: col.isin(v),
                 "between": lambda: col.between(*v)}[op]()
        out = c if out is None else out & c
    return out


def _city_sums(spec):
    """q46, q68, q79: per-ticket sums in the city bought, for customers now
    living elsewhere (tpcds_q2.py:439)."""
    hd_terms, date_terms, store_terms, sums = spec

    def run(dfs):
        f = _F()
        q = (dfs["store_sales"]
             .join(dfs["date_dim"].filter(_cond(f, date_terms)),
                   on=[("ss_sold_date_sk", "d_date_sk")])
             .join(dfs["store"].filter(_cond(f, store_terms)),
                   on=[("ss_store_sk", "s_store_sk")])
             .join(dfs["household_demographics"].filter(
                 _cond(f, hd_terms)), on=[("ss_hdemo_sk", "hd_demo_sk")])
             .join(dfs["customer_address"],
                   on=[("ss_addr_sk", "ca_address_sk")])
             .group_by("ss_ticket_number", "ss_customer_sk",
                       f.col("ca_city").alias("bought_city"))
             .agg(*[f.sum(f.col(c)).alias(a) for c, a in sums]))
        cur = (dfs["customer"]
               .join(dfs["customer_address"],
                     on=[("c_current_addr_sk", "ca_address_sk")]))
        q = (q.join(cur, on=[("ss_customer_sk", "c_customer_sk")])
             .filter(f.col("ca_city") != f.col("bought_city"))
             .select("c_last_name", "c_first_name", "ca_city", "bought_city",
                     "ss_ticket_number", *[a for _, a in sums])
             .sort("c_last_name", "c_first_name", "ca_city", "bought_city",
                   "ss_ticket_number")
             .limit(100))
        return q.collect()
    return run


run_q46 = _city_sums(_Q46)
run_q68 = _city_sums(_Q68)
run_q79 = _city_sums(_Q79)


def run_q65(dfs):
    f = _F()
    dd = dfs["date_dim"].filter(f.col("d_month_seq").between(1176, 1187))
    sc = (dfs["store_sales"]
          .join(dd, on=[("ss_sold_date_sk", "d_date_sk")])
          .group_by("ss_store_sk", "ss_item_sk")
          .agg(f.sum(f.col("ss_sales_price")).alias("revenue")))
    sb = (sc.group_by(f.col("ss_store_sk").alias("sb_store_sk"))
          .agg(f.avg(f.col("revenue")).alias("ave")))
    q = (sc.join(sb, on=[("ss_store_sk", "sb_store_sk")])
         .filter(f.col("revenue") <= f.col("ave") * 0.1)
         .join(dfs["store"], on=[("ss_store_sk", "s_store_sk")])
         .join(dfs["item"], on=[("ss_item_sk", "i_item_sk")])
         .select("s_store_name", "i_item_id", "revenue")
         .sort("s_store_name", "i_item_id")
         .limit(100))
    return q.collect()


_Q94_DATES = (datetime.date(1999, 2, 1), datetime.date(1999, 4, 2))


def _web_ship_base(dfs, f):
    lo, hi = _Q94_DATES
    return (dfs["web_sales"]
            .join(dfs["date_dim"].filter(
                (f.col("d_date") >= lo) & (f.col("d_date") <= hi)),
                on=[("ws_ship_date_sk", "d_date_sk")])
            .join(dfs["customer_address"].filter(
                f.col("ca_state") == "IL"),
                on=[("ws_ship_addr_sk", "ca_address_sk")])
            .join(dfs["web_site"].filter(
                f.col("web_company_name") == "pri"),
                on=[("ws_web_site_sk", "web_site_sk")]))


def _multi_wh_orders(dfs, f):
    """Orders shipping from more than one warehouse, cached: both of its
    consumers read one materialization (tpcds_q2.py:705)."""
    per = (dfs["web_sales"]
           .group_by(f.col("ws_order_number").alias("mw_order"))
           .agg(f.min(f.col("ws_warehouse_sk")).alias("wh_min"),
                f.max(f.col("ws_warehouse_sk")).alias("wh_max")))
    return per.filter(f.col("wh_min") != f.col("wh_max")) \
        .select("mw_order").cache()


def _orders_and_sums(kept, f):
    orders = kept.select("ws_order_number").distinct().count()
    sums = kept.agg(f.sum(f.col("ws_ext_ship_cost")).alias("s1"),
                    f.sum(f.col("ws_net_profit")).alias("s2")).collect()
    return [(orders, sums[0][0], sums[0][1])]


def run_q94(dfs):
    f = _F()
    base = _web_ship_base(dfs, f)
    # EXISTS multi-warehouse, NOT EXISTS returned
    wr = dfs["web_returns"].select(
        f.col("wr_order_number").alias("wr_on")).distinct()
    kept = (base
            .join(_multi_wh_orders(dfs, f),
                  on=[("ws_order_number", "mw_order")], how="semi")
            .join(wr, on=[("ws_order_number", "wr_on")], how="anti"))
    return _orders_and_sums(kept, f)


def run_q95(dfs):
    f = _F()
    base = _web_ship_base(dfs, f)
    multi = _multi_wh_orders(dfs, f)
    wr = (dfs["web_returns"]
          .join(multi.select(f.col("mw_order").alias("mw2")),
                on=[("wr_order_number", "mw2")], how="semi")
          .select(f.col("wr_order_number").alias("wr_on")).distinct())
    kept = (base
            .join(multi, on=[("ws_order_number", "mw_order")], how="semi")
            .join(wr, on=[("ws_order_number", "wr_on")], how="semi"))
    return _orders_and_sums(kept, f)


_Q64_COLORS = ["papaya", "firebrick", "azure", "salmon", "plum",
               "chartreuse"]


def _q64_cs_ui(dfs, f):
    """Catalog items whose sales beat twice their refunds, computed once and
    cached: both years of the cross sales read it (tpcds_q2.py:787)."""
    cs_r = (dfs["catalog_sales"]
            .join(dfs["catalog_returns"],
                  on=[("cs_item_sk", "cr_item_sk"),
                      ("cs_order_number", "cr_order_number")])
            .group_by(f.col("cs_item_sk").alias("ui_item_sk"))
            .agg(f.sum(f.col("cs_ext_list_price")).alias("sale"),
                 f.sum(f.col("cr_refunded_cash")
                       + f.col("cr_reversed_charge")
                       + f.col("cr_store_credit")).alias("refund")))
    return cs_r.filter(f.col("sale") > f.col("refund") * 2.0) \
        .select("ui_item_sk").cache()


def _q64_cross_sales(dfs, f, year, cs_ui):
    item = dfs["item"].filter(
        f.col("i_color").isin(_Q64_COLORS)
        & f.col("i_current_price").between(35.0, 45.0))
    d1 = (dfs["date_dim"].filter(f.col("d_year") == year)
          .select(f.col("d_date_sk").alias("d1_sk"),
                  f.col("d_year").alias("syear")))
    return (dfs["store_sales"]
            .join(dfs["store_returns"],
                  on=[("ss_item_sk", "sr_item_sk"),
                      ("ss_ticket_number", "sr_ticket_number")])
            .join(cs_ui, on=[("ss_item_sk", "ui_item_sk")], how="semi")
            .join(d1, on=[("ss_sold_date_sk", "d1_sk")])
            .join(dfs["store"], on=[("ss_store_sk", "s_store_sk")])
            .join(dfs["customer"], on=[("ss_customer_sk", "c_customer_sk")])
            .join(dfs["customer_address"],
                  on=[("c_current_addr_sk", "ca_address_sk")])
            .join(item, on=[("ss_item_sk", "i_item_sk")])
            .group_by("i_product_name", "ss_item_sk", "s_store_name",
                      "s_zip", "syear")
            .agg(f.count_star().alias("cnt"),
                 f.sum(f.col("ss_wholesale_cost")).alias("s1"),
                 f.sum(f.col("ss_list_price")).alias("s2"),
                 f.sum(f.col("ss_coupon_amt")).alias("s3")))


def run_q64(dfs):
    f = _F()
    cs_ui = _q64_cs_ui(dfs, f)
    cs1 = _q64_cross_sales(dfs, f, 1999, cs_ui)
    cs2 = _q64_cross_sales(dfs, f, 2000, cs_ui)
    cs2 = cs2.select(
        f.col("ss_item_sk").alias("item2"),
        f.col("s_store_name").alias("store2"),
        f.col("s_zip").alias("zip2"),
        f.col("syear").alias("syear2"), f.col("cnt").alias("cnt2"),
        f.col("s1").alias("s1_2"), f.col("s2").alias("s2_2"),
        f.col("s3").alias("s3_2"))
    q = (cs1.join(cs2, on=[("ss_item_sk", "item2"),
                           ("s_store_name", "store2"),
                           ("s_zip", "zip2")])
         .filter(f.col("cnt2") <= f.col("cnt"))
         .select("i_product_name", "s_store_name", "s_zip", "syear",
                 "cnt", "s1", "s2", "s3", "syear2", "cnt2", "s1_2",
                 "s2_2", "s3_2")
         .sort("i_product_name", "s_store_name", "s_zip", "cnt2",
               "syear", "s1"))
    return q.collect()


# ---------------------------------------------------------------------------------
# Numpy oracles
# ---------------------------------------------------------------------------------

def _valid(col) -> np.ndarray:
    if isinstance(col, np.ma.MaskedArray):
        return ~np.ma.getmaskarray(col)
    return np.ones(len(col), dtype=bool)


def _data(col) -> np.ndarray:
    return np.ma.getdata(col) if isinstance(col, np.ma.MaskedArray) else col


def _fk(fk, pk: np.ndarray, keep: Optional[np.ndarray] = None):
    """(rows of the fact whose non-null ``fk`` finds a row of the dense key
    ``pk`` (pk[0], pk[0] + 1, ...) that ``keep`` keeps, each row's index
    into the dimension)."""
    n, base = len(pk), int(pk[0])
    if n and int(pk[-1]) - base != n - 1:
        raise ValueError("the key is not dense")
    idx = _data(fk).astype(np.int64) - base
    ok = _valid(fk) & (idx >= 0) & (idx < n)
    idx = np.where(ok, idx, 0)
    if keep is not None:
        ok &= keep[idx]
    return ok, idx


def _codes(values: np.ndarray):
    """(each value's rank among the distinct values, their count)."""
    uniq, inv = np.unique(values, return_inverse=True)
    return inv.reshape(-1).astype(np.int64), len(uniq)


def _packed(cols, sizes) -> np.ndarray:
    key = np.zeros(len(cols[0]), dtype=np.int64)
    width = 1
    for c, s in zip(cols, sizes):
        width *= max(s, 1)
        if width >= 1 << 62:
            raise OverflowError("the packed key does not fit 62 bits")
        key = key * max(s, 1) + c
    return key


def _groups(*keys):
    """(one row of each group, each row's group) of the rows' key tuples;
    groups in ascending key order."""
    if not len(keys[0]):
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    coded = [_codes(k) for k in keys]
    key = _packed([c for c, _ in coded], [s for _, s in coded])
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    return first, inv.reshape(-1)


def _pairs(lkeys, rkeys):
    """(left rows, right rows) of the equi-join of two key tuples (no
    nulls)."""
    coded = [_codes(np.concatenate([a, b])) for a, b in zip(lkeys, rkeys)]
    both = _packed([c for c, _ in coded], [s for _, s in coded])
    nl = len(lkeys[0])
    lk, rk = both[:nl], both[nl:]
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lo = np.searchsorted(rs, lk, "left")
    cnt = np.searchsorted(rs, lk, "right") - lo
    li = np.repeat(np.arange(nl), cnt)
    within = np.arange(len(li)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return li, order[np.repeat(lo, cnt) + within]


def _cents(x: np.ndarray) -> np.ndarray:
    return np.rint(x * 100.0).astype(np.int64)


def _sum(x: np.ndarray, inv: np.ndarray, n: int) -> np.ndarray:
    """Per group, the exact sum of money values (in integer cents) as the
    nearest float, or of integers as int64."""
    if x.dtype.kind == "f":
        return np.bincount(inv, weights=_cents(x).astype(np.float64),
                           minlength=n) / 100.0
    return np.bincount(inv, weights=x.astype(np.float64),
                       minlength=n).astype(np.int64)


def _count(inv: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(inv, minlength=n).astype(np.int64)


def _top(cols, keys, limit: Optional[int]) -> List[tuple]:
    """Rows of ``cols`` ordered by ``keys`` ((values, descending) pairs,
    stable), the first ``limit``, as tuples of Python values."""
    if keys:
        ranks = [(-_codes(v)[0] if desc else _codes(v)[0])
                 for v, desc in keys]
        order = np.lexsort(ranks[::-1])
    else:
        order = np.arange(len(cols[0]) if cols else 0)
    if limit is not None:
        order = order[:limit]
    return list(zip(*[np.asarray(c)[order].tolist() for c in cols])) \
        if len(order) else []


def _between(x, lo, hi) -> np.ndarray:
    return (x >= lo) & (x <= hi)


def numpy_q3(t):
    ss, d, i = t["store_sales"], t["date_dim"], t["item"]
    ok, di = _fk(ss["ss_sold_date_sk"], d["d_date_sk"], d["d_moy"] == 11)
    ok2, ii = _fk(ss["ss_item_sk"], i["i_item_sk"],
                  i["i_manufact_id"] == 128)
    m = ok & ok2
    di, ii = di[m], ii[m]
    keys = (d["d_year"][di], i["i_brand_id"][ii], i["i_brand"][ii])
    first, inv = _groups(*keys)
    s = _sum(ss["ss_ext_sales_price"][m], inv, len(first))
    k = [c[first] for c in keys]
    return _top(k + [s], [(k[0], False), (s, True), (k[1], False)], 100)


def _bmy(t, year, moy, manager):
    ss, d, i = t["store_sales"], t["date_dim"], t["item"]
    ok, di = _fk(ss["ss_sold_date_sk"], d["d_date_sk"],
                 (d["d_moy"] == moy) & (d["d_year"] == year))
    ok2, ii = _fk(ss["ss_item_sk"], i["i_item_sk"],
                  i["i_manager_id"] == manager)
    m = ok & ok2
    return m, di[m], ii[m]


def numpy_q42(t):
    d, i = t["date_dim"], t["item"]
    m, di, ii = _bmy(t, 2000, 11, 1)
    keys = (d["d_year"][di], i["i_category_id"][ii], i["i_category"][ii])
    first, inv = _groups(*keys)
    s = _sum(t["store_sales"]["ss_ext_sales_price"][m], inv, len(first))
    k = [c[first] for c in keys]
    return _top(k + [s], [(s, True), (k[0], False), (k[1], False),
                          (k[2], False)], 100)


def numpy_q52(t):
    d, i = t["date_dim"], t["item"]
    m, di, ii = _bmy(t, 2000, 11, 1)
    keys = (d["d_year"][di], i["i_brand_id"][ii], i["i_brand"][ii])
    first, inv = _groups(*keys)
    s = _sum(t["store_sales"]["ss_ext_sales_price"][m], inv, len(first))
    k = [c[first] for c in keys]
    return _top(k + [s], [(k[0], False), (s, True), (k[1], False)], 100)


def numpy_q55(t):
    i = t["item"]
    m, _, ii = _bmy(t, 1999, 11, 28)
    keys = (i["i_brand_id"][ii], i["i_brand"][ii])
    first, inv = _groups(*keys)
    s = _sum(t["store_sales"]["ss_ext_sales_price"][m], inv, len(first))
    k = [c[first] for c in keys]
    return _top(k + [s], [(s, True), (k[0], False)], 100)


def _numpy_avg4(fact, pre, cdemo):
    def oracle(t):
        s, cd, d, i, p = (t[k] for k in (fact, "customer_demographics",
                                         "date_dim", "item", "promotion"))
        ok = _fk(s[cdemo], cd["cd_demo_sk"],
                 (cd["cd_gender"] == "M") & (cd["cd_marital_status"] == "S")
                 & (cd["cd_education_status"] == "College"))[0]
        ok &= _fk(s[pre + "_sold_date_sk"], d["d_date_sk"],
                  d["d_year"] == 2000)[0]
        ok2, ii = _fk(s[pre + "_item_sk"], i["i_item_sk"])
        ok &= ok2 & _fk(s[pre + "_promo_sk"], p["p_promo_sk"],
                        (p["p_channel_email"] == "N")
                        | (p["p_channel_event"] == "N"))[0]
        ids = i["i_item_id"][ii[ok]]
        first, inv = _groups(ids)
        n = _count(inv, len(first))
        cols = [ids[first]] + [
            _sum(s[pre + c][ok], inv, len(first)) / n
            for c in ("_quantity", "_list_price", "_coupon_amt",
                      "_sales_price")]
        return _top(cols, [(cols[0], False)], 100)
    return oracle


numpy_q7 = _numpy_avg4("store_sales", "ss", "ss_cdemo_sk")
numpy_q26 = _numpy_avg4("catalog_sales", "cs", "cs_bill_cdemo_sk")


def _numpy_revratio(fact):
    pre = _PRE[fact]

    def oracle(t):
        s, i, d = t[fact], t["item"], t["date_dim"]
        lo, hi = (np.datetime64(x) for x in _Q12_DATES)
        ok, ii = _fk(s[pre + "_item_sk"], i["i_item_sk"],
                     np.isin(i["i_category"], _Q12_CATS))
        ok &= _fk(s[pre + "_sold_date_sk"], d["d_date_sk"],
                  _between(d["d_date"], lo, hi))[0]
        ii = ii[ok]
        keys = (i["i_item_id"][ii], i["i_class"][ii], i["i_category"][ii],
                i["i_current_price"][ii])
        first, inv = _groups(*keys)
        rev = _sum(s[pre + "_ext_sales_price"][ok], inv, len(first))
        k = [c[first] for c in keys]
        cfirst, cinv = _groups(k[1])
        cls = np.bincount(cinv, weights=_cents(rev).astype(np.float64),
                          minlength=len(cfirst)) / 100.0
        ratio = rev * 100.0 / cls[cinv]
        return _top([k[0], k[2], k[1], k[3], rev, ratio],
                    [(k[2], False), (k[1], False), (k[0], False),
                     (ratio, False)], 100)
    return oracle


numpy_q12 = _numpy_revratio("web_sales")
numpy_q20 = _numpy_revratio("catalog_sales")
numpy_q98 = _numpy_revratio("store_sales")


def _numpy_demo_sales(t, year, cd_branches, ca_branches):
    ss, st, d, cd, ca = (t[k] for k in ("store_sales", "store", "date_dim",
                                        "customer_demographics",
                                        "customer_address"))
    ok = _fk(ss["ss_store_sk"], st["s_store_sk"])[0]
    ok &= _fk(ss["ss_sold_date_sk"], d["d_date_sk"], d["d_year"] == year)[0]
    ok2, ci = _fk(ss["ss_cdemo_sk"], cd["cd_demo_sk"])
    ok3, ai = _fk(ss["ss_addr_sk"], ca["ca_address_sk"],
                  ca["ca_country"] == "United States")
    ok &= ok2 & ok3
    price, profit = ss["ss_sales_price"], ss["ss_net_profit"]
    ms, ed = cd["cd_marital_status"][ci], cd["cd_education_status"][ci]
    cd_ok = np.zeros(len(ok), dtype=bool)
    for m_, e_, lo, hi in cd_branches:
        cd_ok |= (ms == m_) & (ed == e_) & _between(price, lo, hi)
    state = ca["ca_state"][ai]
    ca_ok = np.zeros(len(ok), dtype=bool)
    for states, lo, hi in ca_branches:
        ca_ok |= np.isin(state, states) & _between(profit, lo, hi)
    return ok & cd_ok & ca_ok


def numpy_q13(t):
    ss = t["store_sales"]
    m = _numpy_demo_sales(t, 2001, _Q13_CD, _Q13_CA)
    n = int(m.sum())
    if not n:
        return [(None, None, None, None)]
    inv = np.zeros(n, dtype=np.int64)
    whole = _sum(ss["ss_ext_wholesale_cost"][m], inv, 1)[0]
    return [(float(_sum(ss["ss_quantity"][m], inv, 1)[0] / n),
             float(_sum(ss["ss_ext_sales_price"][m], inv, 1)[0] / n),
             float(whole / n), float(whole))]


def numpy_q48(t):
    m = _numpy_demo_sales(t, 2000, _Q48_CD, _Q48_CA)
    if not m.any():
        return [(None,)]
    return [(int(t["store_sales"]["ss_quantity"][m].sum()),)]


def numpy_q19(t):
    ss, d, i, c, ca, st = (t[k] for k in (
        "store_sales", "date_dim", "item", "customer", "customer_address",
        "store"))
    ok = _fk(ss["ss_sold_date_sk"], d["d_date_sk"],
             (d["d_moy"] == 11) & (d["d_year"] == 1998))[0]
    ok2, ii = _fk(ss["ss_item_sk"], i["i_item_sk"], i["i_manager_id"] == 8)
    ok3, ci = _fk(ss["ss_customer_sk"], c["c_customer_sk"])
    ok4, si = _fk(ss["ss_store_sk"], st["s_store_sk"])
    ok &= ok2 & ok3 & ok4
    ok5, ai = _fk(c["c_current_addr_sk"][ci], ca["ca_address_sk"])
    ok &= ok5
    # substr(zip, 1, 5): a cast to 5 characters truncates
    diff = ca["ca_zip"][ai[ok]].astype("<U5") \
        != st["s_zip"][si[ok]].astype("<U5")
    m = np.flatnonzero(ok)[diff]
    ii = ii[m]
    keys = (i["i_brand_id"][ii], i["i_brand"][ii], i["i_manufact_id"][ii])
    first, inv = _groups(*keys)
    s = _sum(ss["ss_ext_sales_price"][m], inv, len(first))
    k = [c_[first] for c_ in keys]
    return _top(k + [s], [(s, True), (k[0], False), (k[1], False),
                          (k[2], False)], 100)


def numpy_q25(t):
    ss, sr, cs, d, st, i = (t[k] for k in (
        "store_sales", "store_returns", "catalog_sales", "date_dim", "store",
        "item"))
    d1 = (d["d_moy"] == 4) & (d["d_year"] == 2001)
    d23 = _between(d["d_moy"], 4, 10) & (d["d_year"] == 2001)
    sok = _fk(ss["ss_sold_date_sk"], d["d_date_sk"], d1)[0] \
        & _valid(ss["ss_customer_sk"])
    sok2, si = _fk(ss["ss_store_sk"], st["s_store_sk"])
    sok &= sok2
    rok = _fk(sr["sr_returned_date_sk"], d["d_date_sk"], d23)[0]
    cok = _fk(cs["cs_sold_date_sk"], d["d_date_sk"], d23)[0]
    sx, rx, cx = np.flatnonzero(sok), np.flatnonzero(rok), np.flatnonzero(cok)
    a, b = _pairs([_data(ss["ss_customer_sk"])[sx], ss["ss_item_sk"][sx],
                   ss["ss_ticket_number"][sx]],
                  [sr["sr_customer_sk"][rx], sr["sr_item_sk"][rx],
                   sr["sr_ticket_number"][rx]])
    sx, rx = sx[a], rx[b]
    a, b = _pairs([sr["sr_customer_sk"][rx], sr["sr_item_sk"][rx]],
                  [cs["cs_bill_customer_sk"][cx], cs["cs_item_sk"][cx]])
    sx, rx, cx = sx[a], rx[a], cx[b]
    ii = _fk(ss["ss_item_sk"][sx], i["i_item_sk"])[1]
    keys = (i["i_item_id"][ii], st["s_store_id"][si[sx]],
            st["s_store_name"][si[sx]])
    first, inv = _groups(*keys)
    g = len(first)
    k = [c[first] for c in keys]
    cols = k + [_sum(ss["ss_net_profit"][sx], inv, g),
                _sum(sr["sr_net_loss"][rx], inv, g),
                _sum(cs["cs_net_profit"][cx], inv, g)]
    return _top(cols, [(k[0], False), (k[1], False), (k[2], False)], 100)


def _numpy_ticket_counts(spec):
    pots, lo, hi, doms = spec

    def oracle(t):
        ss, d, st, hd, c = (t[k] for k in (
            "store_sales", "date_dim", "store", "household_demographics",
            "customer"))
        dom = np.zeros(len(d["d_dom"]), dtype=bool)
        for a, b in doms:
            dom |= _between(d["d_dom"], a, b)
        veh = hd["hd_vehicle_count"]
        hd_ok = np.isin(hd["hd_buy_potential"], pots) & (veh > 0)
        hd_ok &= hd["hd_dep_count"] * 1.0 / np.where(veh > 0, veh, 1) > 1.2
        ok = _fk(ss["ss_sold_date_sk"], d["d_date_sk"],
                 dom & np.isin(d["d_year"], [1999, 2000, 2001]))[0]
        ok &= _fk(ss["ss_store_sk"], st["s_store_sk"],
                  np.isin(st["s_county"], _Q34_COUNTIES))[0]
        ok &= _fk(ss["ss_hdemo_sk"], hd["hd_demo_sk"], hd_ok)[0]
        # null customers group apart and then join no customer
        ok &= _valid(ss["ss_customer_sk"])
        tk = ss["ss_ticket_number"][ok]
        cu = _data(ss["ss_customer_sk"])[ok]
        first, inv = _groups(tk, cu)
        cnt = _count(inv, len(first))
        keep = _between(cnt, lo, hi)
        tk, cu, cnt = tk[first][keep], cu[first][keep], cnt[keep]
        ok2, ci = _fk(cu, c["c_customer_sk"])
        ci, tk, cnt = ci[ok2], tk[ok2], cnt[ok2]
        cols = [c["c_last_name"][ci], c["c_first_name"][ci],
                c["c_preferred_cust_flag"][ci], tk, cnt]
        return _top(cols, [(cols[0], False), (cols[1], False),
                           (tk, False)], 200)
    return oracle


numpy_q34 = _numpy_ticket_counts(_Q34)
numpy_q73 = _numpy_ticket_counts(_Q73)


def _mask(table, terms) -> np.ndarray:
    """``_cond``'s terms over a dict of numpy arrays."""
    out = None
    for term in terms:
        if term[0] == "or":
            m = _mask(table, (term[1],)) | _mask(table, (term[2],))
        else:
            name, op, v = term
            x = table[name]
            m = {"==": lambda: x == v, ">": lambda: x > v,
                 "in": lambda: np.isin(x, v),
                 "between": lambda: _between(x, *v)}[op]()
        out = m if out is None else out & m
    return out


def _numpy_city_sums(spec):
    hd_terms, date_terms, store_terms, sums = spec

    def oracle(t):
        ss, d, st, hd, ca, c = (t[k] for k in (
            "store_sales", "date_dim", "store", "household_demographics",
            "customer_address", "customer"))
        ok = _fk(ss["ss_sold_date_sk"], d["d_date_sk"],
                 _mask(d, date_terms))[0]
        ok &= _fk(ss["ss_store_sk"], st["s_store_sk"],
                  _mask(st, store_terms))[0]
        ok &= _fk(ss["ss_hdemo_sk"], hd["hd_demo_sk"],
                  _mask(hd, hd_terms))[0]
        ok2, ai = _fk(ss["ss_addr_sk"], ca["ca_address_sk"])
        ok &= ok2 & _valid(ss["ss_customer_sk"])
        tk = ss["ss_ticket_number"][ok]
        cu = _data(ss["ss_customer_sk"])[ok]
        city = ca["ca_city"][ai[ok]]
        first, inv = _groups(tk, cu, city)
        sumcols = [_sum(ss[col][ok], inv, len(first)) for col, _ in sums]
        tk, cu, city = tk[first], cu[first], city[first]
        ok3, ci = _fk(cu, c["c_customer_sk"])
        ok4, cai = _fk(c["c_current_addr_sk"][ci], ca["ca_address_sk"])
        now = ca["ca_city"][cai]
        keep = ok3 & ok4 & (now != city)
        ci, cai = ci[keep], cai[keep]
        cols = [c["c_last_name"][ci], c["c_first_name"][ci],
                ca["ca_city"][cai], city[keep], tk[keep]] \
            + [s[keep] for s in sumcols]
        return _top(cols, [(x, False) for x in cols[:5]], 100)
    return oracle


numpy_q46 = _numpy_city_sums(_Q46)
numpy_q68 = _numpy_city_sums(_Q68)
numpy_q79 = _numpy_city_sums(_Q79)


def numpy_q65(t):
    ss, d, st, i = (t[k] for k in ("store_sales", "date_dim", "store",
                                   "item"))
    ok = _fk(ss["ss_sold_date_sk"], d["d_date_sk"],
             _between(d["d_month_seq"], 1176, 1187))[0]
    # a null store groups apart and then joins no store average
    ok &= _valid(ss["ss_store_sk"])
    store = _data(ss["ss_store_sk"])[ok]
    item = ss["ss_item_sk"][ok]
    first, inv = _groups(store, item)
    rev = _sum(ss["ss_sales_price"][ok], inv, len(first))
    store, item = store[first], item[first]
    sfirst, sinv = _groups(store)
    ave = np.bincount(sinv, weights=rev, minlength=len(sfirst)) \
        / _count(sinv, len(sfirst))
    keep = rev <= ave[sinv] * 0.1
    ok2, si = _fk(store[keep], st["s_store_sk"])
    ok3, ii = _fk(item[keep], i["i_item_sk"])
    both = ok2 & ok3
    cols = [st["s_store_name"][si[both]], i["i_item_id"][ii[both]],
            rev[keep][both]]
    return _top(cols, [(cols[0], False), (cols[1], False)], 100)


def _numpy_web_base(t):
    ws, d, ca, web = (t[k] for k in ("web_sales", "date_dim",
                                     "customer_address", "web_site"))
    lo, hi = (np.datetime64(x) for x in _Q94_DATES)
    ok = _fk(ws["ws_ship_date_sk"], d["d_date_sk"],
             _between(d["d_date"], lo, hi))[0]
    ok &= _fk(ws["ws_ship_addr_sk"], ca["ca_address_sk"],
              ca["ca_state"] == "IL")[0]
    ok &= _fk(ws["ws_web_site_sk"], web["web_site_sk"],
              web["web_company_name"] == "pri")[0]
    return ok


def _numpy_multi_wh(ws) -> np.ndarray:
    """The order numbers whose lines ship from more than one warehouse."""
    first, inv = _groups(ws["ws_order_number"])
    g = len(first)
    lo = np.full(g, np.iinfo(np.int64).max)
    hi = np.full(g, np.iinfo(np.int64).min)
    np.minimum.at(lo, inv, ws["ws_warehouse_sk"])
    np.maximum.at(hi, inv, ws["ws_warehouse_sk"])
    return ws["ws_order_number"][first][lo != hi]


def _numpy_orders_and_sums(ws, kept):
    n = int(kept.sum())
    inv = np.zeros(n, dtype=np.int64)
    orders = len(np.unique(ws["ws_order_number"][kept]))
    if not n:
        return [(orders, None, None)]
    return [(orders, float(_sum(ws["ws_ext_ship_cost"][kept], inv, 1)[0]),
             float(_sum(ws["ws_net_profit"][kept], inv, 1)[0]))]


def numpy_q94(t):
    ws = t["web_sales"]
    multi = _numpy_multi_wh(ws)
    returned = np.unique(t["web_returns"]["wr_order_number"])
    on = ws["ws_order_number"]
    kept = _numpy_web_base(t) & np.isin(on, multi) & ~np.isin(on, returned)
    return _numpy_orders_and_sums(ws, kept)


def numpy_q95(t):
    ws = t["web_sales"]
    multi = _numpy_multi_wh(ws)
    wr = t["web_returns"]["wr_order_number"]
    returned = np.unique(wr[np.isin(wr, multi)])
    on = ws["ws_order_number"]
    kept = _numpy_web_base(t) & np.isin(on, multi) & np.isin(on, returned)
    return _numpy_orders_and_sums(ws, kept)


def _numpy_q64_cross(t, year, ui):
    ss, sr, d, st, c, ca, i = (t[k] for k in (
        "store_sales", "store_returns", "date_dim", "store", "customer",
        "customer_address", "item"))
    a, b = _pairs([ss["ss_item_sk"], ss["ss_ticket_number"]],
                  [sr["sr_item_sk"], sr["sr_ticket_number"]])
    rows = a[np.isin(ss["ss_item_sk"][a], ui)]
    ok, di = _fk(ss["ss_sold_date_sk"][rows], d["d_date_sk"],
                 d["d_year"] == year)
    ok2, si = _fk(ss["ss_store_sk"][rows], st["s_store_sk"])
    ok3, ci = _fk(ss["ss_customer_sk"][rows], c["c_customer_sk"])
    ok4 = _fk(c["c_current_addr_sk"][ci], ca["ca_address_sk"])[0]
    ok5, ii = _fk(ss["ss_item_sk"][rows], i["i_item_sk"],
                  np.isin(i["i_color"], _Q64_COLORS)
                  & _between(i["i_current_price"], 35.0, 45.0))
    m = ok & ok2 & ok3 & ok4 & ok5
    rows, di, si, ii = rows[m], di[m], si[m], ii[m]
    keys = (i["i_product_name"][ii], ss["ss_item_sk"][rows],
            st["s_store_name"][si], st["s_zip"][si], d["d_year"][di])
    first, inv = _groups(*keys)
    g = len(first)
    return [k[first] for k in keys] + [
        _count(inv, g), _sum(ss["ss_wholesale_cost"][rows], inv, g),
        _sum(ss["ss_list_price"][rows], inv, g),
        _sum(ss["ss_coupon_amt"][rows], inv, g)]


def numpy_q64(t):
    cs, cr = t["catalog_sales"], t["catalog_returns"]
    a, b = _pairs([cs["cs_item_sk"], cs["cs_order_number"]],
                  [cr["cr_item_sk"], cr["cr_order_number"]])
    items = cs["cs_item_sk"][a]
    first, inv = _groups(items)
    sale = _sum(cs["cs_ext_list_price"][a], inv, len(first))
    refund = _sum(cr["cr_refunded_cash"][b] + cr["cr_reversed_charge"][b]
                  + cr["cr_store_credit"][b], inv, len(first))
    ui = items[first][sale > refund * 2.0]
    one = _numpy_q64_cross(t, 1999, ui)
    two = _numpy_q64_cross(t, 2000, ui)
    # (product, item, store, zip, year, cnt, s1, s2, s3) of each year,
    # joined on (item, store name, zip)
    a, b = _pairs([one[1], one[2], one[3]], [two[1], two[2], two[3]])
    keep = two[5][b] <= one[5][a]
    a, b = a[keep], b[keep]
    cols = [one[0][a], one[2][a], one[3][a], one[4][a], one[5][a],
            one[6][a], one[7][a], one[8][a], two[4][b], two[5][b],
            two[6][b], two[7][b], two[8][b]]
    return _top(cols, [(cols[0], False), (cols[1], False), (cols[2], False),
                       (cols[9], False), (cols[3], False), (cols[5], False)],
                None)


QUERIES = {
    "ds_q3": (run_q3, numpy_q3), "ds_q42": (run_q42, numpy_q42),
    "ds_q52": (run_q52, numpy_q52), "ds_q55": (run_q55, numpy_q55),
    "ds_q7": (run_q7, numpy_q7), "ds_q12": (run_q12, numpy_q12),
    "ds_q13": (run_q13, numpy_q13), "ds_q19": (run_q19, numpy_q19),
    "ds_q20": (run_q20, numpy_q20), "ds_q25": (run_q25, numpy_q25),
    "ds_q26": (run_q26, numpy_q26), "ds_q34": (run_q34, numpy_q34),
    "ds_q46": (run_q46, numpy_q46), "ds_q48": (run_q48, numpy_q48),
    "ds_q64": (run_q64, numpy_q64), "ds_q65": (run_q65, numpy_q65),
    "ds_q68": (run_q68, numpy_q68), "ds_q73": (run_q73, numpy_q73),
    "ds_q79": (run_q79, numpy_q79), "ds_q94": (run_q94, numpy_q94),
    "ds_q95": (run_q95, numpy_q95), "ds_q98": (run_q98, numpy_q98)}

_STAR = ["store_sales", "date_dim", "item"]
_CITY = ["store_sales", "date_dim", "store", "household_demographics",
         "customer_address", "customer"]
_TICKETS = ["store_sales", "date_dim", "store", "household_demographics",
            "customer"]
_DEMO = ["store_sales", "store", "date_dim", "customer_demographics",
         "customer_address"]
_WEB = ["web_sales", "web_returns", "web_site", "customer_address",
        "date_dim"]
# each query's tables (reference tpcds.py:604 TABLES, tpcds_q2.py:922)
TABLES: Dict[str, List[str]] = {
    "ds_q3": _STAR, "ds_q42": _STAR, "ds_q52": _STAR, "ds_q55": _STAR,
    "ds_q7": ["store_sales", "customer_demographics", "date_dim", "item",
              "promotion"],
    "ds_q12": ["web_sales", "item", "date_dim"], "ds_q13": _DEMO,
    "ds_q19": ["store_sales", "date_dim", "item", "customer",
               "customer_address", "store"],
    "ds_q20": ["catalog_sales", "item", "date_dim"],
    "ds_q25": ["store_sales", "store_returns", "catalog_sales", "date_dim",
               "store", "item"],
    "ds_q26": ["catalog_sales", "customer_demographics", "date_dim", "item",
               "promotion"],
    "ds_q34": _TICKETS, "ds_q46": _CITY, "ds_q48": _DEMO,
    "ds_q64": ["catalog_sales", "catalog_returns", "store_sales",
               "store_returns", "date_dim", "store", "customer",
               "customer_address", "item"],
    "ds_q65": ["store_sales", "date_dim", "store", "item"],
    "ds_q68": _CITY, "ds_q73": _TICKETS, "ds_q79": _CITY,
    "ds_q94": _WEB, "ds_q95": _WEB,
    "ds_q98": ["store_sales", "item", "date_dim"]}
# the queries that cache a subplan (``df.cache()``), each materialized once
# per run of the query
CACHED_QUERIES = ("ds_q64", "ds_q94", "ds_q95")
_CITY_ORDER = ((0, False), (1, False), (2, False), (3, False), (4, False))
_RATIO_ORDER = ((1, False), (2, False), (0, False), (5, False))
# each query's ORDER BY as (output column, descending) pairs, with Spark's
# null placement (first ascending, last descending); () for the queries
# that end in one aggregate row
ORDER_BY = {
    "ds_q3": ((0, False), (3, True), (1, False)),
    "ds_q42": ((3, True), (0, False), (1, False), (2, False)),
    "ds_q52": ((0, False), (3, True), (1, False)),
    "ds_q55": ((2, True), (0, False)),
    "ds_q7": ((0, False),), "ds_q12": _RATIO_ORDER, "ds_q13": (),
    "ds_q19": ((3, True), (0, False), (1, False), (2, False)),
    "ds_q20": _RATIO_ORDER,
    "ds_q25": ((0, False), (1, False), (2, False)),
    "ds_q26": ((0, False),), "ds_q34": ((0, False), (1, False), (3, False)),
    "ds_q46": _CITY_ORDER, "ds_q48": (),
    "ds_q64": ((0, False), (1, False), (2, False), (9, False), (3, False),
               (5, False)),
    "ds_q65": ((0, False), (1, False)), "ds_q68": _CITY_ORDER,
    "ds_q73": ((0, False), (1, False), (3, False)), "ds_q79": _CITY_ORDER,
    "ds_q94": (), "ds_q95": (), "ds_q98": _RATIO_ORDER}


def in_query_order(name: str, rows) -> bool:
    """Whether ``rows`` come in query ``name``'s ORDER BY order.  Rows of
    equal keys may come in any order, so rows that also equal the
    oracle's as a multiset (``rows_rel_err``) are its rows in order."""
    def before(a, b) -> bool:  # a may precede b
        for i, desc in ORDER_BY[name]:
            x, y = a[i], b[i]
            if x == y:
                continue
            if x is None or y is None:
                return (x is None) != desc
            return (x > y) if desc else (x < y)
        return True
    return all(before(a, b) for a, b in zip(rows, rows[1:]))


def run_query(name: str, dfs) -> list:
    """Query ``name`` over ``dfs`` ({table: DataFrame}): its rows."""
    return QUERIES[name][0](dfs)


def query_oracle(name: str, tables) -> list:
    """The numpy oracle of query ``name`` over ``tables`` ({table: dict of
    numpy arrays}), as rows."""
    return QUERIES[name][1](tables)


def rows_rel_err(got, want) -> float:
    """Canonical-sorted row comparison returning the max relative error
    over numeric cells (1.0 on any structural mismatch): the reference's
    ``tpch_suite.py:947``, the gate of ``bench.py`` (< 1e-6)."""
    def key(r):
        return tuple((x is None, str(type(x).__name__), x if x is not None
                      and not isinstance(x, float) else
                      (round(x, 6) if x is not None else 0)) for x in r)
    if len(got) != len(want):
        return 1.0
    gs = sorted(got, key=key)
    ws = sorted(want, key=key)
    err = 0.0
    for g, w in zip(gs, ws):
        if len(g) != len(w):
            return 1.0
        for a, b in zip(g, w):
            if a is None or b is None:
                if not (a is None and b is None):
                    return 1.0
            elif isinstance(b, float):
                err = max(err, abs(float(a) - b) / max(1.0, abs(b)))
            elif a != b:
                return 1.0
    return err
