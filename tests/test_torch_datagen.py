"""The port's numpy lineitem generator draws what the reference writes."""

import numpy as np
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.models import tpch as ref_tpch
from spark_rapids_tpu_torch.models import tpch


@pytest.mark.parametrize("rows,chunk", [(2500, 1000), (999, 1000)])
def test_gen_lineitem_arrays_match_reference_parquet(tmp_path, rows, chunk):
    path = ref_tpch.gen_lineitem(0, str(tmp_path), rows=rows, chunk=chunk)
    ref = pq.read_table(path)
    got = tpch.gen_lineitem_arrays(0, rows=rows, chunk=chunk)
    assert list(got) == ref.column_names
    for name in ref.column_names:
        want = ref.column(name).to_numpy()
        if want.dtype.kind == "O":
            assert got[name].tolist() == want.tolist(), name
        else:
            assert got[name].dtype == want.dtype, name
            np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_row_count_follows_the_scale_factor():
    assert len(tpch.gen_lineitem_arrays(0.0001)["l_quantity"]) == 600


@pytest.mark.parametrize("sf,rows,chunk", [(0.002, None, 1_000_000),
                                           (0.01, 2500, 1000)])
def test_gen_orders_arrays_match_reference_parquet(tmp_path, sf, rows, chunk):
    path = ref_tpch.gen_orders(sf, str(tmp_path), rows=rows, chunk=chunk)
    ref = pq.read_table(path)
    got = tpch.gen_orders_arrays(sf, rows=rows, chunk=chunk)
    assert list(got) == ref.column_names
    for name in ref.column_names:
        want = ref.column(name).to_numpy()
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_gen_customer_arrays_match_reference_parquet(tmp_path):
    path = ref_tpch.gen_customer(0.01, str(tmp_path))
    ref = pq.read_table(path)
    got = tpch.gen_customer_arrays(0.01)
    assert list(got) == ref.column_names
    np.testing.assert_array_equal(got["c_custkey"],
                                  ref.column("c_custkey").to_numpy())
    assert got["c_mktsegment"].tolist() == \
        ref.column("c_mktsegment").to_pylist()


def test_orders_cover_every_lineitem_order_key():
    li = tpch.gen_lineitem_arrays(0.001)
    orders = tpch.gen_orders_arrays(0.001)
    assert set(np.unique(li["l_orderkey"])) <= set(orders["o_orderkey"])


@pytest.mark.parametrize("table", ["partsupp", "nation"])
def test_gen_db_partsupp_and_nation_match_reference_parquet(tmp_path, table):
    """partsupp (four suppliers per part, seed 1005) and nation (seed 1001)
    equal what the reference suite's gen_db writes, and partsupp has 4 rows
    per part."""
    from spark_rapids_tpu.models import tpch_suite
    sf = 0.003
    paths = tpch_suite.gen_db(sf, str(tmp_path))
    ref = pq.read_table(paths[table])
    got = tpch.gen_db_arrays(sf, tables=(table,))[table]
    assert list(got) == ref.column_names
    for name in ref.column_names:
        want = ref.column(name).to_numpy()
        if got[name].dtype.kind == "U":
            assert got[name].tolist() == ref.column(name).to_pylist(), name
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert len(got[ref.column_names[0]]) == tpch.db_rows(table, sf)


@pytest.mark.parametrize("chunk", [1_000_000, 1000])
def test_tpcds_gen_db_arrays_match_reference_parquet(tmp_path, chunk):
    """Every column of the sixteen TPC-DS tables equals what the
    reference's ``models/tpcds.gen_db`` writes at SF 0.01, nulls included
    (masked where the reference's column is null), in one chunk and over
    1,000-row chunks, whose sizes are the reference's row groups."""
    from spark_rapids_tpu.models import tpcds as ref_tpcds
    from spark_rapids_tpu_torch.models import tpcds
    paths = ref_tpcds.gen_db(0.01, str(tmp_path), chunk=chunk)
    groups = {}
    got = tpcds.gen_db_arrays(0.01, chunk=chunk, row_groups=groups)
    assert list(got) == list(tpcds.DB_TABLES) == list(paths)
    nullable = 0
    for t in tpcds.DB_TABLES:
        ref = pq.read_table(paths[t])
        assert ref.column_names == list(got[t]), t
        for name in ref.column_names:
            col = got[t][name]
            want = ref.column(name).to_pylist()
            if isinstance(col, np.ma.MaskedArray):
                nullable += 1
                data = np.ma.getdata(col).tolist()
                mine = [None if m else v for v, m in zip(
                    data, np.ma.getmaskarray(col).tolist())]
            else:
                mine = col.astype(object).tolist()
            assert mine == want, f"{t}.{name}"
        if t in groups:
            md = pq.ParquetFile(paths[t]).metadata
            assert groups[t] == [md.row_group(i).num_rows
                                 for i in range(md.num_row_groups)], t
        if tpcds.db_rows(t, 0.01) is not None:
            assert ref.num_rows == tpcds.db_rows(t, 0.01), t
    assert nullable == 15
    picked = tpcds.gen_db_arrays(0.01, tables=("store_returns",),
                                 chunk=chunk)
    assert list(picked) == ["store_returns"]
    np.testing.assert_array_equal(picked["store_returns"]["sr_net_loss"],
                                  got["store_returns"]["sr_net_loss"])
