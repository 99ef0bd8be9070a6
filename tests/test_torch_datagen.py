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
