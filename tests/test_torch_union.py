"""UNION ALL in the port (``DataFrame.union``, ``plan/logical.py Union``,
``plan/exec_nodes.py UnionExec``) against the JAX reference's Session on
the same numpy inputs: int, float, date and string columns with nulls, a
filter pushed into every branch, a union of two string-keyed aggregations
feeding a device sort that concatenates their two dictionaries
(``batch_utils.concat_batches``' remap into the union dictionary), and the
explain strings.  The port runs on the CPU (its kernels' plain versions).
Rows compare exactly in order where the query orders them (floats within
rel 1e-12: the packages sum in different orders), else as multisets."""

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.plan import cbo
from spark_rapids_tpu_torch.sql import functions as TF
from spark_rapids_tpu_torch.utils.metrics import QueryStats as TStats

REL = 1e-12


def _key(row):
    return tuple((0, 0) if x is None else (1, x) for x in row)


def _same_rows(got, want, ordered=True):
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= REL * max(abs(b), 1e-300), (g, w)
            else:
                assert a == b, (g, w)


def _sessions(settings=None):
    return (jsrt.Session(dict(settings or {})),
            tsrt.Session(dict(settings or {}), device="cpu"))


def _table(seed, n):
    rng = np.random.default_rng(seed)
    words = np.array(["alpha", "beta", "gamma", "delta", "eps"], dtype=object)
    s = words[rng.integers(0, len(words), n)].astype(object)
    s[rng.random(n) < 0.1] = None
    v = rng.integers(-50, 50, n).astype(object)
    v[rng.random(n) < 0.1] = None
    return {"k": rng.integers(0, 9, n),
            "x": rng.uniform(-10.0, 10.0, n),
            "d": np.datetime64("1995-01-01") + rng.integers(0, 900, n),
            "s": s,
            "v": v}


def _both(build, settings=None):
    jsess, tsess = _sessions(settings)
    return (build(jsess, JF).collect(), build(tsess, TF).collect(),
            build(jsess, JF), build(tsess, TF))


def test_union_of_every_column_type_keeps_branch_order():
    def q(s, F):
        a = s.create_dataframe(_table(1, 300))
        b = s.create_dataframe(_table(2, 200))
        return a.union(b)
    want, got, _, _ = _both(q)
    assert len(got) == 500
    _same_rows(got, want)


def test_union_all_keeps_duplicates_and_alias():
    def q(s, F):
        a = s.create_dataframe(_table(3, 50))
        return a.unionAll(a).union(a)
    want, got, _, _ = _both(q)
    assert len(got) == 150
    _same_rows(got, want)


def test_filter_pushed_into_every_branch():
    def q(s, F):
        a = s.create_dataframe(_table(4, 400))
        b = s.create_dataframe(_table(5, 300))
        return a.union(b).filter((F.col("k") < 4) & (F.col("x") > 0.0))
    want, got, jq, tq = _both(q)
    _same_rows(got, want)
    lines = tq.explain_string().splitlines()[2:]
    assert lines == jq.explain_string().splitlines()[2:]
    # the filter sits under the union, once in each branch
    assert lines[0].strip() == "* Union"
    assert sum("Filter" in ln for ln in lines) == 2
    assert not lines[0].lstrip("* ").startswith("Filter")


def test_union_of_aggregations_sorted_concatenates_two_dictionaries(
        monkeypatch):
    """Each branch's aggregate codes its string key in a dictionary of its
    own; the device sort above concatenates both branches, so the codes
    are remapped into the union dictionary."""
    from spark_rapids_tpu_torch.batch import DictStringColumn
    from spark_rapids_tpu_torch.ops import batch_utils
    concat, seen = batch_utils.concat_batches, []

    def spy(batches):
        dicts = {id(b.columns[0].dictionary) for b in batches
                 if isinstance(b.columns[0], DictStringColumn)}
        seen.append(len(dicts))
        return concat(batches)
    monkeypatch.setattr(batch_utils, "concat_batches", spy)

    def q(s, F):
        a = s.create_dataframe(_table(6, 500))
        b = s.create_dataframe(_table(7, 500)).filter(F.col("k") > 2)
        ga = a.group_by("s").agg(F.sum(F.col("x")).alias("t"),
                                 F.count(F.col("v")).alias("c"))
        gb = b.group_by("s").agg(F.min(F.col("x")).alias("t"),
                                 F.count_star().alias("c"))
        return ga.union(gb).sort(F.col("t").desc(), F.col("c"))
    want, got, jq, tq = _both(q)
    _same_rows(got, want)
    lines = tq.explain_string().splitlines()[2:]
    assert lines == jq.explain_string().splitlines()[2:]
    assert lines[0].startswith("* Sort")
    assert 2 in seen
    strings = [r[0] for r in got]
    assert None in strings and "alpha" in strings


def test_union_explain_string_matches_reference():
    def q(s, F):
        a = s.create_dataframe(_table(8, 100)).group_by("k").agg(
            F.sum(F.col("x")).alias("t"))
        b = s.create_dataframe(_table(9, 100)).group_by("k").agg(
            F.max(F.col("x")).alias("t"))
        return a.union(b).limit(7)
    want, got, jq, tq = _both(q)
    assert len(got) == len(want) == 7
    assert tq.explain_string().splitlines()[2:] == \
        jq.explain_string().splitlines()[2:]


def test_union_grouped_above():
    def q(s, F):
        a = s.create_dataframe(_table(10, 300))
        b = s.create_dataframe(_table(11, 300))
        return a.union(b).group_by("k").agg(
            F.sum(F.col("x")).alias("t"), F.count(F.col("v")).alias("c"))
    want, got, _, _ = _both(q)
    _same_rows(got, want, ordered=False)


def test_union_nullability_and_type_check():
    tsess = tsrt.Session({}, device="cpu")
    a = tsess.create_dataframe({"k": np.arange(3), "x": np.ones(3)})
    b = tsess.create_dataframe({"k": np.array([7, None], dtype=object),
                                "x": np.ones(2)})
    u = a.union(b)
    assert [f.nullable for f in u.schema] == [True, False]
    assert u.collect() == [(0, 1.0), (1, 1.0), (2, 1.0), (7, 1.0),
                           (None, 1.0)]
    c = tsess.create_dataframe({"k": np.ones(3), "x": np.ones(3)})
    with pytest.raises(ValueError, match="union"):
        a.union(c).collect()


def test_union_row_estimate_is_the_branches_sum():
    tsess = tsrt.Session({}, device="cpu")
    a = tsess.create_dataframe({"k": np.arange(30)})
    b = tsess.create_dataframe({"k": np.arange(12)})
    assert cbo.estimate_rows(a.union(b)._plan) == 42.0
    assert cbo.estimate_rows(a.union(b).filter(TF.col("k") > 3)._plan) \
        == 21.0


def test_union_fetches():
    """The union adds no fetch: the two aggregations' outputs, sorted,
    cost what the sort and the collect cost."""
    tsess = tsrt.Session({}, device="cpu")
    a = tsess.create_dataframe(_table(12, 200)).group_by("k").agg(
        TF.sum(TF.col("x")).alias("t"))
    with TStats.scoped() as one:
        a.collect()
    with TStats.scoped() as two:
        a.union(a).collect()
    assert two.blocking_fetches <= 2 * one.blocking_fetches
