"""Comparisons of two string operands over different columns, in the port
against the JAX reference's Session on the same numpy inputs: ``=``,
``!=``, ``<``, ``<=``, ``>`` and ``>=`` of two raw columns, of a substring
of each side and of a column against a substring, with nulls on either
side, in a filter and in a projection, over two scans of one table and
with a group key against a scan column.

The port compares strings, never the codes of two dictionaries
(``plan/stringpred.py StringPairCompare``: each side as dictionary codes,
compared as ranks in the union of the two dictionaries).  Before it, a
comparison of two substrings compared two booleans (every row equal) and
one of two raw columns raised.  The port runs on the CPU."""

import numpy as np
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql import functions as JF
import spark_rapids_tpu_torch as tsrt
from spark_rapids_tpu_torch.plan import stringpred
from spark_rapids_tpu_torch.sql import functions as TF

OPS = {"eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
       "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
       "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b}
# the operands: both columns, a substring of each, a column against a
# substring (positions 2.. of y: 'ab' against 'bc' of 'abc')
FORMS = {"columns": lambda F: (F.col("x"), F.col("y")),
         "substrings": lambda F: (F.col("x").substr(1, 2),
                                  F.col("y").substr(1, 2)),
         "column_substring": lambda F: (F.col("x"),
                                        F.col("y").substr(2, 3))}


def _sides(n, seed):
    """Two tables keyed 0..n-1 whose strings share prefixes, differ in
    length and case, hold a non-ASCII letter and are null in places."""
    rng = np.random.default_rng(seed)
    words = np.array(["ab", "abc", "abd", "b", "ba", "Ab", "", "zz", "é",
                      "ée", "abcd", "bc"], dtype=object)
    x = words[rng.integers(0, len(words), n)].astype(object)
    y = words[rng.integers(0, len(words), n)].astype(object)
    x[rng.random(n) < 0.15] = None
    y[rng.random(n) < 0.15] = None
    return {"k": np.arange(n), "x": x}, {"k": np.arange(n), "y": y}


def _joined(sess, n=400, seed=7):
    a, b = _sides(n, seed)
    return sess.create_dataframe(a).join(sess.create_dataframe(b), on="k")


def _both(build):
    jsess = jsrt.Session({"spark.rapids.tpu.sql.batchSizeRows": 128})
    tsess = tsrt.Session({"spark.rapids.tpu.sql.batchSizeRows": 128},
                         device="cpu")
    return sorted(build(jsess, JF)), sorted(build(tsess, TF),
                                            key=lambda r: r[0])


def _null_last(row):
    return tuple((x is None, x) for x in row)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("op", list(OPS))
def test_compare_in_a_filter_matches_reference(op, form):
    def q(sess, F):
        left, right = FORMS[form](F)
        return _joined(sess).filter(OPS[op](left, right)) \
            .select("k", "x", "y").collect()
    want, got = _both(q)
    assert want  # the inputs make every comparison keep some rows
    assert got == want


@pytest.mark.parametrize("op", list(OPS))
def test_compare_in_a_projection_matches_reference(op):
    def q(sess, F):
        left, right = FORMS["substrings"](F)
        return _joined(sess).select(
            "k", OPS[op](F.col("x"), F.col("y")).alias("raw"),
            OPS[op](left, right).alias("sub")).collect()
    want, got = _both(q)
    assert sorted(got, key=_null_last) == sorted(want, key=_null_last)
    assert any(r[1] is None for r in got) and any(r[1] for r in got)


def test_four_rows_of_the_fault():
    """x = b, a, c, d against y = a, a, c, z: != keeps rows 0 and 3 over
    the columns and over their first letters, = keeps rows 1 and 2."""
    def q(sess, F):
        a = sess.create_dataframe({"i": np.arange(4),
                                   "x": np.array(["b", "a", "c", "d"])})
        b = sess.create_dataframe({"j": np.arange(4),
                                   "y": np.array(["a", "a", "c", "z"])})
        j = a.join(b, on=[("i", "j")])
        sub = (F.col("x").substr(1, 1), F.col("y").substr(1, 1))
        return [sorted(r[0] for r in j.filter(c).select("i").collect())
                for c in (F.col("x") != F.col("y"), sub[0] != sub[1],
                          sub[0] == sub[1])]
    want, got = _both(q)
    assert got == want == [[0, 3], [0, 3], [1, 2]]


def test_two_scans_of_one_table():
    """One table scanned twice (a self join): each scan codes its strings
    in its own dictionary, so the two sides' codes differ for one
    string."""
    def q(sess, F):
        a, _ = _sides(300, 11)
        t = sess.create_dataframe(a)
        u = sess.create_dataframe(a).select(
            (F.col("k") + 1).alias("k2"), F.col("x").alias("x2"))
        return t.join(u, on=[("k", "k2")]) \
            .filter(F.col("x") < F.col("x2")).select("k").collect()
    want, got = _both(q)
    assert want and got == want


def test_group_key_against_a_scan_column():
    """A string group key (codes from the aggregate) against a column of
    another scan, as ds_q46's ``ca_city != bought_city``."""
    def q(sess, F):
        a, b = _sides(500, 13)
        g = sess.create_dataframe(a).group_by(
            "k", F.col("x").alias("bought")).agg(F.count_star().alias("n"))
        return g.join(sess.create_dataframe(b), on="k") \
            .filter(F.col("bought") != F.col("y")) \
            .select("k", "bought", "y", "n").collect()
    want, got = _both(q)
    assert want and got == want


def test_union_ranks_follow_code_point_order():
    """The merged dictionary orders strings by code point (UTF-8 byte
    order), so ranks compare as the strings do."""
    left = np.array(["b", "é", "a", "Z"], dtype=object)
    right = np.array(["ab", "b", "ée"], dtype=object)
    lr, rr = stringpred._union_ranks(left, right, torch.device("cpu"))
    union = sorted(set(left) | set(right))
    assert lr.tolist() == [union.index(s) for s in left] + [0]
    assert rr.tolist() == [union.index(s) for s in right] + [0]


def test_join_on_a_grid_aggregates_string_key():
    """A string group key that the grid aggregate produces over another
    aggregate's codes (with no null key, its null slot is a dead row of
    code len(dictionary)) as a join key against another scan's strings:
    the codes are remapped into the join's dictionary without reading past
    the remap table (ds_q12's per-class join)."""
    def q(sess, F):
        a, _ = _sides(300, 17)
        a["x"] = np.where([v is None for v in a["x"]], "ab", a["x"])
        per = sess.create_dataframe(a).group_by(
            "x", (F.col("k") % 3).alias("m")).agg(
            F.sum(F.col("k")).alias("t")).group_by(
            F.col("x").alias("cls")).agg(F.sum(F.col("t")).alias("s"))
        dim = sess.create_dataframe({"y": np.array(["ab", "b", "é", "zz"]),
                                     "w": np.arange(4)})
        return per.join(dim, on=[("cls", "y")]).select("cls", "s", "w") \
            .collect()
    want, got = _both(q)
    assert want and got == want
