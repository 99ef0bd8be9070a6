"""The port's expression families held against the JAX package's on the
same seeded columns: comparisons, Kleene AND/OR/NOT, arithmetic with
int→double promotion and null-on-division-by-zero, date literals, casts
and null literals.  Results must agree exactly: the same IEEE operations
run on the same float64 values, and validity masks must be equal."""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (enables jax x64)
from spark_rapids_tpu import batch as jb
from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu_torch import batch as tb
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import types as TT

N = 257
D1, D2 = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)


def _columns():
    rng = np.random.default_rng(20260101)
    f64 = rng.normal(size=N) * 1e3
    f64[:6] = [np.nan, np.inf, -np.inf, 3e10, -3e10, -0.0]
    return {
        "i32": (rng.integers(-3, 4, N).astype(np.int32), rng.random(N) < 0.8),
        "i64": (rng.integers(-10**12, 10**12, N), None),
        "f64": (f64, rng.random(N) < 0.9),
        "g64": (rng.choice(np.array([0.0, 1.5, -2.0]), N), None),
        "b": (rng.random(N) < 0.5, rng.random(N) < 0.7),
        "d": (rng.integers(8000, 11000, N).astype(np.int32),
              rng.random(N) < 0.9),
    }


_KINDS = {"i32": "INT32", "i64": "INT64", "f64": "FLOAT64", "g64": "FLOAT64",
          "b": "BOOLEAN", "d": "DATE"}

CASES = {
    "eq_int_double": lambda E, T, c: E.EqualTo(c("i32"), c("g64")),
    "lt_int_literal": lambda E, T, c: E.LessThan(c("i32"), E.Literal(1)),
    "le_date_literal": lambda E, T, c: E.LessThanOrEqual(
        c("d"), E.Literal(datetime.date(1998, 9, 2))),
    "date_window": lambda E, T, c: E.And(
        E.GreaterThanOrEqual(c("d"), E.Literal(D1)),
        E.LessThan(c("d"), E.Literal(D2))),
    "ge_double_literal": lambda E, T, c: E.GreaterThanOrEqual(
        c("f64"), E.Literal(0.05)),
    "gt_long_int": lambda E, T, c: E.GreaterThan(c("i64"), c("i32")),
    "and_with_nulls": lambda E, T, c: E.And(
        c("b"), E.LessThan(c("f64"), E.Literal(0.0))),
    "or_with_nulls": lambda E, T, c: E.Or(
        c("b"), E.GreaterThan(c("i32"), E.Literal(1))),
    "not_with_nulls": lambda E, T, c: E.Not(c("b")),
    "add_int_double": lambda E, T, c: E.Add(c("i32"), c("f64")),
    "sub_literal": lambda E, T, c: E.Subtract(E.Literal(1), c("f64")),
    "q1_charge": lambda E, T, c: E.Multiply(
        E.Multiply(c("f64"), E.Subtract(E.Literal(1), c("g64"))),
        E.Add(E.Literal(1), c("g64"))),
    "div_by_zero_is_null": lambda E, T, c: E.Divide(c("i64"), c("i32")),
    "div_double": lambda E, T, c: E.Divide(c("f64"), c("g64")),
    "div_not_null_by_zero": lambda E, T, c: E.Divide(c("i64"), c("g64")),
    "int_add_wraps": lambda E, T, c: E.Add(c("i32"),
                                           E.Literal(2**31 - 1)),
    "long_mul_wraps": lambda E, T, c: E.Multiply(c("i64"), c("i64")),
    "cast_int_double": lambda E, T, c: E.Cast(c("i32"), T.FLOAT64),
    "cast_double_int": lambda E, T, c: E.Cast(c("f64"), T.INT32),
    "cast_long_int_wraps": lambda E, T, c: E.Cast(c("i64"), T.INT32),
    "cast_double_bool": lambda E, T, c: E.Cast(c("g64"), T.BOOLEAN),
    "null_literal": lambda E, T, c: E.Add(c("i32"), E.Literal(None)),
}


def _evaluate(pkg: str, name: str, ansi: bool = False):
    cols = _columns()
    if pkg == "jax":
        E, T, B = JE, JT, jb
        wrap = jnp.asarray
    else:
        E, T, B = TE, TT, tb
        wrap = torch.from_numpy
    schema = B.Schema([B.Field(n, getattr(T, _KINDS[n]), v is not None)
                       for n, (_, v) in cols.items()])
    expr = E.bind(CASES[name](E, T, E.UnresolvedColumn), schema)
    arrays = [(wrap(np.ascontiguousarray(d)),
               None if v is None else wrap(v)) for d, v in cols.values()]
    if pkg == "jax":
        ctx = E.EvalContext(arrays, N, ansi=ansi)
    else:
        ctx = E.EvalContext(arrays, N, torch.device("cpu"), ansi=ansi)
    data, valid = expr.eval(ctx)
    data = np.broadcast_to(np.asarray(data), (N,))
    valid = (np.ones(N, dtype=bool) if valid is None
             else np.broadcast_to(np.asarray(valid), (N,)))
    errors = np.zeros(N, dtype=bool)
    for e in ctx.errors:
        errors |= np.broadcast_to(np.asarray(e), (N,))
    return expr, data, valid, errors


@pytest.mark.parametrize("name", sorted(CASES))
def test_expression_matches_reference(name):
    je, jd, jv, _ = _evaluate("jax", name)
    te, td, tv, _ = _evaluate("torch", name)
    assert str(te.dtype) == str(je.dtype)
    np.testing.assert_array_equal(tv, jv)
    assert td.dtype == jd.dtype
    np.testing.assert_array_equal(td[jv], jd[jv])


@pytest.mark.parametrize("name", sorted(CASES))
def test_nullable_covers_every_null_the_port_makes(name):
    """The grid aggregation lays out its accumulator from ``nullable``
    before the first batch, so an expression that yields a null must say
    that it can."""
    expr, _, valid, _ = _evaluate("torch", name)
    assert expr.nullable or valid.all()


@pytest.mark.parametrize("name", ["div_by_zero_is_null", "cast_double_int"])
def test_ansi_error_rows_match_reference(name):
    *_, jerr = _evaluate("jax", name, ansi=True)
    *_, terr = _evaluate("torch", name, ansi=True)
    assert jerr.any()
    np.testing.assert_array_equal(terr, jerr)


def test_from_numpy_types_match_reference_create_dataframe():
    """The same numpy dict gives the same logical schema in both packages
    (strings, dates, nullable object columns)."""
    import spark_rapids_tpu as jsrt
    data = {
        "s": np.array(["a", "b", "a"]),
        "d": np.array(["1994-01-01", "1995-06-30", "1970-01-01"],
                      dtype="datetime64[D]"),
        "f": np.array([1.5, None, 2.0], dtype=object),
        "k": np.array(["x", None, "y"], dtype=object),
        "i": np.arange(3, dtype=np.int32),
    }
    jdf = jsrt.Session({}).create_dataframe(data)
    batch = tb.from_numpy(data, "cpu")
    assert [(f.name, str(f.dtype)) for f in batch.schema] == \
        [(f.name, str(f.dtype)) for f in jdf.schema]
    assert batch.column("d").data.tolist() == [8766, 9311, 0]
    assert batch.column("f").valid.tolist() == [True, False, True]
    assert batch.column("k").valid.tolist() == [True, False, True]
