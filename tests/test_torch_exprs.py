"""The port's expression families held against the JAX package's on the
same seeded columns: comparisons, Kleene AND/OR/NOT, arithmetic with
int→double promotion and null-on-division-by-zero, date literals, casts
and null literals; IN, IS [NOT] NULL, IF, CASE WHEN, COALESCE, unary
minus, abs, % and pmod, and ``year`` over dates before and after the
epoch; the host string functions LIKE and substring, nulls included.  Results must agree exactly: the same IEEE operations
run on the same float64 values, and validity masks must be equal."""

import datetime
import importlib

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
        "e": (rng.integers(-800_000, 800_000, N).astype(np.int32),
              rng.random(N) < 0.9),
    }


_KINDS = {"i32": "INT32", "i64": "INT64", "f64": "FLOAT64", "g64": "FLOAT64",
          "b": "BOOLEAN", "d": "DATE", "e": "DATE"}


def _year(E, c):
    """``year(c)`` from the datetime module of ``E``'s package."""
    dt = importlib.import_module(E.__name__.rsplit(".", 1)[0]
                                 + ".datetimefns")
    return dt.Year(c)

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
    "in_int": lambda E, T, c: E.In(c("i32"), [1, 2, -3]),
    "in_with_null": lambda E, T, c: E.In(c("i32"), [1, None]),
    "in_double": lambda E, T, c: E.In(c("g64"), [1.5, 0.0]),
    "in_date": lambda E, T, c: E.In(c("d"), [D1, datetime.date(1995, 6, 1)]),
    "is_null": lambda E, T, c: E.IsNull(c("f64")),
    "is_null_no_mask": lambda E, T, c: E.IsNull(c("i64")),
    "is_not_null": lambda E, T, c: E.IsNotNull(c("i32")),
    "if_with_nulls": lambda E, T, c: E.If(c("b"), c("f64"), c("i32")),
    "case_when": lambda E, T, c: E.CaseWhen(
        [(E.LessThan(c("i32"), E.Literal(0)), c("f64")),
         (c("b"), E.Literal(1.0))], E.Literal(0.0)),
    "case_when_no_else": lambda E, T, c: E.CaseWhen([(c("b"), c("i32"))]),
    "coalesce": lambda E, T, c: E.Coalesce(c("f64"), c("i32"),
                                           E.Literal(0.0)),
    "coalesce_nullable": lambda E, T, c: E.Coalesce(c("f64"), c("i32")),
    "unary_minus": lambda E, T, c: E.UnaryMinus(c("i64")),
    "abs_double": lambda E, T, c: E.Abs(c("f64")),
    "abs_int": lambda E, T, c: E.Abs(c("i32")),
    "remainder_long_int": lambda E, T, c: E.Remainder(c("i64"), c("i32")),
    "remainder_double": lambda E, T, c: E.Remainder(c("f64"), c("g64")),
    "pmod_long_int": lambda E, T, c: E.Pmod(c("i64"), c("i32")),
    "pmod_double": lambda E, T, c: E.Pmod(c("f64"), E.Literal(7.0)),
    "year": lambda E, T, c: _year(E, c("d")),
    "year_around_epoch": lambda E, T, c: _year(E, c("e")),
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


STRINGS = np.array(["part 7 goldenrod", "PROMO BRUSHED", "13-555-1234",
                    "", "a_b%c", "x", None, "31-2", "goldenrod",
                    "PROMO"], dtype=object)


@pytest.mark.parametrize("make", [
    lambda S, E, c: S.Like(c, "%goldenrod%"),
    lambda S, E, c: S.Like(c, "PROMO%"),
    lambda S, E, c: S.Like(c, "%rod"),
    lambda S, E, c: S.Like(c, "_3-%"),
    lambda S, E, c: S.Like(c, "a\\_b\\%c"),
    lambda S, E, c: S.Substring(c, E.Literal(1), E.Literal(2)),
    lambda S, E, c: S.Substring(c, E.Literal(0), E.Literal(3)),
    lambda S, E, c: S.Substring(c, E.Literal(4), E.Literal(100)),
    lambda S, E, c: S.Substring(c, E.Literal(-3), E.Literal(2)),
    lambda S, E, c: S.Substring(c, E.Literal(2), E.Literal(-1)),
], ids=["like_contains", "like_prefix", "like_suffix", "like_underscore",
        "like_escape", "substring_prefix", "substring_pos0",
        "substring_tail", "substring_from_end", "substring_negative_len"])
def test_host_string_functions_match_reference(make):
    """LIKE and substring as the port's stage evaluates them (once per
    distinct value, ``plan/stringpred.py``) against the reference's
    row-by-row ``eval_host``; a null row is null in both."""
    from spark_rapids_tpu import stringfns as JS
    from spark_rapids_tpu_torch import stringfns as TS
    from spark_rapids_tpu_torch.plan.stringpred import _eval_host
    jcol = JE.BoundReference(0, JT.STRING, True, "s")
    tcol = TE.BoundReference(0, TT.STRING, True, "s")
    je, te = make(JS, JE, jcol), make(TS, TE, tcol)
    assert str(te.dtype) == str(je.dtype)
    valid = np.array([x is not None for x in STRINGS])
    n = len(STRINGS)

    def ev(e):  # the column, or a literal argument
        if isinstance(e, JE.BoundReference):
            return STRINGS, valid
        return np.full(n, e.value, dtype=object), None
    jd, jv = je.eval_host(ev, n)
    jv = np.ones(n, dtype=bool) if jv is None else jv
    td, tv = _eval_host(te, STRINGS, valid)
    np.testing.assert_array_equal(tv, jv)
    assert [str(x) for x in td[tv]] == [str(x) for x in jd[jv]]
