"""Port parity: the device expression VM (``query.expr.eval_expr``) against
the JAX package's, op by op and function by function.

Seeded numpy columns go to both: int32 ``a`` and ``b`` (zeros, negatives,
the int32 extremes), float32 ``f`` and ``g`` (zeros, negatives, halves,
values past the int32 range), int32 timestamps ``t`` (before and after
1970, near both ends of the int32 range) and an int32 weight. Every node
of ``eval_expr`` and every function of ``_call`` runs, with integer
division and remainder by zero, negative operands, float -> int32 casts
out of range and NaN, and FIBONACCI past the uint32 wrap; the host-only
nodes must raise ``ExprError`` in both.

Tolerance: exact (same dtype, same values, NaN where JAX has NaN) for the
integer results and for float +, -, *, /, SQRT and every cast. SIN, COS,
EXP, LN, LOG2, LOG10, POW, ATAN2 and GEODIST are held to 4 ulp: the two
sides call different libm code.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manticoresearch_tpu.query import expr as jax_expr
from manticoresearch_tpu_torch.query import expr as port_expr

torch.set_num_threads(2)

N = 64


def _columns() -> dict:
    rng = np.random.RandomState(5)
    a = rng.randint(-50, 50, N).astype(np.int32)
    a[:8] = [0, 1, -1, 7, -7, 2**31 - 1, -(2**31), 5]
    b = rng.randint(-6, 6, N).astype(np.int32)
    b[:8] = [0, 0, 0, 2, -2, -1, -1, 0]
    f = (rng.randn(N) * 100).astype(np.float32)
    f[:10] = [0.0, -2.5, 2.5, 0.5, -0.5, 3e9, -3e9, 1.5, np.nan, 1e-3]
    g = (rng.randn(N) * 3).astype(np.float32)
    g[:6] = [0.0, 2.0, -2.0, 0.0, 1.0, -0.75]
    t = rng.randint(-(2**31), 2**31 - 1, N, dtype=np.int64).astype(np.int32)
    t[:8] = [0, -1, 86399, -86400, 951782400, 1709251199, 2**31 - 1,
             -(2**31)]
    lat = rng.uniform(-1.5, 1.5, N).astype(np.float32)
    lon = rng.uniform(-3.1, 3.1, N).astype(np.float32)
    pos = np.abs(f) + np.float32(0.25)
    return dict(a=a, b=b, f=f, g=g, t=t, lat=lat, lon=lon, pos=pos)


COLS = _columns()
WEIGHT = np.random.RandomState(6).randint(0, 5000, N).astype(np.int32)

EXACT = [
    # constants, attributes, weight
    "3", "2.5", "3000000000", "-4", "A + 1", "weight() * 2", "@weight + a",
    # arithmetic (int32 wrap, int/float promotion)
    "a + b", "a - b", "a * b", "a * 2147483647", "a + 2147483647",
    "-a", "-f", "a + f", "f - g", "f * g", "a * 0.5", "a / b", "f / g",
    "a / 0", "1 / 3",
    # DIV and MOD (truncating / floor, divisors of zero)
    "a DIV b", "a DIV 0", "f DIV g", "a DIV f", "a % b", "a % 0",
    "a MOD b", "f % g", "f % 2", "a % g", "-7 % 2", "7 % -2",
    # logic, bitwise, comparisons
    "NOT a", "NOT f", "a AND b", "a OR b", "f AND g", "a & b", "a | b",
    "f & 7", "a | f", "a = b", "a != b", "a <> b", "a < b", "a <= b",
    "a > b", "a >= b", "a = f", "f < g", "f >= 1.5", "a BETWEEN -5 AND 5",
    "a IN (1, 7, -7)", "f IN (2.5, 1.5)",
    # casts and rounding
    "ABS(a)", "ABS(f)", "CEIL(f)", "FLOOR(f)", "CEIL(a)", "BIGINT(f)",
    "SINT(f)", "INTEGER(g)", "UINT(a)", "DOUBLE(a)", "DOUBLE(f)",
    "SQRT(pos)", "SQRT(a)",
    # MIN / MAX / LEAST / GREATEST, IF, IN, INTERVAL
    "MIN(a, b)", "MAX(a, f)", "MIN(f, g)", "LEAST(a, b, 3)",
    "GREATEST(f, a, -1)", "IF(a > 0, f, 2)", "IF(f, a, b)",
    "IF(a, 1, 2.5)", "IN(a, 0, 5)", "IN(f, 1.5, a)", "INTERVAL(a, -5, 0, 5)",
    "INTERVAL(f, 0.5, 100)",
    # IDIV (floor; by zero), MADD, MUL3, BITDOT, REMAP
    "IDIV(a, b)", "IDIV(a, 0)", "IDIV(f, g)", "IDIV(a, g)", "IDIV(0, 0)",
    "MADD(a, b, 3)", "MADD(f, 2, a)", "MUL3(a, b, a)", "MUL3(f, g, 2)",
    "BITDOT(a, 1, 2.5, b)", "BITDOT(b, f, g)",
    "REMAP(a, 100, (1, 7), (10, 70))", "REMAP(b, f, (0, 2), (0.5, 1.5))",
    # FIBONACCI past the uint32 wrap, from ints and floats
    "FIBONACCI(a)", "FIBONACCI(ABS(b) * 10)", "FIBONACCI(f)",
    "FIBONACCI(50)",
    # dates (floor division before 1970), from ints and floats
    "DAY(t)", "MONTH(t)", "YEAR(t)", "YEARMONTH(t)", "YEARMONTHDAY(t)",
    "WEEK(t)", "HOUR(t)", "MINUTE(t)", "SECOND(t)", "YEAR(f)", "HOUR(a)",
    "WEEK(a * 86400)",
    # nested
    "IF(a % 3 = 0, a DIV 3, MAX(b, -a)) + INTERVAL(f, 0) * 10",
    "(a + b) * (a - b) % 7 + (f > g)",
]

ULP4 = [
    "SIN(f)", "COS(f)", "EXP(g)", "LN(pos)", "LOG2(pos)", "LOG10(pos)",
    "LN(a)", "POW(pos, g)", "POW(2, b)", "ATAN2(f, g)", "ATAN2(a, b)",
    "SIN(a)", "COS(b)", "GEODIST(lat, lon, 0.5, 1.0)",
    "GEODIST(lat, lon, lon, lat)",
]

HOST_ONLY = ["j.x IS NULL", "ANY(x > 1 FOR x IN j.arr)", "'abc'", "id + 1",
             "CRC32(a)", "LENGTH(a)", "NOW()", "nosuch + 1",
             "CONCAT(a, b)", "GEODIST(lat, lon, 0.5, 1.0, {in=degrees})"]


def _jax(text: str):
    tree = jax_expr.parse_expr(text)
    attrs = {k: jnp.asarray(v) for k, v in COLS.items()}
    return np.asarray(jax_expr.eval_expr(tree, attrs, jnp.asarray(WEIGHT)))


def _port(text: str):
    tree = port_expr.parse_expr(text)
    attrs = {k: torch.from_numpy(v) for k, v in COLS.items()}
    out = port_expr.eval_expr(tree, attrs, torch.from_numpy(WEIGHT))
    return out.numpy()


def _ulps(x: np.ndarray) -> np.ndarray:
    """float32 -> int64 on a line where adjacent floats differ by 1."""
    b = x.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


@pytest.mark.parametrize("text", EXACT)
def test_exact_ops_match_jax(text):
    want = _jax(text)
    got = _port(text)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True), (got, want)


@pytest.mark.parametrize("text", ULP4)
def test_transcendental_ops_within_4_ulp(text):
    want = _jax(text)
    got = _port(text)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.array_equal(np.isinf(got[ok]), np.isinf(want[ok]))
    fin = ok & np.isfinite(want)
    assert np.abs(_ulps(got[fin]) - _ulps(want[fin])).max(initial=0) <= 4


@pytest.mark.parametrize("text", HOST_ONLY)
def test_host_only_nodes_raise_like_jax(text):
    with pytest.raises(jax_expr.ExprError):
        _jax(text)
    with pytest.raises(port_expr.ExprError):
        _port(text)


def test_constants_stay_zero_dim_on_the_attrs_device():
    attrs = {"a": torch.zeros(3, dtype=torch.int32)}
    out = port_expr.eval_expr(port_expr.parse_expr("1 + 2 * 3"), attrs)
    assert out.dim() == 0 and out.dtype == torch.int32 and int(out) == 7
    out = port_expr.eval_expr(port_expr.parse_expr("a + 0.5"), attrs)
    assert out.dtype == torch.float32 and out.shape == (3,)
