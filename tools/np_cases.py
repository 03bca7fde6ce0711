"""Sample calls of every ``mx.np`` name of the reference's tables, for
holding one implementation of the namespace against another on seeded
inputs.

``cases()`` gives one or more :class:`Case` per name of ``mx.np``'s
op tables (``_SIMPLE_OPS``, the creation functions), ``mx.np.linalg``'s
21 names and the callable-taking functions.  A case's arguments are
plain Python and numpy values; :func:`run` turns each numpy array among
them into an array of the namespace under test (``wrap``), resolves a
:class:`Fn` argument against that namespace, calls the op and brings
the result back to the host (:func:`to_host`), or names the exception
it raised.  :func:`agree` compares two such results at the case's
tolerance.

Used by ``tests/test_torch_numpy.py`` (the port against the JAX
package on the CPU) and ``chip_smoke.py`` phase 26 (the port on the
card against the port on the CPU).  Run it directly to print the case
count::

    python tools/np_cases.py
"""
from __future__ import annotations

import numpy as np


class Case:
    """One call: ``name`` (``'linalg.svd'`` for a submodule's), its
    positional and keyword arguments, the relative / absolute tolerance
    of its comparison, and whether a gradient check through it belongs
    to the sample (``grad``)."""

    __slots__ = ("name", "args", "kwargs", "rtol", "atol", "grad", "tag",
                 "oracle")

    def __init__(self, name, args, kwargs, rtol=1e-5, atol=1e-6,
                 grad=False, tag="", oracle="reference"):
        self.name, self.args, self.kwargs = name, args, kwargs
        self.rtol, self.atol, self.grad, self.tag = rtol, atol, grad, tag
        self.oracle = oracle

    @property
    def id(self):
        return self.name + (f"[{self.tag}]" if self.tag else "")

    def floating(self) -> bool:
        """Whether an array argument is floating point (a float op)."""
        return any(isinstance(a, np.ndarray) and a.dtype.kind == "f"
                   for a in _leaves((self.args, self.kwargs)))


class Fn:
    """An argument built from the namespace under test: ``make(np)``."""

    __slots__ = ("make",)

    def __init__(self, make):
        self.make = make


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def cases():
    """Every case, from one seeded generator (the same list each call)."""
    rs = np.random.RandomState(0)
    out = []

    def f(*shape, lo=-2.0, hi=2.0):
        return rs.uniform(lo, hi, shape).astype(np.float32)

    def i(*shape, lo=0, hi=10):
        return rs.randint(lo, hi, shape).astype(np.int32)

    def add(name, *args, rtol=1e-5, atol=1e-6, grad=False, tag="",
            oracle="reference", **kw):
        out.append(Case(name, args, kw, rtol, atol, grad, tag, oracle))

    # ---------------------------------------------------- element-wise
    pos = dict(lo=0.2, hi=3.0)
    for n in ("abs", "absolute", "square", "negative", "positive", "sign",
              "exp", "expm1", "exp2", "sin", "cos", "arctan", "sinh",
              "cosh", "tanh", "arcsinh", "deg2rad", "rad2deg", "degrees",
              "radians", "ceil", "floor", "rint", "trunc", "fix", "sinc",
              "i0", "real", "imag", "conj", "conjugate", "angle",
              "signbit", "logical_not", "round_", "cbrt"):
        add(n, f(3, 4), grad=n in ("exp", "tanh", "cbrt"), rtol=2e-5)
    for n in ("sqrt", "log", "log2", "log10", "log1p", "reciprocal", "tan"):
        add(n, f(3, 4, lo=0.2, hi=1.4), grad=n == "log")
    add("arcsin", f(3, 4, lo=-0.9, hi=0.9))
    add("arccos", f(3, 4, lo=-0.9, hi=0.9))
    add("arctanh", f(3, 4, lo=-0.9, hi=0.9))
    add("arccosh", f(3, 4, lo=1.1, hi=3.0))
    special = np.array([1.5, np.nan, np.inf, -np.inf, -2.0], np.float32)
    for n in ("isnan", "isinf", "isfinite", "isneginf", "isposinf"):
        add(n, special)
    add("nan_to_num", special)
    add("nan_to_num", special, nan=0.5, posinf=9.0, tag="values")
    add("around", f(3, 4), decimals=1)
    add("round", f(3, 4), 2)
    add("frexp", f(3, 4))
    add("modf", f(3, 4))
    add("invert", i(3, 4))
    for n in ("add", "subtract", "multiply", "divide", "true_divide",
              "power", "float_power", "logaddexp", "logaddexp2", "arctan2",
              "hypot", "maximum", "minimum", "fmax", "fmin", "copysign",
              "nextafter", "mod", "fmod", "remainder", "floor_divide",
              "equal", "not_equal", "greater", "greater_equal", "less",
              "less_equal", "logical_and", "logical_or", "logical_xor",
              "isclose", "divmod"):
        a, b = f(3, 4, **pos), f(4, **pos)
        if n in ("equal", "not_equal", "greater_equal", "less_equal"):
            b = a[1].copy()
        add(n, a, b, grad=n in ("divide", "power", "maximum", "arctan2"),
            rtol=2e-5)
    add("add", f(2, 3), 2.5, tag="scalar")
    add("multiply", 3.0, f(2, 3), tag="scalar")
    add("power", f(2, 3, **pos), 2, tag="scalar")
    add("mod", i(3, 4, lo=-9), i(4, lo=1, hi=5), tag="int")
    add("floor_divide", i(3, 4, lo=-9), i(4, lo=1, hi=5), tag="int")
    add("heaviside", np.array([-1.0, 0.0, 2.0], np.float32), 0.5)
    add("ldexp", f(3, 4), i(3, 4, lo=-3, hi=3))
    add("allclose", f(3, 4), f(3, 4))
    x = f(3, 4)
    add("allclose", x, x + 1e-7, tag="close")
    add("array_equal", x, x.copy())
    add("array_equal", x, f(3, 4), tag="differ")
    for n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        add(n, i(3, 4, hi=64), i(3, 4, hi=64))
    add("left_shift", i(3, 4, hi=64), i(3, 4, hi=4))
    add("right_shift", i(3, 4, hi=64), i(3, 4, hi=4))
    add("gcd", i(3, 4, lo=1, hi=60), i(3, 4, lo=1, hi=60))
    add("lcm", i(3, 4, lo=1, hi=12), i(3, 4, lo=1, hi=12))
    add("clip", f(3, 4), -0.5, 0.7, grad=True)

    # ------------------------------------------------------ reductions
    x = f(3, 4, 5)
    for n in ("sum", "prod", "mean", "min", "max", "amin", "amax"):
        add(n, x, grad=n == "prod", rtol=2e-5)
        add(n, x, axis=1, tag="axis", rtol=2e-5)
        add(n, x, axis=(0, 2), keepdims=True, tag="axes", rtol=2e-5)
    add("std", x, axis=1, grad=True, rtol=1e-4)
    add("std", x, ddof=1, tag="ddof", rtol=1e-4)
    add("var", x, axis=(0, 2), rtol=1e-4)
    add("var", x, ddof=1, keepdims=True, tag="ddof", rtol=1e-4)
    xn = f(3, 4)
    xn[0, 1] = np.nan
    xn[2, 3] = np.nan
    for n in ("nansum", "nanprod", "nanmean", "nanstd", "nanvar", "nanmin",
              "nanmax", "nanargmax", "nanargmin", "nancumsum",
              "nancumprod", "nanmedian"):
        add(n, xn, rtol=1e-4)
        add(n, xn, axis=1, tag="axis", rtol=1e-4)
    add("nanquantile", xn, 0.3, axis=1, rtol=1e-4)
    add("nanpercentile", xn, 30.0, rtol=1e-4)
    for n in ("argmax", "argmin"):
        add(n, x)
        add(n, x, axis=2, tag="axis")
    add("all", i(3, 4, hi=2))
    add("all", i(3, 4, hi=2), axis=0, tag="axis")
    add("any", i(3, 4, hi=2))
    add("any", i(3, 4, hi=2) * 0, axis=1, tag="axis")
    add("ptp", x, axis=1)
    add("median", x, grad=True)
    add("median", x, axis=1, tag="axis")
    add("quantile", x, 0.25, rtol=1e-4)
    add("quantile", x, np.array([0.1, 0.9], np.float32), axis=2, tag="qs",
        rtol=1e-4)
    add("percentile", x, 75.0, axis=0, rtol=1e-4)
    add("average", x, axis=1)
    add("average", f(4), weights=f(4, **pos), tag="weights")
    add("count_nonzero", i(3, 4, hi=3))
    add("count_nonzero", i(3, 4, hi=3), axis=1, tag="axis")
    add("cumsum", x, axis=1, grad=True, rtol=2e-5)
    add("cumsum", i(3, 4), tag="flat")
    add("cumprod", f(3, 4, **pos), axis=0, rtol=2e-5)
    add("cumulative_sum", f(3, 4), axis=1, rtol=2e-5)
    add("trapezoid", f(3, 5), rtol=2e-5)
    add("trapezoid", f(6), x=np.linspace(0, 1, 6).astype(np.float32),
        tag="x", rtol=2e-5)
    add("trapz", f(3, 5), dx=0.5, rtol=2e-5)

    # ------------------------------------------------- linear algebra-ish
    add("dot", f(3, 4), f(4, 5), rtol=1e-4)
    add("dot", f(4), f(4), tag="1d", rtol=1e-4)
    add("vdot", f(3, 4), f(3, 4), rtol=1e-4)
    add("inner", f(3, 4), f(2, 4), rtol=1e-4)
    add("outer", f(3), f(4))
    add("matmul", f(2, 3, 4), f(4, 5), grad=True, rtol=1e-4)
    add("tensordot", f(3, 4, 5), f(4, 5, 2), rtol=1e-4)
    add("tensordot", f(3, 4), f(4, 3), axes=1, tag="axes1", rtol=1e-4)
    add("einsum", "ij,jk->ik", f(3, 4), f(4, 2), grad=True, rtol=1e-4)
    add("einsum", "bij->bji", f(2, 3, 4), tag="transpose")
    add("kron", f(2, 3), f(3, 2))
    add("cross", f(4, 3), f(4, 3), rtol=1e-4)
    add("trace", f(4, 4))
    add("trace", f(3, 4, 4), axis1=1, axis2=2, offset=1, tag="axes")
    add("diagonal", f(4, 5), offset=1)
    add("diag", f(4, 4))
    add("diag", f(4), k=-1, tag="1d")
    add("diagflat", f(3))
    add("diag_indices", 3)

    # ------------------------------------------------------------ shapes
    x = f(2, 3, 4)
    add("reshape", x, (6, 4))
    add("reshape", x, (-1, 2), tag="infer")
    add("ravel", x)
    add("transpose", x)
    add("transpose", x, (2, 0, 1), tag="axes")
    add("swapaxes", x, 0, 2)
    add("moveaxis", x, 0, -1)
    add("rollaxis", x, 2)
    add("expand_dims", x, 1)
    add("squeeze", f(2, 1, 3, 1))
    add("squeeze", f(2, 1, 3, 1), axis=1, tag="axis")
    add("broadcast_to", f(3, 1), (2, 3, 4))
    add("broadcast_arrays", f(3, 1), f(1, 4))
    add("atleast_1d", np.float32(2.5))
    add("atleast_1d", f(3), tag="1d")
    add("atleast_2d", f(3))
    add("atleast_3d", f(3, 2))
    add("flip", x)
    add("flip", x, axis=1, tag="axis")
    add("fliplr", f(3, 4))
    add("flipud", f(3, 4))
    add("rot90", f(3, 4))
    add("rot90", f(3, 4), k=3, tag="k3")
    add("roll", x, 2)
    add("roll", x, -1, axis=2, tag="axis")
    add("tile", f(2, 3), (2, 2))
    add("repeat", f(2, 3), 2)
    add("repeat", f(2, 3), 3, axis=0, tag="axis")
    add("pad", f(2, 3), 1)
    add("pad", f(2, 3), ((1, 0), (0, 2)), mode="edge", tag="edge")
    add("pad", f(3, 4), 2, mode="reflect", tag="reflect")
    add("pad", f(2, 3), 1, constant_values=5.0, tag="value")
    add("flatnonzero", i(3, 4, hi=3))

    # ------------------------------------------------ joining / splitting
    a, b = f(2, 3), f(2, 3)
    add("concatenate", [a, b], grad=True)
    add("concatenate", [a, b], axis=1, tag="axis")
    add("stack", [a, b])
    add("stack", [a, b], axis=2, tag="axis")
    for n in ("vstack", "hstack", "dstack", "column_stack", "row_stack"):
        add(n, [a, b])
    add("hstack", [f(3), f(2)], tag="1d")
    add("split", f(6, 2), 3)
    add("split", f(6, 2), [1, 4], tag="sections")
    add("array_split", f(7, 2), 3)
    add("hsplit", f(2, 4), 2)
    add("vsplit", f(4, 2), 2)
    add("dsplit", f(2, 2, 4), 2)
    add("append", f(2, 3), f(1, 3), axis=0)
    add("append", f(2, 3), f(2), tag="flat")
    add("insert", f(5), 2, 9.0)
    add("insert", f(2, 3), 1, f(3), axis=0, tag="axis")
    add("delete", f(5), 1)
    add("delete", f(3, 4), 2, axis=1, tag="axis")
    add("resize", f(2, 3), (3, 4))

    # ------------------------------------------------ indexing / selection
    x = f(3, 4)
    add("where", x > 0, x, f(3, 4), grad=True)
    add("where", i(3, 4, hi=2), tag="nonzero")
    add("take", x, np.array([2, 0, 1], np.int32))
    add("take", x, np.array([[3, 0]], np.int32), axis=1, tag="axis")
    add("take_along_axis", x, rs.randint(0, 4, (3, 2)).astype(np.int32),
        axis=1)
    add("choose", i(3, 4, hi=3), [f(3, 4), f(3, 4), f(3, 4)])
    add("compress", np.array([1, 0, 1], bool), x, axis=0)
    add("extract", x > 0.2, x)
    add("searchsorted", np.sort(f(8)), f(5))
    add("searchsorted", np.sort(f(8)), f(5), side="right", tag="right")
    add("argwhere", i(3, 4, hi=3))
    add("nonzero", i(3, 4, hi=3))
    add("unravel_index", i(5, hi=24), (4, 6))
    add("ravel_multi_index", (i(5, hi=4), i(5, hi=6)), (4, 6))
    add("tril", f(4, 5))
    add("tril", f(4, 5), k=-1, tag="k")
    add("triu", f(4, 5), k=1)
    add("tril_indices", 4)
    add("tril_indices", 4, k=-1, m=5, tag="km")
    add("triu_indices", 4, k=1)
    add("indices", (2, 3))
    add("ix_", i(2, hi=5), i(3, hi=5))
    add("select", [x > 0.5, x < -0.5], [x, 2 * x], 7.0)
    add("piecewise", x, [x < 0, x >= 0], [-1.0, Fn(lambda np: (
        lambda v: v * 2.0))])
    add("put_along_axis", x, np.array([[0], [2], [1]], np.int32),
        f(3, 1), axis=1, inplace=False)

    # ----------------------------------------------------------- sorting
    x = f(3, 5)
    add("sort", x, grad=True)
    add("sort", x, axis=0, tag="axis")
    add("argsort", x)
    add("argsort", x, axis=None, tag="flat")
    add("lexsort", (i(6, hi=3), i(6, hi=3)))
    add("partition", f(7), 3)
    add("partition", x, 2, axis=1, tag="axis")
    add("argpartition", f(7), 3)

    # -------------------------------------------------------------- sets
    u = i(12, hi=6)
    add("unique", u)
    add("unique", u, return_counts=True, tag="counts")
    add("unique", u, return_index=True, return_inverse=True, tag="index")
    add("unique", i(4, 3, hi=3), axis=0, tag="axis")
    add("intersect1d", i(8, hi=6), i(8, hi=6))
    add("union1d", i(8, hi=6), i(8, hi=6))
    add("setdiff1d", i(8, hi=6), i(5, hi=6))
    add("setxor1d", i(8, hi=6), i(8, hi=6))
    add("in1d", i(8, hi=6), i(4, hi=6))
    add("isin", i(3, 4, hi=6), i(4, hi=6))

    # ------------------------------------------------- statistics / misc
    add("bincount", i(20, hi=6))
    add("bincount", i(20, hi=6), weights=f(20), minlength=8, tag="weights")
    add("digitize", f(10), np.linspace(-2, 2, 5).astype(np.float32))
    add("digitize", f(10), np.linspace(-2, 2, 5).astype(np.float32),
        right=True, tag="right")
    add("histogram", f(50), bins=5, range=(-2.0, 2.0))
    add("histogram", f(50), bins=np.array([-2, -1, 0, 0.5, 2], np.float32),
        tag="edges")
    add("histogram2d", f(40), f(40), bins=4)
    add("histogramdd", f(40, 2), bins=3)
    add("corrcoef", f(3, 8), rtol=1e-4, atol=1e-5)
    add("cov", f(3, 8), rtol=1e-4, atol=1e-5)
    add("cov", f(3, 8), rowvar=False, tag="cols", rtol=1e-4, atol=1e-5)
    add("convolve", f(6), f(3), rtol=1e-4, atol=1e-5)
    add("convolve", f(6), f(3), mode="same", tag="same", rtol=1e-4,
        atol=1e-5)
    add("correlate", f(6), f(3), rtol=1e-4, atol=1e-5)
    add("correlate", f(6), f(3), mode="full", tag="full", rtol=1e-4,
        atol=1e-5)
    xp = np.sort(f(6))
    add("interp", f(8), xp, f(6))
    add("gradient", f(6), rtol=1e-4)
    add("gradient", f(3, 4), tag="2d", rtol=1e-4)
    add("diff", f(3, 5), grad=True)
    add("diff", f(3, 5), n=2, axis=0, tag="n2")
    add("ediff1d", f(6))
    add("polyval", f(3), f(5), rtol=1e-4)
    xs = np.linspace(-1, 1, 9).astype(np.float32)
    add("polyfit", xs, 1 + 2 * xs - xs ** 2 + 0.01 * f(9), 2, rtol=1e-3,
        atol=1e-3)
    add("vander", f(4))
    add("vander", f(4), 3, increasing=True, tag="N")
    add("trim_zeros", np.array([0, 0, 1, 2, 0, 3, 0], np.float32))
    add("apply_along_axis", Fn(lambda np: (lambda r: np.sum(r * r))), 1,
        f(3, 4), rtol=2e-5)
    add("apply_over_axes", Fn(lambda np: np.sum), f(2, 3, 4), [0, 2],
        rtol=2e-5)
    # (the reference's block raises on arrays: numpy is its oracle)
    add("block", [[f(2, 2), f(2, 3)], [f(1, 2), f(1, 3)]], oracle="numpy")

    # ---------------------------------------------------- type utilities
    # (host-side; the reference's wrapper raises on most of these, so
    # numpy itself is their oracle)
    num = dict(oracle="numpy")
    add("result_type", f(2), i(2), **num)
    add("result_type", "float32", "int32", tag="names", **num)
    add("can_cast", "int32", "float32", **num)
    add("can_cast", "int8", "float32", tag="safe", **num)
    add("promote_types", "int32", "float32", **num)
    add("iinfo", "int32", **num)
    add("finfo", "float32", **num)
    add("isscalar", 3.0, **num)
    add("isscalar", f(2), tag="array", **num)
    add("ndim", f(2, 3), **num)
    add("shape", f(2, 3), **num)
    add("size", f(2, 3), **num)

    # ------------------------------------------------------- creation
    add("zeros", (2, 3))
    add("ones", 4)
    add("full", (2, 2), 7.0)
    add("empty", (0, 3))
    add("arange", 5)
    add("arange", 1.0, 3.0, 0.5, tag="float")
    add("linspace", 0.0, 1.0, 5)
    add("linspace", 0.0, 1.0, 4, endpoint=False, tag="open")
    add("logspace", 0.0, 2.0, 4, rtol=1e-4)
    add("geomspace", 1.0, 1000.0, 4, rtol=1e-4)
    add("eye", 3)
    add("eye", 3, 4, k=1, tag="k")
    add("identity", 3)
    add("tri", 3, 4)
    add("zeros_like", f(2, 3))
    add("ones_like", i(2, 3))
    add("full_like", f(2, 3), 2.5)
    add("empty_like", f(0, 2))
    add("meshgrid", f(3), f(2))
    add("meshgrid", f(3), f(2), indexing="ij", tag="ij")
    add("fromfunction", Fn(lambda np: (lambda a, b: a * 10 + b)), (2, 3))
    add("frombuffer", np.arange(6, dtype=np.float32).tobytes(),
        dtype=np.float32)
    add("copy", f(2, 3))
    add("asarray", f(2, 3))
    add("array", [[1, 2], [3, 4]], dtype="float32")

    # ------------------------------------------------------------ linalg
    m = f(4, 4)
    spd = (m @ m.T + 4 * np.eye(4)).astype(np.float32)
    add("linalg.norm", f(3, 4), grad=True, rtol=1e-4, atol=1e-5)
    add("linalg.norm", f(3, 4), axis=1, tag="axis", rtol=1e-4)
    add("linalg.norm", f(3, 4), ord="fro", tag="fro", rtol=1e-4)
    add("linalg.norm", f(5), ord=1, tag="ord1", rtol=1e-4)
    add("linalg.svd", f(4, 3), compute_uv=False, rtol=1e-4, atol=1e-5)
    add("linalg.svdvals", f(4, 3), rtol=1e-4, atol=1e-5)
    add("linalg.cholesky", spd, grad=True, rtol=1e-4, atol=1e-5)
    add("linalg.inv", spd, grad=True, rtol=1e-4, atol=1e-5)
    add("linalg.pinv", f(4, 3), rtol=1e-3, atol=1e-4)
    add("linalg.det", spd, grad=True, rtol=1e-4)
    add("linalg.slogdet", f(4, 4), rtol=1e-4, atol=1e-5)
    add("linalg.solve", spd, f(4, 2), grad=True, rtol=1e-4, atol=1e-5)
    add("linalg.lstsq", f(6, 3), f(6), rtol=1e-3, atol=1e-4)
    add("linalg.eigh", spd, rtol=1e-4, atol=1e-4, tag="vals")
    add("linalg.eigvalsh", spd, grad=True, rtol=1e-4, atol=1e-4)
    add("linalg.eigvals", spd, rtol=1e-4, atol=1e-4)
    add("linalg.eig", np.diag([3.0, 1.0, 2.0]).astype(np.float32),
        rtol=1e-4, atol=1e-4)
    add("linalg.matrix_rank", f(4, 3))
    add("linalg.matrix_power", f(3, 3), 3, rtol=1e-4, atol=1e-5)
    add("linalg.multi_dot", [f(2, 3), f(3, 4), f(4, 2)], rtol=1e-4,
        atol=1e-5)
    t = spd.reshape(4, 2, 2)
    add("linalg.tensorinv", spd.reshape(2, 2, 2, 2), ind=2, rtol=1e-3,
        atol=1e-4)
    add("linalg.tensorsolve", spd.reshape(2, 2, 2, 2), t[0], rtol=1e-3,
        atol=1e-4)
    add("linalg.cond", spd, rtol=1e-3)
    add("linalg.qr", f(4, 3), mode="r", rtol=1e-4, atol=1e-5)
    return out


# -------------------------------------------------------------- harness

def resolve(op_name, npmod):
    """The callable ``op_name`` names in namespace ``npmod``."""
    mod = npmod
    parts = op_name.split(".")
    for p in parts[:-1]:
        mod = getattr(mod, p)
    return getattr(mod, parts[-1])


def _args(x, npmod, wrap):
    if isinstance(x, np.ndarray):
        return wrap(x)
    if isinstance(x, Fn):
        return x.make(npmod)
    if isinstance(x, list):
        return [_args(v, npmod, wrap) for v in x]
    if isinstance(x, tuple):
        return tuple(_args(v, npmod, wrap) for v in x)
    if isinstance(x, dict):
        return {k: _args(v, npmod, wrap) for k, v in x.items()}
    return x


def to_host(x):
    """A result as host values: arrays (``asnumpy``) in nested lists;
    dtypes and other objects by their string."""
    if hasattr(x, "asnumpy"):
        return np.asarray(x.asnumpy())
    if isinstance(x, (list, tuple)):
        return [to_host(v) for v in x]
    if isinstance(x, (bool, int, float, np.number, np.bool_)):
        return np.asarray(x)
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, np.dtype) or (isinstance(x, type) and
                                   issubclass(x, np.generic)):
        return str(np.dtype(x))
    for attr in ("bits", "eps"):            # iinfo / finfo
        if hasattr(x, attr):
            return {k: str(getattr(x, k)) for k in ("bits", "min", "max",
                                                    "eps", "dtype")
                    if hasattr(x, k)}
    return str(x)


def run(case, npmod, wrap):
    """``("ok", host result)`` of ``case`` in namespace ``npmod`` (numpy
    arrays made arrays by ``wrap``), or ``("raise", exception name)``."""
    fn = resolve(case.name, npmod)
    try:
        res = fn(*_args(case.args, npmod, wrap),
                 **_args(case.kwargs, npmod, wrap))
        return "ok", to_host(res)
    except Exception as e:      # a case both sides refuse agrees
        return "raise", type(e).__name__


def agree(case, a, b, dtypes=True):
    """None when results ``a`` and ``b`` of ``case`` agree (values within
    the case's tolerance, same shapes, and with ``dtypes`` the same
    dtypes), else the first difference."""
    if a[0] != b[0]:
        return f"{case.id}: {a[0]} {a[1] if a[0] == 'raise' else ''} " \
               f"against {b[0]} {b[1] if b[0] == 'raise' else ''}"
    if a[0] == "raise":
        return None
    return _same(case, a[1], b[1], case.id, dtypes)


def _same(case, x, y, where, dtypes):
    if isinstance(x, list) or isinstance(y, list):
        if not (isinstance(x, list) and isinstance(y, list)) or \
                len(x) != len(y):
            return f"{where}: structure {_kind(x)} against {_kind(y)}"
        for k, (u, v) in enumerate(zip(x, y)):
            d = _same(case, u, v, f"{where}[{k}]", dtypes)
            if d:
                return d
        return None
    if isinstance(x, np.ndarray) and isinstance(y, np.ndarray):
        if x.shape != y.shape:
            return f"{where}: shape {x.shape} against {y.shape}"
        if dtypes and x.dtype != y.dtype:
            return f"{where}: dtype {x.dtype} against {y.dtype}"
        if x.dtype.kind in "fc" or y.dtype.kind in "fc":
            wide = np.complex128 if "c" in (x.dtype.kind, y.dtype.kind) \
                else np.float64
            if not np.allclose(x.astype(wide), y.astype(wide),
                               rtol=case.rtol, atol=case.atol,
                               equal_nan=True):
                err = np.nanmax(np.abs(x.astype(wide) - y.astype(wide))) \
                    if x.size else 0.0
                return f"{where}: values differ by {err:.3g}"
        elif not np.array_equal(x, y):
            return f"{where}: values {x.ravel()[:6]} against " \
                   f"{y.ravel()[:6]}"
        return None
    if x != y:
        return f"{where}: {x!r} against {y!r}"
    return None


def _kind(x):
    return f"list of {len(x)}" if isinstance(x, list) else type(x).__name__


if __name__ == "__main__":
    cs = cases()
    print(f"{len(cs)} cases over {len({c.name for c in cs})} names")
