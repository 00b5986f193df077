"""Kubernetes resource.Quantity semantics.

The reference engine does all resource arithmetic on int64s extracted from
`resource.Quantity` (vendor/k8s.io/apimachinery/pkg/api/resource): CPU via
``MilliValue()`` (rounded up to the nearest milli-core) and everything else via
``Value()`` (rounded up to the nearest whole unit). This module reproduces the
parsing grammar (sign, decimal digits, optional fraction, and a binary-SI /
decimal-SI / decimal-exponent suffix) and the two integer views, using exact
Fraction arithmetic so "100m", "0.1", and "1e-1" all agree.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
import re

_BINARY_SUFFIXES = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}

_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<exp>[eE][+-]?\d+)|(?P<suffix>[A-Za-z]{0,2}))$"
)


class Quantity:
    """Immutable exact quantity with k8s Value()/MilliValue() views."""

    __slots__ = ("_frac", "_text", "_value", "_milli")

    def __init__(self, value, text: str | None = None):
        if isinstance(value, Quantity):
            self._frac = value._frac
            self._text = text if text is not None else value._text
        elif isinstance(value, Fraction):
            self._frac = value
            self._text = text
        elif isinstance(value, (int, float, str)):
            q = parse_quantity(value)
            self._frac = q._frac
            self._text = text if text is not None else q._text
        else:
            raise TypeError(f"cannot build Quantity from {type(value)}")
        # integer views are lazily computed once: the engine reads them per
        # pod per scheduling pass, and Fraction math is the host-compile
        # hot path at 100k+ pods
        self._value = None
        self._milli = None

    # --- integer views (reference: resource.Quantity.Value/MilliValue) ---

    def value(self) -> int:
        """Round up to the nearest integer (k8s Value())."""
        if self._value is None:
            self._value = _ceil(self._frac)
        return self._value

    def milli_value(self) -> int:
        """Round up to the nearest 1/1000 (k8s MilliValue())."""
        if self._milli is None:
            self._milli = _ceil(self._frac * 1000)
        return self._milli

    def is_zero(self) -> bool:
        return self._frac == 0

    @property
    def fraction(self) -> Fraction:
        return self._frac

    # --- arithmetic ---

    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self._frac + _as_frac(other))

    def __sub__(self, other: "Quantity") -> "Quantity":
        return Quantity(self._frac - _as_frac(other))

    def __neg__(self) -> "Quantity":
        return Quantity(-self._frac)

    def __eq__(self, other) -> bool:
        return isinstance(other, (Quantity, int, Fraction)) and self._frac == _as_frac(other)

    def __lt__(self, other) -> bool:
        return self._frac < _as_frac(other)

    def __le__(self, other) -> bool:
        return self._frac <= _as_frac(other)

    def __hash__(self):
        return hash(self._frac)

    # --- printing (canonical-ish; keeps original text when available) ---

    def __str__(self) -> str:
        if self._text is not None:
            return self._text
        return format_quantity(self._frac)

    def __repr__(self) -> str:
        return f"Quantity({str(self)!r})"


def _as_frac(x) -> Fraction:
    if isinstance(x, Quantity):
        return x._frac
    if isinstance(x, (int, Fraction)):
        return Fraction(x)
    raise TypeError(f"cannot compare Quantity with {type(x)}")


def _ceil(f: Fraction) -> int:
    """k8s Value()/MilliValue() round away from zero (resource/math.go), so
    fractional negatives get more negative: -0.5 -> -1."""
    if f.numerator >= 0:
        return -((-f.numerator) // f.denominator)
    return f.numerator // f.denominator


def parse_quantity(s) -> Quantity:
    """Parse a k8s quantity literal (str) or bare number (int/float).
    String parses are memoized — workloads repeat a handful of literals
    across 100k+ pods, and Quantity is immutable so sharing is safe."""
    if isinstance(s, Quantity):
        return s
    if isinstance(s, int):
        return Quantity(Fraction(s), text=str(s))
    if isinstance(s, float):
        return Quantity(Fraction(str(s)), text=None)
    return _parse_str(str(s))


@lru_cache(maxsize=65536)
def _parse_str(text: str) -> Quantity:
    text = text.strip()
    m = _QUANTITY_RE.match(text)
    if not m:
        raise ValueError(f"invalid quantity: {text!r}")
    num = Fraction(m.group("num"))
    if m.group("sign") == "-":
        num = -num
    exp = m.group("exp")
    if exp:
        e = int(exp[1:])
        num *= Fraction(10) ** e
    else:
        suffix = m.group("suffix") or ""
        if suffix in _BINARY_SUFFIXES:
            num *= _BINARY_SUFFIXES[suffix]
        elif suffix in _DECIMAL_SUFFIXES:
            num *= _DECIMAL_SUFFIXES[suffix]
        else:
            raise ValueError(f"invalid quantity suffix: {text!r}")
    return Quantity(num, text=text)


def format_quantity(f: Fraction) -> str:
    """Canonical decimal-SI-ish formatting, good enough for reports."""
    if f.denominator == 1:
        n = f.numerator
        for suffix in ("E", "P", "T", "G", "M", "k"):
            factor = _DECIMAL_SUFFIXES[suffix]
            if n != 0 and Fraction(n) % factor == 0 and abs(n) >= factor:
                return f"{n // int(factor)}{suffix}"
        return str(n)
    milli = f * 1000
    if milli.denominator == 1:
        return f"{milli.numerator}m"
    return str(float(f))


def milli_value(v) -> int:
    """MilliValue of a quantity literal (None -> 0)."""
    if v is None:
        return 0
    return parse_quantity(v).milli_value()


def int_value(v) -> int:
    """Value of a quantity literal (None -> 0)."""
    if v is None:
        return 0
    return parse_quantity(v).value()
