"""Time labels as numpy ``datetime64``, without pandas.

The JAX package handles time labels with pandas 3 (``pd.Timestamp``,
``pd.to_timedelta``, ``pd.to_datetime``, ``Timestamp.isoformat``), which
keeps each record's own resolution: seconds, milliseconds, microseconds or
nanoseconds, with coarser numpy units moved to seconds.  This module gives
the same labels in numpy, so that records outside ``datetime64[ns]``'s
1678-2262 keep their instants.  A value that its unit cannot hold raises;
nothing wraps.
"""
from __future__ import annotations

import re

import numpy as np

__all__ = ["as_labels", "cast_labels", "decode_cf", "isoformat",
           "parse_cf_origin"]

# a CF time origin: Y-M-D with unpadded fields (a year of 3 or 4 digits:
# pandas reads "1-1-1" as 2001-01-01, so shorter years are refused rather
# than read otherwise), an optional T or spaces and H:M[:S[.fraction]], an
# optional zone
_ORIGIN = re.compile(
    r"(\d{3,4})-(\d{1,2})-(\d{1,2})"
    r"(?:(?:T|\s+)(\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:\.(\d*))?)?)?"
    r"\s*(?:(Z|z|UTC|GMT)|([+-])(\d{2})(?::?(\d{2}))?)?")

_SPAN_SECONDS = {"seconds": 1, "minutes": 60, "hours": 3600, "days": 86400}

_INT64 = np.iinfo(np.int64)


def _fit(ints, unit: str, what: str) -> np.ndarray:
    """Python ints (an object array) as int64, raising where one does not
    fit a ``datetime64[unit]`` (the int64 minimum is NaT)."""
    ints = np.asarray(ints, dtype=object)
    if ints.size and (ints.max() > _INT64.max or ints.min() <= _INT64.min):
        raise OverflowError(f"{what} does not fit datetime64[{unit}]")
    return ints.astype(np.int64)


def parse_cf_origin(text: str) -> np.datetime64:
    """The UTC instant of a CF time origin, as ``pd.Timestamp(text)``
    followed by ``.values`` gives it: ``datetime64[us]``, or ``[ns]`` where
    the fraction has more than six digits (digits past the ninth are
    dropped, as pandas drops them).  A zone offset is subtracted.  Raises
    ``ValueError`` naming ``text`` where it cannot read it."""
    m = _ORIGIN.fullmatch(text.strip())
    if m is None:
        raise ValueError(f"cannot read the CF time origin {text!r}")
    year, month, day, hour, minute, sec, frac, _, sign, zh, zm = m.groups()
    hour, minute, sec = (int(x or 0) for x in (hour, minute, sec))
    zh, zm = int(zh or 0), int(zm or 0)
    if hour > 23 or minute > 59 or sec > 59 or zh > 23 or zm > 59:
        raise ValueError(f"cannot read the CF time origin {text!r}")
    try:
        date = np.datetime64(f"{int(year):04d}-{int(month):02d}-"
                             f"{int(day):02d}", "D")
    except ValueError:
        raise ValueError(f"cannot read the CF time origin {text!r}") from None
    frac = frac or ""
    unit, per_s = ("ns", 10 ** 9) if len(frac) > 6 else ("us", 10 ** 6)
    zone = (-1 if sign == "-" else 1) * (zh * 60 + zm) * 60
    seconds = int(date.astype(np.int64)) * 86400 + hour * 3600 \
        + minute * 60 + sec - zone
    ticks = seconds * per_s + int((frac + "0" * 9)[:len(str(per_s)) - 1])
    return np.datetime64(int(_fit([ticks], unit, repr(text))[0]), unit)


def decode_cf(values, units: str | None):
    """CF decode of ``"<span> since <origin>"`` (span: seconds, minutes,
    hours or days), as ``pd.Timestamp(origin) + pd.to_timedelta(values,
    unit=span)`` gives it in pandas 3: whole offsets are exact counts of the
    span, at the origin's resolution; where any offset has a fraction, the
    instants are nanoseconds, each offset cut into its whole part and its
    fraction rounded to the span's digits (pandas'
    ``cast_from_unit_vectorized``).  NaN decodes to NaT.  Other units come
    back unchanged."""
    if not units or " since " not in units:
        return values
    span, origin = units.split(" since ")
    step = _SPAN_SECONDS.get(span.strip().lower())
    if step is None:
        return values
    origin = parse_cf_origin(origin)
    x = np.asarray(values, dtype=np.float64)
    nan = np.isnan(x)
    x = np.where(nan, 0.0, x)
    with np.errstate(invalid="ignore"):
        whole = x.astype(np.int64)
    if (x == whole).all():
        unit = np.datetime_data(origin.dtype)[0]
        ticks = whole.astype(object) * (step * (10 ** 6 if unit == "us"
                                                else 10 ** 9))
    else:
        if (np.abs(x) >= 2.0 ** 63).any():
            raise OverflowError(f"offsets in {units!r} do not fit int64")
        unit, per_span = "ns", step * 10 ** 9
        frac = np.round(x - whole, len(str(per_span)) - 1)
        ticks = whole.astype(object) * per_span \
            + (frac * per_span).astype(np.int64).astype(object)
        origin = cast_labels(origin, np.dtype("M8[ns]"))
    ticks = ticks + int(origin.astype(np.int64))
    out = _fit(ticks, unit, f"a time in {units!r}").view(f"M8[{unit}]")
    out[nan] = np.datetime64("NaT")
    return out


def cast_labels(t, dtype: np.dtype):
    """``t.astype(dtype)`` for datetime64 labels, raising ``OverflowError``
    where the cast wraps (numpy does not check)."""
    t = np.asarray(t) if not isinstance(t, np.datetime64) else t
    out = t.astype(dtype)
    if out.dtype != t.dtype and np.any((out.astype(t.dtype) != t)
                                       & ~np.isnat(t)):
        raise OverflowError(f"time labels do not fit {dtype}")
    return out


def as_labels(values) -> np.ndarray:
    """Time labels as ``pd.to_datetime(values)`` gives them: datetime64 at
    its own resolution, moved to seconds where coarser; anything else as
    nanoseconds since 1970 (numpy's reading of numbers and ISO strings)."""
    t = np.asarray(values)
    if not np.issubdtype(t.dtype, np.datetime64):
        return t.astype("datetime64[ns]")
    return cast_labels(t, np.promote_types(t.dtype, np.dtype("M8[s]")))


def isoformat(t: np.datetime64) -> str:
    """``pd.Timestamp(t).isoformat(sep=" ")``: no fraction for a whole
    second, six digits for microseconds, nine where nanoseconds remain."""
    if np.isnat(t):
        return "NaT"
    whole = t.astype("M8[s]")
    ns = int((t - whole).astype("m8[ns]").astype(np.int64))
    frac = (f".{ns:09d}" if ns % 1000 else f".{ns // 1000:06d}") if ns \
        else ""
    return np.datetime_as_string(whole).replace("T", " ") + frac
