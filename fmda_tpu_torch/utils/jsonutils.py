"""JSON and dict normalisation of API payloads, as
``fmda_tpu.utils.jsonutils`` defines it: keys sanitised (``"1. open"`` ->
``"1_open"``) and numeric strings coerced, through nested containers."""

from __future__ import annotations

from typing import Any


def change_keys(obj: Any, old: str, new: str) -> Any:
    """Replace ``old`` with ``new`` in every dict key, recursively."""
    if isinstance(obj, dict):
        return {k.replace(old, new): change_keys(v, old, new)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return type(obj)(change_keys(v, old, new) for v in obj)
    return obj


def to_number(value: Any) -> Any:
    """A string as int (all digits) or float; anything else unchanged."""
    if not isinstance(value, str):
        return value
    if value.isdigit():
        return int(value)
    try:
        return float(value)
    except ValueError:
        return value


def values_to_numbers(obj: Any) -> Any:
    """Coerce the numeric strings inside nested containers."""
    if isinstance(obj, dict):
        return {k: values_to_numbers(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return type(obj)(values_to_numbers(v) for v in obj)
    return to_number(obj)
