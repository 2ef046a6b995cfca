"""Attribute system (paper §2.2).

Every resource has a set of tunable parameters called *attributes*.
Defaults are specified at global scope (here: env vars ``LCX_ATTR_<NAME>``
or :func:`set_global_attr`), and per-resource values are given at
allocation time.  Resources expose ``get_attr_<name>()`` query methods —
implemented once here via ``__getattr__`` dispatch on :class:`HasAttrs`.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

_GLOBAL_ATTRS: Dict[str, Any] = {}


def set_global_attr(name: str, value: Any) -> None:
    """Set a global default attribute (applies to resources allocated
    after this call)."""
    _GLOBAL_ATTRS[name] = value


def get_global_attr(name: str, default: Any = None) -> Any:
    env = os.environ.get(f"LCX_ATTR_{name.upper()}")
    if env is not None:
        return _parse_env(env)
    return _GLOBAL_ATTRS.get(name, default)


def reset_global_attrs() -> None:
    _GLOBAL_ATTRS.clear()


def _parse_env(s: str) -> Any:
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


class HasAttrs:
    """Mixin giving a resource its attribute table and the
    ``get_attr_<name>`` query interface.

    Resolution order at allocation: explicit per-resource value >
    env var ``LCX_ATTR_<NAME>`` > global default > class default.
    """

    _ATTR_DEFAULTS: Dict[str, Any] = {}

    def _init_attrs(self, overrides: Optional[Dict[str, Any]] = None) -> None:
        attrs: Dict[str, Any] = {}
        for name, default in type(self)._ATTR_DEFAULTS.items():
            attrs[name] = get_global_attr(name, default)
        for name, value in (overrides or {}).items():
            if name not in type(self)._ATTR_DEFAULTS:
                raise AttributeError(
                    f"{type(self).__name__} has no attribute {name!r}; "
                    f"known: {sorted(type(self)._ATTR_DEFAULTS)}"
                )
            if value is not None:
                attrs[name] = value
        self._attrs = attrs

    def __getattr__(self, item: str) -> Any:
        if item.startswith("get_attr_"):
            name = item[len("get_attr_"):]
            try:
                value = self._attrs[name]
            except (AttributeError, KeyError):
                raise AttributeError(
                    f"{type(self).__name__} has no attribute {name!r}"
                ) from None

            def getter(_value: Any = value) -> Any:
                return _value

            return getter
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {item!r}"
        )

    def attrs(self) -> Dict[str, Any]:
        return dict(self._attrs)
