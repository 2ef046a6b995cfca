"""The *objectized flexible function* idiom (paper §3.1, Listing 1.1).

The paper replaces C function definitions with C++ classes whose
constructor takes the positional arguments, whose chainable methods set
optional arguments (in any order), and whose ``operator()`` invokes the
operation::

    D d = foo_x(a1).c(c1)();

``FlexOp`` is the Python realization.  A subclass declares its signature
declaratively::

    class send_x(FlexOp):
        _positional = ("buffer",)
        _optional = dict(tag=0, to=None, comp=None, device=None,
                         matching_engine=None)
        def _invoke(self): ...

and callers write ``send_x(buf).tag(3).comp(cq)()``.  Setters mutate and
return ``self`` so an op object can be **reused** across calls without
re-passing unchanged arguments — the paper calls this out as an explicit
advantage of the idiom.  ``clone()`` gives an independent copy when reuse
must not alias.

Every flex op also gets a plain-function shorthand via :func:`plain`,
matching the binding guideline "[each op] also defines a normal C++
function with all positional arguments to simplify programming in the
simple case".
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Tuple


class _Required:
    """Sentinel for optional-args that must be set before invocation."""

    def __repr__(self) -> str:  # pragma: no cover
        return "<required>"


REQUIRED = _Required()


def _make_setter(name: str) -> Callable[["FlexOp", Any], "FlexOp"]:
    def setter(self: "FlexOp", value: Any) -> "FlexOp":
        self._args[name] = value
        return self

    setter.__name__ = name
    setter.__qualname__ = name
    setter.__doc__ = f"Set optional argument ``{name}`` and return self."
    return setter


class FlexOp:
    """Base class for objectized flexible functions.

    Subclasses declare ``_positional`` (tuple of names) and ``_optional``
    (dict name -> default, or :data:`REQUIRED`), and implement
    ``_invoke()`` which may read every argument via ``self.arg(name)``.
    """

    _positional: Tuple[str, ...] = ()
    _optional: Dict[str, Any] = {}

    def __init_subclass__(cls, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        for name in cls._optional:
            if name in cls._positional:
                raise TypeError(
                    f"{cls.__name__}: argument {name!r} is both positional "
                    "and optional"
                )
            # Do not clobber a hand-written setter/override.
            if name not in cls.__dict__:
                setattr(cls, name, _make_setter(name))

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        cls = type(self)
        if len(args) > len(cls._positional):
            raise TypeError(
                f"{cls.__name__} takes {len(cls._positional)} positional "
                f"arguments ({', '.join(cls._positional)}), got {len(args)}"
            )
        self._args: Dict[str, Any] = dict(cls._optional)
        for name, value in zip(cls._positional, args):
            self._args[name] = value
        for name in cls._positional[len(args):]:
            self._args.setdefault(name, REQUIRED)
        for name, value in kwargs.items():
            if name not in cls._optional and name not in cls._positional:
                raise TypeError(f"{cls.__name__}: unknown argument {name!r}")
            self._args[name] = value

    # -- argument access ---------------------------------------------------
    def arg(self, name: str) -> Any:
        value = self._args[name]
        if value is REQUIRED:
            raise TypeError(
                f"{type(self).__name__}: required argument {name!r} was "
                "never set"
            )
        return value

    def arg_or(self, name: str, default: Any) -> Any:
        value = self._args.get(name, REQUIRED)
        return default if value is REQUIRED or value is None else value

    def is_set(self, name: str) -> bool:
        return self._args.get(name, REQUIRED) is not REQUIRED

    # -- reuse -------------------------------------------------------------
    def clone(self) -> "FlexOp":
        new = copy.copy(self)
        new._args = dict(self._args)
        return new

    # -- invocation --------------------------------------------------------
    def __call__(self, **late: Any) -> Any:
        """Invoke the operation.  Late keyword overrides are applied to a
        *temporary* copy so the op object stays reusable."""
        if late:
            return self._call_with(late)
        return self._invoke()

    def _call_with(self, late: Dict[str, Any]) -> Any:
        tmp = self.clone()
        for name, value in late.items():
            if name not in type(self)._optional and name not in type(self)._positional:
                raise TypeError(f"{type(self).__name__}: unknown argument {name!r}")
            tmp._args[name] = value
        return tmp._invoke()

    def _invoke(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def __repr__(self) -> str:
        cls = type(self)
        parts = []
        for name in (*cls._positional, *cls._optional):
            v = self._args.get(name, REQUIRED)
            parts.append(f"{name}={'<unset>' if v is REQUIRED else v!r}")
        return f"{cls.__name__}({', '.join(parts)})"


def plain(flex_cls: type) -> Callable[..., Any]:
    """Derive the plain-function shorthand for a flex-op class.

    ``send = plain(send_x)`` gives ``send(buf, tag=3)`` ==
    ``send_x(buf).tag(3)()``.
    """

    def fn(*args: Any, **kwargs: Any) -> Any:
        return flex_cls(*args, **kwargs)()

    fn.__name__ = flex_cls.__name__.removesuffix("_x")
    fn.__doc__ = f"Plain-function shorthand for {flex_cls.__name__}."
    return fn
