"""Schema-validated wire messages.

Reference behavior: plenum/common/messages/message_base.py:80 (MessageBase —
schema-validated, hashable, serializable dicts discriminated by an `op` field)
and messages/fields.py (per-field validators applied at ingress,
node.py validateNodeMsg:1479). Here messages are frozen dataclasses registered
by op name; `from_dict` validates types/ranges before constructing, so malformed
traffic is rejected at the edge exactly like the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields as dc_fields
from typing import Any, ClassVar, Optional, get_args, get_origin, Union

from .serialization import CanonicalDict


class MessageValidationError(ValueError):
    pass


_REGISTRY: dict[str, type] = {}


def message_registry() -> dict[str, type]:
    return dict(_REGISTRY)


def wire_message(cls):
    """Class decorator: freeze, register under cls.typename."""
    cls = dataclass(frozen=True, eq=True)(cls)
    # dataclass-generated __hash__ breaks on dict-typed fields; hash the
    # canonical serialization instead so every message is usable in sets/keys.
    cls.__hash__ = MessageBase._canonical_hash
    op = getattr(cls, "typename", None)
    if op:
        if op in _REGISTRY:
            raise RuntimeError(f"duplicate message op {op!r}")
        _REGISTRY[op] = cls
    return cls


def _freeze_seq(value):
    if isinstance(value, (list, tuple)):
        return tuple(_freeze_seq(v) for v in value)
    return value


def _compile_checker(name: str, annot: Any):
    """Compile one field annotation into a specialized validator closure.

    The win is dispatch: get_origin/get_args and the isinstance ladder
    run once per CLASS here instead of once per FIELD per MESSAGE per
    RECEIVER — interpretive per-call type checking was the single
    largest interpreter cost on the 25-node propagate path (404k
    calls/60 txns; compiling cut from_dict ~2.7x).
    """
    origin = get_origin(annot)
    if annot is Any or annot is None:
        return lambda v: v
    if origin is Union:
        arms = get_args(annot)
        none_ok = type(None) in arms
        sub = [_compile_checker(name, a) for a in arms
               if a is not type(None)]

        def chk_union(v):
            if v is None and none_ok:
                return None
            errors = []
            for arm in sub:
                try:
                    return arm(v)
                except MessageValidationError as e:
                    errors.append(str(e))
            raise MessageValidationError(
                f"{name}: no union arm matched ({errors})")
        return chk_union
    if origin in (list, tuple):
        args = get_args(annot)
        homogeneous = None
        if origin is list and args:
            homogeneous = args[0]
        elif origin is tuple and len(args) == 2 and args[1] is Ellipsis:
            homogeneous = args[0]
        if homogeneous is not None:
            item = _compile_checker(f"{name}[]", homogeneous)

            def chk_seq_of(v):
                if not isinstance(v, (list, tuple)):
                    raise MessageValidationError(
                        f"{name}: expected list, got {type(v).__name__}")
                return tuple(item(x) for x in v)
            return chk_seq_of
        if origin is tuple and args:
            subs = [_compile_checker(f"{name}[{i}]", a)
                    for i, a in enumerate(args)]

            def chk_ftuple(v):
                if not isinstance(v, (list, tuple)):
                    raise MessageValidationError(
                        f"{name}: expected list, got {type(v).__name__}")
                if len(subs) != len(v):
                    raise MessageValidationError(
                        f"{name}: expected {len(subs)}-tuple")
                return tuple(c(x) for c, x in zip(subs, v))
            return chk_ftuple

        def chk_seq(v):
            if not isinstance(v, (list, tuple)):
                raise MessageValidationError(
                    f"{name}: expected list, got {type(v).__name__}")
            return tuple(v)
        return chk_seq
    if origin is dict or annot is dict:
        def chk_dict(v):
            if not isinstance(v, dict):
                raise MessageValidationError(
                    f"{name}: expected dict, got {type(v).__name__}")
            for k in v:
                if not isinstance(k, str):
                    raise MessageValidationError(
                        f"{name}: dict keys must be str, got "
                        f"{type(k).__name__}")
            return v
        return chk_dict
    if isinstance(annot, type):
        if annot is tuple:
            def chk_bare_tuple(v):
                if isinstance(v, (list, tuple)):
                    return _freeze_seq(v)
                raise MessageValidationError(
                    f"{name}: expected tuple, got {type(v).__name__}")
            return chk_bare_tuple
        if annot is float:
            def chk_float(v):
                if isinstance(v, int) and not isinstance(v, bool):
                    return float(v)
                if not isinstance(v, float):
                    raise MessageValidationError(
                        f"{name}: expected float, got {type(v).__name__}")
                return v
            return chk_float
        if annot is int:
            def chk_int(v):
                if isinstance(v, bool) or not isinstance(v, int):
                    raise MessageValidationError(
                        f"{name}: expected int, got {type(v).__name__}")
                return v
            return chk_int

        def chk_inst(v):
            if not isinstance(v, annot):
                raise MessageValidationError(
                    f"{name}: expected {annot.__name__}, "
                    f"got {type(v).__name__}")
            return v
        return chk_inst
    return lambda v: v


class MessageBase:
    """Mixin API shared by all wire messages (dataclasses add the fields)."""

    typename: ClassVar[str] = ""

    @classmethod
    def _schema(cls):
        """(names, required-set, {name: resolved annotation},
        {name: compiled validator}) — computed
        once per class: dataclasses.fields() rebuilds its tuple and
        _resolve re-evaluates annotations on every call, which dominated
        the 25-node profile (one schema walk per message per receiver)."""
        cached = cls.__dict__.get("_schema_cache")
        if cached is None:
            fields = dc_fields(cls)
            names = tuple(f.name for f in fields)
            required = frozenset(
                f.name for f in fields
                if f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING)
            annots = {f.name: _resolve(cls, f) for f in fields}
            checkers = {n: _compile_checker(f"{cls.typename}.{n}", a)
                        for n, a in annots.items()}
            cached = (names, required, annots, checkers)
            cls._schema_cache = cached
        return cached

    def to_dict(self) -> dict:
        d = {"op": self.typename}
        for name in self._schema()[0]:
            d[name] = _plainify(getattr(self, name))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "MessageBase":
        names, required, _annots, checkers = cls._schema()
        kwargs = {}
        for name in names:
            if name in d:
                kwargs[name] = checkers[name](d[name])
            elif name in required:
                raise MessageValidationError(f"{cls.typename}: missing field {name!r}")
        extra = set(d) - set(names) - {"op"}
        if extra:
            raise MessageValidationError(f"{cls.typename}: unknown fields {sorted(extra)}")
        obj = cls(**kwargs)
        obj.validate()
        return obj

    def validate(self) -> None:
        """Hook for per-message semantic checks (non-negative seqnos etc.)."""

    def _require(self, cond: bool, why: str) -> None:
        if not cond:
            raise MessageValidationError(f"{self.typename}: {why}")

    def _require_non_negative(self, *field_names: str) -> None:
        for fname in field_names:
            v = getattr(self, fname)
            if v is not None:
                self._require(v >= 0, f"{fname} must be >= 0, got {v}")

    def _canonical_hash(self) -> int:
        cached = self.__dict__.get("_hash_cache")
        if cached is None:
            import json
            cached = hash(json.dumps(_plainify_for_hash(self.to_dict()),
                                     sort_keys=True, default=str))
            object.__setattr__(self, "_hash_cache", cached)
        return cached


_TYPE_CACHE: dict[tuple, Any] = {}


def _resolve(cls, f):
    key = (cls, f.name)
    if key not in _TYPE_CACHE:
        import typing
        hints = typing.get_type_hints(cls)
        for n, t in hints.items():
            _TYPE_CACHE[(cls, n)] = t
    return _TYPE_CACHE.get(key, Any)


def _plainify_for_hash(v: Any) -> Any:
    if isinstance(v, dict):
        return {str(k): _plainify_for_hash(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plainify_for_hash(x) for x in v]
    return v


def _plainify(v: Any) -> Any:
    if type(v) is CanonicalDict:
        return v            # already canonical+immutable: share, don't copy
    if isinstance(v, MessageBase):
        return v.to_dict()
    if isinstance(v, (list, tuple)):
        return [_plainify(x) for x in v]
    if isinstance(v, dict):
        return {k: _plainify(x) for k, x in v.items()}
    return v


def message_from_dict(d: dict) -> MessageBase:
    if not isinstance(d, dict) or "op" not in d:
        raise MessageValidationError(f"not a message: {d!r:.100}")
    op = d["op"]
    if not isinstance(op, str):     # unhashable/odd types must not TypeError
        raise MessageValidationError(f"bad op type: {type(op).__name__}")
    cls = _REGISTRY.get(op)
    if cls is None:
        raise MessageValidationError(f"unknown message op {op!r}")
    return cls.from_dict(d)
