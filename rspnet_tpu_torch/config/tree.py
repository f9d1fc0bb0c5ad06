"""ConfigTree: a dotted-path configuration mapping.

Drop-in replacement for the pyhocon ``ConfigTree`` surface the reference uses
(reference: framework/config.py:3, utils/moco.py:8-21, pretrain.py:36-77):
typed getters with dotted paths and defaults, ``put`` for mutation, and JSON
serialization. Implemented from scratch on nested dicts.
"""
from __future__ import annotations

import json
from typing import Any, Iterator, List, Optional

_MISSING = object()


class ConfigMissingError(KeyError):
    pass


class ConfigTree:
    def __init__(self, data: Optional[dict] = None):
        self._data: dict = {}
        if data:
            for k, v in data.items():
                self._data[k] = self._wrap(v)

    @classmethod
    def from_dict(cls, d: dict) -> "ConfigTree":
        return cls(d)

    @staticmethod
    def _wrap(v: Any) -> Any:
        if isinstance(v, ConfigTree):
            return v
        if isinstance(v, dict):
            return ConfigTree(v)
        if isinstance(v, list):
            return [ConfigTree._wrap(x) for x in v]
        return v

    # -- core access ------------------------------------------------------
    def _resolve(self, path: str, create: bool = False) -> tuple:
        keys = path.split(".")
        node = self
        for k in keys[:-1]:
            child = node._data.get(k, _MISSING)
            if child is _MISSING or not isinstance(child, ConfigTree):
                if not create:
                    raise ConfigMissingError(path)
                child = ConfigTree()
                node._data[k] = child
            node = child
        return node, keys[-1]

    def get(self, path: str, default: Any = _MISSING) -> Any:
        try:
            node, leaf = self._resolve(path)
            v = node._data.get(leaf, _MISSING)
        except ConfigMissingError:
            v = _MISSING
        if v is _MISSING:
            if default is _MISSING:
                raise ConfigMissingError(f"No configuration setting found for key {path!r}")
            return default
        return v

    def put(self, path: str, value: Any) -> None:
        node, leaf = self._resolve(path, create=True)
        node._data[leaf] = self._wrap(value)

    # -- typed getters (pyhocon-compatible names) ---------------------------
    def get_string(self, path: str, default: Any = _MISSING) -> str:
        v = self.get(path, default)
        return v if v is None or v is default else str(v)

    def get_int(self, path: str, default: Any = _MISSING) -> int:
        v = self.get(path, default)
        return v if v is None or v is default else int(v)

    def get_float(self, path: str, default: Any = _MISSING) -> float:
        v = self.get(path, default)
        return v if v is None or v is default else float(v)

    def get_bool(self, path: str, default: Any = _MISSING) -> bool:
        v = self.get(path, default)
        if isinstance(v, str):
            return v.lower() in ("true", "yes", "on", "1")
        return v if v is None or v is default else bool(v)

    def get_list(self, path: str, default: Any = _MISSING) -> List[Any]:
        v = self.get(path, default)
        if v is None or v is default:
            return v
        if not isinstance(v, list):
            raise TypeError(f"{path} is not a list: {type(v).__name__}")
        return v

    def get_config(self, path: str, default: Any = _MISSING) -> "ConfigTree":
        v = self.get(path, default)
        if v is None or v is default:
            return v
        if not isinstance(v, ConfigTree):
            raise TypeError(f"{path} is not a config: {type(v).__name__}")
        return v

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, path: str) -> Any:
        return self.get(path)

    def __setitem__(self, path: str, value: Any) -> None:
        self.put(path, value)

    def __contains__(self, path: str) -> bool:
        try:
            self.get(path)
            return True
        except ConfigMissingError:
            return False

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def pop(self, path: str, default: Any = _MISSING) -> Any:
        try:
            node, leaf = self._resolve(path)
            if leaf in node._data:
                return node._data.pop(leaf)
        except ConfigMissingError:
            pass
        if default is _MISSING:
            raise ConfigMissingError(path)
        return default

    # -- conversion ------------------------------------------------------------
    def as_plain_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, ConfigTree):
                return v.as_plain_dict()
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v
        return {k: unwrap(v) for k, v in self._data.items()}

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.as_plain_dict(), indent=indent)

    def to_hocon(self) -> str:
        """Human-readable rendering for logs (HOCON-ish)."""
        lines: List[str] = []

        def render(tree: "ConfigTree", prefix: str):
            for k, v in tree.items():
                if isinstance(v, ConfigTree):
                    lines.append(f"{prefix}{k} {{")
                    render(v, prefix + "  ")
                    lines.append(f"{prefix}}}")
                else:
                    lines.append(f"{prefix}{k} = {json.dumps(self._plain(v))}")
        render(self, "")
        return "\n".join(lines)

    @staticmethod
    def _plain(v):
        if isinstance(v, ConfigTree):
            return v.as_plain_dict()
        if isinstance(v, list):
            return [ConfigTree._plain(x) for x in v]
        return v

    def __repr__(self) -> str:
        return f"ConfigTree({self.as_plain_dict()!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, ConfigTree):
            return self.as_plain_dict() == other.as_plain_dict()
        if isinstance(other, dict):
            return self.as_plain_dict() == other
        return NotImplemented
