"""Config composition: jsonnet experiment configs + CLI override snippets.

Same contract as the reference config system (reference: framework/config.py):
the base config (``-c``) is composed with N CLI snippets (``-x``), each of
which may reference the sibling ``addition.libsonnet`` of the base config via
``local add = import '__addition_config__';``. The composed object is
manifested to JSON and wrapped in a :class:`ConfigTree`.
"""
from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import List, Optional

from .jsonnet import JsonnetError, evaluate_file, evaluate_snippet
from .tree import ConfigMissingError, ConfigTree

__all__ = [
    "ConfigTree", "ConfigMissingError", "JsonnetError",
    "get_config", "load_config", "save_config",
    "evaluate_snippet", "evaluate_file",
]

logger = logging.getLogger(__name__)

_ARG_RE = re.compile(r"^__arg_(\d+)__$")


def _config_snippet(ext_config_count: int) -> str:
    snippet = 'local base = import "__base_config__";\n'
    for i in range(ext_config_count):
        snippet += f'local arg{i} = import "__arg_{i}__";\n'
    snippet += "base"
    for i in range(ext_config_count):
        snippet += f" + arg{i}"
    return snippet


def _ext_config_template(ext_config: str) -> str:
    return 'local add = import "__addition_config__";\n' + ext_config


def load_config(config_path: str, ext_config: Optional[List[str]] = None) -> ConfigTree:
    """Compose ``config_path`` with optional ``-x`` snippet overrides."""
    ext_config = ext_config or []
    config_path = Path(config_path)

    def import_callback(dir: str, rel: str):
        m = _ARG_RE.match(rel)
        if m is not None:
            return rel, _ext_config_template(ext_config[int(m.group(1))])
        if rel == "__base_config__":
            rel_path = config_path
        elif rel == "__addition_config__":
            rel_path = config_path.with_name("addition.libsonnet")
        else:
            rel_path = Path(rel)
        full_path = rel_path if rel_path.is_absolute() else Path(dir) / rel_path
        with open(full_path) as f:
            return str(full_path), f.read()

    json_str = evaluate_snippet(
        "__composed_config__",
        _config_snippet(len(ext_config)),
        import_callback=import_callback,
    )
    return ConfigTree.from_dict(json.loads(json_str))


def get_config(args) -> ConfigTree:
    """Reference-compatible entry: args has .config and .ext_config."""
    cfg = load_config(args.config, list(getattr(args, "ext_config", []) or []))
    logger.info("Config = \n%s", cfg.to_hocon())
    return cfg


def save_config(args, cfg: ConfigTree) -> None:
    config_path = Path(args.run_dir) / "config.json"
    with open(config_path, "w") as f:
        f.write(cfg.to_json())
