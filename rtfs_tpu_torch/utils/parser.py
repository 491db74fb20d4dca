"""Config override parsing: ``--group.key value`` CLI merges onto a config.

Counterpart of ``rtfs_tpu/utils/parser.py`` without PyYAML: a value is
parsed as JSON (numbers, ``true``/``false``, ``null``, lists, objects),
falling back to the raw string, so ``--training.batch_size 8``,
``--optim.lr 5e-4`` and ``--data.synthetic true`` give an int, a float and
a bool.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


def parse_overrides(conf: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply ``--a.b.c value`` (or ``--a.b.c=value``) overrides to a nested
    config dict, in place; returns it."""
    i = 0
    while i < len(overrides):
        key = overrides[i]
        if not key.startswith("--"):
            raise ValueError(f"unexpected argument: {key}")
        key = key[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(overrides):
                raise ValueError(f"missing value for --{key}")
            value = overrides[i + 1]
            i += 2
        node = conf
        parts = key.replace("-", "_").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return conf
