"""Config loading, saving and ``--set`` overrides (port of the JAX
``utils/config.py``: ``load_config``, ``save_config``, ``override_config``).

A ``.json`` path is read with the standard library; any other path is YAML,
and ``yaml`` is imported only then (and by ``override_config``, whose
values are YAML scalars).
"""
from __future__ import annotations

import copy
import json
import logging
from typing import Any, Dict, List


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        if str(path).endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.safe_load(f)


def save_config(config: Dict[str, Any], path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)


def override_config(config: Dict[str, Any],
                    overrides: List[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` overrides, values parsed as YAML scalars.

    A path that does not exist yet is created (configs omit optional keys),
    with a warning, so a typo'd key does not silently leave the default in
    place."""
    import yaml

    config = copy.deepcopy(config)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"bad override (need key=value): {item!r}")
        key, value = item.split("=", 1)
        parts = key.strip().split(".")
        node = config
        created = None
        for i, p in enumerate(parts[:-1]):
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
                created = created or ".".join(parts[: i + 1])
            node = node[p]
        if parts[-1] not in node:
            created = created or key.strip()
        if created:
            logging.warning(
                "config override created new key %r (from --set %s): check "
                "for typos if it was meant to override an existing value",
                created, item)
        node[parts[-1]] = yaml.safe_load(value)
    return config
