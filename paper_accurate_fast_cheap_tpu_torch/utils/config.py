"""Config loading (port of the JAX ``utils/config.load_config``).

A ``.json`` path is read with the standard library; any other path is YAML,
and ``yaml`` is imported only then.
"""
from __future__ import annotations

import json
from typing import Any, Dict


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        if str(path).endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.safe_load(f)
