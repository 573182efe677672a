"""Pretrained-model hub: download, cache, resolve by name or URL (port of
the JAX ``hub.py``).

Parity target: `wenet/cli/hub.py` -- `Hub.get_model_by_lang` downloads a
model tarball into `~/.wenet/<lang>/` once and reuses the cached copy;
`wenet/cli/model.py:load_model` accepts a language name, a hub id, or a
local dir.  Same surface here:

- cache root ``~/.pafc_torch/`` (override with ``$PAFC_HOME``): the port's
  model directories hold ``state_dict`` checkpoints, the JAX package's
  hold others, so the two caches are kept apart;
- a model dir is complete when it holds ``train.yaml``
  (``api.Model.from_dir`` layout);
- ``Assets`` maps names -> URLs of ``.tar.gz`` archives; the registry is
  extended at run time (``register_model``) or by a JSON file at
  ``$PAFC_HOME/assets.json``; no URL is built in.

``resolve(name_or_dir)`` is what ``api.load_model`` routes through: local
dirs pass straight through, ``http(s)://`` and ``file://`` archive URLs and
registered names hit the cache/download path.
"""
from __future__ import annotations

import json
import logging
import os
import tarfile
from pathlib import Path
from typing import Dict
from urllib.request import urlretrieve

log = logging.getLogger(__name__)

# name -> url; mirrors the reference's Assets keys (`cli/hub.py:73-81`).
# URLs intentionally unset here: fill via register_model/assets.json.
Assets: Dict[str, str] = {}

URL_SCHEMES = ("http://", "https://", "file://")


def cache_root() -> str:
    return os.environ.get(
        "PAFC_HOME", os.path.join(Path.home(), ".pafc_torch"))


def register_model(name: str, url: str) -> None:
    Assets[name] = url


def _load_user_assets() -> None:
    path = os.path.join(cache_root(), "assets.json")
    if os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as f:
                Assets.update(json.load(f))
        except Exception as e:  # pragma: no cover
            log.warning("ignoring malformed %s: %s", path, e)


def _is_model_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "train.yaml"))


def download(url: str, dest: str, only_child: bool = True) -> None:
    """Fetch a `.tar.gz` (or any tar archive ``tarfile`` opens) into
    ``dest`` and unpack it (flattening one directory level, like the
    reference's `hub.download`)."""
    os.makedirs(dest, exist_ok=True)
    name = url.split("?")[0].split("/")[-1] or "model.tar.gz"
    tar_path = os.path.join(dest, name)
    log.info("downloading %s -> %s", url, tar_path)
    urlretrieve(url, filename=tar_path)
    with tarfile.open(tar_path) as f:
        if only_child:
            for ti in f:
                if "/" not in ti.name or not ti.isfile():
                    continue
                base = os.path.basename(ti.name)
                src = f.extractfile(ti)
                if src is None:
                    continue
                with open(os.path.join(dest, base), "wb") as w:
                    w.write(src.read())
        else:
            f.extractall(dest, filter="data")
    os.remove(tar_path)


def get_model_by_name(name: str) -> str:
    """Cached model dir for a registered name (downloads once)."""
    _load_user_assets()
    if name not in Assets:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(Assets)} — register "
            "with hub.register_model(name, url) or $PAFC_HOME/assets.json")
    model_dir = os.path.join(cache_root(), name)
    if _is_model_dir(model_dir):
        return model_dir
    download(Assets[name], model_dir)
    if not _is_model_dir(model_dir):
        raise RuntimeError(
            f"downloaded archive for {name!r} lacks train.yaml "
            f"(unpacked into {model_dir})")
    return model_dir


def resolve(name_or_dir: str) -> str:
    """Local model dir passthrough, registered name -> cached download,
    direct URL -> cached download keyed by the archive name (without
    ``.tar.gz``, ``.tgz`` or ``.tar``)."""
    if _is_model_dir(name_or_dir):
        return name_or_dir
    if name_or_dir.startswith(URL_SCHEMES):
        key = os.path.basename(name_or_dir.split("?")[0]) or "model"
        key = key.replace(".tar.gz", "").replace(".tgz", "")
        key = key[:-4] if key.endswith(".tar") else key
        model_dir = os.path.join(cache_root(), key)
        if not _is_model_dir(model_dir):
            download(name_or_dir, model_dir)
        return model_dir
    return get_model_by_name(name_or_dir)
