"""Checkpoint download and caching, port of the JAX package's
``utils/download.py`` (reference ``vfi_utils.py:84-137``).

:func:`get_converted_params` gives a node its state dict, looking in turn at:

1. the in-memory cache: the same dict object on every call for one file, so
   the nodes' model caches (keyed by the params object) hit;
2. ``<ckpts_path>/<model_type>/<ckpt_name>.npz``, the converted cache, written
   by either package (``/``-joined keys, ``utils.ckpt.save_npz``);
3. the checkpoint itself in ``<ckpts_path>/<model_type>/``, read with the
   container and ``module.`` rules of ``utils.ckpt.load_checkpoint_file``;
4. a download into that directory from each mirror in turn (the reference's
   release mirrors, then the per-file fallbacks), to ``<name>.part`` and
   renamed when complete.

After 3 or 4 the state dict (after ``convert``) is written as the ``.npz``.
A checkpoint found nowhere raises ``FileNotFoundError`` naming the path to put
the file at.
"""

from __future__ import annotations

import os
import urllib.parse
import urllib.request
import warnings
from typing import Callable, Dict, List, Optional

import torch

from ..core.config import get_ckpt_container_path
from .ckpt import load_checkpoint_file, load_npz, save_npz

__all__ = [
    "BASE_MODEL_DOWNLOAD_URLS",
    "CKPT_FALLBACK_URLS",
    "get_converted_params",
    "load_file_from_direct_url",
    "load_file_from_github_release",
]

# the JAX package's mirror lists (its utils/download.py), kept here as the port imports nothing of it
BASE_MODEL_DOWNLOAD_URLS = [
    "https://github.com/styler00dollar/VSGAN-tensorrt-docker/releases/download/models/",
    "https://github.com/Fannovel16/ComfyUI-Frame-Interpolation/releases/download/models/",
    "https://github.com/dajes/frame-interpolation-pytorch/releases/download/v1.0.0/",
]

CKPT_FALLBACK_URLS: Dict[str, List[str]] = {
    "rife47.pth": [
        "https://huggingface.co/marduk191/rife/resolve/main/rife47.pth",
        "https://huggingface.co/wavespeed/misc/resolve/main/rife/rife47.pth",
    ],
    "rife49.pth": [
        "https://huggingface.co/marduk191/rife/resolve/main/rife49.pth",
        "https://huggingface.co/hfmaster/models-moved/resolve/main/rife/rife49.pth",
    ],
    "sudo_rife4_269.662_testV1_scale1.pth": [
        "https://huggingface.co/marduk191/rife/resolve/main/sudo_rife4_269.662_testV1_scale1.pth",
    ],
}


def _download(url: str, dest_dir: str) -> str:
    """``url`` into ``dest_dir`` under its own file name, through
    ``<name>.part``, renamed once complete; an existing file is kept."""
    os.makedirs(dest_dir, exist_ok=True)
    cached = os.path.join(dest_dir, os.path.basename(urllib.parse.urlparse(url).path))
    if not os.path.exists(cached):
        print(f'Downloading: "{url}" to {cached}')
        tmp = cached + ".part"
        try:
            urllib.request.urlretrieve(url, tmp)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        os.replace(tmp, cached)
    return cached


def load_file_from_github_release(model_type: str, ckpt_name: str) -> str:
    """The path of ``ckpt_name`` in ``<ckpts_path>/<model_type>/``, downloaded
    there from the first mirror that has it if it is missing
    (``vfi_utils.py:118-133``)."""
    dest = get_ckpt_container_path(model_type)
    cached = os.path.join(dest, ckpt_name)
    if os.path.exists(cached):
        return cached
    urls = [base + ckpt_name for base in BASE_MODEL_DOWNLOAD_URLS] + CKPT_FALLBACK_URLS.get(ckpt_name, [])
    errors = []
    for i, url in enumerate(urls):
        try:
            return _download(url, dest)
        except Exception as e:  # any mirror's failure moves on to the next
            if i < len(urls) - 1:
                print("Failed! Trying another endpoint.")
            errors.append(f"{url}: {e!r}")
    raise _not_found(model_type, cached, "no mirror had it:\n" + "\n".join(errors))


def load_file_from_direct_url(model_type: str, url: str) -> str:
    """The path of ``url``'s file in ``<ckpts_path>/<model_type>/``,
    downloaded if missing (AMT's node gives its Hugging Face URL)."""
    dest = get_ckpt_container_path(model_type)
    cached = os.path.join(dest, os.path.basename(urllib.parse.urlparse(url).path))
    if not os.path.exists(cached):
        try:
            _download(url, dest)
        except Exception as e:
            raise _not_found(model_type, cached, f"{url}: {e!r}") from e
    return cached


def _not_found(model_type: str, cached: str, why: str) -> FileNotFoundError:
    name = os.path.basename(cached)
    return FileNotFoundError(
        f"{model_type} checkpoint {cached} not found and not downloaded; {why}\nPlace {name} (or a converted "
        f"{name}.npz) there, or pass params= (a state dict, e.g. the model module's init_params(seed))"
    )


# one state dict per checkpoint file, keyed by (its directory, its name)
_params_memcache: Dict[tuple, Dict[str, torch.Tensor]] = {}


def get_converted_params(
    model_type: str,
    ckpt_name: str,
    convert: Optional[Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]] = None,
    url: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """The flat state dict (CPU tensors) of checkpoint ``ckpt_name`` of
    ``model_type``, found in the order of the module's docstring.
    ``convert`` post-processes a checkpoint read from its file (not one read
    from the ``.npz``, which holds the converted dict); ``url`` downloads from
    there instead of the mirrors. Repeated calls return the same dict."""
    dest = get_ckpt_container_path(model_type)
    key = (dest, ckpt_name)
    if key in _params_memcache:
        return _params_memcache[key]
    npz_path = os.path.join(dest, ckpt_name + ".npz")
    if os.path.exists(npz_path):
        sd = load_npz(npz_path)
    else:
        path = load_file_from_direct_url(model_type, url) if url else load_file_from_github_release(model_type, ckpt_name)
        sd = load_checkpoint_file(path)
        if convert is not None:
            sd = convert(sd)
        try:
            save_npz(sd, npz_path)
        except OSError as e:  # a read-only checkpoint directory: the cache is only a cache
            warnings.warn(f"could not write {npz_path}: {e}")
    _params_memcache[key] = sd
    return sd
