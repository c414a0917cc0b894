"""Parameter trees, checkpoint files and the ``.npz`` cache as the port's
state dicts.

The JAX package keeps parameters as nested dicts in torch layout, keyed by the
torch module names (its ``utils/ckpt.py``), so flattening a tree with ``.``
gives the port's ``state_dict`` keys directly, with no per-model table. The
models load the result with ``strict=True``.

Checkpoint files are raw ``torch.save`` containers, or TorchScript archives
(FILM's ``film_net_fp32.pt``, which the reference loads with
``torch.jit.load``), read through ``torch.jit.load`` as the JAX loader does
(its ``utils/ckpt.py:90-132``): :func:`load_checkpoint_file`. Multi-file
models (GMFSS Fortuna, EISAI) load a checkpoint set: one state dict per
sub-network, its keys prefixed by the sub-network's name
(:func:`load_checkpoint_set`).

A converted state dict round-trips through ``.npz`` with ``/``-joined keys,
the JAX ``flatten_tree`` keys, so one file serves both packages
(:func:`save_npz`, :func:`load_npz`). The CLI converts a checkpoint once::

    python -m comfyui_frame_interpolation_tpu_torch.utils.ckpt SRC [DST.npz]
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


__all__ = [
    "is_torchscript_archive",
    "load_checkpoint_file",
    "load_checkpoint_set",
    "load_npz",
    "main",
    "params_from_jax",
    "save_npz",
]

# the training containers a state dict may sit in, in the order the JAX
# loader tries them (its ``utils/ckpt.py:load_torch_state_dict``): AMT, CAIN,
# FLAVR and STMFNet; ATM and EISAI's full checkpoint; MoMo; XVFI
NESTED_KEYS = ("state_dict", "model_state_dict", "model", "state_dict_Model")


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested JAX parameter tree (numpy or JAX array leaves) -> flat state dict
    of CPU tensors with ``.``-joined keys (the JAX ``flatten_tree``)."""
    flat: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(params_from_jax(v, key))
        else:
            flat[key] = torch.from_numpy(np.array(v))
    return flat


def is_torchscript_archive(path: str) -> bool:
    """True if ``path`` is a TorchScript zip archive, which holds a
    ``constants.pkl`` member (a plain ``torch.save`` zip holds ``data.pkl``
    only), as the JAX ``is_torchscript_archive`` tells them apart."""
    if not zipfile.is_zipfile(path):
        return False
    try:
        with zipfile.ZipFile(path) as zf:
            return any(name.endswith("constants.pkl") for name in zf.namelist())
    except zipfile.BadZipFile:
        return False


def load_checkpoint_file(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in the checkpoint file ``path``, loaded on the CPU, with
    the keys the JAX loader gives the same file: a TorchScript archive
    through ``torch.jit.load(...).state_dict()``; a raw ``torch.save``
    container with ``weights_only=True``, taken out of the first training
    container of :data:`NESTED_KEYS` it holds (STMFNet's ``state_dict``,
    EISAI's ``model_state_dict``); a leading ``module.`` (``nn.DataParallel``'s,
    as in ``FLAVR_*.pth``) stripped from every key."""
    if is_torchscript_archive(path):
        obj = dict(torch.jit.load(path, map_location="cpu").state_dict())
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        inner = next((obj[k] for k in NESTED_KEYS if isinstance(obj.get(k), dict)), None)
        obj = obj if inner is None else inner
    return {k.removeprefix("module."): v for k, v in obj.items()}


def load_checkpoint_set(files: Mapping[str, Tuple[str, ...]]) -> Dict[str, torch.Tensor]:
    """One state dict from a set of checkpoints: ``files`` maps each prefix to
    its ``(model_type, ckpt_name)``, or ``(model_type, ckpt_name, part)`` for
    a file that holds more than the sub-network, as the nodes'
    ``CKPTS_PATH_CONFIG`` entries do. Each file comes through
    ``utils.download.get_converted_params`` (its ``.npz`` cache, the file
    with a leading ``module.`` stripped from its keys, or a download; a file
    found nowhere raises ``FileNotFoundError`` naming it); with a ``part``,
    only the keys under ``part.`` are kept, without it, as EISAI's node takes
    ``flownet`` from its full checkpoint (a file with no key under ``part.``
    raises ``KeyError`` naming both); and the prefix is put before them
    (``flownet.backbone.conv1.weight``)."""
    from .download import get_converted_params

    out: Dict[str, torch.Tensor] = {}
    for prefix, (model_type, ckpt_name, *part) in files.items():
        sd = get_converted_params(model_type, ckpt_name)  # the whole file, as cached
        if part:
            sd = {k[len(part[0]) + 1 :]: v for k, v in sd.items() if k.startswith(f"{part[0]}.")}
            if not sd:
                raise KeyError(f"{model_type} checkpoint {ckpt_name} holds no key under {part[0]}.")
        for key, value in sd.items():
            out[f"{prefix}.{key}"] = value
    return out


def _to_numpy(value: torch.Tensor) -> np.ndarray:
    value = value.detach().cpu()
    return (value.float() if value.dtype == torch.bfloat16 else value).numpy()  # numpy has no bf16


def save_npz(sd: Mapping[str, torch.Tensor], path: str) -> None:
    """A flat state dict as ``.npz``, its keys ``/``-joined (the JAX
    ``save_npz``'s ``flatten_tree`` keys); bf16 tensors as f32."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k.replace(".", "/"): _to_numpy(v) for k, v in sd.items()})


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """An ``.npz`` of either package as the port's flat state dict."""
    with np.load(path) as z:
        return {k.replace("/", "."): torch.from_numpy(z[k]) for k in z.files}


def main(argv=None) -> int:
    """Convert a checkpoint once into the ``.npz`` both packages load:

    ``python -m comfyui_frame_interpolation_tpu_torch.utils.ckpt SRC [DST]``

    ``SRC`` is any container :func:`load_checkpoint_file` reads (raw, nested
    or ``module.``-prefixed pickles, TorchScript archives); ``DST`` (default:
    ``SRC`` with ``.npz``) must end in ``.npz``: the JAX CLI's other
    destination, an orbax directory, is JAX-native and not written here."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    ap.add_argument("src", help="torch .pth/.pkl pickle or TorchScript archive")
    ap.add_argument("dst", nargs="?", help="the .npz to write")
    args = ap.parse_args(argv)
    dst = args.dst or os.path.splitext(args.src)[0] + ".npz"
    if not dst.endswith(".npz"):
        raise ValueError(f"{dst}: the port writes .npz only; an orbax directory is the JAX package's format")
    sd = load_checkpoint_file(args.src)
    save_npz(sd, dst)
    print(f"converted {args.src} -> {dst} ({len(sd)} tensors)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
