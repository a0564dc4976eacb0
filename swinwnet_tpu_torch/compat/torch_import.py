"""Weights in and out of the port.

The port's modules carry the upstream torch state-dict names, so an
upstream `.pth` loads with `load_pth` and `model.load_state_dict` and no
key mapping. `state_dict_from_jax` turns the JAX package's params (nested
dicts of arrays) into a port state dict; it is the inverse of the JAX
package's `convert_state_dict`:

  `layers_0/`           -> `layers.0.` (blocks, downs, ups, swin_blocks, linears)
  `mlp/fc1|fc2`         -> `mlp.0|mlp.3`
  head `conv1|conv2`    -> `seg_head.0|.2`, or `reconstruction.0|.2` in the
                           upscaling head (the head that has `ups_*`)
  `in_proj_kernel|bias` -> `attn.in_proj_weight|bias`; `out_proj` -> `attn.out_proj`
  `proj_kernel|bias`    -> `proj.weight|bias` (the patch-embed conv)
  Dense kernel [in,out] -> weight [out,in]; conv [kh,kw,in,out] -> [out,in,kh,kw];
  LayerNorm `scale`     -> `weight`
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from ..ops.window import relative_position_index

_LIST_MODULES = ("layers", "blocks", "downs", "ups", "swin_blocks", "linears")
_LIST_RE = re.compile(r"^(%s)_(\d+)$" % "|".join(_LIST_MODULES))


def unwrap_state_dict(obj: Mapping[str, Any]) -> Dict[str, Any]:
    """Unwrap {'state_dict': ...} / {'model_state_dict': ...} and strip the
    DataParallel 'module.' prefix."""
    for key in ("state_dict", "model_state_dict"):
        if key in obj and isinstance(obj[key], Mapping):
            obj = obj[key]
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in obj.items()}


def sniff_error_matrix(state_dict: Mapping[str, Any]) -> bool:
    """A multimodal checkpoint's patch-embed conv takes 2 input channels."""
    w = state_dict.get("patch_embed.proj.weight")
    return w is not None and int(w.shape[1]) >= 2


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """An upstream `.pth` as a port state dict (on the CPU)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return unwrap_state_dict(obj)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX params (`{'params': tree}` or the tree) -> port state dict, with
    the relative-position index buffers the port's modules carry."""
    if isinstance(params.get("params"), Mapping):
        params = params["params"]
    flat = dict(_flatten(params))
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        *mods, leaf = path
        mods = list(mods)
        if leaf == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf in ("proj_kernel", "proj_bias"):  # the patch-embed conv
            if leaf == "proj_kernel":
                arr = arr.transpose(3, 2, 0, 1)
            mods, leaf = mods + ["proj"], "weight" if leaf == "proj_kernel" else "bias"
        elif leaf == "in_proj_kernel":
            mods, leaf, arr = mods + ["attn"], "in_proj_weight", arr.T
        elif leaf == "in_proj_bias":
            mods = mods + ["attn"]
        if mods and mods[-1] == "out_proj":
            mods.insert(len(mods) - 1, "attn")
        if len(mods) >= 2 and mods[-1] in ("conv1", "conv2"):
            head = path[: len(mods) - 1]
            upscaling = any(
                q[: len(head)] == head and q[len(head)].startswith("ups_")
                for q in flat if len(q) > len(head)
            )
            seq = "reconstruction" if upscaling else "seg_head"
            mods[-1:] = [seq, "0" if mods[-1] == "conv1" else "2"]
        if len(mods) >= 2 and mods[-2] == "mlp" and mods[-1] in ("fc1", "fc2"):
            mods[-1] = "0" if mods[-1] == "fc1" else "3"
        names = []
        for m in mods:
            hit = _LIST_RE.match(m)
            names += [hit.group(1), hit.group(2)] if hit else [m]
        key = ".".join(names + [leaf])
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if leaf == "relative_position_bias_table":
            ws = (int(round(arr.shape[0] ** 0.5)) + 1) // 2
            out[key[: -len(leaf)] + "relative_position_index"] = torch.from_numpy(
                relative_position_index(ws).copy()
            )
    return out
