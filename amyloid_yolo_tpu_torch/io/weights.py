"""Weight import: JAX parameter pytrees, reference ``.pth`` state dicts and
darknet binaries, all into one state-dict form.

The port's parameters are a state dict in the reference trainer's key
layout (the reference's ``models.py`` module builder, ``train.py:205-206``):

* ``module_list.{i}.conv_{i}.weight`` — conv weights, OIHW;
* ``module_list.{i}.conv_{i}.bias`` — only on BN-free (head) convs;
* ``module_list.{i}.batch_norm_{i}.{weight,bias,running_mean,running_var,
  num_batches_tracked}``.

So a reference ``.pth`` checkpoint loads through the same path as weights
carried over from the JAX package, whose pytree is
``{"conv_i": {"w": HWIO, "b"?}, "bn_i": {"scale", "bias", "mean", "var"}}``.
Orbax checkpoints are not read here: export them to a ``.pth`` with the JAX
CLI first.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..graphspec import ConvSpec, GraphSpec

StateDict = Dict[str, torch.Tensor]


def _conv_key(i: int) -> str:
    return f"module_list.{i}.conv_{i}"


def _bn_key(i: int) -> str:
    return f"module_list.{i}.batch_norm_{i}"


def _np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.array(t, np.float32, copy=True)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(_np32(a))


def params_from_jax(np_params: Mapping, spec: GraphSpec) -> StateDict:
    """JAX parameter pytree (numpy leaves, conv weights HWIO) → the port's
    state dict (OIHW, reference key layout).  Same keys and values as the
    JAX package's ``params_to_torch_state_dict``."""
    sd: StateDict = {}
    for i in spec.conv_indices:
        layer: ConvSpec = spec.layers[i]  # type: ignore[assignment]
        w = np.asarray(np_params[f"conv_{i}"]["w"], np.float32)
        sd[f"{_conv_key(i)}.weight"] = _f32(w.transpose(3, 2, 0, 1))
        if layer.batch_normalize:
            bn = np_params[f"bn_{i}"]
            p = _bn_key(i)
            sd[f"{p}.weight"] = _f32(bn["scale"])
            sd[f"{p}.bias"] = _f32(bn["bias"])
            sd[f"{p}.running_mean"] = _f32(bn["mean"])
            sd[f"{p}.running_var"] = _f32(bn["var"])
            sd[f"{p}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        else:
            sd[f"{_conv_key(i)}.bias"] = _f32(np_params[f"conv_{i}"]["b"])
    return sd


def params_to_jax(sd: Mapping[str, torch.Tensor], spec: GraphSpec) -> Dict:
    """Inverse of :func:`params_from_jax`: state dict → JAX pytree of numpy
    float32 arrays (conv weights HWIO)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for i in spec.conv_indices:
        layer: ConvSpec = spec.layers[i]  # type: ignore[assignment]
        w = _np32(sd[f"{_conv_key(i)}.weight"])
        entry = {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
        if layer.batch_normalize:
            p = _bn_key(i)
            out[f"bn_{i}"] = {
                "scale": _np32(sd[f"{p}.weight"]),
                "bias": _np32(sd[f"{p}.bias"]),
                "mean": _np32(sd[f"{p}.running_mean"]),
                "var": _np32(sd[f"{p}.running_var"]),
            }
        else:
            entry["b"] = _np32(sd[f"{_conv_key(i)}.bias"])
        out[f"conv_{i}"] = entry
    return out


def load_torch_state_dict(spec: GraphSpec, path: str) -> StateDict:
    """Import a reference ``.pth`` checkpoint (a state dict, or a pickled
    module that has one), keeping the keys ``spec`` reads, as float32."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out: StateDict = {}
    for i in spec.conv_indices:
        layer: ConvSpec = spec.layers[i]  # type: ignore[assignment]
        names = [f"{_conv_key(i)}.weight"]
        if layer.batch_normalize:
            names += [f"{_bn_key(i)}.{n}" for n in
                      ("weight", "bias", "running_mean", "running_var")]
        else:
            names.append(f"{_conv_key(i)}.bias")
        for n in names:
            out[n] = sd[n].detach().to(torch.float32).clone()
    return out


def load_darknet_weights(spec: GraphSpec, path: str,
                         params: Optional[Mapping[str, torch.Tensor]] = None
                         ) -> Tuple[StateDict, np.ndarray]:
    """Read a raw darknet weight file into ``(state_dict, header)``.

    The file is an int32[5] header (``seen`` at index 3), then per conv
    block either ``[bn_bias, bn_weight, running_mean, running_var]`` or
    ``[conv_bias]``, then the OIHW weights (the reference's
    ``models.py:257-308``).  A ``darknet53.conv.74`` file holds only the 75-layer
    backbone; ``params`` then supplies the layers it lacks.
    """
    with open(path, "rb") as fh:
        header = np.fromfile(fh, dtype=np.int32, count=5)
        weights = np.fromfile(fh, dtype=np.float32)

    cutoff = 75 if "darknet53.conv.74" in os.path.basename(path) else None
    out: StateDict = dict(params) if params else {}
    ptr = 0

    def take(n: int) -> np.ndarray:
        nonlocal ptr
        chunk = weights[ptr:ptr + n]
        ptr += n
        return chunk

    for i in spec.conv_indices:
        if cutoff is not None and i >= cutoff:
            break
        layer: ConvSpec = spec.layers[i]  # type: ignore[assignment]
        oc = layer.out_ch
        if layer.batch_normalize:
            p = _bn_key(i)
            out[f"{p}.bias"] = _f32(take(oc))
            out[f"{p}.weight"] = _f32(take(oc))
            out[f"{p}.running_mean"] = _f32(take(oc))
            out[f"{p}.running_var"] = _f32(take(oc))
            out[f"{p}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        else:
            out[f"{_conv_key(i)}.bias"] = _f32(take(oc))
        k = layer.kernel
        w = take(oc * layer.in_ch * k * k)
        out[f"{_conv_key(i)}.weight"] = _f32(w.reshape(oc, layer.in_ch, k, k))
    if ptr != len(weights) and cutoff is None:
        raise ValueError(f"weight file size mismatch: consumed {ptr} of {len(weights)}")
    return out, header


__all__ = ["StateDict", "params_from_jax", "params_to_jax",
           "load_torch_state_dict", "load_darknet_weights"]
