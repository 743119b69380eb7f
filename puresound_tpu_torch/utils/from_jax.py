"""JAX (flax) variables -> this package's state_dict.

The inverse of the converters in puresound_tpu/utils/torch_import.py: the
port keeps PureSound's module and parameter names, so the flax tree maps
onto them one module type at a time. Leaves may be numpy or jax arrays
(anything `np.asarray` takes); this module never imports jax.

    sd = from_jax(variables)               # a whole TSE SoTaskWrapModule
    model.load_state_dict(sd)
    grads = params_by_name(jax_grads)      # {name: array} like the params

The per-module converters take (params, batch_stats) subtrees and return a
flat {name: np.ndarray} dict; `to_torch` turns one into tensors.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

Flat = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.array(np.asarray(x))


def _prefix(name: str, flat: Flat) -> Flat:
    return {f"{name}.{k}": v for k, v in flat.items()}


def _merge(*parts: Flat) -> Flat:
    out: Flat = {}
    for p in parts:
        out.update(p)
    return out


def to_torch(flat: Flat) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in flat.items()}


# ---------------------------------------------------------------- primitives
def conv1d(p) -> Flat:
    out = {"weight": _a(p["w"])}
    if "b" in p:
        out["bias"] = _a(p["b"])
    return out


def prelu(p) -> Flat:
    return {"weight": _a(p["alpha"]).reshape(-1)}


def linear(p) -> Flat:
    return {"weight": _a(p["kernel"]).T.copy(), "bias": _a(p["bias"])}


def layer_norm_last(p) -> Flat:
    return {"weight": _a(p["scale"]), "bias": _a(p["bias"])}


def norm(p, s=None, kind: str = "gLN") -> Flat:
    """BatchNorm (its flax params are scale/bias; running stats when `s`
    has them); else GlobLN (gamma/beta) for kind 'gLN' or torch GroupNorm
    (weight/bias) for kind 'gGN'."""
    if "scale" in p:
        out = {"weight": _a(p["scale"]), "bias": _a(p["bias"])}
        if s:
            out.update(running_mean=_a(s["mean"]), running_var=_a(s["var"]))
        return out
    if kind == "gLN":
        return {"gamma": _a(p["gamma"]), "beta": _a(p["beta"])}
    if kind == "gGN":
        return {"weight": _a(p["gamma"]), "bias": _a(p["beta"])}
    raise NotImplementedError(kind)


def lstm(p) -> Flat:
    f = p["fwd"]
    return {"weight_ih_l0": _a(f["w_ih"]).T.copy(),
            "weight_hh_l0": _a(f["w_hh"]).T.copy(),
            "bias_ih_l0": _a(f["b_ih"]), "bias_hh_l0": _a(f["b_hh"])}


# --------------------------------------------------------------- composites
def _sub(tree: Optional[Mapping], key: str):
    return tree.get(key) if tree else None


def dsconv(p, s=None, norm_kind: str = "gGN") -> Flat:
    if "in_conv" in p or "skip_conv" in p:
        raise NotImplementedError("DSConv 1x1-in / skip is not ported yet")
    return _merge(*(
        _merge(_prefix(f"{prefix}.0", conv1d(p[f"{name}_conv"])),
               _prefix(f"{prefix}.1", norm(p[f"{name}_norm"],
                                           _sub(s, f"{name}_norm"), norm_kind)),
               _prefix(f"{prefix}.2", prelu(p[f"{name}_act"])))
        for name, prefix in (("dw", "depthwise"), ("pw", "pointwise"))))


def tcn(p, s=None, tcn_norm: str = "gLN", dconv_norm: str = "gGN") -> Flat:
    return _merge(
        _prefix("in_conv.0", conv1d(p["in_conv"])),
        _prefix("in_conv.1", norm(p["in_norm"], _sub(s, "in_norm"), tcn_norm)),
        _prefix("in_conv.2", prelu(p["in_act"])),
        _prefix("dconv.0", dsconv(p["dconv"], _sub(s, "dconv"), dconv_norm)),
        _prefix("out_conv", conv1d(p["out_conv"])))


def film(p) -> Flat:
    out = _merge(_prefix("cond_scale", conv1d(p["cond_scale"])),
                 _prefix("cond_bias", conv1d(p["cond_bias"])))
    if "norm" in p:
        out.update(_prefix("norm", layer_norm_last(p["norm"])))
    return out


def seg_lstm(p) -> Flat:
    return _merge(_prefix("lstm", lstm(p["lstm"])),
                  _prefix("proj", linear(p["proj"])),
                  _prefix("norm", layer_norm_last(p["norm"])))


def mem_lstm(p) -> Flat:
    return _merge(*(_prefix(f"{b}_{part}", fn(p[f"{b}_{part}"]))
                    for b in ("h", "c")
                    for part, fn in (("net", lstm), ("proj", linear),
                                     ("norm", layer_norm_last))))


def skim(p) -> Flat:
    parts = []
    for key in sorted(p):
        kind, _, idx = key.rpartition("_")
        if kind == "seg_lstm":
            parts.append(_prefix(f"seg_lstm.{idx}", seg_lstm(p[key])))
        elif kind == "mem_lstm":
            parts.append(_prefix(f"mem_lstm.{idx}", mem_lstm(p[key])))
        elif kind == "seg_input_fusion":
            if "cond_scale" not in p[key]:
                raise NotImplementedError("Gate fusion is not ported yet")
            parts.append(_prefix(f"seg_input_fusion.{idx}", film(p[key])))
    parts += [_prefix("output_fc.0", prelu(p["out_act"])),
              _prefix("output_fc.1", conv1d(p["out_conv"]))]
    return _merge(*parts)


def asp(p, s=None) -> Flat:
    return _merge(_prefix("tdnn.0", conv1d(p["tdnn_conv"])),
                  _prefix("tdnn.2", norm(p["tdnn_bn"], _sub(s, "tdnn_bn"))),
                  _prefix("conv", conv1d(p["conv"])))


def free_encdec(p) -> Flat:
    return {"encoder.weight": _a(p["enc_w"]), "decoder.weight": _a(p["dec_w"])}


def speaker_net_layer(p, s=None) -> Flat:
    if "dconv" in p:
        return tcn(p, s)
    if "tdnn_conv" in p:
        return asp(p, s)
    if "w" in p:
        return conv1d(p)
    raise NotImplementedError(f"speaker-net layer with keys {sorted(p)}")


def so_wrapper_tse_skim(variables: Mapping) -> Flat:
    """A TSE SoTaskWrapModule (FreeEncDec + SkiM + speaker net)."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    parts = [_prefix("encoder", free_encdec(p["encoder"])),
             _prefix("masker", skim(p["masker"]))]
    for key in p:
        if key.startswith("speaker_net_"):
            i = key.rsplit("_", 1)[1]
            parts.append(_prefix(f"speaker_net.{i}",
                                 speaker_net_layer(p[key], s.get(key))))
    return _merge(*parts)


def params_by_name(tree: Mapping) -> Flat:
    """A params-shaped pytree of a TSE SoTaskWrapModule (its params, a
    gradient, an optimizer moment) -> {port parameter name: array}, each
    laid out as the port's parameter (kernels transposed, as the weights
    are), so gradients and updated parameters compare name by name."""
    return so_wrapper_tse_skim({"params": tree})


def from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables ({"params", "batch_stats"}) of a TSE SoTaskWrapModule
    (or StreamingTSE) -> state_dict."""
    return to_torch(so_wrapper_tse_skim(variables))
