"""JAX (flax) variables -> this package's state_dict.

The inverse of the converters in puresound_tpu/utils/torch_import.py: the
port keeps PureSound's module and parameter names, so the flax tree maps
onto them one module type at a time. Leaves may be numpy or jax arrays
(anything `np.asarray` takes); this module never imports jax.

    sd = from_jax(variables)               # a whole TSE (SkiM, ConvTasNet, DPRNN,
                                           # UnetTcn / UnetFsmn) / NS wrapper or the
                                           # DSS SIMO one
    model.load_state_dict(sd)
    grads = params_by_name(jax_grads)      # {name: array} like the params
    model.load_state_dict(for_model(sd, model))   # a checkpoint with extra keys

The per-module converters take (params, batch_stats) subtrees and return a
flat {name: np.ndarray} dict; `to_torch` turns one into tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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
    """LSTM `fwd` (and `bwd`, torch's `*_reverse` set) LSTMCellParams, or a
    GRU's / RNN's `cell_f` (and `cell_b`): the same four tensors."""
    out = {}
    for d, sfx in (("fwd", ""), ("bwd", "_reverse"), ("cell_f", ""), ("cell_b", "_reverse")):
        if d in p:
            c = p[d]
            out.update({f"weight_ih_l0{sfx}": _a(c["w_ih"]).T.copy(),
                        f"weight_hh_l0{sfx}": _a(c["w_hh"]).T.copy(),
                        f"bias_ih_l0{sfx}": _a(c["b_ih"]),
                        f"bias_hh_l0{sfx}": _a(c["b_hh"])})
    return out


def conv_stft(p) -> Flat:
    return {"wsin": _a(p["wsin"]), "wcos": _a(p["wcos"])}


# --------------------------------------------------------------- composites
def _sub(tree: Optional[Mapping], key: str):
    return tree.get(key) if tree else None


def _conv_norm_act(p, s, name: str, prefix: str, norm_kind: str) -> Flat:
    """flax's `{name}_conv` / `_norm` / `_act` -> PureSound's Sequential
    `{prefix}.0` / `.1` / `.2`."""
    return _merge(_prefix(f"{prefix}.0", conv1d(p[f"{name}_conv"])),
                  _prefix(f"{prefix}.1", norm(p[f"{name}_norm"], _sub(s, f"{name}_norm"),
                                              norm_kind)),
                  _prefix(f"{prefix}.2", prelu(p[f"{name}_act"])))


def dsconv(p, s=None, norm_kind: str = "gGN") -> Flat:
    """DepthwiseSeparableConv1d, with the 1x1-in (`in_conv`) and the skip
    (`skip_conv`) where the tree has them."""
    parts = [_conv_norm_act(p, s, name, prefix, norm_kind)
             for name, prefix in (("in", "in_conv"), ("dw", "depthwise"), ("pw", "pointwise"))
             if f"{name}_conv" in p]
    if "skip_conv" in p:
        parts.append(_prefix("skip_conv", conv1d(p["skip_conv"])))
    return _merge(*parts)


def tcn(p, s=None, tcn_norm: str = "gLN", dconv_norm: str = "gGN") -> Flat:
    return _merge(
        _prefix("in_conv.0", conv1d(p["in_conv"])),
        _prefix("in_conv.1", norm(p["in_norm"], _sub(s, "in_norm"), tcn_norm)),
        _prefix("in_conv.2", prelu(p["in_act"])),
        _prefix("dconv.0", dsconv(p["dconv"], _sub(s, "dconv"), dconv_norm)),
        _prefix("out_conv", conv1d(p["out_conv"])))


def gated_tcn(p, s=None, tcn_norm: str = "gLN") -> Flat:
    """GatedTCN: `left_conv` / `right_conv` are Sequential(conv, norm,
    PReLU); FiLM's `cond_scale` / `cond_bias` where the tree has them."""
    return _merge(*(_prefix(k, conv1d(p[k])) for k in ("in_conv", "out_conv", "cond_scale",
                                                       "cond_bias") if k in p),
                  *(_conv_norm_act(p, s, side, f"{side}_conv", tcn_norm)
                    for side in ("left", "right")))


def tcn_block(p, s=None) -> Flat:
    """A TCN or a GatedTCN block, told apart by its keys."""
    return tcn(p, s) if "dconv" in p else gated_tcn(p, s)


def fsmn(p, s=None, norm_kind: str = "gLN") -> Flat:
    """FSMN / ConditionFSMN: flax's raw kernels -> the 1x1 / depthwise convs
    `in_proj`, `ctx_conv`, `out_proj` (+ `embed_proj`, or FiLM's
    `cond_scale` / `cond_bias`) and `out_norm`."""
    names = {"in_proj_w": "in_proj.weight", "ctx_w": "ctx_conv.weight",
             "out_proj_w": "out_proj.weight", "out_proj_b": "out_proj.bias",
             "embed_proj_w": "embed_proj.weight", "cond_scale_w": "cond_scale.weight",
             "cond_bias_w": "cond_bias.weight"}
    return _merge({names[k]: _a(v) for k, v in p.items() if k in names},
                  _prefix("out_norm", norm(p["out_norm"], _sub(s, "out_norm"), norm_kind)))


def film(p) -> Flat:
    out = _merge(_prefix("cond_scale", conv1d(p["cond_scale"])),
                 _prefix("cond_bias", conv1d(p["cond_bias"])))
    if "norm" in p:
        out.update(_prefix("norm", layer_norm_last(p["norm"])))
    return out


def gate(p) -> Flat:
    """Gate (the inverse of torch_import.gate): left_conv / right_conv are
    Sequential(conv, cLN, PReLU)."""
    parts = [_prefix("in_conv", conv1d(p["in_conv"])),
             _prefix("out_conv", conv1d(p["out_conv"]))]
    for side in ("left", "right"):
        parts += [_prefix(f"{side}_conv.0", conv1d(p[f"{side}_conv"])),
                  _prefix(f"{side}_conv.1", norm(p[f"{side}_norm"], kind="gLN")),
                  _prefix(f"{side}_conv.2", prelu(p[f"{side}_act"]))]
    return _merge(*parts)


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
            fusion = film if "cond_scale" in p[key] else gate
            parts.append(_prefix(f"seg_input_fusion.{idx}", fusion(p[key])))
    parts += [_prefix("output_fc.0", prelu(p["out_act"])),
              _prefix("output_fc.1", conv1d(p["out_conv"]))]
    return _merge(*parts)


def layer_norm_2d(p) -> Flat:
    """LayerNorm2D: its [1, CH, F, 1] `w` / `b` under the same names."""
    return {"w": _a(p["w"]), "b": _a(p["b"])}


def spectral_transform(p, s=None) -> Flat:
    """SpectralTransform: the three Conv2d (`in_conv`, `fft_conv`,
    `out_conv`) and the two BatchNorms with their running statistics
    (`in_bn`, `fft_bn`; flax's `batch_stats` in `s`)."""
    return _merge(*(_prefix(k, conv1d(p[k])) for k in ("in_conv", "fft_conv", "out_conv")),
                  *(_prefix(k, norm(p[k], _sub(s, k))) for k in ("in_bn", "fft_bn")))


def ffc(p, s=None) -> Flat:
    """FFC: `global_spec_trans`, the three Conv2d of the channel split and
    the two BatchNorms (`global_bn`, `local_bn`) with their statistics."""
    return _merge(
        _prefix("global_spec_trans", spectral_transform(p["global_spec_trans"],
                                                        _sub(s, "global_spec_trans"))),
        *(_prefix(k, conv1d(p[k]))
          for k in ("global_conv", "local_global_conv", "local_local_conv")),
        *(_prefix(k, norm(p[k], _sub(s, k))) for k in ("global_bn", "local_bn")))


def asp(p, s=None) -> Flat:
    return _merge(_prefix("tdnn.0", conv1d(p["tdnn_conv"])),
                  _prefix("tdnn.2", norm(p["tdnn_bn"], _sub(s, "tdnn_bn"))),
                  _prefix("conv", conv1d(p["conv"])))


def free_encdec(p) -> Flat:
    return {"encoder.weight": _a(p["enc_w"]), "decoder.weight": _a(p["dec_w"])}


def single_rnn(p) -> Flat:
    """SingleRNN: an LSTM's cells under `rnn`, a GRU's / RNN's `cell_f` /
    `cell_b` beside `proj` (JAX `rnn.py:305-312`); PureSound's `rnn`."""
    return _merge(_prefix("rnn", lstm(p.get("rnn", p))), _prefix("proj", linear(p["proj"])))


def speaker_net_layer(p, s=None) -> Flat:
    """A speaker-net layer with parameters: TCN, GatedTCN (the Unet speaker
    net's), ASP, the 1x1 conv or the SingleRNN (`tse_skim_v1_causal`'s)."""
    if "dconv" in p:
        return tcn(p, s)
    if "left_conv" in p:
        return gated_tcn(p, s)
    if "tdnn_conv" in p:
        return asp(p, s)
    if "rnn" in p or "cell_f" in p:
        return single_rnn(p)
    if "w" in p:
        return conv1d(p)
    raise NotImplementedError(f"speaker-net layer with keys {sorted(p)}")


def fbank_enc(p) -> Flat:
    """A trainable FbankEnc: its STFT kernels and the two mel maps."""
    return _merge(_prefix("stft", conv_stft(p["stft"])),
                  {k: _a(p[k]) for k in ("filterbank", "inv_filterbank")})


def speaker_loss(p) -> Flat:
    """The speaker loss's parameters: GE2E's scale `w` and bias `b`, or
    AAM-softmax's `weight` [n_class, input_dim], under the same names."""
    return {k: _a(v) for k, v in p.items()}


def _tse_wrapper(variables: Mapping, masker: Flat) -> Flat:
    """A TSE SoTaskWrapModule around its masker's tensors: the FreeEncDec
    (or the STFT-domain models' ConvEncDec), the speaker net, and the speaker
    loss's parameters where the tree has them."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    enc = p["encoder"]
    encoder = (free_encdec(enc) if "enc_w" in enc
               else _prefix("encoder", conv_stft(enc["encoder"])))
    parts = [_prefix("encoder", encoder), _prefix("masker", masker)]
    if "encoder_spk" in p:
        parts.append(_prefix("encoder_spk", fbank_enc(p["encoder_spk"])))
    if "loss_func_spk" in p:
        parts.append(_prefix("loss_func_spk", speaker_loss(p["loss_func_spk"])))
    parts += [_prefix(f"speaker_net.{key.rsplit('_', 1)[1]}",
                      speaker_net_layer(p[key], s.get(key)))
              for key in p if key.startswith("speaker_net_")]
    return _merge(*parts)


def so_wrapper_tse_skim(variables: Mapping) -> Flat:
    """A TSE SoTaskWrapModule with a SkiM masker."""
    return _tse_wrapper(variables, skim(variables["params"]["masker"]))


def conv_tasnet(p, s=None) -> Flat:
    """ConvTasNet's (or UnetTcn's) blocks: flax's `tcn_list_{r}_{i}` ->
    `tcn_list.{r}.{i}`, TCN or GatedTCN (BatchNorm's running statistics
    from `s`)."""
    return _merge(*(_prefix("tcn_list." + key[len("tcn_list_"):].replace("_", "."),
                            tcn_block(p[key], _sub(s, key)))
                    for key in p if key.startswith("tcn_list_")))


def so_wrapper_td_conv_tasnet(variables: Mapping) -> Flat:
    """A TSE SoTaskWrapModule with a ConvTasNet masker."""
    return _tse_wrapper(variables, conv_tasnet(variables["params"]["masker"],
                                               variables.get("batch_stats", {}).get("masker")))


def dprnn(p) -> Flat:
    """DPRNN: flax's `{part}_{i}` -> `{part}.{i}` (PureSound's module lists),
    the FiLMs where the tree has them."""
    parts = []
    for key in p:
        kind, _, i = key.rpartition("_")
        fn = {"input_film": film, "intra_rnn": lstm, "inter_rnn": lstm,
              "intra_proj": linear, "inter_proj": linear, "intra_norm": layer_norm_last,
              "inter_norm": layer_norm_last}.get(kind)
        if fn is not None:
            parts.append(_prefix(f"{kind}.{i}", fn(p[key])))
    parts += [_prefix("output_fc.0", prelu(p["out_act"])),
              _prefix("output_fc.1", conv1d(p["out_conv"]))]
    return _merge(*parts)


def so_wrapper_tse_dprnn(variables: Mapping) -> Flat:
    """A TSE SoTaskWrapModule with a DPRNN masker (`veve_dprnn_v0_causal`)."""
    return _tse_wrapper(variables, dprnn(variables["params"]["masker"]))


def dprnn_block2d(p) -> Flat:
    return _merge(*(_prefix(k, fn(p[k])) for k, fn in (
        ("intra_rnn", single_rnn), ("intra_norm", layer_norm_last),
        ("inter_rnn", single_rnn), ("inter_norm", layer_norm_last))))


def unet_updown(p, s=None) -> Flat:
    """The Unet's conv stacks in PureSound's Sequential layout: cnn_down[i]
    = [pad, Conv2d, norm, act, dropout], cnn_up[j] = [ConvTranspose2d, norm,
    act], skip_cnn[j] = [Conv2d, act] (`skip_conv`)."""
    parts = []
    for key in p:
        kind, _, i = key.rpartition("_")
        slot = {"cnn_down": ("cnn_down", 1), "down_norm": ("cnn_down", 2),
                "down_act": ("cnn_down", 3), "cnn_up": ("cnn_up", 0),
                "up_norm": ("cnn_up", 1), "up_act": ("cnn_up", 2),
                "skip_cnn": ("skip_cnn", 0), "skip_act": ("skip_cnn", 1)}.get(kind)
        if slot is None:
            continue
        name = f"{slot[0]}.{i}.{slot[1]}"
        if kind.endswith("norm"):
            parts.append(_prefix(name, norm(p[key], _sub(s, key))))
        elif kind.endswith("act"):
            parts.append(_prefix(name, prelu(p[key])))
        else:
            parts.append(_prefix(name, conv1d(p[key])))
    return _merge(*parts)


def unet_tcn(p, s=None) -> Flat:
    """UnetTcn: the Unet's stacks and the nested `tcn_list.{r}.{i}`."""
    return _merge(unet_updown(p, s), conv_tasnet(p, s))


def unet_fsmn(p, s=None) -> Flat:
    """UnetFsmn: the Unet's stacks and `fsmn_list.{i}`."""
    return _merge(unet_updown(p, s),
                  *(_prefix(f"fsmn_list.{key.rpartition('_')[2]}", fsmn(p[key], _sub(s, key)))
                    for key in p if key.startswith("fsmn_list_")))


def so_wrapper_tse_unet(variables: Mapping) -> Flat:
    """An STFT-domain TSE SoTaskWrapModule (ConvEncDec + UnetTcn / UnetFsmn
    + the speaker net) or its StreamingNS."""
    masker = variables["params"]["masker"]
    s = variables.get("batch_stats", {}).get("masker")
    fn = unet_fsmn if "fsmn_list_0" in masker else unet_tcn
    return _tse_wrapper(variables, fn(masker, s))


def dpcrn(p, s=None) -> Flat:
    return _merge(unet_updown(p, s),
                  *(_prefix(k, dprnn_block2d(p[k])) for k in ("dprnn_block1",
                                                             "dprnn_block2")))


def so_wrapper_ns_dpcrn(variables: Mapping) -> Flat:
    """An NS SoTaskWrapModule (ConvEncDec + DPCRN) or its StreamingNS."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    return _merge(_prefix("encoder.encoder", conv_stft(p["encoder"]["encoder"])),
                  _prefix("masker", dpcrn(p["masker"], s.get("masker"))))


def flax_layer_norm(p) -> Flat:
    """flax nn.LayerNorm (scale / bias) -> torch LayerNorm names."""
    return {"weight": _a(p["scale"]), "bias": _a(p["bias"])}


def mha_self_atten_layer(p) -> Flat:
    """MhaSelfAttenLayer: MHA under `self_atten.atten` (torch
    MultiheadAttention's names) and the norms; improved=False the
    feed-forward Sequential's Linears at 0 and 3, improved=True the LSTM
    `recurrent` and `ff2`."""
    ff = (_merge(_prefix("recurrent", lstm(p["recurrent"])), _prefix("ff2", linear(p["ff2"])))
          if "recurrent" in p else
          _merge(_prefix("feedforward.0", linear(p["ff1"])),
                 _prefix("feedforward.3", linear(p["ff2"]))))
    return _merge({"self_atten.atten.in_proj_weight": _a(p["self_atten"]["in_proj"]),
                   "self_atten.atten.out_proj.weight": _a(p["self_atten"]["out_proj"])},
                  _prefix("norm1", flax_layer_norm(p["norm1"])),
                  _prefix("norm2", flax_layer_norm(p["norm2"])), ff)


def dparn_block2d(p) -> Flat:
    return _merge(*(_prefix(k, fn(p[k])) for k, fn in (
        ("intra_atten1", mha_self_atten_layer), ("intra_atten2", mha_self_atten_layer),
        ("intra_fc", linear), ("intra_norm", layer_norm_last),
        ("inter_rnn", single_rnn), ("inter_norm", layer_norm_last))))


def dparn(p, s=None) -> Flat:
    return _merge(unet_updown(p, s),
                  *(_prefix(k, dparn_block2d(p[k])) for k in ("dprnn_block1",
                                                             "dprnn_block2")))


def so_wrapper_ns_dparn(variables: Mapping) -> Flat:
    """An NS SoTaskWrapModule (ConvEncDec + DPARN) or its StreamingNS."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    return _merge(_prefix("encoder.encoder", conv_stft(p["encoder"]["encoder"])),
                  _prefix("masker", dparn(p["masker"], s.get("masker"))))


def simo_wrapper_dss_dparn(variables: Mapping) -> Flat:
    """The DSS SiMoTaskWrapModule (ConvEncDec + DPARN_Mout) or its
    StreamingDSS: the tree of the NS DPARN wrapper, the last up conv's
    output channels M-fold."""
    return so_wrapper_ns_dparn(variables)


def params_by_name(tree: Mapping) -> Flat:
    """A params-shaped pytree of a SoTaskWrapModule (its params, a
    gradient, an optimizer moment) -> {port parameter name: array}, each
    laid out as the port's parameter (kernels transposed, as the weights
    are), so gradients and updated parameters compare name by name."""
    return flat_from_jax({"params": tree})


def flat_from_jax(variables: Mapping) -> Flat:
    """flax variables ({"params", "batch_stats"}) of a TSE (FreeEncDec +
    SkiM, ConvTasNet or DPRNN; a trainable FbankEnc `encoder_spk`; ConvEncDec
    + UnetTcn / UnetFsmn) or NS (ConvEncDec + DPCRN / DPARN)
    SoTaskWrapModule, of the DSS SiMoTaskWrapModule (ConvEncDec +
    DPARN_Mout), or of their streaming engines -> {state_dict name:
    np.ndarray}, told apart by the masker's keys (a DPARN and a DPARN_Mout
    share their names)."""
    masker = variables["params"]["masker"]
    if "cnn_down_0" in masker and ("tcn_list_0_0" in masker or "fsmn_list_0" in masker):
        return so_wrapper_tse_unet(variables)
    if "tcn_list_0_0" in masker:
        return so_wrapper_td_conv_tasnet(variables)
    if "intra_rnn_0" in masker:
        return so_wrapper_tse_dprnn(variables)
    if "dprnn_block1" in masker:
        if "intra_atten1" in masker["dprnn_block1"]:
            return so_wrapper_ns_dparn(variables)
        return so_wrapper_ns_dpcrn(variables)
    return so_wrapper_tse_skim(variables)


def from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """`flat_from_jax` as tensors: the state_dict of the same model."""
    return to_torch(flat_from_jax(variables))


_NORM_PAIRS = (("gamma", "weight"), ("beta", "bias"))


def _norm_names(state: Mapping[str, Any], names) -> Mapping[str, Any]:
    """flax's gamma / beta of a norm the tree does not name the kind of
    (`norm` reads them as a gLN's gamma / beta in a TCN's 1x1-in and as a
    GroupNorm's weight / bias in its depthwise / pointwise convs) under the
    names the model has: a cLN (gamma / beta) where the converter wrote a
    GroupNorm's, and the other way round."""
    have = set(names)
    out = dict(state)
    for n in names:
        if n in out:
            continue
        head, _, leaf = n.rpartition(".")
        for a, b in _NORM_PAIRS:
            other = {a: b, b: a}.get(leaf) if leaf in (a, b) else None
            if other and f"{head}.{other}" in out and f"{head}.{other}" not in have:
                out[n] = out.pop(f"{head}.{other}")
    return out


def for_model(state: Mapping[str, Any], model: torch.nn.Module) -> Dict[str, Any]:
    """The entries of `state` that `model`'s state_dict holds, as JAX's
    eval load keeps them (`serialization.from_state_dict` on the eval
    model's own tree, puresound_tpu/tasks/base.py:733-748): a key the model
    lacks is dropped (a training checkpoint's `loss_func_spk.*`, GE2E's w /
    b, in a model built without losses); a key of the model that `state`
    lacks raises."""
    names = list(model.state_dict())
    state = _norm_names(state, names)
    missing = [n for n in names if n not in state]
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} of the model's tensors, "
                       f"e.g. {missing[:3]}")
    return {n: state[n] for n in names}
