"""Model export on `torch.export`, shared by the recipes' `export_model`
action (counterpart of puresound_tpu/utils/export.py, which writes
StableHLO).

Every task family writes the same artifacts as JAX's (`_subnet_fns`
`:21-107`, `_stream_step_fn` `:110-166`), where the model has them:

- ``EncoderNet``, ``decoderNet``, ``MaskNet`` and ``FullModel`` (the whole
  offline inference); a TSE model with a speaker net adds ``SpeakerNet``;
  an embedding-free model has no ``SpeakerNet`` / ``MaskNet`` split;
- ``StreamStep``: one chunk of the streaming engine, the state dict in and
  out. Its state comes from `stream_state`, which carries SkiM's segment
  clock as a 0-d tensor (the engine's `init_state` keeps a host int).

Each artifact is `torch.export.export` of a small wrapper module at JAX's
static shapes (a 5 s dummy, a chunk of 4 hops), saved with
`torch.export.save` to ``{save_dir}/{tag}.{Name}.pt2``. The model is traced
under `torch.no_grad()` on its own device, so the LSTM scans and TCN blocks
are the `puresound_tpu_torch::` ops (`ops.lstm_train_kernel`,
`ops.tcn_train_kernel`): an artifact exported and run on the card launches
the CUDA kernels, on the CPU their plain versions. `torch.export.load` needs
the ops registered: import `puresound_tpu_torch` first. Call a loaded
artifact's `module()` under `torch.no_grad()`.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

from ..nnet.base_nn import SiMoTaskWrapModule


class Artifact(nn.Module):
    """`fn(owner, *args)` as a module that holds `owner`, so that its
    parameters and buffers are the exported program's."""

    def __init__(self, owner: nn.Module, fn: Callable):
        super().__init__()
        self.owner = owner
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.owner, *args)


def _tensor_clock(state, device):
    """`state` with every `frame_count` (SkiM's segment clock) a 0-d int64
    tensor on `device`."""
    if isinstance(state, dict):
        return {k: (torch.tensor(v, dtype=torch.int64, device=device)
                    if k == "frame_count" else _tensor_clock(v, device))
                for k, v in state.items()}
    return state


def stream_state(engine, batch: int = 1, dtype=torch.float32, device=None, **init_kw) -> dict:
    """The state an exported StreamStep takes: `engine.init_state` with
    SkiM's clock as a tensor, so the artifact crosses segment boundaries."""
    if device is None:
        device = next(engine.parameters()).device
    return _tensor_clock(engine.init_state(batch, dtype, device, **init_kw), device)


def _subnets(model, dummy_wav) -> Dict[str, Tuple[nn.Module, tuple]]:
    """Name -> (wrapper module, example args) for every sub-net."""
    if isinstance(model, SiMoTaskWrapModule):
        feats = model._encode(dummy_wav)
        masks = model.masker(feats)                        # [N, M, C, T]
        return {
            "EncoderNet": (Artifact(model, lambda m, wav: m._encode(wav)), (dummy_wav,)),
            "MaskNet": (Artifact(model.masker, lambda m, f: m(f)), (feats,)),
            "decoderNet": (Artifact(model, lambda m, f: m._decode_multi(f)),
                           (torch.zeros_like(masks),)),
            "FullModel": (Artifact(model, lambda m, wav: m.inference(wav)), (dummy_wav,)),
        }
    feats = model._encode(dummy_wav)
    out = {"EncoderNet": (Artifact(model, lambda m, wav: m._encode(wav)), (dummy_wav,)),
           "decoderNet": (Artifact(model, lambda m, f: m._decode(f)), (feats,))}
    full = Artifact(model, lambda m, *a: m.inference(*a))
    # an input of its own: export would fold one tensor passed twice into
    # one graph input
    dummy_enroll = dummy_wav.clone()
    if model.embedding_free_tse:
        # the conditioning is the masker's initial recurrent state: no
        # SpeakerNet / MaskNet split
        out["FullModel"] = (full, (dummy_wav, dummy_enroll))
    elif model.speaker_net is not None:
        spk = Artifact(model, lambda m, wav: m.inference_tse_embedding(wav))
        dvec = model.inference_tse_embedding(dummy_wav)
        dv = dvec.squeeze(-1) if dvec.dim() == 3 else dvec
        out["SpeakerNet"] = (spk, (dummy_wav,))
        out["MaskNet"] = (Artifact(model.masker, lambda m, f, d: m(f, d)), (feats, dv))
        out["FullModel"] = (full, (dummy_wav, dummy_enroll))
    else:
        out["MaskNet"] = (Artifact(model.masker, lambda m, f: m(f)), (feats,))
        out["FullModel"] = (full, (dummy_wav,))
    return out


def _stream_step(model, sample_rate: int) -> Tuple[nn.Module, tuple]:
    """(wrapper module, example args) of the streaming step. Raises
    TypeError for a model without an engine and ValueError for one its
    engine refuses (a non-causal SkiM / UnetTcn, a UnetFsmn with right
    context, a DPRNN whose segments the 4-hop chunk does not fill)."""
    from ..streaming.engine import StreamingTSE
    from ..streaming.file_eval import build_engine, check_chunk_frames
    from ..streaming.ns_engine import StreamingNS
    from ..streaming.simo_engine import StreamingDSS

    engine = build_engine(model)
    device = next(model.parameters()).device
    chunk = torch.zeros((1, 4 * model.encoder.hop_length), device=device)
    state0 = stream_state(engine)
    if isinstance(engine, StreamingDSS):
        return Artifact(engine, lambda e, c, s: e.step(c, s)), (chunk, state0)
    conditioned = model.speaker_net is not None
    if isinstance(engine, StreamingNS):
        if not conditioned:
            return Artifact(engine, lambda e, c, s: e.step(c, s)), (chunk, state0)
        dvec = engine.embed(torch.zeros((1, sample_rate), device=device))
        return Artifact(engine, lambda e, c, s, d: e.step(c, s, d)), (chunk, state0, dvec)
    if isinstance(engine, StreamingTSE):
        check_chunk_frames(engine, chunk.shape[1], sample_rate)
        if not conditioned:
            # embedding-free: the conditioning is carried in the state
            return Artifact(engine, lambda e, c, s: e.step(c, None, s)), (chunk, state0)
        dvec = engine.embed(torch.zeros((1, sample_rate), device=device))
        return Artifact(engine, lambda e, c, d, s: e.step(c, d, s)), (chunk, dvec, state0)
    raise TypeError(f"no streaming export for engine {type(engine).__name__}")


def export_program(model, sample_rate: int, save_dir: str, tag: str) -> List[str]:
    """Export every artifact of the eval `model`, on its own device, to
    ``{save_dir}/{tag}.{Name}.pt2`` (a model whose engine refuses to stream
    gets no StreamStep, and the reason is printed); returns the paths."""
    device = next(model.parameters()).device
    paths = []
    with torch.no_grad():
        dummy_wav = torch.zeros((1, sample_rate * 5), device=device)
        exports = _subnets(model, dummy_wav)
        try:
            exports["StreamStep"] = _stream_step(model, sample_rate)
        except (TypeError, ValueError) as e:
            print(f"streaming step not exportable for this model: {e}")
        # the graphs keep no Python stack trace a node (a quarter of the
        # tracing and saving time, and the exporting machine's paths) where
        # this torch has the switch
        keep = getattr(torch.fx.config, "do_not_emit_stack_traces", None)
        if keep is not None:
            torch.fx.config.do_not_emit_stack_traces = True
        try:
            for name, (module, args) in exports.items():
                path = f"{save_dir}/{tag}.{name}.pt2"
                torch.export.save(torch.export.export(module, args), path)
                print(f"exported {name}: {path} ({os.path.getsize(path)} bytes)")
                paths.append(path)
        finally:
            if keep is not None:
                torch.fx.config.do_not_emit_stack_traces = keep
    return paths


def op_nodes(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """Calls of the `puresound_tpu_torch::` ops in an exported graph and its
    `torch.cond` branches, by op name."""
    counts: Dict[str, int] = {}
    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            name = str(node.target)
            if node.op == "call_function" and name.startswith("puresound_tpu_torch."):
                key = name.split(".")[1]
                counts[key] = counts.get(key, 0) + 1
    return counts
