"""Carry weights into the port's modules.

The port's modules use the reference's torch key space — the one the key
maps of asva_tpu/convert/torch_to_jax.py map from — so a torch-layout state
dict (the reference's checkpoints, or asva_tpu's
`convert/jax_to_torch.py:export_state_dict(params, <key map>)` output) loads
with `load_state_dict(strict=True)`.

Shape fixes beyond that export's own re-layout (`_adapt`): 1x1
convolutions that asva_tpu holds as Dense (the VAE's quant_conv /
post_quant_conv) come out as (o, i) and are held here, as in the
reference checkpoints, as (o, i, 1, 1); a Linear stored as a 1x1 conv and
an (n,) vector stored as (1, n) are squeezed.

The published files of the metric nets and the audio tower name their keys
in a second key space, which the key maps of asva_tpu/convert/
torch_to_jax.py also accept (their later candidates): the raw
`imagebind_huge.pth` (every modality, `modality_*.<modality>.` prefixes,
the audio stem as `rgbt_stem` or `audio_stem`), pytorch-fid's InceptionV3
with its classifier, and the stylegan-v TorchScript I3D's branch names.
`to_port_keys` renames such a state dict into the port's key space through
one alias table per space (`SOURCE_SPACES`), `from_port_keys` renames the
port's keys back into a space's published names, `load_report` says whether
a state dict fits a module (the keys converted, missing, allowed to be
missing, unexpected, dropped by the space, and the shape mismatches)
without loading anything, and `load_source_state` loads it strictly on
that report's decision.  `detect_bn_eps` / `extract_state_and_eps` read a
TorchScript blob (the port's copy of asva_tpu/convert/torchscript.py).

The networks with BatchNorm (AVSync classifier, I3D, InceptionV3) keep
their running statistics in flax's `batch_stats` collection, outside
`params`; the key maps drop both prefixes and name the leaves
`running_mean` / `running_var`, so exporting the whole variables dict
({"params": ..., "batch_stats": ...}) yields every real key.  torch's
`num_batches_tracked` counters have no JAX source: `load_exported` keeps the
module's own value for exactly those keys and stays strict for all others.

An optax AdamW state exported the same way loads into the port's optimizer
(`load_exported_adam_state`), so a run can move between the two packages;
`load_exported_sync_state` carries a whole classifier training state
(parameters, BatchNorm running statistics, Adam moments, step) across.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _adapt(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The shape adaptations of asva_tpu/convert/torch_to_jax.py:47-79 in
    torch layout: a Linear or 1x1 conv stored as the other, a (1, n) vector
    for an (n,) one.  Both sides are torch layouts, so a Linear weight is
    never transposed (a square one would pass a shape check either way)."""
    if tuple(t.shape) == shape:
        return t
    if len(shape) == 4 and t.dim() == 2 and shape[2:] == (1, 1):
        return t[:, :, None, None]
    if len(shape) == 2 and t.dim() == 4 and tuple(t.shape[2:]) == (1, 1):
        return t[:, :, 0, 0]
    if len(shape) == 1 and t.dim() == 2 and t.shape[0] == 1:
        return t[0]
    return t


def load_exported(module: nn.Module, state: Dict[str, np.ndarray],
                  strict: bool = True) -> nn.Module:
    """Load a {torch key: numpy array or tensor} state dict into `module`,
    casting to each parameter's dtype and device.  Returns the module."""
    own = module.state_dict()
    tensors = {}
    for key, value in state.items():
        t = (value if torch.is_tensor(value)
             else torch.from_numpy(np.array(value)))  # a writable copy
        target = own.get(key)
        if target is not None:
            t = _adapt(t, tuple(target.shape)).to(dtype=target.dtype,
                                                   device=target.device)
        tensors[key] = t
    for key, value in own.items():
        if key.endswith(".num_batches_tracked") and key not in tensors:
            tensors[key] = value
    module.load_state_dict(tensors, strict=strict)
    return module


def load_exported_adam_state(optimizer, mu: Dict[str, np.ndarray],
                             nu: Dict[str, np.ndarray], count: int) -> None:
    """Load an optax AdamW state into the port's optimizer
    (`training.optim.AdamW`): `mu` and `nu` are the first and second moments
    of the trainable subtree as {torch key: torch-layout numpy array} (the
    moment trees passed through asva_tpu's `export_state_dict` like the
    parameters), `count` the number of steps taken."""
    state = {"count": int(count), "mu": {}, "nu": {}}
    for name, p in zip(optimizer.names, optimizer.params):
        for kind, tree in (("mu", mu), ("nu", nu)):
            if name not in tree:
                raise KeyError(f"no {kind} for trainable parameter {name}")
            arr = np.asarray(tree[name])
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{kind}[{name}]: shape {arr.shape}, "
                                 f"expected {tuple(p.shape)}")
            state[kind][name] = torch.from_numpy(np.array(arr))
    extra = (set(mu) | set(nu)) - set(optimizer.names)
    if extra:
        raise KeyError(f"moments for non-trainable parameters: "
                       f"{sorted(extra)[:8]}")
    optimizer.load_state_dict(state)


def load_exported_sync_state(state, variables: Dict[str, np.ndarray],
                             mu: Dict[str, np.ndarray],
                             nu: Dict[str, np.ndarray], count: int,
                             step: int) -> None:
    """Load asva_tpu's `SyncTrainState` into the port's
    (`training.sync_trainer.SyncTrainState`): `variables` is the export of
    {"params": ..., "batch_stats": ...} through `avsync_key_map`, `mu`/`nu`
    the exports of the optax Adam moments of `params`, `count` the
    optimizer's step count and `step` the trainer's."""
    load_exported(state.classifier, variables)
    load_exported_adam_state(state.optimizer, mu, nu, count)
    state.step = int(step)


# ---------------------------------------------------------------------------
# second source key spaces -> the port's key space
# ---------------------------------------------------------------------------

_IB_PARTS = ("preprocessors", "trunks", "heads", "postprocessors")


def _imagebind(modality: str, export_prefixes: Optional[dict] = None):
    """Keep one modality of a raw imagebind_huge state dict; with
    `export_prefixes` ({part: prefix}) its `modality_<part>s.<modality>.`
    prefixes become those of the port's module."""
    def rename(key):
        m = re.match(r"^modality_(\w+?)\.(\w+)\.", key)
        if m is None:
            return key
        if m.group(1) not in _IB_PARTS or m.group(2) != modality \
                or m.group(1) == "postprocessors":
            return None               # another modality, or the logit scale
        if export_prefixes is None:
            return key
        return export_prefixes[m.group(1)] + key[m.end():]
    return rename


_AUDIO_EXPORT = {"preprocessors": "preprocessor.", "trunks": "trunk.",
                 "heads": "head."}


def _audio_key(key):
    key = _imagebind("audio", _AUDIO_EXPORT)(key)
    if key is None or key.startswith("postprocessor."):
        return None
    return key.replace(".audio_stem.", ".rgbt_stem.")


def _first_present(alternatives):
    """Rename `old` to `new` only where the state has no `new` key (the
    key maps' later candidates)."""
    def fix(state):
        for old, new in alternatives:
            for key in [k for k in state if old in k]:
                target = key.replace(old, new)
                if target not in state:
                    state[target] = state.pop(key)
        return state
    return fix


# I3D: pytorch-i3d's names are the port's; the stylegan-v blob's differ
_I3D_ALIASES = ((".batch3d.", ".bn."), (".b1.0.", ".b1a."),
                (".b1.1.", ".b1b."), (".b2.0.", ".b2a."),
                (".b2.1.", ".b2b."), (".b3.1.", ".b3b."))


def _i3d_key(key):
    for old, new in _I3D_ALIASES:
        key = key.replace(old, new)
    return key


# space -> (key rename or None to drop, whole-state fix, keys that may be
# missing after the rename: a layer the reference initialises fresh)
SOURCE_SPACES = {
    # the HF CLIPTextModel file of SD1.5: position_ids is an index buffer,
    # not a weight (asva_tpu's gate allows it unused)
    "clip_text": (lambda k: None if k.endswith("embeddings.position_ids")
                  else k, None, ()),
    # asva_tpu/convert/torch_to_jax.py:233-296 (the audio export or the raw
    # imagebind_huge.pth; the segment tower's final_layer_norm is fresh)
    "imagebind_audio": (_audio_key, None, ("final_layer_norm.",)),
    # :340-363: the stem conv at proj.1 (after PadIm2Video) or proj.0
    "imagebind_vision": (_imagebind("vision"), _first_present(
        [(".rgbt_stem.proj.0.", ".rgbt_stem.proj.1.")]), ()),
    # :366-385: the final LayerNorm in the head or after the trunk
    "imagebind_text": (_imagebind("text"), _first_present(
        [("modality_trunks.text.post_transformer_layer.0.",
          "modality_heads.text.proj.0.")]), ()),
    # :313 pytorch-fid / torchvision names; the 1008-way classifier and
    # torchvision's auxiliary head are not part of the feature net
    "inception_v3": (lambda k: None if k.startswith(("fc.", "AuxLogits."))
                     else k, None, ()),
    # :299 pytorch-i3d or the stylegan-v TorchScript blob
    "i3d": (_i3d_key, None, ()),
}


def to_port_keys(state: Dict, space: str) -> Tuple[Dict, tuple]:
    """(the state dict renamed into the port's key space through the alias
    table of `space`, the key prefixes that may be missing from it)."""
    rename, fix, may_miss = SOURCE_SPACES[space]
    out = {}
    for key, value in state.items():
        new = rename(key)
        if new is not None:
            out[new] = value
    return (fix(out) if fix else out), may_miss


def _to_raw_audio(key):
    for part, prefix in _AUDIO_EXPORT.items():
        if key.startswith(prefix):
            return f"modality_{part}.audio." + key[len(prefix):]
    return key


# space -> the rename of the port's keys into the space's published names
# (the first candidate of asva_tpu's key map, as its export writes them);
# the other spaces already name their tensors as the port does
_EXPORT_RENAMES = {"imagebind_audio": _to_raw_audio}


def from_port_keys(state: Dict, space: str) -> Dict:
    """The inverse of `to_port_keys`: the port's state dict under the
    published names of `space` (the raw imagebind_huge.pth's
    `modality_*.audio.` prefixes for the audio tower; pytorch-fid's,
    pytorch-i3d's, the raw file's vision and text names and HF CLIP's are
    the port's own).  Keys outside the space's tensors (the segment
    tower's final_layer_norm) keep their names, so that
    to_port_keys(from_port_keys(s, space), space) == s; a writer of the raw
    file leaves them out, as the published file has none."""
    if space not in SOURCE_SPACES:
        raise KeyError(f"unknown key space {space!r}")
    rename = _EXPORT_RENAMES.get(space, lambda k: k)
    return {rename(k): v for k, v in state.items()}


@dataclasses.dataclass
class LoadReport:
    """Whether a state dict fits a module, decided once for the loaders
    and the weights gate.  Keys are the port's (after the space's rename)
    except `dropped`, the file's keys the space's alias table drops (other
    modalities of imagebind_huge.pth, pytorch-fid's classifier, CLIP's
    position_ids).  `missing` holds the module's keys the state lacks that
    may not be missing; `missing_allowed` those that may (the space's
    prefixes, or with `graft` every `_temp`/`_audio` key at once);
    BatchNorm's num_batches_tracked counters are never required.
    `mismatched`: (key, the file's shape, the module's) where even
    `_adapt` cannot make them agree.  `state` is the renamed state dict,
    ready for `load_exported`."""
    converted: list
    missing: list
    missing_allowed: list
    unexpected: list
    dropped: list
    mismatched: list
    state: dict

    def counts(self) -> str:
        return (f"{len(self.converted)} converted, "
                f"{len(self.missing) + len(self.missing_allowed)} fresh, "
                f"{len(self.unexpected) + len(self.dropped)} unused, "
                f"{len(self.mismatched)} mismatched")


def graft_keys(keys) -> set:
    """The temporal and audio layers' keys among `keys`: what a 2D SD1.5
    UNet file lacks (the `from_pretrained_2d` graft)."""
    from .training.optim import TRAINABLE_SEGMENTS
    return {k for k in keys if TRAINABLE_SEGMENTS & set(k.split("."))}


def load_report(module: nn.Module, state: Dict, space: Optional[str] = None,
                graft: bool = False) -> LoadReport:
    """What loading `state` (in the key space `space`, or the port's own)
    into `module` would do, without loading or raising (see LoadReport).
    `graft`: the `_temp`/`_audio` keys may be missing, all of them or
    none."""
    allowed, dropped = (), []
    if space is not None:
        rename = SOURCE_SPACES[space][0]
        dropped = sorted(k for k in state if rename(k) is None)
        state, allowed = to_port_keys(state, space)
    own = module.state_dict()
    missing = sorted(k for k in own if k not in state
                     and not k.endswith(".num_batches_tracked"))
    free = {k for k in missing if k.startswith(allowed)}
    grafted = graft_keys(own) if graft else set()
    if grafted and grafted <= set(missing):
        free |= grafted
    mismatched, converted = [], []
    for key, value in state.items():
        target = own.get(key)
        if target is None:
            continue
        shape = tuple(target.shape)
        got = tuple((value if torch.is_tensor(value)
                     else torch.as_tensor(np.asarray(value))).shape)
        if got != shape and tuple(_adapt(torch.empty(got, device="meta"),
                                         shape).shape) != shape:
            mismatched.append((key, got, shape))
        else:
            converted.append(key)
    return LoadReport(
        converted=sorted(converted),
        missing=[k for k in missing if k not in free],
        missing_allowed=[k for k in missing if k in free],
        unexpected=sorted(set(state) - set(own)), dropped=dropped,
        mismatched=mismatched, state=state)


def load_source_state(module: nn.Module, state: Dict,
                      space: str) -> nn.Module:
    """Rename `state` from `space` into the port's keys, adapt shapes and
    load it strictly: an unexpected key, or a missing one outside the
    space's prefixes that may be missing, raises KeyError."""
    report = load_report(module, state, space)
    if report.unexpected or report.missing:
        raise KeyError(f"{space}: the state does not fit the module: "
                       f"missing {report.missing[:8]}, unexpected "
                       f"{report.unexpected[:8]}")
    return load_exported(module, report.state,
                         strict=not report.missing_allowed)


# ---------------------------------------------------------------------------
# TorchScript blobs (asva_tpu/convert/torchscript.py)
# ---------------------------------------------------------------------------

def detect_bn_eps(module) -> Optional[float]:
    """Best-effort BatchNorm epsilon of a torch.jit module: the `.eps`
    attributes of its (recursively) scripted BatchNorm submodules, else the
    constants feeding the 8th argument of aten::batch_norm /
    aten::instance_norm in the inlined graph (a traced module bakes eps as
    prim::Constant).  The value if all call sites agree, the most common
    one if not (ties: the smallest), None if no BatchNorm is found."""
    values = []
    stack = [module]
    while stack:
        m = stack.pop()
        stack.extend(m.children())
        eps = getattr(m, "eps", None)
        if isinstance(eps, float):
            values.append(eps)
    if not values:
        try:
            graph = str(module.inlined_graph)
        except Exception:
            graph = ""
        consts = {
            name: float(val)
            for name, val in re.findall(
                r"(%[\w.]+)\s*:\s*float\s*=\s*prim::Constant\[value="
                r"([0-9eE.+-]+)\]", graph)
        }
        for call in re.finditer(
                r"aten::(?:batch_norm|instance_norm)\(([^)]*)\)", graph):
            args = [a.strip() for a in call.group(1).split(",")]
            if len(args) >= 8 and args[7] in consts:
                values.append(consts[args[7]])
    if not values:
        return None
    counts = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    return sorted(counts, key=lambda v: (-counts[v], v))[0]


def extract_state_and_eps(blob_path: str):
    """(float32 state dict, detected BatchNorm eps or None) of a jit
    blob."""
    module = torch.jit.load(blob_path, map_location="cpu")
    state = {k: v.float() for k, v in module.state_dict().items()}
    return state, detect_bn_eps(module)
