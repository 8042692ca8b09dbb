"""Carry the JAX package's variables into the port's models and back.

The port's modules carry the reference's state_dict names, so the mapping
from the JAX package's flax tree is a table: this module's own copy of the
table in the JAX package's ``utils/torch_port.py`` (``port_model_geometry``),
read in the other direction. Layouts:

- flax conv kernel [kh, kw, I, O]  ->  torch Conv2d weight [O, I, kh, kw]
- flax Dense kernel [I, O]         ->  torch Linear weight [O, I]
- flax BatchNorm scale/bias (params) + mean/var (batch_stats)
    -> weight/bias + running_mean/running_var

``load_jax_variables`` takes the variables as nested dicts (or flax
FrozenDicts) of numpy arrays, and loads them strictly: every parameter and
buffer of the model must be set and every leaf of the tree must be used.
``jax_variables`` goes the other way. A model with the loss base scale's
extra disparity heads maps them to the JAX tree's ``ReflectConv3x3_x{s}``.
The models are ``JointModel``, ``TriangulationPoseModel`` and
``FlowPoseModel`` (each by the sub-networks it holds, one table group a
sub-network) and the two attention modules (their convs and ``gamma``).
A model with RAFT (``flow_net="raft"``) raises: the JAX package has none.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch


def _fpyramid_names():
    for i in range(12):
        yield "conv", f"fpyramid.conv{i + 1}.0", f"fpyramid/ConvLReLU_{i}/Conv_0"


def _pwc_names():
    # torch level order conv6..conv2 == flax DenseFlowBlock_0..4
    for blk, lvl in enumerate((6, 5, 4, 3, 2)):
        for j in range(5):
            yield (
                "conv",
                f"pwc_model.conv{lvl}_{j}.0",
                f"pwc/DenseFlowBlock_{blk}/ConvLReLU_{j}/Conv_0",
            )
        yield "conv", f"pwc_model.predict_flow{lvl}", f"pwc/DenseFlowBlock_{blk}/Conv_0/Conv_0"
    for j in range(6):
        yield "conv", f"pwc_model.dc_conv{j + 1}.0", f"pwc/ContextNet_0/ConvLReLU_{j}/Conv_0"
    yield "conv", "pwc_model.dc_conv7", "pwc/ContextNet_0/Conv_0/Conv_0"


def _pose_net_names():
    for i in range(7):
        yield "conv", f"pose_net.net.{i}", f"pose_net/Conv_{i}/Conv_0"
    yield "conv", "pose_net.pose_conv", "pose_net/Conv_7/Conv_0"
    for i in range(4):
        yield "conv", f"pose_net.refine_net.{i}", f"pose_net/Conv_{8 + i}/Conv_0"
    yield "conv", "pose_net.refine_pose_conv", "pose_net/Conv_12/Conv_0"
    for name in ("query_fc", "key_fc", "value_fc"):
        yield "linear", f"pose_net.{name}", f"pose_net/{name}"


def _depth_net_names(num_scales: int, extra_head_scales: int):
    enc, fenc = "depth_net.encoder.encoder", "depth_net/ResNet18Encoder_0"
    yield "conv", f"{enc}.conv1", f"{fenc}/Conv_0"
    yield "bn", f"{enc}.bn1", f"{fenc}/BatchNorm_0"
    blk = 0
    for layer in range(1, 5):
        for sub in range(2):
            t, f = f"{enc}.layer{layer}.{sub}", f"{fenc}/BasicBlock_{blk}"
            yield "conv", f"{t}.conv1", f"{f}/Conv_0"
            yield "bn", f"{t}.bn1", f"{f}/BatchNorm_0"
            yield "conv", f"{t}.conv2", f"{f}/Conv_1"
            yield "bn", f"{t}.bn2", f"{f}/BatchNorm_1"
            if layer > 1 and sub == 0:
                yield "conv", f"{t}.downsample.0", f"{f}/Conv_2"
                yield "bn", f"{t}.downsample.1", f"{f}/BatchNorm_2"
            blk += 1

    # upconvs[i] is scale 4-i; flax ConvBlock_{2i+j}
    dec = "depth_net/DepthDecoder_0"
    for i in range(5):
        for j in range(2):
            yield (
                "conv",
                f"depth_net.decoder.upconvs.{i}.{j}.conv.conv",
                f"{dec}/ConvBlock_{2 * i + j}/ReflectConv3x3_0/Conv_0",
            )
    # flax heads are created coarse to fine: ReflectConv3x3_k == dispconvs[ns-1-k]
    for k in range(num_scales):
        yield (
            "conv",
            f"depth_net.decoder.dispconvs.{num_scales - 1 - k}.conv",
            f"{dec}/ReflectConv3x3_{k}/Conv_0",
        )
    # the loss base scale's coarser heads keep their scale in the flax name
    for s in range(num_scales, num_scales + extra_head_scales):
        yield "conv", f"depth_net.decoder.dispconvs.{s}.conv", f"{dec}/ReflectConv3x3_x{s}/Conv_0"


def _flow_pose_net_names():
    # flax Conv_0..6 are conv1..conv7, Conv_7 the 1x1 head
    for i in range(7):
        yield "conv", f"flow_pose_net.conv{i + 1}", f"flow_pose_net/Conv_{i}/Conv_0"
    yield "conv", "flow_pose_net.pose_pred", "flow_pose_net/Conv_7/Conv_0"


def _attention_names(position: bool):
    if position:
        for name in ("query_conv", "key_conv", "value_conv"):
            yield "conv", name, name
    yield "scalar", "gamma", "gamma"


def name_table(num_scales: int = 3, extra_head_scales: int = 0) -> Iterator[tuple[str, str, str]]:
    """(kind, torch module name, flax path) for every mapped layer of the
    joint model.

    ``kind`` is "conv", "linear", "bn" or "scalar" (a parameter leaf of its
    own, torch name = flax path). Convs with a bias in the flax tree map
    their bias too.
    """
    yield from _fpyramid_names()
    yield from _pwc_names()
    yield from _pose_net_names()
    yield from _depth_net_names(num_scales, extra_head_scales)


def model_table(model: torch.nn.Module) -> list[tuple[str, str, str]]:
    """The table of ``model``: the joint model, ``TriangulationPoseModel``
    and ``FlowPoseModel`` by the sub-networks they hold, or one of the two
    attention modules."""
    if hasattr(model, "gamma"):
        return list(_attention_names(hasattr(model, "query_conv")))
    if hasattr(model, "raft"):
        raise TypeError("no JAX weight table for a model with RAFT (flow_net='raft'): "
                        "the JAX package has no RAFT")
    groups = {"fpyramid": _fpyramid_names, "pwc_model": _pwc_names,
              "pose_net": _pose_net_names, "flow_pose_net": _flow_pose_net_names}
    table = [row for name, group in groups.items() if hasattr(model, name) for row in group()]
    if hasattr(model, "depth_net"):
        dec = model.depth_net.decoder
        table += _depth_net_names(dec.num_scales, len(dec.dispconvs) - dec.num_scales)
    if not table:
        raise TypeError(f"no JAX weight table for {type(model).__name__}")
    return table


def _leaf_paths(tree: Mapping, prefix: str) -> set:
    out = set()
    for k, v in tree.items():
        p = f"{prefix}/{k}"
        if isinstance(v, Mapping):
            out |= _leaf_paths(v, p)
        else:
            out.add(p)
    return out


def _state_dict(params: Mapping, batch_stats: Mapping, table) -> dict:
    """The state_dict of ``table``'s layers from the JAX variables; every
    leaf of the tree must be used."""
    used: set = set()
    trees = {"params": params, "batch_stats": batch_stats}
    sd = {}

    def node(prefix, path):
        n = trees[prefix]
        for part in path.split("/"):
            n = n[part]
        return n

    def take(prefix, path, perm=None):
        used.add(f"{prefix}/{path}")
        a = np.asarray(node(prefix, path), np.float32)
        return torch.from_numpy(np.array(a if perm is None else a.transpose(perm)))

    for kind, name, path in table:
        if kind == "scalar":
            sd[name] = take("params", path)
        elif kind == "bn":
            sd[f"{name}.weight"] = take("params", f"{path}/scale")
            sd[f"{name}.bias"] = take("params", f"{path}/bias")
            sd[f"{name}.running_mean"] = take("batch_stats", f"{path}/mean")
            sd[f"{name}.running_var"] = take("batch_stats", f"{path}/var")
        else:
            perm = (3, 2, 0, 1) if kind == "conv" else (1, 0)
            sd[f"{name}.weight"] = take("params", f"{path}/kernel", perm)
            if "bias" in node("params", path):
                sd[f"{name}.bias"] = take("params", f"{path}/bias")
    unused = (_leaf_paths(params, "params") | _leaf_paths(batch_stats, "batch_stats")) - used
    if unused:
        raise ValueError(f"unmapped JAX variables: {sorted(unused)[:8]}")
    return sd


def jax_state_dict(params: Mapping, batch_stats: Mapping, num_scales: int = 3,
                   extra_head_scales: int = 0) -> dict:
    """The joint model's state_dict (name -> f32 tensor) from the JAX variables."""
    return _state_dict(params, batch_stats, name_table(num_scales, extra_head_scales))


def load_jax_variables(model: torch.nn.Module, params: Mapping,
                       batch_stats: Mapping | None = None) -> None:
    """Load the JAX package's ``params`` / ``batch_stats`` into ``model``
    (any model of ``model_table``) strictly."""
    sd = _state_dict(params, batch_stats or {}, model_table(model))
    model.load_state_dict(sd, strict=True)


def jax_variables(model: torch.nn.Module) -> tuple[dict, dict]:
    """The other way: (params, batch_stats) as the JAX package's nested dicts
    of f32 numpy arrays, from ``model``'s state_dict."""
    sd = model.state_dict()
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().float().cpu().numpy()

    for kind, name, path in model_table(model):
        if kind == "scalar":
            put(params, path, sd[name])
        elif kind == "bn":
            put(params, f"{path}/scale", sd[f"{name}.weight"])
            put(params, f"{path}/bias", sd[f"{name}.bias"])
            put(stats, f"{path}/mean", sd[f"{name}.running_mean"])
            put(stats, f"{path}/var", sd[f"{name}.running_var"])
        else:
            w = sd[f"{name}.weight"]
            put(params, f"{path}/kernel", w.permute(2, 3, 1, 0) if kind == "conv" else w.t())
            if f"{name}.bias" in sd:
                put(params, f"{path}/bias", sd[f"{name}.bias"])
    return params, stats
