"""Load the JAX package's variables into the port's ``JointModel``.

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
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch


def name_table(num_scales: int = 3, extra_head_scales: int = 0) -> Iterator[tuple[str, str, str]]:
    """(kind, torch module name, flax path) for every mapped layer.

    ``kind`` is "conv", "linear" or "bn". Convs with a bias in the flax tree
    map their bias too.
    """
    for i in range(12):
        yield "conv", f"fpyramid.conv{i + 1}.0", f"fpyramid/ConvLReLU_{i}/Conv_0"
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

    for i in range(7):
        yield "conv", f"pose_net.net.{i}", f"pose_net/Conv_{i}/Conv_0"
    yield "conv", "pose_net.pose_conv", "pose_net/Conv_7/Conv_0"
    for i in range(4):
        yield "conv", f"pose_net.refine_net.{i}", f"pose_net/Conv_{8 + i}/Conv_0"
    yield "conv", "pose_net.refine_pose_conv", "pose_net/Conv_12/Conv_0"
    for name in ("query_fc", "key_fc", "value_fc"):
        yield "linear", f"pose_net.{name}", f"pose_net/{name}"

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


def _node(tree: Mapping, path: str, used: set, prefix: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    used.add(f"{prefix}/{path}")
    return node


def _leaf_paths(tree: Mapping, prefix: str) -> set:
    out = set()
    for k, v in tree.items():
        p = f"{prefix}/{k}"
        if isinstance(v, Mapping):
            out |= _leaf_paths(v, p)
        else:
            out.add(p.rsplit("/", 1)[0])
    return out


def jax_state_dict(params: Mapping, batch_stats: Mapping, num_scales: int = 3,
                   extra_head_scales: int = 0) -> dict:
    """The port's state_dict (name -> f32 tensor) from the JAX variables."""
    used: set = set()
    sd = {}

    def t(a, perm=None):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.array(a if perm is None else a.transpose(perm)))

    for kind, name, path in name_table(num_scales, extra_head_scales):
        node = _node(params, path, used, "params")
        if kind == "bn":
            sd[f"{name}.weight"] = t(node["scale"])
            sd[f"{name}.bias"] = t(node["bias"])
            stats = _node(batch_stats, path, used, "batch_stats")
            sd[f"{name}.running_mean"] = t(stats["mean"])
            sd[f"{name}.running_var"] = t(stats["var"])
            continue
        sd[f"{name}.weight"] = t(node["kernel"], (3, 2, 0, 1) if kind == "conv" else (1, 0))
        if "bias" in node:
            sd[f"{name}.bias"] = t(node["bias"])
    unused = (_leaf_paths(params, "params") | _leaf_paths(batch_stats, "batch_stats")) - used
    if unused:
        raise ValueError(f"unmapped JAX variables: {sorted(unused)[:8]}")
    return sd


def _heads(model: torch.nn.Module) -> tuple[int, int]:
    dec = model.depth_net.decoder
    return dec.num_scales, len(dec.dispconvs) - dec.num_scales


def load_jax_variables(model: torch.nn.Module, params: Mapping, batch_stats: Mapping) -> None:
    """Load the JAX package's ``params`` / ``batch_stats`` into ``model`` strictly."""
    sd = jax_state_dict(params, batch_stats, *_heads(model))
    model.load_state_dict(sd, strict=True)


def jax_variables(model: torch.nn.Module) -> tuple[dict, dict]:
    """The other way: (params, batch_stats) as the JAX package's nested dicts
    of f32 numpy arrays, from ``model``'s state_dict."""
    sd = model.state_dict()
    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaf, value):
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node[leaf] = value.detach().float().cpu().numpy()

    for kind, name, path in name_table(*_heads(model)):
        if kind == "bn":
            put(params, path, "scale", sd[f"{name}.weight"])
            put(params, path, "bias", sd[f"{name}.bias"])
            put(stats, path, "mean", sd[f"{name}.running_mean"])
            put(stats, path, "var", sd[f"{name}.running_var"])
            continue
        w = sd[f"{name}.weight"]
        put(params, path, "kernel", w.permute(2, 3, 1, 0) if kind == "conv" else w.t())
        if f"{name}.bias" in sd:
            put(params, path, "bias", sd[f"{name}.bias"])
    return params, stats
