"""The port's checkpoints: save / restore, retention, the layout sidecar, the
stage graft (against the JAX package's ``graft_params``), and a resume that
is bit-for-bit an uninterrupted run, on the CPU at 64x128."""

import os

import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import (
    build_model,
    init_state,
    make_train_step,
)
from unsupervised_depth_opticalflow_egomotion_torch.utils import checkpoint as tckpt
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import name_table
from unsupervised_depth_opticalflow_egomotion_tpu.utils.checkpoint import (
    graft_params as j_graft_params,
)

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

H, W = 64, 128


def _cfg(**kw):
    base = dict(img_hw=(H, W), batch_size=2, compute_dtype="float32", ssim_impl="xla")
    base.update(kw)
    return Config(**base)


def _fake_step(model, opt, seed):
    """An Adam step on seeded gradients and moved BatchNorm statistics: the
    state a checkpoint holds, without a train step's cost."""
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen))


def _state(model, opt):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {id_: {k: v.clone() for k, v in s.items()} for id_, s in opt.state_dict()["state"].items()})


def _assert_state_equal(a, b):
    (ma, oa), (mb, ob) = a, b
    assert ma.keys() == mb.keys() and oa.keys() == ob.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


def test_save_restore_round_trip(tmp_path):
    """Parameters, buffers, the Adam state and the step come back equal; the
    file holds CPU copies; the sidecar records the schema and the meta."""
    cfg = _cfg(fix_pose=True)
    model, opt = init_state(cfg, "cpu")
    _fake_step(model, opt, 0)
    _fake_step(model, opt, 1)
    saved = _state(model, opt)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    layout = tckpt.opt_layout_tag(fix_pose=True)
    mgr.save(7, model, opt, meta={"opt_layout": layout, "mode": "geom", "img_hw": [H, W]})
    assert mgr.steps() == [7] and mgr.latest_step() == 7
    meta = mgr.load_meta()
    assert meta == {"schema_version": tckpt.SCHEMA_VERSION, "opt_layout": layout,
                    "mode": "geom", "img_hw": [H, W]}
    raw = mgr.load()
    assert raw["step"] == 7 and all(v.device.type == "cpu" for v in raw["model"].values())
    assert not [n for n in os.listdir(mgr.directory) if ".tmp" in n]

    model2, opt2 = init_state(cfg, "cpu")
    key = "depth_net.encoder.encoder.conv1.weight"
    assert not torch.equal(model2.state_dict()[key], saved[0][key])
    step = mgr.restore(model2, opt2, expect_opt_layout=layout)
    assert step == 7
    _assert_state_equal(_state(model2, opt2), saved)
    assert int(opt2.state_dict()["state"][0]["step"]) == 2
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore(model2, opt2)


def test_at_most_five_kept(tmp_path):
    cfg = _cfg()
    model, opt = init_state(cfg, "cpu")
    mgr = tckpt.CheckpointManager(str(tmp_path))
    for step in (2, 4, 6, 8, 10, 12, 14):
        mgr.save(step, model, opt)
    assert mgr.steps() == [6, 8, 10, 12, 14]
    assert sorted(os.listdir(tmp_path)) == sorted(f"{s}.pt" for s in (6, 8, 10, 12, 14))
    assert tckpt.CheckpointManager(str(tmp_path), max_to_keep=2).steps() == [6, 8, 10, 12, 14]


def test_layout_mismatch_raises_before_any_load(tmp_path):
    """Every fix_* combination has its own tag; a checkpoint of another
    layout is refused from the sidecar, before its file is read (here it is
    not even a checkpoint)."""
    tags = {tckpt.opt_layout_tag(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)}
    assert len(tags) == 8
    cfg = _cfg()
    model, opt = init_state(cfg, "cpu")
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(3, model, opt, meta={"opt_layout": tckpt.opt_layout_tag(fix_flow=True)})
    with open(mgr.path(3), "wb") as f:
        f.write(b"not a checkpoint")
    before = _state(model, opt)
    with pytest.raises(RuntimeError, match="optimizer layout.*fix_flow/fix_depth/fix_pose"):
        mgr.restore(model, opt, expect_opt_layout=tckpt.opt_layout_tag())
    _assert_state_equal(_state(model, opt), before)
    with pytest.raises(Exception):  # the same layout goes on to read the file
        mgr.restore(model, opt, expect_opt_layout=tckpt.opt_layout_tag(fix_flow=True))


def _flax_tree(sd):
    """The JAX package's params tree (flax layouts) of a port state_dict,
    and each leaf's port name, by ``name_table``."""
    tree, names = {}, {}
    for kind, tname, fpath in name_table(3):
        node = tree
        for part in fpath.split("/"):
            node = node.setdefault(part, {})
        leaves = ({"scale": ".weight", "bias": ".bias"} if kind == "bn"
                  else {"kernel": ".weight", "bias": ".bias"})
        for leaf, suffix in leaves.items():
            if tname + suffix not in sd:
                continue
            a = sd[tname + suffix].numpy()
            if leaf == "kernel":
                a = a.transpose((2, 3, 1, 0) if kind == "conv" else (1, 0))
            node[leaf] = np.array(a)
            names[f"{fpath}/{leaf}"] = tname + suffix
    return tree, names


def test_graft_copies_params_not_buffers_like_jax():
    """A donor built at another img_hw (PoseNet's Q/K/V shapes differ), with
    one key missing and one unknown: the port copies exactly the parameters
    that the JAX ``graft_params`` copies on the same names, and no buffer."""
    target = build_model(_cfg(), "cpu")
    donor_model = build_model(_cfg(img_hw=(128, 256), seed=5), "cpu")
    with torch.no_grad():
        for name, b in donor_model.named_buffers():
            b.add_(1.0)
    donor = dict(donor_model.state_dict())
    del donor["fpyramid.conv1.0.weight"]
    donor["extra.weight"] = torch.ones(3)
    fresh = {k: v.clone() for k, v in target.state_dict().items()}

    copied = tckpt.graft_params(target, donor)

    after = target.state_dict()
    params = dict(target.named_parameters())
    mismatched = {k for k in params if k in donor and donor[k].shape != params[k].shape}
    assert mismatched == {f"pose_net.{n}_fc.{p}" for n in ("query", "key", "value")
                          for p in ("weight", "bias")}
    assert set(copied) == set(params) - mismatched - {"fpyramid.conv1.0.weight"}
    for k in params:
        assert torch.equal(after[k], donor[k] if k in copied else fresh[k]), k
    for k, _ in target.named_buffers():
        assert torch.equal(after[k], fresh[k]) and not torch.equal(after[k], donor[k]), k

    # the JAX graft on the same names selects the same leaves
    t_tree, t_names = _flax_tree(fresh)
    d_tree, _ = _flax_tree({k: v for k, v in donor.items() if k != "extra.weight"})
    d_tree["extra"] = {"kernel": np.ones(3)}
    j_out = _flat(j_graft_params(t_tree, d_tree))
    d_flat = _flat(d_tree)
    from_donor = {t_names[p] for p, leaf in j_out.items() if p in d_flat and leaf is d_flat[p]}
    assert from_donor == set(copied)
    assert set(t_names.values()) == set(params)


def _flat(tree, prefix=""):
    """{"a/b/leaf": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v
    return out


def _batches(n, b=2):
    rng = np.random.RandomState(0)
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    tile = lambda x: torch.from_numpy(np.tile(x[None], (b, 1, 1, 1)))  # noqa: E731
    return [(torch.from_numpy((rng.rand(b, 3 * H, W, 3) * 255).astype(np.uint8)),
             tile(K_ms), tile(K_inv_ms)) for _ in range(n)]


def test_resume_is_bit_for_bit(tmp_path):
    """Flow mode, b2: two steps, a save, a restore into a fresh model and
    optimizer and one more step give the parameters, buffers and Adam state
    of three straight steps, bit for bit."""
    cfg = _cfg(mode="flow", flow_occ_impl="splat")
    batches = _batches(3)

    model, opt = init_state(cfg, "cpu")
    step = make_train_step(model, cfg, opt)
    for batch in batches:
        step(batch)
    straight = _state(model, opt)

    model, opt = init_state(cfg, "cpu")
    step = make_train_step(model, cfg, opt)
    for batch in batches[:2]:
        step(batch)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(2, model, opt, meta={"opt_layout": tckpt.opt_layout_tag()})
    del model, opt, step

    model, opt = init_state(cfg, "cpu")
    assert mgr.restore(model, opt, expect_opt_layout=tckpt.opt_layout_tag()) == 2
    step = make_train_step(model, cfg, opt)
    step(batches[2])
    _assert_state_equal(_state(model, opt), straight)


def test_restore_keeps_adam_capturable_as_built(tmp_path):
    """A state saved by a graphed step's Adam (``capturable``, which the
    step turns on at its capture) restores into a fresh Adam that stays
    torch's default, with its state as saved and its step counts on the
    CPU; the flag follows the optimizer restored into, not the saving run."""
    cfg = _cfg(mode="depth")
    model, opt = init_state(cfg, "cpu")
    _fake_step(model, opt, 3)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, model, opt)
    path = mgr.path(1)
    saved = torch.load(path, weights_only=True)
    for g in saved["optimizer"]["param_groups"]:
        g["capturable"] = True
    torch.save(saved, path)

    model2, opt2 = init_state(cfg, "cpu")
    assert mgr.restore(model2, opt2) == 1
    assert all(g["capturable"] is False for g in opt2.param_groups)
    assert all(st["step"].device.type == "cpu" for st in opt2.state.values())
    _assert_state_equal(_state(model2, opt2), _state(model, opt))
    _fake_step(model, opt, 4)
    _fake_step(model2, opt2, 4)
    _assert_state_equal(_state(model2, opt2), _state(model, opt))
