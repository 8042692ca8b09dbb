"""Data-parallel training of the port on the CPU: two spawned gloo ranks
(tests/torch_dp_workers.py, each rendezvous through a FileStore under the
test's temporary directory) against one process and against the JAX
package's mesh step.

- The depth step at global b2 64x128 f32 on two ranks (b1 each, so the
  BatchNorm statistics exist only over the global batch) against the JAX
  depth step under ``make_mesh(2)`` on the same weights and batch: the
  metrics, the updated parameters and ``batch_stats`` at
  tests/test_torch_modes.py's step tolerances.
- The geom step with the four optional losses and the flow step
  (``"splat"``) on two ranks against the port's one-process step on the
  global batch: metrics, gradients, parameters, running statistics and
  Adam moments.
- The synchronised ``BatchNorm`` alone against one ``BatchNorm`` on the
  concatenated batch; the draws of the sampled losses; the training CLI on
  two ranks; the refusals of ``num_devices`` and ``batch_size % world``;
  ``distributed_init``'s reading of torchrun's environment and of the JAX
  flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import torch_dp_workers as dpw
from unsupervised_depth_opticalflow_egomotion_torch import train as cli
from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.models.layers import BatchNorm
from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model
from unsupervised_depth_opticalflow_egomotion_torch.parallel import mesh as tmesh
from unsupervised_depth_opticalflow_egomotion_torch.parallel.train_step import step_draws
from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import (
    jax_state_dict,
    jax_variables,
)
from unsupervised_depth_opticalflow_egomotion_tpu.config import Config as JConfig
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import build_model as j_build_model
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import (
    make_optimizer as j_make_optimizer,
)
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import (
    make_train_step as j_make_train_step,
)
from unsupervised_depth_opticalflow_egomotion_tpu.parallel.mesh import make_mesh, shard_batch
from unsupervised_depth_opticalflow_egomotion_tpu.parallel.train_step import TrainState

pytestmark = pytest.mark.e2e
torch.set_num_threads(2)

B = 2  # the global batch
BASE = dict(img_hw=(dpw.H, dpw.W), batch_size=B, compute_dtype="float32")
GEO = dict(enable_triangle=True, enable_pnp=True, enable_eight_point=True,
           enable_depth_consis=True)
STEPS = {
    "depth": dict(BASE, mode="depth"),
    "flow": dict(BASE, mode="flow", flow_occ_impl="splat"),
    # the sampled losses are computed and reported, but weighted 0: at init
    # their gradients follow f32 rounding (see test_two_ranks_match_one_process)
    "geom": dict(BASE, mode="geom", **GEO, w_triangle=0.0, w_pnp=0.0, w_8point=0.0),
}
NETS = {"flow": ("fpyramid", "pwc_model"), "depth": ("depth_net", "pose_net"),
        "geom": ("depth_net", "pose_net", "fpyramid", "pwc_model")}
STATS = ("running_mean", "running_var")


def _rel(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's summary of one step of each configuration; rank 0's
    comparison with the one-process step, and its depth step's record."""
    out = tmp_path_factory.mktemp("dp_steps")
    return dpw.spawn_ranks(dpw.steps_job, (STEPS, NETS, ("depth",)), str(out))


def test_ranks_end_bit_equal(ranks):
    """Both ranks end with the same metrics (world means), parameters,
    running statistics and Adam moments, bit for bit (each applies the same
    all-reduced gradient), and the networks a mode does not train keep
    their parameters."""
    for r in ranks:
        for name in STEPS:
            assert r[name]["differing"] == 0 and r[name]["untouched"], name


@pytest.mark.parametrize("mode", ["geom", "flow"])
def test_two_ranks_match_one_process(ranks, mode):
    """The two-rank step against the one-process step on the global batch.
    Both run the same f32 arithmetic, split differently (the BatchNorm sums,
    the per-item convolutions, the gradient sums), so they differ by f32
    rounding, which the hard masks and the sampled geom losses amplify at
    init (tests/test_torch_geom.py). The tolerances are chip_smoke.py's
    phase 4 (the card against the CPU):

    - metrics: 1e-3 relative + 1e-7; the sampled losses, ill-conditioned in
      f32 at init: triangulation to 3e-2 relative, PnP to 0.2, the
      eight-point loss within its range [0, 2/9]. Their gradients through
      the flow and the pose are as ill-conditioned (two ranks against one
      process: 0.8 to 5 relative L2 error per network), so the geom step
      weights them 0: the gradients compared are those of the total
      without them, as phase 4 compares;
    - gradients and Adam's first moment: per network the relative L2 error
      under 2e-2 (tests/test_torch_modes.py's bar); the same parameters get
      gradients;
    - the second moment (the gradient squared): twice the first's bound;
    - parameters: Adam's first update is +-lr where |g| >> 1e-8, so every
      entry within 2 lr and under 2 % of a network's entries off by more
      than 0.1 lr; the other networks equal;
    - running statistics: 1e-5 of each tensor's max-abs.
    """
    cmp = ranks[0][mode]["vs_one_process"]
    got, want = cmp["metrics"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k == "loss_eight_point":
            assert 0 < got[k] <= 2 / 9 and 0 < w <= 2 / 9
            continue
        rtol = {"loss_triangle": 3e-2, "loss_pnp": 0.2}.get(k, 1e-3)
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=1e-7, err_msg=k)
    if mode == "geom":
        assert all(got[k] != 0 for k in (
            "loss_triangle", "loss_pnp", "loss_eight_point", "loss_depth_consis"))
    assert cmp["same_grads"] and cmp["others_equal"]
    bar = {"grads": 2e-2, "mu": 2e-2, "nu": 4e-2}
    assert {k for k, _ in cmp["rel"]} == set(bar) and {n for _, n in cmp["rel"]} == set(NETS[mode])
    for (what, net), err in cmp["rel"].items():
        assert err < bar[what], (what, net, err)
    for net, (worst, share) in cmp["params"].items():
        assert worst <= 2.0 * 1.001 and share < 0.02, net
    assert cmp["stats"] < 1e-5


@pytest.fixture(scope="module")
def jax_mesh_depth_step():
    """The JAX depth step under ``make_mesh(2)`` from the port's seed-built
    weights, on the global batch."""
    model = build_model(Config(**STEPS["depth"]), "cpu")
    params, stats = jax.tree_util.tree_map(np.array, jax_variables(model))
    jcfg = JConfig(**STEPS["depth"])
    tx = j_make_optimizer(jcfg, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(jparams))
    mesh = make_mesh(2)
    step = j_make_train_step(j_build_model(jcfg), jcfg, tx, mesh=mesh)
    new_state, metrics = step(state, shard_batch(dpw.batch(B), mesh), jax.random.PRNGKey(1))
    unravel = ravel_pytree(params)[1]
    return dict(
        before=model.state_dict(),
        metrics={k: float(v) for k, v in metrics.items()},
        mu=jax_state_dict(unravel(new_state.opt_state[0].mu), stats),
        after=jax_state_dict(jax.tree_util.tree_map(np.asarray, new_state.params),
                             jax.tree_util.tree_map(np.asarray, new_state.batch_stats)),
    )


def test_two_ranks_match_the_jax_mesh_depth_step(ranks, jax_mesh_depth_step):
    """tests/test_torch_modes.py's step tolerances: metrics 1e-3 relative +
    1e-7; Adam's first moment per network under 2e-2 relative L2; the
    trained parameters within 2 lr of JAX's, under 2 % of a network's
    entries off by more than 0.1 lr; the flow networks untouched in both;
    every running statistic moved and within 1e-4 of its max-abs."""
    got, j = ranks[0]["depth"]["record"], jax_mesh_depth_step
    assert ranks[0]["depth"]["untouched"]
    assert got["metrics"].keys() == j["metrics"].keys()
    for k, w in j["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-3, atol=1e-7, err_msg=k)
    lr = Config().lr
    stats = [k for k in j["after"] if k.endswith(STATS)]
    assert len(stats) == 40
    for k in stats:
        assert not torch.equal(got["after"][k], j["before"][k]), k
        scale = j["after"][k].abs().max()
        assert ((got["after"][k] - j["after"][k]).abs().max() / scale).item() < 1e-4, k
    for net in NETS["flow"]:
        for k in [k for k in j["after"] if k.startswith(net + ".")]:
            assert torch.equal(j["after"][k], j["before"][k]), k
    for net in NETS["depth"]:
        ks = [k for k in got["mu"] if k.startswith(net + ".")]
        a = torch.cat([got["mu"][k].flatten() for k in ks])
        b = torch.cat([j["mu"][k].flatten() for k in ks])
        assert _rel(a, b) < 2e-2, net
        ks = [k for k in j["after"] if k.startswith(net + ".") and not k.endswith(STATS)]
        d = torch.cat([(got["after"][k] - j["after"][k]).flatten() for k in ks])
        moved = torch.cat([(got["after"][k] - j["before"][k]).flatten() for k in ks])
        assert moved.abs().max() > 0.5 * lr
        assert d.abs().max() <= 2.0 * lr * 1.001, net
        assert (d.abs() > 0.1 * lr).float().mean() < 0.02, net


def test_synchronised_batch_norm_matches_the_concatenated_batch(tmp_path):
    """Two ranks' BatchNorm, forward and backward, against one BatchNorm on
    the concatenated batch, to 1e-6: the output, the input's gradient, the
    parameters' gradients summed over the ranks, and both running
    statistics (equal on the two ranks)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(4, 5, 6, 8) * 2.0 + 0.5).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 5, 6, 8).astype(np.float32))
    weight = torch.from_numpy(rng.rand(8).astype(np.float32) + 0.5)
    bias = torch.from_numpy(rng.randn(8).astype(np.float32))
    got = dpw.spawn_ranks(dpw.bn_job, (x, g, weight, bias), str(tmp_path))
    bn = BatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    xr = x.clone().requires_grad_()
    y = bn(xr)
    (y * g).sum().backward()
    want = dict(y=y.detach(), dx=xr.grad, dweight=bn.weight.grad, dbias=bn.bias.grad,
                running_mean=bn.running_mean, running_var=bn.running_var)
    for k in ("y", "dx"):
        np.testing.assert_allclose(torch.cat([r[k] for r in got]).numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("dweight", "dbias", "running_mean", "running_var"):
        for r in got:
            np.testing.assert_allclose(r[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_rank_draws_are_rows_of_the_global_draw(tmp_path):
    """Rank r's draws are rows [r b, (r + 1) b) of the one-process draw at
    the global batch, at every step, with the eight-point loss's too."""
    kw = dict(BASE, mode="geom", batch_size=4, **GEO)
    got = dpw.spawn_ranks(dpw.draws_job, (kw, 4, (0, 7)), str(tmp_path))
    model = build_model(Config(**kw), "cpu")
    whole = tuple(torch.from_numpy(x) for x in dpw.batch(4))
    for s in (0, 7):
        want = step_draws(model, s, whole)
        assert set(want) == {"bwd", "fwd", "8_bwd", "8_fwd"}
        for k, v in want.items():
            assert torch.equal(torch.cat([r[s][k] for r in got]), v), (s, k)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """8 stacked 3x64x128 PNGs, calib, train.txt (the CLI tests' dataset)."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("prepared")
    (root / "d").mkdir()
    rng = np.random.RandomState(0)
    (root / "calib.txt").write_text(
        "P_rect_02: 100.0 0.0 64.0 0.0 0.0 100.0 32.0 0.0 0.0 0.0 1.0 0.0\n")
    lines = []
    for i in range(8):
        cv2.imwrite(str(root / "d" / f"{i:06d}.png"),
                    rng.randint(0, 255, (3 * dpw.H, dpw.W, 3), np.uint8))
        lines.append(f"d/{i:06d}.png calib.txt\n")
    (root / "train.txt").write_text("".join(lines))
    return str(root)


def test_cli_on_two_ranks(prepared, tmp_path):
    """The training CLI on two CPU ranks, geom at global b2: 3 steps with a
    save at 2, then a resume to 4. In the group, ``num_devices`` 3 and a
    global batch of 3 raise on both ranks. Rank 0 alone writes (checkpoints,
    the logger, config.json) and prints; each step's metrics are the mean
    of the two ranks' local ones, and they are what log.pkl holds; both
    ranks end bit-equal. (A resumed run starts a new log.pkl, in one process
    too.)"""
    import pickle
    import shutil

    kw = dict(BASE, mode="geom", num_iterations=3, num_workers=1, log_interval=1,
              test_interval=0, save_interval=2, prepared_base_dir=prepared,
              model_dir=str(tmp_path / "run"))
    r0, r1 = dpw.spawn_ranks(dpw.cli_job, (kw, 4), str(tmp_path / "ranks"))
    for r in (r0, r1):
        assert "torchrun --nproc_per_node 3" in r["refusals"]["num_devices"]
        assert "must divide" in r["refusals"]["batch_size"]
        assert r["steps"] == (3, 4)
    assert r0["writes"] == {"save": 4, "logger": 2, "dump": 2}
    assert r1["writes"] == {"save": 0, "logger": 0, "dump": 0} and r1["printed"] == ""
    assert "training done" in r0["printed"] and "resumed from step 3" in r0["printed"]
    assert "x 2 ranks (gloo)" in r0["printed"]
    assert CheckpointManager(kw["model_dir"] + "/ckpt").steps() == [2, 3, 4]
    assert len(r0["reduced"]) == len(r1["reduced"]) == 4
    for (l0, m0), (l1, m1) in zip(r0["reduced"], r1["reduced"]):
        assert m0 == m1
        for k in m0:
            np.testing.assert_allclose(m0[k], (l0[k] + l1[k]) / 2, rtol=1e-6, err_msg=k)
    assert l0 != l1  # the ranks' shards differ
    with open(tmp_path / "run" / "log.pkl", "rb") as f:
        log = pickle.load(f)  # the resumed run's logger: step 4's record
    assert {k: [v for _, v in vals] for k, vals in log.items()} == {
        k: [v] for k, v in r0["reduced"][-1][1].items()}
    assert r0["differing"] == r1["differing"] == 0
    shutil.rmtree(tmp_path / "run")  # three checkpoints with Adam's moments


def test_one_process_refuses_one_of_many_cards(prepared, tmp_path, monkeypatch):
    """Without torchrun, ``num_devices`` 0 on a host with more than one card
    raises before anything runs, naming torchrun and ``--num_devices 1``;
    with ``--num_devices 1`` the card check passes (and the run then needs
    CUDA); on the CPU, or with one card, it does not apply."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    cfg = Config(**BASE, prepared_base_dir=prepared, model_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 4") as e:
        cli.train(cfg)
    assert "--num_devices 1" in str(e.value)
    cli.refuse_one_of_many_cards(cfg.replace(num_devices=1), None)
    cli.refuse_one_of_many_cards(cfg, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cli.refuse_one_of_many_cards(cfg, None)
    assert not (tmp_path / "ckpt").exists()


def test_distributed_init_reads_torchrun_and_the_jax_flags(monkeypatch):
    """Under torchrun's environment the group is ``env://`` with its rank
    and size (even for one process); otherwise the JAX flags give a
    ``tcp://`` group; gloo on the CPU unless a backend is named; one
    process with no flags, or an existing group, makes none; incomplete
    flags raise."""
    calls = []
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.distributed_init(device="cpu") == torch.device("cpu")
    assert tmesh.distributed_init("host:1234", 1, 0, device="cpu") == torch.device("cpu")
    assert calls == []
    tmesh.distributed_init("host:1234", 2, 1, device="cpu")
    tmesh.distributed_init("host:1234", 2, 0, device="cpu", backend="mpi")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    tmesh.distributed_init(device="cpu")
    timeout = tmesh.GROUP_TIMEOUT
    assert calls == [
        ("gloo", dict(init_method="tcp://host:1234", rank=1, world_size=2, timeout=timeout)),
        ("mpi", dict(init_method="tcp://host:1234", rank=0, world_size=2, timeout=timeout)),
        ("gloo", dict(init_method="env://", rank=0, world_size=1, timeout=timeout)),
    ]
    monkeypatch.delenv("RANK")
    for bad in (("", 2, 0), ("host:1234", 2, -1), ("host:1234", 2, 2)):
        with pytest.raises(ValueError, match="coordinator_address"):
            tmesh.distributed_init(*bad, device="cpu")
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setenv("RANK", "0")
    tmesh.distributed_init(device="cpu")
    assert len(calls) == 3
