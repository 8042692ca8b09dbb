"""The port's training step (``parallel/train_step.TrainStep``) on the CPU,
at 64x128 b2 f32.

- Where it stays op by op: on the CPU, in a process group and with the
  sampled geom losses the step never captures, its metrics and parameters
  are bit-equal to the eager body's, and Adam stays torch's default.
- The graph's logic with stand-ins for the card (the side stream a no-op,
  the capture a ``FakeGraph``): two eager calls, the capture at the third,
  replays after it, each replay on its own batch with fresh metrics.
- After the capture a batch the graph's buffers cannot take is refused.
- ``make_optimizer`` builds torch's default Adam; only a capture turns it
  ``capturable`` (the card tests check that on the card).
"""

import contextlib
import copy

import pytest
import torch
import torch.distributed as dist

import torch_dp_workers as dpw
from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import train_step as tts

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

H, W = 64, 128
SAMPLED = dict(enable_triangle=True, enable_pnp=True, enable_eight_point=True)


def port_cfg(**kw):
    return Config(img_hw=(H, W), batch_size=2, compute_dtype="float32", **kw)


def port_batches(n):
    """``n`` distinct batches (another seed each)."""
    return [tuple(torch.from_numpy(a) for a in dpw.batch(2, seed)) for seed in range(n)]


def twins(cfg, group=None):
    """Two models from the same weights, their Adam and their steps."""
    model = tts.build_model(cfg, "cpu")
    twin = copy.deepcopy(model)
    return [(m, tts.make_train_step(m, cfg, tts.make_optimizer(cfg, m), group)) for m in (model, twin)]


def refuse(*args, **kwargs):
    raise AssertionError("the step tried to use the card's stream or graph")


@pytest.mark.parametrize("case", ["cpu_flow", "cpu_geom", "group_flow", "sampled_geom"])
def test_port_step_stays_eager(case, monkeypatch, tmp_path):
    """On the CPU, with a process group, or with the sampled geom losses, the
    step never captures (for the group and the sampled losses even when the
    batch is taken to lie on a card), its metrics and parameters are
    bit-equal to those of the eager body called directly, and Adam stays
    torch's default."""
    where, mode = case.split("_")
    cfg = port_cfg(mode=mode, **(SAMPLED if where == "sampled" else {}))
    monkeypatch.setattr(tts, "_new_stream", refuse)
    monkeypatch.setattr(tts, "_capture", refuse)
    monkeypatch.setattr(tts, "_make_capturable", refuse)
    if where != "cpu":
        monkeypatch.setattr(tts, "_on_card", lambda batch: True)
    group = None
    if where == "group":
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                                rank=0, world_size=1)
        group = dist.group.WORLD
    try:
        (model, step), (twin, eager_twin) = twins(cfg, group)
        for i, batch in enumerate(port_batches(tts.WARMUP_CALLS + 2)):
            got, want = step(batch, i), eager_twin.eager(batch, i)
            assert got.keys() == want.keys()
            for k in got:
                assert torch.equal(got[k], want[k]), (i, k)
    finally:
        if group is not None:
            dist.destroy_process_group()
    assert step.graph is None and step.warm_calls == 0
    assert step.body_runs == tts.WARMUP_CALLS + 2
    assert all(g["capturable"] is False for g in step.optimizer.param_groups)
    for (k, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), k


class FakeGraph:
    """A stand-in for a captured graph: the capture records the work without
    its effects (the model's and Adam's tensors are put back), a replay runs
    it again into the captured outputs."""

    def __init__(self, fn, tensors):
        self.fn, self.replays = fn, 0
        saved = [t.detach().clone() for t in tensors]
        keys, self.out = fn()
        self.keys = keys
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)

    def replay(self):
        self.replays += 1
        out = self.fn()[1]
        with torch.no_grad():
            self.out.copy_(out)


def stand_in_card(monkeypatch, model, optimizer):
    """CPU tensors taken as the card's, the side stream a no-op and the
    capture a ``FakeGraph``; returns the graphs made and the optimizers
    made capturable (a CPU Adam cannot be: the flag is left as it is)."""
    graphs, made_capturable = [], []

    def capture(fn, stream):
        tensors = [*model.parameters(), *model.buffers(),
                   *(v for st in optimizer.state.values() for v in st.values()
                     if isinstance(v, torch.Tensor))]
        graphs.append(FakeGraph(fn, tensors))
        return graphs[-1], (graphs[-1].keys, graphs[-1].out)

    monkeypatch.setattr(tts, "_on_card", lambda batch: True)
    monkeypatch.setattr(tts, "_new_stream", lambda device: "side stream")
    monkeypatch.setattr(tts, "_side_stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(tts, "_capture", capture)
    monkeypatch.setattr(tts, "_make_capturable", made_capturable.append)
    return graphs, made_capturable


@pytest.mark.parametrize("mode", ["flow", "depth", "geom"])
def test_port_graph_logic_with_a_stand_in_card(mode, monkeypatch):
    """Two eager calls, the capture at the third (Adam made capturable there,
    once) and replays after it: each replay reads its own batch (its loss is
    that batch's eager loss, not the captured batch's), returns fresh
    tensors, and the parameters follow the eager twin's."""
    cfg = port_cfg(mode=mode)
    (model, step), (twin, eager_twin) = twins(cfg)
    graphs, made_capturable = stand_in_card(monkeypatch, model, step.optimizer)
    batches = port_batches(5)
    seen = []
    for i, batch in enumerate(batches):
        got, want = step(batch, i), eager_twin.eager(batch, i)
        assert step.warm_calls == min(i + 1, tts.WARMUP_CALLS)
        assert len(graphs) == (i >= tts.WARMUP_CALLS)
        assert made_capturable == ([step.optimizer] if i >= tts.WARMUP_CALLS else [])
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
        assert all(got[k].data_ptr() != v.data_ptr() for v in seen for k in got)
        seen.extend(got.values())
    assert graphs[0].replays == len(batches) - tts.WARMUP_CALLS
    for (k, p), q in zip(model.named_parameters(), twin.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.parametrize("change", ["smaller_batch", "float_images", "no_intrinsics"])
def test_port_graph_refuses_a_batch_it_cannot_take(change, monkeypatch):
    """After the capture, a batch of another shape, dtype or length than the
    captured one raises ``ValueError`` naming the captured batch, and
    neither runs the body nor replays the graph."""
    cfg = port_cfg(mode="flow")
    (model, step), _ = twins(cfg)
    graphs, _ = stand_in_card(monkeypatch, model, step.optimizer)
    batches = port_batches(tts.WARMUP_CALLS + 1)
    for i, batch in enumerate(batches):
        step(batch, i)
    images, K_ms, K_inv_ms = batches[0]
    bad = {"smaller_batch": (images[:1], K_ms[:1], K_inv_ms[:1]),
           "float_images": (images.float(), K_ms, K_inv_ms),
           "no_intrinsics": (images, K_ms)}[change]
    runs, replays = step.body_runs, graphs[0].replays
    with pytest.raises(ValueError, match="captured for batches"):
        step(bad, len(batches))
    assert step.body_runs == runs and graphs[0].replays == replays


@pytest.mark.parametrize("kw", [dict(mode="flow"), dict(mode="geom", fix_flow=True),
                                dict(mode="depth", fix_pose=True)])
def test_port_make_optimizer_is_torch_default_adam(kw):
    """``make_optimizer`` builds torch's default Adam (not capturable),
    whatever the mode and the parameters it holds; only a capture turns it
    capturable."""
    cfg = port_cfg(**kw)
    opt = tts.make_optimizer(cfg, tts.build_model(cfg, "cpu"))
    assert opt.param_groups and all(g["capturable"] is False for g in opt.param_groups)
    default = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=cfg.lr).param_groups[0]
    assert {k: v for k, v in opt.param_groups[0].items() if k != "params"} == \
        {k: v for k, v in default.items() if k != "params"}
