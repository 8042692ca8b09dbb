"""The port's program spans (``utils/profiler.span``) in its training step
on the CPU, at 64x128.

- Spans off: with no profiler session, ``span`` never enters
  ``record_function`` and the step runs.
- Spans on: under ``torch.profiler`` (CPU), one step of each mode gives
  its spans, each once, nested as the train step and the model place them.
- Same arithmetic: every loss of the pack and ``loss_total`` are bitwise
  equal with and without a profiler session.
- The data-parallel step's ``train_step.allreduce`` (a one-rank gloo group).
"""

import copy

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import torch_dp_workers as dpw
from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import (
    build_model,
    make_optimizer,
    make_train_step,
)
from unsupervised_depth_opticalflow_egomotion_torch.utils import profiler

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

B = 2
MODES = {
    "geom": dict(mode="geom"),
    "geom_sampled": dict(mode="geom", enable_triangle=True, enable_pnp=True,
                         enable_eight_point=True),
    "flow": dict(mode="flow", flow_occ_impl="splat_nn"),
    "flow_diff": dict(mode="flow", flow_occ_impl="diff_weights"),
    "depth": dict(mode="depth"),
}
STEP = ("train_step.forward", "train_step.backward", "train_step.optimizer")
NETS = {"geom": ("net.depth", "net.pose", "net.pyramid", "net.pwc"),
        "flow": ("net.pyramid", "net.pwc"), "depth": ("net.depth", "net.pose")}
LOSS = {"geom": ("loss.recon", "loss.flow_warps", "loss.masks", "loss.terms"),
        "flow": ("loss.flow_warps", "loss.masks", "loss.terms"),
        "depth": ("loss.recon", "loss.masks", "loss.terms")}


def expected(name: str) -> dict:
    """Each span of mode ``name`` with the program span it nests in."""
    mode = MODES[name]["mode"]
    want = {"train_step": None, **{s: "train_step" for s in STEP}}
    want.update({s: "train_step.forward" for s in NETS[mode] + LOSS[mode]})
    if name == "geom_sampled":
        want.update({"train_step.draws": "train_step", "loss.sampled": "train_step.forward"})
    if name == "flow_diff":
        del want["loss.masks"]  # the occlusion weights are the masks
    return want


def _cfg(name: str) -> Config:
    return Config(img_hw=(dpw.H, dpw.W), batch_size=B, compute_dtype="float32",
                  **MODES[name])


def _batch():
    return tuple(torch.from_numpy(a) for a in dpw.batch(B))


def _step(model, cfg, group=None):
    return make_train_step(model, cfg, make_optimizer(cfg, model), group)


def is_span(name: str) -> bool:
    return name == "train_step" or name.startswith(("train_step.", "net.", "loss."))


def program_spans(prof) -> list:
    """(name, start, end, the enclosing program span's name) of every program
    span of the session."""
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if is_span(e.name)), key=lambda s: (s[1], -s[2]))
    out = []
    for name, s, e in spans:
        inside = [o for o in out if o[1] <= s and e <= o[2]]
        out.append((name, s, e, max(inside, key=lambda o: o[1])[0] if inside else None))
    return out


@pytest.fixture(scope="module", params=sorted(MODES))
def stepped(request):
    """One step of the mode with spans off (``record_function`` made to
    raise on a program span's name) and one from the same state under a CPU
    profiler session."""
    cfg = _cfg(request.param)
    model = build_model(cfg, "cpu")
    twin = copy.deepcopy(model)
    batch = _batch()

    real = torch.profiler.record_function

    def refuse(name, *args, **kwargs):
        # torch's optimizer opens ranges of its own whatever the session
        if is_span(name):
            raise AssertionError(f"record_function({name!r}) entered with no profiler session")
        return real(name, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        off = _step(model, cfg)(batch, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _step(twin, cfg)(batch, 0)
    return request.param, off, on, program_spans(prof)


def test_spans_off_run_the_step(stepped):
    off = stepped[1]
    assert torch.isfinite(off["loss_total"])
    assert profiler.span("train_step", 3) is profiler.span("net.depth")


def test_spans_on_each_once_and_nested(stepped):
    name, spans = stepped[0], stepped[3]
    got = {}
    for span, _, _, parent in spans:
        assert span not in got, f"{span} opened twice in one step"
        got[span] = parent
    assert got == expected(name)


def test_same_arithmetic_with_and_without_a_session(stepped):
    _, off, on, _ = stepped
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_allreduce_span_in_a_group(tmp_path):
    """The step over a process group (one gloo rank) opens
    ``train_step.allreduce`` inside ``train_step``."""
    cfg = _cfg("flow")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        step = _step(build_model(cfg, "cpu"), cfg, dist.group.WORLD)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(_batch(), 0)
    finally:
        dist.destroy_process_group()
    got = {span: parent for span, _, _, parent in program_spans(prof)}
    assert got == {**expected("flow"), "train_step.allreduce": "train_step"}
