"""The port's profiler (``utils/profiler.py``) on the CPU: the checkpoint
API and the summary format of the JAX package's ``Profiler``, and a
Chrome trace written by ``device_trace``."""

import json

import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.utils.profiler import Profiler, device_trace
from unsupervised_depth_opticalflow_egomotion_tpu.utils.profiler import Profiler as JProfiler

pytestmark = pytest.mark.quick
torch.set_num_threads(2)


def test_checkpoints_and_summary_as_jax(capsys):
    """Named intervals add up per name and count; ``report`` returns the
    interval and prints it unless silent; the summary lists names by total
    time, in the JAX package's format (the same timings give the same
    text)."""
    prof = Profiler(device="cpu")
    for name in ("load", "step", "step"):
        dt = prof.report(name)
        assert dt >= 0.0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[0].startswith("[profiler] load: ") and out[0].endswith(" ms")
    assert prof.counts == {"load": 1, "step": 2}
    jprof = JProfiler(silent=True)
    for p in (prof, jprof):
        p.timings = {"load": 0.25, "step": 1.5, "eval": 0.0125}
        p.counts = {"load": 1, "step": 3, "eval": 5}
    assert prof.summary() == jprof.summary()
    lines = prof.summary().splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == ["step", "load", "eval"]
    assert lines[0] == f"{'step':>24}: total {1.5:8.3f}s  avg {500.0:8.2f}ms  n=3"
    quiet = Profiler(silent=True, device="cpu")
    quiet.reset()
    quiet.report("x", sync=False)
    assert capsys.readouterr().out == ""


def test_profiler_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Profiler()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with device_trace("unused"):
            pass


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """The region's host ops in ``<logdir>/trace.json``."""
    with device_trace(str(tmp_path / "trace"), device="cpu") as path:
        x = torch.randn(64, 64)
        (x @ x).sum().item()
    assert path == str(tmp_path / "trace" / "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
